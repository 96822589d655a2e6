"""A helper a captured loop imports (parse-only)."""


def scale_rows(out, s):
    if out.sum() > 0:  # expect: JG101
        return out * 0.5
    return out
