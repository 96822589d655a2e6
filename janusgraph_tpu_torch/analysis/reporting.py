"""graphlint reporters: human-readable text and machine-readable JSON."""

from __future__ import annotations

import json
from typing import Dict, List

from janusgraph_tpu_torch.analysis.core import Finding, RULES, SEV_ERROR, SEV_WARNING

#: v2: finding objects carry the stable ``file``/``line``/``rule``/
#: ``severity`` keys (plus ``col``/``message``/``suppressed``); ``path``
#: is kept as the v1 alias of ``file``
SCHEMA_VERSION = 2


def summarize(findings: List[Finding]) -> Dict[str, int]:
    live = [f for f in findings if not f.suppressed]
    return {
        "errors": sum(1 for f in live if f.severity == SEV_ERROR),
        "warnings": sum(1 for f in live if f.severity == SEV_WARNING),
        "suppressed": sum(1 for f in findings if f.suppressed),
    }


def to_text(findings: List[Finding], files_scanned: int) -> str:
    lines = []
    for f in findings:
        tag = " (suppressed)" if f.suppressed else ""
        lines.append(
            f"{f.path}:{f.line}:{f.col}: {f.rule_id} {f.severity}{tag}: "
            f"{f.message}"
        )
    c = summarize(findings)
    lines.append(
        f"graphlint: {c['errors']} error(s), {c['warnings']} warning(s)"
        + (f", {c['suppressed']} suppressed" if c["suppressed"] else "")
        + f" in {files_scanned} file(s)"
    )
    return "\n".join(lines)


def to_json(findings: List[Finding], files_scanned: int) -> str:
    return json.dumps(
        {
            "schema_version": SCHEMA_VERSION,
            "tool": "graphlint",
            "files_scanned": files_scanned,
            "counts": summarize(findings),
            "findings": [f.to_dict() for f in findings],
        },
        indent=2,
        sort_keys=True,
    )


def from_json(blob: str) -> List[Finding]:
    """Round-trip loader (used by tests and tooling that post-processes
    reports)."""
    data = json.loads(blob)
    return [
        Finding(
            rule_id=d["rule"],
            severity=d["severity"],
            path=d.get("file", d.get("path")),
            line=d["line"],
            col=d["col"],
            message=d["message"],
            suppressed=d.get("suppressed", False),
        )
        for d in data["findings"]
    ]


def list_rules_text() -> str:
    lines = ["graphlint rules:"]
    for rid in sorted(RULES):
        r = RULES[rid]
        lines.append(f"  {r.id}  [{r.severity}]  {r.summary}")
    return "\n".join(lines)
