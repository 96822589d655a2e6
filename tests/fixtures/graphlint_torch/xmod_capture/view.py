"""A property a captured loop reads (parse-only)."""


class View:
    def __init__(self, deg):
        self._deg = deg.clone()

    @property
    def degree(self):
        return self._deg.item()  # expect: JG105
