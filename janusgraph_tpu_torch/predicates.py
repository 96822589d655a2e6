"""Comparison predicates — the port's copy of ``Predicate``, ``_CmpPredicate``
and ``Cmp`` from ``janusgraph_tpu/core/predicates.py``.

A predicate is a singleton with a pure ``evaluate(value, condition)``. The
OLAP traversal's filter masks vectorize ``Cmp`` over numeric property
columns through ``_fn``; any other object with an ``evaluate`` method (a
text or geo predicate) is evaluated value by value.
"""

from __future__ import annotations


class Predicate:
    """A binary predicate value ``test(stored_value, condition_value)``."""

    name: str = "predicate"

    def evaluate(self, value, condition) -> bool:
        raise NotImplementedError

    def __repr__(self):
        return self.name


class _CmpPredicate(Predicate):
    def __init__(self, name, fn):
        self.name = name
        self._fn = fn

    def evaluate(self, value, condition) -> bool:
        if value is None:
            return self.name == "neq" and condition is not None
        try:
            return self._fn(value, condition)
        except TypeError:
            return self.name == "neq"


class Cmp:
    """The comparison predicates (JanusGraph's ``Cmp``)."""

    EQUAL = _CmpPredicate("eq", lambda v, c: v == c)
    NOT_EQUAL = _CmpPredicate("neq", lambda v, c: v != c)
    LESS_THAN = _CmpPredicate("lt", lambda v, c: v < c)
    LESS_THAN_EQUAL = _CmpPredicate("lte", lambda v, c: v <= c)
    GREATER_THAN = _CmpPredicate("gt", lambda v, c: v > c)
    GREATER_THAN_EQUAL = _CmpPredicate("gte", lambda v, c: v >= c)
