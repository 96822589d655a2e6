"""Ambient request deadlines: the budget a caller is still willing to wait —
the port's copy of ``janusgraph_tpu/core/deadline.py``.

The deadline rides the ambient context like the span tracer and the
resource ledger (a contextvar, so nesting follows the call structure):
open a :func:`deadline_scope` around a request, and :func:`check` raises
:class:`~janusgraph_tpu_torch.exceptions.DeadlineExceededError` once it is
spent. The traversal checks it at every step boundary, the spillover
planner before it compiles and before it runs.

Deadlines are ABSOLUTE ``time.monotonic()`` instants. A nested scope can
only TIGHTEN the ambient deadline (min of the two): an inner layer granting
itself more time than its caller has left would defeat the point.
"""

from __future__ import annotations

import contextvars
import time
from contextlib import contextmanager
from typing import Optional

from janusgraph_tpu_torch.exceptions import DeadlineExceededError

#: absolute time.monotonic() instant, or None = no ambient deadline
_DEADLINE_VAR: "contextvars.ContextVar[Optional[float]]" = (
    contextvars.ContextVar("janusgraph_tpu_torch_deadline", default=None)
)


def current_deadline() -> Optional[float]:
    """The ambient absolute deadline (time.monotonic() frame), or None."""
    return _DEADLINE_VAR.get()


@contextmanager
def deadline_scope(budget_ms: Optional[float]):
    """Run a block under a deadline ``budget_ms`` from now. ``None`` (or a
    non-positive budget) leaves the ambient deadline untouched, so call
    sites never need to branch on whether a caller propagated one. A
    nested scope only tightens: the effective deadline is the min of the
    ambient one and ``now + budget_ms``."""
    if budget_ms is None or budget_ms <= 0:
        yield
        return
    proposed = time.monotonic() + budget_ms / 1000.0
    ambient = _DEADLINE_VAR.get()
    if ambient is not None:
        proposed = min(ambient, proposed)
    token = _DEADLINE_VAR.set(proposed)
    try:
        yield
    finally:
        _DEADLINE_VAR.reset(token)


def remaining_ms() -> Optional[float]:
    """Milliseconds left on the ambient deadline (negative once spent);
    None when no deadline is set."""
    dl = _DEADLINE_VAR.get()
    if dl is None:
        return None
    return (dl - time.monotonic()) * 1000.0


def expired() -> bool:
    """True when an ambient deadline exists and is already spent."""
    dl = _DEADLINE_VAR.get()
    return dl is not None and time.monotonic() >= dl


def check(where: str = "") -> None:
    """Raise :class:`DeadlineExceededError` when the ambient deadline is
    spent; no-op otherwise (and outside any deadline scope)."""
    dl = _DEADLINE_VAR.get()
    if dl is not None and time.monotonic() >= dl:
        raise DeadlineExceededError(
            f"deadline exceeded{f' in {where}' if where else ''} "
            f"(budget spent {-(remaining_ms() or 0.0):.0f}ms ago)"
        )
