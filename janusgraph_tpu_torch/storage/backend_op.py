"""Retrying backend-operation wrapper — the port's copy of
``janusgraph_tpu/storage/backend_op.py``.

Capability parity with the reference's universal backend-call guard
(reference: diskstorage/util/BackendOperation.java — every storage call is
wrapped in execute(), which retries TemporaryBackendExceptions with
exponential backoff up to a time budget and lets PermanentBackendExceptions
fail fast). Used by the buffered backend transaction's read and flush
paths (``Backend.guard``); available to any caller touching a backend
that can flake.

Backoff shape: exponential base with DECORRELATED JITTER — each delay is
drawn uniformly from [base, prev * 3], capped at the ceiling. Pure
exponential backoff synchronizes every client that failed at the same
instant into retry convoys that re-stampede the recovering backend on the
same schedule (the thundering herd); decorrelated jitter spreads them.

Telemetry: ``storage.backend_op.retries`` counts every replayed attempt,
``storage.backend_op.exhausted`` every guard that gave up (budget or
attempt cap spent) — the recovered-vs-lost split.

Deadline awareness (core/deadline.py): when the ambient request deadline
is spent, the guard raises ``DeadlineExceededError`` BEFORE dispatching
the operation (zero attempts, zero retries), and it stops replaying temporary failures the moment the deadline expires
mid-backoff. This is what keeps a saturated serving path from turning
client timeouts into storage-layer retry storms: the caller gave up, so
every layer below gives up too. ``storage.backend_op.deadline_expired``
counts the refusals.
"""

from __future__ import annotations

import random
import time
from typing import Callable, Optional, TypeVar

from janusgraph_tpu_torch.core import deadline as _deadline
from janusgraph_tpu_torch.exceptions import (
    DeadlineExceededError,
    PermanentBackendError,
    TemporaryBackendError,
)
from janusgraph_tpu_torch.observability import flight_recorder, get_logger, registry
from janusgraph_tpu_torch.observability.profiler import accrue

T = TypeVar("T")

#: default backoff shape; per-backend overrides come in as execute()
#: arguments (storage.backoff-base-ms / storage.backoff-max-ms are wired
#: per Backend, not process-wide: two graphs in one process must not
#: clobber each other's tuning)
BASE_DELAY_S = 0.05
MAX_DELAY_S = 2.0


def check_deadline(stage: str = "dispatch") -> None:
    """Refuse NOW when the ambient caller deadline is already spent:
    counts ``storage.backend_op.deadline_expired`` and raises
    ``DeadlineExceededError`` (permanent — never replayed)."""
    _refuse_if_spent(_deadline.current_deadline(), stage)


def _refuse_if_spent(caller_dl: Optional[float], stage) -> None:
    """``stage`` is a name, or the number of the attempt about to run."""
    if caller_dl is not None and time.monotonic() >= caller_dl:
        registry.counter("storage.backend_op.deadline_expired").inc()
        if isinstance(stage, int):
            stage = f"attempt {stage}"
        raise DeadlineExceededError(
            f"caller deadline spent before {stage} "
            "(no storage dispatch performed)"
        )


def execute(
    op: Callable[[], T],
    max_time_s: float = 10.0,
    base_delay_s: Optional[float] = None,
    max_delay_s: Optional[float] = None,
    max_attempts: int = 0,
) -> T:
    """Run `op`, replaying temporary failures with jittered exponential
    backoff until the time budget is spent; the last temporary error is
    then re-raised. Permanent failures propagate immediately (reference:
    BackendOperation.executeDirect semantics). `max_attempts` (> 0) caps
    the replay COUNT as well as the time budget — whichever trips first
    (reference: storage.write-attempts / read-attempts)."""
    deadline = time.monotonic() + max_time_s
    # the ambient request deadline (propagated from the caller, possibly
    # across the wire) caps the retry budget too: whichever is tighter
    caller_dl = _deadline.current_deadline()
    if caller_dl is not None:
        deadline = min(deadline, caller_dl)
    base = BASE_DELAY_S if base_delay_s is None else base_delay_s
    if max_delay_s is None:
        max_delay_s = MAX_DELAY_S
    delay = base
    attempt = 0
    while True:
        # refuse BEFORE dispatch: no attempt, no retry
        _refuse_if_spent(caller_dl, attempt + 1)
        try:
            return op()
        except PermanentBackendError:
            raise
        except TemporaryBackendError as e:
            attempt += 1
            now = time.monotonic()
            if caller_dl is not None and now >= caller_dl:
                # the deadline (not the retry budget) ran out mid-replay:
                # surface THAT, permanently — more backoff cannot help a
                # caller who already gave up
                registry.counter(
                    "storage.backend_op.deadline_expired"
                ).inc()
                raise DeadlineExceededError(
                    f"caller deadline spent after {attempt} attempt(s); "
                    f"last temporary error: {e}"
                ) from e
            if now >= deadline or (max_attempts and attempt >= max_attempts):
                registry.counter("storage.backend_op.exhausted").inc()
                # a guard giving up is a salient incident event (absorbed
                # retries are just counters; exhaustion loses work)
                flight_recorder.record(
                    "retry_exhausted",
                    attempts=attempt, error=type(e).__name__,
                    message=str(e)[:200],
                )
                get_logger("storage.backend_op").warning(
                    "retry-exhausted",
                    attempts=attempt, error=type(e).__name__,
                    message=str(e)[:200],
                )
                raise
            registry.counter("storage.backend_op.retries").inc()
            # replayed attempts are a per-query cost too: the ledger
            # attributes retry burn to the query that paid it
            accrue(retries=1)
            time.sleep(min(delay, max_delay_s, max(0.0, deadline - now)))
            # decorrelated jitter
            delay = min(max_delay_s, random.uniform(base, delay * 3))
