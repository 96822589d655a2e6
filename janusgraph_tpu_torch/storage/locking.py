"""Distributed locking for backends without native transactions: optimistic
consistent-key lock claims plus in-process mediation plus expected-value
assertions at commit — the port's copy of ``janusgraph_tpu/storage/locking.py``.

Capability parity with the reference's locking stack (reference:
diskstorage/locking/consistentkey/ConsistentKeyLocker.java — write a claim
column ``[timestamp, rid]`` to the lock row, wait ``lock.wait-time``, re-read
and let the lexicographically-first unexpired claim win, delete the claim on
loss; locking/LocalLockMediator.java:273 — in-process arbitration so
co-resident transactions never pay the storage round-trip;
consistentkey/ExpectedValueCheckingStore.java:133 +
ExpectedValueCheckingTransaction.java:285 — the slice observed at lock time
must still hold at commit, otherwise the commit fails).

The protocol needs only key-consistent reads from the store — no CAS — which
is exactly what every storage adapter of this framework guarantees.
"""

from __future__ import annotations

import threading
import time
import weakref
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

# the canonical locking errors: TemporaryLockingError IS a
# TemporaryBackendError, so workload-level retry loops written against the
# backend taxonomy ('except TemporaryBackendError: retry the tx') absorb
# lock contention and lease expiry without special-casing
from janusgraph_tpu_torch.exceptions import (
    PermanentLockingError,
    TemporaryLockingError,
)
from janusgraph_tpu_torch.storage.kcvs import (
    KeyColumnValueStore,
    KeySliceQuery,
    SliceQuery,
)


@dataclass(frozen=True)
class KeyColumn:
    """The logical lock target: one (store row, column) cell."""

    key: bytes
    column: bytes


def lock_row_key(target: KeyColumn) -> bytes:
    """Lock-store row for a target cell: length-prefixed key ⧺ column so
    distinct (key, column) pairs can never collide."""
    return (
        len(target.key).to_bytes(4, "big") + target.key + target.column
    )


class LocalLockMediator:
    """In-process lock arbitration per lock namespace. Two transactions in
    the same process contending for one cell resolve here and only the
    winner talks to the store (reference: LocalLockMediator.java:273)."""

    def __init__(self):
        self._held: Dict[KeyColumn, Tuple[object, float]] = {}
        self._cv = threading.Condition()

    def claim(self, target: KeyColumn, holder: object, expiry: float) -> bool:
        with self._cv:
            cur = self._held.get(target)
            now = time.monotonic()
            if cur is not None and cur[0] is not holder and cur[1] > now:
                return False
            self._held[target] = (holder, expiry)
            return True

    def release(self, target: KeyColumn, holder: object) -> None:
        with self._cv:
            cur = self._held.get(target)
            if cur is not None and cur[0] is holder:
                del self._held[target]
                self._cv.notify_all()


#: one mediator namespace per store-manager instance — instances sharing a
#: manager (the "multiple graphs in one process" test technique) share it
_MEDIATORS: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()
_MEDIATORS_LOCK = threading.Lock()


def mediator_for(manager) -> LocalLockMediator:
    # decorator managers (the TTL wrapper) expose the real manager as
    # .wrapped — mediation must key on the SHARED backend, or two graphs
    # over one store would stop mediating in-process
    while hasattr(manager, "wrapped"):
        manager = manager.wrapped
    with _MEDIATORS_LOCK:
        med = _MEDIATORS.get(manager)
        if med is None:
            med = LocalLockMediator()
            _MEDIATORS[manager] = med
        return med


@dataclass
class _LockStatus:
    write_timestamp_ns: int
    expected: Optional[list]  # EntryList observed at lock time (None = unread)
    checked: bool = False


class ConsistentKeyLocker:
    """Claim-then-verify locking on a dedicated lock store.

    Claim column encoding: ``[timestamp_ns (8B big-endian)][rid]`` — sorting
    by column therefore sorts by claim time, and the first unexpired claim in
    the row owns the lock (reference: ConsistentKeyLocker.java claim
    write/check/delete cycle).
    """

    def __init__(
        self,
        lock_store: KeyColumnValueStore,
        store_tx_factory,
        rid: bytes,
        mediator: LocalLockMediator,
        wait_ms: float = 1.0,
        expiry_ms: float = 10_000.0,
        retries: int = 3,
        clean_expired: bool = False,
        clock_ns=None,
    ):
        self.store = lock_store
        self._tx_factory = store_tx_factory
        self.rid = rid
        self.mediator = mediator
        self.wait_ms = wait_ms
        self.expiry_ms = expiry_ms
        self.retries = retries
        #: lease-expiry clock used by check_locks. Injectable so tests can
        #: skew it — an expired lease must raise TemporaryLockingError and
        #: be re-acquirable, and that path needs to be exercisable without
        #: real 10s waits. Claim WRITE timestamps stay on the real clock:
        #: skewing only the check models a holder whose lease ran out.
        self.clock_ns = clock_ns or time.time_ns
        #: locks.clean-expired: delete expired claim columns encountered
        #: during checks (dead holders' claims otherwise linger until a
        #: compaction; reference: ConsistentKeyLocker CLEAN_EXPIRED)
        self.clean_expired = clean_expired
        self._locks: Dict[object, Dict[KeyColumn, _LockStatus]] = {}
        self._guard = threading.Lock()

    # ------------------------------------------------------------- claim path
    def _claim_column(self, ts_ns: int) -> bytes:
        return ts_ns.to_bytes(8, "big") + self.rid

    def write_lock(
        self, target: KeyColumn, tx: object, expected: Optional[list] = None
    ) -> None:
        """Acquire (or re-enter) the lock on `target` for holder `tx`."""
        with self._guard:
            held = self._locks.setdefault(tx, {})
            if target in held:
                if expected is not None and held[target].expected is None:
                    held[target].expected = expected
                return
        from janusgraph_tpu_torch.observability import registry, span

        with span("lock.acquire"), registry.time("locks.write_lock"):
            self._write_claim(target, tx, expected)

    def _write_claim(
        self, target: KeyColumn, tx: object, expected: Optional[list]
    ) -> None:
        if not self.mediator.claim(
            target, tx, time.monotonic() + self.expiry_ms / 1000.0
        ):
            raise TemporaryLockingError(
                f"local lock contention on {target.key!r}/{target.column!r}"
            )
        row = lock_row_key(target)
        stx = self._tx_factory()
        last_exc: Optional[Exception] = None
        for _attempt in range(self.retries):
            ts = time.time_ns()
            col = self._claim_column(ts)
            try:
                self.store.mutate(row, [(col, b"")], [], stx)
            except Exception as e:  # claim write failed: clean up, retry
                last_exc = e
                try:
                    self.store.mutate(row, [], [col], stx)
                except Exception:
                    pass
                continue
            with self._guard:
                self._locks.setdefault(tx, {})[target] = _LockStatus(
                    ts, expected
                )
            return
        self.mediator.release(target, tx)
        raise TemporaryLockingError(
            f"failed to write lock claim after {self.retries} attempts"
        ) from last_exc

    # ------------------------------------------------------------- check path
    def check_locks(self, tx: object) -> None:
        """After all claims: wait out the claim window once, then verify every
        claim of `tx` is the first unexpired claim in its row."""
        with self._guard:
            held = dict(self._locks.get(tx, {}))
        if not held:
            return
        newest = max(s.write_timestamp_ns for s in held.values())
        elapsed_ms = (time.time_ns() - newest) / 1e6
        if elapsed_ms < self.wait_ms:
            time.sleep((self.wait_ms - elapsed_ms) / 1000.0)
        stx = self._tx_factory()
        now_ns = self.clock_ns()
        cutoff_ns = now_ns - int(self.expiry_ms * 1e6)
        for target, status in held.items():
            if status.checked:
                continue
            row = lock_row_key(target)
            if status.write_timestamp_ns < cutoff_ns:
                # the holder's OWN lease ran out (slow tx, GC pause, clock
                # skew): surface it as the retriable lease-expiry error and
                # release so the target is immediately re-acquirable
                self._release_target(target, status, tx, stx)
                raise TemporaryLockingError(
                    f"lock lease expired on {target.key!r}/"
                    f"{target.column!r} (claim age exceeds locks.expiry-ms="
                    f"{self.expiry_ms}) — re-acquire and retry"
                )
            entries = self.store.get_slice(
                KeySliceQuery(row, SliceQuery()), stx
            )
            winner = None
            stale: list = []
            for col, _val in entries:  # columns sort by timestamp
                ts = int.from_bytes(col[:8], "big")
                if ts < cutoff_ns:
                    stale.append(col)  # expired claim
                    continue
                winner = col[8:]
                break
            if self.clean_expired and stale:
                try:  # best-effort: cleanup must never fail the check
                    self.store.mutate(row, [], stale, stx)
                except Exception:  # noqa: BLE001
                    pass
            if winner != self.rid:
                self._release_target(target, status, tx, stx)
                raise TemporaryLockingError(
                    f"lost lock race on {target.key!r}/{target.column!r}"
                )
            status.checked = True

    def check_expected_values(self, tx: object, reader) -> None:
        """The expected-value half: `reader(target) -> EntryList` re-reads the
        data store; any drift since lock time fails the commit (reference:
        ExpectedValueCheckingTransaction.checkAllExpectedValues)."""
        with self._guard:
            held = dict(self._locks.get(tx, {}))
        for target, status in held.items():
            if status.expected is None:
                continue
            current = reader(target)
            if list(current) != list(status.expected):
                raise PermanentLockingError(
                    f"expected value changed under lock for "
                    f"{target.key!r}/{target.column!r}"
                )

    # ----------------------------------------------------------- release path
    def _release_target(
        self, target: KeyColumn, status: _LockStatus, tx: object, stx
    ) -> None:
        try:
            self.store.mutate(
                lock_row_key(target),
                [],
                [self._claim_column(status.write_timestamp_ns)],
                stx,
            )
        finally:
            self.mediator.release(target, tx)
            with self._guard:
                # drop the registration: a released (lost/expired) target
                # must be re-acquirable with a FRESH claim, not re-entered
                # on the stale timestamp
                held = self._locks.get(tx)
                if held is not None:
                    held.pop(target, None)

    def delete_locks(self, tx: object) -> None:
        with self._guard:
            held = self._locks.pop(tx, {})
        if not held:
            return
        stx = self._tx_factory()
        for target, status in held.items():
            self._release_target(target, status, tx, stx)

    def held_by(self, tx: object) -> List[KeyColumn]:
        with self._guard:
            return list(self._locks.get(tx, {}))
