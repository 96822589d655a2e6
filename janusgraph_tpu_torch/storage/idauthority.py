"""Cluster-unique ID block allocation over the KCVS itself.

Capability parity with the reference's consistent-key ID authority
(reference: diskstorage/idmanagement/ConsistentKeyIDAuthority.java:206-320 —
claim-then-verify block allocation needing only key-consistent reads, no
CAS; graphdb/database/idassigner/StandardIDPool.java:301 — double-buffered
block prefetch).

Protocol per (namespace, partition):
  1. read the current frontier (largest claimed block end),
  2. propose the next block and write a claim cell
     column = [block_end:8 BE][timestamp_ns:8 BE][uid:16],
  3. wait out the write-propagation window (`wait_ms`) so every rival claim
     written before our re-read is visible under key-consistent reads,
  4. re-read claims for that block end: the lexicographically-first claim
     (earliest timestamp, uid tiebreak) wins; losers delete their claim and
     retry from a fresh frontier.

The wait window is the same assumption the reference makes: with
key-consistent reads and a window exceeding the store's write latency, all
contenders observe the same rival set and agree on the winner.

Block size is a cluster-global constant (the reference's `ids.block-size`
is GLOBAL_OFFLINE): the first authority persists it in the id store and
every later authority must match or fails fast — differing sizes would make
claim columns incomparable and blocks overlap.

The port's copy of ``janusgraph_tpu/storage/idauthority.py`` (``IDBlock``,
``ConsistentKeyIDAuthority``, ``StandardIDPool``, ``ConflictAvoidanceMode``,
which the attribute serializer also registers as type id 51), with the
same claim cells, claim keys and blocks in every conflict-avoidance mode.
"""

from __future__ import annotations

import os
import struct
import threading
import time
import uuid
from enum import Enum
from typing import Dict, Optional

from janusgraph_tpu_torch.exceptions import (
    ConfigurationError,
    IDPoolExhaustedError,
    PermanentBackendError,
    TemporaryBackendError,
)
from janusgraph_tpu_torch.storage.kcvs import (
    KeyColumnValueStore,
    KeySliceQuery,
    SliceQuery,
    StoreTransaction,
)

ID_STORE_NAME = "janusgraph_ids"

_BLOCK_SIZE_KEY = b"\x00block_size"
_BLOCK_SIZE_COL = b"size"


class ConflictAvoidanceMode(Enum):
    """How allocators avoid contending on the same id-block claim key
    (reference: diskstorage/idmanagement/ConflictAvoidanceMode.java:76 —
    a user-visible config enum serialized into global config). The members
    and their order are the reference's: the serializer encodes a member
    by its position.

    NONE          — all instances race on one claim key per (ns, partition);
                    the claim protocol resolves conflicts (default).
    LOCAL_MANUAL  — this instance uses its locally configured tag.
    GLOBAL_MANUAL — every instance is expected to carry a (distinct)
                    configured tag; same mechanics as LOCAL_MANUAL here,
                    the distinction is operational intent.
    GLOBAL_AUTO   — each authority draws a random tag at startup.

    A tagged authority claims under key+tag and owns the tag's whole
    block-number subsequence (global block = local * num_tags + tag), so
    tagged allocators NEVER contend — at the cost of id-space striping.
    """

    NONE = "none"
    LOCAL_MANUAL = "local_manual"
    GLOBAL_MANUAL = "global_manual"
    GLOBAL_AUTO = "global_auto"


def _partition_key(namespace: int, partition: int) -> bytes:
    return struct.pack(">BI", namespace, partition)


class IDBlock:
    __slots__ = ("start", "size", "_next")

    def __init__(self, start: int, size: int):
        self.start = start
        self.size = size
        self._next = 0

    def next_id(self) -> Optional[int]:
        if self._next >= self.size:
            return None
        v = self.start + self._next
        self._next += 1
        return v

    def next_span(self, count: int):
        """Consume up to `count` contiguous ids; returns (start, taken)."""
        taken = min(count, self.size - self._next)
        start = self.start + self._next
        self._next += taken
        return start, taken

    @property
    def remaining(self) -> int:
        return self.size - self._next


class ConsistentKeyIDAuthority:
    """Allocates disjoint ID blocks from the shared `janusgraph_ids` store."""

    # namespaces (the reference separates vertex/relation/schema counters by key)
    NS_VERTEX = 0
    NS_RELATION = 1
    NS_SCHEMA = 2

    def __init__(
        self,
        store: KeyColumnValueStore,
        txh: StoreTransaction,
        block_size: int = 10_000,
        uid: Optional[bytes] = None,
        max_retries: int = 20,
        wait_ms: float = 2.0,
        conflict_mode: ConflictAvoidanceMode = ConflictAvoidanceMode.NONE,
        conflict_tag: int = 0,
        conflict_tag_bits: int = 4,
        read_only: bool = False,
    ):
        self.store = store
        self.txh = txh
        self.block_size = block_size
        #: storage.read-only: refuse block claims up front (the claim
        #: protocol writes to the id store before anything else would)
        self.read_only = read_only
        self.conflict_mode = conflict_mode
        if conflict_mode is ConflictAvoidanceMode.NONE:
            self.num_tags = 1
            self.tag = 0
        else:
            self.num_tags = 1 << conflict_tag_bits
            if conflict_mode is ConflictAvoidanceMode.GLOBAL_AUTO:
                import random

                self.tag = random.randrange(self.num_tags)
            else:
                if not 0 <= conflict_tag < self.num_tags:
                    raise ValueError(
                        f"conflict-avoidance tag {conflict_tag} outside "
                        f"[0, 2^{conflict_tag_bits})"
                    )
                self.tag = conflict_tag
        self.uid = uid if uid is not None else (
            uuid.uuid4().bytes[:12] + os.getpid().to_bytes(4, "big")
        )
        assert len(self.uid) == 16
        self.max_retries = max_retries
        self.wait_ms = wait_ms
        self._frontier_cache: Dict[bytes, int] = {}
        self._check_block_size_agreement()

    def _check_block_size_agreement(self) -> None:
        stored = self.store.get_slice(
            KeySliceQuery(
                _BLOCK_SIZE_KEY,
                SliceQuery(_BLOCK_SIZE_COL, _BLOCK_SIZE_COL + b"\x00"),
            ),
            self.txh,
        )
        if not stored:
            self.store.mutate(
                _BLOCK_SIZE_KEY,
                [(_BLOCK_SIZE_COL, struct.pack(">Q", self.block_size))],
                [],
                self.txh,
            )
            stored = self.store.get_slice(
                KeySliceQuery(
                    _BLOCK_SIZE_KEY,
                    SliceQuery(_BLOCK_SIZE_COL, _BLOCK_SIZE_COL + b"\x00"),
                ),
                self.txh,
            )
        (agreed,) = struct.unpack(">Q", stored[0][1])
        if agreed != self.block_size:
            raise ConfigurationError(
                f"id block_size {self.block_size} disagrees with the cluster "
                f"value {agreed}; block size is a global constant"
            )

    def get_id_block(self, namespace: int, partition: int) -> IDBlock:
        if self.read_only:
            raise PermanentBackendError("storage.read-only: id-block claims write to the id store")
        key = _partition_key(namespace, partition)
        if self.num_tags > 1:
            # tagged claim space: no cross-tag contention; the frontier
            # under key+tag counts TAG-LOCAL blocks, remapped to a globally
            # disjoint block-number stripe below
            key += struct.pack(">H", self.tag)
        for _ in range(self.max_retries):
            frontier = self._read_frontier(key)
            block_end = frontier + self.block_size
            claim_col = (
                struct.pack(">QQ", block_end, time.time_ns()) + self.uid
            )
            self.store.mutate(key, [(claim_col, b"")], [], self.txh)
            # wait out write propagation so all contenders see the same rivals
            time.sleep(self.wait_ms / 1000.0)
            rivals = self.store.get_slice(
                KeySliceQuery(
                    key,
                    SliceQuery(
                        struct.pack(">Q", block_end),
                        struct.pack(">Q", block_end + 1),
                    ),
                ),
                self.txh,
            )
            if rivals and rivals[0][0] == claim_col:
                self._frontier_cache[key] = block_end
                if self.num_tags > 1:
                    # local block b -> global block b*num_tags + tag: every
                    # tag owns a disjoint stripe of the id space
                    b = frontier // self.block_size
                    start = (b * self.num_tags + self.tag) * self.block_size
                    return IDBlock(start + 1, self.block_size)
                return IDBlock(frontier + 1, self.block_size)
            # lost the race: withdraw and retry from a fresh frontier
            self.store.mutate(key, [], [claim_col], self.txh)
        raise TemporaryBackendError(
            f"could not allocate id block for ns={namespace} partition={partition} "
            f"after {self.max_retries} attempts"
        )

    def _read_frontier(self, key: bytes) -> int:
        """Largest claimed block end (0 if none). Claim columns sort by block
        end, so the frontier is the last column. Reads are incremental: we
        only slice claims beyond the last frontier this authority observed,
        so allocation cost doesn't grow with the claim history."""
        cached = self._frontier_cache.get(key, 0)
        entries = self.store.get_slice(
            KeySliceQuery(key, SliceQuery(struct.pack(">Q", cached + 1))),
            self.txh,
        )
        if entries:
            (end,) = struct.unpack(">Q", entries[-1][0][:8])
            cached = max(cached, end)
        self._frontier_cache[key] = cached
        return cached


class StandardIDPool:
    """Double-buffered per-(namespace, partition) ID pool: hands out single
    IDs from the current block and prefetches the next block in a background
    thread before exhaustion (reference: StandardIDPool.java:301)."""

    RENEW_FRACTION = 0.3  # prefetch when <30% remaining (ids.renew-percentage)

    def __init__(
        self,
        authority: ConsistentKeyIDAuthority,
        namespace: int,
        partition: int,
        max_id: Optional[int] = None,
        renew_fraction: Optional[float] = None,
        renew_timeout_ms: float = 0.0,
    ):
        self.authority = authority
        self.namespace = namespace
        self.partition = partition
        self.max_id = max_id
        #: ids.renew-timeout-ms: bound the wait for an in-flight background
        #: block fetch (0 = wait forever; reference: ids.renew-timeout)
        self.renew_timeout_ms = renew_timeout_ms
        self.RENEW_FRACTION = (
            renew_fraction if renew_fraction is not None else type(self).RENEW_FRACTION
        )
        self._lock = threading.Lock()
        self._current: Optional[IDBlock] = None
        self._next_block: Optional[IDBlock] = None
        self._prefetch_thread: Optional[threading.Thread] = None
        self._prefetch_error: Optional[Exception] = None

    def next_id(self) -> int:
        with self._lock:
            while True:
                if self._current is not None:
                    v = self._current.next_id()
                    if v is not None:
                        if (
                            self._current.remaining
                            < self.authority.block_size * self.RENEW_FRACTION
                        ):
                            self._start_prefetch()
                        if self.max_id is not None and v > self.max_id:
                            raise IDPoolExhaustedError(
                                f"id namespace {self.namespace} partition "
                                f"{self.partition} exhausted"
                            )
                        return v
                # current exhausted (or absent): install the prefetched block,
                # or wait for an in-flight prefetch, or fetch synchronously.
                if self._next_block is not None:
                    self._current, self._next_block = self._next_block, None
                    continue
                t = self._prefetch_thread
                if t is not None:
                    # drop the lock while waiting; afterwards loop re-checks
                    # state, since another thread may have swapped already
                    self._lock.release()
                    try:
                        timeout = (
                            self.renew_timeout_ms / 1000.0
                            if self.renew_timeout_ms > 0 else None
                        )
                        t.join(timeout)
                        if t.is_alive():
                            raise TemporaryBackendError(
                                "id-block renewal exceeded "
                                f"ids.renew-timeout-ms "
                                f"({self.renew_timeout_ms:.0f}ms)"
                            )
                    finally:
                        self._lock.acquire()
                    if self._next_block is None and self._prefetch_error is not None:
                        err, self._prefetch_error = self._prefetch_error, None
                        raise err
                    continue
                # synchronous fallback: the double-buffer missed, so there
                # are NO ids to hand out until the claim round-trip (incl.
                # its propagation wait) completes — contenders must block
                # graphlint: disable=JG203 -- intentional: empty pool, callers must wait for the block claim
                self._current = self._fetch()

    def next_ids(self, count: int):
        """Bulk allocation: spans of contiguous ids drawn from successive
        blocks (the columnar write-back path needs millions of relation ids;
        one next_id() round trip per id would dominate). Returns a list of
        (start, length) spans covering exactly `count` ids."""
        spans = []
        remaining = count
        with self._lock:
            while remaining > 0:
                if self._current is None or self._current.remaining == 0:
                    if self._next_block is not None:
                        self._current, self._next_block = self._next_block, None
                    else:
                        # same synchronous-fallback contract as next_id
                        # graphlint: disable=JG203 -- intentional: empty pool, callers must wait for the block claim
                        self._current = self._fetch()
                start, taken = self._current.next_span(remaining)
                if taken:
                    if self.max_id is not None and start + taken - 1 > self.max_id:
                        raise IDPoolExhaustedError(
                            f"id namespace {self.namespace} exhausted"
                        )
                    spans.append((start, taken))
                    remaining -= taken
        return spans

    def _fetch(self) -> IDBlock:
        return self.authority.get_id_block(self.namespace, self.partition)

    def _start_prefetch(self) -> None:
        if self._prefetch_thread is not None or self._next_block is not None:
            return

        def run():
            try:
                blk = self._fetch()
                with self._lock:
                    self._next_block = blk
                    self._prefetch_error = None
                    self._prefetch_thread = None
            except Exception as e:  # surfaced on next exhaustion
                with self._lock:
                    self._prefetch_error = e
                    self._prefetch_thread = None

        t = threading.Thread(target=run, daemon=True, name="id-prefetch")
        # graphlint: disable=JG401 -- _start_prefetch is only called from next_id with self._lock already held; the prefetch thread's writes take the same lock
        self._prefetch_thread = t
        t.start()
