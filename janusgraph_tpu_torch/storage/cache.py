"""Store-level slice cache with expiration and write-through invalidation —
the port's copy of ``janusgraph_tpu/storage/cache.py``.

Capability parity with the reference's two-level caching
(reference: diskstorage/keycolumnvalue/cache/ExpirationKCVSCache.java:225,
KCVSCache.java:82): an LRU of slice results keyed by (row key, slice),
invalidated per row on mutation, with a TTL for cross-instance staleness
bounds. Wraps any KeyColumnValueStore transparently.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict
from typing import Dict, Iterator, Optional, Sequence, Tuple

from janusgraph_tpu_torch.storage.kcvs import (
    EntryList,
    KeyColumnValueStore,
    KeySliceQuery,
    SliceQuery,
    StoreTransaction,
)


class CacheMetrics:
    def __init__(self):
        self.hits = 0
        self.misses = 0
        self.invalidations = 0


class ExpirationCacheStore(KeyColumnValueStore):
    """LRU slice cache wrapper. Thread-safe; snapshot semantics inherited
    from the underlying store."""

    def __init__(
        self,
        store: KeyColumnValueStore,
        max_entries: int = 65536,
        ttl_seconds: Optional[float] = None,
        clean_wait_seconds: float = 0.0,
    ):
        self._store = store
        self._max = max_entries
        self._ttl = ttl_seconds
        # cache.db-cache-clean-wait-ms: after a row invalidation, refuse to
        # re-admit that row for this long — an eventually-consistent backend
        # may still be propagating the write that invalidated it
        # (reference: ExpirationKCVSCache.java penaltyCountdown)
        self._clean_wait = clean_wait_seconds
        self._dirty_rows: Dict[bytes, float] = {}
        self._lock = threading.Lock()
        # (key, slice start, end, limit) -> (entries, inserted_at)
        self._cache: "OrderedDict[tuple, Tuple[EntryList, float]]" = (
            OrderedDict()
        )
        # row key -> set of cached slice keys, for O(row) invalidation
        self._by_row: Dict[bytes, set] = {}
        # bumped on every invalidation; a fetch started before a concurrent
        # invalidation must not populate the cache with its (stale) result
        self._generation = 0
        self.metrics = CacheMetrics()

    @property
    def name(self) -> str:
        return self._store.name

    @property
    def wrapped(self) -> KeyColumnValueStore:
        return self._store

    def get_slice(self, query: KeySliceQuery, txh: StoreTransaction) -> EntryList:
        # a flat tuple: its hash runs in C, where the frozen SliceQuery's
        # generated __hash__ is a Python call (four a miss)
        sq = query.slice
        ck = (query.key, sq.start, sq.end, sq.limit)
        now = time.monotonic()
        with self._lock:
            hit = self._cache.get(ck)
            if hit is not None:
                entries, at = hit
                if self._ttl is None or now - at < self._ttl:
                    self._cache.move_to_end(ck)
                    self.metrics.hits += 1
                    return list(entries)
                self._evict(ck)
            self.metrics.misses += 1
            gen = self._generation
        entries = self._store.get_slice(query, txh)
        with self._lock:
            if self._generation != gen:
                # a row was invalidated during the unlocked fetch; our result
                # may predate the write — serve it but don't cache it
                return list(entries)
            if self._clean_wait > 0:
                dirty_at = self._dirty_rows.get(query.key)
                if dirty_at is not None:
                    if time.monotonic() - dirty_at < self._clean_wait:
                        return list(entries)  # within the clean-wait window
                    del self._dirty_rows[query.key]
            self._cache[ck] = (entries, now)
            self._by_row.setdefault(query.key, set()).add(ck)
            while len(self._cache) > self._max:
                old, _ = self._cache.popitem(last=False)
                rowset = self._by_row.get(old[0])
                if rowset is not None:
                    rowset.discard(old)
                    if not rowset:
                        del self._by_row[old[0]]
        return list(entries)

    def get_slice_multi(self, keys, slice_query, txh):
        return {k: self.get_slice(KeySliceQuery(k, slice_query), txh) for k in keys}

    def mutate(
        self,
        key: bytes,
        additions: EntryList,
        deletions: Sequence[bytes],
        txh: StoreTransaction,
    ) -> None:
        self._store.mutate(key, additions, deletions, txh)
        self.invalidate(key)

    def invalidate(self, key: bytes) -> None:
        with self._lock:
            self._generation += 1
            if self._clean_wait > 0:
                now = time.monotonic()
                self._dirty_rows[key] = now
                # amortized prune: rows written but never re-read would
                # otherwise accumulate for the process lifetime
                if len(self._dirty_rows) > max(1024, 2 * self._max):
                    self._dirty_rows = {
                        k: at for k, at in self._dirty_rows.items()
                        if now - at < self._clean_wait
                    }
            for ck in self._by_row.pop(key, ()):  # all slices of this row
                self._cache.pop(ck, None)
                self.metrics.invalidations += 1

    def invalidate_all(self) -> None:
        """Drop every cached slice (cross-instance schema changes)."""
        with self._lock:
            self._generation += 1
            self.metrics.invalidations += len(self._cache)
            self._cache.clear()
            self._by_row.clear()

    def _evict(self, ck) -> None:
        self._cache.pop(ck, None)
        rowset = self._by_row.get(ck[0])
        if rowset is not None:
            rowset.discard(ck)
            if not rowset:
                del self._by_row[ck[0]]

    def get_keys(self, query, txh: StoreTransaction) -> Iterator[Tuple[bytes, EntryList]]:
        # scans bypass the cache (reference does the same: scans are OLAP)
        return self._store.get_keys(query, txh)

    def close(self) -> None:
        with self._lock:
            self._cache.clear()
            self._by_row.clear()
        self._store.close()
