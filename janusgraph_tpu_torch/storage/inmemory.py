"""In-memory KCVS backend — the port's copy of
``janusgraph_tpu/storage/inmemory.py`` (``InMemoryStoreManager`` and its
store): rows are copy-on-write snapshots of parallel sorted (columns,
values) lists, a mutation builds a fresh row and swaps one reference, and
key scans are ordered.

Cell TTL, as the reference's: an addition ``(column, value, expire_ns)``
records the cell's expiry in a side table; reads filter expired cells
(before a slice's limit) and ``purge_expired`` reclaims them. The store
advertises ``cell_ttl``, so ``set_ttl`` accepts it.

Added: ``InMemoryStoreManager.from_rows`` opens a manager over plain bytes
(``{store: {key: [(column, value), ...]}}``), which is how a graph that the
JAX package wrote is carried across, and ``dump_rows`` is its inverse. The
store keeps its keys sorted between writes that add or drop a row, so a
key-range scan is a bisect instead of a pass over every key; the rows it
yields, and their order, are the reference's.
"""

from __future__ import annotations

import bisect
import threading
import time
from typing import Dict, Iterator, List, Mapping, Optional, Sequence, Tuple

from janusgraph_tpu_torch.storage.kcvs import (
    EntryList,
    KCVMutation,
    KeyColumnValueStore,
    KeyColumnValueStoreManager,
    KeyRangeQuery,
    KeySliceQuery,
    SliceQuery,
    StoreFeatures,
    StoreTransaction,
)


class _Row:
    """Immutable snapshot of one row: parallel sorted columns/values."""

    __slots__ = ("columns", "values")

    def __init__(self, columns: List[bytes], values: List[bytes]):
        self.columns = columns
        self.values = values

    def slice(self, q: SliceQuery) -> EntryList:
        cols = self.columns
        lo = bisect.bisect_left(cols, q.start)
        hi = len(cols) if q.end is None else bisect.bisect_left(cols, q.end)
        if q.limit is not None and hi - lo > q.limit:
            hi = lo + q.limit
        vals = self.values
        return [(cols[i], vals[i]) for i in range(lo, hi)]

    def mutated(self, additions: EntryList, deletions: Sequence[bytes]) -> "_Row":
        """Return a new row with the mutation applied (additions override
        deletions of the same column). One O(n+m) two-way merge."""
        added = {c: v for c, v in additions}
        deleted = set(deletions) - set(added)
        cols: List[bytes] = []
        vals: List[bytes] = []
        old_cols, old_vals = self.columns, self.values
        add_cols = sorted(added)
        i = j = 0
        n, m = len(old_cols), len(add_cols)
        while i < n or j < m:
            if j >= m or (i < n and old_cols[i] < add_cols[j]):
                c = old_cols[i]
                if c not in deleted and c not in added:
                    cols.append(c)
                    vals.append(old_vals[i])
                i += 1
            else:
                c = add_cols[j]
                cols.append(c)
                vals.append(added[c])
                j += 1
                if i < n and old_cols[i] == c:
                    i += 1
        return _Row(cols, vals)

    def is_empty(self) -> bool:
        return not self.columns


_EMPTY_ROW = _Row([], [])


class InMemoryKeyColumnValueStore(KeyColumnValueStore):
    def __init__(self, name: str):
        self._name = name
        self._rows: Dict[bytes, _Row] = {}
        self._write_lock = threading.Lock()
        #: the row keys in byte order, rebuilt after a write that added or
        #: dropped a row (None until then)
        self._sorted_keys: Optional[List[bytes]] = None
        # cell-TTL side table: (key, column) -> expire_ns, filled only by
        # 3-tuple additions (column, value, expire_ns)
        self._expiry: Dict[Tuple[bytes, bytes], int] = {}
        # per-row count of TTL'd cells: limited slices only widen their
        # range for rows that hold expiring cells
        self._expiry_rows: Dict[bytes, int] = {}

    @property
    def name(self) -> str:
        return self._name

    def _filter_expired(self, key: bytes, entries: EntryList) -> EntryList:
        if not self._expiry_rows.get(key):
            return entries
        now = time.time_ns()
        out = []
        for e in entries:
            exp = self._expiry.get((key, e[0]))
            if exp is not None and exp <= now:
                continue
            out.append(e)
        return out

    def _drop_expiry(self, key: bytes, col: bytes) -> None:
        if self._expiry.pop((key, col), None) is not None:
            n = self._expiry_rows.get(key, 0) - 1
            if n > 0:
                self._expiry_rows[key] = n
            else:
                self._expiry_rows.pop(key, None)

    def get_slice(self, query: KeySliceQuery, txh: StoreTransaction) -> EntryList:
        row = self._rows.get(query.key)
        if row is None:
            return []
        sq = query.slice
        if sq.limit is not None and self._expiry_rows.get(query.key):
            # filter BEFORE limiting: expired cells must not occupy the
            # limit window
            live = self._filter_expired(
                query.key, row.slice(SliceQuery(sq.start, sq.end))
            )
            return live[: sq.limit]
        return self._filter_expired(query.key, row.slice(sq))

    def mutate(
        self,
        key: bytes,
        additions: EntryList,
        deletions: Sequence[bytes],
        txh: StoreTransaction,
    ) -> None:
        with self._write_lock:
            plain = []
            added_cols = set()
            for e in additions:
                if len(e) >= 3 and e[2]:
                    if (key, e[0]) not in self._expiry:
                        self._expiry_rows[key] = self._expiry_rows.get(key, 0) + 1
                    self._expiry[(key, e[0])] = e[2]
                elif self._expiry_rows:
                    self._drop_expiry(key, e[0])
                plain.append((e[0], e[1]))
                added_cols.add(e[0])
            if self._expiry_rows:
                for col in deletions:
                    # additions override same-column deletions: their
                    # freshly recorded expiry survives too
                    if col not in added_cols:
                        self._drop_expiry(key, col)
            row = self._rows.get(key)
            new_row = (row or _EMPTY_ROW).mutated(plain, deletions)
            if new_row.is_empty():
                if self._rows.pop(key, None) is not None:
                    self._sorted_keys = None
            else:
                self._rows[key] = new_row
                if row is None:
                    self._sorted_keys = None

    def _keys_in_order(self) -> List[bytes]:
        keys = self._sorted_keys
        if keys is None:
            with self._write_lock:
                keys = self._sorted_keys = sorted(self._rows)
        return keys

    def get_keys(
        self, query, txh: StoreTransaction
    ) -> Iterator[Tuple[bytes, EntryList]]:
        keys = self._keys_in_order()
        if isinstance(query, KeyRangeQuery):
            sq = query.slice
            keys = keys[
                bisect.bisect_left(keys, query.key_start):
                bisect.bisect_left(keys, query.key_end)
            ]
        else:
            sq = query
        for k in keys:
            row = self._rows.get(k)
            if row is None:
                continue
            entries = self._filter_expired(k, row.slice(sq))
            if entries:
                yield k, entries

    def purge_expired(self) -> int:
        """Reclaim expired cells (reads only filter them). Returns the
        number of cells purged."""
        now = time.time_ns()
        with self._write_lock:
            dead = [(k, c) for (k, c), exp in self._expiry.items() if exp <= now]
            by_key: Dict[bytes, List[bytes]] = {}
            for k, c in dead:
                by_key.setdefault(k, []).append(c)
                self._drop_expiry(k, c)
            for k, cols in by_key.items():
                row = self._rows.get(k)
                if row is None:
                    continue
                new_row = row.mutated([], cols)
                if new_row.is_empty():
                    self._rows.pop(k, None)
                    self._sorted_keys = None
                else:
                    self._rows[k] = new_row
        return len(dead)

    # -- introspection used by the OLAP bulk loader ------------------------
    def row_count(self) -> int:
        return len(self._rows)

    def clear(self) -> None:
        with self._write_lock:
            self._rows.clear()
            self._expiry.clear()
            self._expiry_rows.clear()
            self._sorted_keys = None


class InMemoryStoreManager(KeyColumnValueStoreManager):
    """Heap-backed store manager; ordered scans, no locking, no tx."""

    def __init__(self, config: Optional[dict] = None):
        self.config = config or {}
        self._stores: Dict[str, InMemoryKeyColumnValueStore] = {}
        self._lock = threading.Lock()
        self._features = StoreFeatures(
            ordered_scan=True,
            unordered_scan=True,
            multi_query=True,
            batch_mutation=True,
            key_consistent=True,
            persists=False,
            cell_ttl=True,
        )

    @classmethod
    def from_rows(
        cls, rows: Mapping[str, Mapping[bytes, Sequence[Tuple[bytes, bytes]]]]
    ) -> "InMemoryStoreManager":
        """A manager holding exactly ``rows``: ``{store_name: {key:
        [(column, value), ...]}}`` of plain bytes, e.g. dumped from the
        JAX package's in-memory stores. ``open_graph(config,
        store_manager=...)`` then opens the graph they hold."""
        mgr = cls()
        txh = mgr.begin_transaction()
        for store_name, store_rows in rows.items():
            store = mgr.open_database(store_name)
            for key, entries in store_rows.items():
                if entries:
                    store.mutate(
                        bytes(key),
                        [(bytes(c), bytes(v)) for c, v in entries], [], txh,
                    )
        return mgr

    def dump_rows(self) -> Dict[str, Dict[bytes, List[Tuple[bytes, bytes]]]]:
        """Every store's rows as plain bytes (``from_rows``' input)."""
        with self._lock:
            stores = dict(self._stores)
        return {
            name: {
                k: list(zip(row.columns, row.values))
                for k, row in sorted(store._rows.items())
            }
            for name, store in stores.items()
        }

    @property
    def features(self) -> StoreFeatures:
        return self._features

    def open_database(self, name: str) -> InMemoryKeyColumnValueStore:
        with self._lock:
            store = self._stores.get(name)
            if store is None:
                store = InMemoryKeyColumnValueStore(name)
                self._stores[name] = store
            return store

    def begin_transaction(self, config: Optional[dict] = None) -> StoreTransaction:
        return StoreTransaction(config)

    def mutate_many(
        self,
        mutations: Dict[str, Dict[bytes, KCVMutation]],
        txh: StoreTransaction,
    ) -> None:
        for store_name, rows in mutations.items():
            store = self.open_database(store_name)
            for key, m in rows.items():
                if not m.is_empty():
                    store.mutate(key, m.additions, m.deletions, txh)

    def close(self) -> None:
        pass

    def clear_storage(self) -> None:
        with self._lock:
            for s in self._stores.values():
                s.clear()
            self._stores.clear()

    def exists(self) -> bool:
        return bool(self._stores)
