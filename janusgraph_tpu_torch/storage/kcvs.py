"""Key-Column-Value store SPI — the layer-1 storage contract: the port's
copy of ``janusgraph_tpu/storage/kcvs.py``. A store's native per-cell
``acquire_lock`` refuses (no ported store has one: the consistent-key
locker in ``locking.py`` serves every store).

The whole graph (vertices, edges, properties, schema, indexes, ID counters,
logs, config) lives in a handful of named stores of *sorted wide rows*:
``key -> sorted[(column, value)]`` with byte-wise lexicographic ordering on
both keys and columns. Everything above this SPI is backend-agnostic.

Capability parity with the reference SPI
(reference: diskstorage/keycolumnvalue/KeyColumnValueStore.java:39 —
getSlice/mutate/acquireLock/getKeys; KeyColumnValueStoreManager.java:31 —
mutateMany; StoreFeatures.java:28 — capability flags), re-designed for a
Python/numpy host runtime feeding a TPU compute path: slice results are
columnar ``EntryList``s that can expose zero-copy numpy views for bulk
CSR decoding.
"""

from __future__ import annotations

import abc
import bisect
from dataclasses import dataclass, field, replace
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

from janusgraph_tpu_torch.exceptions import PermanentBackendError


# A column-value entry. Kept as a plain tuple (column, value) for speed;
# helper accessors below. Columns and values are immutable `bytes`.
Entry = Tuple[bytes, bytes]
EntryList = List[Entry]

@dataclass(frozen=True)
class SliceQuery:
    """A contiguous column range [start, end) on one row, with a limit.

    Byte-lexicographic bounds; ``end=None`` means unbounded (strictly after
    every possible column — no byte sentinel can express that). ``limit``
    caps the number of returned entries
    (reference: diskstorage/keycolumnvalue/SliceQuery.java).
    """

    start: bytes = b""
    end: Optional[bytes] = None
    limit: Optional[int] = None

    def with_limit(self, limit: int) -> "SliceQuery":
        return replace(self, limit=limit)

    def contains(self, column: bytes) -> bool:
        return self.start <= column and (self.end is None or column < self.end)

    def subsumes(self, other: "SliceQuery") -> bool:
        if self.start > other.start:
            return False
        if self.end is not None and (other.end is None or self.end < other.end):
            return False
        return self.limit is None or (
            other.limit is not None and self.limit >= other.limit
        )


@dataclass(frozen=True)
class KeySliceQuery:
    """A SliceQuery bound to a specific row key."""

    key: bytes
    slice: SliceQuery

    @property
    def start(self) -> bytes:
        return self.slice.start

    @property
    def end(self) -> bytes:
        return self.slice.end

    @property
    def limit(self) -> Optional[int]:
        return self.slice.limit


@dataclass(frozen=True)
class KeyRangeQuery:
    """Iterate keys in [key_start, key_end) returning a column slice per key.

    Requires ordered-scan capability (reference: KCVS.getKeys(KeyRangeQuery)).
    """

    key_start: bytes
    key_end: bytes
    slice: SliceQuery


@dataclass
class KCVMutation:
    """Batched additions + deletions for one row.

    Deletions are column keys. Additions are (column, value) entries.
    (reference: diskstorage/keycolumnvalue/KCVMutation.java)
    """

    additions: EntryList = field(default_factory=list)
    deletions: List[bytes] = field(default_factory=list)

    def is_empty(self) -> bool:
        return not self.additions and not self.deletions

    def merge(self, other: "KCVMutation") -> None:
        """Merge a *later* mutation into this one, preserving temporal order:
        a later deletion cancels an earlier addition of the same column and
        vice versa (reference: KCVSMutation consolidation semantics).
        Addition entries are (column, value) or (column, value, expire_ns)
        for cell-TTL backends — indexed, never unpacked, so both co-exist."""
        if other.deletions:
            dels = set(other.deletions)
            self.additions = [e for e in self.additions if e[0] not in dels]
            self.deletions.extend(other.deletions)
        if other.additions:
            adds = {e[0] for e in other.additions}
            self.deletions = [d for d in self.deletions if d not in adds]
            self.additions.extend(other.additions)


@dataclass(frozen=True)
class StoreFeatures:
    """Capability flags a backend advertises; upper layers adapt to them.

    (reference: diskstorage/keycolumnvalue/StandardStoreFeatures.java)
    """

    ordered_scan: bool = False
    unordered_scan: bool = False
    multi_query: bool = False
    locking: bool = False          # native per-cell locking
    batch_mutation: bool = False
    transactional: bool = False
    key_consistent: bool = False   # quorum-consistent single-key reads
    distributed: bool = False
    #: storage is reachable by writers OUTSIDE this process (a network
    #: client adapter): cell payloads cross a trust boundary, so upper
    #: layers must not decode formats that execute on read (pickle).
    #: distinct from `distributed` — an in-process sharded composite is
    #: distributed but only this process writes to it
    network_attached: bool = False
    persists: bool = False
    cell_ttl: bool = False
    timestamps: bool = False

    @property
    def scan(self) -> bool:
        return self.ordered_scan or self.unordered_scan


class StoreTransaction:
    """Handle for backend-level transaction state.

    Backends without native transactions use this only to carry config
    (consistency level, timestamps). Commit/rollback are no-ops there.
    """

    def __init__(self, config: Optional[dict] = None):
        self.config = config or {}

    def commit(self) -> None:  # pragma: no cover - trivial
        pass

    def rollback(self) -> None:  # pragma: no cover - trivial
        pass


class KeyColumnValueStore(abc.ABC):
    """One named store of sorted wide rows."""

    @property
    @abc.abstractmethod
    def name(self) -> str:
        ...

    @abc.abstractmethod
    def get_slice(self, query: KeySliceQuery, txh: StoreTransaction) -> EntryList:
        """Return entries of row ``query.key`` with columns in the slice range,
        sorted ascending by column, truncated at ``limit``."""

    def get_slice_multi(
        self, keys: Sequence[bytes], slice_query: SliceQuery, txh: StoreTransaction
    ) -> Dict[bytes, EntryList]:
        """Batched multi-row slice (the multi-query path). Default: loop."""
        return {
            k: self.get_slice(KeySliceQuery(k, slice_query), txh) for k in keys
        }

    @abc.abstractmethod
    def mutate(
        self,
        key: bytes,
        additions: EntryList,
        deletions: Sequence[bytes],
        txh: StoreTransaction,
    ) -> None:
        """Atomically apply additions and deletions to one row. Additions win
        over deletions of the same column within one call."""

    def acquire_lock(
        self, key: bytes, column: bytes, expected_value: Optional[bytes],
        txh: StoreTransaction,
    ) -> None:
        """Claim a lock hint for (key, column); only for stores with native
        locking. Others are wrapped by the consistent-key locker."""
        raise PermanentBackendError(f"store {self.name} does not support native locking")

    @abc.abstractmethod
    def get_keys(
        self, query, txh: StoreTransaction
    ) -> Iterator[Tuple[bytes, EntryList]]:
        """Iterate rows. ``query`` is a SliceQuery (all keys, unordered OK) or a
        KeyRangeQuery (ordered range scan). Yields (key, entries) with entries
        restricted to the query's column slice; rows with no matching entries
        are skipped."""

    def close(self) -> None:  # pragma: no cover - trivial
        pass


class KeyColumnValueStoreManager(abc.ABC):
    """Factory/registry of stores in one backend plus batched cross-store
    mutation (reference: KeyColumnValueStoreManager.java:31)."""

    @property
    @abc.abstractmethod
    def features(self) -> StoreFeatures:
        ...

    @property
    def name(self) -> str:
        return type(self).__name__

    @abc.abstractmethod
    def open_database(self, name: str) -> KeyColumnValueStore:
        ...

    @abc.abstractmethod
    def begin_transaction(self, config: Optional[dict] = None) -> StoreTransaction:
        ...

    @abc.abstractmethod
    def mutate_many(
        self,
        mutations: Dict[str, Dict[bytes, KCVMutation]],
        txh: StoreTransaction,
    ) -> None:
        """Apply mutations across stores: {store_name: {key: KCVMutation}}.

        ``features.batch_mutation`` means the backend accepts the whole batch
        in one call (e.g. one RPC); it does NOT imply cross-row atomicity —
        per-row application is atomic, the batch is not (matching reference
        semantics where only `transactional` backends give batch atomicity).
        """

    def get_local_key_partition(self):
        """Key ranges held locally (region-aware backends); None otherwise."""
        return None

    @abc.abstractmethod
    def close(self) -> None:
        ...

    @abc.abstractmethod
    def clear_storage(self) -> None:
        ...

    def exists(self) -> bool:
        return True


def entries_in_slice(entries: EntryList, q: SliceQuery) -> EntryList:
    """Filter an already-sorted EntryList down to a slice (helper for caches
    answering a narrower query from a wider cached result)."""
    lo = bisect.bisect_left(entries, (q.start, b""))
    hi = len(entries) if q.end is None else bisect.bisect_left(entries, (q.end, b""))
    out = entries[lo:hi]
    if q.limit is not None and len(out) > q.limit:
        out = out[: q.limit]
    return out
