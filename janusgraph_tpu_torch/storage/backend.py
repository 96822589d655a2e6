"""Backend orchestration: opens the named stores and the ID authority, wires
the slice caches and the consistent-key lockers, and builds buffered
backend transactions — the port's copy of
``janusgraph_tpu/storage/backend.py``.

``Backend`` opens ``edgestore``, ``graphindex``, ``system_properties`` (with
the cluster-global config over it) and ``janusgraph_ids``, and tracks the
committed edgestore batches: ``note_edge_mutations`` bumps the mutation
epoch (the one ``load_csr_snapshot`` records), marks each touched row with
it (``touched_since``/``touched_count_since``, what ``refresh_csr``
re-reads; past 1,000,000 rows the tracker resets and records its overflow
epoch) and streams the batch to the registered change capture
(``register_change_capture``, the delta snapshot's feed).
With ``metrics.enabled`` the raw ``edgestore`` and ``graphindex`` are
wrapped in ``MetricInstrumentedStore`` (``util/metrics.py``), and with
``cache.db-cache`` (the default) in an ``ExpirationCacheStore`` over that,
split ``cache.edgestore-fraction`` / the rest between the two. Each store
has a consistent-key locker over its own lock store (``edgestore_lock_``,
``graphindex_lock_``), mediated in-process per store manager.

``BackendTransaction`` buffers writes per store and row and flushes them
as one ``mutate_many`` at commit, after the lock checks (claims verified,
expected values re-read past the cache), then invalidates the cached rows
it wrote. Every read and the flush run under ``Backend.guard``, the retry
guard of ``backend_op.py`` (``storage.retry-time-ms``,
``storage.backoff-*``, ``storage.write-attempts``). ``storage.read-only``
refuses every buffered write and every global-config write.

``BackendTransaction.commit(preflush=...)`` runs the WAL's pre-flush hook
after the lock checks pass and just before the flush, and only when the
transaction has mutations (``core/graph.py`` commit step 6). The logs
(``TXLOG_NAME``, ``SYSTEMLOG_NAME``, ``ulog_<id>``) are stores of the same
manager (``storage/log.py``); the instance registry lives in the global
config (``del_global_config``, ``list_global_config``).

Left out: the id authority's conflict-avoidance modes and the resource
ledger's per-query cell accounting.
"""

from __future__ import annotations

import threading
import uuid
from typing import Dict, List, Optional, Sequence

from janusgraph_tpu_torch.exceptions import PermanentBackendError
from janusgraph_tpu_torch.storage import backend_op
from janusgraph_tpu_torch.storage.cache import ExpirationCacheStore
from janusgraph_tpu_torch.storage.idauthority import (
    ConflictAvoidanceMode,
    ConsistentKeyIDAuthority,
    ID_STORE_NAME,
)
from janusgraph_tpu_torch.storage.kcvs import (
    EntryList,
    KCVMutation,
    KeyColumnValueStoreManager,
    KeySliceQuery,
    SliceQuery,
)

EDGESTORE_NAME = "edgestore"
INDEXSTORE_NAME = "graphindex"
SYSTEM_PROPERTIES_NAME = "system_properties"
TXLOG_NAME = "txlog"
SYSTEMLOG_NAME = "systemlog"
LOCK_STORE_SUFFIX = "_lock_"


class GlobalConfigStore:
    """Cluster-global config over the ``system_properties`` store, usable
    before the full Backend is built (reference: KCVSConfiguration)."""

    _CONFIG_KEY = b"\x00config"

    def __init__(self, manager: KeyColumnValueStoreManager, read_only: bool = False):
        self._store = manager.open_database(SYSTEM_PROPERTIES_NAME)
        self._tx = manager.begin_transaction()
        #: storage.read-only: global-config writes refuse
        self.read_only = read_only

    def _check_writable(self) -> None:
        if self.read_only:
            raise PermanentBackendError("storage.read-only: global config writes refused")

    def set_global_config(self, name: str, value: bytes) -> None:
        self._check_writable()
        self._store.mutate(
            self._CONFIG_KEY, [(name.encode(), value)], [], self._tx
        )

    def get_global_config(self, name: str) -> Optional[bytes]:
        col = name.encode()
        entries = self._store.get_slice(
            KeySliceQuery(self._CONFIG_KEY, SliceQuery(col, col + b"\x00")),
            self._tx,
        )
        return entries[0][1] if entries else None

    def del_global_config(self, name: str) -> None:
        self._check_writable()
        self._store.mutate(self._CONFIG_KEY, [], [name.encode()], self._tx)

    def list_global_config(self, prefix: str = "") -> List[str]:
        p = prefix.encode()
        end = (p + b"\xff") if p else None
        entries = self._store.get_slice(
            KeySliceQuery(self._CONFIG_KEY, SliceQuery(p, end)),
            self._tx,
        )
        return [col.decode() for col, _ in entries]


class Backend:
    """Owns the store manager and the named stores of one graph."""

    def __init__(
        self,
        manager: KeyColumnValueStoreManager,
        cache_enabled: bool = True,
        cache_size: int = 65536,
        id_block_size: int = 10_000,
        id_conflict_mode: str = "none",
        id_conflict_tag: int = 0,
        id_conflict_tag_bits: int = 4,
        id_max_retries: int = 20,
        cache_ttl_seconds: Optional[float] = 10.0,
        cache_clean_wait_seconds: float = 0.0,
        metrics_enabled: bool = False,
        metrics_merge_stores: bool = False,
        edgestore_cache_fraction: float = 0.8,
        read_only: bool = False,
        retry_time_s: float = 10.0,
        backoff_base_s: Optional[float] = None,
        backoff_max_s: Optional[float] = None,
        retry_attempts: int = 0,
    ):
        self.manager = manager
        self.metrics_enabled = metrics_enabled
        #: storage.read-only: every mutation through this backend raises
        self.read_only = read_only
        #: the retry guard's shape for this backend's read and flush paths
        self.retry_time_s = retry_time_s
        self.backoff_base_s = backoff_base_s
        self.backoff_max_s = backoff_max_s
        self.retry_attempts = retry_attempts
        self._base_tx = manager.begin_transaction()
        edgestore = manager.open_database(EDGESTORE_NAME)
        indexstore = manager.open_database(INDEXSTORE_NAME)
        if metrics_enabled:
            # instrument the raw stores, before the cache layer, so cache
            # hits show as the gap between the tx-level and store-level
            # counts (as the reference does)
            from janusgraph_tpu_torch.util.metrics import MetricInstrumentedStore

            edgestore = MetricInstrumentedStore(edgestore, merge_stores=metrics_merge_stores)
            indexstore = MetricInstrumentedStore(indexstore, merge_stores=metrics_merge_stores)
        if cache_enabled:
            f = edgestore_cache_fraction
            edgestore = ExpirationCacheStore(
                edgestore, max(1, int(cache_size * f)),
                ttl_seconds=cache_ttl_seconds,
                clean_wait_seconds=cache_clean_wait_seconds,
            )
            indexstore = ExpirationCacheStore(
                indexstore, max(1, int(cache_size * (1.0 - f))),
                ttl_seconds=cache_ttl_seconds,
                clean_wait_seconds=cache_clean_wait_seconds,
            )
        self.edgestore = edgestore
        self.indexstore = indexstore
        self.system_properties = manager.open_database(SYSTEM_PROPERTIES_NAME)
        self.global_config = GlobalConfigStore(manager, read_only=read_only)
        self.id_store = manager.open_database(ID_STORE_NAME)
        self.id_authority = ConsistentKeyIDAuthority(
            self.id_store, self._base_tx, block_size=id_block_size,
            conflict_mode=ConflictAvoidanceMode(id_conflict_mode),
            conflict_tag=id_conflict_tag,
            conflict_tag_bits=id_conflict_tag_bits,
            max_retries=id_max_retries,
            read_only=read_only,
        )
        #: mutation-epoch tracker: edgestore row key -> epoch of its last
        #: committed mutation (refresh_csr re-reads only these rows)
        self._mutation_epochs: Dict[bytes, int] = {}
        self._epoch = 0
        self._epoch_lock = threading.Lock()
        #: past this many rows the tracker resets and records the overflow
        #: epoch; snapshots older than that must reload in full
        self._epoch_track_limit = 1_000_000
        self._overflow_epoch = 0
        #: the delta snapshot's change-capture sink (register_change_capture)
        self._change_capture = None
        # consistent-key lockers over dedicated lock stores, one in-process
        # mediator per store manager
        from janusgraph_tpu_torch.storage.locking import ConsistentKeyLocker, mediator_for

        self.rid = uuid.uuid4().bytes[:8]
        mediator = mediator_for(manager)
        self.edge_locker = ConsistentKeyLocker(
            manager.open_database(EDGESTORE_NAME + LOCK_STORE_SUFFIX),
            manager.begin_transaction, self.rid, mediator,
        )
        self.index_locker = ConsistentKeyLocker(
            manager.open_database(INDEXSTORE_NAME + LOCK_STORE_SUFFIX),
            manager.begin_transaction, self.rid, mediator,
        )

    def clear_caches(self) -> None:
        """Drop every cached slice (what a schema change evicts)."""
        for store in (self.edgestore, self.indexstore):
            if isinstance(store, ExpirationCacheStore):
                store.invalidate_all()

    def configure_lockers(
        self, wait_ms: float, expiry_ms: float, retries: int,
        clean_expired: bool = False,
    ) -> None:
        for locker in (self.edge_locker, self.index_locker):
            locker.wait_ms = wait_ms
            locker.expiry_ms = expiry_ms
            locker.retries = retries
            locker.clean_expired = clean_expired

    def begin_transaction(self, config: Optional[dict] = None) -> "BackendTransaction":
        return BackendTransaction(self, self.manager.begin_transaction(config))

    # -- mutation-epoch tracking --------------------------------------------
    def note_edge_mutations(self, keys, mutations=None) -> None:
        """One committed edgestore batch: bump the epoch, mark its rows and
        hand the batch to the change capture (under the epoch lock, so
        batches reach it in epoch order)."""
        with self._epoch_lock:
            self._epoch += 1
            e = self._epoch
            for key in keys:
                self._mutation_epochs[key] = e
            if len(self._mutation_epochs) > self._epoch_track_limit:
                self._mutation_epochs.clear()
                self._overflow_epoch = e
            if self._change_capture is not None and mutations is not None:
                self._change_capture(e, mutations)

    def mutation_epoch(self) -> int:
        """Monotonic counter bumped per committed edgestore batch."""
        with self._epoch_lock:
            return self._epoch

    def touched_since(self, epoch: int) -> Optional[List[bytes]]:
        """Edgestore row keys mutated after ``epoch``, or None when the
        tracker overflowed past it (the caller must reload in full)."""
        with self._epoch_lock:
            if epoch < self._overflow_epoch:
                return None
            return [k for k, e in self._mutation_epochs.items() if e > epoch]

    def touched_count_since(self, epoch: int) -> Optional[int]:
        """How many distinct rows were mutated after ``epoch`` (None =
        overflow)."""
        with self._epoch_lock:
            if epoch < self._overflow_epoch:
                return None
            return sum(1 for e in self._mutation_epochs.values() if e > epoch)

    def register_change_capture(self, callback) -> None:
        """Register the change-capture sink: called with (epoch, edgestore
        row mutations) for every committed batch."""
        with self._epoch_lock:
            self._change_capture = callback

    # -- global config on system_properties ---------------------------------
    def set_global_config(self, name: str, value: bytes) -> None:
        self.global_config.set_global_config(name, value)

    def get_global_config(self, name: str) -> Optional[bytes]:
        return self.global_config.get_global_config(name)

    def del_global_config(self, name: str) -> None:
        self.global_config.del_global_config(name)

    def list_global_config(self, prefix: str = "") -> List[str]:
        return self.global_config.list_global_config(prefix)

    def guard(self, op):
        """Run one backend operation under this backend's retry guard."""
        return backend_op.execute(
            op,
            max_time_s=self.retry_time_s,
            base_delay_s=self.backoff_base_s,
            max_delay_s=self.backoff_max_s,
            max_attempts=self.retry_attempts,
        )

    def close(self) -> None:
        self.edgestore.close()
        self.indexstore.close()
        self.manager.close()

    def clear(self) -> None:
        self.manager.clear_storage()


class BackendTransaction:
    """Multiplexes reads over the backend stores and buffers writes until
    commit, flushing them as one batched mutate_many
    (reference: BackendTransaction.java + CacheTransaction.java)."""

    def __init__(self, backend: Backend, store_tx):
        self.backend = backend
        self.store_tx = store_tx
        self._mutations: Dict[str, Dict[bytes, KCVMutation]] = {}
        self._lock = threading.Lock()
        self._open = True
        # the request's resource ledger counts cells here for a manager
        # that does not count its own (the remote store's client counts at
        # the wire, and counting again here would double every cell)
        self._ledger_local = not getattr(backend.manager, "ledger_self_accounting", False)

    def _accrue_read(self, *entry_lists: EntryList) -> None:
        if self._ledger_local:
            from janusgraph_tpu_torch.observability.profiler import accrue, current_ledger

            if current_ledger() is not None:
                accrue(cells_read=sum(map(len, entry_lists)),
                       bytes_read=sum(len(c) + len(v) for es in entry_lists for c, v in es))

    # ----------------------------------------------------------------- reads
    # each read rides Backend.guard: temporary failures replay with
    # jittered backoff instead of surfacing into the transaction layer
    def edge_store_query(self, query: KeySliceQuery) -> EntryList:
        entries = self.backend.guard(
            lambda: self.backend.edgestore.get_slice(query, self.store_tx)
        )
        self._accrue_read(entries)
        return entries

    def edge_store_multi_query(
        self, keys: Sequence[bytes], slice_query: SliceQuery
    ) -> Dict[bytes, EntryList]:
        res = self.backend.guard(
            lambda: self.backend.edgestore.get_slice_multi(keys, slice_query, self.store_tx)
        )
        self._accrue_read(*res.values())
        return res

    def index_query(self, query: KeySliceQuery) -> EntryList:
        entries = self.backend.guard(
            lambda: self.backend.indexstore.get_slice(query, self.store_tx)
        )
        self._accrue_read(entries)
        return entries

    def index_query_uncached(self, query: KeySliceQuery) -> EntryList:
        """Past the slice cache: claim-time reads that back lock
        expectations must not see TTL-stale rows."""
        store = self.backend.indexstore
        if isinstance(store, ExpirationCacheStore):
            store = store.wrapped
        entries = self.backend.guard(lambda: store.get_slice(query, self.store_tx))
        self._accrue_read(entries)
        return entries

    # ---------------------------------------------------------------- writes
    def _buffer(self, store: str, key: bytes, additions: EntryList, deletions: Sequence[bytes]):
        if self.backend.read_only:
            raise PermanentBackendError(
                "storage.read-only: the backend was opened read-only"
            )
        with self._lock:
            rows = self._mutations.setdefault(store, {})
            m = rows.setdefault(key, KCVMutation())
            m.merge(KCVMutation(additions=list(additions), deletions=list(deletions)))

    def mutate_edges(self, key: bytes, additions: EntryList, deletions: Sequence[bytes]):
        self._buffer(EDGESTORE_NAME, key, additions, deletions)

    def mutate_index(self, key: bytes, additions: EntryList, deletions: Sequence[bytes]):
        self._buffer(INDEXSTORE_NAME, key, additions, deletions)

    def has_mutations(self) -> bool:
        return any(
            not m.is_empty() for rows in self._mutations.values() for m in rows.values()
        )

    # ----------------------------------------------------------------- locks
    def acquire_edge_lock(self, key: bytes, column: bytes, expected=None) -> None:
        from janusgraph_tpu_torch.storage.locking import KeyColumn

        self.backend.edge_locker.write_lock(KeyColumn(key, column), self, expected)

    def acquire_index_lock(self, key: bytes, column: bytes, expected=None) -> None:
        """An index-cell lock: the commit takes one on the row of every
        value it claims in a unique composite index, with the slice it
        observed as the expected value."""
        from janusgraph_tpu_torch.storage.locking import KeyColumn

        self.backend.index_locker.write_lock(KeyColumn(key, column), self, expected)

    def _check_and_release_locks(self, commit: bool) -> None:
        be = self.backend
        try:
            if commit:
                for locker, store in (
                    (be.edge_locker, be.edgestore),
                    (be.index_locker, be.indexstore),
                ):
                    if not locker.held_by(self):
                        continue
                    # expected-value reads see the real store, never a
                    # possibly stale slice cache
                    if isinstance(store, ExpirationCacheStore):
                        store = store.wrapped
                    locker.check_locks(self)
                    locker.check_expected_values(
                        self,
                        lambda t, _s=store: be.guard(
                            lambda: _s.get_slice(
                                KeySliceQuery(
                                    t.key, SliceQuery(t.column, t.column + b"\x00"),
                                ),
                                self.store_tx,
                            )
                        ),
                    )
        except Exception:
            be.edge_locker.delete_locks(self)
            be.index_locker.delete_locks(self)
            raise

    # ---------------------------------------------------------------- commit
    def commit(self, preflush=None) -> None:
        """``preflush``: the WAL's hook, called after the lock checks pass
        and just before the batched flush, the point past which a crash can
        tear the batch (``core/graph.py`` commit step 6)."""
        if not self._open:
            return
        try:
            self._check_and_release_locks(commit=True)
            if preflush is not None and self.has_mutations():
                preflush()
            if self._mutations and self._ledger_local:
                from janusgraph_tpu_torch.observability.profiler import accrue, current_ledger

                if current_ledger() is not None:
                    muts = [m for rows in self._mutations.values() for m in rows.values()]
                    accrue(
                        cells_written=sum(len(m.additions) + len(m.deletions) for m in muts),
                        bytes_written=sum(len(e[0]) + len(e[1]) for m in muts for e in m.additions),
                    )
            if self._mutations:
                flush = lambda: self.backend.manager.mutate_many(  # noqa: E731
                    self._mutations, self.store_tx
                )
                if self.backend.metrics_enabled:
                    # batched writes bypass the per-store wrapper, so they
                    # are timed here
                    from janusgraph_tpu_torch.util.metrics import metrics

                    with metrics.time("storage.mutateMany"):
                        self.backend.guard(flush)
                    for store_name, rows in self._mutations.items():
                        # graphlint: disable=JG110 -- store names are the fixed schema-declared store set (edgestore/indexstore/system)
                        metrics.counter(f"storage.{store_name}.mutate.rows").inc(len(rows))
                else:
                    self.backend.guard(flush)
                edge_rows = self._mutations.get(EDGESTORE_NAME)
                if edge_rows:
                    self.backend.note_edge_mutations(edge_rows.keys(), edge_rows)
                # invalidate the cached slices of every written row
                for store_name, rows in self._mutations.items():
                    store = {
                        EDGESTORE_NAME: self.backend.edgestore,
                        INDEXSTORE_NAME: self.backend.indexstore,
                    }.get(store_name)
                    if isinstance(store, ExpirationCacheStore):
                        for key in rows:
                            store.invalidate(key)
                self._mutations = {}
            self.store_tx.commit()
        finally:
            self.backend.edge_locker.delete_locks(self)
            self.backend.index_locker.delete_locks(self)
            self._open = False

    def rollback(self) -> None:
        self._mutations = {}
        self.backend.edge_locker.delete_locks(self)
        self.backend.index_locker.delete_locks(self)
        self.store_tx.rollback()
        self._open = False
