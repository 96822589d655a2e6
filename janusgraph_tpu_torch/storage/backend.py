"""Backend orchestration: opens the named stores and the ID authority, and
builds buffered backend transactions — the port's copy of
``janusgraph_tpu/storage/backend.py``.

``Backend`` opens ``edgestore``, ``graphindex``, ``system_properties`` (with
the cluster-global config over it) and ``janusgraph_ids``, and tracks the
committed edgestore batches: ``note_edge_mutations`` bumps the mutation
epoch (the one ``load_csr_snapshot`` records), marks each touched row with
it (``touched_since``/``touched_count_since``, what ``refresh_csr``
re-reads; past 1,000,000 rows the tracker resets and records its overflow
epoch) and streams the batch to the registered change capture
(``register_change_capture``, the delta snapshot's feed).
``BackendTransaction`` buffers writes per store and row and flushes them
as one ``mutate_many`` at commit. With ``metrics.enabled`` the raw
``edgestore`` and ``graphindex`` are wrapped in ``MetricInstrumentedStore``
(``util/metrics.py``) and a commit's batched write is timed as
``storage.mutateMany`` with ``storage.<store>.mutate.rows`` counted, as the
reference does.

Left out: the slice caches (the reference wraps its stores in them after
the metrics), the consistent-key lockers and lock stores, the read-only
mode and the retry guard around each storage call (ROADMAP Queue A #5).
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Sequence

from janusgraph_tpu_torch.storage.idauthority import (
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


class GlobalConfigStore:
    """Cluster-global config over the ``system_properties`` store, usable
    before the full Backend is built (reference: KCVSConfiguration)."""

    _CONFIG_KEY = b"\x00config"

    def __init__(self, manager: KeyColumnValueStoreManager):
        self._store = manager.open_database(SYSTEM_PROPERTIES_NAME)
        self._tx = manager.begin_transaction()

    def set_global_config(self, name: str, value: bytes) -> None:
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


class Backend:
    """Owns the store manager and the named stores of one graph."""

    def __init__(
        self,
        manager: KeyColumnValueStoreManager,
        id_block_size: int = 10_000,
        metrics_enabled: bool = False,
        metrics_merge_stores: bool = False,
    ):
        self.manager = manager
        self.metrics_enabled = metrics_enabled
        self._base_tx = manager.begin_transaction()
        self.edgestore = manager.open_database(EDGESTORE_NAME)
        self.indexstore = manager.open_database(INDEXSTORE_NAME)
        if metrics_enabled:
            # instrument the raw stores (before any cache layer, as the
            # reference does)
            from janusgraph_tpu_torch.util.metrics import MetricInstrumentedStore

            self.edgestore = MetricInstrumentedStore(self.edgestore, merge_stores=metrics_merge_stores)
            self.indexstore = MetricInstrumentedStore(self.indexstore, merge_stores=metrics_merge_stores)
        self.system_properties = manager.open_database(SYSTEM_PROPERTIES_NAME)
        self.global_config = GlobalConfigStore(manager)
        self.id_store = manager.open_database(ID_STORE_NAME)
        self.id_authority = ConsistentKeyIDAuthority(
            self.id_store, self._base_tx, block_size=id_block_size,
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

    # ----------------------------------------------------------------- reads
    def edge_store_query(self, query: KeySliceQuery) -> EntryList:
        return self.backend.edgestore.get_slice(query, self.store_tx)

    def edge_store_multi_query(
        self, keys: Sequence[bytes], slice_query: SliceQuery
    ) -> Dict[bytes, EntryList]:
        return self.backend.edgestore.get_slice_multi(keys, slice_query, self.store_tx)

    def index_query(self, query: KeySliceQuery) -> EntryList:
        return self.backend.indexstore.get_slice(query, self.store_tx)

    # ---------------------------------------------------------------- writes
    def _buffer(self, store: str, key: bytes, additions: EntryList, deletions: Sequence[bytes]):
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

    # ---------------------------------------------------------------- commit
    def commit(self) -> None:
        if not self._open:
            return
        try:
            if self._mutations:
                if self.backend.metrics_enabled:
                    # batched writes bypass the per-store wrapper, so they
                    # are timed here
                    from janusgraph_tpu_torch.util.metrics import metrics

                    with metrics.time("storage.mutateMany"):
                        self.backend.manager.mutate_many(self._mutations, self.store_tx)
                    for store_name, rows in self._mutations.items():
                        metrics.counter(f"storage.{store_name}.mutate.rows").inc(len(rows))
                else:
                    self.backend.manager.mutate_many(self._mutations, self.store_tx)
                edge_rows = self._mutations.get(EDGESTORE_NAME)
                if edge_rows:
                    self.backend.note_edge_mutations(edge_rows.keys(), edge_rows)
                self._mutations = {}
            self.store_tx.commit()
        finally:
            self._open = False

    def rollback(self) -> None:
        self._mutations = {}
        self.store_tx.rollback()
        self._open = False
