"""Backend orchestration: opens the named stores and the ID authority, and
builds buffered backend transactions — the port's copy of
``janusgraph_tpu/storage/backend.py``.

``Backend`` opens ``edgestore``, ``graphindex``, ``system_properties`` (with
the cluster-global config over it) and ``janusgraph_ids``, and counts the
committed edgestore batches (``mutation_epoch``/``note_edge_mutations``),
the epoch ``load_csr_snapshot`` records. ``BackendTransaction`` buffers writes per
store and row and flushes them as one ``mutate_many`` at commit.

Left out: the slice caches, the consistent-key lockers and lock stores,
metrics, the read-only mode, the retry guard around each storage call,
and the per-row epochs, ``touched_since`` and the change-capture sink
(they come with ``refresh_csr`` and the delta capture side, ROADMAP
Queue A #2).
"""

from __future__ import annotations

import threading
from typing import Dict, Optional, Sequence

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
    ):
        self.manager = manager
        self._base_tx = manager.begin_transaction()
        self.edgestore = manager.open_database(EDGESTORE_NAME)
        self.indexstore = manager.open_database(INDEXSTORE_NAME)
        self.system_properties = manager.open_database(SYSTEM_PROPERTIES_NAME)
        self.global_config = GlobalConfigStore(manager)
        self.id_store = manager.open_database(ID_STORE_NAME)
        self.id_authority = ConsistentKeyIDAuthority(
            self.id_store, self._base_tx, block_size=id_block_size,
        )
        #: committed edgestore batches; load_csr_snapshot records the epoch
        #: it saw before its scan
        self._epoch = 0
        self._epoch_lock = threading.Lock()

    def begin_transaction(self, config: Optional[dict] = None) -> "BackendTransaction":
        return BackendTransaction(self, self.manager.begin_transaction(config))

    # -- mutation-epoch tracking --------------------------------------------
    def note_edge_mutations(self) -> None:
        with self._epoch_lock:
            self._epoch += 1

    def mutation_epoch(self) -> int:
        """Monotonic counter bumped per committed edgestore batch."""
        with self._epoch_lock:
            return self._epoch

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
                self.backend.manager.mutate_many(self._mutations, self.store_tx)
                if self._mutations.get(EDGESTORE_NAME):
                    self.backend.note_edge_mutations()
                self._mutations = {}
            self.store_tx.commit()
        finally:
            self._open = False

    def rollback(self) -> None:
        self._mutations = {}
        self.store_tx.rollback()
        self._open = False
