"""Sharded store manager — the port's copy of
``janusgraph_tpu/storage/sharded_store.py`` (the CQL analogue).

Keys hash onto N child store managers ("nodes"; in-memory by default, any
manager through ``node_factory``): ``_shard_of`` is the first 4 bytes of
a key's blake2b digest, big-endian, modulo N, so every key lands on the
node the reference puts it on. Reads route to one node, a multi-slice
groups its keys by node, ``mutate_many`` sends one batch per node, and
``get_keys`` is an unordered scan (node 0's rows, then node 1's, ...); an
ordered ``KeyRangeQuery`` raises ``PermanentBackendError``, as the
reference's does. ``fail_node(i)`` makes node i raise
``TemporaryBackendError`` until ``heal_node(i)``.

Open it with ``storage.backend = "sharded"`` and ``storage.sharded-nodes``
(default 3), or serve it over TCP with ``python -m janusgraph_tpu_torch
storage-server --sharded-nodes N``.
"""

from __future__ import annotations

import hashlib
from typing import Callable, Dict, Iterator, List, Optional, Sequence, Tuple

from janusgraph_tpu_torch.exceptions import PermanentBackendError, TemporaryBackendError
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
from janusgraph_tpu_torch.storage.inmemory import InMemoryStoreManager


def _shard_of(key: bytes, n: int) -> int:
    # stable content hash (NOT Python hash()) so placement survives restarts
    return int.from_bytes(hashlib.blake2b(key, digest_size=4).digest(), "big") % n


class ShardedKCVStore(KeyColumnValueStore):
    def __init__(self, manager: "ShardedStoreManager", name: str):
        self._manager = manager
        self._name = name
        self._children: List[KeyColumnValueStore] = [
            m.open_database(name) for m in manager.nodes
        ]

    @property
    def name(self) -> str:
        return self._name

    def _child(self, key: bytes) -> KeyColumnValueStore:
        i = _shard_of(key, len(self._children))
        self._manager._check_up(i)
        return self._children[i]

    def get_slice(self, query: KeySliceQuery, txh: StoreTransaction) -> EntryList:
        return self._child(query.key).get_slice(query, txh)

    def get_slice_multi(self, keys, slice_query, txh):
        out: Dict[bytes, EntryList] = {}
        by_child: Dict[int, List[bytes]] = {}
        for k in keys:
            by_child.setdefault(_shard_of(k, len(self._children)), []).append(k)
        for i, ks in by_child.items():
            self._manager._check_up(i)
            out.update(self._children[i].get_slice_multi(ks, slice_query, txh))
        return out

    def mutate(self, key, additions, deletions, txh) -> None:
        self._child(key).mutate(key, additions, deletions, txh)

    def get_keys(self, query, txh) -> Iterator[Tuple[bytes, EntryList]]:
        if isinstance(query, KeyRangeQuery):
            raise PermanentBackendError(
                "sharded store supports unordered scans only "
                "(reference: CQL token-range getKeys)"
            )
        for i, child in enumerate(self._children):
            self._manager._check_up(i)
            yield from child.get_keys(query, txh)


class ShardedStoreManager(KeyColumnValueStoreManager):
    """Hash-partitioned composite of N child KCVS managers."""

    def __init__(
        self,
        num_nodes: int = 3,
        node_factory: Optional[Callable[[int], KeyColumnValueStoreManager]] = None,
        config: Optional[dict] = None,
    ):
        factory = node_factory or (lambda i: InMemoryStoreManager())
        self.nodes: List[KeyColumnValueStoreManager] = [
            factory(i) for i in range(num_nodes)
        ]
        self._down: set = set()
        self._stores: Dict[str, ShardedKCVStore] = {}

    # ----------------------------------------------------- failure injection
    def fail_node(self, i: int) -> None:
        self._down.add(i)

    def heal_node(self, i: int) -> None:
        self._down.discard(i)

    def _check_up(self, i: int) -> None:
        if i in self._down:
            raise TemporaryBackendError(f"node {i} unavailable")

    # ----------------------------------------------------------------- SPI
    @property
    def features(self) -> StoreFeatures:
        return StoreFeatures(
            unordered_scan=True,
            multi_query=True,
            batch_mutation=True,
            key_consistent=True,
            distributed=True,
            persists=any(m.features.persists for m in self.nodes),
            # a composite over network clients crosses the trust boundary
            # wherever any node does (drives the allow-pickle=auto guard)
            network_attached=any(
                m.features.network_attached for m in self.nodes
            ),
        )

    @property
    def name(self) -> str:
        return f"sharded({len(self.nodes)}x{type(self.nodes[0]).__name__})"

    @property
    def ledger_self_accounting(self) -> bool:
        """A composite of remote clients accounts cells at the wire; only
        when EVERY node does is BackendTransaction counting redundant."""
        return all(
            getattr(m, "ledger_self_accounting", False) for m in self.nodes
        )

    def open_database(self, name: str) -> ShardedKCVStore:
        if name not in self._stores:
            self._stores[name] = ShardedKCVStore(self, name)
        return self._stores[name]

    def begin_transaction(self, config: Optional[dict] = None) -> StoreTransaction:
        return StoreTransaction(config)

    def mutate_many(
        self,
        mutations: Dict[str, Dict[bytes, KCVMutation]],
        txh: StoreTransaction,
    ) -> None:
        # group by child node, delegate one batched call each (the analogue
        # of CQL's per-node async batch futures, CQLStoreManager.java:446-510)
        per_node: Dict[int, Dict[str, Dict[bytes, KCVMutation]]] = {}
        for store_name, rows in mutations.items():
            for key, mut in rows.items():
                i = _shard_of(key, len(self.nodes))
                per_node.setdefault(i, {}).setdefault(store_name, {})[key] = mut
        for i, node_muts in per_node.items():
            self._check_up(i)
            self.nodes[i].mutate_many(node_muts, txh)

    def get_local_key_partition(self):
        return None

    def close(self) -> None:
        for m in self.nodes:
            m.close()

    def clear_storage(self) -> None:
        for m in self.nodes:
            m.clear_storage()

    def exists(self) -> bool:
        return any(m.exists() for m in self.nodes)
