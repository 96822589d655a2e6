"""The graph: open, wiring, ID assignment and schema persistence — the
port's copy of the part of ``janusgraph_tpu/core/graph.py`` that the
stored-graph OLAP path runs.

``open_graph(config, store_manager=None)`` opens a ``JanusGraphTPU`` over
an in-memory store (or over ``store_manager``, e.g.
``InMemoryStoreManager.from_rows`` of a graph the JAX package wrote). It
holds ``config``, ``backend``, ``idm``, ``serializer``,
``edge_serializer``, ``system_types``, ``schema_cache`` and ``id_assigner``
(vertex, relation and schema id pools), and offers ``management()``,
``compute()`` and ``close()``. Data goes in through ``core/bulk.py`` and
out through ``load_csr`` and ``ComputerResult.write_back``.

Left out (ROADMAP Queue A #5): OLTP transactions and the traversal
(``new_transaction``, ``traversal``), indexes and index providers, the
WAL, logs and schema broadcast, the instance registry, fault injection,
metrics reporters and the other store backends.
"""

from __future__ import annotations

import struct
import threading
from typing import Dict, Optional

from janusgraph_tpu_torch.core.attributes import Serializer
from janusgraph_tpu_torch.core.codecs import EdgeSerializer
from janusgraph_tpu_torch.core.config import GraphConfiguration
from janusgraph_tpu_torch.core.ids import IDManager, VertexIDType
from janusgraph_tpu_torch.core.management import (
    SCHEMA_NAME_INDEX_PREFIX,
    ManagementSystem,
)
from janusgraph_tpu_torch.core.schema import (
    SchemaCache,
    SystemTypes,
    decode_definition,
    encode_definition,
    schema_element_from_definition,
)
from janusgraph_tpu_torch.storage.backend import Backend, GlobalConfigStore
from janusgraph_tpu_torch.storage.idauthority import (
    ConsistentKeyIDAuthority,
    StandardIDPool,
)
from janusgraph_tpu_torch.storage.inmemory import InMemoryStoreManager
from janusgraph_tpu_torch.storage.kcvs import KeySliceQuery, SliceQuery


def open_graph(config: Optional[dict] = None, store_manager=None) -> "JanusGraphTPU":
    """JanusGraphFactory.open equivalent."""
    return JanusGraphTPU(config, store_manager=store_manager)


class VertexIDAssigner:
    """Maps new elements to IDs: round-robin partition placement for normal
    vertices, canonical-partition ids for partitioned (vertex-cut) labels
    (reference: idassigner/VertexIDAssigner.java)."""

    def __init__(
        self,
        authority: ConsistentKeyIDAuthority,
        idm: IDManager,
        renew_fraction: Optional[float] = None,
    ):
        self.authority = authority
        self.idm = idm
        self.renew_fraction = renew_fraction  # ids.renew-percentage
        self._vertex_pools: Dict[int, StandardIDPool] = {}
        self._relation_pool = StandardIDPool(
            authority, ConsistentKeyIDAuthority.NS_RELATION, 0,
            renew_fraction=renew_fraction,
        )
        self._schema_pool = StandardIDPool(
            authority, ConsistentKeyIDAuthority.NS_SCHEMA, 0,
            renew_fraction=renew_fraction,
        )
        self._rr = 0
        self._lock = threading.Lock()

    def _pool(self, partition: int) -> StandardIDPool:
        with self._lock:
            pool = self._vertex_pools.get(partition)
            if pool is None:
                pool = StandardIDPool(
                    self.authority, ConsistentKeyIDAuthority.NS_VERTEX, partition,
                    renew_fraction=self.renew_fraction,
                )
                self._vertex_pools[partition] = pool
            return pool

    def assign_vertex_id(self, partitioned: bool = False) -> int:
        with self._lock:
            partition = self._rr % self.idm.num_partitions
            self._rr += 1
        count = self._pool(partition).next_id()
        if partitioned:
            canonical = count % self.idm.num_partitions
            return self.idm.make_vertex_id(
                count, canonical, VertexIDType.PARTITIONED
            )
        return self.idm.make_vertex_id(count, partition)

    def assign_relation_id(self) -> int:
        return self.idm.make_relation_id(self._relation_pool.next_id())

    def assign_relation_ids(self, count: int):
        """Bulk relation-id spans for columnar writers: [(start, len), ...]."""
        return self._relation_pool.next_ids(count)

    def assign_schema_id(self, id_type: VertexIDType) -> int:
        return self.idm.make_schema_id(id_type, self._schema_pool.next_id())


class JanusGraphTPU:
    def __init__(self, config: Optional[dict] = None, store_manager=None):
        self.config = GraphConfiguration(dict(config or {}))
        cfg = self.config
        if store_manager is None:
            # only "inmemory" passes the option's check
            store_manager = InMemoryStoreManager()
        self.serializer = Serializer()
        # reconcile cluster-global options BEFORE building the backend so
        # stored GLOBAL/FIXED values govern its construction
        cfg.attach_backend(GlobalConfigStore(store_manager))
        self.backend = Backend(store_manager, id_block_size=cfg.get("ids.block-size"))
        self.idm = IDManager(partition_bits=cfg.get("ids.partition-bits"))
        self.edge_serializer = EdgeSerializer(self.serializer, self.idm)
        self.system_types = SystemTypes(self.idm)
        self.backend.id_authority.wait_ms = cfg.get("ids.authority-wait-ms")
        self.id_assigner = VertexIDAssigner(
            self.backend.id_authority, self.idm,
            renew_fraction=cfg.get("ids.renew-percentage"),
        )
        self.schema_cache = SchemaCache(
            self._load_schema_by_name, self._load_schema_by_id
        )
        #: relation-type index ids (no relation indexes in the port)
        self.relation_index_ids = frozenset()
        self._open = True

    # ------------------------------------------------------------- lifecycle
    def management(self) -> ManagementSystem:
        return ManagementSystem(self)

    def compute(self, executor: str = None):
        """OLAP entry point (reference: JanusGraph.compute()). Defaults the
        executor to the computer.executor config option: "tpu", the card;
        "cpu", the plain versions on the CPU."""
        from janusgraph_tpu_torch.olap.computer import GraphComputer

        return GraphComputer(self, executor=executor)

    def close(self) -> None:
        if self._open:
            self.backend.close()
            self._open = False

    # ------------------------------------------------------ schema persistence
    def persist_schema_element(self, el) -> None:
        es = self.edge_serializer
        st = self.system_types
        btx = self.backend.begin_transaction()
        key = self.idm.get_key(el.id)
        rid = self.id_assigner.assign_relation_id
        adds = [
            es.write_property(st.EXISTS, rid(), True),
            es.write_property(st.SCHEMA_NAME, rid(), el.name),
            es.write_property(
                st.SCHEMA_DEF, rid(), encode_definition(el.definition())
            ),
        ]
        btx.mutate_edges(key, adds, [])
        # name -> id lookup row
        btx.mutate_index(
            SCHEMA_NAME_INDEX_PREFIX + el.name.encode(),
            [(struct.pack(">Q", el.id), b"")],
            [],
        )
        btx.commit()
        self.schema_cache.invalidate(el.name)

    def _load_schema_by_name(self, name: str):
        btx = self.backend.begin_transaction()
        entries = btx.index_query(
            KeySliceQuery(SCHEMA_NAME_INDEX_PREFIX + name.encode(), SliceQuery())
        )
        if not entries:
            return None
        (sid,) = struct.unpack(">Q", entries[0][0])
        return self._load_schema_by_id(sid)

    def _load_schema_by_id(self, sid: int):
        es = self.edge_serializer
        st = self.system_types
        btx = self.backend.begin_transaction()
        key = self.idm.get_key(sid)
        name = None
        definition = None
        for q, want in (
            (es.get_type_slice(st.SCHEMA_NAME, False), "name"),
            (es.get_type_slice(st.SCHEMA_DEF, False), "def"),
        ):
            entries = btx.edge_store_query(KeySliceQuery(key, q))
            if not entries:
                return None
            rc = es.parse_relation(entries[0], st.type_info)
            if want == "name":
                name = rc.value
            else:
                definition = decode_definition(rc.value)
        return schema_element_from_definition(sid, name, definition)
