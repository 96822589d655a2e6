"""Schema management — the port's copy of the makers and type modifiers of
``janusgraph_tpu/core/management.py``: ``make_property_key``,
``make_edge_label``, ``make_vertex_label``, the consistency modifier
(``set_consistency``/``get_consistency``), time-to-live
(``set_ttl``/``get_ttl``) and the schema constraints (``add_properties``,
``add_connection``), each persisted through
``graph.persist_schema_element``. Each schema operation commits on its
own, as in the reference. A changed element is evicted from this
instance's caches and the eviction is broadcast over the management log
to every open instance (``graph.schema_changed``);
``broadcast_eviction(schema_id)`` does so and waits for every open
instance's acknowledgement (``schema.eviction-ack-timeout-ms``).

Cluster options and instances: ``get_config``, ``set_config`` (a GLOBAL or
GLOBAL_OFFLINE option, through ``GraphConfiguration.set_global``),
``open_instances`` and ``force_close_instance``.

Indexes: ``build_composite_index``, ``build_mixed_index`` and
``add_index_key`` (graph indexes, registered under ``INDEX_REGISTRY_KEY``
and named in their own namespace), ``build_edge_index``,
``reindex_relation_index`` and ``set_relation_index_status`` (vertex-centric
relation indexes), and the lifecycle ``update_index`` (REGISTER / REINDEX /
ENABLE / DISABLE / REMOVE), ``await_graph_index_status``, ``reindex`` (the
``IndexRepairJob`` over the scan framework, ``olap/jobs.py``) and
``ghost_vertex_removal``. The enumeration: ``get``, ``contains``,
``property_keys``, ``edge_labels``, ``vertex_labels``, ``indexes`` and
``print_schema``.
"""

from __future__ import annotations

import dataclasses
import struct
import time
from enum import Enum
from typing import List, Optional, Sequence

from janusgraph_tpu_torch.core.codecs import (
    Cardinality,
    Consistency,
    Direction,
    Multiplicity,
)
from janusgraph_tpu_torch.core.ids import VertexIDType
from janusgraph_tpu_torch.core.schema import (
    _DATA_TYPE_NAMES,
    EdgeLabel,
    IndexDefinition,
    PropertyKey,
    RelationIndex,
    VertexLabel,
)
from janusgraph_tpu_torch.exceptions import SchemaViolationError

#: graphindex row prefix of the schema name -> id lookup
SCHEMA_NAME_INDEX_PREFIX = b"\x00sn\x00"
# graph-index names are a namespace separate from relation-type names
# (reference: buildIndex("name", ...) coexists with PropertyKey "name")
INDEX_NAME_PREFIX = b"\x00in\x00"
INDEX_REGISTRY_KEY = b"\x00indexes"
RELINDEX_REGISTRY_KEY = b"\x00relindexes"


class SchemaAction(Enum):
    """Index lifecycle actions (reference: core/schema/SchemaAction.java:30-51).
    Transitions: INSTALLED -> REGISTER_INDEX -> REGISTERED -> REINDEX/
    ENABLE_INDEX -> ENABLED -> DISABLE_INDEX -> DISABLED -> REMOVE_INDEX."""

    REGISTER_INDEX = "REGISTER_INDEX"
    REINDEX = "REINDEX"
    ENABLE_INDEX = "ENABLE_INDEX"
    DISABLE_INDEX = "DISABLE_INDEX"
    REMOVE_INDEX = "REMOVE_INDEX"


class SchemaStatus(Enum):
    """Index lifecycle states (reference: core/schema/SchemaStatus.java).
    Management APIs accept either the enum or its string value; index cells
    store the string form."""

    INSTALLED = "INSTALLED"
    REGISTERED = "REGISTERED"
    ENABLED = "ENABLED"
    DISABLED = "DISABLED"


def _status_str(status) -> str:
    return status.value if isinstance(status, SchemaStatus) else status


class ManagementSystem:
    def __init__(self, graph):
        self.graph = graph

    # ------------------------------------------------------------------ makers
    def make_property_key(
        self,
        name: str,
        data_type: type = str,
        cardinality: Cardinality = Cardinality.SINGLE,
    ) -> PropertyKey:
        if data_type not in _DATA_TYPE_NAMES:
            raise SchemaViolationError(
                f"unsupported property data type {data_type!r}"
            )
        self._check_fresh(name)
        sid = self.graph.id_assigner.assign_schema_id(
            VertexIDType.USER_PROPERTY_KEY
        )
        el = PropertyKey(sid, name, data_type, cardinality)
        self._persist(el)
        return el

    def make_edge_label(
        self,
        name: str,
        multiplicity: Multiplicity = Multiplicity.MULTI,
        sort_key: Sequence[str] = (),
        unidirected: bool = False,
    ) -> EdgeLabel:
        self._check_fresh(name)
        key_ids = []
        for key_name in sort_key:
            pk = self.graph.schema_cache.get_by_name(key_name)
            if not isinstance(pk, PropertyKey):
                raise SchemaViolationError(
                    f"sort key {key_name} is not a property key"
                )
            ser = self.graph.serializer.serializer_for_type(pk.data_type)
            if ser.fixed_width is None:
                raise SchemaViolationError(
                    f"sort key {key_name}: only fixed-width types can be "
                    f"sort keys (got {pk.data_type.__name__})"
                )
            key_ids.append(pk.id)
        sid = self.graph.id_assigner.assign_schema_id(VertexIDType.USER_EDGE_LABEL)
        el = EdgeLabel(sid, name, multiplicity, tuple(key_ids), unidirected)
        self._persist(el)
        return el

    def make_vertex_label(
        self, name: str, partitioned: bool = False, static: bool = False
    ) -> VertexLabel:
        self._check_fresh(name)
        sid = self.graph.id_assigner.assign_schema_id(VertexIDType.VERTEX_LABEL)
        el = VertexLabel(sid, name, partitioned, static)
        self._persist(el)
        return el

    # -------------------------------------------------------- type modifiers
    def _update(self, name: str, **fields):
        """Persist the element ``name`` with ``fields`` replaced (read
        under the schema RMW lock), and evict it."""
        with self.graph._schema_rmw_lock:
            el = self.graph.schema_cache.get_by_name(name)
            updated = dataclasses.replace(el, **fields)
            self._persist(updated)
            self.graph.schema_cache.invalidate(name)
            self.graph.schema_cache.invalidate_id(el.id)
        self.graph.schema_changed(el.id)
        return updated

    def set_consistency(self, name: str, consistency: Consistency):
        """Attach a consistency modifier to a property key or edge label
        (reference: ManagementSystem.setConsistency). LOCK makes commits
        touching the type take consistent-key locks with expected-value
        checks; FORK (edge labels only) turns in-place edge updates into a
        delete and a re-add under a fresh relation id."""
        el = self.graph.schema_cache.get_by_name(name)
        if el is None or not (el.is_property_key or el.is_edge_label):
            raise SchemaViolationError(f"{name} is not a property key or edge label")
        consistency = Consistency(consistency)
        if consistency is Consistency.FORK and not el.is_edge_label:
            raise SchemaViolationError(
                "FORK consistency applies only to edge labels "
                "(reference: ConsistencyModifier.FORK)"
            )
        # the same RMW lock as the constraint declarations: auto-created
        # declarations arrive from concurrent writers
        return self._update(name, consistency=consistency)

    def get_consistency(self, name: str) -> Consistency:
        el = self.graph.schema_cache.get_by_name(name)
        if el is None or not hasattr(el, "consistency"):
            raise SchemaViolationError(f"{name} is not a property key or edge label")
        return el.consistency

    def add_properties(self, label_name: str, *key_names: str):
        """Declare property keys for a vertex or edge label (reference:
        SchemaManager.addProperties). With schema.constraints on, every key
        written on an element of a label other than the default "vertex"
        must be declared; with schema.default=auto a missing declaration
        is made on first write. Additive across calls."""
        with self.graph._schema_rmw_lock:
            el = self.graph.schema_cache.get_by_name(label_name)
            if el is None or not hasattr(el, "allowed_property_ids"):
                raise SchemaViolationError(f"{label_name} is not a vertex or edge label")
            ids = list(el.allowed_property_ids)
            for kn in key_names:
                pk = self.graph.schema_cache.get_by_name(kn)
                if not isinstance(pk, PropertyKey):
                    raise SchemaViolationError(f"{kn} is not a property key")
                if pk.id not in ids:
                    ids.append(pk.id)
            updated = dataclasses.replace(el, allowed_property_ids=tuple(ids))
            self._persist(updated)
            self.graph.schema_cache.invalidate(label_name)
            self.graph.schema_cache.invalidate_id(el.id)
        self.graph.schema_changed(el.id)
        return updated

    def add_connection(self, edge_label_name: str, out_label_name: str, in_label_name: str):
        """Declare an (out-vertex-label, in-vertex-label) connection for an
        edge label (reference: SchemaManager.addConnection). With
        schema.constraints on, every edge between vertices of labels other
        than "vertex" must match a declared connection; auto mode declares
        it on first write. Additive."""
        with self.graph._schema_rmw_lock:
            el = self.graph.schema_cache.get_by_name(edge_label_name)
            if not isinstance(el, EdgeLabel):
                raise SchemaViolationError(f"{edge_label_name} is not an edge label")
            pair = []
            for ln in (out_label_name, in_label_name):
                vl = self.graph.schema_cache.get_by_name(ln)
                if not isinstance(vl, VertexLabel):
                    raise SchemaViolationError(f"{ln} is not a vertex label")
                pair.append(vl.id)
            conns = list(el.connections)
            if tuple(pair) not in conns:
                conns.append(tuple(pair))
            updated = dataclasses.replace(el, connections=tuple(conns))
            self._persist(updated)
            self.graph.schema_cache.invalidate(edge_label_name)
            self.graph.schema_cache.invalidate_id(el.id)
        self.graph.schema_changed(el.id)
        return updated

    def set_ttl(self, name: str, ttl_seconds: int):
        """Attach a time-to-live to a property key, edge label or static
        vertex label (reference: ManagementSystem.setTTL). Cells of the type
        are written with a per-cell expiry, so the store must keep cell TTLs
        (``StoreFeatures.cell_ttl``: the in-memory store does, the local
        store does not). A vertex label's TTL expires the vertex's existence
        cell; its relations become ghosts."""
        if ttl_seconds < 0:
            raise SchemaViolationError("ttl must be >= 0")
        if ttl_seconds and not self.graph.backend.manager.features.cell_ttl:
            raise SchemaViolationError(
                f"backend does not support cell TTL ({self.graph.backend.manager.name})"
            )
        el = self.graph.schema_cache.get_by_name(name)
        if el is None or not hasattr(el, "ttl_seconds"):
            raise SchemaViolationError(f"{name} is not a schema type")
        if ttl_seconds and isinstance(el, VertexLabel) and not el.static:
            # a non-static vertex could keep gaining never-expiring
            # relations after its existence cell died
            raise SchemaViolationError(
                "vertex-label TTL requires a static label "
                "(reference: ManagementSystem.setTTL)"
            )
        return self._update(name, ttl_seconds=int(ttl_seconds))

    def get_ttl(self, name: str) -> int:
        el = self.graph.schema_cache.get_by_name(name)
        if el is None or not hasattr(el, "ttl_seconds"):
            raise SchemaViolationError(f"{name} is not a schema type")
        return el.ttl_seconds

    # ----------------------------------------- relation-type (vertex-centric)
    def build_edge_index(
        self,
        label_name: str,
        name: str,
        sort_keys: Sequence[str],
        direction: Direction = Direction.BOTH,
    ) -> RelationIndex:
        """Create a vertex-centric index on an EXISTING edge label
        (reference: ManagementSystem.buildEdgeIndex -> RelationTypeIndex).
        New edges of the label immediately write index cells (status
        REGISTERED); pre-existing edges become queryable after
        reindex_relation_index(), which flips the index to ENABLED. Sort
        keys must be fixed-width property keys (the same restriction as
        label sort keys)."""
        label = self.graph.schema_cache.get_by_name(label_name)
        if not isinstance(label, EdgeLabel):
            raise SchemaViolationError(f"{label_name} is not an edge label")
        self._check_fresh(name)
        if not sort_keys:
            raise SchemaViolationError("relation index needs sort keys")
        key_ids = []
        for key_name in sort_keys:
            pk = self.graph.schema_cache.get_by_name(key_name)
            if not isinstance(pk, PropertyKey):
                raise SchemaViolationError(
                    f"sort key {key_name} is not a property key"
                )
            ser = self.graph.serializer.serializer_for_type(pk.data_type)
            if ser.fixed_width is None:
                raise SchemaViolationError(
                    f"sort key {key_name}: only fixed-width types can be "
                    f"sort keys (got {pk.data_type.__name__})"
                )
            key_ids.append(pk.id)
        sid = self.graph.id_assigner.assign_schema_id(
            VertexIDType.USER_EDGE_LABEL
        )
        ri = RelationIndex(
            sid, name, label.id, tuple(key_ids), int(direction), "REGISTERED"
        )
        self._persist(ri)
        btx = self.graph.backend.begin_transaction()
        btx.mutate_index(
            RELINDEX_REGISTRY_KEY, [(struct.pack(">Q", sid), b"")], []
        )
        btx.commit()
        self.graph.schema_changed(sid)  # reloads the index registry
        return ri

    def reindex_relation_index(self, name: str) -> int:
        """Write index cells for every pre-existing edge of the indexed
        label, then ENABLE the index (reference: mgmt.updateIndex(REINDEX)
        on a RelationTypeIndex). Returns edges indexed."""
        ri = self.graph.schema_cache.get_by_name(name)
        if not isinstance(ri, RelationIndex):
            raise SchemaViolationError(f"{name} is not a relation index")
        g = self.graph
        from janusgraph_tpu_torch.storage.kcvs import SliceQuery

        es = g.edge_serializer
        ser = g.serializer
        sq = es.get_type_slice(ri.label_id, True, Direction.OUT)
        codec_schema = None
        btx = g.backend.begin_transaction()
        stx = g.backend.manager.begin_transaction()
        count = 0
        for key, entries in g.backend.edgestore.get_keys(
            SliceQuery(sq.start, sq.end), stx
        ):
            vid = g.idm.get_vertex_id(key)
            for entry in entries:
                if codec_schema is None:
                    from janusgraph_tpu_torch.olap.csr import graph_codec_schema

                    codec_schema = graph_codec_schema(g)
                rc = es.parse_relation(entry, codec_schema)
                if rc.type_id != ri.label_id or rc.direction != Direction.OUT:
                    continue
                props = rc.properties or {}
                sk = ri.sort_key_bytes(ser, props)
                if sk is None:
                    continue
                if ri.direction in (int(Direction.OUT), int(Direction.BOTH)):
                    btx.mutate_edges(
                        key,
                        [es.write_edge(
                            ri.id, Direction.OUT, rc.other_vertex_id,
                            rc.relation_id, sk, props or None,
                        )],
                        [],
                    )
                if ri.direction in (int(Direction.IN), int(Direction.BOTH)):
                    btx.mutate_edges(
                        g.idm.get_key(rc.other_vertex_id),
                        [es.write_edge(
                            ri.id, Direction.IN, vid,
                            rc.relation_id, sk, props or None,
                        )],
                        [],
                    )
                count += 1
        btx.commit()
        self.set_relation_index_status(name, "ENABLED")
        return count

    def set_relation_index_status(self, name: str, status) -> RelationIndex:
        status = _status_str(status)
        if status not in ("REGISTERED", "ENABLED", "DISABLED"):
            raise SchemaViolationError(f"unknown relation-index status {status}")
        ri = self.graph.schema_cache.get_by_name(name)
        if not isinstance(ri, RelationIndex):
            raise SchemaViolationError(f"{name} is not a relation index")
        updated = dataclasses.replace(ri, status=status)
        self._persist(updated)
        self.graph.schema_cache.invalidate(name)
        self.graph.schema_cache.invalidate_id(ri.id)
        self.graph.schema_changed(ri.id)  # reloads the index registry
        return updated

    # ------------------------------------------------------------ graph indexes
    def build_composite_index(
        self,
        name: str,
        keys: Sequence[str],
        unique: bool = False,
        label: Optional[str] = None,
    ) -> IndexDefinition:
        if not keys:
            raise SchemaViolationError("composite index needs at least one key")
        if not name or name.startswith("\x00"):
            raise SchemaViolationError(f"invalid index name {name!r}")
        if name in self.graph.indexes:
            raise SchemaViolationError(f"index name already exists: {name}")
        key_ids = []
        for key_name in keys:
            pk = self.graph.schema_cache.get_by_name(key_name)
            if not isinstance(pk, PropertyKey):
                raise SchemaViolationError(f"{key_name} is not a property key")
            if pk.cardinality != Cardinality.SINGLE:
                raise SchemaViolationError(
                    "composite index keys must have SINGLE cardinality"
                )
            key_ids.append(pk.id)
        sid = self.graph.id_assigner.assign_schema_id(VertexIDType.GENERIC_SCHEMA)
        idx = IndexDefinition(sid, name, tuple(key_ids), unique, label)
        self._persist(idx)
        # register in the index registry row so commits can enumerate indexes
        btx = self.graph.backend.begin_transaction()
        btx.mutate_index(INDEX_REGISTRY_KEY, [(struct.pack(">Q", sid), b"")], [])
        btx.commit()
        self.graph.register_index(idx)
        # cover data committed before the index existed
        self.reindex(name)
        return idx

    def build_mixed_index(
        self,
        name: str,
        keys: Sequence[str],
        backing: str = "search",
        label: Optional[str] = None,
        mappings: Optional[dict] = None,
    ) -> IndexDefinition:
        """Create a mixed index backed by an IndexProvider (reference:
        ManagementSystem buildIndex(...).buildMixedIndex(backingIndex);
        key mappings core/schema/Mapping.java)."""
        if not keys:
            raise SchemaViolationError("mixed index needs at least one key")
        if not name or name.startswith("\x00"):
            raise SchemaViolationError(f"invalid index name {name!r}")
        if name in self.graph.indexes:
            raise SchemaViolationError(f"index name already exists: {name}")
        if backing not in self.graph.index_providers:
            raise SchemaViolationError(
                f"unknown index backend {backing!r}; configured: "
                f"{sorted(self.graph.index_providers)}"
            )
        mappings = mappings or {}
        key_ids, mapping_pairs = [], []
        for key_name in keys:
            pk = self.graph.schema_cache.get_by_name(key_name)
            if not isinstance(pk, PropertyKey):
                raise SchemaViolationError(f"{key_name} is not a property key")
            key_ids.append(pk.id)
            m = str(mappings.get(key_name, "DEFAULT")).upper()
            if m not in ("DEFAULT", "TEXT", "STRING", "TEXTSTRING"):
                raise SchemaViolationError(f"unknown mapping {m!r}")
            mapping_pairs.append((pk.id, m))
        sid = self.graph.id_assigner.assign_schema_id(VertexIDType.GENERIC_SCHEMA)
        idx = IndexDefinition(
            sid,
            name,
            tuple(key_ids),
            False,
            label,
            "ENABLED",
            mixed=True,
            backing=backing,
            mappings=tuple(mapping_pairs),
        )
        self._persist(idx)
        btx = self.graph.backend.begin_transaction()
        btx.mutate_index(INDEX_REGISTRY_KEY, [(struct.pack(">Q", sid), b"")], [])
        btx.commit()
        self.graph.register_index(idx)
        # register fields with the provider up front (reference:
        # IndexTransaction.register on index creation)
        self.graph.mixed_index_fields(idx, register=True)
        # cover data committed before the index existed
        self.reindex(name)
        return idx

    def add_index_key(
        self, index_name: str, key_name: str, mapping: str = "DEFAULT"
    ) -> IndexDefinition:
        """Extend a mixed index with another key (reference:
        ManagementSystem.addIndexKey)."""
        idx = self.graph.indexes.get(index_name)
        if idx is None or not idx.mixed:
            raise SchemaViolationError(f"{index_name} is not a mixed index")
        pk = self.graph.schema_cache.get_by_name(key_name)
        if not isinstance(pk, PropertyKey):
            raise SchemaViolationError(f"{key_name} is not a property key")
        if pk.id in idx.key_ids:
            raise SchemaViolationError(f"{key_name} already indexed")
        m = str(mapping).upper()
        if m not in ("DEFAULT", "TEXT", "STRING", "TEXTSTRING"):
            raise SchemaViolationError(f"unknown mapping {m!r}")
        new = IndexDefinition(
            idx.id,
            idx.name,
            idx.key_ids + (pk.id,),
            idx.unique,
            idx.label_constraint,
            idx.status,
            True,
            idx.backing,
            idx.mappings + ((pk.id, m),),
        )
        self.graph.update_schema_element(new)
        self.graph.mixed_index_fields(new, register=True)
        # backfill the new key from existing data, like build_*_index does
        self.reindex(index_name)
        return new

    # -------------------------------------------------------- index lifecycle
    _TRANSITIONS = {
        SchemaAction.REGISTER_INDEX: (("INSTALLED",), "REGISTERED"),
        SchemaAction.ENABLE_INDEX: (("REGISTERED",), "ENABLED"),
        SchemaAction.DISABLE_INDEX: (("ENABLED", "REGISTERED"), "DISABLED"),
    }

    def update_index(self, name: str, action: SchemaAction):
        """Drive an index through its lifecycle (reference:
        ManagementSystem.updateIndex — SchemaAction REGISTER/REINDEX/ENABLE/
        DISABLE/REMOVE). A status change evicts the index from this
        instance's caches and broadcasts the eviction to every open
        instance (ManagementLogger.java:287)."""
        idx = self.graph.indexes.get(name)
        if idx is None:
            raise SchemaViolationError(f"unknown index {name}")
        if action is SchemaAction.REINDEX:
            # rebuild entries from primary storage, then enable
            count = self.reindex(name)
            if idx.status != "ENABLED":
                self._set_index_status(idx, "ENABLED")
            return count
        if action is SchemaAction.REMOVE_INDEX:
            if idx.status not in ("DISABLED", "INSTALLED"):
                raise SchemaViolationError(
                    f"index {name} must be DISABLED before removal "
                    f"(is {idx.status})"
                )
            from janusgraph_tpu_torch.olap.jobs import IndexRemoveJob

            metrics = IndexRemoveJob(self.graph, idx).run()
            # drop from registry + schema store
            btx = self.graph.backend.begin_transaction()
            btx.mutate_index(
                INDEX_REGISTRY_KEY, [], [struct.pack(">Q", idx.id)]
            )
            btx.mutate_index(INDEX_NAME_PREFIX + idx.name.encode(), [],
                             [struct.pack(">Q", idx.id)])
            btx.commit()
            self.graph._load_index_registry()
            # forget provider field registrations so a same-name index built
            # later re-registers with ITS mappings, not the removed one's
            self.graph._mixed_key_infos.pop(idx.name, None)
            self.graph.schema_cache.invalidate(idx.name)
            self.graph.schema_cache.invalidate_id(idx.id)
            self.graph.schema_changed(idx.id)
            return metrics
        allowed, target = self._TRANSITIONS[action]
        if idx.status not in allowed:
            raise SchemaViolationError(
                f"cannot {action.value} index {name} in status {idx.status}"
            )
        self._set_index_status(idx, target)
        return self.graph.indexes[name]

    def _set_index_status(self, idx: IndexDefinition, status: str) -> None:
        new = IndexDefinition(
            idx.id,
            idx.name,
            idx.key_ids,
            idx.unique,
            idx.label_constraint,
            status,
            idx.mixed,
            idx.backing,
            idx.mappings,
        )
        self.graph.update_schema_element(new)

    def await_graph_index_status(
        self, name: str, status="ENABLED", timeout_s: float = 10.0
    ) -> bool:
        """Poll until the index reaches `status` (reference:
        GraphIndexStatusWatcher.java:102 — used after REGISTER/ENABLE to wait
        for cluster-wide acknowledgement)."""
        status = _status_str(status)
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            idx = self.graph.indexes.get(name)
            if idx is not None and idx.status == status:
                return True
            if idx is None and status == "REMOVED":
                return True
            time.sleep(0.01)
        idx = self.graph.indexes.get(name)
        return (idx is not None and idx.status == status) or (
            idx is None and status == "REMOVED"
        )

    def ghost_vertex_removal(self, num_workers: int = 1):
        """Purge half-deleted vertices (reference:
        GhostVertexRemover.java:44)."""
        from janusgraph_tpu_torch.olap.jobs import GhostVertexRemover, run_scan_job

        return run_scan_job(
            self.graph, GhostVertexRemover(self.graph), num_workers
        )

    def reindex(self, name: str) -> int:
        """Rebuild an index from primary storage so data committed before the
        index existed becomes visible. Runs the IndexRepairJob over the
        partition-parallel scan framework (reference:
        graphdb/olap/job/IndexRepairJob.java driven by StandardScanner;
        invoked automatically by build_*_index here -- a convenience
        divergence from the explicit REGISTER/REINDEX/ENABLE ceremony, which
        update_index() also supports). Returns rows processed."""
        g = self.graph
        idx = g.indexes.get(name)
        if idx is None:
            raise SchemaViolationError(f"unknown index {name}")
        from janusgraph_tpu_torch.olap.jobs import IndexRepairJob, run_scan_job

        metrics = run_scan_job(g, IndexRepairJob(g, idx))
        return metrics.rows_processed

    # ----------------------------------------------------------------- lookups
    def get(self, name: str):
        return self.graph.schema_cache.get_by_name(name)

    def contains(self, name: str) -> bool:
        return self.get(name) is not None

    def property_keys(self) -> List[PropertyKey]:
        return [e for e in self._all_schema() if isinstance(e, PropertyKey)]

    def edge_labels(self) -> List[EdgeLabel]:
        return [e for e in self._all_schema() if isinstance(e, EdgeLabel)]

    def vertex_labels(self) -> List[VertexLabel]:
        return [e for e in self._all_schema() if isinstance(e, VertexLabel)]

    def indexes(self) -> List[IndexDefinition]:
        return list(self.graph.indexes.values())

    def print_schema(self) -> str:
        """Formatted schema overview (reference:
        ManagementSystem.printSchema — property keys, labels, indexes)."""
        def _mods(el):
            out = []
            if getattr(el, "consistency", Consistency.DEFAULT) != Consistency.DEFAULT:
                out.append(el.consistency.name)
            if getattr(el, "ttl_seconds", 0):
                out.append(f"ttl={el.ttl_seconds}s")
            if getattr(el, "allowed_property_ids", ()):
                names = ",".join(
                    self.graph.schema_cache.get_by_id(i).name
                    for i in el.allowed_property_ids
                )
                out.append(f"props=[{names}]")
            if getattr(el, "connections", ()):
                conns = ",".join(
                    f"{self.graph.schema_cache.get_by_id(o).name}->"
                    f"{self.graph.schema_cache.get_by_id(i).name}"
                    for o, i in el.connections
                )
                out.append(f"connections=[{conns}]")
            return (" " + " ".join(out)) if out else ""

        lines = ["--- property keys ---"]
        for pk in sorted(self.property_keys(), key=lambda e: e.name):
            lines.append(
                f"{pk.name:<24} {pk.data_type.__name__:<12} "
                f"{pk.cardinality.name}{_mods(pk)}"
            )
        lines.append("--- edge labels ---")
        for el in sorted(self.edge_labels(), key=lambda e: e.name):
            sk = ""
            if el.sort_key:
                names = [
                    self.graph.schema_cache.get_by_id(k).name
                    for k in el.sort_key
                ]
                sk = f" sortKey={','.join(names)}"
            lines.append(
                f"{el.name:<24} {el.multiplicity.name}"
                f"{' unidirected' if el.unidirected else ''}{sk}{_mods(el)}"
            )
        lines.append("--- vertex labels ---")
        for vl in sorted(self.vertex_labels(), key=lambda e: e.name):
            flags = []
            if vl.partitioned:
                flags.append("partitioned")
            if vl.static:
                flags.append("static")
            lines.append(f"{vl.name:<24} {' '.join(flags)}{_mods(vl)}")
        lines.append("--- relation indexes ---")
        for lid, ris in sorted(self.graph.relation_indexes.items()):
            for ri in ris:
                label = self.graph.schema_cache.get_by_id(ri.label_id)
                keys = ",".join(
                    self.graph.schema_cache.get_by_id(k).name
                    for k in ri.sort_key
                )
                lines.append(
                    f"{ri.name:<24} on {label.name} [{keys}] "
                    f"{Direction(ri.direction).name} {ri.status}"
                )
        lines.append("--- indexes ---")
        for idx in sorted(self.indexes(), key=lambda i: i.name):
            kind = "mixed" if idx.mixed else "composite"
            keys = ",".join(
                self.graph.schema_cache.get_by_id(k).name for k in idx.key_ids
            )
            extra = " unique" if getattr(idx, "unique", False) else ""
            lines.append(
                f"{idx.name:<24} {kind:<10} [{keys}] {idx.status}{extra}"
            )
        return "\n".join(lines)

    def _all_schema(self):
        return self.graph.load_all_schema_elements()

    # -------------------------------------------------------- schema eviction
    def broadcast_eviction(
        self, schema_id: int, timeout_s: Optional[float] = None,
    ) -> bool:
        """Tell every open instance to drop ``schema_id`` from its caches
        and wait for their acknowledgements (reference:
        ManagementLogger.java:287). ``timeout_s`` defaults to
        schema.eviction-ack-timeout-ms."""
        if timeout_s is None:
            timeout_s = self.graph.config.get("schema.eviction-ack-timeout-ms") / 1000.0
        ml = self.graph.management_logger
        evict_id = ml.broadcast_eviction(schema_id)
        expected = len(self.open_instances())
        return ml.wait_for_acks(evict_id, expected, timeout_s)

    # --------------------------------------------- cluster config + instances
    # (reference: ManagementSystem.set/get over GLOBAL options;
    #  getOpenInstances/forceCloseInstance, StandardJanusGraph.java:176-185)
    def get_config(self, path: str):
        return self.graph.config.get(path)

    def set_config(self, path: str, value) -> None:
        self.graph.config.set_global(
            path, value, open_instances=len(self.open_instances())
        )
        self.graph._on_global_config_change(path, value)

    def open_instances(self) -> List[str]:
        return self.graph.instance_registry.open_instances()

    def force_close_instance(self, instance_id: str) -> None:
        if instance_id == self.graph.instance_id:
            raise SchemaViolationError(
                "cannot force-close the current instance; use graph.close()"
            )
        self.graph.instance_registry.deregister(instance_id)

    def _check_fresh(self, name: str) -> None:
        if not name or name.startswith("\x00"):
            raise SchemaViolationError(f"invalid schema name {name!r}")
        if self.graph.schema_cache.get_by_name(name) is not None:
            raise SchemaViolationError(f"schema name already exists: {name}")

    def _persist(self, el) -> None:
        self.graph.persist_schema_element(el)
