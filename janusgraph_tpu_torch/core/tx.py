"""OLTP transaction: vertex cache, added/deleted relation overlay, reads
merging backend state with uncommitted changes, and the commit hand-off —
the port's copy of the write side and the point reads of
``janusgraph_tpu/core/tx.py``.

Capability parity with the reference transaction
(reference: graphdb/transaction/StandardJanusGraphTx.java:99 — vertex cache
:133-152, addVertex:502, addEdge:703 with multiplicity checks :716-724,
addProperty:747 with cardinality handling). IDs are assigned eagerly on
element creation (the reference's default ``ids.flush-ids=true``), so the
same calls draw the same vertex and relation ids as the reference's, and
``graph.commit_tx`` writes the same cells.

The traversal's reads are here too: ``prefetch`` (the multi-query slice
batch, ``query.batch-size`` vertices a call), the sort-range
``get_edges`` (the vertex-centric index's column range on a sort-keyed
label) and ``adjacency_edges`` (point lookups of specific neighbours).

The schema options apply as in the reference: ``schema.default`` "none"
refuses an undefined key or label instead of making it, and with
``schema.constraints`` a labelled element carries only declared keys and
an edge only declared connections (``mgmt.add_properties``,
``mgmt.add_connection``; auto mode declares them on first write).

Relation indexes: their copies of an edge are invisible to untyped reads,
and a sort range on a label without a sort key goes through an ENABLED
relation index. ``log_identifier`` names the user log the commit writes
its changes to through the WAL (``core/graph.py`` commit step 7); the
attributes ``_fail_mixed_for_test`` and ``_fail_secondary_for_test``, set
by tests, make the commit's secondary persistence fail.

Telemetry, as the reference's: ``tx.begin`` and ``tx.rollback`` counters,
a ``tx.commit`` span (added and deleted relations, lifetime) around a
``tx.commit`` timer, a ``tx.rollback`` span, and per-transaction counters
``<metrics_group>.commit`` where a group is named.
"""

from __future__ import annotations

import threading
import time
from collections import defaultdict
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

from janusgraph_tpu_torch.core.attributes import BigInt
from janusgraph_tpu_torch.core.codecs import (
    Cardinality,
    Consistency,
    Direction,
    Multiplicity,
    RelationIdentifier,
)
from janusgraph_tpu_torch.core.elements import Edge, LifeCycle, Vertex, VertexProperty
from janusgraph_tpu_torch.core.ids import VertexIDType
from janusgraph_tpu_torch.core.schema import EdgeLabel, PropertyKey
from janusgraph_tpu_torch.exceptions import (
    InvalidElementError,
    QueryError,
    ReadOnlyTransactionError,
    SchemaViolationError,
)
from janusgraph_tpu_torch.observability import registry, span
from janusgraph_tpu_torch.storage.kcvs import KeySliceQuery, SliceQuery


class Transaction:
    def __init__(
        self,
        graph,
        read_only: bool = False,
        log_identifier: Optional[str] = None,
        metrics_group: Optional[str] = None,
    ):
        self.graph = graph
        self.read_only = read_only
        self.log_identifier = log_identifier
        # per-tx metric group (reference: StandardJanusGraphTx.java:258-262):
        # bare <group>.<op> names; the reporters prepend metrics.prefix
        self.metrics_group = metrics_group
        registry.counter("tx.begin").inc()
        self._t0_ns = time.perf_counter_ns()
        self.backend_tx = graph.backend.begin_transaction()
        self._vertex_cache: Dict[int, Vertex] = {}
        # vid -> list of added relations incident to it (edges appear under
        # both endpoints, properties under their vertex)
        self._added: Dict[int, List] = defaultdict(list)
        # relation-ids deleted in this tx
        self._deleted_ids: Set[int] = set()
        # deleted relation objects (for commit serialization)
        self._deleted: List = []
        self._new_vertex_labels: Dict[int, int] = {}  # vid -> label schema id
        self._removed_vertices: Set[int] = set()
        # per-tx slice cache: (vid, SliceQuery) -> EntryList
        self._slice_cache: Dict[Tuple[int, SliceQuery], list] = {}
        self._open = True
        self._lock = threading.RLock()

    # ------------------------------------------------------------ schema sugar
    def schema_by_name(self, name: str):
        return self.graph.schema_cache.get_by_name(name)

    def schema_by_id(self, sid: int):
        return self.graph.schema_cache.get_by_id(sid)

    def schema_name(self, sid: int) -> str:
        el = self.schema_by_id(sid)
        if el is None:
            raise SchemaViolationError(f"unknown schema id {sid}")
        return el.name

    @staticmethod
    def _coerce_value(pk: PropertyKey, key: str, value):
        """Type-check a value against its key's declared datatype, with the
        int->float / int->BigInt literal conveniences; raises
        SchemaViolationError on mismatch (shared by plain and META
        properties)."""
        if not isinstance(value, pk.data_type) or (
            pk.data_type is not bool and isinstance(value, bool)
        ):
            if pk.data_type is float and isinstance(value, int) and not isinstance(value, bool):
                return float(value)
            if pk.data_type is BigInt and isinstance(value, int) and not isinstance(value, bool):
                # plain ints promote to declared BigInteger keys (and the
                # codec reads back plain int, so round-trip writes stay
                # legal)
                return BigInt(value)
            raise SchemaViolationError(
                f"property {key} expects {pk.data_type.__name__}, "
                f"got {type(value).__name__}"
            )
        return value

    def _property_key(self, name: str, value=None) -> PropertyKey:
        el = self.schema_by_name(name)
        if el is None:
            if not self.graph.auto_schema:
                raise SchemaViolationError(f"undefined property key: {name}")
            el = self.graph.management().make_property_key(
                name, type(value) if value is not None else str
            )
        if not isinstance(el, PropertyKey):
            raise SchemaViolationError(f"{name} is not a property key")
        return el

    # -- schema constraints (reference: StandardJanusGraphTx.java:669-698):
    # with schema.constraints on, labelled elements carry only declared
    # keys and connections; auto schema declares a missing one, "none"
    # refuses it. The default "vertex" label is exempt.
    def _vertex_label_el(self, v: Vertex):
        name = self.get_vertex_label(v)
        if name == "vertex":
            return None
        return self.schema_by_name(name)

    def _check_property_constraint(self, v: Vertex, pk: PropertyKey) -> None:
        if not self.graph.schema_constraints:
            return
        vl = self._vertex_label_el(v)
        if vl is None or not hasattr(vl, "allowed_property_ids"):
            return
        if pk.id in vl.allowed_property_ids:
            return
        if self.graph.auto_schema:
            self.graph.management().add_properties(vl.name, pk.name)
            return
        raise SchemaViolationError(
            f"property {pk.name!r} is not declared for vertex label "
            f"{vl.name!r} (schema.constraints; mgmt.add_properties)"
        )

    def _check_edge_property_constraint(self, el: EdgeLabel, pk: PropertyKey) -> None:
        if not self.graph.schema_constraints:
            return
        if pk.id in el.allowed_property_ids:
            return
        if self.graph.auto_schema:
            self.graph.management().add_properties(el.name, pk.name)
            return
        raise SchemaViolationError(
            f"property {pk.name!r} is not declared for edge label "
            f"{el.name!r} (schema.constraints; mgmt.add_properties)"
        )

    def _check_connection_constraint(self, el: EdgeLabel, out_v: Vertex, in_v: Vertex) -> None:
        if not self.graph.schema_constraints:
            return
        ovl = self._vertex_label_el(out_v)
        ivl = self._vertex_label_el(in_v)
        if ovl is None or ivl is None:
            return  # a default-labelled endpoint is exempt
        if (ovl.id, ivl.id) in el.connections:
            return
        if self.graph.auto_schema:
            self.graph.management().add_connection(el.name, ovl.name, ivl.name)
            return
        raise SchemaViolationError(
            f"connection {ovl.name!r}-[{el.name!r}]->{ivl.name!r} is not "
            "declared (schema.constraints; mgmt.add_connection)"
        )

    def _edge_label(self, name: str) -> EdgeLabel:
        el = self.schema_by_name(name)
        if el is None:
            if not self.graph.auto_schema:
                raise SchemaViolationError(f"undefined edge label: {name}")
            el = self.graph.management().make_edge_label(name)
        if not isinstance(el, EdgeLabel):
            raise SchemaViolationError(f"{name} is not an edge label")
        return el

    # ------------------------------------------------------------------ writes
    def _check_writable(self):
        if not self._open:
            raise InvalidElementError("transaction is closed")
        if self.read_only:
            raise ReadOnlyTransactionError("read-only transaction")

    def add_vertex(
        self,
        label: Optional[str] = None,
        vertex_id: Optional[int] = None,
        **props,
    ) -> Vertex:
        """``vertex_id``: caller-chosen id, permitted only under
        graph.set-vertex-id=true. Must be a well-formed NORMAL user vertex
        id not already present; custom ids bypass the id authority."""
        self._check_writable()
        if vertex_id is not None:
            # validate BEFORE label resolution: a rejected call must not
            # auto-create the label as a side effect
            if not self.graph.config.get("graph.set-vertex-id"):
                raise InvalidElementError(
                    "custom vertex ids require graph.set-vertex-id=true"
                )
            idm = self.graph.idm
            if (
                not idm.is_user_vertex_id(vertex_id)
                or idm.id_type(vertex_id) is not VertexIDType.NORMAL
            ):
                raise InvalidElementError(
                    f"{vertex_id} is not a well-formed NORMAL user vertex "
                    "id — build one with graph.idm.make_vertex_id(count, "
                    "partition)"
                )
            if vertex_id in self._removed_vertices:
                raise InvalidElementError(
                    f"vertex id {vertex_id} was removed in this "
                    "transaction — commit the removal first"
                )
            if self.get_vertex(vertex_id) is not None:
                raise InvalidElementError(
                    f"vertex id {vertex_id} already exists"
                )
            existing_label = self.graph.schema_cache.get_by_name(
                label or "vertex"
            )
            if existing_label is not None and getattr(
                existing_label, "partitioned", False
            ):
                raise InvalidElementError(
                    "custom vertex ids cannot target a PARTITIONED label "
                    "(vertex-cut copies derive their own id family)"
                )
        label_el = self.graph.get_or_create_vertex_label(label or "vertex")
        if vertex_id is not None:
            vid = vertex_id
        else:
            vid = self.graph.id_assigner.assign_vertex_id(
                partitioned=label_el.partitioned
            )
        v = Vertex(vid, self, LifeCycle.NEW)
        v._label_cache = label_el.name
        with self._lock:
            self._vertex_cache[vid] = v
            self._new_vertex_labels[vid] = label_el.id
        for k, val in props.items():
            self.add_property(v, k, val)
        return v

    def add_edge(self, out_v: Vertex, label: str, in_v: Vertex, **props) -> Edge:
        self._check_writable()
        out_v._check_alive()
        in_v._check_alive()
        if out_v.id in self._removed_vertices or in_v.id in self._removed_vertices:
            raise InvalidElementError("endpoint vertex was removed in this tx")
        el = self._edge_label(label)
        self._check_multiplicity(el, out_v, in_v)
        self._check_connection_constraint(el, out_v, in_v)
        rid = self.graph.id_assigner.assign_relation_id()
        prop_ids = {}
        for k, val in props.items():
            pk = self._property_key(k, val)
            self._check_edge_property_constraint(el, pk)
            prop_ids[pk.id] = val
        sort_key = self._build_sort_key(el, prop_ids)
        e = Edge(
            rid, el.id, out_v, in_v, self, LifeCycle.NEW, prop_ids, sort_key
        )
        with self._lock:
            self._added[out_v.id].append(e)
            if in_v.id != out_v.id:
                self._added[in_v.id].append(e)
        return e

    def _build_sort_key(self, el: EdgeLabel, prop_ids: Dict[int, object]) -> bytes:
        if not el.sort_key:
            return b""
        parts = []
        for key_id in el.sort_key:
            if key_id not in prop_ids:
                raise SchemaViolationError(
                    f"edge label {el.name} requires sort-key property "
                    f"{self.schema_name(key_id)}"
                )
            parts.append(self.graph.serializer.write_ordered(prop_ids[key_id]))
        return b"".join(parts)

    def _check_multiplicity(self, el: EdgeLabel, out_v: Vertex, in_v: Vertex):
        m = el.multiplicity
        if m == Multiplicity.MULTI:
            return
        if m == Multiplicity.SIMPLE:
            for e in self.get_edges(out_v, Direction.OUT, (el.name,)):
                if e.in_vertex.id == in_v.id:
                    raise SchemaViolationError(
                        f"SIMPLE multiplicity violated for {el.name}"
                    )
        if m in (Multiplicity.MANY2ONE, Multiplicity.ONE2ONE):
            if self.get_edges(out_v, Direction.OUT, (el.name,)):
                raise SchemaViolationError(
                    f"{m.name} multiplicity violated for {el.name}: "
                    f"{out_v} already has an outgoing edge"
                )
        if m in (Multiplicity.ONE2MANY, Multiplicity.ONE2ONE):
            if self.get_edges(in_v, Direction.IN, (el.name,)):
                raise SchemaViolationError(
                    f"{m.name} multiplicity violated for {el.name}: "
                    f"{in_v} already has an incoming edge"
                )

    def add_property(self, v: Vertex, key: str, value, **meta) -> VertexProperty:
        """``**meta``: META-properties on the new vertex property, typed
        through the same schema machinery as ordinary keys."""
        self._check_writable()
        v._check_alive()
        if v.id in self._removed_vertices:
            raise InvalidElementError("vertex was removed in this tx")
        pk = self._property_key(key, value)
        value = self._coerce_value(pk, key, value)
        # resolve + validate metas BEFORE any destructive step (the SINGLE
        # removal below and the durable auto-schema constraint): a write
        # that is going to be rejected must not leave mutations behind
        meta_ids = {}
        for mk, mv in meta.items():
            mpk = self._property_key(mk, mv)
            meta_ids[mpk.id] = self._coerce_value(mpk, mk, mv)
        self._check_property_constraint(v, pk)
        if pk.cardinality == Cardinality.SINGLE:
            for existing in self.get_properties(v, key):
                self.remove_property(existing)
        elif pk.cardinality == Cardinality.SET:
            for existing in self.get_properties(v, key):
                if existing.value == value:
                    if meta_ids:
                        # SET dedup must not silently drop metas: update
                        # the existing entry
                        live = existing
                        for mk, mv in meta.items():
                            live = live.set_property(mk, mv)
                        return live
                    return existing
        rid = self.graph.id_assigner.assign_relation_id()
        p = VertexProperty(
            rid, pk.id, v, value, self, LifeCycle.NEW, meta=meta_ids
        )
        with self._lock:
            self._added[v.id].append(p)
        return p

    def set_meta_property(self, p: VertexProperty, key: str, value):
        """Set a meta-property on ``p``. NEW properties mutate in place;
        LOADED ones rewrite as remove + re-add (metas live inside the
        property cell)."""
        self._check_writable()
        if p.is_removed:
            raise InvalidElementError(
                "cannot set a meta-property on a removed property"
            )
        mpk = self._property_key(key, value)
        value = self._coerce_value(mpk, key, value)
        if p.is_new:
            p._meta[mpk.id] = value
            return p
        metas = dict(p._meta)
        metas[mpk.id] = value
        named = {self.schema_name(tid): val for tid, val in metas.items()}
        vertex, pkey, pval = p.vertex, p.key, p.value
        self.remove_property(p)
        return self.add_property(vertex, pkey, pval, **named)

    def set_edge_property(self, e: Edge, key: str, value) -> "Edge":
        """Set an inline edge property. New edges mutate in place; LOADED
        edges are rewritten as delete + re-add (edge properties live inside
        the relation cell), keeping the relation id unless the label has
        FORK consistency. Returns the live edge."""
        self._check_writable()
        if getattr(e, "_replacement", None) is not None:
            return self.set_edge_property(e._replacement, key, value)
        if e.is_removed:
            raise InvalidElementError(
                "cannot set a property on a removed edge", e
            )
        pk = self._property_key(key, value)
        label = self.schema_by_id(e.type_id)
        if isinstance(label, EdgeLabel):
            self._check_edge_property_constraint(label, pk)
        if e.is_new:
            e._props[pk.id] = value
            # sort-key columns encode property values: rebuild so the stored
            # column reflects the final value
            if isinstance(label, EdgeLabel) and label.sort_key:
                e._sort_key = self._build_sort_key(label, e._props)
            return e
        new_props = dict(e._props or {})
        new_props[pk.id] = value
        self.remove_edge(e)
        fork = (
            isinstance(label, EdgeLabel)
            and label.consistency == Consistency.FORK
        )
        rid = self.graph.id_assigner.assign_relation_id() if fork else e.id
        sort_key = (
            self._build_sort_key(label, new_props)
            if isinstance(label, EdgeLabel) and label.sort_key
            else b""
        )
        ne = Edge(
            rid, e.type_id, e.out_vertex, e.in_vertex, self,
            LifeCycle.NEW, new_props, sort_key,
        )
        with self._lock:
            self._added[ne.out_vertex.id].append(ne)
            if ne.in_vertex.id != ne.out_vertex.id:
                self._added[ne.in_vertex.id].append(ne)
        e._replacement = ne
        return ne

    def remove_property(self, p: VertexProperty) -> None:
        self._check_writable()
        with self._lock:
            if p.is_new:
                self._added[p.vertex.id].remove(p)
            else:
                self._deleted_ids.add(p.id)
                self._deleted.append(p)
            p.lifecycle = LifeCycle.REMOVED

    def remove_edge(self, e: Edge) -> None:
        self._check_writable()
        with self._lock:
            if e.is_new:
                self._added[e.out_vertex.id].remove(e)
                if e.in_vertex.id != e.out_vertex.id:
                    self._added[e.in_vertex.id].remove(e)
            else:
                self._deleted_ids.add(e.id)
                self._deleted.append(e)
            e.lifecycle = LifeCycle.REMOVED

    def remove_vertex(self, v: Vertex) -> None:
        self._check_writable()
        # remove all incident relations first (loaded from storage + overlay)
        for e in self.get_edges(v, Direction.BOTH, ()):
            self.remove_edge(e)
        for p in self.get_properties(v):
            self.remove_property(p)
        with self._lock:
            self._removed_vertices.add(v.id)
            self._vertex_cache.pop(v.id, None)
            self._new_vertex_labels.pop(v.id, None)
        v.lifecycle = LifeCycle.REMOVED

    # ------------------------------------------------------------------- reads
    def get_vertex(self, vid: int) -> Optional[Vertex]:
        with self._lock:
            v = self._vertex_cache.get(vid)
        if v is not None:
            return None if v.is_removed else v
        if vid in self._removed_vertices:
            return None
        if not self.graph.idm.is_user_vertex_id(vid):
            return None
        if not self._vertex_exists(vid):
            return None
        v = Vertex(vid, self, LifeCycle.LOADED)
        with self._lock:
            self._vertex_cache[vid] = v
        return v

    def _vertex_exists(self, vid: int) -> bool:
        es = self.graph.edge_serializer
        q = es.get_type_slice(self.graph.system_types.EXISTS, False)
        return bool(self._read_slice(vid, q))

    def vertices(self) -> Iterable[Vertex]:
        """Full-graph vertex iteration via ordered key scan (g.V())."""
        es = self.graph.edge_serializer
        q = es.get_type_slice(self.graph.system_types.EXISTS, False)
        seen: Set[int] = set()
        for key, _ in self.graph.backend.edgestore.get_keys(
            q, self.backend_tx.store_tx
        ):
            vid = self.graph.idm.get_vertex_id(key)
            if vid in self._removed_vertices or not self.graph.idm.is_user_vertex_id(vid):
                continue
            seen.add(vid)
            v = self.get_vertex(vid)
            if v is not None:
                yield v
        with self._lock:
            fresh = [
                v
                for vid, v in self._vertex_cache.items()
                if v.is_new and vid not in seen
            ]
        yield from fresh

    def get_properties(self, v: Vertex, *keys: str) -> List[VertexProperty]:
        """The vertex's properties (of ``keys``, or all). One slice over the
        whole user-property range, filtered here (the reference's default
        ``query.fast-property``)."""
        es = self.graph.edge_serializer
        results: List[VertexProperty] = []
        key_ids = None
        if keys:
            key_ids = set()
            for k in keys:
                pk = self.schema_by_name(k)
                if isinstance(pk, PropertyKey):
                    key_ids.add(pk.id)
        if not v.is_new:
            for entry in self._read_slice(v.id, es.user_relations_bounds()[0]):
                rc = es.parse_relation(entry, self._codec_schema)
                if rc.relation_id in self._deleted_ids:
                    continue
                if key_ids is not None and rc.type_id not in key_ids:
                    continue
                results.append(
                    VertexProperty(
                        rc.relation_id, rc.type_id, v, rc.value, self,
                        LifeCycle.LOADED, meta=rc.properties,
                    )
                )
        with self._lock:
            for rel in self._added.get(v.id, ()):
                if isinstance(rel, VertexProperty) and not rel.is_removed:
                    if key_ids is None or rel.type_id in key_ids:
                        results.append(rel)
        return results

    def get_edges(
        self,
        v: Vertex,
        direction: Direction,
        labels: Sequence[str],
        sort_range: Optional[tuple] = None,
    ) -> List[Edge]:
        """Edges incident to ``v`` in ``direction`` with one of ``labels``
        (all user edges when empty), committed and added in this tx.
        ``sort_range=(lo, hi)`` restricts a sort-keyed label to sort-key
        values in [lo, hi), compiled into a column-range slice: the
        vertex-centric index (reference: BasicVertexCentricQueryBuilder
        interval constraints). lo/hi are a value (first sort-key property)
        or a tuple of values (a prefix of the label's sort-key properties);
        None leaves that bound open. Requires exactly one sort-keyed label
        and a concrete direction."""
        es = self.graph.edge_serializer
        results: List[Edge] = []
        sr_bytes = None
        if sort_range is not None:
            sr_bytes = self._encode_sort_range(labels, direction, sort_range)
        if not v.is_new:
            if sr_bytes is not None:
                el, lo_b, hi_b, sk_len = sr_bytes
                slices = [es.get_sort_range_slice(el.id, direction, lo_b, hi_b, sk_len)]
            else:
                slices = self._edge_slices(direction, labels)
            relidx_ids = self.graph.relation_index_ids
            for q in slices:
                for entry in self._read_slice(v.id, q):
                    rc = es.parse_relation(entry, self._codec_schema)
                    if rc.relation_id in self._deleted_ids:
                        continue
                    if direction != Direction.BOTH and rc.direction != direction:
                        continue  # unlabeled ranges span both directions
                    if rc.type_id in relidx_ids:
                        if sr_bytes is None:
                            # index copies are invisible to plain scans
                            continue
                        # an index-routed range surfaces the edge under its
                        # label, with the label's (empty) sort key, so a
                        # later delete rebuilds the primary column
                        rc.type_id = self.graph.schema_cache.get_by_id(
                            rc.type_id
                        ).label_id
                        rc.sort_key = b""
                    results.append(self._edge_from_cache(v, rc))
        with self._lock:
            label_ids = self._label_ids(labels)
            for rel in self._added.get(v.id, ()):
                if not isinstance(rel, Edge) or rel.is_removed:
                    continue
                if label_ids is not None and rel.type_id not in label_ids:
                    continue
                if direction == Direction.OUT and rel.out_vertex.id != v.id:
                    continue
                if direction == Direction.IN and rel.in_vertex.id != v.id:
                    continue
                if sr_bytes is not None:
                    # the committed column range's [lo, hi) on the sort key
                    _el, lo_b, hi_b, _len = sr_bytes
                    if isinstance(_el, EdgeLabel):
                        sk = rel._sort_key or b""
                    else:
                        # index-routed range: the index's sort key from the
                        # added edge's properties
                        sk = _el.sort_key_bytes(self.graph.serializer, rel._props)
                        if sk is None:
                            continue  # an unindexed edge is out of range
                    if (lo_b and sk < lo_b) or (hi_b and sk >= hi_b):
                        continue
                results.append(rel)
                # a self-loop has two incidences: BOTH sees it twice, matching
                # the committed representation (one OUT + one IN cell)
                if (
                    direction == Direction.BOTH
                    and rel.out_vertex.id == v.id
                    and rel.in_vertex.id == v.id
                ):
                    results.append(rel)
        return results

    def get_edge(self, rid) -> Optional[Edge]:
        """Point lookup by RelationIdentifier or its string form: one
        label-restricted slice of the OUT vertex's row."""
        if isinstance(rid, str):
            rid = RelationIdentifier.parse(rid)
        if not isinstance(rid, RelationIdentifier):
            raise InvalidElementError(
                f"not a relation identifier: {rid!r}", rid
            )
        v = self.get_vertex(rid.out_vertex_id)
        if v is None:
            return None
        el = self.graph.schema_cache.get_by_id(rid.type_id)
        if el is None:
            return None
        for e in self.get_edges(v, Direction.OUT, (el.name,)):
            if e.id == rid.relation_id and e.in_vertex.id == rid.in_vertex_id:
                return e
        return None

    def adjacency_edges(
        self,
        v: Vertex,
        direction: Direction,
        labels: Sequence[str],
        target_ids: Set[int],
    ) -> List[Edge]:
        """Edges from v to SPECIFIC neighbors as point lookups (one bounded
        column slice per (label, target) instead of iterating the whole
        neighborhood): the AdjacentVertex optimization. Labels with sort
        keys (other_vid not at a fixed column offset) and tx-added edges
        take the filtered general path."""
        es = self.graph.edge_serializer
        if not labels:
            # no label restriction -> no per-type point lookup; filtered
            # general read keeps the semantics
            return [
                e
                for e in self.get_edges(v, direction, ())
                if e.other(v).id in target_ids
            ]
        label_els = []
        for name in labels:
            el = self.schema_by_name(name)
            if isinstance(el, EdgeLabel):
                label_els.append(el)
        results: List[Edge] = []
        if not v.is_new:
            for el in label_els:
                if el.sort_key:
                    # variable other_vid offset: filtered general read
                    for e in self.get_edges(v, direction, (el.name,)):
                        if e.other(v).id in target_ids:
                            results.append(e)
                    continue
                dirs = (
                    (Direction.OUT, Direction.IN)
                    if direction == Direction.BOTH
                    else (direction,)
                )
                for d in dirs:
                    for t in target_ids:
                        q = es.get_adjacency_slice(el.id, d, t)
                        for entry in self._read_slice(v.id, q):
                            rc = es.parse_relation(entry, self._codec_schema)
                            if rc.relation_id in self._deleted_ids:
                                continue
                            results.append(self._edge_from_cache(v, rc))
        with self._lock:
            label_ids = {el.id for el in label_els}
            for rel in self._added.get(v.id, ()):
                if not isinstance(rel, Edge) or rel.is_removed:
                    continue
                if rel.type_id not in label_ids:
                    continue
                if direction == Direction.OUT and rel.out_vertex.id != v.id:
                    continue
                if direction == Direction.IN and rel.in_vertex.id != v.id:
                    continue
                if rel.other(v).id in target_ids:
                    results.append(rel)
                    # tx-added self-loops have two incidences under BOTH,
                    # as in get_edges
                    if (
                        direction == Direction.BOTH
                        and rel.out_vertex.id == v.id
                        and rel.in_vertex.id == v.id
                    ):
                        results.append(rel)
        return results

    def _encode_sort_range(self, labels, direction, sort_range):
        """Resolve (lo, hi) sort-range values into order-preserving byte
        bounds for one sort-keyed label: (target, lo_bytes, hi_bytes,
        width). ``target`` is the label when it carries a sort key, else an
        ENABLED RelationIndex on the label covering the direction; both
        compile to the same vertex-centric column-range slice."""
        if len(labels) != 1:
            raise QueryError("sort_range requires exactly one edge label")
        if direction == Direction.BOTH:
            raise QueryError("sort_range requires a concrete direction")
        el = self.schema_by_name(labels[0])
        if not isinstance(el, EdgeLabel):
            raise QueryError(f"{labels[0]!r} is not an edge label")
        if not el.sort_key:
            for cand in self.graph.relation_indexes.get(el.id, ()):
                if cand.status == "ENABLED" and cand.direction in (
                    int(Direction.BOTH), int(direction)
                ):
                    el = cand
                    break
            else:
                raise QueryError(
                    f"label {labels[0]!r} has no sort key and no enabled "
                    "relation index covering this direction"
                )
        ser = self.graph.serializer
        sk_len = 0
        for key_id in el.sort_key:
            pk = self.schema_by_id(key_id)
            sk_len += ser.serializer_for_type(pk.data_type).fixed_width

        def enc(bound):
            if bound is None:
                return b""
            vals = bound if isinstance(bound, tuple) else (bound,)
            if len(vals) > len(el.sort_key):
                raise QueryError("sort_range bound has too many values")
            out = []
            for key_id, val in zip(el.sort_key, vals):
                pk = self.schema_by_id(key_id)
                if not isinstance(val, pk.data_type):
                    try:
                        coerced = pk.data_type(val)
                    except (TypeError, ValueError) as e:
                        raise QueryError(f"sort_range bound {val!r}: {e}") from e
                    if coerced != val:
                        # a float bound on an int sort key would be encoded
                        # in a non-comparable byte space and match nothing
                        raise QueryError(
                            f"sort_range bound {val!r} is not exactly "
                            f"representable as {pk.data_type.__name__}"
                        )
                    val = coerced
                out.append(ser.write_ordered(val))
            return b"".join(out)

        lo, hi = sort_range
        return el, enc(lo), enc(hi), sk_len

    def _label_ids(self, labels: Sequence[str]) -> Optional[Set[int]]:
        if not labels:
            return None
        out = set()
        for name in labels:
            el = self.schema_by_name(name)
            if isinstance(el, EdgeLabel):
                out.add(el.id)
        return out

    def _edge_slices(self, direction: Direction, labels: Sequence[str]):
        es = self.graph.edge_serializer
        if not labels:
            # all user edge types; single-direction callers post-filter the
            # parsed relations (columns group by type, not direction)
            return [es.user_relations_bounds()[1]]
        slices = []
        for name in labels:
            el = self.schema_by_name(name)
            if isinstance(el, EdgeLabel):
                slices.append(es.get_type_slice(el.id, True, direction))
        return slices

    def _edge_from_cache(self, v: Vertex, rc) -> Edge:
        if rc.direction == Direction.OUT:
            out_v, in_v = v, self._vertex_handle(rc.other_vertex_id)
        else:
            out_v, in_v = self._vertex_handle(rc.other_vertex_id), v
        return Edge(
            rc.relation_id, rc.type_id, out_v, in_v, self, LifeCycle.LOADED,
            rc.properties, rc.sort_key,
        )

    def _vertex_handle(self, vid: int) -> Vertex:
        with self._lock:
            v = self._vertex_cache.get(vid)
            if v is None:
                v = Vertex(vid, self, LifeCycle.LOADED)
                self._vertex_cache[vid] = v
            return v

    def _codec_schema(self, type_id: int):
        info = self.graph.system_types.type_info(type_id)
        if info is not None:
            return info
        el = self.schema_by_id(type_id)
        if el is None:
            raise SchemaViolationError(f"unknown relation type id {type_id}")
        return el.type_info()

    def _read_slice(self, vid: int, q: SliceQuery) -> list:
        ck = (vid, q)
        cached = self._slice_cache.get(ck)
        if cached is not None:
            return cached
        entries = self.backend_tx.edge_store_query(
            KeySliceQuery(self.graph.idm.get_key(vid), q)
        )
        self._slice_cache[ck] = entries
        return entries

    def prefetch(
        self, vertices: Sequence[Vertex], direction: Direction, labels: Sequence[str]
    ) -> None:
        """Batched multi-vertex slice prefetch (the multi-query path,
        reference: StandardJanusGraphTx.executeMultiQuery:1118): fills the
        per-tx slice cache so the get_edges that follow hit memory, in
        chunks of query.batch-size vertices."""
        vids = [v.id for v in vertices if not v.is_new]
        if not vids:
            return
        chunk = self.graph.config.get("query.batch-size")
        idm = self.graph.idm
        for q in self._edge_slices(direction, labels):
            missing = [vid for vid in vids if (vid, q) not in self._slice_cache]
            for lo in range(0, len(missing), chunk):
                part = missing[lo:lo + chunk]
                res = self.backend_tx.edge_store_multi_query(
                    [idm.get_key(vid) for vid in part], q
                )
                for vid in part:
                    self._slice_cache[(vid, q)] = res[idm.get_key(vid)]

    # ------------------------------------------------------------------ labels
    def get_vertex_label(self, v: Vertex) -> str:
        with self._lock:
            lid = self._new_vertex_labels.get(v.id)
        if lid is None:
            es = self.graph.edge_serializer
            q = es.get_type_slice(
                self.graph.system_types.VERTEX_LABEL_EDGE, True, Direction.OUT
            )
            entries = self._read_slice(v.id, q)
            if not entries:
                return "vertex"
            rc = es.parse_relation(entries[0], self._codec_schema)
            lid = rc.other_vertex_id
        el = self.schema_by_id(lid)
        return el.name if el is not None else "vertex"

    # ------------------------------------------------------------------ commit
    def commit(self) -> None:
        if not self._open:
            return
        if self.metrics_group:
            registry.counter(f"{self.metrics_group}.commit").inc()
        with self._lock:
            added = sum(len(v) for v in self._added.values())
            deleted = len(self._deleted)
        with span(
            "tx.commit", added=added, deleted=deleted,
            lifetime_ms=round((time.perf_counter_ns() - self._t0_ns) / 1e6, 3),
            group=self.metrics_group,
        ):
            with registry.time("tx.commit"):
                try:
                    if self.has_mutations():
                        self.graph.commit_tx(self)
                    self.backend_tx.commit()
                except BaseException:
                    self.backend_tx.rollback()
                    raise
                finally:
                    self._open = False

    def rollback(self) -> None:
        registry.counter("tx.rollback").inc()
        with span(
            "tx.rollback",
            lifetime_ms=round((time.perf_counter_ns() - self._t0_ns) / 1e6, 3),
        ):
            self.backend_tx.rollback()
        self._open = False

    def has_mutations(self) -> bool:
        return bool(
            any(self._added.values())
            or self._deleted
            or self._new_vertex_labels
            or self._removed_vertices
        )

    @property
    def is_open(self) -> bool:
        return self._open
