"""Schema management — the port's copy of the makers and type modifiers of
``janusgraph_tpu/core/management.py``: ``make_property_key``,
``make_edge_label``, ``make_vertex_label``, the consistency modifier
(``set_consistency``/``get_consistency``), time-to-live
(``set_ttl``/``get_ttl``) and the schema constraints (``add_properties``,
``add_connection``), each persisted through
``graph.persist_schema_element``. Each schema operation commits on its
own, as in the reference. A changed element is evicted from this
instance's caches (``graph.evict_schema_element``); the reference also
broadcasts the eviction over its management log to other instances
(ROADMAP Queue A #5.3).

Left out: indexes (composite, mixed, relation) and their lifecycle
(#5.2), and enumeration.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

from janusgraph_tpu_torch.core.codecs import Cardinality, Consistency, Multiplicity
from janusgraph_tpu_torch.core.ids import VertexIDType
from janusgraph_tpu_torch.core.schema import (
    _DATA_TYPE_NAMES,
    EdgeLabel,
    PropertyKey,
    VertexLabel,
)
from janusgraph_tpu_torch.exceptions import SchemaViolationError

#: graphindex row prefix of the schema name -> id lookup
SCHEMA_NAME_INDEX_PREFIX = b"\x00sn\x00"


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
        self.graph.evict_schema_element(el.id)
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
        self.graph.evict_schema_element(el.id)
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
        self.graph.evict_schema_element(el.id)
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

    def _check_fresh(self, name: str) -> None:
        if not name or name.startswith("\x00"):
            raise SchemaViolationError(f"invalid schema name {name!r}")
        if self.graph.schema_cache.get_by_name(name) is not None:
            raise SchemaViolationError(f"schema name already exists: {name}")

    def _persist(self, el) -> None:
        self.graph.persist_schema_element(el)
