"""Schema management: make property keys, edge labels and vertex labels —
the port's copy of the makers of ``janusgraph_tpu/core/management.py``
(``make_property_key``, ``make_edge_label``, ``make_vertex_label``,
persisted through ``graph.persist_schema_element``). Each schema operation
commits on its own, as in the reference.

Left out: indexes (composite, mixed, relation) and their lifecycle,
consistency modifiers, TTL, schema constraints and enumeration.
"""

from __future__ import annotations

from typing import Sequence

from janusgraph_tpu_torch.core.codecs import Cardinality, Multiplicity
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

    def _check_fresh(self, name: str) -> None:
        if not name or name.startswith("\x00"):
            raise SchemaViolationError(f"invalid schema name {name!r}")
        if self.graph.schema_cache.get_by_name(name) is not None:
            raise SchemaViolationError(f"schema name already exists: {name}")

    def _persist(self, el) -> None:
        self.graph.persist_schema_element(el)
