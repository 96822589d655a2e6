"""Schema model: property keys, edge labels, vertex labels — stored as
vertices in the graph itself.

Capability parity with the reference's type system
(reference: graphdb/types/ — schema elements are vertices with system
properties holding a TypeDefinitionMap; types/system/BaseKey.java system
types with fixed ids; database/cache/StandardSchemaCache.java:206 name->id
and id->definition caching).

A schema vertex's row holds:
  EXISTS          system property  (True)
  SCHEMA_NAME     system property  (the type name)
  SCHEMA_DEF      system property  (JSON-encoded definition map)
and the name->id mapping lives in the `graphindex` store under the system
schema-name index so lookups are one slice read.

The port's copy of ``janusgraph_tpu/core/schema.py``: ``SystemTypes``,
``PropertyKey``, ``EdgeLabel``, ``VertexLabel``, ``SchemaCache`` and the
definition codec, with the same definition bytes and the reference's 22
schema datatypes by their persisted names.
``RelationIndex`` (a vertex-centric index on an edge label) and
``IndexDefinition`` (a composite or mixed graph index) carry the same
definitions as the reference's, so either package loads the other's.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from threading import RLock
from typing import Dict, Optional, Tuple

from janusgraph_tpu_torch.core.codecs import (
    Cardinality,
    Consistency,
    Multiplicity,
    TypeInfo,
)
from janusgraph_tpu_torch.core.ids import IDManager, VertexIDType
from janusgraph_tpu_torch.core.predicates import Geoshape
from janusgraph_tpu_torch.exceptions import SchemaViolationError


class SystemTypes:
    """Fixed-id system schema types (reference: types/system/BaseKey.java,
    BaseLabel.java, SystemTypeManager.java). IDs are stable constants —
    they appear in storage cells."""

    def __init__(self, idm: IDManager):
        mk = idm.make_schema_id
        self.EXISTS = mk(VertexIDType.SYSTEM_PROPERTY_KEY, 1)
        self.SCHEMA_NAME = mk(VertexIDType.SYSTEM_PROPERTY_KEY, 2)
        self.SCHEMA_DEF = mk(VertexIDType.SYSTEM_PROPERTY_KEY, 3)
        self.VERTEX_LABEL_EDGE = mk(VertexIDType.SYSTEM_EDGE_LABEL, 1)
        self._infos = {
            self.EXISTS: TypeInfo(self.EXISTS, False),
            self.SCHEMA_NAME: TypeInfo(self.SCHEMA_NAME, False),
            self.SCHEMA_DEF: TypeInfo(self.SCHEMA_DEF, False),
            self.VERTEX_LABEL_EDGE: TypeInfo(self.VERTEX_LABEL_EDGE, True),
        }

    def type_info(self, type_id: int) -> Optional[TypeInfo]:
        return self._infos.get(type_id)


def _attribute_types() -> Dict[str, type]:
    """Schema-declarable property datatypes (reference: the ~60 datatype
    registrations at StandardSerializer.java:78-132; names are the stable
    schema-definition vocabulary persisted in schema cells)."""
    import uuid as _uuid
    from datetime import date as _d, datetime as _dt, time as _t, timedelta
    from decimal import Decimal as _Decimal

    import numpy as np

    from janusgraph_tpu_torch.core.attributes import BigInt as _BigInt, Char, Instant

    return {
        "Boolean": bool,
        "Long": int,
        "Double": float,
        "String": str,
        "Bytes": bytes,
        "Geoshape": Geoshape,
        "FloatList": list,
        "Date": _dt,
        "UUID": _uuid.UUID,
        "Byte": np.int8,
        "Short": np.int16,
        "Int": np.int32,
        "Long64": np.int64,
        "Float": np.float32,
        "Char": Char,
        "Instant": Instant,
        "Duration": timedelta,
        "LocalDate": _d,
        "LocalTime": _t,
        "Array": np.ndarray,
        "BigInteger": _BigInt,
        "Decimal": _Decimal,
    }


_DATA_TYPES: Dict[str, type] = _attribute_types()
_DATA_TYPE_NAMES = {v: k for k, v in _DATA_TYPES.items()}


@dataclass(frozen=True)
class PropertyKey:
    """A property key definition (reference: core/PropertyKey.java)."""

    id: int
    name: str
    data_type: type
    cardinality: Cardinality = Cardinality.SINGLE
    consistency: Consistency = Consistency.DEFAULT
    #: seconds until cells of this type expire (0 = never); requires a
    #: cell-TTL backend (reference: ManagementSystem.setTTL)
    ttl_seconds: int = 0

    @property
    def is_property_key(self) -> bool:
        return True

    @property
    def is_edge_label(self) -> bool:
        return False

    def definition(self) -> dict:
        return {
            "kind": "property",
            "dataType": _DATA_TYPE_NAMES[self.data_type],
            "cardinality": int(self.cardinality),
            "consistency": int(self.consistency),
            "ttl": self.ttl_seconds,
        }

    def type_info(self) -> TypeInfo:
        return TypeInfo(self.id, False, self.cardinality)


@dataclass(frozen=True)
class EdgeLabel:
    """An edge label definition (reference: core/EdgeLabel.java)."""

    id: int
    name: str
    multiplicity: Multiplicity = Multiplicity.MULTI
    # property-key ids whose ordered fixed-width encodings form the sort key
    sort_key: Tuple[int, ...] = ()
    unidirected: bool = False
    consistency: Consistency = Consistency.DEFAULT
    ttl_seconds: int = 0
    #: schema constraints (reference: SchemaManager.addProperties /
    #: addConnection) — enforcement is gated by the schema.constraints
    #: option; when enabled, EMPTY tuples mean nothing is declared (all
    #: writes reject in 'none' mode, auto mode declares on first write)
    allowed_property_ids: Tuple[int, ...] = ()
    connections: Tuple[Tuple[int, int], ...] = ()  # (outV label id, inV label id)

    @property
    def is_property_key(self) -> bool:
        return False

    @property
    def is_edge_label(self) -> bool:
        return True

    def definition(self) -> dict:
        d = {
            "kind": "edge",
            "multiplicity": int(self.multiplicity),
            "sortKey": list(self.sort_key),
            "unidirected": self.unidirected,
            "consistency": int(self.consistency),
            "ttl": self.ttl_seconds,
        }
        if self.allowed_property_ids:
            d["allowedProps"] = list(self.allowed_property_ids)
        if self.connections:
            d["connections"] = [list(c) for c in self.connections]
        return d

    def type_info(self) -> TypeInfo:
        return TypeInfo(self.id, True, Cardinality.SINGLE, self.sort_key)


@dataclass(frozen=True)
class VertexLabel:
    """A vertex label (reference: core/VertexLabel.java). `partitioned`
    marks vertex-cut labels whose adjacency is spread over all partitions."""

    id: int
    name: str
    partitioned: bool = False
    static: bool = False
    ttl_seconds: int = 0
    #: schema constraints (reference: SchemaManager.addProperties)
    allowed_property_ids: Tuple[int, ...] = ()

    def definition(self) -> dict:
        d = {
            "kind": "vertexlabel",
            "partitioned": self.partitioned,
            "static": self.static,
            "ttl": self.ttl_seconds,
        }
        if self.allowed_property_ids:
            d["allowedProps"] = list(self.allowed_property_ids)
        return d


@dataclass(frozen=True)
class RelationIndex:
    """A vertex-centric index on one edge label, built AFTER the label
    exists (reference: core/schema/RelationTypeIndex.java via
    mgmt.buildEdgeIndex): edges of the label are additionally written as
    cells under THIS type id with the index's sort key encoded in the
    column, so sort-range slices work without the label itself being
    sort-keyed. Index cells are invisible to untyped edge enumeration."""

    id: int
    name: str
    label_id: int
    #: property-key ids forming the index sort key (fixed-width encodings)
    sort_key: Tuple[int, ...] = ()
    #: Direction value the index covers (int(Direction.BOTH) = both)
    direction: int = 2
    # REGISTERED (written, not yet queryable) -> ENABLED -> DISABLED
    status: str = "REGISTERED"

    @property
    def is_property_key(self) -> bool:
        return False

    @property
    def is_edge_label(self) -> bool:
        return False

    def definition(self) -> dict:
        return {
            "kind": "relindex",
            "label": self.label_id,
            "sortKey": list(self.sort_key),
            "direction": self.direction,
            "status": self.status,
        }

    def type_info(self) -> TypeInfo:
        return TypeInfo(self.id, True, Cardinality.SINGLE, self.sort_key)

    def sort_key_bytes(self, serializer, props) -> Optional[bytes]:
        """Order-preserving index sort-key bytes for an edge's properties,
        or None when a key is missing (such edges are simply not indexed).
        The ONE encoding shared by the write path, the reindex job, and
        the tx overlay filter."""
        parts = []
        for key_id in self.sort_key:
            if not props or key_id not in props:
                return None
            parts.append(serializer.write_ordered(props[key_id]))
        return b"".join(parts)


@dataclass(frozen=True)
class IndexDefinition:
    """A graph index over property keys, optionally label-constrained.
    Composite (exact-match rows in `graphindex`) or mixed (documents in an
    external IndexProvider) — reference: core/schema/JanusGraphIndex.java;
    mixed/composite split graphdb/types/CompositeIndexType +
    MixedIndexType."""

    id: int
    name: str
    key_ids: Tuple[int, ...]
    unique: bool = False
    label_constraint: Optional[str] = None
    # lifecycle (reference core/schema/SchemaStatus.java):
    # INSTALLED -> REGISTERED -> ENABLED -> DISABLED
    status: str = "ENABLED"
    mixed: bool = False
    backing: Optional[str] = None  # index backend shorthand for mixed
    # key_id -> Mapping name (TEXT/STRING/TEXTSTRING), mixed only
    mappings: Tuple[Tuple[int, str], ...] = ()

    def definition(self) -> dict:
        d = {
            "kind": "index",
            "keys": list(self.key_ids),
            "unique": self.unique,
            "label": self.label_constraint,
            "status": self.status,
        }
        if self.mixed:
            d["mixed"] = True
            d["backing"] = self.backing
            d["mappings"] = [list(m) for m in self.mappings]
        return d

    def mapping_for(self, key_id: int) -> str:
        for kid, m in self.mappings:
            if kid == key_id:
                return m
        return "DEFAULT"


def schema_element_from_definition(sid: int, name: str, d: dict):
    kind = d["kind"]
    if kind == "property":
        return PropertyKey(
            sid,
            name,
            _DATA_TYPES[d["dataType"]],
            Cardinality(d["cardinality"]),
            Consistency(d.get("consistency", 0)),
            d.get("ttl", 0),
        )
    if kind == "edge":
        return EdgeLabel(
            sid,
            name,
            Multiplicity(d["multiplicity"]),
            tuple(d.get("sortKey", ())),
            d.get("unidirected", False),
            Consistency(d.get("consistency", 0)),
            d.get("ttl", 0),
            tuple(d.get("allowedProps", ())),
            tuple(tuple(c) for c in d.get("connections", ())),
        )
    if kind == "vertexlabel":
        return VertexLabel(
            sid, name, d.get("partitioned", False), d.get("static", False),
            d.get("ttl", 0),
            tuple(d.get("allowedProps", ())),
        )
    if kind == "relindex":
        return RelationIndex(
            sid,
            name,
            d["label"],
            tuple(d.get("sortKey", ())),
            d.get("direction", 2),
            d.get("status", "REGISTERED"),
        )
    if kind == "index":
        return IndexDefinition(
            sid,
            name,
            tuple(d["keys"]),
            d.get("unique", False),
            d.get("label"),
            d.get("status", "ENABLED"),
            d.get("mixed", False),
            d.get("backing"),
            tuple((int(k), str(m)) for k, m in d.get("mappings", ())),
        )
    raise SchemaViolationError(f"unknown schema kind {kind!r}")


def encode_definition(d: dict) -> bytes:
    return json.dumps(d, sort_keys=True).encode()


def decode_definition(data: bytes) -> dict:
    return json.loads(data.decode())


class SchemaCache:
    """Name->element and id->element cache with explicit invalidation
    (reference: StandardSchemaCache.java:206). Loading is delegated to the
    graph, which reads schema vertices from storage."""

    def __init__(self, loader_by_name, loader_by_id):
        self._by_name: Dict[str, object] = {}
        self._by_id: Dict[int, object] = {}
        self._load_name = loader_by_name
        self._load_id = loader_by_id
        self._lock = RLock()
        # bumped on every invalidation: a load that STARTED before a
        # concurrent invalidation must not repopulate the cache with its
        # (stale) result — same guard the slice cache uses
        self._generation = 0

    def get_by_name(self, name: str):
        with self._lock:
            el = self._by_name.get(name)
            gen = self._generation
        if el is not None:
            return el
        el = self._load_name(name)
        if el is not None:
            with self._lock:
                if self._generation == gen:
                    self._by_name[name] = el
                    self._by_id[el.id] = el
        return el

    def get_by_id(self, sid: int):
        with self._lock:
            el = self._by_id.get(sid)
            gen = self._generation
        if el is not None:
            return el
        el = self._load_id(sid)
        if el is not None:
            with self._lock:
                if self._generation == gen:
                    self._by_id[sid] = el
                    # index names are a separate namespace: never let an
                    # index shadow a relation type of the same name
                    if not isinstance(el, IndexDefinition):
                        self._by_name[el.name] = el
        return el

    def invalidate(self, name: Optional[str] = None) -> None:
        with self._lock:
            self._generation += 1
            if name is None:
                self._by_name.clear()
                self._by_id.clear()
            else:
                el = self._by_name.pop(name, None)
                if el is not None:
                    self._by_id.pop(el.id, None)

    def invalidate_id(self, sid: int) -> None:
        with self._lock:
            self._generation += 1
            el = self._by_id.pop(sid, None)
            if el is not None:
                self._by_name.pop(el.name, None)

    def data_type_for(self, serializer, key: "PropertyKey"):
        return serializer.serializer_for_type(key.data_type)
