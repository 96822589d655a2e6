"""Runtime graph elements: Vertex, Edge, VertexProperty — the port's copy
of ``janusgraph_tpu/core/elements.py`` (all of it).

Capability parity with the reference's element hierarchy
(reference: graphdb/vertices/*, graphdb/relations/*, graphdb/internal/
ElementLifeCycle.java). Elements are thin handles onto their transaction;
all data access goes through the tx so the added/deleted overlay and vertex
cache apply uniformly.
"""

from __future__ import annotations

from enum import Enum
from typing import TYPE_CHECKING, Dict, Iterator, List, Optional

from janusgraph_tpu_torch.core.codecs import Direction, RelationIdentifier
from janusgraph_tpu_torch.exceptions import InvalidElementError

if TYPE_CHECKING:
    from janusgraph_tpu_torch.core.tx import Transaction


# Vertex defines a `property(key, value)` method (TinkerPop vocabulary),
# which shadows the builtin decorator inside class bodies — keep a handle.
_py_property = property


class LifeCycle(Enum):
    NEW = 1
    LOADED = 2
    MODIFIED = 3
    REMOVED = 4


class Element:
    __slots__ = ("id", "tx", "lifecycle")

    def __init__(self, eid: int, tx: "Transaction", lifecycle: LifeCycle):
        self.id = eid
        self.tx = tx
        self.lifecycle = lifecycle

    @property
    def is_new(self) -> bool:
        return self.lifecycle is LifeCycle.NEW

    @property
    def is_removed(self) -> bool:
        return self.lifecycle is LifeCycle.REMOVED

    def _check_alive(self):
        if self.is_removed:
            raise InvalidElementError("element has been removed", self)


class Vertex(Element):
    __slots__ = ("_label_cache",)

    def __init__(self, vid: int, tx: "Transaction", lifecycle: LifeCycle):
        super().__init__(vid, tx, lifecycle)
        self._label_cache: Optional[str] = None

    # -- properties ---------------------------------------------------------
    def property(self, key: str, value=None, **meta) -> "VertexProperty":
        if value is not None:
            return self.tx.add_property(self, key, value, **meta)
        props = self.tx.get_properties(self, key)
        if not props:
            raise KeyError(key)
        return props[0]

    def value(self, key: str, default=None):
        props = self.tx.get_properties(self, key)
        if not props:
            return default
        return props[0].value

    def values(self, key: str) -> List[object]:
        return [p.value for p in self.tx.get_properties(self, key)]

    def properties(self, *keys: str) -> List["VertexProperty"]:
        self._check_alive()
        return self.tx.get_properties(self, *keys)

    # -- label --------------------------------------------------------------
    @_py_property
    def label(self) -> str:
        if self._label_cache is None:
            self._label_cache = self.tx.get_vertex_label(self)
        return self._label_cache

    # -- edges --------------------------------------------------------------
    def edges(self, direction: Direction = Direction.BOTH, *labels: str) -> List["Edge"]:
        self._check_alive()
        return self.tx.get_edges(self, direction, labels)

    def add_edge(self, label: str, other: "Vertex", **props) -> "Edge":
        return self.tx.add_edge(self, label, other, **props)

    def vertices(self, direction: Direction = Direction.BOTH, *labels: str) -> List["Vertex"]:
        out = []
        for e in self.edges(direction, *labels):
            out.append(e.other(self))
        return out

    def remove(self) -> None:
        self.tx.remove_vertex(self)

    def __repr__(self):
        return f"v[{self.id}]"

    def __eq__(self, other):
        return isinstance(other, Vertex) and other.id == self.id

    def __hash__(self):
        return hash(self.id)


class Relation(Element):
    """Common base of Edge and VertexProperty (both are 'relations')."""

    __slots__ = ("type_id",)

    def __init__(self, rid: int, type_id: int, tx, lifecycle: LifeCycle):
        super().__init__(rid, tx, lifecycle)
        self.type_id = type_id


class Edge(Relation):
    __slots__ = (
        "out_vertex", "in_vertex", "_props", "_sort_key", "_replacement"
    )

    def __init__(
        self,
        rid: int,
        type_id: int,
        out_vertex: Vertex,
        in_vertex: Vertex,
        tx,
        lifecycle: LifeCycle,
        props: Optional[Dict[int, object]] = None,
        sort_key: bytes = b"",
    ):
        super().__init__(rid, type_id, tx, lifecycle)
        self.out_vertex = out_vertex
        self.in_vertex = in_vertex
        self._props: Dict[int, object] = props or {}
        self._sort_key = sort_key
        # set when a LOADED edge is rewritten by set_property: the live
        # replacement relation this handle forwards further updates to
        self._replacement: Optional["Edge"] = None

    @property
    def label(self) -> str:
        return self.tx.schema_name(self.type_id)

    def other(self, v: Vertex) -> Vertex:
        if v.id == self.out_vertex.id:
            return self.in_vertex
        if v.id == self.in_vertex.id:
            return self.out_vertex
        raise InvalidElementError(f"{v} is not incident to edge", self)

    def value(self, key: str, default=None):
        pk = self.tx.schema_by_name(key)
        if pk is None:
            return default
        return self._props.get(pk.id, default)

    def property_values(self) -> Dict[str, object]:
        return {self.tx.schema_name(k): v for k, v in self._props.items()}

    def set_property(self, key: str, value) -> "Edge":
        """Set an inline property. Loaded edges are rewritten (see
        tx.set_edge_property); this handle then forwards further updates to
        the live replacement, and the replacement is returned either way —
        so chained e.set_property(...) calls compose."""
        if self._replacement is not None:
            return self._replacement.set_property(key, value)
        live = self.tx.set_edge_property(self, key, value)
        if live is not self:
            self._replacement = live
        return live

    @property
    def identifier(self) -> RelationIdentifier:
        return RelationIdentifier(
            self.id, self.out_vertex.id, self.type_id, self.in_vertex.id
        )

    def remove(self) -> None:
        self.tx.remove_edge(self)

    def __repr__(self):
        return f"e[{self.id}][{self.out_vertex.id}-{self.label}->{self.in_vertex.id}]"

    def __eq__(self, other):
        return (
            isinstance(other, Edge)
            and other.id == self.id
            and other.out_vertex.id == self.out_vertex.id
            and other.in_vertex.id == self.in_vertex.id
        )

    def __hash__(self):
        return hash((self.id, self.out_vertex.id, self.in_vertex.id))


class VertexProperty(Relation):
    __slots__ = ("vertex", "value", "_meta", "_replacement")

    def __init__(
        self, rid: int, type_id: int, vertex: Vertex, value, tx, lifecycle,
        meta=None,
    ):
        super().__init__(rid, type_id, tx, lifecycle)
        self.vertex = vertex
        self.value = value
        #: META-properties — properties on this property, keyed by the
        #: meta key's schema id (reference: JanusGraphVertexProperty
        #: extends Relation; TinkerPop vertexProperty.property(...))
        self._meta = dict(meta) if meta else {}
        self._replacement = None

    @property
    def key(self) -> str:
        return self.tx.schema_name(self.type_id)

    # -- meta-properties (mirrors the Edge inline-property API) ------------
    def value_of(self, key: str):
        """Meta-property value, or None (vp.value stays the property's own
        value — TinkerPop's vertexProperty.value(metaKey) analogue)."""
        el = self.tx.schema_by_name(key)
        if el is None:
            return None
        return self._meta.get(el.id)

    def property_values(self) -> dict:
        """{meta key name: value}."""
        return {
            self.tx.schema_name(tid): v for tid, v in self._meta.items()
        }

    def set_property(self, key: str, value) -> "VertexProperty":
        """Set a meta-property. New properties mutate in place; LOADED
        ones are rewritten (metas live inside the property cell) and this
        handle forwards to the live replacement — chained calls compose,
        like Edge.set_property."""
        if self._replacement is not None:
            return self._replacement.set_property(key, value)
        live = self.tx.set_meta_property(self, key, value)
        if live is not self:
            self._replacement = live
        return live

    def remove(self) -> None:
        self.tx.remove_property(self)

    def __repr__(self):
        return f"vp[{self.key}->{self.value!r}]"

    def __eq__(self, other):
        return (
            isinstance(other, VertexProperty)
            and other.id == self.id
            and other.vertex.id == self.vertex.id
        )

    def __hash__(self):
        return hash((self.id, self.vertex.id))
