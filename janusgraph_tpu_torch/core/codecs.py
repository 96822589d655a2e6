"""Relation cell codec — how edges and properties become storage cells.

Capability parity with the reference's encoding stack
(reference: graphdb/database/EdgeSerializer.java:86-182 parseRelation /
:235-319 writeRelation; idhandling/IDHandler.java dir+type prefix;
idhandling/VariableLong.java), re-designed TPU-first:

The reference packs variable-length varints for compactness. We instead use
**fixed-width big-endian fields** so that the OLAP bulk loader can decode an
entire adjacency row with vectorized numpy views (no per-edge Python) — the
dominant cost in store→CSR conversion. Byte-order still equals semantic
order, so column *ranges* still express vertex-centric queries exactly like
the reference's getBounds slices.

Cell layouts (column || value), all ints big-endian:

  EDGE      col = [cat:1][type:8][dir:1][sklen:1][sortkey][other_vid:8][rel:8]
            val = inline properties ([count:2] + ([key:8][vlen:2][framed])*)
  PROP single  col = [cat:1][type:8][0]
               val = [rel:8][framed value]
  PROP list    col = [cat:1][type:8][0][rel:8]
               val = [framed value]
  PROP set     col = [cat:1][type:8][0][framed value]
               val = [rel:8]

  cat: 0 = system property, 1 = user property, 2 = system edge, 3 = user edge
  dir: 0 = OUT, 1 = IN

With no sort key and no inline properties (the bulk-load common case) an edge
column is exactly 27 bytes — `bulk decode` = one reshape + three strided views.

The port's copy of ``janusgraph_tpu/core/codecs.py``, with the same bytes.
The traversal's vertex-centric reads slice through
``get_adjacency_slice`` (one neighbour) and ``get_sort_range_slice`` (a
sort-key range). Left out: ``get_bounds`` (whole relation categories),
which nothing in the port reads.
"""

from __future__ import annotations

import re
import struct
from dataclasses import dataclass
from enum import IntEnum
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from janusgraph_tpu_torch.core.attributes import Serializer
from janusgraph_tpu_torch.core.ids import IDManager, VertexIDType
from janusgraph_tpu_torch.exceptions import JanusGraphTorchError
from janusgraph_tpu_torch.storage.kcvs import Entry, SliceQuery


class CodecError(JanusGraphTorchError):
    pass


class Direction(IntEnum):
    OUT = 0
    IN = 1
    BOTH = 2

    def opposite(self) -> "Direction":
        if self is Direction.BOTH:
            return self
        return Direction.IN if self is Direction.OUT else Direction.OUT


class RelationCategory(IntEnum):
    PROPERTY = 0
    EDGE = 1
    RELATION = 2  # both


class Cardinality(IntEnum):
    SINGLE = 0
    LIST = 1
    SET = 2


class Multiplicity(IntEnum):
    """Edge multiplicity constraints (reference: core/Multiplicity.java)."""

    MULTI = 0
    SIMPLE = 1      # at most one edge of this label between any vertex pair
    ONE2MANY = 2    # in-vertex has at most one incoming
    MANY2ONE = 3    # out-vertex has at most one outgoing
    ONE2ONE = 4


class Consistency(IntEnum):
    """Per-type consistency modifier (reference:
    core/schema/ConsistencyModifier.java; applied via mgmt.setConsistency).
    LOCK: commits touching relations of this type acquire consistent-key
    locks with expected-value checks, serializing concurrent writers across
    instances. FORK (edge labels only): modifying an existing edge deletes
    it and writes a NEW relation id instead of updating in place, so
    concurrent eventual-consistency modifications fork rather than
    clobber."""

    DEFAULT = 0
    LOCK = 1
    FORK = 2


# category bytes
_CAT_SYS_PROP = 0
_CAT_USER_PROP = 1
_CAT_SYS_EDGE = 2
_CAT_USER_EDGE = 3

#: meta-carrying property cells prefix their inline-props block with this
#: marker — 0xFFFF is never a valid serializer type id, so meta-free cells
#: (whose next 2 bytes are the value's type id) stay unambiguous
_META_MARKER = b"\xff\xff"

#: hot-decode helpers: compiled Structs skip per-call format parsing and
#: the table skips IntEnum.__call__ (parse_relation runs once per cell)
_S_HEADER = struct.Struct(">BQB")
_S_QQ = struct.Struct(">QQ")
_DIR_BY_VALUE = {
    Direction.OUT.value: Direction.OUT,
    Direction.IN.value: Direction.IN,
    Direction.BOTH.value: Direction.BOTH,
}

EDGE_COL_FIXED = 1 + 8 + 1 + 1 + 8 + 8  # cat, type, dir, sklen=0, other, rel


@dataclass
class RelationCache:
    """Decoded cell (reference: graphdb/relations/RelationCache.java)."""

    relation_id: int
    type_id: int
    direction: Direction
    other_vertex_id: Optional[int] = None  # edges only
    value: object = None                   # property value (properties only)
    properties: Optional[Dict[int, object]] = None  # edge inline props
    sort_key: bytes = b""                  # edges: raw sort-key bytes

    @property
    def is_edge(self) -> bool:
        return self.other_vertex_id is not None


@dataclass(frozen=True)
class RelationIdentifier:
    """Globally unique edge identifier: (relation-id, out-vid, type-id, in-vid)
    (reference: janusgraph-driver .../RelationIdentifier.java:131)."""

    relation_id: int
    out_vertex_id: int
    type_id: int
    in_vertex_id: int

    def __str__(self):
        return (
            f"{self.relation_id}-{self.out_vertex_id}-"
            f"{self.type_id}-{self.in_vertex_id}"
        )

    _FORMAT = re.compile(r"^(-?\d+)-(-?\d+)-(-?\d+)-(-?\d+)$")

    @classmethod
    def parse(cls, s: str) -> "RelationIdentifier":
        m = cls._FORMAT.match(s)
        if m is None:
            raise CodecError(f"malformed relation identifier: {s}")
        return cls(*(int(p) for p in m.groups()))


def _increment(prefix: bytes) -> bytes:
    """Smallest byte string strictly greater than every string starting with
    `prefix` (byte increment with carry; all-0xff prefixes shorten)."""
    b = bytearray(prefix)
    while b and b[-1] == 0xFF:
        b.pop()
    if not b:
        raise CodecError("cannot increment all-0xff prefix")
    b[-1] += 1
    return bytes(b)


def _is_system_type(type_id: int, idm: IDManager) -> bool:
    t = idm.id_type(type_id)
    return t in (VertexIDType.SYSTEM_PROPERTY_KEY, VertexIDType.SYSTEM_EDGE_LABEL)


def _category_byte(type_id: int, is_edge: bool, idm: IDManager) -> int:
    sys = _is_system_type(type_id, idm)
    if is_edge:
        return _CAT_SYS_EDGE if sys else _CAT_USER_EDGE
    return _CAT_SYS_PROP if sys else _CAT_USER_PROP


class TypeInfo:
    """The slice of schema the codec needs about one relation type."""

    __slots__ = ("type_id", "is_edge", "cardinality", "sort_key")

    def __init__(
        self,
        type_id: int,
        is_edge: bool,
        cardinality: Cardinality = Cardinality.SINGLE,
        sort_key: Tuple[int, ...] = (),
    ):
        self.type_id = type_id
        self.is_edge = is_edge
        self.cardinality = cardinality
        self.sort_key = sort_key


SchemaLookup = Callable[[int], TypeInfo]


class EdgeSerializer:
    """Writes/parses relation cells. Stateless apart from registries."""

    def __init__(self, serializer: Serializer, id_manager: IDManager):
        self.serializer = serializer
        self.idm = id_manager

    # ------------------------------------------------------------------ write
    def write_edge(
        self,
        type_id: int,
        direction: Direction,
        other_vid: int,
        relation_id: int,
        sort_key: bytes = b"",
        inline_properties: Optional[Dict[int, object]] = None,
    ) -> Entry:
        if direction not in (Direction.OUT, Direction.IN):
            raise CodecError("edge cells are written per concrete direction")
        if len(sort_key) > 255:
            raise CodecError("sort key too long (max 255 bytes)")
        cat = _category_byte(type_id, True, self.idm)
        col = struct.pack(
            ">BQBB", cat, type_id, int(direction), len(sort_key)
        ) + sort_key + struct.pack(">QQ", other_vid, relation_id)
        val = self._write_inline_props(inline_properties or {})
        return (col, val)

    def write_property(
        self,
        type_id: int,
        relation_id: int,
        value,
        cardinality: Cardinality = Cardinality.SINGLE,
        meta: Optional[Dict[int, object]] = None,
    ) -> Entry:
        """`meta`: META-properties (properties ON this vertex property —
        the reference's JanusGraphVertexProperty-extends-Relation feature),
        the same inline-props block edge cells use, marker-prefixed and
        placed BEFORE the framed value: variable-length serializers read
        to the end of the buffer, so the value must stay last; the
        0xFFFF marker (never a valid type id) distinguishes meta-carrying
        cells, keeping meta-free cells byte-identical to the old layout."""
        cat = _category_byte(type_id, False, self.idm)
        head = struct.pack(">BQB", cat, type_id, 0)
        framed = self.serializer.write_object(value)
        metas = (
            _META_MARKER + self._write_inline_props(meta) if meta else b""
        )
        if cardinality == Cardinality.SINGLE:
            return (head, struct.pack(">Q", relation_id) + metas + framed)
        if cardinality == Cardinality.LIST:
            return (head + struct.pack(">Q", relation_id), metas + framed)
        # SET: value bytes in the column => set semantics by column uniqueness
        return (head + framed, struct.pack(">Q", relation_id) + metas)

    def _write_inline_props(self, props: Dict[int, object]) -> bytes:
        if not props:
            return b""
        out = [struct.pack(">H", len(props))]
        for key_id in sorted(props):
            framed = self.serializer.write_object(props[key_id])
            out.append(struct.pack(">QH", key_id, len(framed)) + framed)
        return b"".join(out)

    # ------------------------------------------------------------------ parse
    def parse_relation(
        self, entry: Entry, schema: SchemaLookup
    ) -> RelationCache:
        # THE hottest OLTP read decode (one call per cell) — compiled
        # Structs + a direction lookup table, no enum construction
        col, val = entry
        cat, type_id, direction = _S_HEADER.unpack_from(col)
        if direction > 2:  # corrupt cell: keep a diagnosable message
            raise ValueError(f"{direction} is not a valid Direction byte")
        if cat in (_CAT_SYS_EDGE, _CAT_USER_EDGE):
            sklen = col[10]
            off = 11 + sklen
            other_vid, rel_id = _S_QQ.unpack_from(col, off)
            props = self._parse_inline_props(val) if val else None
            return RelationCache(
                relation_id=rel_id,
                type_id=type_id,
                direction=_DIR_BY_VALUE[direction],
                other_vertex_id=other_vid,
                properties=props,
                sort_key=col[11:off],
            )
        info = schema(type_id)
        if info.cardinality == Cardinality.SINGLE:
            (rel_id,) = struct.unpack(">Q", val[:8])
            metas, rest = self._split_meta(val[8:])
            value, _ = self.serializer.read_object(rest)
        elif info.cardinality == Cardinality.LIST:
            (rel_id,) = struct.unpack(">Q", col[10:18])
            metas, rest = self._split_meta(val)
            value, _ = self.serializer.read_object(rest)
        else:  # SET
            value, _ = self.serializer.read_object(col[10:])
            (rel_id,) = struct.unpack(">Q", val[:8])
            metas, _rest = self._split_meta(val[8:])
        return RelationCache(
            relation_id=rel_id,
            type_id=type_id,
            direction=Direction.OUT,
            value=value,
            properties=metas,
        )

    def _parse_inline_props(self, data: bytes) -> Dict[int, object]:
        return self._parse_inline_props_sized(data)[0]

    def _parse_inline_props_sized(self, data: bytes):
        """(props, bytes consumed) — the block is self-delimiting, so a
        framed value may follow it (meta-carrying property cells)."""
        (count,) = struct.unpack(">H", data[:2])
        off = 2
        props: Dict[int, object] = {}
        for _ in range(count):
            key_id, vlen = struct.unpack(">QH", data[off : off + 10])
            off += 10
            value, _ = self.serializer.read_object(data[off : off + vlen])
            off += vlen
            props[key_id] = value
        return props, off

    def _split_meta(self, buf: bytes):
        """(meta props or None, remaining buffer) — strips the marker-
        prefixed meta block so the variable-length value read stays last."""
        if buf[:2] == _META_MARKER:
            props, off = self._parse_inline_props_sized(buf[2:])
            return props, buf[2 + off:]
        return None, buf

    # ------------------------------------------------------------------ bounds
    def user_relations_bounds(self) -> Tuple[SliceQuery, SliceQuery]:
        """User properties + user edges, as two ranges (cat 1 and cat 3)."""
        return (
            SliceQuery(bytes([_CAT_USER_PROP]), bytes([_CAT_USER_PROP + 1])),
            SliceQuery(bytes([_CAT_USER_EDGE]), bytes([_CAT_USER_EDGE + 1])),
        )

    def get_type_slice(
        self,
        type_id: int,
        is_edge: bool,
        direction: Direction = Direction.BOTH,
        sort_key_prefix: bytes = b"",
        sort_key_len: int = 0,
    ) -> SliceQuery:
        """Column range for one relation type (optionally one direction and a
        sort-key prefix) — the vertex-centric index scan.

        Sort-key constraint ranges require ``sort_key_len``, the label's total
        encoded sort-key width. Design restriction (TPU-first): sort-key
        property encodings are fixed-width order-preserving (ints, doubles,
        dates), so ``sort_key_len`` is a schema constant per label and a byte
        prefix range is an exact index scan. (The reference permits
        variable-width sort keys via its varint scheme; we trade that for
        vectorized decodability.)
        """
        cat = _category_byte(type_id, is_edge, self.idm)
        prefix = struct.pack(">BQ", cat, type_id)
        if direction == Direction.BOTH:
            return SliceQuery(prefix + b"\x00", prefix + b"\x02")
        d = int(direction)
        if sort_key_prefix:
            if not is_edge:
                raise CodecError("sort keys only apply to edges")
            if len(sort_key_prefix) > sort_key_len:
                raise CodecError("sort key prefix longer than label sort key")
            base = prefix + bytes([d, sort_key_len])
            start = base + sort_key_prefix
            return SliceQuery(start, _increment(start))
        return SliceQuery(prefix + bytes([d]), prefix + bytes([d + 1]))

    # ------------------------------------------------- vertex-centric slices
    def get_adjacency_slice(
        self, type_id: int, direction: Direction, other_vid: int
    ) -> SliceQuery:
        """Point-lookup slice for edges of one type+direction to ONE specific
        neighbor (reference: the AdjacentVertex*OptimizerStrategy rewrites —
        graphdb/tinkerpop/optimize/strategy/AdjacentVertexFilter/HasId/Is —
        turn neighborhood iteration into adjacency checks; here the check is
        a single column-range read because other_vid sits at a fixed offset
        in sort-key-free edge columns)."""
        if direction == Direction.BOTH:
            raise CodecError("adjacency lookups need a concrete direction")
        cat = _category_byte(type_id, True, self.idm)
        base = struct.pack(">BQBB", cat, type_id, int(direction), 0)
        start = base + struct.pack(">Q", other_vid)
        return SliceQuery(start, _increment(start))

    def get_sort_range_slice(
        self,
        type_id: int,
        direction: Direction,
        lo: bytes,
        hi: bytes,
        sort_key_len: int,
    ) -> SliceQuery:
        """Column range covering sort keys in [lo, hi) for one edge type and
        direction — the vertex-centric index RANGE scan (reference:
        BasicVertexCentricQueryBuilder.java:780 interval constraints compiled
        into key ranges by EdgeSerializer.java:235-319's order-preserving
        sort-key encoding). lo/hi are order-preserving encodings of sort-key
        value prefixes; hi is exclusive at its prefix."""
        if direction == Direction.BOTH:
            raise CodecError("sort-range scans need a concrete direction")
        if len(lo) > sort_key_len or len(hi) > sort_key_len:
            raise CodecError("sort-range bound longer than label sort key")
        cat = _category_byte(type_id, True, self.idm)
        base = struct.pack(">BQ", cat, type_id) + bytes(
            [int(direction), sort_key_len]
        )
        end = base + hi if hi else _increment(base)
        return SliceQuery(base + lo, end)

    # ------------------------------------------------------------- bulk decode
    def bulk_decode_edges(
        self, columns: List[bytes]
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        """Vectorized decode of fixed-width edge columns (sklen=0).

        Returns (type_ids, directions, other_vids, relation_ids) as numpy
        arrays. Columns with sort keys fall back to per-entry parsing by the
        caller (they are detectable: len != EDGE_COL_FIXED).
        This replaces the reference's per-entry parseRelation hot loop
        (EdgeSerializer.java:86) for the OLAP store→CSR path.
        """
        if not columns:
            z = np.empty(0, dtype=np.int64)
            return z, z.copy(), z.copy(), z.copy()
        buf = np.frombuffer(b"".join(columns), dtype=np.uint8).reshape(
            len(columns), EDGE_COL_FIXED
        )
        type_ids = buf[:, 1:9].copy().view(">u8").astype(np.int64).ravel()
        dirs = buf[:, 9].astype(np.int64)
        other = buf[:, 11:19].copy().view(">u8").astype(np.int64).ravel()
        rel = buf[:, 19:27].copy().view(">u8").astype(np.int64).ravel()
        return type_ids, dirs, other, rel
