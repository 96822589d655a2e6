"""Element ID scheme — 63-bit partitioned vertex IDs: the port's copy of
``janusgraph_tpu/core/ids.py`` (``VertexIDType``, ``IDManager``), all of
it, with the same bit layout, so ids and row keys equal the reference's.

Capability parity with the reference's ID manager
(reference: graphdb/idmanagement/IDManager.java:33-58 bit-table, :59-333
VertexIDType enum, getKey:480/getKeyID:496/getPartitionId:472,
getCanonicalVertexId:543), re-designed rather than copied:

    vertex id  = [ count | partition (P bits) | type-suffix ]
    row key    = [ partition (P bits) | count | type-suffix ]  (8 bytes BE)

The type suffix in the LOW bits tags the vertex class (normal / partitioned /
unmodifiable / schema kinds) so classification is a mask test. The row key
moves the partition to the HIGH bits so one storage partition is one
contiguous key range — this is what makes partition-parallel scans and the
TPU CSR block loader's per-shard key ranges trivial range queries.

Relation (edge/property instance) IDs are a separate plain-count namespace.
Temporary (not-yet-assigned) IDs are negative.
"""

from __future__ import annotations

from dataclasses import dataclass
from enum import Enum

import numpy as np

from janusgraph_tpu_torch.exceptions import InvalidIDError

TOTAL_BITS = 63  # keep ids positive in signed 64-bit interop

# --- type suffixes ----------------------------------------------------------
# Normal-family suffixes are 3 bits; schema suffixes are 6 bits:
# (kind << 3) | 0b111. The 0b111 low bits unambiguously mark "schema"
# because no normal-family suffix uses them.
NORMAL_SUFFIX_BITS = 3
SCHEMA_SUFFIX_BITS = 6
SCHEMA_MARK = 0b111


class VertexIDType(Enum):
    # value = (suffix, suffix_bits)
    NORMAL = (0b000, NORMAL_SUFFIX_BITS)
    PARTITIONED = (0b010, NORMAL_SUFFIX_BITS)      # vertex-cut vertices
    UNMODIFIABLE = (0b100, NORMAL_SUFFIX_BITS)
    # schema kinds
    USER_PROPERTY_KEY = ((0 << 3) | SCHEMA_MARK, SCHEMA_SUFFIX_BITS)
    USER_EDGE_LABEL = ((1 << 3) | SCHEMA_MARK, SCHEMA_SUFFIX_BITS)
    VERTEX_LABEL = ((2 << 3) | SCHEMA_MARK, SCHEMA_SUFFIX_BITS)
    SYSTEM_PROPERTY_KEY = ((3 << 3) | SCHEMA_MARK, SCHEMA_SUFFIX_BITS)
    SYSTEM_EDGE_LABEL = ((4 << 3) | SCHEMA_MARK, SCHEMA_SUFFIX_BITS)
    GENERIC_SCHEMA = ((5 << 3) | SCHEMA_MARK, SCHEMA_SUFFIX_BITS)

    @property
    def suffix(self) -> int:
        return self.value[0]

    @property
    def suffix_bits(self) -> int:
        return self.value[1]

    @property
    def is_schema(self) -> bool:
        return self.suffix_bits == SCHEMA_SUFFIX_BITS


_SCHEMA_KINDS = {
    t.suffix >> 3: t for t in VertexIDType if t.is_schema
}

SCHEMA_TYPES = (
    VertexIDType.USER_PROPERTY_KEY,
    VertexIDType.USER_EDGE_LABEL,
    VertexIDType.VERTEX_LABEL,
    VertexIDType.SYSTEM_PROPERTY_KEY,
    VertexIDType.SYSTEM_EDGE_LABEL,
    VertexIDType.GENERIC_SCHEMA,
)


#: low-3-bits -> normal-family type (plain dict: this is THE hottest id
#: decode — enum property descriptors cost ~2x the arithmetic around them)
_NORMAL_BY_LOW = {
    0b000: VertexIDType.NORMAL,
    0b010: VertexIDType.PARTITIONED,
    0b100: VertexIDType.UNMODIFIABLE,
}


def _suffix_of(vid: int) -> VertexIDType:
    low = vid & 0b111
    if low == SCHEMA_MARK:
        kind = (vid >> 3) & 0b111
        t = _SCHEMA_KINDS.get(kind)
        if t is None:
            raise InvalidIDError(f"unknown schema kind in id {vid}")
        return t
    t = _NORMAL_BY_LOW.get(low)
    if t is None:
        raise InvalidIDError(f"unrecognized id suffix in {vid}")
    return t


@dataclass(frozen=True)
class IDManager:
    """Encodes/decodes element IDs for a fixed partition-bit width."""

    partition_bits: int = 5  # 32 partitions by default

    def __post_init__(self):
        if not (0 <= self.partition_bits <= 16):
            raise InvalidIDError("partition_bits must be in [0, 16]")
        # frozen dataclass: the memo rides object.__setattr__ (it is pure
        # derived state, not identity — hashing/eq stay field-based)
        object.__setattr__(self, "_key_cache", {})
        object.__setattr__(self, "_num_partitions", 1 << self.partition_bits)

    @property
    def num_partitions(self) -> int:
        return self._num_partitions

    def count_bits(self, id_type: VertexIDType) -> int:
        return TOTAL_BITS - self.partition_bits - id_type.suffix_bits

    def max_count(self, id_type: VertexIDType) -> int:
        return (1 << self.count_bits(id_type)) - 1

    # -- construction -------------------------------------------------------
    def make_vertex_id(
        self, count: int, partition: int, id_type: VertexIDType = VertexIDType.NORMAL
    ) -> int:
        if count <= 0 or count > self.max_count(id_type):
            raise InvalidIDError(f"count {count} out of range for {id_type}")
        if not (0 <= partition < self.num_partitions):
            raise InvalidIDError(f"partition {partition} out of range")
        if id_type.is_schema and partition != 0:
            raise InvalidIDError("schema vertices live in partition 0")
        return (
            ((count << self.partition_bits) | partition) << id_type.suffix_bits
        ) | id_type.suffix

    def make_schema_id(self, id_type: VertexIDType, count: int) -> int:
        if not id_type.is_schema:
            raise InvalidIDError(f"{id_type} is not a schema type")
        return self.make_vertex_id(count, 0, id_type)

    def make_relation_id(self, count: int) -> int:
        if count <= 0:
            raise InvalidIDError("relation count must be positive")
        return count

    # -- decomposition ------------------------------------------------------
    def id_type(self, vid: int) -> VertexIDType:
        return _suffix_of(vid)

    def get_partition_id(self, vid: int) -> int:
        t = _suffix_of(vid)
        return (vid >> t.suffix_bits) & (self.num_partitions - 1)

    def get_count(self, vid: int) -> int:
        t = _suffix_of(vid)
        return vid >> (t.suffix_bits + self.partition_bits)

    def is_schema_vertex_id(self, vid: int) -> bool:
        return vid & SCHEMA_MARK == SCHEMA_MARK

    def is_partitioned_vertex_id(self, vid: int) -> bool:
        # the suffix as a literal: an enum lookup per call costs more than
        # the test (a scan asks this of every row)
        return vid & 0b111 == 0b010  # VertexIDType.PARTITIONED.suffix

    def is_user_vertex_id(self, vid: int) -> bool:
        return vid > 0 and not self.is_schema_vertex_id(vid)

    def is_temporary(self, eid: int) -> bool:
        return eid < 0

    # -- partitioned (vertex-cut) vertices ----------------------------------
    def get_canonical_vertex_id(self, vid: int) -> int:
        """All partition-copies of a vertex-cut vertex map to one canonical
        representative id whose partition is derived from the count
        (reference: IDManager.getCanonicalVertexId:543)."""
        if not self.is_partitioned_vertex_id(vid):
            return vid
        count = self.get_count(vid)
        canonical_partition = count % self.num_partitions
        return self.make_vertex_id(count, canonical_partition, VertexIDType.PARTITIONED)

    def partitioned_vertex_copy(self, vid: int, partition: int) -> int:
        if not self.is_partitioned_vertex_id(vid):
            raise InvalidIDError(f"{vid} is not a partitioned vertex id")
        return self.make_vertex_id(
            self.get_count(vid), partition, VertexIDType.PARTITIONED
        )

    def partitioned_vertex_copies(self, vid: int):
        return [
            self.partitioned_vertex_copy(vid, p) for p in range(self.num_partitions)
        ]

    # -- key <-> id ---------------------------------------------------------
    #: get_key memo bound — the render is pure, OLTP touches the same
    #: vertices repeatedly, and ~90 bytes/entry keeps 1M entries < 100MB
    KEY_CACHE_MAX = 1 << 20

    def get_key(self, vid: int) -> bytes:
        """8-byte BE row key with the partition moved to the top bits, making
        each partition a contiguous key range (reference: IDManager.getKey:480).
        Memoized: the hottest decode on the OLTP write path (one decode +
        one render per relation endpoint per cell)."""
        key = self._key_cache.get(vid)
        if key is not None:
            return key
        if vid <= 0:
            raise InvalidIDError(f"cannot make key for non-positive id {vid}")
        t = _suffix_of(vid)
        suffix, suffix_bits = t.value  # plain tuple: skip enum descriptors
        partition = (vid >> suffix_bits) & (self.num_partitions - 1)
        count = vid >> (suffix_bits + self.partition_bits)
        rest = (count << suffix_bits) | suffix
        key_int = (partition << (TOTAL_BITS - self.partition_bits)) | rest
        key = key_int.to_bytes(8, "big")
        if len(self._key_cache) < self.KEY_CACHE_MAX:
            self._key_cache[vid] = key
        return key

    def get_keys_array(self, vids) -> "list":
        """Vectorized get_key for USER vertex ids (3-bit suffix): one numpy
        pass renders all 8-byte BE row keys (the columnar bulk-load and
        write-back paths call this with millions of ids)."""
        vids = np.asarray(vids, dtype=np.int64)
        if len(vids) and np.any((vids & 0b111) == SCHEMA_MARK):
            raise InvalidIDError("get_keys_array handles user vertex ids only")
        pb = self.partition_bits
        partition = (vids >> 3) & ((1 << pb) - 1)
        count = vids >> (3 + pb)
        rest = (count << 3) | (vids & 0b111)
        key_int = (partition << (TOTAL_BITS - pb)) | rest
        raw = key_int.astype(">u8").tobytes()
        return [raw[i : i + 8] for i in range(0, len(raw), 8)]

    def get_vertex_id(self, key: bytes) -> int:
        """The id whose row key is ``key``: ``make_vertex_id`` of its
        count, partition and type, inlined (a scan decodes every row's key;
        the count cannot pass its maximum, as ``rest`` holds its bits)."""
        key_int = int.from_bytes(key, "big")
        pb = self.partition_bits
        rest_bits = TOTAL_BITS - pb
        partition = key_int >> rest_bits
        rest = key_int & ((1 << rest_bits) - 1)
        t = _suffix_of(rest)
        suffix, suffix_bits = t.value  # plain tuple: skip enum descriptors
        count = rest >> suffix_bits
        if count <= 0:
            raise InvalidIDError(f"count {count} out of range for {t}")
        if partition >= self._num_partitions:
            raise InvalidIDError(f"partition {partition} out of range")
        if suffix_bits == SCHEMA_SUFFIX_BITS and partition != 0:
            raise InvalidIDError("schema vertices live in partition 0")
        return (((count << pb) | partition) << suffix_bits) | suffix

    def partition_key_range(self, partition: int):
        """[start, end) row-key range covering one partition — the unit of
        shard-parallel scanning for the OLAP bulk loader."""
        rest_bits = TOTAL_BITS - self.partition_bits
        start = (partition << rest_bits).to_bytes(8, "big")
        if partition + 1 >= self.num_partitions:
            end = (1 << TOTAL_BITS).to_bytes(8, "big")
        else:
            end = ((partition + 1) << rest_bits).to_bytes(8, "big")
        return start, end
