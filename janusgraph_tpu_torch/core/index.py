"""Composite (exact-match) graph index over the `graphindex` store.

Capability parity with the reference's index maintenance/query
(reference: graphdb/database/IndexSerializer.java:68 — getIndexUpdates
derives index row mutations from relation changes; composite index rows are
hash(key-values) -> vertex-id columns; uniqueness enforced per row).

Row layout:
  key    = [index_id:8 BE][sha1(ordered-encoded values)[:16]]
  column = [vertex_id:8 BE]    (non-unique: one column per matching vertex)
  column = b"\\x00", value = [vertex_id:8 BE]   (unique: single-slot row)

The port's copy of ``janusgraph_tpu/core/index.py``.
"""

from __future__ import annotations

import hashlib
import struct
from typing import List, Optional, Sequence, Tuple

from janusgraph_tpu_torch.core.attributes import Serializer
from janusgraph_tpu_torch.core.schema import IndexDefinition
from janusgraph_tpu_torch.exceptions import SchemaViolationError
from janusgraph_tpu_torch.storage.kcvs import Entry, KeySliceQuery, SliceQuery

_UNIQUE_COL = b"\x00"


class IndexSerializer:
    def __init__(self, serializer: Serializer):
        self.serializer = serializer

    # ------------------------------------------------------------------- keys
    def index_row_key(self, index: IndexDefinition, values: Sequence[object]) -> bytes:
        h = hashlib.sha1()
        for v in values:
            enc = self.serializer.write_ordered(v)
            h.update(struct.pack(">I", len(enc)))
            h.update(enc)
        return struct.pack(">Q", index.id) + h.digest()[:16]

    # ---------------------------------------------------------------- updates
    def index_updates(
        self,
        index: IndexDefinition,
        vertex_id: int,
        before: Optional[Sequence[object]],
        after: Optional[Sequence[object]],
    ) -> List[Tuple[bytes, List[Entry], List[bytes]]]:
        """Mutations for one vertex's transition on one index. `before`/
        `after` are the complete value tuples for the index keys, or None if
        incomplete (composite indexes only record vertices with ALL keys
        present — reference IndexSerializer semantics)."""
        out: List[Tuple[bytes, List[Entry], List[bytes]]] = []
        if before is not None and before != after:
            row = self.index_row_key(index, before)
            col = _UNIQUE_COL if index.unique else struct.pack(">Q", vertex_id)
            out.append((row, [], [col]))
        if after is not None and before != after:
            row = self.index_row_key(index, after)
            if index.unique:
                out.append((row, [(_UNIQUE_COL, struct.pack(">Q", vertex_id))], []))
            else:
                out.append((row, [(struct.pack(">Q", vertex_id), b"")], []))
        return out

    # ------------------------------------------------------------------ query
    def query(
        self,
        index: IndexDefinition,
        values: Sequence[object],
        backend_tx,
        uncached: bool = False,
    ) -> List[int]:
        """Vertex ids matching the exact value tuple."""
        row = self.index_row_key(index, values)
        q = KeySliceQuery(row, SliceQuery())
        entries = (
            backend_tx.index_query_uncached(q)
            if uncached
            else backend_tx.index_query(q)
        )
        if index.unique:
            return [struct.unpack(">Q", v)[0] for c, v in entries if c == _UNIQUE_COL]
        return [struct.unpack(">Q", c)[0] for c, _ in entries]

    def check_unique(
        self,
        index: IndexDefinition,
        values: Sequence[object],
        vertex_id: int,
        backend_tx,
    ) -> None:
        existing = self.query(index, values, backend_tx)
        if any(vid != vertex_id for vid in existing):
            raise SchemaViolationError(
                f"unique index {index.name} violated for values {values!r}"
            )
