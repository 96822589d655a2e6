"""Columnar bulk loader: edge lists -> raw storage cells, batched.

The reference reserves a "batch-loading" mode that skips consistency checks
and retries (reference: GraphDatabaseConfiguration storage.batch-loading;
bulk loading docs docs/operations/bulk-loading.md) but still funnels every
element through per-object transaction machinery. Here bulk ingestion is
columnar end to end: vertex ids come as block spans from the ID authority,
edge cells are rendered as one numpy (m, EDGE_COL_FIXED) byte matrix with
vectorized field fills, and rows flush through the backend's buffered
mutator in chunks. This is the write-side mirror of the scan->CSR bulk
decode (olap/csr.py load_csr).

Consistency contract (same as the reference's batch mode): no multiplicity
checks, no locks, no WAL entries, no index maintenance — use it to seed a
graph, not to mutate a live one. Schema (labels/keys) must exist or be
auto-creatable.

The port's copy of ``janusgraph_tpu/core/bulk.py`` (all of it): the same
ids, the same cells, in the same batches.
"""

from __future__ import annotations

import struct
from typing import Optional, Sequence

import numpy as np

from janusgraph_tpu_torch.core.codecs import Direction, EDGE_COL_FIXED, _category_byte


def _render_edge_cols(
    type_id: int,
    direction: Direction,
    others: np.ndarray,
    rels: np.ndarray,
    idm,
) -> np.ndarray:
    """Vectorized render of fixed-width edge columns: (m, EDGE_COL_FIXED)
    uint8, fields filled via big-endian views (the inverse of
    EdgeSerializer.bulk_decode_edges)."""
    m = len(others)
    buf = np.zeros((m, EDGE_COL_FIXED), dtype=np.uint8)
    buf[:, 0] = _category_byte(type_id, True, idm)
    buf[:, 1:9] = np.frombuffer(
        np.full(m, type_id, dtype=">u8").tobytes(), dtype=np.uint8
    ).reshape(m, 8)
    buf[:, 9] = int(direction)
    # byte 10 = sort-key length = 0
    buf[:, 11:19] = np.frombuffer(
        others.astype(">u8").tobytes(), dtype=np.uint8
    ).reshape(m, 8)
    buf[:, 19:27] = np.frombuffer(
        rels.astype(">u8").tobytes(), dtype=np.uint8
    ).reshape(m, 8)
    return buf


def bulk_add_vertices(
    graph,
    count: int,
    label: Optional[str] = None,
    batch: int = 100_000,
) -> np.ndarray:
    """Create `count` vertices (EXISTS cell + optional label cell each),
    returning their ids as an int64 array."""
    idm = graph.idm
    es = graph.edge_serializer
    st = graph.system_types

    label_el = None
    if label is not None:
        label_el = graph.schema_cache.get_by_name(label)
        if label_el is None:
            label_el = graph.management().make_vertex_label(label)

    # ids: spread over partitions in span-sized stripes
    vids = np.empty(count, dtype=np.int64)
    filled = 0
    parts = idm.num_partitions
    per_part = -(-count // parts)
    for p in range(parts):
        take = min(per_part, count - filled)
        if take <= 0:
            break
        for start, ln in graph.id_assigner._pool(p).next_ids(take):
            counts = np.arange(start, start + ln, dtype=np.int64)
            vids[filled : filled + ln] = (
                ((counts << idm.partition_bits) | p) << 3
            )  # NORMAL suffix 0b000
            filled += ln
    vids = vids[:filled]

    # unique relation ids per cell (the same invariant the tx path keeps —
    # rel-id-keyed deletion filtering and RelationIdentifier equality rely
    # on it): one span-drawn id per EXISTS cell, one per label edge
    per_vertex = 1 if label_el is None else 2
    rels = np.empty(len(vids) * per_vertex, dtype=np.int64)
    off = 0
    for start, ln in graph.id_assigner.assign_relation_ids(len(rels)):
        rels[off : off + ln] = np.arange(start, start + ln, dtype=np.int64)
        off += ln

    # EXISTS value = [rel_id:8][framed True]; only the rel id varies
    exists_col, exists_val_tpl = es.write_property(st.EXISTS, 1, True)
    exists_tail = exists_val_tpl[8:]
    label_col_tpl = (
        es.write_edge(st.VERTEX_LABEL_EDGE, Direction.OUT, label_el.id, 1)[0]
        if label_el is not None
        else None
    )
    keys = idm.get_keys_array(vids)
    for lo in range(0, len(vids), batch):
        btx = graph.backend.begin_transaction()
        for i in range(lo, min(lo + batch, len(vids))):
            rid = int(rels[i * per_vertex])
            adds = [(exists_col, struct.pack(">Q", rid) + exists_tail)]
            if label_col_tpl is not None:
                lrid = int(rels[i * per_vertex + 1])
                # relation id sits in the last 8 bytes of the edge column
                adds.append((label_col_tpl[:-8] + struct.pack(">Q", lrid), b""))
            btx.mutate_edges(keys[i], adds, [])
        btx.commit()
    return vids


def bulk_add_edges(
    graph,
    label: str,
    src_vids: Sequence[int],
    dst_vids: Sequence[int],
    batch: int = 200_000,
) -> int:
    """Write edges columnar: OUT cell on each src row, IN cell on each dst
    row, relation ids from bulk spans. Returns the number of edges written."""
    idm = graph.idm
    el = graph.schema_cache.get_by_name(label)
    if el is None:
        el = graph.management().make_edge_label(label)

    src = np.asarray(src_vids, dtype=np.int64)
    dst = np.asarray(dst_vids, dtype=np.int64)
    if len(src) != len(dst):
        raise ValueError("src/dst length mismatch")
    m = len(src)
    rels = np.empty(m, dtype=np.int64)
    off = 0
    for start, ln in graph.id_assigner.assign_relation_ids(m):
        rels[off : off + ln] = np.arange(start, start + ln, dtype=np.int64)
        off += ln

    out_cols = _render_edge_cols(el.id, Direction.OUT, dst, rels, idm)
    in_cols = _render_edge_cols(el.id, Direction.IN, src, rels, idm)
    src_keys = idm.get_keys_array(src)
    dst_keys = idm.get_keys_array(dst)

    for lo in range(0, m, batch):
        hi = min(lo + batch, m)
        # group cells by row key within the chunk
        per_row: dict = {}
        for i in range(lo, hi):
            per_row.setdefault(src_keys[i], []).append(
                (out_cols[i].tobytes(), b"")
            )
            per_row.setdefault(dst_keys[i], []).append(
                (in_cols[i].tobytes(), b"")
            )
        btx = graph.backend.begin_transaction()
        for key, adds in per_row.items():
            btx.mutate_edges(key, adds, [])
        btx.commit()
    return m
