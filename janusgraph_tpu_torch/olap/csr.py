"""CSR snapshot for OLAP — the port of ``janusgraph_tpu/olap/csr.py``.

Bulk load from storage: ``load_csr`` scans the edgestore once, partition by
partition (a ``TemporaryBackendError`` mid-range re-issues the range from
just past the last row, up to ``storage.scan-retries`` times), decodes the
fixed-width edge columns in vectorized chunks (``bulk_decode_edges``) and
every other cell through ``parse_relation``, skips ghost rows (no
existence cell), canonicalizes partitioned-vertex ids, reindexes the
vertex ids densely and builds both orientations with the native host
library (``build_csr_from_raw``). ``load_csr_snapshot`` adds the backend's
mutation epoch and marks an unfiltered snapshot refreshable;
``refresh_csr`` folds the writes since that epoch into it by re-reading
only the rows the backend marked as touched (a full reload when its
tracker overflowed). The arrays equal the reference's, filter for filter.

The synthetic-graph path is ``csr_from_edges``; ``csr_from_arrays``
carries a reference snapshot across, so both packages compute on the same
graph state. ``channel_edges`` flattens a typed edge view
(``EdgeChannel``) into an edge list.

``build_csr_from_raw`` merges one or more raw scans: the distributed
loader (``olap/distributed_load.py``) hands it one per worker process.

A store that scans only unordered (the sharded store,
``features.ordered_scan`` false) is read in one full scan whose rows are
kept when their key falls in one of the partitions' ranges, as the
reference does; that branch has no per-range retry, so a scan killed
mid-stream raises to the caller in both packages.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from janusgraph_tpu_torch import native
from janusgraph_tpu_torch.core.codecs import EDGE_COL_FIXED, Direction
from janusgraph_tpu_torch.exceptions import TemporaryBackendError
from janusgraph_tpu_torch.observability import registry
from janusgraph_tpu_torch.storage.kcvs import KeyRangeQuery, KeySliceQuery, SliceQuery


@dataclass
class CSRGraph:
    """Columnar snapshot of the graph for OLAP (host numpy arrays).

    Vertices are densely indexed [0, n); ``vertex_ids[i]`` maps back to the
    64-bit graph id. Both edge orientations are kept:
      out CSR: out_indptr/out_dst  — messages pushed along out-edges
      in  CSR: in_indptr/in_src    — pull-based aggregation (the hot one)
    """

    vertex_ids: np.ndarray          # (n,) int64, sorted ascending
    out_indptr: np.ndarray          # (n+1,) int64
    out_dst: np.ndarray             # (m,) int32 vertex indices
    in_indptr: np.ndarray           # (n+1,) int64
    in_src: np.ndarray              # (m,) int32 vertex indices
    out_degree: np.ndarray          # (n,) int32
    in_edge_weight: Optional[np.ndarray] = None   # (m,) float32, aligned to in_src
    out_edge_weight: Optional[np.ndarray] = None  # (m,) float32, aligned to out_dst
    properties: Dict[str, np.ndarray] = field(default_factory=dict)
    labels: Optional[np.ndarray] = None           # (n,) int64 vertex-label ids
    in_edge_type: Optional[np.ndarray] = None     # (m,) int32, aligned to in_src
    out_edge_type: Optional[np.ndarray] = None    # (m,) int32, aligned to out_dst

    @property
    def num_vertices(self) -> int:
        return len(self.vertex_ids)

    @property
    def num_edges(self) -> int:
        return len(self.out_dst)

    @property
    def in_degree(self) -> np.ndarray:
        """(n,) int32 in-degrees, derived from in_indptr."""
        return np.diff(self.in_indptr).astype(np.int32)

    def index_of(self, vid: int) -> int:
        i = int(np.searchsorted(self.vertex_ids, vid))
        if i >= len(self.vertex_ids) or self.vertex_ids[i] != vid:
            raise KeyError(f"vertex id {vid} not in snapshot")
        return i

    def id_of(self, index: int) -> int:
        return int(self.vertex_ids[index])


def load_csr(
    graph,
    edge_labels: Optional[Sequence[str]] = None,
    property_keys: Sequence[str] = (),
    weight_key: Optional[str] = None,
    partitions: Optional[Sequence[int]] = None,
    vertex_labels: Optional[Sequence[str]] = None,
) -> CSRGraph:
    """Scan the edgestore and build a CSRGraph.

    edge_labels: restrict to these labels (None = all user edges) — the
    reference's GraphFilter.edges equivalent.
    vertex_labels: restrict to vertices with these labels — the reference's
    GraphFilter.vertices equivalent (edges incident to excluded vertices are
    dropped with them).
    property_keys: vertex property columns to materialize as arrays.
    weight_key: edge property to materialize as edge weight (float).
    partitions: restrict the scan to these storage partitions (the unit that
    maps onto mesh shards).
    """
    idm = graph.idm

    label_ids: Optional[set] = None
    if edge_labels is not None:
        label_ids = set()
        for name in edge_labels:
            el = graph.schema_cache.get_by_name(name)
            if el is not None:
                label_ids.add(el.id)

    vlabel_ids: Optional[set] = None
    if vertex_labels is not None:
        vlabel_ids = set()
        for name in vertex_labels:
            vl = graph.schema_cache.get_by_name(name)
            if vl is not None:
                vlabel_ids.add(vl.id)

    prop_key_ids: Dict[int, str] = {}
    for name in property_keys:
        pk = graph.schema_cache.get_by_name(name)
        if pk is not None:
            prop_key_ids[pk.id] = name
    weight_key_id = None
    if weight_key is not None:
        pk = graph.schema_cache.get_by_name(weight_key)
        if pk is not None:
            weight_key_id = pk.id

    raw = _scan_raw(
        graph, label_ids, vlabel_ids, prop_key_ids, weight_key_id, partitions
    )
    return build_csr_from_raw(idm, [raw])


def _scan_raw(
    graph, label_ids, vlabel_ids, prop_key_ids, weight_key_id, partitions
):
    """Partition scan -> RAW vid-space arrays with NO endpoint validation
    (build_csr_from_raw validates)."""
    es = graph.edge_serializer
    idm = graph.idm
    st = graph.system_types
    btx = graph.backend.begin_transaction()
    store_tx = btx.store_tx
    store = graph.backend.edgestore

    # ONE wide slice covering every cell category (sys-prop .. user-edge):
    # the whole row arrives with the scan, so there are no per-row get_slice
    # round trips at all
    full_q = SliceQuery(bytes([0]), bytes([4]))
    exists_tid = st.EXISTS
    label_tid = st.VERTEX_LABEL_EDGE
    label_filter = (
        np.array(sorted(label_ids), dtype=np.int64)
        if label_ids is not None
        else None
    )
    # RelationTypeIndex cells duplicate edges under the index's type id —
    # invisible to untyped edge enumeration (they'd double-count otherwise)
    relidx_ids = getattr(graph, "relation_index_ids", frozenset())
    relidx_filter = (
        np.array(sorted(relidx_ids), dtype=np.int64)
        if (relidx_ids and label_ids is None)
        else None
    )

    src_ids: List[np.ndarray] = []
    dst_ids: List[np.ndarray] = []
    weights: List[np.ndarray] = []
    etypes: List[np.ndarray] = []
    vertex_id_list: List[int] = []
    vertex_labels: List[int] = []
    raw_props: Dict[str, Dict[int, object]] = {name: {} for name in prop_key_ids.values()}

    if partitions is None:
        ranges = [idm.partition_key_range(p) for p in range(idm.num_partitions)]
    else:
        ranges = [idm.partition_key_range(p) for p in partitions]

    canonicalize = idm.get_canonical_vertex_id

    def _scan_rows():
        if not graph.backend.manager.features.ordered_scan:
            # unordered backends (the sharded store): one full scan, the
            # key ranges filtered here (the reference's token-range scan)
            for key, entries in store.get_keys(full_q, store_tx):
                if any(s <= key < e for s, e in ranges):
                    yield key, entries
            return
        # per-range retry + resume: a TemporaryBackendError mid-stream
        # re-issues the range from just past the last yielded key
        retries = 3
        cfg = getattr(graph, "config", None)
        if cfg is not None:
            retries = cfg.get("storage.scan-retries")
        for start, end in ranges:
            cursor = start
            attempt = 0
            while True:
                try:
                    for key, entries in store.get_keys(
                        KeyRangeQuery(cursor, end, full_q), store_tx
                    ):
                        yield key, entries
                        cursor = key + b"\x00"
                    break
                except TemporaryBackendError:
                    attempt += 1
                    if attempt > retries:
                        raise
                    registry.counter("storage.scan.retries").inc()

    # chunked bulk decode: fixed-width edge columns accumulate across rows
    # and decode in one numpy pass per chunk
    CHUNK = 1 << 16
    pend_cols: List[bytes] = []
    pend_vids: List[int] = []
    unpack_tid = struct.Struct(">Q").unpack_from

    def _flush_edges():
        if not pend_cols:
            return
        tids, dirs, others, _rels = es.bulk_decode_edges(pend_cols)
        owner = np.array(pend_vids, dtype=np.int64)
        pend_cols.clear()
        pend_vids.clear()
        mask = dirs == int(Direction.OUT)
        if label_filter is not None:
            mask &= np.isin(tids, label_filter)
        elif relidx_filter is not None:
            mask &= ~np.isin(tids, relidx_filter)
        if not mask.any():
            return
        src_ids.append(owner[mask])
        dst_ids.append(others[mask])
        etypes.append(tids[mask].astype(np.int32))
        if weight_key_id is not None:
            weights.append(np.ones(int(mask.sum()), dtype=np.float32))

    for key, entries in _scan_rows():
        vid = idm.get_vertex_id(key)
        if not idm.is_user_vertex_id(vid):
            continue
        vid = canonicalize(vid)

        # single pass over the row's cells, classified by category byte
        exists = False
        label_id = 0
        row_edge_cols: List[bytes] = []
        slow_entries = []
        prop_entries = []
        for col, val in entries:
            cat = col[0]
            if cat == 3:  # user edge
                if len(col) == EDGE_COL_FIXED and not val:
                    row_edge_cols.append(col)
                else:
                    slow_entries.append((col, val))
            elif cat == 0:  # system property
                if unpack_tid(col, 1)[0] == exists_tid:
                    exists = True
            elif cat == 2:  # system edge (vertex label)
                if unpack_tid(col, 1)[0] == label_tid:
                    rc = es.parse_relation((col, val), st.type_info)
                    label_id = rc.other_vertex_id
            elif cat == 1 and prop_key_ids:  # user property
                name = prop_key_ids.get(unpack_tid(col, 1)[0])
                if name is not None:
                    prop_entries.append((name, col, val))

        # ghost check: only rows with the existence cell are real
        # vertices (reference: VertexJobConverter.java:126) — filtered
        # rows must not pay property decode either
        if not exists:
            continue
        if vlabel_ids is not None and label_id not in vlabel_ids:
            continue
        vertex_id_list.append(vid)
        vertex_labels.append(label_id)
        for name, col, val in prop_entries:
            rc = es.parse_relation((col, val), graph_codec_schema(graph))
            raw_props[name][vid] = rc.value

        if row_edge_cols:
            pend_cols.extend(row_edge_cols)
            pend_vids.extend([vid] * len(row_edge_cols))
            if len(pend_cols) >= CHUNK:
                _flush_edges()
        for col, val in slow_entries:
            rc = es.parse_relation((col, val), graph_codec_schema(graph))
            if rc.direction != Direction.OUT or not rc.is_edge:
                continue
            if label_ids is not None and rc.type_id not in label_ids:
                continue
            if label_ids is None and rc.type_id in relidx_ids:
                continue
            src_ids.append(np.array([vid], dtype=np.int64))
            dst_ids.append(np.array([rc.other_vertex_id], dtype=np.int64))
            etypes.append(np.array([rc.type_id], dtype=np.int32))
            if weight_key_id is not None:
                w = 1.0
                if rc.properties and weight_key_id in rc.properties:
                    w = float(rc.properties[weight_key_id])
                weights.append(np.array([w], dtype=np.float32))

    _flush_edges()

    return {
        "vertex_id_list": vertex_id_list,
        "vertex_labels": vertex_labels,
        "src": np.concatenate(src_ids) if src_ids else np.empty(0, np.int64),
        "dst": np.concatenate(dst_ids) if dst_ids else np.empty(0, np.int64),
        "etype": np.concatenate(etypes) if etypes else None,
        "weights": np.concatenate(weights) if weights else None,
        "raw_props": raw_props,
    }


def build_csr_from_raw(idm, raws) -> CSRGraph:
    """Merge one or more _scan_raw outputs (e.g. from N loader processes
    over disjoint partition sets) into a validated CSRGraph."""
    vid_parts, vlabel_parts = [], []
    src_parts, dst_parts, et_parts, w_parts = [], [], [], []
    raw_props: Dict[str, Dict[int, object]] = {}
    any_et = any(r["etype"] is not None for r in raws)
    any_w = any(r["weights"] is not None for r in raws)
    for r in raws:
        vid_parts.append(np.asarray(r["vertex_id_list"], dtype=np.int64))
        vlabel_parts.append(np.asarray(r["vertex_labels"], dtype=np.int64))
        src_parts.append(r["src"])
        dst_parts.append(r["dst"])
        if any_et:
            et_parts.append(
                r["etype"] if r["etype"] is not None
                else np.zeros(len(r["src"]), dtype=np.int32)
            )
        if any_w:
            w_parts.append(
                r["weights"] if r["weights"] is not None
                else np.ones(len(r["src"]), dtype=np.float32)
            )
        for name, mapping in r["raw_props"].items():
            raw_props.setdefault(name, {}).update(mapping)
    src = np.concatenate(src_parts) if src_parts else np.empty(0, np.int64)
    dst = np.concatenate(dst_parts) if dst_parts else np.empty(0, np.int64)
    et = np.concatenate(et_parts) if any_et else None
    w = np.concatenate(w_parts) if any_w else None

    # one unique pass; return_index picks each id's label
    vids_all = np.concatenate(vid_parts) if vid_parts else np.empty(0, np.int64)
    vlabels_all = np.concatenate(vlabel_parts) if vlabel_parts else np.empty(0, np.int64)
    vertex_ids, first_idx = np.unique(vids_all, return_index=True)
    label_arr = vlabels_all[first_idx] if len(vlabels_all) else None
    n = len(vertex_ids)
    if len(src):
        # canonicalize partitioned-vertex endpoints on the dst side too
        if idm.partition_bits > 0 and _any_partitioned(idm, dst):
            dst = canonicalize_ids(idm, dst)
        # drop edges to vertices outside the snapshot (ghost endpoints)
        src_idx = np.searchsorted(vertex_ids, src)
        dst_idx = np.searchsorted(vertex_ids, dst)
        valid = (
            (src_idx < n)
            & (dst_idx < n)
            & (vertex_ids[np.minimum(src_idx, n - 1)] == src)
            & (vertex_ids[np.minimum(dst_idx, n - 1)] == dst)
        )
        src_idx = src_idx[valid].astype(np.int32)
        dst_idx = dst_idx[valid].astype(np.int32)
        if w is not None:
            w = w[valid]
        if et is not None:
            et = et[valid]
    else:
        src_idx = np.empty(0, dtype=np.int32)
        dst_idx = np.empty(0, dtype=np.int32)
        w = None
        et = None

    # build out-CSR (sorted by src) and in-CSR (sorted by dst)
    out_indptr, out_dst, out_order, in_indptr, in_src, in_order = (
        native.build_csr(n, src_idx, dst_idx)
    )
    out_degree = np.diff(out_indptr).astype(np.int32)

    props: Dict[str, np.ndarray] = {}
    for name, mapping in raw_props.items():
        vals = [mapping.get(int(v)) for v in vertex_ids]
        if all(isinstance(x, (int, float)) or x is None for x in vals):
            props[name] = np.array(
                [float(x) if x is not None else np.nan for x in vals],
                dtype=np.float64,
            )
        else:
            props[name] = np.array(vals, dtype=object)

    return CSRGraph(
        vertex_ids=vertex_ids,
        out_indptr=out_indptr,
        out_dst=out_dst,
        in_indptr=in_indptr,
        in_src=in_src,
        out_degree=out_degree,
        in_edge_weight=w[in_order] if w is not None else None,
        out_edge_weight=w[out_order] if w is not None else None,
        properties=props,
        labels=label_arr,
        in_edge_type=et[in_order] if et is not None else None,
        out_edge_type=et[out_order] if et is not None else None,
    )


def _any_partitioned(idm, ids: np.ndarray) -> bool:
    # partitioned suffix is 0b010 in the low 3 bits
    return bool(np.any((ids & 0b111) == 0b010))


def canonicalize_ids(idm, ids: np.ndarray) -> np.ndarray:
    """Vectorized IDManager.get_canonical_vertex_id over an int64 array:
    partition-copies of vertex-cut vertices map to the canonical
    representative (partition = count % num_partitions); everything else
    passes through unchanged."""
    ids = np.asarray(ids, dtype=np.int64)
    # 0b010 suffix identifies partitioned user vertices (schema ids end 0b111)
    part_mask = (ids & 0b111) == 0b010
    if not np.any(part_mask):
        return ids
    pb = idm.partition_bits
    count = ids >> (3 + pb)
    canonical = (((count << pb) | (count % (1 << pb))) << 3) | 0b010
    return np.where(part_mask, canonical, ids)


def graph_codec_schema(graph):
    def lookup(type_id: int):
        info = graph.system_types.type_info(type_id)
        if info is not None:
            return info
        el = graph.schema_cache.get_by_id(type_id)
        if el is None:
            raise KeyError(type_id)
        return el.type_info()

    return lookup


def csr_from_edges(
    n: int,
    src: np.ndarray,
    dst: np.ndarray,
    weights: Optional[np.ndarray] = None,
    edge_types: Optional[np.ndarray] = None,
) -> CSRGraph:
    """Build a CSRGraph from an edge list with dense [0, n) ids — the
    synthetic-graph path (graph500 R-MAT etc.). ``edge_types``: optional
    (m,) per-edge label ids, carried into ``in_edge_type``/``out_edge_type``."""
    src = np.asarray(src, dtype=np.int32)
    dst = np.asarray(dst, dtype=np.int32)
    out_indptr, out_dst, out_order, in_indptr, in_src, in_order = (
        native.build_csr(n, src, dst)
    )
    if weights is not None:
        weights = np.asarray(weights)
    et = np.asarray(edge_types, dtype=np.int32) if edge_types is not None else None
    return CSRGraph(
        vertex_ids=np.arange(n, dtype=np.int64),
        out_indptr=out_indptr,
        out_dst=out_dst,
        in_indptr=in_indptr,
        in_src=in_src,
        out_degree=np.diff(out_indptr).astype(np.int32),
        in_edge_weight=weights[in_order].astype(np.float32) if weights is not None else None,
        out_edge_weight=weights[out_order].astype(np.float32) if weights is not None else None,
        in_edge_type=et[in_order] if et is not None else None,
        out_edge_type=et[out_order] if et is not None else None,
    )


def load_csr_snapshot(graph, **kwargs) -> Tuple[CSRGraph, int]:
    """load_csr plus the backend mutation epoch observed BEFORE the scan —
    the handle incremental refresh resumes from."""
    epoch = graph.backend.mutation_epoch()
    csr = load_csr(graph, **kwargs)
    # refresh_csr re-derives touched rows without filters or properties:
    # a filtered snapshot must fail loudly there instead of refreshing
    # into another graph
    csr._refreshable = not any(
        kwargs.get(k)
        for k in ("edge_labels", "vertex_labels", "property_keys", "weight_key", "partitions")
    )
    return csr, epoch


def refresh_csr(graph, csr: CSRGraph, since_epoch: int) -> Tuple[CSRGraph, int]:
    """Fold the writes committed since ``since_epoch`` into an unfiltered
    snapshot without a store scan: only the rows the backend's
    mutation-epoch tracker marked are re-read, their OUT-edges re-derived
    and merged with the edges of untouched rows (an edge lives in its
    source row's OUT cell, and every edge write touches both endpoint
    rows, so keeping the edges of untouched source rows is exact). The
    arrays are rebuilt in the canonical (src, type, dst) layout of a fresh
    load. Returns (csr, the epoch it now covers); ``csr`` itself when no
    row was touched, a full reload when the tracker overflowed past
    ``since_epoch``."""
    if not getattr(csr, "_refreshable", True) or csr.properties or (
        csr.in_edge_weight is not None
    ):
        raise ValueError(
            "refresh_csr supports unfiltered snapshots without materialized "
            "properties/weights — reload with load_csr for filtered views"
        )
    es = graph.edge_serializer
    idm = graph.idm
    st = graph.system_types
    new_epoch = graph.backend.mutation_epoch()
    keys = graph.backend.touched_since(since_epoch)
    if keys is None:
        return load_csr_snapshot(graph)
    if not keys:
        return csr, new_epoch

    store_tx = graph.backend.begin_transaction().store_tx
    store = graph.backend.edgestore
    full_q = SliceQuery(bytes([0]), bytes([4]))
    unpack_tid = struct.Struct(">Q").unpack_from
    relidx_ids = graph.relation_index_ids
    schema = graph_codec_schema(graph)

    touched: set = set()
    alive: Dict[int, int] = {}          # vid -> label id
    new_src: List[int] = []
    new_dst: List[int] = []
    new_et: List[int] = []
    for key in keys:
        vid = idm.get_vertex_id(key)
        if not idm.is_user_vertex_id(vid):
            continue
        vid = idm.get_canonical_vertex_id(vid)
        touched.add(vid)
        exists = False
        label_id = 0
        for col, val in store.get_slice(KeySliceQuery(key, full_q), store_tx):
            cat = col[0]
            if cat == 0:
                if unpack_tid(col, 1)[0] == st.EXISTS:
                    exists = True
            elif cat == 2:
                if unpack_tid(col, 1)[0] == st.VERTEX_LABEL_EDGE:
                    label_id = es.parse_relation((col, val), st.type_info).other_vertex_id
            elif cat == 3:
                if len(col) == EDGE_COL_FIXED and not val:
                    tid = int.from_bytes(col[1:9], "big")
                    if col[9] == int(Direction.OUT) and tid not in relidx_ids:
                        new_src.append(vid)
                        new_dst.append(int.from_bytes(col[11:19], "big"))
                        new_et.append(tid)
                else:
                    rc = es.parse_relation((col, val), schema)
                    if (rc.is_edge and rc.direction == Direction.OUT
                            and rc.type_id not in relidx_ids):
                        new_src.append(vid)
                        new_dst.append(int(rc.other_vertex_id))
                        new_et.append(int(rc.type_id))
        if exists:
            alive[vid] = label_id

    # old edges in vid space, minus those whose source row was re-derived
    old_src_vid = np.repeat(csr.vertex_ids, np.diff(csr.out_indptr))
    old_dst_vid = csr.vertex_ids[csr.out_dst]
    keep = ~np.isin(old_src_vid, np.fromiter(touched, dtype=np.int64))
    old_src_vid = old_src_vid[keep]
    old_dst_vid = old_dst_vid[keep]
    old_et = csr.out_edge_type[keep] if csr.out_edge_type is not None else None

    removed = {v for v in touched if v not in alive}
    vertex_ids = np.unique(np.concatenate([
        csr.vertex_ids[~np.isin(csr.vertex_ids, np.fromiter(removed, dtype=np.int64))]
        if removed else csr.vertex_ids,
        np.fromiter(alive.keys(), dtype=np.int64, count=len(alive)),
    ]))

    src_vid = np.concatenate([old_src_vid, np.asarray(new_src, dtype=np.int64)])
    dst_vid = np.concatenate([old_dst_vid, np.asarray(new_dst, dtype=np.int64)])
    if idm.partition_bits > 0 and _any_partitioned(idm, dst_vid):
        dst_vid = canonicalize_ids(idm, dst_vid)
    et = None
    if old_et is not None or new_et:
        et = np.concatenate([
            old_et if old_et is not None else np.zeros(len(old_src_vid), dtype=np.int32),
            np.asarray(new_et, dtype=np.int32),
        ])

    n = len(vertex_ids)
    si = np.searchsorted(vertex_ids, src_vid)
    di = np.searchsorted(vertex_ids, dst_vid)
    valid = (
        (si < n) & (di < n)
        & (vertex_ids[np.minimum(si, n - 1)] == src_vid)
        & (vertex_ids[np.minimum(di, n - 1)] == dst_vid)
    )
    si = si[valid].astype(np.int32)
    di = di[valid].astype(np.int32)
    if et is not None:
        et = et[valid]
    # the canonical layout of a fresh load: within each source row the
    # store orders edge columns by (type, other vid)
    order = np.lexsort((di, et if et is not None else np.zeros(len(si), dtype=np.int32), si))
    si, di = si[order], di[order]
    if et is not None:
        et = et[order]

    # labels: kept from the old snapshot where known, overridden for
    # touched rows
    labels = None
    if csr.labels is not None or alive:
        labels = np.zeros(n, dtype=np.int64)
        if csr.labels is not None:
            pos = np.searchsorted(vertex_ids, csr.vertex_ids)
            ok = (pos < n) & (vertex_ids[np.minimum(pos, n - 1)] == csr.vertex_ids)
            labels[pos[ok]] = csr.labels[ok]
        for vid, lid in alive.items():
            labels[int(np.searchsorted(vertex_ids, vid))] = lid

    refreshed = csr_from_edges(n, si, di, edge_types=et)
    refreshed.vertex_ids = vertex_ids
    refreshed.labels = labels
    return refreshed, new_epoch


def csr_from_arrays(
    vertex_ids,
    out_indptr,
    out_dst,
    in_indptr,
    in_src,
    out_degree,
    in_edge_weight=None,
    out_edge_weight=None,
    properties=None,
    labels=None,
    in_edge_type=None,
    out_edge_type=None,
) -> CSRGraph:
    """The port's CSRGraph from a reference snapshot's fields (numpy
    arrays, e.g. ``dataclasses.asdict``-style from
    ``janusgraph_tpu.olap.csr.CSRGraph``). Dtypes are normalized to the
    layout above; values are copied as they are."""

    def opt(a, dtype):
        return None if a is None else np.asarray(a, dtype=dtype)

    return CSRGraph(
        vertex_ids=np.asarray(vertex_ids, dtype=np.int64),
        out_indptr=np.asarray(out_indptr, dtype=np.int64),
        out_dst=np.asarray(out_dst, dtype=np.int32),
        in_indptr=np.asarray(in_indptr, dtype=np.int64),
        in_src=np.asarray(in_src, dtype=np.int32),
        out_degree=np.asarray(out_degree, dtype=np.int32),
        in_edge_weight=opt(in_edge_weight, np.float32),
        out_edge_weight=opt(out_edge_weight, np.float32),
        properties={k: np.asarray(v) for k, v in (properties or {}).items()},
        labels=opt(labels, np.int64),
        in_edge_type=opt(in_edge_type, np.int32),
        out_edge_type=opt(out_edge_type, np.int32),
    )


def channel_edges(
    csr: CSRGraph, channel
) -> Tuple[np.ndarray, np.ndarray, Optional[np.ndarray]]:
    """Flatten an ``EdgeChannel`` view into (src_idx, dst_idx, weight)
    arrays where messages flow src -> dst (aggregation happens at dst).

    Direction "out": traversers move src->dst, so aggregation reads the
    in-CSR; "in" reverses the edges (aggregate at the source over its
    out-edges); "both" is the in-CSR's edges, then the out-CSR's. Label
    filtering needs the CSR's per-edge type arrays. Weightless edges of a
    weighted CSR's other orientation get weight 1."""
    parts_src: List[np.ndarray] = []
    parts_dst: List[np.ndarray] = []
    parts_w: List[np.ndarray] = []
    have_w = csr.in_edge_weight is not None or csr.out_edge_weight is not None

    def select(src, dst, w, types):
        if channel.labels is not None:
            if types is None:
                raise ValueError(
                    "EdgeChannel with labels requires per-edge type arrays "
                    "(load the CSR with edge types)"
                )
            mask = np.isin(types, np.asarray(channel.labels, dtype=types.dtype))
            src, dst = src[mask], dst[mask]
            w = w[mask] if w is not None else None
        parts_src.append(src)
        parts_dst.append(dst)
        if have_w:
            parts_w.append(w if w is not None else np.ones(len(src), dtype=np.float32))

    if channel.direction not in ("out", "in", "both"):
        raise ValueError(f"unknown channel direction {channel.direction!r}")
    rows = np.arange(csr.num_vertices, dtype=np.int64)
    if channel.direction in ("out", "both"):
        select(csr.in_src.astype(np.int64), np.repeat(rows, np.diff(csr.in_indptr)),
               csr.in_edge_weight, csr.in_edge_type)
    if channel.direction in ("in", "both"):
        select(csr.out_dst.astype(np.int64), np.repeat(rows, np.diff(csr.out_indptr)),
               csr.out_edge_weight, csr.out_edge_type)
    src = np.concatenate(parts_src)
    dst = np.concatenate(parts_dst)
    w = np.concatenate(parts_w) if have_w else None
    return src, dst, w
