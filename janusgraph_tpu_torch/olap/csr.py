"""CSR snapshot for OLAP — the port of ``CSRGraph`` and ``csr_from_edges``
from ``janusgraph_tpu/olap/csr.py``.

Only the synthetic-graph path is ported: the storage scan (``load_csr``)
stays with the reference for now. ``csr_from_arrays`` carries a reference
snapshot across, so both packages compute on the same graph state.
``channel_edges`` flattens a typed edge view (``EdgeChannel``) into an edge
list.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from janusgraph_tpu_torch import native


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
