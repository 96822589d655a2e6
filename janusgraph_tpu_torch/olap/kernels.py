"""Aggregation kernels for the BSP superstep — the port of
``janusgraph_tpu/olap/kernels.py`` (ELL, hybrid and sorted-segment-sum
parts, with per-column edge transforms for ``[n, k]`` messages).

The superstep's hot op is ``combine({msg(src) for (src,dst) edges}) by
dst``. Three strategies here:

1. **Degree-bucketed ELL** (``ELLPack`` / ``ell_aggregate``), plain torch:
   in-edges are packed per destination into power-of-two-capacity row
   buckets; aggregation is gather + the fixed adjacent-pair ``tree_reduce``.
   Every monoid. Bitwise equal to the reference's numpy replay: torch eager
   rounds every mul and add on its own, and the tree order is the same.

2. **Degree-bucketed hybrid** (``HybridPack`` / ``hybrid_aggregate``),
   plain torch: an exact-width ELL torso for vertices up to a degree
   cutoff and a chunked CSR tail for hubs; bitwise equal to ELL, since
   both reduce through the same tree.

3. **Sorted segment sum** (``make_segsum_plan`` / ``sorted_segment_sum``):
   the SUM monoid over destination-sorted edges, through the hand-written
   CUDA kernel ``janusgraph_tpu_torch/csrc/segsum.cu`` on a CUDA tensor and
   through ``sorted_segment_sum_plain`` on a CPU tensor. The plan keeps
   the reference's tile-aligned layout, which the plain version reads; the
   kernel reads only the segment offsets and a merge-path partition.

Each host structure is built once per (graph, orientation), or per typed
edge channel (``edge_list_plan``), and reused across supersteps.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from janusgraph_tpu_torch.olap.vertex_program import (
    Combiner,
    EdgeTransform,
    apply_edge_transform,
)


# --------------------------------------------------------------------------
# Degree-bucketed ELL packing (host, numpy)
# --------------------------------------------------------------------------

def fill_ell_rows(starts_r, degs_r, src32, w32, idx, wmat, valid):
    """Fill one ELL bucket's (rows, cap) matrices in place. Callers
    pre-fill idx with the sentinel and wmat/valid with zeros; wmat/valid are
    None for unweighted packs (the sentinel slot alone provides the monoid
    identity)."""
    total = int(np.asarray(degs_r).sum())
    if not total:
        return
    degs_r = np.asarray(degs_r, dtype=np.int64)
    starts_r = np.asarray(starts_r, dtype=np.int64)
    rows = len(starts_r)
    row_ids = np.repeat(np.arange(rows), degs_r)
    col_ids = np.arange(total) - np.repeat(np.cumsum(degs_r) - degs_r, degs_r)
    edge_pos = np.repeat(starts_r, degs_r) + col_ids
    idx[row_ids, col_ids] = src32[edge_pos]
    if valid is not None:
        valid[row_ids, col_ids] = 1.0
    if wmat is not None:
        wmat[row_ids, col_ids] = w32[edge_pos] if w32 is not None else 1.0


def row_fold_matrix(rowseg: np.ndarray, num_slots: int) -> np.ndarray:
    """(num_slots, most rows of one slot) matrix of the row indices each
    slot folds, in row order, padded with ``len(rowseg)`` (an identity row
    the fold appends). ``rowseg`` is sorted (``split_rows`` gives each owner
    consecutive rows)."""
    rows = len(rowseg)
    counts = np.bincount(rowseg, minlength=num_slots).astype(np.int64)
    kmax = int(counts.max()) if rows else 0
    pos = np.arange(rows, dtype=np.int64) - np.repeat(np.cumsum(counts) - counts, counts)
    fold = np.full((num_slots, kmax), rows, dtype=np.int64)
    fold[np.asarray(rowseg, dtype=np.int64), pos] = np.arange(rows, dtype=np.int64)
    return fold


def fold_rows(op: str, r: torch.Tensor, fold: torch.Tensor) -> torch.Tensor:
    """Fold row partials into one value per slot: identity, then each of a
    slot's rows in row order — the order of the reference's
    ``np.<ufunc>.at`` over sorted segment ids, with no atomics, so the
    result has the same bits on every device and every call."""
    identity = Combiner.IDENTITY[op]
    pad = torch.full((1,) + tuple(r.shape[1:]), identity, dtype=r.dtype, device=r.device)
    r_ext = torch.cat([r, pad], dim=0)
    acc = torch.full(
        (fold.shape[0],) + tuple(r.shape[1:]), identity, dtype=r.dtype, device=r.device
    )
    for j in range(fold.shape[1]):
        part = torch.index_select(r_ext, 0, fold[:, j])
        if op == Combiner.SUM:
            acc = acc + part
        elif op == Combiner.MIN:
            acc = torch.minimum(acc, part)
        else:
            acc = torch.maximum(acc, part)
    return acc


def split_rows(members: np.ndarray, deg_m: np.ndarray, starts_m: np.ndarray, cap: int):
    """Row-split supernode edge ranges into chunks of at most ``cap`` edges.

    Returns (starts, degs, rowseg): one entry per row; rowseg maps each row
    to its owner's slot index (position within ``members``)."""
    n_rows = np.maximum(1, -(-deg_m // cap)).astype(np.int64)
    total = int(n_rows.sum())
    rowseg = np.repeat(np.arange(len(members), dtype=np.int64), n_rows)
    chunk = np.arange(total, dtype=np.int64) - np.repeat(
        np.cumsum(n_rows) - n_rows, n_rows
    )
    starts = np.repeat(starts_m, n_rows) + chunk * cap
    degs = np.minimum(cap, np.repeat(deg_m, n_rows) - chunk * cap)
    degs = np.maximum(degs, 0)
    return starts, degs, rowseg


class ELLPack:
    """ELLPACK layout of an edge list grouped by destination.

    For each power-of-two capacity bucket c: the destinations whose
    in-degree d satisfies prev_c < d <= c, with a (rows, c) matrix of source
    indices (padded with the sentinel ``n``) and, for weighted packs, a
    (rows, c) weight and validity matrix. Destinations with degree above
    ``max_capacity`` are row-split; ``rowseg`` folds the row partials.

    Bucket tuple: (idx, wmat, valid, rowseg, num_slots); ``row_folds`` holds
    each bucket's ``row_fold_matrix`` (None without split rows). Built as
    numpy; ``to(device)`` moves the arrays to torch tensors once.
    """

    def __init__(
        self,
        src: np.ndarray,
        dst: np.ndarray,
        weight: Optional[np.ndarray],
        num_vertices: int,
        max_capacity: int = 1 << 14,
    ):
        n = num_vertices
        self.num_vertices = n
        self.sentinel = n
        self.has_weight = weight is not None
        order = np.argsort(dst, kind="stable")
        src = np.asarray(src, dtype=np.int64)[order]
        dst = np.asarray(dst, dtype=np.int64)[order]
        w = np.asarray(weight, dtype=np.float32)[order] if weight is not None else None
        deg = np.bincount(dst, minlength=n).astype(np.int64)
        indptr = np.zeros(n + 1, dtype=np.int64)
        np.cumsum(deg, out=indptr[1:])

        caps = np.maximum(1, 1 << np.ceil(np.log2(np.maximum(deg, 1))).astype(np.int64))
        caps = np.minimum(caps, max_capacity)

        self.buckets: List[Tuple] = []
        self.row_folds: List[Optional[np.ndarray]] = []
        parts: List[np.ndarray] = []
        src32 = np.ascontiguousarray(src, dtype=np.int32)
        w32 = np.ascontiguousarray(w, dtype=np.float32) if w is not None else None
        for c in sorted(set(int(c) for c in np.unique(caps))):
            members = np.nonzero(caps == c)[0]
            deg_m = deg[members]
            starts_m = indptr[members]
            if c == max_capacity and int(deg_m.max()) > c:
                starts_r, degs_r, rowseg = split_rows(members, deg_m, starts_m, c)
            else:
                starts_r, degs_r, rowseg = starts_m, deg_m, None
            rows = len(starts_r)
            idx = np.full((rows, c), self.sentinel, dtype=np.int32)
            if self.has_weight:
                wmat = np.zeros((rows, c), dtype=np.float32)
                valid = np.zeros((rows, c), dtype=np.float32)
            else:
                wmat = valid = None
            fill_ell_rows(starts_r, degs_r, src32, w32, idx, wmat, valid)
            self.buckets.append((
                idx, wmat, valid,
                rowseg.astype(np.int32) if rowseg is not None else None,
                len(members),
            ))
            self.row_folds.append(
                row_fold_matrix(rowseg, len(members)) if rowseg is not None else None
            )
            parts.append(members)

        vertex_order = np.concatenate(parts) if parts else np.zeros(0, dtype=np.int64)
        pos = np.zeros(n, dtype=np.int64)
        pos[vertex_order] = np.arange(len(vertex_order), dtype=np.int64)
        self.unpermute = pos.astype(np.int32)
        #: gathered slots, padding included, and their ratio to the edges
        self.slots = sum(int(b[0].size) for b in self.buckets)
        self.pad_ratio = self.slots / max(1, len(src))

    def to(self, device) -> "ELLPack":
        """Move the index/weight matrices to ``device`` once (in place)."""

        def put(a):
            return None if a is None else torch.as_tensor(a, device=device)

        self.buckets = [
            (put(i), put(w), put(v), put(rs), ns)
            for (i, w, v, rs, ns) in self.buckets
        ]
        self.row_folds = [put(f) for f in self.row_folds]
        self.unpermute = put(self.unpermute)
        return self


def flat_take(tab: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``tab[idx]`` for a 2-D index matrix, as a flat 1-D gather + reshape."""
    flat = idx.reshape(-1)
    return torch.index_select(tab, 0, flat).reshape(tuple(idx.shape) + tuple(tab.shape[1:]))


def fp_fence(a: torch.Tensor) -> torch.Tensor:
    """Add a zero to ``a``. Eager torch never contracts a multiply into a
    following add, so this is no fence here; it is kept because the zero
    turns -0.0 into +0.0 exactly as the reference's fence does."""
    return a + 0.0


def tree_reduce(m: torch.Tensor, op: str) -> torch.Tensor:
    """Reduce axis 1 of ``m`` (width a power of two) through the fixed
    adjacent-pair halving tree [a,b,c,d] -> [a+b, c+d] -> [(a+b)+(c+d)] —
    the reference's bitwise contract."""
    width = m.shape[1]
    if width & (width - 1):
        raise ValueError(f"tree_reduce width {width} is not a power of two")
    while m.shape[1] > 1:
        a = m[:, 0::2]
        b = m[:, 1::2]
        if op == Combiner.SUM:
            m = a + b
        elif op == Combiner.MIN:
            m = torch.minimum(a, b)
        else:
            m = torch.maximum(a, b)
    return m[:, 0]


def segment_combine(op: str, values: torch.Tensor, seg: torch.Tensor, num_segments: int):
    """Monoid fold of ``values`` rows by segment into an identity-filled
    output. SUM adds in index order on the CPU, like the reference's
    ``np.add.at``, and through float atomics on the card (no fixed order);
    MIN/MAX do not depend on the order. ``values`` arrive transformed
    (``apply_edge_transform``, per column where the program says so)."""
    out = torch.full(
        (num_segments,) + tuple(values.shape[1:]), Combiner.IDENTITY[op],
        dtype=values.dtype, device=values.device,
    )
    seg = seg.long()
    if op == Combiner.SUM:
        return out.index_add_(0, seg, values)
    index = seg.view((-1,) + (1,) * (values.ndim - 1)).expand_as(values)
    reduce = "amin" if op == Combiner.MIN else "amax"
    return out.scatter_reduce_(0, index, values, reduce, include_self=True)


def ell_aggregate(
    pack: ELLPack,
    msgs: torch.Tensor,
    op: str,
    edge_transform: str = EdgeTransform.NONE,
    cols=None,
) -> torch.Tensor:
    """Aggregate per-vertex messages over an ELLPack (tensors on the
    messages' device). msgs: (n,) or (n, k); ``cols``: per-column
    transforms of (n, k) messages (``apply_edge_transform``). Returns the
    per-destination fold, the monoid identity where a vertex has no
    in-edges."""
    identity = Combiner.IDENTITY[op]
    if not pack.has_weight:
        edge_transform = EdgeTransform.NONE
        cols = None
    pad = torch.full(
        (1,) + tuple(msgs.shape[1:]), identity, dtype=msgs.dtype, device=msgs.device
    )
    msgs_ext = torch.cat([msgs, pad], dim=0)
    parts = []
    for (idx, w, valid, _rowseg, _num_slots), fold in zip(pack.buckets, pack.row_folds):
        m = flat_take(msgs_ext, idx)
        if w is not None:
            # transform, then force padded slots back to the identity (a
            # transform can disturb it, e.g. inf * 0 = nan for MIN)
            m = _transform(m, w, valid, op, edge_transform, cols)
        r = tree_reduce(m, op)
        if fold is not None:
            r = fold_rows(op, r, fold)
        parts.append(r)
    if not parts:
        return torch.full(msgs.shape, identity, dtype=msgs.dtype, device=msgs.device)
    stacked = torch.cat(parts, dim=0)
    return torch.index_select(stacked, 0, pack.unpermute)


def _transform(m, w, valid, op: str, edge_transform: str, cols=None) -> torch.Tensor:
    """A weighted bucket's transform, slot for slot: the weight product or
    sum (per column with ``cols``), padded slots forced back to the
    identity (where ``valid`` is given), then the fence."""
    if cols is not None:
        m = apply_edge_transform(m, w, edge_transform, cols)
    else:
        w_ = w[:, :, None] if m.ndim == 3 else w
        if edge_transform == EdgeTransform.MUL_WEIGHT:
            m = m * w_
        elif edge_transform == EdgeTransform.ADD_WEIGHT:
            m = m + w_
    if valid is not None:
        valid_ = valid[:, :, None] if m.ndim == 3 else valid
        m = torch.where(valid_ > 0, m, Combiner.IDENTITY[op])
    return fp_fence(m)


# --------------------------------------------------------------------------
# Degree-bucketed hybrid: exact-width ELL torso + chunked CSR tail
# --------------------------------------------------------------------------

def _next_pow2(v: int) -> int:
    return 1 << max(0, int(v) - 1).bit_length() if v > 1 else 1


class HybridPack:
    """Hybrid layout of an edge list grouped by destination degree.

    Torso (in-degree 1..hub_cutoff): one bucket per exact degree d, a
    (rows, d) source-index matrix with no padded slot; the reduction pads to
    next-pow2(d) with the identity without gathering it, which reproduces
    the ELL bucket's leaves. Degree-0 vertices get the identity.

    Tail (hubs, in-degree > hub_cutoff): the hubs' destination-sorted edge
    ranges cut into ``tail_chunk``-wide chunks (the last chunk of a row
    sentinel-padded); chunk partials go to an identity-filled per-row table
    of width cap / tail_chunk, which folds down the remaining tree levels.
    Degrees above ``max_capacity`` row-split first, as in ``ELLPack``.

    Every width is a power of two, so each vertex reduces through the same
    ``tree_reduce`` tree as ELL: hybrid and ELL results are bitwise equal.
    Built as numpy (the arrays equal the reference's); ``to(device)`` moves
    them once. Each tail entry with split rows also holds its
    ``row_fold_matrix`` under "fold".
    """

    def __init__(
        self,
        src: np.ndarray,
        dst: np.ndarray,
        weight: Optional[np.ndarray],
        num_vertices: int,
        hub_cutoff: int = 64,
        tail_chunk: int = 256,
        max_capacity: int = 1 << 14,
    ):
        n = num_vertices
        self.num_vertices = n
        self.sentinel = n
        self.has_weight = weight is not None
        self.hub_cutoff = int(hub_cutoff)
        tail_chunk = int(tail_chunk)
        if tail_chunk < 1 or tail_chunk & (tail_chunk - 1):
            raise ValueError(f"tail_chunk must be a power of two (got {tail_chunk})")
        if self.hub_cutoff < 1:
            raise ValueError(f"hub_cutoff must be >= 1 (got {hub_cutoff})")
        # every hub's tree width is >= next_pow2(cutoff + 1); the chunk must
        # divide it so chunks stay aligned subtrees
        self.tail_chunk = min(tail_chunk, _next_pow2(self.hub_cutoff + 1), int(max_capacity))

        order = np.argsort(dst, kind="stable")
        src = np.asarray(src, dtype=np.int64)[order]
        dst = np.asarray(dst, dtype=np.int64)[order]
        w = np.asarray(weight, dtype=np.float32)[order] if weight is not None else None
        deg = np.bincount(dst, minlength=n).astype(np.int64)
        indptr = np.zeros(n + 1, dtype=np.int64)
        np.cumsum(deg, out=indptr[1:])
        src32 = np.ascontiguousarray(src, dtype=np.int32)
        w32 = np.ascontiguousarray(w, dtype=np.float32) if w is not None else None

        parts: List[np.ndarray] = []
        #: torso buckets ({"idx", "w"?}) and their (width, tree width)
        self.torso: List[dict] = []
        self.torso_meta: List[Tuple[int, int]] = []
        for d in (int(x) for x in np.unique(deg[(deg >= 1) & (deg <= self.hub_cutoff)])):
            members = np.nonzero(deg == d)[0]
            pos = indptr[members][:, None] + np.arange(d, dtype=np.int64)
            entry = {"idx": src32[pos]}
            if self.has_weight:
                entry["w"] = w32[pos]
            self.torso.append(entry)
            self.torso_meta.append((d, _next_pow2(d)))
            parts.append(members)

        zero_members = np.nonzero(deg == 0)[0]
        self.num_zero = len(zero_members)
        if self.num_zero:
            parts.append(zero_members)

        #: tail buckets ({"idx", "slot", "w"?, "valid"?, "rowseg"?, "fold"?})
        #: and their (tree width, partials per row, rows, slots)
        self.tail: List[dict] = []
        self.tail_meta: List[Tuple[int, int, int, int]] = []
        T = self.tail_chunk
        hub = deg > self.hub_cutoff
        if hub.any():
            caps = np.minimum(
                1 << np.ceil(np.log2(np.maximum(deg, 1))).astype(np.int64),
                int(max_capacity),
            )
            for c in sorted(int(x) for x in np.unique(caps[hub])):
                members = np.nonzero(hub & (caps == c))[0]
                deg_m = deg[members]
                starts_m = indptr[members]
                if c == int(max_capacity) and int(deg_m.max()) > c:
                    starts_r, degs_r, rowseg = split_rows(members, deg_m, starts_m, c)
                else:
                    starts_r, degs_r, rowseg = starts_m, deg_m, None
                rows = len(starts_r)
                ppr = c // T  # partial-table width per row
                nch = -(-degs_r // T)  # real chunks per row (degs_r >= 1)
                total = int(nch.sum())
                row_of = np.repeat(np.arange(rows, dtype=np.int64), nch)
                posr = np.arange(total, dtype=np.int64) - np.repeat(np.cumsum(nch) - nch, nch)
                ch_start = starts_r[row_of] + posr * T
                ch_deg = np.minimum(T, degs_r[row_of] - posr * T)
                idx = np.full((total, T), self.sentinel, dtype=np.int32)
                if self.has_weight:
                    wmat = np.zeros((total, T), dtype=np.float32)
                    valid = np.zeros((total, T), dtype=np.float32)
                else:
                    wmat = valid = None
                fill_ell_rows(ch_start, ch_deg, src32, w32, idx, wmat, valid)
                entry = {"idx": idx, "slot": (row_of * ppr + posr).astype(np.int32)}
                if wmat is not None:
                    entry["w"] = wmat
                    entry["valid"] = valid
                if rowseg is not None:
                    entry["rowseg"] = rowseg.astype(np.int32)
                    entry["fold"] = row_fold_matrix(rowseg, len(members))
                self.tail.append(entry)
                self.tail_meta.append((c, ppr, rows, len(members)))
                parts.append(members)

        vertex_order = np.concatenate(parts) if parts else np.zeros(0, dtype=np.int64)
        pos = np.zeros(n, dtype=np.int64)
        pos[vertex_order] = np.arange(len(vertex_order), dtype=np.int64)
        self.unpermute = pos.astype(np.int32)
        #: gathered slots (what the pad ratio prices); the partial tables
        #: are rows-sized and left out
        self.slots = sum(int(b["idx"].size) for b in self.torso) + sum(
            int(b["idx"].size) for b in self.tail
        )
        self.pad_ratio = self.slots / max(1, len(src))

    def to(self, device) -> "HybridPack":
        """Move the index/weight/slot matrices to ``device`` once (in place);
        the tail's slots become int64, the index type torch scatters take."""

        def put(k, a):
            t = torch.as_tensor(a, device=device)
            return t.long() if k == "slot" else t

        self.torso = [{k: put(k, v) for k, v in b.items()} for b in self.torso]
        self.tail = [{k: put(k, v) for k, v in b.items()} for b in self.tail]
        self.unpermute = torch.as_tensor(self.unpermute, device=device)
        return self


def hybrid_aggregate(
    pack: HybridPack,
    msgs: torch.Tensor,
    op: str,
    edge_transform: str = EdgeTransform.NONE,
    cols=None,
) -> torch.Tensor:
    """Aggregate per-vertex messages over a HybridPack: the contract of
    ``ell_aggregate`` (msgs (n,) or (n, k), ``cols``, the per-destination
    fold, the identity where a vertex has no in-edges), with the same
    bits."""
    identity = Combiner.IDENTITY[op]
    if not pack.has_weight:
        edge_transform = EdgeTransform.NONE
        cols = None
    pad = torch.full(
        (1,) + tuple(msgs.shape[1:]), identity, dtype=msgs.dtype, device=msgs.device
    )
    msgs_ext = torch.cat([msgs, pad], dim=0)
    parts = []
    for entry, (d, cap) in zip(pack.torso, pack.torso_meta):
        m = flat_take(msgs_ext, entry["idx"])  # (rows, d[, k])
        if "w" in entry:
            m = _transform(m, entry["w"], None, op, edge_transform, cols)
        if cap > d:
            # identity pad up to the pow2 tree width: the ELL bucket's
            # sentinel leaves, never gathered
            fill = torch.full(
                (m.shape[0], cap - d) + tuple(m.shape[2:]), identity,
                dtype=m.dtype, device=m.device,
            )
            m = torch.cat([m, fill], dim=1)
        parts.append(tree_reduce(m, op))

    if pack.num_zero:
        parts.append(torch.full(
            (pack.num_zero,) + tuple(msgs.shape[1:]), identity,
            dtype=msgs.dtype, device=msgs.device,
        ))

    for entry, (_cap, ppr, rows, _num_slots) in zip(pack.tail, pack.tail_meta):
        m = flat_take(msgs_ext, entry["idx"])  # (chunks, T[, k])
        if "w" in entry:
            m = _transform(m, entry["w"], entry["valid"], op, edge_transform, cols)
        part = tree_reduce(m, op)  # (chunks[, k]): aligned subtrees
        table = torch.full(
            (rows * ppr,) + tuple(part.shape[1:]), identity,
            dtype=part.dtype, device=part.device,
        )
        table = table.index_copy(0, entry["slot"], part)
        # the remaining upper tree levels: fold each row's partials
        r = tree_reduce(table.reshape((rows, ppr) + tuple(part.shape[1:])), op)
        if "fold" in entry:
            r = fold_rows(op, r, entry["fold"])
        parts.append(r)

    if not parts:
        return torch.full(msgs.shape, identity, dtype=msgs.dtype, device=msgs.device)
    stacked = torch.cat(parts, dim=0)
    return torch.index_select(stacked, 0, pack.unpermute)


# --------------------------------------------------------------------------
# Sorted segment sum
# --------------------------------------------------------------------------

#: threads of one CTA of the merge kernel and the merge items (segment ends
#: + edges) each walks (``kThreads``, ``kItemsPerThread`` in
#: csrc/segsum.cu); an odd count, so the threads of a warp, each walking its
#: own run, spread their shared-memory reads over the banks
SEGSUM_THREADS = 256
SEGSUM_ITEMS_PER_THREAD = 15
#: merge items per CTA: the default split, and the most one CTA holds
SEGSUM_ITEMS_PER_CTA = SEGSUM_THREADS * SEGSUM_ITEMS_PER_THREAD


class _SegSumPlan:
    """Static host-side plan of the sorted segment sum.

    Two layouts of the same destination-sorted edges:

    - the reference's tile-aligned blocks (``gather_idx``, ``pad_mask``,
      ``seg_local``, ``out_tile``, ``is_first``), equal to
      ``janusgraph_tpu/olap/kernels.py::_SegSumPlan``'s arrays; the plain
      version reads them;
    - what the CUDA kernel reads: the segment offsets ``seg_ptr``
      ((n + 1,) int32, ``seg_ptr[s]`` = the first edge of segment s) and a
      merge-path partition of the n segment ends merged with the E edges
      into ``num_ctas`` runs of at most ``items_per_cta`` items: CTA k
      starts at segment end ``seg_start[k]`` and edge ``edge_start[k]``
      ((num_ctas + 1,) int32 each; Merrill and Garland, SC '16).
    """

    def __init__(
        self,
        seg: np.ndarray,
        num_segments: int,
        block: int = 1024,
        tile: int = 1024,
        items_per_cta: int = SEGSUM_ITEMS_PER_CTA,
    ):
        if len(seg) >= 2**31:
            raise ValueError(f"sorted_segment_sum takes fewer than 2**31 edges, got {len(seg)}")
        if items_per_cta < 1:
            raise ValueError(f"items_per_cta must be positive, got {items_per_cta}")
        self.block = block
        self.tile = tile
        self.num_segments = num_segments
        self.padded_segments = -(-max(num_segments, 1) // tile) * tile
        num_tiles = self.padded_segments // tile
        self.num_tiles = num_tiles

        seg = np.asarray(seg, dtype=np.int64)
        m = len(seg)
        if m and (np.any(np.diff(seg) < 0) or seg[0] < 0 or seg[-1] >= num_segments):
            raise ValueError("segment ids must be sorted and within [0, num_segments)")
        self._merge_path(seg, items_per_cta)
        self.num_edges = m
        tile_of = seg // tile
        counts = np.bincount(tile_of, minlength=num_tiles)
        blocks_per_tile = np.maximum(1, -(-counts // block))
        total_blocks = int(blocks_per_tile.sum())
        padded_m = total_blocks * block

        gather_idx = np.zeros(padded_m, dtype=np.int32)
        pad_mask = np.zeros(padded_m, dtype=np.float32)
        seg_local = np.zeros(padded_m, dtype=np.int32)
        out_tile = np.zeros(total_blocks, dtype=np.int32)
        is_first = np.zeros(total_blocks, dtype=np.int32)

        edge_starts = np.zeros(num_tiles + 1, dtype=np.int64)
        np.cumsum(counts, out=edge_starts[1:])
        b = 0
        w = 0
        for t in range(num_tiles):
            lo, hi = edge_starts[t], edge_starts[t + 1]
            k = hi - lo
            gather_idx[w : w + k] = np.arange(lo, hi, dtype=np.int32)
            pad_mask[w : w + k] = 1.0
            seg_local[w : w + k] = (seg[lo:hi] - t * tile).astype(np.int32)
            nb = int(blocks_per_tile[t])
            out_tile[b : b + nb] = t
            is_first[b] = 1
            b += nb
            w += nb * block
        self.gather_idx = gather_idx
        self.pad_mask = pad_mask
        self.seg_local = seg_local
        self.out_tile = out_tile
        self.is_first = is_first
        self.num_blocks = total_blocks
        self._device: Dict[Tuple[str, bool], Dict[str, torch.Tensor]] = {}

    def _merge_path(self, seg: np.ndarray, items_per_cta: int) -> None:
        """``seg_ptr`` and the merge-path partition. Segment end s is merge
        item s + seg_ptr[s + 1] (its edges and the ends before it come
        first), an increasing sequence; a diagonal d starts after the ends
        placed before d, so one searchsorted places every diagonal."""
        n, m = self.num_segments, len(seg)
        seg_ptr = np.searchsorted(seg, np.arange(n + 1), side="left")
        total = n + m
        num_ctas = -(-total // items_per_cta)
        diag = np.minimum(np.arange(num_ctas + 1, dtype=np.int64) * items_per_cta, total)
        seg_start = np.searchsorted(seg_ptr[1:] + np.arange(n), diag, side="left")
        self.items_per_cta = items_per_cta
        self.num_ctas = num_ctas
        self.seg_ptr = seg_ptr.astype(np.int32)
        self.seg_start = seg_start.astype(np.int32)
        self.edge_start = (diag - seg_start).astype(np.int32)

    def max_segment_cta_span(self) -> int:
        """The most CTAs one segment's items (its edges, then its end)
        reach: 1 unless a segment crosses a CTA boundary."""
        if not self.num_segments:
            return 0
        s = np.arange(self.num_segments, dtype=np.int64)
        first = (s + self.seg_ptr[:-1]) // self.items_per_cta
        last = (s + self.seg_ptr[1:]) // self.items_per_cta
        return int((last - first).max()) + 1

    def device_arrays(self, device, plain: bool = False) -> Dict[str, torch.Tensor]:
        """The arrays the kernel reads (segment offsets and the partition),
        or with ``plain`` the plain version's view of the reference layout
        (each valid slot's edge and global segment), as tensors on
        ``device``; moved once."""
        key = (str(device), plain)
        arrs = self._device.get(key)
        if arrs is None:
            if plain:
                valid = np.nonzero(self.pad_mask)[0]
                tile_of_slot = np.repeat(self.out_tile.astype(np.int64), self.block)[valid]
                host = {
                    "edge": self.gather_idx[valid].astype(np.int64),
                    "seg": tile_of_slot * self.tile + self.seg_local[valid],
                }
            else:
                host = {
                    "seg_ptr": self.seg_ptr,
                    "seg_start": self.seg_start,
                    "edge_start": self.edge_start,
                }
            arrs = {k: torch.as_tensor(v, device=device) for k, v in host.items()}
            self._device[key] = arrs
        return arrs

    def function_bytes(self) -> int:
        """Bytes the sum itself must move, whatever the layout: each value
        read once, the n + 1 segment offsets read once (sorted segments need
        no per-edge id), each segment's sum written once."""
        return 4 * (self.num_edges + 2 * self.num_segments + 1)

    def kernel_read_bytes(self) -> int:
        """Bytes the CUDA kernels move, each counted once: values, the n
        segment ends, the sums (each written once); the partition; each
        CTA's open run and its part of the segment it closes first, written
        and read back by the fix-up."""
        heads = int(np.count_nonzero(np.diff(self.seg_start)[1:]))
        return 4 * (
            self.num_edges + 2 * self.num_segments
            + 2 * (self.num_ctas + 1) + 2 * self.num_ctas + 2 * heads
        )


def make_segsum_plan(
    seg: np.ndarray,
    num_segments: int,
    block: int = 1024,
    tile: int = 1024,
    items_per_cta: int = SEGSUM_ITEMS_PER_CTA,
) -> _SegSumPlan:
    return _SegSumPlan(seg, num_segments, block=block, tile=tile, items_per_cta=items_per_cta)


def edge_list_plan(
    src: np.ndarray, dst: np.ndarray, weight: Optional[np.ndarray], num_vertices: int
) -> Tuple[_SegSumPlan, np.ndarray, Optional[np.ndarray]]:
    """The segment-sum plan of an edge list that aggregates at ``dst`` (a
    typed channel's ``channel_edges``), with the sources and weights in the
    plan's edge order: (plan, src, weight). The edges are sorted stably by
    destination, so each destination keeps the list's order (a "both"
    channel: in-edges, then out-edges), the order the ELL pack reads."""
    dst = np.asarray(dst, dtype=np.int64)
    src = np.asarray(src, dtype=np.int64)
    if len(dst) and np.any(dst[1:] < dst[:-1]):
        order = np.argsort(dst, kind="stable")
        src, dst = src[order], dst[order]
        weight = weight[order] if weight is not None else None
    return make_segsum_plan(dst, num_vertices), src, weight


def _check_segsum_input(data: torch.Tensor, plan: _SegSumPlan) -> None:
    if data.dtype != torch.float32 or data.ndim != 1 or data.shape[0] != plan.num_edges:
        raise ValueError(
            f"sorted_segment_sum takes ({plan.num_edges},) float32 data, got "
            f"{tuple(data.shape)} {data.dtype}"
        )


def sorted_segment_sum_plain(data: torch.Tensor, plan: _SegSumPlan) -> torch.Tensor:
    """Plain PyTorch version of the kernel: ``index_add_`` of the plan's
    valid slots into a zeroed output. Returns (num_segments,) float32."""
    _check_segsum_input(data, plan)
    arrs = plan.device_arrays(data.device, plain=True)
    out = torch.zeros(plan.padded_segments, dtype=torch.float32, device=data.device)
    out.index_add_(0, arrs["seg"], torch.index_select(data, 0, arrs["edge"]))
    return out[: plan.num_segments]


def sorted_segment_sum(data: torch.Tensor, plan: _SegSumPlan) -> torch.Tensor:
    """Per-segment fp32 sum of per-edge ``data`` (edges sorted by segment).
    Returns (num_segments,) float32.

    Replaces ``janusgraph_tpu/olap/kernels.py::pallas_sorted_segment_sum``.
    On a CUDA tensor this launches the CUDA kernels (``csrc/segsum.cu``: the
    merge-path pass, then the one-CTA carry fix-up) or raises; on a CPU
    tensor it runs ``sorted_segment_sum_plain``.
    """
    if data.device.type == "cpu":
        return sorted_segment_sum_plain(data, plan)
    if data.device.type != "cuda":
        raise ValueError(f"sorted_segment_sum: unsupported device {data.device}")
    _check_segsum_input(data, plan)
    if not data.is_contiguous():
        raise ValueError("sorted_segment_sum: data must be contiguous")
    if plan.num_edges >= 2**31:
        raise ValueError(f"sorted_segment_sum takes fewer than 2**31 edges, got {plan.num_edges}")
    out = torch.empty(plan.num_segments, dtype=torch.float32, device=data.device)
    if plan.num_ctas == 0:
        return out
    from janusgraph_tpu_torch import _build

    lib = _build.load_library()
    arrs = plan.device_arrays(data.device)
    counter = _device_counter(data.device)
    # each CTA's open run, then its part of the first segment it closes
    carry = torch.empty(2 * plan.num_ctas, dtype=torch.float32, device=data.device)
    with torch.cuda.device(data.device):
        stream = torch.cuda.current_stream(data.device).cuda_stream
        rc = lib.jg_sorted_segment_sum(
            data.data_ptr(),
            arrs["seg_ptr"].data_ptr(),
            arrs["seg_start"].data_ptr(),
            arrs["edge_start"].data_ptr(),
            plan.num_ctas,
            plan.items_per_cta,
            plan.num_segments,
            carry.data_ptr(),
            out.data_ptr(),
            counter.data_ptr(),
            stream,
        )
    if rc != 0:
        msg = lib.jg_error_string(rc).decode()
        raise RuntimeError(f"sorted_segment_sum kernel launch failed: {msg} ({rc})")
    if torch.cuda.is_current_stream_capturing():
        # recorded into a CUDA graph: the kernels run at each replay, which
        # the host does not see
        sorted_segment_sum.captured += 1
    else:
        sorted_segment_sum.launches += 1
    return out


#: calls that launched the CUDA kernels (the merge-path pass and its
#: fix-up) since the last reset; the CPU path adds none
sorted_segment_sum.launches = 0
#: calls recorded into CUDA graphs since the last reset (their kernels
#: launch only when a graph is replayed)
sorted_segment_sum.captured = 0

#: device -> the (1,) int64 counter the fix-up kernel adds one to at every
#: run, eager or replayed from a CUDA graph
_DEVICE_COUNTERS: Dict[str, torch.Tensor] = {}


def _counter_key(device) -> str:
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return str(dev)


def _device_counter(device) -> torch.Tensor:
    key = _counter_key(device)
    counter = _DEVICE_COUNTERS.get(key)
    if counter is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                "sorted_segment_sum: the first call on a device must run eagerly, "
                "not inside a CUDA graph capture"
            )
        counter = torch.zeros(1, dtype=torch.int64, device=device)
        _DEVICE_COUNTERS[key] = counter
    return counter


def device_launches(device) -> int:
    """Runs of the kernels on ``device`` since the last reset, as the
    kernels count them (replays from CUDA graphs included); reads the
    device, so it waits for the work queued before it."""
    counter = _DEVICE_COUNTERS.get(_counter_key(device))
    return int(counter.item()) if counter is not None else 0


def reset_launch_counts() -> None:
    sorted_segment_sum.launches = 0
    sorted_segment_sum.captured = 0
    for counter in _DEVICE_COUNTERS.values():
        counter.zero_()


def launch_counts() -> Dict[str, int]:
    return {"sorted_segment_sum": sorted_segment_sum.launches}
