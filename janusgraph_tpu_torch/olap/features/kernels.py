"""Dense-feature kernels: the superstep over ``[n, d]`` feature blocks —
the port of ``janusgraph_tpu/olap/features/kernels.py``.

Three message modes ride the packed layouts of ``olap/kernels.py``:

  copy      message = source feature row (plain SpMM over the pack)
  weighted  message = w_e * source row (the scalar tier's MUL_WEIGHT path)
  sddmm     message = <h_src, h_dst> * h_src — a per-edge dot-attention
            coefficient computed in the same gather pass

plus the post-aggregate dense layer ``act(h @ w + b)`` (``dense_transform``).

Bitwise contract (the reference's): every reduction that feeds vertex
state goes through the fixed adjacent-pair tree (``tree_reduce``), the
SDDMM dot (``tree_dot``) and the dense layer's contraction
(``tree_matmul``) included, and every product feeding an add is fenced.
Eager torch rounds each operation on its own, so these functions give the
reference's numpy bits on the CPU and on the card, and ELL and hybrid give
each other's bits. Feature dims pad to power-of-two lane tiers
(``FEATURE_TIERS``); padded columns hold zeros and stay zero.

Everything here is plain torch. ``tree_matmul`` materializes the
``(rows, k, j)`` products of a row block and folds them; it is the dense
tier's largest cost on the card (PERF.md) and a hand-kernel candidate
(ROADMAP.md Queue B). ``native=True`` is ``torch.matmul`` at torch's
default float32 precision (TF32 off), outside the bitwise contract.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from janusgraph_tpu_torch.olap.kernels import (
    ELLPack,
    HybridPack,
    _next_pow2,
    flat_take,
    fold_rows,
    fp_fence,
    segment_combine,
    tree_reduce,
)
from janusgraph_tpu_torch.olap.vertex_program import Combiner

#: power-of-two lane-width tiers the feature dimension pads to; larger dims
#: take the next power of two
FEATURE_TIERS = (8, 16, 32, 64, 128, 256, 512)


def pick_feature_tier(d: int, forced: int = 0) -> int:
    """Smallest lane tier >= d (next pow2 above the ladder). ``forced``
    pins the tier; it must be a power of two that does not truncate d."""
    d = int(d)
    if d < 1:
        raise ValueError(f"feature_dim must be >= 1 (got {d})")
    if forced:
        forced = int(forced)
        if forced & (forced - 1) or forced < d:
            raise ValueError(
                f"features dim tier {forced} must be a power of two >= the "
                f"logical feature dim {d}"
            )
        return forced
    for t in FEATURE_TIERS:
        if t >= d:
            return t
    return _next_pow2(d)


def pad_features(h: np.ndarray, d_pad: int) -> np.ndarray:
    """Host-side zero-pad of an (n, d) float block to (n, d_pad)."""
    h = np.asarray(h, dtype=np.float32)
    if h.ndim != 2:
        raise ValueError(f"feature block must be 2-D (got shape {h.shape})")
    n, d = h.shape
    if d == d_pad:
        return h
    if d > d_pad:
        raise ValueError(f"feature dim {d} exceeds padded tier {d_pad}")
    out = np.zeros((n, d_pad), dtype=np.float32)
    out[:, :d] = h
    return out


def tree_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Row-wise dot product over the last axis (a pow2 lane tier) through
    the fixed adjacent-pair tree, the product fenced."""
    prod = fp_fence(a * b)
    flat = prod.reshape((-1, prod.shape[-1]))
    return tree_reduce(flat, Combiner.SUM).reshape(prod.shape[:-1])


#: product bytes one row block of ``tree_matmul`` materializes. The
#: reference's 8 MB suits a TPU core's VMEM; on the card it would cut
#: (2^20, 32) @ (32, 32) into 512 blocks, some 4,000 launches a layer. A
#: 256 MB block is 16 blocks there, and its (rows, k, j) products and tree
#: levels take about 512 MB of the card's 80 GB. Blocks never change bits:
#: rows reduce independently.
MM_BLOCK_BYTES = 1 << 28


def tree_matmul(h: torch.Tensor, w: torch.Tensor, native: bool = False) -> torch.Tensor:
    """(n, k) @ (k, j) with the contraction folded through the fixed
    adjacent-pair tree over k (a power of two), in row blocks of about
    ``MM_BLOCK_BYTES`` of products. ``native=True`` is ``torch.matmul`` in
    fp32: TF32 is off for the call, and the caller's setting is restored
    after it."""
    if native:
        allow = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            return torch.matmul(h, w)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = allow
    n, k = h.shape
    j = w.shape[1]
    if k & (k - 1):
        raise ValueError(f"tree_matmul contraction width {k} is not pow2")

    def block(hb):
        return tree_reduce(fp_fence(hb[:, :, None] * w[None, :, :]), Combiner.SUM)

    rows = max(1, MM_BLOCK_BYTES // max(1, 4 * k * j))
    rows = 1 << (rows.bit_length() - 1)
    if n <= rows:
        return block(h)
    return torch.cat([block(h[i: i + rows]) for i in range(0, n, rows)], dim=0)


_ACTIVATIONS = ("identity", "relu", "tanh")


def dense_transform(h: torch.Tensor, w: torch.Tensor, b=None, activation: str = "identity",
                    native: bool = False) -> torch.Tensor:
    """The post-aggregate dense layer ``act(h @ w + b)``. relu and identity
    are exact (inside the bitwise contract); tanh is the backend's."""
    if activation not in _ACTIVATIONS:
        raise ValueError(f"unknown activation {activation!r}")
    out = tree_matmul(h, w, native=native)
    if b is not None:
        out = out + b
    if activation == "relu":
        out = torch.clamp_min(out, 0.0)
    elif activation == "tanh":
        out = torch.tanh(out)
    return out


# --------------------------------------------------------------------------
# SDDMM row-destination indices
# --------------------------------------------------------------------------
#
# Every slot of a pack row shares one destination, so the SDDMM coefficient
# needs one destination index per row (per chunk in the hybrid tail). A
# shadow pack built from the (dst, dst) edge list has the real pack's
# layout row for row (bucketing reads destination degrees only); column 0
# of each index matrix is the row's destination.


def ell_row_dsts(src: np.ndarray, dst: np.ndarray, num_vertices: int,
                 max_capacity: int = 1 << 14) -> List[np.ndarray]:
    """Per-bucket (rows,) destination indices aligned with
    ``ELLPack(src, dst, ..., max_capacity)``'s buckets."""
    dst = np.asarray(dst, dtype=np.int64)
    shadow = ELLPack(dst, dst, None, num_vertices, max_capacity=max_capacity)
    return [np.ascontiguousarray(b[0][:, 0]) for b in shadow.buckets]


def hybrid_row_dsts(src: np.ndarray, dst: np.ndarray, num_vertices: int,
                    hub_cutoff: int = 64, tail_chunk: int = 256,
                    max_capacity: int = 1 << 14) -> dict:
    """{"torso": [...], "tail": [...]} destination indices aligned with the
    equivalent ``HybridPack``'s torso buckets and tail chunks."""
    dst = np.asarray(dst, dtype=np.int64)
    shadow = HybridPack(dst, dst, None, num_vertices, hub_cutoff=hub_cutoff,
                        tail_chunk=tail_chunk, max_capacity=max_capacity)
    return {
        "torso": [np.ascontiguousarray(b["idx"][:, 0]) for b in shadow.torso],
        "tail": [np.ascontiguousarray(b["idx"][:, 0]) for b in shadow.tail],
    }


# --------------------------------------------------------------------------
# Fused SDDMM-SpMM aggregation
# --------------------------------------------------------------------------


def _check_sddmm(op: str, msgs: torch.Tensor) -> None:
    if op != Combiner.SUM:
        raise ValueError(
            f"sddmm aggregation is SUM-only (dot-attention coefficients "
            f"have no {op} semantics)"
        )
    d = msgs.shape[-1]
    if msgs.ndim != 2 or d & (d - 1):
        raise ValueError(
            f"sddmm needs (n, d) features with a pow2 lane-tier d "
            f"(got shape {tuple(msgs.shape)})"
        )


def _extended(msgs: torch.Tensor) -> torch.Tensor:
    """The messages plus the sentinel row (zeros, the SUM identity)."""
    return torch.cat([msgs, torch.zeros((1,) + tuple(msgs.shape[1:]), dtype=msgs.dtype,
                                        device=msgs.device)], dim=0)


def _scored(m: torch.Tensor, dstf: torch.Tensor) -> torch.Tensor:
    """Each gathered slot times its dot-attention coefficient with the
    row's destination, fenced: (rows, c, d)."""
    alpha = tree_dot(m, dstf[:, None, :])
    return fp_fence(m * alpha[:, :, None])


def sddmm_ell_aggregate(pack: ELLPack, row_dsts, msgs: torch.Tensor,
                        op: str = Combiner.SUM) -> torch.Tensor:
    """Fused SDDMM+SpMM over an ELLPack on the messages' device: for each
    in-edge, coefficient = <h_src, h_dst> (tree dot), message =
    coefficient * h_src, summed per destination through the shared tree.
    ``row_dsts``: per-bucket (rows,) destination indices (``ell_row_dsts``)
    as tensors. Sentinel slots gather the zero row, so their coefficient
    and message are exactly zero."""
    _check_sddmm(op, msgs)
    if len(row_dsts) != len(pack.buckets):
        raise ValueError(
            f"sddmm row-dst count {len(row_dsts)} != bucket count "
            f"{len(pack.buckets)} (pack drift)"
        )
    msgs_ext = _extended(msgs)
    parts = []
    for (idx, _w, _valid, _rowseg, _slots), fold, rdst in zip(
        pack.buckets, pack.row_folds, row_dsts
    ):
        m = flat_take(msgs_ext, idx)                     # (rows, c, d)
        r = tree_reduce(_scored(m, flat_take(msgs_ext, rdst)), op)
        if fold is not None:
            # split supernode rows share one destination: fold the partials
            r = fold_rows(op, r, fold)
        parts.append(r)
    if not parts:
        return torch.zeros_like(msgs)
    return torch.index_select(torch.cat(parts, dim=0), 0, pack.unpermute)


def sddmm_hybrid_aggregate(pack: HybridPack, row_dsts, msgs: torch.Tensor,
                           op: str = Combiner.SUM) -> torch.Tensor:
    """Fused SDDMM+SpMM over a HybridPack, bitwise equal to
    ``sddmm_ell_aggregate``: per-slot coefficients are elementwise, so the
    leaves of every row's reduction tree carry the same bits in both
    layouts."""
    _check_sddmm(op, msgs)
    if len(row_dsts["torso"]) != len(pack.torso_meta) or len(row_dsts["tail"]) != len(pack.tail_meta):
        raise ValueError(
            f"sddmm row-dst counts ({len(row_dsts['torso'])}/"
            f"{len(row_dsts['tail'])}) != hybrid metadata "
            f"({len(pack.torso_meta)}/{len(pack.tail_meta)}) (pack drift)"
        )
    msgs_ext = _extended(msgs)
    parts = []
    for entry, (d, cap), rdst in zip(pack.torso, pack.torso_meta, row_dsts["torso"]):
        m = _scored(flat_take(msgs_ext, entry["idx"]), flat_take(msgs_ext, rdst))
        if cap > d:
            m = torch.cat([m, torch.zeros((m.shape[0], cap - d) + tuple(m.shape[2:]),
                                          dtype=m.dtype, device=m.device)], dim=1)
        parts.append(tree_reduce(m, op))
    if pack.num_zero:
        parts.append(torch.zeros((pack.num_zero,) + tuple(msgs.shape[1:]), dtype=msgs.dtype,
                                 device=msgs.device))
    for entry, (_cap, ppr, rows, _slots), rdst in zip(pack.tail, pack.tail_meta, row_dsts["tail"]):
        part = tree_reduce(
            _scored(flat_take(msgs_ext, entry["idx"]), flat_take(msgs_ext, rdst)), op
        )
        table = torch.zeros((rows * ppr,) + tuple(part.shape[1:]), dtype=part.dtype,
                            device=part.device).index_copy(0, entry["slot"], part)
        r = tree_reduce(table.reshape((rows, ppr) + tuple(part.shape[1:])), op)
        if "fold" in entry:
            r = fold_rows(op, r, entry["fold"])
        parts.append(r)
    if not parts:
        return torch.zeros_like(msgs)
    return torch.index_select(torch.cat(parts, dim=0), 0, pack.unpermute)


def sddmm_segment_aggregate(msgs: torch.Tensor, src_idx: torch.Tensor, dst_idx: torch.Tensor,
                            num_vertices: int) -> torch.Tensor:
    """Flat SDDMM+SpMM: per-edge coefficient from the edge list, then a
    segment sum (``index_add_``: in edge order on the CPU, atomics on the
    card, so outside the pack-vs-pack bitwise contract there)."""
    _check_sddmm(Combiner.SUM, msgs)
    hs = torch.index_select(msgs, 0, src_idx)
    hd = torch.index_select(msgs, 0, dst_idx)
    vals = fp_fence(hs * tree_dot(hs, hd)[:, None])
    return segment_combine(Combiner.SUM, vals, dst_idx, num_vertices)


def sddmm_flops(num_edges: int, d_pad: int) -> float:
    """Flops of one SDDMM pass: a length-d dot (2d) plus the coefficient
    multiply (d) per edge."""
    return 3.0 * float(num_edges) * float(d_pad)


def matmul_flops(n: int, d_in: int, d_out: int) -> float:
    """Flops of one (n, d_in) @ (d_in, d_out) layer."""
    return 2.0 * float(n) * float(d_in) * float(d_out)
