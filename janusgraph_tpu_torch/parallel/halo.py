"""Propagation-blocked halo exchange plan: the source-partitioned view —
the port of ``janusgraph_tpu/parallel/halo.py`` (numpy, host side).

The dst-partitioned ShardedCSR (``parallel/sharded.py``) ships boundary
SOURCE values: every superstep each shard gathers the values its peers need
and swaps (S, B) buckets, then aggregates ALL of its in-edges locally — the
"eager" exchange. Propagation blocking flips the plan to the SOURCE
partition: each shard owns its out-edges, bins remote-bound messages by
DESTINATION shard inside the superstep, combiner-merges them locally (one
merged value per distinct remote destination), and exchanges the merged
bins in ONE batched all-to-all. The receiver only combines S*Hc merged
values instead of aggregating its remote edges.

This module builds the host-side plans and holds the numpy replay oracle:

  * :class:`BlockedPlan` — per-shard source-partitioned edge blocks
    (``blk_src_loc``/``blk_seg``/``blk_valid``/``blk_weight``), the
    bins-only segment map the frontier engine merges through
    (``blk_bin_seg``), and the receive map (``recv_dst``). Bin capacities
    are pow2-tiered (``halo_cap``).
  * distributed loading — ``pair_dst_lists`` / ``build_local`` /
    ``fill_recv`` let a host build ONLY its own shards' blocks, exchanging
    just the compact per-(q→s) distinct-destination lists.
  * :func:`replay_superstep` — the numpy twin of the executor's blocked
    superstep, same arithmetic in the same order (``np.add.at`` adds in
    index order, as torch's ``index_add_`` does on the CPU; the packed form
    reduces through the same adjacent-pair tree) — the bitwise oracle of
    the blocked path, and the per-shard measured-wall probe
    (:func:`measure_shard_walls`).

Bitwise contract: MIN/MAX are exactly order-insensitive, so blocked
results equal the eager paths' (BFS/SSSP/CC). SUM associates per source
shard, then across shards: there the contract is bitwise identity with
:func:`replay_superstep`, and float tolerance against the eager exchange.
On the card the packed ("ell") form keeps it for every monoid; the segment
form's SUM adds through float atomics there (no fixed order).

The port differs from the reference in one place: ``build_ell`` fills the
receiver's combine rows with array operations instead of a Python loop
over every (destination, peer) pair, the same rows in the same order.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from janusgraph_tpu_torch.olap.kernels import _next_pow2, split_rows
from janusgraph_tpu_torch.olap.vertex_program import Combiner, EdgeTransform


# ---------------------------------------------------------------------------
# numpy twins of the executor's torch arithmetic (olap/kernels.py)


def np_fence(a: np.ndarray) -> np.ndarray:
    """``kernels.fp_fence``: add a zero (turns -0.0 into +0.0)."""
    return a + np.float32(0.0)


def np_flat_take(tab: np.ndarray, idx: np.ndarray) -> np.ndarray:
    """``kernels.flat_take``: ``tab[idx]`` for a 2-D index matrix."""
    return tab[idx.reshape(-1)].reshape(idx.shape + tab.shape[1:])


def np_tree_reduce(m: np.ndarray, op: str) -> np.ndarray:
    """``kernels.tree_reduce``: the fixed adjacent-pair halving tree over
    axis 1 (width a power of two)."""
    while m.shape[1] > 1:
        a, b = m[:, 0::2], m[:, 1::2]
        if op == Combiner.SUM:
            m = a + b
        elif op == Combiner.MIN:
            m = np.minimum(a, b)
        else:
            m = np.maximum(a, b)
    return m[:, 0]


def np_edge_transform(msgs: np.ndarray, w, transform, cols=None) -> np.ndarray:
    """``vertex_program.apply_edge_transform`` on numpy arrays."""
    if w is None:
        return msgs
    if cols is not None:
        mul = np.array([1.0 if t == EdgeTransform.MUL_WEIGHT else 0.0 for t in cols], np.float32)
        add = np.array([1.0 if t == EdgeTransform.ADD_WEIGHT else 0.0 for t in cols], np.float32)
        wb = w[..., None]
        return np.where(mul > 0, msgs * wb, msgs) + wb * add
    if transform == EdgeTransform.MUL_WEIGHT:
        return msgs * (w[..., None] if msgs.ndim > w.ndim else w)
    if transform == EdgeTransform.ADD_WEIGHT:
        return msgs + (w[..., None] if msgs.ndim > w.ndim else w)
    return msgs


def edges_from_sharded(sc) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The canonical dst-sorted edge multiset of a ShardedCSR (global src,
    global dst, weight) — the blocked plan builds from the SAME edges the
    eager plan packed, so the two plans aggregate the identical multiset."""
    S, Np, Em = sc.num_shards, sc.shard_size, sc.edges_per_shard
    offsets = sc._offsets
    dst_parts: List[np.ndarray] = []
    w_parts: List[np.ndarray] = []
    for s in range(S):
        k = int(offsets[s + 1] - offsets[s])
        base = s * Em
        dst_parts.append(
            s * Np + sc.in_dst_loc[base : base + k].astype(np.int64)
        )
        w_parts.append(sc.in_weight[base : base + k])
    dst = (
        np.concatenate(dst_parts) if dst_parts
        else np.empty(0, np.int64)
    )
    w = np.concatenate(w_parts) if w_parts else np.empty(0, np.float32)
    return sc._src_sorted.astype(np.int64), dst, w.astype(np.float32)


def _pair_index_dtype(num_shards: int):
    """The narrowest integer type of a (q, s) pair index q * S + s: a stable
    argsort over it is a radix sort."""
    return np.int16 if num_shards * num_shards <= np.iinfo(np.int16).max else np.int64


def pair_dst_lists(
    src: np.ndarray,
    dst: np.ndarray,
    num_shards: int,
    shard_size: int,
    owner_range: Optional[Tuple[int, int]] = None,
) -> Dict[Tuple[int, int], np.ndarray]:
    """{(q, s): sorted distinct global dst ids} for every cross-shard pair
    with at least one edge, in (q, s) order. ``owner_range`` restricts to
    owners q in [lo, hi) — the distributed-loading case where this host
    only scanned the storage partitions backing those source shards. One
    grouping of the cross edges by pair (the reference makes one pass per
    pair): the same lists."""
    S = num_shards
    owner = src // shard_size
    dshard = dst // shard_size
    lo, hi = owner_range if owner_range is not None else (0, S)
    keep = (owner != dshard) & (owner >= lo) & (owner < hi)
    pair = (owner[keep] * S + dshard[keep]).astype(_pair_index_dtype(S))
    d = dst[keep]
    if len(d) > 1 and np.any(d[1:] < d[:-1]):
        order = np.lexsort((d, pair))
    else:
        # dst-sorted edges stay sorted within each pair's group
        order = np.argsort(pair, kind="stable")
    pair, d = pair[order], d[order]
    first = np.ones(len(d), dtype=bool)
    first[1:] = (pair[1:] != pair[:-1]) | (d[1:] != d[:-1])
    pair, d = pair[first], d[first]
    cuts = np.searchsorted(pair, np.arange(S * S + 1))
    return {
        (int(p) // S, int(p) % S): d[cuts[p] : cuts[p + 1]]
        for p in np.nonzero(np.diff(cuts))[0]
    }


def halo_tier(
    lists: Dict[Tuple[int, int], np.ndarray], floor: int = 1
) -> int:
    """Pow2-tiered bin capacity: the smallest power of two covering the
    widest per-pair distinct-destination list. One tier serves the whole
    mesh (all_to_all needs uniform splits), and pow2 tiers mean a halo
    that grows within its tier keeps every buffer shape (and captured CUDA
    graph) it had."""
    widest = max((len(u) for u in lists.values()), default=0)
    return _next_pow2(max(int(floor), widest, 1))


def pair_widths(
    src: np.ndarray, dst: np.ndarray, num_shards: int, shard_size: int
) -> Dict[str, int]:
    """Cheap comparative exchange stats for the autotuner: the eager
    boundary width B (max distinct cross-shard SOURCES any pair ships) vs
    the blocked halo width (max distinct cross-shard DESTINATIONS any
    pair merges into)."""
    owner = src // shard_size
    dshard = dst // shard_size
    cross = owner != dshard
    b_src = 0
    b_dst = 0
    if cross.any():
        pair = owner[cross] * num_shards + dshard[cross]
        n = int(max(src.max(initial=0), dst.max(initial=0))) + 1
        b_src = int(np.bincount(
            np.unique(pair * n + src[cross]) // n
        ).max())
        b_dst = int(np.bincount(
            np.unique(pair * n + dst[cross]) // n
        ).max())
    return {
        "boundary_width": max(1, b_src),
        "halo_width": max(1, b_dst),
        "halo_cap": _next_pow2(max(1, b_dst)),
        "cross_edges": int(cross.sum()),
    }


class BlockedPlan:
    """Host-side propagation-blocked exchange plan, ready for device
    placement (every array's leading dim is divisible by S).

    Arrays (Eq = max out-edges any shard owns, Hc = halo_cap, the pow2
    bin tier; T = Np + S*Hc segments per shard plus one trailing dead
    slot):

      blk_src_loc (S*Eq,)       int32  edge source, LOCAL to its owner
      blk_seg     (S*Eq,)       int32  full segment map: local dst
                                        [0, Np), outgoing bin slot
                                        [Np, Np+S*Hc), dead (padding)
      blk_bin_seg (S*Eq,)       int32  bins-only map for the frontier
                                        engine: [0, S*Hc) or dead S*Hc
                                        (local edges excluded — they stay
                                        for compacted expansion)
      blk_valid   (S*Eq,)       f32
      blk_weight  (S*Eq,)       f32
      recv_dst    (S*(S*Hc),)   int32  received bin slot -> local dst,
                                        pad -> Np (dead)
    """

    def __init__(
        self,
        num_shards: int,
        shard_size: int,
        halo_cap: int,
        edges_per_owner: int,
        owner_lo: int = 0,
        owner_hi: Optional[int] = None,
    ):
        S = num_shards
        self.num_shards = S
        self.shard_size = shard_size
        self.halo_cap = halo_cap
        self.edges_per_owner = edges_per_owner
        self.owner_lo = owner_lo
        self.owner_hi = S if owner_hi is None else owner_hi
        rows = self.owner_hi - self.owner_lo
        Eq, Hc, Np = edges_per_owner, halo_cap, shard_size
        self.blk_src_loc = np.zeros(rows * Eq, dtype=np.int32)
        # padded slots land in the trailing dead segment so a padded edge
        # can never leak into a bin or a local vertex
        self.blk_seg = np.full(rows * Eq, Np + S * Hc, dtype=np.int32)
        self.blk_bin_seg = np.full(rows * Eq, S * Hc, dtype=np.int32)
        self.blk_valid = np.zeros(rows * Eq, dtype=np.float32)
        self.blk_weight = np.ones(rows * Eq, dtype=np.float32)
        self.recv_dst = np.full(rows * (S * Hc), Np, dtype=np.int32)
        #: per-owner real (unpadded) edge counts, local/remote split — the
        #: per-shard cost inputs for the skew report and measured walls
        self.edges_by_owner = [0] * rows
        self.local_edges_by_owner = [0] * rows
        self.bins_used_by_owner = [0] * rows

    # ------------------------------------------------------------ the plans
    @classmethod
    def build(
        cls,
        src: np.ndarray,
        dst: np.ndarray,
        w: np.ndarray,
        num_shards: int,
        shard_size: int,
        halo_cap: Optional[int] = None,
        edges_per_owner: Optional[int] = None,
    ) -> "BlockedPlan":
        """Single-process build over the full edge multiset."""
        lists = pair_dst_lists(src, dst, num_shards, shard_size)
        if halo_cap is None:
            halo_cap = halo_tier(lists)
        owner = src // shard_size
        counts = np.bincount(owner, minlength=num_shards)
        if edges_per_owner is None:
            edges_per_owner = max(1, int(counts.max()) if len(counts) else 1)
        plan = cls(num_shards, shard_size, halo_cap, edges_per_owner)
        plan.fill_owners(src, dst, w, lists, (0, num_shards))
        plan.fill_recv(lists, (0, num_shards))
        plan.pair_lists = lists
        return plan

    @classmethod
    def build_local(
        cls,
        src: np.ndarray,
        dst: np.ndarray,
        w: np.ndarray,
        num_shards: int,
        shard_size: int,
        shard_range: Tuple[int, int],
        halo_cap: int,
        edges_per_owner: int,
        all_pair_lists: Dict[Tuple[int, int], np.ndarray],
    ) -> "BlockedPlan":
        """Distributed build: this host holds ONLY the edges whose source
        shard falls in ``shard_range`` (the storage partitions it
        scanned), plus the exchanged metadata — the global pow2 bin tier,
        the global per-owner edge ceiling, and every pair's compact
        distinct-destination list (``all_pair_lists``, the halo index:
        at most S*S*Hc vertex ids, NOT the O(E) edge set)."""
        plan = cls(
            num_shards, shard_size, halo_cap, edges_per_owner,
            owner_lo=shard_range[0], owner_hi=shard_range[1],
        )
        plan.fill_owners(src, dst, w, all_pair_lists, shard_range)
        plan.fill_recv(all_pair_lists, shard_range)
        plan.pair_lists = all_pair_lists
        return plan

    def fill_owners(self, src, dst, w, lists, owner_range) -> None:
        S, Np, Eq, Hc = (
            self.num_shards, self.shard_size, self.edges_per_owner,
            self.halo_cap,
        )
        owner = src // Np
        dshard = dst // Np
        lo = owner_range[0]
        for q in range(*owner_range):
            m = np.nonzero(owner == q)[0]  # keeps dst-sorted order
            k = len(m)
            row = q - lo
            base = row * Eq
            self.edges_by_owner[row] = k
            if not k:
                continue
            qsrc, qdst, qds = src[m], dst[m], dshard[m]
            self.blk_src_loc[base : base + k] = (qsrc - q * Np).astype(
                np.int32
            )
            self.blk_valid[base : base + k] = 1.0
            self.blk_weight[base : base + k] = w[m]
            seg = np.empty(k, dtype=np.int64)
            bin_seg = np.full(k, S * Hc, dtype=np.int64)
            local = qds == q
            seg[local] = qdst[local] - q * Np
            self.local_edges_by_owner[row] = int(local.sum())
            used = 0
            for s in range(S):
                if s == q:
                    continue
                mm = qds == s
                if not mm.any():
                    continue
                u = lists[(q, s)]
                j = np.searchsorted(u, qdst[mm])
                seg[mm] = Np + s * Hc + j
                bin_seg[mm] = s * Hc + j
                used += len(u)
            self.bins_used_by_owner[row] = used
            self.blk_seg[base : base + k] = seg.astype(np.int32)
            self.blk_bin_seg[base : base + k] = bin_seg.astype(np.int32)

    def fill_recv(self, lists, shard_range) -> None:
        S, Np, Hc = self.num_shards, self.shard_size, self.halo_cap
        lo = shard_range[0]
        for s in range(*shard_range):
            base = (s - lo) * (S * Hc)
            for q in range(S):
                u = lists.get((q, s))
                if u is None:
                    continue
                self.recv_dst[base + q * Hc : base + q * Hc + len(u)] = (
                    u - s * Np
                ).astype(np.int32)

    # ------------------------------------------------------------- reporting
    def comm_stats(self) -> Dict[str, object]:
        S, Hc = self.num_shards, self.halo_cap
        used = sum(self.bins_used_by_owner)
        return {
            "halo_cap": Hc,
            "blocked_elems": S * Hc,
            "bin_fill": round(used / max(1, (self.owner_hi - self.owner_lo) * S * Hc), 4),
            "edges_per_owner": list(self.edges_by_owner),
        }


# ---------------------------------------------------------------------------
# packed (ELL/tree) aggregation for the blocked exchange

_BLOCKED_ELL_MAX_CAP = 1 << 14


def build_ell(plan: BlockedPlan, has_weight: bool) -> None:
    """Attach the packed aggregation structures to a (full) BlockedPlan:

    Sender side — a uniform degree-bucketed ELL over the fused segment
    space [local destinations ++ outgoing bins]: gather + fixed
    adjacent-pair tree reduction (olap/kernels.tree_reduce) instead of a
    scatter-add, indexing the shard's OWN Np-row outgoing block (plus one
    identity pad row) — no message-table concat, cache-resident. Bucket
    row counts are padded uniform across shards (SPMD); oversized
    segments row-split through kernels.split_rows exactly like the eager
    pack.

      ell_buckets    [(idx (S*N_r, c)[, w, valid][, rowseg])...]
      ell_meta       [None | n_slots] per bucket (split fold width)
      ell_unpermute  (S*(Np+S*Hc),) int32 — position of each segment in
                     the stacked bucket output (+1 appended identity row
                     for empty segments)
      ell_out_len    stacked rows per shard (dead slot = this index)

    Receiver side — a width-R (pow2) combine row per local vertex over
    [received bins (S*Hc) ++ local partials (Np) ++ identity pad]: the
    local partial first, then contributing peers in ascending shard
    order, reduced through the same tree.

      recv_idx       (S*Np, R) int32
      recv_width     R
    """
    S, Np, Eq, Hc = (
        plan.num_shards, plan.shard_size, plan.edges_per_owner,
        plan.halo_cap,
    )
    assert plan.owner_lo == 0 and plan.owner_hi == S
    T = Np + S * Hc

    deg = np.zeros((S, T), dtype=np.int64)
    orders = []
    starts_all = []
    for q in range(S):
        base = q * Eq
        k = plan.edges_by_owner[q]
        seg = plan.blk_seg[base : base + k].astype(np.int64)
        order = np.argsort(seg, kind="stable")
        d = np.bincount(seg, minlength=T)[:T]
        deg[q] = d
        ip = np.zeros(T + 1, dtype=np.int64)
        np.cumsum(d, out=ip[1:])
        orders.append(order)
        starts_all.append(ip)

    caps = np.maximum(
        1, 1 << np.ceil(np.log2(np.maximum(deg, 1))).astype(np.int64)
    )
    caps = np.minimum(caps, _BLOCKED_ELL_MAX_CAP)
    # empty segments join no bucket; their unpermute slot reads the
    # appended identity row
    caps[deg == 0] = 0

    cap_set = sorted(
        c for c in set(int(x) for x in np.unique(caps)) if c > 0
    )
    buckets: List[Tuple] = []
    meta: List[Optional[int]] = []
    unpermute: Optional[np.ndarray] = None
    out_off = 0
    rows_total = 0
    for c in cap_set:
        members_per_shard = [np.nonzero(caps[q] == c)[0] for q in range(S)]
        split = c == _BLOCKED_ELL_MAX_CAP and any(
            len(m) and int(deg[q][m].max()) > c
            for q, m in enumerate(members_per_shard)
        )
        shard_rows = []
        for q in range(S):
            m = members_per_shard[q]
            st = starts_all[q][m]
            if split:
                shard_rows.append(split_rows(m, deg[q][m], st, c))
            else:
                shard_rows.append(
                    (st, deg[q][m], np.arange(len(m), dtype=np.int64))
                )
        N_rows = max(len(r[0]) for r in shard_rows)
        N_slots = max(len(m) for m in members_per_shard)
        if N_rows == 0:
            continue
        idx = np.full((S * N_rows, c), Np, dtype=np.int32)  # sentinel pad row
        if has_weight:
            wmat = np.zeros((S * N_rows, c), dtype=np.float32)
            valid = np.zeros((S * N_rows, c), dtype=np.float32)
        else:
            wmat = valid = None
        rowseg = np.full(S * N_rows, N_slots, dtype=np.int32)
        for q in range(S):
            members = members_per_shard[q]
            starts_r, degs_r, rseg = shard_rows[q]
            rows = len(starts_r)
            if rows == 0:
                continue
            base = q * Eq
            order = orders[q]
            total = int(degs_r.sum())
            if total:
                row_ids = np.repeat(np.arange(rows), degs_r)
                col_ids = np.arange(total) - np.repeat(
                    np.cumsum(degs_r) - degs_r, degs_r
                )
                epos = order[np.repeat(starts_r, degs_r) + col_ids]
                bidx = idx[q * N_rows : q * N_rows + rows]
                bidx[row_ids, col_ids] = plan.blk_src_loc[base + epos]
                if valid is not None:
                    valid[q * N_rows : q * N_rows + rows][
                        row_ids, col_ids
                    ] = 1.0
                if wmat is not None:
                    wmat[q * N_rows : q * N_rows + rows][
                        row_ids, col_ids
                    ] = plan.blk_weight[base + epos]
            rowseg[q * N_rows : q * N_rows + rows] = rseg.astype(np.int32)
            if unpermute is None:
                unpermute = np.zeros(S * T, dtype=np.int64)
            unpermute[q * T + members] = out_off + np.arange(len(members))
        if split:
            buckets.append((idx, wmat, valid, rowseg))
            meta.append(N_slots)
            out_off += N_slots
        else:
            buckets.append((idx, wmat, valid))
            meta.append(None)
            out_off += N_rows
        rows_total += N_rows
    if unpermute is None:
        unpermute = np.zeros(S * T, dtype=np.int64)
    # empty segments -> the appended identity row
    for q in range(S):
        empty = np.nonzero(deg[q] == 0)[0]
        unpermute[q * T + empty] = out_off
    plan.ell_buckets = buckets
    plan.ell_meta = meta
    plan.ell_unpermute = unpermute.astype(np.int32)
    plan.ell_out_len = out_off

    # receiver combine rows: local partial first, then the contributing
    # peers in ascending shard order (a destination appears at most once
    # in each (q, s) list, so (q, j) pairs sort by q alone)
    sentinel = S * Hc + Np
    keys = sorted(plan.pair_lists)
    if keys:
        vs = np.concatenate([plan.pair_lists[k] for k in keys]).astype(np.int64)
        qs = np.concatenate([
            np.full(len(plan.pair_lists[k]), k[0], dtype=np.int64) for k in keys
        ])
        js = np.concatenate([
            np.arange(len(plan.pair_lists[k]), dtype=np.int64) for k in keys
        ])
        order = np.lexsort((qs, vs))
        vs, qs, js = vs[order], qs[order], js[order]
        first = np.ones(len(vs), dtype=bool)
        first[1:] = vs[1:] != vs[:-1]
        starts = np.nonzero(first)[0]
        rank = np.arange(len(vs)) - np.repeat(starts, np.diff(np.append(starts, len(vs))))
        width = 1 + int(rank.max()) + 1
    else:
        vs = qs = js = rank = np.zeros(0, dtype=np.int64)
        width = 1
    R = _next_pow2(width)
    recv_idx = np.full((S * Np, R), sentinel, dtype=np.int32)
    recv_idx[:, 0] = S * Hc + (np.arange(S * Np) % Np)  # own local partial
    recv_idx[vs, 1 + rank] = (qs * Hc + js).astype(np.int32)
    plan.recv_idx = recv_idx
    plan.recv_width = R


# ---------------------------------------------------------------------------
# numpy replay oracle + measured-wall probe


def _seg_reduce_np(op: str, data, seg, n: int):
    tail = data.shape[1:]
    if op == Combiner.SUM:
        acc = np.zeros((n,) + tail, dtype=data.dtype)
        np.add.at(acc, seg, data)
    elif op == Combiner.MIN:
        acc = np.full((n,) + tail, np.inf, dtype=data.dtype)
        np.minimum.at(acc, seg, data)
    else:
        acc = np.full((n,) + tail, -np.inf, dtype=data.dtype)
        np.maximum.at(acc, seg, data)
    return acc


def replay_superstep(
    plan: BlockedPlan,
    outgoing: np.ndarray,
    op: str,
    edge_transform=None,
    transform_cols=None,
    has_weight: bool = False,
    agg: str = "segment",
) -> np.ndarray:
    """The numpy twin of the device blocked superstep: same gathers, same
    per-shard reductions in the same edge order (segment scatter OR the
    packed gather + adjacent-pair tree), the same bin transpose standing
    in for the all_to_all, the same final combine — np.add.at adds in
    index order as torch's CPU index_add_ does, and the packed form runs
    the executor's tree, which makes this the blocked path's CPU oracle
    for BOTH aggregation formats."""
    S, Np, Eq, Hc = (
        plan.num_shards, plan.shard_size, plan.edges_per_owner,
        plan.halo_cap,
    )
    assert plan.owner_lo == 0 and plan.owner_hi == S, (
        "replay needs the full plan"
    )
    identity = np.float32(Combiner.IDENTITY[op])
    tail = outgoing.shape[1:]
    out = np.empty_like(outgoing)
    bins = np.empty((S, S * Hc) + tail, dtype=outgoing.dtype)
    local_parts = np.empty((S, Np) + tail, dtype=outgoing.dtype)
    nseg = Np + S * Hc + 1
    if agg == "ell":
        if not hasattr(plan, "ell_buckets"):
            build_ell(plan, has_weight)
        pad_row = np.full((1,) + tail, identity, dtype=outgoing.dtype)
        for q in range(S):
            out_ext = np.concatenate(
                [outgoing[q * Np : (q + 1) * Np], pad_row], axis=0
            )
            parts = []
            for bucket, n_slots in zip(plan.ell_buckets, plan.ell_meta):
                idx, wm, va = bucket[0], bucket[1], bucket[2]
                rows = idx.shape[0] // S
                bi = idx[q * rows : (q + 1) * rows]
                m = np_flat_take(out_ext, bi)
                if wm is not None:
                    bw = wm[q * rows : (q + 1) * rows]
                    bv = va[q * rows : (q + 1) * rows]
                    m = np_edge_transform(m, bw, edge_transform, transform_cols)
                    bv_ = bv.reshape(bv.shape + (1,) * (m.ndim - 2))
                    m = np.where(bv_ > 0, m, identity).astype(
                        outgoing.dtype
                    )
                    m = np_fence(m)
                r = np_tree_reduce(m, op)
                if n_slots is not None:
                    rs = bucket[3][q * rows : (q + 1) * rows]
                    r = _seg_reduce_np(op, r, rs, n_slots + 1)[:n_slots]
                parts.append(r)
            stacked = np.concatenate(parts + [pad_row], axis=0)
            T = Np + S * Hc
            tab = stacked[plan.ell_unpermute[q * T : (q + 1) * T]]
            local_parts[q] = tab[:Np]
            bins[q] = tab[Np:]
    else:
        for q in range(S):
            base = q * Eq
            msgs = outgoing[q * Np + plan.blk_src_loc[base : base + Eq]]
            wq = plan.blk_weight[base : base + Eq] if has_weight else None
            msgs = np_edge_transform(msgs, wq, edge_transform, transform_cols)
            valid = plan.blk_valid[base : base + Eq]
            vmask = valid.reshape((-1,) + (1,) * (msgs.ndim - 1))
            msgs = np.where(vmask > 0, msgs, identity).astype(outgoing.dtype)
            # mirror the device kernel's fp-contraction fence (+0.0, which
            # also normalizes -0.0 the same way on both sides)
            msgs = np_fence(msgs)
            acc = _seg_reduce_np(
                op, msgs, plan.blk_seg[base : base + Eq], nseg
            )
            local_parts[q] = acc[:Np]
            bins[q] = acc[Np : Np + S * Hc]
    # all_to_all: shard s receives bins[q].reshape(S, Hc)[s] from each q
    binsq = bins.reshape((S, S, Hc) + tail)
    for s in range(S):
        recv = np.ascontiguousarray(binsq[:, s]).reshape((S * Hc,) + tail)
        if agg == "ell":
            pad_row = np.full((1,) + tail, identity, dtype=outgoing.dtype)
            rtab = np.concatenate([recv, local_parts[s], pad_row], axis=0)
            ri = plan.recv_idx[s * Np : (s + 1) * Np]
            out[s * Np : (s + 1) * Np] = np_tree_reduce(np_flat_take(rtab, ri), op)
            continue
        rbase = s * (S * Hc)
        remote = _seg_reduce_np(
            op, recv, plan.recv_dst[rbase : rbase + S * Hc], Np + 1
        )[:Np]
        if op == Combiner.SUM:
            out[s * Np : (s + 1) * Np] = local_parts[s] + remote
        elif op == Combiner.MIN:
            out[s * Np : (s + 1) * Np] = np.minimum(local_parts[s], remote)
        else:
            out[s * Np : (s + 1) * Np] = np.maximum(local_parts[s], remote)
    return out


def measure_shard_walls(
    plan: BlockedPlan, repeats: int = 3
) -> List[float]:
    """MEASURED per-shard superstep walls (milliseconds): time each
    shard's real aggregation workload — the gather over its out-edges
    plus the local/bin segment reduction over its real edge count — on
    the host, taking the minimum over ``repeats`` (least scheduler
    noise). The SPMD barrier hides per-shard walls inside one dispatch;
    this probe runs the identical per-shard arithmetic shard-by-shard, so
    the skew report prices each shard from a measurement instead of the
    plan-derived share (cost_source="measured")."""
    S, Np, Eq, Hc = (
        plan.num_shards, plan.shard_size, plan.edges_per_owner,
        plan.halo_cap,
    )
    vals = (
        np.arange(plan.shard_size, dtype=np.float32) % 97 + 1.0
    )
    nseg = Np + S * Hc + 1
    walls: List[float] = []
    for row in range(plan.owner_hi - plan.owner_lo):
        base = row * Eq
        k = max(1, plan.edges_by_owner[row])
        src = plan.blk_src_loc[base : base + k]
        seg = plan.blk_seg[base : base + k]
        w = plan.blk_weight[base : base + k]
        best = float("inf")
        for _ in range(max(1, repeats)):
            t0 = time.perf_counter()
            msgs = vals[src] * w
            acc = np.zeros(nseg, dtype=np.float32)
            np.add.at(acc, seg, msgs)
            best = min(best, time.perf_counter() - t0)
        walls.append(best * 1000.0)
    return walls
