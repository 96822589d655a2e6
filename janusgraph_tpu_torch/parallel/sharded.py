"""Sharded BSP executor over a device mesh — the port of
``janusgraph_tpu/parallel/sharded.py``.

The reference runs one controller over a ``jax.sharding.Mesh`` through
``shard_map``. Here a ``parallel/compat.Mesh`` holds S slots, each a torch
device; slots may share a device (8 shards on one card, or on the CPU in
the tests):

  - vertex state and in-edge blocks are sharded by contiguous vertex-index
    blocks; every shard is padded to one shape (vertices to S*Np, edges to
    the largest shard's count with masked no-op entries), so the shards
    that share a device keep every array stacked on a leading axis and one
    launch serves them all. Gathers index into their own shard's block
    through offsets added when the arrays are placed;
  - each superstep exchanges boundary messages only: "a2a" swaps the
    boundary-source buckets (S*B elements a shard), "blocked" the
    destination-binned, combiner-merged halo bins (S*Hc), "ring" streams
    one Np block per hop (S-1 hops), "gather" the whole padded vector;
  - local aggregation is the uniform degree-bucketed ELL (gather + the
    fixed adjacent-pair tree of ``olap/kernels.py``, every monoid, the same
    bits on every device) or a flat segment reduction (``index_add_`` /
    ``scatter_reduce_``: SUM through float atomics on the card);
  - global aggregators reduce at the superstep barrier: each shard's apply
    emits its metrics, and the mesh's sum/min/max folds them (psum/pmin/
    pmax).

The superstep body is written once per group of slots that share a device
(``compat.lockstep``); the groups meet only in the collectives. On a mesh
that spans processes (``multihost.global_mesh``) every process builds the
same global plans, places and runs only its own groups, and meets the
others in the mesh's collectives over the process group; every process
returns the same global arrays (``_fetch``, the reference's
``process_allgather``). A program's
``message`` runs once over a group's stacked rows (it is row-wise, so one
call equals the per-shard calls); ``apply`` runs once per shard on its own
rows and view, so every metric is a per-shard partial before the barrier,
as in the reference.

Paths: "host-loop"; "fused" (on one card of one process: CUDA-graph
replay of predicated chunks of the whole S-shard superstep, as
``GPUExecutor``'s fused loop; elsewhere, and always on a mesh that spans
processes, whose collectives go through the host, the same chunks run
eagerly); "frontier" (ShortestPath and CC
through ``parallel/sharded_frontier.py``). Checkpoints (single file or the
per-shard format of ``olap/sharded_checkpoint.py``), the fault hook
(``FaultPlan.sharded_hook``: shard preemption, collective timeout, halo
drop, straggler skew) and the resume follow the reference.

No kernel written by hand runs here: the exchanges are copies, transposes
and rolls, and the aggregations the plain torch ops of ``olap/kernels.py``.
"""

from __future__ import annotations

import gc
import inspect
import os
import time
import weakref
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from janusgraph_tpu_torch.exceptions import SuperstepPreempted
from janusgraph_tpu_torch.observability import flight_recorder, profiler, registry, tracer
from janusgraph_tpu_torch.olap import kernels
from janusgraph_tpu_torch.olap.csr import CSRGraph
from janusgraph_tpu_torch.olap.vertex_program import (
    Combiner,
    EdgeTransform,
    Memory,
    VertexProgram,
    apply_edge_transform,
    check_weighted_transforms,
)
from janusgraph_tpu_torch.parallel import halo
from janusgraph_tpu_torch.parallel.compat import Mesh, lockstep

_ELL_MAX_CAPACITY = 1 << 14

#: modeled per-shard skew (slowest/mean) above which the run leaves a
#: ``shard_skew`` event on the flight-recorder timeline even without an
#: injected straggler
SKEW_FLIGHT_THRESHOLD = 2.0

EXCHANGES = ("a2a", "ring", "gather", "blocked", "auto")


class ShardedCSR:
    """Host-side sharded/padded representation, ready for device placement.

    Arrays with leading dim S*Np (vertex-sharded) or S*Em (edge-sharded):
      out_degree   (S*Np,) float32
      active       (S*Np,) float32
      in_src_glob  (S*Em,) int32  — global (padded) source vertex index
      in_dst_loc   (S*Em,) int32  — destination index local to its shard
      in_valid     (S*Em,) float32
      in_weight    (S*Em,) float32 (all ones if unweighted)

    Boundary-exchange plan (the all-to-all schedule):
      boundary_width B — max distinct cross-shard sources any (q→s) pair needs
      send_idx     (S*S, B) int32 — row q*S+s: indices LOCAL TO q of the
                   sources q must send to s (padded with 0; padded slots are
                   transmitted but never referenced by any receiver)
      in_src_tab   (S*Em,) int32 — per-edge index into the superstep message
                   table [own outgoing (Np) ++ received buckets (S*B)]

    Uniform ELL pack (SPMD-identical bucket shapes across shards):
      ell_buckets  list of (idx (S*N_c, c) int32, w (S*N_c, c) f32,
                   valid (S*N_c, c) f32); idx indexes the message table,
                   sentinel = Np + S*B
      ell_unpermute (S*Np,) int32 — position of each local vertex in the
                   concatenated bucket output (local length sum_c N_c)
    """

    def __init__(
        self,
        csr: CSRGraph,
        num_shards: int,
        undirected: bool,
        edges: Optional[Tuple] = None,
    ):
        n = csr.num_vertices
        S = num_shards
        Np = -(-max(n, 1) // S)  # ceil
        self.csr = csr
        self.num_shards = S
        self.shard_size = Np
        self.padded_n = S * Np
        self.real_n = n

        if edges is not None:
            # pre-filtered edge view (EdgeChannel): messages flow src -> dst
            src, dst, w = edges
            src = np.asarray(src, dtype=np.int64)
            dst = np.asarray(dst, dtype=np.int64)
            self.has_weight = w is not None
            w = (
                np.asarray(w, dtype=np.float32)
                if w is not None
                else np.ones(len(src), dtype=np.float32)
            )
        else:
            src = csr.in_src.astype(np.int64)
            dst = np.repeat(
                np.arange(n, dtype=np.int64), np.diff(csr.in_indptr)
            )
            self.has_weight = csr.in_edge_weight is not None
            w = (
                csr.in_edge_weight.astype(np.float32)
                if csr.in_edge_weight is not None
                else np.ones(len(src), dtype=np.float32)
            )
            if undirected:
                # symmetric closure: aggregate both orientations in one pass
                src, dst = np.concatenate([src, dst]), np.concatenate([dst, src])
                w = np.concatenate([w, w])

        # sorting by dst groups edges by owning shard (shard = dst // Np is
        # monotone in dst) AND keeps each shard's edges dst-sorted, which the
        # ELL fill below requires
        order = np.argsort(dst, kind="stable")
        src, dst, w = src[order], dst[order], w[order]
        shard_of = dst // Np
        counts = np.bincount(shard_of, minlength=S)
        Em = int(counts.max()) if len(counts) else 0
        Em = max(Em, 1)
        self.edges_per_shard = Em
        offsets = np.zeros(S + 1, dtype=np.int64)
        np.cumsum(counts, out=offsets[1:])

        in_src_glob = np.zeros(S * Em, dtype=np.int32)
        in_dst_loc = np.zeros(S * Em, dtype=np.int32)
        in_valid = np.zeros(S * Em, dtype=np.float32)
        in_weight = np.ones(S * Em, dtype=np.float32)
        for s in range(S):
            lo, hi = offsets[s], offsets[s + 1]
            k = hi - lo
            base = s * Em
            in_src_glob[base : base + k] = src[lo:hi]
            in_dst_loc[base : base + k] = dst[lo:hi] - s * Np
            in_valid[base : base + k] = 1.0
            in_weight[base : base + k] = w[lo:hi]

        out_degree = np.zeros(S * Np, dtype=np.float32)
        out_degree[:n] = csr.out_degree
        active = np.zeros(S * Np, dtype=np.float32)
        active[:n] = 1.0
        # padded per-vertex in-degree of THIS edge view (dense programs
        # normalize by it — GCNForwardProgram's mean aggregation)
        # (s * Np + the local destination is the global one: one count)
        in_degree = np.bincount(dst, minlength=S * Np).astype(np.float32)

        self.out_degree = out_degree
        self.active = active
        self.in_degree = in_degree
        self.in_src_glob = in_src_glob
        self.in_dst_loc = in_dst_loc
        self.in_valid = in_valid
        self.in_weight = in_weight

        # retained for the lazily-built exchange plan / ELL pack — each
        # executor configuration pays only for the structures it ships
        self._src_sorted = src
        self._offsets = offsets
        self._exchange_built = False
        self._ell_built = False
        #: the measured-wall probe's walls per layout ("blocked", "eager"),
        #: cached: the probe prices the layout, which runs do not change
        self.measured_walls: Dict[str, List[float]] = {}

    def ensure_exchange_plan(self) -> None:
        """Build the boundary all-to-all plan (send_idx / in_src_tab) once,
        on first use — the gather/segment debug path never pays for it."""
        if self._exchange_built:
            return
        self._exchange_built = True
        S, Np, Em = self.num_shards, self.shard_size, self.edges_per_shard
        src, offsets = self._src_sorted, self._offsets

        # distinct sources per (q → s) pair
        uniq: Dict[Tuple[int, int], np.ndarray] = {}
        inv_parts: List[Tuple[int, np.ndarray, int, np.ndarray]] = []
        B = 1
        for s in range(S):
            lo, hi = offsets[s], offsets[s + 1]
            ssrc = src[lo:hi]
            qof = ssrc // Np
            for q in range(S):
                if q == s:
                    continue
                m = np.nonzero(qof == q)[0]
                if len(m) == 0:
                    continue
                u, inv = np.unique(ssrc[m], return_inverse=True)
                uniq[(q, s)] = u
                inv_parts.append((s, m, q, inv))
                B = max(B, len(u))
        self.boundary_width = B

        send_idx = np.zeros((S * S, B), dtype=np.int32)
        for (q, s), u in uniq.items():
            send_idx[q * S + s, : len(u)] = u - q * Np
        self.send_idx = send_idx

        in_src_tab = np.zeros(S * Em, dtype=np.int32)
        for s in range(S):
            lo, hi = offsets[s], offsets[s + 1]
            k = hi - lo
            ssrc = src[lo:hi]
            local = (ssrc // Np) == s
            seg = in_src_tab[s * Em : s * Em + k]
            seg[local] = (ssrc[local] - s * Np).astype(np.int32)
        for s, m, q, inv in inv_parts:
            in_src_tab[s * Em + m] = (Np + q * B + inv).astype(np.int32)
        self.in_src_tab = in_src_tab
        self.msg_table_len = Np + S * B
        # per-superstep comm volume (elements/shard): a2a vs all_gather
        self.comm_a2a_elems = S * B
        self.comm_gather_elems = self.padded_n

    def ensure_ring(self) -> None:
        """Build the ring-exchange plan once: per shard, edge slots grouped
        by SOURCE OWNER into uniform blocks of Eo = max edges any (shard,
        owner) pair holds, so ring step t reduces exactly one owner's block
        (dynamic-slice by traced owner index) instead of masking the whole
        edge list every step. Arrays (leading dim S, per-shard layout
        owner-major):
          ring_src_loc (S*S*Eo,) int32 — source index LOCAL to the owner
          ring_dst_loc (S*S*Eo,) int32 — destination local to this shard
          ring_valid   (S*S*Eo,) f32
          ring_weight  (S*S*Eo,) f32
        """
        if getattr(self, "_ring_built", False):
            return
        self._ring_built = True
        S, Np, Em = self.num_shards, self.shard_size, self.edges_per_shard
        src, offsets = self._src_sorted, self._offsets

        counts = np.zeros((S, S), dtype=np.int64)
        per_shard = []
        for s in range(S):
            lo, hi = offsets[s], offsets[s + 1]
            ssrc = src[lo:hi]
            owner = (ssrc // Np).astype(np.int64)
            order = np.argsort(owner, kind="stable")
            per_shard.append((lo, order, owner[order]))
            counts[s] = np.bincount(owner, minlength=S)
        Eo = max(1, int(counts.max()))
        self.ring_block = Eo

        ring_src = np.zeros((S, S * Eo), dtype=np.int32)
        ring_dst = np.zeros((S, S * Eo), dtype=np.int32)
        ring_valid = np.zeros((S, S * Eo), dtype=np.float32)
        ring_weight = np.ones((S, S * Eo), dtype=np.float32)
        for s in range(S):
            lo, order, owner_sorted = per_shard[s]
            k = len(order)
            if not k:
                continue
            gsrc = src[lo + order]
            # position within each owner block
            block_start = np.concatenate(
                ([0], np.cumsum(np.bincount(owner_sorted, minlength=S)))
            )
            pos = np.arange(k) - block_start[owner_sorted]
            col = owner_sorted * Eo + pos
            ring_src[s, col] = (gsrc - owner_sorted * Np).astype(np.int32)
            ring_dst[s, col] = self.in_dst_loc[s * Em + order]
            ring_valid[s, col] = 1.0
            ring_weight[s, col] = self.in_weight[s * Em + order]
        self.ring_src_loc = ring_src.reshape(-1)
        self.ring_dst_loc = ring_dst.reshape(-1)
        self.ring_valid = ring_valid.reshape(-1)
        self.ring_weight = ring_weight.reshape(-1)

    def ensure_frontier_plan(self) -> None:
        """Build the frontier-compaction plan once: per shard, a CSC over
        MESSAGE-TABLE SLOTS (own Np ++ received S*B buckets) so a superstep
        can expand only the edges whose source slot is fresh, instead of
        gathering all Em local edges (the sharded analogue of
        olap/frontier.py's capped expansion). Arrays
        (leading dim divisible by S, device-shardable):
          ftr_ip        (S*(T+2),) int32 — per-shard CSC indptr over table
                        slots, +1 sentinel row (slot T reads degree 0 — the
                        compaction fill target)
          ftr_dst       (S*Em,) int32 — local destination, CSC order
          ftr_w         (S*Em,) f32  — edge weight, CSC order
          ftr_deg       (S*T,) int32 — edges per table slot (planning)
          ftr_src_glob  (S*T,) int32 — global source vertex index per slot
                        (predecessor tracking); bucket pad slots alias the
                        peer's vertex 0 but carry degree 0, so they can
                        never contribute a message
        Only VALID edges enter the CSC (the dense path's in_valid pad slots
        are excluded) — a padded-edge slot must not resurrect under slot-0.
        """
        if getattr(self, "_frontier_built", False):
            return
        self.ensure_exchange_plan()
        self._frontier_built = True
        S, Np, Em = self.num_shards, self.shard_size, self.edges_per_shard
        B, T = self.boundary_width, self.msg_table_len
        offsets = self._offsets

        ftr_ip = np.zeros(S * (T + 2), dtype=np.int32)
        ftr_dst = np.zeros(S * Em, dtype=np.int32)
        ftr_w = np.ones(S * Em, dtype=np.float32)
        ftr_deg = np.zeros(S * T, dtype=np.int32)
        ftr_src_glob = np.zeros(S * T, dtype=np.int32)
        for s in range(S):
            k = int(offsets[s + 1] - offsets[s])
            base = s * Em
            tabidx = self.in_src_tab[base : base + k]
            order = np.argsort(tabidx, kind="stable")
            deg = np.bincount(tabidx[order], minlength=T)
            ip = np.zeros(T + 2, dtype=np.int64)
            np.cumsum(deg, out=ip[1 : T + 1])
            ip[T + 1] = ip[T]
            ftr_ip[s * (T + 2) : (s + 1) * (T + 2)] = ip
            ftr_dst[base : base + k] = self.in_dst_loc[base : base + k][order]
            ftr_w[base : base + k] = self.in_weight[base : base + k][order]
            ftr_deg[s * T : s * T + T] = deg
            glob = np.zeros(T, dtype=np.int64)
            glob[:Np] = s * Np + np.arange(Np)
            for q in range(S):
                if q == s:
                    continue
                glob[Np + q * B : Np + (q + 1) * B] = (
                    q * Np + self.send_idx[q * S + s]
                )
            ftr_src_glob[s * T : s * T + T] = glob
        self.ftr_ip = ftr_ip
        self.ftr_dst = ftr_dst
        self.ftr_w = ftr_w
        self.ftr_deg = ftr_deg
        self.ftr_src_glob = ftr_src_glob

    def ensure_blocked_plan(self) -> None:
        """Build the propagation-blocked (source-partitioned) halo plan
        once, on first use (parallel/halo.py): per-owner edge blocks whose
        superstep kernel bins remote-bound messages by destination shard,
        merges them locally, and exchanges pow2-tiered bins in ONE
        all_to_all — the a2a boundary table is never materialized."""
        if getattr(self, "_blocked_built", False):
            return
        self._blocked_built = True
        src, dst, w = halo.edges_from_sharded(self)
        plan = halo.BlockedPlan.build(
            src, dst, w, self.num_shards, self.shard_size
        )
        self.blocked_plan = plan
        self.blk_src_loc = plan.blk_src_loc
        self._blocked_ell_built = False
        self.blk_seg = plan.blk_seg
        self.blk_bin_seg = plan.blk_bin_seg
        self.blk_valid = plan.blk_valid
        self.blk_weight = plan.blk_weight
        self.recv_dst = plan.recv_dst
        self.halo_cap = plan.halo_cap
        self.edges_per_owner = plan.edges_per_owner
        # per-superstep comm volume (elements/shard), blocked exchange
        self.comm_blocked_elems = self.num_shards * plan.halo_cap

    def ensure_frontier_plan_blocked(self) -> None:
        """Frontier CSC over the BLOCKED message table [own Np ++ received
        merged bins S*Hc]: local slots keep their intra-shard edges; each
        used (q→s, j) bin slot collapses that pair's remote edges into ONE
        edge to its destination (weight 0 — the sender already folded the
        edge weight into the merged MIN), so remote expansion work shrinks
        from per-edge to per-distinct-destination and each hop exchanges
        S*Hc merged elements instead of the S*B boundary table."""
        if getattr(self, "_frontier_blocked_built", False):
            return
        self.ensure_blocked_plan()
        self._frontier_blocked_built = True
        plan = self.blocked_plan
        S, Np, Hc = self.num_shards, self.shard_size, self.halo_cap
        T = Np + S * Hc
        src, dst, w = halo.edges_from_sharded(self)
        owner = src // Np
        dshard = dst // Np

        slot_parts: List[Tuple[np.ndarray, np.ndarray, np.ndarray]] = []
        E2 = 1
        for s in range(S):
            loc = np.nonzero((owner == s) & (dshard == s))[0]
            slots = [src[loc] - s * Np]
            dsts = [dst[loc] - s * Np]
            ws = [w[loc]]
            for q in range(S):
                u = plan.pair_lists.get((q, s))
                if u is None:
                    continue
                slots.append(Np + q * Hc + np.arange(len(u)))
                dsts.append(u - s * Np)
                ws.append(np.zeros(len(u), dtype=np.float32))
            sl = np.concatenate(slots).astype(np.int64)
            dl = np.concatenate(dsts).astype(np.int64)
            wl = np.concatenate(ws).astype(np.float32)
            order = np.argsort(sl, kind="stable")
            slot_parts.append((sl[order], dl[order], wl[order]))
            E2 = max(E2, len(sl))
        self.fblk_edges = E2
        ftr_ip = np.zeros(S * (T + 2), dtype=np.int32)
        ftr_dst = np.zeros(S * E2, dtype=np.int32)
        ftr_w = np.ones(S * E2, dtype=np.float32)
        ftr_deg = np.zeros(S * T, dtype=np.int32)
        for s in range(S):
            sl, dl, wl = slot_parts[s]
            k = len(sl)
            deg = np.bincount(sl, minlength=T)
            ip = np.zeros(T + 2, dtype=np.int64)
            np.cumsum(deg, out=ip[1 : T + 1])
            ip[T + 1] = ip[T]
            ftr_ip[s * (T + 2) : (s + 1) * (T + 2)] = ip
            ftr_dst[s * E2 : s * E2 + k] = dl
            ftr_w[s * E2 : s * E2 + k] = wl
            ftr_deg[s * T : s * T + T] = deg
        self.fblk_ip = ftr_ip
        self.fblk_dst = ftr_dst
        self.fblk_w = ftr_w
        self.fblk_deg = ftr_deg

    def ensure_blocked_ell(self) -> None:
        """Build the packed aggregation for the blocked exchange once:
        sender-side uniform ELL over [local destinations ++ outgoing
        bins] + the receiver's width-R combine rows (halo.build_ell) —
        gathers and adjacent-pair trees only, no scatter."""
        self.ensure_blocked_plan()
        if self._blocked_ell_built:
            return
        self._blocked_ell_built = True
        halo.build_ell(self.blocked_plan, self.has_weight)
        plan = self.blocked_plan
        self.bell_buckets = plan.ell_buckets
        self.bell_meta = plan.ell_meta
        self.bell_unpermute = plan.ell_unpermute
        self.bell_recv_idx = plan.recv_idx
        self.bell_recv_width = plan.recv_width

    def ensure_ell(self) -> None:
        """Build the uniform ELL pack once, on first use (requires the
        exchange plan: ELL indices point into the a2a message table)."""
        if self._ell_built:
            return
        self.ensure_exchange_plan()
        self._ell_built = True
        self._build_uniform_ell(self._offsets, self.edges_per_shard)

    def _build_uniform_ell(self, offsets: np.ndarray, Em: int) -> None:
        """Per-shard degree-bucketed ELL with bucket shapes made UNIFORM
        across shards (pad each capacity's row count to the max over shards)
        so the pack stacks over the mesh slots as plain arrays (one shape per
        shard)."""
        S, Np = self.num_shards, self.shard_size
        sentinel = self.msg_table_len

        deg = np.zeros((S, Np), dtype=np.int64)
        indptr = np.zeros((S, Np + 1), dtype=np.int64)
        for s in range(S):
            k = int(offsets[s + 1] - offsets[s])
            d = np.bincount(
                self.in_dst_loc[s * Em : s * Em + k].astype(np.int64),
                minlength=Np,
            )
            deg[s] = d
            np.cumsum(d, out=indptr[s, 1:])

        # capacity per vertex: next pow2 >= degree (min 1), clamped to the
        # max capacity — larger degrees row-split into ceil(d/cap) rows of
        # the top bucket, folded by a rows-sized segment reduce (supernodes:
        # avoids padding a jumbo bucket to the max degree)
        caps = np.maximum(
            1, 1 << np.ceil(np.log2(np.maximum(deg, 1))).astype(np.int64)
        )
        caps = np.minimum(caps, _ELL_MAX_CAPACITY)

        cap_set = sorted(set(int(c) for c in np.unique(caps)))
        self.ell_buckets: List[Tuple] = []
        # static per-bucket metadata: None (rows == slots) or the slot count
        # (+1 dead slot for padded rows) of a row-split bucket
        self.ell_meta: List[Optional[int]] = []
        unpermute = np.zeros(S * Np, dtype=np.int32)
        out_off = 0
        for c in cap_set:
            members_per_shard = [
                np.nonzero(caps[s] == c)[0] for s in range(S)
            ]
            split = c == _ELL_MAX_CAPACITY and any(
                len(m) and int(deg[s][m].max()) > c
                for s, m in enumerate(members_per_shard)
            )
            shard_rows = []
            for s in range(S):
                m = members_per_shard[s]
                if split:
                    shard_rows.append(
                        kernels.split_rows(m, deg[s][m], indptr[s][m], c)
                    )
                else:
                    shard_rows.append(
                        (indptr[s][m], deg[s][m],
                         np.arange(len(m), dtype=np.int64))
                    )
            N_rows = max(len(r[0]) for r in shard_rows)
            N_slots = max(len(m) for m in members_per_shard)
            if N_rows == 0:
                continue
            idx = np.full((S * N_rows, c), sentinel, dtype=np.int32)
            # unweighted: idx only — padded slots point at the message
            # table's identity pad slot (mirrors olap/kernels.py ELLPack)
            if self.has_weight:
                wmat = np.zeros((S * N_rows, c), dtype=np.float32)
                valid = np.zeros((S * N_rows, c), dtype=np.float32)
            else:
                wmat = valid = None
            # padded rows point at the dead slot (N_slots) and are dropped
            rowseg = np.full(S * N_rows, N_slots, dtype=np.int32)
            for s in range(S):
                members = members_per_shard[s]
                starts_r, degs_r, rseg = shard_rows[s]
                rows = len(starts_r)
                if rows == 0:
                    continue
                src32 = np.ascontiguousarray(
                    self.in_src_tab[s * Em : (s + 1) * Em], dtype=np.int32
                )
                w32 = np.ascontiguousarray(
                    self.in_weight[s * Em : (s + 1) * Em], dtype=np.float32
                )
                bidx = idx[s * N_rows : s * N_rows + rows]
                bw = (
                    wmat[s * N_rows : s * N_rows + rows]
                    if wmat is not None else None
                )
                bv = (
                    valid[s * N_rows : s * N_rows + rows]
                    if valid is not None else None
                )
                kernels.fill_ell_rows(starts_r, degs_r, src32, w32, bidx, bw, bv)
                rowseg[s * N_rows : s * N_rows + rows] = rseg.astype(np.int32)
                unpermute[s * Np + members] = (
                    out_off + np.arange(len(members))
                ).astype(np.int32)
            if split:
                self.ell_buckets.append((idx, wmat, valid, rowseg))
                self.ell_meta.append(N_slots)
                out_off += N_slots
            else:
                self.ell_buckets.append((idx, wmat, valid))
                self.ell_meta.append(None)
                out_off += N_rows
        self.ell_unpermute = unpermute
        self.ell_out_len = out_off



class _ShardView:
    """The graph view a program's hooks see: the whole padded domain
    (setup), one group's stacked rows (message) or one shard (apply)."""

    def __init__(self, num_vertices, local_num_vertices, global_offset, out_degree, active,
                 in_degree, device, num_edges):
        self.num_vertices = num_vertices              # real global count
        self.local_num_vertices = local_num_vertices  # rows of this view
        self.global_offset = global_offset
        self.out_degree = out_degree
        self.active = active
        self.in_degree = in_degree
        self.device = device
        self.num_edges = num_edges


def _fold_matrix(rowseg: np.ndarray, slots: int, rows: int, n_slots: int) -> np.ndarray:
    """The row-fold matrix of one split ELL bucket over ``slots`` stacked
    shards of ``rows`` rows each (``kernels.fold_rows``): output
    j*n_slots + v lists, in row order, the rows shard j's vertex-slot v
    folds; padded rows (rowseg == n_slots) fold nowhere. Pads point at the
    identity row fold_rows appends (index slots*rows)."""
    rs = np.asarray(rowseg, dtype=np.int64).reshape(slots, rows)
    ridx = np.arange(slots * rows, dtype=np.int64).reshape(slots, rows)
    keep = rs < n_slots
    seg = (rs + np.arange(slots, dtype=np.int64)[:, None] * n_slots)[keep]
    ridx = ridx[keep]
    counts = np.bincount(seg, minlength=slots * n_slots)
    kmax = int(counts.max()) if len(seg) else 0
    pos = np.arange(len(seg), dtype=np.int64) - np.repeat(np.cumsum(counts) - counts, counts)
    fold = np.full((slots * n_slots, kmax), slots * rows, dtype=np.int64)
    fold[seg, pos] = ridx
    return fold


def _combine(op: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    if op == Combiner.SUM:
        return a + b
    if op == Combiner.MIN:
        return torch.minimum(a, b)
    return torch.maximum(a, b)


def _mask(valid: torch.Tensor, msgs: torch.Tensor) -> torch.Tensor:
    return valid.reshape((-1,) + (1,) * (msgs.ndim - 1)) > 0


def captures_chunks(mesh: Mesh) -> bool:
    """Whether the fused loop captures its chunks into CUDA graphs: only
    on one card of one process. A mesh that spans processes exchanges
    through the host (gloo), which no graph may hold."""
    return (
        len(mesh.local_groups) == 1 and mesh.home.type == "cuda" and not mesh.spans_processes
    )


class _ShardedFusedLoop:
    """Static buffers (per group: state, aggregators, step counter and its
    bound) and CUDA graphs of one fused program over the mesh — the
    counterpart of ``gpu_executor._FusedLoop``. ``step()`` is one
    predicated superstep of every shard (the reference's while_loop
    ``cond``/``body`` inside ``shard_map``); a chunk is ``length`` steps and
    then ``finish()``. On one card of one process each chunk length is
    captured once into a CUDA graph (the exchanges are device copies, so
    the whole S-shard superstep captures) and replayed; a mesh over
    several devices or processes, or the CPU, runs the chunks eagerly: a
    collective between processes is never captured."""

    def __init__(self, executor: "ShardedExecutor", program: VertexProgram, op: str,
                 sc: "ShardedCSR", states, mems):
        mesh = executor.mesh
        self.ex = weakref.proxy(executor)
        self.program = program
        self.op = op
        self.sc = sc
        self.gargs = executor._graph_args(sc, program.undirected)
        self.views = executor._views(sc, program.undirected)
        self.state = [{k: v.clone() for k, v in st.items()} for st in states]
        self.mem = [{k: v.clone() for k, v in m.items()} for m in mems]
        self.steps = [torch.zeros((), dtype=torch.int64, device=g.device) for g in mesh.local_groups]
        self.limit = [torch.zeros((), dtype=torch.int64, device=g.device) for g in mesh.local_groups]
        self.status = torch.zeros(2, dtype=torch.int64, device=mesh.home)
        self.mem_ops: Dict[str, str] = {}
        self.graphs: Dict[int, torch.cuda.CUDAGraph] = {}
        self.captured_with = []
        one_card = captures_chunks(mesh)
        self.pool = torch.cuda.graph_pool_handle() if one_card else None
        #: how the chunks run: "captured" (CUDA-graph replay) or "eager"
        self.mode = "captured" if one_card else "eager"

    def set_bounds(self, steps_done: int = None, limit: int = None) -> None:
        for s, lim in zip(self.steps, self.limit):
            if steps_done is not None:
                s.fill_(steps_done)
            if limit is not None:
                lim.fill_(limit)

    def load(self, states, mems, steps_done: int, limit: int) -> bool:
        """Copy a run's starting point into the buffers; False where keys
        or shapes differ (the loop is then rebuilt)."""
        for bufs, st in zip(self.state, states):
            if set(st) != set(bufs):
                return False
            for k, buf in bufs.items():
                if st[k].shape != buf.shape or st[k].dtype != buf.dtype:
                    return False
        if not all(set(m) <= set(b) for m, b in zip(mems, self.mem)):
            return False
        for bufs, st in zip(self.state, states):
            for k, buf in bufs.items():
                buf.copy_(st[k])
        for bufs, m in zip(self.mem, mems):
            for k, buf in bufs.items():
                if k in m:
                    buf.copy_(m[k])
                else:
                    buf.fill_(Combiner.IDENTITY[self.mem_ops[k]])
        self.set_bounds(steps_done, limit)
        return True

    def step(self, discover: bool = False) -> None:
        program = self.program
        new_states, reduced, mops = self.ex._superstep(
            program, self.op, self.sc, self.gargs, self.views, self.state, self.steps, self.mem,
        )
        if discover:
            for k, o in mops.items():
                self.mem_ops[k] = o
                for bufs, s in zip(self.mem, self.steps):
                    if k not in bufs:
                        bufs[k] = torch.full(
                            (), Combiner.IDENTITY[o], dtype=torch.float32, device=s.device
                        )
        for gi, s in enumerate(self.steps):
            mem = self.mem[gi]
            # the predicate reads the buffers before this superstep's update
            run = (s < self.limit[gi]) & ((s == 0) | ~program.terminate_device(mem, s))
            updates = [
                (buf, torch.where(run, new_states[gi][k], buf))
                for k, buf in self.state[gi].items()
            ]
            updates += [
                (buf, torch.where(run, reduced[gi][k], buf))
                for k, buf in mem.items() if k in reduced[gi]
            ]
            for buf, new in updates:
                buf.copy_(new)
            s.add_(run.to(s.dtype))

    def finish(self) -> None:
        """status = (steps, whether the program has terminated)."""
        s = self.steps[0]
        stopped = (s > 0) & self.program.terminate_device(self.mem[0], s)
        self.status.copy_(torch.stack([s, stopped.to(torch.int64)]).to(self.status.device))

    def chunk(self, length: int, top: int) -> Tuple[float, tuple]:
        """Run one chunk; (seconds spent capturing, the chunk's marks)."""
        if self.pool is None:
            t0 = time.perf_counter()
            for _ in range(length):
                self.step()
            self.finish()
            return 0.0, (t0, time.perf_counter())
        capture_s = 0.0
        if length not in self.graphs:
            t0 = time.perf_counter()
            size = 1
            while size <= max(top, length):
                if size not in self.graphs:
                    self.graphs[size] = self._capture(size)
                size *= 2
            capture_s = time.perf_counter() - t0
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        self.graphs[length].replay()
        end.record()
        return capture_s, (start, end)

    def _capture(self, length: int) -> torch.cuda.CUDAGraph:
        """Capture ``length`` steps and the status, any hidden host sync
        raising; the cyclic collector is off meanwhile (see
        ``gpu_executor._FusedLoop._capture``)."""
        graph = torch.cuda.CUDAGraph()
        if not any(p is self.program for p in self.captured_with):
            self.captured_with.append(self.program)
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph, pool=self.pool):
                mode = torch.cuda.get_sync_debug_mode()
                torch.cuda.set_sync_debug_mode("error")
                try:
                    for _ in range(length):
                        self.step()
                    self.finish()
                finally:
                    torch.cuda.set_sync_debug_mode(mode)
        finally:
            if collecting:
                gc.enable()
        self.ex._captures += 1
        return graph


class ShardedExecutor:
    """BSP executor over a ``Mesh`` of S slots (default: one slot per
    visible card; ``Mesh([torch.device("cpu")] * 8)`` on the CPU).

    exchange: "blocked" — propagation-blocked halo exchange: remote-bound
              messages are binned by destination shard inside the
              superstep, combiner-merged locally, and the pow2-tiered
              merged bins swap in one all-to-all (S*halo_cap elements);
              "a2a" — boundary-bucket all-to-all of raw source values
              (S*B elements), the receiver aggregating its remote edges;
              "ring" — S-1 rolls of one shard block each, each folded in as
              it passes (peak exchange buffer one Np block);
              "gather" — the whole padded vector (debug/reference path);
              "auto" — ``olap/autotune.decide_sharded`` picks from the
              graph's boundary/halo widths and the device's peaks, keyed
              by shard count (``last_run_info["autotune"]``).
    agg:      "ell" — uniform degree-bucketed ELL (a2a and blocked);
              "segment" — flat segment reduction (ring/gather use this).
    """

    #: distinct EdgeChannel views kept on the device at once (LRU)
    CHANNEL_CACHE_SIZE = 8
    #: the longest fused chunk in supersteps (see GPUExecutor.MAX_CHUNK)
    MAX_CHUNK = 8
    #: skip the measured-wall probe past this many edges — the probe runs
    #: every shard's aggregation once on the host, which must stay a
    #: negligible fraction of the run it prices
    MEASURE_MAX_EDGES = 20_000_000

    def __init__(
        self,
        csr: CSRGraph,
        mesh=None,
        axis: str = "p",
        exchange: str = "a2a",
        agg: str = "ell",
        frontier_tier_growth: int = None,
        shard_measure: bool = None,
    ):
        if not isinstance(mesh, Mesh):
            mesh = Mesh(mesh, axis)
        self.mesh = mesh
        self.axis = mesh.axis
        self.num_shards = mesh.size
        self.csr = csr
        if exchange not in EXCHANGES:
            raise ValueError(f"unknown exchange {exchange!r}")
        if agg not in ("ell", "segment"):
            raise ValueError(f"unknown agg {agg!r}")
        if exchange in ("gather", "ring") and agg == "ell":
            # the ELL pack indexes the a2a message table, which the other
            # exchanges never build — refuse rather than silently rewiring
            raise ValueError(
                "agg='ell' requires exchange='a2a' (the ELL indices point "
                "into the all-to-all message table); use agg='segment' with "
                f"exchange={exchange!r}"
            )
        #: "auto" defers to olap/autotune.decide_sharded at first run
        self.exchange_requested = exchange
        self.exchange = exchange
        self.agg = agg
        #: measured per-shard superstep walls (host probe) feeding the
        #: skew report; None/True = on, False = plan-derived costs only
        self.shard_measure = True if shard_measure is None else bool(shard_measure)
        self._autotune_record = None
        self._measured_prior = None
        #: CUDA graphs captured this run (the port's compiles)
        self._captures = 0
        #: bytes moved to the devices this run
        self._h2d_bytes = 0
        #: the mesh's transport counters at the run's start
        self._transport0 = None
        self._sharded_cache: Dict[object, ShardedCSR] = {}
        self._channel_views: "OrderedDict" = OrderedDict()
        #: placed arrays and views per (kind, edge view, ...) key
        self._device_cache: Dict[Tuple, object] = {}
        #: (program.cache_key(), op) -> {metric: its combiner}, learned at
        #: the first superstep
        self._metric_ops: Dict[Tuple, Dict[str, str]] = {}
        self._fused_loops: Dict[Tuple, _ShardedFusedLoop] = {}
        self._frontier_engine = None
        self._frontier_tier_growth = frontier_tier_growth
        self._straggler_events: List[dict] = []
        self._ck_saves = 0
        self._resume_ms = 0.0
        self._resume_t_catch = None
        #: observability for the most recent run (path, frontier tiers,
        #: shards, exchange, autotune, ...), also registry.last_run("olap")
        self.last_run_info: Dict[str, object] = {}

    # ------------------------------------------------------------- planning
    def comm_stats(self, undirected: bool = False) -> Dict[str, object]:
        """Per-superstep exchange volume in elements per shard. Each plan
        is only built for executors configured to use it."""
        self._resolve_exchange(undirected)
        sc = self._sharded(undirected)
        stats: Dict[str, object] = {
            "gather_elems": sc.padded_n,
            # ring: S-1 hops x one Np block per superstep (the own block
            # folds locally), peak resident exchange buffer one Np block
            "ring_elems": (self.num_shards - 1) * sc.shard_size,
            "ring_peak_elems": sc.shard_size,
            "a2a_elems": None,
            "boundary_width": None,
            "blocked_elems": None,
            "halo_cap": None,
            #: collectives per superstep carrying message payload
            "batches": self.num_shards - 1 if self.exchange == "ring" else 1,
        }
        if self.exchange == "a2a":
            sc.ensure_exchange_plan()
            stats["a2a_elems"] = sc.comm_a2a_elems
            stats["boundary_width"] = sc.boundary_width
        if self.exchange == "blocked":
            sc.ensure_blocked_plan()
            stats["blocked_elems"] = sc.comm_blocked_elems
            stats["halo_cap"] = sc.halo_cap
        return stats

    def _exchange_info(self, sc: "ShardedCSR") -> Dict[str, object]:
        """run_info["exchange"]: what the configured exchange ships per
        superstep and per shard — elements, f32 payload bytes, and the
        number of message-carrying collectives (batches)."""
        S = self.num_shards
        if self.exchange == "blocked":
            sc.ensure_blocked_plan()
            elems, width = sc.comm_blocked_elems, sc.halo_cap
        elif self.exchange == "a2a":
            sc.ensure_exchange_plan()
            elems, width = sc.comm_a2a_elems, sc.boundary_width
        elif self.exchange == "ring":
            elems, width = (S - 1) * sc.shard_size, sc.shard_size
        else:
            elems, width = sc.padded_n, sc.padded_n
        return {
            "mode": self.exchange,
            "agg": self.agg,
            "elems_per_superstep": int(elems),
            "bytes_per_superstep": int(elems) * 4,
            "batches_per_superstep": S - 1 if self.exchange == "ring" else 1,
            "width": int(width),
        }

    def _device_kind(self) -> str:
        return self.mesh.kind

    def _resolve_exchange(self, undirected: bool = False) -> None:
        """Resolve exchange='auto' into a concrete (exchange, agg) pair via
        ``autotune.decide_sharded`` (pure in the graph, the device kind and
        the shard count); the decision is recorded."""
        if self.exchange_requested != "auto" or self._autotune_record:
            return
        from janusgraph_tpu_torch.olap import autotune

        sc = self._sharded(undirected)
        src, dst, _w = halo.edges_from_sharded(sc)
        widths = halo.pair_widths(src, dst, self.num_shards, sc.shard_size)
        stats = autotune.GraphStats.from_csr(self.csr, undirected=undirected)
        decision = autotune.decide_sharded(
            stats, self._device_kind(), self.num_shards, widths,
            measured=self._measured_prior,
        )
        self.exchange = decision.exchange
        self.agg = decision.agg
        self._autotune_record = decision.as_dict()

    def _sharded(self, undirected: bool) -> "ShardedCSR":
        sc = self._sharded_cache.get(undirected)
        if sc is None:
            sc = ShardedCSR(self.csr, self.num_shards, undirected)
            self._sharded_cache[undirected] = sc
        return sc

    def _channel_view(self, program: VertexProgram, name: str):
        """(ShardedCSR, graph args, views) of one named EdgeChannel, cached
        per channel VALUE, LRU-bounded by CHANNEL_CACHE_SIZE (eviction
        drops the channel's device arrays)."""
        from janusgraph_tpu_torch.olap.csr import channel_edges

        channel = program.edge_channels[name]
        hit = self._channel_views.get(channel)
        if hit is not None:
            self._channel_views.move_to_end(channel)
            return hit
        sc = ShardedCSR(self.csr, self.num_shards, False, edges=channel_edges(self.csr, channel))
        cache: Dict[Tuple, object] = {}
        entry = (sc, self._graph_args(sc, ("ch", channel), cache), self._views(sc, ("ch", channel), cache))
        self._channel_views[channel] = entry
        while len(self._channel_views) > self.CHANNEL_CACHE_SIZE:
            self._channel_views.popitem(last=False)
        return entry

    # ------------------------------------------------------------ placement
    def _put(self, host, grp, rows_per_slot: int, stride: int = 0, index: bool = False):
        """One group's block of a slot-major host array on its device; an
        index array becomes int64 with ``stride`` times the group-local slot
        added to each slot's rows (offsets into the group's stacked
        blocks)."""
        block = np.asarray(host[grp.lo * rows_per_slot : grp.hi * rows_per_slot])
        if index:
            block = block.astype(np.int64)
            if stride:
                off = np.repeat(np.arange(grp.size, dtype=np.int64) * stride, rows_per_slot)
                block = block + off.reshape((-1,) + (1,) * (block.ndim - 1))
        t = torch.as_tensor(np.ascontiguousarray(block), device=grp.device)
        self._h2d_bytes += t.numel() * t.element_size()
        return t

    def _put_ell(self, buckets, meta, grp, stride: int) -> List[dict]:
        S = self.num_shards
        out = []
        for bucket, n_slots in zip(buckets, meta):
            idx, wm, va = bucket[0], bucket[1], bucket[2]
            rows = idx.shape[0] // S
            entry = {
                "idx": self._put(idx, grp, rows, stride, index=True),
                "w": self._put(wm, grp, rows) if wm is not None else None,
                "valid": self._put(va, grp, rows) if va is not None else None,
                "rows": rows,
                "n_slots": n_slots,
                "fold": None,
            }
            if n_slots is not None:
                fold = _fold_matrix(
                    bucket[3][grp.lo * rows : grp.hi * rows], grp.size, rows, n_slots
                )
                entry["fold"] = torch.as_tensor(fold, device=grp.device)
                self._h2d_bytes += fold.nbytes
            out.append(entry)
        return out

    def _put_ring(self, sc: "ShardedCSR", grp) -> List[tuple]:
        """Per ring step t: (src, dst, valid, weight) of every slot's block
        of the owner passing by at t (owner (s - t) mod S), the source and
        destination offset into the group's stacked Np blocks."""
        S, Np, Eo = self.num_shards, sc.shard_size, sc.ring_block
        t_idx = np.arange(S)[:, None]
        s_idx = np.arange(grp.lo, grp.hi)[None, :]
        owner = (s_idx - t_idx) % S

        def perm(arr):
            return arr.reshape(S, S, Eo)[s_idx, owner]  # [t, slot, Eo]

        off = (np.arange(grp.size, dtype=np.int64) * Np)[None, :, None]
        src = perm(sc.ring_src_loc).astype(np.int64) + off
        dst = perm(sc.ring_dst_loc).astype(np.int64) + off
        valid, weight = perm(sc.ring_valid), perm(sc.ring_weight)
        steps = []
        for t in range(S):
            arrs = [src[t], dst[t], valid[t], weight[t]]
            tens = tuple(
                torch.as_tensor(np.ascontiguousarray(a).reshape(-1), device=grp.device) for a in arrs
            )
            self._h2d_bytes += sum(x.numel() * x.element_size() for x in tens)
            steps.append(tens)
        return steps

    def _graph_args(self, sc: "ShardedCSR", view_key, cache=None) -> List[dict]:
        """Per group, the device arrays the configured body reads; placed
        once per (edge view, exchange, agg)."""
        store = self._device_cache if cache is None else cache
        key = ("gargs", view_key, self.exchange, self.agg)
        hit = store.get(key)
        if hit is not None:
            return hit
        S, Np, Em = self.num_shards, sc.shard_size, sc.edges_per_shard
        out = []
        for grp in self.mesh.local_groups:
            g: Dict[str, object] = {}
            if self.exchange == "blocked":
                sc.ensure_blocked_plan()
                Hc, Eq = sc.halo_cap, sc.edges_per_owner
                if self.agg == "ell":
                    sc.ensure_blocked_ell()
                    plan = sc.blocked_plan
                    g["bell"] = self._put_ell(sc.bell_buckets, sc.bell_meta, grp, Np + 1)
                    g["bell_unpermute"] = self._put(
                        sc.bell_unpermute, grp, Np + S * Hc, plan.ell_out_len + 1, index=True
                    )
                    g["bell_recv_idx"] = self._put(
                        sc.bell_recv_idx, grp, Np, S * Hc + Np + 1, index=True
                    )
                else:
                    g["blk_src"] = self._put(sc.blk_src_loc, grp, Eq, Np, index=True)
                    g["blk_seg"] = self._put(sc.blk_seg, grp, Eq, Np + S * Hc + 1, index=True)
                    g["blk_valid"] = self._put(sc.blk_valid, grp, Eq)
                    g["blk_w"] = self._put(sc.blk_weight, grp, Eq) if sc.has_weight else None
                    g["recv_dst"] = self._put(sc.recv_dst, grp, S * Hc, Np + 1, index=True)
            elif self.exchange == "ring":
                sc.ensure_ring()
                g["ring"] = self._put_ring(sc, grp)
            else:
                if self.exchange == "a2a":
                    sc.ensure_exchange_plan()
                    g["send_idx"] = self._put(sc.send_idx, grp, S, Np, index=True)
                    T1 = sc.msg_table_len + 1
                if self.agg == "ell":
                    sc.ensure_ell()
                    g["ell"] = self._put_ell(sc.ell_buckets, sc.ell_meta, grp, T1)
                    g["ell_unpermute"] = self._put(sc.ell_unpermute, grp, Np, sc.ell_out_len, index=True)
                else:
                    if self.exchange == "a2a":
                        g["src_idx"] = self._put(sc.in_src_tab, grp, Em, T1, index=True)
                    else:
                        g["src_idx"] = self._put(sc.in_src_glob, grp, Em, index=True)
                    g["dst_loc"] = self._put(sc.in_dst_loc, grp, Em, Np, index=True)
                    g["valid"] = self._put(sc.in_valid, grp, Em)
                    g["weight"] = self._put(sc.in_weight, grp, Em) if sc.has_weight else None
            out.append(g)
        store[key] = out
        return out

    def _views(self, sc: "ShardedCSR", view_key, cache=None) -> list:
        """Per group: (its stacked-rows view, one view per shard)."""
        store = self._device_cache if cache is None else cache
        key = ("views", view_key)
        hit = store.get(key)
        if hit is not None:
            return hit
        Np = sc.shard_size
        out = []
        for grp in self.mesh.local_groups:
            arrs = [
                self._put(a, grp, Np) for a in (sc.out_degree, sc.active, sc.in_degree)
            ]
            whole = _ShardView(
                sc.real_n, grp.size * Np, grp.lo * Np, *arrs, grp.device, self.csr.num_edges
            )
            slots = [
                _ShardView(
                    sc.real_n, Np, (grp.lo + j) * Np,
                    *[a[j * Np : (j + 1) * Np] for a in arrs], grp.device, self.csr.num_edges,
                )
                for j in range(grp.size)
            ]
            out.append((whole, slots))
        store[key] = out
        return out

    def _global_view(self, sc: "ShardedCSR") -> _ShardView:
        """The whole padded domain on the mesh's home device (setup)."""
        home = self.mesh.home

        def put(a):
            return torch.as_tensor(a, device=home)

        return _ShardView(
            sc.real_n, sc.padded_n, 0, put(sc.out_degree), put(sc.active), put(sc.in_degree),
            home, self.csr.num_edges,
        )

    def _split(self, t: torch.Tensor, sc: "ShardedCSR") -> List[torch.Tensor]:
        Np = sc.shard_size
        return [t[g.lo * Np : g.hi * Np].to(g.device) for g in self.mesh.local_groups]

    def _setup(self, program: VertexProgram, sc: "ShardedCSR"):
        """(per-group state, per-group aggregators) from program.setup over
        the whole padded domain, as the reference's host-side setup."""
        state, init = program.setup(self._global_view(sc))
        states = self._split_state(state, sc)
        mem = {k: torch.as_tensor(v, dtype=torch.float32, device=self.mesh.home) for k, (_o, v) in init.items()}
        return states, self._mems(mem)

    def _split_state(self, state: Dict[str, torch.Tensor], sc) -> List[Dict[str, torch.Tensor]]:
        parts = {k: self._split(v, sc) for k, v in state.items()}
        return [{k: parts[k][i] for k in parts} for i in range(len(self.mesh.local_groups))]

    def _mems(self, mem: Dict[str, torch.Tensor]) -> List[Dict[str, torch.Tensor]]:
        return [{k: v.to(g.device) for k, v in mem.items()} for g in self.mesh.local_groups]

    def _restore(self, program, sc, ck_state) -> List[Dict[str, torch.Tensor]]:
        """State from a checkpoint: its real rows over a fresh setup's
        padding (checkpoints hold the real rows only, so they are portable
        across shard counts and executors)."""
        fresh, _m = program.setup(self._global_view(sc))
        state = {}
        for k, pad in fresh.items():
            arr = pad.detach().cpu().numpy().copy()
            arr[: sc.real_n] = np.asarray(ck_state[k])
            state[k] = torch.as_tensor(arr, device=self.mesh.home)
        return self._split_state(state, sc)

    def _fetch(self, states, sc) -> Dict[str, np.ndarray]:
        """Host copy of the whole state, padding stripped: on a mesh that
        spans processes every process gathers every process's rows, so all
        return the identical global arrays."""
        keys = list(states[0])
        return {
            k: self.mesh.gather_rows([st[k] for st in states]).numpy()[: sc.real_n]
            for k in keys
        }

    # ------------------------------------------------------------ superstep
    def _ell_parts(self, buckets, tab, op, program, has_w, slots):
        """[slots, rows-or-n_slots, ...] per bucket: gather, transform,
        tree, and the fold of row-split supernodes."""
        et = program.edge_transform if has_w else EdgeTransform.NONE
        cols = program.edge_transform_cols if has_w else None
        parts = []
        for b in buckets:
            m = kernels.flat_take(tab, b["idx"])
            if b["w"] is not None:
                m = kernels._transform(m, b["w"], b["valid"], op, et, cols)
            r = kernels.tree_reduce(m, op)
            if b["fold"] is not None:
                r = kernels.fold_rows(op, r, b["fold"])
                parts.append(r.reshape((slots, b["n_slots"]) + tuple(r.shape[1:])))
            else:
                parts.append(r.reshape((slots, b["rows"]) + tuple(r.shape[1:])))
        return parts

    def _body(self, program, op, sc, g, views, state, step, mem):
        """One group's superstep (a generator: each collective is a yield
        the lockstep driver answers for every group at once)."""
        S, Np = self.num_shards, sc.shard_size
        whole, slot_views = views
        Sg = len(slot_views)
        identity = Combiner.IDENTITY[op]
        has_w = sc.has_weight
        et, cols = program.edge_transform, program.edge_transform_cols
        outgoing = program.message(state, step, whole)
        tail = tuple(outgoing.shape[1:])
        dev, dt = outgoing.device, outgoing.dtype

        def pad():
            return torch.full((Sg, 1) + tail, identity, dtype=dt, device=dev)

        def stacked(x, rows):
            return x.reshape((Sg, rows) + tail)

        if self.exchange == "ring":
            # S-step ring: rotate the shard blocks one slot at a time; step
            # t folds exactly the edges whose sources the passing owner
            # holds, so a superstep does ~Em edge work, not S*Em
            block = stacked(outgoing, Np)
            agg = torch.full((Sg * Np,) + tail, identity, dtype=dt, device=dev)
            for t in range(S):
                if t:
                    block = yield ("ppermute", block)
                src, dst, valid, w = g["ring"][t]
                msgs = torch.index_select(block.reshape((Sg * Np,) + tail), 0, src)
                # ones-materialized pad weights must not transform on a
                # weightless view
                msgs = apply_edge_transform(msgs, w if has_w else None, et, cols)
                msgs = torch.where(_mask(valid, msgs), msgs, identity)
                agg = _combine(op, agg, kernels.segment_combine(op, msgs, dst, Sg * Np))
        elif self.exchange == "blocked":
            # propagation blocking: per-edge messages bin by destination
            # shard and combiner-merge locally (local destinations [0, Np)
            # + outgoing bins [Np, Np+S*Hc)); the merged bins swap in one
            # all-to-all and the receiver combines S*Hc merged values
            Hc = sc.halo_cap
            if self.agg == "ell":
                out_ext = torch.cat([stacked(outgoing, Np), pad()], 1).reshape((-1,) + tail)
                parts = self._ell_parts(g["bell"], out_ext, op, program, has_w, Sg)
                flat = torch.cat(parts + [pad()], 1).reshape((-1,) + tail)
                btab = stacked(torch.index_select(flat, 0, g["bell_unpermute"]), Np + S * Hc)
                local = btab[:, :Np]
                bins = btab[:, Np:].reshape((Sg, S, Hc) + tail)
                recv = yield ("all_to_all", bins)
                rtab = torch.cat([recv.reshape((Sg, S * Hc) + tail), local, pad()], 1)
                m = kernels.flat_take(rtab.reshape((-1,) + tail), g["bell_recv_idx"])
                agg = kernels.tree_reduce(m, op)
            else:
                msgs = torch.index_select(outgoing, 0, g["blk_src"])
                msgs = apply_edge_transform(msgs, g["blk_w"] if has_w else None, et, cols)
                msgs = torch.where(_mask(g["blk_valid"], msgs), msgs, identity)
                msgs = kernels.fp_fence(msgs)
                ns = Np + S * Hc + 1
                seg_out = stacked(kernels.segment_combine(op, msgs, g["blk_seg"], Sg * ns), ns)
                local = seg_out[:, :Np]
                bins = seg_out[:, Np : Np + S * Hc].reshape((Sg, S, Hc) + tail)
                recv = yield ("all_to_all", bins)
                remote = kernels.segment_combine(
                    op, recv.reshape((-1,) + tail), g["recv_dst"], Sg * (Np + 1)
                )
                agg = _combine(op, local, stacked(remote, Np + 1)[:, :Np]).reshape((-1,) + tail)
        else:
            if self.exchange == "a2a":
                # boundary buckets only: gather the values each peer needs
                # and swap the buckets in one all-to-all
                B = sc.boundary_width
                sends = kernels.flat_take(outgoing, g["send_idx"]).reshape((Sg, S, B) + tail)
                recv = yield ("all_to_all", sends)
                tab = torch.cat(
                    [stacked(outgoing, Np), recv.reshape((Sg, S * B) + tail), pad()], 1
                ).reshape((-1,) + tail)
            else:
                full = yield ("all_gather", stacked(outgoing, Np))
                tab = full.reshape((-1,) + tail)
            if self.agg == "ell":
                parts = self._ell_parts(g["ell"], tab, op, program, has_w, Sg)
                flat = torch.cat(parts, 1).reshape((-1,) + tail)
                agg = torch.index_select(flat, 0, g["ell_unpermute"])
            else:
                msgs = torch.index_select(tab, 0, g["src_idx"])
                msgs = apply_edge_transform(msgs, g["weight"] if has_w else None, et, cols)
                msgs = torch.where(_mask(g["valid"], msgs), msgs, identity)
                agg = kernels.segment_combine(op, msgs, g["dst_loc"], Sg * Np)

        # apply per shard, then the barrier: each metric's per-shard
        # partials reduce over the mesh (psum / pmin / pmax)
        new_parts, partials, mops = [], {}, {}
        for j, view in enumerate(slot_views):
            rows = slice(j * Np, (j + 1) * Np)
            st = {k: v[rows] for k, v in state.items()}
            new_st, metrics = program.apply(st, agg[rows], step, mem, view)
            new_parts.append(new_st)
            for k, (mop, v) in metrics.items():
                mops[k] = mop
                partials.setdefault(k, []).append(
                    torch.as_tensor(v, dtype=torch.float32, device=dev).reshape(())
                )
        new_state = (
            new_parts[0] if Sg == 1
            else {k: torch.cat([p[k] for p in new_parts]) for k in new_parts[0]}
        )
        reduced = {}
        for k, vals in partials.items():
            reduced[k] = yield ("reduce", mops[k], torch.stack(vals))
        return new_state, reduced, mops

    def _superstep(self, program, op, sc, gargs, views, states, steps, mems):
        """One superstep of every shard: (per-group new state, per-group
        reduced metrics, {metric: combiner})."""
        bodies = [
            self._body(program, op, sc, gargs[i], views[i], states[i], steps[i], mems[i])
            for i in range(len(self.mesh.local_groups))
        ]
        outs = lockstep(self.mesh, bodies)
        mops = outs[0][2]
        self._metric_ops[(program.cache_key(), op)] = dict(mops)
        return [o[0] for o in outs], [o[1] for o in outs], mops

    # ------------------------------------------------------------- frontier
    def _frontier_eligible(self, program: VertexProgram, mode: str) -> bool:
        """The ShortestPath family runs per-shard frontier compaction unless
        the numeric guards say no (as ``GPUExecutor._frontier_eligible``,
        over the padded index space)."""
        from janusgraph_tpu_torch.olap.gpu_executor import GPUExecutor
        from janusgraph_tpu_torch.parallel.sharded_frontier import ShardedFrontierEngine

        kind = GPUExecutor._frontier_family(program)
        if kind is None or self.csr.num_edges >= ShardedFrontierEngine.MAX_EDGES:
            return False
        padded_n = self._sharded(program.undirected).padded_n
        if kind == "sssp":
            return not (program.track_paths and padded_n >= (1 << 24))
        return padded_n < (1 << 24) and (
            mode == "always" or self.csr.num_edges >= GPUExecutor.FRONTIER_CC_MIN_EDGES
        )

    def _run_frontier(self, program: VertexProgram, fault_hook=None) -> Dict[str, np.ndarray]:
        from janusgraph_tpu_torch.olap.gpu_executor import GPUExecutor
        from janusgraph_tpu_torch.parallel.sharded_frontier import ShardedFrontierEngine

        if self._frontier_engine is None:
            self._frontier_engine = ShardedFrontierEngine(self)
        t0 = time.perf_counter()
        if GPUExecutor._frontier_family(program) == "cc":
            out = self._frontier_engine.run_cc(program, fault_hook=fault_hook)
        else:
            out = self._frontier_engine.run(program, fault_hook=fault_hook)
        trace = self._frontier_engine.last_trace
        self.last_run_info = {
            "path": "frontier",
            "supersteps": len(trace),
            "wall_s": round(time.perf_counter() - t0, 4),
            "tiers": trace,
        }
        return out

    # ------------------------------------------------- fault/checkpoint glue
    def _bind_hook(self, fault_hook):
        """Normalize a fault hook to hook(step) -> straggler events. Mesh-
        aware hooks (FaultPlan.sharded_hook) take (step, num_shards) and
        return straggler records; single-argument hooks are called as-is."""
        if fault_hook is None:
            return None
        try:
            params = [
                p for p in inspect.signature(fault_hook).parameters.values()
                if p.kind in (
                    inspect.Parameter.POSITIONAL_ONLY,
                    inspect.Parameter.POSITIONAL_OR_KEYWORD,
                    inspect.Parameter.VAR_POSITIONAL,
                )
            ]
            mesh_aware = len(params) >= 2 or any(
                p.kind is inspect.Parameter.VAR_POSITIONAL for p in params
            )
        except (TypeError, ValueError):
            mesh_aware = False
        S = self.num_shards
        if mesh_aware:
            return lambda step: fault_hook(step, S)
        return fault_hook

    def _consult(self, hook, step: int) -> None:
        """One superstep-boundary fault consultation; straggler skew
        records accumulate for the run report."""
        if hook is None:
            return
        events = hook(step)
        if events:
            self._straggler_events.extend(events)

    def _barrier(self) -> None:
        """Wait for every process of a mesh that spans processes."""
        if self.mesh.spans_processes:
            import torch.distributed as dist

            dist.barrier()

    def _save_ck(self, checkpoint_path, shard_dir, state_host, mem_values, steps,
                 records=None) -> None:
        """Every process holds the same global state (``_fetch``), so on a
        mesh that spans processes process 0 writes the files alone and the
        others wait for it: no file is written by two processes at once,
        and a resume on any process reads a whole checkpoint."""
        ck0 = time.perf_counter()
        if self.mesh.process_id == 0:
            if shard_dir:
                from janusgraph_tpu_torch.olap.sharded_checkpoint import save_sharded_checkpoint

                save_sharded_checkpoint(shard_dir, state_host, mem_values, steps, self.num_shards)
            else:
                from janusgraph_tpu_torch.olap.checkpoint import save_checkpoint

                save_checkpoint(checkpoint_path, state_host, mem_values, steps)
        self._barrier()
        self._ck_saves += 1
        if records:
            # the save's wall, stamped on the superstep that paid it
            records[-1]["checkpoint_ms"] = round((time.perf_counter() - ck0) * 1000.0, 3)

    def _load_ck(self, checkpoint_path, shard_dir):
        if shard_dir:
            from janusgraph_tpu_torch.olap.sharded_checkpoint import load_sharded_checkpoint

            ck = load_sharded_checkpoint(shard_dir)
        elif checkpoint_path:
            from janusgraph_tpu_torch.olap.checkpoint import load_checkpoint

            ck = load_checkpoint(checkpoint_path)
        else:
            ck = None
        if ck is not None and self._resume_t_catch is not None:
            # catch -> state restored: the recovery latency an operator pays
            self._resume_ms += (time.perf_counter() - self._resume_t_catch) * 1000.0
            self._resume_t_catch = None
        return ck

    def _mark(self):
        """A timing mark: a CUDA event on the home device's stream on the
        card, the host clock elsewhere."""
        if self.mesh.home.type == "cuda":
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev
        return time.perf_counter()

    # -------------------------------------------------- per-shard reporting
    def _measured_walls(self, sc: "ShardedCSR") -> Optional[List[float]]:
        """MEASURED per-shard superstep walls (ms): one launch runs every
        shard in lockstep, hiding per-shard time, so each shard's real
        aggregation workload runs shard-by-shard on the host and is timed
        (min of 3 repeats). Cached per edge view and layout."""
        if not self.shard_measure or self.csr.num_edges > self.MEASURE_MAX_EDGES:
            return None
        # the blocked and the eager layouts price different workloads
        probe = "blocked" if self.exchange == "blocked" else "eager"
        cached = sc.measured_walls.get(probe)
        if cached is not None:
            return cached
        t0 = time.perf_counter()
        if probe == "blocked":
            sc.ensure_blocked_plan()
            walls = halo.measure_shard_walls(sc.blocked_plan)
        else:
            # dst-partitioned probe: gather + scatter over each shard's
            # real in-edge slice (the eager paths' per-shard work shape)
            S, Np, Em = sc.num_shards, sc.shard_size, sc.edges_per_shard
            offsets = sc._offsets
            ramp = np.arange(sc.padded_n, dtype=np.float32) % 97 + 1.0
            walls = []
            for s in range(S):
                k = max(1, int(offsets[s + 1] - offsets[s]))
                src = sc.in_src_glob[s * Em : s * Em + k]
                dst = sc.in_dst_loc[s * Em : s * Em + k]
                w = sc.in_weight[s * Em : s * Em + k]
                best = float("inf")
                for _ in range(3):
                    t1 = time.perf_counter()
                    msgs = ramp[src] * w
                    acc = np.zeros(Np, dtype=np.float32)
                    np.add.at(acc, dst, msgs)
                    best = min(best, time.perf_counter() - t1)
                walls.append(best * 1000.0)
        if self.mesh.spans_processes:
            # every process reports the same figures for every shard
            import torch.distributed as dist

            box = [walls]
            dist.broadcast_object_list(box, src=0)
            walls = box[0]
        sc.measured_walls[probe] = walls
        return walls

    def _shard_report(self, sc: "ShardedCSR", records: List[dict]) -> None:
        """Per-shard ledger + roofline, straggler detection, and the skew
        gauge. Per-shard time comes from the measured host probe
        (cost_source="measured") when available, else from the plan's edge
        counts ("plan"); the superstep wall is attributed by relative
        per-shard cost, and injected straggler skew adds on top."""
        S, Np = sc.num_shards, sc.shard_size
        offsets = sc._offsets
        edges = [int(offsets[s + 1] - offsets[s]) for s in range(S)]
        n_steps = max(1, len(records))
        mean_wall = sum(r.get("wall_ms", 0.0) for r in records) / n_steps if records else 0.0
        peaks = profiler.device_peaks(self._device_kind())
        strag: Dict[int, float] = {}
        for ev in self._straggler_events:
            strag[ev["shard"]] = strag.get(ev["shard"], 0.0) + float(ev["ms"])
        costs = []
        for s in range(S):
            verts = max(0, min(sc.real_n - s * Np, Np))
            costs.append((verts, profiler.estimate_superstep_cost(max(verts, 1), max(edges[s], 1))))
        max_edges = max(max(edges), 1)
        measured = self._measured_walls(sc)
        cost_source = "measured" if measured else "plan"
        max_meas = max(measured) if measured else 0.0
        per, t_by_shard = [], []
        for s in range(S):
            verts, cost = costs[s]
            # the barrier wall is set by the busiest shard
            share = measured[s] / max_meas if measured and max_meas > 0 else edges[s] / max_edges
            modeled_ms = mean_wall * share
            strag_ms = strag.get(s, 0.0)
            t_by_shard.append(modeled_ms + strag_ms / n_steps)
            point = profiler.roofline_point(
                cost["flops"], cost["bytes_accessed"], modeled_ms if modeled_ms > 0 else 0.0, peaks,
            )
            per.append({
                "shard": s,
                **({"process": self.mesh.process_of[s]} if self.mesh.spans_processes else {}),
                "vertices": verts,
                "edges": edges[s],
                "modeled_ms": round(modeled_ms, 4),
                "measured_ms": round(measured[s], 4) if measured else None,
                "cost_source": cost_source,
                "straggler_ms": round(strag_ms, 3),
                "ledger": {
                    "cells_read": edges[s],
                    "bytes_read": int(cost["bytes_accessed"]),
                    "bytes_written": 8 * verts,
                },
                "roofline": {
                    "flops": cost["flops"],
                    "bytes_accessed": cost["bytes_accessed"],
                    "cost_source": cost["cost_source"],
                    **point,
                },
            })
        mean_t = sum(t_by_shard) / S if S else 0.0
        skew = (max(t_by_shard) / mean_t) if mean_t > 0 else 1.0
        slowest = int(np.argmax(t_by_shard)) if t_by_shard else 0
        self.last_run_info["shards"] = {
            "count": S,
            "skew": round(skew, 4),
            "cost_source": cost_source,
            "slowest_shard": slowest,
            "straggler_events": len(self._straggler_events),
            "straggler_ms_total": round(sum(strag.values()), 3),
            "boundary_elems": getattr(sc, "comm_a2a_elems", None),
            "per_shard": per,
        }
        self.last_run_info["exchange"] = self._exchange_info(sc)
        if self._autotune_record is not None:
            self.last_run_info["autotune"] = self._autotune_record
        registry.gauge("olap.shard.skew").set(skew)
        registry.gauge("olap.shard.skew.measured").set(1.0 if cost_source == "measured" else 0.0)
        registry.counter("olap.sharded.runs").inc()
        profiler.accrue(
            cells_read=sum(edges),
            bytes_read=sum(int(c["bytes_accessed"]) for _v, c in costs),
            bytes_written=8 * sc.real_n,
        )
        with tracer.span(
            "olap.shard.slowest", shard=slowest,
            modeled_ms=round(t_by_shard[slowest], 4) if t_by_shard else 0.0,
            skew=round(skew, 4),
        ):
            pass
        if self._straggler_events or skew >= SKEW_FLIGHT_THRESHOLD:
            flight_recorder.record(
                "shard_skew",
                skew=round(skew, 4),
                slowest_shard=slowest,
                straggler_events=len(self._straggler_events),
                injected_ms=round(sum(strag.values()), 3),
            )

    def _persist_measured(self, sc: "ShardedCSR", checkpoint_path, shard_dir, records) -> None:
        """The measured record, keyed by SHARD COUNT inside the shared
        .autotune.json (``autotune.save_measured`` v2)."""
        if not records:
            return
        path = (
            os.path.join(shard_dir, "autotune.json") if shard_dir
            else (checkpoint_path + ".autotune.json" if checkpoint_path else None)
        )
        if not path:
            return
        from janusgraph_tpu_torch.olap import autotune

        prior = autotune.load_measured(path, shard_count=self.num_shards)
        mean_wall = sum(r.get("wall_ms", 0.0) for r in records) / max(1, len(records))
        self._barrier()  # every process has read the prior
        if self.mesh.process_id == 0:
            autotune.save_measured(
                path,
                {
                    "strategy": f"sharded-{self.exchange}-{self.agg}",
                    "pad_ratio": round(sc.padded_n / max(1, sc.real_n), 4),
                    "superstep_ms": round(mean_wall, 3),
                    "roofline_by_tier": None,
                    "exchange": self.exchange,
                    "agg": self.agg,
                    "halo_cap": getattr(sc, "halo_cap", None),
                },
                shard_count=self.num_shards,
            )
        self._barrier()  # the next run's prior is the file just written
        self.last_run_info["autotune_persist"] = {
            "path": path,
            "shard_count": self.num_shards,
            "calibrated": prior is not None,
        }

    # ------------------------------------------------------------------ run
    def run(
        self,
        program: VertexProgram,
        sync_every: int = 1,
        fused: bool = None,
        checkpoint_path: str = None,
        checkpoint_every: int = 0,
        resume: bool = False,
        frontier: str = "auto",
        fault_hook=None,
        resume_attempts: int = 3,
        shard_checkpoint_dir: str = None,
    ) -> Dict[str, np.ndarray]:
        """Run to termination; the final state as numpy arrays, padding
        stripped. ``fused`` (default ``program.fused_eligible()``): spans of
        the run without a host sync per superstep, chunked at checkpoints;
        otherwise a host loop fetching the aggregators every ``sync_every``
        supersteps. ``frontier``: "auto"/"always"/"off" — the ShortestPath
        family runs frontier-compacted supersteps where eligible
        (checkpointing rides the dense path).

        ``shard_checkpoint_dir`` saves the per-shard checkpoint format
        (``olap/sharded_checkpoint.py``) every ``checkpoint_every``
        supersteps instead of the single file ``checkpoint_path``.

        ``fault_hook`` (e.g. ``FaultPlan.sharded_hook``) is consulted at
        every host-visible superstep boundary (a fused chunk's) and may
        raise ``SuperstepPreempted`` (also ShardPreempted, CollectiveTimeout,
        HaloDropped). With checkpointing on, every shard rolls back to the
        last complete checkpoint and replays, up to ``resume_attempts``
        times, to the uninterrupted run's bits; a frontier run restarts
        from scratch."""
        check_weighted_transforms(program, self.csr)
        if frontier not in ("auto", "off", "always"):
            raise ValueError(f"unknown frontier mode: {frontier!r}")
        if sync_every < 1:
            raise ValueError(f"sync_every must be >= 1, got {sync_every}")
        if not getattr(program, "sharded_compatible", True):
            # the per-edge dot needs both endpoints' feature rows in one
            # kernel; the exchanges ship source-side rows only
            raise NotImplementedError(
                "sddmm dense programs are not supported on the sharded "
                "executor (the per-edge dot needs dst features on the "
                "source side); run executor='tpu' or message_mode="
                "'copy'/'weighted'"
            )
        if self.exchange_requested == "auto" and self._autotune_record is None:
            apath = (
                os.path.join(shard_checkpoint_dir, "autotune.json") if shard_checkpoint_dir
                else (checkpoint_path + ".autotune.json" if checkpoint_path else None)
            )
            if apath:
                from janusgraph_tpu_torch.olap import autotune

                self._measured_prior = autotune.load_measured(apath, shard_count=self.num_shards)
        self._resolve_exchange(program.undirected)
        from janusgraph_tpu_torch.olap.gpu_executor import GPUExecutor

        use_frontier = False
        if frontier != "off" and GPUExecutor._frontier_family(program):
            if checkpoint_path or shard_checkpoint_dir:
                if frontier == "always":
                    raise ValueError(
                        "frontier='always' cannot be combined with "
                        "checkpointing (the frontier loop does not "
                        "checkpoint) — drop checkpoint_path or use "
                        "frontier='auto'"
                    )
            elif self._frontier_eligible(program, frontier):
                use_frontier = True
            elif frontier == "always":
                raise ValueError(
                    "frontier='always' but the graph exceeds the frontier "
                    f"engine's guards (|V|={self.csr.num_vertices}, "
                    f"|E|={self.csr.num_edges}; float32 label/predecessor "
                    "exactness needs padded |V| < 2^24, int32 expansion "
                    "needs |E| < 2^30) — use frontier='auto' or 'off'"
                )
        sc = self._sharded(program.undirected)
        if fused is None:
            fused = program.fused_eligible()
        use_fused = (
            not use_frontier and fused
            and type(program).combiner_for is VertexProgram.combiner_for
            and type(program).channel_for is VertexProgram.channel_for
        )
        hook = self._bind_hook(fault_hook)
        self._straggler_events = []
        self._ck_saves = 0
        self._resume_ms = 0.0
        self._resume_t_catch = None
        self._captures = 0
        self._h2d_bytes = 0
        self._transport0 = dict(self.mesh.transport)
        t_run = time.perf_counter()
        with tracer.span(
            "olap.run", executor="sharded", shards=self.num_shards, exchange=self.exchange,
        ) as sp:
            out = self._run_guarded(
                program, sc, sync_every, checkpoint_path, checkpoint_every, resume, hook,
                resume_attempts, shard_checkpoint_dir, use_frontier, use_fused,
            )
            self._publish_run(sp, program, out, time.perf_counter() - t_run)
            return out

    def _run_guarded(self, program, sc, sync_every, checkpoint_path, checkpoint_every, resume,
                     hook, resume_attempts, shard_dir, use_frontier, use_fused):
        can_resume = bool((shard_dir or checkpoint_path) and checkpoint_every)
        resumes = 0
        while True:
            try:
                if use_frontier:
                    out = self._run_frontier(program, fault_hook=hook)
                elif use_fused:
                    out = self._run_fused(
                        program, sc, checkpoint_path, checkpoint_every, resume, hook, shard_dir,
                    )
                else:
                    out = self._run_host_loop(
                        program, sc, sync_every, checkpoint_path, checkpoint_every, resume,
                        hook, shard_dir,
                    )
                break
            except SuperstepPreempted as e:
                registry.counter("olap.preemptions").inc()
                # frontier runs restart from scratch (deterministic and
                # short); dense paths need a checkpoint to roll back to
                if resumes >= resume_attempts or not (use_frontier or can_resume):
                    raise
                resumes += 1
                resume = True
                self._resume_t_catch = time.perf_counter()
                registry.counter("olap.resumes").inc()
                registry.counter("olap.sharded.resumes").inc()
                flight_recorder.record(
                    "olap_resume", executor="sharded", attempt=resumes,
                    program=type(program).__name__, fault=type(e).__name__,
                    format="sharded" if shard_dir else "single",
                )
                if use_frontier:
                    # nothing to reload: the restart is the recovery
                    self._resume_ms += (time.perf_counter() - self._resume_t_catch) * 1000.0
                    self._resume_t_catch = None
        if resumes:
            self.last_run_info["resumes"] = resumes
            self.last_run_info["resume_ms"] = round(self._resume_ms, 3)
        if self._ck_saves or can_resume:
            self.last_run_info["checkpoint"] = {
                "format": "sharded" if shard_dir else "single",
                "saves": self._ck_saves,
                "location": shard_dir or checkpoint_path,
            }
        return out

    def _publish_run(self, sp, program, result, wall_s) -> None:
        """Publish the finished run in GPUExecutor's record vocabulary
        (path/supersteps/superstep_records, transfer bytes, compile cache,
        device memory, slowest superstep, the olap.* gauges)."""
        info = self.last_run_info
        info["executor"] = "sharded"
        mesh = self.mesh
        info["mesh"] = {
            "slots": self.num_shards,
            "devices": [str(d) for d in mesh.devices],
            "groups": len(mesh.groups),
        }
        # the processes the run spans, and what crossed between them
        info["processes"] = mesh.processes
        info["process_id"] = mesh.process_id
        info["transport"] = "gloo" if mesh.spans_processes else None
        info["staged_through_host"] = mesh.staged_through_host
        if mesh.spans_processes:
            since = self._transport0
            info["transport_bytes"] = int(mesh.transport["bytes"] - since["bytes"])
            info["transport_s"] = round(mesh.transport["seconds"] - since["seconds"], 6)
            info["transport_calls"] = int(mesh.transport["calls"] - since["calls"])
        info["wall_s"] = round(wall_s, 4)
        info["retraces"] = self._captures
        info["h2d_arg_bytes"] = int(self._h2d_bytes)
        info["d2h_bytes"] = int(sum(np.asarray(v).nbytes for v in result.values()))
        sc = self._sharded(bool(getattr(program, "undirected", False)))
        pad_ratio = round(sc.padded_n / max(1, sc.real_n), 4)
        info["pad_ratio"] = pad_ratio
        info["ell_pad_ratio"] = pad_ratio
        records = info.get("superstep_records")
        if records is None:
            # frontier path: the tier trace is the per-superstep record
            records = [
                {
                    "step": int(t.get("hop", i)),
                    "frontier": int(t.get("frontier", 0)),
                    "edges": int(t.get("edges", 0)),
                    "e_cap": int(t.get("E_cap", 0)),
                    **{k: t[k] for k in ("transport_bytes", "transport_ms") if k in t},
                }
                for i, t in enumerate(info.get("tiers", []))
            ]
        for i, r in enumerate(records):
            r.setdefault("frontier", sc.real_n)
            r.setdefault("pad_ratio", pad_ratio)
            r.setdefault("h2d_bytes", info["h2d_arg_bytes"] if i == 0 else 0)
        info["superstep_records"] = records
        dispatches = max(len(records), 1)
        misses = min(self._captures, dispatches)
        info["compile_cache"] = {
            "hits": dispatches - misses,
            "misses": misses,
            "compiled_total": sum(len(lp.graphs) for lp in self._fused_loops.values()),
        }
        registry.counter("olap.compile_cache.hits").inc(dispatches - misses)
        registry.counter("olap.compile_cache.misses").inc(misses)
        home = self.mesh.home
        if home.type == "cuda":
            allocated = torch.cuda.memory_stats_as_nested_dict(home)["allocated_bytes"]["all"]
            info["device_memory"] = {
                "source": "device",
                "bytes_in_use": int(allocated["current"]),
                "peak_bytes_in_use": int(allocated["peak"]),
            }
        else:
            info["device_memory"] = {
                "source": "host-estimate",
                "bytes_in_use": int(info["h2d_arg_bytes"]) + int(info["d2h_bytes"]),
            }
        registry.set_gauge("olap.device.bytes_in_use", float(info["device_memory"]["bytes_in_use"]))
        slowest = None
        for r in records[:128]:
            s = tracer.record_span(
                "superstep", float(r.get("wall_ms", 0.0)),
                **{k: v for k, v in r.items() if k != "wall_ms"},
            )
            if slowest is None or s.duration_ms > slowest.duration_ms:
                slowest = s
        if slowest is not None:
            info["slowest_superstep"] = {
                "step": slowest.attrs.get("step"),
                "wall_ms": round(slowest.duration_ms, 4),
                "span_id": f"{slowest.span_id:016x}",
                "trace_id": f"{slowest.trace_id:016x}",
            }
        sp.annotate(
            path=info.get("path"),
            supersteps=info.get("supersteps"),
            wall_s=info["wall_s"],
            retraces=self._captures,
            ell_pad_ratio=pad_ratio,
            h2d_arg_bytes=info["h2d_arg_bytes"],
            d2h_bytes=info["d2h_bytes"],
        )
        registry.counter("olap.runs").inc()
        registry.timer("olap.run").update(int(wall_s * 1e9))
        registry.set_gauge("olap.superstep.count", float(info.get("supersteps", 0) or 0))
        registry.set_gauge("olap.run.wall_ms", round(wall_s * 1000.0, 3))
        registry.set_gauge("olap.transfer.h2d_bytes", float(info["h2d_arg_bytes"]))
        registry.set_gauge("olap.transfer.d2h_bytes", float(info["d2h_bytes"]))
        registry.record_run("olap", info)

    def _stamp_transport(self, recs, since: dict, steps: int) -> None:
        """Per-superstep bytes and ms between processes since the mark
        ``since``, shared over the ``steps`` supersteps that ran (those of
        a fused chunk predicated out included: they exchanged too)."""
        if not self.mesh.spans_processes:
            return
        tr = self.mesh.transport
        per_b = (tr["bytes"] - since["bytes"]) / max(1, steps)
        per_ms = (tr["seconds"] - since["seconds"]) * 1e3 / max(1, steps)
        for r in recs:
            r["transport_bytes"] = int(round(per_b))
            r["transport_ms"] = round(per_ms, 4)

    def _host_memory(self, mems) -> Dict[str, float]:
        """One device->host transfer of every aggregator."""
        names = list(mems[0])
        if not names:
            return {}
        vals = torch.stack([mems[0][k].to(torch.float32) for k in names]).cpu().tolist()
        return dict(zip(names, vals))

    def _run_host_loop(self, program, sc, sync_every, checkpoint_path, checkpoint_every, resume,
                       hook, shard_dir) -> Dict[str, np.ndarray]:
        from janusgraph_tpu_torch.olap.gpu_executor import _elapsed_ms

        t0 = time.perf_counter()
        memory = Memory()
        states = None
        start = 0
        if resume and (checkpoint_path or shard_dir):
            ck = self._load_ck(checkpoint_path, shard_dir)
            if ck is not None:
                ck_state, ck_mem, start = ck
                states = self._restore(program, sc, ck_state)
                memory.values = {k: float(v) for k, v in ck_mem.items()}
                memory.superstep = start
                mems = self._mems({
                    k: torch.tensor(v, dtype=torch.float32, device=self.mesh.home)
                    for k, v in memory.values.items()
                })
        if states is None:
            states, mems = self._setup(program, sc)
        gargs = self._graph_args(sc, program.undirected)
        views = self._views(sc, program.undirected)
        steps_done = start
        records, timed = [], []
        last_step = program.max_iterations - 1
        for step in range(start, program.max_iterations):
            # the fault boundary: the barrier between supersteps, the one
            # point where no shard holds partial superstep state
            self._consult(hook, step)
            op = program.combiner_for(step)
            ch = program.channel_for(step)
            if ch is not None:
                sc_step, g_step, v_step = self._channel_view(program, ch)
            else:
                sc_step, g_step, v_step = sc, gargs, views
            mark0 = self._mark()
            tr0 = dict(self.mesh.transport)
            states, reduced, _mops = self._superstep(
                program, op, sc_step, g_step, v_step, states, [step] * len(states), mems,
            )
            mems = [{**m, **r} for m, r in zip(mems, reduced)]
            records.append({"step": step, "combiner": op, "channel": ch})
            self._stamp_transport([records[-1]], tr0, 1)
            timed.append((records[-1], (mark0, self._mark())))
            steps_done += 1
            if steps_done % sync_every and step != last_step:
                continue
            memory.values = self._host_memory(mems)
            memory.superstep = steps_done
            if checkpoint_every and (checkpoint_path or shard_dir) and (
                steps_done % checkpoint_every == 0 or step == last_step
            ):
                self._save_ck(
                    checkpoint_path, shard_dir, self._fetch(states, sc), memory.values,
                    steps_done, records=records,
                )
            if program.terminate(memory):
                break
        out = self._fetch(states, sc)
        # the fetch waited for every superstep: the marks are done
        for r, marks in timed:
            r["wall_ms"] = round(_elapsed_ms(marks), 4)
        self.last_run_info = {
            "path": "host-loop", "supersteps": steps_done,
            "wall_s": time.perf_counter() - t0,
            "superstep_records": records,
        }
        self._shard_report(sc, records)
        self._persist_measured(sc, checkpoint_path, shard_dir, records)
        return out

    def _fused_loop(self, program, op, sc, states, mems, steps_done, limit):
        """The cached loop of (program, monoid, exchange, agg) loaded with
        this run's starting point, or a new one: (loop, whether it is new)."""
        key = (program.cache_key(), op, self.exchange, self.agg, bool(program.undirected))
        loop = self._fused_loops.get(key)
        if loop is not None and loop.load(states, mems, steps_done, limit):
            loop.program = program
            return loop, False
        loop = _ShardedFusedLoop(self, program, op, sc, states, mems)
        loop.set_bounds(steps_done, limit)
        self._fused_loops[key] = loop
        return loop, True

    def _run_fused(self, program, sc, checkpoint_path, checkpoint_every, resume, hook=None,
                   shard_dir=None) -> Dict[str, np.ndarray]:
        """Spans of the run as chunks of predicated supersteps (the
        reference's while_loop inside shard_map): a new loop runs its first
        superstep eagerly (moving every array and learning the aggregators),
        then each chunk is the longest power of two up to MAX_CHUNK that
        fits the span, followed by one fetch of (steps, stopped). A span
        ends at max_iterations or at the next checkpoint, where the host
        saves and consults ``hook``."""
        from janusgraph_tpu_torch.olap.gpu_executor import GPUExecutor, _elapsed_ms

        t0 = time.perf_counter()
        op = program.combiner
        max_iter = program.max_iterations
        states = mems = None
        steps_done = 0
        if resume and (checkpoint_path or shard_dir):
            ck = self._load_ck(checkpoint_path, shard_dir)
            if ck is not None:
                ck_state, ck_mem, steps_done = ck
                states = self._restore(program, sc, ck_state)
                mems = self._mems({
                    k: torch.tensor(float(v), dtype=torch.float32, device=self.mesh.home)
                    for k, v in ck_mem.items()
                })
        if states is None:
            states, mems = self._setup(program, sc)
            if max_iter == 0:
                return self._fetch(states, sc)
        info = {
            "path": "fused", "supersteps": steps_done, "chunks": 0, "host_syncs": 0,
            "predicated_steps": 0, "capture_s": 0.0,
        }
        tr0 = dict(self.mesh.transport)
        first_step = steps_done
        top = 1 << (min(max(max_iter, 1), self.MAX_CHUNK).bit_length() - 1)
        loop = None
        cold = False
        records, timed = [], []
        stopped = False
        while steps_done < max_iter:
            # the fault boundary: once per span (the chunks own the
            # intra-span superstep boundaries on the device)
            self._consult(hook, steps_done)
            limit = max_iter
            if checkpoint_every:
                limit = min(steps_done + checkpoint_every, max_iter)
            spans = []
            if loop is None:
                loop, new = self._fused_loop(program, op, sc, states, mems, steps_done, limit)
                expected = steps_done
                if new:
                    cold = True
                    mark0 = self._mark()
                    loop.step(discover=True)
                    spans.append((expected, 1, (mark0, self._mark())))
                    expected += 1
            else:
                loop.set_bounds(limit=limit)
                expected = steps_done
            while expected < limit:
                length = 1 << (min(limit - expected, self.MAX_CHUNK).bit_length() - 1)
                capture_s, marks = loop.chunk(length, top)
                spans.append((expected, length, marks))
                info["capture_s"] += capture_s
                info["chunks"] += 1
                new_steps, stopped = loop.status.tolist()
                info["host_syncs"] += 1
                info["predicated_steps"] += expected + length - new_steps
                GPUExecutor._fused_records(records, timed, spans, new_steps, cold)
                spans = []
                steps_done = expected = new_steps
                if stopped:
                    break
            if expected > steps_done:
                # the eager first superstep was the whole span
                loop.finish()
                new_steps, stopped = loop.status.tolist()
                info["host_syncs"] += 1
                info["predicated_steps"] += expected - new_steps
                GPUExecutor._fused_records(records, timed, spans, new_steps, cold)
                steps_done = new_steps
            if checkpoint_every and (checkpoint_path or shard_dir):
                self._save_ck(
                    checkpoint_path, shard_dir, self._fetch(loop.state, sc),
                    self._host_memory(loop.mem), steps_done, records=records,
                )
                info["host_syncs"] += 1
            if stopped or steps_done < limit:
                break
        final = loop.state if loop is not None else states
        # a copy: the loop's buffers serve the next run
        out = self._fetch(final, sc)
        info["host_syncs"] += 1
        for recs, marks in timed:
            per_ms = round(_elapsed_ms(marks) / len(recs), 4)
            for r in recs:
                r["wall_ms"] = per_ms
        info["supersteps"] = steps_done
        info["wall_s"] = time.perf_counter() - t0
        self._stamp_transport(records, tr0, steps_done - first_step + info["predicated_steps"])
        info["superstep_records"] = records
        info["compile_in_first_dispatch"] = cold
        #: "captured" (CUDA-graph replay) or "eager" chunks
        info["fused_mode"] = loop.mode if loop is not None else None
        self.last_run_info = info
        self._shard_report(sc, records)
        self._persist_measured(sc, checkpoint_path, shard_dir, records)
        return out


def shard_csr(csr: CSRGraph, num_shards: int, undirected: bool = False) -> "ShardedCSR":
    return ShardedCSR(csr, num_shards, undirected)
