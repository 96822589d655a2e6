"""Frontier-compacted supersteps on the sharded executor — the port of
``janusgraph_tpu/parallel/sharded_frontier.py``, on top of the port's
``olap/frontier.py`` (``compact``, ``capped_expand``, ``_tier``).

A hop is two parts and one host round trip, as on one device:

  plan  mask the vertex values to INF off the frontier, exchange them
        (the a2a boundary buckets, or under exchange="blocked" without
        path tracking the sender-merged relaxation bins: a segment-min by
        destination bin, then one all-to-all of S*Hc elements), build each
        shard's message table [own Np ++ received] and count its fresh
        slots and their edges (pmax for the tier, psum for the trace);
  step  compact each shard's fresh table slots to F_cap (a cumsum of the
        mask, no host sync), expand them through the shard's table-slot
        CSC (``ShardedCSR.ensure_frontier_plan*``) and scatter-min only
        the frontier's edges.

On a mesh that spans processes each process runs its own groups' hops;
the plan's exchange and counts cross processes through the mesh, and the
result gathers every process's rows.

The shards that share a device expand as one: their compacted slots are
concatenated and expanded through their stacked CSCs in one
``capped_expand`` of Sg * E_cap slots. The tier covers the largest shard
(F_cap >= its fresh slots, E_cap >= its edges), so no edge is ever
dropped, and MIN does not depend on the order, so each hop equals the
reference's per-shard expansion and the dense sharded path bit for bit.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from janusgraph_tpu_torch.olap import kernels
from janusgraph_tpu_torch.olap.frontier import _tier, capped_expand
from janusgraph_tpu_torch.olap.vertex_program import INF, Combiner
from janusgraph_tpu_torch.parallel.compat import lockstep


def _compact_rows(mask: torch.Tensor, F_cap: int, fill: int) -> torch.Tensor:
    """``frontier.compact`` of each row of a [Sg, T] mask: [Sg, F_cap]
    ascending indices of the row's true entries, padded with ``fill``."""
    rows, T = mask.shape
    slot = torch.cumsum(mask, 1) - 1
    slot = torch.where(mask & (slot < F_cap), slot, F_cap)
    out = torch.full((rows, F_cap + 1), fill, dtype=torch.int64, device=mask.device)
    src = torch.arange(T, device=mask.device).expand(rows, T)
    out.scatter_(1, slot, src)
    return out[:, :F_cap]


class ShardedFrontierEngine:
    """Per-executor engine: the device placement of the frontier plans of
    each edge view, per group of slots."""

    F_MIN = 1 << 10
    E_MIN = 1 << 13
    GROWTH = 4
    #: the reference's int32 telescoping-cumsum headroom, kept so both
    #: packages route the same graphs the same way
    MAX_EDGES = 1 << 30

    def __init__(self, executor):
        self.ex = executor
        if getattr(executor, "_frontier_tier_growth", None):
            self.GROWTH = executor._frontier_tier_growth
        self.mesh = executor.mesh
        self._gargs_cache: Dict[tuple, list] = {}
        self.last_trace = []

    def _mode(self, track: bool) -> str:
        """'blocked' merges remote relaxations sender-side (MIN is exactly
        order-insensitive) and collapses remote expansion to one edge per
        used bin; predecessor tracking needs the per-source identity a
        merged bin discards, so it stays on the boundary table."""
        return "blocked" if self.ex.exchange == "blocked" and not track else "a2a"

    def _gargs(self, sc, view_key, weighted: bool, track: bool, mode: str) -> list:
        """Per group, the plan arrays on its device, offset into the
        group's stacked blocks: table slots by T (+2 for the CSC pointers),
        edges by the shard's edge count, destinations by Np."""
        key = (view_key, weighted, track, mode)
        hit = self._gargs_cache.get(key)
        if hit is not None:
            return hit
        ex = self.ex
        S, Np = sc.num_shards, sc.shard_size
        if mode == "blocked":
            sc.ensure_frontier_plan_blocked()
            T, E = Np + S * sc.halo_cap, sc.fblk_edges
            ip, dst, w, deg = sc.fblk_ip, sc.fblk_dst, sc.fblk_w, sc.fblk_deg
        else:
            sc.ensure_frontier_plan()
            T, E = sc.msg_table_len, sc.edges_per_shard
            ip, dst, w, deg = sc.ftr_ip, sc.ftr_dst, sc.ftr_w, sc.ftr_deg
        out = []
        for grp in self.mesh.local_groups:
            g = {
                "ip": ex._put(ip, grp, T + 2, E, index=True),
                "dst": ex._put(dst, grp, E, Np, index=True),
                "deg": ex._put(deg, grp, T, index=True),
                "T": T,
                "E": E,
            }
            if weighted:
                g["w"] = ex._put(w, grp, E)
            if mode == "blocked":
                Hc = sc.halo_cap
                Eq = sc.edges_per_owner
                g["blk_src"] = ex._put(sc.blk_src_loc, grp, Eq, Np, index=True)
                g["blk_bin_seg"] = ex._put(sc.blk_bin_seg, grp, Eq, S * Hc + 1, index=True)
                g["blk_valid"] = ex._put(sc.blk_valid, grp, Eq)
                if weighted:
                    g["blk_w"] = ex._put(sc.blk_weight, grp, Eq)
            else:
                g["send_idx"] = ex._put(sc.send_idx, grp, S, Np, index=True)
                if track:
                    g["src_glob"] = ex._put(sc.ftr_src_glob, grp, T, index=True)
            out.append(g)
        self._gargs_cache[key] = out
        return out

    # ------------------------------------------------------------------ plan
    def _plan_body(self, sc, g, value, mask, mode, has_w, Sg):
        """One group's plan: (message table [Sg*T], the four counts)."""
        S, Np, T = sc.num_shards, sc.shard_size, g["T"]
        outgoing = torch.where(mask, value, INF)
        if mode == "blocked":
            Hc = sc.halo_cap
            msgs = torch.index_select(outgoing, 0, g["blk_src"])
            if has_w:
                # the edge weight folds into the merged candidate; the
                # receiver's bin edge carries weight 0
                msgs = msgs + g["blk_w"]
            msgs = torch.where(g["blk_valid"] > 0, msgs, INF)
            bins = kernels.segment_combine(Combiner.MIN, msgs, g["blk_bin_seg"], Sg * (S * Hc + 1))
            bins = bins.reshape(Sg, S * Hc + 1)[:, : S * Hc].reshape(Sg, S, Hc)
            recv = yield ("all_to_all", bins)
            width = S * Hc
        else:
            B = sc.boundary_width
            sends = kernels.flat_take(outgoing, g["send_idx"]).reshape(Sg, S, B)
            recv = yield ("all_to_all", sends)
            width = S * B
        tab = torch.cat([outgoing.reshape(Sg, Np), recv.reshape(Sg, width)], 1)
        fresh = tab < INF
        count = fresh.sum(1)
        edges = torch.where(fresh, g["deg"].reshape(Sg, T), 0).sum(1)
        cmax = yield ("reduce", "max", count)
        emax = yield ("reduce", "max", edges)
        csum = yield ("reduce", "sum", count)
        esum = yield ("reduce", "sum", edges)
        return tab.reshape(-1), torch.stack([cmax, emax, csum, esum])

    # ------------------------------------------------------------------ step
    @staticmethod
    def _step(sc, g, value, pred, tab, t, F_cap, E_cap, weighted, track, has_w, Sg):
        """One group's hop at tier (F_cap, E_cap)."""
        Np, T = sc.shard_size, g["T"]
        dev = value.device
        fresh = (tab < INF).reshape(Sg, T)
        idx = _compact_rows(fresh, F_cap, T)
        slot_base = torch.arange(Sg, dtype=torch.int64, device=dev)[:, None]
        rows = (idx + slot_base * (T + 2)).reshape(-1)
        own, pos, nbr, valid = capped_expand(rows, g["ip"], g["dst"], Sg * E_cap, Sg * Np)
        safe = (torch.clamp(idx, 0, T - 1) + slot_base * T).reshape(-1)
        if weighted:
            msg = torch.index_select(tab, 0, safe)[own]
            if has_w:
                msg = msg + g["w"][pos]
        elif track:
            msg = torch.index_select(g["src_glob"], 0, safe).to(torch.float32)[own]
        else:
            msg = torch.zeros(Sg * E_cap, dtype=torch.float32, device=dev)
        msg = torch.where(valid, msg, INF)
        tmp = torch.full((Sg * Np + 1,), INF, dtype=torch.float32, device=dev)
        tmp = tmp.scatter_reduce_(0, nbr, msg, "amin", include_self=True)[: Sg * Np]
        if weighted:
            new = torch.minimum(value, tmp)
            return new, pred, new < value
        changed = (value >= INF) & (tmp < INF)
        new = torch.where(changed, float(t) + 1.0, value)
        if track:
            pred = torch.where(changed, tmp, pred)
        return new, pred, changed

    # ------------------------------------------------------------- host loop
    def _hop_loop(self, sc, view_key, values, preds, masks, weighted, track, max_iterations,
                  use_weights=None, fault_hook=None):
        """``use_weights`` decouples value messages (weighted=True) from
        the edge weight: CC propagates labels as value messages and must
        never add a weight. ``fault_hook`` is consulted once per hop; a
        frontier run carries no checkpoint, so a preemption restarts it."""
        has_w = (weighted if use_weights is None else use_weights) and sc.has_weight
        mode = self._mode(track)
        gargs = self._gargs(sc, view_key, has_w, track, mode)
        T, E = gargs[0]["T"], gargs[0]["E"]
        exchange_elems = sc.num_shards * (sc.halo_cap if mode == "blocked" else sc.boundary_width)
        trace = []
        groups = self.mesh.local_groups
        for t in range(max_iterations):
            if fault_hook is not None:
                fault_hook(t)
            tr0 = dict(self.mesh.transport)
            plans = lockstep(self.mesh, [
                self._plan_body(sc, g, v, m, mode, has_w, grp.size)
                for g, v, m, grp in zip(gargs, values, masks, groups)
            ])
            cmax, emax, csum, esum = (int(x) for x in plans[0][1].tolist())
            if csum == 0:
                break
            f_cap = _tier(max(cmax, 1), self.F_MIN, T, self.GROWTH)
            e_cap = _tier(max(emax, 1), self.E_MIN, E, self.GROWTH)
            trace.append({
                "hop": t, "frontier": csum, "edges": esum,
                "shard_max_frontier": cmax, "shard_max_edges": emax,
                "F_cap": f_cap, "E_cap": e_cap,
                "exchange": mode, "exchange_elems": exchange_elems,
            })
            self.ex._stamp_transport(trace[-1:], tr0, 1)
            for i, grp in enumerate(groups):
                values[i], preds[i], masks[i] = self._step(
                    sc, gargs[i], values[i], preds[i], plans[i][0], t, f_cap, e_cap,
                    weighted, track, has_w, grp.size,
                )
        self.last_trace = trace
        return values, preds

    def _split(self, arr: np.ndarray, sc) -> list:
        Np = sc.shard_size
        return [
            torch.as_tensor(arr[g.lo * Np : g.hi * Np], device=g.device)
            for g in self.mesh.local_groups
        ]

    def _join(self, parts, sc) -> np.ndarray:
        """The whole vector, every process's rows included."""
        return self.mesh.gather_rows(parts).numpy()[: sc.real_n]

    # ---------------------------------------------------------------- entry
    def run(self, program, fault_hook=None) -> Dict[str, np.ndarray]:
        """SSSP/BFS (ShortestPathProgram) through the sharded hop loop."""
        sc = self.ex._sharded(program.undirected)
        track = program.track_paths
        idx0 = np.arange(sc.padded_n, dtype=np.int64)
        is_seed = idx0 == program.seed_index
        values = self._split(np.where(is_seed, 0.0, INF).astype(np.float32), sc)
        preds = [None] * len(values)
        if track:
            preds = self._split(
                np.where(is_seed, float(program.seed_index), -1.0).astype(np.float32), sc
            )
        masks = self._split(is_seed, sc)
        values, preds = self._hop_loop(
            sc, program.undirected, values, preds, masks, program.weighted, track,
            program.max_iterations, fault_hook=fault_hook,
        )
        out = {"distance": self._join(values, sc)}
        if track:
            out["predecessor"] = self._join(preds, sc)
        return out

    def run_cc(self, program, fault_hook=None) -> Dict[str, np.ndarray]:
        """Frontier connected components: min-label propagation with a
        changed-vertex frontier, value messages through the weighted step
        with NO weight arrays (a label must never absorb an edge weight)."""
        sc = self.ex._sharded(True)  # the symmetric closure
        labels = self._split(np.arange(sc.padded_n, dtype=np.float32), sc)
        masks = self._split(sc.active > 0, sc)
        labels, _ = self._hop_loop(
            sc, True, labels, [None] * len(labels), masks, True, False,
            program.max_iterations, use_weights=False, fault_hook=fault_hook,
        )
        return {"component": self._join(labels, sc)}
