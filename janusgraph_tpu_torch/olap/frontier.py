"""Frontier-compacted SSSP/BFS/CC supersteps (push-style, capped
expansion) — the port of ``janusgraph_tpu/olap/frontier.py``.

A dense superstep gathers every edge even when the BFS frontier is a
handful of vertices. Here each hop:

  1. compacts the active frontier into an index buffer of F_cap slots
     (padded with the sentinel n),
  2. expands it into an edge buffer of E_cap slots by scatter + cumsum
     "pointer spreading" (no binary search),
  3. gathers only the frontier's neighbors (E_frontier elements, not E),
  4. scatter-mins the relaxed values into the state.

Tiers: (F_cap, E_cap) come from the autotuner's pow2 ladders
(``olap/autotune.decide_tiers``), or with ``autotune=False`` grow in powers
of ``GROWTH`` from (F_MIN, E_MIN); either way up to (n, m), and the top
tier is a full-edge pass, so nothing is ever dropped.
Per-step results are bit-identical to the dense path: relaxing a
non-frontier edge is a no-op (its source has not changed since it was last
relaxed), and min does not depend on order.

Plain torch on the executor's device. Where JAX clamps an out-of-range
gather and drops an out-of-range scatter (``mode="drop"``), torch raises
(or, on CUDA, asserts on the device), so every scatter here routes the
indices JAX would drop into one extra slot that is cut off afterwards, and
every gather clamps explicitly where JAX would have clamped. The result is
equal to the reference's arrays in every slot, valid or not. Indices are
int64 (what torch's scatters take); their values equal the reference's
int32 values below ``MAX_EDGES``.

One device->host round trip per hop: the plan's three scalars. The
compaction needs no second one, since it writes through a cumsum of the
mask instead of calling ``nonzero``.
"""

from __future__ import annotations

import time
from typing import Dict

import numpy as np
import torch

from janusgraph_tpu_torch.olap.autotune import pick_tier
from janusgraph_tpu_torch.olap.vertex_program import INF


def _tier(need: int, lo: int, hi: int, growth: int = 4) -> int:
    """Smallest ``growth``-power multiple of ``lo``, >= need, clamped to hi
    (callers guarantee hi >= need)."""
    if growth < 2:
        raise ValueError(f"frontier tier growth must be >= 2 (got {growth})")
    c = lo
    while c < need:
        c *= growth
    return min(c, hi)


def compact(mask: torch.Tensor, F_cap: int, fill: int) -> torch.Tensor:
    """Indices of ``mask``'s true entries in ascending order, padded with
    ``fill`` to F_cap slots (``jnp.nonzero(mask, size=F_cap,
    fill_value=fill)``). Entries past F_cap are dropped, like the
    reference's. int64, no host sync."""
    n = mask.shape[0]
    slot = torch.cumsum(mask, 0) - 1
    # unset entries and those past the buffer go to the extra last slot
    slot = torch.where(mask & (slot < F_cap), slot, F_cap)
    out = torch.full((F_cap + 1,), fill, dtype=torch.int64, device=mask.device)
    out.scatter_(0, slot, torch.arange(n, device=mask.device))
    return out[:F_cap]


def _scatter_add_drop(E_cap: int, index: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """``zeros(E_cap).at[index].add(values, mode="drop")`` for indices in
    [0, E_cap]: index E_cap lands in an extra slot that is cut off."""
    out = torch.zeros(E_cap + 1, dtype=values.dtype, device=values.device)
    out.index_add_(0, index, values)
    return out[:E_cap]


def capped_expand(idx, indptr, dst, E_cap: int, sentinel: int):
    """Capped frontier expansion: frontier rows -> (owner slot, edge pos,
    neighbor, valid) buffers of length E_cap.

    ``idx``: (F_cap,) int64 row indices, padded with a row whose degree is 0
    (the n+2-padded ``indptr`` gives the sentinel row n degree 0). own/pos
    come from scatter + cumsum over the frontier-sized start offsets: a
    deg-0 row collapses onto the next row's start, the scatter-adds
    accumulate, and the cumsum lands on the last row covering a slot. Rows
    starting at E_cap (deg-0 rows at the end when total == E_cap) are
    dropped, as the reference's ``mode="drop"`` drops them."""
    F_cap = idx.shape[0]
    starts = indptr[idx]
    degs = indptr[idx + 1] - starts
    cum = torch.cumsum(degs, 0)
    total = cum[-1]
    cum_ex = cum - degs
    # cum_ex >= 0; every start at or past E_cap is one the reference drops
    at = torch.clamp_max(cum_ex, E_cap)
    inc = torch.ones(F_cap, dtype=torch.int64, device=idx.device)
    inc[0] = 0
    own = torch.cumsum(_scatter_add_drop(E_cap, at, inc), 0)
    # pos[s] = s + (starts - cum_ex)[own[s]], encoded the same way
    base = starts - cum_ex
    dbase = torch.cat([base[:1], torch.diff(base)])
    slots = torch.arange(E_cap, dtype=torch.int64, device=idx.device)
    pos = slots + torch.cumsum(_scatter_add_drop(E_cap, at, dbase), 0)
    valid = slots < total
    pos = torch.clamp(pos, 0, dst.shape[0] - 1)
    nbr = torch.where(valid, dst[pos].long(), sentinel)
    return own, pos, nbr, valid


class FrontierEngine:
    """Per-executor engine: owns the device-resident CSR pointer arrays of
    the ShortestPath / ConnectedComponents frontier runs. A hop is
    ``plan`` -> ``tiers`` -> ``step``; the parts are public so a profiler
    can time them one by one."""

    F_MIN = 1 << 10
    E_MIN = 1 << 13
    GROWTH = 4
    #: index headroom the reference's int32 telescoping cumsum needs; kept
    #: so both packages route the same graphs the same way
    MAX_EDGES = 1 << 30

    def __init__(self, executor, f_schedule=None, e_schedule=None):
        self.ex = executor
        self.device = executor.device
        # the static ladder's floors and growth (computer.frontier-f-min,
        # -e-min, -tier-growth), where the executor sets them
        self.F_MIN = getattr(executor, "_frontier_f_min", None) or self.F_MIN
        self.E_MIN = getattr(executor, "_frontier_e_min", None) or self.E_MIN
        self.GROWTH = getattr(executor, "_frontier_tier_growth", None) or self.GROWTH
        # the tier ladders (olap/autotune.decide_tiers; the executor passes
        # its directed view's, since frontier programs are scalar-message
        # in-CSR runs); None prices every hop on the static ladder above
        self.f_schedule = f_schedule
        self.e_schedule = e_schedule
        csr = executor.csr
        self.n = csr.num_vertices
        self.m = csr.num_edges
        if self.m >= self.MAX_EDGES:
            raise ValueError("frontier engine requires < 2^30 edges")
        self._fargs_cache: Dict[str, Dict[str, torch.Tensor]] = {}
        self.last_trace = []
        #: host clock after each plan fetch (and after the result fetch),
        #: for per-hop walls
        self.last_marks = []

    def _orientation_args(self, prefix: str):
        """Device arrays of one orientation, built on first use: dst/src
        reuse the executor's lazy device copies; the pointer and degree
        vectors are O(n)."""
        csr, g = self.ex.csr, self.ex.g
        args = self._fargs_cache.get(prefix)
        if args is None:
            if prefix == "out":
                indptr, edges = csr.out_indptr, g.out_dst
            else:
                indptr, edges = csr.in_indptr, g.in_src
            args = {
                # indptr padded to n+2: the sentinel row (idx n) has deg 0
                f"{prefix}_ip": torch.as_tensor(
                    np.concatenate([indptr, indptr[-1:]]).astype(np.int64),
                    device=self.device,
                ),
                "out_dst" if prefix == "out" else "in_src": edges,
                f"{prefix}_deg": torch.as_tensor(
                    np.diff(indptr).astype(np.int64), device=self.device
                ),
            }
            self._fargs_cache[prefix] = args
        return args

    def fargs(self, undirected: bool, weighted: bool):
        """The device arrays a step reads for one program's view."""
        g = self.ex.g
        args = dict(self._orientation_args("out"))
        if undirected:
            args.update(self._orientation_args("in"))
        if weighted:
            if g.out_edge_weight is not None:
                args["out_w"] = g.out_edge_weight
            if undirected and g.in_edge_weight is not None:
                args["in_w"] = g.in_edge_weight
        return args

    # ------------------------------------------------------------------ plan
    @staticmethod
    def plan(mask, fargs, undirected: bool):
        """(frontier count, out-edge total, in-edge total) as host ints: O(n)
        vector work and the hop's one device->host fetch."""
        count = torch.sum(mask)
        tot_out = torch.sum(torch.where(mask, fargs["out_deg"], 0))
        tot_in = (
            torch.sum(torch.where(mask, fargs["in_deg"], 0))
            if undirected else torch.zeros_like(tot_out)
        )
        return [int(x) for x in torch.stack([count, tot_out, tot_in]).tolist()]

    @property
    def tier_source(self) -> str:
        return "autotune" if self.e_schedule else "static"

    def tiers(self, count: int, edges: int):
        """(F_cap, E_cap) of a hop with ``count`` frontier rows and at most
        ``edges`` edges in one orientation, on the tuned ladders where the
        engine has them, else on the static ladder."""
        if self.f_schedule and self.e_schedule:
            return (
                pick_tier(count, self.f_schedule, self.n),
                pick_tier(max(edges, 1), self.e_schedule, self.m),
            )
        return (
            _tier(count, self.F_MIN, self.n, self.GROWTH),
            _tier(max(edges, 1), self.E_MIN, self.m, self.GROWTH),
        )

    # ------------------------------------------------------------------ step
    def relax(self, tmp, dist, idx, indptr, dst, w, E_cap, weighted, track_paths):
        """One orientation: scatter-min each frontier edge's message into
        ``tmp`` ((n+1,), row n the sentinel)."""
        n = self.n
        own, pos, nbr, valid = capped_expand(idx, indptr, dst, E_cap, n)
        if weighted:
            # message = sender value (+ edge weight where present); invalid
            # slots target the sentinel row and are masked as well
            dist_f = dist[torch.clamp(idx, 0, n - 1)]
            msg = dist_f[own]
            if w is not None:
                msg = msg + w[pos]
        elif track_paths:
            # message = sender's index; MIN-combining yields the
            # smallest-index frontier predecessor, as the dense program
            msg = idx.to(torch.float32)[own]
        else:
            # unweighted: any finite marker means "reached this hop"
            msg = torch.zeros(E_cap, dtype=torch.float32, device=idx.device)
        msg = torch.where(valid, msg, INF)
        return tmp.scatter_reduce_(0, nbr, msg, "amin", include_self=True)

    def step(self, dist, pred, mask, t: int, fargs, F_cap, E_cap, weighted, track_paths, undirected):
        """One hop at tier (F_cap, E_cap): (new value, new pred, new mask)."""
        n = self.n
        idx = compact(mask, F_cap, n)
        tmp = torch.full((n + 1,), INF, dtype=torch.float32, device=dist.device)
        tmp = self.relax(
            tmp, dist, idx, fargs["out_ip"], fargs["out_dst"],
            fargs.get("out_w") if weighted else None, E_cap, weighted, track_paths,
        )
        if undirected:
            tmp = self.relax(
                tmp, dist, idx, fargs["in_ip"], fargs["in_src"],
                fargs.get("in_w") if weighted else None, E_cap, weighted, track_paths,
            )
        tmp = tmp[:n]
        if weighted:
            new = torch.minimum(dist, tmp)
            return new, pred, new < dist
        newly = (dist >= INF) & (tmp < INF)
        new = torch.where(newly, float(t) + 1.0, dist)
        if track_paths:
            pred = torch.where(newly, tmp, pred)
        return new, pred, newly

    # ------------------------------------------------------------------- run
    def _hop_loop(self, value, pred, mask, weighted, track, und, fargs, max_iterations):
        """Plan (3 scalars) -> pick tier -> one step, per hop; per-step
        output is identical to the dense path's."""
        if self.m == 0:
            mask = torch.zeros_like(mask)
        trace = []
        marks = []
        for t in range(max_iterations):
            count, tot_out, tot_in = self.plan(mask, fargs, und)
            marks.append(time.perf_counter())
            if count == 0:
                break
            f_cap, e_cap = self.tiers(count, max(tot_out, tot_in))
            trace.append({
                "hop": t, "frontier": count, "edges": max(tot_out, tot_in),
                "F_cap": f_cap, "E_cap": e_cap, "tier_source": self.tier_source,
            })
            value, pred, mask = self.step(
                value, pred, mask, t, fargs, f_cap, e_cap, weighted, track, und
            )
        self.last_trace = trace
        self.last_marks = marks
        return value, pred

    def run(self, program) -> Dict[str, np.ndarray]:
        """SSSP/BFS through the hop loop."""
        n, dev = self.n, self.device
        is_seed = torch.arange(n, device=dev) == program.seed_index
        inf = torch.full((n,), INF, dtype=torch.float32, device=dev)
        dist = torch.where(is_seed, torch.zeros_like(inf), inf)
        pred = None
        if program.track_paths:
            seed = torch.full_like(inf, float(program.seed_index))
            pred = torch.where(is_seed, seed, torch.full_like(inf, -1.0))
        dist, pred = self._hop_loop(
            dist, pred, is_seed, program.weighted, program.track_paths,
            program.undirected, self.fargs(program.undirected, program.weighted),
            program.max_iterations,
        )
        out = {"distance": dist.cpu().numpy()}
        if program.track_paths:
            out["predecessor"] = pred.cpu().numpy()
        self.last_marks.append(time.perf_counter())
        return out

    def run_cc(self, program) -> Dict[str, np.ndarray]:
        """Frontier connected components: min-label propagation with a
        changed-vertex frontier, through the weighted-relaxation step with
        no weight arrays (a label must never absorb an edge weight). Labels
        ride float32, exact below 2^24 vertices (the executor guards it)."""
        dev = self.device
        labels = torch.arange(self.n, dtype=torch.float32, device=dev)
        mask = torch.ones(self.n, dtype=torch.bool, device=dev)
        labels, _ = self._hop_loop(
            labels, None, mask, True, False, True,
            self.fargs(True, False), program.max_iterations,
        )
        out = {"component": labels.cpu().numpy()}
        self.last_marks.append(time.perf_counter())
        return out
