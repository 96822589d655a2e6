#!/usr/bin/env python3
"""Drive janusgraph_tpu_torch on a CUDA card and hold its kernels to their
plain versions.

    python3 chip_smoke.py [--scale 20] [--seed 1]

Phases, each printing one JSON line:
  device   the card (and its name and power limit from nvidia-smi)
  build    nvcc builds the kernels from csrc/ (sm_90a)
  kernel   sorted_segment_sum against sorted_segment_sum_plain on the card,
           at the plan shape of the graph500 R-MAT graph's in-CSR and on
           edge cases; bitwise repeat; kernel, plain and library times, each
           with the L2 flushed before every call (the kernel also back to
           back, ``kernel_ms_warm``, and after a flush that leaves the L2
           clean, ``kernel_ms_read_flush``)
  pagerank PageRank, 20 supersteps, tol=0, through run_on(strategy=
           "segsum") (the fused path): the card must run the kernel once a
           superstep, counted by the kernel's device counter; the host
           loop (fused=False) timed beside the plain-torch ELL strategy,
           which it must agree with
  profile  torch.profiler over one more host-loop PageRank run: device
           busy time against wall, and device time by kernel
  autotune the tuner's decisions for the directed and undirected views on
           this card (twice, equal), and the calibration behind its "gpu"
           constants: ELL, hybrid at two cutoffs and segment aggregates
  hybrid   hybrid_aggregate bitwise equal to ell_aggregate (SUM, MIN;
           scalar and [n, 64]), its pad ratio, buckets and time against
           ELL and the segsum kernel; PageRank under "hybrid" and "auto"
  fused    the fused loop (CUDA graphs): PageRank under segsum and ELL
           bitwise equal to the host loop, syncs, chunks, capture time,
           walls; fused_profile profiles one more run (20 kernel runs);
           CC against scipy; dense BFS against the frontier run; the 3-hop
           count (3 kernel runs)
  checkpoint  PageRank with checkpoints every 5 supersteps and one
           injected preemption at superstep 12, fused (preempted at the
           next span's start, nothing lost) and on the host loop (steps
           10 and 11 recomputed from the step-10 checkpoint): each
           auto-resumed run bitwise equal to the uninterrupted one
  cc       connected components against scipy: dense ELL (fused) under
           frontier="off" and "auto", and through the frontier engine
           ("always")
  bfs      ShortestPath from the out-degree hub, 4 hops, through the
           frontier engine on the tuned tier ladders: bitwise equal to the
           dense ELL run and to the static ladder's run, equal to scipy's
           BFS within 4 hops; bfs_4hop_wall_s (both ladders),
           pagerank_plus_bfs4_wall_s (host-loop PageRank + static ladder,
           as before the fused loop) and its fused + tuned counterpart;
           then bfs_profile over one more run
  frontier_parts  the frontier hop and its parts (plan, compaction,
           expansion, scatter-min) timed hop by hop against a bytes bound
  paths    track_paths BFS to convergence: predecessors equal the dense
           run's, 1,000 reconstructed paths are real edge chains
  khop     TraversalCount, 3 hops, segsum: one kernel run per hop, counts
           against ELL and the total against a float64 product
  peer_pressure  PeerPressure, 5 rounds, sync_every=5: segsum and segment
           strategies bitwise equal, wall and peak device memory; 2 rounds
           bitwise equal to a numpy count-and-resolve; the [E, 64] message
           gather timed against its bytes bound
  delta    the delta overlay at the reference bench's streaming shape (a
           burst of 0.5 % of the edges, seeded tombstones, lanes capped at
           2^22 cells): the kernel against its plain version on the add
           and tombstone lanes' plans; PageRank fused over base + overlay,
           3 kernel runs a superstep, bitwise equal to the host loop and
           within a relative 1e-4 of the materialized CSR's; CC and a 4-hop hub BFS bitwise equal to the
           materialized CSR's (CC also to scipy's); a vertex overlay through
           compact_result; materialize and the trade against it; the
           "gpu" lane and materialize constants; a set_delta swap
  traversal  the OLAP traversal program at full scale: the bench's
           filtered 3-hop (score > 5 on step 2) under segsum (3 kernel
           runs on the channel's plan) against ELL (rtol 1e-4, bitwise
           below 2^24) and a float64 product; a typed chain over 4 hashed
           edge types (out [0, 1], in [2], both) and a label set that
           matches no edge against float64 products built from the hashed
           types directly (not through channel_edges); sack sum
           and mult (the [n, k] SUM path) bitwise on repeat and against
           float64; the kernel on every channel plan against its plain
           version; the bench's seeded 3-hop paths (real edge chains);
           DegreeCountProgram (1 kernel run, the CSR's degrees); the
           MapReduce jobs over CC and PageRank; the Fulgora analogue's
           edges/s beside the fused PageRank's
  dense    GCN (d = 32, 2 layers) and the attention GCN under ELL and
           hybrid, bitwise equal; GCN under the default segsum (ELL)
           bitwise equal to a repeat, its host loop and ELL; the
           embedding update ELL against hybrid; scale 12 on the card
           bitwise equal to the CPU; tree_matmul against torch.matmul,
           tree_dot and the sddmm aggregates against their bounds
  ldbc     the LDBC SNB SF1-sized proxy (3.2M vertices, 17.3M edges): CC
           against scipy, the bench's filtered 3-hop (creation_day > 1825)
           held as at scale 20; the host build time
Each phase that drives a path zeroes the kernel launch counts just before
it and reads them just after. The wrapper counts its eager launches; the
fix-up kernel adds one to a device counter at every run, eager or replayed
from a CUDA graph, which is the count the checks hold (the calls each
replayed graph captured are the cross-check). Then the ``kernels`` line,
and last ``{"ok": true, "device": ...}``.
Exits non-zero, without the last line, if there is no CUDA card or any
check fails.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np

#: H100 SXM published peaks (NVIDIA data sheet): HBM3 bytes/s, fp32 FLOP/s
#: outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOPS = 67e12
TOL = dict(rtol=1e-4, atol=1e-4)
#: the most relative difference two float32 PageRank runs that sum in other
#: orders may show (ranks are positive: every vertex keeps its teleport share)
RANK_REL = 1e-4


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls: inputs
    that fit the 50 MB L2 may stay there between calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def replay_ms(fn, iters: int = 20) -> float:
    """Mean device time of ``fn`` captured once into a CUDA graph and
    replayed back to back: what a superstep of the fused loop pays for it,
    without the host's launch overhead."""
    import torch

    import gc

    fn()  # everything ``fn`` reads moves to the card before the capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    gc.disable()  # a graph freed by the collector mid-capture would void it
    try:
        with torch.cuda.graph(graph):
            fn()
    finally:
        gc.enable()
    return cuda_ms(graph.replay, iters)


_FLUSH = []


def flushed_ms(fn, iters: int = 25, warmup: int = 2, by_reading: bool = False) -> float:
    """Median device time of one call of ``fn``, each call preceded by
    zeroing a 256 MB buffer, which evicts its inputs from the 50 MB L2 and
    leaves it full of dirty lines that ``fn`` then writes back; with
    ``by_reading`` the buffer is summed instead, which leaves clean lines.
    CUDA events bracket ``fn`` alone."""
    import torch

    if not _FLUSH:
        _FLUSH.append(torch.zeros(256 << 20, dtype=torch.uint8, device="cuda"))
    for _ in range(warmup):
        fn()
    pairs = []
    for _ in range(iters):
        if by_reading:
            _FLUSH[0].sum()
        else:
            _FLUSH[0].zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in pairs]))


def check_kernel_case(name, seg, num_segments, data, kernels, **plan_kw):
    """Kernel vs plain on the card at TOL, plus a bitwise repeat."""
    return check_plan(name, kernels.make_segsum_plan(seg, num_segments, **plan_kw), data, kernels)


def check_plan(name, plan, data, kernels):
    """``check_kernel_case`` on a plan already made."""
    import torch

    num_segments = plan.num_segments
    got = kernels.sorted_segment_sum(data, plan)
    again = kernels.sorted_segment_sum(data, plan)
    want = kernels.sorted_segment_sum_plain(data, plan)
    torch.cuda.synchronize()
    if got.shape != (num_segments,) or not torch.isfinite(got).all():
        raise RuntimeError(f"kernel case {name}: bad output {tuple(got.shape)}")
    if not torch.equal(got.view(torch.int32), again.view(torch.int32)):
        raise RuntimeError(f"kernel case {name}: two launches differ")
    err = (got - want).abs()
    if not torch.allclose(got, want, **TOL):
        raise RuntimeError(f"kernel case {name}: max abs err {err.max().item()}")
    return plan, got, float(err.max().item()) if err.numel() else 0.0


def counted(fn, expect: int):
    """Run ``fn`` and count the sorted-segment-sum runs on the card by the
    kernel's device counter (``kernels.device_launches``), which sees the
    runs replayed from CUDA graphs as well as the eager ones; the count
    must be ``expect``. Returns (fn()'s result, the count)."""
    import torch

    from janusgraph_tpu_torch.olap import kernels

    before = kernels.device_launches("cuda")
    out = fn()
    torch.cuda.synchronize()
    ran = kernels.device_launches("cuda") - before
    if ran != expect:
        raise RuntimeError(f"the kernel counted {ran} runs, expected {expect}")
    return out, ran


def profile_run(ex, program, emit, phase: str = "profile", **run_kw) -> int:
    """One more run under torch.profiler. Every figure comes from this one
    run: device busy time (the sum of kernel and copy time on the card)
    against the run's own wall and against the span from its first device
    event to its last, the device-to-host copies (each one a host sync),
    the segment-sum runs the card did (the kernel's device counter,
    returned), and the top entries by device time. The profiler slows the host, so the idle shares are upper
    bounds; a negative share is measurement error and is printed as it is."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from janusgraph_tpu_torch.olap import kernels

    before = kernels.device_launches("cuda")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        ex.run(program, **run_kw)
        torch.cuda.synchronize()
    runs = kernels.device_launches("cuda") - before
    device_events = [
        e for e in prof.key_averages()
        if e.device_type == torch.autograd.DeviceType.CUDA
    ]
    busy_us = sum(e.self_device_time_total for e in device_events)
    if busy_us <= 0:
        raise RuntimeError("the profiler recorded no device time")
    ranges = [
        e.time_range for e in prof.events()
        if e.device_type == torch.autograd.DeviceType.CUDA
    ]
    span_us = max(r.end for r in ranges) - min(r.start for r in ranges)
    wall_us = ex.last_run_info["wall_s"] * 1e6
    top = sorted(device_events, key=lambda e: -e.self_device_time_total)[:8]
    dtoh = sum(e.count for e in device_events if "DtoH" in e.key)
    emit(phase, wall_ms=wall_us / 1e3, device_busy_ms=busy_us / 1e3,
         device_span_ms=span_us / 1e3,
         device_idle_share=1.0 - busy_us / wall_us,
         device_idle_share_of_span=1.0 - busy_us / span_us,
         supersteps=ex.last_run_info["supersteps"], dtoh_copies=dtoh,
         segsum_kernel_runs=runs,
         by_device_time=[{"name": e.key[:60], "calls": e.count,
                          "device_ms": e.self_device_time_total / 1e3} for e in top])
    return runs


def frontier_parts(ex, seed: int, emit, hops: int = 4) -> None:
    """Replay the 4-hop BFS hop by hop through the engine's public parts
    and time each part on the card (CUDA events, back to back): the
    compaction of the mask, the capped expansion, the relaxation (expansion
    + message + scatter-min), and the whole step; the plan, which ends in
    the hop's one device->host fetch, on the host clock. Each bound counts
    the bytes the part must move at this hop (inputs read once, outputs
    written once) at the card's memory rate."""
    import torch
    from janusgraph_tpu_torch.olap.frontier import capped_expand, compact
    from janusgraph_tpu_torch.olap.vertex_program import INF

    eng = ex.frontier_engine()
    n = eng.n
    fargs = eng.fargs(False, False)
    ip, dst = fargs["out_ip"], fargs["out_dst"]
    is_seed = torch.arange(n, device="cuda") == seed
    dist = torch.where(is_seed, 0.0, torch.full((n,), INF, device="cuda"))
    mask = is_seed
    tmp = torch.full((n + 1,), INF, dtype=torch.float32, device="cuda")
    rows = []
    for t in range(hops):
        count, edges, _ = eng.plan(mask, fargs, False)
        if count == 0:
            break
        f_cap, e_cap = eng.tiers(count, edges)
        h0 = time.perf_counter()
        for _ in range(20):
            eng.plan(mask, fargs, False)
        plan_ms = (time.perf_counter() - h0) / 20 * 1e3
        idx = compact(mask, f_cap, n)
        step = lambda: eng.step(dist, None, mask, t, fargs, f_cap, e_cap, False, False, False)  # noqa: E731
        ms = {
            "compact_ms": cuda_ms(lambda: compact(mask, f_cap, n), 20),
            "expand_ms": cuda_ms(lambda: capped_expand(idx, ip, dst, e_cap, n), 20),
            "relax_ms": cuda_ms(
                lambda: eng.relax(tmp, dist, idx, ip, dst, None, e_cap, False, False), 20
            ),
            "step_ms": cuda_ms(step, 20),
        }
        # int64 offsets and indices (8 B), int32 destinations, a 1-byte mask
        need = {
            "plan": n + 8 * n,                          # mask, degrees
            "compact": n + 8 * f_cap,                   # mask; indices out
            "expand": 8 * f_cap + 16 * count + 4 * edges + 25 * e_cap,
            "relax": 8 * f_cap + 16 * count + 4 * edges + 4 * (n + 1),
            # mask + distances in, the frontier rows' offsets and their
            # edges' destinations, distances + mask out
            "step": (n + 4 * n) * 2 + 16 * count + 4 * edges,
        }
        rows.append({
            "hop": t, "frontier": count, "edges": edges, "F_cap": f_cap, "E_cap": e_cap,
            "plan_host_ms": plan_ms, **ms,
            **{f"{k}_bound_ms": b / PEAK_BYTES_PER_S * 1e3 for k, b in need.items()},
        })
        dist, _, mask = step()
    torch.cuda.synchronize()
    emit("frontier_parts", hops=rows)


def peer_pressure_numpy(csr, rounds: int, K: int = 64) -> np.ndarray:
    """PeerPressure labels after ``rounds`` rounds, in numpy: each edge
    carries a message both ways; a vertex counts its neighbours' label
    buckets (label mod K), takes the fullest bucket (the lowest on a tie),
    then adopts the smallest neighbour label in that bucket; a vertex with
    no neighbours keeps its label."""
    n = csr.num_vertices
    src = np.repeat(np.arange(n, dtype=np.int64), np.diff(csr.out_indptr))
    dst = csr.out_dst.astype(np.int64)
    send, recv = np.concatenate([src, dst]), np.concatenate([dst, src])
    labels = np.arange(n, dtype=np.int64)
    for _ in range(rounds):
        sent = labels[send]
        counts = np.bincount(recv * K + sent % K, minlength=n * K).reshape(n, K)
        chosen = np.argmax(counts, axis=1)
        hit = sent % K == chosen[recv]
        # smallest label per receiver: sort (receiver, label) keys, take
        # each receiver's first
        keys = np.sort(recv[hit] * n + sent[hit])
        rows, first = np.unique(keys // n, return_index=True)
        labels = labels.copy()
        labels[rows] = keys[first] % n
    return labels.astype(np.float32)


def peer_pressure_phase(csr, seg_ex, args, emit) -> None:
    """PeerPressure, 5 rounds, sync_every=5, as the reference's bench runs
    it: the segsum and segment strategies must give the same labels bit for
    bit (counts are small integers, min has no order); wall and peak device
    memory of each; one superstep of each phase and the [E, 64] message
    gather timed alone; and a small graph on the card against the CPU."""
    import torch
    from janusgraph_tpu_torch.olap import GPUExecutor, kernels, rmat_csr, run_on
    from janusgraph_tpu_torch.olap.programs import PeerPressureProgram

    def pp():
        return PeerPressureProgram(rounds=5)

    n, m = csr.num_vertices, csr.num_edges
    runs = {}
    for strategy in ("segsum", "segment"):
        ex = seg_ex if strategy == "segsum" else GPUExecutor(csr, strategy="segment")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        out = ex.run(pp(), sync_every=5)
        wall = time.perf_counter() - t0
        info = dict(ex.last_run_info)
        runs[strategy] = (out["cluster"], {
            "wall_s": wall, "run_wall_s": info["wall_s"], "supersteps": info["supersteps"],
            "strategy_resolved": info["strategy_resolved"],
            "max_memory_allocated": torch.cuda.max_memory_allocated(),
            "kernel_launches": kernels.launch_counts()["sorted_segment_sum"],
        })
    labels = runs["segsum"][0]
    if not np.array_equal(labels.view(np.int32), runs["segment"][0].view(np.int32)):
        raise RuntimeError("PeerPressure labels differ between segsum and segment")
    # the path as a user drives it, counted
    kernels.reset_launch_counts()
    via_run_on = run_on(csr, pp(), sync_every=5)["cluster"]
    run_on_launches = kernels.launch_counts()["sorted_segment_sum"]
    if not np.array_equal(labels.view(np.int32), via_run_on.view(np.int32)):
        raise RuntimeError("run_on's PeerPressure differs from the executor's")
    if labels.shape != (n,) or not np.all((labels >= 0) & (labels < n) & (labels == np.floor(labels))):
        raise RuntimeError("PeerPressure labels are not vertex indices")
    clusters = len(np.unique(labels))
    if not 1 <= clusters < n:
        raise RuntimeError(f"PeerPressure left {clusters} clusters of {n} vertices")
    # two rounds held against numpy, bit for bit
    t0 = time.perf_counter()
    want2 = peer_pressure_numpy(csr, rounds=2)
    numpy_s = time.perf_counter() - t0
    got2 = seg_ex.run(PeerPressureProgram(rounds=2), sync_every=2)["cluster"]
    if not np.array_equal(got2.view(np.int32), want2.view(np.int32)):
        bad = int(np.sum(got2 != want2))
        raise RuntimeError(f"PeerPressure, 2 rounds: {bad} labels differ from numpy's")

    # one superstep of each phase, and the count phase's per-edge gather
    prog = pp()
    state, _ = prog.setup(seg_ex.g)
    count_msg = prog.message(state, 0, seg_ex.g)
    label_msg = prog.message(state, 1, seg_ex.g)
    K = count_msg.shape[1]
    sum_ms = cuda_ms(lambda: seg_ex._aggregate(prog, "sum", count_msg), 3, warmup=1)
    min_ms = cuda_ms(lambda: seg_ex._aggregate(prog, "min", label_msg), 3, warmup=1)
    in_src = seg_ex.g.in_src
    gather_ms = cuda_ms(lambda: torch.index_select(count_msg, 0, in_src), 5, warmup=1)
    # indices and the [E, K] messages once each, the [n, K] table once
    gather_bytes = 4 * m + 4 * K * m + 4 * K * n
    del count_msg, label_msg, state

    small = rmat_csr(10, 16, seed=args.seed)
    on_card = run_on(small, pp(), sync_every=5)["cluster"]
    on_cpu = run_on(small, pp(), device="cpu", sync_every=5)["cluster"]
    if not np.array_equal(on_card.view(np.int32), on_cpu.view(np.int32)):
        raise RuntimeError("PeerPressure on the card differs from the CPU on a scale-10 graph")
    emit("peer_pressure", rounds=5, sync_every=5, clusters=clusters, buckets=K,
         **{s: r[1] for s, r in runs.items()}, run_on_kernel_launches=run_on_launches,
         sum_superstep_ms=sum_ms, min_superstep_ms=min_ms,
         gather_ms=gather_ms, gather_bytes=gather_bytes,
         gather_bound_ms=gather_bytes / PEAK_BYTES_PER_S * 1e3,
         small_graph_equal_to_cpu=True, two_rounds_equal_to_numpy=True,
         two_rounds_changed=int(np.sum(want2 != np.arange(n))), numpy_s=numpy_s)


def max_rel(a, b) -> float:
    """Largest |a - b| / |b| over positive ``b``, in float64."""
    b = np.asarray(b, dtype=np.float64)
    return float(np.max(np.abs(np.asarray(a, dtype=np.float64) - b) / b)) if b.size else 0.0


def bits_equal(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and a.dtype == b.dtype and np.array_equal(
        a.view(np.int32), b.view(np.int32)
    )


def gpu_constants(rows, seg_ms, n, edges) -> dict:
    """The tuner's "gpu" constants from one set of aggregate times: a
    non-negative least-squares fit of t = slots * gather + buckets * bucket
    + chunk_rows * chunk over the ELL and hybrid aggregates of ``rows``
    (each counted as the model counts it), then the segment penalty that
    makes the model give the measured segment aggregate. ``recipe`` is the
    plain reading beside it, over the directed rows: ELL's ms over its
    slots, the segment's ms per edge over that, and the first two hybrid
    packs solved for the rest (it charges ELL's launches twice, once per
    slot and once per bucket)."""
    from scipy.optimize import nnls

    a = np.array([[r["model_slots"], r["buckets"], r["chunk_rows"]] for r in rows], np.float64)
    t = np.array([r["ms"] for r in rows]) * 1e-3
    (gather, bucket, chunk), residual = nnls(a, t)
    seg_bytes = 8.0 * edges + 8.0 * n  # the model's bytes for one slot per edge
    penalty = (seg_ms * 1e-3 - bucket) / max(seg_bytes / PEAK_BYTES_PER_S, edges * gather)
    g0 = t[0] / a[0, 0]
    b0, c0 = np.linalg.solve(a[1:3, 1:], t[1:3] - a[1:3, 0] * g0)
    return {"gather_cost_s": float(gather), "bucket_overhead_s": float(bucket),
            "tail_chunk_cost_s": float(chunk), "segment_penalty": float(penalty),
            "fit_residual_s": float(residual),
            "model_ms": [float(x) * 1e3 for x in a @ np.array([gather, bucket, chunk])],
            "recipe": {"gather_cost_s": float(g0), "segment_penalty": seg_ms * 1e-3 / edges / g0,
                       "bucket_overhead_s": float(b0), "tail_chunk_cost_s": float(c0)}}


def autotune_phase(csr, kind, emit) -> dict:
    """The tuner on this card: decisions for both views (each twice), and
    the measurements its "gpu" constants come from: PageRank-shaped SUM
    aggregates of both views (ELL, and hybrid packs at several cutoffs; the
    segment aggregate, gather + index_add_, of the directed view), each
    captured into a CUDA graph and replayed, as the fused loop runs them
    (the constants in use come from these), and the directed ELL, segment
    and two hybrid packs eagerly, as the host loop runs them (printed
    beside); CUDA events, back to back."""
    import torch
    from janusgraph_tpu_torch.olap import autotune, kernels
    from janusgraph_tpu_torch.olap.gpu_executor import GPUExecutor

    decisions = {}
    for undirected in (False, True):
        stats = autotune.GraphStats.from_csr(csr, undirected=undirected)
        first, again = autotune.decide(stats, kind), autotune.decide(stats, kind)
        if first != again:
            raise RuntimeError("two autotune decisions on the same inputs differ")
        if autotune.device_class(kind) != "gpu":
            raise RuntimeError(f"{kind!r} is not priced as a GPU")
        decisions["undirected" if undirected else "directed"] = first.as_dict()
    n, m = csr.num_vertices, csr.num_edges
    ex = GPUExecutor(csr, strategy="ell")
    gen = torch.Generator(device="cuda").manual_seed(7)
    x = torch.rand(n, generator=gen, device="cuda")
    g = ex.g

    def seg_fn():
        return kernels.segment_combine(
            "sum", torch.index_select(x, 0, g.in_src), g.in_dst_seg, n)

    rows = {"replayed": [], "eager": []}
    for undirected, cutoffs in ((False, (16, 64, 1024)), (True, (8, 64))):
        stats = autotune.GraphStats.from_csr(csr, undirected=undirected)
        ell = ex._ell_pack(undirected)
        view = {"view": "undirected" if undirected else "directed"}
        row = dict(view, layout="ell", model_slots=stats.ell_slots, slots=ell.slots,
                   buckets=len(stats.degree_hist), chunk_rows=0)
        rows["replayed"].append(dict(row, ms=replay_ms(lambda: kernels.ell_aggregate(ell, x, "sum"))))
        if not undirected:
            rows["eager"].append(dict(row, ms=cuda_ms(lambda: kernels.ell_aggregate(ell, x, "sum"), 10)))
        by_cutoff = {c: rest for c, *rest in stats.hybrid_by_cutoff}
        src, dst, w = ex._edge_view(undirected)
        for cutoff in cutoffs:
            pack = kernels.HybridPack(src, dst, w, n, hub_cutoff=cutoff, tail_chunk=256).to("cuda")
            slots, _hubs, buckets, chunk_rows = by_cutoff[cutoff]
            row = dict(view, layout="hybrid", cutoff=cutoff, slots=pack.slots, model_slots=slots,
                       buckets=buckets + autotune.tail_buckets(stats.degree_hist, cutoff),
                       chunk_rows=chunk_rows, torso_buckets=len(pack.torso),
                       tail_buckets=len(pack.tail), pad_ratio=pack.pad_ratio)
            rows["replayed"].append(dict(row, ms=replay_ms(
                lambda: kernels.hybrid_aggregate(pack, x, "sum"), 10)))
            if not undirected and cutoff <= 64:
                rows["eager"].append(dict(row, ms=cuda_ms(
                    lambda: kernels.hybrid_aggregate(pack, x, "sum"), 5)))
            del pack
    seg = {"replayed": replay_ms(seg_fn), "eager": cuda_ms(seg_fn, 10)}
    constants = {mode: gpu_constants(rows[mode], seg[mode], n, m) for mode in rows}
    emit("autotune", decisions=decisions, gpu_constants=constants["replayed"],
         gpu_constants_eager=constants["eager"], edges=m, segment_ms=seg, rows=rows,
         in_use={"gather_cost_s": autotune._GATHER_COST_S["gpu"],
                 "segment_penalty": autotune._SEGMENT_PENALTY["gpu"],
                 "bucket_overhead_s": autotune._BUCKET_OVERHEAD_S["gpu"],
                 "tail_chunk_cost_s": autotune._TAIL_CHUNK_COST_S["gpu"]})
    return decisions


def hybrid_phase(csr, seg_ex, seg_rank, emit) -> None:
    """hybrid_aggregate against ell_aggregate on the card, bit for bit, for
    SUM and MIN, scalar and [n, 64] messages, at the tuner's layout; its
    time against ELL's and against the segsum path (gather + kernel), eager
    and replayed from a CUDA graph; then PageRank (fused, the second run)
    under "hybrid" and "auto" against the segsum ranks."""
    import torch
    from janusgraph_tpu_torch.olap import GPUExecutor, kernels
    from janusgraph_tpu_torch.olap.programs import ConnectedComponentsProgram, PageRankProgram

    n = csr.num_vertices
    ex = GPUExecutor(csr, strategy="hybrid")
    hyb = ex._hybrid_pack(False)
    ell = ex._ell_pack(False)
    gen = torch.Generator(device="cuda").manual_seed(11)
    checks = {}
    for shape in ((n,), (n, 64)):
        x = torch.rand(shape, generator=gen, device="cuda")
        for op in ("sum", "min"):
            a = kernels.ell_aggregate(ell, x, op)
            b = kernels.hybrid_aggregate(hyb, x, op)
            if not torch.equal(a.view(torch.int32), b.view(torch.int32)):
                raise RuntimeError(f"hybrid differs from ELL ({op}, {shape})")
            checks[f"{op}_{'x'.join(map(str, shape))}"] = True
        del x, a, b
    x = torch.rand(n, generator=gen, device="cuda")
    plan = seg_ex._segsum_plan("in")
    in_src = seg_ex.g.in_src
    fns = {
        "hybrid": lambda: kernels.hybrid_aggregate(hyb, x, "sum"),
        "ell": lambda: kernels.ell_aggregate(ell, x, "sum"),
        "segsum_path": lambda: kernels.sorted_segment_sum(torch.index_select(x, 0, in_src), plan),
    }
    times = {f"{k}_ms": cuda_ms(fn, 10) for k, fn in fns.items()}
    times.update({f"{k}_replayed_ms": replay_ms(fn) for k, fn in fns.items()})
    # what the SUM aggregate must move: each edge's source index, each
    # message and each sum once
    times["bound_ms"] = 4 * (csr.num_edges + 2 * n) / PEAK_BYTES_PER_S * 1e3
    runs = {}
    for strategy in ("hybrid", "auto"):
        rex = ex if strategy == "hybrid" else GPUExecutor(csr, strategy="auto")
        rex.run(PageRankProgram(max_iterations=20, tol=0.0))  # warm
        rank = rex.run(PageRankProgram(max_iterations=20, tol=0.0))["rank"]
        info = rex.last_run_info
        rel = float(np.max(np.abs(rank.astype(np.float64) - seg_rank) / np.abs(seg_rank)))
        if rel > 1e-4:
            raise RuntimeError(f"PageRank under {strategy!r}: max rel diff {rel} vs segsum")
        runs[strategy] = {"strategy_resolved": info["strategy_resolved"],
                          "wall_s": info["wall_s"], "path": info["path"],
                          "pad_ratio": info["pad_ratio"], "max_rel_diff_vs_segsum": rel}
    # CC: the undirected view's decision, against ELL (fused, second runs)
    cc = {}
    for strategy in ("auto", "ell"):
        cex = GPUExecutor(csr, strategy=strategy)
        want = cex.run(ConnectedComponentsProgram())["component"]
        got = cex.run(ConnectedComponentsProgram())["component"]
        cc[strategy] = {"wall_s": cex.last_run_info["wall_s"],
                        "strategy_resolved": cex.last_run_info["strategy_resolved"],
                        "decision": cex.last_run_info["autotune"]["strategy"]}
        cc[strategy + "_labels"] = got
        if not bits_equal(got, want):
            raise RuntimeError(f"two CC runs under {strategy!r} differ")
    if not bits_equal(cc.pop("auto_labels"), cc.pop("ell_labels")):
        raise RuntimeError("CC under 'auto' differs from ELL")
    runs["cc"] = cc
    emit("hybrid", bitwise_equal_to_ell=checks, pad_ratio=hyb.pad_ratio,
         ell_pad_ratio=ell.pad_ratio, hub_cutoff=hyb.hub_cutoff, tail_chunk=hyb.tail_chunk,
         torso_buckets=len(hyb.torso), tail_buckets=len(hyb.tail), **times,
         pagerank=runs)


def fused_phase(csr, seg_ex, ell_ex, host_ranks, adj, seed, emit) -> dict:
    """The fused loop on the card: PageRank (20 supersteps, tol 0) fused
    against the host loop under segsum and ELL, bitwise; CC against scipy;
    the dense 4-hop BFS against the frontier run; the 3-hop count."""
    import torch
    from scipy.sparse.csgraph import connected_components
    from janusgraph_tpu_torch.olap import kernels
    from janusgraph_tpu_torch.olap.programs import (
        ConnectedComponentsProgram,
        PageRankProgram,
        ShortestPathProgram,
        TraversalCountProgram,
    )

    def pagerank():
        return PageRankProgram(max_iterations=20, tol=0.0)

    n = csr.num_vertices
    out = {}
    for strategy, ex in (("segsum", seg_ex), ("ell", ell_ex)):
        kernels.reset_launch_counts()
        first = ex.run(pagerank())
        first_info = dict(ex.last_run_info)
        kernels.reset_launch_counts()
        rank = ex.run(pagerank())["rank"]
        info = dict(ex.last_run_info)
        launches = kernels.launch_counts()["sorted_segment_sum"]
        if info["path"] != "fused" or info["supersteps"] != 20:
            raise RuntimeError(f"fused PageRank ({strategy}): {info}")
        for got in (first["rank"], rank):
            if not bits_equal(got, host_ranks[strategy]):
                raise RuntimeError(f"fused PageRank differs from the host loop ({strategy})")
        # eager launches (the first run's eager superstep) plus the calls
        # its replayed graphs hold: a cross-check of the device count below
        expect = 20 if strategy == "segsum" else 0
        for run_info in (first_info, info):
            if run_info["kernel_launches"] + run_info["graph_kernel_launches"] != expect:
                raise RuntimeError(f"fused PageRank ({strategy}) launch counts: {run_info}")
        if launches != info["kernel_launches"]:
            raise RuntimeError(f"fused PageRank launched the kernel {launches} times eagerly")
        if info["predicated_steps"] != 0:
            raise RuntimeError(f"a bounded run discarded {info['predicated_steps']} supersteps")
        keep = ("wall_s", "chunks", "host_syncs", "predicated_steps", "capture_s",
                "kernel_launches", "graph_kernel_launches")
        out[strategy] = {**{k: info[k] for k in keep},
                         "superstep_ms": info["wall_s"] / 20 * 1e3,
                         "first_run": {k: first_info[k] for k in keep}}
    fused_runs = profile_run(seg_ex, pagerank(), emit, phase="fused_profile")
    if fused_runs != 20:
        raise RuntimeError(f"the profiled fused PageRank ran the kernel {fused_runs} times")
    out["segsum"]["kernel_runs"] = fused_runs
    # one captured chunk of 8 PageRank supersteps, replayed with its bound
    # at 0 so that every superstep is computed and discarded (the buffers
    # keep the last run's state)
    loop = next(lp for key, lp in seg_ex._fused_loops.items() if "PageRankProgram" in key[0][1])
    graph, captured = loop.graphs[8]
    loop.limit.fill_(0)
    chunk_ms = cuda_ms(graph.replay, 10)
    # per superstep: in_src once (4 B an edge); rank, out-degree, active,
    # the segment offsets and the new rank once (4 B a vertex each)
    chunk_bytes = 8 * (4 * csr.num_edges + 5 * 4 * n)
    out["chunk8"] = {"ms": chunk_ms, "kernel_launches_captured": captured,
                     "bytes": chunk_bytes, "bound_ms": chunk_bytes / PEAK_BYTES_PER_S * 1e3}

    ncomp, labels = connected_components(adj, directed=True, connection="weak")
    lowest = np.full(ncomp, n, dtype=np.int64)
    np.minimum.at(lowest, labels, np.arange(n))
    cc = {}
    for key, kw in (("fused", {}), ("fused_warm", {}), ("host_loop", {"fused": False})):
        comp = seg_ex.run(ConnectedComponentsProgram(), **kw)["component"]
        info = dict(seg_ex.last_run_info)
        if not np.array_equal(comp.astype(np.int64), lowest[labels]):
            raise RuntimeError(f"CC ({key}) differs from scipy's components")
        cc[key] = {k: info.get(k) for k in ("path", "supersteps", "wall_s", "chunks",
                                              "host_syncs", "predicated_steps")}
    if cc["fused"]["path"] != "fused" or cc["host_loop"]["path"] != "host-loop":
        raise RuntimeError(f"CC paths: {cc}")

    def bfs4():
        return ShortestPathProgram(seed_index=seed, max_iterations=4)

    frontier = seg_ex.run(bfs4())["distance"]
    dense = seg_ex.run(bfs4(), frontier="off")["distance"]
    bfs_info = dict(seg_ex.last_run_info)
    if bfs_info["path"] != "fused" or not bits_equal(dense, frontier):
        raise RuntimeError(f"dense fused BFS differs from the frontier run: {bfs_info}")

    host = seg_ex.run(TraversalCountProgram(hops=3), fused=False)["count"]
    counts, khop_runs = counted(lambda: seg_ex.run(TraversalCountProgram(hops=3))["count"], 3)
    khop = dict(seg_ex.last_run_info, kernel_runs=khop_runs)
    if (khop["path"] != "fused"
            or khop["kernel_launches"] + khop["graph_kernel_launches"] != 3
            or not bits_equal(counts, host)):
        raise RuntimeError(f"fused 3-hop count: {khop}")
    emit("fused", max_chunk=seg_ex.MAX_CHUNK, pagerank=out, cc=cc,
         dense_bfs={k: bfs_info[k] for k in ("wall_s", "supersteps", "chunks", "host_syncs",
                                              "predicated_steps")},
         khop={k: khop[k] for k in ("wall_s", "kernel_launches", "graph_kernel_launches",
                                    "kernel_runs", "chunks", "host_syncs")})
    return out


def checkpoint_phase(csr, want_rank, emit) -> None:
    """PageRank with a checkpoint every 5 supersteps and one injected
    preemption at superstep 12 or later, fused and on the host loop: each
    run resumes from its last checkpoint and must end bitwise equal to the
    uninterrupted run. The fused path consults the hook at span starts
    only, so it is preempted at 15, after that span's checkpoint, and
    recomputes nothing; the host loop is preempted at 12 and recomputes
    supersteps 10 and 11 from the step-10 checkpoint."""
    import os
    import tempfile

    from janusgraph_tpu_torch.exceptions import SuperstepPreempted
    from janusgraph_tpu_torch.olap import GPUExecutor
    from janusgraph_tpu_torch.olap.checkpoint import save_checkpoint
    from janusgraph_tpu_torch.olap.programs import PageRankProgram

    runs = {}
    with tempfile.TemporaryDirectory() as d:
        for name, fused, expect in (("fused", True, (15, 15)), ("host_loop", False, (12, 10))):
            fired = []

            def hook(step):
                if step >= 12 and not fired:
                    fired.append(step)
                    raise SuperstepPreempted(f"injected at superstep {step}")

            ex = GPUExecutor(csr, strategy="segsum")
            path = os.path.join(d, f"{name}.npz")
            rank = ex.run(PageRankProgram(max_iterations=20, tol=0.0), fused=fused,
                          checkpoint_path=path, checkpoint_every=5, fault_hook=hook)["rank"]
            info = dict(ex.last_run_info)
            steps = info.get("resume_steps") or [{}]
            got = (steps[0].get("preempted_at"), steps[0].get("from_step"))
            if not fired or info.get("resumes") != 1 or got != expect:
                raise RuntimeError(f"{name}: preempted/resumed at {got}, expected {expect}: {info}")
            if not bits_equal(rank, want_rank):
                raise RuntimeError(f"the resumed PageRank ({name}) differs from the uninterrupted run")
            runs[name] = {k: info.get(k) for k in ("path", "resumes", "resume_steps", "wall_s",
                                                    "run_wall_s", "host_syncs", "chunks")}
            runs[name]["recomputed_supersteps"] = got[0] - got[1]
            runs[name]["measured_record_written"] = os.path.exists(path + ".autotune.json")
        state = {"rank": rank}
        t0 = time.perf_counter()
        for _ in range(5):
            save_checkpoint(os.path.join(d, "save.npz"), state, {"delta": np.float32(0)}, 20)
        save_ms = (time.perf_counter() - t0) / 5 * 1e3
    emit("checkpoint", every=5, **runs, save_ms=save_ms, state_bytes=rank.nbytes,
         save_bound_ms=rank.nbytes / PEAK_BYTES_PER_S * 1e3, bitwise_equal=True)


def tier(n: int) -> int:
    """The overlay's pow2 lane tier of ``n`` cells (``delta.overlay_tier``)."""
    return 0 if n <= 0 else 1 << max(0, int(n) - 1).bit_length()


def pick_tombstones(csr, edges, burst: int, max_cells: int) -> tuple:
    """The largest power-of-two prefix of ``edges`` (edge positions in the
    out-CSR, in seeded order) whose overlay lanes fit ``max_cells`` in both
    orientations: every tombstone dirties its destination (and, for an
    undirected program, its source), and a dirty row re-aggregates all its
    surviving base edges through the live lane. Returns (count, directed
    live cells, undirected live cells)."""
    src = np.repeat(np.arange(csr.num_vertices), np.diff(csr.out_indptr))
    ind = np.diff(csr.in_indptr)
    both = ind + np.diff(csr.out_indptr)
    t = len(edges)
    while t:
        ts, td = src[edges[:t]], csr.out_dst[edges[:t]].astype(np.int64)
        live_d = int(ind[np.unique(td)].sum()) - t
        live_u = int(both[np.unique(np.concatenate([td, ts]))].sum()) - 2 * t
        cells = max(tier(burst) + tier(t) + tier(live_d),
                    tier(2 * burst) + tier(2 * t) + tier(live_u))
        if cells <= max_cells:
            return t, live_d, live_u
        t //= 2
    return 0, 0, 0


def delta_phase(csr, args, emit) -> dict:
    """The delta overlay at the reference bench's streaming shape: a burst
    of 0.5 % of the edges as uniform pairs, tombstones of existing edges,
    lanes capped at 2^22 cells. PageRank (20 supersteps, tol 0, segsum)
    over base + overlay: 3 segment-sum runs a superstep on the kernel's
    device counter (base, adds, tombstones), the fused loop bitwise equal
    to the host loop, the ranks within a relative ``RANK_REL`` of PageRank
    over the materialized CSR; the kernel against its plain version on the
    add and tombstone lanes' plans, with the cells they gather; CC
    (ELL) and a 4-hop hub BFS over the overlay bitwise equal to the
    materialized CSR's, CC equal to scipy's components; a vertex overlay
    (new vertices with edges, removed vertices with theirs) through
    compact_result against the materialized run by vertex id; the "gpu"
    lane and materialize constants and decide_delta's threshold; one
    set_delta swap and its recapture."""
    import torch
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import connected_components

    from janusgraph_tpu_torch.olap import GPUExecutor, autotune, kernels
    from janusgraph_tpu_torch.olap import delta as D
    from janusgraph_tpu_torch.olap.programs import (
        ConnectedComponentsProgram,
        PageRankProgram,
        ShortestPathProgram,
    )

    phase_t0 = time.perf_counter()
    n, m = csr.num_vertices, csr.num_edges
    rng = np.random.default_rng(args.seed + 5)
    max_cells = 1 << 22
    burst = m // 200  # 0.5 % of the edges (bench.py's streaming burst)
    zeros = np.zeros(burst, np.int64)
    a_src, a_dst = rng.integers(0, n, burst), rng.integers(0, n, burst)
    cand = rng.choice(m, 1 << 14, replace=False)
    t, live_d, live_u = pick_tombstones(csr, cand, burst, max_cells)
    src_all = np.repeat(np.arange(n, dtype=np.int64), np.diff(csr.out_indptr))
    tomb = cand[:t]
    batch = {"add": (a_src, a_dst, zeros),
             "del": (src_all[tomb], csr.out_dst[tomb].astype(np.int64), np.zeros(t, np.int64)),
             "v_add": {}, "v_del": []}
    t0 = time.perf_counter()
    overlay = D.DeltaOverlay.from_batches([batch])
    view = D.OverlayView(csr, overlay, max_lane_cells=max_cells)
    lanes = {u: view.lanes(u) for u in (False, True)}
    build_s = time.perf_counter() - t0
    if any(v is None for v in lanes.values()):
        raise RuntimeError(f"the overlay's lanes overflow {max_cells} cells")
    caps = {("undirected" if u else "directed"): {k: lanes[u]["_meta"][k] for k in ("acap", "tcap", "lcap")}
            for u in lanes}
    dirty = {("undirected" if u else "directed"): int(lanes[u]["dirty"].sum()) for u in lanes}
    t0 = time.perf_counter()
    mat = D.materialize(csr, overlay)
    materialize_s = time.perf_counter() - t0
    if mat.num_edges != view.num_edges_real:
        raise RuntimeError(f"materialized {mat.num_edges} edges, the view says {view.num_edges_real}")

    def pagerank():
        return PageRankProgram(max_iterations=20, tol=0.0)

    # base, then the overlay, on one executor: the swap keeps the plan
    dex = GPUExecutor(csr, strategy="segsum")
    dex.run(pagerank())
    dex.set_delta(view)
    t0 = time.perf_counter()
    dex.run(pagerank())  # the lanes move to the card, the loop captures
    delta_first_s = time.perf_counter() - t0
    first_capture_s = dex.last_run_info["capture_s"]
    kernels.reset_launch_counts()
    fused, launches = counted(lambda: dex.run(pagerank())["rank"], 60)
    info = dict(dex.last_run_info)
    eager = kernels.launch_counts()["sorted_segment_sum"]
    if (info["path"] != "fused"
            or info["kernel_launches"] + info["graph_kernel_launches"] != 60 or eager != 0):
        raise RuntimeError(f"delta PageRank: {launches} kernel runs ({eager} eagerly), "
                           f"expected 3 a superstep: {info}")
    host = dex.run(pagerank(), fused=False)["rank"]
    if not bits_equal(fused, host):
        raise RuntimeError("delta PageRank: the fused loop differs from the host loop")
    if fused.shape != (n,) or not np.isfinite(fused).all():
        raise RuntimeError("delta PageRank ranks are not finite")
    # the trade: materialize, then a fresh executor over its result
    t0 = time.perf_counter()
    mex = GPUExecutor(mat, strategy="segsum")
    want = mex.run(pagerank())["rank"]
    fresh_first_s = time.perf_counter() - t0
    # warm walls swing by half from run to run: five of each, in turns
    bex = GPUExecutor(csr, strategy="segsum")
    bex.run(pagerank())
    walls = {"base": [], "delta": [], "materialized": [], "delta_host_loop": []}
    for _ in range(5):
        for key, ex, kw in (("base", bex, {}), ("delta", dex, {}), ("materialized", mex, {}),
                            ("delta_host_loop", dex, {"fused": False})):
            ex.run(pagerank(), **kw)
            walls[key].append(ex.last_run_info["wall_s"])
    wall = {k: float(np.median(v)) for k, v in walls.items()}
    del bex
    rel = max_rel(fused, want)
    if not rel <= RANK_REL:
        raise RuntimeError(f"delta PageRank vs materialized: max rel diff {rel}")

    # the lane merge alone, replayed as the fused loop runs it, beside the
    # base aggregate it follows
    g = dex.g
    x = torch.rand(view.n_pad, generator=torch.Generator(device="cuda").manual_seed(3),
                   device="cuda")
    dl = view.device_args("cuda", False)
    plan = dex._segsum_plan("in")
    base_agg = kernels.sorted_segment_sum(torch.index_select(x, 0, g.in_src), plan)
    # the kernel on each lane's plan, fed the cells the merge gathers
    msgs_ext = torch.cat([x, x.new_zeros(1)])
    lane_err = {}
    for lane in ("add", "tomb"):
        cells_in = torch.index_select(msgs_ext, 0, dl[f"{lane}_src"])
        _p, _g, lane_err[lane] = check_plan(f"delta_{lane}_lane", dl[f"{lane}_plan"],
                                            cells_in, kernels)
    merge_ms = replay_ms(lambda: D.fused_delta_aggregate(dl, x, base_agg, "sum"))
    base_ms = replay_ms(lambda: kernels.sorted_segment_sum(torch.index_select(x, 0, g.in_src), plan))
    cells = len(dl["add_src"]) + len(dl["tomb_src"])
    # the merge reads the base sums once, each cell's source, destination
    # and message once, and writes the n_pad sums
    merge_bytes = 8 * view.n_pad + 12 * cells
    lane_cost = merge_ms * 1e-3 / overlay.size
    mat_cost = materialize_s / m
    decision = autotune.decide_delta(m, n, device_kind=torch.cuda.get_device_name(0))

    # CC (ELL) and the 4-hop hub BFS over the overlay, bitwise to the
    # materialized CSR's dense runs
    cc_ex = GPUExecutor(csr, strategy="ell", delta=view)
    comp = cc_ex.run(ConnectedComponentsProgram())["component"]
    cc_info = dict(cc_ex.last_run_info)
    mat_ell = GPUExecutor(mat, strategy="ell")
    comp_mat = mat_ell.run(ConnectedComponentsProgram(), frontier="off")["component"]
    if not bits_equal(comp, comp_mat):
        raise RuntimeError("delta CC differs from CC over the materialized CSR")
    msrc = np.repeat(np.arange(n), np.diff(mat.out_indptr))
    adj = coo_matrix((np.ones(mat.num_edges), (msrc, mat.out_dst)), shape=(n, n)).tocsr()
    ncomp, labels = connected_components(adj, directed=True, connection="weak")
    lowest = np.full(ncomp, n, dtype=np.int64)
    np.minimum.at(lowest, labels, np.arange(n))
    if not np.array_equal(comp.astype(np.int64), lowest[labels]):
        raise RuntimeError("delta CC differs from scipy's components over the merged edges")
    hub = int(np.argmax(csr.out_degree))
    bfs = cc_ex.run(ShortestPathProgram(seed_index=hub, max_iterations=4))["distance"]
    bfs_info = dict(cc_ex.last_run_info)
    bfs_mat = mat_ell.run(ShortestPathProgram(seed_index=hub, max_iterations=4),
                          frontier="off")["distance"]
    if bfs_info["path"] != "fused" or not bits_equal(bfs, bfs_mat):
        raise RuntimeError(f"delta BFS differs from the materialized CSR's: {bfs_info}")
    del cc_ex, mat_ell, mex

    # a vertex overlay: 1,000 new vertices with 4 out- and 4 in-edges each,
    # and 64 removed vertices (no out-edges, 1-16 in-edges) with theirs
    ind = np.diff(csr.in_indptr)
    gone = rng.choice(np.nonzero((csr.out_degree == 0) & (ind >= 1) & (ind <= 16))[0], 64,
                      replace=False)
    # the new edges' base ends avoid the removed vertices, as the store's
    # edges do
    alive = np.setdiff1d(np.arange(n), gone)
    new = np.arange(n, n + 1000, dtype=np.int64)
    v_src = np.concatenate([np.repeat(new, 4), rng.choice(alive, 4000)])
    v_dst = np.concatenate([rng.choice(alive, 4000), np.repeat(new, 4)])
    g_dst = np.repeat(gone, ind[gone])
    g_src = np.concatenate([csr.in_src[csr.in_indptr[v]:csr.in_indptr[v + 1]] for v in gone])
    vbatch = {"add": (v_src, v_dst, np.zeros(len(v_src), np.int64)),
              "del": (g_src.astype(np.int64), g_dst.astype(np.int64), np.zeros(len(g_src), np.int64)),
              "v_add": {int(v): 0 for v in new}, "v_del": [int(v) for v in gone]}
    voverlay = D.DeltaOverlay.from_batches([vbatch])
    vview = D.OverlayView(csr, voverlay, max_lane_cells=max_cells)
    dex.set_delta(vview)  # the swap: base plan kept, loops recaptured
    vout = dex.run(pagerank())
    swap_info = dict(dex.last_run_info)
    ranks, rview = D.compact_result(vview, vout)
    vmat = D.materialize(csr, voverlay)
    vwant = GPUExecutor(vmat, strategy="segsum").run(pagerank())["rank"]
    pos = np.searchsorted(vmat.vertex_ids, rview.vertex_ids)
    if len(rview.vertex_ids) != vmat.num_vertices or not np.array_equal(
            vmat.vertex_ids[pos], rview.vertex_ids):
        raise RuntimeError("the vertex overlay's live vertices differ from the materialized set")
    vrel = max_rel(ranks["rank"], vwant[pos])
    if not vrel <= RANK_REL:
        raise RuntimeError(f"vertex-overlay PageRank vs the materialized run by id: "
                           f"max rel diff {vrel}")
    dex.set_delta(None)
    emit("delta", seconds=time.perf_counter() - phase_t0, scale=args.scale, edges=m,
         burst_adds=burst, tombstones=t,
         tombstones_why=(f"the largest power of two (from 16384 seeded candidates) whose lanes "
                         f"fit {max_cells} cells in both orientations: each tombstone dirties "
                         f"its row, which re-aggregates its surviving in-edges"),
         live_cells={"directed": live_d, "undirected": live_u}, caps=caps, dirty_rows=dirty,
         overlay_depth=overlay.size, view_build_s=build_s, materialize_s=materialize_s,
         pagerank={"kernel_runs": launches, "supersteps": info["supersteps"],
                   "median_wall_s": wall, "walls_s": walls,
                   "delta_first_run_s": delta_first_s, "first_capture_s": first_capture_s,
                   "materialize_plus_fresh_run_s": materialize_s + fresh_first_s,
                   "fresh_first_run_s": fresh_first_s,
                   "lanes_per_superstep_ms": (wall["delta"] - wall["base"]) / 20 * 1e3,
                   "base_superstep_ms": wall["base"] / 20 * 1e3,
                   "max_abs_diff_vs_materialized": float(np.abs(fused - want).max()),
                   "max_rel_diff_vs_materialized": rel},
         lane_kernel_max_abs_err=lane_err,
         merge={"replayed_ms": merge_ms, "base_segsum_replayed_ms": base_ms, "cells": cells,
                # [n, d] SUM lanes fold each destination's cells in lane
                # order: the fold's width is the most cells of one
                "fold_width": {lane: int(dl[f"{lane}_fold"].shape[1]) for lane in ("add", "tomb")},
                "bytes": merge_bytes, "bound_ms": merge_bytes / PEAK_BYTES_PER_S * 1e3,
                "calls_per_run": 20},
         gpu_constants={"lane_cost_per_record_per_step_s": lane_cost,
                        "materialize_cost_per_edge_s": mat_cost},
         in_use={"lane": autotune._DELTA_LANE_COST_S["gpu"],
                 "materialize": autotune._DELTA_MATERIALIZE_COST_S["gpu"]},
         decide_delta=decision.as_dict(),
         cc={"path": cc_info["path"], "supersteps": cc_info["supersteps"],
             "wall_s": cc_info["wall_s"], "components": int(ncomp)},
         bfs={"hub": hub, "reached": int(np.sum(bfs < 1e18)), "wall_s": bfs_info["wall_s"]},
         vertex_overlay={"new": len(new), "removed": len(gone), "n_pad": vview.n_pad,
                         "swap_capture_s": swap_info["capture_s"], "wall_s": swap_info["wall_s"],
                         "max_rel_diff_vs_materialized": vrel,
                         "delta": swap_info["delta"]})
    return {"launches": launches, "merge_ms": merge_ms, "merge_bound_ms": merge_bytes / PEAK_BYTES_PER_S * 1e3}


def dense_phase(csr, args, emit) -> dict:
    """The dense-feature tier at the bench's width (d = 32, 2 layers): GCN
    fused under ELL and hybrid, bitwise equal; under segsum (ELL) bitwise
    equal to a repeat, its host loop and the ELL run; the attention GCN (sddmm) under ELL and hybrid,
    bitwise; the embedding update (5 iterations) ELL against hybrid,
    bitwise; at scale 12 each ELL result bitwise equal to the port's CPU
    run. Per-superstep ms and peak memory of each; tree_matmul against
    torch.matmul (TF32 off) at (2^20, 32) @ (32, 32); tree_dot and the
    three sddmm aggregates against their bounds."""
    import torch

    from janusgraph_tpu_torch.olap import GPUExecutor, rmat_csr
    from janusgraph_tpu_torch.olap.features import kernels as fk
    from janusgraph_tpu_torch.olap.programs import EmbeddingUpdateProgram, GCNForwardProgram

    if torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("TF32 matmul is on; the dense tier's yardstick needs it off")
    phase_t0 = time.perf_counter()
    d = 32

    def gcn(**kw):
        return GCNForwardProgram(feature_dim=d, hidden_dim=d, out_dim=d, num_layers=2, **kw)

    def emb():
        return EmbeddingUpdateProgram(feature_dim=d, max_iterations=5)

    cases = (("gcn", gcn, "h"), ("gcn_attention", lambda: gcn(attention=True), "h"),
             ("embedding", emb, "emb"))
    n, m = csr.num_vertices, csr.num_edges
    exs = {s: GPUExecutor(csr, strategy=s) for s in ("ell", "hybrid")}
    runs, results = {}, {}
    step = torch.zeros((), dtype=torch.int64, device="cuda")

    def superstep_ms(ex, prog):
        """One superstep (message, aggregate, apply) replayed from a CUDA
        graph, and its aggregate alone: the device time a fused superstep
        takes, without the run's host set-up (the numpy features)."""
        state, _ = prog.setup(ex.g)
        agg = lambda: ex._aggregate(prog, "sum", prog.message(state, step, ex.g))[0]  # noqa: E731
        whole = replay_ms(lambda: prog.apply(state, agg(), step, {}, ex.g), 5)
        return whole, replay_ms(agg, 5)

    for name, make, key in cases:
        for strategy, ex in exs.items():
            ex.run(make())  # packs, rows and the capture
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            out = ex.run(make())[key]
            info = dict(ex.last_run_info)
            if info["path"] != "fused" or out.shape != (n, d) or not np.isfinite(out).all():
                raise RuntimeError(f"{name} ({strategy}): {info}")
            results[(name, strategy)] = out
            whole_ms, agg_ms = superstep_ms(ex, make())
            runs[f"{name}_{strategy}"] = {
                "wall_s": info["wall_s"], "supersteps": info["supersteps"],
                "superstep_replayed_ms": whole_ms, "aggregate_replayed_ms": agg_ms,
                "capture_s": info["capture_s"],
                "max_memory_allocated": torch.cuda.max_memory_allocated(),
                "pad_ratio": info["pad_ratio"]}
        if not bits_equal(results[(name, "ell")], results[(name, "hybrid")]):
            raise RuntimeError(f"{name}: hybrid differs from ELL")
    # the default strategy: [n, d] SUM takes ELL, so the GCN
    # repeats bit for bit, its fused run equals its host loop and both
    # equal the ELL run
    seg = GPUExecutor(csr, strategy="segsum")
    h_first = seg.run(gcn())["h"]
    h_seg = seg.run(gcn())["h"]
    seg_info = dict(seg.last_run_info)
    h_host = seg.run(gcn(), fused=False)["h"]
    if (seg_info["strategy_resolved"] != "ell" or seg_info["path"] != "fused"
            or not bits_equal(h_first, h_seg) or not bits_equal(h_seg, h_host)
            or not bits_equal(h_seg, results[("gcn", "ell")])):
        raise RuntimeError(f"GCN under segsum: {seg_info['strategy_resolved']}, not bitwise "
                           f"(max abs vs ELL {np.abs(h_seg - results[('gcn', 'ell')]).max()})")
    whole_ms, agg_ms = superstep_ms(seg, gcn())
    runs["gcn_segsum"] = {"wall_s": seg_info["wall_s"], "strategy_resolved": seg_info["strategy_resolved"],
                          "superstep_replayed_ms": whole_ms, "aggregate_replayed_ms": agg_ms,
                          "bitwise_repeat_fused_host_loop_ell": True}
    del seg

    small = rmat_csr(12, 16, seed=args.seed)
    for name, make, key in cases:
        card = GPUExecutor(small, strategy="ell").run(make())[key]
        cpu = GPUExecutor(small, strategy="ell", device="cpu").run(make())[key]
        if not bits_equal(card, cpu):
            raise RuntimeError(f"{name} on the card differs from the CPU at scale 12")

    # the jnp-ported kernels alone, at the shapes the runs give them
    gen = torch.Generator(device="cuda").manual_seed(5)
    h = torch.randn(n, d, generator=gen, device="cuda")
    w = torch.randn(d, d, generator=gen, device="cuda")
    mm_bytes = 4 * (n * d + d * d + n * d)
    mm_flops = fk.matmul_flops(n, d, d)
    kern = {"tree_matmul": {
        "ms": cuda_ms(lambda: fk.tree_matmul(h, w), 5, warmup=1),
        "library_ms": cuda_ms(lambda: torch.matmul(h, w), 20),
        "calls_per_run": 2, "block_bytes": fk.MM_BLOCK_BYTES,
        "blocks": -(-n // (fk.MM_BLOCK_BYTES // (4 * d * d))),
        "bytes": mm_bytes, "flops": mm_flops,
        "bound_ms": max(mm_bytes / PEAK_BYTES_PER_S, mm_flops / PEAK_FP32_FLOPS) * 1e3}}
    tm = fk.tree_matmul(h, w)
    kern["tree_matmul"]["max_abs_diff_vs_matmul"] = float((tm - torch.matmul(h, w)).abs().max())
    ex = exs["ell"]
    src_idx = ex.g.in_src
    a = torch.index_select(h, 0, src_idx)
    b = torch.index_select(h, 0, ex.g.in_dst_seg)
    dot_bytes = 4 * (2 * m * d + m)
    kern["tree_dot"] = {
        "ms": cuda_ms(lambda: fk.tree_dot(a, b), 3, warmup=1),
        "library_ms": cuda_ms(lambda: torch.linalg.vecdot(a, b), 5, warmup=1),
        "shape": [m, d], "bytes": dot_bytes, "flops": 2.0 * m * d,
        "bound_ms": max(dot_bytes / PEAK_BYTES_PER_S, 2.0 * m * d / PEAK_FP32_FLOPS) * 1e3}
    del a, b, tm
    # sddmm: each edge's source index once, the features once, the sums once
    sd_bytes = 4 * (m + 2 * n * d)
    sd_flops = fk.sddmm_flops(m, d) + m * d
    sd_bound = max(sd_bytes / PEAK_BYTES_PER_S, sd_flops / PEAK_FP32_FLOPS) * 1e3
    hyb = exs["hybrid"]
    fns = {
        "sddmm_ell_aggregate": lambda: fk.sddmm_ell_aggregate(
            ex._ell_pack(False), ex._sddmm_rows("ell", False), h),
        "sddmm_hybrid_aggregate": lambda: fk.sddmm_hybrid_aggregate(
            hyb._hybrid_pack(False), hyb._sddmm_rows("hybrid", False), h),
        "sddmm_segment_aggregate": lambda: fk.sddmm_segment_aggregate(
            h, ex.g.in_src, ex.g.in_dst_seg, n),
    }
    for name, fn in fns.items():
        kern[name] = {"ms": cuda_ms(fn, 3, warmup=1), "library_ms": None, "bytes": sd_bytes,
                      "flops": sd_flops, "bound_ms": sd_bound, "calls_per_run": 2}
    # the run's host set-up: the reference's numpy features (2^20 x 32
    # normals), drawn on the host for the same bits
    t0 = time.perf_counter()
    gcn().setup(exs["ell"].g)
    setup_s = time.perf_counter() - t0
    emit("dense", seconds=time.perf_counter() - phase_t0, scale=args.scale, d=d, layers=2,
         embedding_iterations=5, runs=runs,
         gcn_setup_s=setup_s,
         bitwise_ell_hybrid=True, small_scale_equal_to_cpu=True, kernels=kern)
    return kern


def edge_hash(a: np.ndarray, b: np.ndarray, salt: int) -> np.ndarray:
    """A fixed 64-bit hash of each (a[i], b[i]) pair (splitmix64's finish
    over a + salt and b): the same edge hashes alike in any orientation's
    arrays, so types and weights need no second graph build."""
    with np.errstate(over="ignore"):
        h = a.astype(np.uint64) * np.uint64(0x9E3779B97F4A7C15) + np.uint64(salt)
        h ^= b.astype(np.uint64) * np.uint64(0xC2B2AE3D27D4EB4F)
        h ^= h >> np.uint64(30)
        h *= np.uint64(0xBF58476D1CE4E5B9)
        h ^= h >> np.uint64(27)
        h *= np.uint64(0x94D049BB133111EB)
        h ^= h >> np.uint64(31)
    return h


def both_orientations(csr):
    """(src, dst) of every edge as the in-CSR and the out-CSR store it."""
    n = csr.num_vertices
    rows = np.arange(n, dtype=np.int64)
    in_pair = (csr.in_src.astype(np.int64), np.repeat(rows, np.diff(csr.in_indptr)))
    out_pair = (np.repeat(rows, np.diff(csr.out_indptr)), csr.out_dst.astype(np.int64))
    return in_pair, out_pair


def channel_matrix(n, edges, channel, weighted=False):
    """The float64 (n, n) matrix of one channel's edges, rows the
    aggregating vertex: x' = M @ x is one traversal step (with
    ``weighted``, the edge weights instead of ones), and the channel's
    edge count (parallel edges merge in the matrix). ``edges`` is
    (src, dst, type, weight) of every edge once; the matrix is built from
    them directly, not through the port's ``channel_edges``: "out"
    aggregates at dst, "in" at src, "both" the sum."""
    from scipy.sparse import coo_matrix

    s, d, types, w = edges
    keep = slice(None) if channel.labels is None else np.isin(types, channel.labels)
    s, d = s[keep], d[keep]
    vals = w[keep].astype(np.float64) if weighted else np.ones(len(s))
    fwd = coo_matrix((vals, (d, s)), shape=(n, n)).tocsr()
    mat = {"out": fwd, "in": fwd.T.tocsr(), "both": fwd + fwd.T}[channel.direction]
    return mat, len(s) * (2 if channel.direction == "both" else 1)


def hold_counts(name, counts, want64, ell_counts=None):
    """Traverser counts against a float64 product (total and per vertex at
    rtol 1e-4) and, given, against the ELL strategy's: rtol 1e-4 per
    vertex, and bitwise where both are below 2^24 (every partial sum of a
    smaller count is an exact integer). Returns the record."""
    got = np.asarray(counts, dtype=np.float64)
    if counts.shape != want64.shape or not np.isfinite(got).all():
        raise RuntimeError(f"{name}: counts of shape {counts.shape} are not finite")
    total, total64 = float(got.sum()), float(want64.sum())
    if abs(total - total64) > 1e-4 * max(total64, 1.0):
        raise RuntimeError(f"{name}: total {total} differs from the float64 product's {total64}")
    if not np.allclose(got, want64, rtol=1e-4, atol=0.0):
        raise RuntimeError(f"{name}: max rel diff {max_rel(got[want64 > 0], want64[want64 > 0])} "
                           "from the float64 product")
    rec = {"total": total, "total_fp64": total64, "max_count": float(got.max()),
           "counts_over_2p24": int(np.sum(want64 >= 2.0 ** 24)),
           "max_rel_diff_vs_fp64": max_rel(got[want64 > 0], want64[want64 > 0])}
    if ell_counts is not None:
        if not np.allclose(got, ell_counts, rtol=1e-4, atol=0.0):
            raise RuntimeError(f"{name}: segsum and ELL counts differ beyond rtol 1e-4")
        small = (counts < 2.0 ** 24) & (ell_counts < 2.0 ** 24)
        if not bits_equal(counts[small], ell_counts[small]):
            raise RuntimeError(f"{name}: counts below 2^24 differ between segsum and ELL")
        rec["bitwise_vs_ell_below_2p24"] = int(small.sum())
        rec["max_rel_diff_vs_ell"] = max_rel(got[ell_counts > 0], ell_counts[ell_counts > 0])
    return rec


def channel_plan_checks(ex, prefix, kernels):
    """The segment-sum kernel against its plain version (and a bitwise
    repeat) on the plan of every channel ``ex`` holds, fed the gathered
    values of a seeded random vector, as a count step is."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(13)
    x = torch.rand(ex.csr.num_vertices, generator=gen, device="cuda")
    out = {}
    for channel, entry in ex._channel_packs.items():
        if entry._segsum is None:
            continue
        plan, src_idx, _w = entry.segsum()
        label = f"{channel.direction}{list(channel.labels) if channel.labels else ''}"
        data = torch.index_select(x, 0, src_idx)
        _p, _g, err = check_plan(f"{prefix}_{label}", plan, data, kernels)
        nbytes = plan.function_bytes()
        out[label] = {"edges": plan.num_edges, "num_ctas": plan.num_ctas, "max_abs_err": err,
                      "kernel_ms": flushed_ms(lambda: kernels.sorted_segment_sum(data, plan), iters=10),
                      "plain_ms": flushed_ms(lambda: kernels.sorted_segment_sum_plain(data, plan),
                                             iters=5),
                      "bytes": nbytes, "bound_ms": nbytes / PEAK_BYTES_PER_S * 1e3}
    return out


def filtered_3hop(csr, key, value):
    """The bench's filtered 3-hop: out, out with ``key > value``, out."""
    from janusgraph_tpu_torch.olap.programs import (
        OLAPTraversalProgram,
        PropertyFilter,
        TraversalStep,
        evaluate_filter_mask,
    )
    from janusgraph_tpu_torch.predicates import Cmp

    flt = (PropertyFilter(key, Cmp.GREATER_THAN, value),)
    fmask = evaluate_filter_mask(csr, flt)
    ones = np.ones(csr.num_vertices, np.float32)
    masks = np.stack([ones, fmask, ones], axis=1)

    def make():
        return OLAPTraversalProgram(
            (TraversalStep("out"), TraversalStep("out", None, flt), TraversalStep("out")),
            step_masks=masks)

    return make, fmask


def run_filtered_3hop(name, csr, adj_t, make, fmask, seg_ex, ell_ex, emit) -> int:
    """The filtered 3-hop under segsum (3 kernel runs, counted), warm and
    timed, against ELL and a float64 product; the kernel on the channel
    plan against its plain version. Returns the kernel runs."""
    from janusgraph_tpu_torch.olap import kernels

    kernels.reset_launch_counts()
    counts, runs = counted(lambda: seg_ex.run(make())["count"], 3)
    first = dict(seg_ex.last_run_info)
    again = seg_ex.run(make())["count"]
    info = dict(seg_ex.last_run_info)
    if not bits_equal(counts, again):
        raise RuntimeError(f"{name}: two segsum runs differ")
    if info["path"] != "host-loop" or info["strategy_resolved"] != "segsum":
        raise RuntimeError(f"{name}: {info['path']}, {info['strategy_resolved']}")
    ell = ell_ex.run(make())["count"]
    ell_info = dict(ell_ex.last_run_info)
    ell_ex.run(make())
    x = np.ones(csr.num_vertices)
    x = adj_t @ x
    x = (adj_t @ x) * fmask
    x = adj_t @ x
    rec = hold_counts(name, counts, x, ell)
    emit(name, kernel_runs=runs, wall_s=info["wall_s"], first_run_wall_s=first["wall_s"],
         superstep_ms=[r["wall_ms"] for r in info["superstep_records"]],
         ell_wall_s=ell_ex.last_run_info["wall_s"], ell_first_run_wall_s=ell_info["wall_s"],
         filter_selectivity=float(fmask.mean()), **rec,
         plans=channel_plan_checks(seg_ex, name, kernels))
    return runs


def traversal_phase(csr, args, seg_ex, ell_ex, adj, rank, pagerank_wall_s, emit) -> dict:
    """The OLAP traversal at full scale: the bench's filtered 3-hop (segsum
    against ELL and a float64 product), a typed channel chain with a label
    set that matches nothing, sack sum and mult (the [n, k] SUM path,
    bitwise on repeat), the bench's seeded 3-hop paths, the degree
    program, the MapReduce jobs and the Fulgora analogue's edges/s beside
    the fused PageRank's."""
    import dataclasses

    import torch
    from janusgraph_tpu_torch.olap import (
        ClusterCountMapReduce,
        EdgeChannel,
        GPUExecutor,
        StatsMapReduce,
        TopKMapReduce,
        kernels,
        measure_fulgora_baseline,
    )
    from janusgraph_tpu_torch.olap.programs import (
        ConnectedComponentsProgram,
        DegreeCountProgram,
        OLAPTraversalProgram,
        TraversalStep,
        build_path_index,
        enumerate_paths,
    )

    phase_t0 = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    n, m = csr.num_vertices, csr.num_edges
    adj_t = adj.T.tocsr()
    out = {}

    # (a) the bench's filtered 3-hop: score > 5 on step 2 (the property
    # rides a copy: the delta phase materializes the bare snapshot)
    scored = dataclasses.replace(csr, properties={
        "score": np.random.default_rng(args.scale).uniform(0, 10, n).astype(np.float32)})
    make, fmask = filtered_3hop(scored, "score", 5.0)
    out["filtered"] = run_filtered_3hop("traversal_filtered_3hop", csr, adj_t, make, fmask,
                                        seg_ex, ell_ex, emit)

    # (b) typed channels: 4 edge types and a weight from a hash of (src, dst)
    t0 = time.perf_counter()
    (ins, ind), (outs, outd) = both_orientations(csr)
    h_in, h_out = edge_hash(ins, ind, 1), edge_hash(outs, outd, 1)
    tcsr = dataclasses.replace(
        csr, properties={},
        in_edge_type=(h_in >> np.uint64(60)).astype(np.int32) & 3,
        out_edge_type=(h_out >> np.uint64(60)).astype(np.int32) & 3,
        in_edge_weight=(0.5 + (h_in & np.uint64(1023)).astype(np.float32) * (1.5 / 1024)),
        out_edge_weight=(0.5 + (h_out & np.uint64(1023)).astype(np.float32) * (1.5 / 1024)),
    )
    typed_edges = (ins, ind, tcsr.in_edge_type, tcsr.in_edge_weight)
    del outs, outd, h_in, h_out
    hash_s = time.perf_counter() - t0
    chain = [("out", (0, 1)), ("in", (2,)), ("both", None)]
    empty = [("out", (0, 1)), ("in", (7,))]

    def prog(spec, **kw):
        return OLAPTraversalProgram([TraversalStep(d, lab) for d, lab in spec], **kw)

    tex = GPUExecutor(csr=tcsr, strategy="segsum")
    kernels.reset_launch_counts()
    typed, typed_runs = counted(lambda: tex.run(prog(chain))["count"], 3)
    typed_first = tex.last_run_info["wall_s"]
    typed_again = tex.run(prog(chain))["count"]
    typed_info = dict(tex.last_run_info)
    if not bits_equal(typed, typed_again):
        raise RuntimeError("typed chain: two runs differ")
    x = np.ones(n)
    mats, edges = {}, {}
    for d, lab in chain:
        mats[(d, lab)], edges[(d, lab)] = channel_matrix(n, typed_edges, EdgeChannel(d, lab))
        x = mats[(d, lab)] @ x
    typed_rec = hold_counts("typed chain", typed, x)
    ell_tex = GPUExecutor(csr=tcsr, strategy="ell")
    typed_rec["max_rel_diff_vs_ell"] = max_rel(
        typed[typed > 0], ell_tex.run(prog(chain))["count"][typed > 0])
    none, empty_runs = counted(lambda: tex.run(prog(empty))["count"], 2)
    if none.shape != (n,) or none.any():
        raise RuntimeError("a label set that matches no edge left traversers")
    kernels.reset_launch_counts()
    typed_plans = channel_plan_checks(tex, "typed", kernels)
    emit("traversal_typed", kernel_runs=typed_runs, empty_label_kernel_runs=empty_runs,
         chain=[[d, list(lab) if lab else None] for d, lab in chain],
         hash_s=hash_s, first_run_wall_s=typed_first, wall_s=typed_info["wall_s"],
         superstep_ms=[r["wall_ms"] for r in typed_info["superstep_records"]],
         channel_edges={f"{d}{list(lab) if lab else ''}": edges[(d, lab)] for d, lab in chain},
         **typed_rec, plans=typed_plans)
    out["typed"] = typed_runs

    # (c) sacks: [n, 3] and [n, 2] SUM messages through the channels' ELL
    # packs, bitwise on repeat, against float64 products
    sacks = {}
    for sack in ("sum", "mult"):
        res = tex.run(prog(chain, sack=sack))
        info = dict(tex.last_run_info)
        again = tex.run(prog(chain, sack=sack))
        if not all(bits_equal(res[k], again[k]) for k in ("count", "sack")):
            raise RuntimeError(f"sack {sack}: two runs differ")
        if {r["strategy"] for r in info["superstep_records"]} != {"ell"}:
            raise RuntimeError(f"sack {sack}: {info['superstep_records']}")
        c = np.ones(n)
        sk = np.zeros(n) if sack == "sum" else np.ones(n)
        for d, lab in chain:
            a = mats[(d, lab)]
            wmat, _e = channel_matrix(n, typed_edges, EdgeChannel(d, lab), weighted=True)
            sk = a @ sk + wmat @ c if sack == "sum" else wmat @ sk
            c = a @ c
        got = res["sack"].astype(np.float64)
        if not np.allclose(got, sk, rtol=1e-4, atol=0.0) or not np.allclose(
                res["count"], c, rtol=1e-4, atol=0.0):
            raise RuntimeError(f"sack {sack}: max rel diff {max_rel(got[sk > 0], sk[sk > 0])}")
        sacks[sack] = {"wall_s": tex.last_run_info["wall_s"], "first_run_wall_s": info["wall_s"],
                       "total": float(got.sum()), "total_fp64": float(sk.sum()),
                       "max_rel_diff_vs_fp64": max_rel(got[sk > 0], sk[sk > 0]),
                       "superstep_ms": [r["wall_ms"] for r in tex.last_run_info["superstep_records"]]}
    # one sack step's aggregate alone (the "both" channel's ELL pack, [n, 3])
    pack = tex._channel_pack(prog(chain, sack="sum"), "s2").ell()
    msgs = torch.rand((n, 3), generator=torch.Generator(device="cuda").manual_seed(2), device="cuda")
    cols = prog(chain, sack="sum").edge_transform_cols
    agg_fn = lambda: kernels.ell_aggregate(pack, msgs, "sum", "none", cols)  # noqa: E731
    e_both = edges[("both", None)]
    # each edge's source index and weight once, the [n, 3] messages and sums once
    agg_bytes = 8 * e_both + 2 * 12 * n
    agg_flops = 4.0 * e_both * 3
    sacks["ell_aggregate_both_n3"] = {
        "ms": cuda_ms(agg_fn, 5, warmup=1), "replayed_ms": replay_ms(agg_fn, 5),
        "slots": pack.slots, "pad_ratio": pack.pad_ratio, "edges": e_both,
        "bytes": agg_bytes, "flops": agg_flops,
        "bound_ms": max(agg_bytes / PEAK_BYTES_PER_S, agg_flops / PEAK_FP32_FLOPS) * 1e3}
    emit("traversal_sack", **sacks)
    del tex, ell_tex, mats, pack, msgs

    # (d) the bench's seeded 3-hop paths
    pseeds = tuple(int(v) for v in np.random.default_rng(7).choice(n, 8, replace=False))
    pprog = OLAPTraversalProgram([TraversalStep("out")] * 3, seed_indices=pseeds, record_reach=True)
    seg_ex.run(pprog)
    t0 = time.perf_counter()
    res = seg_ex.run(pprog)
    device_wall = time.perf_counter() - t0
    t0 = time.perf_counter()
    index = build_path_index(csr, pprog)
    index_s = time.perf_counter() - t0
    sample = list(enumerate_paths(csr, pprog, res, limit=10_000, path_index=index))
    enum_wall = time.perf_counter() - t0
    if not sample:
        raise RuntimeError("seeded 3-hop: no path enumerated")
    p = np.asarray(sample, dtype=np.int64)
    src_all = np.repeat(np.arange(n, dtype=np.int64), np.diff(csr.out_indptr))
    keys = np.sort(src_all * n + csr.out_dst.astype(np.int64))
    hops = (p[:, :-1] * n + p[:, 1:]).ravel()
    pos = np.minimum(np.searchsorted(keys, hops), len(keys) - 1)
    reach = res["reach"] > 0
    if (not np.all(keys[pos] == hops) or not np.all(np.isin(p[:, 0], pseeds))
            or not all(reach[p[:, k], k].all() for k in range(4))):
        raise RuntimeError("seeded 3-hop: a path is no chain of real edges through the reach masks")
    emit("traversal_paths", seeds=len(pseeds), paths_enumerated=len(sample),
         paths_total=float(res["count"].astype(np.float64).sum()),
         device_wall_s=device_wall, enum_wall_s=enum_wall, path_index_s=index_s)

    # (e) the degree program: one superstep, one kernel run
    kernels.reset_launch_counts()
    deg, deg_runs = counted(lambda: seg_ex.run(DegreeCountProgram()), 1)
    if not bits_equal(deg["in_degree"], csr.in_degree.astype(np.float32)) or not bits_equal(
            deg["out_degree"], csr.out_degree.astype(np.float32)):
        raise RuntimeError("DegreeCountProgram differs from the CSR's degrees")
    deg_info = dict(seg_ex.last_run_info)

    # (f) MapReduce over CC's components and the PageRank ranks
    comp = seg_ex.run(ConnectedComponentsProgram())
    t0 = time.perf_counter()
    clusters = ClusterCountMapReduce("component").execute(comp, csr)
    stats = StatsMapReduce("rank").execute({"rank": rank}, csr)
    top = TopKMapReduce("rank", 10).execute({"rank": rank}, csr)
    mr_s = time.perf_counter() - t0
    labels, sizes = np.unique(comp["component"], return_counts=True)
    want_top = np.argsort(-rank.astype(np.float64), kind="stable")[:10]
    if (clusters["count"] != len(labels)
            or clusters["sizes"] != {float(a): float(b) for a, b in zip(labels, sizes)}
            or abs(stats["sum"] - float(rank.astype(np.float64).sum())) > 1e-9
            or stats["count"] != n
            or sorted(v for _i, v in top) != sorted(float(rank[i]) for i in want_top)):
        raise RuntimeError("MapReduce results differ from numpy's")

    # (g) the Fulgora analogue, one superstep on the card's host
    fb = measure_fulgora_baseline(csr, iterations=1)
    pr_eps = 20 * m / pagerank_wall_s
    torch.cuda.synchronize()
    emit("traversal_extras", degree={"kernel_runs": deg_runs, "wall_s": deg_info["wall_s"],
                                     "path": deg_info["path"]},
         mapreduce={"components": clusters["count"], "top1": top[0], "stats": stats,
                    "host_s": mr_s},
         fulgora={**fb, "fused_pagerank_edges_per_s": pr_eps,
                  "fused_pagerank_over_fulgora": pr_eps / fb["edges_per_sec"]},
         phase_seconds=time.perf_counter() - phase_t0,
         max_memory_allocated=torch.cuda.max_memory_allocated())
    out["degree"] = deg_runs
    out["fulgora_ratio"] = pr_eps / fb["edges_per_sec"]
    return out


def ldbc_phase(emit) -> int:
    """The LDBC SNB SF1-sized proxy (3.2M vertices, 17.3M edges): CC
    against scipy's components, and the bench's filtered 3-hop
    (creation_day > 1825) through the kernel, held as at scale 20."""
    import torch
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import connected_components

    from janusgraph_tpu_torch.olap import GPUExecutor, ldbc_sf_csr
    from janusgraph_tpu_torch.olap.programs import ConnectedComponentsProgram

    phase_t0 = time.perf_counter()
    t0 = time.perf_counter()
    lcsr = ldbc_sf_csr(sf=1)
    build_s = time.perf_counter() - t0
    n, m = lcsr.num_vertices, lcsr.num_edges
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    src = np.repeat(np.arange(n), np.diff(lcsr.out_indptr))
    adj = coo_matrix((np.ones(m), (src, lcsr.out_dst)), shape=(n, n)).tocsr()
    del src
    seg_ex = GPUExecutor(lcsr, strategy="segsum")
    ell_ex = GPUExecutor(lcsr, strategy="ell")
    cc_first = seg_ex.run(ConnectedComponentsProgram(max_iterations=64))["component"]
    comp = seg_ex.run(ConnectedComponentsProgram(max_iterations=64))["component"]
    cc_info = dict(seg_ex.last_run_info)
    ncomp, labels = connected_components(adj, directed=True, connection="weak")
    lowest = np.full(ncomp, n, dtype=np.int64)
    np.minimum.at(lowest, labels, np.arange(n))
    if not bits_equal(cc_first, comp) or not np.array_equal(comp.astype(np.int64), lowest[labels]):
        raise RuntimeError("CC on the SF1 proxy differs from scipy's components")
    emit("ldbc", vertices=n, edges=m, host_build_s=build_s, components=int(ncomp),
         cc={"path": cc_info["path"], "supersteps": cc_info["supersteps"],
             "wall_s": cc_info["wall_s"], "strategy_resolved": cc_info["strategy_resolved"]})
    make, fmask = filtered_3hop(lcsr, "creation_day", 1825)
    runs = run_filtered_3hop("ldbc_filtered_3hop", lcsr, adj.T.tocsr(), make, fmask,
                             seg_ex, ell_ex, emit)
    torch.cuda.synchronize()
    emit("ldbc_done", seconds=time.perf_counter() - phase_t0,
         max_memory_allocated=torch.cuda.max_memory_allocated())
    return runs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scale", type=int, default=20)
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2

    from janusgraph_tpu_torch import _build
    from janusgraph_tpu_torch.native import segment_ids
    from janusgraph_tpu_torch.observability import profiler
    from janusgraph_tpu_torch.olap import (
        GPUExecutor,
        csr_from_edges,
        rmat_csr,
        rmat_edges,
        run_on,
    )
    from janusgraph_tpu_torch.olap import kernels
    from janusgraph_tpu_torch.olap.programs import (
        ConnectedComponentsProgram,
        PageRankProgram,
        ShortestPathProgram,
        TraversalCountProgram,
        reconstruct_path,
    )
    from janusgraph_tpu_torch.olap.vertex_program import INF

    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    emit("device", kind=kind, count=torch.cuda.device_count(), nvidia_smi=smi,
         torch=torch.__version__, cuda=torch.version.cuda, peaks=profiler.device_peaks())

    # ---------------------------------------------------------------- build
    _build.load_library()
    info = _build.build_info
    ptxas = [ln.strip() for ln in info["log"].splitlines() if "registers" in ln or "spill" in ln]
    emit("build", seconds=round(info["seconds"], 3), cached=info["cached"], ptxas=ptxas)

    # ------------------------------------------------------- graph (host)
    t0 = time.perf_counter()
    csr = rmat_csr(args.scale, 16, seed=args.seed)
    n, m = csr.num_vertices, csr.num_edges
    emit("graph", scale=args.scale, vertices=n, edges=m,
         max_in_degree=int(csr.in_degree.max()), host_s=round(time.perf_counter() - t0, 3))

    # ------------------------------------------------ kernel vs plain, card
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    # PageRank's messages are positive; so are these (no cancellation, so
    # fp32 sums in two orders stay inside the reference's rtol)
    data = torch.rand(m, generator=gen, device=dev)
    seg = segment_ids(csr.in_indptr, m)
    plan, got, max_err = check_kernel_case("rmat", seg, n, data, kernels)
    want64 = np.bincount(seg, weights=data.cpu().numpy().astype(np.float64), minlength=n)
    err64 = float(np.abs(got.cpu().numpy() - want64).max())
    lengths = torch.as_tensor(csr.in_degree.astype(np.int64), device=dev)
    kernel_ms = flushed_ms(lambda: kernels.sorted_segment_sum(data, plan))
    kernel_ms_warm = cuda_ms(lambda: kernels.sorted_segment_sum(data, plan), 50)
    kernel_ms_read_flush = flushed_ms(lambda: kernels.sorted_segment_sum(data, plan),
                                      by_reading=True)
    plain_ms = flushed_ms(lambda: kernels.sorted_segment_sum_plain(data, plan))
    library_ms = flushed_ms(lambda: torch.segment_reduce(data, "sum", lengths=lengths))
    # the bound counts what the sum needs (values and sums once, the n + 1
    # segment offsets once), whatever layout a kernel reads
    nbytes = plan.function_bytes()
    bound_ms = max(nbytes / PEAK_BYTES_PER_S, m / PEAK_FP32_FLOPS) * 1e3
    kernel_bytes = plan.kernel_read_bytes()
    emit("kernel", case="rmat", edges=m, segments=n, items_per_cta=plan.items_per_cta,
         num_ctas=plan.num_ctas, max_segment_cta_span=plan.max_segment_cta_span(),
         ctas_per_sm=_build.load_library().jg_segsum_ctas_per_sm(plan.items_per_cta),
         max_abs_err=max_err, max_abs_err_vs_fp64=err64, kernel_ms=kernel_ms,
         kernel_ms_warm=kernel_ms_warm, kernel_ms_read_flush=kernel_ms_read_flush,
         plain_ms=plain_ms, library_ms=library_ms,
         bytes=nbytes, bound_ms=bound_ms, bound_by="bytes",
         share_of_bound=bound_ms / kernel_ms, kernel_bytes=kernel_bytes,
         kernel_bytes_per_s=kernel_bytes / (kernel_ms * 1e-3))

    rng = np.random.default_rng(args.seed)
    hub = np.concatenate([
        np.sort(rng.integers(0, 7, 500)), np.full(200_000, 7),
        np.sort(rng.integers(8, 5000, 20_000)),
    ])
    n_u, src_u, dst_u = rmat_edges(max(args.scale - 2, 8), 16, seed=args.seed, permute=False)
    unpermuted = csr_from_edges(n_u, src_u, dst_u)
    cases = {
        # name: (segment ids, segments, plan arguments, data offset)
        "empty_segments_and_tiles": (np.array([0, 0, 5, 1030, 3100]), 4000, {}, 0),
        "hub_over_many_blocks": (hub, 5000, {}, 0),
        "hub_over_many_ctas_small": (hub, 5000, {"items_per_cta": 256}, 0),
        "no_edges": (np.zeros(0, dtype=np.int64), 3000, {}, 0),
        "random_multi_tile": (np.sort(rng.integers(0, 2500, 9000)), 2500, {}, 0),
        "empty_run_1e5": (np.concatenate([
            np.sort(rng.integers(0, 5, 4000)), np.sort(rng.integers(100_005, 100_010, 4000)),
        ]), 100_010, {}, 0),
        "one_segment_owns_all": (np.full(300_000, 3), 10, {}, 0),
        "unaligned_edge_count": (np.sort(rng.integers(0, 50_000, 1_000_003)), 50_000, {}, 0),
        # data starting 4 bytes past a 16-byte boundary: the copies' ends
        # are plain loads
        "misaligned_data_view": (np.sort(rng.integers(0, 50_000, 1_000_003)), 50_000, {}, 1),
        "rmat_unpermuted_in_csr": (segment_ids(unpermuted.in_indptr, unpermuted.num_edges),
                                   n_u, {}, 0),
    }
    for name, (cseg, ns, kw, offset) in cases.items():
        cdata = torch.rand(len(cseg) + offset, generator=gen, device=dev)[offset:]
        cplan, _g, err = check_kernel_case(name, cseg, ns, cdata, kernels, **kw)
        case_ms = flushed_ms(lambda: kernels.sorted_segment_sum(cdata, cplan))
        emit("kernel", case=name, edges=len(cseg), segments=ns, max_abs_err=err,
             items_per_cta=cplan.items_per_cta, num_ctas=cplan.num_ctas,
             max_segment_cta_span=cplan.max_segment_cta_span(), kernel_ms=case_ms)

    # ------------------------------------------- main path: PageRank, s20
    def pagerank():
        return PageRankProgram(max_iterations=20, tol=0.0)

    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    result, main_launches = counted(lambda: run_on(csr, pagerank(), strategy="segsum"), 20)
    first_wall = time.perf_counter() - t0
    launches = kernels.launch_counts()
    rank = result["rank"]
    # the wrapper counts its one eager launch (superstep 0); the other 19
    # replay from CUDA graphs, which the kernel's device counter sees
    if launches["sorted_segment_sum"] < 1:
        raise RuntimeError(f"main path: {launches} eager launches, expected 1 a run")
    if rank.shape != (n,) or not np.isfinite(rank).all():
        raise RuntimeError("PageRank ranks are not finite")
    if abs(float(rank.astype(np.float64).sum()) - 1.0) > 1e-3:
        raise RuntimeError(f"PageRank mass {rank.sum()} is not 1")

    # the host loop, timed as in the slices before the fused loop
    timed, execs = {}, {}
    for strategy in ("segsum", "ell"):
        ex = GPUExecutor(csr, strategy=strategy)
        ex.run(pagerank(), fused=False)  # warm: plan/pack build and transfer
        out = ex.run(pagerank(), fused=False)
        info = dict(ex.last_run_info)
        if info["supersteps"] != 20 or info["path"] != "host-loop":
            raise RuntimeError(f"{strategy}: {info}")
        if strategy == "segsum" and info["kernel_launches"] != info["supersteps"]:
            raise RuntimeError(f"kernel_launches {info['kernel_launches']} != supersteps")
        timed[strategy] = (info, out["rank"])
        execs[strategy] = ex
        if strategy == "segsum":
            profile_run(ex, pagerank(), emit, fused=False)
    if not bits_equal(rank, timed["segsum"][1]):
        raise RuntimeError("run_on's fused PageRank differs from the host loop")
    ell_rank = timed["ell"][1]
    rel = float(np.max(np.abs(rank.astype(np.float64) - ell_rank) / np.abs(ell_rank)))
    if rel > 1e-4:
        raise RuntimeError(f"segsum vs ell PageRank max rel diff {rel}")
    seg_info = timed["segsum"][0]
    emit("pagerank", scale=args.scale, supersteps=20, kernel_launches=main_launches,
         eager_kernel_launches=launches["sorted_segment_sum"],
         first_run_wall_s_profiled=first_wall, wall_s=seg_info["wall_s"],
         superstep_ms=seg_info["wall_s"] / 20 * 1e3,
         edges_per_s=20 * m / seg_info["wall_s"],
         ell_wall_s=timed["ell"][0]["wall_s"],
         ell_superstep_ms=timed["ell"][0]["wall_s"] / 20 * 1e3,
         max_rel_diff_vs_ell=rel, rank_sum=float(rank.astype(np.float64).sum()))

    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import connected_components, shortest_path

    src = np.repeat(np.arange(n), np.diff(csr.out_indptr))
    adj = coo_matrix((np.ones(m), (src, csr.out_dst)), shape=(n, n)).tocsr()
    seg_ex = execs["segsum"]
    seed = int(np.argmax(csr.out_degree))

    # ------------------------------- autotune, hybrid, fused, checkpoints
    autotune_phase(csr, kind, emit)
    hybrid_phase(csr, seg_ex, rank.astype(np.float64), emit)
    kernels.reset_launch_counts()
    fused = fused_phase(csr, seg_ex, execs["ell"],
                        {s: timed[s][1] for s in timed}, adj, seed, emit)
    fused_launches = fused["segsum"]["kernel_runs"]
    checkpoint_phase(csr, rank, emit)

    # ------------------------------------ connected components, both paths
    ncomp, labels = connected_components(adj, directed=True, connection="weak")
    first = np.full(ncomp, n, dtype=np.int64)
    np.minimum.at(first, labels, np.arange(n))
    cc = {}
    # the first dense run also builds the undirected ELL pack; the second
    # times the run alone; "auto" keeps CC dense, "always" takes the
    # frontier engine
    modes = (("dense_first", "off"), ("dense", "off"), ("auto", "auto"), ("always", "always"))
    for key, mode in modes:
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        comp = seg_ex.run(ConnectedComponentsProgram(), frontier=mode)["component"]
        wall = time.perf_counter() - t0
        info = dict(seg_ex.last_run_info)
        if not np.array_equal(comp.astype(np.int64), first[labels]):
            raise RuntimeError(f"CC (frontier={mode}) labels differ from scipy's components")
        cc[key] = {"path": info["path"], "supersteps": info["supersteps"], "wall_s": wall,
                    "run_wall_s": info["wall_s"],
                    "strategy_resolved": info.get("strategy_resolved"),
                    "kernel_launches": kernels.launch_counts()["sorted_segment_sum"]}
    for key in ("dense_first", "dense", "auto"):
        if cc[key]["path"] != "fused" or cc[key]["strategy_resolved"] != "ell":
            raise RuntimeError(f"CC ({key}) did not run dense through ELL: {cc}")
    if cc["always"]["path"] != "frontier":
        raise RuntimeError(f"CC (frontier='always') did not take the frontier engine: {cc}")
    emit("cc", components=int(ncomp), **cc, always_tiers=seg_ex.last_run_info["tiers"])

    # ------------------------------------------------ BFS, 4 hops, frontier
    want = shortest_path(adj, method="D", directed=True, unweighted=True, indices=seed)

    def bfs4():
        return ShortestPathProgram(seed_index=seed, max_iterations=4)

    # the path as a user drives it, counted; then one warm and one timed
    # run on a kept executor
    kernels.reset_launch_counts()
    dist_run_on = run_on(csr, bfs4())["distance"]
    bfs_launches = kernels.launch_counts()["sorted_segment_sum"]
    seg_ex.run(bfs4())  # warm: the engine's pointer arrays
    dist = seg_ex.run(bfs4())["distance"]
    info = dict(seg_ex.last_run_info)
    if info["path"] != "frontier" or not 1 <= info["supersteps"] <= 4:
        raise RuntimeError(f"BFS did not take the frontier engine: {info}")
    if not np.array_equal(dist.view(np.int32), dist_run_on.view(np.int32)):
        raise RuntimeError("run_on's BFS differs from the executor's")
    if {t["tier_source"] for t in info["tiers"]} != {"autotune"}:
        raise RuntimeError(f"BFS did not price on the tuned ladders: {info['tiers']}")
    dense = execs["ell"].run(bfs4(), frontier="off")["distance"]
    if execs["ell"].last_run_info["path"] != "fused":
        raise RuntimeError("frontier='off' did not run dense")
    if not np.array_equal(dist.view(np.int32), dense.view(np.int32)):
        raise RuntimeError("frontier BFS differs from the dense ELL run")
    expect = np.where(want <= 4, want, INF).astype(np.float32)
    if not np.array_equal(dist, expect):
        raise RuntimeError("BFS distances differ from scipy's")
    # the static ladder (autotune=False), as before the tuned ladders
    static_ex = GPUExecutor(csr, strategy="segsum", autotune=False)
    static_ex.run(bfs4())  # warm
    static_dist = static_ex.run(bfs4())["distance"]
    static = dict(static_ex.last_run_info)
    if not bits_equal(static_dist, dist) or {t["tier_source"] for t in static["tiers"]} != {"static"}:
        raise RuntimeError("the static-ladder BFS differs from the tuned one")
    emit("bfs", seed=seed, seed_out_degree=int(csr.out_degree[seed]),
         hops=info["supersteps"], reached=int(np.sum(dist < INF)),
         tiers=info["tiers"], hop_wall_s=info["hop_wall_s"],
         bfs_4hop_wall_s=info["wall_s"], static_tiers=static["tiers"],
         static_hop_wall_s=static["hop_wall_s"], static_bfs_4hop_wall_s=static["wall_s"],
         # as before the fused loop: host-loop PageRank + static ladder
         pagerank_plus_bfs4_wall_s=seg_info["wall_s"] + static["wall_s"],
         fused_pagerank_plus_tuned_bfs4_wall_s=fused["segsum"]["wall_s"] + info["wall_s"],
         dense_wall_s=execs["ell"].last_run_info["wall_s"], kernel_launches=bfs_launches)
    profile_run(seg_ex, bfs4(), emit, phase="bfs_profile")
    frontier_parts(seg_ex, seed, emit)

    # ------------------------------------- BFS with paths, to convergence
    def tracked():
        return ShortestPathProgram(seed_index=seed, track_paths=True)

    res = seg_ex.run(tracked())
    info = dict(seg_ex.last_run_info)
    dense = execs["ell"].run(tracked(), frontier="off")
    for key in ("distance", "predecessor"):
        if not np.array_equal(res[key].view(np.int32), dense[key].view(np.int32)):
            raise RuntimeError(f"tracked BFS {key} differs from the dense run")
    if info["path"] != "frontier" or not np.array_equal(
        res["distance"], np.where(np.isfinite(want), want, INF).astype(np.float32)
    ):
        raise RuntimeError("tracked BFS distances differ from scipy's")
    reached = np.nonzero(res["distance"] < INF)[0]
    # 1,000 targets (every reached vertex on a graph that reaches fewer)
    targets = np.random.default_rng(args.seed).choice(reached, min(1000, len(reached)), replace=False)
    for v in targets:
        path = reconstruct_path(res, int(v))
        if path is None or path[0] != seed or path[-1] != v or len(path) != res["distance"][v] + 1:
            raise RuntimeError(f"path to {v} is not a chain of length dist: {path}")
        for a, b in zip(path, path[1:]):
            if not np.any(csr.out_dst[csr.out_indptr[a]:csr.out_indptr[a + 1]] == b):
                raise RuntimeError(f"path to {v}: {a}->{b} is not an edge")
    emit("paths", hops=info["supersteps"], reached=len(reached), paths_checked=len(targets),
         wall_s=info["wall_s"], dense_wall_s=execs["ell"].last_run_info["wall_s"],
         dense_supersteps=execs["ell"].last_run_info["supersteps"])

    # ------------------------------------------- 3-hop traversal count
    kernels.reset_launch_counts()
    counts, khop_launches = counted(
        lambda: run_on(csr, TraversalCountProgram(hops=3), strategy="segsum")["count"], 3)
    khop_eager = kernels.launch_counts()["sorted_segment_sum"]
    if khop_eager < 1:
        raise RuntimeError(f"3-hop count: {khop_eager} eager launches, expected 1 a run")
    seg_ex.run(TraversalCountProgram(hops=3))  # warm
    timed_counts = seg_ex.run(TraversalCountProgram(hops=3))["count"]
    khop_info = dict(seg_ex.last_run_info)
    if (khop_info["kernel_launches"] + khop_info["graph_kernel_launches"] != 3
            or not np.array_equal(timed_counts, counts)):
        raise RuntimeError(f"3-hop count on the kept executor: {khop_info}")
    ell_counts = execs["ell"].run(TraversalCountProgram(hops=3))["count"]
    if counts.shape != (n,) or not np.isfinite(counts).all():
        raise RuntimeError("3-hop counts are not finite")
    if not np.allclose(counts, ell_counts, **TOL):
        raise RuntimeError("3-hop counts differ from the ELL strategy's")
    x = np.ones(n)
    for _ in range(3):
        x = adj.T @ x
    total = float(counts.astype(np.float64).sum())
    if abs(total - float(x.sum())) > 1e-4 * float(x.sum()):
        raise RuntimeError(f"3-hop total {total} differs from the product's {x.sum()}")
    emit("khop", hops=3, kernel_launches=khop_launches,
         wall_s=khop_info["wall_s"],
         total_paths=total, total_paths_fp64=float(x.sum()),
         max_rel_diff_vs_ell=float(np.max(np.abs(counts - ell_counts) / np.maximum(ell_counts, 1))),
         ell_wall_s=execs["ell"].last_run_info["wall_s"])

    traversal = traversal_phase(csr, args, seg_ex, execs["ell"], adj, rank,
                                fused["segsum"]["wall_s"], emit)
    peer_pressure_phase(csr, seg_ex, args, emit)
    del seg_ex, execs, fused
    kernels.reset_launch_counts()
    delta = delta_phase(csr, args, emit)
    dense_phase(csr, args, emit)
    ldbc_launches = ldbc_phase(emit)
    print(json.dumps({"kernels": [{
        "name": "sorted_segment_sum",
        "route": "cuda",
        "source": "janusgraph_tpu_torch/csrc/segsum.cu",
        "replaces": "janusgraph_tpu/olap/kernels.py:764",
        # counted by the kernel's device counter (CUDA-graph replays
        # included): run_on's PageRank, a fused PageRank on a kept
        # executor, run_on's 3-hop count
        "launches": main_launches,
        "launches_fused": fused_launches,
        "launches_khop": khop_launches,
        # the delta PageRank: base, adds and tombstones each superstep
        "launches_delta": delta["launches"],
        # the filtered 3-hop (scale 20), the typed chain, the degree
        # program and the SF1 proxy's filtered 3-hop, each on its
        # channel's plan
        "launches_traversal": traversal["filtered"],
        "launches_typed": traversal["typed"],
        "launches_degree": traversal["degree"],
        "launches_ldbc": ldbc_launches,
        "max_abs_err": max_err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "bytes",
        "library_ms": library_ms,
        "kernel_ms_warm": kernel_ms_warm,
        "share_of_bound": bound_ms / kernel_ms,
        "held_by": "kernel",
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
