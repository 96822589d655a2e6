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
           "segsum"): every superstep must launch the kernel once; timed
           beside the plain-torch ELL strategy, which it must agree with
  profile  torch.profiler over one more PageRank run: device busy time
           against wall, and device time by kernel
  cc       connected components (MIN falls back to ELL) against scipy
Then the ``kernels`` line, and last ``{"ok": true, "device": ...}``.
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
    import torch

    plan = kernels.make_segsum_plan(seg, num_segments, **plan_kw)
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


def profile_run(ex, program, emit) -> None:
    """One more run under torch.profiler. Every figure comes from this one
    run: device busy time (the sum of kernel and copy time on the card)
    against the run's own wall and against the span from its first device
    event to its last, and the top entries by device time. The profiler
    slows the host, so the idle shares are upper bounds; a negative share
    is measurement error and is printed as it is."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        ex.run(program)
        torch.cuda.synchronize()
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
    top = sorted(device_events, key=lambda e: -e.self_device_time_total)[:6]
    emit("profile", wall_ms=wall_us / 1e3, device_busy_ms=busy_us / 1e3,
         device_span_ms=span_us / 1e3,
         device_idle_share=1.0 - busy_us / wall_us,
         device_idle_share_of_span=1.0 - busy_us / span_us,
         by_device_time=[{"name": e.key[:60], "calls": e.count,
                          "device_ms": e.self_device_time_total / 1e3} for e in top])


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
    )

    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    emit("device", kind=kind, count=torch.cuda.device_count(), nvidia_smi=smi,
         torch=torch.__version__, cuda=torch.version.cuda)

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
    result = run_on(csr, pagerank(), strategy="segsum")
    first_wall = time.perf_counter() - t0
    launches = kernels.launch_counts()
    rank = result["rank"]
    if launches["sorted_segment_sum"] != 20:
        raise RuntimeError(f"main path launched the kernel {launches} times, expected 20")
    if rank.shape != (n,) or not np.isfinite(rank).all():
        raise RuntimeError("PageRank ranks are not finite")
    if abs(float(rank.astype(np.float64).sum()) - 1.0) > 1e-3:
        raise RuntimeError(f"PageRank mass {rank.sum()} is not 1")

    timed = {}
    for strategy in ("segsum", "ell"):
        ex = GPUExecutor(csr, strategy=strategy)
        ex.run(pagerank())  # warm: plan/pack build and transfer
        out = ex.run(pagerank())
        info = dict(ex.last_run_info)
        if info["supersteps"] != 20:
            raise RuntimeError(f"{strategy}: {info['supersteps']} supersteps")
        if strategy == "segsum" and info["kernel_launches"] != info["supersteps"]:
            raise RuntimeError(f"kernel_launches {info['kernel_launches']} != supersteps")
        timed[strategy] = (info, out["rank"])
        if strategy == "segsum":
            profile_run(ex, pagerank(), emit)
    ell_rank = timed["ell"][1]
    rel = float(np.max(np.abs(rank.astype(np.float64) - ell_rank) / np.abs(ell_rank)))
    if rel > 1e-4:
        raise RuntimeError(f"segsum vs ell PageRank max rel diff {rel}")
    seg_info = timed["segsum"][0]
    emit("pagerank", scale=args.scale, supersteps=20, kernel_launches=launches["sorted_segment_sum"],
         first_run_wall_s=first_wall, wall_s=seg_info["wall_s"],
         superstep_ms=seg_info["wall_s"] / 20 * 1e3,
         edges_per_s=20 * m / seg_info["wall_s"],
         ell_wall_s=timed["ell"][0]["wall_s"],
         ell_superstep_ms=timed["ell"][0]["wall_s"] / 20 * 1e3,
         max_rel_diff_vs_ell=rel, rank_sum=float(rank.astype(np.float64).sum()))

    # ------------------------------------------- connected components, ELL
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import connected_components

    t0 = time.perf_counter()
    ex = GPUExecutor(csr, strategy="segsum")
    comp = ex.run(ConnectedComponentsProgram())["component"]
    cc_wall = time.perf_counter() - t0
    src = np.repeat(np.arange(n), np.diff(csr.out_indptr))
    adj = coo_matrix((np.ones(m, dtype=np.int8), (src, csr.out_dst)), shape=(n, n))
    ncomp, labels = connected_components(adj, directed=True, connection="weak")
    first = np.full(ncomp, n, dtype=np.int64)
    np.minimum.at(first, labels, np.arange(n))
    if ex.last_run_info["strategy_resolved"] != "ell":
        raise RuntimeError("CC did not fall back to ELL")
    if not np.array_equal(comp.astype(np.int64), first[labels]):
        raise RuntimeError("CC labels differ from scipy's components")
    emit("cc", components=int(ncomp), supersteps=ex.last_run_info["supersteps"],
         wall_s=cc_wall, run_wall_s=ex.last_run_info["wall_s"])

    print(json.dumps({"kernels": [{
        "name": "sorted_segment_sum",
        "route": "cuda",
        "source": "janusgraph_tpu_torch/csrc/segsum.cu",
        "replaces": "janusgraph_tpu/olap/kernels.py:764",
        "launches": launches["sorted_segment_sum"],
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
