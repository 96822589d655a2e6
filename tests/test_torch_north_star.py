"""The north-star phase of ``chip_smoke.py`` on the CPU.

``north_star_phase`` runs the port's main path (the segment-sum kernel's
plain version on the graph's in-plan, PageRank through ``run_on`` and a
kept ``GPUExecutor``, the out-degree hub's 4-hop BFS on both tier ladders)
and holds each result to a host reference that stays cheap at 2^27 edges:
a float64 PageRank over a scipy CSR matrix and a numpy level-synchronous
BFS. Here it runs at scale 10 with ``device="cpu"``; the two host
references are held at scale 12 to ``pagerank_fp64`` (1e-12) and scipy's
BFS (exactly); the port's ``run_on`` PageRank and BFS at scale 12 to the
JAX package's ``run_on`` (rel 1e-5, exactly); and the phase must raise
when one rank, one distance or one segment sum is off.
"""

import argparse
import importlib.util
import os

import numpy as np
import pytest

import janusgraph_tpu.olap as ref
from janusgraph_tpu.olap.generators import rmat_csr as ref_rmat_csr
from janusgraph_tpu.olap.programs import PageRankProgram as RefPR
from janusgraph_tpu.olap.programs import ShortestPathProgram as RefSP
from janusgraph_tpu_torch.olap import GPUExecutor, kernels, rmat_csr, run_on
from janusgraph_tpu_torch.olap.programs import PageRankProgram, ShortestPathProgram

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, os.path.join(ROOT, path))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _smoke():
    return _load("chip_smoke", "chip_smoke.py")


@pytest.fixture
def cpu_runs_counted():
    """The plain versions' runs counted as the CPU's kernel runs, as
    ``bin/torch_north_star.py --device cpu`` counts them."""
    with _load("torch_north_star", "bin/torch_north_star.py").cpu_runs_counted():
        yield


def _run_phase(smoke, scale=10, repeats=3):
    lines = []
    out = smoke.north_star_phase(
        argparse.Namespace(seed=1), lambda phase, **f: lines.append({"phase": phase, **f}),
        "cpu", scale=scale, repeats=repeats,
    )
    return out, lines


def test_north_star_phase_on_the_cpu(cpu_runs_counted):
    smoke = _smoke()
    out, lines = _run_phase(smoke)
    assert [ln["phase"] for ln in lines] == [
        "north_star_graph", "kernel", "north_star_pagerank", "north_star_bfs", "north_star"]
    graph, kernel, pr, bfs, end = lines
    n, m = 1 << 10, 16 << 10
    assert (graph["vertices"], graph["edges"], graph["device"]) == (n, m, "cpu")
    assert graph["rmat_s"] > 0 and graph["build_csr_s"] > 0 and graph["max_in_degree"] > 0

    assert kernel["case"] == "rmat_s10" and (kernel["edges"], kernel["segments"]) == (m, n)
    assert kernel["max_abs_err"] <= 1e-4 and kernel["max_abs_err_vs_fp64"] <= 1e-3
    assert kernel["bytes"] == 4 * (m + 2 * n + 1)
    assert kernel["bound_ms"] == pytest.approx(kernel["bytes"] / 3.35e12 * 1e3)
    # no device time on the CPU: not measured
    for key in ("kernel_ms", "kernel_ms_warm", "plain_ms", "library_ms", "share_of_bound"):
        assert kernel[key] is None

    assert pr["kernel_launches"] == 20 and pr["supersteps"] == 20 and pr["repeats"] == 3
    assert pr["max_rel_vs_fp64"] <= 1e-4 and abs(pr["rank_sum"] - 1.0) <= 1e-3
    for path in ("host_loop", "fused"):
        st = pr[path]
        assert len(st["walls_s"]) == 3
        assert st["min_s"] <= st["median_s"] <= st["max_s"]
        assert st["superstep_ms"] == pytest.approx(st["median_s"] / 20 * 1e3)
        assert st["edges_per_s"] == pytest.approx(20 * m / st["median_s"])
    assert pr["profile"]["host_loop"]["device_idle_share"] is None
    assert pr["profile"]["fused"]["device_idle_share"] is None

    assert bfs["kernel_launches"] == 0 and bfs["reached"] > 1
    for ladder, source in (("tuned", "autotune"), ("static", "static")):
        st = bfs[ladder]
        assert 1 <= st["hops"] <= 4 and len(st["hop_wall_s"]) == st["hops"]
        assert {t["tier_source"] for t in st["tiers"]} == {source}
        assert all(t["F_cap"] >= t["frontier"] and t["E_cap"] >= t["edges"] for t in st["tiers"])
    assert bfs["pagerank_plus_bfs4_wall_s"] == pytest.approx(
        pr["host_loop"]["median_s"] + bfs["static"]["median_s"])
    assert bfs["fused_pagerank_plus_tuned_bfs4_wall_s"] == pytest.approx(
        pr["fused"]["median_s"] + bfs["tuned"]["median_s"])

    assert end["seconds"] > 0 and end["host_peak_rss"] > 0
    assert list(end["section_s"]) == ["graph", "kernel", "pagerank", "bfs", "release"]
    assert sum(end["section_s"].values()) == pytest.approx(end["seconds"])
    assert end["max_memory_allocated"] is None
    assert out["launches"] == 20 and out["kernel"]["bound_ms"] == kernel["bound_ms"]


def test_the_phase_takes_at_least_three_repeats():
    with pytest.raises(ValueError, match="at least 3 repeats"):
        _run_phase(_smoke(), repeats=2)


def test_fp64_pagerank_over_the_csr_matrix_equals_bincount():
    smoke = _smoke()
    csr = rmat_csr(12, 16, seed=1)
    want = smoke.pagerank_fp64(csr, 20)
    got = smoke.pagerank_fp64_csr(csr, 20)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)


@pytest.mark.parametrize("hops", [1, 2, 4])
def test_numpy_bfs_equals_scipy_within_the_hops(hops):
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import shortest_path

    smoke = _smoke()
    csr = rmat_csr(12, 16, seed=1)
    n, m = csr.num_vertices, csr.num_edges
    src = np.repeat(np.arange(n), np.diff(csr.out_indptr))
    adj = coo_matrix((np.ones(m), (src, csr.out_dst)), shape=(n, n)).tocsr()
    for seed in (int(np.argmax(csr.out_degree)), 0, n - 1):
        want = shortest_path(adj, method="D", directed=True, unweighted=True, indices=seed)
        want = np.where(want <= hops, want, np.inf)
        np.testing.assert_array_equal(smoke.bfs_numpy(csr, seed, hops), want)


@pytest.mark.parametrize("program", ["pagerank", "bfs4"])
def test_run_on_at_scale_12_matches_the_jax_package(program):
    rc, pc = ref_rmat_csr(12, 16, seed=1), rmat_csr(12, 16, seed=1)
    np.testing.assert_array_equal(rc.in_src, pc.in_src)
    if program == "pagerank":
        want = np.asarray(ref.run_on(
            rc, RefPR(max_iterations=20, tol=0.0), "tpu", strategy="pallas")["rank"])
        got = run_on(pc, PageRankProgram(max_iterations=20, tol=0.0), strategy="segsum",
                     device="cpu")["rank"]
        np.testing.assert_allclose(got.astype(np.float64), want, rtol=1e-5, atol=0)
    else:
        seed = int(np.argmax(pc.out_degree))
        want = np.asarray(ref.run_on(rc, RefSP(seed_index=seed, max_iterations=4), "tpu")["distance"])
        got = run_on(pc, ShortestPathProgram(seed_index=seed, max_iterations=4),
                     device="cpu")["distance"]
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("key,match", [
    ("distance", "differ from the host BFS"),
    ("rank", "from float64"),
    ("segsum", "from a float64 bincount"),
])
def test_the_phase_fails_on_one_perturbed_value(monkeypatch, cpu_runs_counted, key, match):
    """Every run returns the same one value off, so the runs agree with
    each other and only the host reference can catch it; the segment sum's
    plain version is off as its kernel is, so only the float64 bincount
    can."""
    if key == "segsum":
        plain = kernels.sorted_segment_sum_plain

        def perturbed_sum(data, plan):
            out = plain(data, plan)
            out[0] += 1.0
            return out

        monkeypatch.setattr(kernels, "sorted_segment_sum_plain", perturbed_sum)
    else:
        run = GPUExecutor.run

        def perturbed(self, program, **kw):
            out = run(self, program, **kw)
            if key in out:
                values = out[key].copy()
                hit = int(np.argmax(values < 1e9)) if key == "distance" else 0
                values[hit] = values[hit] + 1 if key == "distance" else values[hit] * 1.01
                out[key] = values
            return out

        monkeypatch.setattr(GPUExecutor, "run", perturbed)
    with pytest.raises(RuntimeError, match=match):
        _run_phase(_smoke())
