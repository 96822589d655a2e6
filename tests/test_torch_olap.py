"""The port's OLAP path held against the JAX package's on the same graphs.

CSR arrays are equal; PageRank and connected components through the port's
``run_on(..., device="cpu")`` match ``TPUExecutor`` (the "pallas"/"ell"
strategies) and the scalar CPU oracle at the reference's own tolerance
(rtol=1e-4, atol=1e-5, tests/test_kernels.py)."""

import dataclasses

import numpy as np
import pytest
import torch

import janusgraph_tpu.olap as ref
from janusgraph_tpu.olap.programs import (
    ConnectedComponentsProgram as RefCC,
    PageRankProgram as RefPR,
)
from janusgraph_tpu.olap.tpu_executor import TPUExecutor
from janusgraph_tpu_torch.olap import (
    GPUExecutor,
    csr_from_arrays,
    csr_from_edges,
    rmat_edges,
    run_on,
)
from janusgraph_tpu_torch.olap.programs import ConnectedComponentsProgram, PageRankProgram

CSR_FIELDS = (
    "vertex_ids", "out_indptr", "out_dst", "in_indptr", "in_src",
    "out_degree", "in_edge_weight", "out_edge_weight",
)


def _random_edges(weights, n=180, m=700, seed=11):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, m).astype(np.int32)
    dst = rng.integers(0, n, m).astype(np.int32)
    w = rng.uniform(0.5, 2.0, m).astype(np.float32) if weights else None
    return n, src, dst, w


def _rmat8_edges():
    n, src, dst = rmat_edges(8, 16, seed=3)
    return n, src, dst, None


GRAPHS = {
    "random": lambda: _random_edges(False),
    "random_weighted": lambda: _random_edges(True),
    "rmat8": _rmat8_edges,
}


def _assert_csr_equal(ref_csr, got):
    for name in CSR_FIELDS:
        a, b = getattr(ref_csr, name), getattr(got, name)
        assert (a is None) == (b is None), name
        if a is not None:
            assert a.dtype == b.dtype, name
            np.testing.assert_array_equal(a, b, err_msg=name)


@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_csr_from_edges_equals_reference(graph):
    n, src, dst, w = GRAPHS[graph]()
    _assert_csr_equal(ref.csr_from_edges(n, src, dst, w), csr_from_edges(n, src, dst, w))


def test_csr_from_arrays_round_trips_reference():
    n, src, dst, w = _random_edges(True)
    r = ref.csr_from_edges(n, src, dst, w)
    fields = {k: v for k, v in dataclasses.asdict(r).items() if k in CSR_FIELDS}
    got = csr_from_arrays(**fields)
    _assert_csr_equal(r, got)
    assert got.num_vertices == r.num_vertices and got.num_edges == r.num_edges
    np.testing.assert_array_equal(got.in_degree, r.in_degree)


CASES = [
    # (program, port strategy, reference TPUExecutor strategy)
    ("pagerank", "segsum", "pallas"),
    ("pagerank", "ell", "ell"),
    ("cc", "segsum", "ell"),
]


def _programs(name):
    if name == "pagerank":
        return PageRankProgram(max_iterations=20), RefPR(max_iterations=20), "rank"
    return ConnectedComponentsProgram(), RefCC(), "component"


@pytest.mark.parametrize("name,strategy,ref_strategy", CASES,
                         ids=[f"{p}-{s}" for p, s, _ in CASES])
@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_run_on_matches_reference(graph, name, strategy, ref_strategy):
    n, src, dst, w = GRAPHS[graph]()
    rg = ref.csr_from_edges(n, src, dst, w)
    prog, ref_prog, key = _programs(name)
    ex = GPUExecutor(csr_from_edges(n, src, dst, w), strategy=strategy, device="cpu")
    got = ex.run(prog)
    assert set(got) == {key}
    info = ex.last_run_info
    assert info["strategy_resolved"] == (strategy if name == "pagerank" else "ell")
    assert info["kernel_launches"] == 0 and info["supersteps"] >= 1

    tpu = TPUExecutor(rg, strategy=ref_strategy, frontier="off").run(ref_prog)
    oracle = ref.run_on(rg, _programs(name)[1], "cpu")
    for want in (tpu, oracle):
        np.testing.assert_allclose(
            got[key].astype(np.float64), np.asarray(want[key], dtype=np.float64),
            rtol=1e-4, atol=1e-5,
        )
    if name == "cc":
        np.testing.assert_array_equal(got[key], np.asarray(oracle[key], dtype=np.float32))


@pytest.mark.parametrize("strategy", ["segsum", "ell", "segment"])
def test_port_strategies_agree(strategy):
    n, src, dst, w = _random_edges(True, seed=21)
    g = csr_from_edges(n, src, dst, w)
    base = run_on(g, PageRankProgram(max_iterations=15), strategy="segment", device="cpu")
    got = run_on(g, PageRankProgram(max_iterations=15), strategy=strategy, device="cpu")
    np.testing.assert_allclose(got["rank"], base["rank"], rtol=1e-5, atol=1e-7)
    assert abs(float(got["rank"].sum()) - 1.0) < 1e-3


def test_pagerank_terminates_on_tolerance():
    n, src, dst, w = _random_edges(False)
    ex = GPUExecutor(csr_from_edges(n, src, dst, w), device="cpu")
    ex.run(PageRankProgram(tol=1e-3, max_iterations=100))
    steps = ex.last_run_info["supersteps"]
    assert 2 <= steps < 100
    prog = PageRankProgram(tol=1e-3)
    assert bool(prog.terminate_device({"delta": torch.tensor(1e-4)}, 2))
    assert not bool(prog.terminate_device({"delta": torch.tensor(1e-4)}, 1))


def test_no_device_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    n, src, dst, w = _random_edges(False)
    g = csr_from_edges(n, src, dst, w)
    with pytest.raises(RuntimeError, match="CUDA"):
        GPUExecutor(g)
    with pytest.raises(RuntimeError, match="CUDA"):
        run_on(g, PageRankProgram(), device="cuda")
    with pytest.raises(ValueError):
        GPUExecutor(g, strategy="pallas", device="cpu")
