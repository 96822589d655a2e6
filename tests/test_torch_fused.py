"""The port's fused loop held against its host loop and the JAX package's
fused ``lax.while_loop``.

On the CPU the fused path runs the same predicated supersteps a CUDA graph
replays on the card, eagerly. Its results must equal the host loop's bit
for bit, and the reference's ``TPUExecutor(...).run(p, fused=True)`` on
JAX's CPU backend bit for bit, with the same superstep count.

PageRank's reference parity uses damping 0.5 on a graph where every vertex
has an out-edge. XLA's CPU backend always allows fused multiply-adds, so
the reference computes ``(1 - d) / n + d * y`` with one rounding, where the
port's eager torch (and the reference's own numpy executor) round twice;
with d = 0.5 the product is exact and both give the same bits. Without
dangling vertices the dangling-mass sum is an exact zero, where XLA and
torch would otherwise sum in different orders. The other PageRank cases
are held to the reference at rtol 1e-6 and to the port's host loop bit for
bit."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import janusgraph_tpu.olap as ref
from janusgraph_tpu.olap.programs import (
    ConnectedComponentsProgram as RefCC,
    PageRankProgram as RefPR,
    PeerPressureProgram as RefPP,
    ShortestPathProgram as RefSP,
    TraversalCountProgram as RefTC,
)
from janusgraph_tpu.olap.tpu_executor import TPUExecutor
from janusgraph_tpu_torch.olap import GPUExecutor, csr_from_edges
from janusgraph_tpu_torch.olap.programs import (
    ConnectedComponentsProgram,
    PageRankProgram,
    PeerPressureProgram,
    ShortestPathProgram,
    TraversalCountProgram,
)


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def edges(n=400, m=4000, seed=7, every_vertex_sends=True):
    rng = np.random.default_rng(seed)
    dst = (rng.zipf(1.4, m) % n).astype(np.int32)
    src = rng.integers(0, n, m).astype(np.int32)
    if every_vertex_sends:  # a ring: no dangling vertex
        src = np.concatenate([src, np.arange(n, dtype=np.int32)])
        dst = np.concatenate([dst, ((np.arange(n) + 1) % n).astype(np.int32)])
    return n, src, dst


_GRAPHS = {}


def graph(name):
    if name not in _GRAPHS:
        n, src, dst = edges(every_vertex_sends=name == "no_dangling", seed=7 if name == "no_dangling" else 9)
        _GRAPHS[name] = (ref.csr_from_edges(n, src, dst), csr_from_edges(n, src, dst))
    return _GRAPHS[name]


#: name: (port program, reference program, frontier mode, graph)
CASES = {
    "pagerank": (lambda: PageRankProgram(damping=0.5, max_iterations=13, tol=0.0),
                 lambda: RefPR(damping=0.5, max_iterations=13, tol=0.0), None, "no_dangling"),
    "pagerank_tol": (lambda: PageRankProgram(damping=0.5, tol=1e-4, max_iterations=100),
                     lambda: RefPR(damping=0.5, tol=1e-4, max_iterations=100), None, "no_dangling"),
    "cc": (lambda: ConnectedComponentsProgram(), lambda: RefCC(), "off", "dangling"),
    "bfs": (lambda: ShortestPathProgram(seed_index=0, max_iterations=5),
            lambda: RefSP(seed_index=0, max_iterations=5), "off", "dangling"),
    "bfs_undirected": (lambda: ShortestPathProgram(seed_index=0, undirected=True),
                       lambda: RefSP(seed_index=0, undirected=True), "off", "dangling"),
    "bfs_paths": (lambda: ShortestPathProgram(seed_index=0, track_paths=True),
                  lambda: RefSP(seed_index=0, track_paths=True), "off", "dangling"),
    "khop": (lambda: TraversalCountProgram(hops=3), lambda: RefTC(hops=3), None, "dangling"),
}


@pytest.mark.parametrize("strategy", ["ell", "hybrid", "segsum"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_fused_equals_host_loop_and_reference(name, strategy):
    make, make_ref, frontier, gname = CASES[name]
    rcsr, csr = graph(gname)
    ex = GPUExecutor(csr, strategy=strategy, device="cpu", hub_cutoff=8, tail_chunk=8)
    fused = ex.run(make(), frontier=frontier)
    info = dict(ex.last_run_info)
    host = ex.run(make(), frontier=frontier, fused=False)
    host_info = dict(ex.last_run_info)
    assert info["path"] == "fused" and host_info["path"] == "host-loop"
    assert info["supersteps"] == host_info["supersteps"]
    assert info["strategy_resolved"] == host_info["strategy_resolved"]
    ref_strategy = {"segsum": "pallas"}.get(strategy, strategy)
    rex = TPUExecutor(rcsr, strategy=ref_strategy, hub_cutoff=8, tail_chunk=8)
    want = rex.run(make_ref(), frontier=frontier, fused=True)
    assert rex.last_run_info["path"] == "fused"
    assert info["supersteps"] == rex.last_run_info["supersteps"]
    assert set(fused) == set(host) == set(want)
    for k in fused:
        np.testing.assert_array_equal(_bits(fused[k]), _bits(host[k]), err_msg=k)
        if ref_strategy == "pallas" and name.startswith("pagerank"):
            # the Pallas kernel sums in its own tile order (rtol 1e-4,
            # tests/test_kernels.py)
            np.testing.assert_allclose(fused[k], np.asarray(want[k]), rtol=1e-4, atol=1e-6)
        else:
            np.testing.assert_array_equal(_bits(fused[k]), _bits(np.asarray(want[k])), err_msg=k)


@pytest.mark.parametrize("strategy", ["ell", "segsum", "segment"])
def test_fused_pagerank_with_dangling_vertices(strategy):
    """Default damping, dangling vertices: the fused loop has the host
    loop's bits; the reference (FMA, its own summation order) is within
    rtol 1e-6."""
    rcsr, csr = graph("dangling")
    ex = GPUExecutor(csr, strategy=strategy, device="cpu")
    fused = ex.run(PageRankProgram(max_iterations=20, tol=0.0))["rank"]
    host = ex.run(PageRankProgram(max_iterations=20, tol=0.0), fused=False)["rank"]
    np.testing.assert_array_equal(_bits(fused), _bits(host))
    want = TPUExecutor(rcsr, strategy="ell").run(RefPR(max_iterations=20, tol=0.0), fused=True)
    np.testing.assert_allclose(fused, np.asarray(want["rank"]), rtol=1e-6, atol=1e-9)


def test_bounded_run_discards_nothing_and_early_stop_is_accounted():
    _rcsr, csr = graph("no_dangling")
    ex = GPUExecutor(csr, strategy="ell", device="cpu")
    ex.run(PageRankProgram(max_iterations=21, tol=0.0))
    info = ex.last_run_info
    assert info["supersteps"] == 21 and info["predicated_steps"] == 0
    # 1 eager superstep, then chunks of 8, 8, 4 (the powers of two that fit)
    assert info["chunks"] == 3 and info["host_syncs"] == 4
    # the cached loop runs no eager superstep: chunks of 8, 8, 4, 1
    ex.run(PageRankProgram(max_iterations=21, tol=0.0))
    assert ex.last_run_info["chunks"] == 4 and ex.last_run_info["predicated_steps"] == 0
    ex.run(ConnectedComponentsProgram(max_iterations=200))
    cc = ex.last_run_info
    host = GPUExecutor(csr, strategy="ell", device="cpu")
    host.run(ConnectedComponentsProgram(max_iterations=200), fused=False)
    assert cc["supersteps"] == host.last_run_info["supersteps"]
    assert 0 <= cc["predicated_steps"] < GPUExecutor.MAX_CHUNK


@pytest.mark.parametrize("max_chunk", [1, 2, 16])
def test_chunk_ladder_does_not_change_results(monkeypatch, max_chunk):
    _rcsr, csr = graph("dangling")
    want = GPUExecutor(csr, strategy="ell", device="cpu").run(
        ShortestPathProgram(seed_index=0), frontier="off", fused=False)
    monkeypatch.setattr(GPUExecutor, "MAX_CHUNK", max_chunk)
    ex = GPUExecutor(csr, strategy="ell", device="cpu")
    got = ex.run(ShortestPathProgram(seed_index=0), frontier="off")
    again = ex.run(ShortestPathProgram(seed_index=1), frontier="off")  # same loop, new seed
    want1 = GPUExecutor(csr, strategy="ell", device="cpu").run(
        ShortestPathProgram(seed_index=1), frontier="off", fused=False)
    np.testing.assert_array_equal(got["distance"], want["distance"])
    np.testing.assert_array_equal(again["distance"], want1["distance"])
    assert len(ex._fused_loops) == 1  # seed_index is a setup-only parameter


def test_peer_pressure_takes_the_host_loop():
    rcsr, csr = graph("dangling")
    ex = GPUExecutor(csr, device="cpu")
    assert not PeerPressureProgram().fused_eligible()
    got = ex.run(PeerPressureProgram(rounds=3), fused=True)
    assert ex.last_run_info["path"] == "host-loop"
    want = TPUExecutor(rcsr, strategy="ell").run(RefPP(rounds=3), fused=True)
    np.testing.assert_array_equal(got["cluster"], np.asarray(want["cluster"]))


def test_default_auto_run_equals_reference_default():
    rcsr, csr = graph("no_dangling")
    rex = TPUExecutor(rcsr)
    want = rex.run(RefPR(damping=0.5, tol=1e-5))
    ex = GPUExecutor(csr, strategy="auto", device="cpu")
    got = ex.run(PageRankProgram(damping=0.5, tol=1e-5))
    info, rinfo = ex.last_run_info, rex.last_run_info
    assert info["path"] == rinfo["path"] == "fused"
    assert info["supersteps"] == rinfo["supersteps"]
    np.testing.assert_array_equal(_bits(got["rank"]), _bits(np.asarray(want["rank"])))
    assert info["autotune"] == rinfo["autotune"]
    assert info["autotune"]["source"] == "model" and info["autotune"]["device_kind"] == "cpu"
    assert info["strategy_resolved"] == rinfo["strategy_resolved"]
    assert info["pad_ratio"] == rinfo["pad_ratio"] == rinfo["ell_pad_ratio"]


def test_auto_needs_the_tuner():
    _rcsr, csr = graph("no_dangling")
    with pytest.raises(ValueError, match="autotune=False"):
        GPUExecutor(csr, strategy="auto", device="cpu", autotune=False)
    # a named strategy runs without it, and reports no decision
    ex = GPUExecutor(csr, strategy="ell", device="cpu", autotune=False)
    ex.run(PageRankProgram(max_iterations=3, tol=0.0))
    assert "autotune" not in ex.last_run_info
    assert ex.frontier_engine().tier_source == "static"


def test_fused_eligibility_and_cache_key():
    assert PageRankProgram().fused_eligible() and ConnectedComponentsProgram().fused_eligible()
    assert ShortestPathProgram(seed_index=0).fused_eligible()
    assert TraversalCountProgram(hops=2).fused_eligible()
    a, b = ShortestPathProgram(seed_index=0), ShortestPathProgram(seed_index=5)
    assert a.cache_key() == b.cache_key()
    assert a.cache_key() != ShortestPathProgram(seed_index=0, undirected=True).cache_key()
    assert PageRankProgram(tol=0.0).cache_key() != PageRankProgram(tol=1e-3).cache_key()
    assert RefSP(seed_index=0).cache_key()[2] == a.cache_key()[2]


@pytest.mark.parametrize("steps", range(6))
def test_peer_pressure_terminate_device_is_elementwise(steps):
    """A device step counter: the predicate must stay a tensor (no bool()),
    equal to the reference's jnp predicate."""
    for changed in (0.0, 1.0):
        got = PeerPressureProgram().terminate_device(
            {"changed": torch.tensor(changed)}, torch.tensor(steps))
        want = RefPP().terminate_device(
            {"changed": jnp.asarray(changed)}, jnp.asarray(steps), jnp)
        assert isinstance(got, torch.Tensor) and got.dtype == torch.bool and got.ndim == 0
        assert bool(got) == bool(want)
