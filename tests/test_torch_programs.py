"""The port's TraversalCount, PeerPressure and ShortestPath helpers held
against the JAX package's on the same graphs.

The reference side runs as its own tests run it: ``TPUExecutor(...,
strategy="ell", autotune=False)`` on JAX's CPU backend, and
``janusgraph_tpu.olap.run_on(..., "cpu")`` as the scalar oracle.
TraversalCount is held at the reference's rtol=1e-4 (tests/test_kernels.py);
PeerPressure's counts are small integers and its MIN phase has no order, so
its labels must be equal bit for bit."""

import numpy as np
import pytest
import torch

import janusgraph_tpu.olap as ref
from janusgraph_tpu.olap.programs import (
    ConnectedComponentsProgram as RefCC,
    PeerPressureProgram as RefPP,
    ShortestPathProgram as RefSP,
    TraversalCountProgram as RefTC,
)
from janusgraph_tpu.olap.programs.shortest_path import (
    reconstruct_path as ref_reconstruct_path,
    weighted_predecessors as ref_weighted_predecessors,
)
from janusgraph_tpu.olap.tpu_executor import TPUExecutor
from janusgraph_tpu_torch.olap import (
    Combiner,
    GPUExecutor,
    VertexProgram,
    csr_from_edges,
    rmat_edges,
    run_on,
)
from janusgraph_tpu_torch.olap.programs import (
    ConnectedComponentsProgram,
    PageRankProgram,
    PeerPressureProgram,
    ShortestPathProgram,
    TraversalCountProgram,
    reconstruct_path,
    weighted_predecessors,
)


def _random(n=240, m=1100, seed=17, weights=True):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, m).astype(np.int32)
    dst = rng.integers(0, n, m).astype(np.int32)
    w = rng.uniform(0.5, 2.0, m).astype(np.float32) if weights else None
    return n, src, dst, w


def _rmat8():
    n, src, dst = rmat_edges(8, 16, seed=3)
    return n, src, dst, None


GRAPHS = {"random": _random, "rmat8": _rmat8}
_CACHE = {}


def graph(name):
    """(port CSR, reference CSR, reference executor), built once."""
    if name not in _CACHE:
        n, src, dst, w = GRAPHS[name]()
        rg = ref.csr_from_edges(n, src, dst, w)
        _CACHE[name] = (
            csr_from_edges(n, src, dst, w), rg,
            TPUExecutor(rg, strategy="ell", autotune=False),
        )
    return _CACHE[name]


def test_combiner_for_defaults_to_combiner():
    assert PageRankProgram().combiner_for(7) == Combiner.SUM
    assert ConnectedComponentsProgram().combiner_for(0) == Combiner.MIN
    pp = PeerPressureProgram()
    assert [pp.combiner_for(s) for s in range(4)] == ["sum", "min", "sum", "min"]
    assert VertexProgram.combiner_for is not PeerPressureProgram.combiner_for


# --------------------------------------------------------- TraversalCount
@pytest.mark.parametrize("strategy", ["segsum", "ell", "segment"])
@pytest.mark.parametrize("hops", [1, 2, 3])
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_traversal_count_matches_reference(name, hops, strategy):
    csr, rg, rex = graph(name)
    ex = GPUExecutor(csr, strategy=strategy, device="cpu")
    got = ex.run(TraversalCountProgram(hops=hops))
    info = ex.last_run_info
    assert info["path"] == "fused" and info["supersteps"] == hops
    assert info["strategy_resolved"] == strategy and info["kernel_launches"] == 0
    for want in (rex.run(RefTC(hops=hops)), ref.run_on(rg, RefTC(hops=hops), "cpu")):
        np.testing.assert_allclose(
            got["count"].astype(np.float64), np.asarray(want["count"], np.float64),
            rtol=1e-4, atol=1e-5,
        )


def test_traversal_count_total_equals_matrix_product():
    csr, _rg, _ = graph("rmat8")
    n = csr.num_vertices
    src = np.repeat(np.arange(n), np.diff(csr.out_indptr))
    adj = np.zeros((n, n))
    np.add.at(adj, (src, csr.out_dst), 1.0)
    want = adj.T @ (adj.T @ (adj.T @ np.ones(n)))
    got = run_on(csr, TraversalCountProgram(hops=3), device="cpu")["count"]
    np.testing.assert_allclose(got.astype(np.float64), want, rtol=1e-4)


# ----------------------------------------------------------- PeerPressure
@pytest.mark.parametrize("strategy", ["segsum", "ell", "segment"])
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_peer_pressure_labels_bitwise(name, strategy):
    csr, rg, rex = graph(name)
    ex = GPUExecutor(csr, strategy=strategy, device="cpu")
    got = ex.run(PeerPressureProgram(rounds=5), sync_every=5)
    want = rex.run(RefPP(rounds=5), sync_every=5)
    assert set(got) == {"cluster", "chosen"}
    np.testing.assert_array_equal(got["cluster"], np.asarray(want["cluster"]))
    np.testing.assert_array_equal(got["chosen"], np.asarray(want["chosen"]))
    assert got["cluster"].dtype == np.float32 and got["chosen"].dtype == np.int32
    info = ex.last_run_info
    assert info["supersteps"] == rex.last_run_info["supersteps"] == 10
    # the kernel sums scalars only: under "segsum" the [n, K] count phase
    # takes ELL (bitwise, never the segment fold's atomics), as does the
    # MIN phase
    assert info["strategy_resolved"] == {
        "segsum": "ell",
        "ell": "ell",
        "segment": "segment",
    }[strategy]
    # labels propagate: fewer clusters than vertices
    assert len(np.unique(got["cluster"])) < csr.num_vertices


def test_peer_pressure_to_convergence_matches_reference_and_oracle():
    csr, rg, rex = graph("random")
    got = run_on(csr, PeerPressureProgram(), device="cpu")
    np.testing.assert_array_equal(got["cluster"], np.asarray(rex.run(RefPP())["cluster"]))
    oracle = ref.run_on(rg, RefPP(), "cpu")
    np.testing.assert_array_equal(got["cluster"], np.asarray(oracle["cluster"], np.float32))


def test_peer_pressure_phase_branch_is_plain_python():
    """The superstep is a Python int: no traced branch, each phase returns
    its own message shape and metrics."""
    csr, _rg, _ = graph("random")
    ex = GPUExecutor(csr, device="cpu")
    prog = PeerPressureProgram(num_buckets=8)
    state, _ = prog.setup(ex.g)
    count_msg = prog.message(state, 0, ex.g)
    label_msg = prog.message(state, 1, ex.g)
    assert count_msg.shape == label_msg.shape == (csr.num_vertices, 8)
    assert set(torch.unique(count_msg).tolist()) == {0.0, 1.0}
    assert torch.all(count_msg.sum(dim=1) == 1)


# ------------------------------------------------------------- sync_every
@pytest.mark.parametrize("sync_every", [2, 3, 7])
def test_sync_every_changes_no_result(sync_every):
    csr, _rg, _ = graph("random")
    ex = GPUExecutor(csr, device="cpu")
    for make, key in (
        (lambda: PeerPressureProgram(rounds=4), "cluster"),
        (lambda: TraversalCountProgram(hops=3), "count"),
        (lambda: ConnectedComponentsProgram(), "component"),
        (lambda: ShortestPathProgram(seed_index=1, weighted=True), "distance"),
    ):
        base = ex.run(make(), frontier="off")
        steps = ex.last_run_info["supersteps"]
        got = ex.run(make(), frontier="off", sync_every=sync_every)
        np.testing.assert_array_equal(got[key], base[key])
        # terminate is read only at a sync: a run stops at the first sync
        # at or after the step where it could stop
        assert steps <= ex.last_run_info["supersteps"] <= steps + sync_every - 1
    with pytest.raises(ValueError, match="sync_every"):
        ex.run(TraversalCountProgram(hops=1), sync_every=0)


def test_sync_every_fetches_only_at_syncs(monkeypatch):
    csr, _rg, _ = graph("random")
    ex = GPUExecutor(csr, device="cpu")
    seen = []
    prog = PeerPressureProgram(rounds=5)
    orig = prog.terminate
    monkeypatch.setattr(prog, "terminate", lambda memory: seen.append(memory.superstep) or orig(memory))
    ex.run(prog, sync_every=4)
    assert seen == [4, 8, 10]


# ------------------------------------------------- paths and predecessors
def test_weighted_predecessors_and_paths_equal_reference():
    csr, rg, rex = graph("random")
    want = rex.run(RefSP(seed_index=0, weighted=True))
    got = run_on(csr, ShortestPathProgram(seed_index=0, weighted=True), device="cpu")
    np.testing.assert_array_equal(got["distance"], np.asarray(want["distance"]))
    pred = weighted_predecessors(csr, got, 0)
    np.testing.assert_array_equal(pred, ref_weighted_predecessors(rg, want, 0))
    assert (pred >= 0).sum() > 10
    tracked = run_on(csr, ShortestPathProgram(seed_index=0, track_paths=True), device="cpu")
    ref_tracked = rex.run(RefSP(seed_index=0, track_paths=True))
    weighted = {"distance": got["distance"], "predecessor": pred.astype(np.float32)}
    for v in range(csr.num_vertices):
        assert reconstruct_path(tracked, v) == ref_reconstruct_path(ref_tracked, v)
        assert reconstruct_path(weighted, v) == ref_reconstruct_path(weighted, v)
    dist = tracked["distance"]
    for v in np.nonzero(dist < 1e17)[0][:25]:
        path = reconstruct_path(tracked, int(v))
        assert path[0] == 0 and path[-1] == v and len(path) == int(dist[v]) + 1
        for a, b in zip(path, path[1:]):
            assert b in csr.out_dst[csr.out_indptr[a]:csr.out_indptr[a + 1]]
    with pytest.raises(ValueError, match="weights"):
        weighted_predecessors(graph("rmat8")[0], got, 0)
    with pytest.raises(ValueError, match="track_paths"):
        ShortestPathProgram(seed_index=0, weighted=True, track_paths=True)


def test_weighted_sssp_on_weightless_csr_raises():
    csr, _rg, _ = graph("rmat8")
    with pytest.raises(ValueError, match="edge weights"):
        run_on(csr, ShortestPathProgram(seed_index=0, weighted=True), device="cpu")


def test_dense_cc_and_sssp_match_reference_under_every_strategy():
    csr, _rg, rex = graph("random")
    for strategy in ("segsum", "ell", "segment"):
        ex = GPUExecutor(csr, strategy=strategy, device="cpu", frontier="off")
        got = ex.run(ShortestPathProgram(seed_index=2, weighted=True, undirected=True))
        want = rex.run(RefSP(seed_index=2, weighted=True, undirected=True), frontier="off")
        np.testing.assert_array_equal(got["distance"], np.asarray(want["distance"]))
        got = ex.run(ConnectedComponentsProgram())
        np.testing.assert_array_equal(
            got["component"], np.asarray(rex.run(RefCC(), frontier="off")["component"])
        )
