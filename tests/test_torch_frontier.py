"""The port's frontier engine held against the JAX package's.

Same edges, made with numpy from a seed, go through
``janusgraph_tpu_torch`` on the CPU and through the reference's
``TPUExecutor`` on JAX's CPU backend: both with ``autotune=False`` (the
static frontier tiers) in the parity matrix, and both with their defaults
(the autotuned ladders) in the tuned-ladder tests. BFS/SSSP/CC distances,
labels and predecessors must be equal bit for bit on the frontier and the
dense (fused) path of both packages, the per-hop tier trace equal hop for
hop, and ``capped_expand`` equal to the reference's in every slot, valid or
not."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import janusgraph_tpu.olap as ref
from janusgraph_tpu.olap.frontier import _tier as ref_tier
from janusgraph_tpu.olap.frontier import capped_expand as ref_capped_expand
from janusgraph_tpu.olap.programs import (
    ConnectedComponentsProgram as RefCC,
    ShortestPathProgram as RefSP,
)
from janusgraph_tpu.olap.tpu_executor import TPUExecutor
from janusgraph_tpu_torch.olap import FrontierEngine, GPUExecutor, csr_from_edges, run_on
from janusgraph_tpu_torch.olap.frontier import _tier, capped_expand, compact
from janusgraph_tpu_torch.olap.programs import (
    ConnectedComponentsProgram,
    ShortestPathProgram,
)
from janusgraph_tpu_torch.olap.vertex_program import INF


def random_edges(n=300, m=1500, seed=7, weights=False):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, m).astype(np.int32)
    dst = rng.integers(0, n, m).astype(np.int32)
    w = rng.uniform(0.5, 2.0, m).astype(np.float32) if weights else None
    return n, src, dst, w


def supernode_edges(n=400, seed=3):
    """Vertex 0 is a hub (out-edges to half the graph), many deg-0
    vertices, plus a sparse tail: deg-0 collapse in the ownership scatter
    and uneven tier growth."""
    rng = np.random.default_rng(seed)
    hub_dst = np.arange(1, n // 2, dtype=np.int32)
    tail_src = rng.integers(1, n // 2, 200).astype(np.int32)
    tail_dst = rng.integers(0, n, 200).astype(np.int32)
    src = np.concatenate([np.zeros(len(hub_dst), np.int32), tail_src])
    return n, src, np.concatenate([hub_dst, tail_dst]), None


class Pair:
    """One graph in both packages, with one executor each, reused;
    ``ref_kw`` goes to the reference's executor alone."""

    def __init__(self, n, src, dst, w, frontier="auto", **ref_kw):
        self.ref_csr = ref.csr_from_edges(n, src, dst, w)
        self.csr = csr_from_edges(n, src, dst, w)
        self.ref = TPUExecutor(
            self.ref_csr, strategy="ell", autotune=False, frontier=frontier, **ref_kw
        )
        self.port = GPUExecutor(self.csr, device="cpu", frontier=frontier, autotune=False)


_PAIRS = {}


def pair(name):
    if name not in _PAIRS:
        builders = {
            "random": lambda: Pair(*random_edges()),
            "random_weighted": lambda: Pair(*random_edges(weights=True)),
            "supernode": lambda: Pair(*supernode_edges()),
            "small_tiers": lambda: Pair(
                *random_edges(weights=True), frontier_f_min=4, frontier_e_min=8,
            ),
            "cutoff": lambda: Pair(*random_edges(n=120, m=500, seed=11)),
        }
        _PAIRS[name] = builders[name]()
    return _PAIRS[name]


def run_all(p, make_port, make_ref, **kw):
    """(port frontier, port dense, ref frontier, ref dense) results and the
    two frontier runs' run info."""
    pf = p.port.run(make_port(), **kw)
    pf_info = dict(p.port.last_run_info)
    pd = p.port.run(make_port(), frontier="off", **kw)
    assert p.port.last_run_info["path"] == "fused"
    rf = p.ref.run(make_ref(), **kw)
    rf_info = dict(p.ref.last_run_info)
    rd = p.ref.run(make_ref(), frontier="off", **kw)
    return pf, pd, rf, rd, pf_info, rf_info


def assert_bitwise(got, *wants):
    for want in wants:
        assert set(got) == set(want)
        for k in got:
            a = np.asarray(want[k])
            assert got[k].dtype == a.dtype, k
            np.testing.assert_array_equal(got[k].view(np.int32), a.view(np.int32), err_msg=k)


# ------------------------------------------------------------------ tiers
@pytest.mark.parametrize("growth", [2, 4, 8])
def test_tier_equals_reference(growth):
    for lo in (1, 4, 1 << 10):
        for hi in (5, 300, 1 << 16, 1 << 20):
            for need in (1, 2, 3, lo - 1, lo, lo + 1, 257, hi // 2, hi):
                if 1 <= need <= hi:
                    assert _tier(need, lo, hi, growth) == ref_tier(need, lo, hi, growth)
    with pytest.raises(ValueError, match="growth"):
        _tier(3, 1, 10, 1)


# --------------------------------------------------------- capped expand
def _expand_case(degs, frontier, pad, e_slack, seed=0):
    """Rows with the given degrees; expand ``frontier`` (row indices) padded
    with ``pad`` sentinel rows at E_cap = total + e_slack."""
    rng = np.random.default_rng(seed)
    n = len(degs)
    indptr = np.zeros(n + 1, np.int64)
    np.cumsum(degs, out=indptr[1:])
    m = int(indptr[-1])
    dst = rng.integers(0, n, max(m, 1)).astype(np.int32)  # one slot when m == 0
    ip = np.concatenate([indptr, indptr[-1:]]).astype(np.int32)
    idx = np.concatenate([np.asarray(frontier, np.int32), np.full(pad, n, np.int32)])
    total = int(np.sum(np.asarray(degs)[np.asarray(frontier, np.int64)])) if len(frontier) else 0
    e_cap = max(total + e_slack, 1)
    return idx, ip, dst, e_cap, n, total


EXPAND_CASES = {
    # name: (degrees, frontier rows, sentinel pads, E_cap - total)
    "dense_exact": ([3, 1, 4, 1, 5], [0, 1, 2, 3, 4], 0, 0),
    "slack": ([3, 1, 4, 1, 5], [0, 2, 4], 0, 7),
    "leading_deg0": ([0, 0, 2, 3, 1], [0, 1, 2, 3, 4], 0, 0),
    "trailing_deg0_total_eq_cap": ([2, 3, 1, 0, 0], [0, 1, 2, 3, 4], 0, 0),
    "trailing_deg0_slack": ([2, 3, 1, 0, 0], [0, 1, 2, 3, 4], 0, 5),
    "deg0_runs": ([0, 2, 0, 0, 3, 0, 1, 0, 0, 0, 4, 0], list(range(12)), 0, 0),
    "sentinel_pad_total_eq_cap": ([2, 0, 5, 1], [0, 2, 3], 5, 0),
    "sentinel_pad_slack": ([2, 0, 5, 1], [0, 1, 3], 6, 3),
    "all_deg0": ([0, 0, 0], [0, 1, 2], 2, 4),
}


@pytest.mark.parametrize("name", sorted(EXPAND_CASES))
def test_capped_expand_equals_reference_in_every_slot(name):
    degs, frontier, pad, slack = EXPAND_CASES[name]
    idx, ip, dst, e_cap, n, total = _expand_case(degs, frontier, pad, slack)
    want = ref_capped_expand(
        jnp, jnp.asarray(idx), jnp.asarray(ip), jnp.asarray(dst), e_cap, n
    )
    got = capped_expand(
        torch.as_tensor(idx.astype(np.int64)), torch.as_tensor(ip.astype(np.int64)),
        torch.as_tensor(dst), e_cap, n,
    )
    for label, g, w in zip(("own", "pos", "nbr", "valid"), got, want):
        w = np.asarray(w)
        assert g.shape == w.shape, label
        np.testing.assert_array_equal(g.numpy(), w, err_msg=label)
    assert int(got[3].sum()) == total


def test_capped_expand_random_rows_equal_reference():
    """Random degree-0 runs and frontiers at one shape (40 frontier slots,
    E_cap 128), so the reference compiles once."""
    rng = np.random.default_rng(5)
    ref_fn = jax.jit(functools.partial(ref_capped_expand, jnp), static_argnums=(3, 4))
    for trial in range(8):
        degs = rng.integers(0, 4, 40) * (rng.random(40) < 0.7)
        k = int(rng.integers(1, 40))
        frontier = np.sort(rng.choice(40, k, replace=False))
        idx, ip, dst, _, n, total = _expand_case(degs, frontier, 40 - k, 0, seed=trial)
        want = ref_fn(jnp.asarray(idx), jnp.asarray(ip), jnp.asarray(dst), 128, n)
        got = capped_expand(
            torch.as_tensor(idx.astype(np.int64)), torch.as_tensor(ip.astype(np.int64)),
            torch.as_tensor(dst), 128, n,
        )
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        assert int(got[3].sum()) == total


@pytest.mark.parametrize("f_cap", [1, 3, 8, 20])
def test_compact_equals_nonzero_with_fill(f_cap):
    rng = np.random.default_rng(f_cap)
    mask = rng.random(20) < 0.3
    want = np.asarray(jnp.nonzero(jnp.asarray(mask), size=f_cap, fill_value=20)[0])
    got = compact(torch.as_tensor(mask), f_cap, 20)
    np.testing.assert_array_equal(got.numpy(), want)


# ----------------------------------------------------- BFS / SSSP parity
CASES = [
    ("bfs", dict()),
    ("bfs_undirected", dict(undirected=True)),
    ("weighted", dict(weighted=True)),
    ("weighted_undirected", dict(weighted=True, undirected=True)),
    ("tracked", dict(track_paths=True)),
]


@pytest.mark.parametrize("name,kw", CASES, ids=[c[0] for c in CASES])
def test_frontier_equals_dense_and_reference_bitwise(name, kw):
    p = pair("random_weighted" if kw.get("weighted") else "random")
    pf, pd, rf, rd, pf_info, rf_info = run_all(
        p, lambda: ShortestPathProgram(seed_index=0, **kw), lambda: RefSP(seed_index=0, **kw)
    )
    assert pf_info["path"] == "frontier" == rf_info["path"]
    assert pf_info["tiers"] == rf_info["tiers"]
    assert set(pf) == {"distance", "predecessor"} if kw.get("track_paths") else {"distance"}
    assert_bitwise(pf, pd, rf, rd)
    oracle = ref.run_on(p.ref_csr, RefSP(seed_index=0, **kw), "cpu")
    d = np.where(pf["distance"] >= 1e17, np.inf, pf["distance"])
    o = np.where(np.asarray(oracle["distance"]) >= 1e17, np.inf, oracle["distance"])
    np.testing.assert_allclose(d, o, rtol=1e-6)


def test_supernode_graph_bitwise():
    p = pair("supernode")
    for kw in (dict(), dict(undirected=True), dict(track_paths=True)):
        pf, pd, rf, rd, pf_info, rf_info = run_all(
            p, lambda: ShortestPathProgram(seed_index=0, **kw), lambda: RefSP(seed_index=0, **kw)
        )
        assert pf_info["tiers"] == rf_info["tiers"]
        assert_bitwise(pf, pd, rf, rd)


def test_hop_trace_over_many_tiers_equals_reference(monkeypatch):
    """Small F_MIN/E_MIN: the ladder moves up and down across hops."""
    monkeypatch.setattr(FrontierEngine, "F_MIN", 4)
    monkeypatch.setattr(FrontierEngine, "E_MIN", 8)
    p = pair("small_tiers")
    for kw in (dict(), dict(weighted=True, undirected=True)):
        pf, pd, rf, rd, pf_info, rf_info = run_all(
            p, lambda: ShortestPathProgram(seed_index=3, **kw), lambda: RefSP(seed_index=3, **kw)
        )
        caps = {(t["F_cap"], t["E_cap"]) for t in pf_info["tiers"]}
        assert len(caps) >= 3, caps
        assert pf_info["tiers"] == rf_info["tiers"]
        assert all(t["tier_source"] == "static" for t in pf_info["tiers"])
        assert len(pf_info["hop_wall_s"]) == pf_info["supersteps"] == len(pf_info["tiers"])
        assert_bitwise(pf, pd, rf, rd)


@pytest.mark.parametrize("max_iter", [0, 1, 2, 3])
def test_step_parity_at_cutoff(max_iter):
    p = pair("cutoff")
    pf, pd, rf, rd, pf_info, rf_info = run_all(
        p,
        lambda: ShortestPathProgram(seed_index=0, max_iterations=max_iter),
        lambda: RefSP(seed_index=0, max_iterations=max_iter),
    )
    assert pf_info["supersteps"] == len(rf_info["tiers"]) <= max_iter
    assert_bitwise(pf, pd, rf, rd)


def test_default_run_on_takes_frontier_and_records_tiers():
    n, src, dst, w = random_edges(n=200, m=900, seed=31)
    ex = GPUExecutor(csr_from_edges(n, src, dst, w), device="cpu")
    ex.run(ShortestPathProgram(seed_index=0, max_iterations=4))
    info = ex.last_run_info
    assert info["path"] == "frontier" and 1 <= info["supersteps"] <= 4
    assert info["tiers"][0]["frontier"] == 1  # hop 0: the seed alone
    assert all(t["E_cap"] >= t["edges"] for t in info["tiers"])
    assert info["kernel_launches"] == 0
    out = run_on(csr_from_edges(n, src, dst, w), ShortestPathProgram(seed_index=0), device="cpu")
    assert out["distance"][0] == 0.0


# ------------------------------------------------------------- frontier CC
def test_cc_auto_heuristic():
    """"auto" runs CC dense (the faster CC on the card) and BFS through the
    frontier; "always" takes the frontier for CC as well."""
    n, src, dst, w = random_edges(n=50, m=120)
    ex = GPUExecutor(csr_from_edges(n, src, dst, w), device="cpu")
    assert not ex._frontier_eligible(ConnectedComponentsProgram(), "auto")
    assert ex._frontier_eligible(ConnectedComponentsProgram(), "always")
    assert ex._frontier_eligible(ShortestPathProgram(seed_index=0), "auto")
    want = ex.run(ConnectedComponentsProgram())
    assert ex.last_run_info["path"] == "fused"
    assert ex.last_run_info["strategy_resolved"] == "ell"
    got = ex.run(ConnectedComponentsProgram(), frontier="always")
    assert ex.last_run_info["path"] == "frontier"
    assert_bitwise(got, want)


@pytest.mark.parametrize("max_iter", [1, 2, 100])
def test_frontier_cc_equals_reference(max_iter):
    n, src, dst, w = random_edges(n=250, m=600, seed=23)
    p = Pair(n, src, dst, w, frontier="always")
    got = p.port.run(ConnectedComponentsProgram(max_iterations=max_iter))
    info = dict(p.port.last_run_info)
    want = p.ref.run(RefCC(max_iterations=max_iter))
    assert info["path"] == "frontier" and info["tiers"] == p.ref.last_run_info["tiers"]
    dense = p.port.run(ConnectedComponentsProgram(max_iterations=max_iter), frontier="off")
    ref_dense = p.ref.run(RefCC(max_iterations=max_iter), frontier="off")
    assert_bitwise(got, dense, want, ref_dense)
    if max_iter == 100:
        oracle = ref.run_on(p.ref_csr, RefCC(max_iterations=100), "cpu")
        np.testing.assert_array_equal(got["component"], np.asarray(oracle["component"], np.float32))


# --------------------------------------------------------------- routing
def test_always_raises_on_ineligible_graph(monkeypatch):
    n, src, dst, w = random_edges(n=50, m=200)
    csr = csr_from_edges(n, src, dst, w)
    monkeypatch.setattr(FrontierEngine, "MAX_EDGES", 100)
    ex = GPUExecutor(csr, device="cpu", frontier="always")
    with pytest.raises(ValueError, match="exceeds the frontier engine's guards"):
        ex.run(ShortestPathProgram(seed_index=0))
    with pytest.raises(ValueError, match="exceeds the frontier engine's guards"):
        GPUExecutor(csr, device="cpu").run(ConnectedComponentsProgram(), frontier="always")
    # "auto" quietly takes the dense path on the same graph
    GPUExecutor(csr, device="cpu").run(ShortestPathProgram(seed_index=0))
    with pytest.raises(ValueError, match="frontier mode"):
        GPUExecutor(csr, device="cpu", frontier="sometimes")
    with pytest.raises(ValueError, match="frontier mode"):
        ex.run(ShortestPathProgram(seed_index=0), frontier="sometimes")


def test_subclass_and_off_run_dense():
    n, src, dst, w = random_edges(n=50, m=200)
    csr = csr_from_edges(n, src, dst, w)

    class Custom(ShortestPathProgram):
        pass

    ex = GPUExecutor(csr, device="cpu")
    assert not ex._frontier_eligible(Custom(seed_index=0), "auto")
    got = ex.run(Custom(seed_index=0))
    assert ex.last_run_info["path"] == "fused"
    off = GPUExecutor(csr, device="cpu", frontier="off")
    want = off.run(ShortestPathProgram(seed_index=0))
    assert off.last_run_info["path"] == "fused"
    np.testing.assert_array_equal(got["distance"], want["distance"])
    ex.run(ShortestPathProgram(seed_index=0))
    assert ex.last_run_info["path"] == "frontier"

    class Declared(ShortestPathProgram):
        frontier_kind = "sssp"

    again = ex.run(Declared(seed_index=0))
    assert ex.last_run_info["path"] == "frontier"
    np.testing.assert_array_equal(again["distance"], want["distance"])


# ----------------------------------------------------------- edge graphs
def test_isolated_seed_and_empty_graph():
    empty = csr_from_edges(5, np.zeros(0, np.int32), np.zeros(0, np.int32))
    ex = GPUExecutor(empty, device="cpu")
    d = ex.run(ShortestPathProgram(seed_index=2))["distance"]
    assert ex.last_run_info["path"] == "frontier" and ex.last_run_info["tiers"] == []
    assert d[2] == 0 and np.all(np.delete(d, 2) == np.float32(INF))
    comp = ex.run(ConnectedComponentsProgram(), frontier="always")["component"]
    np.testing.assert_array_equal(comp, np.arange(5, dtype=np.float32))
    # an isolated seed in a graph with edges: one hop, nothing reached
    src = np.array([0, 1, 3], np.int32)
    dst = np.array([1, 3, 0], np.int32)
    rg = ref.csr_from_edges(5, src, dst)
    ex = GPUExecutor(csr_from_edges(5, src, dst), device="cpu")
    got = ex.run(ShortestPathProgram(seed_index=4, undirected=True))
    want = TPUExecutor(rg, strategy="ell", autotune=False).run(
        RefSP(seed_index=4, undirected=True)
    )
    assert_bitwise(got, want)
    assert [t["frontier"] for t in ex.last_run_info["tiers"]] == [1]


def test_line_graph_many_hops():
    n = 40
    csr = csr_from_edges(n, np.arange(n - 1, dtype=np.int32), np.arange(1, n, dtype=np.int32))
    res = GPUExecutor(csr, device="cpu").run(ShortestPathProgram(seed_index=0))
    np.testing.assert_array_equal(res["distance"], np.arange(n, dtype=np.float32))


# ------------------------------------------------------- tuned tier ladders
def _hub_graph(seed=5, n=3000, m=30000):
    """Skewed out-degrees, so a hub BFS climbs the tuned E ladder."""
    rng = np.random.default_rng(seed)
    src = (rng.zipf(1.4, m) % n).astype(np.int32)
    dst = rng.integers(0, n, m).astype(np.int32)
    return n, src, dst, None


@pytest.mark.parametrize("kw", [dict(), dict(undirected=True), dict(track_paths=True)],
                         ids=["bfs", "undirected", "tracked"])
def test_tuned_ladder_trace_equals_reference_default(kw):
    """Both packages with their defaults: every hop prices on the
    autotuner's ladders (tier_source "autotune"), hop for hop the same."""
    n, src, dst, w = _hub_graph()
    rg = ref.csr_from_edges(n, src, dst, w)
    seed = int(np.argmax(rg.out_degree))
    rex = TPUExecutor(rg)
    want = rex.run(RefSP(seed_index=seed, max_iterations=4, **kw))
    ex = GPUExecutor(csr_from_edges(n, src, dst, w), strategy="auto", device="cpu")
    got = ex.run(ShortestPathProgram(seed_index=seed, max_iterations=4, **kw))
    info, rinfo = ex.last_run_info, rex.last_run_info
    assert info["path"] == "frontier" == rinfo["path"]
    assert info["tiers"] == rinfo["tiers"] and len(info["tiers"]) >= 3
    assert all(t["tier_source"] == "autotune" for t in info["tiers"])
    # the engine prices on the directed view's ladder, whatever the view
    sched = ex.frontier_engine().e_schedule
    assert sched == rex._frontier_engine.e_schedule
    assert all(t["E_cap"] in sched for t in info["tiers"])
    assert info["autotune"] == rinfo["autotune"]
    assert_bitwise(got, want)


def test_tuned_and_static_ladders_give_the_same_distances():
    n, src, dst, w = _hub_graph(seed=9)
    csr = csr_from_edges(n, src, dst, w)
    seed = int(np.argmax(csr.out_degree))
    tuned = GPUExecutor(csr, device="cpu")
    static = GPUExecutor(csr, device="cpu", autotune=False)
    a = tuned.run(ShortestPathProgram(seed_index=seed, max_iterations=5))
    b = static.run(ShortestPathProgram(seed_index=seed, max_iterations=5))
    assert_bitwise(a, b)
    assert {t["tier_source"] for t in tuned.last_run_info["tiers"]} == {"autotune"}
    assert {t["tier_source"] for t in static.last_run_info["tiers"]} == {"static"}
    assert "autotune" not in static.last_run_info
