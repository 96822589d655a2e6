"""The propagation-blocked halo exchange of the port's sharded executor held
to the JAX package's — the twins of ``tests/test_blocked_exchange.py``.

Contracts, on a mesh of 8 CPU slots beside the reference's 8 virtual
devices:

* MIN programs (BFS/SSSP/CC) are bitwise equal between the blocked and the
  eager exchange, dense and frontier, and equal to the reference's.
* SUM programs are bitwise equal to the plan's numpy replay
  (``halo.replay_superstep``), for both aggregation forms. On the CPU
  torch's ``index_add_`` adds in index order, as ``np.add.at`` does
  (checked here); on the card the segment form's SUM goes through float
  atomics and meets the replay to 1e-4 only (``chip_smoke.py``), while the
  packed ("ell") form stays bitwise for every monoid.
* blocked agrees with eager to 1e-5/1e-8 and with the CPU oracle to
  1e-4/1e-6, the reference's tolerances.
* the distributed plan build, a halo drop and a preemption resumed
  bitwise, the measured walls, the exchange record, ``decide_sharded``
  (equal to the reference's decision on the CPU) and the
  ``computer.sharded-auto`` routing.
"""

import numpy as np
import pytest
import torch

from janusgraph_tpu.olap import autotune as ref_autotune
from janusgraph_tpu.olap import csr_from_edges as ref_csr_from_edges
from janusgraph_tpu.olap import programs as ref_programs
from janusgraph_tpu.olap.cpu_executor import CPUExecutor
from janusgraph_tpu.parallel import ShardedExecutor as RefShardedExecutor
from janusgraph_tpu.parallel import halo as ref_halo
from janusgraph_tpu_torch.olap import autotune
from janusgraph_tpu_torch.olap import csr_from_edges
from janusgraph_tpu_torch.olap import programs
from janusgraph_tpu_torch.olap.vertex_program import Combiner, VertexProgram
from janusgraph_tpu_torch.parallel import Mesh, ShardedExecutor, halo
from janusgraph_tpu_torch.parallel.sharded import ShardedCSR

CPU = torch.device("cpu")


def graphs(n=170, m=700, seed=11, weights=False):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, m).astype(np.int32)
    dst = rng.integers(0, n, m).astype(np.int32)
    w = rng.uniform(0.5, 2.0, m).astype(np.float32) if weights else None
    return ref_csr_from_edges(n, src, dst, w), csr_from_edges(n, src, dst, w)


@pytest.fixture(scope="module")
def mesh8():
    return Mesh([CPU] * 8)


@pytest.fixture(scope="module")
def ref_mesh8():
    import jax
    from jax.sharding import Mesh as JaxMesh

    return JaxMesh(np.array(jax.devices()[:8]), ("p",))


# ------------------------------------------------------ bitwise: MIN family
@pytest.mark.parametrize("agg", ["ell", "segment"])
@pytest.mark.parametrize("name,make", [
    ("bfs", lambda P: P.ShortestPathProgram(seed_index=0)),
    ("sssp_w", lambda P: P.ShortestPathProgram(seed_index=3, weighted=True)),
    ("cc", lambda P: P.ConnectedComponentsProgram()),
])
def test_blocked_bitwise_min_family_dense_path(mesh8, ref_mesh8, agg, name, make):
    """Blocked against eager on dense supersteps: MIN merges do not depend
    on the order, so the restructured exchange changes no bit, and the
    result is the reference's blocked run's."""
    rg, pg = graphs(weights=True)
    rb = ShardedExecutor(pg, mesh=mesh8, exchange="blocked", agg=agg).run(make(programs), frontier="off")
    re_ = ShardedExecutor(pg, mesh=mesh8).run(make(programs), frontier="off")
    want = RefShardedExecutor(rg, mesh=ref_mesh8, exchange="blocked", agg=agg).run(
        make(ref_programs), frontier="off")
    cpu = CPUExecutor(rg).run(make(ref_programs))
    for k in rb:
        np.testing.assert_array_equal(rb[k], re_[k], err_msg=f"{name}:{k}")
        np.testing.assert_array_equal(rb[k], np.asarray(want[k]), err_msg=f"{name}:{k}")
        np.testing.assert_allclose(np.asarray(rb[k], np.float64), cpu[k], rtol=1e-5, atol=1e-6)


def test_blocked_frontier_bitwise_and_collapsed_expansion(mesh8, ref_mesh8):
    """The frontier engine under the blocked exchange: sender-merged
    relaxation bins, bitwise hops, and the reference's hop trace."""
    rg, pg = graphs(n=190, m=900, seed=5, weights=True)
    blocked = ShardedExecutor(pg, mesh=mesh8, exchange="blocked")
    eager = ShardedExecutor(pg, mesh=mesh8)
    ref_blocked = RefShardedExecutor(rg, mesh=ref_mesh8, exchange="blocked")
    for make in (
        lambda P: P.ShortestPathProgram(seed_index=0),
        lambda P: P.ShortestPathProgram(seed_index=3, weighted=True),
    ):
        rb = blocked.run(make(programs))
        assert blocked.last_run_info["path"] == "frontier"
        re_ = eager.run(make(programs))
        want = ref_blocked.run(make(ref_programs))
        for k in rb:
            np.testing.assert_array_equal(rb[k], re_[k])
            np.testing.assert_array_equal(rb[k], np.asarray(want[k]))
        assert blocked._frontier_engine.last_trace == ref_blocked._frontier_engine.last_trace
    assert all(h["exchange"] == "blocked" for h in blocked._frontier_engine.last_trace)
    rt = blocked.run(programs.ShortestPathProgram(seed_index=0, track_paths=True))
    rte = eager.run(programs.ShortestPathProgram(seed_index=0, track_paths=True))
    np.testing.assert_array_equal(rt["predecessor"], rte["predecessor"])
    assert blocked._frontier_engine.last_trace[0]["exchange"] == "a2a"


# --------------------------------------------- bitwise: replay oracle (SUM)
class _PassthroughProgram(VertexProgram):
    """apply() returns the aggregate unchanged, so the state after ONE
    superstep is the aggregation of the setup values: the harness that pins
    the superstep to ``halo.replay_superstep`` bit for bit."""

    compute_keys = ("x",)
    combiner = Combiner.SUM
    max_iterations = 1

    def __init__(self, op=Combiner.SUM, cols=0):
        self.combiner = op
        self.cols = cols

    @staticmethod
    def values(n, active, cols):
        base = (np.arange(n) % 89 + 1.0) / 7.0
        if cols:
            return (base[:, None] * (np.arange(cols)[None, :] + 1.0)).astype(np.float32)
        return (base * active).astype(np.float32)

    def setup(self, graph):
        x = self.values(graph.local_num_vertices, graph.active.cpu().numpy(), self.cols)
        return {"x": torch.as_tensor(x, device=graph.device)}, {}

    def message(self, state, step, graph):
        return state["x"]

    def apply(self, state, agg, step, mem, graph):
        return {"x": agg}, {}

    def terminate(self, memory):
        return False


def test_cpu_index_add_adds_in_index_order():
    """The premise of the SUM replay on the CPU: torch's index_add_ adds in
    index order, as np.add.at does."""
    rng = np.random.default_rng(0)
    v = (rng.standard_normal((50_000, 3)) * 1e3).astype(np.float32)
    seg = rng.integers(0, 31, 50_000)
    acc = np.zeros((31, 3), np.float32)
    np.add.at(acc, seg, v)
    got = torch.zeros(31, 3).index_add_(0, torch.as_tensor(seg), torch.as_tensor(v))
    np.testing.assert_array_equal(got.numpy(), acc)


@pytest.mark.parametrize("agg", ["ell", "segment"])
@pytest.mark.parametrize("op", [Combiner.SUM, Combiner.MIN])
@pytest.mark.parametrize("weights", [False, True])
def test_blocked_superstep_bitwise_vs_numpy_replay(mesh8, agg, op, weights):
    """One full superstep (gather, fused bin merge, all-to-all, receiver
    combine) equals the plan's numpy replay bit for bit, and the port's
    replay equals the reference's."""
    rg, pg = graphs(n=210, m=860, seed=7, weights=weights)
    ex = ShardedExecutor(pg, mesh=mesh8, exchange="blocked", agg=agg)
    out = ex.run(_PassthroughProgram(op=op), fused=False, frontier="off")
    sc = ex._sharded(False)
    outgoing = _PassthroughProgram.values(sc.padded_n, sc.active, 0)
    expect = halo.replay_superstep(sc.blocked_plan, outgoing, op, has_weight=sc.has_weight, agg=agg)
    np.testing.assert_array_equal(out["x"], expect[: sc.real_n])
    from janusgraph_tpu.parallel.sharded import ShardedCSR as RefShardedCSR

    rsc = RefShardedCSR(rg, 8, False)
    rsc.ensure_blocked_plan()
    ref_expect = ref_halo.replay_superstep(
        rsc.blocked_plan, outgoing, op, has_weight=rsc.has_weight, agg=agg)
    np.testing.assert_array_equal(expect, ref_expect)


@pytest.mark.parametrize("agg", ["ell", "segment"])
def test_blocked_dense_feature_block_bitwise_vs_replay(mesh8, agg):
    """The same replay contract for [n, d] feature-block messages."""
    _rg, pg = graphs(n=130, m=520, seed=9, weights=True)
    ex = ShardedExecutor(pg, mesh=mesh8, exchange="blocked", agg=agg)
    out = ex.run(_PassthroughProgram(op=Combiner.SUM, cols=8), fused=False, frontier="off")
    sc = ex._sharded(False)
    outgoing = _PassthroughProgram.values(sc.padded_n, sc.active, 8)
    expect = halo.replay_superstep(
        sc.blocked_plan, outgoing, Combiner.SUM, has_weight=sc.has_weight, agg=agg)
    np.testing.assert_array_equal(out["x"], expect[: sc.real_n])


@pytest.mark.parametrize("agg", ["ell", "segment"])
def test_blocked_pagerank_and_dense_match_oracle(mesh8, ref_mesh8, agg):
    """PageRank and a GCN forward pass across the exchange restructure:
    blocked against eager (1e-5/1e-8), against the CPU oracle (1e-4/1e-6 and
    1e-4/1e-5) and against the reference's blocked run."""
    rg, pg = graphs(n=180, m=760, seed=3)
    rb = ShardedExecutor(pg, mesh=mesh8, exchange="blocked", agg=agg).run(
        programs.PageRankProgram(max_iterations=15, tol=0.0))
    re_ = ShardedExecutor(pg, mesh=mesh8).run(programs.PageRankProgram(max_iterations=15, tol=0.0))
    np.testing.assert_allclose(rb["rank"], re_["rank"], rtol=1e-5, atol=1e-8)
    cpu = CPUExecutor(rg).run(ref_programs.PageRankProgram(max_iterations=15, tol=0.0))
    np.testing.assert_allclose(rb["rank"], cpu["rank"], rtol=1e-4, atol=1e-6)
    want = RefShardedExecutor(rg, mesh=ref_mesh8, exchange="blocked", agg=agg).run(
        ref_programs.PageRankProgram(max_iterations=15, tol=0.0))
    np.testing.assert_allclose(rb["rank"], want["rank"], rtol=1e-5, atol=1e-8)

    def gcn(P):
        return P.GCNForwardProgram(feature_dim=16, hidden_dim=16, out_dim=16, num_layers=2, seed=1)

    db = ShardedExecutor(pg, mesh=mesh8, exchange="blocked", agg=agg).run(gcn(programs))
    dc = CPUExecutor(rg).run(gcn(ref_programs))
    np.testing.assert_allclose(db["h"], dc["h"], rtol=1e-4, atol=1e-5)


def test_sddmm_refused_on_sharded(mesh8):
    _rg, pg = graphs()
    prog = programs.GCNForwardProgram(feature_dim=8, hidden_dim=8, out_dim=8, attention=True)
    assert not prog.sharded_compatible
    with pytest.raises(NotImplementedError, match="sddmm"):
        ShardedExecutor(pg, mesh=mesh8, exchange="blocked").run(prog)


# ----------------------------------------------------- distributed loading
def test_blocked_plan_distributed_build_matches_full():
    """Each host builds only its shard range's blocks from its own edges
    and the exchanged pair lists; the blocks concatenate to the
    single-process plan, which equals the reference's."""
    rg, pg = graphs(n=220, m=900, seed=13, weights=True)
    S = 8
    sc = ShardedCSR(pg, S, False)
    src, dst, w = halo.edges_from_sharded(sc)
    full = halo.BlockedPlan.build(src, dst, w, S, sc.shard_size)
    ref_full = ref_halo.BlockedPlan.build(src, dst, w, S, sc.shard_size)
    lists = {}
    for lo, hi in ((0, 3), (3, 8)):
        lists.update(halo.pair_dst_lists(src, dst, S, sc.shard_size, owner_range=(lo, hi)))
    assert set(lists) == set(full.pair_lists)
    hc = halo.halo_tier(lists)
    assert hc == full.halo_cap == ref_full.halo_cap
    parts = []
    for lo, hi in ((0, 3), (3, 8)):
        m = ((src // sc.shard_size) >= lo) & ((src // sc.shard_size) < hi)
        parts.append(halo.BlockedPlan.build_local(
            src[m], dst[m], w[m], S, sc.shard_size, (lo, hi), hc, full.edges_per_owner, lists,
        ))
    for name in ("blk_src_loc", "blk_seg", "blk_bin_seg", "blk_valid", "blk_weight", "recv_dst"):
        got = np.concatenate([getattr(p, name) for p in parts])
        np.testing.assert_array_equal(got, getattr(full, name), err_msg=name)
        np.testing.assert_array_equal(got, getattr(ref_full, name), err_msg=name)
    assert full.comm_stats() == ref_full.comm_stats()
    assert sum(p.edges_by_owner[0] for p in parts) > 0


def test_host_shard_range_couples_to_partition_range():
    from janusgraph_tpu.parallel import multihost as ref_multihost
    from janusgraph_tpu_torch.parallel.multihost import host_partition_range, host_shard_range

    assert host_shard_range(8, 0, 2) == host_partition_range(8, 0, 2)
    spans = [host_shard_range(8, p, 3) for p in range(3)]
    assert spans == [ref_multihost.host_shard_range(8, p, 3) for p in range(3)]
    assert spans[0][0] == 0 and spans[-1][1] == 8
    assert all(spans[i][1] == spans[i + 1][0] for i in range(2))


# ------------------------------------------------------------------- chaos
@pytest.mark.parametrize("agg", ["ell", "segment"])
def test_blocked_halo_drop_and_preempt_resume_bitwise(mesh8, tmp_path, agg):
    """A dropped halo batch and a shard preemption mid-run, absorbed by the
    cross-shard resume: the final state is the fault-free run's, bit for
    bit, and the fault journal is the reference plan's."""
    from janusgraph_tpu.storage.faults import FaultPlan as RefFaultPlan
    from janusgraph_tpu_torch.storage.faults import FaultPlan

    _rg, pg = graphs(n=160, m=640, seed=2)

    def mk():
        return programs.PageRankProgram(max_iterations=12, tol=0.0)

    base = ShardedExecutor(pg, mesh=mesh8, exchange="blocked", agg=agg).run(
        mk(), fused=False, checkpoint_every=3, shard_checkpoint_dir=str(tmp_path / "base"))
    plan = FaultPlan(seed=5, halo_drop_at=4, shard_preempt_superstep=8)
    ex = ShardedExecutor(pg, mesh=mesh8, exchange="blocked", agg=agg)
    out = ex.run(mk(), fused=False, checkpoint_every=3,
                 shard_checkpoint_dir=str(tmp_path / "chaos"), fault_hook=plan.sharded_hook)
    kinds = {e["kind"] for e in plan.journal}
    assert "halo_drop" in kinds and "shard_preempt" in kinds
    assert ex.last_run_info["resumes"] == 2
    np.testing.assert_array_equal(base["rank"], out["rank"])
    ref_plan = RefFaultPlan(seed=5, halo_drop_at=4, shard_preempt_superstep=8)
    for step in range(12):
        try:
            ref_plan.sharded_hook(step, 8)
        except Exception:  # noqa: BLE001 - the injected faults
            pass
    assert [e["kind"] for e in ref_plan.journal] == [e["kind"] for e in plan.journal]


# ------------------------------------------------- measured per-shard walls
def test_measured_walls_feed_skew_report(mesh8):
    from janusgraph_tpu_torch.observability import registry

    _rg, pg = graphs(n=200, m=800, seed=4)
    ex = ShardedExecutor(pg, mesh=mesh8, exchange="blocked")
    ex.run(programs.PageRankProgram(max_iterations=4, tol=0.0), fused=False)
    shards = ex.last_run_info["shards"]
    assert shards["cost_source"] == "measured"
    assert all(p["cost_source"] == "measured" for p in shards["per_shard"])
    assert all(p["measured_ms"] is not None and p["measured_ms"] >= 0.0 for p in shards["per_shard"])
    assert registry.gauge("olap.shard.skew.measured").value == 1.0
    off = ShardedExecutor(pg, mesh=mesh8, shard_measure=False)
    off.run(programs.PageRankProgram(max_iterations=4, tol=0.0), fused=False)
    shards = off.last_run_info["shards"]
    assert shards["cost_source"] == "plan"
    assert all(p["measured_ms"] is None for p in shards["per_shard"])
    assert registry.gauge("olap.shard.skew.measured").value == 0.0


def test_exchange_info_recorded(mesh8, ref_mesh8):
    rg, pg = graphs(n=150, m=600, seed=6)
    ex = ShardedExecutor(pg, mesh=mesh8, exchange="blocked")
    ex.run(programs.PageRankProgram(max_iterations=3, tol=0.0), fused=False)
    info = ex.last_run_info["exchange"]
    ref_ex = RefShardedExecutor(rg, mesh=ref_mesh8, exchange="blocked")
    ref_ex.run(ref_programs.PageRankProgram(max_iterations=3, tol=0.0), fused=False)
    assert info == ref_ex.last_run_info["exchange"]
    assert info["mode"] == "blocked" and info["batches_per_superstep"] == 1
    assert info["elems_per_superstep"] == 8 * ex._sharded(False).halo_cap
    assert info["bytes_per_superstep"] == info["elems_per_superstep"] * 4
    hc = info["width"]
    assert hc > 0 and (hc & (hc - 1)) == 0


# ----------------------------------------------------------------- autotune
def test_decide_sharded_deterministic_and_keyed_by_shard_count(tmp_path):
    """Pure and equal to the reference's decision field for field on the
    CPU kind; the card prices with the "gpu" constants; forcing pins the
    layout; the measured record stays keyed by shard count."""
    rg, pg = graphs(n=240, m=1100, seed=8, weights=True)
    sc = ShardedCSR(pg, 8, False)
    src, dst, _w = halo.edges_from_sharded(sc)
    widths = halo.pair_widths(src, dst, 8, sc.shard_size)
    stats = autotune.GraphStats.from_csr(pg)
    d1 = autotune.decide_sharded(stats, "cpu", 8, widths)
    assert d1.as_dict() == autotune.decide_sharded(stats, "cpu", 8, widths).as_dict()
    ref = ref_autotune.decide_sharded(ref_autotune.GraphStats.from_csr(rg), "cpu", 8, widths)
    assert d1.as_dict() == ref.as_dict()
    assert set(d1.modeled_ms) == {
        "a2a-ell", "a2a-segment", "blocked-ell", "blocked-segment", "ring-segment",
        "gather-segment",
    }
    card = autotune.decide_sharded(stats, "NVIDIA H100 80GB HBM3", 8, widths)
    assert card.device_kind == "NVIDIA H100 80GB HBM3" and card.modeled_ms != d1.modeled_ms
    df = autotune.decide_sharded(stats, "cpu", 8, widths, overrides={"exchange": "blocked"})
    assert (df.exchange, df.source) == ("blocked", "config")
    path = str(tmp_path / "a.autotune.json")
    autotune.save_measured(path, {
        "strategy": "sharded-blocked-ell", "pad_ratio": 1.1, "superstep_ms": 2.5,
        "roofline_by_tier": None, "exchange": "blocked", "agg": "ell", "halo_cap": 64,
    }, shard_count=8)
    rec = autotune.load_measured(path, shard_count=8)
    assert rec["exchange"] == "blocked" and rec["halo_cap"] == 64
    assert autotune.load_measured(path, shard_count=4) is None
    assert ref_autotune.load_measured(path, shard_count=8) == rec
    dm = autotune.decide_sharded(stats, "cpu", 8, widths, measured=rec)
    assert dm.source == "measured+model"


def test_auto_exchange_resolves_and_records(mesh8, ref_mesh8):
    rg, pg = graphs(n=200, m=900, seed=12)
    ex = ShardedExecutor(pg, mesh=mesh8, exchange="auto")
    ex.run(programs.PageRankProgram(max_iterations=3, tol=0.0), fused=False)
    assert ex.exchange in ("a2a", "blocked", "ring", "gather")
    rec = ex.last_run_info["autotune"]
    assert rec["shard_count"] == 8 and (rec["exchange"], rec["agg"]) == (ex.exchange, ex.agg)
    ex2 = ShardedExecutor(pg, mesh=mesh8, exchange="auto")
    ex2.run(programs.PageRankProgram(max_iterations=3, tol=0.0), fused=False)
    assert (ex2.exchange, ex2.agg) == (ex.exchange, ex.agg)
    ref_ex = RefShardedExecutor(rg, mesh=ref_mesh8, exchange="auto")
    ref_ex.run(ref_programs.PageRankProgram(max_iterations=3, tol=0.0), fused=False)
    assert (ref_ex.exchange, ref_ex.agg) == (ex.exchange, ex.agg)


# ------------------------------------------------------------------ routing
@pytest.fixture
def eight_cards(monkeypatch):
    """A machine that shows 8 cards to the routing, whose default mesh is 8
    CPU slots and whose "tpu" executor runs on the CPU."""
    from janusgraph_tpu_torch.olap import computer

    monkeypatch.setattr(computer, "visible_cards", lambda: 8)
    monkeypatch.setattr(computer, "default_mesh", lambda: Mesh([CPU] * 8))
    real = computer.executor_device
    monkeypatch.setattr(
        computer, "executor_device",
        lambda executor, mesh=None: real("cpu") if executor == "tpu" else real(executor, mesh),
    )
    return computer


def _gods_graph(config):
    from janusgraph_tpu_torch.core import gods
    from janusgraph_tpu_torch.core.graph import open_graph

    g = open_graph(dict({"ids.authority-wait-ms": 0.0}, **config))
    gods.load(g)
    return g


def test_sharded_auto_routing_records_run_info(eight_cards):
    g = _gods_graph({})
    try:
        res = g.compute().program(programs.PageRankProgram(max_iterations=6)).submit()
        routing = res.run_info["routing"]
        assert routing["requested"] == "tpu" and routing["routed"] == "sharded"
        assert "mesh of 8" in routing["reason"]
        assert res.run_info["exchange"]["batches_per_superstep"] == 1
        assert abs(res.states["rank"].sum() - 1.0) < 1e-4
    finally:
        g.close()


def test_sharded_auto_off_keeps_single_device(eight_cards):
    g = _gods_graph({"computer.sharded-auto": False})
    try:
        res = g.compute().program(programs.PageRankProgram(max_iterations=6)).submit()
        assert res.run_info["routing"]["routed"] == "tpu"
        assert res.run_info.get("executor") != "sharded"
    finally:
        g.close()


def test_sddmm_program_not_routed(eight_cards):
    """Attention (sddmm) programs stay on the single-device executor."""
    g = _gods_graph({})
    try:
        res = g.compute().program(programs.GCNForwardProgram(
            feature_dim=8, hidden_dim=8, out_dim=8, attention=True)).submit()
        routing = res.run_info["routing"]
        assert routing["routed"] == "tpu" and routing["reason"] == "sddmm program"
    finally:
        g.close()


def test_routed_failure_falls_back_and_records_why(eight_cards, monkeypatch):
    """A routed sharded run that fails reruns on the single-device executor
    and records the reason; an explicit "sharded" raises instead."""
    from janusgraph_tpu_torch.parallel import sharded

    def boom(self, *a, **kw):
        raise RuntimeError("collectives unavailable")

    monkeypatch.setattr(sharded.ShardedExecutor, "run", boom)
    g = _gods_graph({})
    try:
        res = g.compute().program(programs.PageRankProgram(max_iterations=6)).submit()
        routing = res.run_info["routing"]
        assert routing["routed"] == "tpu" and "collectives unavailable" in routing["fallback"]
        assert abs(res.states["rank"].sum() - 1.0) < 1e-4
        with pytest.raises(RuntimeError, match="collectives unavailable"):
            g.compute(executor="sharded").program(programs.PageRankProgram(max_iterations=6)).submit()
    finally:
        g.close()
