"""Fault-tolerant sharded OLAP in the port: shard faults consumed by the
sharded executor, the cross-shard resume from the sharded checkpoint, the
straggler skew report — the twins of ``tests/test_sharded_chaos.py`` (the
checkpoint format's own cases are ``tests/test_torch_sharded_checkpoint.py``).

The contract: a shard preemption, a collective timeout or a dropped halo
batch costs at most one checkpoint interval, and the resumed run ends
bitwise equal to the fault-free run on the same executor; the fault
journal is the reference plan's for the same seed; a manifest the port's
mesh writes restores on the reference's CPU oracle.
"""

import json

import numpy as np
import pytest
import torch

from janusgraph_tpu.olap import csr_from_edges as ref_csr_from_edges
from janusgraph_tpu.olap.cpu_executor import CPUExecutor
from janusgraph_tpu.olap.programs import PageRankProgram as RefPageRankProgram
from janusgraph_tpu.storage.faults import FaultPlan as RefFaultPlan
from janusgraph_tpu_torch.exceptions import ShardPreempted
from janusgraph_tpu_torch.olap import csr_from_edges
from janusgraph_tpu_torch.olap.programs import PageRankProgram, ShortestPathProgram
from janusgraph_tpu_torch.olap.sharded_checkpoint import load_sharded_checkpoint
from janusgraph_tpu_torch.parallel import Mesh, ShardedExecutor
from janusgraph_tpu_torch.storage.faults import FaultPlan


def graphs(n=150, m=600, seed=13):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, m).astype(np.int32)
    dst = rng.integers(0, n, m).astype(np.int32)
    return ref_csr_from_edges(n, src, dst), csr_from_edges(n, src, dst)


@pytest.fixture(scope="module")
def mesh8():
    return Mesh([torch.device("cpu")] * 8)


def _pagerank(iters=10):
    return PageRankProgram(max_iterations=iters, tol=0.0)


def _bitwise_equal(a, b):
    assert set(a) == set(b)
    for k in a:
        assert np.array_equal(np.asarray(a[k]), np.asarray(b[k])), k


def _ref_journal(plan_kwargs, steps, num_shards=8):
    """The reference plan's journal over the same boundaries (the hook
    raises once per kind; a resumed run consults the raising steps again)."""
    plan = RefFaultPlan(**plan_kwargs)
    for step in steps:
        try:
            plan.sharded_hook(step, num_shards)
        except Exception:  # noqa: BLE001 - the injected faults
            pass
    return [(e["kind"], e.get("shard")) for e in plan.journal]


# ------------------------------------------------- cross-shard auto-resume
@pytest.mark.parametrize("exchange,agg", [
    ("a2a", "ell"), ("a2a", "segment"), ("blocked", "ell"), ("blocked", "segment"),
])
def test_shard_preempt_resume_bitwise_sharded(mesh8, tmp_path, exchange, agg):
    _rg, pg = graphs()
    base = ShardedExecutor(pg, mesh=mesh8, exchange=exchange, agg=agg).run(
        _pagerank(), fused=False, checkpoint_every=3, shard_checkpoint_dir=str(tmp_path / "base"))
    plan = FaultPlan(seed=21, shard_preempt_superstep=5)
    ex = ShardedExecutor(pg, mesh=mesh8, exchange=exchange, agg=agg)
    out = ex.run(_pagerank(), fused=False, checkpoint_every=3,
                 shard_checkpoint_dir=str(tmp_path / "chaos"), fault_hook=plan.sharded_hook)
    _bitwise_equal(base, out)
    assert ex.last_run_info["resumes"] >= 1 and ex.last_run_info["resume_ms"] > 0
    assert ex.last_run_info["checkpoint"]["format"] == "sharded"
    assert [e["kind"] for e in plan.journal] == ["shard_preempt"]
    assert [(e["kind"], e["shard"]) for e in plan.journal] == _ref_journal(
        {"seed": 21, "shard_preempt_superstep": 5}, range(10))


@pytest.mark.parametrize("exchange", ["a2a", "blocked"])
def test_collective_timeout_and_halo_drop_resume(mesh8, tmp_path, exchange):
    _rg, pg = graphs(seed=17)
    base = ShardedExecutor(pg, mesh=mesh8, exchange=exchange).run(
        _pagerank(), fused=False, checkpoint_every=2, shard_checkpoint_dir=str(tmp_path / "base"))
    plan = FaultPlan(seed=3, collective_timeout_at=4, halo_drop_at=7)
    ex = ShardedExecutor(pg, mesh=mesh8, exchange=exchange)
    out = ex.run(_pagerank(), fused=False, checkpoint_every=2,
                 shard_checkpoint_dir=str(tmp_path / "chaos"), fault_hook=plan.sharded_hook)
    _bitwise_equal(base, out)
    kinds = [e["kind"] for e in plan.journal]
    assert "collective" in kinds and "halo_drop" in kinds
    assert ex.last_run_info["resumes"] == 2


def test_fused_path_resumes_from_manifest(mesh8, tmp_path):
    _rg, pg = graphs(seed=29)
    base = ShardedExecutor(pg, mesh=mesh8).run(
        _pagerank(12), fused=True, checkpoint_every=4, shard_checkpoint_dir=str(tmp_path / "base"))
    plan = FaultPlan(seed=5, shard_preempt_superstep=6)
    ex = ShardedExecutor(pg, mesh=mesh8)
    out = ex.run(_pagerank(12), fused=True, checkpoint_every=4,
                 shard_checkpoint_dir=str(tmp_path / "chaos"), fault_hook=plan.sharded_hook)
    _bitwise_equal(base, out)
    assert ex.last_run_info["path"] == "fused" and ex.last_run_info["resumes"] >= 1


def test_single_file_checkpoint_resumes_too(mesh8, tmp_path):
    """Without a shard directory the run saves the single-file format and
    resumes from it the same way."""
    _rg, pg = graphs(seed=31)
    base = ShardedExecutor(pg, mesh=mesh8).run(_pagerank(9), fused=False)
    plan = FaultPlan(seed=9, shard_preempt_superstep=4)
    ex = ShardedExecutor(pg, mesh=mesh8)
    out = ex.run(_pagerank(9), fused=False, checkpoint_every=2,
                 checkpoint_path=str(tmp_path / "ck"), fault_hook=plan.sharded_hook)
    _bitwise_equal(base, out)
    assert ex.last_run_info["checkpoint"]["format"] == "single"


def test_checkpoint_portable_between_executors(mesh8, tmp_path):
    """A manifest written by the port's mesh restores on the reference's
    CPU oracle (real rows only, the same format)."""
    rg, pg = graphs(n=90, m=360, seed=31)
    d = str(tmp_path / "ck")
    ShardedExecutor(pg, mesh=mesh8).run(_pagerank(6), fused=False, checkpoint_every=6,
                                        shard_checkpoint_dir=d)
    loaded = load_sharded_checkpoint(d)
    assert loaded is not None
    lstate, _m, steps = loaded
    assert steps == 6 and lstate["rank"].shape[0] == pg.num_vertices
    out = CPUExecutor(rg).run(RefPageRankProgram(max_iterations=6, tol=0.0), checkpoint_every=6,
                              shard_checkpoint_dir=d, resume=True)
    assert np.array_equal(out["rank"], np.asarray(lstate["rank"], np.float64))


def test_frontier_run_restarts_on_preemption(mesh8):
    """Frontier runs carry no checkpoint: the resume restarts the (short,
    deterministic) run from scratch."""
    _rg, pg = graphs(seed=41)
    base = ShardedExecutor(pg, mesh=mesh8).run(ShortestPathProgram(seed_index=0), frontier="always")
    fired = {"n": 0}

    def hook(step):
        if step == 1 and fired["n"] == 0:
            fired["n"] += 1
            raise ShardPreempted("injected")

    ex = ShardedExecutor(pg, mesh=mesh8)
    out = ex.run(ShortestPathProgram(seed_index=0), frontier="always", fault_hook=hook)
    _bitwise_equal(base, out)
    assert ex.last_run_info["resumes"] == 1


# --------------------------------------------------- determinism + skew
def test_distributed_journal_reproducibility(mesh8, tmp_path):
    _rg, pg = graphs(seed=19)

    def chaos_run(sub):
        plan = FaultPlan(seed=77, shard_preempt_superstep=4, collective_timeout_at=7,
                         straggler_ms=1.0, straggler_rate=0.3)
        out = ShardedExecutor(pg, mesh=mesh8).run(
            _pagerank(8), fused=False, checkpoint_every=2,
            shard_checkpoint_dir=str(tmp_path / sub), fault_hook=plan.sharded_hook)
        return plan.journal, out

    j1, o1 = chaos_run("a")
    j2, o2 = chaos_run("b")
    assert j1 == j2 and len(j1) > 0
    _bitwise_equal(o1, o2)


def test_straggler_skew_report_and_gauge(mesh8):
    from janusgraph_tpu_torch.observability import flight_recorder, registry

    _rg, pg = graphs(seed=23)
    plan = FaultPlan(seed=1, straggler_ms=2.0, straggler_rate=1.0)
    ex = ShardedExecutor(pg, mesh=mesh8)
    ex.run(_pagerank(4), fused=False, fault_hook=plan.sharded_hook)
    shards = ex.last_run_info["shards"]
    assert shards["count"] == 8 and len(shards["per_shard"]) == 8
    assert shards["straggler_events"] > 0 and shards["straggler_ms_total"] > 0
    assert shards["skew"] >= 1.0
    per = shards["per_shard"][shards["slowest_shard"]]
    assert per["ledger"]["cells_read"] == per["edges"] and per["roofline"]["flops"] > 0
    assert registry.snapshot()["olap.shard.skew"]["value"] >= 1.0
    assert any(e["category"] == "shard_skew" for e in flight_recorder.events())


def test_per_shard_roofline_blocks_without_faults(mesh8):
    _rg, pg = graphs(seed=37)
    ex = ShardedExecutor(pg, mesh=mesh8)
    ex.run(_pagerank(4), fused=True)
    shards = ex.last_run_info["shards"]
    assert shards["straggler_events"] == 0
    assert sum(p["edges"] for p in shards["per_shard"]) == pg.num_edges
    assert sum(p["vertices"] for p in shards["per_shard"]) == pg.num_vertices
    for p in shards["per_shard"]:
        assert {"flops", "bytes_accessed", "operational_intensity"} <= set(p["roofline"])


def test_healthz_sharded_block(mesh8, tmp_path):
    from janusgraph_tpu_torch.server.server import healthz_snapshot

    _rg, pg = graphs(seed=43)
    plan = FaultPlan(seed=2, shard_preempt_superstep=3)
    ShardedExecutor(pg, mesh=mesh8).run(
        _pagerank(6), fused=False, checkpoint_every=2, shard_checkpoint_dir=str(tmp_path / "ck"),
        fault_hook=plan.sharded_hook)
    sharded = healthz_snapshot()["sharded"]
    assert sharded["faults"]["shard_preempt"] >= 1
    assert sharded["resumes"] >= 1 and sharded["skew"] is not None


def test_graph_fault_plan_reaches_the_sharded_executor(tmp_path):
    """storage.faults.shard-* open and reach a graph.compute(executor=
    "sharded") submit as the plan's mesh-aware hook; the resumed submit
    equals the fault-free one."""
    from janusgraph_tpu_torch.core.bulk import bulk_add_edges, bulk_add_vertices
    from janusgraph_tpu_torch.core.graph import open_graph

    mesh = Mesh([torch.device("cpu")] * 4)
    rng = np.random.default_rng(3)
    results = []
    for faults in (False, True):
        cfg = {"computer.executor": "cpu", "computer.delta": False,
               "computer.shard-checkpoint-path": str(tmp_path / f"ck{faults}"),
               "computer.shard-checkpoint-every": 2}
        if faults:
            cfg.update({"storage.faults.enabled": True, "storage.faults.seed": 4,
                        "storage.faults.shard-preempt-superstep": 3})
        g = open_graph(cfg)
        vids = bulk_add_vertices(g, 60)
        src = rng.integers(0, 60, 240) if not results else src
        dst = rng.integers(0, 60, 240) if not results else dst
        bulk_add_edges(g, "e", vids[src], vids[dst])
        res = g.compute(executor="sharded", mesh=mesh).program(_pagerank(8)).submit()
        results.append(res)
        if faults:
            assert [e["kind"] for e in g.fault_plan.journal] == ["shard_preempt"]
            assert res.run_info["resumes"] == 1
        g.close()
    np.testing.assert_array_equal(results[0].states["rank"], results[1].states["rank"])


# -------------------------------------------- measured-record persistence
def test_autotune_measured_keyed_by_shard_count(tmp_path):
    from janusgraph_tpu.olap import autotune as ref_autotune
    from janusgraph_tpu_torch.olap import autotune

    path = str(tmp_path / "ck.autotune.json")
    autotune.save_measured(path, {"strategy": "hybrid", "pad_ratio": 1.01, "superstep_ms": 75.0,
                                  "roofline_by_tier": None}, shard_count=1)
    autotune.save_measured(path, {"strategy": "sharded-a2a-ell", "pad_ratio": 1.2,
                                  "superstep_ms": 12.0, "roofline_by_tier": None}, shard_count=8)
    one, eight = autotune.load_measured(path, 1), autotune.load_measured(path, 8)
    assert one["superstep_ms"] == 75.0 and one["strategy"] == "hybrid"
    assert eight["superstep_ms"] == 12.0 and autotune.load_measured(path, 4) is None
    assert ref_autotune.load_measured(path, 8) == eight


def test_autotune_measured_v1_backcompat(tmp_path):
    from janusgraph_tpu_torch.olap import autotune

    path = str(tmp_path / "old.autotune.json")
    with open(path, "w") as f:
        json.dump({"version": 1, "strategy": "ell", "pad_ratio": 1.4, "superstep_ms": 88.0,
                   "roofline_by_tier": None}, f)
    assert autotune.load_measured(path, 1)["superstep_ms"] == 88.0
    assert autotune.load_measured(path, 8) is None
    autotune.save_measured(path, {"strategy": "sharded-a2a-ell", "pad_ratio": 1.1,
                                  "superstep_ms": 9.0, "roofline_by_tier": None}, shard_count=8)
    assert autotune.load_measured(path, 1)["superstep_ms"] == 88.0
    assert autotune.load_measured(path, 8)["superstep_ms"] == 9.0


def test_sharded_run_persists_measured_record(mesh8, tmp_path):
    from janusgraph_tpu_torch.olap import autotune

    _rg, pg = graphs(seed=47)
    d = str(tmp_path / "ck")
    ex = ShardedExecutor(pg, mesh=mesh8)
    ex.run(_pagerank(4), fused=False, checkpoint_every=2, shard_checkpoint_dir=d)
    persisted = ex.last_run_info["autotune_persist"]
    assert persisted["shard_count"] == 8 and persisted["calibrated"] is False
    rec = autotune.load_measured(persisted["path"], shard_count=8)
    assert rec is not None and rec["strategy"] == "sharded-a2a-ell"
    assert autotune.load_measured(persisted["path"], shard_count=1) is None
    ex2 = ShardedExecutor(pg, mesh=mesh8)
    ex2.run(_pagerank(4), fused=False, checkpoint_every=2, shard_checkpoint_dir=d)
    assert ex2.last_run_info["autotune_persist"]["calibrated"] is True
