"""The port's OLAP run record held to the reference's: both packages run the
same programs on the same R-MAT CSR on the CPU, the reference's XLA cost
harvest switched off so both price every superstep with the host estimate,
and the records agree field by field (key set, supersteps, each superstep's
sizes, flops, bytes and operational intensity, the pad ratio, the
per-tier roofline keys, the MXU flops). Also: the registry holds the
executor's record, the measured tuner record carries the roofline by tier,
the stored ``submit()`` builds the reference's span tree, the transaction's
spans and counters, the flight events of a preempted checkpointed run, and
the executor options of ``computer.*`` give the reference's decisions and
packs."""

import numpy as np
import pytest

import janusgraph_tpu.olap as ref
from janusgraph_tpu.observability import profiler as ref_profiler
from janusgraph_tpu.olap import autotune as ref_at
from janusgraph_tpu.olap import delta as RD
from janusgraph_tpu.olap.programs import (
    ConnectedComponentsProgram as RefCC,
    PageRankProgram as RefPR,
    ShortestPathProgram as RefSP,
    TraversalCountProgram as RefCount,
)
from janusgraph_tpu.olap.programs.gcn import GCNForwardProgram as RefGCN
from janusgraph_tpu.olap.tpu_executor import TPUExecutor

from janusgraph_tpu_torch.core import bulk
from janusgraph_tpu_torch.core.graph import open_graph
from janusgraph_tpu_torch.exceptions import SuperstepPreempted
from janusgraph_tpu_torch.observability import flight_recorder, registry, tracer
from janusgraph_tpu_torch.olap import GPUExecutor, autotune, csr_from_edges
from janusgraph_tpu_torch.olap import delta as D
from janusgraph_tpu_torch.olap.generators import rmat_edges
from janusgraph_tpu_torch.olap.gpu_executor import _nbytes
from janusgraph_tpu_torch.olap.programs import (
    ConnectedComponentsProgram,
    GCNForwardProgram,
    PageRankProgram,
    ShortestPathProgram,
    TraversalCountProgram,
)

#: run-record keys only the port writes, and why
PORT_ONLY = {
    "run_wall_s": "all of run(), resumes included (the reference's wall_s); "
                  "the port's wall_s is the path's own clock",
    "kernel_launches": "eager launches of the segment-sum kernel",
    "chunks": "CUDA-graph chunks the fused loop replayed",
    "host_syncs": "fetches of the fused loop",
    "predicated_steps": "supersteps a chunk computed and discarded",
    "capture_s": "seconds spent capturing CUDA graphs",
    "graph_kernel_launches": "segment-sum calls the replayed graphs hold",
    "hop_wall_s": "the frontier path's per-hop host walls",
    "strategy_resolved": "the reference names it only where an ELL or hybrid "
                         "pack exists; the port on every dense path",
}
#: keys only the reference writes (none: every field is ported)
REF_ONLY = {}

RECORD_FIELDS = ("step", "frontier", "edges", "e_cap", "flops", "bytes_accessed",
                 "operational_intensity", "cost_source")


@pytest.fixture(autouse=True)
def _estimate_only(monkeypatch):
    """Both packages price supersteps with the host estimate."""
    monkeypatch.setattr(ref_profiler, "harvest_cost", lambda lowered: None)


_GRAPH = {}


def rmat(scale=9):
    if scale not in _GRAPH:
        n, src, dst = rmat_edges(scale, 8, seed=3)
        _GRAPH[scale] = (ref.csr_from_edges(n, src, dst), csr_from_edges(n, src, dst))
    return _GRAPH[scale]


def _assert_records_match(r_info, p_info, bytes_equal=True):
    assert set(r_info) - set(p_info) == set(REF_ONLY)
    assert set(p_info) - set(r_info) <= set(PORT_ONLY)
    assert p_info["supersteps"] == r_info["supersteps"]
    assert p_info["path"] == r_info["path"]
    rr, pr = r_info["superstep_records"], p_info["superstep_records"]
    assert len(pr) == len(rr)
    fields = RECORD_FIELDS if bytes_equal else tuple(
        f for f in RECORD_FIELDS if f not in ("bytes_accessed", "operational_intensity"))
    for a, b in zip(rr, pr):
        assert {f: a.get(f) for f in fields} == {f: b.get(f) for f in fields}
    assert p_info["pad_ratio"] == r_info["pad_ratio"]
    assert p_info["ell_pad_ratio"] == r_info["ell_pad_ratio"]
    assert set(p_info["roofline_by_tier"]) == set(r_info["roofline_by_tier"])
    if bytes_equal:
        assert p_info["h2d_arg_bytes"] == r_info["h2d_arg_bytes"]
    assert p_info["d2h_bytes"] == r_info["d2h_bytes"]
    assert p_info["resources"]["flops"] == r_info["resources"]["flops"]
    # the registry holds the executor's record
    assert registry.last_run("olap") == p_info


def _run_both(r_ex, p_ex, r_prog, p_prog, **kw):
    r_ex.run(r_prog, **kw)
    p_ex.run(p_prog, **kw)
    return r_ex.last_run_info, p_ex.last_run_info


@pytest.mark.parametrize("fused", [True, False])
def test_pagerank_record_matches(fused):
    rc, pc = rmat()
    r, p = _run_both(TPUExecutor(rc, strategy="ell"), GPUExecutor(pc, strategy="ell", device="cpu"),
                     RefPR(max_iterations=5, tol=0.0), PageRankProgram(max_iterations=5, tol=0.0),
                     fused=fused)
    assert p["path"] == ("fused" if fused else "host-loop")
    _assert_records_match(r, p)
    recs = p["superstep_records"]
    assert recs[0]["h2d_bytes"] == p["h2d_arg_bytes"] > 0
    assert all(rec["h2d_bytes"] == 0 for rec in recs[1:])
    assert all(rec["cost_source"] == "estimate" and rec["wall_ms"] > 0 for rec in recs)
    assert p["slowest_superstep"]["wall_ms"] == max(round(x["wall_ms"], 4) for x in recs)
    if fused:
        assert p["compile_in_first_dispatch"] is True and recs[0]["compiled"]
        assert not any(rec["compiled"] for rec in recs[1:])
        assert p["first_dispatch_s"] >= 0


def test_segsum_record_adds_the_plan_bytes():
    """The port's kernel reads its plan (seg_ptr and the partition) as
    device arrays; the reference's Pallas plan is closed over, not an
    argument. Everything else in the record is the reference's."""
    rc, pc = rmat()
    p_ex = GPUExecutor(pc, strategy="segsum", device="cpu")
    r, p = _run_both(TPUExecutor(rc, strategy="pallas"), p_ex,
                     RefPR(max_iterations=4, tol=0.0), PageRankProgram(max_iterations=4, tol=0.0))
    _assert_records_match(r, p, bytes_equal=False)
    plan = p_ex._segsum_plan("in")
    assert p["h2d_arg_bytes"] == r["h2d_arg_bytes"] + _nbytes(plan)
    assert _nbytes(plan) == plan.seg_ptr.nbytes + plan.seg_start.nbytes + plan.edge_start.nbytes


def test_frontier_bfs_record_matches():
    rc, pc = rmat()
    r, p = _run_both(TPUExecutor(rc), GPUExecutor(pc, device="cpu"),
                     RefSP(seed_index=0, max_iterations=6), ShortestPathProgram(seed_index=0, max_iterations=6))
    assert p["path"] == "frontier"
    _assert_records_match(r, p)
    assert p["h2d_arg_bytes"] == 0
    # the port times each hop (its fetch to the next), so its tiers carry
    # a utilization where the reference's carry none
    assert all(rec["wall_ms"] > 0 for rec in p["superstep_records"])
    assert set(p["roofline_by_tier"]) == {str(t["E_cap"]) for t in p["tiers"]}


@pytest.mark.parametrize("make", [
    lambda: (RefCC(max_iterations=30), ConnectedComponentsProgram(max_iterations=30)),
    lambda: (RefCount(hops=3), TraversalCountProgram(hops=3)),
], ids=["cc", "count3"])
def test_cc_and_khop_records_match(make):
    rc, pc = rmat()
    r_prog, p_prog = make()
    r, p = _run_both(TPUExecutor(rc, strategy="ell"), GPUExecutor(pc, strategy="ell", device="cpu"),
                     r_prog, p_prog)
    assert p["path"] == "fused"
    _assert_records_match(r, p)


def test_gcn_record_and_mxu_match():
    rc, pc = rmat(8)
    dims = dict(feature_dim=12, hidden_dim=12, out_dim=8, num_layers=2, seed=5)
    r, p = _run_both(TPUExecutor(rc, strategy="ell"), GPUExecutor(pc, strategy="ell", device="cpu"),
                     RefGCN(**dims), GCNForwardProgram(**dims))
    _assert_records_match(r, p)
    assert p["mxu"]["per_superstep_flops"] == r["mxu"]["per_superstep_flops"] > 0
    assert p["mxu"]["peak_source"] == "table:cpu"
    assert all(rec["mxu_flops"] == p["mxu"]["per_superstep_flops"] for rec in p["superstep_records"])


def test_delta_pagerank_record():
    """Over an overlay the sizes and flops are the reference's; the bytes
    are the port's own lanes (sorted per destination, with segment-sum
    plans, int64 indices), counted as the device arrays the superstep
    reads."""
    rc, pc = rmat(8)
    n = pc.num_vertices
    rng = np.random.default_rng(4)
    batches = [{"add": (rng.integers(0, n, 40), rng.integers(0, n, 40), np.zeros(40, np.int64)),
                "del": (pc.in_src[:10].astype(np.int64),
                        np.repeat(np.arange(n), np.diff(pc.in_indptr))[:10],
                        np.zeros(10, np.int64)),
                "v_add": {}, "v_del": []}]
    rv = RD.OverlayView(rc, RD.DeltaOverlay.from_batches(batches), max_lane_cells=1 << 14)
    pv = D.OverlayView(pc, D.DeltaOverlay.from_batches(batches), max_lane_cells=1 << 14)
    p_ex = GPUExecutor(pc, strategy="ell", device="cpu", delta=pv)
    r, p = _run_both(TPUExecutor(rc, strategy="ell", delta=rv), p_ex,
                     RefPR(max_iterations=4, tol=0.0), PageRankProgram(max_iterations=4, tol=0.0))
    assert p["delta"] == r["delta"]
    _assert_records_match(r, p, bytes_equal=False)
    lanes = _nbytes(pv.device_args(p_ex.device, False))
    (fields,) = p_ex._viewkeys.values()  # what PageRank's message/apply read
    assert "out_degree" in fields
    assert p["h2d_arg_bytes"] == _nbytes(p_ex._ell_pack(False)) + lanes + sum(
        _nbytes(getattr(p_ex.g, k)) for k in fields)


def test_measured_record_and_tier_pruning_match(tmp_path):
    """The measured record carries roofline_by_tier and superstep_ms as the
    median record wall; a second lifetime's ladders equal the reference's
    whichever package wrote the file."""
    rc, pc = rmat()
    paths = {}
    for name, ex, prog in (
        ("ref", TPUExecutor(rc, strategy="ell"), RefPR(max_iterations=4, tol=0.0)),
        ("port", GPUExecutor(pc, strategy="ell", device="cpu"), PageRankProgram(max_iterations=4, tol=0.0)),
    ):
        paths[name] = str(tmp_path / f"{name}.npz")
        ex.run(prog, checkpoint_path=paths[name], checkpoint_every=2)
        rec = ref_at.load_measured(paths[name] + ".autotune.json")
        assert rec["roofline_by_tier"] == ex.last_run_info["roofline_by_tier"]
        walls = sorted(r["wall_ms"] for r in ex.last_run_info["superstep_records"])
        assert rec["superstep_ms"] == walls[len(walls) // 2]
    for path in paths.values():
        measured = autotune.load_measured(path + ".autotune.json")
        # a dead tier in the record is pruned alike
        measured["roofline_by_tier"] = dict(measured["roofline_by_tier"], **{
            "65536": {"supersteps": 1, "operational_intensity": 0.1, "roofline_utilization": 0.0}})
        p_stats = autotune.GraphStats.from_csr(pc)
        r_stats = ref_at.GraphStats.from_csr(rc)
        p_dec = autotune.decide(p_stats, "cpu", measured=measured)
        r_dec = ref_at.decide(r_stats, "cpu", measured=measured)
        assert p_dec.e_schedule == r_dec.e_schedule and p_dec.f_schedule == r_dec.f_schedule
        assert p_dec.source == r_dec.source == "measured+model"


def test_preempted_checkpointed_run_records_flight_events(tmp_path):
    rc, pc = rmat(8)
    flight_recorder.reset()
    preempts0 = registry.get_count("olap.preemptions")
    resumes0 = registry.get_count("olap.resumes")
    hit = []

    def hook(step):
        if step == 2 and not hit:
            hit.append(step)
            raise SuperstepPreempted("injected at superstep 2")

    for fused in (True, False):
        hit.clear()
        ex = GPUExecutor(pc, strategy="ell", device="cpu")
        ex.run(PageRankProgram(max_iterations=5, tol=0.0), fused=fused,
               checkpoint_path=str(tmp_path / f"ck{fused}.npz"), checkpoint_every=2, fault_hook=hook)
        assert ex.last_run_info["resumes"] == 1
    assert registry.get_count("olap.preemptions") - preempts0 == 2
    assert registry.get_count("olap.resumes") - resumes0 == 2
    resumes = flight_recorder.events("olap_resume")
    assert [(e["executor"], e["attempt"], e["program"]) for e in resumes] == [
        ("cpu", 1, "PageRankProgram")] * 2
    saves = flight_recorder.events("checkpoint")
    assert saves and all(e["action"] == "save" for e in saves)
    # a torn newest checkpoint falls back to .prev, counted and recorded
    path = str(tmp_path / "ckFalse.npz")
    with open(path, "wb") as f:
        f.write(b"torn")
    fallback0 = registry.get_count("olap.checkpoint.fallback")
    from janusgraph_tpu_torch.olap.checkpoint import load_checkpoint

    assert load_checkpoint(path) is not None
    assert registry.get_count("olap.checkpoint.fallback") == fallback0 + 1
    assert flight_recorder.events("checkpoint")[-1]["action"] == "fallback"
    flight_recorder.reset()


# ------------------------------------------------------- the stored path

def _stored_graph(config=None):
    g = open_graph({"computer.strategy": "ell", **(config or {})})
    vids = bulk.bulk_add_vertices(g, 64)
    rng = np.random.default_rng(0)
    bulk.bulk_add_edges(g, "link", vids[rng.integers(0, 64, 300)], vids[rng.integers(0, 64, 300)])
    return g


def test_submit_span_tree_with_superstep_children():
    """Mirrors the reference's tests/test_telemetry.py: olap.submit, then
    olap.load_csr, then olap.run with one superstep child per superstep
    carrying frontier/pad_ratio/h2d_bytes; run_info is the registry's
    record plus routing."""
    g = _stored_graph()
    runs0 = registry.get_count("olap.runs")
    for path in ("cold", "warm"):
        res = g.compute(executor="cpu").program(PageRankProgram(max_iterations=3, tol=0.0)).submit()
        assert res.run_info["snapshot"]["path"] == path
        root = tracer.recent("olap.submit")[-1]
        assert [c.name for c in root.children] == ["olap.load_csr", "olap.run"]
        assert root.children[0].attrs["delta_path"] == path
        assert root.attrs["program"] == "PageRankProgram"
        run = root.find("olap.run")[-1]
        steps = run.find("superstep")
        assert len(steps) == 3 and run.attrs["supersteps"] == 3
        for s in steps:
            assert {"frontier", "pad_ratio", "h2d_bytes"} <= set(s.attrs)
        assert steps[0].attrs["h2d_bytes"] > 0
        rec = registry.last_run("olap")
        assert {k: v for k, v in res.run_info.items() if k not in ("routing", "snapshot")} == rec
        assert registry.last_run("olap.routing") == res.run_info["routing"]
        assert rec["superstep_records"][0]["h2d_bytes"] == rec["h2d_arg_bytes"] > 0
    assert registry.get_count("olap.runs") == runs0 + 2
    assert registry.snapshot()["olap.superstep.count"]["value"] == 3.0
    # a map-reduce job gets its own child span
    from janusgraph_tpu_torch.olap.mapreduce import StatsMapReduce

    g.compute(executor="cpu").program(PageRankProgram(max_iterations=2, tol=0.0)).map_reduce(
        StatsMapReduce("rank")).submit()
    assert tracer.recent("olap.submit")[-1].find("olap.map_reduce")
    g.close()


def test_tx_lifecycle_spans_counters_and_store_timers():
    """Mirrors the reference's tests/test_telemetry.py tx and store tests."""
    g = open_graph({"metrics.enabled": True})
    begins0, rollbacks0 = registry.get_count("tx.begin"), registry.get_count("tx.rollback")
    tx = g.new_transaction()
    tx.add_vertex(name="s")
    tx.commit()
    tx = g.new_transaction()
    tx.rollback()
    commits = tracer.recent("tx.commit")
    assert commits and commits[-1].attrs["added"] >= 1 and commits[-1].attrs["lifetime_ms"] >= 0
    assert tracer.recent("tx.rollback")
    assert registry.get_count("tx.begin") - begins0 >= 2
    assert registry.get_count("tx.rollback") - rollbacks0 >= 1
    entry = registry.snapshot()["tx.commit"]
    assert entry["type"] == "timer" and entry["count"] >= 1 and "p95_ms" in entry
    # batched writes timed at the manager, reads per store
    tx = g.new_transaction()
    v = tx.add_vertex(name="h")
    tx.commit()
    tx = g.new_transaction()
    tx.get_vertex(v.id)
    tx.rollback()
    snap = registry.snapshot()
    assert snap["storage.mutateMany"]["count"] >= 1
    assert snap["storage.edgestore.getSlice"]["count"] >= 1 and "p99_ms" in snap["storage.edgestore.getSlice"]
    assert registry.get_count("storage.edgestore.mutate.rows") >= 1
    g.close()


def test_metrics_options_apply_at_open(tmp_path):
    g = open_graph({"metrics.slow-op-threshold-ms": 5.0, "metrics.span-buffer": 7,
                    "metrics.flight-buffer": 9, "metrics.flight-dump-dir": str(tmp_path),
                    "metrics.csv-interval-ms": 3600_000.0, "metrics.enabled": True,
                    "metrics.csv-directory": str(tmp_path / "csv"),
                    "metrics.merge-stores": True})
    assert tracer.slow_threshold_ms == 5.0
    assert flight_recorder.capacity == 9 and flight_recorder.dump_dir == str(tmp_path)
    assert g.backend.edgestore.wrapped.name == "edgestore"
    tx = g.new_transaction()
    tx.add_vertex(name="a")
    tx.commit()
    tx = g.new_transaction()
    tx.vertices()
    assert registry.get_count("storage.mutateMany") >= 0
    g.close()  # stops the CSV reporter with a final flush
    assert (tmp_path / "csv").is_dir() and any((tmp_path / "csv").iterdir())
    open_graph({}).close()  # the defaults restore the tracer and the ring
    assert tracer.slow_threshold_ms == 100.0 and flight_recorder.capacity == 512


# --------------------------------------------- the executor's options

OPTIONS = dict(ell_max_capacity=16, frontier_f_min=64, frontier_e_min=256,
               frontier_tier_growth=2, autotune_min_gain=0.2, autotune_max_tiers=4)


def test_options_give_the_references_decisions_and_packs():
    rc, pc = rmat()
    r_ex = TPUExecutor(rc, strategy="auto", **OPTIONS)
    p_ex = GPUExecutor(pc, strategy="auto", device="cpu", **OPTIONS)
    for und in (False, True):
        assert p_ex._autotune(und).as_dict() == {
            k: v for k, v in r_ex._autotune(und).as_dict().items()
        }
    rp, pp = r_ex._ell_pack(False), p_ex._ell_pack(False)
    assert max(b[0].shape[1] for b in pp.buckets) == 16
    assert len(rp.buckets) == len(pp.buckets)
    for a, b in zip(rp.buckets, pp.buckets):
        np.testing.assert_array_equal(np.asarray(a[0]), b[0].numpy())
        if a[3] is not None:
            np.testing.assert_array_equal(np.asarray(a[3]), b[3].numpy())
    np.testing.assert_array_equal(np.asarray(rp.unpermute), pp.unpermute.numpy())
    # the static ladder takes the floors and growth (tuner off)
    r_static = TPUExecutor(rc, autotune=False, **OPTIONS)
    p_static = GPUExecutor(pc, autotune=False, device="cpu", **OPTIONS)
    r_static.run(RefSP(seed_index=0, max_iterations=6))
    p_static.run(ShortestPathProgram(seed_index=0, max_iterations=6))
    assert [(t["F_cap"], t["E_cap"]) for t in p_static.last_run_info["tiers"]] == [
        (t["F_cap"], t["E_cap"]) for t in r_static.last_run_info["tiers"]]


def test_footprint_equals_the_references():
    rc, pc = rmat()
    for cap in (16, 1 << 14):
        for und in (False, True):
            assert GPUExecutor.ell_footprint(pc, cap, und) == TPUExecutor.ell_footprint(rc, cap, und)


def test_cc_cutover_option_routes_cc_to_the_frontier():
    rc, pc = rmat()
    ex = GPUExecutor(pc, device="cpu")
    ex.run(ConnectedComponentsProgram(max_iterations=30))
    assert ex.last_run_info["path"] == "fused"  # dense by default
    ex = GPUExecutor(pc, device="cpu", frontier_cc_min_edges=1)
    out = ex.run(ConnectedComponentsProgram(max_iterations=30))
    assert ex.last_run_info["path"] == "frontier"
    r_ex = TPUExecutor(rc, frontier_cc_min_edges=1)
    want = r_ex.run(RefCC(max_iterations=30))
    assert r_ex.last_run_info["path"] == "frontier"
    np.testing.assert_array_equal(want["component"], out["component"])


def test_feature_options_reach_the_program():
    rc, pc = rmat(8)
    dims = dict(feature_dim=12, hidden_dim=12, out_dim=8, num_layers=1, seed=5)
    p_prog, r_prog = GCNForwardProgram(**dims), RefGCN(**dims)
    p_ex = GPUExecutor(pc, strategy="ell", device="cpu", features_dim_tier=64,
                       features_native_matmul=True)
    out = p_ex.run(p_prog)
    assert p_prog.d_pad == 64 and p_prog.native_matmul is True
    assert p_ex.last_run_info["autotune"]["feature_tier"] == 64
    r_ex = TPUExecutor(rc, strategy="ell", features_dim_tier=64)
    want = r_ex.run(r_prog)
    assert r_ex.last_run_info["autotune"]["feature_tier"] == 64
    assert out["h"].shape == want["h"].shape == (pc.num_vertices, 64)
    np.testing.assert_allclose(out["h"], want["h"], rtol=1e-5, atol=1e-6)


def test_graph_computer_passes_the_options(monkeypatch):
    from janusgraph_tpu_torch.olap import computer

    made = []
    real = computer.GPUExecutor

    def spy(*a, **kw):
        made.append(kw)
        return real(*a, **kw)

    monkeypatch.setattr(computer, "GPUExecutor", spy)
    g = _stored_graph({"computer.ell-max-capacity": 32, "computer.frontier-f-min": 16,
                       "computer.autotune-max-tiers": 3, "computer.features-native-matmul": True,
                       "computer.ell-auto-budget-bytes": 1 << 20, "computer.delta": False})
    g.compute(executor="cpu").program(PageRankProgram(max_iterations=2)).submit()
    kw = made[-1]
    assert kw["ell_max_capacity"] == 32 and kw["frontier_f_min"] == 16
    assert kw["autotune_max_tiers"] == 3 and kw["features_native_matmul"] is True
    assert kw["ell_auto_bytes"] == 1 << 20 and kw["frontier_tier_growth"] == 4
    assert kw["frontier_cc_min_edges"] == 1 << 30
    g.close()
