"""The port's sharded executor (``janusgraph_tpu_torch/parallel``) held to
the JAX package's on the same numpy-seeded graphs: the port on a mesh of 8
CPU slots, the reference's ``ShardedExecutor`` on the 8 virtual CPU
devices ``tests/conftest.py`` provides, both against the reference's
scalar CPU oracle at the reference test's own tolerance (rtol 1e-4, atol
1e-5). The twins of ``tests/test_sharded.py``, plus the port's own cases:
the host plans array for array against the reference's, fused against the
host loop bit for bit, a mesh of two device groups (explicit copies
between them) against one, a hub graph whose boundary sets are wide, and
the default mesh's need for a card."""

import numpy as np
import pytest
import torch

from janusgraph_tpu.olap import csr_from_edges as ref_csr_from_edges
from janusgraph_tpu.olap import run_on as ref_run_on
from janusgraph_tpu.olap import programs as ref_programs
from janusgraph_tpu.parallel import ShardedExecutor as RefShardedExecutor
from janusgraph_tpu.parallel import halo as ref_halo
from janusgraph_tpu.parallel import sharded as ref_sharded_mod
from janusgraph_tpu_torch.olap import csr_from_edges
from janusgraph_tpu_torch.olap import programs
from janusgraph_tpu_torch.olap.gpu_executor import GPUExecutor
from janusgraph_tpu_torch.parallel import Mesh, ShardedExecutor
from janusgraph_tpu_torch.parallel import sharded as sharded_mod

CPU = torch.device("cpu")


def graphs(n=170, m=700, seed=11, weights=False):
    """(reference CSR, port CSR) of one numpy-seeded random graph."""
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

    devices = np.array(jax.devices()[:8])
    assert len(devices) == 8, "conftest must provide 8 virtual devices"
    return JaxMesh(devices, ("p",))


PROGRAMS = [
    ("pagerank", lambda P: P.PageRankProgram(max_iterations=25)),
    ("sssp", lambda P: P.ShortestPathProgram(seed_index=0)),
    ("sssp_weighted", lambda P: P.ShortestPathProgram(seed_index=3, weighted=True)),
    ("cc", lambda P: P.ConnectedComponentsProgram()),
    ("khop", lambda P: P.TraversalCountProgram(hops=3)),
    ("peer_pressure", lambda P: P.PeerPressureProgram(num_buckets=512)),
]

PAIRS = [
    ("a2a", "ell"), ("a2a", "segment"), ("gather", "segment"), ("ring", "segment"),
    ("blocked", "ell"), ("blocked", "segment"),
]


def held(got, want, oracle, tag=""):
    """The port against the reference's sharded run and its CPU oracle."""
    assert set(got) == set(want) == set(oracle)
    for k in got:
        assert got[k].shape[0] == oracle[k].shape[0]  # padding stripped
        for other in (want, oracle):
            np.testing.assert_allclose(
                np.asarray(got[k], np.float64), np.asarray(other[k], np.float64),
                rtol=1e-4, atol=1e-5, err_msg=f"{tag}:{k}",
            )


@pytest.mark.parametrize("name,make", PROGRAMS, ids=[p[0] for p in PROGRAMS])
def test_sharded_matches_cpu_oracle(mesh8, ref_mesh8, name, make):
    rg, pg = graphs(weights=True)
    oracle = ref_run_on(rg, make(ref_programs), "cpu")
    want = RefShardedExecutor(rg, mesh=ref_mesh8).run(make(ref_programs))
    got = ShardedExecutor(pg, mesh=mesh8).run(make(programs))
    held(got, want, oracle, name)


def test_sharded_pagerank_mass_conserved(mesh8):
    _rg, pg = graphs(n=333, m=1200)  # deliberately not divisible by 8
    res = ShardedExecutor(pg, mesh=mesh8).run(programs.PageRankProgram(max_iterations=30))
    assert abs(res["rank"].sum() - 1.0) < 1e-4


def test_sharded_tiny_graph_fewer_vertices_than_shards(mesh8):
    """Three vertices over eight shards: most shards hold only padding, and
    a wrong per-shard offset would read another shard's block."""
    g = csr_from_edges(3, np.array([0, 1], np.int32), np.array([1, 2], np.int32))
    for exchange, agg in PAIRS:
        ex = ShardedExecutor(g, mesh=mesh8, exchange=exchange, agg=agg)
        np.testing.assert_allclose(
            ex.run(programs.ShortestPathProgram(seed_index=0))["distance"], [0, 1, 2]
        )
        dense = ex.run(programs.ShortestPathProgram(seed_index=0), frontier="off")
        np.testing.assert_allclose(dense["distance"], [0, 1, 2], err_msg=exchange)
        rank = ex.run(programs.PageRankProgram(max_iterations=10))["rank"]
        want = GPUExecutor(g, device="cpu").run(programs.PageRankProgram(max_iterations=10))["rank"]
        np.testing.assert_allclose(rank, want, rtol=1e-5, atol=1e-7, err_msg=exchange)


@pytest.mark.parametrize("exchange,agg", PAIRS)
def test_exchange_agg_matrix_parity(mesh8, ref_mesh8, exchange, agg):
    """Every exchange x aggregation pair gives the oracle's results and the
    reference's."""
    rg, pg = graphs(n=190, m=900, seed=5, weights=True)
    for make in (
        lambda P: P.PageRankProgram(max_iterations=12),
        lambda P: P.ShortestPathProgram(seed_index=2, weighted=True),
    ):
        oracle = ref_run_on(rg, make(ref_programs), "cpu")
        want = RefShardedExecutor(rg, mesh=ref_mesh8, exchange=exchange, agg=agg).run(
            make(ref_programs))
        got = ShardedExecutor(pg, mesh=mesh8, exchange=exchange, agg=agg).run(make(programs))
        held(got, want, oracle, f"{exchange}/{agg}")


def test_a2a_comm_volume_proportional_to_boundary(mesh8, ref_mesh8):
    """The all-to-all moves boundary buckets only (S*B elements), equal to
    the reference's plan, and the result stays exact."""
    n, k = 4096, 4
    src = np.repeat(np.arange(n, dtype=np.int64), k)
    dst = (src + np.tile(np.arange(1, k + 1), n)) % n
    g = csr_from_edges(n, src.astype(np.int32), dst.astype(np.int32))
    rg = ref_csr_from_edges(n, src.astype(np.int32), dst.astype(np.int32))
    ex = ShardedExecutor(g, mesh=mesh8)
    stats = ex.comm_stats()
    assert stats == RefShardedExecutor(rg, mesh=ref_mesh8).comm_stats()
    assert stats["gather_elems"] == 4096
    assert stats["boundary_width"] <= k and stats["a2a_elems"] <= 8 * k
    oracle = ref_run_on(rg, ref_programs.ShortestPathProgram(seed_index=0), "cpu")
    res = ex.run(programs.ShortestPathProgram(seed_index=0))
    np.testing.assert_allclose(res["distance"], oracle["distance"])


def test_supernode_row_split_parity(mesh8, ref_mesh8, monkeypatch):
    """Degrees past the ELL capacity row-split instead of padding a jumbo
    bucket; results stay exact."""
    monkeypatch.setattr(sharded_mod, "_ELL_MAX_CAPACITY", 8)
    monkeypatch.setattr(ref_sharded_mod, "_ELL_MAX_CAPACITY", 8)
    rng = np.random.default_rng(3)
    n = 120
    src = np.concatenate([np.arange(n), rng.integers(0, n, 300)]).astype(np.int32)
    dst = np.concatenate([np.full(n, 7), rng.integers(0, n, 300)]).astype(np.int32)
    g, rg = csr_from_edges(n, src, dst), ref_csr_from_edges(n, src, dst)
    ex = ShardedExecutor(g, mesh=mesh8)
    sc = ex._sharded(False)
    sc.ensure_ell()
    assert any(m is not None for m in sc.ell_meta), "expected a split bucket"
    for make in (
        lambda P: P.PageRankProgram(max_iterations=15),
        lambda P: P.ShortestPathProgram(seed_index=0),
    ):
        oracle = ref_run_on(rg, make(ref_programs), "cpu")
        want = RefShardedExecutor(rg, mesh=ref_mesh8).run(make(ref_programs))
        held(ex.run(make(programs), frontier="off"), want, oracle)


def test_sharded_single_device_mesh():
    _rg, pg = graphs(n=50, m=200)
    want = GPUExecutor(pg, device="cpu").run(programs.PageRankProgram(max_iterations=15))
    res = ShardedExecutor(pg, mesh=Mesh([CPU])).run(programs.PageRankProgram(max_iterations=15))
    np.testing.assert_allclose(res["rank"], want["rank"], rtol=1e-4, atol=1e-6)


def test_ring_exchange_parity_all_programs(mesh8, ref_mesh8):
    """The ring (one shard block rolled per hop) matches the oracle and the
    reference for every monoid and program shape, fused spans included."""
    rg, pg = graphs(n=190, m=800, seed=13, weights=True)
    for name, make in PROGRAMS:
        oracle = ref_run_on(rg, make(ref_programs), "cpu")
        want = RefShardedExecutor(rg, mesh=ref_mesh8, exchange="ring", agg="segment").run(
            make(ref_programs))
        got = ShardedExecutor(pg, mesh=mesh8, exchange="ring", agg="segment").run(make(programs))
        held(got, want, oracle, f"ring:{name}")


def test_ring_comm_stats(mesh8):
    _rg, pg = graphs(n=512, m=2000)
    ex = ShardedExecutor(pg, mesh=mesh8, exchange="ring", agg="segment")
    stats = ex.comm_stats()
    assert stats["ring_elems"] == 7 * stats["ring_peak_elems"]
    assert stats["a2a_elems"] is None  # the a2a plan is not built


# ---------------------------------------------------------------- frontier

def test_sharded_frontier_dense_parity_at_step_cutoffs(mesh8):
    _rg, pg = graphs(n=300, m=1500, seed=7)
    ex = ShardedExecutor(pg, mesh=mesh8)
    seed = int(np.argmax(pg.out_degree))
    for k in (1, 2, 3, 5):
        prog = programs.ShortestPathProgram(seed_index=seed, max_iterations=k)
        front = ex.run(prog)
        assert ex.last_run_info["path"] == "frontier"
        dense = ex.run(prog, frontier="off")
        np.testing.assert_array_equal(front["distance"], dense["distance"], err_msg=f"cutoff {k}")


def test_sharded_frontier_weighted_and_paths(mesh8, ref_mesh8):
    rg, pg = graphs(n=200, m=900, seed=3, weights=True)
    ex = ShardedExecutor(pg, mesh=mesh8)
    pw = programs.ShortestPathProgram(seed_index=1, weighted=True, max_iterations=12)
    np.testing.assert_allclose(
        ex.run(pw)["distance"], ex.run(pw, frontier="off")["distance"], rtol=1e-5
    )
    pt = programs.ShortestPathProgram(seed_index=1, max_iterations=6, track_paths=True)
    rf, rd = ex.run(pt), ex.run(pt, frontier="off")
    np.testing.assert_array_equal(rf["predecessor"], rd["predecessor"])
    np.testing.assert_array_equal(rf["distance"], rd["distance"])
    want = RefShardedExecutor(rg, mesh=ref_mesh8).run(
        ref_programs.ShortestPathProgram(seed_index=1, max_iterations=6, track_paths=True))
    np.testing.assert_array_equal(rf["predecessor"], want["predecessor"])
    pred = rf["predecessor"].astype(np.int64)
    v = int(np.nonzero(rf["distance"] < 1e17)[0][-1])
    for _ in range(pg.num_vertices):
        if v == 1:
            break
        v = int(pred[v])
    assert v == 1


def test_sharded_frontier_cc_parity_and_trace(mesh8, ref_mesh8):
    rg, pg = graphs(n=260, m=1000, seed=5, weights=True)  # weights ignored
    ex = ShardedExecutor(pg, mesh=mesh8)
    cc = programs.ConnectedComponentsProgram(max_iterations=32)
    rf = ex.run(cc, frontier="always")
    assert ex.last_run_info["path"] == "frontier"
    tiers = ex.last_run_info["tiers"]
    assert tiers and all(t["edges"] >= 0 and t["F_cap"] >= t["shard_max_frontier"] for t in tiers)
    assert tiers[-1]["frontier"] <= tiers[0]["frontier"]
    ref_ex = RefShardedExecutor(rg, mesh=ref_mesh8)
    want = ref_ex.run(ref_programs.ConnectedComponentsProgram(max_iterations=32),
                      frontier="always")
    # the hop trace is the reference's, hop for hop
    assert tiers == ref_ex.last_run_info["tiers"]
    np.testing.assert_array_equal(rf["component"], want["component"])
    rd = ex.run(cc, frontier="off")
    np.testing.assert_array_equal(rf["component"], rd["component"])


def test_sharded_frontier_matches_cpu_oracle(mesh8):
    rg, pg = graphs(n=180, m=800, seed=13)
    seed = int(np.argmax(pg.out_degree))
    oracle = ref_run_on(rg, ref_programs.ShortestPathProgram(seed_index=seed), "cpu")
    got = ShardedExecutor(pg, mesh=mesh8).run(programs.ShortestPathProgram(seed_index=seed))
    np.testing.assert_allclose(got["distance"], oracle["distance"], rtol=1e-6)


def test_sharded_frontier_respects_off_and_checkpoint(mesh8, tmp_path):
    _rg, pg = graphs(n=150, m=600, seed=2)
    ex = ShardedExecutor(pg, mesh=mesh8)
    prog = programs.ShortestPathProgram(seed_index=0, max_iterations=4)
    ex.run(prog, frontier="off")
    assert ex.last_run_info.get("path") != "frontier"
    ex.run(prog, checkpoint_path=str(tmp_path / "ck"), checkpoint_every=2)
    assert ex.last_run_info.get("path") != "frontier"


# ------------------------------------------------------- the port's own

def test_host_plans_equal_the_reference():
    """The numpy plans are the reference's copies: every array of the boundary,
    ring, frontier, uniform-ELL and blocked plans (the receiver's combine
    rows built without the reference's Python loop) equals the
    reference's."""
    rg, pg = graphs(n=210, m=900, seed=19, weights=True)
    for undirected in (False, True):
        ours = sharded_mod.ShardedCSR(pg, 8, undirected)
        ref = ref_sharded_mod.ShardedCSR(rg, 8, undirected)
        for sc in (ours, ref):
            sc.ensure_ell()
            sc.ensure_ring()
            sc.ensure_frontier_plan()
            sc.ensure_frontier_plan_blocked()
            sc.ensure_blocked_ell()
        for name in (
            "out_degree", "active", "in_degree", "in_src_glob", "in_dst_loc", "in_valid",
            "in_weight", "send_idx", "in_src_tab", "ell_unpermute", "ring_src_loc",
            "ring_dst_loc", "ring_valid", "ring_weight", "ftr_ip", "ftr_dst", "ftr_w",
            "ftr_deg", "ftr_src_glob", "fblk_ip", "fblk_dst", "fblk_w", "fblk_deg",
            "blk_src_loc", "blk_seg", "blk_bin_seg", "blk_valid", "blk_weight", "recv_dst",
            "bell_unpermute", "bell_recv_idx",
        ):
            np.testing.assert_array_equal(getattr(ours, name), getattr(ref, name), err_msg=name)
        for a_list, b_list in ((ours.ell_buckets, ref.ell_buckets),
                               (ours.bell_buckets, ref.bell_buckets)):
            assert len(a_list) == len(b_list)
            for a, b in zip(a_list, b_list):
                for x, y in zip(a, b):
                    if x is None:
                        assert y is None
                    else:
                        np.testing.assert_array_equal(x, y)
        assert ours.ell_meta == ref.ell_meta and ours.bell_meta == ref.bell_meta
        src, dst, _w = ref_halo.edges_from_sharded(ref)
        from janusgraph_tpu_torch.parallel import halo

        assert halo.pair_widths(src, dst, 8, ref.shard_size) == ref_halo.pair_widths(
            src, dst, 8, ref.shard_size)


@pytest.mark.parametrize("exchange,agg", PAIRS)
def test_fused_equals_the_host_loop_bitwise(mesh8, exchange, agg):
    """The fused span (predicated chunks) runs the host loop's supersteps:
    the same bits, for a SUM and a MIN program."""
    _rg, pg = graphs(n=230, m=1000, seed=23, weights=True)
    for make in (lambda: programs.PageRankProgram(max_iterations=20),
                 lambda: programs.ConnectedComponentsProgram()):
        ex = ShardedExecutor(pg, mesh=mesh8, exchange=exchange, agg=agg)
        fused = ex.run(make(), fused=True, frontier="off")
        assert ex.last_run_info["path"] == "fused"
        host = ShardedExecutor(pg, mesh=mesh8, exchange=exchange, agg=agg).run(
            make(), fused=False, frontier="off")
        for k in fused:
            np.testing.assert_array_equal(fused[k], host[k], err_msg=f"{exchange}/{agg}:{k}")


@pytest.mark.parametrize("exchange,agg", PAIRS)
def test_two_device_groups_equal_one(mesh8, exchange, agg):
    """A mesh whose slots sit on two devices (torch counts cpu and cpu:0 as
    two) runs the body per group and meets in explicit copies: the same
    bits as the one-device mesh, dense and frontier."""
    mesh2 = Mesh([CPU] * 4 + [torch.device("cpu", 0)] * 4)
    assert len(mesh2.groups) == 2
    _rg, pg = graphs(n=150, m=700, seed=29, weights=True)
    for make, frontier in (
        (lambda: programs.PageRankProgram(max_iterations=12), "off"),
        (lambda: programs.ShortestPathProgram(seed_index=2, weighted=True), "auto"),
        (lambda: programs.PeerPressureProgram(num_buckets=16, rounds=4), "off"),
    ):
        a = ShardedExecutor(pg, mesh=mesh8, exchange=exchange, agg=agg).run(make(), frontier=frontier)
        b = ShardedExecutor(pg, mesh=mesh2, exchange=exchange, agg=agg).run(make(), frontier=frontier)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=f"{exchange}/{agg}:{k}")


def test_hub_graph_wide_boundaries(mesh8, ref_mesh8):
    """A hub every shard links to and from: the boundary and halo widths
    approach the shard size, and every exchange still meets the oracle."""
    n = 256
    rng = np.random.default_rng(31)
    src = np.concatenate([np.arange(n), np.full(n, 5), rng.integers(0, n, 600)]).astype(np.int32)
    dst = np.concatenate([np.full(n, 5), np.arange(n), rng.integers(0, n, 600)]).astype(np.int32)
    rg, pg = ref_csr_from_edges(n, src, dst), csr_from_edges(n, src, dst)
    ex = ShardedExecutor(pg, mesh=mesh8)
    assert ex.comm_stats()["boundary_width"] >= n // 8 - 1
    for exchange, agg in PAIRS:
        for make in (lambda P: P.PageRankProgram(max_iterations=10),
                     lambda P: P.ConnectedComponentsProgram()):
            oracle = ref_run_on(rg, make(ref_programs), "cpu")
            want = RefShardedExecutor(rg, mesh=ref_mesh8, exchange=exchange, agg=agg).run(
                make(ref_programs))
            got = ShardedExecutor(pg, mesh=mesh8, exchange=exchange, agg=agg).run(make(programs))
            held(got, want, oracle, f"hub {exchange}/{agg}")


def test_default_mesh_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _rg, pg = graphs(n=20, m=40)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ShardedExecutor(pg)
    with pytest.raises(RuntimeError, match="not available"):
        Mesh([torch.device("cuda", 0)] * 2)
    with pytest.raises(ValueError):
        Mesh([])


def test_run_record_and_timeline_lanes(mesh8):
    """The run publishes GPUExecutor's record vocabulary plus the shards,
    the exchange and the mesh; the timeline draws one lane per shard."""
    from janusgraph_tpu_torch.observability import registry
    from janusgraph_tpu_torch.observability.timeline import chrome_trace, validate_chrome_trace

    _rg, pg = graphs(n=120, m=500, seed=37)
    ex = ShardedExecutor(pg, mesh=mesh8, exchange="blocked")
    ex.run(programs.PageRankProgram(max_iterations=5, tol=0.0), fused=False)
    info = registry.last_run("olap")
    assert info["executor"] == "sharded" and info["path"] == "host-loop"
    assert info["mesh"] == {"slots": 8, "devices": ["cpu"] * 8, "groups": 1}
    assert len(info["superstep_records"]) == 5 and info["h2d_arg_bytes"] > 0
    doc = chrome_trace(info)
    assert validate_chrome_trace(doc) is None
    lanes = {e["args"]["name"] for e in doc["traceEvents"] if e["ph"] == "M"}
    assert {f"shard {s}" for s in range(8)} <= lanes
    assert sum(1 for e in doc["traceEvents"] if e.get("cat") == "exchange") == 5 * 8
