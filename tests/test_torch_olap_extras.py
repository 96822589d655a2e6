"""The port's degree program, MapReduce jobs, LDBC/Twitter generators and
Fulgora baseline held against the JAX package's on the same seeds.

Graphs stay at 2^12 vertices or fewer so the reference's JAX compiles stay
cheap."""

import numpy as np
import pytest

import janusgraph_tpu.olap as ref
from janusgraph_tpu.olap import fulgora_baseline as ref_fb
from janusgraph_tpu.olap import generators as ref_gen
from janusgraph_tpu.olap import mapreduce as ref_mr
from janusgraph_tpu.olap.cpu_executor import CPUExecutor
from janusgraph_tpu.olap.programs import (
    ConnectedComponentsProgram as RefCC,
    DegreeCountProgram as RefDegree,
)
from janusgraph_tpu.olap.tpu_executor import TPUExecutor
from janusgraph_tpu_torch.olap import (
    LDBC_SF_SIZES,
    ClusterCountMapReduce,
    FulgoraAnalogueComputer,
    GPUExecutor,
    MapReduce,
    StatsMapReduce,
    TopKMapReduce,
    csr_from_edges,
    ldbc_sf_csr,
    ldbc_snb_csr,
    ldbc_snb_edges,
    measure_fulgora_baseline,
    run_map_reduce,
    run_on,
    twitter_csr,
    twitter_edges,
)
from janusgraph_tpu_torch.olap import generators as gen
from janusgraph_tpu_torch.olap.programs import (
    ConnectedComponentsProgram,
    DegreeCountProgram,
    PageRankProgram,
)

CSR_ARRAYS = ("vertex_ids", "out_indptr", "out_dst", "in_indptr", "in_src", "out_degree")


def _graph(n=300, m=1800, seed=17, dangling=False):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, m).astype(np.int32)
    dst = rng.integers(0, n, m).astype(np.int32)
    if dangling:
        src = np.where(src % 7 == 0, (src + 1) % n, src).astype(np.int32)
    return csr_from_edges(n, src, dst), ref.csr_from_edges(n, src, dst)


def _assert_csr_equal(pc, rc):
    for f in CSR_ARRAYS:
        a, b = getattr(pc, f), getattr(rc, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    assert set(pc.properties) == set(rc.properties)
    for k in rc.properties:
        np.testing.assert_array_equal(pc.properties[k], rc.properties[k], err_msg=k)


# ------------------------------------------------------------------ degree
@pytest.mark.parametrize("strategy", ["segsum", "ell", "hybrid"])
@pytest.mark.parametrize("fused", [True, False])
def test_degree_count_equal_reference(strategy, fused):
    pc, rc = _graph(dangling=True)
    ex = GPUExecutor(pc, strategy=strategy, device="cpu")
    got = ex.run(DegreeCountProgram(), fused=fused)
    want = TPUExecutor(rc, strategy="ell").run(RefDegree())
    assert set(got) == {"in_degree", "out_degree"}
    for k in got:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)
        np.testing.assert_array_equal(got[k], CPUExecutor(rc).run(RefDegree())[k].astype(np.float32))
    np.testing.assert_array_equal(got["in_degree"], pc.in_degree.astype(np.float32))
    np.testing.assert_array_equal(got["out_degree"], pc.out_degree.astype(np.float32))
    assert ex.last_run_info["supersteps"] == 1
    assert ex.last_run_info["path"] == ("fused" if fused else "host-loop")


# --------------------------------------------------------------- MapReduce
def test_cluster_count_over_components_equal_reference():
    pc, rc = _graph(n=400, m=300, seed=3)
    comp = run_on(pc, ConnectedComponentsProgram(), device="cpu")
    rcomp = TPUExecutor(rc).run(RefCC())
    np.testing.assert_array_equal(comp["component"], np.asarray(rcomp["component"]))
    got = run_map_reduce(ClusterCountMapReduce("component"), comp, pc)
    want = ref_mr.run_map_reduce(ref_mr.ClusterCountMapReduce("component"),
                                 {k: np.asarray(v) for k, v in rcomp.items()}, rc)
    assert got == want
    labels, sizes = np.unique(comp["component"], return_counts=True)
    assert got["count"] == len(labels) > 1
    assert got["sizes"] == {float(a): float(b) for a, b in zip(labels, sizes)}
    assert ClusterCountMapReduce().memory_key == "clusterCount"


def test_stats_and_top_k_over_ranks_equal_reference():
    pc, rc = _graph()
    rank = run_on(pc, PageRankProgram(max_iterations=10, tol=0.0), device="cpu")
    rrank = {"rank": np.asarray(rank["rank"])}
    assert run_map_reduce(StatsMapReduce("rank"), rank, pc) == ref_mr.run_map_reduce(
        ref_mr.StatsMapReduce("rank"), rrank, rc)
    for k in (1, 10, 300, 500):
        got = TopKMapReduce("rank", k).execute(rank, pc)
        assert got == ref_mr.TopKMapReduce("rank", k).execute(rrank, rc)
        assert len(got) == min(k, 300)
        assert [v for _i, v in got] == sorted((v for _i, v in got), reverse=True)
    stats = StatsMapReduce("rank").execute(rank, pc)
    assert stats["count"] == 300 and abs(stats["sum"] - 1.0) < 1e-5


@pytest.mark.parametrize("op", ["sum", "min", "max"])
def test_group_by_reduce_monoids_equal_reference(op):
    class ByDegree(MapReduce):
        reduce_op = op

        def map(self, states, csr, xp):
            return xp.asarray(csr.out_degree), xp.asarray(states["rank"], dtype=xp.float64)

    class RefByDegree(ref_mr.MapReduce):
        reduce_op = op

        def map(self, states, csr, xp):
            return xp.asarray(csr.out_degree), xp.asarray(states["rank"], dtype=xp.float64)

    pc, rc = _graph()
    rank = run_on(pc, PageRankProgram(max_iterations=5), device="cpu")
    assert ByDegree().execute(rank, pc) == RefByDegree().execute(rank, rc)


# -------------------------------------------------------------- generators
def test_ldbc_snb_edges_equal_reference():
    got = ldbc_snb_edges(10)
    want = ref_gen.ldbc_snb_edges(10)
    assert got[0] == want[0] == 1024
    for a, b in zip(got[1:3], want[1:3]):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert set(got[3]) == {"community", "country", "creation_day"}
    for k in got[3]:
        np.testing.assert_array_equal(got[3][k], want[3][k])
    other = ldbc_snb_edges(10, seed=8)
    assert not np.array_equal(other[2], got[2])
    _assert_csr_equal(ldbc_snb_csr(9, seed=3), ref_gen.ldbc_snb_csr(9, seed=3))


def test_ldbc_sf_csr_equal_reference():
    pc = ldbc_sf_csr(1, scale_down=1000)
    rc = ref_gen.ldbc_sf_csr(1, scale_down=1000)
    _assert_csr_equal(pc, rc)
    nv, ne = LDBC_SF_SIZES[1]
    assert LDBC_SF_SIZES == ref_gen.LDBC_SF_SIZES
    assert pc.num_vertices == nv // 1000 and pc.num_edges == ne // 1000


def test_twitter_edges_equal_reference():
    got = twitter_edges(2**12)
    want = ref_gen.twitter_edges(2**12)
    assert got[0] == want[0]
    for a, b in zip(got[1:], want[1:]):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert len(got[1]) == int(2**12 * 35.0)
    _assert_csr_equal(twitter_csr(2**11, 20, seed=3), ref_gen.twitter_csr(2**11, 20, seed=3))


def test_land_edge_count_equal_reference():
    for target in (50, 500, 5000):
        a = gen._land_edge_count(np.full(100, 7, np.int64), target, np.random.default_rng(2))
        b = ref_gen._land_edge_count(np.full(100, 7, np.int64), target, np.random.default_rng(2))
        np.testing.assert_array_equal(a, b)
        assert a.sum() == max(target, 100) or target < 100


# ------------------------------------------------------------------ Fulgora
def test_fulgora_ranks_equal_reference():
    pc, rc = _graph()
    rank, wall = FulgoraAnalogueComputer(pc, num_workers=3).pagerank(12)
    want, _ = ref_fb.FulgoraAnalogueComputer(rc, num_workers=3).pagerank(12)
    np.testing.assert_allclose(rank, want, rtol=1e-6)
    np.testing.assert_allclose(rank, run_on(pc, PageRankProgram(max_iterations=12, tol=0.0),
                                            device="cpu")["rank"], rtol=1e-5)
    assert wall > 0 and abs(rank.sum() - 1.0) < 1e-6


def test_fulgora_dangling_mass_and_measure():
    n = 6
    star = csr_from_edges(n, np.arange(1, n, dtype=np.int32), np.zeros(n - 1, np.int32))
    rank, _ = FulgoraAnalogueComputer(star, num_workers=2).pagerank(20)
    assert abs(rank.sum() - 1.0) < 1e-9 and rank[0] > rank[1]
    pc, _rc = _graph()
    m = measure_fulgora_baseline(pc, iterations=2, num_workers=2)
    assert set(m) == set(ref_fb.measure_fulgora_baseline(_rc, iterations=1, num_workers=1))
    assert m["edges_per_sec"] > 0 and m["iterations"] == 2 and m["num_workers"] == 2
