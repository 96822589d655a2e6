"""Typed edge channels and per-column edge transforms in the port, held
against the JAX package on the same seeded graphs.

The reference side runs as its own tests run it: ``TPUExecutor`` on JAX's
CPU backend, and ``CPUExecutor`` (the numpy oracle). Channel steps are MIN
relaxations here (exact, no order), so every strategy of the port must give
the reference's distances bit for bit."""

import numpy as np
import pytest
import torch

import janusgraph_tpu.olap as ref
from janusgraph_tpu.olap.cpu_executor import CPUExecutor
from janusgraph_tpu.olap.csr import channel_edges as ref_channel_edges
from janusgraph_tpu.olap.programs.olap_traversal import (
    OLAPTraversalProgram as RefOLAP,
    TraversalStep as RefStep,
)
from janusgraph_tpu.olap.tpu_executor import TPUExecutor
from janusgraph_tpu.olap.vertex_program import (
    Combiner as RefCombiner,
    EdgeChannel as RefChannel,
    EdgeTransform as RefTransform,
    VertexProgram as RefVP,
    apply_edge_transform as ref_apply_edge_transform,
    check_weighted_transforms as ref_check_weighted_transforms,
)
from janusgraph_tpu_torch.olap import (
    Combiner,
    EdgeChannel,
    EdgeTransform,
    GPUExecutor,
    VertexProgram,
    channel_edges,
    csr_from_edges,
    kernels,
    run_on,
)
from janusgraph_tpu_torch.olap import delta as D
from janusgraph_tpu_torch.olap.programs import (
    GCNForwardProgram,
    OLAPTraversalProgram,
    TraversalStep,
    build_olap_traversal,
)
from janusgraph_tpu_torch.olap.vertex_program import (
    apply_edge_transform,
    check_weighted_transforms,
)

INF = 1e18
STRATEGIES = ["segsum", "ell", "hybrid", "segment", "auto"]


def two_label(n=150, m=800, seed=7, labels=2, weights=False):
    """(port CSR, reference CSR, (src, dst, types, weights))."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, m).astype(np.int32)
    dst = rng.integers(0, n, m).astype(np.int32)
    et = rng.integers(0, labels, m).astype(np.int32)
    w = rng.uniform(0.5, 2.0, m).astype(np.float32) if weights else None
    return (csr_from_edges(n, src, dst, w, edge_types=et),
            ref.csr_from_edges(n, src, dst, w, edge_types=et), (src, dst, et, w))


class Alternating(VertexProgram):
    """Hop relaxation over label-0 edges on even supersteps and label-1
    edges on odd ones."""

    compute_keys = ("dist",)
    combiner = Combiner.MIN
    setup_only_params = ("seed_index",)
    edge_channels = {"even": EdgeChannel("out", (0,)), "odd": EdgeChannel("out", (1,))}

    def __init__(self, seed_index=0, max_iterations=4):
        self.seed_index = seed_index
        self.max_iterations = max_iterations

    def channel_for(self, superstep):
        return "even" if superstep % 2 == 0 else "odd"

    def setup(self, graph):
        idx = torch.arange(graph.local_num_vertices) + graph.global_offset
        dist = torch.where(idx == self.seed_index, 0.0, INF).to(torch.float32)
        return {"dist": dist}, {"changed": (Combiner.SUM, torch.tensor(1.0))}

    def message(self, state, superstep, graph):
        return state["dist"] + 1.0

    def apply(self, state, aggregated, superstep, memory_in, graph):
        new = torch.minimum(state["dist"], aggregated)
        changed = torch.sum(torch.where(new < state["dist"], 1.0, 0.0))
        return {"dist": new}, {"changed": (Combiner.SUM, changed)}

    def terminate(self, memory):
        return memory.get("changed", 1.0) == 0.0


class RefAlternating(RefVP):
    compute_keys = ("dist",)
    combiner = RefCombiner.MIN
    setup_only_params = ("seed_index",)
    edge_channels = {"even": RefChannel("out", (0,)), "odd": RefChannel("out", (1,))}

    def __init__(self, seed_index=0, max_iterations=4):
        self.seed_index = seed_index
        self.max_iterations = max_iterations

    def channel_for(self, superstep):
        return "even" if superstep % 2 == 0 else "odd"

    def setup(self, graph, xp):
        idx = xp.arange(graph.local_num_vertices) + graph.global_offset
        return {"dist": xp.where(idx == self.seed_index, 0.0, INF)}, {
            "changed": (RefCombiner.SUM, xp.asarray(1.0))}

    def message(self, state, superstep, graph, xp):
        return state["dist"] + 1.0

    def apply(self, state, aggregated, superstep, memory_in, graph, xp):
        new = xp.minimum(state["dist"], aggregated)
        changed = xp.sum(xp.where(new < state["dist"], 1.0, 0.0))
        return {"dist": new}, {"changed": (RefCombiner.SUM, changed)}

    def terminate(self, memory):
        return memory.get("changed", 1.0) == 0.0


class Both(Alternating):
    edge_channels = {"even": EdgeChannel("both", (0,)), "odd": EdgeChannel("both", (1,))}


class RefBoth(RefAlternating):
    edge_channels = {"even": RefChannel("both", (0,)), "odd": RefChannel("both", (1,))}


def numpy_relax(n, src, dst, et, steps, both=False):
    dist = np.full(n, INF)
    dist[0] = 0.0
    for step in range(steps):
        m = et == step % 2
        agg = np.full(n, INF)
        np.minimum.at(agg, dst[m], dist[src[m]] + 1.0)
        if both:
            np.minimum.at(agg, src[m], dist[dst[m]] + 1.0)
        dist = np.minimum(dist, agg)
    return dist


# ----------------------------------------------------------- channel_edges
@pytest.mark.parametrize("direction", ["out", "in", "both"])
@pytest.mark.parametrize("labels", [None, (0,), (1, 2), (7,)])
@pytest.mark.parametrize("weights", [False, True])
def test_channel_edges_array_equal(direction, labels, weights):
    pc, rc, _ = two_label(labels=3, weights=weights)
    got = channel_edges(pc, EdgeChannel(direction, labels))
    want = ref_channel_edges(rc, RefChannel(direction, labels))
    for a, b in zip(got, want):
        if b is None:
            assert a is None
        else:
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


def test_channel_edges_without_types_and_bad_direction_raise():
    pc = csr_from_edges(4, [0, 1], [1, 2])
    rc = ref.csr_from_edges(4, [0, 1], [1, 2])
    for fn, csr, ch in ((channel_edges, pc, EdgeChannel), (ref_channel_edges, rc, RefChannel)):
        with pytest.raises(ValueError, match="type arrays"):
            fn(csr, ch("out", (0,)))
        with pytest.raises(ValueError, match="unknown channel direction"):
            fn(csr, ch("sideways"))


def test_edge_list_plan_sorts_stably_by_destination():
    pc, _rc, (src, dst, et, _w) = two_label(labels=3, weights=True)
    s, d, w = channel_edges(pc, EdgeChannel("both", (0, 2)))
    plan, ps, pw = kernels.edge_list_plan(s, d, w, pc.num_vertices)
    order = np.argsort(d, kind="stable")
    np.testing.assert_array_equal(ps, s[order])
    np.testing.assert_array_equal(pw, w[order])
    np.testing.assert_array_equal(plan.seg_ptr, np.searchsorted(d[order], np.arange(pc.num_vertices + 1)))
    x = np.random.default_rng(0).random(pc.num_vertices).astype(np.float32)
    got = kernels.sorted_segment_sum(torch.as_tensor(x[ps]), plan).numpy()
    want = np.zeros(pc.num_vertices, np.float64)
    np.add.at(want, d, x[s].astype(np.float64))
    np.testing.assert_allclose(got, want, rtol=1e-5)
    # a label set that matches nothing: a plan of zero edges sums to zero
    s0, d0, w0 = channel_edges(pc, EdgeChannel("in", (9,)))
    plan0, _, _ = kernels.edge_list_plan(s0, d0, w0, pc.num_vertices)
    empty = kernels.sorted_segment_sum(torch.zeros(0), plan0)
    assert plan0.num_edges == 0 and empty.shape == (pc.num_vertices,) and not empty.any()


# ------------------------------------------------------ channel programs
@pytest.mark.parametrize("strategy", STRATEGIES)
def test_alternating_channels_parity(strategy):
    pc, rc, (src, dst, et, _w) = two_label()
    got = GPUExecutor(pc, strategy=strategy, device="cpu").run(Alternating(0, 4))["dist"]
    want = np.asarray(TPUExecutor(rc).run(RefAlternating(0, 4))["dist"])
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, numpy_relax(pc.num_vertices, src, dst, et, 4).astype(np.float32))
    np.testing.assert_array_equal(
        got, CPUExecutor(rc).run(RefAlternating(0, 4))["dist"].astype(np.float32))


@pytest.mark.parametrize("strategy", ["segsum", "ell"])
def test_both_direction_channel_parity(strategy):
    pc, rc, (src, dst, et, _w) = two_label(n=80, m=300, seed=3)
    got = GPUExecutor(pc, strategy=strategy, device="cpu").run(Both(0, 4))["dist"]
    np.testing.assert_array_equal(got, np.asarray(TPUExecutor(rc).run(RefBoth(0, 4))["dist"]))
    np.testing.assert_array_equal(
        got, numpy_relax(80, src, dst, et, 4, both=True).astype(np.float32))


def test_channels_actually_restrict_traversal():
    # 0 -(0)-> 1 -(1)-> 2 -(0)-> 3, and 0 -(0)-> 4 -(0)-> 5
    src = np.array([0, 1, 2, 0, 4], dtype=np.int32)
    dst = np.array([1, 2, 3, 4, 5], dtype=np.int32)
    et = np.array([0, 1, 0, 0, 0], dtype=np.int32)
    g = csr_from_edges(6, src, dst, edge_types=et)
    ex = GPUExecutor(g, device="cpu")
    d = ex.run(Alternating(0, 3))["dist"]
    assert d.tolist()[:6] == [0.0, 1.0, 2.0, 3.0, 1.0, 2.0]
    assert ex.run(Alternating(0, 1))["dist"][5] >= INF
    info = ex.last_run_info
    assert info["path"] == "host-loop"
    assert [r["channel"] for r in info["superstep_records"]] == ["even"]
    assert info["strategy_resolved"] == "ell"  # MIN takes the channel's ELL pack


def test_channel_steps_record_channel_and_strategy():
    pc, _rc, _ = two_label(labels=3)
    ex = GPUExecutor(pc, device="cpu")
    prog = OLAPTraversalProgram([TraversalStep("out", (0,)), TraversalStep("both"),
                                 TraversalStep("in", (1, 2))])
    assert not prog.fused_eligible()
    launches = kernels.sorted_segment_sum.launches
    ex.run(prog, fused=True)  # a channel program never fuses
    info = ex.last_run_info
    assert info["path"] == "host-loop" and info["supersteps"] == 3
    assert [(r["channel"], r["combiner"], r["strategy"]) for r in info["superstep_records"]] == [
        ("s0", "sum", "segsum"), ("s1", "sum", "segsum"), ("s2", "sum", "segsum")]
    assert info["strategy_resolved"] == "segsum"
    # on the CPU the wrapper runs the plain version: no launch counted
    assert kernels.sorted_segment_sum.launches == launches
    ell = GPUExecutor(pc, strategy="ell", device="cpu")
    ell.run(OLAPTraversalProgram([TraversalStep("out", (0,))], sack=None))
    assert ell.last_run_info["superstep_records"][0]["strategy"] == "ell"


def test_executor_reuse_does_not_alias_channels():
    pc, _rc, (src, dst, et, _w) = two_label(labels=3)
    ex = GPUExecutor(pc, device="cpu")
    a = ex.run(OLAPTraversalProgram([TraversalStep("out", (0,))]))["count"]
    b = ex.run(OLAPTraversalProgram([TraversalStep("in", (2,))]))["count"]
    assert a.sum() == (et == 0).sum() and b.sum() == (et == 2).sum()
    np.testing.assert_array_equal(a, np.bincount(dst[et == 0], minlength=pc.num_vertices))
    np.testing.assert_array_equal(b, np.bincount(src[et == 2], minlength=pc.num_vertices))
    assert set(ex._channel_packs) == {EdgeChannel("out", (0,)), EdgeChannel("in", (2,))}


def test_channel_cache_bounded_and_eviction_safe():
    pc, _rc, (src, dst, et, _w) = two_label(labels=6)
    assert GPUExecutor.CHANNEL_CACHE_SIZE == 8
    ex = GPUExecutor(pc, device="cpu")
    ex.CHANNEL_CACHE_SIZE = 4
    specs = [(d, lab) for lab in range(6) for d in ("out", "in")]
    first = {}
    for d, lab in specs:
        first[(d, lab)] = ex.run(OLAPTraversalProgram([TraversalStep(d, (lab,))]))["count"]
        assert len(ex._channel_packs) <= 4
    # the least recently used went first; the first spec is long gone
    assert list(ex._channel_packs) == [EdgeChannel(d, (lab,)) for d, lab in specs[-4:]]
    again = ex.run(OLAPTraversalProgram([TraversalStep("out", (0,))]))["count"]
    np.testing.assert_array_equal(again, first[("out", 0)])
    np.testing.assert_array_equal(again, np.bincount(dst[et == 0], minlength=pc.num_vertices))
    # a hit moves its channel to the back
    ex.run(OLAPTraversalProgram([TraversalStep("in", (4,))]))
    assert list(ex._channel_packs)[-1] == EdgeChannel("in", (4,))
    # an evicted pack's tensors are released with it
    import weakref

    entry = ex._channel_packs[EdgeChannel("in", (4,))]
    plan = weakref.ref(entry.segsum()[0])
    del entry
    for lab in (0, 1, 2, 3):
        ex.run(OLAPTraversalProgram([TraversalStep("both", (lab,))]))
    assert plan() is None


def test_run_on_runs_channel_programs():
    pc, rc, _ = two_label(labels=3)
    steps = [("out", (0,)), ("both", (1,)), ("in", None)]
    got = run_on(pc, OLAPTraversalProgram([TraversalStep(d, lab) for d, lab in steps]),
                 device="cpu")["count"]
    want = TPUExecutor(rc).run(RefOLAP([RefStep(d, lab) for d, lab in steps]))["count"]
    np.testing.assert_array_equal(got, np.asarray(want))


# ---------------------------------------------------- per-column transforms
COLS = [
    (RefTransform.NONE, RefTransform.MUL_WEIGHT),
    (RefTransform.NONE, RefTransform.NONE, RefTransform.MUL_WEIGHT),
    (RefTransform.ADD_WEIGHT, RefTransform.MUL_WEIGHT, RefTransform.NONE),
]


@pytest.mark.parametrize("cols", COLS)
def test_apply_edge_transform_cols_equal(cols):
    rng = np.random.default_rng(3)
    k = len(cols)
    msgs = rng.standard_normal((5, 8, k)).astype(np.float32)
    msgs[0, 0] = -0.0
    w = rng.uniform(0.5, 2.0, (5, 8)).astype(np.float32)
    w[1, :] = 1e-8  # below float32 eps from 1: the where-select stays exact
    got = apply_edge_transform(torch.as_tensor(msgs), torch.as_tensor(w), EdgeTransform.NONE, cols)
    want = ref_apply_edge_transform(np, msgs, w, RefTransform.NONE, cols)
    np.testing.assert_array_equal(got.numpy().view(np.int32), want.view(np.int32))
    with pytest.raises(ValueError, match="entries"):
        apply_edge_transform(torch.as_tensor(msgs[..., :1]), torch.as_tensor(w),
                             EdgeTransform.NONE, cols)


def test_tiny_weight_mul_column_exact():
    out = apply_edge_transform(torch.ones(1, 2), torch.tensor([1e-8]), EdgeTransform.NONE,
                               (EdgeTransform.NONE, EdgeTransform.MUL_WEIGHT))
    assert out[0, 0].item() == 1.0 and out[0, 1].item() == np.float32(1e-8)


@pytest.mark.parametrize("layout", ["ell", "hybrid"])
@pytest.mark.parametrize("cols", COLS)
def test_pack_aggregates_take_cols_bitwise(layout, cols):
    from janusgraph_tpu.olap import kernels as rk

    _pc, _rc, (src, dst, _et, w) = two_label(labels=1, weights=True)
    n = 150
    msgs = np.random.default_rng(8).random((n, len(cols))).astype(np.float32)
    if layout == "ell":
        got = kernels.ell_aggregate(kernels.ELLPack(src, dst, w, n).to("cpu"), torch.as_tensor(msgs),
                                    "sum", EdgeTransform.NONE, cols)
        want = rk.ell_aggregate(np, rk.ELLPack(src, dst, w, n), msgs, "sum",
                                RefTransform.NONE, cols)
    else:
        got = kernels.hybrid_aggregate(kernels.HybridPack(src, dst, w, n, hub_cutoff=4, tail_chunk=4).to("cpu"),
                                       torch.as_tensor(msgs), "sum", EdgeTransform.NONE, cols)
        want = rk.hybrid_aggregate(np, rk.HybridPack(src, dst, w, n, hub_cutoff=4, tail_chunk=4),
                                   msgs, "sum", RefTransform.NONE, cols)
    np.testing.assert_array_equal(got.numpy().view(np.int32), np.asarray(want).view(np.int32))


def test_check_weighted_transforms_sees_cols():
    pc, rc, _ = two_label()

    class P:
        edge_transform = EdgeTransform.NONE
        edge_transform_cols = (EdgeTransform.NONE, EdgeTransform.MUL_WEIGHT)

    class Q(P):
        edge_transform_cols = (EdgeTransform.NONE, EdgeTransform.NONE)

    for check, csr in ((check_weighted_transforms, pc), (ref_check_weighted_transforms, rc)):
        with pytest.raises(ValueError, match="no edge weights"):
            check(P(), csr)
        check(Q(), csr)


def test_weightless_sack_refused():
    pc, rc, _ = two_label()
    with pytest.raises(ValueError, match="weight"):
        build_olap_traversal(None, pc, [("out", None)], sack="sum")
    prog = OLAPTraversalProgram([TraversalStep("out")], sack="mult")
    with pytest.raises(ValueError, match="no edge weights"):
        GPUExecutor(pc, device="cpu").run(prog)
    with pytest.raises(ValueError, match="no edge weights"):
        TPUExecutor(rc).run(RefOLAP([RefStep("out")], sack="mult"))
    with pytest.raises(ValueError, match="sack op"):
        OLAPTraversalProgram([TraversalStep("out")], sack="max")


# ------------------------------------------------------------- refusals
def test_channel_program_refused_over_a_delta_overlay():
    pc, _rc, (src, dst, _et, _w) = two_label()
    z = np.zeros(3, np.int64)
    ov = D.DeltaOverlay.from_batches([{"add": (np.arange(3), np.arange(3) + 1, z),
                                       "del": (src[:2].astype(np.int64), dst[:2].astype(np.int64), z[:2]),
                                       "v_add": {}, "v_del": []}])
    ex = GPUExecutor(pc, device="cpu", delta=D.OverlayView(pc, ov))
    with pytest.raises(ValueError, match="default-edge-view"):
        ex.run(OLAPTraversalProgram([TraversalStep("out", (0,))]))
    with pytest.raises(ValueError, match="default-edge-view"):
        ex.run(Alternating(0, 2))
    assert not D.program_delta_compatible(OLAPTraversalProgram([TraversalStep("out")]))
    assert D.program_delta_compatible(GCNForwardProgram(feature_dim=8))


def test_channel_program_refused_under_sddmm():
    pc, _rc, _ = two_label()

    class Channelled(GCNForwardProgram):
        def channel_for(self, superstep):
            return None

    with pytest.raises(ValueError, match="channels"):
        GPUExecutor(pc, strategy="ell", device="cpu").run(Channelled(feature_dim=8, attention=True))
    # the base class's channel_for is no channel: plain sddmm runs
    h = GPUExecutor(pc, strategy="ell", device="cpu").run(
        GCNForwardProgram(feature_dim=8, attention=True))["h"]
    assert np.isfinite(h).all()


def test_channels_on_the_sharded_executor():
    """Typed channels through the sharded executor (one sharded edge view
    per channel value, LRU-cached) on 8 CPU slots: the reference's sharded
    run's distances and the port's single-device run's, bit for bit."""
    import jax
    from jax.sharding import Mesh as JaxMesh

    from janusgraph_tpu.parallel import ShardedExecutor as RefShardedExecutor
    from janusgraph_tpu_torch.parallel import Mesh, ShardedExecutor

    pc, rc, _ = two_label()
    ex = ShardedExecutor(pc, mesh=Mesh([torch.device("cpu")] * 8))
    got = ex.run(Alternating(seed_index=3, max_iterations=6))
    assert ex.last_run_info["path"] == "host-loop" and len(ex._channel_views) == 2
    want = RefShardedExecutor(rc, mesh=JaxMesh(np.array(jax.devices()[:8]), ("p",))).run(
        RefAlternating(seed_index=3, max_iterations=6))
    np.testing.assert_array_equal(got["dist"], np.asarray(want["dist"]))
    single = GPUExecutor(pc, device="cpu").run(Alternating(seed_index=3, max_iterations=6))
    np.testing.assert_array_equal(got["dist"], single["dist"])
    small = ShardedExecutor(pc, mesh=Mesh([torch.device("cpu")] * 8))
    small.CHANNEL_CACHE_SIZE = 1
    again = small.run(Alternating(seed_index=3, max_iterations=6))
    assert len(small._channel_views) == 1
    np.testing.assert_array_equal(again["dist"], got["dist"])
