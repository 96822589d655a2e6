"""The port's delta overlay held against the JAX package's on the CPU.

The same numpy-made snapshot and change batches go through
``janusgraph_tpu.olap.delta`` and ``janusgraph_tpu_torch.olap.delta``:
netting, materialization, the overlay view's lanes and degrees equal
array for array. Runs over base + overlay are held to the contract of the
reference's own tests (``tests/test_delta_csr.py``): the MIN family (CC,
SSSP) bit for bit to a run over the materialized CSR and to the
reference's ``TPUExecutor(delta=view)``; the SUM merge bit for bit to the
reference's numpy replay oracle; PageRank at the reference test's rtol
1e-5, atol 1e-7 (XLA's CPU backend contracts PageRank's multiply-add into
an FMA, so the reference's ranks differ from eager arithmetic in the last
bits, as ``tests/test_torch_fused.py`` explains)."""

import types

import numpy as np
import pytest
import torch

import janusgraph_tpu.olap as ref
from janusgraph_tpu.core.ids import IDManager
from janusgraph_tpu.olap import delta as RD
from janusgraph_tpu.olap import autotune as ref_autotune
from janusgraph_tpu.olap.cpu_executor import CPUExecutor
from janusgraph_tpu.olap.programs import (
    ConnectedComponentsProgram as RefCC,
    PageRankProgram as RefPR,
    ShortestPathProgram as RefSP,
)
from janusgraph_tpu.olap.tpu_executor import TPUExecutor
from janusgraph_tpu_torch.exceptions import SuperstepPreempted
from janusgraph_tpu_torch.olap import GPUExecutor, autotune, csr_from_edges, run_on
from janusgraph_tpu_torch.olap import delta as D
from janusgraph_tpu_torch.olap.programs import (
    ConnectedComponentsProgram,
    GCNForwardProgram,
    PageRankProgram,
    ShortestPathProgram,
)

N, M = 240, 2000


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _edges(seed=5):
    rng = np.random.default_rng(seed)
    dst = (rng.zipf(1.4, M) % N).astype(np.int64)
    src = rng.integers(0, N, M).astype(np.int64)
    return src, dst


def _batches(src, dst, seed=6, vertices=True):
    """Edge adds, tombstones of existing edges, an add that a later batch
    deletes again; with ``vertices``, new vertices with edges and one
    removed vertex, whose edges are deleted with it (as the store does)."""
    rng = np.random.default_rng(seed)
    k = 60
    gone = 7
    a = np.stack([rng.integers(0, N, k), rng.integers(0, N, k), np.zeros(k, np.int64)], 1)
    a = a[(a[:, 0] != gone) & (a[:, 1] != gone)]
    e = np.stack([src, dst, np.zeros(M, np.int64)], 1)
    touches = (src == gone) | (dst == gone)
    t = e[rng.choice(np.nonzero(~touches)[0], 25, replace=False)]
    b1 = {"add": tuple(a.T), "del": tuple(t.T), "v_add": {}, "v_del": []}
    b2 = {"add": (np.array([1, 2]), np.array([3, 4]), np.array([0, 0])),
          "del": (np.array([1]), np.array([3]), np.array([0])), "v_add": {}, "v_del": []}
    if vertices:
        b1["v_add"] = {N + 10: 2, N + 11: 3, N + 12: 4}
        b2["add"] = (np.array([1, 2, N + 10, N + 11]), np.array([3, 4, 0, N + 10]),
                     np.array([0, 0, 0, 0]))
        b2["v_add"] = {N + 12: 5}
        gone_edges = e[touches]
        b2["del"] = tuple(np.concatenate([[[1, 3, 0]], gone_edges]).T)
        b2["v_del"] = [gone]
    return [b1, b2]


_CACHE = {}


def world(vertices=True):
    """(reference csr, port csr, reference view, port view, reference
    materialized, port materialized) of one snapshot and overlay."""
    if vertices not in _CACHE:
        src, dst = _edges()
        rc, pc = ref.csr_from_edges(N, src, dst), csr_from_edges(N, src, dst)
        batches = _batches(src, dst, vertices=vertices)
        ro, po = RD.DeltaOverlay.from_batches(batches), D.DeltaOverlay.from_batches(batches)
        rv = RD.OverlayView(rc, ro, max_lane_cells=1 << 14)
        pv = D.OverlayView(pc, po, max_lane_cells=1 << 14)
        _CACHE[vertices] = (rc, pc, rv, pv, RD.materialize(rc, ro), D.materialize(pc, po))
    return _CACHE[vertices]


CSR_FIELDS = ("vertex_ids", "out_indptr", "out_dst", "in_indptr", "in_src", "out_degree",
              "labels", "in_edge_type", "out_edge_type")


def _assert_csr_equal(r, p):
    for f in CSR_FIELDS:
        a, b = getattr(r, f), getattr(p, f)
        if a is None or b is None:
            assert a is None and b is None, f
            continue
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)


# ----------------------------------------------------------------- records
@pytest.mark.parametrize("vertices", [True, False])
def test_from_batches_equals_reference(vertices):
    src, dst = _edges()
    batches = _batches(src, dst, vertices=vertices)
    r, p = RD.DeltaOverlay.from_batches(batches), D.DeltaOverlay.from_batches(batches)
    np.testing.assert_array_equal(r.add, p.add)
    np.testing.assert_array_equal(r.tomb, p.tomb)
    assert r.new_vertices == p.new_vertices and r.removed == p.removed and r.size == p.size
    # the (1, 3) add of the second batch cancels against its delete
    empty = D.DeltaOverlay.from_batches([])
    assert empty.size == 0 and empty.add.shape == (0, 3)


def _labelled_csrs(wide_types=False):
    """A snapshot with sparse graph ids, labels and edge types (with
    ``wide_types``, ids too wide to pack with the endpoints into one int64
    sort key), parallel edges, in both packages."""
    rng = np.random.default_rng(9)
    n, m = 120, 700
    vids = np.unique(rng.integers(1, 1 << 40, 3 * n))[:n] << 3
    src, dst = rng.integers(0, n, m), rng.integers(0, n, m)
    src[:40], dst[:40] = src[40:80], dst[40:80]
    et = rng.integers(0, 3, m) << (55 if wide_types else 0)
    rc = ref.csr_from_edges(n, src, dst, edge_types=et)
    pc = csr_from_edges(n, src, dst, edge_types=et)
    labels = rng.integers(0, 4, n).astype(np.int64)
    for c in (rc, pc):
        c.vertex_ids = vids
        c.labels = labels
    e = np.stack([vids[src], vids[dst], et], 1)
    add = np.stack([vids[rng.integers(0, n, 30)], vids[rng.integers(0, n, 30)],
                    rng.integers(0, 3, 30)], 1)
    new = (int(vids.max()) + 8, int(vids.max()) + 16)
    add = np.concatenate([add, [[new[0], vids[0], 1], [vids[1], new[1], 2]]])
    tomb = np.concatenate([e[rng.choice(m, 15, replace=False)], e[40:44], e[40:42]])
    batches = [{"add": tuple(add.T), "del": tuple(tomb.T), "v_add": {new[0]: 7, new[1]: 8},
                "v_del": [int(vids[5])]}]
    return rc, pc, batches


@pytest.mark.parametrize("wide_types", [False, True])
@pytest.mark.parametrize("idm", ["none", "partition_bits_3", "reference_idmanager"])
def test_materialize_equals_reference(idm, wide_types):
    rc, pc, batches = _labelled_csrs(wide_types)
    idm_obj = {"none": None, "partition_bits_3": types.SimpleNamespace(partition_bits=3),
               "reference_idmanager": IDManager()}[idm]
    want = RD.materialize(rc, RD.DeltaOverlay.from_batches(batches), idm=idm_obj)
    got = D.materialize(pc, D.DeltaOverlay.from_batches(batches), idm=idm_obj)
    _assert_csr_equal(want, got)
    if idm_obj is not None:
        np.testing.assert_array_equal(
            RD._key_rank(idm_obj, want.vertex_ids), D._key_rank(idm_obj, got.vertex_ids))


def test_materialize_refuses_weights():
    src, dst = _edges()
    weighted = csr_from_edges(N, src, dst, weights=np.ones(M, np.float32))
    with pytest.raises(ValueError, match="weights"):
        D.materialize(weighted, D.DeltaOverlay.from_batches(_batches(src, dst)))


@pytest.mark.parametrize("undirected", [False, True])
@pytest.mark.parametrize("vertices", [True, False])
def test_overlay_view_equals_reference(undirected, vertices):
    _rc, _pc, rv, pv, _rm, _pm = world(vertices)
    want, got = rv.lanes(undirected), pv.lanes(undirected)
    assert want["_meta"] == got["_meta"]
    for k in want:
        if k != "_meta":
            assert want[k].dtype == got[k].dtype, k
            np.testing.assert_array_equal(want[k], got[k], err_msg=k)
    assert rv.sig(undirected) == pv.sig(undirected)
    for a, b in zip(rv.fused_degrees(), pv.fused_degrees()):
        np.testing.assert_array_equal(a, b)
    for f in ("n_base", "n_extra", "n_real", "vcap", "n_pad", "num_edges_real",
              "num_vertices_real", "depth"):
        assert getattr(rv, f) == getattr(pv, f), f
    np.testing.assert_array_equal(rv.vertex_ids, pv.vertex_ids)


def test_lane_overflow_equals_reference():
    rc, pc, rv, pv, _rm, _pm = world()
    small_r = RD.OverlayView(rc, rv.overlay, max_lane_cells=64)
    small_p = D.OverlayView(pc, pv.overlay, max_lane_cells=64)
    for undirected in (False, True):
        assert small_r.lanes(undirected) is None and small_p.lanes(undirected) is None
        assert small_p.sig(undirected) is None and small_p.device_args("cpu", undirected) is None
    with pytest.raises(ValueError, match="max_lane_cells"):
        GPUExecutor(pc, device="cpu", delta=small_p).run(PageRankProgram(max_iterations=2))


# ------------------------------------------------------------ the SUM merge
def _oracle_inputs(rng):
    """The inputs of the reference's replay-oracle test."""
    npad, nb = 272, 256

    def lane(cap, hi):
        src = np.full(cap, npad, np.int32)
        dst = np.full(cap, npad, np.int32)
        k = int(rng.integers(1, cap))
        src[:k] = rng.integers(0, hi, k)
        dst[:k] = rng.integers(0, hi, k)
        return src, dst

    a_s, a_d = lane(32, npad)
    t_s, t_d = lane(16, nb)
    l_s, l_d = lane(64, nb)
    dirty = np.zeros(npad, np.float32)
    dirty[np.unique(t_d[t_d < npad])] = 1.0
    lanes = {"add_src": a_s, "add_dst": a_d, "tomb_src": t_s, "tomb_dst": t_d,
             "live_src": l_s, "live_dst": l_d, "dirty": dirty}
    return lanes, {"n_base": nb, "n_pad": npad}


@pytest.mark.parametrize("shape", ["scalar", "n_by_4"])
@pytest.mark.parametrize("op", ["sum", "min", "max"])
def test_fused_merge_equals_replay_oracle_bitwise(op, shape):
    rng = np.random.default_rng(0)
    lanes, meta = _oracle_inputs(rng)
    npad, nb = meta["n_pad"], meta["n_base"]
    rest = () if shape == "scalar" else (4,)
    msgs = rng.standard_normal((npad,) + rest).astype(np.float32)
    base = rng.standard_normal((nb,) + rest).astype(np.float32)
    want = RD.replay_fused_aggregate(lanes, meta, msgs, base, op)
    dev = D.device_lanes(lanes, npad, "cpu")
    got = D.fused_delta_aggregate(dev, torch.as_tensor(msgs), torch.as_tensor(base), op)
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))


def test_sum_lanes_sorted_stably_and_sentinels_dropped():
    lanes, meta = _oracle_inputs(np.random.default_rng(0))
    dev = D.device_lanes(lanes, meta["n_pad"], "cpu")
    for lane in ("add", "tomb"):
        dst = lanes[f"{lane}_dst"].astype(np.int64)
        keep = dst < meta["n_pad"]
        order = np.argsort(dst[keep], kind="stable")
        np.testing.assert_array_equal(dev[f"{lane}_dst"].numpy(), dst[keep][order])
        np.testing.assert_array_equal(dev[f"{lane}_src"].numpy(), lanes[f"{lane}_src"][keep][order])
        assert dev[f"{lane}_plan"].num_edges == int(keep.sum())


# ----------------------------------------------------- runs over the overlay
_REF_RUNS = {}


def _ref_run(name, vertices=True):
    key = (name, vertices)
    if key not in _REF_RUNS:
        rc, _pc, rv, _pv, rm, _pm = world(vertices)
        prog = {"cc": lambda: RefCC(), "sssp": lambda: RefSP(seed_index=0, max_iterations=6),
                "pagerank": lambda: RefPR(max_iterations=10)}[name]
        out = TPUExecutor(rc, strategy="ell", delta=rv).run(prog())
        _REF_RUNS[key] = {k: np.asarray(v) for k, v in out.items()}
    return _REF_RUNS[key]


def _program(name):
    return {"cc": lambda: ConnectedComponentsProgram(),
            "sssp": lambda: ShortestPathProgram(seed_index=0, max_iterations=6),
            "pagerank": lambda: PageRankProgram(max_iterations=10)}[name]()


_MAT_RUNS = {}


def _materialized_run(name, strategy):
    key = (name, strategy)
    if key not in _MAT_RUNS:
        pm = world(False)[5]
        _MAT_RUNS[key] = GPUExecutor(pm, strategy=strategy, device="cpu", frontier="off").run(
            _program(name))
    return _MAT_RUNS[key]


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("strategy", ["segsum", "ell", "hybrid"])
@pytest.mark.parametrize("name,key", [("cc", "component"), ("sssp", "distance")])
def test_min_family_bitwise_to_repack_and_reference(name, key, strategy, fused):
    _rc, pc, _rv, pv, _rm, _pm = world(False)
    ex = GPUExecutor(pc, strategy=strategy, device="cpu", delta=pv, hub_cutoff=4, tail_chunk=4)
    got = ex.run(_program(name), fused=fused)[key]
    info = ex.last_run_info
    assert info["path"] == ("fused" if fused else "host-loop")
    assert info["delta"]["overlay_depth"] == pv.depth
    np.testing.assert_array_equal(_bits(got), _bits(_materialized_run(name, strategy)[key]))
    np.testing.assert_array_equal(_bits(got), _bits(_ref_run(name, False)[key]))


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("strategy", ["segsum", "ell", "hybrid"])
def test_pagerank_close_to_repack_and_reference(strategy, fused):
    _rc, pc, _rv, pv, _rm, _pm = world(False)
    ex = GPUExecutor(pc, strategy=strategy, device="cpu", delta=pv, hub_cutoff=4, tail_chunk=4)
    got = ex.run(_program("pagerank"), fused=fused)["rank"]
    np.testing.assert_allclose(got, _materialized_run("pagerank", strategy)["rank"],
                               rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(got, _ref_run("pagerank", False)["rank"], rtol=1e-5, atol=1e-7)
    if strategy == "segsum":
        # the lanes ride the segment-sum wrapper: its plain version here
        host = ex.run(_program("pagerank"), fused=not fused)["rank"]
        np.testing.assert_array_equal(_bits(got), _bits(host))


def test_cc_over_a_view_with_new_vertices():
    """New vertices pad the domain to n_base + vcap: CC's state spans the
    padded domain (local_num_vertices), not the real vertex count."""
    _rc, pc, _rv, pv, _rm, pm = world(True)
    assert pv.vcap > 0 and pv.n_pad != pv.num_vertices_real
    got = GPUExecutor(pc, strategy="ell", device="cpu", delta=pv).run(
        ConnectedComponentsProgram())["component"]
    np.testing.assert_array_equal(_bits(got), _bits(_ref_run("cc", True)["component"]))
    comp, rview = D.compact_result(pv, {"component": got})
    want = GPUExecutor(pm, strategy="ell", device="cpu", frontier="off").run(
        ConnectedComponentsProgram())["component"]

    def by_id(labels, vids):
        """vertex id -> the smallest vertex id of its component (labels
        are indices, which the two index spaces do not share)."""
        lab = labels.astype(np.int64)
        low = {}
        for c, v in zip(lab, vids):
            low[c] = min(low.get(c, v), v)
        return {int(v): int(low[c]) for v, c in zip(vids, lab)}

    assert by_id(comp["component"], rview.vertex_ids) == by_id(want, pm.vertex_ids)


def test_vertex_add_remove_through_compact_result():
    _rc, pc, _rv, pv, _rm, pm = world(True)
    ex = GPUExecutor(pc, strategy="segsum", device="cpu", delta=pv)
    out = ex.run(PageRankProgram(max_iterations=8))
    assert out["rank"].shape == (pv.n_real,)
    assert ex.last_run_info["delta"]["n_extra"] == pv.n_extra == 3
    assert ex.last_run_info["delta"]["removed"] == 1
    comp, rview = D.compact_result(pv, out)
    want = run_on(pm, PageRankProgram(max_iterations=8), device="cpu")["rank"]
    assert set(rview.vertex_ids.tolist()) == set(pm.vertex_ids.tolist())
    for vid in rview.vertex_ids:
        np.testing.assert_allclose(comp["rank"][rview.index_of(int(vid))],
                                   want[pm.index_of(int(vid))], rtol=1e-5, atol=1e-7)
    # the reference's numpy executor over the same view (its XLA run sits
    # 3e-6 from both here: the FMA contraction, compounded over 8 steps)
    rc, _pc, rv, _pv, _rm, _pm = world(True)
    ref_out = CPUExecutor(rc, strategy="ell", delta=rv).run(RefPR(max_iterations=8))
    ref_comp, _ = RD.compact_result(rv, ref_out)
    np.testing.assert_allclose(comp["rank"], ref_comp["rank"], rtol=1e-5, atol=1e-7)


def test_set_delta_swap_reuses_packs_and_equals_fresh():
    _rc, pc, _rv, pv, _rm, _pm = world(False)
    pv2 = D.OverlayView(pc, world(True)[3].overlay, max_lane_cells=1 << 14)
    ex = GPUExecutor(pc, strategy="ell", device="cpu")
    base = ex.run(PageRankProgram(max_iterations=6))["rank"]
    pack, base_g = ex._ell_pack(False), ex._base_g
    for view in (pv, pv2):
        ex.set_delta(view)
        got = ex.run(PageRankProgram(max_iterations=6))["rank"]
        fresh = GPUExecutor(pc, strategy="ell", device="cpu", delta=view).run(
            PageRankProgram(max_iterations=6))["rank"]
        np.testing.assert_array_equal(_bits(got), _bits(fresh))
        assert ex._ell_pack(False) is pack and ex.g._base is base_g
        sigs = {k[-1] for k in ex._fused_loops}
        assert sigs == {None, view.sig(False)}
    ex.set_delta(None)
    assert ex.g is base_g and {k[-1] for k in ex._fused_loops} == {None}
    np.testing.assert_array_equal(_bits(ex.run(PageRankProgram(max_iterations=6))["rank"]),
                                  _bits(base))


def test_delta_refusals():
    _rc, pc, _rv, pv, _rm, _pm = world(False)
    src, dst = _edges()
    weighted = csr_from_edges(N, src, dst, weights=np.ones(M, np.float32))
    with pytest.raises(ValueError, match="weightless"):
        GPUExecutor(weighted, device="cpu", delta=D.OverlayView(weighted, pv.overlay))
    other = csr_from_edges(N, src, dst)
    with pytest.raises(ValueError, match="different base snapshot"):
        GPUExecutor(other, device="cpu").set_delta(pv)
    with pytest.raises(ValueError, match="default-edge-view"):
        GPUExecutor(pc, device="cpu", delta=pv).run(
            GCNForwardProgram(feature_dim=8, attention=True))

    class Channelled(PageRankProgram):
        def channel_for(self, superstep):
            return None

    assert D.program_delta_compatible(PageRankProgram())
    assert not D.program_delta_compatible(Channelled())
    # an empty overlay is no overlay
    ex = GPUExecutor(pc, device="cpu", delta=D.OverlayView(pc, D.DeltaOverlay.from_batches([])))
    assert ex._delta is None


@pytest.mark.parametrize("fused", [True, False])
def test_preempted_delta_pagerank_resumes_bitwise(fused, tmp_path):
    _rc, pc, _rv, pv, _rm, _pm = world(True)

    def prog():
        return PageRankProgram(max_iterations=12, tol=0.0)

    want = GPUExecutor(pc, device="cpu", delta=pv).run(prog(), fused=fused)["rank"]
    fired = []

    def hook(step):
        if step >= 7 and not fired:
            fired.append(step)
            raise SuperstepPreempted("injected")

    ex = GPUExecutor(pc, device="cpu", delta=pv)
    got = ex.run(prog(), fused=fused, checkpoint_path=str(tmp_path / "ck.npz"),
                 checkpoint_every=3, fault_hook=hook)["rank"]
    assert fired and ex.last_run_info["resumes"] == 1
    assert ex.last_run_info["delta"]["n_extra"] == pv.n_extra
    np.testing.assert_array_equal(_bits(got), _bits(want))


# --------------------------------------------------------------- snapshots
def test_snapshot_files_cross_load(tmp_path):
    _rc, pc, _batches_ = _labelled_csrs()
    path = str(tmp_path / "snap.npz")
    D.save_snapshot(path, pc, 42)
    loaded, epoch = RD.load_snapshot(path)
    assert epoch == 42
    _assert_csr_equal(loaded, pc)
    RD.save_snapshot(path, loaded, 43)
    back, epoch = D.load_snapshot(path)
    assert epoch == 43
    _assert_csr_equal(loaded, back)
    assert D.load_snapshot(str(tmp_path / "missing.npz")) is None
    with open(path, "wb") as f:
        f.write(b"torn")
    assert D.load_snapshot(path) is None


# ---------------------------------------------------------------- decisions
@pytest.mark.parametrize("kind", ["cpu", "TPU v5 lite", "TPU v6e"])
def test_decide_delta_equals_reference(kind):
    for edges in (1 << 10, 1 << 20, 1 << 24, 1 << 28):
        want = ref_autotune.decide_delta(edges, edges // 16, device_kind=kind)
        got = autotune.decide_delta(edges, edges // 16, device_kind=kind)
        assert got.as_dict() == want.as_dict()
    assert autotune.decide_delta(10, 1, overrides={"compact_threshold": 5}).source == "config"


def test_decide_delta_gpu_class():
    got = autotune.decide_delta(1 << 24, 1 << 20, device_kind="NVIDIA H100 80GB HBM3")
    assert got == autotune.decide_delta(1 << 24, 1 << 20, device_kind="NVIDIA H100 80GB HBM3")
    assert got.cells["lane_cost_per_record_per_step_s"] == autotune._DELTA_LANE_COST_S["gpu"]
    t = got.compact_threshold
    assert 1024 <= t <= 1 << 16 and t & (t - 1) == 0


def test_device_graph_has_the_reference_view_fields():
    rc, pc, rv, pv, _rm, _pm = world(True)
    g = GPUExecutor(pc, device="cpu").g
    assert (g.local_num_vertices, g.global_offset, g.num_vertices) == (rc.local_num_vertices, 0, N)
    np.testing.assert_array_equal(g.in_degree.numpy(), rc.in_degree.astype(np.float32))
    dg = GPUExecutor(pc, device="cpu", delta=pv).g
    fused = RD.FusedHostView(rv)
    assert (dg.num_vertices, dg.local_num_vertices, dg.num_edges) == (
        fused.num_vertices, fused.local_num_vertices, fused.num_edges)
    for f in ("in_degree", "out_degree", "active"):
        np.testing.assert_array_equal(getattr(dg, f).numpy(), np.asarray(getattr(fused, f), np.float32))
    assert dg.in_src is g.in_src or np.array_equal(dg.in_src.numpy(), g.in_src.numpy())


@pytest.mark.parametrize("num_shards", [1, 3, 8])
def test_route_overlay_and_route_for_host_equal_reference(num_shards):
    """The overlay's records partitioned by the shard owning their
    destination rows, and a host's span of them, equal the reference's."""
    rc, pc, rv, pv, _rm, _pm = world()
    want, got = RD.route_overlay(rv, num_shards), D.route_overlay(pv, num_shards)
    assert len(got) == len(want) == num_shards
    for a, b in zip(got, want):
        assert a["shard"] == b["shard"] and a["row_range"] == b["row_range"]
        for k in ("add_src", "add_dst", "tomb_src", "tomb_dst"):
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert sum(len(r["add_dst"]) for r in got) == len(pv.add_dst)
    for pid, nproc in ((0, 1), (1, 2), (2, 3)):
        a = D.route_for_host(pv, num_shards, pid, nproc)
        b = RD.route_for_host(rv, num_shards, pid, nproc)
        assert a["shards"] == b["shards"]
        for k in ("add_src", "add_dst", "tomb_src", "tomb_dst"):
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("op", ["sum", "min", "max"])
def test_replay_fused_aggregate_equals_reference(op):
    """The fused merge's numpy replay equals the reference's bit for bit;
    the port's torch merge meets it (SUM to 1e-6: its lanes sum through the
    sorted segment sum)."""
    rng = np.random.default_rng(2)
    lanes, meta = _oracle_inputs(rng)
    outgoing = rng.standard_normal(meta["n_pad"]).astype(np.float32)
    base = rng.standard_normal(meta["n_base"]).astype(np.float32)
    got = D.replay_fused_aggregate(lanes, meta, outgoing, base, op)
    np.testing.assert_array_equal(got, RD.replay_fused_aggregate(lanes, meta, outgoing, base, op))
    dev = D.fused_delta_aggregate(
        D.device_lanes(lanes, meta["n_pad"], "cpu"), torch.as_tensor(outgoing),
        torch.as_tensor(base), op,
    ).numpy()
    if op == "sum":
        np.testing.assert_allclose(dev, got, rtol=1e-6, atol=1e-6)
    else:
        np.testing.assert_array_equal(dev, got)


def test_sharded_run_over_a_materialized_overlay():
    """The sharded executor consumes a materialized overlay: equal to the
    single-device run over the same repack; an unmaterialized view is
    refused."""
    from janusgraph_tpu_torch.parallel import Mesh, ShardedExecutor

    _rc, pc, _rv, pv, _rm, pm = world()
    mesh = Mesh([torch.device("cpu")] * 8)
    got = ShardedExecutor(pm, mesh=mesh).run(ConnectedComponentsProgram())
    want = run_on(pm, ConnectedComponentsProgram(), device="cpu", frontier="off")
    np.testing.assert_array_equal(got["component"], want["component"])
    with pytest.raises(ValueError, match="MATERIALIZED"):
        run_on(pc, PageRankProgram(max_iterations=2), executor="sharded", mesh=mesh, delta=pv)
