"""The port's dense-feature tier held against the JAX package's on the CPU.

Kernels (``olap/features/kernels.py``) take the same numpy inputs as the
reference's numpy path and must give its bits. GCN and the embedding
update run through the port's ELL and hybrid strategies, fused and on the
host loop, against the reference's ``TPUExecutor(strategy="ell")`` on
JAX's CPU backend: bit for bit in every message mode, as the reference's
own matrix holds its executors (``tests/test_dense_features.py``)."""

import numpy as np
import pytest
import torch

import janusgraph_tpu.olap as ref
from janusgraph_tpu.olap import delta as RD
from janusgraph_tpu.olap.features import kernels as RK
from janusgraph_tpu.olap.kernels import ELLPack as RefELL, HybridPack as RefHybrid
from janusgraph_tpu.olap.programs.embedding import EmbeddingUpdateProgram as RefEmb
from janusgraph_tpu.olap.programs.gcn import GCNForwardProgram as RefGCN
from janusgraph_tpu.olap.tpu_executor import TPUExecutor
from janusgraph_tpu_torch.olap import GPUExecutor, autotune, csr_from_edges, kernels, run_on
from janusgraph_tpu_torch.olap import delta as D
from janusgraph_tpu_torch.olap.features import kernels as fk
from janusgraph_tpu_torch.olap.features import (
    FEATURE_TIERS,
    MessageMode,
    dense_transform,
    ell_row_dsts,
    hybrid_row_dsts,
    matmul_flops,
    pad_features,
    pick_feature_tier,
    sddmm_ell_aggregate,
    sddmm_flops,
    sddmm_hybrid_aggregate,
    sddmm_segment_aggregate,
    tree_dot,
    tree_matmul,
)
from janusgraph_tpu_torch.olap.programs import EmbeddingUpdateProgram, GCNForwardProgram


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _skewed(n=300, m=4000, seed=3, weights=False):
    """Heavy-tailed destinations so the hybrid pack has a real tail, in
    both packages."""
    rng = np.random.default_rng(seed)
    dst = (rng.zipf(1.35, m) % n).astype(np.int64)
    src = rng.integers(0, n, m).astype(np.int64)
    w = rng.uniform(0.25, 2.0, m).astype(np.float32) if weights else None
    return ref.csr_from_edges(n, src, dst, w), csr_from_edges(n, src, dst, w), (src, dst, w)


# ------------------------------------------------------------ tiers, padding
@pytest.mark.parametrize("d,forced", [(1, 0), (8, 0), (9, 0), (32, 0), (33, 0), (512, 0),
                                      (700, 0), (12, 64), (16, 16)])
def test_feature_tier_ladder_equals_reference(d, forced):
    assert FEATURE_TIERS == RK.FEATURE_TIERS
    assert pick_feature_tier(d, forced) == RK.pick_feature_tier(d, forced)
    assert autotune.pick_feature_tier is pick_feature_tier


@pytest.mark.parametrize("d,forced", [(0, 0), (12, 8), (12, 24)])
def test_feature_tier_refusals(d, forced):
    with pytest.raises(ValueError):
        pick_feature_tier(d, forced)


def test_pad_features_equals_reference():
    h = np.random.default_rng(0).standard_normal((5, 6))
    np.testing.assert_array_equal(pad_features(h, 8), RK.pad_features(h, 8))
    assert pad_features(h.astype(np.float32), 6).dtype == np.float32
    for bad in ((h, 4), (h[0], 8)):
        with pytest.raises(ValueError):
            pad_features(*bad)


# ------------------------------------------------------------------ kernels
def test_tree_dot_equals_reference():
    rng = np.random.default_rng(1)
    for shape in ((7, 8), (3, 5, 32), (4, 1)):
        a = rng.standard_normal(shape).astype(np.float32)
        b = rng.standard_normal(shape).astype(np.float32)
        want = RK.tree_dot(np, a, b)
        got = tree_dot(torch.as_tensor(a), torch.as_tensor(b)).numpy()
        np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("n,k,j,block_bytes", [
    (40, 16, 8, 1 << 28),      # one block
    (1000, 32, 16, 1 << 14),   # many port blocks, one reference block
    (4096, 32, 32, 1 << 28),   # one port block, two reference blocks
    (77, 8, 8, 1 << 10),       # a ragged last block
])
def test_tree_matmul_equals_reference(n, k, j, block_bytes, monkeypatch):
    rng = np.random.default_rng(2)
    h = rng.standard_normal((n, k)).astype(np.float32)
    w = rng.standard_normal((k, j)).astype(np.float32)
    want = RK.tree_matmul(np, h, w)
    monkeypatch.setattr(fk, "MM_BLOCK_BYTES", block_bytes)
    got = tree_matmul(torch.as_tensor(h), torch.as_tensor(w)).numpy()
    np.testing.assert_array_equal(_bits(got), _bits(want))
    native = tree_matmul(torch.as_tensor(h), torch.as_tensor(w), native=True).numpy()
    # another summation order: close, not bitwise
    np.testing.assert_allclose(native, want, rtol=1e-4, atol=1e-4)
    with pytest.raises(ValueError, match="pow2"):
        tree_matmul(torch.as_tensor(h[:, :3]), torch.as_tensor(w[:3]))


@pytest.mark.parametrize("activation", ["identity", "relu", "tanh"])
def test_dense_transform_equals_reference(activation):
    rng = np.random.default_rng(4)
    h = rng.standard_normal((50, 16)).astype(np.float32)
    w = rng.standard_normal((16, 16)).astype(np.float32)
    b = rng.standard_normal(16).astype(np.float32)
    want = RK.dense_transform(np, h, w, b, activation)
    got = dense_transform(torch.as_tensor(h), torch.as_tensor(w), torch.as_tensor(b),
                          activation).numpy()
    if activation == "tanh":
        # the backend's libm: outside the bitwise contract
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    else:
        np.testing.assert_array_equal(_bits(got), _bits(want))
    with pytest.raises(ValueError, match="activation"):
        dense_transform(torch.as_tensor(h), torch.as_tensor(w), activation="gelu")


def test_row_dsts_equal_reference():
    _r, _p, (src, dst, _w) = _skewed()
    for a, b in zip(ell_row_dsts(src, dst, 300), RK.ell_row_dsts(src, dst, 300)):
        np.testing.assert_array_equal(a, b)
    got = hybrid_row_dsts(src, dst, 300, hub_cutoff=16, tail_chunk=16)
    want = RK.hybrid_row_dsts(src, dst, 300, hub_cutoff=16, tail_chunk=16)
    for part in ("torso", "tail"):
        assert len(got[part]) == len(want[part])
        for a, b in zip(got[part], want[part]):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("layout", ["ell", "hybrid", "segment"])
def test_sddmm_aggregates_equal_reference(layout):
    _r, pc, (src, dst, _w) = _skewed()
    n = 300
    rng = np.random.default_rng(5)
    msgs = (rng.standard_normal((n, 16)) * 0.5).astype(np.float32)
    # small max_capacity splits the hubs' rows, so the row folds run too
    if layout == "ell":
        want = RK.sddmm_ell_aggregate(
            np, RefELL(src, dst, None, n, max_capacity=64),
            RK.ell_row_dsts(src, dst, n, max_capacity=64), msgs)
        pack = kernels.ELLPack(src, dst, None, n, max_capacity=64).to("cpu")
        rows = [torch.as_tensor(r) for r in ell_row_dsts(src, dst, n, max_capacity=64)]
        got = sddmm_ell_aggregate(pack, rows, torch.as_tensor(msgs))
    elif layout == "hybrid":
        kw = dict(hub_cutoff=16, tail_chunk=16, max_capacity=64)
        want = RK.sddmm_hybrid_aggregate(
            np, RefHybrid(src, dst, None, n, **kw), RK.hybrid_row_dsts(src, dst, n, **kw), msgs)
        pack = kernels.HybridPack(src, dst, None, n, **kw).to("cpu")
        rows = {k: [torch.as_tensor(r) for r in v]
                for k, v in hybrid_row_dsts(src, dst, n, **kw).items()}
        got = sddmm_hybrid_aggregate(pack, rows, torch.as_tensor(msgs))
    else:
        seg = np.repeat(np.arange(n), np.diff(pc.in_indptr))
        want = RK.sddmm_segment_aggregate(np, msgs, pc.in_src.astype(np.int64), seg, n)
        got = sddmm_segment_aggregate(torch.as_tensor(msgs), torch.as_tensor(pc.in_src).long(),
                                      torch.as_tensor(seg), n)
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))


def test_sddmm_refusals_and_flops():
    pack = kernels.ELLPack(np.array([0]), np.array([1]), None, 2).to("cpu")
    rows = [torch.as_tensor(r) for r in ell_row_dsts(np.array([0]), np.array([1]), 2)]
    with pytest.raises(ValueError, match="SUM-only"):
        sddmm_ell_aggregate(pack, rows, torch.zeros(2, 8), "min")
    with pytest.raises(ValueError, match="pow2"):
        sddmm_ell_aggregate(pack, rows, torch.zeros(2, 6))
    with pytest.raises(ValueError, match="drift"):
        sddmm_ell_aggregate(pack, rows + rows, torch.zeros(2, 8))
    assert sddmm_flops(10, 32) == RK.sddmm_flops(10, 32) == 960.0
    assert matmul_flops(4, 8, 16) == RK.matmul_flops(4, 8, 16)


# ------------------------------------------------------------- the programs
GCN_MODES = {
    "gcn_copy": ({}, False),
    "gcn_weighted": ({"weighted": True}, True),
    "gcn_attention": ({"attention": True}, False),
}
EMB_MODES = {
    "emb_copy": ({"mode": MessageMode.COPY}, False),
    "emb_weighted": ({"mode": MessageMode.WEIGHTED}, True),
    "emb_sddmm": ({"mode": MessageMode.SDDMM}, False),
}


def _programs(name):
    """(port program, reference program, state key, weighted graph)."""
    if name in GCN_MODES:
        kw, weighted = GCN_MODES[name]
        dims = dict(feature_dim=12, hidden_dim=12, out_dim=8, num_layers=2, seed=5)
        return GCNForwardProgram(**dims, **kw), RefGCN(**dims, **kw), "h", weighted
    kw, weighted = EMB_MODES[name]
    dims = dict(feature_dim=16, max_iterations=3, seed=9)
    return EmbeddingUpdateProgram(**dims, **kw), RefEmb(**dims, **kw), "emb", weighted


_GRAPHS = {}
_REF = {}


def _graph(weighted):
    if weighted not in _GRAPHS:
        _GRAPHS[weighted] = _skewed(weights=weighted)
    return _GRAPHS[weighted]


def _reference(name):
    if name not in _REF:
        _p, rprog, key, weighted = _programs(name)
        _REF[name] = np.asarray(TPUExecutor(_graph(weighted)[0], strategy="ell").run(rprog)[key])
    return _REF[name]


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("strategy", ["ell", "hybrid"])
@pytest.mark.parametrize("name", list(GCN_MODES) + list(EMB_MODES))
def test_dense_programs_bitwise_to_reference(name, strategy, fused):
    prog, _rprog, key, weighted = _programs(name)
    ex = GPUExecutor(_graph(weighted)[1], strategy=strategy, device="cpu",
                     hub_cutoff=16, tail_chunk=16)
    got = ex.run(prog, fused=fused)[key]
    info = ex.last_run_info
    assert info["path"] == ("fused" if fused else "host-loop")
    assert info["strategy_resolved"] == strategy
    assert info["autotune"]["feature_tier"] == prog.d_pad
    assert got.dtype == np.float32 and got.shape == (300, prog.d_pad)
    np.testing.assert_array_equal(_bits(got), _bits(_reference(name)))


@pytest.mark.parametrize("name", ["gcn_copy", "gcn_attention"])
def test_dense_programs_under_segsum_take_the_segment_fold(name):
    """segsum sums scalars only: [n, d] messages take ELL, never the
    segment fold (float atomics on the card, no fixed order), so the result
    is the reference's ELL run, bit for bit. The name is the one this check
    had when segsum still sent rows to the segment fold."""
    prog, _rprog, key, weighted = _programs(name)
    ex = GPUExecutor(_graph(weighted)[1], strategy="segsum", device="cpu")
    got = ex.run(prog)[key]
    assert ex.last_run_info["strategy_resolved"] == "ell"
    np.testing.assert_array_equal(_bits(got), _bits(_reference(name)))


def test_native_matmul_flows_from_run_on():
    kw, weighted = GCN_MODES["gcn_copy"]
    prog = GCNForwardProgram(feature_dim=12, hidden_dim=12, out_dim=8, num_layers=2, seed=5,
                             native_matmul=True, **kw)
    got = run_on(_graph(weighted)[1], prog, strategy="ell", device="cpu")["h"]
    assert prog.native_matmul
    # torch.matmul sums in its own order: close to the tree, not bitwise
    np.testing.assert_allclose(got, _reference("gcn_copy"), rtol=1e-4, atol=1e-5)


def test_features_dim_tier_flows_through():
    _r, pc, _e = _graph(False)
    ex = GPUExecutor(pc, strategy="ell", device="cpu")
    prog = GCNForwardProgram(feature_dim=12, hidden_dim=12, out_dim=8, dim_tier=64)
    h = ex.run(prog)["h"]
    assert prog.d_pad == 64 and h.shape == (300, 64)
    assert not np.any(h[:, 8:])
    assert (False, 64) in ex._autotune_decisions
    assert ex.last_run_info["autotune"]["feature_tier"] == 64
    rprog = RefGCN(feature_dim=12, hidden_dim=12, out_dim=8)
    want = TPUExecutor(_r, strategy="ell", features_dim_tier=64).run(rprog)["h"]
    np.testing.assert_array_equal(_bits(h), _bits(np.asarray(want)))
    # a scalar program on the same executor keys its own decision
    from janusgraph_tpu_torch.olap.programs import PageRankProgram

    ex.run(PageRankProgram(max_iterations=2))
    assert (False, 0) in ex._autotune_decisions


def test_undirected_sddmm_and_channelled_sddmm_raise():
    _r, pc, _e = _graph(False)
    prog = GCNForwardProgram(feature_dim=8, attention=True)
    prog.undirected = True
    with pytest.raises(ValueError, match="undirected"):
        GPUExecutor(pc, strategy="ell", device="cpu").run(prog)

    class Channelled(GCNForwardProgram):
        def channel_for(self, superstep):
            return None

    with pytest.raises(ValueError, match="channels"):
        GPUExecutor(pc, strategy="ell", device="cpu").run(Channelled(feature_dim=8, attention=True))


def test_two_gcns_with_other_weights_do_not_share_a_fused_loop():
    """cache_key keeps the scalar parameters, which two GCNs with other
    explicit weights share; the weights' digest keeps their fused loops
    apart, so one GCN's weights are never replayed for the other."""
    _r, pc, _e = _graph(False)
    rng = np.random.default_rng(0)
    dims = dict(feature_dim=8, hidden_dim=8, out_dim=8)
    wa = [rng.standard_normal((8, 8)).astype(np.float32) for _ in range(2)]
    wb = [rng.standard_normal((8, 8)).astype(np.float32) for _ in range(2)]
    a, b = GCNForwardProgram(**dims, weights=wa), GCNForwardProgram(**dims, weights=wb)
    assert a.cache_key() != b.cache_key()
    assert a.cache_key() == GCNForwardProgram(**dims, weights=wa).cache_key()
    ex = GPUExecutor(pc, strategy="ell", device="cpu")
    ha, hb = ex.run(a)["h"], ex.run(b)["h"]
    assert len(ex._fused_loops) == 2
    fresh = GPUExecutor(pc, strategy="ell", device="cpu").run(
        GCNForwardProgram(**dims, weights=wb))["h"]
    np.testing.assert_array_equal(_bits(hb), _bits(fresh))
    assert not np.array_equal(ha, hb)


def test_copy_gcn_over_a_delta_view_equals_reference():
    rc, pc, (src, dst, _w) = _skewed(seed=8)
    rng = np.random.default_rng(6)
    add = np.stack([rng.integers(0, 300, 50), rng.integers(0, 300, 50), np.zeros(50, np.int64)], 1)
    pick = rng.choice(len(src), 30, replace=False)
    tomb = np.stack([src[pick], dst[pick], np.zeros(30, np.int64)], 1)
    batches = [{"add": tuple(add.T), "del": tuple(tomb.T), "v_add": {400: 1}, "v_del": []}]
    rv = RD.OverlayView(rc, RD.DeltaOverlay.from_batches(batches), max_lane_cells=1 << 14)
    pv = D.OverlayView(pc, D.DeltaOverlay.from_batches(batches), max_lane_cells=1 << 14)
    dims = dict(feature_dim=8, hidden_dim=8, out_dim=8)
    want = np.asarray(TPUExecutor(rc, strategy="ell", delta=rv).run(RefGCN(**dims))["h"])
    for strategy in ("ell", "hybrid", "segment"):
        got = GPUExecutor(pc, strategy=strategy, device="cpu", delta=pv, hub_cutoff=16,
                          tail_chunk=16).run(GCNForwardProgram(**dims))["h"]
        assert got.shape == (pv.n_real, 8)
        if strategy == "segment":
            # the base rows sum in edge order there: close, not bitwise
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
        else:
            np.testing.assert_array_equal(_bits(got), _bits(want))
