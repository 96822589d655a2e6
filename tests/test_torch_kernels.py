"""The port's aggregation kernels held against the JAX package's.

ELL aggregation is bitwise equal to the reference's numpy replay; the
sorted-segment-sum plan is array-equal to the reference plan, and its plain
PyTorch path (what a CPU tensor runs) matches the Pallas kernel in
interpret mode at the reference's own tolerance (rtol=atol=1e-4,
tests/test_kernels.py). The CUDA kernel itself runs only on the card and is
held to its plain version by chip_smoke.py; tests/test_torch_segsum_plan.py
replays its work split in numpy."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from janusgraph_tpu.olap import kernels as ref
from janusgraph_tpu_torch import _build
from janusgraph_tpu_torch.olap import kernels as port

OPS = ["sum", "min", "max"]
#: (edge transform, weighted pack)
TRANSFORMS = [("none", False), ("none", True), ("mul", True), ("add", True)]


def _bits(a):
    a = np.ascontiguousarray(a, dtype=np.float32)
    return a.view(np.int32)


def _edges(seed=3, n=97, m=450):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, m)
    dst = rng.integers(0, n, m)
    w = rng.uniform(0.1, 2.0, m).astype(np.float32)
    return rng, n, src, dst, w


def _both_ell(src, dst, w, n, msgs, op, transform, **kw):
    want = ref.ell_aggregate(np, ref.ELLPack(src, dst, w, n, **kw), msgs, op, transform)
    pack = port.ELLPack(src, dst, w, n, **kw).to("cpu")
    got = port.ell_aggregate(pack, torch.from_numpy(msgs), op, transform).numpy()
    return got, np.asarray(want)


@pytest.mark.parametrize("cols", [(), (5,)], ids=["n", "nk"])
@pytest.mark.parametrize("transform,weighted", TRANSFORMS,
                         ids=[f"{t}-{'w' if w else 'unw'}" for t, w in TRANSFORMS])
@pytest.mark.parametrize("op", OPS)
def test_ell_aggregate_bitwise_vs_reference(op, transform, weighted, cols):
    rng, n, src, dst, w = _edges()
    msgs = rng.uniform(-1, 1, (n,) + cols).astype(np.float32)
    got, want = _both_ell(src, dst, w if weighted else None, n, msgs, op, transform)
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("op", OPS)
def test_ell_supernode_row_split_bitwise(op):
    """A hub above max_capacity row-splits; its row partials fold through
    segment_combine exactly as the reference's np.<ufunc>.at does."""
    n, hub_deg = 40, 70
    src = np.concatenate([np.arange(hub_deg) % (n - 1) + 1, [0, 0]])
    dst = np.concatenate([np.zeros(hub_deg, dtype=np.int64), [1, 2]])
    rng = np.random.default_rng(5)
    w = rng.uniform(0.5, 2.0, len(src)).astype(np.float32)
    msgs = rng.uniform(-1, 1, n).astype(np.float32)
    got, want = _both_ell(src, dst, w, n, msgs, op, "mul", max_capacity=16)
    np.testing.assert_array_equal(_bits(got), _bits(want))
    ones = np.ones(n, dtype=np.float32)
    got, _ = _both_ell(src, dst, None, n, ones, "sum", "none", max_capacity=16)
    assert got[0] == hub_deg and got[1] == 1 and got[2] == 1


def test_ell_pack_arrays_equal_reference():
    _rng, n, src, dst, w = _edges(seed=8)
    a = ref.ELLPack(src, dst, w, n, max_capacity=8)
    b = port.ELLPack(src, dst, w, n, max_capacity=8)
    assert len(a.buckets) == len(b.buckets)
    for ba, bb in zip(a.buckets, b.buckets):
        for x, y in zip(ba[:4], bb[:4]):
            assert (x is None) == (y is None)
            if x is not None:
                np.testing.assert_array_equal(x, y)
        assert ba[4] == bb[4]
    np.testing.assert_array_equal(a.unpermute, b.unpermute)


def test_tree_reduce_and_fence():
    rng = np.random.default_rng(1)
    m = rng.uniform(-1, 1, (7, 16)).astype(np.float32)
    for op in OPS:
        np.testing.assert_array_equal(
            _bits(port.tree_reduce(torch.from_numpy(m), op).numpy()),
            _bits(ref.tree_reduce(np, m, op)),
        )
    with pytest.raises(ValueError):
        port.tree_reduce(torch.zeros(2, 3), "sum")
    z = port.fp_fence(torch.tensor([-0.0, 1.5]))
    np.testing.assert_array_equal(_bits(z.numpy()), _bits(ref.fp_fence(np, np.array([-0.0, 1.5], np.float32))))


PLAN_CASES = {
    "multi_tile": (np.sort(np.random.default_rng(9).integers(0, 2500, 9000)), 2500, {}),
    "empty_tiles": (np.array([0, 0, 5, 1030]), 4000, {}),
    "small_blocks": (np.sort(np.random.default_rng(2).integers(0, 300, 1000)), 300, dict(block=8, tile=32)),
    "no_edges": (np.zeros(0, dtype=np.int64), 70, dict(block=8, tile=32)),
}


@pytest.mark.parametrize("case", sorted(PLAN_CASES))
def test_segsum_plan_arrays_equal_reference(case):
    seg, ns, kw = PLAN_CASES[case]
    a = ref.make_segsum_plan(seg, ns, **kw)
    b = port.make_segsum_plan(seg, ns, **kw)
    for name in ("gather_idx", "pad_mask", "seg_local", "out_tile", "is_first"):
        x, y = getattr(a, name), getattr(b, name)
        assert x.dtype == y.dtype, name
        np.testing.assert_array_equal(x, y, err_msg=name)
    assert (a.num_blocks, a.padded_segments) == (b.num_blocks, b.padded_segments)
    # what the kernel reads instead: the segment offsets of the same edges
    assert b.seg_ptr.dtype == np.int32 and b.seg_ptr[0] == 0 and b.seg_ptr[-1] == len(seg)
    np.testing.assert_array_equal(np.repeat(np.arange(ns), np.diff(b.seg_ptr)), seg)


@pytest.mark.parametrize("case", ["multi_tile", "empty_tiles", "small_blocks"])
def test_sorted_segment_sum_cpu_matches_pallas_and_bincount(case):
    seg, ns, kw = PLAN_CASES[case]
    data = np.random.default_rng(4).uniform(-1, 1, len(seg)).astype(np.float32)
    port.reset_launch_counts()
    got = port.sorted_segment_sum(torch.from_numpy(data), port.make_segsum_plan(seg, ns, **kw))
    assert got.shape == (ns,) and got.dtype == torch.float32
    assert port.launch_counts() == {"sorted_segment_sum": 0}
    pallas = np.asarray(ref.pallas_sorted_segment_sum(
        jnp.asarray(data), ref.make_segsum_plan(seg, ns, **kw), interpret=True
    ))
    want = np.bincount(seg, weights=data.astype(np.float64), minlength=ns)
    np.testing.assert_allclose(got.numpy(), pallas, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


def test_sorted_segment_sum_empty_segments_read_zero():
    seg = np.array([0, 0, 5, 1030])
    data = torch.tensor([1.0, 2.0, 3.0, 4.0])
    got = port.sorted_segment_sum(data, port.make_segsum_plan(seg, 4000)).numpy()
    assert got[0] == 3.0 and got[5] == 3.0 and got[1030] == 4.0
    assert got.sum() == 10.0


def test_sorted_segment_sum_rejects_bad_input():
    plan = port.make_segsum_plan(np.array([0, 1, 1]), 4)
    with pytest.raises(ValueError):
        port.sorted_segment_sum(torch.zeros(3, dtype=torch.float64), plan)
    with pytest.raises(ValueError):
        port.sorted_segment_sum(torch.zeros(4), plan)
    with pytest.raises(ValueError):
        port.make_segsum_plan(np.array([3, 1]), 4)


def test_kernel_build_raises_without_nvcc(monkeypatch):
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build.os.path, "exists", lambda path: False)
    with pytest.raises(RuntimeError, match="nvcc"):
        _build._nvcc()
