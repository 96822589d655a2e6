"""The port's hybrid strategy held against the JAX package's.

``HybridPack``'s arrays must equal the reference's, and
``hybrid_aggregate`` must give the bits of the port's ``ell_aggregate``
and of the reference's numpy replay of ``hybrid_aggregate``, for every
monoid, scalar and ``[n, k]`` messages, weight transforms, degree-0
vertices and the supernode row split (graphs made with numpy from a seed,
as ``tests/test_autotune.py`` makes them)."""

import numpy as np
import pytest
import torch

from janusgraph_tpu.olap import kernels as ref
from janusgraph_tpu_torch.olap import GPUExecutor, csr_from_edges
from janusgraph_tpu_torch.olap import kernels as port
from janusgraph_tpu_torch.olap.programs import (
    ConnectedComponentsProgram,
    PageRankProgram,
    ShortestPathProgram,
)

OPS = ["sum", "min", "max"]


def _bits(a):
    return np.ascontiguousarray(a, dtype=np.float32).view(np.int32)


def skewed(n=300, m=6000, seed=7, weights=False):
    """Heavy-tailed destinations (a torso plus hubs) and degree-0 vertices."""
    rng = np.random.default_rng(seed)
    dst = (rng.zipf(1.35, m) % (n - 20)).astype(np.int64)  # the last 20 get nothing
    src = rng.integers(0, n, m).astype(np.int64)
    w = rng.uniform(0.25, 2.0, m).astype(np.float32) if weights else None
    return n, src, dst, w


def supernode(seed=2, weights=False):
    """One hub far above max_capacity=64: its tail rows split."""
    rng = np.random.default_rng(seed)
    n, m = 300, 8000
    dst = np.concatenate([np.zeros(5000, np.int64), (rng.zipf(1.4, m - 5000) % n).astype(np.int64)])
    src = rng.integers(0, n, m)
    w = rng.uniform(0.5, 2.0, m).astype(np.float32) if weights else None
    return n, src, dst, w


#: name: (edges, pack arguments)
LAYOUTS = {
    "skewed": (skewed(), dict(hub_cutoff=8, tail_chunk=16)),
    "skewed_weighted": (skewed(seed=3, weights=True), dict(hub_cutoff=8, tail_chunk=8)),
    "default_cutoff": (skewed(seed=4), dict()),
    "large_chunk": (skewed(seed=5), dict(hub_cutoff=32, tail_chunk=1024)),
    "supernode": (supernode(), dict(hub_cutoff=8, tail_chunk=16, max_capacity=64)),
    "supernode_weighted": (supernode(weights=True), dict(hub_cutoff=8, tail_chunk=16, max_capacity=64)),
}


def _packs(name):
    (n, src, dst, w), kw = LAYOUTS[name]
    return ref.HybridPack(src, dst, w, n, **kw), port.HybridPack(src, dst, w, n, **kw), (n, src, dst, w, kw)


@pytest.mark.parametrize("name", sorted(LAYOUTS))
def test_hybrid_pack_arrays_equal_reference(name):
    want, got, _ = _packs(name)
    for attr in ("hub_cutoff", "tail_chunk", "num_zero", "has_weight", "slots", "pad_ratio",
                 "torso_meta", "tail_meta"):
        assert getattr(got, attr) == getattr(want, attr), attr
    np.testing.assert_array_equal(got.unpermute, want.unpermute)
    for part in ("torso", "tail"):
        a, b = getattr(want, part), getattr(got, part)
        assert len(a) == len(b)
        for ea, eb in zip(a, b):
            # the port keeps each split bucket's fold matrix beside the
            # reference's arrays
            assert set(eb) - {"fold"} == set(ea), part
            for k in ea:
                assert eb[k].dtype == ea[k].dtype, (part, k)
                np.testing.assert_array_equal(eb[k], ea[k], err_msg=f"{part}.{k}")
    if name.startswith("supernode"):
        assert any("fold" in e for e in got.tail)


#: (layout, transform): weight transforms on the weighted layouts only
AGGREGATE_CASES = [
    (name, t) for name in sorted(LAYOUTS)
    for t in (("none", "mul", "add") if LAYOUTS[name][0][3] is not None else ("none",))
]


@pytest.mark.parametrize("cols", [(), (4,)], ids=["n", "nk"])
@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("name,transform", AGGREGATE_CASES,
                         ids=[f"{n}-{t}" for n, t in AGGREGATE_CASES])
def test_hybrid_aggregate_bitwise(name, transform, op, cols):
    """Against the port's ELL and the reference's numpy replay of the same
    hybrid pack."""
    want_pack, got_pack, (n, src, dst, w, kw) = _packs(name)
    msgs = np.random.default_rng(1).uniform(-1, 1, (n,) + cols).astype(np.float32)
    want = ref.hybrid_aggregate(np, want_pack, msgs, op, transform)
    got = port.hybrid_aggregate(got_pack.to("cpu"), torch.from_numpy(msgs), op, transform).numpy()
    ell_kw = {"max_capacity": kw["max_capacity"]} if "max_capacity" in kw else {}
    ell = port.ell_aggregate(
        port.ELLPack(src, dst, w, n, **ell_kw).to("cpu"), torch.from_numpy(msgs), op, transform
    ).numpy()
    assert got.shape == want.shape == ell.shape and got.dtype == np.float32
    np.testing.assert_array_equal(_bits(got), _bits(want))
    np.testing.assert_array_equal(_bits(got), _bits(ell))
    if name.startswith("skewed"):  # degree-0 vertices read the identity
        identity = {"sum": 0.0, "min": np.inf, "max": -np.inf}[op]
        np.testing.assert_array_equal(got[n - 20:], np.full_like(got[n - 20:], identity))


@pytest.mark.parametrize("op", OPS)
def test_fold_rows_equals_ufunc_at(op):
    """The split rows' fold: identity, then each slot's rows in order, the
    order of the reference's np.<ufunc>.at."""
    rng = np.random.default_rng(3)
    rowseg = np.sort(rng.integers(0, 7, 40))
    rowseg[:3] = 0
    r = rng.uniform(-1, 1, (40, 3)).astype(np.float32)
    r[5] = -0.0
    want = ref._segment_combine_host(np, op, r, rowseg, 9)
    fold = torch.as_tensor(port.row_fold_matrix(rowseg, 9))
    got = port.fold_rows(op, torch.from_numpy(r), fold).numpy()
    np.testing.assert_array_equal(_bits(got), _bits(want))


def test_bad_hybrid_arguments_raise():
    n, src, dst, _w = skewed()
    with pytest.raises(ValueError, match="power of two"):
        port.HybridPack(src, dst, None, n, tail_chunk=100)
    with pytest.raises(ValueError, match="hub_cutoff"):
        port.HybridPack(src, dst, None, n, hub_cutoff=0)
    with pytest.raises(ValueError, match="aggregation strategy"):
        GPUExecutor(csr_from_edges(n, src.astype(np.int32), dst.astype(np.int32)),
                    strategy="pallas", device="cpu")


PROGRAMS = [
    ("pagerank", lambda: PageRankProgram(max_iterations=12, tol=0.0)),
    ("bfs", lambda: ShortestPathProgram(seed_index=3, max_iterations=6)),
    ("bfs_weighted", lambda: ShortestPathProgram(seed_index=3, weighted=True, max_iterations=6)),
    ("cc", lambda: ConnectedComponentsProgram(max_iterations=40)),
]


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "host_loop"])
@pytest.mark.parametrize("name,make", PROGRAMS, ids=[p[0] for p in PROGRAMS])
def test_hybrid_runs_bitwise_equal_to_ell(name, make, fused):
    n, src, dst, w = skewed(n=600, m=12000, seed=11, weights=True)
    csr = csr_from_edges(n, src.astype(np.int32), dst.astype(np.int32), w)
    ell = GPUExecutor(csr, strategy="ell", device="cpu")
    hyb = GPUExecutor(csr, strategy="hybrid", device="cpu", hub_cutoff=16, tail_chunk=8)
    a = ell.run(make(), frontier="off", fused=fused)
    b = hyb.run(make(), frontier="off", fused=fused)
    assert hyb.last_run_info["strategy_resolved"] == "hybrid"
    assert hyb.last_run_info["pad_ratio"] < ell.last_run_info["pad_ratio"]
    assert hyb.last_run_info["pad_ratio"] == hyb.last_run_info["ell_pad_ratio"]
    for k in a:
        np.testing.assert_array_equal(_bits(b[k]), _bits(a[k]), err_msg=k)


@pytest.mark.parametrize("strategy", ["ell", "hybrid", "segsum"])
def test_prewarm_builds_what_the_run_uses(strategy):
    n, src, dst, _w = skewed(seed=13)
    ex = GPUExecutor(csr_from_edges(n, src.astype(np.int32), dst.astype(np.int32)),
                     strategy=strategy, device="cpu")
    ex.prewarm(PageRankProgram())
    built = {"ell": ex._ell_packs, "hybrid": ex._hybrid_packs, "segsum": ex._segsum_plans}[strategy]
    before = dict(built)
    assert len(before) == 1
    ex.run(PageRankProgram(max_iterations=3))
    assert built == before  # the run reused the prewarmed structure
