"""The port's native host library held to the JAX package's.

``build_csr``, ``segment_ids``, ``ell_fill`` and ``rmat_edges`` of
``janusgraph_tpu_torch.native`` (``csrc/graphcsr.cpp`` through ``ctypes``,
and the numpy versions under ``native.numpy_only()``) equal
``janusgraph_tpu.native`` array for array, on both of its paths. The
R-MAT generator is the case that matters: the port used to draw with numpy
where the reference draws with its C++ generator, so the same (scale, seed)
gave two different graphs. ``fill_ell_rows`` is equal native against numpy.
"""

import numpy as np
import pytest

import janusgraph_tpu.native as ref_native
from janusgraph_tpu.olap import generators as ref_generators
from janusgraph_tpu_torch import native
from janusgraph_tpu_torch.olap import generators, kernels

pytestmark = pytest.mark.skipif(
    not native.available(), reason="no C++ compiler for the native host library"
)


def _edges(n=300, m=2000, seed=5):
    rng = np.random.default_rng(seed)
    return n, rng.integers(0, n, m).astype(np.int32), rng.integers(0, n, m).astype(np.int32)


@pytest.fixture(params=["native", "numpy"])
def path(request, monkeypatch):
    """Both packages on the same path: the reference's numpy path is its
    ``_load`` returning None, as ``JG_TPU_NO_NATIVE`` makes it."""
    if request.param == "numpy":
        monkeypatch.setattr(ref_native, "_load", lambda: None)
        with native.numpy_only():
            assert not native.available()
            yield request.param
    else:
        assert ref_native.available()
        yield request.param


#: below 2^16 edges the native sort runs on one thread (the last of those:
#: more vertices than edges), from 2^16 on several: many vertices, three
#: hubs, more vertices than edges
@pytest.mark.parametrize("shape", [(300, 2000), (1, 0), (50, 1), (1 << 16, 3000), (4096, 70000),
                                   (3, 200_000), (1 << 18, 1 << 17)])
def test_build_csr_equals_reference(path, shape):
    n, src, dst = _edges(*shape)
    got = native.build_csr(n, src, dst)
    want = ref_native.build_csr(n, src, dst)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_build_csr_refuses_2_31_edges(path):
    """The native sort counts edges in int32; both paths refuse before they
    read an edge (the arrays here are broadcasts, never made)."""
    edges = np.broadcast_to(np.int32(0), (2**31,))
    with pytest.raises(ValueError, match="2\\*\\*31"):
        native.build_csr(1, edges, edges)


@pytest.mark.parametrize("m", [0, 1, 1999, 2000])
def test_segment_ids_equals_reference(path, m):
    n, src, dst = _edges()
    indptr = native.build_csr(n, src, dst)[3]
    got = native.segment_ids(indptr, m)
    want = ref_native.segment_ids(indptr, m)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("weighted", [False, True])
def test_ell_fill_equals_reference(weighted):
    rng = np.random.default_rng(2)
    rows, cap = 5000, 16
    degs = rng.integers(0, cap + 1, rows).astype(np.int64)
    starts = np.concatenate([[0], np.cumsum(degs)[:-1]]).astype(np.int64)
    src = rng.integers(0, 10_000, int(degs.sum())).astype(np.int32)
    w = rng.uniform(0.5, 2.0, len(src)).astype(np.float32) if weighted else None
    out = []
    for fill in (native.ell_fill, ref_native.ell_fill):
        idx = np.full((rows, cap), 99, dtype=np.int32)
        wmat = np.zeros((rows, cap), dtype=np.float32) if weighted else None
        valid = np.zeros((rows, cap), dtype=np.float32) if weighted else None
        assert fill(cap, starts, degs, src, w, idx, wmat, valid)
        out.append((idx, wmat, valid))
    for a, b in zip(*out):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("weighted", [False, True])
def test_fill_ell_rows_native_equals_numpy(weighted):
    rng = np.random.default_rng(4)
    rows, cap = 700, 8
    degs = rng.integers(0, cap + 1, rows).astype(np.int64)
    starts = rng.integers(0, 3000, rows).astype(np.int64)
    src = rng.integers(0, 5000, 3000 + cap).astype(np.int32)
    w = rng.uniform(0.5, 2.0, len(src)).astype(np.float32) if weighted else None
    out = []
    for numpy_path in (False, True):
        idx = np.full((rows, cap), -1, dtype=np.int32)
        wmat = np.zeros((rows, cap), dtype=np.float32) if weighted else None
        valid = np.zeros((rows, cap), dtype=np.float32) if weighted else None
        if numpy_path:
            with native.numpy_only():
                kernels.fill_ell_rows(starts, degs, src, w, idx, wmat, valid)
        else:
            kernels.fill_ell_rows(starts, degs, src, w, idx, wmat, valid)
        out.append((idx, wmat, valid))
    for a, b in zip(*out):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("scale", [8, 10, 12, 14])
@pytest.mark.parametrize("seed", [1, 2, 17])
def test_rmat_edges_equals_reference(path, scale, seed):
    """The same (scale, seed) is the same graph in both packages, on the
    native path (SplitMix64) and on the numpy path alike."""
    got = generators.rmat_edges(scale, seed=seed)
    want = ref_generators.rmat_edges(scale, seed=seed)
    assert got[0] == want[0]
    for a, b in zip(got[1:], want[1:]):
        assert a.dtype == b.dtype == np.int32
        np.testing.assert_array_equal(a, b)


def test_rmat_unpermuted_and_weighted_csr_equal_reference():
    got = generators.rmat_edges(10, seed=3, permute=False)
    want = ref_generators.rmat_edges(10, seed=3, permute=False)
    for a, b in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(a, b)
    g = generators.rmat_csr(9, seed=4, weights=True)
    r = ref_generators.rmat_csr(9, seed=4, weights=True)
    for f in ("out_indptr", "out_dst", "in_indptr", "in_src", "in_edge_weight"):
        np.testing.assert_array_equal(getattr(g, f), getattr(r, f))


def test_native_and_numpy_draw_different_edges():
    """The two generators are different streams: which one ran is part of
    the graph's identity, and the port now takes the reference's choice."""
    nat = generators.rmat_edges(10, seed=1)
    with native.numpy_only():
        num = generators.rmat_edges(10, seed=1)
    assert not np.array_equal(nat[1], num[1])
