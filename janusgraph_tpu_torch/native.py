"""Host-side CSR builders (numpy).

The port's copy of the numpy paths of ``janusgraph_tpu/native/__init__.py``
(``build_csr``, ``segment_ids``). The reference's C++ host library is not
ported; its stable counting sort and ``np.argsort(kind="stable")`` give the
same permutations, so these arrays equal the reference's either way.
"""

from __future__ import annotations

import numpy as np


def build_csr(n: int, src: np.ndarray, dst: np.ndarray):
    """Both CSR orientations + stable sort permutations.

    Returns (out_indptr, out_dst, out_perm, in_indptr, in_src, in_perm).
    """
    src = np.ascontiguousarray(src, dtype=np.int32)
    dst = np.ascontiguousarray(dst, dtype=np.int32)
    out_perm = np.argsort(src, kind="stable")
    in_perm = np.argsort(dst, kind="stable")
    out_indptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(np.bincount(src, minlength=n), out=out_indptr[1:])
    in_indptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(np.bincount(dst, minlength=n), out=in_indptr[1:])
    return (
        out_indptr, dst[out_perm], out_perm,
        in_indptr, src[in_perm], in_perm,
    )


def segment_ids(indptr: np.ndarray, m: int) -> np.ndarray:
    """indptr -> per-edge segment ids (repeat encoding), int32."""
    indptr = np.asarray(indptr, dtype=np.int64)
    return np.repeat(
        np.arange(len(indptr) - 1, dtype=np.int32), np.diff(indptr)
    )[:m]
