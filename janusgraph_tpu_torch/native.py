"""Host-side graph-structure helpers: the native host library with numpy
versions beside it.

The port's copy of ``janusgraph_tpu/native/__init__.py``. The C++ source is
the port's own ``csrc/graphcsr.cpp`` (counting-sort CSR build, segment ids,
ELL fill, R-MAT), built by ``_build.load_host_library`` with ``g++`` at
first use and called through ``ctypes`` on raw array pointers. Every entry
point keeps its numpy version for hosts without a compiler; ``available()``
says which path is active. The counting sort and
``np.argsort(kind="stable")`` give the same permutations, so the arrays are
equal either way.

``with numpy_only(): ...`` forces the numpy versions (the tests drive both
paths this way, as the reference's ``JG_TPU_NO_NATIVE`` does).
"""

from __future__ import annotations

import contextlib
import ctypes
import threading
from typing import Optional

import numpy as np

_lib = None
_tried = False
_lock = threading.Lock()
#: ``numpy_only()`` depth: while positive, every entry point takes numpy
_forced_numpy = 0


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _forced_numpy:
        return None
    if _lib is not None or _tried:
        return _lib
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        from janusgraph_tpu_torch import _build

        try:
            # the first-use compile holds _lock on purpose: concurrent
            # callers wait for the library instead of taking numpy for the
            # life of the process
            # graphlint: disable=JG403 -- intentional: first-use g++ compile gate (the comment above); waiting beats losing the native path
            lib = _build.load_host_library()
        except (OSError, RuntimeError) as e:
            _build.host_build_info["error"] = str(e)[:2000]
            return None
        I64, I32, F32 = (
            np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS"),
        )

        class F32OrNull:
            """float32 C-contiguous ndpointer that also accepts None."""

            @classmethod
            def from_param(cls, obj):
                if obj is None:
                    return None
                return F32.from_param(obj)

        lib.build_csr.argtypes = [
            ctypes.c_int64, ctypes.c_int64, I32, I32,
            I64, I32, I64, I64, I32, I64,
        ]
        lib.segment_ids.argtypes = [ctypes.c_int64, ctypes.c_int64, I64, I32]
        lib.ell_fill.argtypes = [
            ctypes.c_int64, ctypes.c_int64, I64, I64, I32,
            F32OrNull, I32, F32OrNull, F32OrNull,
        ]
        lib.rmat_edges.argtypes = [
            ctypes.c_int64, ctypes.c_int64, ctypes.c_uint64,
            ctypes.c_double, ctypes.c_double, ctypes.c_double, I32, I32,
        ]
        _lib = lib
        return _lib


def available() -> bool:
    """True where the native library is built, loaded and not switched off."""
    return _load() is not None


@contextlib.contextmanager
def numpy_only():
    """Run the enclosed calls through the numpy versions (process-wide)."""
    global _forced_numpy
    _forced_numpy += 1
    try:
        yield
    finally:
        _forced_numpy -= 1


# ------------------------------------------------------------- entry points

def build_csr(n: int, src: np.ndarray, dst: np.ndarray):
    """Both CSR orientations + stable sort permutations.

    Returns (out_indptr, out_dst, out_perm, in_indptr, in_src, in_perm).
    Takes fewer than 2**31 edges (the native sort counts in int32).
    """
    m = len(src)
    if m >= 2**31:
        raise ValueError(f"build_csr takes fewer than 2**31 edges, got {m}")
    src = np.ascontiguousarray(src, dtype=np.int32)
    dst = np.ascontiguousarray(dst, dtype=np.int32)
    lib = _load()
    if lib is not None:
        out_indptr = np.empty(n + 1, dtype=np.int64)
        out_dst = np.empty(m, dtype=np.int32)
        out_perm = np.empty(m, dtype=np.int64)
        in_indptr = np.empty(n + 1, dtype=np.int64)
        in_src = np.empty(m, dtype=np.int32)
        in_perm = np.empty(m, dtype=np.int64)
        lib.build_csr(
            n, m, src, dst,
            out_indptr, out_dst, out_perm, in_indptr, in_src, in_perm,
        )
        return out_indptr, out_dst, out_perm, in_indptr, in_src, in_perm
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
    indptr = np.ascontiguousarray(indptr, dtype=np.int64)
    lib = _load()
    if lib is not None:
        seg = np.empty(m, dtype=np.int32)
        lib.segment_ids(len(indptr) - 1, m, indptr, seg)
        return seg
    return np.repeat(
        np.arange(len(indptr) - 1, dtype=np.int32), np.diff(indptr)
    )[:m]


def ell_fill(cap, starts, degs, sorted_src, sorted_w, idx, wmat, valid) -> bool:
    """Fill one ELL bucket in place (wmat/valid may be None for unweighted
    packs). Returns False where the library is not available, and the
    caller keeps its numpy path."""
    lib = _load()
    if lib is None:
        return False
    lib.ell_fill(
        len(starts), cap,
        np.ascontiguousarray(starts, dtype=np.int64),
        np.ascontiguousarray(degs, dtype=np.int64),
        np.ascontiguousarray(sorted_src, dtype=np.int32),
        sorted_w, idx, wmat, valid,
    )
    return True


def rmat_edges(
    scale: int, m: int, seed: int, a: float = 0.57, b: float = 0.19, c: float = 0.19
):
    """Multi-threaded R-MAT edge synthesis (SplitMix64 over a fixed grid of
    64 chunks, so the edges do not depend on the thread count); returns
    (src, dst) or None where the library is not available."""
    lib = _load()
    if lib is None:
        return None
    src = np.empty(m, dtype=np.int32)
    dst = np.empty(m, dtype=np.int32)
    lib.rmat_edges(scale, m, seed & 0xFFFFFFFFFFFFFFFF, a, b, c, src, dst)
    return src, dst
