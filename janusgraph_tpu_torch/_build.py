"""Build and load the port's CUDA kernels.

The ``csrc/*.cu`` sources are compiled by one ``nvcc`` call for ``sm_90a``
into a shared library with a plain C interface and loaded with ``ctypes``; no
PyTorch headers are involved. Libraries go to ``_build/<source hash>/``
beside this file (listed in ``.gitignore``) and are built at first use, so
a fresh checkout builds from its own sources.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

_DIR = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_DIR, "csrc")
BUILD_DIR = os.path.join(_DIR, "_build")
SOURCES = ("segsum.cu",)
LIB_NAME = "libjg_kernels.so"
#: no -use_fast_math: the kernels add in fp32 with IEEE rounding
COMPILE_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_lib = None
#: what the last build did: {"seconds", "log", "path", "cached"}
build_info: dict = {}


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(COMPILE_FLAGS).encode())
    for name in SOURCES:
        with open(os.path.join(CSRC, name), "rb") as f:
            h.update(name.encode() + f.read())
    return h.hexdigest()[:16]


def _compile(out_path: str) -> str:
    """Compile the sources into ``out_path`` with one nvcc call. Returns
    the compiler output."""
    tmp = f"{out_path}.{os.getpid()}.tmp"
    proc = subprocess.run(
        [_nvcc(), *COMPILE_FLAGS, "-shared", "-o", tmp,
         *[os.path.join(CSRC, name) for name in SOURCES]],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    if proc.returncode != 0:
        raise RuntimeError("nvcc failed:\n" + proc.stdout)
    os.replace(tmp, out_path)
    return proc.stdout


def load_library() -> ctypes.CDLL:
    """The kernels' shared library, built on first use."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is not None:
            return _lib
        work = os.path.join(BUILD_DIR, _source_hash())
        path = os.path.join(work, LIB_NAME)
        t0 = time.perf_counter()
        cached = os.path.exists(path)
        log = ""
        if not cached:
            os.makedirs(work, exist_ok=True)
            log = _compile(path)
        lib = ctypes.CDLL(path)
        ptr = ctypes.c_void_p
        lib.jg_sorted_segment_sum.argtypes = [
            ptr, ptr, ptr, ptr,
            ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ptr, ptr, ptr, ptr,
        ]
        lib.jg_sorted_segment_sum.restype = ctypes.c_int
        lib.jg_segsum_ctas_per_sm.argtypes = [ctypes.c_int]
        lib.jg_segsum_ctas_per_sm.restype = ctypes.c_int
        lib.jg_error_string.argtypes = [ctypes.c_int]
        lib.jg_error_string.restype = ctypes.c_char_p
        build_info.update(
            seconds=time.perf_counter() - t0, log=log, path=path, cached=cached
        )
        _lib = lib
        return _lib
