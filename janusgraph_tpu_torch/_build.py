"""Build and load the port's native libraries.

The ``csrc/*.cu`` sources are compiled by one ``nvcc`` call for ``sm_90a``
into a shared library with a plain C interface and loaded with ``ctypes``; no
PyTorch headers are involved. The host library ``csrc/graphcsr.cpp`` (CSR
build, segment ids, ELL fill, R-MAT) is compiled by ``g++`` with the JAX
package's flags (``load_host_library``). Libraries go to
``_build/<source hash>/`` beside this file (listed in ``.gitignore``) and are
built at first use, so a fresh checkout builds from its own sources.
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

HOST_SOURCE = "graphcsr.cpp"
HOST_LIB_NAME = "libjg_graphcsr.so"
HOST_COMPILE_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")

_lock = threading.Lock()
_lib = None
#: what the last build did: {"seconds", "log", "path", "cached"}
build_info: dict = {}
#: the host library's build: the same keys, plus "error" where g++ failed
host_build_info: dict = {}


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def _source_hash(sources=SOURCES, flags=COMPILE_FLAGS) -> str:
    h = hashlib.sha256(" ".join(flags).encode())
    for name in sources:
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


def load_host_library() -> ctypes.CDLL:
    """The host library (``csrc/graphcsr.cpp``), built with ``g++`` on first
    use. Raises ``RuntimeError`` where it cannot be built or loaded; the
    caller (``native.py``) then keeps its numpy versions."""
    work = os.path.join(BUILD_DIR, _source_hash((HOST_SOURCE,), HOST_COMPILE_FLAGS))
    path = os.path.join(work, HOST_LIB_NAME)
    t0 = time.perf_counter()
    cached = os.path.exists(path)
    log = ""
    if not cached:
        gxx = shutil.which("g++")
        if gxx is None:
            raise RuntimeError("g++ not found: the host library cannot be built")
        os.makedirs(work, exist_ok=True)
        # a unique name per process: concurrent processes each replace the
        # file atomically with the same bytes
        tmp = f"{path}.{os.getpid()}.tmp"
        proc = subprocess.run(
            [gxx, *HOST_COMPILE_FLAGS, "-o", tmp, os.path.join(CSRC, HOST_SOURCE)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, timeout=300,
        )
        if proc.returncode != 0:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise RuntimeError("g++ failed:\n" + proc.stdout)
        os.replace(tmp, path)
        log = proc.stdout
    lib = ctypes.CDLL(path)
    host_build_info.update(
        seconds=time.perf_counter() - t0, log=log, path=path, cached=cached
    )
    return lib
