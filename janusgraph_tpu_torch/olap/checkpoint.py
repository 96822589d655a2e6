"""Superstep checkpoints — the port of ``janusgraph_tpu/olap/checkpoint.py``.

A checkpoint is the vertex state dict, the aggregators and the step count,
written atomically as one ``.npz`` in the reference's format (``state__``
and ``mem__`` prefixes, ``meta__steps``, ``meta__digest``), so a checkpoint
written by either package resumes in the other.

Each checkpoint embeds a sha256 digest of its arrays, and each save demotes
the previous checkpoint to ``<path>.prev`` before promoting the new one;
``load_checkpoint`` falls back to ``.prev`` when the newest file is torn or
corrupt. The reference also records saves and fallbacks in its flight
recorder and counters; those wait for the port's observability slice.
"""

from __future__ import annotations

import hashlib
import os
import tempfile
from typing import Dict, Optional, Tuple

import numpy as np

_STATE = "state__"
_MEM = "mem__"
_META = "meta__steps"
_DIGEST = "meta__digest"


def _content_digest(arrays: Dict[str, np.ndarray]) -> np.ndarray:
    """Digest over the names, dtypes, shapes and bytes of every payload
    array, in name order."""
    h = hashlib.sha256()
    for name in sorted(arrays):
        if name == _DIGEST:
            continue
        a = np.ascontiguousarray(arrays[name])
        h.update(name.encode())
        h.update(str(a.dtype).encode())
        h.update(str(a.shape).encode())
        h.update(a.tobytes())
    return np.frombuffer(h.digest(), dtype=np.uint8).copy()


def save_checkpoint(
    path: str,
    state: Dict[str, np.ndarray],
    memory: Dict[str, np.ndarray],
    steps_done: int,
) -> None:
    """Atomic write: a temporary file in the same directory, then a rename;
    the previous checkpoint survives as ``<path>.prev``."""
    arrays = {_STATE + k: np.asarray(v) for k, v in state.items()}
    arrays.update({_MEM + k: np.asarray(v) for k, v in memory.items()})
    arrays[_META] = np.asarray(steps_done, dtype=np.int64)
    arrays[_DIGEST] = _content_digest(arrays)
    d = os.path.dirname(os.path.abspath(path)) or "."
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".npz.tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **arrays)
        if os.path.exists(path):
            # demote the old checkpoint before promoting the new one: a crash
            # between the renames leaves .prev as the newest intact file
            os.replace(path, path + ".prev")
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def _load_verified(
    path: str,
) -> Optional[Tuple[Dict[str, np.ndarray], Dict[str, np.ndarray], int]]:
    """One file, its digest verified; None when it is missing, truncated,
    unreadable or fails verification."""
    if not os.path.exists(path):
        return None
    try:
        with np.load(path) as z:
            arrays = {k: z[k] for k in z.files}
    except Exception:  # zipfile/format errors: a torn or truncated write
        return None
    if _META not in arrays:
        return None
    stored = arrays.pop(_DIGEST, None)
    if stored is None or not np.array_equal(stored, _content_digest(arrays)):
        return None
    state = {k[len(_STATE):]: v for k, v in arrays.items() if k.startswith(_STATE)}
    memory = {k[len(_MEM):]: v for k, v in arrays.items() if k.startswith(_MEM)}
    return state, memory, int(arrays[_META])


def load_checkpoint(
    path: str,
) -> Optional[Tuple[Dict[str, np.ndarray], Dict[str, np.ndarray], int]]:
    """(state, memory, steps_done), falling back to ``<path>.prev`` when the
    newest checkpoint is torn or corrupt; None when neither verifies."""
    loaded = _load_verified(path)
    if loaded is not None:
        return loaded
    return _load_verified(path + ".prev")
