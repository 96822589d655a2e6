"""Sharded checkpoint format: per-shard state slices + an atomic manifest —
the port's copy of ``janusgraph_tpu/olap/sharded_checkpoint.py``, whole,
writing the same files byte for byte (a checkpoint either package writes
loads array-equal in the other).

The single-file checkpoint (olap/checkpoint.py) serializes the FULL vertex
state each interval — fine on one chip, but on a mesh it funnels every
shard's state through one writer and one rename, and a torn write loses the
whole interval for the whole mesh. This module is the multi-chip form:

- each shard's rows land in their own ``shard-<s>.npz`` slice, digest-
  embedded and written atomically (tmp + rename, previous slice demoted to
  ``.prev``) — slices can be written independently and, on a real multi-
  controller deployment, by different hosts;
- a checkpoint COMMITS only when ``manifest.json`` lands (tmp + rename,
  previous manifest demoted to ``.prev``). The manifest names every slice
  by content digest, carries the reduced aggregators + step counter, and
  embeds its own digest. The manifest rename is the linearization point:
  the superstep boundary it records is the cross-shard CONSISTENCY CUT the
  BSP barrier already guarantees (no shard can be "between" supersteps at
  a barrier), so rolling every shard back to the last manifest and
  replaying reproduces the exact run.

Torn-write containment, per file class:

- torn SLICE write: the slice's digest won't match the manifest; the
  loader falls back to the slice's ``.prev`` twin IF its digest matches
  (the tear happened after demotion but before promotion), else the whole
  manifest is incomplete and the loader falls back to ``manifest.json
  .prev`` — one interval lost, never the run;
- torn MANIFEST write: the JSON parse or embedded digest fails; the
  loader falls back to ``manifest.json.prev`` whose slices are still on
  disk (every slice save keeps its ``.prev`` twin precisely so the
  previous manifest stays loadable).

Slices store REAL (unpadded) rows keyed by contiguous row ranges, so a
checkpoint written by an S-shard mesh restores on any shard count — the
executors re-derive padding rows from a fresh ``setup()`` exactly like the
single-file resume path.
"""

from __future__ import annotations

import hashlib
import json
import os
import tempfile
from typing import Dict, List, Optional, Tuple

import numpy as np

from janusgraph_tpu_torch.olap.checkpoint import _content_digest

MANIFEST_NAME = "manifest.json"
_MANIFEST_VERSION = 1
_STATE = "state__"


def shard_ranges(num_rows: int, num_shards: int) -> List[Tuple[int, int]]:
    """Contiguous [lo, hi) row ranges, one per shard (ceil split — the
    same contiguous-block convention as ShardedCSR / host_partition_range)."""
    S = max(1, int(num_shards))
    size = -(-max(num_rows, 1) // S)
    return [
        (min(s * size, num_rows), min((s + 1) * size, num_rows))
        for s in range(S)
    ]


def _slice_path(dir_path: str, shard: int) -> str:
    return os.path.join(dir_path, f"shard-{shard}.npz")


def _atomic_npz(path: str, arrays: Dict[str, np.ndarray]) -> None:
    """tmp + rename in the target directory; the previous file survives as
    ``<path>.prev`` (same two-rename discipline as olap/checkpoint.py)."""
    d = os.path.dirname(os.path.abspath(path)) or "."
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".npz.tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **arrays)
        if os.path.exists(path):
            os.replace(path, path + ".prev")
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def _manifest_digest(body: dict) -> str:
    """Digest over the canonical JSON of the manifest body (sorted keys,
    ``digest`` field excluded) — a torn/edited manifest cannot verify."""
    canon = json.dumps(
        {k: v for k, v in sorted(body.items()) if k != "digest"},
        sort_keys=True,
    )
    return hashlib.sha256(canon.encode()).hexdigest()


def save_sharded_checkpoint(
    dir_path: str,
    state: Dict[str, np.ndarray],
    memory: Dict[str, object],
    steps_done: int,
    num_shards: int,
) -> None:
    """Write per-shard slices, then commit the manifest. ``state`` holds
    the REAL rows (padding stripped); each array's leading dim is the
    vertex axis and is sliced into ``num_shards`` contiguous blocks."""
    state = {k: np.asarray(v) for k, v in state.items()}
    num_rows = int(next(iter(state.values())).shape[0]) if state else 0
    ranges = shard_ranges(num_rows, num_shards)
    shards = []
    for s, (lo, hi) in enumerate(ranges):
        arrays = {
            _STATE + k: np.ascontiguousarray(v[lo:hi])
            for k, v in state.items()
        }
        digest = _content_digest(arrays)
        arrays["meta__digest"] = digest
        _atomic_npz(_slice_path(dir_path, s), arrays)
        shards.append({
            "file": f"shard-{s}.npz",
            "rows": [int(lo), int(hi)],
            "digest": digest.tobytes().hex(),
        })
    body = {
        "version": _MANIFEST_VERSION,
        "steps": int(steps_done),
        "num_shards": int(num_shards),
        "num_rows": num_rows,
        "state_keys": sorted(state),
        "memory": {k: float(v) for k, v in memory.items()},
        "shards": shards,
    }
    body["digest"] = _manifest_digest(body)
    mpath = os.path.join(dir_path, MANIFEST_NAME)
    fd, tmp = tempfile.mkstemp(dir=dir_path, suffix=".json.tmp")
    try:
        with os.fdopen(fd, "w") as f:
            json.dump(body, f)
        if os.path.exists(mpath):
            os.replace(mpath, mpath + ".prev")
        os.replace(tmp, mpath)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise
    from janusgraph_tpu_torch.observability import flight_recorder

    flight_recorder.record(
        "checkpoint", action="shard_save", steps=int(steps_done),
        shards=int(num_shards),
    )


def _read_manifest(mpath: str) -> Optional[dict]:
    """One manifest file, digest-verified; None when missing/torn/edited."""
    if not os.path.exists(mpath):
        return None
    try:
        with open(mpath) as f:
            body = json.load(f)
    except (OSError, ValueError):
        return None
    if not isinstance(body, dict) or body.get("version") != _MANIFEST_VERSION:
        return None
    if body.get("digest") != _manifest_digest(body):
        return None
    return body


def _read_slice(
    path: str, want_digest: str
) -> Optional[Dict[str, np.ndarray]]:
    """One slice file IF its content digest matches the manifest's record.
    Missing/torn/mismatched files return None (caller tries ``.prev``)."""
    if not os.path.exists(path):
        return None
    try:
        with np.load(path) as z:
            arrays = {k: z[k] for k in z.files}
    except Exception:  # zipfile/format errors: torn or truncated
        return None
    arrays.pop("meta__digest", None)
    if _content_digest(arrays).tobytes().hex() != want_digest:
        return None
    return {
        k[len(_STATE):]: v for k, v in arrays.items() if k.startswith(_STATE)
    }


def _assemble(dir_path: str, body: dict, record_fallbacks: bool = True) -> Optional[
    Tuple[Dict[str, np.ndarray], Dict[str, float], int]
]:
    """Collect every slice the manifest names — current file first, its
    ``.prev`` twin second (content-addressed by digest, so whichever file
    carries the manifest's bytes is the right one). None if any shard has
    neither."""
    from janusgraph_tpu_torch.observability import flight_recorder, registry

    num_rows = int(body["num_rows"])
    keys = list(body["state_keys"])
    pieces: List[Dict[str, np.ndarray]] = []
    for rec in body["shards"]:
        path = os.path.join(dir_path, rec["file"])
        sl = _read_slice(path, rec["digest"])
        if sl is None:
            sl = _read_slice(path + ".prev", rec["digest"])
            if sl is not None and record_fallbacks:
                # a demoted twin carried the manifest's bytes: the current
                # slice write was torn after demotion
                registry.counter("olap.checkpoint.shard_fallback").inc()
                flight_recorder.record(
                    "checkpoint", action="shard_fallback",
                    file=rec["file"], steps=int(body["steps"]),
                )
        if sl is None or set(sl) != set(keys):
            return None
        pieces.append(sl)
    state = {
        k: np.concatenate([p[k] for p in pieces], axis=0)[:num_rows]
        for k in keys
    }
    return state, dict(body.get("memory", {})), int(body["steps"])


# ---------------------------------------------------------------------------
# CSR snapshot checkpoints (fleet replica warm-up)
# ---------------------------------------------------------------------------
#
# The per-shard-slice + digest-verified-manifest discipline above also
# carries the snapshot-CSR cache across processes: a serving replica
# exports its base pack once, and a JOINING replica hydrates from the
# files instead of re-scanning storage (zero edgestore reads — the
# warm-up half of server/fleet.py). Unlike the state checkpoints, a CSR
# pack mixes vertex-axis and edge-axis arrays, so slices are row-range
# shards whose edge arrays cover exactly the rows' indptr spans — the
# same contiguous-block convention as ShardedCSR, and reassembly is
# byte-identical to the exported arrays (the acceptance contract).

_CSR_KIND = "csr-snapshot"

#: arrays present only when the exported pack carries them (the loader
#: passes absent ones as None, matching a scanned snapshot)
_CSR_OPTIONAL = ("labels", "out_edge_type", "in_edge_type")


def save_csr_checkpoint(
    dir_path: str, csr, epoch: int, num_shards: int = 1
) -> None:
    """Export one CSR snapshot pack as a sharded checkpoint: per-shard
    row-range slices (vertex arrays by rows, edge arrays by the rows'
    indptr spans), each digest-embedded and written atomically, committed
    by the digest-verified manifest."""
    n = int(len(csr.vertex_ids))
    ranges = shard_ranges(n, num_shards)
    shards = []
    for s, (lo, hi) in enumerate(ranges):
        olo, ohi = int(csr.out_indptr[lo]), int(csr.out_indptr[hi])
        ilo, ihi = int(csr.in_indptr[lo]), int(csr.in_indptr[hi])
        arrays = {
            "vertex_ids": np.ascontiguousarray(csr.vertex_ids[lo:hi]),
            "out_degree": np.ascontiguousarray(csr.out_degree[lo:hi]),
            "out_indptr": np.ascontiguousarray(
                csr.out_indptr[lo: hi + 1]
            ),
            "in_indptr": np.ascontiguousarray(csr.in_indptr[lo: hi + 1]),
            "out_dst": np.ascontiguousarray(csr.out_dst[olo:ohi]),
            "in_src": np.ascontiguousarray(csr.in_src[ilo:ihi]),
        }
        if csr.labels is not None:
            arrays["labels"] = np.ascontiguousarray(csr.labels[lo:hi])
        if csr.out_edge_type is not None:
            arrays["out_edge_type"] = np.ascontiguousarray(
                csr.out_edge_type[olo:ohi]
            )
            arrays["in_edge_type"] = np.ascontiguousarray(
                csr.in_edge_type[ilo:ihi]
            )
        digest = _content_digest(arrays)
        arrays["meta__digest"] = digest
        _atomic_npz(_slice_path(dir_path, s), arrays)
        shards.append({
            "file": f"shard-{s}.npz",
            "rows": [int(lo), int(hi)],
            "digest": digest.tobytes().hex(),
        })
    body = {
        "version": _MANIFEST_VERSION,
        "kind": _CSR_KIND,
        "epoch": int(epoch),
        "num_shards": int(num_shards),
        "num_rows": n,
        "num_edges": int(csr.num_edges),
        "optional": sorted(
            k for k in _CSR_OPTIONAL
            if getattr(csr, k, None) is not None
        ),
        "shards": shards,
    }
    body["digest"] = _manifest_digest(body)
    mpath = os.path.join(dir_path, MANIFEST_NAME)
    fd, tmp = tempfile.mkstemp(dir=dir_path, suffix=".json.tmp")
    try:
        with os.fdopen(fd, "w") as f:
            json.dump(body, f)
        if os.path.exists(mpath):
            os.replace(mpath, mpath + ".prev")
        os.replace(tmp, mpath)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise
    from janusgraph_tpu_torch.observability import flight_recorder

    flight_recorder.record(
        "checkpoint", action="csr_save", rows=n,
        edges=int(csr.num_edges), shards=int(num_shards),
    )


def _assemble_csr(dir_path: str, body: dict):
    pieces = []
    for rec in body["shards"]:
        path = os.path.join(dir_path, rec["file"])
        sl = None
        for candidate in (path, path + ".prev"):
            if not os.path.exists(candidate):
                continue
            try:
                with np.load(candidate) as z:
                    arrays = {k: z[k] for k in z.files}
            except Exception:  # noqa: BLE001 - torn/truncated slice
                continue
            arrays.pop("meta__digest", None)
            if _content_digest(arrays).tobytes().hex() == rec["digest"]:
                sl = arrays
                break
        if sl is None:
            return None
        pieces.append(sl)
    if not pieces:
        return None

    def _cat(key, indptr=False):
        if key not in pieces[0]:
            return None
        if indptr:
            # each slice stored indptr[lo:hi+1] with ABSOLUTE values;
            # drop the duplicated boundary of every later slice
            parts = [pieces[0][key]] + [p[key][1:] for p in pieces[1:]]
        else:
            parts = [p[key] for p in pieces]
        return np.concatenate(parts) if len(parts) > 1 else parts[0]

    from janusgraph_tpu_torch.olap.csr import CSRGraph

    csr = CSRGraph(
        vertex_ids=_cat("vertex_ids"),
        out_indptr=_cat("out_indptr", indptr=True),
        out_dst=_cat("out_dst"),
        in_indptr=_cat("in_indptr", indptr=True),
        in_src=_cat("in_src"),
        out_degree=_cat("out_degree"),
        labels=_cat("labels"),
        out_edge_type=_cat("out_edge_type"),
        in_edge_type=_cat("in_edge_type"),
    )
    if len(csr.vertex_ids) != int(body["num_rows"]) or (
        len(csr.out_dst) != int(body["num_edges"])
    ):
        return None
    return csr, int(body["epoch"])


def load_csr_checkpoint(dir_path: str):
    """(CSRGraph, epoch) from the newest COMPLETE CSR snapshot checkpoint
    (current manifest first, ``manifest.json.prev`` fallback — the state
    checkpoints' torn-write containment), or None. Arrays reassemble
    byte-identical to the exported pack; the epoch binds to the EXPORTING
    process's backend — a joining replica re-anchors at its own observed
    epoch (server/fleet.py warm_replica)."""
    mpath = os.path.join(dir_path, MANIFEST_NAME)
    for candidate in (mpath, mpath + ".prev"):
        body = _read_manifest(candidate)
        if body is None or body.get("kind") != _CSR_KIND:
            continue
        out = _assemble_csr(dir_path, body)
        if out is not None:
            if candidate != mpath:
                from janusgraph_tpu_torch.observability import (
                    flight_recorder,
                    registry,
                )

                registry.counter(
                    "olap.checkpoint.manifest_fallback"
                ).inc()
                flight_recorder.record(
                    "checkpoint", action="manifest_fallback",
                    steps=int(out[1]),
                )
            return out
    return None


def load_sharded_checkpoint(
    dir_path: str,
) -> Optional[Tuple[Dict[str, np.ndarray], Dict[str, float], int]]:
    """(state, memory, steps_done) from the newest COMPLETE checkpoint:
    the current manifest if every slice verifies, else ``manifest.json
    .prev`` — a torn write (slice or manifest) costs one interval, never
    the run. None when no complete checkpoint exists."""
    mpath = os.path.join(dir_path, MANIFEST_NAME)
    current = _read_manifest(mpath)
    if current is not None:
        out = _assemble(dir_path, current)
        if out is not None:
            return out
    fallback = _read_manifest(mpath + ".prev")
    if fallback is None:
        return None
    # the previous manifest's slices usually live in the .prev twins (the
    # newer save demoted them) — that is the expected layout, not a
    # per-shard incident, so slice fallbacks are not re-counted here
    out = _assemble(dir_path, fallback, record_fallbacks=False)
    if out is not None and os.path.exists(mpath):
        from janusgraph_tpu_torch.observability import flight_recorder, registry

        registry.counter("olap.checkpoint.manifest_fallback").inc()
        # the newest manifest (or one of its slices) was torn and .prev
        # saved the run — the exact event a post-mortem timeline needs
        flight_recorder.record(
            "checkpoint", action="manifest_fallback", steps=int(out[2]),
        )
    return out
