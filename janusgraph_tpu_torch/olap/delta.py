"""Delta overlay: analytics over a base snapshot plus the writes pending
against it, without the repack — the port of ``janusgraph_tpu/olap/delta.py``
(``ChangeCapture``, ``overlay_since``, ``DeltaOverlay``, ``materialize``,
``OverlayView``, ``fused_delta_aggregate``, ``FusedHostView``,
``DeltaSnapshot``, ``compact_result``, ``program_delta_compatible`` and the
snapshot files).

- **Change capture** (:class:`ChangeCapture`): ``BackendTransaction.commit``
  taps every committed edgestore batch into a bounded per-graph ring.
  Batches decode vectorized through the fixed-width bulk edge decoder the
  scan uses (cells with a sort key or properties through
  ``parse_relation``), so a bulk-load commit costs one pass, into records:
  edge adds, edge deletes (the tombstone lane), vertex add and remove. A
  cell the decoder cannot classify poisons the ring: epochs before it are
  served by a full scan, never by stale lanes.

- **Delta overlay** (:class:`DeltaOverlay`): pending records net out
  (multiset counting: a delete cancels a pending add of the same
  ``(src, dst, type)`` triple) into an add lane and a tombstone lane; new
  vertices and removed vertices ride beside them.

- **Overlay view** (:class:`OverlayView`): the overlay in the base
  snapshot's index space, with pow2-tiered COO lanes, the reference's
  arrays exactly. For the MIN/MAX family, where a deleted edge's
  contribution cannot be subtracted, every destination with a tombstoned
  in-edge ("dirty row") re-aggregates its surviving base edges through a
  live lane. New vertices extend the domain in a pow2 ``vcap`` tier after
  the base rows, so base indices, packs and plans stay as they are.

- **Fused consumption** (:func:`fused_delta_aggregate`): the executor runs
  its base aggregation over the untouched base structures (messages
  sliced to the base rows), then merges the lanes::

    SUM:      out = base + segsum(adds) - segsum(tombstones)
    MIN/MAX:  out = op(where(dirty, seg_op(live), base), seg_op(adds))

  The MIN family equals a repacked CSR bit for bit (min is exact and
  order-free). SUM equals the reference's numpy replay oracle bit for bit:
  each SUM lane is stably sorted by destination once (:func:`device_lanes`)
  and summed in that order, scalar lanes through the segment-sum kernel
  (``olap/kernels.py``), ``[n, d]`` lanes through ``fold_rows``; both add
  each destination's cells in lane order, which is ``np.add.at``'s order,
  with no atomics, so the card gives the same bits on every run.

- **Materialization** (:func:`materialize`): the overlay folded into fresh
  CSR arrays with the canonical edge layout of a fresh load, from the
  records alone.

- **Warm snapshot** (:class:`DeltaSnapshot`, one per graph through
  :func:`get_snapshot`): the base CSR, the capture epoch it covers and the
  executors built over it. ``GraphComputer.submit()`` acquires it: a cold
  snapshot scans the store once; afterwards a submit reads only the
  pending overlay ("warm" with none, "fused" below
  ``computer.delta-max-overlay``, "refresh" above it, which folds the
  overlay into a new base with ``materialize``, zero store reads). The
  overlay is compacted into the base after a run once it crosses
  ``autotune.decide_delta``'s threshold for the card (or
  ``computer.delta-compact-threshold``), saved with tmp+rename when
  ``computer.delta-snapshot-path`` is set. A new base drops the cached
  executors and their device packs.

The capture, the snapshot and the executor cache count into the
telemetry registry under the reference's names (``olap.delta.*``,
``olap.executor.cache_*``) and a compaction records a ``delta_compact``
flight event. The sharded routing is the reference's: ``route_overlay`` /
``route_for_host`` partition the overlay's records by the shard that owns
their destination rows, and ``replay_fused_aggregate`` is the fused
merge's numpy replay.
"""

from __future__ import annotations

import os
import struct
import tempfile
import threading
import time
import zipfile
from collections import deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from janusgraph_tpu_torch.core.codecs import EDGE_COL_FIXED, Direction
from janusgraph_tpu_torch.observability import flight_recorder, registry
from janusgraph_tpu_torch.olap import kernels
from janusgraph_tpu_torch.olap.csr import CSRGraph, csr_from_edges, graph_codec_schema
from janusgraph_tpu_torch.olap.vertex_program import Combiner, VertexProgram

#: bits of a graph id (``janusgraph_tpu/core/ids.py``'s ``TOTAL_BITS``)
TOTAL_BITS = 63


def overlay_tier(n: int) -> int:
    """The pow2 capacity tier of ``n`` cells or vertices (0 = none)."""
    if n <= 0:
        return 0
    return 1 << max(0, int(n) - 1).bit_length()


# ---------------------------------------------------------------------------
# Change capture
# ---------------------------------------------------------------------------

class ChangeCapture:
    """Bounded per-graph ring of committed graph-structure deltas.

    Fed from ``BackendTransaction.commit`` (through ``Backend.
    register_change_capture``) with each committed edgestore batch, under
    the backend's epoch lock, so batches append in epoch order. Consumers
    call :meth:`slice_since`; None means the capture cannot serve that
    epoch (the ring dropped past it, or a cell resisted decoding) and the
    caller must reload in full. ``decode_s`` sums the decode time and
    ``poisoned`` counts the batches that failed to decode."""

    def __init__(self, graph, limit: int = 1 << 16):
        self.graph = graph
        self.limit = int(limit)
        self._lock = threading.Lock()
        self._batches: deque = deque()  # graphlint: disable=JG206 -- bounded by the record-count prune below (limit records, oldest batches dropped on overflow)
        self._count = 0
        #: records with epoch <= floor may have been dropped or undecodable
        self._floor = 0
        #: sinks fed every decoded batch as fn(epoch, batch), poison as
        #: fn(epoch, None)
        self._sinks: List = []
        self.decode_s = 0.0
        self.poisoned = 0

    def add_sink(self, fn) -> None:
        """Register a ``fn(epoch, batch_or_None)`` sink. Sinks ride the
        commit path, so their failures are swallowed: neither the capture
        nor the commit fails because a sink did."""
        with self._lock:
            self._sinks.append(fn)

    def _feed_sinks(self, epoch: int, batch: Optional[dict]) -> None:
        for fn in self._sinks:
            try:
                fn(epoch, batch)
            except Exception:  # noqa: BLE001 - never fail a commit
                registry.counter("olap.delta.sink_errors").inc()

    # -- write side ---------------------------------------------------------
    def on_commit(self, epoch: int, edge_rows: Dict[bytes, object]) -> None:
        """Called with the committed edgestore row mutations."""
        t0 = time.perf_counter()
        try:
            batch = self._decode(edge_rows)
        except Exception:  # noqa: BLE001 - capture must never fail a commit
            batch = None
        with self._lock:
            self.decode_s += time.perf_counter() - t0
            if batch is None:
                # poison: snapshots at or before this epoch cannot be
                # served incrementally any more
                self._batches.clear()
                self._count = 0
                self._floor = epoch
                self.poisoned += 1
                registry.counter("olap.delta.capture_poisoned").inc()
                self._feed_sinks(epoch, None)
                return
            if not batch["n"]:
                return
            self._batches.append((epoch, batch))
            self._count += batch["n"]
            while self._count > self.limit and self._batches:
                e0, b0 = self._batches.popleft()
                self._count -= b0["n"]
                self._floor = e0
            self._feed_sinks(epoch, batch)

    def _decode(self, edge_rows) -> dict:
        """One committed batch -> vid-space record arrays. Raises where a
        cell resists classification (on_commit then poisons the ring)."""
        g = self.graph
        idm = g.idm
        st = g.system_types
        es = g.edge_serializer
        relidx = g.relation_index_ids
        unpack_tid = struct.Struct(">Q").unpack_from

        add_cols: List[bytes] = []
        add_vids: List[int] = []
        del_cols: List[bytes] = []
        del_vids: List[int] = []
        slow_add: List[Tuple[int, int, int]] = []
        slow_del: List[Tuple[int, int, int]] = []
        v_add: Dict[int, int] = {}
        v_del: List[int] = []

        def _slow(vid, col, val):
            rc = es.parse_relation((col, val), graph_codec_schema(g))
            if not rc.is_edge or rc.direction != Direction.OUT:
                return None
            if rc.type_id in relidx:
                return None
            return (vid, int(rc.other_vertex_id), int(rc.type_id))

        for key, m in edge_rows.items():
            vid = idm.get_vertex_id(key)
            if not idm.is_user_vertex_id(vid):
                continue
            vid = idm.get_canonical_vertex_id(vid)
            for entry in m.additions:
                col, val = entry[0], entry[1]
                cat = col[0]
                if cat == 3:
                    if len(col) == EDGE_COL_FIXED:
                        add_cols.append(col)
                        add_vids.append(vid)
                    else:
                        t = _slow(vid, col, val)
                        if t is not None:
                            slow_add.append(t)
                elif cat == 0:
                    if unpack_tid(col, 1)[0] == st.EXISTS:
                        v_add.setdefault(vid, 0)
                elif cat == 2:
                    if unpack_tid(col, 1)[0] == st.VERTEX_LABEL_EDGE:
                        rc = es.parse_relation((col, val), st.type_info)
                        v_add[vid] = int(rc.other_vertex_id)
            for col in m.deletions:
                cat = col[0]
                if cat == 3:
                    if len(col) == EDGE_COL_FIXED:
                        del_cols.append(col)
                        del_vids.append(vid)
                    else:
                        # a deletion carries no value; the OUT-edge identity
                        # fields all live in the column
                        t = _slow(vid, col, b"")
                        if t is not None:
                            slow_del.append(t)
                elif cat == 0:
                    if unpack_tid(col, 1)[0] == st.EXISTS:
                        v_del.append(vid)

        def _bulk(cols, vids, slow):
            if cols:
                tids, dirs, others, _rels = es.bulk_decode_edges(cols)
                owner = np.asarray(vids, dtype=np.int64)
                mask = dirs == int(Direction.OUT)
                if relidx:
                    mask &= ~np.isin(tids, np.fromiter(relidx, dtype=np.int64))
                src, dst, et = owner[mask], others[mask], tids[mask]
            else:
                src = dst = et = np.empty(0, np.int64)
            if slow:
                s = np.asarray(slow, dtype=np.int64).reshape(-1, 3)
                src = np.concatenate([src, s[:, 0]])
                dst = np.concatenate([dst, s[:, 1]])
                et = np.concatenate([et, s[:, 2]])
            return (
                np.asarray(src, dtype=np.int64),
                np.asarray(dst, dtype=np.int64),
                np.asarray(et, dtype=np.int64),
            )

        a_src, a_dst, a_et = _bulk(add_cols, add_vids, slow_add)
        d_src, d_dst, d_et = _bulk(del_cols, del_vids, slow_del)
        return {
            "n": len(a_src) + len(d_src) + len(v_add) + len(v_del),
            "add": (a_src, a_dst, a_et),
            "del": (d_src, d_dst, d_et),
            "v_add": dict(v_add),
            "v_del": list(v_del),
        }

    # -- read side ----------------------------------------------------------
    def records_since(self, epoch: int) -> Optional[List[dict]]:
        with self._lock:
            if epoch < self._floor:
                return None
            return [b for e, b in self._batches if e > epoch]

    def slice_since(self, epoch: int) -> Optional[Tuple[List[dict], int]]:
        """(batches past ``epoch``, anchor epoch): the anchor is the last
        epoch actually consumed, so a consumer that re-anchors there never
        applies a record committed during the read twice."""
        with self._lock:
            if epoch < self._floor:
                return None
            batches = [(e, b) for e, b in self._batches if e > epoch]
            upto = max((e for e, _ in batches), default=epoch)
            return [b for _, b in batches], upto

    def depth_since(self, epoch: int) -> Optional[int]:
        """Pending record count past ``epoch`` (None = cannot serve)."""
        with self._lock:
            if epoch < self._floor:
                return None
            return sum(b["n"] for e, b in self._batches if e > epoch)


# ---------------------------------------------------------------------------
# Delta overlay (vid space)
# ---------------------------------------------------------------------------

@dataclass
class DeltaOverlay:
    """Netted graph-structure delta in graph-id space: the multiset
    difference between the live graph and a base snapshot."""

    #: net edge additions, one row per surviving instance
    add: np.ndarray          # (a, 3) int64 (src vid, dst vid, type id)
    #: net edge deletions against the base multiset
    tomb: np.ndarray         # (t, 3) int64
    new_vertices: Dict[int, int] = field(default_factory=dict)
    removed: frozenset = frozenset()

    @property
    def size(self) -> int:
        return len(self.add) + len(self.tomb) + len(self.new_vertices) + len(self.removed)

    @classmethod
    def from_batches(cls, batches: List[dict]) -> "DeltaOverlay":
        """Net change batches (``{"add": (src, dst, type), "del": (...),
        "v_add": {vid: label}, "v_del": [vid]}``, in commit order): counts
        of adds minus deletes per (src, dst, type) triple, positive nets
        the add lane, negative nets the tombstone lane; the last vertex
        record of each vertex wins."""

        def _stack(parts):
            if not parts or not any(len(p[0]) for p in parts):
                return np.empty((0, 3), dtype=np.int64)
            return np.stack([np.concatenate([p[i] for p in parts]) for i in range(3)], axis=1)

        a = _stack([b["add"] for b in batches])
        d = _stack([b["del"] for b in batches])
        if len(a) or len(d):
            uni, inv = np.unique(np.concatenate([a, d]), axis=0, return_inverse=True)
            inv = inv.reshape(-1)
            cnt = np.bincount(inv[: len(a)], minlength=len(uni)).astype(np.int64) - np.bincount(
                inv[len(a):], minlength=len(uni)
            )
            net_add = np.repeat(uni[cnt > 0], cnt[cnt > 0], axis=0)
            net_del = np.repeat(uni[cnt < 0], -cnt[cnt < 0], axis=0)
        else:
            net_add = net_del = np.empty((0, 3), dtype=np.int64)
        vfinal: Dict[int, Optional[int]] = {}
        for b in batches:
            for vid, label in b["v_add"].items():
                vfinal[vid] = label
            for vid in b["v_del"]:
                vfinal[vid] = None
        return cls(
            add=net_add, tomb=net_del,
            new_vertices={vid: lab for vid, lab in vfinal.items() if lab is not None},
            removed=frozenset(vid for vid, lab in vfinal.items() if lab is None),
        )


def overlay_since(graph, epoch: int) -> Optional[Tuple[DeltaOverlay, int]]:
    """(pending overlay past ``epoch``, anchor epoch) from the graph's
    change capture, or None when it cannot serve it (disabled, overflow,
    poisoned decode)."""
    cap = getattr(graph, "change_capture", None)
    if cap is None:
        return None
    sl = cap.slice_since(epoch)
    if sl is None:
        return None
    batches, upto = sl
    return DeltaOverlay.from_batches(batches), upto


# ---------------------------------------------------------------------------
# Materialization: overlay -> new CSR arrays
# ---------------------------------------------------------------------------

def _key_rank(idm, vertex_ids: np.ndarray) -> np.ndarray:
    """Per-vertex rank in store-key order (partition-prefixed row keys):
    the order an ordered scan visits rows in. ``idm`` is any object with
    ``partition_bits``."""
    vids = np.asarray(vertex_ids, dtype=np.int64)
    pb = idm.partition_bits
    partition = (vids >> 3) & ((1 << pb) - 1)
    rest = ((vids >> (3 + pb)) << 3) | (vids & 0b111)
    key_int = (partition.astype(np.uint64) << np.uint64(TOTAL_BITS - pb)) | rest.astype(np.uint64)
    rank = np.empty(len(vids), dtype=np.int64)
    rank[np.argsort(key_int, kind="stable")] = np.arange(len(vids))
    return rank


def _untombstoned(dst_vid: np.ndarray, et: np.ndarray, out_indptr: np.ndarray,
                  vids: np.ndarray, tomb: np.ndarray) -> np.ndarray:
    """Keep-mask of the base edges (out-CSR order) after the multiset
    subtraction: each distinct tombstone triple drops the first ``count``
    base instances of itself, in edge order (parallel edges are
    count-equivalent). The reference tokenizes every edge triple to find
    them; only the tombstoned source rows are searched here, with the same
    result."""
    keep = np.ones(len(dst_vid), dtype=bool)
    uni, counts = np.unique(np.asarray(tomb, dtype=np.int64), axis=0, return_counts=True)
    rows = np.searchsorted(vids, uni[:, 0])
    for (s, d, t), c, r in zip(uni, counts, rows):
        if r >= len(vids) or vids[r] != s:
            continue
        lo, hi = int(out_indptr[r]), int(out_indptr[r + 1])
        hit = np.nonzero((dst_vid[lo:hi] == d) & (et[lo:hi] == t))[0][: int(c)]
        keep[lo + hit] = False
    return keep


def _edge_order(src_key: np.ndarray, et: np.ndarray, di: np.ndarray, n: int) -> np.ndarray:
    """``np.lexsort((di, et, src_key))``: one stable argsort of a combined
    int64 key where (source, type, destination) fit in 63 bits, the
    lexsort otherwise. Both keep equal keys in input order."""
    if not len(di):
        return np.zeros(0, dtype=np.int64)
    lo = int(et.min())
    span = int(et.max()) - lo + 1
    if n * n * span >= (1 << 63):
        return np.lexsort((di, et, src_key))
    key = (src_key.astype(np.int64) * span + (et - lo)) * n + di
    return np.argsort(key, kind="stable")


def materialize(csr: CSRGraph, overlay: DeltaOverlay, idm=None) -> CSRGraph:
    """Fold the overlay into fresh CSR arrays with the canonical edge
    layout of a full reload, from the records alone. With ``idm`` the
    merged edges sort in store-key scan order (the source row's key rank,
    then type, then destination); without it, in source-index order.
    Unfiltered, weightless snapshots only."""
    if csr.in_edge_weight is not None or csr.properties:
        raise ValueError(
            "delta materialize supports unfiltered snapshots without "
            "materialized properties/weights"
        )
    vids = csr.vertex_ids
    removed = overlay.removed
    extra = np.setdiff1d(
        np.fromiter(overlay.new_vertices.keys(), dtype=np.int64, count=len(overlay.new_vertices)),
        vids,
    ) if overlay.new_vertices else np.empty(0, np.int64)
    keep_v = (
        ~np.isin(vids, np.fromiter(removed, dtype=np.int64))
        if removed else np.ones(len(vids), dtype=bool)
    )
    vertex_ids = np.unique(np.concatenate([vids[keep_v], extra]))
    n = len(vertex_ids)

    # base edges as base indices (out-CSR order), minus the tombstoned
    src_b = np.repeat(np.arange(len(vids), dtype=np.int64), np.diff(csr.out_indptr))
    dst_b = csr.out_dst.astype(np.int64)
    et = (
        csr.out_edge_type.astype(np.int64)
        if csr.out_edge_type is not None else np.zeros(len(src_b), dtype=np.int64)
    )
    if len(overlay.tomb):
        keep = _untombstoned(vids[dst_b], et, csr.out_indptr, vids, overlay.tomb)
        src_b, dst_b, et = src_b[keep], dst_b[keep], et[keep]
    # each base vertex's index among the merged vertices (a removed one is
    # not there); the added edges' ends are looked up by id
    pos = np.searchsorted(vertex_ids, vids)
    present = (pos < n) & (vertex_ids[np.minimum(pos, n - 1)] == vids)
    si, di = pos[src_b], pos[dst_b]
    valid = present[src_b] & present[dst_b]
    if len(overlay.add):
        a_si = np.searchsorted(vertex_ids, overlay.add[:, 0])
        a_di = np.searchsorted(vertex_ids, overlay.add[:, 1])
        a_ok = (
            (a_si < n) & (a_di < n)
            & (vertex_ids[np.minimum(a_si, n - 1)] == overlay.add[:, 0])
            & (vertex_ids[np.minimum(a_di, n - 1)] == overlay.add[:, 1])
        )
        si, di = np.concatenate([si, a_si]), np.concatenate([di, a_di])
        valid = np.concatenate([valid, a_ok])
        et = np.concatenate([et, overlay.add[:, 2]])
    si = si[valid].astype(np.int32)
    di = di[valid].astype(np.int32)
    et = et[valid]
    # the fresh load's global edge order: rows in store-key order, and both
    # derived CSRs inherit it through build_csr's stable sorts
    src_key = _key_rank(idm, vertex_ids)[si] if idm is not None else si
    order = _edge_order(src_key, et, di, n)
    si, di, et = si[order], di[order], et[order]

    labels = None
    if csr.labels is not None or overlay.new_vertices:
        labels = np.zeros(n, dtype=np.int64)
        if csr.labels is not None:
            labels[pos[present]] = csr.labels[present]
        for vid, lid in overlay.new_vertices.items():
            i = int(np.searchsorted(vertex_ids, vid))
            if i < n and vertex_ids[i] == vid:
                labels[i] = lid

    has_et = csr.out_edge_type is not None or len(overlay.add)
    out = csr_from_edges(n, si, di, edge_types=et.astype(np.int32) if has_et else None)
    out.vertex_ids = vertex_ids
    out.labels = labels
    return out


# ---------------------------------------------------------------------------
# Overlay view (index space)
# ---------------------------------------------------------------------------

class OverlayView:
    """The overlay in the base snapshot's index space, with pow2-tiered
    lane capacities.

    Domain layout (base indices stay stable so device packs are reused):
      [0, n_base)              base snapshot rows
      [n_base, n_base+n_extra) new vertices, in sorted-vid order
      [n_real, n_pad)          padding up to the vcap tier (inactive)
    """

    def __init__(self, csr: CSRGraph, overlay: DeltaOverlay, max_lane_cells: int = 1 << 16):
        self.csr = csr
        self.overlay = overlay
        vids = csr.vertex_ids
        nb = len(vids)
        self.n_base = nb
        extra = np.setdiff1d(
            np.fromiter(overlay.new_vertices.keys(), dtype=np.int64, count=len(overlay.new_vertices)),
            vids,
        ) if overlay.new_vertices else np.empty(0, np.int64)
        self.extra_ids = extra
        self.n_extra = len(extra)
        self.n_real = nb + self.n_extra
        self.vcap = overlay_tier(self.n_extra)
        self.n_pad = nb + self.vcap
        self.vertex_ids = np.concatenate([vids, extra])

        def _idx(v):
            """vid array -> fused index (or -1 when unknown)."""
            v = np.asarray(v, dtype=np.int64)
            i = np.searchsorted(vids, v)
            base_ok = (i < nb) & (vids[np.minimum(i, nb - 1)] == v)
            out = np.where(base_ok, i, -1)
            if self.n_extra:
                j = np.searchsorted(extra, v)
                ex_ok = (j < self.n_extra) & (extra[np.minimum(j, self.n_extra - 1)] == v)
                out = np.where(ex_ok & ~base_ok, nb + j, out)
            return out.astype(np.int64)

        a = overlay.add
        asrc = _idx(a[:, 0]) if len(a) else np.empty(0, np.int64)
        adst = _idx(a[:, 1]) if len(a) else np.empty(0, np.int64)
        ok = (asrc >= 0) & (adst >= 0)
        self.add_src = asrc[ok]
        self.add_dst = adst[ok]
        self.add_et = a[ok, 2] if len(a) else np.empty(0, np.int64)
        t = overlay.tomb
        tsrc = _idx(t[:, 0]) if len(t) else np.empty(0, np.int64)
        tdst = _idx(t[:, 1]) if len(t) else np.empty(0, np.int64)
        tok = (tsrc >= 0) & (tdst >= 0) & (tsrc < nb) & (tdst < nb)
        self.tomb_src = tsrc[tok]
        self.tomb_dst = tdst[tok]
        rm = (
            _idx(np.fromiter(overlay.removed, dtype=np.int64, count=len(overlay.removed)))
            if overlay.removed else np.empty(0, np.int64)
        )
        self.removed_idx = rm[(rm >= 0) & (rm < nb)]
        self.max_lane_cells = int(max_lane_cells)
        #: the capture epoch the overlay reaches (set by DeltaSnapshot)
        self.upto_epoch: Optional[int] = None
        self._lanes: Dict[bool, Optional[dict]] = {}
        self._device: Dict[Tuple, dict] = {}
        self._fused_degrees = None

    def fused_degrees(self):
        """(out_degree, in_degree, active) over [0, n_pad): base degrees
        patched by the lanes, extras from the add lane, padding zero —
        the repacked CSR's degrees."""
        if self._fused_degrees is not None:
            return self._fused_degrees
        csr = self.csr
        nb, npad = self.n_base, self.n_pad
        outd = np.zeros(npad, dtype=np.int64)
        ind = np.zeros(npad, dtype=np.int64)
        outd[:nb] = np.diff(csr.out_indptr)
        ind[:nb] = np.diff(csr.in_indptr)
        np.subtract.at(outd, self.tomb_src, 1)
        np.subtract.at(ind, self.tomb_dst, 1)
        np.add.at(outd, self.add_src, 1)
        np.add.at(ind, self.add_dst, 1)
        active = np.zeros(npad, dtype=np.float64)
        active[: self.n_real] = 1.0
        if len(self.removed_idx):
            active[self.removed_idx] = 0.0
        self._fused_degrees = (
            np.maximum(outd, 0).astype(np.int32),
            np.maximum(ind, 0).astype(np.int32),
            active,
        )
        return self._fused_degrees

    @property
    def num_edges_real(self) -> int:
        return self.csr.num_edges - len(self.tomb_src) + len(self.add_src)

    @property
    def num_vertices_real(self) -> int:
        return self.n_real - len(self.removed_idx)

    @property
    def depth(self) -> int:
        return self.overlay.size

    def lanes(self, undirected: bool) -> Optional[dict]:
        """Padded COO lanes for one aggregation orientation (the in-CSR
        view, or the symmetric closure when ``undirected``); None where the
        lanes would exceed ``max_lane_cells`` (a tombstoned hub row makes
        the live lane O(degree)) — the caller materializes instead."""
        if undirected not in self._lanes:
            self._lanes[undirected] = self._build_lanes(undirected)
        return self._lanes[undirected]

    def _build_lanes(self, undirected: bool) -> Optional[dict]:
        csr = self.csr
        npad = self.n_pad
        a_src, a_dst = self.add_src, self.add_dst
        t_src, t_dst = self.tomb_src, self.tomb_dst
        if undirected:
            a_src = np.concatenate([a_src, self.add_dst])
            a_dst = np.concatenate([a_dst, self.add_src])
            t_src = np.concatenate([t_src, self.tomb_dst])
            t_dst = np.concatenate([t_dst, self.tomb_src])

        # MIN-family dirty rows re-aggregate their surviving base edges
        # through the live lane (adds ride the add lane; min(x, x) = x
        # makes the double merge of adds into a dirty row exact)
        dirty_rows = np.unique(t_dst)
        live_src_parts: List[np.ndarray] = []
        live_dst_parts: List[np.ndarray] = []
        in_indptr, in_src = csr.in_indptr, csr.in_src
        out_indptr, out_dst = csr.out_indptr, csr.out_dst

        def _survivors(srcs, rm):
            """Base neighbours minus the tombstoned multiset (one removal per
            tombstone instance)."""
            if not len(rm):
                return np.asarray(srcs, dtype=np.int64)
            srcs = np.sort(np.asarray(srcs, dtype=np.int64))
            keep = np.ones(len(srcs), dtype=bool)
            vals, cnts = np.unique(np.asarray(rm, dtype=np.int64), return_counts=True)
            for v, c in zip(vals, cnts):
                lo = int(np.searchsorted(srcs, v, side="left"))
                hi = int(np.searchsorted(srcs, v, side="right"))
                keep[lo: min(hi, lo + int(c))] = False
            return srcs[keep]

        if len(dirty_rows):
            order = np.argsort(t_dst, kind="stable")
            td_sorted = t_dst[order]
            ts_sorted = t_src[order]
            bounds = np.searchsorted(td_sorted, dirty_rows, side="left")
            bounds_hi = np.searchsorted(td_sorted, dirty_rows, side="right")
            for r, lo, hi in zip(dirty_rows, bounds, bounds_hi):
                r = int(r)
                rm = ts_sorted[lo:hi]
                neigh = in_src[in_indptr[r]: in_indptr[r + 1]].astype(
                    np.int64
                ) if r < self.n_base else np.empty(0, np.int64)
                if undirected and r < self.n_base:
                    # symmetric closure: the row's out-neighbours too
                    neigh = np.concatenate([
                        neigh, out_dst[out_indptr[r]: out_indptr[r + 1]].astype(np.int64),
                    ])
                surv = _survivors(neigh, rm)
                live_src_parts.append(surv)
                live_dst_parts.append(np.full(len(surv), r, dtype=np.int64))
        live_src = np.concatenate(live_src_parts) if live_src_parts else np.empty(0, np.int64)
        live_dst = np.concatenate(live_dst_parts) if live_dst_parts else np.empty(0, np.int64)

        acap = overlay_tier(len(a_src))
        tcap = overlay_tier(len(t_src))
        lcap = overlay_tier(len(live_src))
        if acap + tcap + lcap > self.max_lane_cells:
            return None

        def _pad(arr, cap):
            out = np.full(cap, npad, dtype=np.int32)  # sentinel = n_pad
            out[: len(arr)] = arr
            return out

        dirty = np.zeros(npad, dtype=np.float32)
        if len(dirty_rows):
            dirty[dirty_rows] = 1.0
        return {
            "add_src": _pad(a_src, acap),
            "add_dst": _pad(a_dst, acap),
            "tomb_src": _pad(t_src, tcap),
            "tomb_dst": _pad(t_dst, tcap),
            "live_src": _pad(live_src, lcap),
            "live_dst": _pad(live_dst, lcap),
            "dirty": dirty,
            "_meta": {"n_base": self.n_base, "n_pad": npad, "acap": acap, "tcap": tcap, "lcap": lcap},
        }

    def sig(self, undirected: bool) -> Optional[Tuple]:
        """The lanes' static signature (part of the fused loops' keys), or
        None where the lanes overflow."""
        lanes = self.lanes(undirected)
        if lanes is None:
            return None
        m = lanes["_meta"]
        return (m["n_base"], m["n_pad"], m["acap"], m["tcap"], m["lcap"], bool(undirected))

    # graphlint: host -- cached per device and orientation: moved on the eager first superstep; a capture only reads it
    def device_args(self, device, undirected: bool) -> Optional[dict]:
        """The lanes as the merge reads them on ``device`` (``device_lanes``),
        built and moved once per device and orientation."""
        key = (str(device), bool(undirected))
        cached = self._device.get(key)
        if cached is None:
            lanes = self.lanes(undirected)
            if lanes is None:
                return None
            cached = device_lanes(lanes, self.n_pad, device)
            self._device[key] = cached
        return cached


#: the lanes each monoid family merges: SUM adds and subtracts, MIN/MAX
#: re-aggregate dirty rows from the live lane
_SORTED_LANES = ("add", "tomb")


def device_lanes(lanes: dict, n_pad: int, device) -> dict:
    """Padded numpy lanes (``OverlayView.lanes``' layout) as tensors on
    ``device``, the form ``fused_delta_aggregate`` reads: cells whose
    destination is the sentinel ``n_pad`` dropped; the add and tombstone
    lanes stably sorted by destination, with a segment-sum plan over the
    n_pad destinations (scalar SUM messages) and a fold matrix over the
    destinations they reach (``[n, d]`` SUM messages); the live lane as it
    is; ``dirty`` as float32. The plans' kernel arrays move to the device
    here, never inside a CUDA graph capture."""
    dev = torch.device(device)
    out = {"n_pad": int(n_pad), "dirty": torch.as_tensor(
        np.asarray(lanes["dirty"], dtype=np.float32), device=dev)}
    for lane in _SORTED_LANES + ("live",):
        src = np.asarray(lanes[f"{lane}_src"], dtype=np.int64)
        dst = np.asarray(lanes[f"{lane}_dst"], dtype=np.int64)
        keep = dst < n_pad
        src, dst = src[keep], dst[keep]
        if lane in _SORTED_LANES:
            order = np.argsort(dst, kind="stable")
            src, dst = src[order], dst[order]
            plan = kernels.make_segsum_plan(dst, n_pad)
            if dev.type == "cuda":
                plan.device_arrays(dev)
            rows, rowseg = np.unique(dst, return_inverse=True)
            out[f"{lane}_plan"] = plan
            out[f"{lane}_rows"] = torch.as_tensor(rows, device=dev)
            out[f"{lane}_fold"] = torch.as_tensor(
                kernels.row_fold_matrix(rowseg.reshape(-1), len(rows)), device=dev)
        out[f"{lane}_src"] = torch.as_tensor(src, device=dev)
        out[f"{lane}_dst"] = torch.as_tensor(dst, device=dev)
    return out


def _lane_sum(lanes: dict, lane: str, msgs_ext: torch.Tensor) -> torch.Tensor:
    """One sorted SUM lane's per-destination sums over [0, n_pad), each
    destination's cells added in lane order."""
    cells = torch.index_select(msgs_ext, 0, lanes[f"{lane}_src"])
    if cells.ndim == 1:
        return kernels.sorted_segment_sum(cells, lanes[f"{lane}_plan"])
    part = kernels.fold_rows(Combiner.SUM, cells, lanes[f"{lane}_fold"])
    out = torch.zeros((lanes["n_pad"],) + tuple(cells.shape[1:]), dtype=cells.dtype,
                      device=cells.device)
    return out.index_copy_(0, lanes[f"{lane}_rows"], part)


def fused_delta_aggregate(lanes: dict, outgoing: torch.Tensor, base_agg: torch.Tensor,
                          op: str) -> torch.Tensor:
    """Merge the delta lanes (``device_lanes``) into a base aggregation:
    SUM adds the add lane and subtracts the tombstone lane, MIN/MAX replace
    dirty rows by the live lane's fold and then take the add lane in.
    ``outgoing`` is the messages over the whole [0, n_pad) domain,
    ``base_agg`` the base rows' aggregate; returns (n_pad,) or (n_pad, d)."""
    identity = Combiner.IDENTITY[op]
    npad = lanes["n_pad"]
    rest = tuple(base_agg.shape[1:])
    tail = npad - base_agg.shape[0]
    base = base_agg
    if tail:
        base = torch.cat([base_agg, torch.full((tail,) + rest, identity, dtype=base_agg.dtype,
                                                device=base_agg.device)], dim=0)
    # the sentinel row: a lane cell whose source is n_pad gathers the identity
    msgs_ext = torch.cat([outgoing, torch.full((1,) + tuple(outgoing.shape[1:]), identity,
                                               dtype=outgoing.dtype, device=outgoing.device)])
    if op == Combiner.SUM:
        return base + _lane_sum(lanes, "add", msgs_ext) - _lane_sum(lanes, "tomb", msgs_ext)

    def fold(lane):
        cells = torch.index_select(msgs_ext, 0, lanes[f"{lane}_src"])
        return kernels.segment_combine(op, cells, lanes[f"{lane}_dst"], npad)

    add, live = fold("add"), fold("live")
    dirty = lanes["dirty"]
    if base.ndim == 2:
        dirty = dirty[:, None]
    merged = torch.where(dirty > 0, live, base)
    if op == Combiner.MIN:
        return torch.minimum(merged, add)
    return torch.maximum(merged, add)


def _np_segment_combine(op: str, values: np.ndarray, seg: np.ndarray, n: int) -> np.ndarray:
    out = np.full((n,) + values.shape[1:], Combiner.IDENTITY[op], dtype=values.dtype)
    if op == Combiner.SUM:
        np.add.at(out, seg, values)
    elif op == Combiner.MIN:
        np.minimum.at(out, seg, values)
    else:
        np.maximum.at(out, seg, values)
    return out


def replay_fused_aggregate(lanes: dict, meta: Optional[dict], outgoing: np.ndarray,
                           base_agg: np.ndarray, op: str) -> np.ndarray:
    """The numpy replay of the fused merge over the padded lanes
    (``OverlayView.lanes``' layout; ``meta`` defaults to their ``_meta``):
    the reference's ``fused_delta_aggregate`` with numpy, every lane folded
    by ``np.<ufunc>.at`` in lane order. ``fused_delta_aggregate`` on the
    CPU meets it to float tolerance for SUM (its lanes sum through the
    sorted segment sum) and exactly for MIN/MAX."""
    meta = lanes["_meta"] if meta is None else meta
    identity = Combiner.IDENTITY[op]
    npad = meta["n_pad"]
    tail = npad - base_agg.shape[0]
    base = base_agg
    if tail:
        pad = np.full((tail,) + tuple(base_agg.shape[1:]), identity, dtype=base_agg.dtype)
        base = np.concatenate([base_agg, pad], axis=0)
    # sentinel slot: padded lane entries gather the identity and scatter
    # into the dropped row npad
    msgs_ext = np.concatenate(
        [outgoing, np.full((1,) + tuple(outgoing.shape[1:]), identity, dtype=outgoing.dtype)]
    )

    def fold(lane):
        return _np_segment_combine(
            op, msgs_ext[lanes[f"{lane}_src"]], lanes[f"{lane}_dst"], npad + 1
        )[:npad]

    add = fold("add")
    if op == Combiner.SUM:
        return base + add - fold("tomb")
    dirty = lanes["dirty"]
    if base.ndim == 2:
        dirty = dirty[:, None]
    merged = np.where(dirty > 0, fold("live"), base)
    if op == Combiner.MIN:
        return np.minimum(merged, add)
    return np.maximum(merged, add)


# ---------------------------------------------------------------------------
# Sharded routing (host_shard_range coupling)
# ---------------------------------------------------------------------------

def route_overlay(view: OverlayView, num_shards: int) -> List[dict]:
    """Partition the overlay's index-space records by OWNER SHARD of the
    aggregation-side (destination) row — the same contiguous ``dst // Np``
    coupling the sharded executor's layout and
    ``multihost.host_shard_range`` use, so a distributed refresh routes
    each record to the host that owns its rows."""
    Np = -(-max(view.n_pad, 1) // num_shards)
    out = []
    for s in range(num_shards):
        lo, hi = s * Np, (s + 1) * Np
        am = (view.add_dst >= lo) & (view.add_dst < hi)
        tm = (view.tomb_dst >= lo) & (view.tomb_dst < hi)
        out.append({
            "shard": s,
            "row_range": (lo, min(hi, view.n_pad)),
            "add_src": view.add_src[am],
            "add_dst": view.add_dst[am],
            "tomb_src": view.tomb_src[tm],
            "tomb_dst": view.tomb_dst[tm],
        })
    return out


def route_for_host(view: OverlayView, num_shards: int, process_id: Optional[int] = None,
                   num_processes: Optional[int] = None) -> dict:
    """The concatenated routed records of THIS host's shard span
    (``multihost.host_shard_range``): what a distributed snapshot refresh
    applies to its local blocks."""
    from janusgraph_tpu_torch.parallel.multihost import host_shard_range

    lo_s, hi_s = host_shard_range(num_shards, process_id, num_processes)
    routed = route_overlay(view, num_shards)[lo_s:hi_s]

    def cat(key):
        return np.concatenate([r[key] for r in routed]) if routed else np.empty(0, np.int64)

    return {
        "shards": (lo_s, hi_s),
        "add_src": cat("add_src"),
        "add_dst": cat("add_dst"),
        "tomb_src": cat("tomb_src"),
        "tomb_dst": cat("tomb_dst"),
    }


# ---------------------------------------------------------------------------
# Fused host view (program-facing graph facade over base + overlay)
# ---------------------------------------------------------------------------

class FusedHostView:
    """CSRGraph-shaped facade for a base snapshot + overlay: programs see
    the real vertex and edge counts and the fused degree/active arrays over
    the padded domain, while the base index arrays stay as they are for the
    base aggregation."""

    def __init__(self, view: OverlayView):
        self._ov = view
        csr = view.csr
        outd, ind, active = view.fused_degrees()
        self.num_vertices = view.num_vertices_real
        self.local_num_vertices = view.n_pad
        self.global_offset = 0
        self.num_edges = view.num_edges_real
        self.out_degree = outd
        self.in_degree = ind
        self.active = active
        self.vertex_ids = view.vertex_ids
        self.in_indptr = csr.in_indptr
        self.in_src = csr.in_src
        self.out_indptr = csr.out_indptr
        self.out_dst = csr.out_dst
        self.in_edge_weight = None
        self.out_edge_weight = None
        self.in_edge_type = csr.in_edge_type
        self.out_edge_type = csr.out_edge_type
        self.properties = {}
        self.labels = None

    def index_of(self, vid: int) -> int:
        i = np.nonzero(self._ov.vertex_ids == vid)[0]
        if not len(i):
            raise KeyError(f"vertex id {vid} not in fused snapshot")
        return int(i[0])

    def id_of(self, index: int) -> int:
        return int(self._ov.vertex_ids[index])


# ---------------------------------------------------------------------------
# Snapshot files (tmp + rename)
# ---------------------------------------------------------------------------

def save_snapshot(path: str, csr: CSRGraph, epoch: int) -> None:
    """Write the base snapshot as the reference's npz (written to a
    temporary file beside ``path``, then renamed over it)."""
    arrays = {
        "vertex_ids": csr.vertex_ids,
        "out_indptr": csr.out_indptr,
        "out_dst": csr.out_dst,
        "in_indptr": csr.in_indptr,
        "in_src": csr.in_src,
        "out_degree": csr.out_degree,
        "epoch": np.asarray(epoch, dtype=np.int64),
    }
    if csr.labels is not None:
        arrays["labels"] = csr.labels
    if csr.out_edge_type is not None:
        arrays["out_edge_type"] = csr.out_edge_type
        arrays["in_edge_type"] = csr.in_edge_type
    d = os.path.dirname(os.path.abspath(path)) or "."
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".npz.tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **arrays)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def load_snapshot(path: str) -> Optional[Tuple[CSRGraph, int]]:
    """(CSRGraph, epoch), or None where the file is missing or unreadable
    (a torn file is a cold start)."""
    if not os.path.exists(path):
        return None
    try:
        with np.load(path) as z:
            csr = CSRGraph(
                vertex_ids=z["vertex_ids"],
                out_indptr=z["out_indptr"],
                out_dst=z["out_dst"],
                in_indptr=z["in_indptr"],
                in_src=z["in_src"],
                out_degree=z["out_degree"],
                labels=z["labels"] if "labels" in z else None,
                in_edge_type=z["in_edge_type"] if "in_edge_type" in z else None,
                out_edge_type=z["out_edge_type"] if "out_edge_type" in z else None,
            )
            return csr, int(z["epoch"])
    except (OSError, ValueError, KeyError, EOFError, zipfile.BadZipFile):
        return None


# ---------------------------------------------------------------------------
# Warm snapshot + compaction
# ---------------------------------------------------------------------------

class DeltaSnapshot:
    """Per-graph warm snapshot: base CSR + capture epoch + compaction
    policy + the executors built over the base. ``GraphComputer.submit()``
    acquires it to skip the store scan."""

    def __init__(self, graph):
        self.graph = graph
        cfg = graph.config
        self.max_overlay = int(cfg.get("computer.delta-max-overlay"))
        self.max_lane_cells = int(cfg.get("computer.delta-max-lane-cells"))
        self.compact_threshold = int(cfg.get("computer.delta-compact-threshold"))
        self.snapshot_path = cfg.get("computer.delta-snapshot-path") or None
        self._lock = threading.RLock()
        self.csr = None
        self.epoch = -1
        self._decision = None
        #: base generation: bumped whenever ``csr`` is replaced (cold load,
        #: compaction, adopt) — the executor cache's invalidation edge
        self.generation = 0
        #: executors (device packs, plans, fused loops) over this base,
        #: keyed by (kind, device, constructor arguments); the overlay is
        #: not part of the key, a cached executor swaps it with set_delta
        self._executors: Dict[Tuple, object] = {}
        #: the last compaction: {"depth", "edges", "vertices", "wall_s",
        #: "threshold"} (None before the first)
        self.last_compaction: Optional[dict] = None

    # ------------------------------------------------------------- snapshot
    def acquire(self):
        """(csr, overlay view or None, info): the current base plus the
        pending overlay. A cold cache (or a capture that cannot serve the
        cached epoch) pays one full scan; afterwards every acquire reads
        only the capture. ``info["path"]`` is "cold", "warm" (no overlay),
        "fused" (an overlay to consume) or "refresh" (the overlay was
        deeper than ``computer.delta-max-overlay`` and folded into a new
        base), with the overlay's depth under "overlay"."""
        with self._lock:
            if self.csr is not None:
                got = overlay_since(self.graph, self.epoch)
                if got is None:
                    registry.counter("olap.delta.capture_overflow").inc()
                    self.csr = None  # fall through to the full load
                else:
                    overlay, upto = got
                    registry.set_gauge("olap.delta.overlay_depth", float(overlay.size))
                    if overlay.size == 0:
                        return self.csr, None, {"path": "warm", "overlay": 0}
                    view = OverlayView(self.csr, overlay, max_lane_cells=self.max_lane_cells)
                    view.upto_epoch = upto
                    if overlay.size > self.max_overlay:
                        # too deep to consume fused: fold into the base
                        # (still zero store reads)
                        self._compact(view)
                        return self.csr, None, {"path": "refresh", "overlay": overlay.size}
                    return self.csr, view, {"path": "fused", "overlay": overlay.size}
            from janusgraph_tpu_torch.olap.csr import load_csr_snapshot

            # the lock is held across the scan so concurrent submitters
            # share one load
            # graphlint: disable=JG403 -- single-repacker by design: acquire() holds _lock across the cold repack so concurrent submitters share ONE snapshot load instead of racing N repacks
            csr, epoch = load_csr_snapshot(self.graph)
            self._install(csr, epoch)
            registry.counter("olap.delta.packs").inc()
            registry.set_gauge("olap.delta.overlay_depth", 0.0)
            return self.csr, None, {"path": "cold", "overlay": 0}

    def adopt(self, csr, epoch: int) -> None:
        """Install an externally materialized base (submit()'s materialize
        branch) so the next acquire resumes from it."""
        with self._lock:
            self._install(csr, epoch)

    def _install(self, csr, epoch: int) -> None:
        """Replace the base (lock held): the generation bump drops every
        cached executor, whose device packs cover the old base."""
        self.csr = csr
        self.epoch = epoch
        self.generation += 1
        # graphlint: disable=JG401 -- every caller (acquire, adopt) holds self._lock per this method's contract ("lock held"); the analyzer cannot see caller-held locks
        self._executors.clear()

    def close(self) -> None:
        """Drop the base and the cached executors (graph.close())."""
        with self._lock:
            self.csr = None
            self.epoch = -1
            self._executors.clear()

    # ------------------------------------------------- warm executor cache
    def cached_executor(self, key: Tuple):
        """The executor stored under ``key`` for this base generation, or
        None."""
        with self._lock:
            ex = self._executors.get(key)
        if ex is not None:
            registry.counter("olap.executor.cache_hits").inc()
        return ex

    def store_executor(self, key: Tuple, ex, csr) -> None:
        """Cache a freshly built executor if it was built over the current
        base (a compaction between acquire and build leaves its device
        arrays stale; dropping it is the cheap correct answer)."""
        registry.counter("olap.executor.cache_misses").inc()
        with self._lock:
            if csr is self.csr:
                self._executors[key] = ex

    # ----------------------------------------------------------- compaction
    def _threshold(self) -> int:
        if self.compact_threshold:
            return self.compact_threshold
        if self._decision is None:
            from janusgraph_tpu_torch.olap import autotune

            kind = torch.cuda.get_device_name(0) if torch.cuda.is_available() else "cpu"
            self._decision = autotune.decide_delta(
                num_edges=self.csr.num_edges if self.csr is not None else 0,
                num_vertices=self.csr.num_vertices if self.csr is not None else 0,
                device_kind=kind,
            )
        return self._decision.compact_threshold

    def maybe_compact(self) -> bool:
        """Fold the pending overlay into the base once it crosses the
        threshold. Off the superstep path: submit() calls this after the
        run returns."""
        with self._lock:
            if self.csr is None:
                return False
            got = overlay_since(self.graph, self.epoch)
            if got is None or got[0].size == 0:
                return False
            overlay, upto = got
            if overlay.size < self._threshold():
                return False
            view = OverlayView(self.csr, overlay, max_lane_cells=self.max_lane_cells)
            view.upto_epoch = upto
            self._compact(view)
            return True

    def _compact(self, view: OverlayView) -> None:
        """Materialize base + overlay into a new base (zero store reads),
        anchored at the last epoch folded, so records committed meanwhile
        stay pending; saved with tmp+rename when a path is configured.
        Call under the lock."""
        t0 = time.perf_counter()
        depth = view.depth
        self._install(materialize(self.csr, view.overlay, idm=self.graph.idm), view.upto_epoch)
        wall_s = time.perf_counter() - t0
        self.last_compaction = {
            "depth": depth, "edges": self.csr.num_edges,
            "vertices": self.csr.num_vertices,
            "wall_s": wall_s, "threshold": self._threshold(),
        }
        registry.counter("olap.delta.compactions").inc()
        registry.set_gauge("olap.delta.overlay_depth", 0.0)
        flight_recorder.record(
            "delta_compact", depth=depth, edges=self.csr.num_edges,
            vertices=self.csr.num_vertices, wall_ms=round(wall_s * 1000.0, 3),
            threshold=self._threshold(),
        )
        if self.snapshot_path:
            try:
                save_snapshot(self.snapshot_path, self.csr, self.epoch)
            except OSError:
                pass  # persistence is best-effort, the base is in memory


def get_snapshot(graph) -> Optional[DeltaSnapshot]:
    """The graph's lazily created DeltaSnapshot (None when the graph has no
    change capture, i.e. computer.delta is off)."""
    if getattr(graph, "change_capture", None) is None:
        return None
    snap = getattr(graph, "_delta_snapshot", None)
    if snap is None:
        snap = DeltaSnapshot(graph)
        graph._delta_snapshot = snap
    return snap


# ---------------------------------------------------------------------------
# Results over the live vertex set
# ---------------------------------------------------------------------------

class ResultView:
    """Surviving vertex ids aligned row for row with compacted state
    arrays."""

    def __init__(self, vertex_ids: np.ndarray):
        self.vertex_ids = np.asarray(vertex_ids, dtype=np.int64)
        self._order = np.argsort(self.vertex_ids, kind="stable")
        self._sorted = self.vertex_ids[self._order]

    @property
    def num_vertices(self) -> int:
        return len(self.vertex_ids)

    @property
    def local_num_vertices(self) -> int:
        return len(self.vertex_ids)

    def index_of(self, vid: int) -> int:
        i = int(np.searchsorted(self._sorted, vid))
        if i >= len(self._sorted) or self._sorted[i] != vid:
            raise KeyError(f"vertex id {vid} not in snapshot")
        return int(self._order[i])

    def id_of(self, index: int) -> int:
        return int(self.vertex_ids[index])


def compact_result(view: OverlayView, states: Dict[str, np.ndarray]):
    """(states filtered to the surviving rows, ResultView): drops removed
    base slots from a delta run's output, so results cover the live vertex
    set a repacked run returns."""
    _outd, _ind, active = view.fused_degrees()
    mask = active[: view.n_real] > 0
    filtered = {k: np.asarray(v)[mask] for k, v in states.items()}
    return filtered, ResultView(view.vertex_ids[mask])


def program_delta_compatible(program) -> bool:
    """Whether a program can consume the overlay fused: the default edge
    view only (typed channels aggregate over packs the lanes do not patch)
    and no sddmm (its row destinations are laid out over the base)."""
    if getattr(program, "message_mode", None) == "sddmm":
        return False
    if getattr(program, "edge_channels", None):
        return False
    return type(program).channel_for is VertexProgram.channel_for
