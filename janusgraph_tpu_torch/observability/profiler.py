"""Roofline cost model, device peaks, resource ledger and flame export —
the port of the main-path half of ``janusgraph_tpu/observability/profiler.py``.

- **Device peaks** (``_DEVICE_PEAKS``, ``configure_roofline``,
  ``device_peaks``): the autotuner prices its layouts against them. The
  reference's TPU and CPU rows are kept as they are, so decisions for
  those kinds stay equal to the reference's; the port adds a row for the
  H100.
- **Roofline records**: every OLAP superstep record carries flops, bytes
  accessed, operational intensity and %-of-roofline utilization
  (``estimate_superstep_cost``, ``roofline_point``, ``attach_roofline``),
  and a dense program's records its matmul utilization (``attach_mxu``).
  The cost is always the host estimate (``cost_source: "estimate"``): the
  reference harvests XLA's ``cost_analysis()`` of the lowered superstep
  where it can, and the port lowers nothing.
- :class:`ResourceLedger` — a per-request cost accumulator carried on the
  ambient context (``ledger_scope``); ``accrue`` adds counters and
  annotates the current span with ``ledger.<field>``, ``accrue_wall``
  buckets walls by layer. Outside a scope both are no-ops. The ledger
  block codec (``encode_ledger_block``, ``split_ledger_block``) carries a
  per-op ledger over the remote store's wire, and ``merge_echo`` merges a
  peer's echo without annotating a span.
- **Query digests** (``traversal_shape``, ``shape_digest``,
  :class:`DigestTable`, the process-wide ``digest_table`` and
  ``digest_records``): every traversal execution is normalized to its
  shape (step vocabulary and access path, literals stripped) and feeds a
  bounded top-K table of measured walls, which the spillover planner's
  promotion reads. The price book that persists the table stays with the
  server (ROADMAP Queue A #5).
- **Flame export** (``flame_lines``, ``flame_text``): a trace's span trees
  as collapsed stacks (``frame;frame;frame weight_us``).

Host-only like the rest of the observability layer: nothing here runs
while a CUDA graph is being captured.
"""

from __future__ import annotations

import contextvars
import hashlib
import re
import struct
import threading
from collections import OrderedDict
from contextlib import contextmanager
from typing import Dict, List, Optional, Tuple

#: (device_kind substring, peak flops/s, peak memory bytes/s, peak matrix
#: flops/s). First match wins, on the lower-cased kind.
_DEVICE_PEAKS: Tuple[Tuple[str, float, float, float], ...] = (
    # NVIDIA H100 SXM (torch.cuda.get_device_name: "NVIDIA H100 80GB HBM3"),
    # data-sheet peaks at its 700 W limit: fp32 outside the tensor cores,
    # HBM3, and dense TF32 on the tensor cores as the matrix peak
    ("h100", 67e12, 3.35e12, 494.7e12),
    ("v5e", 197e12, 819e9, 197e12),
    ("v5p", 459e12, 2765e9, 459e12),
    ("v4", 275e12, 1228e9, 275e12),
    ("v3", 123e12, 900e9, 123e12),
    ("v2", 45e12, 700e9, 45e12),
    # CPU fallback: a generous server-class core count; what matters on the
    # CPU is the relative shape of the model, not its absolute truth
    ("cpu", 5e11, 5e10, 1e11),
)

#: rows that describe a GPU: the autotuner prices them with its "gpu"
#: constants
GPU_ROWS = ("h100",)

_ROOFLINE_OVERRIDE = {
    "peak_flops": 0.0, "peak_bytes_per_s": 0.0, "peak_mxu_flops": 0.0,
}


def configure_roofline(
    peak_flops: Optional[float] = None,
    peak_bytes_per_s: Optional[float] = None,
    peak_mxu_flops: Optional[float] = None,
) -> None:
    """Operator override of the peak table (0 = the table's row)."""
    if peak_flops is not None:
        _ROOFLINE_OVERRIDE["peak_flops"] = float(peak_flops)
    if peak_bytes_per_s is not None:
        _ROOFLINE_OVERRIDE["peak_bytes_per_s"] = float(peak_bytes_per_s)
    if peak_mxu_flops is not None:
        _ROOFLINE_OVERRIDE["peak_mxu_flops"] = float(peak_mxu_flops)


def current_device_kind() -> str:
    """The name of CUDA device 0, or "cpu" without one."""
    import torch

    if torch.cuda.is_available():
        return torch.cuda.get_device_name(0)
    return "cpu"


def device_peaks(device_kind: Optional[str] = None) -> dict:
    """{peak_flops, peak_bytes_per_s, peak_mxu_flops, device_kind, source}
    for the named device kind, or for the current device (asked of torch)."""
    if device_kind is None:
        device_kind = current_device_kind()
    kind = (device_kind or "cpu").lower()
    flops, bw, mxu, source = 0.0, 0.0, 0.0, "default"
    for sub, pf, pb, pm in _DEVICE_PEAKS:
        if sub in kind:
            flops, bw, mxu, source = pf, pb, pm, f"table:{sub}"
            break
    if not flops:
        flops, bw, mxu = (
            _DEVICE_PEAKS[-1][1], _DEVICE_PEAKS[-1][2], _DEVICE_PEAKS[-1][3]
        )
    if _ROOFLINE_OVERRIDE["peak_flops"]:
        flops, source = _ROOFLINE_OVERRIDE["peak_flops"], "config"
    if _ROOFLINE_OVERRIDE["peak_bytes_per_s"]:
        bw = _ROOFLINE_OVERRIDE["peak_bytes_per_s"]
        source = "config"
    if _ROOFLINE_OVERRIDE["peak_mxu_flops"]:
        mxu = _ROOFLINE_OVERRIDE["peak_mxu_flops"]
        source = "config"
    return {
        "peak_flops": flops,
        "peak_bytes_per_s": bw,
        "peak_mxu_flops": mxu,
        "device_kind": device_kind,
        "source": source,
    }


def matmul_peak(peaks: dict, device_type: str) -> Tuple[float, str]:
    """(peak flops/s, its name) of the unit the port's dense-tier matmuls
    run on. They run with TF32 off (ROADMAP contract 4), so on the card
    that is the fp32 peak, not the table's TF32 tensor-core peak; on the
    CPU it is the table's matrix peak. A configured
    ``metrics.roofline-peak-mxu-flops`` wins."""
    if _ROOFLINE_OVERRIDE["peak_mxu_flops"]:
        return _ROOFLINE_OVERRIDE["peak_mxu_flops"], "config"
    if device_type == "cuda":
        return float(peaks["peak_flops"]), "fp32 (TF32 off)"
    return float(peaks["peak_mxu_flops"]), peaks["source"]


# --------------------------------------------------------------------------
# Resource ledger
# --------------------------------------------------------------------------

#: the counter vocabulary: one naming for run records and span annotations
COUNTER_FIELDS = (
    "cells_read",
    "cells_written",
    "bytes_read",
    "bytes_written",
    "index_hits",
    "retries",
    "h2d_bytes",
    "d2h_bytes",
)

#: wire tags of the ledger block (tag-value pairs, so the block can grow
#: without a protocol bump); wall_ns rides the wire but merges into
#: wall_by_layer, not a counter. The reference's numbering: the blocks
#: are byte-equal in both directions
_FIELD_TAGS: Dict[str, int] = {f: i + 1 for i, f in enumerate(COUNTER_FIELDS)}
_FIELD_TAGS["wall_ns"] = 15
_TAG_FIELDS = {v: k for k, v in _FIELD_TAGS.items()}


class ResourceLedger:
    """Per-request cost accumulator (cells, bytes, hits, retries, walls)."""

    __slots__ = ("counters", "wall_by_layer", "_lock")

    def __init__(self):
        self.counters: Dict[str, int] = {}
        self.wall_by_layer: Dict[str, float] = {}
        self._lock = threading.Lock()

    def add(self, **fields) -> "ResourceLedger":
        with self._lock:
            for k, v in fields.items():
                if v:
                    self.counters[k] = self.counters.get(k, 0) + int(v)
        return self

    def add_wall(self, layer: str, ms: float) -> "ResourceLedger":
        with self._lock:
            self.wall_by_layer[layer] = (
                self.wall_by_layer.get(layer, 0.0) + float(ms)
            )
        return self

    def merge(self, other: "ResourceLedger") -> None:
        with other._lock:
            counters = dict(other.counters)
            walls = dict(other.wall_by_layer)
        self.add(**counters)
        for layer, ms in walls.items():
            self.add_wall(layer, ms)

    def get(self, field: str) -> int:
        with self._lock:
            return self.counters.get(field, 0)

    def op_cells(self) -> int:
        with self._lock:
            return self.counters.get("cells_read", 0) + self.counters.get(
                "cells_written", 0
            )

    def to_dict(self) -> dict:
        with self._lock:
            out: Dict[str, object] = dict(self.counters)
            if self.wall_by_layer:
                out["wall_ms_by_layer"] = {
                    k: round(v, 3) for k, v in self.wall_by_layer.items()
                }
        return out


_LEDGER_VAR: "contextvars.ContextVar[Optional[ResourceLedger]]" = (
    contextvars.ContextVar("janusgraph_tpu_torch_ledger", default=None)
)


def current_ledger() -> Optional[ResourceLedger]:
    return _LEDGER_VAR.get()


@contextmanager
def ledger_scope():
    """Run a block under a fresh ledger; on exit the block's accruals
    merge into the enclosing scope (if any)."""
    led = ResourceLedger()
    parent = _LEDGER_VAR.get()
    token = _LEDGER_VAR.set(led)
    try:
        yield led
    finally:
        _LEDGER_VAR.reset(token)
        if parent is not None:
            parent.merge(led)


def accrue(**fields) -> None:
    """Add to the ambient ledger AND annotate the current span with
    aggregating ``ledger.<field>`` attributes. No-op outside a ledger
    scope (zero overhead for unprofiled work)."""
    led = _LEDGER_VAR.get()
    if led is None:
        return
    led.add(**fields)
    from janusgraph_tpu_torch.observability import tracer

    sp = tracer.current()
    if sp is not None:
        for k, v in fields.items():
            if v:
                key = f"ledger.{k}"
                sp.attrs[key] = int(sp.attrs.get(key, 0)) + int(v)


def accrue_wall(layer: str, ms: float) -> None:
    """Layer-wall accrual (no span annotation: the span's own duration
    already represents the wall; this just buckets it by layer)."""
    led = _LEDGER_VAR.get()
    if led is not None and ms:
        led.add_wall(layer, ms)


def merge_echo(fields: Optional[dict], layer: str = "") -> None:
    """Merge a remote peer's echoed ledger block into the ambient ledger
    WITHOUT annotating a span: the peer annotated its own span with the
    same fields, and the two sides of the wire must not double-count."""
    if not fields:
        return
    led = _LEDGER_VAR.get()
    if led is None:
        return
    counters = {k: v for k, v in fields.items() if k in _FIELD_TAGS and k != "wall_ns"}
    led.add(**counters)
    wall_ns = fields.get("wall_ns")
    if wall_ns and layer:
        led.add_wall(layer, wall_ns / 1e6)


# ------------------------------------------------------------- wire codec
_LEDGER_VERSION = 1


def encode_ledger_block(fields: dict) -> bytes:
    """``[u8 blen][ver:1][n:1]([tag:1][u64])*``: length-prefixed like the
    trace-context prefix, so it can ride in front of any response body
    (the remote store server echoes a per-op ledger in it)."""
    pairs = [
        (_FIELD_TAGS[k], int(v))
        for k, v in fields.items()
        if k in _FIELD_TAGS and v
    ]
    payload = bytes([_LEDGER_VERSION, len(pairs)]) + b"".join(
        struct.pack(">BQ", tag, value) for tag, value in pairs
    )
    return bytes([len(payload)]) + payload


def split_ledger_block(body: bytes) -> Tuple[Optional[dict], bytes]:
    """Inverse of :func:`encode_ledger_block`: (fields|None, rest).
    Malformed blocks degrade to None: a bad ledger must never fail the
    response it rides on."""
    if not body:
        return None, body
    blen = body[0]
    if len(body) < 1 + blen or blen < 2:
        return None, body
    payload, rest = body[1 : 1 + blen], body[1 + blen :]
    if payload[0] != _LEDGER_VERSION:
        return None, body
    n = payload[1]
    if len(payload) != 2 + 9 * n:
        return None, body
    fields: Dict[str, int] = {}
    for i in range(n):
        tag, value = struct.unpack_from(">BQ", payload, 2 + 9 * i)
        name = _TAG_FIELDS.get(tag)
        if name is not None:
            fields[name] = value
    return fields, rest


# --------------------------------------------------------------------------
# Query digests
# --------------------------------------------------------------------------

#: literals embedded in step labels (e.g. ``adjacentVertexHasId(1, 2)``)
_LITERAL_RE = re.compile(r"\(.*\)|['\"].*['\"]|\d+", re.S)


def traversal_shape(labels, plan: Optional[dict] = None) -> str:
    """Normalize a traversal to its shape: the step vocabulary joined in
    order with literals stripped, prefixed by the resolved access path
    (index choice included — two queries that differ only in literals or
    in nothing the planner sees share a shape)."""
    plan = plan or {}
    access = plan.get("access", "traversal")
    index = plan.get("index")
    head = f"{access}[{index}]" if index else str(access)
    steps = [_LITERAL_RE.sub("", str(lb)).strip() or "step" for lb in labels]
    return ">".join([head] + steps) if steps else head


def shape_digest(shape: str) -> str:
    """Stable 8-hex-char digest of a shape string."""
    return hashlib.sha1(shape.encode()).hexdigest()[:8]


class DigestTable:
    """Bounded top-K table of query digests ranked by total cost.

    One entry per digest: occurrence count, total wall, total cells, and
    a log-bucket wall histogram for p50/p95. When the table exceeds its
    capacity the entry with the smallest total cost is evicted — heavy
    hitters survive, one-off shapes age out."""

    def __init__(self, capacity: int = 128):
        self.capacity = capacity
        self._entries: "OrderedDict[str, dict]" = OrderedDict()
        self._lock = threading.Lock()

    def configure(self, capacity: Optional[int] = None) -> None:
        with self._lock:
            if capacity is not None and capacity > 0:
                self.capacity = capacity

    def observe(
        self, digest: str, shape: str, wall_ms: float, cells: int = 0
    ) -> None:
        """Record one execution of a digest (host only: never inside a
        CUDA graph capture)."""
        from janusgraph_tpu_torch.observability.metrics_core import Histogram

        with self._lock:
            e = self._entries.get(digest)
            if e is None:
                e = self._entries[digest] = {
                    "digest": digest,
                    "shape": shape,
                    "count": 0,
                    "total_ms": 0.0,
                    "total_cells": 0,
                    "hist": Histogram(),
                }
            e["count"] += 1
            e["total_ms"] += float(wall_ms)
            e["total_cells"] += int(cells)
            e["hist"].observe(float(wall_ms))
            if len(self._entries) > self.capacity:
                victim = min(
                    self._entries, key=lambda d: self._entries[d]["total_ms"]
                )
                del self._entries[victim]

    def mean_cost_ms(self, digest: str) -> Optional[float]:
        """Measured mean wall of one digest (total/count), or None when
        the table has never seen it (the spillover planner's promotion
        reads it)."""
        with self._lock:
            e = self._entries.get(digest)
            if e is None or not e["count"]:
                return None
            return e["total_ms"] / e["count"]

    def top(self, k: int = 10) -> List[dict]:
        """The k digests with the largest total cost, descending."""
        with self._lock:
            entries = list(self._entries.values())
        entries.sort(key=lambda e: e["total_ms"], reverse=True)
        out = []
        for e in entries[:k]:
            h = e["hist"]
            out.append({
                "digest": e["digest"],
                "shape": e["shape"],
                "count": e["count"],
                "total_ms": round(e["total_ms"], 3),
                "total_cells": e["total_cells"],
                "p50_ms": round(h.percentile(0.50), 3),
                "p95_ms": round(h.percentile(0.95), 3),
            })
        return out

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def reset(self) -> None:
        with self._lock:
            self._entries.clear()


#: process-wide digest table: the traversal feeds it, the spillover planner
#: reads it
digest_table = DigestTable()


def digest_records(table: DigestTable) -> List[dict]:
    """A table's entries as plain records (histogram bucket counts
    included, at the live table's log-bucket resolution)."""
    with table._lock:
        entries = [dict(e) for e in table._entries.values()]
    out = []
    for e in entries:
        h = e["hist"]
        with h._lock:
            counts = list(h._counts)
            hcount, htotal, hmax = h.count, h.total, h.max
        out.append({
            "digest": e["digest"],
            "shape": e["shape"],
            "count": e["count"],
            "total_ms": e["total_ms"],
            "total_cells": e["total_cells"],
            "hist": {
                "counts": counts, "count": hcount,
                "total": htotal, "max": hmax,
            },
        })
    return out


# --------------------------------------------------------------------------
# Roofline records
# --------------------------------------------------------------------------

def estimate_superstep_cost(
    num_vertices: int,
    num_edges: int,
    msg_cols: int = 1,
    weighted: bool = False,
    arg_bytes: int = 0,
) -> dict:
    """One BSP superstep's cost from its sizes: a message gathered per
    edge (one multiply when weighted), combined at the destination (one op
    per edge) and applied elementwise per vertex. Bytes = the superstep's
    graph arguments (or an index + message estimate when unknown) plus the
    state read and written."""
    cols = max(1, int(msg_cols))
    flops = float(num_edges) * cols * (2.0 if weighted else 1.0)
    flops += 5.0 * float(num_vertices) * cols
    if arg_bytes <= 0:
        arg_bytes = 8 * num_edges + 4 * num_vertices
    bytes_accessed = float(arg_bytes) + 8.0 * float(num_vertices) * cols
    return {
        "flops": flops,
        "bytes_accessed": bytes_accessed,
        "cost_source": "estimate",
    }


def roofline_point(
    flops: float, bytes_accessed: float, wall_ms: float, peaks: dict
) -> dict:
    """Operational intensity + utilization for one measured wall.
    Utilization = achieved flops/s over the roofline ceiling at this OI
    (``min(peak_flops, oi * peak_bw)`` — the classic two-segment roof)."""
    oi = flops / bytes_accessed if bytes_accessed > 0 else 0.0
    out = {"operational_intensity": round(oi, 5)}
    if wall_ms and wall_ms > 0 and flops > 0:
        achieved = flops / (wall_ms / 1e3)
        roof = min(peaks["peak_flops"], oi * peaks["peak_bytes_per_s"])
        out["roofline_utilization"] = (
            round(achieved / roof, 6) if roof > 0 else 0.0
        )
    else:
        out["roofline_utilization"] = None
    return out


def attach_roofline(records: List[dict], cost: dict, peaks: dict) -> dict:
    """Stamp per-superstep records with flops / bytes / OI / utilization
    and return the per-E_cap-tier aggregation. ``cost`` is one
    superstep's {flops, bytes_accessed, cost_source}, the default for a
    record without its own; walls come from each record."""
    tiers: Dict[object, dict] = {}
    for r in records:
        r.setdefault("flops", cost["flops"])
        r.setdefault("bytes_accessed", cost["bytes_accessed"])
        r.setdefault("cost_source", cost["cost_source"])
        point = roofline_point(
            r["flops"], r["bytes_accessed"], r.get("wall_ms", 0.0), peaks
        )
        r.update(point)
        tier = r.get("e_cap", "dense")
        t = tiers.setdefault(
            tier, {"supersteps": 0, "oi_sum": 0.0, "util_sum": 0.0,
                   "util_n": 0},
        )
        t["supersteps"] += 1
        t["oi_sum"] += point["operational_intensity"]
        if point["roofline_utilization"] is not None:
            t["util_sum"] += point["roofline_utilization"]
            t["util_n"] += 1
    out = {}
    for tier, t in tiers.items():
        out[str(tier)] = {
            "supersteps": t["supersteps"],
            "operational_intensity": round(t["oi_sum"] / t["supersteps"], 5),
            "roofline_utilization": (
                round(t["util_sum"] / t["util_n"], 6) if t["util_n"] else None
            ),
        }
    return out


def attach_mxu(records: List[dict], mxu_flops: float, peaks: dict) -> dict:
    """Stamp per-superstep records with the dense tier's matmul
    accounting: ``mxu_flops`` (matmul-attributable flops per superstep,
    from the program's ``matmul_flops``) and ``mxu_utilization`` (achieved
    matmul flops/s over ``peaks["peak_mxu_flops"]``). Returns the
    run-level summary block (``run_info["mxu"]``)."""
    peak = float(peaks.get("peak_mxu_flops") or 0.0)
    utils = []
    for r in records:
        r["mxu_flops"] = mxu_flops
        wall = r.get("wall_ms")
        if not mxu_flops:
            r["mxu_utilization"] = 0.0
        elif wall and wall > 0 and peak > 0:
            u = round((mxu_flops / (wall / 1e3)) / peak, 6)
            r["mxu_utilization"] = u
            utils.append(u)
        else:
            r["mxu_utilization"] = None
    return {
        "peak_mxu_flops": peak,
        "per_superstep_flops": mxu_flops,
        "mean_utilization": (
            round(sum(utils) / len(utils), 6) if utils else None
        ),
    }


# --------------------------------------------------------------------------
# Flamegraph export
# --------------------------------------------------------------------------

_FRAME_SANITIZE = re.compile(r"[;\s]+")


def _frame_name(span) -> str:
    """One collapsed-stack frame: the span name, with ledger annotations
    folded in (semicolons and whitespace are the format's separators, so
    they are squeezed out)."""
    name = _FRAME_SANITIZE.sub("_", span.name)
    led = sorted(
        (k[len("ledger."):], v)
        for k, v in span.attrs.items()
        if k.startswith("ledger.")
    )
    if led:
        name += "(" + ",".join(f"{k}:{v}" for k, v in led) + ")"
    return name


def flame_lines(roots) -> List[str]:
    """Render a trace's span trees to collapsed-stack lines
    (``frame;frame;frame weight``, weight = self-time in µs). Roots that
    joined a parent from elsewhere (``parent_span_id``) are grafted under
    that span when it is retained locally."""
    by_id: Dict[int, List[str]] = {}

    def index(span, prefix: List[str]):
        path = prefix + [_frame_name(span)]
        by_id[span.span_id] = path
        for c in span.children:
            index(c, path)

    attached: List[object] = []
    pending = list(roots)
    # multi-pass graft: a root with a parent can only be placed once its
    # parent's tree is indexed, whatever order the ring returned them in
    while pending:
        progressed = False
        rest = []
        for r in pending:
            parent_path = by_id.get(r.parent_span_id) if r.parent_span_id else []
            if parent_path is not None:
                index(r, parent_path or [])
                attached.append(r)
                progressed = True
            else:
                rest.append(r)
        if not progressed:
            for r in rest:  # orphaned roots: emit as separate stacks
                index(r, [])
                attached.append(r)
            rest = []
        pending = rest

    lines: List[str] = []

    def emit(span, prefix: List[str]):
        path = prefix + [_frame_name(span)]
        child_ms = sum(c.duration_ms for c in span.children)
        self_us = max(0, int(round((span.duration_ms - child_ms) * 1000)))
        lines.append(f"{';'.join(path)} {self_us}")
        for c in span.children:
            emit(c, path)

    for r in attached:
        prefix = by_id[r.span_id][:-1]
        emit(r, prefix)
    return lines


def flame_text(tracer, trace_id) -> str:
    """Collapsed-stack rendering of one retained trace (newline-joined;
    empty string when the trace is not retained)."""
    roots = tracer.find_trace(trace_id)
    return "\n".join(flame_lines(roots))
