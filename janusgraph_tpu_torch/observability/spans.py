"""Structured spans: a context-var tracer with parent/child nesting — the
port's copy of ``janusgraph_tpu/observability/spans.py``.

Spans cover the transaction (``tx.commit``/``tx.rollback``), the
instrumented store (``store.<op>``) and the OLAP ``GraphComputer.submit()``
path down to per-superstep children.

Design:

- ``contextvars`` carry the current span, so nesting follows Python's
  call/async structure per thread with zero plumbing; a thread (or
  context) always builds its own tree.
- finished ROOT spans land in a bounded ring buffer (``recent()``); the
  process never accumulates unbounded trees.
- every finished span — root or child — whose duration crosses the
  configured threshold is ALSO appended to the slow-op ring buffer
  (``slow_ops()``), the always-on recorder of outliers (threshold via
  ``metrics.slow-op-threshold-ms`` in core/config.py).
- pre-timed children (``record_span``) let host-resident measurements —
  per-superstep records timed on the card and read once after the run —
  appear in the tree without recording from inside a CUDA-graph capture.
- every span carries a 64-bit ``trace_id``/``span_id``; a
  :class:`TraceContext` serializes (trace_id, parent span_id, sampled)
  compactly for process boundaries, so a caller can join a trace started
  elsewhere (``child_span``).
"""

from __future__ import annotations

import contextvars
import random
import struct
import threading
import time
from collections import deque
from contextlib import contextmanager
from typing import Dict, List, Optional

_CURRENT: "contextvars.ContextVar[Optional[Span]]" = contextvars.ContextVar(
    "janusgraph_tpu_torch_current_span", default=None
)


def _new_id() -> int:
    """Non-zero 64-bit id. `random` (not urandom syscalls): ids only need
    collision resistance within a ring buffer, and spans sit on the tx
    hot path."""
    v = random.getrandbits(64)
    return v or 1


class TraceContext:
    """The serializable slice of a span that crosses process boundaries:
    (trace_id, parent span_id, sampled flag).

    Two codecs, both versioned:

    - ``to_bytes``/``from_bytes`` — compact binary for the length-prefixed
      storage/index protocols: ``[ver:1][trace_id:8][span_id:8][flags:1]``.
    - ``to_header``/``from_header`` — W3C-traceparent-shaped text for the
      HTTP/WS query protocol: ``01-<trace:16hex>-<span:16hex>-<flags:2hex>``.

    Decoders return ``None`` on anything malformed: a bad trace header
    must never fail the request it rides on.
    """

    __slots__ = ("trace_id", "span_id", "sampled")

    _VERSION = 1

    def __init__(self, trace_id: int, span_id: int, sampled: bool = True):
        self.trace_id = int(trace_id)
        self.span_id = int(span_id)
        self.sampled = bool(sampled)

    def to_bytes(self) -> bytes:
        return struct.pack(
            ">BQQB", self._VERSION, self.trace_id, self.span_id,
            1 if self.sampled else 0,
        )

    @classmethod
    def from_bytes(cls, raw: bytes) -> Optional["TraceContext"]:
        if len(raw) != 18:
            return None
        ver, trace_id, span_id, flags = struct.unpack(">BQQB", raw)
        if ver != cls._VERSION or trace_id == 0:
            return None
        return cls(trace_id, span_id, sampled=bool(flags & 1))

    def to_header(self) -> str:
        return (
            f"{self._VERSION:02d}-{self.trace_id:016x}-{self.span_id:016x}"
            f"-{1 if self.sampled else 0:02x}"
        )

    @classmethod
    def from_header(cls, text: str) -> Optional["TraceContext"]:
        if not text:
            return None
        parts = text.strip().split("-")
        if len(parts) != 4:
            return None
        try:
            ver = int(parts[0], 10)
            trace_id = int(parts[1], 16)
            span_id = int(parts[2], 16)
            flags = int(parts[3], 16)
        except ValueError:
            return None
        if ver != cls._VERSION or trace_id == 0:
            return None
        return cls(trace_id, span_id, sampled=bool(flags & 1))

    def __repr__(self) -> str:
        return f"TraceContext({self.to_header()})"


def _plain(value):
    """Attribute values must be JSON-friendly host scalars — coercing a
    traced/device value here would be a hidden sync, so only coerce known
    host types and stringify the rest."""
    if isinstance(value, (str, bool, int, float)) or value is None:
        return value
    try:
        import numpy as np

        if isinstance(value, np.integer):
            return int(value)
        if isinstance(value, np.floating):
            return float(value)
    except ImportError:  # numpy is always present here, but be safe
        pass
    return str(value)


class Span:
    """One timed node: name, attributes, children (cf. the profiler's
    QueryProfiler group, but subsystem-agnostic and context-propagated).
    Carries trace identity: ``trace_id`` is shared by every span of one
    logical operation (across processes when propagated),
    ``parent_span_id`` links a local root under its remote parent."""

    __slots__ = (
        "name", "attrs", "children", "start_ns", "end_ns", "wall_t",
        "trace_id", "span_id", "parent_span_id", "sampled",
    )

    def __init__(self, name: str, attrs: Optional[dict] = None):
        self.name = name
        self.attrs: Dict[str, object] = (
            {k: _plain(v) for k, v in attrs.items()} if attrs else {}
        )
        self.children: List["Span"] = []
        self.start_ns = 0
        self.end_ns = 0
        self.wall_t = 0.0  # epoch seconds at start (for the slow-op log)
        self.span_id = _new_id()
        self.trace_id = 0  # assigned at attach: inherited or fresh
        self.parent_span_id = 0  # non-zero only for remote-parented roots
        self.sampled = True

    @property
    def duration_ms(self) -> float:
        return (self.end_ns - self.start_ns) / 1e6

    def context(self) -> TraceContext:
        """This span's identity as a propagatable context."""
        return TraceContext(self.trace_id, self.span_id, self.sampled)

    def annotate(self, **attrs) -> "Span":
        for k, v in attrs.items():
            self.attrs[k] = _plain(v)
        return self

    def to_dict(self) -> dict:
        d = {
            "name": self.name,
            "duration_ms": round(self.duration_ms, 4),
            "trace_id": f"{self.trace_id:016x}",
            "span_id": f"{self.span_id:016x}",
            "attrs": dict(self.attrs),
            "children": [c.to_dict() for c in self.children],
        }
        if self.parent_span_id:
            d["parent_span_id"] = f"{self.parent_span_id:016x}"
        return d

    def find(self, name: str) -> List["Span"]:
        """All descendants (and self) with this name, depth-first."""
        out = [self] if self.name == name else []
        for c in self.children:
            out.extend(c.find(name))
        return out


class Tracer:
    """Owns the current-span context plus the two ring buffers."""

    def __init__(
        self,
        max_roots: int = 256,
        slow_threshold_ms: float = 100.0,
        slow_buffer: int = 128,
    ):
        self.slow_threshold_ms = slow_threshold_ms
        self._roots: deque = deque(maxlen=max_roots)
        self._slow: deque = deque(maxlen=slow_buffer)
        self._lock = threading.Lock()
        #: optional sink fed every slow-op event (the flight recorder
        #: registers here; observability/__init__.py wires it)
        self.on_slow = None

    def configure(
        self,
        max_roots: Optional[int] = None,
        slow_threshold_ms: Optional[float] = None,
        slow_buffer: Optional[int] = None,
    ) -> None:
        with self._lock:
            if slow_threshold_ms is not None:
                self.slow_threshold_ms = slow_threshold_ms
            if max_roots is not None and max_roots != self._roots.maxlen:
                self._roots = deque(self._roots, maxlen=max_roots)
            if slow_buffer is not None and slow_buffer != self._slow.maxlen:
                self._slow = deque(self._slow, maxlen=slow_buffer)

    # -------------------------------------------------------------- recording
    @contextmanager
    def span(self, name: str, **attrs):
        parent = _CURRENT.get()
        s = Span(name, attrs)
        if parent is not None:
            parent.children.append(s)
            s.trace_id = parent.trace_id
            s.sampled = parent.sampled
        else:
            s.trace_id = _new_id()
        token = _CURRENT.set(s)
        s.wall_t = time.time()
        s.start_ns = time.perf_counter_ns()
        try:
            yield s
        finally:
            s.end_ns = time.perf_counter_ns()
            _CURRENT.reset(token)
            self._finished(s, root=parent is None)

    @contextmanager
    def child_span(self, ctx: Optional[TraceContext], name: str, **attrs):
        """A span under a REMOTE parent: joins ctx's trace as a local root
        (it lands in this process's root ring, linked by
        ``parent_span_id``). With ``ctx=None`` this is a plain ``span`` —
        receive sites never need to branch on whether a peer propagated."""
        if ctx is None:
            with self.span(name, **attrs) as s:
                yield s
            return
        parent = _CURRENT.get()
        s = Span(name, attrs)
        s.trace_id = ctx.trace_id
        s.parent_span_id = ctx.span_id
        s.sampled = ctx.sampled
        if parent is not None:
            # a remote context wins over the ambient span: the handler
            # thread's tree keeps its shape, the ids join the caller's trace
            parent.children.append(s)
        token = _CURRENT.set(s)
        s.wall_t = time.time()
        s.start_ns = time.perf_counter_ns()
        try:
            yield s
        finally:
            s.end_ns = time.perf_counter_ns()
            _CURRENT.reset(token)
            self._finished(s, root=parent is None)

    def record_span(self, name: str, duration_ms: float, **attrs) -> Span:
        """Attach a pre-timed span under the current span (or as a root).
        For measurements taken elsewhere — per-superstep records pulled
        from host-resident reduced metrics, never from traced code."""
        parent = _CURRENT.get()
        s = Span(name, attrs)
        now = time.perf_counter_ns()
        # reconstructs the wall START STAMP of a pre-timed span (duration_ms was measured elsewhere, on a monotonic clock)
        s.wall_t = time.time() - duration_ms / 1e3
        s.start_ns = now - int(duration_ms * 1e6)
        s.end_ns = now
        if parent is not None:
            parent.children.append(s)
            s.trace_id = parent.trace_id
            s.sampled = parent.sampled
        else:
            s.trace_id = _new_id()
        self._finished(s, root=parent is None)
        return s

    def _finished(self, s: Span, root: bool) -> None:
        thr = self.slow_threshold_ms
        if thr > 0 and s.duration_ms >= thr:
            event = {
                "name": s.name,
                "ms": round(s.duration_ms, 3),
                "time": s.wall_t,
                "trace_id": f"{s.trace_id:016x}",
                "span_id": f"{s.span_id:016x}",
                "attrs": dict(s.attrs),
            }
            with self._lock:
                self._slow.append(event)
            sink = self.on_slow
            if sink is not None:
                try:
                    sink(dict(event))
                except Exception:  # noqa: BLE001 - telemetry must not break work
                    pass
        if root and s.sampled:
            with self._lock:
                self._roots.append(s)

    # -------------------------------------------------------------- querying
    def current(self) -> Optional[Span]:
        return _CURRENT.get()

    def current_context(self) -> Optional[TraceContext]:
        """The ambient span's propagatable identity (None outside spans)."""
        cur = _CURRENT.get()
        return cur.context() if cur is not None else None

    def recent(self, name: Optional[str] = None) -> List[Span]:
        """Completed root spans, oldest first (optionally name-filtered)."""
        with self._lock:
            roots = list(self._roots)
        if name is not None:
            roots = [r for r in roots if r.name == name]
        return roots

    def find_trace(self, trace_id) -> List[Span]:
        """Every retained root span belonging to one trace, oldest first.
        Accepts an int or the 16-hex-char form the JSON surfaces use."""
        if isinstance(trace_id, str):
            try:
                trace_id = int(trace_id, 16)
            except ValueError:
                return []
        with self._lock:
            roots = list(self._roots)
        return [r for r in roots if r.trace_id == trace_id]

    def slow_ops(self) -> List[dict]:
        with self._lock:
            return [dict(e) for e in self._slow]

    def reset(self) -> None:
        with self._lock:
            self._roots.clear()
            self._slow.clear()


def capture_scope(fn):
    """Bind ``fn`` to the caller's ambient scope for execution on another
    thread.

    ``contextvars`` do not cross thread boundaries: a pool worker starts
    from an empty context, so the submitting request's current span,
    deadline, and profiler ledger silently vanish. This
    is the explicit handoff: it snapshots every contextvar at call time
    and returns a wrapper that re-enters the snapshot around each
    invocation::

        with span("store.scan"):
            pool.map(capture_scope(work), splits)   # workers keep the span

    Each invocation sets/resets the vars on its own thread rather than
    sharing one ``Context.run`` — a single ``Context`` object refuses
    concurrent entry, and pool workers run concurrently by design.
    """
    snapshot = list(contextvars.copy_context().items())

    def _reentered(*args, **kwargs):
        tokens = [(var, var.set(value)) for var, value in snapshot]
        try:
            return fn(*args, **kwargs)
        finally:
            for var, token in reversed(tokens):
                var.reset(token)

    return _reentered


#: process-wide tracer; `janusgraph_tpu_torch.observability.span` is its
#: `span` method
tracer = Tracer()
