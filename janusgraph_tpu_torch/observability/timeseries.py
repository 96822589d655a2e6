"""Time-series metrics history: a bounded ring of periodic snapshots —
the port's copy of ``janusgraph_tpu/observability/timeseries.py``.

``/metrics`` and ``/telemetry`` expose the registry *now*; the flight
recorder keeps salient events; the profiler prices single runs. None of them can answer the questions the serving rung
lives on — "is p99 degrading over the last five minutes?", "is the AIMD
limit oscillating?" — because nothing retains history. This module does:

- :class:`MetricsHistory` samples the process registry at a fixed
  interval (injectable clock; the server owns the sampling thread) into
  a bounded ring of **windows**. Counters and timers are cumulative at
  the source, so each window stores the **delta** against the previous
  sample — the rate the operator actually wants — while gauges store the
  sampled value. Histogram/timer windows keep the per-window bucket
  delta vector, so window percentiles (p50/p95/p99 *of that window*, not
  of process lifetime) and threshold fractions ("what fraction of this
  window's requests ran over 250 ms") are exact to the shared log2
  bucket ladder.

- Every per-metric read goes through ``Histogram.state()`` — one lock
  acquisition per metric — so a window can never be torn by a concurrent
  ``observe`` (sum of bucket deltas == count delta, always).

- Sampling cost is measured into the ``observability.history.overhead_ms``
  gauge (last sample) and the ``observability.history.sample``
  timer. The sampler never touches request paths: it reads the same
  per-metric locks request threads use for nanoseconds each, nothing
  more.

- Retention is ``metrics.history-retention`` windows of
  ``metrics.history-interval-s`` seconds (defaults: 360 x 5 s = 30 min).
  ``GET /timeseries?name=&window=`` queries it; :meth:`MetricsHistory.export_jsonl` writes one JSON line per
  window for offline analysis.

Listeners (the SLO engine) run after each sample on the sampler thread,
so burn-rate evaluation is clocked by the same windows it reads —
deterministic under a fake clock with manual :meth:`sample` calls.
"""

from __future__ import annotations

import json
import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional

from janusgraph_tpu_torch.observability.metrics_core import (
    BUCKET_BOUNDS,
    Histogram,
)

OVERHEAD_GAUGE = "observability.history.overhead_ms"


class MetricsHistory:
    """Bounded ring of periodic registry snapshots (delta windows)."""

    def __init__(
        self,
        registry=None,
        capacity: int = 360,
        interval_s: float = 5.0,
        clock: Callable[[], float] = time.monotonic,
        wall_clock: Callable[[], float] = time.time,
    ):
        self._registry = registry
        self.interval_s = float(interval_s)
        self._clock = clock
        self._wall = wall_clock
        self._ring: deque = deque(maxlen=int(capacity))
        self._lock = threading.Lock()
        self._seq = 0
        #: previous cumulative values per metric, for window deltas
        self._prev_counters: Dict[str, int] = {}
        self._prev_hist: Dict[str, tuple] = {}  # name -> (count, total, counts)
        self._listeners: List[Callable[[dict], None]] = []
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    # ------------------------------------------------------------- lifecycle
    def configure(
        self,
        capacity: Optional[int] = None,
        interval_s: Optional[float] = None,
    ) -> None:
        with self._lock:
            if capacity is not None and capacity != self._ring.maxlen:
                self._ring = deque(self._ring, maxlen=int(capacity))
            if interval_s is not None and interval_s > 0:
                self.interval_s = float(interval_s)

    def bind(self, registry) -> "MetricsHistory":
        self._registry = registry
        return self

    def add_listener(self, fn: Callable[[dict], None]) -> None:
        """Register a per-window hook (the SLO engine); runs on the
        sampling thread after each window lands."""
        if fn not in self._listeners:
            self._listeners.append(fn)

    def remove_listener(self, fn) -> None:
        if fn in self._listeners:
            self._listeners.remove(fn)

    def start(self, interval_s: Optional[float] = None) -> None:
        """Start the background sampler (idempotent). The server calls
        this at start(); embedded use can call it directly."""
        if interval_s is not None:
            self.configure(interval_s=interval_s)
        if self._thread is not None and self._thread.is_alive():
            return
        self._stop.clear()

        def _loop():
            while not self._stop.wait(self.interval_s):
                try:
                    self.sample()
                except Exception as e:  # noqa: BLE001 - sampling must not die
                    # record before continuing: a silently
                    # failing sampler leaves a stale ring that reads as
                    # a healthy-but-frozen process
                    from janusgraph_tpu_torch.observability.flight import (
                        recorder,
                    )

                    recorder.record(
                        "thread_error", thread="metrics-history",
                        error=repr(e),
                    )

        self._thread = threading.Thread(
            target=_loop, name="metrics-history", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=2.0)
        self._thread = None

    @property
    def running(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    # -------------------------------------------------------------- sampling
    def sample(self) -> dict:
        """Take one window: read the registry (consistent per-metric
        ``state()`` reads), diff against the previous cumulative values,
        append the delta window, notify listeners. Returns the window."""
        registry = self._registry
        if registry is None:
            from janusgraph_tpu_torch.observability import registry as _r

            registry = self._registry = _r
        t0 = time.perf_counter()
        counters, timers, histograms, gauges = registry.metric_objects()
        counter_deltas: Dict[str, int] = {}
        hist_windows: Dict[str, dict] = {}
        # the prev-cumulative maps are shared with reset(), which clears
        # them under _lock from the caller's thread while this runs on the
        # sampler thread — diff and update them under the same lock (the
        # reads here are in-memory registry state, never blocking)
        with self._lock:
            for name, c in counters.items():
                cur = c.count
                prev = self._prev_counters.get(name)
                self._prev_counters[name] = cur
                # first sight of a counter: the whole cumulative value is
                # the window's delta (a restart-reset registry behaves the
                # same — deltas never go negative, matching Prometheus
                # rate() resets)
                delta = (
                    cur - prev if prev is not None and cur >= prev else cur
                )
                if delta:
                    counter_deltas[name] = delta
            for name, h in list(timers.items()) + list(histograms.items()):
                count, total, hi, counts = h.state()
                prev = self._prev_hist.get(name)
                self._prev_hist[name] = (count, total, counts)
                if prev is not None and count >= prev[0]:
                    dcount = count - prev[0]
                    dtotal = total - prev[1]
                    dcounts = [a - b for a, b in zip(counts, prev[2])]
                else:
                    dcount, dtotal, dcounts = count, total, counts
                if dcount <= 0:
                    continue
                hist_windows[name] = {
                    "kind": "timer" if name in timers else "histogram",
                    "count": dcount,
                    "sum": dtotal,
                    # max is cumulative (windowed max is not derivable)
                    "max": hi,
                    "buckets": dcounts,
                    "p50": Histogram.percentile_of(dcounts, 0.50, hi),
                    "p95": Histogram.percentile_of(dcounts, 0.95, hi),
                    "p99": Histogram.percentile_of(dcounts, 0.99, hi),
                }
        gauge_values = {
            name: g.value for name, g in gauges.items()
        }
        with self._lock:
            self._seq += 1
            window = {
                "seq": self._seq,
                "t": self._clock(),
                "ts": self._wall(),
                "interval_s": self.interval_s,
                "counters": counter_deltas,
                "series": hist_windows,
                "gauges": gauge_values,
            }
            self._ring.append(window)
            listeners = list(self._listeners)
        overhead_ms = (time.perf_counter() - t0) * 1000.0
        registry.set_gauge(OVERHEAD_GAUGE, round(overhead_ms, 4))
        registry.timer("observability.history.sample").update(
            int(overhead_ms * 1e6)
        )
        for fn in listeners:
            try:
                fn(window)
            except Exception:  # noqa: BLE001 - a listener must not kill sampling
                pass
        return window

    # ------------------------------------------------------------- querying
    def last_seq(self) -> int:
        """Sequence of the newest sealed window — the ``window``
        stream's cursor position (telemetry bus / ``/watch/info``),
        the same cursor vocabulary the federation scrape uses."""
        with self._lock:
            return self._seq

    def windows(self, last: int = 0) -> List[dict]:
        """The most recent ``last`` windows (0 = all retained), oldest
        first."""
        with self._lock:
            ws = list(self._ring)
        return ws[-last:] if last > 0 else ws

    def series(self, name: str, last: int = 0) -> List[dict]:
        """Per-window points for ONE metric name (exact match), oldest
        first. Counter points carry ``delta``; histogram/timer points the
        window summary; gauge points ``value``."""
        out = []
        for w in self.windows(last):
            point = {"seq": w["seq"], "ts": w["ts"]}
            if name in w["counters"]:
                point["delta"] = w["counters"][name]
            elif name in w["series"]:
                point.update(w["series"][name])
                point.pop("buckets", None)
            elif name in w["gauges"]:
                point["value"] = w["gauges"][name]
            else:
                continue
            out.append(point)
        return out

    def names(self) -> List[str]:
        """Every metric name seen in any retained window (sorted)."""
        seen = set()
        for w in self.windows():
            seen.update(w["counters"])
            seen.update(w["series"])
            seen.update(w["gauges"])
        return sorted(seen)

    def query(self, name: str = "", window: int = 0) -> dict:
        """The ``GET /timeseries`` payload: windows retained, interval,
        and one series per metric whose name starts with ``name``
        (empty = all), each bounded to the last ``window`` windows
        (0 = all retained)."""
        ws = self.windows(window)
        names = [n for n in self.names() if n.startswith(name)]
        return {
            "interval_s": self.interval_s,
            "retention": self._ring.maxlen,
            "windows": len(ws),
            "first_seq": ws[0]["seq"] if ws else 0,
            "last_seq": ws[-1]["seq"] if ws else 0,
            "series": {
                n: self.series(n, window) for n in names
            },
        }

    def scrape(self, last: int = 0) -> dict:
        """The federation scrape payload (``GET /timeseries?raw=1``):
        full retained windows WITH their bucket delta vectors (what
        :meth:`query` strips), plus the sampling clocks' *now* so the
        scraper can window by sequence and estimate this replica's
        wall-clock offset from the request round-trip. Consumed by
        ``observability/federation.py``; per-replica merge semantics
        (counters sum, buckets add) need the raw vectors."""
        from janusgraph_tpu_torch.observability.identity import replica_name

        ws = self.windows(last)
        return {
            "replica": replica_name(),
            "now": self._wall(),
            "mono": self._clock(),
            "interval_s": self.interval_s,
            "retention": self._ring.maxlen,
            "first_seq": ws[0]["seq"] if ws else 0,
            "last_seq": ws[-1]["seq"] if ws else 0,
            "windows": ws,
        }

    # -------------------------------------------------------------- export
    def export_jsonl(self, path: str, last: int = 0) -> int:
        """One JSON line per retained window (full bucket vectors
        included) for offline analysis; returns the line count."""
        ws = self.windows(last)
        with open(path, "w") as f:
            for w in ws:
                f.write(json.dumps(w, default=str) + "\n")
        return len(ws)

    def reset(self) -> None:
        self.stop()
        with self._lock:
            self._ring.clear()
            self._prev_counters.clear()
            self._prev_hist.clear()
            self._seq = 0
            self._listeners.clear()


def bucket_upper_index(threshold: float) -> int:
    """Index of the first bucket whose upper bound exceeds ``threshold``
    (observations in buckets >= this index may exceed the threshold).
    Shared by the SLO engine's latency evaluation."""
    for i, b in enumerate(BUCKET_BOUNDS):
        if b > threshold:
            return i
    return len(BUCKET_BOUNDS)


#: process-wide history; the server starts its sampler, ``GET
#: /timeseries`` reads it back
history = MetricsHistory()
