"""Metric primitives and the telemetry registry — the port's copy of
``janusgraph_tpu/observability/metrics_core.py``.

Counters, gauges, value histograms and nanosecond timers keyed by dotted
names, with fixed log-scale bucket reservoirs that give p50/p95/p99:

- buckets are powers of two over one shared ladder (``BUCKET_BOUNDS``),
  so recording is a ``bit_length``-class operation with no allocation and
  percentiles are a bounded cumulative walk — cheap enough for the
  instrumented-store hot path;
- everything is thread-safe behind per-metric locks;
- the registry also keeps the last OLAP run records (``record_run``,
  ``last_run``);
- nothing here may be called while a CUDA graph is being captured: a
  registry write made during a capture runs once, at capture, and never
  on replay. Run records are built on the host from values the run
  fetched anyway.
"""

from __future__ import annotations

import threading
import time
from bisect import bisect_left
from collections import deque
from contextlib import contextmanager
from typing import Dict, List, Optional, Tuple

#: shared log2 bucket ladder: bounds[i] = 2**(i - 20), covering ~1e-6
#: (sub-microsecond in ns terms: fractional units) up to 2**43 (~8.8e12 —
#: 2.4 hours in nanoseconds, terabytes in bytes). One ladder for every
#: histogram keeps exposition buckets consistent across scrapes.
_LOW_EXP = -20
_NUM_BUCKETS = 64
BUCKET_BOUNDS: Tuple[float, ...] = tuple(
    2.0 ** (i + _LOW_EXP) for i in range(_NUM_BUCKETS)
)


def bucket_index(value: float) -> int:
    """Index of the first bound >= value; ``_NUM_BUCKETS`` = overflow."""
    if value <= BUCKET_BOUNDS[0]:
        return 0
    return bisect_left(BUCKET_BOUNDS, value)


class Counter:
    __slots__ = ("count", "_lock")

    def __init__(self):
        self.count = 0
        self._lock = threading.Lock()

    def inc(self, delta: int = 1) -> None:
        with self._lock:
            self.count += delta


class Gauge:
    """Last-write-wins scalar (OLAP superstep count, pad ratio, ...)."""

    __slots__ = ("value", "_lock")

    def __init__(self):
        self.value = 0.0
        self._lock = threading.Lock()

    def set(self, value: float) -> None:
        with self._lock:
            self.value = float(value)

    def add(self, delta: float) -> None:
        with self._lock:
            self.value += float(delta)


class Histogram:
    """Fixed log-scale bucket reservoir over non-negative values.

    ``observe`` is O(log buckets) under one lock; ``percentile`` walks the
    (copied) counts. Values beyond the top bound land in a dedicated
    overflow slot so finite-bucket cumulative counts stay honest for the
    Prometheus ``le`` semantics.
    """

    __slots__ = ("count", "total", "max", "_counts", "_lock")

    def __init__(self):
        self.count = 0
        self.total = 0.0
        self.max = 0.0
        self._counts = [0] * (_NUM_BUCKETS + 1)  # +1 = overflow (+Inf)
        self._lock = threading.Lock()

    def observe(self, value: float) -> None:
        idx = bucket_index(value)
        with self._lock:
            self._counts[idx] += 1
            self.count += 1
            self.total += value
            if value > self.max:
                self.max = value

    def state(self) -> Tuple[int, float, float, List[int]]:
        """ONE-lock consistent read: ``(count, total, max, bucket counts)``
        with ``sum(counts) == count`` guaranteed. Every reader below (and
        the history sampler's window deltas) goes through here — a reader
        taking count and buckets under SEPARATE lock acquisitions can see
        a torn window when an observe lands in between."""
        with self._lock:
            return self.count, self.total, self.max, list(self._counts)

    @staticmethod
    def percentile_of(counts: List[int], q: float, hi: float) -> float:
        """Quantile over one (possibly windowed) bucket-count vector."""
        total = sum(counts)
        if total == 0:
            return 0.0
        rank = max(1, int(q * total + 0.5))
        cum = 0
        for i, c in enumerate(counts):
            cum += c
            if cum >= rank:
                return BUCKET_BOUNDS[i] if i < _NUM_BUCKETS else hi
        return hi

    def percentile(self, q: float) -> float:
        """Upper bucket bound at quantile ``q`` in [0, 1] (0.0 if empty).
        Log-bucket resolution: the answer is exact to within 2x."""
        _count, _total, hi, counts = self.state()
        return self.percentile_of(counts, q, hi)

    def cumulative_buckets(self) -> List[Tuple[float, int]]:
        """``[(le_bound, cumulative_count)]`` for the finite buckets that
        carry data (plus every bound below the max observed bucket that
        contributes to the cumulative shape), for exposition."""
        _count, _total, _hi, counts = self.state()
        out: List[Tuple[float, int]] = []
        cum = 0
        for i in range(_NUM_BUCKETS):
            cum += counts[i]
            if counts[i]:
                out.append((BUCKET_BOUNDS[i], cum))
        return out

    def summary(self) -> Dict[str, float]:
        # one consistent state read feeds every field: count, sum, and the
        # percentiles all describe the SAME point in time even while other
        # threads keep observing
        count, total, hi, counts = self.state()
        return {
            "count": count,
            "sum": total,
            "max": hi,
            "p50": self.percentile_of(counts, 0.50, hi),
            "p95": self.percentile_of(counts, 0.95, hi),
            "p99": self.percentile_of(counts, 0.99, hi),
        }


class Timer(Histogram):
    """Latency histogram in nanoseconds. Keeps the legacy flat-timer
    surface (``count``/``total_ns``/``max_ns``/``mean_ms``) on top of the
    bucket reservoir so p50/p95/p99 report uniformly everywhere the old
    mean/max timer did."""

    __slots__ = ()

    def update(self, elapsed_ns: int) -> None:
        self.observe(float(elapsed_ns))

    @property
    def total_ns(self) -> int:
        return int(self.total)

    @property
    def max_ns(self) -> int:
        return int(self.max)

    @property
    def mean_ms(self) -> float:
        return (self.total / self.count) / 1e6 if self.count else 0.0

    def percentile_ms(self, q: float) -> float:
        return self.percentile(q) / 1e6


class TelemetryRegistry:
    """The process registry (reference: MetricManager.java:36), grown
    four metric kinds (counter/timer/histogram/gauge) plus a bounded
    per-kind run-record log (`record_run`) that surfaces structured
    execution records — e.g. the OLAP executor's per-run info — without
    private-attribute spelunking."""

    def __init__(self):
        self._counters: Dict[str, Counter] = {}
        self._timers: Dict[str, Timer] = {}
        self._histograms: Dict[str, Histogram] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._runs: Dict[str, deque] = {}
        self._lock = threading.Lock()

    # ------------------------------------------------------------ accessors
    def counter(self, name: str) -> Counter:
        c = self._counters.get(name)
        if c is None:
            with self._lock:
                c = self._counters.setdefault(name, Counter())
        return c

    def timer(self, name: str) -> Timer:
        t = self._timers.get(name)
        if t is None:
            with self._lock:
                t = self._timers.setdefault(name, Timer())
        return t

    def histogram(self, name: str) -> Histogram:
        h = self._histograms.get(name)
        if h is None:
            with self._lock:
                h = self._histograms.setdefault(name, Histogram())
        return h

    def gauge(self, name: str) -> Gauge:
        g = self._gauges.get(name)
        if g is None:
            with self._lock:
                g = self._gauges.setdefault(name, Gauge())
        return g

    def set_gauge(self, name: str, value: float) -> None:
        self.gauge(name).set(value)

    @contextmanager
    def time(self, name: str):
        t0 = time.perf_counter_ns()
        try:
            yield
        finally:
            self.timer(name).update(time.perf_counter_ns() - t0)

    # ---------------------------------------------------------- run records
    def record_run(self, kind: str, info: dict, keep: int = 32) -> None:
        """Append one structured execution record (e.g. an OLAP run's
        ``{"path", "supersteps", "wall_s", "superstep_records", ...}``)."""
        with self._lock:
            dq = self._runs.get(kind)
            if dq is None:
                dq = self._runs.setdefault(kind, deque(maxlen=keep))
        dq.append(dict(info))

    def runs(self, kind: str) -> List[dict]:
        dq = self._runs.get(kind)
        return [dict(r) for r in dq] if dq else []

    def last_run(self, kind: str) -> Optional[dict]:
        dq = self._runs.get(kind)
        return dict(dq[-1]) if dq else None

    # ------------------------------------------------------------- reporting
    def metric_objects(self):
        """Stable shallow copies of the four metric maps (for renderers)."""
        with self._lock:
            return (
                dict(self._counters),
                dict(self._timers),
                dict(self._histograms),
                dict(self._gauges),
            )

    def snapshot(self) -> Dict[str, dict]:
        """ONE dict over all metric kinds in stable dotted-name order, so
        snapshot diffs are deterministic regardless of kind or insertion
        order. Timers and histograms report count + percentiles uniformly
        (the old reporter asymmetry — counters with counts, timers with
        mean/max only — is gone)."""
        counters, timers, histograms, gauges = self.metric_objects()
        out: Dict[str, dict] = {}
        names = sorted(
            set(counters) | set(timers) | set(histograms) | set(gauges)
        )
        for name in names:
            if name in counters:
                out[name] = {"type": "counter", "count": counters[name].count}
            elif name in timers:
                # one state() read per timer: count/total/percentiles stay
                # mutually consistent under concurrent updates
                count, total, hi, counts = timers[name].state()
                out[name] = {
                    "type": "timer",
                    "count": count,
                    "total_ms": total / 1e6,
                    "mean_ms": (total / count) / 1e6 if count else 0.0,
                    "max_ms": hi / 1e6,
                    "p50_ms": Histogram.percentile_of(counts, 0.50, hi) / 1e6,
                    "p95_ms": Histogram.percentile_of(counts, 0.95, hi) / 1e6,
                    "p99_ms": Histogram.percentile_of(counts, 0.99, hi) / 1e6,
                }
            elif name in histograms:
                h = histograms[name]
                out[name] = {"type": "histogram", **h.summary()}
            else:
                out[name] = {"type": "gauge", "value": gauges[name].value}
        return out

    def report(self) -> str:
        """Console reporter (reference: console reporter config
        GraphDatabaseConfiguration.java:1012). Same columns for every
        latency metric: count, mean, p50, p95, p99, total."""
        lines = [
            f"{'name':46} {'count':>9} {'mean_ms':>9} {'p50_ms':>9} "
            f"{'p95_ms':>9} {'p99_ms':>9} {'total_ms':>10}"
        ]
        for name, m in self.snapshot().items():
            if m["type"] == "counter":
                lines.append(f"{name:46} {m['count']:>9}")
            elif m["type"] == "gauge":
                lines.append(f"{name:46} {'':>9} {m['value']:>9.3f}")
            elif m["type"] == "histogram":
                lines.append(
                    f"{name:46} {m['count']:>9} {'':>9} {m['p50']:>9.3f} "
                    f"{m['p95']:>9.3f} {m['p99']:>9.3f} {m['sum']:>10.2f}"
                )
            else:
                lines.append(
                    f"{name:46} {m['count']:>9} {m['mean_ms']:>9.3f} "
                    f"{m['p50_ms']:>9.3f} {m['p95_ms']:>9.3f} "
                    f"{m['p99_ms']:>9.3f} {m['total_ms']:>10.2f}"
                )
        return "\n".join(lines)

    def get_count(self, name: str) -> int:
        c = self._counters.get(name)
        if c is not None:
            return c.count
        t = self._timers.get(name)
        if t is not None:
            return t.count
        h = self._histograms.get(name)
        return h.count if h is not None else 0

    def reset(self) -> None:
        with self._lock:
            self._counters.clear()
            self._timers.clear()
            self._histograms.clear()
            self._gauges.clear()
            self._runs.clear()
