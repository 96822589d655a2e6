"""Operation metrics: the registry facade, the instrumented-store wrapper
and the periodic reporters — the port's copy of
``janusgraph_tpu/util/metrics.py``.

The registry lives in ``janusgraph_tpu_torch/observability/``; this module
re-exports it as ``metrics``. ``MetricInstrumentedStore`` times every call
of a raw store under ``<prefix>.<store>.<op>`` (histogram-backed timers)
and runs it inside a ``store.<op>`` span, so storage work nests under the
transaction or scan span that is current. ``Backend`` wraps its raw stores
with it when ``metrics.enabled`` is set, as the reference's Backend does
(reference: diskstorage/util/MetricInstrumentedStore.java, wrapped at
Backend.java:184-188). A multi-key slice reaches the wrapped store's own
``get_slice_multi`` (the remote store's parallel fan-out, the sharded
store's per-node batches) as one ``getSliceMulti`` call, and a lock claim
is timed as ``acquireLock``, as in the reference. ``MetricManager`` is
the reference's historical name for the registry class.
"""

from __future__ import annotations

import threading
import time
from typing import Optional

from janusgraph_tpu_torch.observability import registry as metrics, span
from janusgraph_tpu_torch.observability.metrics_core import (
    BUCKET_BOUNDS,
    Counter,
    Gauge,
    Histogram,
    TelemetryRegistry,
    Timer,
)
from janusgraph_tpu_torch.storage.kcvs import KeyColumnValueStore, StoreTransaction

#: historical name for the registry class (graphs can still carry private
#: managers; per-tx groups use name prefixes instead)
MetricManager = TelemetryRegistry

__all__ = [
    "BUCKET_BOUNDS",
    "Counter",
    "Gauge",
    "Histogram",
    "MetricInstrumentedStore",
    "MetricManager",
    "PeriodicReporter",
    "TelemetryRegistry",
    "Timer",
    "metrics",
]


class PeriodicReporter:
    """Background reporter thread: periodically renders the registry to the
    console or to per-metric CSV files (reference: the reporter plumbing of
    GraphDatabaseConfiguration.java:1012-1094). Started at graph open when
    metrics.console-interval-ms / metrics.csv-interval-ms are set."""

    def __init__(
        self,
        manager: MetricManager,
        interval_ms: float,
        mode: str = "console",
        directory: str = "",
        prefix: str = "janusgraph",
        sink=None,
    ):
        if mode not in ("console", "csv"):
            raise ValueError(f"unknown reporter mode {mode!r}")
        if mode == "csv" and not directory:
            raise ValueError("csv reporter requires metrics.csv-directory")
        self.manager = manager
        self.interval_s = interval_ms / 1000.0
        self.mode = mode
        self.directory = directory
        self.prefix = prefix
        self._sink = sink if sink is not None else print
        self._stop = threading.Event()
        self._thread: "threading.Thread | None" = None

    def start(self) -> "PeriodicReporter":
        self._thread = threading.Thread(
            target=self._loop, daemon=True, name=f"metrics-{self.mode}"
        )
        self._thread.start()
        return self

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.flush()
            except Exception as e:  # noqa: BLE001 — reporting must not die
                self._sink(f"metrics reporter error: {e}")

    def flush(self) -> None:
        """One reporting tick (also callable directly, e.g. at close)."""
        if self.mode == "console":
            self._sink(
                f"-- metrics [{self.prefix}] @ {time.strftime('%H:%M:%S')}\n"
                + self.manager.report()
            )
            return
        import os
        import re

        os.makedirs(self.directory, exist_ok=True)
        now = time.time()
        for name, m in self.manager.snapshot().items():
            # metric names embed caller-supplied group strings: flatten
            # anything path-like so files cannot escape csv-directory
            safe = re.sub(r"[^\w.\-]", "_", f"{self.prefix}.{name}")
            path = os.path.join(self.directory, f"{safe}.csv")
            new = not os.path.exists(path)
            with open(path, "a") as f:
                if m["type"] == "counter":
                    if new:
                        f.write("t,count\n")
                    f.write(f"{now:.3f},{m['count']}\n")
                elif m["type"] == "gauge":
                    if new:
                        f.write("t,value\n")
                    f.write(f"{now:.3f},{m['value']:.6g}\n")
                elif m["type"] == "histogram":
                    if new:
                        f.write("t,count,sum,p50,p95,p99,max\n")
                    f.write(
                        f"{now:.3f},{m['count']},{m['sum']:.6g},"
                        f"{m['p50']:.6g},{m['p95']:.6g},{m['p99']:.6g},"
                        f"{m['max']:.6g}\n"
                    )
                else:
                    if new:
                        f.write(
                            "t,count,mean_ms,total_ms,max_ms,"
                            "p50_ms,p95_ms,p99_ms\n"
                        )
                    f.write(
                        f"{now:.3f},{m['count']},{m['mean_ms']:.3f},"
                        f"{m['total_ms']:.2f},{m['max_ms']:.3f},"
                        f"{m['p50_ms']:.3f},{m['p95_ms']:.3f},"
                        f"{m['p99_ms']:.3f}\n"
                    )

    def stop(self, final_flush: bool = True) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
        if final_flush:
            self.flush()


class MetricInstrumentedStore(KeyColumnValueStore):
    """Times + counts every store operation (reference:
    MetricInstrumentedStore.java). Metric names: `<prefix>.<store>.<op>`,
    histogram-backed timers; each call runs inside a `store.<op>` span."""

    def __init__(
        self,
        store: KeyColumnValueStore,
        manager: Optional[MetricManager] = None,
        prefix: str = "storage",
        merge_stores: bool = False,
    ):
        self._store = store
        self._m = manager if manager is not None else metrics
        # metrics.merge-stores: one "stores" bucket instead of per-store
        # names (reference: MERGE_BASIC_METRICS / generateName)
        bucket = "stores" if merge_stores else store.name
        self._prefix = f"{prefix}.{bucket}"

    @property
    def name(self) -> str:
        return self._store.name

    @property
    def wrapped(self) -> KeyColumnValueStore:
        return self._store

    def _timed(self, op: str):
        return self._m.time(f"{self._prefix}.{op}")

    def get_slice(self, query, txh: StoreTransaction):
        with span("store.getSlice", store=self._store.name):
            with self._timed("getSlice"):
                return self._store.get_slice(query, txh)

    def get_slice_multi(self, keys, query, txh: StoreTransaction):
        with span("store.getSliceMulti", store=self._store.name,
                  keys=len(keys)):
            with self._timed("getSliceMulti"):
                return self._store.get_slice_multi(keys, query, txh)

    def mutate(self, key, additions, deletions, txh: StoreTransaction):
        with span("store.mutate", store=self._store.name,
                  additions=len(additions), deletions=len(deletions)):
            with self._timed("mutate"):
                return self._store.mutate(key, additions, deletions, txh)

    def acquire_lock(self, key, column, expected, txh: StoreTransaction):
        with span("store.acquireLock", store=self._store.name):
            with self._timed("acquireLock"):
                return self._store.acquire_lock(key, column, expected, txh)

    def get_keys(self, query, txh: StoreTransaction):
        # time only the store's own fetch work (per next), not the
        # consumer's per-row processing; one timer update per scan, recorded
        # even if the consumer abandons the iterator
        name = f"{self._prefix}.getKeys"
        total = 0
        it = self._store.get_keys(query, txh)
        try:
            while True:
                t0 = time.perf_counter_ns()
                try:
                    item = next(it)
                except StopIteration:
                    total += time.perf_counter_ns() - t0
                    return
                total += time.perf_counter_ns() - t0
                yield item
        finally:
            self._m.timer(name).update(total)

    def close(self) -> None:
        self._store.close()
