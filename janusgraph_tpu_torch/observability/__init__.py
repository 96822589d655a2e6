"""Telemetry of the port: histogram metrics, structured spans, the flight
recorder, roofline run records and their renderings, and the plane the
query server and the fleet read — the port's copy of
``janusgraph_tpu/observability/``.

Layout:

- ``metrics_core``: :class:`Counter`, :class:`Timer`, :class:`Histogram`,
  :class:`Gauge` and :class:`TelemetryRegistry`, the registry that
  ``janusgraph_tpu_torch.util.metrics`` re-exports as ``metrics``.
- ``spans``: the context-var tracer with parent/child nesting and the
  always-on slow-op ring.
- ``flight``: the black-box ring of salient events; ``logging``: JSON log
  records carrying the current trace; ``identity``: the replica tag.
- ``profiler``: device peaks, the roofline records, the resource ledger,
  the query digests with their price book, and the flame export.
- ``timeseries``: the bounded ring of registry snapshots (``history``);
  ``slo``: burn-rate SLOs over it (``slo_engine``); ``continuous``: the
  sampling profiler, the instrumented lock, the stall watchdog and the
  forensics bundles; ``stream``: the push telemetry bus behind the
  server's ``/watch``. The server starts their threads; a graph open only
  sizes them.
- ``exposition``: Prometheus text and the JSON snapshot; ``timeline``:
  Chrome-trace rendering of a run record.
- ``federation``: the fleet frontend's view over its replicas: merged
  history windows (exact merged percentiles), clock offsets, the fleet
  SLOs, the push-mode transport, shipped bundles and the cross-replica
  incident timeline.

Recording is host-only: no metric, span, flight or ledger call may run
while a CUDA graph is being captured (it would run once, at capture, and
never on replay). The executor builds its run record on the host after
the run's final fetch.

- ``benchdiff``: the bench regression sentinel (per-cell verdicts
  between two bench artifacts), behind the ``benchdiff`` subcommand.
"""

from janusgraph_tpu_torch.observability.continuous import (
    BundleWriter,
    InstrumentedLock,
    SamplingProfiler,
    StallWatchdog,
    bundle_writer,
    flame_from_artifact,
    flamediff,
    sampling_profiler,
    watchdog,
)
from janusgraph_tpu_torch.observability.exposition import (
    json_snapshot,
    prometheus_text,
)
from janusgraph_tpu_torch.observability.federation import (
    ClockOffsets,
    FleetBundleStore,
    FleetFederation,
    FleetHistory,
    fleet_default_specs,
    merge_incident_events,
    merge_series,
    merge_windows,
)
from janusgraph_tpu_torch.observability.flight import FlightRecorder
from janusgraph_tpu_torch.observability.flight import recorder as flight_recorder
from janusgraph_tpu_torch.observability.identity import (
    replica_name,
    set_replica,
)
from janusgraph_tpu_torch.observability.logging import (
    StructuredLogger,
    get_logger,
)
from janusgraph_tpu_torch.observability.metrics_core import (
    BUCKET_BOUNDS,
    Counter,
    Gauge,
    Histogram,
    TelemetryRegistry,
    Timer,
)
from janusgraph_tpu_torch.observability.profiler import (
    DigestTable,
    ResourceLedger,
    accrue,
    accrue_wall,
    current_ledger,
    digest_table,
    flame_lines,
    ledger_scope,
)
from janusgraph_tpu_torch.observability.slo import (
    SLOEngine,
    SLOSpec,
    slo_engine,
)
from janusgraph_tpu_torch.observability.spans import (
    Span,
    TraceContext,
    Tracer,
    capture_scope,
    tracer,
)
from janusgraph_tpu_torch.observability.stream import (
    STREAMS,
    Subscription,
    TelemetryBus,
    telemetry_bus,
)
from janusgraph_tpu_torch.observability.timeline import (
    chrome_trace,
    render_run,
)
from janusgraph_tpu_torch.observability.timeseries import (
    MetricsHistory,
    history,
)

#: process-wide registry; `janusgraph_tpu_torch.util.metrics.metrics` is
#: THIS object
registry = TelemetryRegistry()

#: convenience alias: `with span("name", attr=...):` on the global tracer
span = tracer.span


def _slow_span_to_flight(event: dict) -> None:
    flight_recorder.record(
        "slow_span",
        name=event["name"],
        ms=event["ms"],
        trace_id=event.get("trace_id"),
        span_id=event.get("span_id"),
        digest=event.get("attrs", {}).get("digest"),
    )


# every span crossing the slow-op threshold also lands in the black box
tracer.on_slow = _slow_span_to_flight

__all__ = [
    "BUCKET_BOUNDS",
    "BundleWriter",
    "ClockOffsets",
    "Counter",
    "DigestTable",
    "FleetBundleStore",
    "FleetFederation",
    "FleetHistory",
    "FlightRecorder",
    "Gauge",
    "Histogram",
    "InstrumentedLock",
    "MetricsHistory",
    "ResourceLedger",
    "SLOEngine",
    "SLOSpec",
    "STREAMS",
    "SamplingProfiler",
    "Span",
    "StallWatchdog",
    "StructuredLogger",
    "Subscription",
    "TelemetryBus",
    "TelemetryRegistry",
    "Timer",
    "TraceContext",
    "Tracer",
    "accrue",
    "accrue_wall",
    "bundle_writer",
    "capture_scope",
    "chrome_trace",
    "current_ledger",
    "digest_table",
    "flame_from_artifact",
    "flame_lines",
    "flamediff",
    "flight_recorder",
    "fleet_default_specs",
    "get_logger",
    "history",
    "json_snapshot",
    "ledger_scope",
    "merge_incident_events",
    "merge_series",
    "merge_windows",
    "prometheus_text",
    "registry",
    "render_run",
    "replica_name",
    "sampling_profiler",
    "set_replica",
    "slo_engine",
    "span",
    "telemetry_bus",
    "tracer",
    "watchdog",
]
