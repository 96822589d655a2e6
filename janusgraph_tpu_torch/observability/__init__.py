"""Telemetry of the port: histogram metrics, structured spans, the flight
recorder, roofline run records and their renderings — the port's copy of
``janusgraph_tpu/observability/`` as far as the OLAP path and the
transaction use it.

Layout:

- ``metrics_core``: :class:`Counter`, :class:`Timer`, :class:`Histogram`,
  :class:`Gauge` and :class:`TelemetryRegistry`, the registry that
  ``janusgraph_tpu_torch.util.metrics`` re-exports as ``metrics``.
- ``spans``: the context-var tracer with parent/child nesting and the
  always-on slow-op ring.
- ``flight``: the black-box ring of salient events; ``logging``: JSON log
  records carrying the current trace; ``identity``: the replica tag.
- ``profiler``: device peaks, the roofline records, the resource ledger
  and the flame export.
- ``exposition``: Prometheus text and the JSON snapshot; ``timeline``:
  Chrome-trace rendering of a run record.

Recording is host-only: no metric, span, flight or ledger call may run
while a CUDA graph is being captured (it would run once, at capture, and
never on replay). The executor builds its run record on the host after
the run's final fetch.

The modules that serve the query server and the remote store (continuous
profiling, federation, SLOs, the telemetry stream, the metric history,
bench diffs, the price book and the digest table) are ROADMAP Queue A #5.
"""

from janusgraph_tpu_torch.observability.exposition import (
    json_snapshot,
    prometheus_text,
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
    ResourceLedger,
    accrue,
    accrue_wall,
    current_ledger,
    flame_lines,
    ledger_scope,
)
from janusgraph_tpu_torch.observability.spans import (
    Span,
    TraceContext,
    Tracer,
    capture_scope,
    tracer,
)
from janusgraph_tpu_torch.observability.timeline import (
    chrome_trace,
    render_run,
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
    "Counter",
    "FlightRecorder",
    "Gauge",
    "Histogram",
    "ResourceLedger",
    "Span",
    "StructuredLogger",
    "TelemetryRegistry",
    "Timer",
    "TraceContext",
    "Tracer",
    "accrue",
    "accrue_wall",
    "capture_scope",
    "chrome_trace",
    "current_ledger",
    "flame_lines",
    "flight_recorder",
    "get_logger",
    "json_snapshot",
    "ledger_scope",
    "prometheus_text",
    "registry",
    "render_run",
    "replica_name",
    "set_replica",
    "span",
    "tracer",
]
