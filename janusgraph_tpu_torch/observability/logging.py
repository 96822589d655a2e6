"""Structured JSON logging with ambient trace correlation — the port's
copy of ``janusgraph_tpu/observability/logging.py``.

One-line-JSON log records that carry the ``trace_id``/``span_id`` of the
tracer's current span, so a grep for one trace id walks the same incident
as the span tree.

Records always land in a bounded in-process ring (``recent()``); they are
written to a stream only once one is configured (:func:`configure`). The
default is ring-only, so library users and the test suite get no stderr
noise.

Host-only like every other telemetry call: nothing is emitted from inside
a CUDA-graph capture.
"""

from __future__ import annotations

import json
import threading
import time
from collections import deque
from typing import Dict, List, Optional

from janusgraph_tpu_torch.observability.spans import _plain, tracer

_RING_LIMIT = 256

_lock = threading.Lock()
_ring: deque = deque(maxlen=_RING_LIMIT)
_stream = None
_loggers: Dict[str, "StructuredLogger"] = {}


def configure(stream=None, ring_size: Optional[int] = None) -> None:
    """Set (or clear, with None) the output stream; optionally resize the
    in-process ring."""
    global _stream, _ring
    with _lock:
        _stream = stream
        if ring_size is not None and ring_size != _ring.maxlen:
            _ring = deque(_ring, maxlen=ring_size)


def recent(level: Optional[str] = None) -> List[dict]:
    with _lock:
        records = [dict(r) for r in _ring]
    if level is not None:
        records = [r for r in records if r["level"] == level]
    return records


def reset() -> None:
    with _lock:
        _ring.clear()


class StructuredLogger:
    """Named emitter. ``info/warning/error(event, **fields)`` builds one
    flat JSON record: ts, level, logger, event, trace/span ids (when a
    span is ambient), then the caller's fields."""

    __slots__ = ("name",)

    def __init__(self, name: str):
        self.name = name

    def _emit(self, level: str, event: str, fields: dict) -> dict:
        from janusgraph_tpu_torch.observability.identity import replica_name

        record = {
            "ts": time.time(),
            "level": level,
            "logger": self.name,
            "event": event,
        }
        replica = replica_name()
        if replica:
            # fleet deployments tag every record with the producing
            # replica so one grep walks an incident across the fleet
            record["replica"] = replica
        span = tracer.current()
        if span is not None:
            record["trace_id"] = f"{span.trace_id:016x}"
            record["span_id"] = f"{span.span_id:016x}"
        for k, v in fields.items():
            record[k] = _plain(v)
        with _lock:
            _ring.append(record)
            stream = _stream
        if stream is not None:
            try:
                stream.write(json.dumps(record, default=str) + "\n")
            except (OSError, ValueError):
                pass  # a dead stream must not fail the operation being logged
        return record

    def info(self, event: str, **fields) -> dict:
        return self._emit("info", event, fields)

    def warning(self, event: str, **fields) -> dict:
        return self._emit("warning", event, fields)

    def error(self, event: str, **fields) -> dict:
        return self._emit("error", event, fields)


def get_logger(name: str) -> StructuredLogger:
    logger = _loggers.get(name)
    if logger is None:
        with _lock:
            logger = _loggers.setdefault(name, StructuredLogger(name))
    return logger
