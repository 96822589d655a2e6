"""Process replica identity — the port's copy of
``janusgraph_tpu/observability/identity.py``.

One tag threaded through every telemetry plane: ``set_replica()`` once at
process start, and the flight recorder, the structured logger and the
Prometheus exposition stamp their output with it. The default is the
empty string, so a single process stays untagged.

Dependency-free (flight.py and logging.py import it).
"""

from __future__ import annotations

import threading

_LOCK = threading.Lock()
_REPLICA = ""


def set_replica(name: str) -> None:
    """Set this process's replica tag ('' clears it)."""
    global _REPLICA
    with _LOCK:
        _REPLICA = str(name or "")


def replica_name() -> str:
    """The process's replica tag ('' when untagged)."""
    with _LOCK:
        return _REPLICA
