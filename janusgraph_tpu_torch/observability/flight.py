"""Black-box flight recorder: a bounded ring of salient events — the
port's copy of ``janusgraph_tpu/observability/flight.py``.

Counters say HOW OFTEN the self-healing paths fire; the flight recorder
says WHAT HAPPENED, IN ORDER. Producers append one small dict per salient
event; the ring is always on, cheap (dict + deque under one lock), and
bounded (``metrics.flight-buffer``).

Event categories the port records (the ``category`` field):

==================  =======================================================
``checkpoint``      an OLAP checkpoint was written (``action: save``), or
                    load fell back to ``.prev`` (``action: fallback``)
                    (olap/checkpoint.py)
``olap_resume``     an executor auto-resumed a preempted superstep run
                    (``executor``, ``attempt``, ``program``)
``delta_compact``   the warm delta snapshot folded its overlay into a new
                    base (olap/delta.py; ``depth``, ``edges``,
                    ``vertices``, ``wall_ms``, ``threshold``)
``slow_span``       a span crossed metrics.slow-op-threshold-ms (fed by the
                    tracer's ``on_slow`` hook)
``torn_recovery``   TornCommitRecovery rolled a tx forward or back
                    (core/txlog.py; ``action``, ``tx_id``, ``changes``)
``cdc_seal``        the durable CDC log sealed its tail into a segment
                    (storage/cdc.py; ``seq``, ``records``,
                    ``first_cursor``, ``first_epoch``, ``last_epoch``)
``cdc_replay``      a CDC replay was served or refused (``action``:
                    ``serve``, ``gap``, ``poison``, ``corrupt``)
``thread_error``    a background loop (a log's send or pull loop, the
                    history sampler, the profiler, the watchdog) caught an
                    exception and went on (``thread``, ``error``)
``server_error``    the query server hit an unhandled evaluation error
``health``          the /healthz status flipped ok -> degraded
``brownout``        the admission controller's ladder changed rungs
                    (server/admission.py; ``rung``, ``direction``,
                    ``reason``)
``spillover``       the spillover planner promoted a digest or spilled a
                    traversal (olap/spillover.py)
``spillover_fallback``  a promoted shape fell back to the row walk
                    (``digest``, ``reason``)
``slo_burn``        the SLO engine's alert ladder moved (observability/
                    slo.py; ``slo``, ``kind``, ``severity``, ``direction``,
                    ``fast_burn``, ``slow_burn``, ``objective``)
``lock_convoy``     the stall watchdog caught a thread blocked on an
                    instrumented lock (observability/continuous.py;
                    ``lock``, ``waiter``, ``wait_s``, ``owner``,
                    ``owner_stack``, ``wait_for``)
``stall``           a progress source reported active work whose progress
                    did not move for the stall window (``source``,
                    ``active``, ``stuck_s``, ``progress``)
``bundle``          a forensics bundle was written (``reason``, ``path``)
``multihost``       the process group's formation (``action``: ``init``,
                    ``init_ok``, ``init_failed``; ``processes``,
                    ``process_id``; parallel/multihost.py)
==================  =======================================================

Dump triggers: an unhandled server error, the /healthz ok->degraded flip,
``GET /flight?dump=1`` and ``dump()``. Dumps are JSON files under
``metrics.flight-dump-dir`` (default: the system temp dir) named
``flight-<pid>-<n>.json``.

Every event carries a monotonic ``seq``, a wall-clock ``ts`` and a
monotonic-clock ``mono`` stamp: ``ts`` is what humans read, ``mono`` is
what in-process interval math reads. All other fields are
producer-supplied.
"""

from __future__ import annotations

import json
import os
import tempfile
import threading
import time
from collections import deque
from typing import Dict, List, Optional

from janusgraph_tpu_torch.observability.spans import _plain


class FlightRecorder:
    def __init__(self, capacity: int = 512, dump_dir: str = ""):
        self._ring: deque = deque(maxlen=capacity)
        self._counts: Dict[str, int] = {}
        self._seq = 0
        self._dumps = 0
        self.dump_dir = dump_dir
        self.last_dump_path: Optional[str] = None
        self.last_dump_ts: Optional[float] = None
        self._lock = threading.Lock()
        #: per-event hooks (the telemetry bus); called after the ring lock
        #: is released, exceptions swallowed
        self._listeners: List = []

    def add_listener(self, fn) -> None:
        """Register a per-event hook (the streaming telemetry bus); runs
        on the recording thread after the event lands."""
        if fn not in self._listeners:
            self._listeners.append(fn)

    def remove_listener(self, fn) -> None:
        if fn in self._listeners:
            self._listeners.remove(fn)

    def configure(
        self,
        capacity: Optional[int] = None,
        dump_dir: Optional[str] = None,
    ) -> None:
        with self._lock:
            if capacity is not None and capacity != self._ring.maxlen:
                self._ring = deque(self._ring, maxlen=capacity)
            if dump_dir is not None:
                self.dump_dir = dump_dir

    # -------------------------------------------------------------- recording
    def record(self, category: str, **fields) -> dict:
        """Append one event. Values are coerced to JSON-friendly host
        scalars (same contract as span attributes — never call this while
        a CUDA graph is being captured). When the process carries a
        replica tag (observability/identity.py) every event is stamped
        with it, so cross-replica incident timelines merge by `replica`."""
        from janusgraph_tpu_torch.observability.identity import replica_name

        replica = replica_name()
        with self._lock:
            self._seq += 1
            event = {
                "seq": self._seq,
                "ts": time.time(),
                "mono": time.monotonic(),
                "category": category,
                **({"replica": replica} if replica else {}),
                **{k: _plain(v) for k, v in fields.items()},
            }
            self._ring.append(event)
            self._counts[category] = self._counts.get(category, 0) + 1
            listeners = list(self._listeners)
        for fn in listeners:
            try:
                fn(event)
            except Exception:  # noqa: BLE001 - a listener must not kill recording
                pass
        return event

    @property
    def last_seq(self) -> int:
        """Sequence of the newest recorded event: the ``flight`` stream's
        cursor position (``/watch/info``)."""
        with self._lock:
            return self._seq

    # -------------------------------------------------------------- querying
    def events(self, category: Optional[str] = None) -> List[dict]:
        with self._lock:
            evs = [dict(e) for e in self._ring]
        if category is not None:
            evs = [e for e in evs if e["category"] == category]
        return evs

    def counts(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._counts)

    @property
    def occupancy(self) -> int:
        with self._lock:
            return len(self._ring)

    @property
    def capacity(self) -> int:
        return self._ring.maxlen or 0

    def health_block(self) -> dict:
        """The compact summary /healthz embeds under ``flight``."""
        with self._lock:
            return {
                "occupancy": len(self._ring),
                "capacity": self._ring.maxlen or 0,
                "last_dump": self.last_dump_path,
                "counts": dict(self._counts),
            }

    def snapshot(self) -> dict:
        """The full ``GET /flight`` payload."""
        with self._lock:
            return {
                "occupancy": len(self._ring),
                "capacity": self._ring.maxlen or 0,
                "total_recorded": self._seq,
                "last_dump": self.last_dump_path,
                "last_dump_ts": self.last_dump_ts,
                "counts": dict(self._counts),
                "events": [dict(e) for e in self._ring],
            }

    # ---------------------------------------------------------------- dumping
    def dump(self, reason: str = "manual", path: Optional[str] = None) -> Optional[str]:
        """Write the ring to a JSON file and return its path. Failures
        return None instead of raising: the recorder dumps on the way down
        and must never turn an incident into a second one."""
        with self._lock:
            self._dumps += 1
            payload = {
                "dumped_at": time.time(),
                "reason": reason,
                "pid": os.getpid(),
                "total_recorded": self._seq,
                "counts": dict(self._counts),
                "events": [dict(e) for e in self._ring],
            }
            n = self._dumps
            directory = self.dump_dir or tempfile.gettempdir()
        if path is None:
            path = os.path.join(directory, f"flight-{os.getpid()}-{n}.json")
        try:
            os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
            tmp = path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(payload, f, default=str)
            os.replace(tmp, path)
        except OSError:
            return None
        from janusgraph_tpu_torch.observability import registry

        registry.counter("flight.dumps").inc()
        with self._lock:
            self.last_dump_path = path
            self.last_dump_ts = payload["dumped_at"]
        return path

    def reset(self) -> None:
        with self._lock:
            self._ring.clear()
            self._counts.clear()
            self._seq = 0
            self._dumps = 0
            self.last_dump_path = None
            self.last_dump_ts = None
            self._listeners.clear()


#: process-wide recorder; every producer site appends here and
#: ``GET /flight`` reads it back
recorder = FlightRecorder()
