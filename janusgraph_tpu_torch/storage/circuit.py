"""Circuit breaker for networked backend clients: the port's copy of
``janusgraph_tpu/storage/circuit.py``.

The retry guard (storage/backend_op.py) absorbs *transient* flake; a
breaker handles the other regime — a backend that is DOWN. Without one,
every caller burns its full retry budget against a dead endpoint (the
thundering-retry problem the reference inherits from BackendOperation's
unconditional replay loop). With one, the first caller pays the probes and
everyone else fails fast until the backend proves healthy again.

Classic three-state machine:

  CLOSED     normal operation; `failure_threshold` CONSECUTIVE temporary
             failures trip it open
  OPEN       every call raises CircuitOpenError immediately (no network
             touch) until `reset_timeout_s` elapses
  HALF_OPEN  up to `half_open_probes` concurrent calls go through as
             probes; one success closes the breaker, one failure re-opens
             it (fresh timeout)

Failure accounting: only ``TemporaryBackendError`` counts — a
``PermanentBackendError`` means the backend *responded* (an application
error, not an availability signal) and resets the consecutive-failure
count. ``CircuitOpenError`` subclasses ``PermanentBackendError`` so the
retry guard propagates it immediately instead of spinning on an open
circuit.

Observability: per-breaker state gauge ``breaker.<name>.state``
(0 closed / 1 half-open / 2 open), trip counter ``breaker.<name>.trips``,
and fail-fast counter ``breaker.<name>.rejected``; every transition is a
flight-recorder event and a structured warning.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, TypeVar

from janusgraph_tpu_torch.exceptions import (
    CircuitOpenError,
    PermanentBackendError,
    TemporaryBackendError,
)

T = TypeVar("T")

CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half_open"

#: gauge encoding, stable across the exposition surface
STATE_VALUES = {CLOSED: 0.0, HALF_OPEN: 1.0, OPEN: 2.0}


class CircuitBreaker:
    def __init__(
        self,
        name: str,
        failure_threshold: int = 5,
        reset_timeout_s: float = 1.0,
        half_open_probes: int = 1,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.name = name
        self.failure_threshold = failure_threshold
        self.reset_timeout_s = reset_timeout_s
        self.half_open_probes = half_open_probes
        self._clock = clock
        self._state = CLOSED
        self._failures = 0
        self._open_until = 0.0
        self._probes_in_flight = 0
        self._lock = threading.Lock()
        self._published: str = ""
        self._publish(CLOSED)

    # -------------------------------------------------------------- telemetry
    def _publish(self, state: str) -> None:
        from janusgraph_tpu_torch.observability import (
            flight_recorder,
            get_logger,
            registry,
        )

        # graphlint: disable=JG110 -- breaker names are one-per-protocol (store/index remote managers): a fixed, tiny set
        registry.set_gauge(
            f"breaker.{self.name}.state", STATE_VALUES[state]
        )
        prev, self._published = self._published, state
        if prev and prev != state:
            # every state transition is a flight-recorder event: the
            # reconstructable timeline of a failover, not just a gauge
            flight_recorder.record(
                "breaker", name=self.name, from_state=prev, to_state=state,
            )
            get_logger("storage.circuit").warning(
                "breaker-transition",
                breaker=self.name, from_state=prev, to_state=state,
            )

    def _trip(self) -> None:
        from janusgraph_tpu_torch.observability import registry

        self._state = OPEN
        self._open_until = self._clock() + self.reset_timeout_s
        self._failures = 0
        self._probes_in_flight = 0
        # graphlint: disable=JG110 -- breaker names are one-per-protocol: a fixed, tiny set
        registry.counter(f"breaker.{self.name}.trips").inc()
        self._publish(OPEN)

    @property
    def state(self) -> str:
        with self._lock:
            # surface the would-be transition so callers polling state see
            # half-open as soon as the window elapses
            if self._state == OPEN and self._clock() >= self._open_until:
                return HALF_OPEN
            return self._state

    # -------------------------------------------------------------- protocol
    def _before_attempt(self) -> bool:
        """Admit or reject one attempt; returns True when the attempt is a
        half-open probe (must be accounted on completion)."""
        from janusgraph_tpu_torch.observability import registry

        with self._lock:
            if self._state == OPEN:
                if self._clock() < self._open_until:
                    # graphlint: disable=JG110 -- breaker names are one-per-protocol: a fixed, tiny set
                    registry.counter(f"breaker.{self.name}.rejected").inc()
                    raise CircuitOpenError(
                        f"circuit {self.name} is open (fail-fast; retry "
                        f"window {self.reset_timeout_s}s)"
                    )
                self._state = HALF_OPEN
                self._probes_in_flight = 0
                self._publish(HALF_OPEN)
            if self._state == HALF_OPEN:
                if self._probes_in_flight >= self.half_open_probes:
                    # graphlint: disable=JG110 -- breaker names are one-per-protocol: a fixed, tiny set
                    registry.counter(f"breaker.{self.name}.rejected").inc()
                    raise CircuitOpenError(
                        f"circuit {self.name} is half-open and its probe "
                        "slots are taken (fail-fast)"
                    )
                self._probes_in_flight += 1
                return True
            return False

    def _on_success(self, probe: bool) -> None:
        with self._lock:
            self._failures = 0
            if self._state == HALF_OPEN:
                self._state = CLOSED
                self._probes_in_flight = 0
                self._publish(CLOSED)
            elif probe:
                self._probes_in_flight = max(0, self._probes_in_flight - 1)

    def _on_failure(self, probe: bool) -> None:
        with self._lock:
            if self._state == HALF_OPEN:
                self._trip()
                return
            if probe:
                self._probes_in_flight = max(0, self._probes_in_flight - 1)
            self._failures += 1
            if self._failures >= self.failure_threshold:
                self._trip()

    def call(self, fn: Callable[[], T]) -> T:
        """Run one backend attempt through the breaker."""
        probe = self._before_attempt()
        try:
            result = fn()
        except TemporaryBackendError:
            self._on_failure(probe)
            raise
        except PermanentBackendError:
            # the backend answered: availability-wise that is a success
            self._on_success(probe)
            raise
        self._on_success(probe)
        return result
