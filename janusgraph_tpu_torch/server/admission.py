"""Cost-aware admission control for the serving path — the port's copy of
``janusgraph_tpu/server/admission.py``.

The reference's Gremlin Server defends itself with a bounded worker pool
and a request timeout — a blind thread cap. This framework has strictly
better raw material: measured per-shape costs (the digest table),
circuit-breaker state, and a flight recorder. This module turns them into
an *adaptive* defense in front of every query request (HTTP, WS, and
in-session traffic alike — they all funnel through ``_run_request``):

- **AIMD concurrency limit** (:class:`AIMDLimiter`): the admitted
  concurrency adapts to observed latency against a windowed baseline —
  additive increase while the window median stays near the baseline,
  multiplicative decrease when it inflates past the threshold. The limit
  finds the knee of the latency curve instead of a hand-tuned constant
  (the classic TCP congestion-avoidance shape, applied to request
  concurrency the way Netflix's concurrency-limits library does).

- **Bounded cost-priority wait queue**: requests beyond the limit park in
  a bounded queue ordered by their shape's PRICE — the measured mean cost
  of the query's digest from a :class:`~janusgraph_tpu_torch.observability.
  profiler.DigestTable` price book (unknown shapes pay
  ``server.admission.default-cost-ms``). Cheap known work overtakes
  expensive work, so one heavy analytical shape cannot convoy a thousand
  point reads. System/observability traffic never queues at all.

- **Load shedding**: arrivals past the queue bound (or refused by a
  brownout rung) are shed immediately with a ``Retry-After`` hint drawn
  with decorrelated jitter — the same anti-convoy argument as the retry
  guard's backoff: if every shed client retried on the same schedule,
  the recovery itself would re-stampede the server.

- **Brownout ladder** (:class:`BrownoutLadder`): under *sustained*
  overload (sheds keep landing inside a sliding window) the server
  degrades in three hysteretic rungs rather than collapsing:

  1. shed span retention — request spans run unsampled, so the tracer's
     root ring and the ledger bookkeeping stop spending memory/cycles on
     traffic that is being dropped anyway;
  2. refuse OLAP ``submit()`` — analytical jobs are the biggest cost
     multiplier a query can trigger; refusing them protects OLTP goodput;
  3. admit only known-cheap digests — the last rung keeps the cheapest
     measured shapes flowing and sheds everything else.

  Each rung is entered fast (``brownout-enter-sheds`` within
  ``brownout-window-s``) and exited slowly (``brownout-exit-s`` with no
  sheds), with a minimum dwell between transitions so the ladder cannot
  flap; every transition is a flight-recorder ``brownout`` event.

Telemetry: gauges ``server.admission.limit`` / ``.in_flight`` /
``.queue_depth`` / ``.brownout_rung``; counters ``server.admission.
admitted`` / ``.queued`` / ``.shed`` / ``.queue_timeouts``. ``GET
/healthz`` folds them into an ``admission`` block (the observability
endpoints bypass admission, so a saturated server stays observable).
"""

from __future__ import annotations

import random
import re
import threading
import time
from typing import List, Optional, Tuple

from janusgraph_tpu_torch.exceptions import (
    DeadlineExceededError,
    ServerOverloadedError,
)

#: brownout rung semantics (see module docstring)
RUNG_NORMAL = 0
RUNG_SHED_SPANS = 1
RUNG_REFUSE_OLAP = 2
RUNG_CHEAP_ONLY = 3

#: literal strippers for the server-side query-text shape: string
#: literals collapse to $, numbers to #, whitespace squeezed — two
#: queries differing only in literals share a digest (and therefore a
#: measured price)
_STR_LIT_RE = re.compile(r"'[^']*'|\"[^\"]*\"")
_NUM_LIT_RE = re.compile(r"\b\d+(?:\.\d+)?\b")
_WS_RE = re.compile(r"\s+")


def query_shape(query: str) -> str:
    """Normalize a submitted query string to its shape (the admission
    analogue of profiler.traversal_shape, computable BEFORE execution)."""
    shape = _STR_LIT_RE.sub("$", query)
    shape = _NUM_LIT_RE.sub("#", shape)
    return _WS_RE.sub("", shape)


class ShedError(ServerOverloadedError):
    """Raised by :meth:`AdmissionController.acquire` when the request is
    load-shed (queue full, or a brownout rung refused it). Carries the
    jittered ``retry_after_s`` hint the response must echo."""

    def __init__(self, msg, retry_after_s: float, reason: str):
        super().__init__(msg, retry_after_s=retry_after_s)
        self.reason = reason


class AIMDLimiter:
    """Adaptive concurrency limit: additive increase, multiplicative
    decrease, driven by completed-request latency vs a windowed baseline.

    Pure bookkeeping — no clocks, no threads: callers feed it one latency
    per completion via :meth:`observe` and read :attr:`limit`. Every
    ``window`` completions it compares the window median against
    ``threshold x baseline``: above → ``limit *= beta`` (floored), below
    → ``limit += 1`` (capped) and the baseline tracks the median with a
    slow EWMA (only while healthy, so an overloaded server cannot inflate
    its own notion of "normal")."""

    #: the healthy-window baseline may never exceed this multiple of the
    #: best (lowest) window median the server has demonstrated: under a
    #: GRADUAL load ramp the plain EWMA is a boiling frog — each window's
    #: queue-inflated median drags the baseline up just enough that the
    #: next window still looks "healthy", and the decrease never fires
    #: (observed re-tuning the limiter for pipelined storage latencies).
    #: The floor itself decays upward 2% per window so a
    #: genuinely slower regime re-anchors instead of pinning forever.
    BASELINE_FLOOR_CAP = 1.25

    def __init__(
        self,
        initial: int = 8,
        min_limit: int = 1,
        max_limit: int = 64,
        window: int = 32,
        threshold: float = 2.0,
        beta: float = 0.7,
    ):
        self.min_limit = max(1, int(min_limit))
        self.max_limit = max(self.min_limit, int(max_limit))
        self.window = max(2, int(window))
        self.threshold = float(threshold)
        self.beta = float(beta)
        self._limit = float(
            min(self.max_limit, max(self.min_limit, int(initial)))
        )
        self.baseline_ms: Optional[float] = None
        #: best window median demonstrated (anchors the baseline)
        self.floor_ms: Optional[float] = None
        self._samples: List[float] = []

    @property
    def limit(self) -> int:
        return int(self._limit)

    def observe(self, latency_ms: float) -> None:
        """Record one completed request's latency; may adjust the limit
        (call under the controller's lock)."""
        self._samples.append(float(latency_ms))
        if len(self._samples) < self.window:
            return
        samples = sorted(self._samples)
        self._samples = []
        median = samples[len(samples) // 2]
        if self.floor_ms is None or median < self.floor_ms:
            self.floor_ms = median
        else:
            self.floor_ms *= 1.02  # slow re-anchor toward a new regime
        if self.baseline_ms is None:
            self.baseline_ms = median
            return
        if median > self.threshold * self.baseline_ms:
            self._limit = max(
                float(self.min_limit), self._limit * self.beta
            )
        else:
            self._limit = min(float(self.max_limit), self._limit + 1.0)
            # slow EWMA, healthy windows only — CLAMPED to the floor
            # anchor: a gradual ramp must not ratchet "normal" upward
            # window by window until overload reads as healthy
            self.baseline_ms = min(
                0.9 * self.baseline_ms + 0.1 * median,
                self.floor_ms * self.BASELINE_FLOOR_CAP,
            )


class BrownoutLadder:
    """Three-rung graded-degradation state machine with hysteresis.

    Escalates one rung when ``enter_sheds`` shed events land inside the
    sliding ``window_s``; de-escalates one rung after ``exit_s`` with no
    sheds. ``dwell_s`` is the minimum time between transitions in either
    direction. Every transition is recorded as a flight-recorder
    ``brownout`` event and mirrored to the ``server.admission.
    brownout_rung`` gauge. The clock is injectable for tests."""

    def __init__(
        self,
        window_s: float = 5.0,
        enter_sheds: int = 8,
        exit_s: float = 10.0,
        dwell_s: float = 2.0,
        clock=time.monotonic,
    ):
        self.window_s = float(window_s)
        self.enter_sheds = max(1, int(enter_sheds))
        self.exit_s = float(exit_s)
        self.dwell_s = float(dwell_s)
        self._clock = clock
        self.rung = RUNG_NORMAL
        self._shed_times: List[float] = []
        self._last_shed = float("-inf")
        self._last_transition = float("-inf")
        self._publish()

    def _publish(self, direction: str = "", reason: str = "") -> None:
        from janusgraph_tpu_torch.observability import registry

        registry.set_gauge("server.admission.brownout_rung", float(self.rung))
        if direction:
            from janusgraph_tpu_torch.observability import (
                flight_recorder,
                get_logger,
            )

            flight_recorder.record(
                "brownout", rung=self.rung, direction=direction,
                reason=reason,
            )
            get_logger("server.admission").warning(
                "brownout-transition",
                rung=self.rung, direction=direction, reason=reason,
            )

    def note_shed(self) -> None:
        """One shed event happened; may escalate (call under the
        controller's lock)."""
        now = self._clock()
        self._last_shed = now
        cutoff = now - self.window_s
        self._shed_times = [t for t in self._shed_times if t >= cutoff]
        self._shed_times.append(now)
        if (
            self.rung < RUNG_CHEAP_ONLY
            and len(self._shed_times) >= self.enter_sheds
            and now - self._last_transition >= self.dwell_s
        ):
            self.rung += 1
            self._last_transition = now
            self._shed_times = []  # a fresh burst is needed per rung
            self._publish(
                "enter",
                f"{self.enter_sheds} sheds within {self.window_s}s",
            )

    def note_healthy(self) -> None:
        """Periodic health tick (each completion / admit); may
        de-escalate (call under the controller's lock)."""
        if self.rung == RUNG_NORMAL:
            return
        now = self._clock()
        if (
            now - self._last_shed >= self.exit_s
            and now - self._last_transition >= self.dwell_s
        ):
            self.rung -= 1
            self._last_transition = now
            self._publish("exit", f"no sheds for {self.exit_s}s")

    def note_underload(self) -> None:
        """A shed happened while serving capacity sat IDLE (empty queue,
        free slots): the only source of such sheds is the ladder's own
        refusal rungs, so the shed stream must not keep the ladder up —
        that would livelock a rung-3 server at zero goodput while clients
        politely retry forever. De-escalate one rung after the dwell
        (call under the controller's lock)."""
        if self.rung == RUNG_NORMAL:
            return
        now = self._clock()
        if now - self._last_transition >= self.dwell_s:
            self.rung -= 1
            self._last_transition = now
            self._shed_times = []
            self._publish(
                "exit", "sheds with idle capacity (ladder-induced)",
            )


class _Ticket:
    __slots__ = ("exempt", "granted", "abandoned", "price_ms", "digest")

    def __init__(self, exempt: bool, price_ms: float = 0.0,
                 digest: str = ""):
        self.exempt = exempt
        self.granted = exempt
        self.abandoned = False
        self.price_ms = price_ms
        self.digest = digest


class AdmissionController:
    """The serving path's front door: price → admit | queue | shed.

    One instance per :class:`~janusgraph_tpu_torch.server.server.JanusGraphServer`
    (built from the ``server.admission.*`` options). Thread-safe; the
    wait queue is a cost-ordered heap under one condition variable.
    ``clock`` is injectable for deterministic brownout tests."""

    def __init__(
        self,
        initial_limit: int = 8,
        min_limit: int = 1,
        max_limit: int = 64,
        queue_bound: int = 32,
        window: int = 32,
        latency_threshold: float = 2.0,
        default_cost_ms: float = 25.0,
        cheap_cost_ms: float = 5.0,
        brownout_window_s: float = 5.0,
        brownout_enter_sheds: int = 8,
        brownout_exit_s: float = 10.0,
        brownout_dwell_s: float = 2.0,
        retry_after_base_s: float = 0.25,
        retry_after_max_s: float = 8.0,
        price_book_capacity: int = 128,
        clock=time.monotonic,
    ):
        from janusgraph_tpu_torch.observability.profiler import DigestTable

        self.limiter = AIMDLimiter(
            initial=initial_limit, min_limit=min_limit,
            max_limit=max_limit, window=window,
            threshold=latency_threshold,
        )
        self.brownout = BrownoutLadder(
            window_s=brownout_window_s, enter_sheds=brownout_enter_sheds,
            exit_s=brownout_exit_s, dwell_s=brownout_dwell_s, clock=clock,
        )
        self.queue_bound = int(queue_bound)
        self.default_cost_ms = float(default_cost_ms)
        self.cheap_cost_ms = float(cheap_cost_ms)
        self.retry_after_base_s = float(retry_after_base_s)
        self.retry_after_max_s = float(retry_after_max_s)
        #: the price book: measured mean wall per query-text digest (a
        #: DigestTable — same eviction/percentile machinery as the
        #: /profile table, fed by the server after each execution)
        self.price_book = DigestTable(capacity=price_book_capacity)
        self._cond = threading.Condition()
        self._in_flight = 0
        self._queue: List[Tuple[float, int, _Ticket]] = []  # cost heap
        self._seq = 0
        self._last_retry_after = retry_after_base_s
        self._gauges()

    # ------------------------------------------------------------- pricing
    def price(self, query: str) -> Tuple[str, float, bool]:
        """(digest, price_ms, known) for one submitted query string. The
        price is the digest's measured mean wall from the price book;
        unknown shapes pay the default price."""
        from janusgraph_tpu_torch.observability.profiler import shape_digest

        shape = query_shape(query)
        digest = shape_digest("server>" + shape)
        mean = self.price_book.mean_cost_ms(digest)
        if mean is None:
            return digest, self.default_cost_ms, False
        return digest, mean, True

    def observe_cost(
        self, digest: str, query: str, wall_ms: float, cells: int = 0
    ) -> None:
        """Feed one measured execution back into the price book."""
        self.price_book.observe(
            digest, "server>" + query_shape(query), wall_ms, cells=cells
        )

    # ----------------------------------------------------------- admission
    def acquire(
        self,
        price_ms: float = 0.0,
        known: bool = True,
        digest: str = "",
        exempt: bool = False,
        timeout_s: Optional[float] = None,
    ) -> _Ticket:
        """Admit one request, parking it in the cost-priority queue when
        the limit is saturated. Raises :class:`ShedError` (shed: queue
        full or brownout refusal) or :class:`DeadlineExceededError` (the
        request's deadline expired while queued). ``exempt=True`` bypasses
        every control (system/observability traffic)."""
        from janusgraph_tpu_torch.observability import registry

        if exempt:
            return _Ticket(True)
        import heapq

        with self._cond:
            rung = self.brownout.rung
            if rung >= RUNG_CHEAP_ONLY and not (
                known and price_ms <= self.cheap_cost_ms
            ):
                raise self._shed(
                    "brownout-cheap-only",
                    f"brownout rung {rung}: only known-cheap digests "
                    f"(mean <= {self.cheap_cost_ms}ms) are admitted",
                )
            if self._in_flight < self.limiter.limit and not self._queue:
                self._in_flight += 1
                registry.counter("server.admission.admitted").inc()
                self.brownout.note_healthy()
                self._gauges()
                return _Ticket(False, price_ms, digest)
            if len(self._queue) >= self.queue_bound:
                raise self._shed(
                    "queue-full",
                    f"wait queue at bound ({self.queue_bound})",
                )
            ticket = _Ticket(False, price_ms, digest)
            self._seq += 1
            heapq.heappush(self._queue, (price_ms, self._seq, ticket))
            registry.counter("server.admission.queued").inc()
            self._gauges()
            deadline_t = (
                time.monotonic() + timeout_s if timeout_s is not None
                else None
            )
            while not ticket.granted:
                wait = None
                if deadline_t is not None:
                    wait = deadline_t - time.monotonic()
                    if wait <= 0:
                        ticket.abandoned = True
                        registry.counter(
                            "server.admission.queue_timeouts"
                        ).inc()
                        self._gauges()
                        raise DeadlineExceededError(
                            "request deadline expired while queued for "
                            "admission"
                        )
                self._cond.wait(wait)
            registry.counter("server.admission.admitted").inc()
            self._gauges()
            return ticket

    def release(self, ticket: _Ticket, latency_ms: float) -> None:
        """One admitted request finished: feed AIMD, free the slot, pump
        the queue."""
        if ticket.exempt:
            return
        with self._cond:
            self._in_flight = max(0, self._in_flight - 1)
            self.limiter.observe(latency_ms)
            self.brownout.note_healthy()
            self._pump()
            self._gauges()

    # ------------------------------------------------------------ internals
    def _pump(self) -> None:
        """Grant queued tickets while capacity allows (lock held)."""
        import heapq

        granted = False
        while self._queue and self._in_flight < self.limiter.limit:
            _price, _seq, ticket = heapq.heappop(self._queue)
            if ticket.abandoned:
                continue
            ticket.granted = True
            self._in_flight += 1
            granted = True
        if granted:
            self._cond.notify_all()

    def _shed(self, reason: str, detail: str) -> ShedError:
        """Build the ShedError (lock held): decorrelated-jitter
        Retry-After, shed counter, brownout escalation."""
        from janusgraph_tpu_torch.observability import registry

        registry.counter("server.admission.shed").inc()
        # graphlint: disable=JG110 -- reason is the fixed shed vocabulary (queue-full / brownout-cheap-only)
        registry.counter(f"server.admission.shed.{reason}").inc()
        # decorrelated jitter, same shape as backend_op's backoff: spread
        # the retry schedule of simultaneously-shed clients
        ra = min(
            self.retry_after_max_s,
            random.uniform(
                self.retry_after_base_s, self._last_retry_after * 3
            ),
        )
        self._last_retry_after = max(ra, self.retry_after_base_s)
        self.brownout.note_shed()
        if not self._queue and self._in_flight < self.limiter.limit // 2 + 1:
            # shedding while capacity sits idle: this shed came from a
            # refusal rung, not from saturation — the ladder steps down
            # instead of livelocking at zero goodput
            self.brownout.note_underload()
        self._gauges()
        return ShedError(
            f"request shed ({detail}); retry after {ra:.2f}s",
            retry_after_s=round(ra, 3), reason=reason,
        )

    def _gauges(self) -> None:
        from janusgraph_tpu_torch.observability import registry

        registry.set_gauge(
            "server.admission.limit", float(self.limiter.limit)
        )
        registry.set_gauge(
            "server.admission.in_flight", float(self._in_flight)
        )
        registry.set_gauge(
            "server.admission.queue_depth", float(len(self._queue))
        )

    # -------------------------------------------------------------- queries
    @property
    def in_flight(self) -> int:
        with self._cond:
            return self._in_flight

    @property
    def queue_depth(self) -> int:
        with self._cond:
            return len(self._queue)

    def span_retention_shed(self) -> bool:
        """True when brownout rung >= 1: request spans should run
        unsampled (no root-ring retention)."""
        return self.brownout.rung >= RUNG_SHED_SPANS

    def snapshot(self) -> dict:
        """The /healthz ``admission`` block."""
        with self._cond:
            return {
                "limit": self.limiter.limit,
                "baseline_ms": (
                    round(self.limiter.baseline_ms, 3)
                    if self.limiter.baseline_ms is not None else None
                ),
                "in_flight": self._in_flight,
                "queue_depth": len(self._queue),
                "queue_bound": self.queue_bound,
                "brownout_rung": self.brownout.rung,
            }

    @classmethod
    def from_config(cls, cfg) -> "AdmissionController":
        """Build from the ``server.admission.*`` option family."""
        return cls(
            initial_limit=cfg.get("server.admission.initial-limit"),
            min_limit=cfg.get("server.admission.min-limit"),
            max_limit=cfg.get("server.admission.max-limit"),
            queue_bound=cfg.get("server.admission.queue-bound"),
            window=cfg.get("server.admission.window"),
            latency_threshold=cfg.get("server.admission.latency-threshold"),
            default_cost_ms=cfg.get("server.admission.default-cost-ms"),
            cheap_cost_ms=cfg.get("server.admission.cheap-cost-ms"),
            brownout_window_s=cfg.get("server.admission.brownout-window-s"),
            brownout_enter_sheds=cfg.get(
                "server.admission.brownout-enter-sheds"
            ),
            brownout_exit_s=cfg.get("server.admission.brownout-exit-s"),
            brownout_dwell_s=cfg.get("server.admission.brownout-dwell-s"),
            retry_after_base_s=cfg.get(
                "server.admission.retry-after-base-s"
            ),
            retry_after_max_s=cfg.get("server.admission.retry-after-max-s"),
            price_book_capacity=cfg.get("metrics.digest-top-k"),
        )


# ---------------------------------------------------------------------------
# process-global hook: the OLAP computer (a different layer) must be able
# to ask "is the serving path browned out?" without importing the server

_ACTIVE_LOCK = threading.Lock()
_ACTIVE: Optional[AdmissionController] = None


def set_active(controller: Optional[AdmissionController]) -> None:
    """Register the serving controller process-globally (the server calls
    this at start/stop); None deregisters."""
    global _ACTIVE
    with _ACTIVE_LOCK:
        _ACTIVE = controller


def active() -> Optional[AdmissionController]:
    with _ACTIVE_LOCK:
        return _ACTIVE


def check_olap_admission() -> None:
    """Raise :class:`ServerOverloadedError` when the active serving
    controller's brownout ladder is refusing OLAP submits (rung >= 2).
    No-op when no server is running in this process — embedded/analytics
    use is never throttled by a ladder that does not exist."""
    ctl = active()
    if ctl is not None and ctl.brownout.rung >= RUNG_REFUSE_OLAP:
        from janusgraph_tpu_torch.observability import registry

        registry.counter("server.admission.olap_refused").inc()
        raise ServerOverloadedError(
            f"OLAP submit refused: serving path is browned out (rung "
            f"{ctl.brownout.rung} >= {RUNG_REFUSE_OLAP}); retry when the "
            "overload clears",
            retry_after_s=ctl.retry_after_max_s,
        )
