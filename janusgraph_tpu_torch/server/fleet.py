"""Fault-tolerant serving fleet: replica router, drain, gossip, warm-up —
the port's copy of ``janusgraph_tpu/server/fleet.py``, whole.

A single :class:`~janusgraph_tpu_torch.server.server.JanusGraphServer`
hardens one process; the deployment model is N replicas over one shared
storage backend, where any replica can die mid-traffic without dropping
the graph. This module turns the per-replica signals (admission, SLOs,
the price book, the CDC log) into a fleet:

- :class:`FleetRouter` — consistent-hash routing with least-loaded
  tie-break. Keys (default: the query's literal-stripped shape digest, so
  a shape's spillover snapshot / price-book affinity lands on the same
  replica) hash onto a vnode ring; among the first ``candidates`` serving
  replicas the router picks the lower **load score**, computed from each
  replica's ``/healthz`` admission block (AIMD in-flight/limit, queue
  depth, brownout rung) and its SLO block (burn-rate severity) —
  point-in-time load plus trend, not just liveness.
- **Retry-elsewhere**: a shed/draining/dead replica costs one token from
  the fleet's :class:`~janusgraph_tpu_torch.driver.client.RetryBudget`
  and the request moves to the next candidate after a jittered backoff
  (never past the caller's deadline). Per-replica circuit breakers
  (``storage/circuit.py``) make a dead replica cost one connect timeout
  once, not once per request.
- **Session stickiness + graceful drain**: WS/tx sessions pin to one
  replica; ``drain()`` stops new work (the server sheds sessionless
  requests with status ``"draining"``, which the router treats as
  retry-elsewhere), lets in-flight sessions finish, hands off sessionless
  sticky pins, and only then retires the replica. A crash is the other
  path: probe/connect failures mark the replica dead and sticky pins fail
  over immediately — the two are distinct flight events.
- :class:`StateGossip` — push-pull anti-entropy between replicas: each
  round ships the local price book (the profiler's digest records) and
  brownout rung to ``fanout`` peers and merges the response, so a digest
  priced expensive on one replica prices correctly fleet-wide within a
  bounded number of rounds (full mesh of N: one push-pull round reaches
  every peer at fanout N-1).
- **Replica warm-up** — :func:`export_snapshot` writes a serving
  replica's snapshot-CSR base pack in the shard-checkpoint format
  (``olap/sharded_checkpoint.save_csr_checkpoint``); :func:`warm_replica`
  hydrates a joining replica's
  :class:`~janusgraph_tpu_torch.olap.delta.DeltaSnapshot` from the files
  (delta-snapshot ``.npz`` packs are the fallback) — array-equal to a
  storage re-scan with zero edgestore reads, so OLAP traffic fans out
  across replicas without N scans of one backend. The pack carries the
  topology, labels and edge types only: edge weights and property
  columns are not in it, as in the reference.
- **Follower role** — :class:`CDCFollower` rides the durable CDC log
  (``storage/cdc.py``): bootstrap from a shard checkpoint, continuously
  pull and fold the netted delta records through ``materialize``
  (cursor gap ⇒ honest re-bootstrap), serve reads at a staleness the SLO
  freshness spec prices, and ``promote()`` to leader on leader death. The
  router learns **staleness-hinted routing**: a request carrying
  ``max_staleness_ms`` may land on a follower whose reported staleness
  clears the hint; everything else stays on leaders. The least-loaded
  tie-break is slope-sharpened with each replica's ``/timeseries``
  goodput trend (``server.fleet.trend-windows``).

None of this touches the card itself: a replica's or a follower's graph
submits its OLAP to the device its ``computer.executor`` names, the card
by default. Every outbound hop here (probes, gossip, drain-era routing)
carries an explicit timeout.
"""

from __future__ import annotations

import json
import random
import threading
import time
import zlib
from bisect import bisect_right
from typing import Callable, Dict, List, Optional, Tuple
from urllib import error as _urlerr
from urllib import request as _urlreq

from janusgraph_tpu_torch.driver.client import (
    JanusGraphClient,
    RemoteError,
    RetryBudget,
)
from janusgraph_tpu_torch.exceptions import (
    CircuitOpenError,
    TemporaryBackendError,
)
from janusgraph_tpu_torch.storage.circuit import CircuitBreaker

#: replica lifecycle states
SERVING = "serving"
DRAINING = "draining"
DEAD = "dead"

#: brownout rungs / SLO severities priced into the load score: each rung
#: weighs like half a saturated admission limit, a paging SLO like a full
#: one — degraded-but-alive replicas keep absorbing traffic, just less
RUNG_WEIGHT = 0.5
PAGE_WEIGHT = 2.0
DEGRADED_WEIGHT = 1.0
#: goodput-trend tie-break weight: a rising admitted-rate slope shaves
#: at most a quarter point off the load score (and a falling one adds
#: it) — sharpens ties, never outvotes real occupancy
TREND_WEIGHT = 0.25


class NoReplicaAvailable(Exception):
    """Every candidate was dead, draining, open-circuit, or shedding and
    the retry budget/deadline ran out."""


class ReplicaHandle:
    """Router-side record of one fleet member."""

    def __init__(self, name: str, host: str, port: int, breaker_kwargs=None):
        self.name = name
        self.host = host
        self.port = port
        self.state = SERVING
        #: the last parsed /healthz payload (or {} before the first probe)
        self.health: dict = {}
        self.probe_failures = 0
        self.last_probe_ts: Optional[float] = None
        #: per-replica request stats (handle-resident, NOT registry
        #: metrics: replica names are operator input, so per-name metric
        #: series would be unbounded)
        self.stats = {"ok": 0, "shed": 0, "errors": 0, "retried_away": 0}
        #: replication role from the last probe's /healthz cdc block:
        #: "leader" (default — replicas without a cdc block take writes)
        #: or "follower" (read-only, staleness-hinted traffic only)
        self.role = "leader"
        #: follower staleness from the same block (ms; None = unknown)
        self.staleness_ms: Optional[float] = None
        #: normalized goodput slope from /timeseries ([-1, 1]; 0 = flat
        #: or trend probing off)
        self.goodput_trend = 0.0
        self.breaker = CircuitBreaker(
            f"fleet.{name}", **(breaker_kwargs or {
                "failure_threshold": 2, "reset_timeout_s": 1.0,
            })
        )

    @property
    def base_url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def load_score(self) -> float:
        """Routing load signal from the replica's own defense plane: the
        admission block's occupancy (in-flight over AIMD limit + queue
        fill), the brownout rung, and the SLO burn verdict. An unprobed
        replica scores neutral (0.5) so cold members still take traffic."""
        h = self.health
        if not h:
            return 0.5
        score = 0.0
        adm = h.get("admission") or {}
        limit = float(adm.get("limit") or 0.0)
        if limit > 0:
            score += float(adm.get("in_flight") or 0.0) / limit
        qb = float(adm.get("queue_bound") or 0.0)
        if qb > 0:
            score += float(adm.get("queue_depth") or 0.0) / qb
        score += RUNG_WEIGHT * float(adm.get("brownout_rung") or 0.0)
        slo = h.get("slo") or {}
        if slo.get("paging"):
            score += PAGE_WEIGHT
        elif slo.get("worst") == "ticket":
            score += PAGE_WEIGHT / 2.0
        if h.get("status") == "degraded":
            score += DEGRADED_WEIGHT
        if h.get("draining"):
            score += PAGE_WEIGHT  # drains should win no tie-breaks
        # trend tie-break: rising goodput prefers, falling defers
        score -= TREND_WEIGHT * self.goodput_trend
        return score

    @property
    def is_follower(self) -> bool:
        return self.role == "follower"

    def snapshot(self) -> dict:
        """The fleet-healthz member block."""
        h = self.health
        return {
            "state": self.state,
            "url": self.base_url,
            "status": h.get("status"),
            "draining": bool(h.get("draining")),
            "role": self.role,
            "staleness_ms": self.staleness_ms,
            "goodput_trend": round(self.goodput_trend, 4),
            "load_score": round(self.load_score(), 4),
            "brownout_rung": (h.get("admission") or {}).get(
                "brownout_rung"
            ),
            "slo_paging": (h.get("slo") or {}).get("paging") or [],
            "open_sessions": h.get("open_sessions"),
            "probe_failures": self.probe_failures,
            "breaker": self.breaker.state,
            "stats": dict(self.stats),
            # continuous-profiling summary: enough for the fleet view to
            # spot a dead sampler or a bundle-writing (anomalous) member
            # without pulling the full member /healthz
            "profiler": {
                k: (h.get("profiler") or {}).get(k)
                for k in ("enabled", "alive", "overhead_cpu_pct")
            },
            "bundles_written": (
                ((h.get("profiler") or {}).get("bundles") or {}).get(
                    "written"
                )
            ),
            "watchdog_events": (
                ((h.get("profiler") or {}).get("watchdog") or {}).get(
                    "events"
                )
            ),
        }


def _default_fetch(url: str, timeout_s: float) -> dict:
    """GET one JSON endpoint; a degraded /healthz answers 503 with the
    same JSON body, so HTTPError bodies parse too."""
    try:
        with _urlreq.urlopen(url, timeout=timeout_s) as resp:
            return json.loads(resp.read())
    except _urlerr.HTTPError as e:
        return json.loads(e.read())


#: the per-replica goodput proxy the trend tie-break slopes over: every
#: admitted request bumps it, so its window deltas ARE the goodput curve
TREND_SERIES = "server.admission.admitted"


def goodput_slope(payload: dict, name: str = TREND_SERIES) -> float:
    """Normalized least-squares slope of a /timeseries counter window:
    the per-window deltas regressed against window index, divided by the
    mean absolute delta (+1 so an idle replica slopes 0, not NaN), and
    clipped to [-1, 1] — a dimensionless 'goodput rising/falling' signal
    comparable across replicas of different traffic levels."""
    points = ((payload or {}).get("series") or {}).get(name) or []
    ys = [float(p.get("delta") or 0.0) for p in points]
    k = len(ys)
    if k < 2:
        return 0.0
    xm = (k - 1) / 2.0
    ym = sum(ys) / k
    var = sum((i - xm) ** 2 for i in range(k))
    if not var:
        return 0.0
    slope = sum((i - xm) * (y - ym) for i, y in enumerate(ys)) / var
    norm = slope / (sum(abs(y) for y in ys) / k + 1.0)
    return max(-1.0, min(1.0, norm))


class FleetRouter:
    """Front-end router: spread traffic across N replicas sharing one
    storage backend. In-process library (the ``janusgraph_tpu_torch fleet``
    runner wraps it in an HTTP frontend); thread-safe; ``clock`` and
    ``fetch`` are injectable so routing/probing tests run deterministic
    and offline."""

    def __init__(
        self,
        vnodes: int = 16,
        candidates: int = 2,
        probe_timeout_s: float = 2.0,
        retry_budget_capacity: Optional[float] = None,
        retry_budget_refill_per_s: Optional[float] = None,
        backoff_base_s: float = 0.02,
        backoff_max_s: float = 0.5,
        clock: Callable[[], float] = time.monotonic,
        fetch: Callable[[str, float], dict] = _default_fetch,
        client_factory: Optional[Callable[[ReplicaHandle], object]] = None,
        trend_windows: int = 0,
    ):
        from janusgraph_tpu_torch.core.config import REGISTRY

        self.vnodes = max(1, int(vnodes))
        self.candidates = max(1, int(candidates))
        self.probe_timeout_s = float(probe_timeout_s)
        if retry_budget_capacity is None:
            retry_budget_capacity = REGISTRY[
                "driver.failover-retry-budget-capacity"
            ].default
        if retry_budget_refill_per_s is None:
            retry_budget_refill_per_s = REGISTRY[
                "driver.failover-retry-budget-refill-per-s"
            ].default
        #: ONE budget for every retry-elsewhere the router performs: a
        #: fleet-wide incident cannot multiply into a retry stampede
        #: against the survivors
        self.retry_budget = RetryBudget(
            retry_budget_capacity, retry_budget_refill_per_s
        )
        self.backoff_base_s = float(backoff_base_s)
        self.backoff_max_s = float(backoff_max_s)
        #: goodput-trend windows fetched per probe (0 = trend tie-break
        #: off — the plain occupancy ordering)
        self.trend_windows = max(0, int(trend_windows))
        self._clock = clock
        self._fetch = fetch
        self._client_factory = client_factory or (
            lambda h: JanusGraphClient(
                host=h.host, port=h.port,
                # the ROUTER owns failover; per-replica clients must not
                # also sleep-and-retry against the same shedding replica
                retry_budget_capacity=0,
            )
        )
        self._lock = threading.RLock()
        self._replicas: Dict[str, ReplicaHandle] = {}
        self._clients: Dict[str, object] = {}
        #: (point, name) vnode ring, sorted by point
        self._ring: List[Tuple[int, str]] = []
        #: sticky pins: session key -> replica name
        self._sessions: Dict[str, str] = {}
        self._probe_thread: Optional[threading.Thread] = None
        self._probe_stop = threading.Event()
        #: last fleet-healthz verdict, for the ok->degraded edge trigger
        self._health_status: Optional[str] = None

    # ------------------------------------------------------------ membership
    def add_replica(
        self, name: str, host: str = "127.0.0.1", port: int = 0
    ) -> ReplicaHandle:
        from janusgraph_tpu_torch.observability import flight_recorder

        with self._lock:
            handle = ReplicaHandle(name, host, port)
            self._replicas[name] = handle
            self._clients.pop(name, None)
            self._rebuild_ring()
        flight_recorder.record(
            "fleet", action="join", replica=name, port=port,
        )
        return handle

    def remove_replica(self, name: str) -> None:
        with self._lock:
            self._replicas.pop(name, None)
            self._clients.pop(name, None)
            self._sessions = {
                k: r for k, r in self._sessions.items() if r != name
            }
            self._rebuild_ring()

    def replicas(self) -> Dict[str, ReplicaHandle]:
        with self._lock:
            return dict(self._replicas)

    def _rebuild_ring(self) -> None:
        """Vnode ring (lock held): ``vnodes`` points per replica, stable
        under membership churn — only the dead member's keys move."""
        ring = []
        for name in self._replicas:
            for v in range(self.vnodes):
                ring.append(
                    (zlib.crc32(f"{name}#{v}".encode()), name)
                )
        ring.sort()
        self._ring = ring

    # --------------------------------------------------------------- probing
    def probe(self, name: Optional[str] = None) -> None:
        """Refresh /healthz state for one replica (or all). Probe
        failures mark the replica dead after two consecutive misses —
        the crash-detection path, distinct from graceful drain."""
        targets = [name] if name else list(self.replicas())
        for n in targets:
            with self._lock:
                handle = self._replicas.get(n)
                base_url = handle.base_url if handle is not None else None
            if handle is None:
                continue
            # the blocking HTTP probe runs OUTSIDE the lock (a slow peer
            # must not stall routing); state transitions re-take it below
            # so the probe thread never races mark_dead/mark_serving/
            # add_replica, which mutate the same handle under _lock
            try:
                payload = self._fetch(
                    base_url + "/healthz", self.probe_timeout_s
                )
            except Exception:  # noqa: BLE001 - any probe failure counts
                with self._lock:
                    if self._replicas.get(n) is not handle:
                        continue  # removed/re-added mid-probe: stale handle
                    handle.probe_failures += 1
                    handle.last_probe_ts = self._clock()
                    dead = (
                        handle.probe_failures >= 2
                        and handle.state != DEAD
                    )
                if dead:
                    self.mark_dead(n, reason="probe")
                continue
            trend = None
            if self.trend_windows:
                # trend probe rides the same injectable fetch; failures
                # leave the last slope standing (a flaky /timeseries
                # must not zero a healthy replica's tie-break)
                try:
                    trend = goodput_slope(self._fetch(
                        base_url
                        + f"/timeseries?name={TREND_SERIES}"
                        + f"&window={self.trend_windows}",
                        self.probe_timeout_s,
                    ))
                except Exception:  # noqa: BLE001 - trend is advisory
                    trend = None
            rejoined = False
            with self._lock:
                if self._replicas.get(n) is not handle:
                    continue  # removed/re-added mid-probe: stale handle
                handle.probe_failures = 0
                handle.last_probe_ts = self._clock()
                handle.health = payload if isinstance(payload, dict) else {}
                cdc = handle.health.get("cdc") or {}
                handle.role = cdc.get("role") or "leader"
                stale_s = cdc.get("staleness_s")
                handle.staleness_ms = (
                    float(stale_s) * 1000.0 if stale_s is not None
                    else None
                )
                if trend is not None:
                    handle.goodput_trend = trend
                rejoined = handle.state == DEAD
                if (
                    not rejoined
                    and handle.health.get("draining")
                    and handle.state == SERVING
                ):
                    handle.state = DRAINING
            if rejoined:
                # the replica answered: it rejoined (restart path)
                self.mark_serving(n)

    def start_probes(self, interval_s: float = 1.0) -> None:
        """Background probe loop (the runner path; tests call probe())."""
        if self._probe_thread is not None:
            return
        self._probe_stop.clear()

        def _loop():
            while not self._probe_stop.wait(interval_s):
                try:
                    self.probe()
                except Exception as e:  # noqa: BLE001 - probes must not die
                    # record before continuing: a probe loop
                    # failing every tick means the router is flying
                    # blind on member health — that must be visible
                    from janusgraph_tpu_torch.observability import (
                        flight_recorder,
                    )

                    flight_recorder.record(
                        "thread_error", thread="fleet-probe",
                        error=repr(e),
                    )

        self._probe_thread = threading.Thread(
            target=_loop, daemon=True, name="fleet-probe"
        )
        self._probe_thread.start()

    def stop(self) -> None:
        self._probe_stop.set()
        if self._probe_thread is not None:
            self._probe_thread.join(timeout=2.0)
            self._probe_thread = None

    def mark_dead(self, name: str, reason: str = "crash") -> None:
        """Crash path: immediate failover — sticky sessions re-pin on
        their next submit, in-flight requests retry elsewhere."""
        from janusgraph_tpu_torch.observability import (
            flight_recorder,
            get_logger,
            registry,
        )

        with self._lock:
            handle = self._replicas.get(name)
            if handle is None or handle.state == DEAD:
                return
            handle.state = DEAD
            moved = [
                k for k, r in self._sessions.items() if r == name
            ]
            for k in moved:
                del self._sessions[k]
        registry.counter("fleet.router.replica_deaths").inc()
        flight_recorder.record(
            "fleet", action="dead", replica=name, reason=reason,
            sessions_failed_over=len(moved),
        )
        get_logger("server.fleet").warning(
            "replica-dead", replica=name, reason=reason,
            sessions_failed_over=len(moved),
        )

    def rejoin_replica(
        self, name: str, host: str, port: int
    ) -> Optional[ReplicaHandle]:
        """A restarted replica rejoins at a (possibly new) address: the
        cached client is dropped, the handle re-addressed, and the state
        returns to serving (its breaker re-closes via half-open probes)."""
        with self._lock:
            handle = self._replicas.get(name)
            if handle is None:
                return self.add_replica(name, host, port)
            handle.host, handle.port = host, port
            self._clients.pop(name, None)
        self.mark_serving(name)
        return handle

    def mark_serving(self, name: str) -> None:
        from janusgraph_tpu_torch.observability import flight_recorder

        with self._lock:
            handle = self._replicas.get(name)
            if handle is None:
                return
            prev, handle.state = handle.state, SERVING
            handle.probe_failures = 0
        if prev != SERVING:
            flight_recorder.record(
                "fleet", action="rejoin", replica=name, was=prev,
            )

    # --------------------------------------------------------------- routing
    @staticmethod
    def routing_key(query: str) -> str:
        """Default routing key: the query's literal-stripped shape digest
        (server/admission.py) — all instances of one shape land on one
        replica, so its measured price, promoted spillover program, and
        snapshot cache stay hot in one place."""
        from janusgraph_tpu_torch.observability.profiler import shape_digest
        from janusgraph_tpu_torch.server.admission import query_shape

        return shape_digest("server>" + query_shape(query))

    def candidates_for(
        self, key: str, max_staleness_ms: Optional[float] = None
    ) -> List[ReplicaHandle]:
        """Replicas in routing preference order: the first ``candidates``
        SERVING members clockwise from the key's ring point, least-loaded
        first (consistent hash for affinity, power-of-two-choices for
        balance), then every remaining serving member in ring order as
        failover tail.

        Staleness-hinted requests (``max_staleness_ms`` set) may land on
        follower replicas whose last-reported staleness clears the hint
        — those sort FIRST (least-loaded), leaders behind them as the
        freshness fallback. Unhinted requests never see a follower."""
        with self._lock:
            ring = self._ring
            if not ring:
                return []
            point = zlib.crc32(str(key).encode())
            start = bisect_right(ring, (point, chr(0x10FFFF)))
            ordered: List[ReplicaHandle] = []
            seen = set()
            for i in range(len(ring)):
                _pt, name = ring[(start + i) % len(ring)]
                if name in seen:
                    continue
                seen.add(name)
                handle = self._replicas.get(name)
                if handle is not None and handle.state == SERVING:
                    ordered.append(handle)
        if not ordered:
            return []
        followers = [h for h in ordered if h.is_follower]
        leaders = [h for h in ordered if not h.is_follower]
        head = sorted(
            leaders[: self.candidates],
            key=lambda h: h.load_score(),
        )
        preferred = head + leaders[self.candidates:]
        if max_staleness_ms is None:
            return preferred
        fresh = sorted(
            (
                f for f in followers
                if f.staleness_ms is not None
                and f.staleness_ms <= float(max_staleness_ms)
            ),
            key=lambda h: h.load_score(),
        )
        return fresh + preferred

    def _client(self, handle: ReplicaHandle):
        with self._lock:
            client = self._clients.get(handle.name)
            if client is None:
                client = self._client_factory(handle)
                self._clients[handle.name] = client
        return client

    def submit(
        self,
        query: str,
        graph: Optional[str] = None,
        deadline_ms: Optional[float] = None,
        key: Optional[str] = None,
        session_key: Optional[str] = None,
        trace_ctx=None,
        max_staleness_ms: Optional[float] = None,
    ):
        """Route one request. Sticky ``session_key`` pins to a replica
        (drain/death re-pin transparently); otherwise the consistent-hash
        candidates serve it. Shed/draining/dead replicas are retried
        elsewhere under the fleet retry budget with jittered backoff,
        never past the caller's deadline.

        The whole routing episode is ONE ``fleet.route`` span joined to
        the caller's ``trace_ctx`` (the frontend parses X-Trace-Context
        into it), with one ``fleet.attempt`` child per replica tried
        (replica id + verdict: ok / shed / draining / dead / unreachable
        / error, retriable verdicts tagged retry-elsewhere) — and the
        per-replica client forwards the ambient context on every hop, so
        one driver query through a failover reads back as one stitched
        trace instead of N orphans."""
        from janusgraph_tpu_torch.observability import registry, tracer

        give_up_at = (
            self._clock() + deadline_ms / 1000.0 if deadline_ms else None
        )
        route_key = key if key is not None else self.routing_key(query)
        t0 = self._clock()
        attempt = 0
        tried: List[str] = []
        last_err: Optional[Exception] = None
        with tracer.child_span(
            trace_ctx, "fleet.route",
            key=route_key, pinned=session_key is not None,
        ) as route_span:
            while True:
                handle = self._pick(
                    route_key, session_key, exclude=tried,
                    max_staleness_ms=max_staleness_ms,
                )
                if handle is None:
                    registry.counter("fleet.router.no_replica").inc()
                    route_span.annotate(
                        verdict="no-replica", attempts=attempt, tried=tried
                    )
                    raise NoReplicaAvailable(
                        f"no serving replica for key {route_key!r} "
                        f"(tried {tried}); last error: {last_err}"
                    ) from last_err
                remaining_ms = (
                    max(0.0, (give_up_at - self._clock()) * 1000.0)
                    if give_up_at is not None else None
                )
                with tracer.span(
                    "fleet.attempt", replica=handle.name, attempt=attempt
                ) as att:
                    try:
                        # graphlint: disable=JG207 -- not a per-element fan-out: the loop IS the retry-elsewhere policy (one logical request, budget-bounded attempts)
                        result = self._call(
                            handle, query, graph, remaining_ms
                        )
                        att.annotate(verdict="ok")
                        handle.stats["ok"] += 1
                        registry.counter("fleet.router.routed").inc()
                        if handle.is_follower:
                            # the read-scale-out share: hinted reads a
                            # follower absorbed instead of the leader
                            registry.counter(
                                "fleet.router.follower_reads"
                            ).inc()
                        if attempt:
                            # wall spent re-routing past failed candidates:
                            # the router-failover-latency headline
                            registry.timer("fleet.router.failover").update(
                                int((self._clock() - t0) * 1e9)
                            )
                        route_span.annotate(
                            verdict="ok", replica=handle.name,
                            attempts=attempt + 1,
                        )
                        return result
                    except RemoteError as e:
                        if e.status in ("shed", "draining"):
                            att.annotate(
                                verdict=e.status, retry_elsewhere=True
                            )
                            handle.stats["shed"] += 1
                            retriable, wait_s, last_err = (
                                True, e.retry_after_s, e
                            )
                            if e.status == "draining":
                                # under _lock: the probe thread writes
                                # handle.state under the same lock
                                with self._lock:
                                    if handle.state == SERVING:
                                        handle.state = DRAINING
                        else:
                            # evaluation/client errors are the CALLER's
                            # problem — rerouting a bad query just fails
                            # it N times
                            att.annotate(verdict="error")
                            handle.stats["errors"] += 1
                            route_span.annotate(
                                verdict="error", attempts=attempt + 1
                            )
                            raise
                    except _urlerr.HTTPError:
                        # replica answered with a non-shed HTTP error: a
                        # caller problem (auth, bad request), not an
                        # availability event
                        att.annotate(verdict="error")
                        handle.stats["errors"] += 1
                        route_span.annotate(
                            verdict="error", attempts=attempt + 1
                        )
                        raise
                    # graphlint: disable=JG204 -- the failure is routed: retriable=True re-enters the retry-elsewhere loop (budget-bounded), exhaustion raises NoReplicaAvailable from the original error
                    except (CircuitOpenError, TemporaryBackendError,
                            ConnectionError, OSError, _urlerr.URLError) as e:
                        # connect refusal / timeout / open breaker: this
                        # replica is gone or unreachable — crash-detection
                        # path
                        dead = isinstance(e, CircuitOpenError)
                        if not dead:
                            # under _lock: races the probe thread's
                            # `handle.probe_failures = 0` reset;
                            # mark_dead re-takes the lock, so call it
                            # after release
                            with self._lock:
                                handle.probe_failures += 1
                                dead = handle.probe_failures >= 2
                            if dead:
                                self.mark_dead(handle.name, reason="connect")
                        att.annotate(
                            verdict="dead" if dead else "unreachable",
                            retry_elsewhere=True,
                        )
                        retriable, wait_s, last_err = True, None, e
                if not retriable:
                    break
                tried.append(handle.name)
                handle.stats["retried_away"] += 1
                if session_key is not None:
                    self._repin(session_key, exclude=tried)
                if not self.retry_budget.take():
                    registry.counter(
                        "fleet.router.budget_exhausted"
                    ).inc()
                    route_span.annotate(
                        verdict="budget-exhausted", attempts=attempt + 1,
                        tried=tried,
                    )
                    raise NoReplicaAvailable(
                        f"fleet retry budget exhausted after {tried}"
                    ) from last_err
                registry.counter("fleet.router.retries").inc()
                wait = wait_s if wait_s else random.uniform(
                    self.backoff_base_s,
                    min(
                        self.backoff_max_s,
                        self.backoff_base_s * (3 ** min(attempt, 4)),
                    ),
                )
                if give_up_at is not None and (
                    self._clock() + wait >= give_up_at
                ):
                    route_span.annotate(
                        verdict="deadline", attempts=attempt + 1,
                        tried=tried,
                    )
                    raise NoReplicaAvailable(
                        f"deadline would expire before retry (tried {tried})"
                    ) from last_err
                time.sleep(min(wait, 1.0))
                attempt += 1

    def _call(self, handle, query, graph, deadline_ms):
        """One attempt against one replica, through its breaker (connect
        failures count as temporary backend errors so a dead replica
        fails fast for everyone after the threshold)."""
        client = self._client(handle)

        def _attempt():
            try:
                return client.submit(
                    query, graph=graph, deadline_ms=deadline_ms,
                )
            except _urlerr.HTTPError:
                # the replica RESPONDED (4xx/5xx application error) —
                # availability-wise that is not a connect failure, and
                # rerouting would just fail the same request N times
                raise
            except (ConnectionError, OSError) as e:
                raise TemporaryBackendError(str(e)) from e
            except _urlerr.URLError as e:
                raise TemporaryBackendError(str(e)) from e

        return handle.breaker.call(_attempt)

    def _pick(
        self,
        route_key: str,
        session_key: Optional[str],
        exclude: List[str],
        max_staleness_ms: Optional[float] = None,
    ) -> Optional[ReplicaHandle]:
        if session_key is not None:
            # sticky sessions imply read-write affinity: pins stay on
            # leaders regardless of any staleness hint
            pinned = self.pin(session_key, exclude=exclude)
            if pinned is not None and pinned.name not in exclude:
                return pinned
            return None
        for handle in self.candidates_for(
            route_key, max_staleness_ms=max_staleness_ms
        ):
            if handle.name not in exclude:
                return handle
        return None

    # ------------------------------------------------------------ stickiness
    def pin(
        self, session_key: str, exclude: Optional[List[str]] = None
    ) -> Optional[ReplicaHandle]:
        """The replica a session is pinned to, creating the pin on first
        use (consistent hash of the session key, least-loaded tie-break).
        Dead/draining/excluded pins re-pin transparently."""
        exclude = exclude or []
        with self._lock:
            name = self._sessions.get(session_key)
            handle = self._replicas.get(name) if name else None
            if (
                handle is not None
                and handle.state == SERVING
                and handle.name not in exclude
            ):
                return handle
        return self._repin(session_key, exclude=exclude)

    def _repin(
        self, session_key: str, exclude: Optional[List[str]] = None
    ) -> Optional[ReplicaHandle]:
        exclude = exclude or []
        for handle in self.candidates_for(session_key):
            if handle.name in exclude:
                continue
            with self._lock:
                self._sessions[session_key] = handle.name
            return handle
        with self._lock:
            self._sessions.pop(session_key, None)
        return None

    def release(self, session_key: str) -> None:
        with self._lock:
            self._sessions.pop(session_key, None)

    def sessions_on(self, name: str) -> List[str]:
        with self._lock:
            return [k for k, r in self._sessions.items() if r == name]

    # ---------------------------------------------------------------- drain
    def drain(
        self, name: str, server=None, timeout_s: float = 10.0
    ) -> dict:
        """Gracefully retire one replica: stop routing new work to it,
        hand off its sessionless sticky pins, wait (via the server's own
        drain) for in-flight sessions to finish, then mark it retired.
        Returns the drain report; ``server`` is the in-process
        JanusGraphServer when the caller holds it (the runner does)."""
        from janusgraph_tpu_torch.observability import (
            flight_recorder,
            registry,
        )

        with self._lock:
            handle = self._replicas.get(name)
            if handle is None:
                return {"replica": name, "state": "unknown"}
            handle.state = DRAINING
            moved = [
                k for k, r in self._sessions.items() if r == name
            ]
        # hand off sessionless sticky pins NOW — new traffic for those
        # sessions flows to the survivors while the replica finishes its
        # in-flight work
        for k in moved:
            self._repin(k, exclude=[name])
        remaining = 0
        if server is not None:
            remaining = server.drain(timeout_s=timeout_s)
        registry.counter("fleet.router.drains").inc()
        report = {
            "replica": name,
            "state": DRAINING,
            "sessions_handed_off": len(moved),
            "sessions_remaining": remaining,
            "graceful": remaining == 0,
        }
        flight_recorder.record(
            "fleet", action="drain", replica=name,
            handed_off=len(moved), remaining=remaining,
        )
        return report

    # --------------------------------------------------------------- healthz
    def healthz(self) -> dict:
        """Fleet-level /healthz: aggregate member blocks; degraded when a
        QUORUM (majority) of members is dead, degraded, or paging — one
        browned-out replica is the defense working, half the fleet paging
        is the incident."""
        members = {
            name: h.snapshot() for name, h in self.replicas().items()
        }
        total = len(members)
        bad = sum(
            1 for m in members.values()
            if m["state"] == DEAD
            or m["status"] == "degraded"
            or m["slo_paging"]
        )
        serving = sum(
            1 for m in members.values() if m["state"] == SERVING
        )
        degraded = total > 0 and bad * 2 > total
        status = "degraded" if degraded else "ok"
        with self._lock:
            flipped = (
                self._health_status == "ok" and status == "degraded"
            )
            self._health_status = status
        if flipped:
            # the same edge trigger as the per-replica /healthz: the
            # moment a QUORUM pages, the event ring that led here is on
            # disk before anyone asks
            from janusgraph_tpu_torch.observability import flight_recorder

            flight_recorder.record(
                "fleet", action="quorum_degraded",
                bad=bad, total=total,
                members={
                    n: m["state"] for n, m in members.items()
                    if m["state"] != SERVING or m["status"] == "degraded"
                },
            )
            flight_recorder.dump(reason="fleet-quorum-degraded")
        return {
            "status": status,
            "replicas": members,
            "total": total,
            "serving": serving,
            "quorum_bad": bad,
            # fleet-level profiling rollup: dead samplers (lying
            # profilers) and total forensics bundles across members
            "profiler": {
                "dead_samplers": [
                    n for n, m in members.items()
                    if (m.get("profiler") or {}).get("enabled")
                    and not (m.get("profiler") or {}).get("alive")
                ],
                "bundles_written": sum(
                    m.get("bundles_written") or 0
                    for m in members.values()
                ),
                "watchdog_events": sum(
                    m.get("watchdog_events") or 0
                    for m in members.values()
                ),
            },
        }


# ---------------------------------------------------------------------------
# State gossip
# ---------------------------------------------------------------------------

class StateGossip:
    """Push-pull anti-entropy of operational state between replicas.

    Each :meth:`tick` POSTs the local digest — price-book records (the
    digest tables the admission controller and spillover planner
    price from) and the current brownout rung — to ``fanout`` peers via
    their ``/gossip`` endpoint, and merges whatever the peer answers
    back. Merging reuses ``profiler.restore_digest_records`` (existing
    local measurements win; the table's top-K eviction bounds growth).
    Convergence bound: on a full mesh of N replicas with fanout f, a new
    fact reaches every peer within ``ceil((N-1)/f)`` push rounds — and
    usually one, because the PULL half returns the peer's whole digest.

    ``clock`` is injectable and ``tick`` is synchronous, so the
    convergence test drives rounds on a fake clock without threads."""

    def __init__(
        self,
        name: str,
        admission,
        fanout: int = 2,
        timeout_s: float = 2.0,
        max_records: int = 64,
        clock: Callable[[], float] = time.monotonic,
        post: Optional[Callable[[str, dict, float], dict]] = None,
    ):
        self.name = name
        self.admission = admission
        self.fanout = max(1, int(fanout))
        self.timeout_s = float(timeout_s)
        self.max_records = int(max_records)
        self._clock = clock
        self._post = post or self._http_post
        self._peers: List[str] = []  # peer /gossip base URLs
        self._rr = 0
        self._seq = 0
        self._lock = threading.Lock()
        #: peer name -> {"rung", "ts", "seq"} — what the fleet healthz
        #: and the brownout-aware router read
        self.peer_state: Dict[str, dict] = {}
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    def set_peers(self, urls: List[str]) -> None:
        with self._lock:
            self._peers = [u.rstrip("/") for u in urls]

    @staticmethod
    def _http_post(url: str, body: dict, timeout_s: float) -> dict:
        data = json.dumps(body).encode()
        req = _urlreq.Request(
            url, data=data, method="POST",
            headers={"Content-Type": "application/json"},
        )
        with _urlreq.urlopen(req, timeout=timeout_s) as resp:
            return json.loads(resp.read())

    # ---------------------------------------------------------------- digest
    def local_digest(self) -> dict:
        from janusgraph_tpu_torch.observability.profiler import digest_records

        with self._lock:
            self._seq += 1
            seq = self._seq
        records = []
        rung = 0
        if self.admission is not None:
            records = digest_records(self.admission.price_book)[
                : self.max_records
            ]
            rung = self.admission.brownout.rung
        return {
            "replica": self.name,
            "seq": seq,
            "brownout_rung": rung,
            "price_book": records,
        }

    def merge(self, body: dict) -> int:
        """Fold one peer digest into local state; returns how many price
        records were new here. Brownout rungs land in ``peer_state`` (the
        fleet view), never forced onto the local ladder — a peer's
        overload is a routing signal, not a local degradation."""
        from janusgraph_tpu_torch.observability.profiler import (
            restore_digest_records,
        )

        if not isinstance(body, dict):
            return 0
        peer = str(body.get("replica") or "")
        loaded = 0
        if self.admission is not None:
            loaded = restore_digest_records(
                self.admission.price_book, body.get("price_book")
            )
        if peer and peer != self.name:
            with self._lock:
                self.peer_state[peer] = {
                    "rung": int(body.get("brownout_rung") or 0),
                    "seq": int(body.get("seq") or 0),
                    "ts": self._clock(),
                }
        return loaded

    # ------------------------------------------------------------------ tick
    def tick(self) -> int:
        """One gossip round: push-pull with the next ``fanout`` peers
        (round-robin). Returns how many peers were reached. Failures are
        counted, never raised — gossip is best-effort by design."""
        from janusgraph_tpu_torch.observability import registry

        with self._lock:
            peers = list(self._peers)
            start = self._rr
            self._rr = (self._rr + self.fanout) % max(1, len(peers) or 1)
        if not peers:
            return 0
        digest = self.local_digest()
        reached = 0
        for i in range(min(self.fanout, len(peers))):
            url = peers[(start + i) % len(peers)] + "/gossip"
            try:
                reply = self._post(url, digest, self.timeout_s)
            except Exception:  # noqa: BLE001 - best-effort by design
                registry.counter("fleet.gossip.failures").inc()
                continue
            self.merge(reply)
            reached += 1
        registry.counter("fleet.gossip.rounds").inc()
        return reached

    def start(self, interval_s: float = 2.0) -> None:
        if self._thread is not None:
            return
        self._stop.clear()

        def _loop():
            while not self._stop.wait(interval_s):
                try:
                    self.tick()
                except Exception as e:  # noqa: BLE001 - gossip must not die
                    # record before continuing: silent gossip
                    # failure strands every peer on stale price books
                    from janusgraph_tpu_torch.observability import (
                        flight_recorder,
                    )

                    flight_recorder.record(
                        "thread_error", thread=f"gossip-{self.name}",
                        error=repr(e),
                    )

        self._thread = threading.Thread(
            target=_loop, daemon=True, name=f"gossip-{self.name}"
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None


# ---------------------------------------------------------------------------
# Follower role (durable-CDC read replicas)
# ---------------------------------------------------------------------------

class CDCFollower:
    """Follower-side replication loop over a durable CDC log.

    Bootstraps its CSR state from a shard checkpoint
    (``olap/sharded_checkpoint.load_csr_checkpoint``), then pulls the
    leader's netted delta records from ``source`` (a ``storage/cdc.py``
    :class:`CDCLog` in-process, or a :class:`CDCReader` over the shared
    log directory — the fleet pull plane) and folds them through
    ``materialize`` — O(delta) per pull, zero store reads. A cursor gap
    (retention prune, poison, corrupt segment) is answered honestly:
    counted, and the follower re-bootstraps from the checkpoint.

    Replay application is idempotent by epoch: records at or below
    ``last_applied_epoch`` fold to nothing, so pulling the same cursor
    twice equals pulling it once.

    ``promote()`` is the leader-death path: one final forced catch-up
    from the durable log, then the role flips — the flight recorder sees
    ``follower_promote`` and a ``cdc_replay``/``caught_up`` event, the
    two phases the federation incident grammar stitches after a kill.

    Staleness is self-reported and honest: seconds since this follower
    last PROVED itself caught up to the log head. Past the priced bound
    (``server.fleet.follower-max-staleness-ms``, the SLO freshness
    ceiling) the /healthz cdc block flags ``degraded`` and the router
    stops preferring the follower for hinted reads."""

    def __init__(
        self,
        source,
        checkpoint_dir: str,
        graph=None,
        idm=None,
        name: str = "",
        max_staleness_ms: float = 10_000.0,
        fault_plan=None,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.source = source
        self.checkpoint_dir = checkpoint_dir
        self.graph = graph
        self.idm = idm if idm is not None else getattr(graph, "idm", None)
        self.name = name
        self.max_staleness_ms = float(max_staleness_ms)
        self.fault_plan = fault_plan
        self._clock = clock
        self.role = "follower"
        self.csr = None
        self.cursor: Optional[int] = None
        self.last_applied_epoch = -1
        self.rebootstraps = 0
        self.pulls = 0
        self._caught_up_at: Optional[float] = None
        self._lock = threading.RLock()
        self._watchdog_key: Optional[str] = None

    # ------------------------------------------------------------ lifecycle
    def bootstrap(self) -> bool:
        """Hydrate from the shard checkpoint and anchor the replay
        cursor at the checkpoint's epoch. False = cannot serve (no
        checkpoint, or the log cannot cover the epoch gap — the
        checkpoint is older than the pruned range)."""
        from janusgraph_tpu_torch.observability import flight_recorder, registry
        from janusgraph_tpu_torch.olap.sharded_checkpoint import (
            load_csr_checkpoint,
        )

        with self._lock:
            pack = load_csr_checkpoint(self.checkpoint_dir)
            if pack is None:
                registry.counter("fleet.follower.bootstrap_misses").inc()
                return False
            csr, epoch = pack
            cursor = self.source.cursor_for_epoch(epoch)
            if cursor is None:
                # the log pruned/poisoned records past this checkpoint's
                # epoch: replay could silently skip them — refuse
                registry.counter("fleet.follower.bootstrap_misses").inc()
                return False
            self.csr = csr
            self.last_applied_epoch = int(epoch)
            self.cursor = int(cursor)
            self._caught_up_at = self._clock()
            self._adopt()
        registry.counter("fleet.follower.bootstraps").inc()
        # the stall-watchdog contract: every background pull
        # source auto-registers as a progress source — a serving
        # follower whose pull counter freezes is a wedged replication
        # loop, caught without any manual wiring
        self._register_watchdog()
        flight_recorder.record(
            "fleet", action="follower_bootstrap", replica=self.name,
            epoch=int(epoch), cursor=int(cursor),
            rows=int(csr.num_vertices), edges=int(csr.num_edges),
        )
        return True

    def _adopt(self) -> None:
        """Install the follower's CSR into its serving graph's
        DeltaSnapshot (lock held) so OLAP/spillover reads on this
        replica serve the replicated state — the warm_replica adoption
        discipline, re-anchored at the follower's own local epoch."""
        if self.graph is None:
            return
        from janusgraph_tpu_torch.olap import delta as _delta

        snap = _delta.get_snapshot(self.graph)
        if snap is not None:
            snap.adopt(self.csr, self.graph.backend.mutation_epoch())

    # ----------------------------------------------------------- replication
    def pull(self, force: bool = False) -> dict:
        """One replication pull: replay from the cursor, fold the fresh
        records, advance. A ``None`` replay (gap) re-bootstraps. The
        seeded lagging-follower fault skips applying (staleness grows)
        unless ``force`` — promotion's final catch-up is never skipped.

        The watchdog progress counter advances when the pull COMPLETES
        (any outcome): a pull wedged inside replay/fold keeps it frozen,
        which is exactly the stall signal."""
        try:
            return self._pull_once(force)
        finally:
            with self._lock:
                self.pulls += 1

    def _pull_once(self, force: bool = False) -> dict:
        from janusgraph_tpu_torch.observability import registry

        with self._lock:
            if self.csr is None and not self.bootstrap():
                return {"ok": False, "applied": 0, "reason": "no-bootstrap"}
            plan = self.fault_plan
            if not force and plan is not None and plan.follower_lag():
                registry.counter("fleet.follower.lagged_pulls").inc()
                return {
                    "ok": True, "applied": 0, "lagging": True,
                    "cursor": self.cursor,
                }
            cursor = self.cursor
            base = self.csr
            floor = self.last_applied_epoch
        # the replay + fold run OUTSIDE the lock: both are pure
        # over the captured base, so a blocked holder never stalls
        # staleness probes; the commit below is optimistic — a
        # concurrent pull that advanced the cursor first wins
        replay = self.source.replay_from(cursor)
        if replay is None:
            with self._lock:
                if self.cursor != cursor:
                    return {
                        "ok": True, "applied": 0, "raced": True,
                        "cursor": self.cursor,
                    }
                # honest gap: count it and rebuild from the checkpoint
                registry.counter("fleet.follower.cursor_gaps").inc()
                self.rebootstraps += 1
                self.csr = None
                ok = self.bootstrap()
                return {
                    "ok": ok, "applied": 0, "rebootstrap": True,
                    "cursor": self.cursor,
                }
        records, next_cursor = replay
        fresh = [(e, b) for e, b in records if e > floor]
        folded = base
        if fresh:
            from janusgraph_tpu_torch.olap.delta import (
                DeltaOverlay,
                materialize,
            )

            overlay = DeltaOverlay.from_batches([b for _e, b in fresh])
            folded = materialize(base, overlay, idm=self.idm)
        with self._lock:
            if self.cursor != cursor or self.csr is not base:
                return {
                    "ok": True, "applied": 0, "raced": True,
                    "cursor": self.cursor,
                }
            if fresh:
                self.csr = folded
                self.last_applied_epoch = max(e for e, _b in fresh)
                self._adopt()
            self.cursor = int(next_cursor)
            self._caught_up_at = self._clock()
            registry.counter("fleet.follower.pulls").inc()
            registry.set_gauge(
                "fleet.follower.applied_epoch",
                float(self.last_applied_epoch),
            )
            return {
                "ok": True, "applied": len(fresh),
                "cursor": self.cursor,
                "epoch": self.last_applied_epoch,
            }

    def promote(self) -> dict:
        """Leader-death path: final forced catch-up from the durable
        log, then flip to leader. Returns the promotion report (the
        bench's ``promote_ms`` headline)."""
        from janusgraph_tpu_torch.observability import flight_recorder, registry

        t0 = self._clock()
        # the forced catch-up manages its own locking (the fold itself
        # runs lock-free); only the role flip needs the lock
        report = self.pull(force=True)
        with self._lock:
            self.role = "leader"
        promote_ms = (self._clock() - t0) * 1000.0
        registry.counter("fleet.follower.promotions").inc()
        flight_recorder.record(
            "follower_promote", replica=self.name,
            promote_ms=round(promote_ms, 3),
            cursor=self.cursor, epoch=self.last_applied_epoch,
            applied=report.get("applied", 0), ok=report.get("ok", False),
        )
        # the caught-up proof closes the incident grammar's final phase:
        # kill -> promote -> caught_up
        flight_recorder.record(
            "cdc_replay", action="caught_up", replica=self.name,
            cursor=self.cursor, epoch=self.last_applied_epoch,
        )
        return {
            "promote_ms": promote_ms,
            "cursor": self.cursor,
            "epoch": self.last_applied_epoch,
            "applied": report.get("applied", 0),
            "ok": report.get("ok", False),
        }

    # -------------------------------------------------------------- watchdog
    def _register_watchdog(self) -> None:
        """Idempotent: one progress source per follower identity."""
        from janusgraph_tpu_torch.observability.continuous import (
            watchdog_singleton,
        )

        with self._lock:
            if self._watchdog_key is not None:
                return
            self._watchdog_key = "fleet.cdc.%s" % (self.name or "follower")
        watchdog_singleton().register_progress(
            self._watchdog_key, self._progress
        )

    def unregister_watchdog(self) -> None:
        from janusgraph_tpu_torch.observability.continuous import (
            watchdog_singleton,
        )

        with self._lock:
            key, self._watchdog_key = self._watchdog_key, None
        if key is not None:
            watchdog_singleton().unregister_progress(key)

    def _progress(self) -> dict:
        """A bootstrapped follower is active replication work; the pull
        counter advances at the END of every pull (success, gap, or
        lagging alike), so a pull wedged mid-replay freezes it."""
        with self._lock:
            return {
                "active": (
                    1 if self.role == "follower" and self.csr is not None
                    else 0
                ),
                "progress": self.pulls,
            }

    # -------------------------------------------------------------- healthz
    def staleness_s(self) -> float:
        with self._lock:
            if self._caught_up_at is None:
                return float("inf")
            return max(0.0, self._clock() - self._caught_up_at)

    def lag_records(self) -> int:
        with self._lock:
            if self.cursor is None:
                return 0
            try:
                head = self.source.head_cursor()
            except Exception:  # noqa: BLE001 - lag is advisory
                return 0
            return max(0, int(head) - int(self.cursor))

    def healthz_block(self) -> dict:
        stale = self.staleness_s()
        with self._lock:
            return {
                "role": self.role,
                "cursor": self.cursor,
                "lag_records": self.lag_records(),
                "last_applied_epoch": self.last_applied_epoch,
                "staleness_s": (
                    round(stale, 3) if stale != float("inf") else None
                ),
                "rebootstraps": self.rebootstraps,
                "degraded": (
                    self.role == "follower"
                    and stale * 1000.0 > self.max_staleness_ms
                ),
            }


# ---------------------------------------------------------------------------
# Replica warm-up (snapshot-CSR cache hydration)
# ---------------------------------------------------------------------------

def export_snapshot(graph, dir_path: str, num_shards: int = 1) -> dict:
    """Export a serving replica's snapshot-CSR base pack in the
    shard-checkpoint format. Pending overlay records are folded first
    (zero store reads — materialization works from the capture alone), so
    the files carry the freshest pack this replica can prove."""
    from janusgraph_tpu_torch.olap import delta as _delta
    from janusgraph_tpu_torch.olap.sharded_checkpoint import save_csr_checkpoint

    snap = _delta.get_snapshot(graph)
    if snap is None:
        raise ValueError(
            "snapshot export needs the delta machinery "
            "(computer.delta=true opens the change capture)"
        )
    csr, view, info = snap.acquire()
    if view is not None:
        # fold the pending overlay so the exported pack IS the graph at
        # the capture anchor (still zero store reads)
        csr = _delta.materialize(
            csr, view.overlay, idm=getattr(graph, "idm", None)
        )
        if view.upto_epoch is not None:
            snap.adopt(csr, view.upto_epoch)
    save_csr_checkpoint(dir_path, csr, snap.epoch, num_shards=num_shards)
    return {
        "rows": int(csr.num_vertices),
        "edges": int(csr.num_edges),
        "shards": int(num_shards),
        "path": dir_path,
        "source": info.get("path"),
    }


def warm_replica(
    graph, dir_path: Optional[str] = None, replica: str = ""
) -> bool:
    """Hydrate a joining replica's snapshot-CSR cache from files instead
    of re-scanning storage: the shard-checkpoint export first, the
    delta-snapshot ``.npz`` pack (``computer.delta-snapshot-path``)
    as fallback. The pack installs into the replica's DeltaSnapshot
    anchored at the replica's OWN current mutation epoch — writes
    committed after the export must be quiesced (the drain/export
    protocol does exactly that) or they stream in through the capture
    from the anchor onward. Zero edgestore reads on this path."""
    from janusgraph_tpu_torch.observability import flight_recorder, registry
    from janusgraph_tpu_torch.olap import delta as _delta

    snap = _delta.get_snapshot(graph)
    if snap is None:
        return False
    pack = None
    source = None
    if dir_path:
        from janusgraph_tpu_torch.olap.sharded_checkpoint import (
            load_csr_checkpoint,
        )

        pack = load_csr_checkpoint(dir_path)
        source = "shard-checkpoint"
    if pack is None and snap.snapshot_path:
        pack = _delta.load_snapshot(snap.snapshot_path)
        source = "delta-pack"
    if pack is None:
        registry.counter("fleet.warmup.misses").inc()
        return False
    csr, _exporter_epoch = pack
    # re-anchor at THIS replica's observed epoch: the exporter's epoch
    # binds to the exporter's backend instance (delta.load_snapshot doc)
    snap.adopt(csr, graph.backend.mutation_epoch())
    registry.counter("fleet.warmup.hits").inc()
    # the replica identity stamp puts the warm-up on the restarted
    # replica's lane in the federation incident report (and lets shared
    # in-process rings dedup the event); "" = unidentified
    flight_recorder.record(
        "fleet", action="warmup", source=source,
        replica=replica,
        rows=int(csr.num_vertices), edges=int(csr.num_edges),
    )
    return True


# ---------------------------------------------------------------------------
# HTTP frontend (the `janusgraph_tpu_torch fleet` runner's listener)
# ---------------------------------------------------------------------------

class FleetFrontend:
    """Minimal HTTP face over a FleetRouter: POST /gremlin routes through
    the fleet (the replica's own JSON response shape comes back), GET
    /healthz serves the fleet aggregate. WS/tx clients connect straight
    to a replica — GET /assign?session=<key> answers which one, honoring
    stickiness and drain state.

    With a :class:`~janusgraph_tpu_torch.observability.federation.FleetFederation`
    attached (``janusgraph_tpu_torch fleet`` wires one when
    ``server.fleet.federation-enabled``), the frontend also serves the
    merged fleet views: GET ``/fleet/timeseries`` (federated windows,
    exact merged percentiles), ``/fleet/metrics`` (replica-labeled
    snapshot merge), and ``/fleet/incident?window=`` (the causally
    ordered cross-replica forensic timeline)."""

    def __init__(self, router: FleetRouter, host: str = "127.0.0.1",
                 port: int = 0, max_request_bytes: int = 1 << 20,
                 federation=None):
        self.router = router
        self.host = host
        self._port = port
        self.max_request_bytes = max_request_bytes
        self.federation = federation
        self._httpd = None
        self._thread = None

    @property
    def port(self) -> int:
        return (
            self._httpd.server_address[1] if self._httpd else self._port
        )

    def start(self) -> "FleetFrontend":
        from http.server import (
            BaseHTTPRequestHandler,
            ThreadingHTTPServer,
        )

        frontend = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *args):
                pass

            def _json(self, code, payload):
                body = json.dumps(payload).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path == "/healthz":
                    payload = frontend.router.healthz()
                    code = 200 if payload["status"] == "ok" else 503
                    self._json(code, payload)
                    return
                if self.path.startswith("/assign"):
                    from urllib.parse import parse_qs, urlsplit

                    qs = parse_qs(urlsplit(self.path).query)
                    skey = (qs.get("session") or [""])[0]
                    if not skey:
                        self._json(400, {"status": {
                            "code": 400,
                            "message": "missing ?session=<key>",
                        }})
                        return
                    handle = frontend.router.pin(skey)
                    if handle is None:
                        self._json(503, {"status": {
                            "code": 503,
                            "message": "no serving replica",
                        }})
                        return
                    self._json(200, {
                        "replica": handle.name,
                        "host": handle.host,
                        "port": handle.port,
                    })
                    return
                if self.path.startswith("/fleet/"):
                    fed = frontend.federation
                    if fed is None:
                        self._json(404, {"status": {
                            "code": 404,
                            "message": "federation not enabled",
                        }})
                        return
                    from urllib.parse import parse_qs, urlsplit

                    parts = urlsplit(self.path)
                    qs = parse_qs(parts.query)
                    if parts.path == "/fleet/timeseries":
                        name = (qs.get("name") or [""])[0]
                        try:
                            window = int((qs.get("window") or ["0"])[0])
                        except ValueError:
                            window = 0
                        self._json(
                            200, fed.timeseries_view(name, window)
                        )
                        return
                    if parts.path == "/fleet/metrics":
                        self._json(200, fed.metrics_view())
                        return
                    if parts.path == "/fleet/incident":
                        try:
                            window_s = float(
                                (qs.get("window") or ["60"])[0]
                            )
                        except ValueError:
                            window_s = 60.0
                        self._json(200, fed.incident(window_s))
                        return
                    if parts.path == "/fleet/bundles":
                        # off-host forensics: bundles announced on the
                        # telemetry bus and shipped here survive their
                        # replica's death — ?replica=&i= pulls one full
                        # bundle, bare path lists the retained summaries
                        replica = (qs.get("replica") or [""])[0]
                        if replica:
                            try:
                                index = int((qs.get("i") or ["-1"])[0])
                            except ValueError:
                                index = -1
                            got = fed.bundles.get(replica, index)
                            if got is None:
                                self._json(404, {"status": {
                                    "code": 404,
                                    "message": "no shipped bundle for "
                                               f"replica {replica!r}",
                                }})
                                return
                            self._json(200, got)
                            return
                        self._json(200, {
                            **fed.bundles.status(),
                            "push": fed.push_status(),
                            "bundles": fed.bundles.summaries(),
                        })
                        return
                self._json(404, {"status": {"code": 404}})

            def do_POST(self):
                length = int(self.headers.get("Content-Length", 0))
                if length > frontend.max_request_bytes:
                    self.close_connection = True
                    self._json(413, {"status": {"code": 413}})
                    return
                raw = self.rfile.read(length)
                if self.path not in ("/gremlin", "/"):
                    self._json(404, {"status": {"code": 404}})
                    return
                try:
                    req = json.loads(raw)
                except json.JSONDecodeError:
                    self._json(400, {"status": {
                        "code": 400, "message": "bad json",
                    }})
                    return
                deadline = self.headers.get("X-Deadline-Ms") or req.get(
                    "deadline"
                )
                try:
                    deadline_ms = float(deadline) if deadline else None
                except (TypeError, ValueError):
                    deadline_ms = None
                # the freshness hint: a client declaring it tolerates N
                # ms of staleness may be served by a follower replica
                stale = self.headers.get(
                    "X-Max-Staleness-Ms"
                ) or req.get("max_staleness_ms")
                try:
                    max_staleness_ms = float(stale) if stale else None
                except (TypeError, ValueError):
                    max_staleness_ms = None
                from janusgraph_tpu_torch.observability.spans import TraceContext

                # the caller's trace joins the routing episode: the
                # fleet.route span (and every per-replica hop under it)
                # lands in the SAME trace as the driver's client span
                trace_ctx = TraceContext.from_header(
                    self.headers.get("X-Trace-Context")
                )
                try:
                    result = frontend.router.submit(
                        req.get("gremlin", ""),
                        graph=req.get("graph"),
                        deadline_ms=deadline_ms,
                        session_key=req.get("session_key"),
                        trace_ctx=trace_ctx,
                        max_staleness_ms=max_staleness_ms,
                    )
                except NoReplicaAvailable as e:
                    self._json(503, {"result": {"data": None}, "status": {
                        "code": 503, "status": "fleet-unavailable",
                        "message": str(e),
                    }})
                    return
                except RemoteError as e:
                    self._json(200, {"result": {"data": None}, "status": {
                        "code": e.code, "status": e.status,
                        "message": str(e),
                    }})
                    return
                from janusgraph_tpu_torch.driver.graphson import graphson_dumps

                self._json(200, {
                    "result": {"data": json.loads(graphson_dumps(result))},
                    "status": {"code": 200},
                })

        self._httpd = ThreadingHTTPServer((self.host, self._port), Handler)
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True,
            name="fleet-frontend",
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
