"""Fleet observability federation: cross-replica telemetry + forensics —
the port's copy of ``janusgraph_tpu/observability/federation.py``, whole.

Every observability plane below this module is per-process: one metrics
registry, one flight ring, one history/SLO engine. In a serving fleet
(``server/fleet.py``) a failover incident is smeared across N
disjoint rings and N independently-evaluated SLO ladders, and nobody can
answer "what happened to the fleet between 12:03:07 and 12:03:09". This
module is the federation layer that runs IN the fleet frontend process
(`janusgraph_tpu_torch fleet`) next to the router:

- **Federated telemetry** — :class:`FleetFederation.tick` pulls each
  replica's raw history windows (``GET /timeseries?raw=1``, bucket
  vectors included) and merges them into one fleet window per tick with
  fixed per-kind semantics: counter deltas SUM, gauges stay KEYED per
  replica (a gauge has no meaningful cross-process sum), and
  histogram/timer bucket delta vectors ADD element-wise — so the fleet
  window's p50/p95/p99 are *exact to the shared log2 ladder*, bitwise
  equal to recomputing from the concatenated per-replica vectors
  (:func:`merge_series`). A scrape that misses a dead/draining replica
  is served with ``partial: true`` and the missing-replica list — never
  silently complete.

- **Clock-offset estimation** — each scrape is also an NTP-style probe:
  the round-trip is timed on the LOCAL monotonic clock, the reply
  carries the replica's wall ``now``, and the offset estimate is
  ``peer_wall - (local_send_wall + rtt/2)`` with the minimum-RTT sample
  winning (:class:`ClockOffsets`) — the classic filter, good to ~rtt/2.

- **Failover forensics** — :meth:`FleetFederation.incident` pulls every
  replica's flight ring, maps each event's wall ``ts`` onto the
  frontend's clock via the offset estimates, and emits ONE causally
  ordered timeline: a merged event list plus a Chrome-trace document
  with one lane per replica (the timeline renderer's vocabulary),
  reconstructing kill -> mark_dead -> re-pin -> warm-up end to end even
  when replica wall clocks disagree by hundreds of milliseconds.

- **Fleet-level SLOs** — the merged fleet windows feed a second
  burn-rate engine (:class:`~janusgraph_tpu_torch.observability.slo.SLOEngine`
  over :class:`FleetHistory` — same multi-window hysteresis, same
  determinism on a fake clock). Stock specs: fleet availability from
  the summed admission counters, routing health from the router's
  retry/routed counters, and a latency-outlier budget fed by the
  cross-replica detector — a replica whose windowed p99 exceeds
  ``outlier_factor x`` the fleet median raises a ``replica_outlier``
  flight event and burns the ticket-rung outlier budget.

- **Push-mode transport** — behind a negotiated capability
  (``GET /watch/info``; a 404 marks the peer POLL-ONLY and keeps the
  exact scrape path above, byte-compatibly), the frontend opens a
  ``/watch`` stream per replica and receives sealed windows and flight
  events at EVENT latency instead of poll latency.  Pushed windows run
  through the same producer-keyed cursor and the same merge semantics;
  a dropped stream reconnects with its cursors (resume, no duplicates)
  and a cursor gap heals with one full ``raw=1`` re-fetch — the same
  heal the bounded poll tail uses.  Bundle announcements on the stream
  drive **off-host forensics shipping**: the frontend fetches the
  episode (rate-bounded, torn-skip) into a :class:`FleetBundleStore`
  served at ``GET /fleet/bundles``, so a dying replica's forensics
  survive the replica.

Everything remote is bounded by a timeout and runs outside locks; every
wall-clock subtraction here is offset math over event *stamps* —
durations use the monotonic clock.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional

from janusgraph_tpu_torch.observability.metrics_core import Histogram
from janusgraph_tpu_torch.observability.slo import SLOEngine, SLOSpec

#: flight categories that mark failover phase boundaries, in causal order
_PHASE_EVENTS = (
    ("kill", lambda e: e.get("category") == "fault"
     and e.get("kind") in ("replica_kill", "replica_restart")),
    ("mark_dead", lambda e: e.get("category") == "fleet"
     and e.get("action") == "dead"),
    ("re_pin", lambda e: e.get("category") == "fleet"
     and e.get("action") in ("rejoin", "join")),
    ("warm_up", lambda e: e.get("category") == "fleet"
     and e.get("action") == "warmup"),
    # durable-CDC failover: a follower promotes from the log,
    # then proves itself caught up — kill -> promote -> caught_up
    ("promote", lambda e: e.get("category") == "follower_promote"),
    ("caught_up", lambda e: e.get("category") == "cdc_replay"
     and e.get("action") == "caught_up"),
)


# ------------------------------------------------------------------ merging
def merge_series(entries: List[dict]) -> Optional[dict]:
    """Merge per-replica window summaries of ONE timer/histogram metric:
    bucket delta vectors add element-wise, so the merged percentiles are
    the percentiles of the concatenated observation multiset — exact to
    the log2 ladder, by construction bitwise equal to recomputing from
    the concatenated per-replica vectors."""
    entries = [e for e in entries if e and e.get("count")]
    if not entries:
        return None
    width = max(len(e.get("buckets") or []) for e in entries)
    buckets = [0] * width
    count = 0
    total = 0.0
    hi = 0.0
    for e in entries:
        for i, v in enumerate(e.get("buckets") or []):
            buckets[i] += v
        count += int(e["count"])
        total += float(e.get("sum", 0.0))
        hi = max(hi, float(e.get("max", 0.0)))
    return {
        "kind": entries[0].get("kind", "timer"),
        "count": count,
        "sum": total,
        "max": hi,
        "buckets": buckets,
        "p50": Histogram.percentile_of(buckets, 0.50, hi),
        "p95": Histogram.percentile_of(buckets, 0.95, hi),
        "p99": Histogram.percentile_of(buckets, 0.99, hi),
    }


def merge_windows(replica_windows: Dict[str, List[dict]]) -> dict:
    """Merge each replica's NEW history windows into one fleet-window
    body: ``counters`` sum, ``series`` bucket-add (:func:`merge_series`),
    ``gauges`` keyed per replica (last value wins within one scrape), and
    ``by_replica`` keeps each replica's own merged series so the outlier
    detector can compare per-replica percentiles against the fleet."""
    counters: Dict[str, int] = {}
    gauges: Dict[str, dict] = {}
    per_metric: Dict[str, List[dict]] = {}
    by_replica: Dict[str, Dict[str, dict]] = {}
    for replica in sorted(replica_windows):
        ws = replica_windows[replica]
        mine: Dict[str, List[dict]] = {}
        for w in ws:
            for name, delta in (w.get("counters") or {}).items():
                counters[name] = counters.get(name, 0) + int(delta)
            for name, entry in (w.get("series") or {}).items():
                per_metric.setdefault(name, []).append(entry)
                mine.setdefault(name, []).append(entry)
            for name, value in (w.get("gauges") or {}).items():
                gauges.setdefault(name, {})[replica] = value
        for name, entries in mine.items():
            merged = merge_series(entries)
            if merged is not None:
                by_replica.setdefault(name, {})[replica] = merged
    series = {}
    for name, entries in per_metric.items():
        merged = merge_series(entries)
        if merged is not None:
            series[name] = merged
    return {
        "counters": counters,
        "series": series,
        "gauges": gauges,
        "by_replica": by_replica,
    }


# -------------------------------------------------------------- clock offsets
class ClockOffsets:
    """Per-replica wall-clock offset estimates from scrape round-trips.

    One observation per scrape: the caller stamps its wall clock at send,
    times the round-trip on its MONOTONIC clock (a wall-clock rtt would
    go negative under NTP steps), and reads the peer's
    wall ``now`` from the reply. The NTP midpoint estimate assumes the
    reply was generated halfway through the round-trip::

        offset = peer_wall - (local_send_wall + rtt / 2)

    so ``peer_ts - offset`` maps a peer event stamp onto the local wall
    clock, good to about rtt/2. The minimum-RTT sample per replica wins
    (least queueing delay = tightest bound), the standard NTP filter."""

    def __init__(self):
        self._lock = threading.Lock()
        #: replica -> {"offset_s", "rtt_s", "samples"}
        self._est: Dict[str, dict] = {}

    def observe(
        self, replica: str, send_wall: float, rtt_s: float,
        peer_wall: float,
    ) -> float:
        """Fold one round-trip observation; returns the current offset."""
        # wall stamps subtracted for OFFSET estimation, not a duration
        # (the rtt itself was measured on the monotonic clock)
        offset = peer_wall - (send_wall + rtt_s / 2.0)
        rtt_s = max(0.0, float(rtt_s))
        with self._lock:
            cur = self._est.get(replica)
            if cur is None or rtt_s <= cur["rtt_s"]:
                self._est[replica] = {
                    "offset_s": offset,
                    "rtt_s": rtt_s,
                    "samples": (cur["samples"] if cur else 0) + 1,
                }
            else:
                cur["samples"] += 1
        return self.offset(replica)

    def offset(self, replica: str) -> float:
        with self._lock:
            est = self._est.get(replica)
            return est["offset_s"] if est else 0.0

    def correct(self, replica: str, ts: float) -> float:
        """Map a peer event's wall stamp onto the local wall clock."""
        return ts - self.offset(replica)

    def snapshot(self) -> Dict[str, dict]:
        with self._lock:
            return {r: dict(e) for r, e in self._est.items()}


# ---------------------------------------------------------------- fleet ring
class FleetHistory:
    """Bounded ring of merged fleet windows — the same ``windows()`` /
    ``add_listener()`` surface :class:`MetricsHistory` gives the SLO
    engine, fed by :meth:`FleetFederation.tick` instead of a registry
    sampler, so the fleet burn-rate engine inherits the SLO engine's determinism
    (drive ticks on a fake clock, get a byte-stable alert sequence)."""

    def __init__(self, capacity: int = 360):
        self._ring: deque = deque(maxlen=int(capacity))
        self._lock = threading.Lock()
        self._listeners: List[Callable[[dict], None]] = []

    def append(self, window: dict) -> None:
        with self._lock:
            self._ring.append(window)
            listeners = list(self._listeners)
        for fn in listeners:
            try:
                fn(window)
            except Exception:  # noqa: BLE001 - a listener must not kill the scraper
                pass

    def windows(self, last: int = 0) -> List[dict]:
        with self._lock:
            ws = list(self._ring)
        return ws[-last:] if last > 0 else ws

    def add_listener(self, fn: Callable[[dict], None]) -> None:
        if fn not in self._listeners:
            self._listeners.append(fn)

    def remove_listener(self, fn) -> None:
        if fn in self._listeners:
            self._listeners.remove(fn)


def fleet_default_specs(
    availability_objective: float = 0.999,
    routing_objective: float = 0.99,
    outlier_objective: float = 0.99,
    fast_windows: int = 3,
    slow_windows: int = 36,
    page_burn: float = 14.4,
    ticket_burn: float = 6.0,
) -> List[SLOSpec]:
    """The stock FLEET spec set (``metrics.fleet-*`` keys):

    - ``fleet_availability`` — the summed admission counters across every
      replica: the fraction of fleet-arriving requests not shed.
    - ``fleet_routing`` — router health: retries-elsewhere (each one a
      failed first attempt) against successfully routed requests.
    - ``fleet_latency_outlier`` — the cross-replica outlier budget:
      federation ticks where some replica's windowed p99 exceeded
      ``outlier_factor x`` the fleet median, against all ticks. Sized so
      a persistent outlier burns the TICKET rung (one sick replica is an
      operator ticket, not a page — the router is already steering
      around it)."""
    common = dict(
        fast_windows=fast_windows, slow_windows=slow_windows,
        page_burn=page_burn, ticket_burn=ticket_burn,
    )
    return [
        SLOSpec(
            name="fleet_availability", kind="availability",
            objective=availability_objective, **common,
        ),
        SLOSpec(
            name="fleet_routing", kind="availability",
            objective=routing_objective,
            good_counter="fleet.router.routed",
            bad_counter="fleet.router.retries", **common,
        ),
        SLOSpec(
            name="fleet_latency_outlier", kind="availability",
            objective=outlier_objective,
            good_counter="fleet.federation.ticks",
            bad_counter="fleet.federation.outlier_windows", **common,
        ),
    ]


def _default_watch_factory(url: str, subscribe: dict, timeout_s: float):
    """Open a real ``/watch`` WebSocket against a replica base URL
    (tests inject a fake factory, the same seam as ``fetch``)."""
    from janusgraph_tpu_torch.driver.client import WatchSession

    return WatchSession(
        url, subscribe=subscribe, connect_timeout_s=timeout_s
    )


# ------------------------------------------------------- bundle shipping
class FleetBundleStore:
    """Fleet-wide retention of per-replica forensics bundles.

    When a replica's BundleWriter announces an episode on its telemetry
    bus (a ``bundle`` flight event on the push stream), the frontend
    fetches the bundle off-host into this bounded ring — so a replica
    that dies seconds later still has its dying forensics readable at
    ``GET /fleet/bundles``.  Rate-bounded per replica
    (``min_interval_s``) and bounded in count (``retention``); an
    unreadable/torn fetch is skipped and counted, never fatal."""

    def __init__(
        self,
        retention: int = 16,
        min_interval_s: float = 5.0,
        clock: Callable[[], float] = time.monotonic,
        wall_clock: Callable[[], float] = time.time,
    ):
        self.retention = max(1, int(retention))
        self.min_interval_s = float(min_interval_s)
        self._clock = clock
        self._wall = wall_clock
        self._lock = threading.Lock()
        self._ring: deque = deque(maxlen=self.retention)
        self._last_fetch: Dict[str, float] = {}
        self.fetched = 0
        self.skipped = 0

    def should_fetch(self, replica: str) -> bool:
        """Rate bound: at most one fetch per replica per
        ``min_interval_s`` (a flapping pager must not turn the frontend
        into a bundle vacuum)."""
        with self._lock:
            now = self._clock()
            last = self._last_fetch.get(replica)
            if last is not None and now - last < self.min_interval_s:
                self.skipped += 1
                return False
            self._last_fetch[replica] = now
            return True

    def add(
        self, replica: str, reason: str, path: str, bundle: dict
    ) -> None:
        with self._lock:
            self.fetched += 1
            self._ring.append({
                "replica": replica,
                "reason": reason,
                "path": path,
                "ts": bundle.get("ts"),
                "fetched_at": self._wall(),
                "bundle": bundle,
            })

    def summaries(self) -> List[dict]:
        """The ``GET /fleet/bundles`` listing (newest last), bundles
        themselves elided."""
        with self._lock:
            return [
                {k: v for k, v in b.items() if k != "bundle"}
                for b in self._ring
            ]

    def get(self, replica: str = "", index: int = -1) -> Optional[dict]:
        """One retained bundle (full body): the newest, or ``index``
        into the (optionally replica-filtered) retained list."""
        with self._lock:
            items = [
                b for b in self._ring
                if not replica or b["replica"] == replica
            ]
        if not items:
            return None
        try:
            return items[index]
        except IndexError:
            return None

    def status(self) -> dict:
        with self._lock:
            return {
                "retention": self.retention,
                "min_interval_s": self.min_interval_s,
                "retained": len(self._ring),
                "fetched": self.fetched,
                "rate_skipped": self.skipped,
            }


# ------------------------------------------------------------ push channel
class _PushChannel:
    """One replica's live ``/watch`` subscription on the frontend.

    A reader thread drains the stream: windows buffer for the next
    :meth:`FleetFederation.tick` merge (same cursor pipeline as poll),
    flight events feed the freshness timer and bundle shipping the
    moment they arrive — the latency collapse push mode exists for.
    The session object only needs ``recv(timeout) -> frame|None`` and
    ``close()`` (injectable via ``watch_factory`` for tests)."""

    def __init__(self, federation, name: str, url: str, producer: str, session):
        self.federation = federation
        self.name = name
        self.url = url
        self.producer = producer
        self.session = session
        self._lock = threading.Lock()
        self._connected = True
        self._windows: List[dict] = []
        self.events_seen = 0
        self.windows_seen = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> None:
        if self._thread is not None:
            return
        self._thread = threading.Thread(
            target=self._run, daemon=True,
            name="fleet-push-%s" % self.name,
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        try:
            self.session.close()
        except Exception:  # noqa: BLE001 - teardown must not raise
            pass
        t = self._thread
        if t is not None and t is not threading.current_thread():
            t.join(timeout=2.0)
        self._thread = None

    @property
    def connected(self) -> bool:
        with self._lock:
            return self._connected

    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                frame = self.session.recv(timeout=1.0)
                if frame is None:
                    continue
                self._handle(frame)
            except Exception as e:  # noqa: BLE001 - record before dying
                if not self._stop.is_set():
                    from janusgraph_tpu_torch.observability.flight import (
                        recorder,
                    )

                    recorder.record(
                        "thread_error",
                        thread="fleet-push-%s" % self.name,
                        error=repr(e),
                    )
                with self._lock:
                    self._connected = False
                return

    def _handle(self, frame: dict) -> None:
        if not isinstance(frame, dict) or frame.get("type") != "event":
            return  # hello / heartbeat
        stream = frame.get("stream")
        data = frame.get("data")
        if not isinstance(data, dict):
            return
        if stream == "window":
            with self._lock:
                self._windows.append(data)
                self.windows_seen += 1
        elif stream == "flight":
            with self._lock:
                self.events_seen += 1
            self.federation._on_push_event(self, data)

    def take_windows(self) -> List[dict]:
        """Drain the buffered windows for this tick's merge."""
        with self._lock:
            ws = self._windows
            self._windows = []
            return ws

    def state(self) -> dict:
        with self._lock:
            return {
                "replica": self.name,
                "producer": self.producer,
                "connected": self._connected,
                "windows_seen": self.windows_seen,
                "events_seen": self.events_seen,
                "buffered": len(self._windows),
            }


# ------------------------------------------------------------- the federator
class FleetFederation:
    """The fleet frontend's scrape-merge-evaluate loop over a
    :class:`~janusgraph_tpu_torch.server.fleet.FleetRouter`'s members.

    ``fetch``, ``clock`` and ``wall_clock`` are injectable and
    :meth:`tick` is synchronous, so the degradation/skew/SLO tests drive
    scrapes deterministically without sockets or threads (the same
    pattern as the router and gossip)."""

    def __init__(
        self,
        router,
        fetch: Optional[Callable[[str, float], dict]] = None,
        interval_s: float = 2.0,
        timeout_s: float = 2.0,
        retention: int = 360,
        clock: Callable[[], float] = time.monotonic,
        wall_clock: Callable[[], float] = time.time,
        outlier_metric: str = "server.request.wall",
        outlier_factor: float = 3.0,
        outlier_min_count: int = 20,
        scrape_window: int = 8,
        slo_specs: Optional[List[SLOSpec]] = None,
        push_enabled: bool = False,
        watch_factory=None,
        ship_bundles: bool = True,
        bundle_retention: int = 16,
        bundle_min_interval_s: float = 5.0,
        watchdog=None,
    ):
        from janusgraph_tpu_torch.server.fleet import _default_fetch

        self.router = router
        self.interval_s = float(interval_s)
        self.timeout_s = float(timeout_s)
        self._fetch = fetch or _default_fetch
        self._clock = clock
        self._wall = wall_clock
        #: negotiated streaming transport: when on, replicas
        #: that answer /watch/info get a push channel; refusals are
        #: poll-only peers on the exact scrape path
        self.push_enabled = bool(push_enabled)
        self._watch_factory = watch_factory or _default_watch_factory
        self.ship_bundles = bool(ship_bundles)
        self.bundles = FleetBundleStore(
            retention=bundle_retention,
            min_interval_s=bundle_min_interval_s,
            clock=clock, wall_clock=wall_clock,
        )
        self._watchdog = watchdog
        self._push: Dict[str, _PushChannel] = {}
        self._push_refused: set = set()
        #: per-producer last pushed flight seq (reconnect resume cursor)
        self._flight_seq: Dict[str, int] = {}
        self._tick_count = 0
        self.outlier_metric = outlier_metric
        self.outlier_factor = float(outlier_factor)
        self.outlier_min_count = int(outlier_min_count)
        #: windows requested per post-bootstrap scrape — a margin over
        #: the expected interval_s / producer-interval ratio; too small
        #: shows up as fleet.federation.cursor_gaps
        self.scrape_window = int(scrape_window)
        #: replicas that have answered a full-backlog bootstrap scrape
        self._bootstrapped: set = set()
        self.history = FleetHistory(capacity=retention)
        self.offsets = ClockOffsets()
        self.slo = SLOEngine(
            self.history,
            specs=(
                slo_specs if slo_specs is not None
                else fleet_default_specs()
            ),
        ).install()
        self._lock = threading.Lock()
        self._seq = 0
        #: per-replica last scraped history window seq (scrape cursor)
        self._last_seq: Dict[str, int] = {}
        #: previous cumulative values of the frontend's own fleet.*
        #: counters, merged into fleet windows as the router's lane.
        #: Primed NOW so the first window carries increments since this
        #: federation was created — not whatever the process-global
        #: registry accumulated before it (prior fleets, other tests).
        self._prev_local: Dict[str, int] = {}
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._local_deltas()

    # -------------------------------------------------------------- scraping
    def targets(self) -> Dict[str, dict]:
        """name -> {url, state} for every fleet member. DEAD members are
        listed (they belong in the missing-replica report) but never
        fetched — a crashed replica must not cost one timeout per tick."""
        from janusgraph_tpu_torch.server.fleet import DEAD

        out = {}
        for name, handle in sorted(self.router.replicas().items()):
            out[name] = {
                "url": handle.base_url,
                "skip": handle.state == DEAD,
            }
        return out

    def tick(self) -> dict:
        """One federation round: scrape every live replica's raw history
        windows, estimate clock offsets from the round-trips, merge one
        fleet window (partial + missing list when any replica failed to
        answer), fold in the frontend's own router-plane counters, run
        the outlier detector, append (which drives the fleet SLO
        engine), and account the scrape overhead. Returns the window."""
        from janusgraph_tpu_torch.observability import registry

        t0 = time.perf_counter()
        cpu0 = time.thread_time()
        registry.counter("fleet.federation.ticks").inc()
        missing: List[str] = []
        contributed: Dict[str, List[dict]] = {}
        live: List[tuple] = []
        for name, target in self.targets().items():
            if target["skip"]:
                missing.append(name)
            else:
                live.append((name, target["url"]))
        # push transport first: replicas with a live channel are served
        # from their pushed-window buffer and SKIP the HTTP scrape
        # entirely; everyone else (poll-only peers, refused capability,
        # dropped channels this tick) takes the poll path below
        push_served: Dict[str, _PushChannel] = {}
        if self.push_enabled:
            push_served = self._push_tick(live)
            live = [(n, u) for n, u in live if n not in push_served]
        # fetches run in parallel — the tick's wall cost is the slowest
        # replica, not the sum. Each fetch measures its own RTT (offset
        # estimation) on the monotonic clock.
        results: Dict[str, Optional[tuple]] = {}

        def _scrape(name: str, url: str) -> None:
            # after the bootstrap scrape (full backlog) only the recent
            # tail is requested — a full-ring payload per tick is O(n^2)
            # over a run; the cursor-gap counter below catches a tail
            # shorter than the gap since the last successful scrape
            suffix = "/timeseries?raw=1"
            if name in self._bootstrapped:
                suffix += f"&window={self.scrape_window}"
            send_wall = self._wall()
            m0 = self._clock()
            c0 = time.thread_time()
            try:
                payload = self._fetch(url + suffix, self.timeout_s)
            except Exception:  # noqa: BLE001 - any scrape failure = missing
                results[name] = (None, time.thread_time() - c0)
                return
            results[name] = (
                (send_wall, self._clock() - m0, payload),
                time.thread_time() - c0,
            )

        if len(live) == 1:
            _scrape(*live[0])
        elif live:
            threads = [
                threading.Thread(
                    target=_scrape, args=(name, url), daemon=True
                )
                for name, url in live
            ]
            for th in threads:
                th.start()
            for th in threads:
                th.join(timeout=self.timeout_s * 2 + 1.0)
        fetch_cpu_s = 0.0
        for name, url in live:
            got, cpu_s = results.get(name) or (None, 0.0)
            fetch_cpu_s += cpu_s
            payload = got[2] if got else None
            if not isinstance(payload, dict) or "windows" not in payload:
                registry.counter("fleet.federation.scrape_failures").inc()
                missing.append(name)
                continue
            send_wall, rtt_s, _ = got
            self._bootstrapped.add(name)
            peer_wall = payload.get("now")
            if isinstance(peer_wall, (int, float)):
                self.offsets.observe(
                    name, send_wall, rtt_s, float(peer_wall)
                )
            # the scrape cursor keys on the PRODUCER identity the
            # payload reports, not the routing name: an in-process
            # fleet (test/bench harness) serves the same shared history
            # ring from every port, and cursoring per routing name
            # would merge each window once per replica (3x counters).
            # Real fleets with no identity set fall back to the routing
            # name — one producer per process, unchanged semantics.
            producer = str(payload.get("replica") or "") or name
            with self._lock:
                cursor = self._last_seq.get(producer, 0)
            fresh = [
                w for w in payload["windows"]
                if isinstance(w, dict) and int(w.get("seq", 0)) > cursor
            ]
            if fresh:
                if cursor > 0 and int(fresh[0].get("seq", 0)) > cursor + 1:
                    # the bounded tail didn't reach back to the cursor:
                    # heal with ONE full-backlog re-fetch instead of
                    # letting the gap count grow tick after tick
                    registry.counter(
                        "fleet.federation.cursor_gaps"
                    ).inc()
                    healed = self._heal_cursor(url, cursor)
                    if healed:
                        fresh = healed
                with self._lock:
                    self._last_seq[producer] = int(fresh[-1]["seq"])
            contributed[name] = fresh
        # push-served replicas: merge their buffered pushed windows
        # through the SAME producer-keyed cursor (shared producers
        # still count once) and the same gap heal
        for name, channel in sorted(push_served.items()):
            producer = channel.producer
            self._bootstrapped.add(name)
            with self._lock:
                cursor = self._last_seq.get(producer, 0)
            fresh = [
                w for w in channel.take_windows()
                if isinstance(w, dict) and int(w.get("seq", 0)) > cursor
            ]
            if fresh:
                if cursor > 0 and int(fresh[0].get("seq", 0)) > cursor + 1:
                    # the bus dropped oldest under backpressure: same
                    # gap, same heal — the poll path never went away
                    registry.counter(
                        "fleet.federation.cursor_gaps"
                    ).inc()
                    healed = self._heal_cursor(channel.url, cursor)
                    if healed:
                        fresh = healed
                with self._lock:
                    self._last_seq[producer] = int(fresh[-1]["seq"])
            contributed[name] = fresh
        body = merge_windows(contributed)
        # the outlier detector runs BEFORE the local-counter diff so its
        # verdict counter lands in THIS window — the SLO engine then
        # evaluates the window that caused the burn, not the next one
        outliers = self._outlier_check(body["by_replica"])
        for name, delta in self._local_deltas().items():
            body["counters"][name] = (
                body["counters"].get(name, 0) + delta
            )
        partial = bool(missing)
        if partial:
            registry.counter("fleet.federation.partial_scrapes").inc()
        with self._lock:
            self._seq += 1
            window = {
                "seq": self._seq,
                "t": self._clock(),
                "ts": self._wall(),
                "interval_s": self.interval_s,
                "replicas": sorted(contributed),
                "partial": partial,
                "missing": sorted(missing),
                "outliers": outliers,
                **body,
            }
        # two overhead measures: wall (what this tick took end-to-end,
        # queueing included) and CPU (the cost the federation actually
        # imposes on the box — fetch-thread CPU + this thread's merge/
        # evaluate CPU). On an oversubscribed core the wall measures the
        # scheduler, not the scrape; budgets gate on the CPU number.
        overhead_ms = (time.perf_counter() - t0) * 1000.0
        overhead_cpu_ms = (
            (time.thread_time() - cpu0) + fetch_cpu_s
        ) * 1000.0
        registry.set_gauge(
            "fleet.federation.overhead_ms", round(overhead_ms, 4)
        )
        registry.set_gauge(
            "fleet.federation.overhead_cpu_ms",
            round(overhead_cpu_ms, 4),
        )
        registry.timer("fleet.federation.scrape").update(
            int(overhead_ms * 1e6)
        )
        registry.timer("fleet.federation.scrape_cpu").update(
            int(overhead_cpu_ms * 1e6)
        )
        # append last: listeners (the fleet SLO engine) see a window
        # whose overhead accounting is already on the books
        self.history.append(window)
        with self._lock:
            # watchdog progress advances only when a tick COMPLETES —
            # a tick wedged mid-scrape freezes this and fires a stall
            self._tick_count += 1
        return window

    def _heal_cursor(self, url: str, cursor: int) -> Optional[List[dict]]:
        """One full-backlog ``raw=1`` re-fetch after a cursor gap (the
        bounded tail or a drop-oldest push stream didn't reach back to
        the cursor).  Returns the fresh windows past the cursor, or
        None when the heal itself failed (the gap stands, counted
        once — not per tick)."""
        from janusgraph_tpu_torch.observability import registry

        try:
            payload = self._fetch(url + "/timeseries?raw=1", self.timeout_s)
        except Exception:  # noqa: BLE001 - a failed heal is a counted no-op
            registry.counter("fleet.federation.cursor_heal_failures").inc()
            return None
        if not isinstance(payload, dict) or "windows" not in payload:
            registry.counter("fleet.federation.cursor_heal_failures").inc()
            return None
        registry.counter("fleet.federation.cursor_heals").inc()
        return [
            w for w in payload["windows"]
            if isinstance(w, dict) and int(w.get("seq", 0)) > cursor
        ]

    # ------------------------------------------------------ push transport
    def _push_tick(self, live: List[tuple]) -> Dict[str, _PushChannel]:
        """Maintain push channels for this tick: drop dead streams
        (flighted, and renegotiated with resume cursors in the same
        pass), negotiate with replicas not yet refused, and return the
        channels serving this tick."""
        from janusgraph_tpu_torch.observability import flight_recorder, registry

        live_names = {n for n, _ in live}
        for name in list(self._push):
            channel = self._push[name]
            if name not in live_names or not channel.connected:
                channel.stop()
                del self._push[name]
                flight_recorder.record(
                    "fleet", action="push_lost", replica=name
                )
                registry.counter("fleet.federation.push_lost").inc()
        served: Dict[str, _PushChannel] = {}
        for name, url in live:
            channel = self._push.get(name)
            if channel is None and name not in self._push_refused:
                channel = self._open_push(name, url)
            if channel is not None:
                served[name] = channel
        registry.set_gauge(
            "fleet.federation.push_channels", float(len(served))
        )
        return served

    def _open_push(self, name: str, url: str) -> Optional[_PushChannel]:
        """Negotiate the streaming capability with one replica and open
        its push channel.  A capability miss (a REPLY without the
        ``watch`` bit — an older peer's 404 body) marks the peer
        POLL-ONLY, terminally: the feature-bit discipline keeps it on
        the exact scrape path from here on.  A transport failure
        (connection refused, timeout — the probe never got an answer)
        is NOT a refusal: a replica mid-restart must renegotiate when
        it comes back, so it retries next tick."""
        from janusgraph_tpu_torch.observability import flight_recorder, registry

        send_wall = self._wall()
        m0 = self._clock()
        try:
            info = self._fetch(url + "/watch/info", self.timeout_s)
        except Exception:  # noqa: BLE001 - unanswered probe: retry next tick
            registry.counter(
                "fleet.federation.push_connect_failures"
            ).inc()
            return None
        if not isinstance(info, dict) or not info.get("watch"):
            self._push_refused.add(name)
            registry.counter("fleet.federation.push_refused").inc()
            return None
        rtt_s = self._clock() - m0
        peer_wall = info.get("now")
        if isinstance(peer_wall, (int, float)):
            # the negotiation round-trip doubles as the NTP-style
            # offset probe the poll path gets from every scrape
            self.offsets.observe(name, send_wall, rtt_s, float(peer_wall))
        producer = str(info.get("replica") or "") or name
        with self._lock:
            cursors = {"window": int(self._last_seq.get(producer, 0))}
            flight_cursor = self._flight_seq.get(producer)
        if flight_cursor is not None:
            # reconnect: resume the flight stream past what we saw
            cursors["flight"] = int(flight_cursor)
        subscribe = {
            "streams": ["window", "flight"],
            "cursors": cursors,
            "heartbeat_s": max(0.5, min(self.interval_s, 2.0)),
            "name": "fleet-federation",
        }
        try:
            session = self._watch_factory(url, subscribe, self.timeout_s)
        except Exception:  # noqa: BLE001 - transport failure: retry next tick
            registry.counter(
                "fleet.federation.push_connect_failures"
            ).inc()
            return None
        channel = _PushChannel(self, name, url, producer, session)
        channel.start()
        self._push[name] = channel
        registry.counter("fleet.federation.push_negotiated").inc()
        flight_recorder.record(
            "fleet", action="push_on", replica=name, producer=producer
        )
        return channel

    def _on_push_event(self, channel: _PushChannel, event: dict) -> None:
        """A flight event arrived on a push stream (reader thread):
        advance the resume cursor, account the event→frontend freshness
        lag, and ship announced bundles off-host."""
        from janusgraph_tpu_torch.observability import registry

        producer = str(event.get("replica") or "") or channel.producer
        seq = int(event.get("seq", 0))
        with self._lock:
            if seq > self._flight_seq.get(producer, 0):
                self._flight_seq[producer] = seq
        ts = event.get("ts")
        if isinstance(ts, (int, float)):
            lag_s = self._wall() - self.offsets.correct(producer, float(ts))
            registry.timer("fleet.federation.push_event_lag").update(
                int(max(0.0, lag_s) * 1e9)
            )
        if str(event.get("category", "")) == "bundle":
            self._ship_bundle(channel, event)

    def _ship_bundle(self, channel: _PushChannel, event: dict) -> None:
        """Fetch an announced forensics bundle off-host (rate-bounded
        per replica, torn/unparseable fetches skipped and counted)."""
        from janusgraph_tpu_torch.observability import registry

        if not self.ship_bundles:
            return
        replica = str(event.get("replica") or "") or channel.producer
        if not self.bundles.should_fetch(replica):
            registry.counter("fleet.federation.bundle_rate_limited").inc()
            return
        try:
            payload = self._fetch(
                channel.url + "/debug/bundle", self.timeout_s
            )
        except Exception:  # noqa: BLE001 - a lost bundle is counted, not fatal
            payload = None
        # GET /debug/bundle returns the bundle dict DIRECTLY (with its
        # on-disk "path" folded in) — a 404/error body carries "status"
        # instead, and a torn reply is not a dict at all
        bundle = (
            payload
            if isinstance(payload, dict) and "status" not in payload
            else None
        )
        if not isinstance(bundle, dict) or not bundle:
            # torn-skip: the replica had no readable bundle (or died
            # mid-reply) — skip it, never poison the store
            registry.counter(
                "fleet.federation.bundle_fetch_failures"
            ).inc()
            return
        self.bundles.add(
            replica,
            reason=str(event.get("reason") or ""),
            path=str(event.get("path") or ""),
            bundle=bundle,
        )
        registry.counter("fleet.federation.bundles_shipped").inc()

    def push_status(self) -> dict:
        """The push-transport block of ``GET /fleet/timeseries`` and
        the CLI's fleet view."""
        with self._lock:
            refused = sorted(self._push_refused)
            channels = {n: c.state() for n, c in self._push.items()}
        return {
            "enabled": self.push_enabled,
            "channels": channels,
            "poll_only": refused,
            "bundles": self.bundles.status(),
        }

    def _tick_progress(self) -> dict:
        """Stall-watchdog progress source (auto-registered by
        :meth:`start`): the loop is active while the thread runs, and
        progress is completed ticks — a tick wedged in a scrape stops
        advancing it and fires a ``stall`` flight event."""
        with self._lock:
            count = self._tick_count
        return {
            "active": 1 if self._thread is not None else 0,
            "progress": count,
        }

    def _local_deltas(self) -> Dict[str, int]:
        """Window deltas of the frontend process's OWN ``fleet.*``
        counters (router retries/deaths, federation verdicts): the
        router's lane of the fleet window — these live here, not on any
        replica, so a pure scrape would never see them."""
        from janusgraph_tpu_torch.observability import registry

        counters, _timers, _hists, _gauges = registry.metric_objects()
        out: Dict[str, int] = {}
        with self._lock:
            for name, c in counters.items():
                if not name.startswith("fleet."):
                    continue
                cur = int(c.count)
                prev = self._prev_local.get(name)
                self._prev_local[name] = cur
                delta = (
                    cur - prev if prev is not None and cur >= prev else cur
                )
                if delta:
                    out[name] = delta
        return out

    def _outlier_check(
        self, by_replica: Dict[str, Dict[str, dict]]
    ) -> List[dict]:
        """Cross-replica latency outlier detection: a replica whose
        windowed p99 of the watched metric exceeds ``outlier_factor x``
        the fleet MEDIAN p99 (among replicas with enough observations)
        raises a ``replica_outlier`` flight event and burns the outlier
        budget (``fleet.federation.outlier_windows``)."""
        from janusgraph_tpu_torch.observability import flight_recorder, registry

        entries = by_replica.get(self.outlier_metric) or {}
        p99s = {
            r: float(e["p99"]) for r, e in entries.items()
            if int(e.get("count", 0)) >= self.outlier_min_count
        }
        if len(p99s) < 2:
            return []
        ranked = sorted(p99s.values())
        mid = len(ranked) // 2
        median = (
            ranked[mid] if len(ranked) % 2
            else (ranked[mid - 1] + ranked[mid]) / 2.0
        )
        if median <= 0:
            return []
        outliers = []
        for replica, p99 in sorted(p99s.items()):
            if p99 > self.outlier_factor * median:
                outliers.append({
                    "replica": replica,
                    "p99_ns": p99,
                    "fleet_median_ns": median,
                    "factor": round(p99 / median, 2),
                })
                flight_recorder.record(
                    "replica_outlier",
                    replica=replica, metric=self.outlier_metric,
                    p99_ns=p99, fleet_median_ns=median,
                    threshold_factor=self.outlier_factor,
                )
        if outliers:
            registry.counter("fleet.federation.outlier_windows").inc()
        return outliers

    # ------------------------------------------------------------ lifecycle
    def start(self, interval_s: Optional[float] = None) -> None:
        if interval_s is not None:
            self.interval_s = float(interval_s)
        if self._thread is not None:
            return
        self._stop.clear()

        def _loop():
            while not self._stop.wait(self.interval_s):
                try:
                    self.tick()
                except Exception as e:  # noqa: BLE001 - the scraper must not die
                    # record before continuing: an unrecorded
                    # tick failure looks identical to "no new windows"
                    from janusgraph_tpu_torch.observability.flight import (
                        recorder,
                    )

                    recorder.record(
                        "thread_error", thread="fleet-federation",
                        error=repr(e),
                    )

        self._thread = threading.Thread(
            target=_loop, daemon=True, name="fleet-federation"
        )
        self._thread.start()
        # the tick loop auto-registers as a watchdog progress source
        # (no manual wiring): a wedged tick fires a stall event
        if self._watchdog is None:
            from janusgraph_tpu_torch.observability.continuous import (
                watchdog_singleton,
            )

            self._watchdog = watchdog_singleton()
        self._watchdog.register_progress(
            "fleet.federation.tick", self._tick_progress
        )

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None
        if self._watchdog is not None:
            self._watchdog.unregister_progress("fleet.federation.tick")
        for name in list(self._push):
            self._push.pop(name).stop()

    # --------------------------------------------------------- merged views
    def timeseries_view(self, name: str = "", window: int = 0) -> dict:
        """The ``GET /fleet/timeseries`` payload: merged fleet windows as
        per-metric series (``?name=`` prefix filter, ``?window=N`` last-N
        bound, same vocabulary as the per-replica ``/timeseries``).
        Counter points carry the fleet-summed ``delta``, series points
        the merged summary WITH its bucket vector, gauge points a
        ``value`` dict keyed per replica. ``partial``/``missing`` report
        scrape completeness over the served slice — a window scraped
        around a dead replica never reads as complete."""
        ws = self.history.windows(window)
        names = set()
        for w in ws:
            names.update(w["counters"])
            names.update(w["series"])
            names.update(w["gauges"])
        series: Dict[str, List[dict]] = {}
        for n in sorted(names):
            if name and not n.startswith(name):
                continue
            pts = []
            for w in ws:
                point = {"seq": w["seq"], "ts": w["ts"]}
                if n in w["counters"]:
                    point["delta"] = w["counters"][n]
                elif n in w["series"]:
                    point.update(w["series"][n])
                elif n in w["gauges"]:
                    point["value"] = w["gauges"][n]
                else:
                    continue
                if w["partial"]:
                    point["partial"] = True
                pts.append(point)
            if pts:
                series[n] = pts
        missing = sorted({m for w in ws for m in w["missing"]})
        return {
            "interval_s": self.interval_s,
            "windows": len(ws),
            "first_seq": ws[0]["seq"] if ws else 0,
            "last_seq": ws[-1]["seq"] if ws else 0,
            "replicas": sorted({r for w in ws for r in w["replicas"]}),
            "partial": bool(missing),
            "missing": missing,
            "offsets": self.offsets.snapshot(),
            "slo": self.slo.snapshot(),
            "series": series,
        }

    def metrics_view(self) -> dict:
        """The ``GET /fleet/metrics`` payload: an on-demand merge of
        every live replica's CURRENT ``/telemetry`` metric snapshot —
        counters sum, gauges keyed per replica, timers/histograms keyed
        per replica with a fleet count/mean roll-up (exact fleet
        percentiles live in the windowed view, where bucket vectors
        exist). Partial + missing semantics match the windowed view."""
        missing: List[str] = []
        snaps: Dict[str, dict] = {}
        for name, target in self.targets().items():
            if target["skip"]:
                missing.append(name)
                continue
            try:
                payload = self._fetch(
                    target["url"] + "/telemetry", self.timeout_s
                )
                snaps[name] = payload["metrics"]
            except Exception:  # noqa: BLE001 - any scrape failure = missing
                missing.append(name)
        merged: Dict[str, dict] = {}
        for replica in sorted(snaps):
            for mname, m in snaps[replica].items():
                kind = m.get("type")
                slot = merged.setdefault(mname, {"type": kind})
                if kind == "counter":
                    slot["count"] = (
                        slot.get("count", 0) + int(m.get("count", 0))
                    )
                elif kind == "gauge":
                    slot.setdefault("value", {})[replica] = m.get("value")
                else:  # timer / histogram: keyed + count/mean roll-up
                    slot.setdefault("by_replica", {})[replica] = m
                    n_old = slot.get("count", 0)
                    n_new = int(m.get("count", 0))
                    slot["count"] = n_old + n_new
                    if kind == "timer":
                        t_old = slot.get("total_ms", 0.0)
                        slot["total_ms"] = t_old + float(
                            m.get("total_ms", 0.0)
                        )
                        slot["mean_ms"] = (
                            slot["total_ms"] / slot["count"]
                            if slot["count"] else 0.0
                        )
        return {
            "replicas": sorted(snaps),
            "partial": bool(missing),
            "missing": sorted(missing),
            "metrics": merged,
        }

    # ------------------------------------------------------------- forensics
    def incident(self, window_s: float = 60.0) -> dict:
        """The ``GET /fleet/incident`` payload: every replica's flight
        ring pulled, every event's wall stamp corrected onto the
        frontend clock by the per-replica offset estimate, merged into
        one causally ordered event list + a Chrome-trace document with a
        lane per replica. ``window_s`` bounds the lookback (0 = whole
        rings). Dead/unreachable replicas make the report ``partial`` —
        the incident ends exactly where their ring went dark, which is
        itself forensic signal."""
        from janusgraph_tpu_torch.observability import flight_recorder

        missing: List[str] = []
        raw: List[dict] = []
        sources: List[str] = []
        for name, target in self.targets().items():
            if target["skip"]:
                missing.append(name)
                continue
            try:
                payload = self._fetch(
                    target["url"] + "/flight", self.timeout_s
                )
                events = payload["events"]
            except Exception:  # noqa: BLE001 - any scrape failure = missing
                missing.append(name)
                continue
            sources.append(name)
            for e in events:
                if isinstance(e, dict):
                    raw.append({**e, "source": name})
        # the frontend's own ring rides along: router-side events
        # (dead/rejoin/drain, slo_burn, replica_outlier) live here
        for e in flight_recorder.events():
            raw.append({**e, "source": "frontend"})
        merged = merge_incident_events(
            raw, self.offsets, now_wall=self._wall(), window_s=window_s,
        )
        trace = incident_trace(merged)
        return {
            "window_s": window_s,
            "replicas": sources,
            "partial": bool(missing),
            "missing": sorted(missing),
            "offsets": self.offsets.snapshot(),
            "events": merged,
            "phases": incident_phases(merged),
            "trace": trace,
        }


# ------------------------------------------------------- incident rendering
def merge_incident_events(
    events: List[dict],
    offsets: ClockOffsets,
    now_wall: float,
    window_s: float = 0.0,
) -> List[dict]:
    """Offset-correct, window, dedup, and causally order raw flight
    events from N rings. Each event's lane is its ``replica`` field (the
    identity stamp every fleet event carries) falling back to the ring
    it was scraped from; the corrected stamp ``ts_corrected`` maps the
    producer's wall clock onto the caller's via the offset estimates, so
    two replicas with ±500 ms of wall skew still interleave in true
    causal order (to ~rtt/2 accuracy). In-process fleets share one ring
    between replicas, so identical events scraped N times collapse."""
    seen = set()
    out = []
    for e in events:
        lane = str(e.get("replica") or e.get("source") or "")
        ts = e.get("ts")
        if not isinstance(ts, (int, float)):
            continue
        source = str(e.get("source") or "")
        corrected = offsets.correct(source, float(ts))
        if window_s and corrected < now_wall - window_s:
            continue
        key = (e.get("seq"), round(float(ts), 6), e.get("category"), lane)
        if key in seen:
            continue
        seen.add(key)
        out.append({
            **{k: v for k, v in e.items() if k != "source"},
            "lane": lane,
            "ts_corrected": corrected,
        })
    out.sort(key=lambda e: (e["ts_corrected"], e.get("seq", 0)))
    return out


def incident_phases(merged: List[dict]) -> List[dict]:
    """The failover narrative: the first corrected-time occurrence of
    each phase boundary (kill -> mark_dead -> re-pin -> warm-up). When
    the stream contains a kill, the narrative anchors there — joins and
    warm-ups from the ORIGINAL fleet bring-up (before the kill) are
    bring-up, not failover, and must not claim a phase slot."""
    anchor = float("-inf")
    kill_match = _PHASE_EVENTS[0][1]
    for e in merged:
        if kill_match(e):
            anchor = e["ts_corrected"]
            break
    phases = []
    for phase, match in _PHASE_EVENTS:
        for e in merged:
            if e["ts_corrected"] >= anchor and match(e):
                phases.append({
                    "phase": phase,
                    "ts_corrected": e["ts_corrected"],
                    "lane": e["lane"],
                    "category": e.get("category"),
                    "detail": e.get("action") or e.get("kind"),
                })
                break
    return phases


def incident_trace(merged: List[dict]) -> dict:
    """One Chrome-trace document over the merged incident: a lane (tid)
    per replica, one instant event per flight record at its corrected
    time — loads in chrome://tracing / ui.perfetto.dev next to the
    OLAP timelines (same catapult vocabulary, validate_chrome_trace
    clean)."""
    from janusgraph_tpu_torch.observability.timeline import PID, _meta

    lanes = sorted({e["lane"] for e in merged})
    tid_of = {lane: i + 1 for i, lane in enumerate(lanes)}
    events = [_meta("process_name", 0, "fleet incident")]
    for lane in lanes:
        events.append(
            _meta("thread_name", tid_of[lane], f"replica {lane}" if lane else "untagged")
        )
    t0 = merged[0]["ts_corrected"] if merged else 0.0
    for e in merged:
        name = str(e.get("category", "event"))
        detail = e.get("action") or e.get("kind")
        if detail:
            name = f"{name}:{detail}"
        args = {
            k: v for k, v in e.items()
            if k not in ("lane", "ts_corrected") and isinstance(
                v, (str, int, float, bool, type(None))
            )
        }
        events.append({
            "ph": "i", "pid": PID, "tid": tid_of[e["lane"]],
            "name": name, "s": "t",
            "ts": round((e["ts_corrected"] - t0) * 1e6, 3),
            "args": args,
        })
    return {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "otherData": {
            "kind": "fleet-incident",
            "lanes": lanes,
            "events": len(merged),
        },
    }
