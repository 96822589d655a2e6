"""Streaming telemetry bus: the push transport under the pull planes —
the port's copy of ``janusgraph_tpu/observability/stream.py``.

The other observability surfaces are pull-driven: a scraper polls
``/timeseries``, forensics bundles wait on disk for someone to ask, and
an operator tailing an incident refreshes ``/flight`` by hand. Polling
bounds freshness by the poll interval and burns a full scrape per tick
even when nothing happened (event-driven delivery beats periodic bulk
exchange when events are sparse, PAPERS.md 2108.11521). This module is
the in-process push transport:

``TelemetryBus``
    A typed pub/sub hub over the existing retained planes.  Five
    streams, each keyed by the PRODUCER's own monotonic sequence — the
    same cursor vocabulary the federation already uses for scrape
    windows, so one resume protocol covers both transports:

    ==========  =========================================  ============
    stream      source                                     seq
    ==========  =========================================  ============
    ``flight``  every :class:`FlightRecorder` event        flight seq
    ``window``  every sealed :class:`MetricsHistory`       window seq
                window (bucket vectors included)
    ``slo``     flight events of category ``slo_burn``     flight seq
                (the SLO engine's ladder transitions)
    ``flame``   history-aligned profiler flame-window      window seq
                seals (fallback seals, ``seq=-1``, have
                no stable cursor and are not streamed)
    ``bundle``  flight events of category ``bundle``       flight seq
                (BundleWriter episode announcements —
                what off-host shipping rides)
    ==========  =========================================  ============

    The bus taps its sources through their listener hooks
    (:meth:`FlightRecorder.add_listener`,
    :meth:`MetricsHistory.add_listener`,
    :meth:`SamplingProfiler.add_seal_listener`), all of which fire
    AFTER the source's ring lock is released — publishing never runs
    under a producer lock, and the bus fan-out itself holds only the
    bus lock for dict/deque work.

``Subscription``
    Bounded per-subscriber queues with DROP-OLDEST overflow and a
    per-subscriber ``dropped`` counter (a fan-out publish into
    subscriber queues without a drop/accounting path is a convoy
    hazard: one slow subscriber must cost itself data, never stall the
    producers).  Each subscription
    tracks per-stream cursors of the last sequence it was offered, so:

    - a reconnecting subscriber passes its cursors back and the bus
      REPLAYS the retained tail past them (no duplicates, no full
      re-bootstrap — the bounded source rings are the replay log);
    - a cursor older than the ring's first retained seq shows up as a
      seq gap at the consumer, exactly like a federation bounded-tail
      gap, and heals the same way (one full re-fetch);
    - passing no cursor for a stream means LIVE-ONLY: the floor is
      seeded at the source's current seq and history is skipped.

    Subscriber drains auto-register with the stall watchdog (a queue
    with work whose ``delivered`` count stops moving is a wedged
    consumer), and deregister on :meth:`TelemetryBus.unsubscribe`.

Self-cost is accounted on BOTH clocks: publish
fan-out wall and CPU seconds accumulate into
``observability.stream.overhead_wall_ms`` / ``overhead_cpu_ms`` gauges,
and a publish with zero subscribers costs one lock acquire and nothing
else.  Consumers: the server's ``/watch`` WebSocket endpoint and the
driver's ``WatchSession``; the reference's ``watch`` tool and the
fleet's push-mode scraper are ROADMAP Queue A #5.6b.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Dict, Iterable, List, Optional, Tuple

__all__ = [
    "STREAMS",
    "Subscription",
    "TelemetryBus",
    "telemetry_bus",
]

#: the bus taxonomy, in documentation order
STREAMS = ("flight", "window", "slo", "flame", "bundle")

#: flight-event categories re-published as their own typed streams
_DERIVED = {"slo_burn": "slo", "bundle": "bundle"}


class Subscription:
    """One subscriber's bounded drop-oldest queue plus its cursors.

    Created by :meth:`TelemetryBus.subscribe`; consumers call
    :meth:`pop` (blocking, for the ``/watch`` handler's event loop) or
    :meth:`drain` (non-blocking batch, for the push federation's
    reader).  Envelopes are ``{"stream", "seq", "data"}``.
    """

    def __init__(
        self,
        name: str,
        streams: Iterable[str],
        names: Iterable[str] = (),
        depth: int = 256,
    ):
        self.name = name
        self.streams = frozenset(streams)
        #: optional name-prefix filters: flight-family events match on
        #: their category, windows are trimmed to matching metric names
        self.names: Tuple[str, ...] = tuple(names or ())
        self.depth = max(1, int(depth))
        # maxlen is a backstop only: _offer pops-and-counts at depth
        # BEFORE appending, so eviction is always accounted
        self._q: deque = deque(maxlen=self.depth)
        self._cond = threading.Condition()
        self.closed = False
        #: events discarded to keep the queue bounded (drop-oldest)
        self.dropped = 0
        self.enqueued = 0
        self.delivered = 0
        #: per-stream last OFFERED seq — the resume cursor. Advanced
        #: even for name-filtered-out events, so a filtered stream is
        #: not gap-free by design (documented in observability.md).
        self.cursors: Dict[str, int] = {}

    # ---------------------------------------------------------- filtering
    def _filter(self, stream: str, data: dict) -> Optional[dict]:
        """Apply the name-prefix filter; None = not for this subscriber."""
        if not self.names:
            return data
        if stream in ("flight", "slo", "bundle"):
            cat = str(data.get("category", ""))
            if any(cat.startswith(p) for p in self.names):
                return data
            return None
        if stream == "window":
            counters = {
                k: v for k, v in (data.get("counters") or {}).items()
                if any(k.startswith(p) for p in self.names)
            }
            series = {
                k: v for k, v in (data.get("series") or {}).items()
                if any(k.startswith(p) for p in self.names)
            }
            gauges = {
                k: v for k, v in (data.get("gauges") or {}).items()
                if any(k.startswith(p) for p in self.names)
            }
            if not (counters or series or gauges):
                return None
            return {
                **data,
                "counters": counters,
                "series": series,
                "gauges": gauges,
            }
        return data

    # ------------------------------------------------------------ enqueue
    def _offer(self, stream: str, seq: int, data: dict) -> Tuple[bool, bool]:
        """Offer one event; returns ``(enqueued, dropped_one)``.  The
        per-stream cursor makes offers idempotent: a replayed tail and
        a racing live publish of the same seq enqueue exactly once."""
        with self._cond:
            if self.closed or stream not in self.streams:
                return False, False
            last = self.cursors.get(stream)
            if last is not None and seq <= last:
                return False, False
            self.cursors[stream] = seq
            payload = self._filter(stream, data)
            if payload is None:
                return False, False
            dropped_one = False
            if len(self._q) >= self.depth:
                # drop-oldest: the slow consumer pays, producers never
                # block (accounted, not silent)
                self._q.popleft()
                self.dropped += 1
                dropped_one = True
            self._q.append({"stream": stream, "seq": seq, "data": payload})
            self.enqueued += 1
            self._cond.notify()
            return True, dropped_one

    # ------------------------------------------------------------ consume
    def pop(self, timeout: Optional[float] = None) -> Optional[dict]:
        """Dequeue one envelope, waiting up to ``timeout`` seconds;
        None on timeout or when closed with an empty queue (the
        ``/watch`` handler turns that into a heartbeat)."""
        with self._cond:
            if not self._q and not self.closed and timeout:
                self._cond.wait(timeout)
            if not self._q:
                return None
            self.delivered += 1
            return self._q.popleft()

    def drain(self, max_events: int = 0) -> List[dict]:
        """Dequeue everything queued right now (bounded by
        ``max_events`` when > 0) without waiting."""
        with self._cond:
            n = len(self._q)
            if max_events > 0:
                n = min(n, max_events)
            out = [self._q.popleft() for _ in range(n)]
            self.delivered += n
            return out

    def close(self) -> None:
        with self._cond:
            self.closed = True
            self._cond.notify_all()

    # ----------------------------------------------------------- plumbing
    def _progress(self) -> dict:
        """Stall-watchdog progress source: queued work whose delivered
        count stops moving is a wedged consumer."""
        with self._cond:
            return {
                "active": 1 if self._q and not self.closed else 0,
                "progress": self.delivered,
            }

    def stats(self) -> dict:
        with self._cond:
            return {
                "name": self.name,
                "streams": sorted(self.streams),
                "names": list(self.names),
                "depth": self.depth,
                "queued": len(self._q),
                "enqueued": self.enqueued,
                "delivered": self.delivered,
                "dropped": self.dropped,
                "cursors": dict(self.cursors),
                "closed": self.closed,
            }


class TelemetryBus:
    """The process-wide pub/sub hub; see the module docstring for the
    stream taxonomy and cursor protocol.  Sources are injectable for
    tests (a fake replica builds a bus over its own history/recorder);
    the module singleton taps the process singletons lazily."""

    def __init__(
        self,
        depth: int = 256,
        history=None,
        recorder=None,
        profiler=None,
    ):
        self.depth = int(depth)
        self._history = history
        self._recorder = recorder
        self._profiler = profiler
        self._lock = threading.Lock()
        self._subs: List[Subscription] = []
        self._serial = 0
        self._attached = False
        self.published = 0
        self.dropped = 0
        self._overhead_wall_s = 0.0
        self._overhead_cpu_s = 0.0

    # ------------------------------------------------------------- sources
    def _sources(self) -> tuple:
        recorder = self._recorder
        history = self._history
        profiler = self._profiler
        if recorder is None:
            from janusgraph_tpu_torch.observability.flight import (
                recorder as _rec,
            )

            recorder = self._recorder = _rec
        if history is None:
            from janusgraph_tpu_torch.observability.timeseries import (
                history as _hist,
            )

            history = self._history = _hist
        if profiler is None:
            from janusgraph_tpu_torch.observability.continuous import (
                sampling_profiler as _prof,
            )

            profiler = self._profiler = _prof
        return recorder, history, profiler

    def configure(self, depth: Optional[int] = None) -> None:
        if depth is not None and depth > 0:
            self.depth = int(depth)

    def attach(self) -> None:
        """Tap the sources (idempotent — the listener hooks dedup, so
        re-attaching after a source reset cleared its listeners simply
        heals the tap)."""
        recorder, history, profiler = self._sources()
        recorder.add_listener(self._on_flight)
        history.add_listener(self._on_window)
        profiler.add_seal_listener(self._on_flame)
        with self._lock:
            self._attached = True

    def detach(self) -> None:
        recorder, history, profiler = self._sources()
        recorder.remove_listener(self._on_flight)
        history.remove_listener(self._on_window)
        profiler.remove_seal_listener(self._on_flame)
        with self._lock:
            self._attached = False

    # ---------------------------------------------------------- publishers
    def _on_flight(self, event: dict) -> None:
        seq = int(event.get("seq", 0))
        self.publish("flight", seq, event)
        derived = _DERIVED.get(str(event.get("category", "")))
        if derived is not None:
            self.publish(derived, seq, event)

    def _on_window(self, window: dict) -> None:
        self.publish("window", int(window.get("seq", 0)), window)

    def _on_flame(self, window: dict) -> None:
        seq = int(window.get("seq", -1))
        if seq > 0:
            self.publish("flame", seq, window)

    def publish(self, stream: str, seq: int, data: dict) -> int:
        """Fan one event out to every matching subscriber; returns the
        number of queues it landed in.  Runs under the bus lock so a
        concurrent :meth:`subscribe` replay and this live publish can
        never lose an event between them (the cursor dedup in
        ``_offer`` collapses the overlap)."""
        with self._lock:
            if not self._subs:
                return 0
            w0 = time.perf_counter()
            c0 = time.thread_time()
            landed = 0
            dropped = 0
            for sub in self._subs:
                ok, dropped_one = sub._offer(stream, seq, data)
                if ok:
                    landed += 1
                if dropped_one:
                    dropped += 1
            self.published += 1
            self.dropped += dropped
            self._overhead_wall_s += time.perf_counter() - w0
            self._overhead_cpu_s += time.thread_time() - c0
            wall_ms = self._overhead_wall_s * 1000.0
            cpu_ms = self._overhead_cpu_s * 1000.0
        from janusgraph_tpu_torch.observability import registry

        registry.counter("observability.stream.published").inc()
        if dropped:
            registry.counter("observability.stream.dropped").inc(dropped)
        registry.set_gauge(
            "observability.stream.overhead_wall_ms", round(wall_ms, 4)
        )
        registry.set_gauge(
            "observability.stream.overhead_cpu_ms", round(cpu_ms, 4)
        )
        return landed

    # ------------------------------------------------------------- cursors
    def cursors(self) -> Dict[str, int]:
        """Current last-published seq per stream, read from the SOURCES
        (authoritative even before the first publish) — the
        ``/watch/info`` payload and every hello frame carry this, so a
        subscriber knows where live begins."""
        recorder, history, profiler = self._sources()
        flight_seq = int(recorder.last_seq)
        return {
            "flight": flight_seq,
            "window": int(history.last_seq()),
            "slo": flight_seq,
            "flame": int(profiler.last_seal_seq()),
            "bundle": flight_seq,
        }

    # ----------------------------------------------------------- subscribe
    def subscribe(
        self,
        streams: Optional[Iterable[str]] = None,
        names: Iterable[str] = (),
        cursors: Optional[Dict[str, int]] = None,
        depth: Optional[int] = None,
        name: str = "",
    ) -> Subscription:
        """Register a subscriber.  ``cursors`` maps stream -> last seq
        already seen: the retained tail past each cursor is replayed
        into the queue before live events flow (resume-after-reconnect
        without duplicates); streams without a cursor start LIVE-ONLY.
        ``streams=None`` subscribes to the full taxonomy."""
        wanted = frozenset(streams) if streams else frozenset(STREAMS)
        unknown = wanted - set(STREAMS)
        if unknown:
            raise ValueError(
                "unknown streams %s (taxonomy: %s)"
                % (sorted(unknown), ", ".join(STREAMS))
            )
        self.attach()
        cursors = dict(cursors or {})
        floors = self.cursors()
        with self._lock:
            self._serial += 1
            sub = Subscription(
                name=name or "sub-%d" % self._serial,
                streams=wanted,
                names=names,
                depth=depth if depth else self.depth,
            )
            for stream in wanted:
                given = cursors.get(stream)
                if given is not None:
                    # resume floor: replay everything retained past it
                    sub.cursors[stream] = int(given)
                else:
                    # live-only: floor at the source's current seq
                    sub.cursors[stream] = int(floors.get(stream, 0))
            self._replay(sub)
            self._subs.append(sub)
        self._register_drain(sub)
        return sub

    def _replay(self, sub: Subscription) -> None:
        """Feed the retained source tails past the subscriber's floors
        into its queue (called under the bus lock, before the sub is
        visible to live publishes — ``_offer``'s cursor check collapses
        any overlap with events racing in behind us)."""
        recorder, history, profiler = self._sources()
        if sub.streams & {"flight", "slo", "bundle"}:
            for event in recorder.events():
                seq = int(event.get("seq", 0))
                sub._offer("flight", seq, event)
                derived = _DERIVED.get(str(event.get("category", "")))
                if derived is not None:
                    sub._offer(derived, seq, event)
        if "window" in sub.streams:
            for window in history.windows():
                sub._offer("window", int(window.get("seq", 0)), window)
        if "flame" in sub.streams:
            for window in profiler.windows():
                seq = int(window.get("seq", -1))
                if seq > 0:
                    sub._offer("flame", seq, window)

    def _register_drain(self, sub: Subscription) -> None:
        """Satellite of the watchdog plane: every subscriber drain is a
        progress source with no manual wiring — a queue holding events
        whose delivered count froze is a wedged consumer."""
        from janusgraph_tpu_torch.observability.continuous import (
            watchdog_singleton,
        )

        watchdog_singleton().register_progress(
            "stream.%s" % sub.name, sub._progress
        )

    def unsubscribe(self, sub: Subscription) -> None:
        sub.close()
        with self._lock:
            if sub in self._subs:
                self._subs.remove(sub)
        from janusgraph_tpu_torch.observability.continuous import (
            watchdog_singleton,
        )

        watchdog_singleton().unregister_progress("stream.%s" % sub.name)

    # ------------------------------------------------------------ querying
    def subscriber_count(self) -> int:
        with self._lock:
            return len(self._subs)

    def status(self) -> dict:
        """The ``/watch/info`` body (minus transport negotiation) and
        the CLI's status view."""
        with self._lock:
            subs = [s.stats() for s in self._subs]
            published = self.published
            dropped = self.dropped
            wall_ms = self._overhead_wall_s * 1000.0
            cpu_ms = self._overhead_cpu_s * 1000.0
            attached = self._attached
        return {
            "streams": list(STREAMS),
            "attached": attached,
            "depth": self.depth,
            "published": published,
            "dropped": dropped,
            "overhead_wall_ms": round(wall_ms, 4),
            "overhead_cpu_ms": round(cpu_ms, 4),
            "subscribers": subs,
            "cursors": self.cursors(),
        }

    def reset(self) -> None:
        """Test hook: detach the taps, close every subscriber, zero the
        accounting."""
        try:
            self.detach()
        except Exception:  # noqa: BLE001 - a reset must always complete
            pass
        with self._lock:
            subs = list(self._subs)
            self._subs = []
        for sub in subs:
            sub.close()
            try:
                from janusgraph_tpu_torch.observability.continuous import (
                    watchdog_singleton,
                )

                watchdog_singleton().unregister_progress(
                    "stream.%s" % sub.name
                )
            except Exception:  # noqa: BLE001 - a reset must always complete
                pass
        with self._lock:
            self._serial = 0
            self.published = 0
            self.dropped = 0
            self._overhead_wall_s = 0.0
            self._overhead_cpu_s = 0.0


#: process-wide bus; the server's /watch endpoint subscribes here and the
#: driver's WatchSession tails it remotely
telemetry_bus = TelemetryBus()
