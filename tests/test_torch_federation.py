"""The port's fleet federation held to the JAX package's (after the
reference's ``tests/test_federation.py``).

Synthetic replicas (each with its own registry and history ring, a wall
clock that can be skewed, canned flight events) sit behind an offline
router of each package; a federation of that package scrapes them on fake
clocks. Every scenario runs through both packages and the observations
are compared:

- partial scrapes (a dead or unreachable replica: ``partial`` and the
  exact missing list), the shared-ring producer cursor, no window merged
  twice;
- merge semantics: counters sum, gauges stay keyed per replica, bucket
  vectors add, and the merged p50/p95/p99 equal ``Histogram
  .percentile_of`` over the concatenated vectors — and the reference's
  ``merge_series``/``merge_windows`` on the same seeded inputs, bit for
  bit;
- ``ClockOffsets`` (the exact skew at zero RTT, the minimum-RTT sample),
  the incident timeline's causal order under ±500 ms skew,
  ``incident_trace`` passing ``validate_chrome_trace``, ring dedup and
  the lookback window;
- the fleet SLOs on a fake clock: the outlier detector's flight event and
  burn, the availability page, the ``slo_burn`` sequence, router counters
  folded into windows;
- the bounded scrape tail's cursor-gap heal;
- push mode: the ``/watch/info`` negotiation, the poll-only fallback on a
  refusal with the exact scrape URLs, an unanswered probe retried,
  reconnect with resume cursors, bundles shipped off-host; over HTTP, a
  push channel to a port query server and a 404 peer kept poll-only;
- the watchdog progress source of the tick loop.

Exact equality: both packages compute the same arithmetic on the same
inputs; the only fields masked are the planes' own self-cost metrics
(``observability.*`` timers and the federation's overhead gauges), which
time real work.
"""

import json
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest

import janusgraph_tpu.observability as ref_obs
import janusgraph_tpu_torch.observability as port_obs
from janusgraph_tpu.observability import continuous as ref_continuous
from janusgraph_tpu.observability import federation as ref_federation
from janusgraph_tpu.observability import metrics_core as ref_metrics_core
from janusgraph_tpu.observability import timeline as ref_timeline
from janusgraph_tpu.observability import timeseries as ref_timeseries
from janusgraph_tpu.server import fleet as ref_fleet
from janusgraph_tpu_torch.observability import continuous, federation, metrics_core, timeline
from janusgraph_tpu_torch.observability import timeseries
from janusgraph_tpu_torch.server import fleet

REF = SimpleNamespace(name="ref", obs=ref_obs, fed=ref_federation, mc=ref_metrics_core,
                      ts=ref_timeseries, fleet=ref_fleet, timeline=ref_timeline,
                      continuous=ref_continuous)
PORT = SimpleNamespace(name="port", obs=port_obs, fed=federation, mc=metrics_core,
                       ts=timeseries, fleet=fleet, timeline=timeline, continuous=continuous)
BOTH = (REF, PORT)


@pytest.fixture(autouse=True)
def _reset():
    for P in BOTH:
        P.obs.flight_recorder.reset()
        P.obs.registry.reset()
    yield
    for P in BOTH:
        P.obs.flight_recorder.reset()


def _both(fn):
    return fn(REF), fn(PORT)


class _Replica:
    """One synthetic replica of package ``P``."""

    def __init__(self, P, name, skew_s=0.0):
        self.name = name
        self.skew_s = skew_s
        self.true_wall = 1_000_000.0
        self.mono = 50.0
        self.registry = P.mc.TelemetryRegistry()
        self.history = P.ts.MetricsHistory(
            registry=self.registry, interval_s=1.0, clock=lambda: self.mono,
            wall_clock=lambda: self.true_wall + self.skew_s)
        self.flight_events = []
        self.unreachable = False
        self.watch = False
        self.bundle = None
        self.fail_full = False

    def observe(self, name, ms_values):
        t = self.registry.timer(name)
        for ms in ms_values:
            t.update(int(ms * 1e6))

    def advance(self, s=1.0):
        self.true_wall += s
        self.mono += s

    def payload(self, path):
        if self.unreachable:
            raise ConnectionError(f"{self.name} unreachable")
        if path.startswith("/timeseries"):
            if self.fail_full and "window=" not in path:
                raise ConnectionError(f"{self.name} full scrape torn")
            last = int(path.split("window=")[1].split("&")[0]) if "window=" in path else 0
            payload = json.loads(json.dumps(self.history.scrape(last=last)))
            payload["replica"] = self.name
            return payload
        if path.startswith("/flight"):
            return {"events": [dict(e) for e in self.flight_events]}
        if path.startswith("/telemetry"):
            return {"metrics": self.registry.snapshot()}
        if path.startswith("/watch/info"):
            return {"watch": self.watch, "replica": self.name, "now": self.true_wall + self.skew_s,
                    "streams": ["flight", "window", "slo", "flame", "bundle"], "cursors": {}}
        if path.startswith("/debug/bundle"):
            return self.bundle
        raise AssertionError(f"unexpected path {path}")


def _fleet(P, replicas, dead=(), **fed_kw):
    by_port = {}
    router = P.fleet.FleetRouter(fetch=lambda url, timeout: {})
    for i, rep in enumerate(replicas):
        router.add_replica(rep.name, "127.0.0.1", 9300 + i)
        by_port[9300 + i] = rep
    for name in dead:
        router.mark_dead(name, reason="test")
    calls = []

    def fetch(url, timeout):
        calls.append(url)
        port, path = url.split("127.0.0.1:", 1)[1].split("/", 1)
        return by_port[int(port)].payload("/" + path)

    clock, wall = {"t": 10.0}, {"t": 2_000_000.0}
    fed_kw.setdefault("interval_s", 1.0)
    fed = P.fed.FleetFederation(router, fetch=fetch, clock=lambda: clock["t"],
                                wall_clock=lambda: wall["t"], **fed_kw)
    fed._test_calls, fed._test_clock, fed._test_wall = calls, clock, wall
    return router, fed


def _masked(window):
    """A fleet window without the planes' self-cost metrics."""
    w = json.loads(json.dumps(window, sort_keys=True))
    for section in ("series", "by_replica", "gauges", "counters"):
        for k in list(w.get(section) or {}):
            if k.startswith("observability.") or k.startswith("fleet.federation.overhead") or (
                    k.startswith("fleet.federation.scrape")):
                del w[section][k]
    return w


def _reps(P, *names, skews=None):
    return [_Replica(P, n, (skews or {}).get(n, 0.0)) for n in names]


# ------------------------------------------------------------ partial scrapes

def test_unreachable_replica_marks_window_partial():
    def run(P):
        reps = _reps(P, "r0", "r1", "r2")
        for rep in reps:
            rep.observe("server.request.wall", [2.0, 3.0])
            rep.history.sample()
        reps[1].unreachable = True
        _router, fed = _fleet(P, reps)
        w = fed.tick()
        view = fed.timeseries_view()
        return _masked(w), view["partial"], view["missing"]

    ref, port = _both(run)
    assert port == ref
    assert port[0]["partial"] is True and port[0]["missing"] == ["r1"]
    assert port[0]["replicas"] == ["r0", "r2"] and port[1:] == (True, ["r1"])


def test_dead_replica_is_missing_without_a_fetch():
    def run(P):
        reps = _reps(P, "r0", "r1")
        for rep in reps:
            rep.history.sample()
        _router, fed = _fleet(P, reps, dead=("r1",))
        w = fed.tick()
        return w["partial"], w["missing"], fed._test_calls

    ref, port = _both(run)
    assert port == ref
    assert port[:2] == (True, ["r1"]) and not any("9301" in u for u in port[2])


def test_full_scrape_is_not_partial():
    def run(P):
        reps = _reps(P, "r0", "r1")
        for rep in reps:
            rep.history.sample()
        w = _fleet(P, reps)[1].tick()
        return w["partial"], w["missing"]

    ref, port = _both(run)
    assert port == ref == (False, [])


def test_shared_producer_ring_counts_once():
    def run(P):
        reps = _reps(P, "r0", "r1")
        reps[0].registry.counter("tx.commit").inc(4)
        reps[0].history.sample()
        reps[1].payload = reps[0].payload
        w = _fleet(P, reps)[1].tick()
        return w["counters"]["tx.commit"], w["replicas"], w["partial"]

    ref, port = _both(run)
    assert port == ref == (4, ["r0", "r1"], False)


def test_scrape_cursor_never_remerges_a_window():
    def run(P):
        reps = _reps(P, "r0")
        reps[0].registry.counter("server.admission.admitted").inc(5)
        reps[0].history.sample()
        _router, fed = _fleet(P, reps)
        w1, w2 = fed.tick(), fed.tick()
        return w1["counters"].get("server.admission.admitted"), "server.admission.admitted" in w2["counters"]

    ref, port = _both(run)
    assert port == ref == (5, False)


# ------------------------------------------------------------ merge semantics

def test_counters_sum_and_gauges_stay_keyed():
    def run(P):
        reps = _reps(P, "r0", "r1")
        reps[0].registry.counter("server.admission.admitted").inc(7)
        reps[1].registry.counter("server.admission.admitted").inc(5)
        reps[0].registry.set_gauge("admission.limit", 8)
        reps[1].registry.set_gauge("admission.limit", 16)
        for rep in reps:
            rep.history.sample()
        w = _fleet(P, reps)[1].tick()
        return w["counters"]["server.admission.admitted"], w["gauges"]["admission.limit"]

    ref, port = _both(run)
    assert port == ref == (12, {"r0": 8, "r1": 16})


def test_fleet_percentiles_bitwise_equal_concatenated_vectors():
    def run(P):
        reps = _reps(P, "r0", "r1", "r2")
        reps[0].observe("server.request.wall", [1.0, 2.0, 4.0, 8.0, 100.0])
        reps[1].observe("server.request.wall", [0.5, 0.5, 3.0, 250.0])
        reps[2].observe("server.request.wall", [16.0] * 10)
        for rep in reps:
            rep.history.sample()
        merged = _fleet(P, reps)[1].tick()["series"]["server.request.wall"]
        per = [rep.history.windows()[-1]["series"]["server.request.wall"] for rep in reps]
        concat = [0] * max(len(e["buckets"]) for e in per)
        for e in per:
            for i, v in enumerate(e["buckets"]):
                concat[i] += v
        hi = max(e["max"] for e in per)
        assert merged["buckets"] == concat and sum(merged["buckets"]) == merged["count"]
        assert merged["count"] == sum(e["count"] for e in per)
        for q, key in ((0.50, "p50"), (0.95, "p95"), (0.99, "p99")):
            assert merged[key] == P.mc.Histogram.percentile_of(concat, q, hi)
        return merged

    ref, port = _both(run)
    assert port == ref


def _seeded_entries(rng, k):
    out = []
    for _ in range(k):
        width = int(rng.integers(1, 40))
        buckets = rng.integers(0, 50, width).tolist()
        out.append({"kind": "timer", "count": int(sum(buckets)), "sum": float(rng.random() * 1e4),
                    "max": float(rng.random() * 1e3), "buckets": buckets})
    return out


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_merge_series_and_windows_equal_the_reference(seed):
    rng = np.random.default_rng(seed)
    entries = _seeded_entries(rng, int(rng.integers(1, 6)))
    assert federation.merge_series(entries) == ref_federation.merge_series(entries)
    windows = {}
    for r in range(int(rng.integers(1, 4))):
        windows[f"r{r}"] = [{
            "seq": s + 1,
            "counters": {f"c{j}": int(rng.integers(0, 9)) for j in range(3)},
            "gauges": {"g": float(rng.random())},
            "series": {"server.request.wall": e},
        } for s, e in enumerate(_seeded_entries(rng, int(rng.integers(1, 3))))]
    assert federation.merge_windows(windows) == ref_federation.merge_windows(windows)


def test_merge_series_empty_and_sparse():
    for P in BOTH:
        assert P.fed.merge_series([]) is None
        assert P.fed.merge_series([{"count": 0, "buckets": []}]) is None


def test_metrics_view_merges_current_snapshots():
    def run(P):
        reps = _reps(P, "r0", "r1")
        reps[0].registry.counter("tx.commit").inc(3)
        reps[1].registry.counter("tx.commit").inc(4)
        reps[0].registry.set_gauge("admission.limit", 8)
        reps[1].observe("server.request.wall", [5.0])
        view = _fleet(P, reps)[1].metrics_view()
        m = view["metrics"]
        return (view["partial"], m["tx.commit"]["count"], m["admission.limit"]["value"],
                sorted(m["server.request.wall"]["by_replica"]))

    ref, port = _both(run)
    assert port == ref == (False, 7, {"r0": 8}, ["r1"])


# ---------------------------------------------------- clock offsets and skew

def test_offset_estimate_equals_injected_skew_at_zero_rtt():
    def run(P):
        reps = _reps(P, "r0", "r1", skews={"r0": 0.5, "r1": -0.5})
        for rep in reps:
            rep.history.sample()
        _router, fed = _fleet(P, reps)
        fed.tick()
        return fed.offsets.snapshot()

    ref, port = _both(run)
    assert port == ref
    assert abs(port["r0"]["offset_s"] - port["r1"]["offset_s"] - 1.0) < 1e-6


def test_min_rtt_sample_wins():
    def run(P):
        co = P.fed.ClockOffsets()
        co.observe("r", send_wall=100.0, rtt_s=0.2, peer_wall=100.9)
        co.observe("r", send_wall=200.0, rtt_s=0.01, peer_wall=200.505)
        co.observe("r", send_wall=300.0, rtt_s=0.5, peer_wall=301.0)
        return co.snapshot()["r"], co.correct("r", 500.0), co.offset("nobody")

    ref, port = _both(run)
    assert port == ref
    assert port[0]["rtt_s"] == 0.01 and port[0]["samples"] == 3
    assert abs(port[0]["offset_s"] - 0.5) < 1e-9


def test_incident_orders_two_replica_sequence_under_skew():
    def run(P):
        reps = _reps(P, "r0", "r1", skews={"r0": 0.5, "r1": -0.5})
        for rep in reps:
            rep.history.sample()
        base = reps[0].true_wall
        reps[0].flight_events = [
            {"seq": 1, "ts": base + 100.5, "mono": 1.0, "category": "fault",
             "kind": "replica_kill", "replica": "r0"},
            {"seq": 2, "ts": base + 101.1, "mono": 1.6, "category": "fleet",
             "action": "warmup", "replica": "r0"},
        ]
        reps[1].flight_events = [
            {"seq": 1, "ts": base + 99.7, "mono": 2.2, "category": "fleet",
             "action": "dead", "replica": "r1"},
            {"seq": 2, "ts": base + 99.9, "mono": 2.4, "category": "fleet",
             "action": "rejoin", "replica": "r1"},
        ]
        _router, fed = _fleet(P, reps)
        fed.tick()
        P.obs.flight_recorder.reset()
        report = fed.incident(window_s=0)
        P.timeline.validate_chrome_trace(report["trace"])
        assert abs(report["events"][0]["ts_corrected"] - (fed._test_wall["t"] + 100.0)) < 1e-6
        return report

    ref, port = _both(run)
    assert port == ref
    assert [e["lane"] for e in port["events"]] == ["r0", "r1", "r1", "r0"]
    assert [p["phase"] for p in port["phases"]] == ["kill", "mark_dead", "re_pin", "warm_up"]
    ts = [e["ts_corrected"] for e in port["events"]]
    assert ts == sorted(ts)
    assert set(port["trace"]["otherData"]["lanes"]) >= {"r0", "r1"}


def test_incident_dedups_shared_ring_events():
    def run(P):
        shared = [{"seq": 7, "ts": 100.0, "mono": 1.0, "category": "fault",
                   "kind": "replica_kill", "replica": "r0"}]
        reps = _reps(P, "r0", "r1")
        reps[0].flight_events = reps[1].flight_events = shared
        for rep in reps:
            rep.history.sample()
        _router, fed = _fleet(P, reps)
        fed.tick()
        P.obs.flight_recorder.reset()
        return [e for e in fed.incident(window_s=0)["events"] if e.get("kind") == "replica_kill"]

    ref, port = _both(run)
    assert port == ref and len(port) == 1


def test_incident_partial_when_a_ring_is_unreachable():
    def run(P):
        reps = _reps(P, "r0", "r1")
        for rep in reps:
            rep.history.sample()
        _router, fed = _fleet(P, reps)
        fed.tick()
        reps[1].unreachable = True
        report = fed.incident(window_s=0)
        return report["partial"], report["missing"]

    ref, port = _both(run)
    assert port == ref == (True, ["r1"])


def test_window_bounds_the_lookback():
    events = [
        {"seq": 1, "ts": 10.0, "category": "fault", "source": "r0", "replica": "r0"},
        {"seq": 2, "ts": 95.0, "category": "fault", "source": "r0", "replica": "r0"},
    ]
    ref, port = _both(lambda P: P.fed.merge_incident_events(
        [dict(e) for e in events], P.fed.ClockOffsets(), now_wall=100.0, window_s=30.0))
    assert port == ref and [e["ts"] for e in port] == [95.0]


def test_incident_phases_and_trace_equal_the_reference():
    """A failover narrative through the follower path (kill, dead, rejoin,
    warm-up, promote, caught up): the same phases and the same Chrome
    trace from both packages' helpers."""
    merged = [
        {"seq": i, "ts": 50.0 + i, "ts_corrected": 50.0 + i, "lane": lane, "category": cat, **kw}
        for i, (lane, cat, kw) in enumerate([
            ("r0", "fault", {"kind": "replica_kill"}),
            ("r1", "fleet", {"action": "dead"}),
            ("r1", "fleet", {"action": "rejoin"}),
            ("r2", "fleet", {"action": "warmup"}),
            ("r2", "follower_promote", {}),
            ("r2", "cdc_replay", {"action": "caught_up"}),
        ])
    ]
    ref, port = _both(lambda P: (P.fed.incident_phases([dict(e) for e in merged]),
                                 P.fed.incident_trace([dict(e) for e in merged])))
    assert port == ref
    assert [p["phase"] for p in port[0]] == ["kill", "mark_dead", "re_pin", "warm_up", "promote",
                                             "caught_up"]
    timeline.validate_chrome_trace(port[1])


# -------------------------------------------------------------- fleet SLOs

def _outlier_fleet(P):
    reps = _reps(P, "r0", "r1", "r2")
    _router, fed = _fleet(P, reps, outlier_factor=2.0, outlier_min_count=10,
                          slo_specs=P.fed.fleet_default_specs(fast_windows=1, slow_windows=1))
    return reps, fed


def _load(reps, sick=None):
    for rep in reps:
        rep.observe("server.request.wall", [400.0 if rep.name == sick else 2.0] * 25)
        rep.registry.counter("server.admission.admitted").inc(25)
        rep.advance()
        rep.history.sample()


def _clockless(events):
    return [{k: v for k, v in e.items() if k not in ("ts", "mono", "seq")} for e in events]


def test_outlier_replica_raises_flight_event_and_burn():
    def run(P):
        reps, fed = _outlier_fleet(P)
        _load(reps, sick="r1")
        w = fed.tick()
        alerts = [a for a in fed.slo.snapshot()["alerts"] if a["name"] == "fleet_latency_outlier"]
        return (w["outliers"], _clockless(P.obs.flight_recorder.events("replica_outlier")),
                w["counters"].get("fleet.federation.outlier_windows"), alerts[0]["severity"])

    ref, port = _both(run)
    assert port == ref
    outliers, events, burned, severity = port
    assert [o["replica"] for o in outliers] == ["r1"]
    assert events[-1]["replica"] == "r1" and events[-1]["threshold_factor"] == 2.0
    assert burned == 1 and severity in ("ticket", "page")


def test_healthy_fleet_raises_no_outlier():
    def run(P):
        reps, fed = _outlier_fleet(P)
        _load(reps)
        return fed.tick()["outliers"], P.obs.flight_recorder.events("replica_outlier")

    ref, port = _both(run)
    assert port == ref == ([], [])


def test_below_min_count_replicas_are_excluded():
    def run(P):
        reps, fed = _outlier_fleet(P)
        reps[0].observe("server.request.wall", [2.0] * 25)
        reps[1].observe("server.request.wall", [400.0] * 3)
        reps[2].observe("server.request.wall", [2.0] * 25)
        for rep in reps:
            rep.history.sample()
        return fed.tick()["outliers"]

    ref, port = _both(run)
    assert port == ref == []


def test_fleet_availability_spec_reads_summed_admission():
    def run(P):
        reps = _reps(P, "r0", "r1")
        _router, fed = _fleet(P, reps, slo_specs=P.fed.fleet_default_specs(fast_windows=1, slow_windows=1))
        for _ in range(3):
            for rep in reps:
                rep.registry.counter("server.admission.admitted").inc(40)
                rep.registry.counter("server.admission.shed").inc(60)
                rep.advance()
                rep.history.sample()
            fed.tick()
        return [a for a in fed.slo.snapshot()["alerts"] if a["name"] == "fleet_availability"]

    ref, port = _both(run)
    assert port == ref and port[0]["severity"] == "page"


def test_slo_sequence_deterministic_on_fake_clock():
    def run(P):
        P.obs.flight_recorder.reset()
        reps, fed = _outlier_fleet(P)
        for round_i in range(4):
            _load(reps, sick="r1" if round_i >= 2 else None)
            fed.tick()
        return json.dumps(_clockless(P.obs.flight_recorder.events("slo_burn")), sort_keys=True)

    first = run(PORT)
    assert first != "[]", "the storm must produce slo_burn transitions"
    assert run(PORT) == first == run(REF)


def test_router_counters_fold_into_fleet_windows():
    def run(P):
        reps = _reps(P, "r0")
        reps[0].history.sample()
        _router, fed = _fleet(P, reps)
        P.obs.registry.counter("fleet.router.routed").inc(9)
        w1, w2 = fed.tick(), fed.tick()
        return w1["counters"].get("fleet.router.routed", 0), "fleet.router.routed" in w2["counters"]

    ref, port = _both(run)
    assert port == ref and port[0] >= 9 and port[1] is False


def test_history_scrape_keeps_bucket_vectors():
    def run(P):
        rep = _Replica(P, "r3")
        rep.observe("server.request.wall", [4.0, 8.0])
        rep.history.sample()
        payload = rep.history.scrape()
        w = payload["windows"][-1]
        assert payload["now"] == pytest.approx(rep.true_wall) and payload["last_seq"] == w["seq"]
        return w["series"]["server.request.wall"]["buckets"]

    ref, port = _both(run)
    assert port == ref and sum(port) == 2


def test_overhead_gauge_and_timer_account_each_tick():
    def run(P):
        reps = _reps(P, "r0")
        reps[0].history.sample()
        _router, fed = _fleet(P, reps)
        before = P.obs.registry.get_count("fleet.federation.ticks")
        fed.tick()
        _c, _t, _h, gauges = P.obs.registry.metric_objects()
        return P.obs.registry.get_count("fleet.federation.ticks") - before, (
            "fleet.federation.overhead_ms" in gauges)

    ref, port = _both(run)
    assert port == ref == (1, True)


# ----------------------------------------------------------- cursor-gap heal

def _burst(rep, n, counter="app.burst"):
    for _ in range(n):
        rep.registry.counter(counter).inc()
        rep.advance()
        rep.history.sample()


def test_burst_past_bounded_tail_heals_with_one_full_refetch():
    def run(P):
        rep = _Replica(P, "r0")
        rep.history.sample()
        _router, fed = _fleet(P, [rep], scrape_window=2)
        fed.tick()
        calls0 = len(fed._test_calls)
        _burst(rep, 6)
        fed.tick()
        tick_calls = fed._test_calls[calls0:]
        gaps = P.obs.registry.get_count("fleet.federation.cursor_gaps")
        heals = P.obs.registry.get_count("fleet.federation.cursor_heals")
        fed.tick()
        merged = sum(w["counters"].get("app.burst", 0) for w in fed.history.windows())
        return tick_calls, gaps, heals, P.obs.registry.get_count("fleet.federation.cursor_gaps"), merged

    ref, port = _both(run)
    assert port == ref
    tick_calls, gaps, heals, gaps_after, merged = port
    assert len(tick_calls) == 2 and "window=2" in tick_calls[0]
    assert tick_calls[1].endswith("/timeseries?raw=1")
    assert (gaps, heals, gaps_after, merged) == (1, 1, 1, 6)


def test_failed_heal_is_counted_and_the_tail_still_merges():
    def run(P):
        rep = _Replica(P, "r0")
        rep.history.sample()
        _router, fed = _fleet(P, [rep], scrape_window=2)
        fed.tick()
        rep.fail_full = True
        _burst(rep, 6)
        fed.tick()
        merged = sum(w["counters"].get("app.burst", 0) for w in fed.history.windows())
        return (P.obs.registry.get_count("fleet.federation.cursor_heal_failures"), merged,
                fed._last_seq[rep.name] == rep.history.last_seq())

    ref, port = _both(run)
    assert port == ref == (1, 2, True)


# ------------------------------------------------------------------ push mode

class _FakeWatchSession:
    def __init__(self, url, subscribe):
        self.url, self.subscribe = url, subscribe
        self.frames, self._lock = [], threading.Lock()
        self.closed = self.fail = False

    def feed(self, *frames):
        with self._lock:
            self.frames.extend(frames)

    def recv(self, timeout=1.0):
        if self.fail:
            raise ConnectionError("replica killed mid-stream")
        with self._lock:
            if self.frames:
                return self.frames.pop(0)
        time.sleep(0.002)
        return None

    def close(self):
        self.closed = True


def _push_fleet(P, replicas, **fed_kw):
    sessions = []

    def factory(url, subscribe, timeout_s):
        sessions.append(_FakeWatchSession(url, subscribe))
        return sessions[-1]

    router, fed = _fleet(P, replicas, push_enabled=True, watch_factory=factory, **fed_kw)
    return router, fed, sessions


def _wait(pred, timeout=10.0):
    deadline = time.monotonic() + timeout
    while not pred():
        assert time.monotonic() < deadline, "condition never held"
        time.sleep(0.005)


def _window_frames(rep, since=0):
    return [{"type": "event", "stream": "window", "seq": w["seq"], "data": w}
            for w in json.loads(json.dumps(rep.history.windows())) if w["seq"] > since]


def _stop_channels(fed):
    for ch in list(getattr(fed, "_push", {}).values()):
        ch.stop()


def test_capable_replica_negotiates_and_windows_merge_identically():
    def run(P):
        def twin():
            rep = _Replica(P, "r0")
            rep.observe("server.request.wall", [4.0, 8.0, 16.0])
            rep.registry.counter("app.ops").inc(7)
            rep.history.sample()
            return rep

        push_rep, poll_rep = twin(), twin()
        push_rep.watch = True
        _r1, fed_push, sessions = _push_fleet(P, [push_rep])
        _r2, fed_poll = _fleet(P, [poll_rep])
        try:
            w_poll = fed_poll.tick()
            fed_push.tick()
            assert sessions[0].subscribe["cursors"] == {"window": 0}
            assert fed_push.push_status()["channels"]["r0"]["connected"]
            assert [c for c in fed_push._test_calls if "/timeseries" in c] == []
            sessions[0].feed(*_window_frames(push_rep))
            channel = fed_push._push["r0"]
            _wait(lambda: channel.state()["windows_seen"] == 1)
            w_push = fed_push.tick()
            assert [c for c in fed_push._test_calls if "/timeseries" in c] == []
            a, b = _masked(w_push), _masked(w_poll)
            assert (a["series"], a["by_replica"]) == (b["series"], b["by_replica"])
            assert w_push["counters"]["app.ops"] == w_poll["counters"]["app.ops"]
            return len(sessions), P.obs.registry.get_count("fleet.federation.push_negotiated"), a["series"]
        finally:
            _stop_channels(fed_push)

    ref, port = _both(run)
    assert port == ref and port[:2] == (1, 1)


def test_poll_only_peer_keeps_the_exact_scrape_path():
    def run(P):
        def twin():
            rep = _Replica(P, "r0")
            rep.observe("server.request.wall", [3.0, 9.0])
            rep.history.sample()
            return rep

        old_rep, plain_rep = twin(), twin()
        _r1, fed_push, sessions = _push_fleet(P, [old_rep])
        _r2, fed_poll = _fleet(P, [plain_rep])
        pairs = [(fed_push.tick(), fed_poll.tick())]
        for rep in (old_rep, plain_rep):
            rep.observe("server.request.wall", [5.0])
            rep.advance()
            rep.history.sample()
        pairs.append((fed_push.tick(), fed_poll.tick()))
        assert sessions == []
        assert fed_push.push_status()["poll_only"] == ["r0"]
        push_urls = [c for c in fed_push._test_calls if "/watch/info" not in c]
        assert push_urls == fed_poll._test_calls
        assert sum("/watch/info" in c for c in fed_push._test_calls) == 1
        for wp, wq in pairs:
            assert _masked(wp)["series"] == _masked(wq)["series"]
        return P.obs.registry.get_count("fleet.federation.push_refused"), push_urls

    ref, port = _both(run)
    assert port == ref and port[0] == 1


def test_unanswered_probe_is_retried_not_refused():
    def run(P):
        rep = _Replica(P, "r0")
        rep.watch = True
        rep.history.sample()
        _router, fed, sessions = _push_fleet(P, [rep])
        try:
            rep.unreachable = True
            fed.tick()
            first = (fed.push_status()["poll_only"], len(sessions),
                     P.obs.registry.get_count("fleet.federation.push_connect_failures"))
            rep.unreachable = False
            fed.tick()
            return first, len(sessions), fed.push_status()["channels"]["r0"]["connected"]
        finally:
            _stop_channels(fed)

    ref, port = _both(run)
    assert port == ref == (([], 0, 1), 1, True)


def test_reconnect_resumes_from_cursors_zero_dup_zero_lost():
    def run(P):
        rep = _Replica(P, "r0")
        rep.watch = True
        rep.registry.counter("app.ops").inc()
        rep.history.sample()
        _router, fed, sessions = _push_fleet(P, [rep])
        try:
            fed.tick()
            sessions[0].feed(*_window_frames(rep))
            sessions[0].feed({"type": "event", "stream": "flight", "seq": 41,
                              "data": {"seq": 41, "replica": "r0", "ts": rep.true_wall,
                                       "category": "compaction", "action": "start"}})
            channel = fed._push["r0"]
            _wait(lambda: channel.state()["windows_seen"] == 1)
            _wait(lambda: channel.state()["events_seen"] == 1)
            fed.tick()
            sessions[0].fail = True
            _wait(lambda: not channel.connected)
            for _ in range(3):
                rep.registry.counter("app.ops").inc()
                rep.advance()
                rep.history.sample()
            fed.tick()
            resumed = sessions[1].subscribe["cursors"]
            sessions[1].feed(*_window_frames(rep, since=1))
            channel2 = fed._push["r0"]
            _wait(lambda: channel2.state()["windows_seen"] == 3)
            fed.tick()
            merged = sum(w["counters"].get("app.ops", 0) for w in fed.history.windows())
            actions = [e["action"] for e in P.obs.flight_recorder.snapshot()["events"]
                       if e["category"] == "fleet" and e.get("action") in ("push_on", "push_lost")
                       and e.get("replica") == "r0"]
            return (len(sessions), resumed, merged, actions[-3:],
                    P.obs.registry.get_count("fleet.federation.push_lost"))
        finally:
            _stop_channels(fed)

    ref, port = _both(run)
    assert port == ref == (2, {"window": 1, "flight": 41}, 4, ["push_on", "push_lost", "push_on"], 1)


def test_bundle_announcement_ships_off_host():
    def run(P):
        rep = _Replica(P, "r0")
        rep.watch = True
        rep.bundle = {"reason": "stall", "ts": 1.0, "path": "/tmp/b1.json", "flight": [],
                      "timeseries": []}
        rep.history.sample()
        _router, fed, sessions = _push_fleet(P, [rep])
        reg = P.obs.registry
        try:
            fed.tick()

            def announce(seq):
                sessions[-1].feed({"type": "event", "stream": "flight", "seq": seq,
                                   "data": {"seq": seq, "replica": "r0", "ts": rep.true_wall,
                                            "category": "bundle", "reason": "stall",
                                            "path": "/tmp/b1.json"}})

            announce(1)
            _wait(lambda: fed.bundles.get("r0") is not None)
            got = fed.bundles.get("r0")
            announce(2)
            _wait(lambda: reg.get_count("fleet.federation.bundle_rate_limited") >= 1)
            fetched = fed.bundles.status()["fetched"]
            fed._test_clock["t"] += 60.0
            rep.bundle = {"status": 404, "error": "no bundle"}
            announce(3)
            _wait(lambda: reg.get_count("fleet.federation.bundle_fetch_failures") == 1)
            return (got["bundle"]["reason"], got["path"], reg.get_count("fleet.federation.bundles_shipped"),
                    fetched, fed.bundles.status()["fetched"], fed.bundles.get("r0")["bundle"]["reason"])
        finally:
            _stop_channels(fed)

    ref, port = _both(run)
    assert port == ref == ("stall", "/tmp/b1.json", 1, 1, 1, "stall")


# ------------------------------------------------------------------- watchdog

def test_wedged_federation_tick_fires_stall(tmp_path):
    def run(P):
        clk = {"t": 0.0}
        wd = P.continuous.StallWatchdog(clock=lambda: clk["t"])
        wd.configure(stall_s=5.0)
        P.continuous.bundle_writer.configure(directory=str(tmp_path / P.name), min_interval_s=0.0)
        rep = _Replica(P, "r0")
        rep.history.sample()
        _router, fed = _fleet(P, [rep], watchdog=wd)
        fed.start(interval_s=3600.0)
        checks = []
        try:
            fed.tick()
            checks.append(wd.check())
            clk["t"] += 3.0
            fed.tick()
            checks.append(wd.check())
            clk["t"] += 2.0
            checks.append(wd.check())
            clk["t"] += 4.0
            fired = wd.check()
            clk["t"] += 10.0
            checks.append(wd.check())
        finally:
            fed.stop()
            P.continuous.bundle_writer.configure(directory="")
        return ([c == [] for c in checks], [e["category"] for e in fired], fired[0]["source"],
                fired[0]["stuck_s"] >= 5.0, "fleet.federation.tick" in wd._progress)

    ref, port = _both(run)
    assert port == ref == ([True] * 4, ["stall"], "fleet.federation.tick", True, False)


def test_push_mode_negotiates_with_a_real_server_and_a_404_peer_stays_poll_only():
    """Over HTTP: a port query server answers ``/watch/info`` with the
    capability, so each package's federation opens a push channel (the
    driver's ``WatchSession``) to it; a fleet frontend standing in as an
    older peer answers that path 404, so it is poll-only (and, serving no
    ``/timeseries`` either, missing from the window)."""
    from janusgraph_tpu_torch.core.graph import open_graph
    from janusgraph_tpu_torch.server import JanusGraphManager, JanusGraphServer

    g = open_graph({"computer.executor": "cpu"})
    m = JanusGraphManager()
    m.put_graph("graph", g)
    server = JanusGraphServer(manager=m, history_enabled=False, slo_enabled=False,
                              replica_name="r0").start()
    old = fleet.FleetFrontend(fleet.FleetRouter(fetch=lambda u, t: {})).start()
    try:
        got = {}
        for P in BOTH:
            router = P.fleet.FleetRouter(fetch=lambda u, t: {})
            router.add_replica("r0", "127.0.0.1", server.port)
            router.add_replica("old", "127.0.0.1", old.port)
            fed = P.fed.FleetFederation(router, timeout_s=10.0, push_enabled=True)
            try:
                window = fed.tick()
                status = fed.push_status()
                got[P.name] = (sorted(status["channels"]), status["poll_only"],
                               status["channels"]["r0"]["connected"], window["missing"])
            finally:
                fed.stop()
        assert got["port"] == got["ref"] == (["r0"], ["old"], True, ["old"])
    finally:
        old.stop()
        server.stop()
        g.close()
