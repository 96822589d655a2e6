"""The port's metric history, SLO engine and telemetry stream held to the
JAX package's (after the reference's ``tests/test_observability_plane.py``
and ``tests/test_stream.py``).

- History: the same seeded traffic (counters, timers, gauges) recorded
  into each package's own registry and sampled on fake clocks gives equal
  ``MetricsHistory`` rings, window for window, once the sampler's own
  overhead gauge and timer (host walls) are dropped; ``query``,
  ``series`` and ``bucket_upper_index`` agree.
- SLOs: the stock specs (``default_specs``) and hand-built availability,
  latency, priced-latency and freshness specs over the same windows give
  equal ``SLOEngine.snapshot()`` verdicts (severity, fast and slow burn,
  ``paging``, transitions) after every window; a seeded latency storm
  drawn from the fault plan's pure decisions gives the same ``slo_burn``
  flight events (clock fields masked). A page-rate burn turns
  ``healthz_snapshot()`` degraded in both and dumps the flight ring once,
  on the edge.
- The telemetry stream over fake sources: subscribe, the same seeded
  publish burst into bounded queues, drain and unsubscribe give equal
  envelopes, drop counts, cursors and bus status in both packages; the
  port server's ``/watch/info`` and a ``/watch`` WebSocket tail (the
  driver's ``WatchSession``) answer as the reference's.

Exact equality: both packages compute the same arithmetic on the same
floats. The process-wide singletons a test touches (the registries, the
flight recorders, the SLO engines) are reset around it.
"""

import json

import numpy as np
import pytest

from janusgraph_tpu.observability import flight_recorder as ref_flight
from janusgraph_tpu.observability import metrics_core as ref_metrics_core
from janusgraph_tpu.observability import profiler as ref_profiler
from janusgraph_tpu.observability import registry as ref_registry
from janusgraph_tpu.observability import slo as ref_slo
from janusgraph_tpu.observability import slo_engine as ref_slo_engine
from janusgraph_tpu.observability import stream as ref_stream
from janusgraph_tpu.observability import timeseries as ref_timeseries
from janusgraph_tpu.server import server as ref_server_mod
from janusgraph_tpu.storage.faults import FaultPlan as RefFaultPlan
from janusgraph_tpu_torch.observability import flight_recorder, history, metrics_core
from janusgraph_tpu_torch.observability import profiler, registry, slo, slo_engine, stream
from janusgraph_tpu_torch.observability import telemetry_bus, timeseries
from janusgraph_tpu_torch.server import server as server_mod
from janusgraph_tpu_torch.storage.faults import FaultPlan

PKGS = {
    "ref": dict(mc=ref_metrics_core, ts=ref_timeseries, slo=ref_slo, prof=ref_profiler,
                flight=ref_flight, registry=ref_registry, engine=ref_slo_engine,
                server=ref_server_mod, plan=RefFaultPlan, stream=ref_stream),
    "port": dict(mc=metrics_core, ts=timeseries, slo=slo, prof=profiler, flight=flight_recorder,
                 registry=registry, engine=slo_engine, server=server_mod, plan=FaultPlan,
                 stream=stream),
}
OVERHEAD = ("observability.history.overhead_ms", "observability.history.sample")


@pytest.fixture(autouse=True)
def _reset():
    # the registries too, as the reference's suite does: a breaker another
    # test file left open in this process would read as degraded
    for p in PKGS.values():
        p["flight"].reset()
        p["registry"].reset()
    yield
    for p in PKGS.values():
        p["flight"].reset()
        p["engine"].reset()
        p["registry"].reset()


def _fake_clock(start):
    state = {"t": start}

    def clock():
        state["t"] += 1.0
        return state["t"]

    return clock


def _history(p, reg, capacity=64):
    return p["ts"].MetricsHistory(reg, capacity=capacity, interval_s=1.0,
                                  clock=_fake_clock(1000.0), wall_clock=_fake_clock(5000.0))


def _masked(window):
    w = json.loads(json.dumps(window))
    for section in ("counters", "series", "gauges"):
        for name in OVERHEAD:
            w[section].pop(name, None)
    return w


def _traffic(reg, rng, window):
    """One window of seeded traffic: admissions and sheds, request walls
    (a storm in windows 6-9), a staleness gauge, a histogram."""
    storm = 6 <= window < 10
    admitted = int(rng.integers(50, 100))
    reg.counter("server.admission.admitted").inc(admitted)
    shed = int(rng.integers(0, 40 if storm else 2))
    if shed:
        reg.counter("server.admission.shed").inc(shed)
    t = reg.timer("server.request.wall")
    for _ in range(admitted):
        ms = float(rng.gamma(2.0, 80.0 if storm else 5.0))
        t.update(int(ms * 1e6))
    dt = reg.timer("server.request.digest.cafe")
    for _ in range(int(rng.integers(5, 20))):
        dt.update(int(float(rng.gamma(2.0, 30.0 if storm else 3.0)) * 1e6))
    reg.set_gauge("olap.spillover.staleness", float(rng.integers(0, 5000 if storm else 50)))
    reg.histogram("x.sizes").observe(float(rng.integers(1, 1 << 20)))


def _run(name, seed=5, windows=16):
    """The seeded windows through one package's history and an engine with
    the stock specs and a priced-latency spec; the snapshots after each
    window."""
    p = PKGS[name]
    reg = p["mc"].TelemetryRegistry()
    h = _history(p, reg)
    book = p["prof"].DigestTable(capacity=8)
    book.observe("cafe", "server>g.V().count()", 12.0)
    specs = p["slo"].default_specs(fast_windows=2, slow_windows=4) + [
        p["slo"].SLOSpec(name="priced", kind="latency", objective=0.9, metric="",
                         threshold_ms=10.0, price_factor=4.0, fast_windows=1,
                         slow_windows=2, page_burn=5.0, ticket_burn=2.0),
        p["slo"].SLOSpec(name="sizes", kind="latency", objective=0.5, metric="x.sizes",
                         threshold_ms=1000.0, fast_windows=1, slow_windows=1),
    ]
    eng = p["slo"].SLOEngine(h, specs, price_book_fn=lambda: book)
    eng.install()
    rng = np.random.default_rng(seed)
    snaps = []
    try:
        for w in range(windows):
            _traffic(reg, rng, w)
            h.sample()
            snaps.append(eng.snapshot())
    finally:
        eng.uninstall()
    return h, snaps


@pytest.mark.parametrize("seed", [5, 17])
def test_history_rings_equal(seed):
    (rh, _), (ph, _) = _run("ref", seed), _run("port", seed)
    assert [_masked(w) for w in ph.windows()] == [_masked(w) for w in rh.windows()]
    for name in ("server.request.wall", "server.admission.shed", "olap.spillover.staleness"):
        assert ph.series(name) == rh.series(name)
        assert ph.query(name=name, window=4)["series"] == rh.query(name=name, window=4)["series"]
    assert ph.last_seq() == rh.last_seq() == 16


def test_bucket_upper_index_equal():
    for ms in (0.001, 0.5, 1.0, 10.0, 250.0, 1e4, 1e7):
        assert timeseries.bucket_upper_index(ms) == ref_timeseries.bucket_upper_index(ms)


@pytest.mark.parametrize("seed", [5, 17])
def test_slo_verdicts_equal_after_every_window(seed):
    (_rh, rsnaps), (_ph, psnaps) = _run("ref", seed), _run("port", seed)
    assert psnaps == rsnaps
    severities = {a["severity"] for s in psnaps for a in s["alerts"]}
    assert {"ok", "ticket", "page"} <= severities, severities
    assert any(s["paging"] for s in psnaps)


def test_default_specs_equal():
    for kw in ({}, {"latency_threshold_ms": 50.0, "page_burn": 10.0, "fast_windows": 3}):
        want = [vars(s) for s in ref_slo.default_specs(**kw)]
        assert [vars(s) for s in slo.default_specs(**kw)] == want


def _storm(name, seed):
    p = PKGS[name]
    reg = p["mc"].TelemetryRegistry()
    h = _history(p, reg)
    spec = p["slo"].SLOSpec(name="latency", kind="latency", objective=0.9,
                            metric="server.request.wall", threshold_ms=50.0,
                            fast_windows=2, slow_windows=4, page_burn=3.0,
                            ticket_burn=1.5, clear_windows=2)
    eng = p["slo"].SLOEngine(h, [spec])
    eng.install()
    plan = p["plan"](seed=seed, latency_ms=200.0, latency_rate=0.7)
    t = reg.timer("server.request.wall")
    op, severities = 0, []
    try:
        for window in range(10):
            for _ in range(25):
                spiked = window < 6 and plan._chance("latency", op, plan.latency_rate)
                t.update(int((200.0 if spiked else 2.0) * 1e6))
                op += 1
            h.sample()
            severities.append(eng.snapshot()["worst"])
    finally:
        eng.uninstall()
    events = [{k: v for k, v in e.items() if k not in ("ts", "mono", "seq")}
              for e in p["flight"].events("slo_burn")]
    return events, severities


@pytest.mark.parametrize("seed", [1234, 99])
def test_latency_storm_flight_events_equal(seed):
    want, got = _storm("ref", seed), _storm("port", seed)
    assert got == want
    assert "page" in got[1] and any(e["direction"] == "exit" for e in got[0])


@pytest.mark.parametrize("name", ["ref", "port"])
def test_page_burn_degrades_healthz_and_dumps_flight_once(name, tmp_path):
    p = PKGS[name]
    eng, srv = p["engine"], p["server"]
    p["flight"].configure(dump_dir=str(tmp_path))
    old = (eng.history, eng.specs, dict(eng._states))
    reg = p["mc"].TelemetryRegistry()
    h = _history(p, reg)
    eng.history = h
    eng.specs = [p["slo"].SLOSpec(name="availability", kind="availability", objective=0.99,
                                  good_counter="good", bad_counter="bad", fast_windows=1,
                                  slow_windows=1, page_burn=10.0, ticket_burn=3.0,
                                  clear_windows=2)]
    eng.reset()
    try:
        with srv._HEALTH_LOCK:
            srv._HEALTH_STATE["status"] = None
        assert srv.healthz_snapshot()["status"] == "ok"
        reg.counter("good").inc(10)
        reg.counter("bad").inc(90)
        h.sample()
        eng.evaluate()
        dumps = p["registry"].get_count("flight.dumps")
        hz = srv.healthz_snapshot()
        assert hz["status"] == "degraded" and hz["slo"]["paging"] == ["availability"]
        dumped = json.load(open(p["flight"].last_dump_path))
        assert any(e["category"] == "slo_burn" and e["severity"] == "page"
                   for e in dumped["events"])
        assert p["registry"].get_count("flight.dumps") == dumps + 1
        srv.healthz_snapshot()  # staying degraded: no second dump
        assert p["registry"].get_count("flight.dumps") == dumps + 1
        health = [e for e in p["flight"].events("health")]
        assert len(health) == 1 and "availability" in health[0]["slo_paging"]
    finally:
        eng.history, eng.specs, eng._states = old
        with srv._HEALTH_LOCK:
            srv._HEALTH_STATE["status"] = None
        p["flight"].configure(dump_dir="")


# -------------------------------------------------------- the telemetry bus
class _Recorder:
    def __init__(self):
        self._listeners, self._events, self.last_seq = [], [], 0

    def add_listener(self, fn):
        if fn not in self._listeners:
            self._listeners.append(fn)

    def remove_listener(self, fn):
        if fn in self._listeners:
            self._listeners.remove(fn)

    def events(self):
        return [dict(e) for e in self._events]

    def record(self, category, **fields):
        self.last_seq += 1
        ev = {"seq": self.last_seq, "ts": float(self.last_seq), "category": category, **fields}
        self._events.append(ev)
        for fn in list(self._listeners):
            fn(ev)


class _History:
    def __init__(self):
        self._listeners, self._windows = [], []

    add_listener, remove_listener = _Recorder.add_listener, _Recorder.remove_listener

    def last_seq(self):
        return self._windows[-1]["seq"] if self._windows else 0

    def windows(self, last=0):
        return [dict(w) for w in self._windows]

    def seal(self, counters):
        w = {"seq": len(self._windows) + 1, "ts": 0.0, "counters": counters, "series": {},
             "gauges": {}}
        self._windows.append(w)
        for fn in list(self._listeners):
            fn(w)


class _Profiler:
    def __init__(self):
        self._listeners, self._windows, self._seal = [], [], 0

    def add_seal_listener(self, fn):
        self._listeners.append(fn)

    def remove_seal_listener(self, fn):
        if fn in self._listeners:
            self._listeners.remove(fn)

    def last_seal_seq(self):
        return self._seal

    def windows(self, last=0):
        return [dict(w) for w in self._windows]

    def seal(self, seq):
        w = {"seq": seq, "ts": 0.0, "samples": 1, "stacks": {"a;b": 1}}
        if seq > 0:
            self._seal = seq
            self._windows.append(w)
        for fn in list(self._listeners):
            fn(w)


def _bus_run(name, seed):
    mod = PKGS[name]["stream"]
    rec, hist, prof = _Recorder(), _History(), _Profiler()
    bus = mod.TelemetryBus(depth=8, history=hist, recorder=rec, profiler=prof)
    rng = np.random.default_rng(seed)
    # history before the subscription: replayed past the given cursors
    for i in range(3):
        rec.record("fault", n=i)
        hist.seal({"c": i})
    subs = [
        bus.subscribe(name="all", cursors={"flight": 1, "window": 2}),
        bus.subscribe(streams=["flight", "slo"], names=("slo_", "brown"), name="slo", depth=4),
        bus.subscribe(streams=["window"], names=("srv.",), name="win", depth=16),
    ]
    out = [bus.cursors()]
    for step in range(120):  # the seeded burst
        k = rng.integers(6)
        if k == 0:
            hist.seal({"srv.ops": int(rng.integers(9)), "other": 1})
        elif k == 1:
            prof.seal(int(rng.integers(-1, 50)))
        elif k == 2:
            rec.record("slo_burn", slo="latency", severity="page")
        elif k == 3:
            rec.record("bundle", reason="manual", path=f"/b/{step}")
        else:
            rec.record("brownout", rung=int(rng.integers(4)))
        if step % 17 == 0:
            out.append([s.drain(max_events=3) for s in subs])
    out.append([s.drain() for s in subs])
    out.append([s.stats() for s in subs])
    status = bus.status()
    out.append({k: v for k, v in status.items() if not k.startswith("overhead")})
    for s in subs:
        bus.unsubscribe(s)
    out.append((bus.subscriber_count(), [s.closed for s in subs], bus.cursors()))
    return out


@pytest.mark.parametrize("seed", [3, 8])
def test_bus_burst_delivers_and_drops_alike(seed):
    got, want = _bus_run("port", seed), _bus_run("ref", seed)
    assert got == want
    stats = got[-3]
    assert sum(s["dropped"] for s in stats) > 0 and all(s["delivered"] for s in stats)


def test_bus_taxonomy_and_unknown_streams():
    assert stream.STREAMS == ref_stream.STREAMS
    bus = stream.TelemetryBus(history=_History(), recorder=_Recorder(), profiler=_Profiler())
    with pytest.raises(ValueError, match="unknown streams"):
        bus.subscribe(streams=["flight", "metrics"])


def test_watch_endpoint_tails_flight_events():
    """The port server's ``/watch/info`` and a ``/watch`` tail through the
    driver's ``WatchSession``: the hello frame, then the recorded events
    in order."""
    from janusgraph_tpu_torch.core.graph import open_graph
    from janusgraph_tpu_torch.driver.client import WatchSession
    from janusgraph_tpu_torch.server import JanusGraphManager, JanusGraphServer

    g = open_graph({"computer.executor": "cpu"})
    m = JanusGraphManager()
    m.put_graph("graph", g)
    s = JanusGraphServer(manager=m, profiler_enabled=False, watchdog_enabled=False,
                         history_enabled=False).start()
    try:
        import urllib.request

        with urllib.request.urlopen(f"http://127.0.0.1:{s.port}/watch/info", timeout=30) as r:
            info = json.loads(r.read())
        assert info["watch"] and info["streams"] == list(ref_stream.STREAMS)
        ws = WatchSession(f"127.0.0.1:{s.port}",
                          subscribe={"streams": ["flight"], "names": ["probe"]})
        try:
            hello = ws.recv(timeout=10)
            assert hello["type"] == "hello" and hello["streams"] == ["flight"]
            for i in range(3):
                flight_recorder.record("probe", n=i)
            got = []
            while len(got) < 3:
                frame = ws.recv(timeout=10)
                assert frame is not None
                if frame["type"] == "event":
                    got.append(frame["data"]["n"])
            assert got == [0, 1, 2]
        finally:
            ws.close()
    finally:
        s.stop()
        g.close()
        telemetry_bus.reset()
        history.reset()
