"""The port's continuous profiling plane held to the JAX package's (after
the reference's ``tests/test_continuous.py``).

- The sampler: each package's ``SamplingProfiler`` samples the same parked
  thread, and the folded stacks of that thread are the same strings
  (``file:function;...``, root first); a sealed window carries the
  reference's keys.
- ``flamediff`` and ``flame_from_artifact`` of seeded artifacts equal the
  reference's, row for row.
- The seeded stall faults: a fault plan built from the
  ``storage.faults.stall-lock-at``/``-ms`` and ``wedge-thread-at`` options
  (which the port now honours) drives a held ``InstrumentedLock`` and a
  wedged worker, and each package's ``StallWatchdog`` on a fake clock
  flights the same ``lock_convoy`` and ``stall`` events (clock fields
  masked) with the same fault journal, and writes a bundle each.
- ``BundleWriter``: the bundle files carry the reference's names and keys,
  retention and the rate limit behave alike, a torn file is skipped.
- ``/healthz`` reports degraded in both packages when an enabled sampler
  thread has died.

Every test stops the sampler and the watchdog it started and resets the
singletons it touched (both packages').
"""

import contextlib
import os
import re
import threading
import time

import numpy as np
import pytest

from janusgraph_tpu.core.config import GraphConfiguration as RefConfiguration
from janusgraph_tpu.observability import continuous as ref_cont
from janusgraph_tpu.observability import flight_recorder as ref_flight
from janusgraph_tpu.observability import history as ref_history
from janusgraph_tpu.observability import registry as ref_registry
from janusgraph_tpu.server import server as ref_server_mod
from janusgraph_tpu.storage.faults import FaultPlan as RefFaultPlan
from janusgraph_tpu_torch.core.config import GraphConfiguration
from janusgraph_tpu_torch.observability import continuous as cont
from janusgraph_tpu_torch.observability import flight_recorder, history, registry
from janusgraph_tpu_torch.server import server as server_mod
from janusgraph_tpu_torch.storage.faults import FaultPlan

PKGS = {
    "ref": dict(cont=ref_cont, flight=ref_flight, registry=ref_registry, history=ref_history,
                plan=RefFaultPlan, cfg=RefConfiguration, server=ref_server_mod),
    "port": dict(cont=cont, flight=flight_recorder, registry=registry, history=history,
                 plan=FaultPlan, cfg=GraphConfiguration, server=server_mod),
}
CLOCK_FIELDS = ("ts", "mono", "seq")


def _reset_all():
    for p in PKGS.values():
        c = p["cont"]
        for step in (c.sampling_profiler.stop, c.sampling_profiler.reset, c.watchdog.stop,
                     c.watchdog.reset, c.bundle_writer.reset, p["flight"].reset):
            step()
        c.bundle_writer.configure(directory="", min_interval_s=30.0)
        c.bundle_writer.directory = ""


@pytest.fixture(autouse=True)
def _plane():
    _reset_all()
    yield
    _reset_all()


class Clock:
    def __init__(self, t=0.0):
        self.t = t

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


@contextlib.contextmanager
def _parked_thread(name="parked"):
    release = threading.Event()

    def _park_here():
        release.wait(30.0)

    t = threading.Thread(target=_park_here, name=name, daemon=True)
    t.start()
    try:
        yield t
    finally:
        release.set()
        t.join(timeout=5.0)


def _masked(events):
    return [{k: v for k, v in e.items() if k not in CLOCK_FIELDS} for e in events]


# ---------------------------------------------------------------- sampler
def test_folded_stacks_of_a_parked_thread_are_the_reference_strings():
    with _parked_thread():
        out = {}
        for name, p in PKGS.items():
            prof = p["cont"].SamplingProfiler()
            assert prof.sample_once() >= 1
            out[name] = sorted(s for s in prof.merged_stacks() if "_park_here" in s)
            w = prof.seal_window(seq=7)
            out[name + "_keys"] = sorted(w)
            out[name + "_seq"] = w["seq"]
    assert out["port"] == out["ref"] and len(out["port"]) == 1
    stack = out["port"][0]
    assert stack.startswith("threading.py:") and stack.endswith(
        "test_torch_continuous.py:_park_here;threading.py:wait;threading.py:wait")
    assert out["port_keys"] == out["ref_keys"] and out["port_seq"] == 7


def test_the_sampler_never_profiles_itself_and_seals_on_history():
    for p in PKGS.values():
        prof = p["cont"].SamplingProfiler()
        with _parked_thread():
            prof.sample_once()
        assert not any("sample_once" in s for s in prof.merged_stacks())
        st = prof.status()
        assert set(st) >= {"enabled", "alive", "hz", "windows", "overhead_cpu_pct",
                           "overhead_wall_pct"}


def test_flamediff_and_artifacts_equal():
    rng = np.random.default_rng(9)
    frames = [f"m{i}.py:f{i}" for i in range(8)]

    def artifact():
        stacks = {}
        for _ in range(30):
            depth = int(rng.integers(1, 5))
            stack = ";".join(frames[int(j)] for j in rng.integers(0, 8, depth))
            stacks[stack] = stacks.get(stack, 0.0) + float(rng.integers(1, 500))
        return stacks

    a, b = artifact(), artifact()
    shapes = [({"stacks": a}, {"stacks": b}), ({"flame": {"stacks": a}}, {"flame": b}), (a, b),
              ({"stacks": a}, {"nothing": "x"})]
    for old, new in shapes:
        for top in (0, 3):
            assert cont.flamediff(old, new, top=top) == ref_cont.flamediff(old, new, top=top)
        assert cont.flame_from_artifact(new) == ref_cont.flame_from_artifact(new)
    assert cont.flamediff({"stacks": a}, {"stacks": b})  # the seeded artifacts differ


# ------------------------------------------------------ seeded stall faults
STALL_OPTS = {"storage.faults.enabled": True, "storage.faults.seed": 1234,
              "storage.faults.stall-lock-at": 0, "storage.faults.stall-lock-ms": 250.0,
              "storage.faults.wedge-thread-at": 1}


def _convoy(name, tmp_path):
    """The reference's stalled-lock scenario on fake clocks, with the plan
    built from the options: the convoy event, the bundle, the journal."""
    p = PKGS[name]
    c = p["cont"]
    plan = p["plan"].from_config(p["cfg"](dict(STALL_OPTS)))
    assert (plan.stall_lock_at, plan.stall_lock_ms, plan.wedge_thread_at) == (0, 250.0, 1)
    clk = Clock(100.0)
    wd = c.StallWatchdog(clock=clk)
    wd.configure(stall_s=5.0)
    c.bundle_writer.configure(directory=str(tmp_path / name), min_interval_s=0.0)
    lk = c.InstrumentedLock("stall-test", watchdog=wd, clock=clk)
    held, release = threading.Event(), threading.Event()

    def _holding_frame():
        release.wait(30.0)

    def _holder():
        assert plan.stalled_lock(lock=lk.name) == 250.0
        with lk:
            held.set()
            _holding_frame()

    th = threading.Thread(target=_holder, name="holder", daemon=True)
    th.start()
    assert held.wait(10.0)
    tw = threading.Thread(target=lambda: (lk.acquire(), lk.release()), name="waiter",
                          daemon=True)
    tw.start()
    deadline = time.monotonic() + 10.0
    while lk.state()["waiters"] < 1:
        assert time.monotonic() < deadline, "the waiter never registered"
        time.sleep(0.005)
    c.sampling_profiler.sample_once()  # snapshot the owner's stack
    clk.advance(2.0)
    early = wd.check()
    clk.advance(4.0)
    fired = wd.check()
    clk.advance(10.0)
    again = wd.check()
    bundle = c.bundle_writer.latest()
    release.set()
    th.join(5.0)
    tw.join(5.0)
    wd.check()

    # the wedged worker: progress freezes at the plan's index
    state = {"done": 0, "wedged": False}

    def _step():
        if plan.wedge_thread():
            state["wedged"] = True
        if not state["wedged"]:
            state["done"] += 1

    wd.register_progress("worker", lambda: {"active": 1, "progress": state["done"]})
    _step()
    wd.check()
    clk.advance(3.0)
    _step()
    wd.check()
    clk.advance(6.0)
    stalled = wd.check()
    return dict(early=early, fired=_masked(fired), again=again, stalled=_masked(stalled),
                bundle_keys=sorted(bundle), bundle_reason=bundle["reason"],
                convoy_in_bundle=len([e for e in bundle["flight"]["events"]
                                      if e["category"] == "lock_convoy"]),
                journal=list(plan.journal), events=wd.state()["events"],
                lock=(lk.state()["owner"], lk.state()["waiters"]),
                files=sorted(re.sub(r"\d+", "N", f) for f in os.listdir(tmp_path / name)))


def test_seeded_stall_faults_trip_both_watchdogs_alike(tmp_path):
    want, got = _convoy("ref", tmp_path), _convoy("port", tmp_path)
    assert got == want
    ev = got["fired"][0]
    assert ev["category"] == "lock_convoy" and ev["owner"] == "holder"
    assert ev["waiter"] == "waiter" and "_holding_frame" in ev["owner_stack"]
    assert got["early"] == [] and got["again"] == [] and got["convoy_in_bundle"] == 1
    assert [e["category"] for e in got["stalled"]] == ["stall"]
    assert [e["kind"] for e in got["journal"]] == ["stalled_lock", "wedged_thread"]
    assert got["files"] == ["bundle-N-N.json", "bundle-N-N.json"]


# ----------------------------------------------------------------- bundles
def _bundles(name, tmp_path):
    c = PKGS[name]["cont"]
    clk = Clock(50.0)
    bw = c.BundleWriter(clock=clk)
    d = tmp_path / name
    bw.configure(directory=str(d), retention=2, min_interval_s=10.0)
    bw.set_request_table(lambda: [{"query": "g.V().count()", "graph": "graph"}])
    paths = [bw.capture("manual")]
    clk.advance(1.0)
    paths.append(bw.capture("stall"))  # rate-limited
    paths.append(bw.capture("stall", force=True))
    for _ in range(2):
        clk.advance(11.0)
        paths.append(bw.capture("slo-page"))
    (d / ("bundle-%d-9999.json" % os.getpid())).write_text("{torn")  # a killed writer
    latest = bw.latest()
    return dict(written=[p is not None for p in paths], status=bw.status(),
                latest_keys=sorted(latest), latest_reason=latest["reason"],
                requests=latest["requests"],
                files=sorted(re.sub(r"\d+", "N", f) for f in os.listdir(d)),
                stacks=sorted(type(v).__name__ for v in latest["stacks"].values())[:1])


def test_bundle_files_and_keys_equal(tmp_path):
    want, got = _bundles("ref", tmp_path), _bundles("port", tmp_path)
    got["status"].pop("dir")
    want["status"].pop("dir")
    assert got == want
    assert got["written"] == [True, False, True, True, True]
    assert got["latest_reason"] == "slo-page" and got["status"]["on_disk"] == 3
    for key in ("flame_windows", "profiler", "flight", "timeseries", "stacks", "requests",
                "watchdog", "reason", "pid", "ts"):
        assert key in got["latest_keys"]


def test_healthz_degrades_when_the_sampler_dies_in_both():
    for name, p in PKGS.items():
        c, srv = p["cont"], p["server"]
        prof = c.sampling_profiler
        with srv._HEALTH_LOCK:
            srv._HEALTH_STATE["status"] = None
        prof.start()
        try:
            assert srv.healthz_snapshot()["profiler"]["alive"], name
            prof._stop.set()  # the thread ends while the profiler stays enabled
            prof._thread.join(5.0)
            hz = srv.healthz_snapshot()
            assert hz["status"] == "degraded" and not hz["profiler"]["alive"], name
            assert hz["profiler"]["enabled"]
        finally:
            prof.stop()
            with srv._HEALTH_LOCK:
                srv._HEALTH_STATE["status"] = None
