"""The port's admission control held to the JAX package's (after the
reference's ``tests/test_admission.py``).

- Both packages' ``AdmissionController``s are fed the same seeded sequence
  of admissions (priced by the same query shapes), releases with seeded
  latencies, measured costs and clock advances, with an injected clock and
  the same ``random`` seed for the decorrelated jitter. After every step
  the AIMD limit and baseline, the decision (admitted, shed with its reason
  and retry-after, queue timeout), the queue, the in-flight count and the
  brownout rung are equal. Exact equality: the same arithmetic on the same
  floats.
- The brownout gate: at rung 2 the port's ``GraphComputer.submit`` raises
  ``ServerOverloadedError`` before any scan or run (the last run record
  does not change, ``server.admission.olap_refused`` goes up by one), as
  the reference's does; the spillover falls back with reason "brownout"
  and still answers with the walk's count; with no controller active,
  every run is admitted.
- A shed request over HTTP is a 503 with a Retry-After header in both
  packages, while ``/healthz`` and ``/metrics`` bypass admission.

The active controller is process-wide: every test that registers one
deregisters it in a ``finally``.
"""

import json
import random
import urllib.error
import urllib.request

import numpy as np
import pytest

from janusgraph_tpu.core.graph import open_graph as ref_open_graph
from janusgraph_tpu.core import gods as ref_gods
from janusgraph_tpu.exceptions import ServerOverloadedError as RefOverloaded
from janusgraph_tpu.observability import registry as ref_registry
from janusgraph_tpu.olap.programs import PageRankProgram as RefPageRank
from janusgraph_tpu.server import JanusGraphManager as RefManager
from janusgraph_tpu.server import JanusGraphServer as RefServer
from janusgraph_tpu.server import admission as ref_admission
from janusgraph_tpu_torch.core import gods
from janusgraph_tpu_torch.core.bulk import bulk_add_edges, bulk_add_vertices
from janusgraph_tpu_torch.core.graph import open_graph
from janusgraph_tpu_torch.exceptions import ServerOverloadedError
from janusgraph_tpu_torch.observability import registry
from janusgraph_tpu_torch.olap.programs import PageRankProgram
from janusgraph_tpu_torch.server import JanusGraphManager, JanusGraphServer, admission

SHAPES = [
    "g.V().count()",
    "g.V(1).out('a').values('name')",
    "g.V().has('name', 'saturn').out('father').out('father')",
    "g.V().pageRank().order().by('pagerank', reverse=True).limit(3)",
    "g.V(7).has('age', 4000).in_('father')",
]


class Clock:
    def __init__(self, t=100.0):
        self.t = t

    def __call__(self):
        return self.t


def _count(reg, name):
    return reg.snapshot().get(name, {}).get("count", 0)


def drive(mod, seed, steps=400):
    """One seeded sequence through ``mod``'s controller; the state after
    every step."""
    clock = Clock()
    ctl = mod.AdmissionController(
        initial_limit=3, min_limit=1, max_limit=6, queue_bound=3, window=4,
        latency_threshold=2.0, default_cost_ms=25.0, cheap_cost_ms=5.0,
        brownout_window_s=5.0, brownout_enter_sheds=3, brownout_exit_s=4.0,
        brownout_dwell_s=1.0, retry_after_base_s=0.25, retry_after_max_s=8.0,
        price_book_capacity=8, clock=clock,
    )
    rng = np.random.default_rng(seed)
    random.seed(seed)
    held, trace = [], []
    for _ in range(steps):
        op = rng.integers(10)
        if op < 5:
            query = SHAPES[int(rng.integers(len(SHAPES)))]
            digest, price, known = ctl.price(query)
            try:
                # a zero wait: a request that would queue times out at once,
                # so the sequence runs on one thread
                held.append(ctl.acquire(price_ms=price, known=known, digest=digest,
                                        timeout_s=0.0))
                out = ("admitted", digest, price, known)
            except mod.ShedError as e:
                out = ("shed", e.reason, e.retry_after_s, str(e))
            except Exception as e:  # the deadline expired while queued
                out = ("timeout", type(e).__name__, str(e))
        elif op < 8 and held:
            ticket = held.pop(int(rng.integers(len(held))))
            latency = float(rng.choice([1.0, 2.0, 30.0, 120.0]) * rng.uniform(0.5, 1.5))
            ctl.release(ticket, latency)
            out = ("released", latency)
        elif op == 8:
            query = SHAPES[int(rng.integers(len(SHAPES)))]
            digest, _p, _k = ctl.price(query)
            cost = float(rng.gamma(2.0, 4.0))
            ctl.observe_cost(digest, query, cost, cells=int(rng.integers(50)))
            out = ("cost", digest, cost)
        else:
            clock.t += float(rng.choice([0.1, 0.5, 2.0, 6.0]))
            out = ("tick", clock.t)
        trace.append((out, ctl.snapshot(), ctl.limiter.limit, ctl.limiter.floor_ms,
                      ctl.queue_depth, ctl.in_flight, ctl.span_retention_shed()))
    return trace


@pytest.mark.parametrize("seed", [1, 4, 7, 10])
def test_controllers_decide_alike_on_a_seeded_sequence(seed):
    want, got = drive(ref_admission, seed), drive(admission, seed)
    assert got == want
    kinds = {t[0][0] for t in got}
    rungs = {t[1]["brownout_rung"] for t in got}
    # the sequence reaches sheds, queue timeouts and the ladder's rungs
    assert {"admitted", "shed", "timeout", "released"} <= kinds, kinds
    assert max(rungs) >= 2, rungs


def test_query_shapes_and_digests_equal():
    for q in SHAPES + ["g.V( 1 )", "g.V(42).has('name', \"x y\").out('father')"]:
        assert admission.query_shape(q) == ref_admission.query_shape(q)
    a, b = admission.AdmissionController(), ref_admission.AdmissionController()
    assert [a.price(q) for q in SHAPES] == [b.price(q) for q in SHAPES]


def test_from_config_takes_the_reference_options():
    opts = {"server.admission.initial-limit": 5, "server.admission.queue-bound": 9,
            "server.admission.brownout-enter-sheds": 2,
            "server.admission.retry-after-max-s": 3.0, "metrics.digest-top-k": 17}
    g, rg = open_graph(dict(opts)), ref_open_graph(dict(opts))
    try:
        ours = admission.AdmissionController.from_config(g.config)
        ref = ref_admission.AdmissionController.from_config(rg.config)
        assert ours.snapshot() == ref.snapshot()
        for attr in ("queue_bound", "default_cost_ms", "cheap_cost_ms", "retry_after_base_s",
                     "retry_after_max_s"):
            assert getattr(ours, attr) == getattr(ref, attr)
        assert (ours.brownout.enter_sheds, ours.price_book.capacity) == (2, 17) == (
            ref.brownout.enter_sheds, ref.price_book.capacity)
    finally:
        g.close()
        rg.close()


def test_brownout_ladders_climb_and_descend_alike():
    out = []
    for mod in (ref_admission, admission):
        clock = Clock()
        ladder = mod.BrownoutLadder(window_s=5.0, enter_sheds=2, exit_s=3.0, dwell_s=1.0,
                                    clock=clock)
        rungs = []
        for dt, op in ([(0.1, "shed")] * 8 + [(1.5, "shed")] * 4 + [(1.0, "healthy")] * 8
                       + [(0.2, "shed"), (1.2, "underload")] * 3):
            clock.t += dt
            getattr(ladder, {"shed": "note_shed", "healthy": "note_healthy",
                             "underload": "note_underload"}[op])()
            rungs.append(ladder.rung)
        out.append(rungs)
    assert out[1] == out[0] and max(out[1]) == 3


# ------------------------------------------------------- the brownout gate
def _small_graph(open_fn, cfg):
    g = open_fn(dict(cfg))
    tx = g.new_transaction()
    vs = [tx.add_vertex("node") for _ in range(6)]
    for i in range(6):
        tx.add_edge(vs[i], "link", vs[(i + 1) % 6])
    tx.commit()
    return g


@pytest.mark.parametrize("pkg", ["port", "ref"])
def test_olap_submit_refused_at_rung_2_before_any_run(pkg):
    if pkg == "port":
        mod, reg, pr, err = admission, registry, PageRankProgram, ServerOverloadedError
        g = _small_graph(open_graph, {"computer.executor": "cpu"})
    else:
        mod, reg, pr, err = ref_admission, ref_registry, RefPageRank, RefOverloaded
        g = _small_graph(ref_open_graph, {"computer.sharded-auto": False})
    try:
        first = g.compute().program(pr(max_iterations=2)).submit()
        runs = len(reg.runs("olap"))
        ctl = mod.AdmissionController(brownout_enter_sheds=1, brownout_dwell_s=0.0)
        # through the ladder's public API: two sheds climb two rungs
        ctl.brownout.note_shed()
        ctl.brownout.note_shed()
        assert ctl.brownout.rung == mod.RUNG_REFUSE_OLAP
        refused = _count(reg, "server.admission.olap_refused")
        mod.set_active(ctl)
        try:
            with pytest.raises(err) as e:
                g.compute().program(pr(max_iterations=2)).submit()
            assert e.value.retry_after_s == ctl.retry_after_max_s
        finally:
            mod.set_active(None)
        assert len(reg.runs("olap")) == runs  # no scan, no run
        assert _count(reg, "server.admission.olap_refused") == refused + 1
        # back down the ladder, and with no controller at all: admitted
        ctl.brownout.note_underload()
        assert ctl.brownout.rung == mod.RUNG_SHED_SPANS
        mod.set_active(ctl)
        try:
            again = g.compute().program(pr(max_iterations=2)).submit()
        finally:
            mod.set_active(None)
        assert np.array_equal(again.states["rank"], first.states["rank"])
        assert g.compute().program(pr(max_iterations=2)).submit() is not None
    finally:
        g.close()


def test_check_olap_admission_admits_without_a_controller():
    admission.set_active(None)
    admission.check_olap_admission()
    ctl = admission.AdmissionController()
    admission.set_active(ctl)
    try:
        admission.check_olap_admission()  # rung 0
        ctl.brownout.rung = admission.RUNG_SHED_SPANS
        admission.check_olap_admission()  # rung 1 sheds spans only
        ctl.brownout.rung = admission.RUNG_CHEAP_ONLY
        with pytest.raises(ServerOverloadedError):
            admission.check_olap_admission()
    finally:
        admission.set_active(None)


SPILL = {"computer.spillover": True, "computer.spillover-min-cost-ms": 0.0,
         "computer.spillover-min-seen": 1}


@pytest.mark.parametrize("pkg", ["port", "ref"])
def test_spillover_falls_back_with_reason_brownout(pkg):
    if pkg == "port":
        mod, reg = admission, registry
        g = open_graph({**SPILL, "computer.executor": "cpu"})
    else:
        mod, reg = ref_admission, ref_registry
        g = ref_open_graph({**SPILL, "computer.sharded-auto": False, "schema.default": "auto"})
    try:
        vids = bulk_add_vertices(g, 32) if pkg == "port" else None
        if pkg == "port":
            rng = np.random.default_rng(4)
            bulk_add_edges(g, "knows", vids[rng.integers(0, 32, 96)],
                           vids[rng.integers(0, 32, 96)])
        else:
            tx = g.new_transaction()
            vs = [tx.add_vertex("person") for _ in range(32)]
            rng = np.random.default_rng(4)
            for a, b in zip(rng.integers(0, 32, 96), rng.integers(0, 32, 96)):
                tx.add_edge(vs[int(a)], "knows", vs[int(b)])
            tx.commit()

        def chain():
            return g.traversal().V().out("knows").out("knows").count()

        walked = chain()  # the walk teaches the digest table
        spilled = _count(reg, "olap.spillover.spilled")
        assert chain() == walked and _count(reg, "olap.spillover.spilled") == spilled + 1
        ctl = mod.AdmissionController()
        ctl.brownout.rung = mod.RUNG_REFUSE_OLAP
        before = _count(reg, "olap.spillover.fallback.brownout")
        mod.set_active(ctl)
        try:
            assert chain() == walked  # walked, not spilled
        finally:
            mod.set_active(None)
        assert _count(reg, "olap.spillover.fallback.brownout") == before + 1
        assert _count(reg, "olap.spillover.spilled") == spilled + 1
        assert reg.last_run("olap.spillover")["spillover"]["fallback"] == "brownout"
    finally:
        g.close()


# ------------------------------------------------------ shedding over HTTP
@pytest.mark.parametrize("pkg", ["port", "ref"])
def test_shed_request_is_a_503_with_retry_after_while_healthz_bypasses(pkg):
    if pkg == "port":
        mod, Manager, Server = admission, JanusGraphManager, JanusGraphServer
        g = open_graph({"computer.executor": "cpu"})
        gods.load(g)
    else:
        mod, Manager, Server = ref_admission, RefManager, RefServer
        g = ref_open_graph({"computer.sharded-auto": False})
        ref_gods.load(g)
    # a breaker another test file left open in this process would make
    # /healthz answer 503 "degraded" (served all the same, which is what
    # counts here); start from a clean registry as the reference's suite does
    (registry if pkg == "port" else ref_registry).reset()
    ctl = mod.AdmissionController(initial_limit=1, max_limit=1, queue_bound=0)
    m = Manager()
    m.put_graph("graph", g)
    s = Server(manager=m, admission=ctl).start()
    try:
        hold = ctl.acquire(price_ms=1.0)  # the one slot is taken
        req = urllib.request.Request(
            f"http://127.0.0.1:{s.port}/gremlin",
            data=json.dumps({"gremlin": "g.V().count()"}).encode())
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(req, timeout=30)
        assert e.value.code == 503
        body = json.loads(e.value.read())
        assert body["status"]["status"] == "shed" and body["status"]["reason"] == "queue-full"
        assert float(e.value.headers["Retry-After"]) == body["status"]["retry_after_s"] > 0
        for path in ("/healthz", "/metrics"):
            with urllib.request.urlopen(f"http://127.0.0.1:{s.port}{path}", timeout=30) as r:
                assert r.status == 200
        ctl.release(hold, 1.0)
        with urllib.request.urlopen(req, timeout=30) as r:
            assert json.loads(r.read())["result"]["data"]["@value"] == 12
    finally:
        s.stop()
        g.close()
    assert mod.active() is None
