"""The port's serving fleet held to the JAX package's (after the
reference's ``tests/test_fleet.py``).

Each scenario runs through both packages, each on its own objects, and
the observations are compared:

- router selection: the same replica names and vnodes give the same ring,
  the same candidate order for every key, the same first choice under an
  injected admission or SLO block, the same load scores and routing keys;
- retry-elsewhere under shed with the fleet retry budget, budget
  exhaustion, connect failures marking a replica dead, caller errors not
  rerouted, the deadline bounding the retries, and one stitched trace
  (``fleet.route`` with one ``fleet.attempt`` per replica tried);
- sticky sessions and drain (zero sessions lost), the server's drain
  (new work shed with status "draining", sessions finish);
- gossip convergence on a fake clock, local measurements winning, the
  brownout rung in ``peer_state``, and gossip over HTTP — also from a
  port agent into a reference server and back;
- warm-up: a replica warmed from either package's export has a snapshot
  array-equal to a storage re-scan with zero edgestore reads, and its CPU
  submit (``computer.executor`` "cpu") gives PageRank bitwise equal to
  the leader's and within rtol 1e-6 of the reference's; the pack carries
  no edge weights and no property columns in either package, so a warmed
  replica's snapshot has neither (reference behaviour, kept);
- the warm-submit executor cache and its invalidation;
- the seeded fleet fault kinds: equal journals, the partition window on
  the target only, the options read into the plan;
- replica identity in flight events, logs and metrics, and the fleet's
  quorum ``/healthz``;
- the chaos cell (one of three replicas killed mid-traffic: zero errors
  to well-budgeted callers, the corpse marked dead, every worker done),
  gated on results only, never on a goodput ratio;
- the frontend: a routed request, the fleet ``/healthz``, ``/assign``,
  and the caller's deadline reaching the replica.

Exact equality for rings, orders, ids, journals and arrays; ranks
bitwise within one package and within rtol 1e-6 across packages (each
package sums in its own order).
"""

import json
import threading
import time
import urllib.request
from types import SimpleNamespace

import numpy as np
import pytest

import janusgraph_tpu.observability as ref_obs
import janusgraph_tpu_torch.observability as port_obs
from janusgraph_tpu import driver as ref_driver
from janusgraph_tpu import server as ref_server
from janusgraph_tpu.core.graph import JanusGraphTPU as RefGraph
from janusgraph_tpu.driver.client import RemoteError as RefRemoteError
from janusgraph_tpu.exceptions import InjectedFaultError as RefInjectedFaultError
from janusgraph_tpu.observability import logging as ref_logging
from janusgraph_tpu.olap import csr as ref_csr
from janusgraph_tpu.olap import delta as ref_delta
from janusgraph_tpu.olap.programs.degree import DegreeCountProgram as RefDegree
from janusgraph_tpu.olap.programs.pagerank import PageRankProgram as RefPageRank
from janusgraph_tpu.server import admission as ref_admission
from janusgraph_tpu.server import fleet as ref_fleet
from janusgraph_tpu.storage.faults import FaultPlan as RefFaultPlan
from janusgraph_tpu.storage.inmemory import InMemoryStoreManager as RefMgr
from janusgraph_tpu_torch import driver as port_driver
from janusgraph_tpu_torch import server as port_server
from janusgraph_tpu_torch.core.graph import JanusGraphTPU as PortGraph
from janusgraph_tpu_torch.driver.client import RemoteError as PortRemoteError
from janusgraph_tpu_torch.exceptions import InjectedFaultError as PortInjectedFaultError
from janusgraph_tpu_torch.observability import logging as port_logging
from janusgraph_tpu_torch.olap import csr as port_csr
from janusgraph_tpu_torch.olap import delta as port_delta
from janusgraph_tpu_torch.olap.programs import DegreeCountProgram as PortDegree
from janusgraph_tpu_torch.olap.programs import PageRankProgram as PortPageRank
from janusgraph_tpu_torch.server import admission as port_admission
from janusgraph_tpu_torch.server import fleet as port_fleet
from janusgraph_tpu_torch.storage.faults import FaultPlan as PortFaultPlan
from janusgraph_tpu_torch.storage.inmemory import InMemoryStoreManager as PortMgr

BASE_CFG = {"ids.authority-wait-ms": 0.0, "locks.wait-ms": 0.0}

REF = SimpleNamespace(
    name="ref", fleet=ref_fleet, server=ref_server, driver=ref_driver, obs=ref_obs,
    logging=ref_logging, admission=ref_admission, Graph=RefGraph, Mgr=RefMgr,
    RemoteError=RefRemoteError, InjectedFaultError=RefInjectedFaultError,
    FaultPlan=RefFaultPlan, delta=ref_delta, csr=ref_csr, PageRank=RefPageRank,
    Degree=RefDegree,
    # the reference's jitted executor on one device (the suite's 8
    # virtual devices route it to the sharded executor otherwise)
    olap_cfg={"computer.sharded-auto": False}, warm_executor="tpu",
)
PORT = SimpleNamespace(
    name="port", fleet=port_fleet, server=port_server, driver=port_driver, obs=port_obs,
    logging=port_logging, admission=port_admission, Graph=PortGraph, Mgr=PortMgr,
    RemoteError=PortRemoteError, InjectedFaultError=PortInjectedFaultError,
    FaultPlan=PortFaultPlan, delta=port_delta, csr=port_csr, PageRank=PortPageRank,
    Degree=PortDegree, olap_cfg={"computer.executor": "cpu"}, warm_executor="cpu",
)
BOTH = (REF, PORT)


@pytest.fixture(autouse=True)
def _reset():
    for P in BOTH:
        P.obs.flight_recorder.reset()
        P.obs.registry.reset()
        P.obs.set_replica("")
    yield
    for P in BOTH:
        P.obs.flight_recorder.reset()
        P.obs.set_replica("")


def _both(fn):
    """(reference's observation, port's observation) of one scenario."""
    return fn(REF), fn(PORT)


def _offline_router(P, **kw):
    """A router whose probes never touch the network."""
    kw.setdefault("fetch", lambda url, timeout: {})
    return P.fleet.FleetRouter(**kw)


def _seed_graph(graph, n=32):
    graph.management().make_edge_label("knows")
    tx = graph.new_transaction()
    ids = [tx.add_vertex().id for _ in range(n)]
    for i in range(n):
        tx.add_edge(tx.get_vertex(ids[i]), "knows", tx.get_vertex(ids[(i * 7 + 1) % n]))
    tx.commit()
    return ids


def _edgestore_touched(P):
    snap = P.obs.registry.snapshot()
    return [k for k in snap if "edgestore" in k and snap[k].get("count")]


# ---------------------------------------------------------------- selection

def _ring(P, vnodes, names):
    r = _offline_router(P, vnodes=vnodes)
    for i, name in enumerate(names):
        r.add_replica(name, "127.0.0.1", 9000 + i)
    return r


@pytest.mark.parametrize("vnodes,names", [
    (16, ["r0", "r1", "r2", "r3"]),
    (1, ["a", "b"]),
    (64, ["replica-east", "replica-west", "replica-north"]),
])
def test_the_same_names_and_vnodes_give_the_same_ring(vnodes, names):
    keys = [str(k) for k in range(200)] + ["", "digest-xyz", "g.V().count()"]
    ref, port = _both(lambda P: (
        _ring(P, vnodes, names)._ring,
        [[h.name for h in _ring(P, vnodes, names).candidates_for(k)] for k in keys],
    ))
    assert port == ref
    # the same key routes to the same replica, and every member appears once
    assert all(sorted(order) == sorted(names) for order in port[1])


def test_consistent_hash_is_deterministic():
    def run(P):
        r1, r2 = _ring(P, 16, [f"r{i}" for i in range(4)]), _ring(P, 16, [f"r{i}" for i in range(4)])
        out = []
        for key in ("a", "b", "digest-xyz", "42", ""):
            names1 = [h.name for h in r1.candidates_for(key)]
            assert names1 == [h.name for h in r2.candidates_for(key)]
            assert sorted(names1) == ["r0", "r1", "r2", "r3"]
            out.append(names1)
        return out

    ref, port = _both(run)
    assert port == ref


def test_keys_spread_across_replicas():
    ref, port = _both(lambda P: [
        _ring(P, 16, [f"r{i}" for i in range(4)]).candidates_for(str(k))[0].name for k in range(64)
    ])
    assert port == ref and len(set(port)) == 4, "vnode ring failed to spread keys"


def test_least_loaded_tie_break_uses_admission_block():
    def run(P):
        r = _offline_router(P, candidates=2)
        for i in range(2):
            r.add_replica(f"r{i}", "127.0.0.1", 9000 + i)
        key = next(k for k in range(256) if r.candidates_for(str(k))[0].name == "r0")
        r.replicas()["r0"].health = {
            "status": "ok",
            "admission": {"limit": 8, "in_flight": 8, "queue_depth": 4, "queue_bound": 8,
                          "brownout_rung": 2},
            "slo": {"paging": []},
        }
        r.replicas()["r1"].health = {
            "status": "ok",
            "admission": {"limit": 8, "in_flight": 0, "queue_depth": 0, "queue_bound": 8,
                          "brownout_rung": 0},
            "slo": {"paging": []},
        }
        return key, r.candidates_for(str(key))[0].name, [
            h.load_score() for h in r.replicas().values()]

    ref, port = _both(run)
    assert port == ref and port[1] == "r1"


def test_slo_burn_weighs_into_load_score():
    def run(P):
        r = _offline_router(P)
        r.add_replica("r0", "127.0.0.1", 9000)
        h = r.replicas()["r0"]
        scores = [h.load_score()]
        for health in (
            {"status": "ok", "admission": {}, "slo": {"paging": []}},
            {"status": "ok", "admission": {}, "slo": {"paging": ["availability"]}},
            {"status": "ok", "admission": {}, "slo": {"paging": [], "worst": "ticket"}},
            {"status": "degraded", "draining": True, "admission": {"brownout_rung": 3}},
        ):
            h.health = health
            scores.append(h.load_score())
        h.goodput_trend = 0.5
        scores.append(h.load_score())
        return scores, h.snapshot()

    ref, port = _both(run)
    assert port == ref
    assert port[0][2] > port[0][1]


def test_dead_and_draining_replicas_are_skipped():
    def run(P):
        r = _offline_router(P)
        for i in range(3):
            r.add_replica(f"r{i}", "127.0.0.1", 9000 + i)
        r.mark_dead("r0")
        r.replicas()["r1"].state = "draining"
        return [r.candidates_for(str(k))[0].name for k in range(16)]

    ref, port = _both(run)
    assert port == ref == ["r2"] * 16


@pytest.mark.parametrize("q", [
    "g.V(1).out('knows').count()",
    "g.V(999).out('knows').count()",
    "g.V(1).in('knows').count()",
    "g.V().has('name', 'saturn').values('age')",
    "g.V().pageRank().order().by('pagerank', reverse=True).limit(10)",
])
def test_routing_key_strips_literals(q):
    assert port_fleet.FleetRouter.routing_key(q) == ref_fleet.FleetRouter.routing_key(q)
    k1 = port_fleet.FleetRouter.routing_key("g.V(1).out('knows').count()")
    assert k1 == port_fleet.FleetRouter.routing_key("g.V(999).out('knows').count()")
    assert k1 != port_fleet.FleetRouter.routing_key("g.V(1).in('knows').count()")


@pytest.mark.parametrize("deltas", [[1, 2, 3, 4], [4, 3, 2, 1], [5, 5, 5, 5], [], [0, 1000], [3, 0, 9, 2, 7]])
def test_goodput_slope_equals_the_reference(deltas):
    payload = {"series": {"server.admission.admitted": [{"delta": d} for d in deltas]}}
    assert port_fleet.goodput_slope(payload) == ref_fleet.goodput_slope(payload)
    assert -1.0 <= port_fleet.goodput_slope(payload) <= 1.0


# ---------------------------------------------------------- retry elsewhere

class _FakeClient:
    def __init__(self, behavior):
        self.behavior = behavior
        self.calls = 0

    def submit(self, query, graph=None, deadline_ms=None):
        self.calls += 1
        out = self.behavior()
        if isinstance(out, Exception):
            raise out
        return out


def _retry_router(P, behaviors, **kw):
    clients = {}

    def factory(handle):
        clients[handle.name] = _FakeClient(behaviors[handle.name])
        return clients[handle.name]

    kw.setdefault("backoff_base_s", 0.001)
    kw.setdefault("backoff_max_s", 0.002)
    r = _offline_router(P, client_factory=factory, **kw)
    for name in behaviors:
        r.add_replica(name, "127.0.0.1", 9000)
    return r, clients


def test_shed_retries_on_another_replica():
    def run(P):
        shed = P.RemoteError(503, "shed", status="shed", retry_after_s=0.001)
        r, clients = _retry_router(P, {"r0": lambda: shed, "r1": lambda: 7, "r2": lambda: 7})
        before = P.obs.registry.get_count("fleet.router.retries")
        got = [r.submit("q", key=str(k)) for k in range(8)]
        retries = P.obs.registry.get_count("fleet.router.retries") - before
        assert clients.get("r0") is None or clients["r0"].calls <= 8
        return got, retries, {n: dict(h.stats) for n, h in r.replicas().items()}

    ref, port = _both(run)
    assert port == ref and port[0] == [7] * 8 and port[1] > 0


def test_budget_exhaustion_surfaces_the_error():
    def run(P):
        shed = P.RemoteError(503, "shed", status="shed", retry_after_s=0.001)
        r, _ = _retry_router(P, {"r0": lambda: shed, "r1": lambda: shed},
                             retry_budget_capacity=1.0, retry_budget_refill_per_s=0.0)
        with pytest.raises(P.fleet.NoReplicaAvailable, match="budget exhausted"):
            r.submit("q", key="k")
        assert r.retry_budget.tokens < 1.0
        return P.obs.registry.get_count("fleet.router.budget_exhausted")

    ref, port = _both(run)
    assert port == ref == 1


def test_connect_failure_marks_replica_dead_and_fails_over():
    def run(P):
        r, _ = _retry_router(P, {"r0": lambda: ConnectionRefusedError("refused"), "r1": lambda: 42})
        got = [r.submit("q", key=k) for k in ("a", "b")] + [r.submit("q", key=str(k)) for k in range(6)]
        deaths = [e for e in P.obs.flight_recorder.events("fleet")
                  if e.get("action") == "dead" and e.get("replica") == "r0"]
        return got, r.replicas()["r0"].state, [e["reason"] for e in deaths]

    ref, port = _both(run)
    assert port == ref
    assert port[0] == [42] * 8 and port[1] == port_fleet.DEAD and port[2] == ["connect"]


def test_evaluation_errors_are_not_rerouted():
    def run(P):
        bad = P.RemoteError(500, "NameError: nope", status=None)
        calls = {"n": 0}

        def r0():
            calls["n"] += 1
            return bad

        r, _ = _retry_router(P, {"r0": r0, "r1": r0})
        with pytest.raises(P.RemoteError):
            r.submit("q", key="k")
        return calls["n"]

    ref, port = _both(run)
    assert port == ref == 1, "a caller error must fail once, not N times"


def test_deadline_bounds_retry_elsewhere():
    def run(P):
        shed = P.RemoteError(503, "shed", status="shed", retry_after_s=5.0)
        r, _ = _retry_router(P, {"r0": lambda: shed, "r1": lambda: shed})
        t0 = time.monotonic()
        with pytest.raises(P.fleet.NoReplicaAvailable, match="deadline"):
            r.submit("q", key="k", deadline_ms=50.0)
        assert time.monotonic() - t0 < 2.0, "honoring a 5 s Retry-After past a 50 ms deadline"
        return [s.attrs.get("verdict") for s in P.obs.tracer.recent("fleet.route")][-1:]

    ref, port = _both(run)
    assert port == ref == ["deadline"]


def test_failover_is_one_stitched_trace():
    def run(P):
        shed = P.RemoteError(503, "shed", status="shed", retry_after_s=0.001)
        behaviors = {"r0": lambda: shed, "r1": lambda: shed, "r2": lambda: shed}
        r, _ = _retry_router(P, behaviors)
        first = r.candidates_for("stitch")[0].name
        for name in behaviors:
            if name != first:
                behaviors[name] = lambda: 11
        caller = P.obs.TraceContext(trace_id=0xABCDEF0123456789, span_id=0x42)
        assert r.submit("q", key="stitch", trace_ctx=caller) == 11
        routes = [s for s in P.obs.tracer.find_trace(caller.trace_id) if s.name == "fleet.route"]
        assert routes, "fleet.route did not join the caller's trace"
        route = routes[-1]
        assert route.parent_span_id == caller.span_id
        attempts = [c for c in route.children if c.name == "fleet.attempt"]
        return first, [(a.attrs.get("replica"), a.attrs.get("verdict"),
                        a.attrs.get("retry_elsewhere")) for a in attempts], route.attrs.get("attempts")

    ref, port = _both(run)
    assert port == ref
    first, attempts, count = port
    assert len(attempts) == 2 and count == 2
    assert attempts[0] == (first, "shed", True) and attempts[-1][1] == "ok"


def test_submit_without_context_still_traces():
    def run(P):
        r, _ = _retry_router(P, {"r0": lambda: 5, "r1": lambda: 5})
        assert r.submit("q", key="k") == 5
        route = P.obs.tracer.recent("fleet.route")[-1]
        return route.attrs.get("verdict"), route.attrs.get("attempts")

    ref, port = _both(run)
    assert port == ref == ("ok", 1)


# ------------------------------------------------------ stickiness and drain

def test_pin_is_stable_and_survives_unrelated_churn():
    def run(P):
        r = _ring(P, 16, ["r0", "r1", "r2"])
        pin = r.pin("sess-1").name
        assert all(r.pin("sess-1").name == pin for _ in range(5))
        r.mark_dead(next(n for n in ("r0", "r1", "r2") if n != pin))
        return pin, r.pin("sess-1").name

    ref, port = _both(run)
    assert port == ref and port[0] == port[1]


def test_drain_hands_off_sticky_sessions_and_loses_none():
    def run(P):
        r = _ring(P, 16, ["r0", "r1", "r2"])
        keys = [f"sess-{k}" for k in range(24)]
        before = {k: r.pin(k).name for k in keys}
        victim = before[keys[0]]
        report = r.drain(victim)
        after = {k: r.pin(k) for k in keys}
        assert all(h is not None and h.name != victim for h in after.values())
        for k, n in before.items():
            if n != victim:
                assert after[k].name == n
        return before, report, {k: h.name for k, h in after.items()}

    ref, port = _both(run)
    assert port == ref
    before, report, _after = port
    assert report["sessions_handed_off"] == sum(1 for n in before.values() if n == report["replica"])
    assert report["graceful"] is True


def test_crash_failover_repins_immediately():
    def run(P):
        r = _ring(P, 16, ["r0", "r1"])
        pin = r.pin("s").name
        r.mark_dead(pin)
        return pin, r.pin("s").name, r.sessions_on(pin)

    ref, port = _both(run)
    assert port == ref and port[0] != port[1] and port[2] == []


def _served(P, graph, **kw):
    m = P.server.JanusGraphManager()
    m.put_graph("graph", graph)
    kw.setdefault("history_enabled", False)
    kw.setdefault("slo_enabled", False)
    return P.server.JanusGraphServer(manager=m, **kw).start()


def _healthz(port):
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz", timeout=10) as resp:
            return json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return json.loads(e.read())


def test_draining_server_sheds_new_work_finishes_sessions():
    def run(P):
        graph = P.Graph(dict(BASE_CFG), store_manager=P.Mgr())
        ids = _seed_graph(graph, n=8)
        server = _served(P, graph, replica_name="r0")
        try:
            client = P.driver.JanusGraphClient(port=server.port, http_timeout_s=30)
            ws = client.ws(session=True)
            ws.sock.settimeout(30)
            done = {}
            try:
                first = ws.submit(f"g.V({ids[0]}).count()")
                opened = server.open_sessions
                th = threading.Thread(target=lambda: done.update(remaining=server.drain(timeout_s=5.0)))
                th.start()
                deadline = time.monotonic() + 30.0
                while not server.draining:
                    assert time.monotonic() < deadline, "drain never began"
                    time.sleep(0.01)
                with pytest.raises(P.RemoteError) as ei:
                    client.submit("g.V().count()")
                second = ws.submit(f"g.V({ids[1]}).count()")
            finally:
                ws.close()
            th.join(timeout=6.0)
            h = _healthz(server.port)
            return (first, opened, ei.value.status, second, done.get("remaining"),
                    h["draining"], h["replica"], h["open_sessions"])
        finally:
            server.stop()
            graph.close()

    ref, port = _both(run)
    assert port == ref == (1, 1, "draining", 1, 0, True, "r0", 0)


def test_draining_server_refuses_new_sessions():
    def run(P):
        graph = P.Graph(dict(BASE_CFG), store_manager=P.Mgr())
        _seed_graph(graph, n=4)
        server = _served(P, graph)
        try:
            server.drain(timeout_s=0.1)
            ws = P.driver.JanusGraphClient(port=server.port, http_timeout_s=30).ws(session=True)
            ws.sock.settimeout(30)
            try:
                with pytest.raises(P.RemoteError) as ei:
                    ws.submit("g.V().count()")
                return ei.value.status, P.obs.registry.get_count("server.drain.refused") >= 0
            finally:
                ws.close()
        finally:
            server.stop()
            graph.close()

    ref, port = _both(run)
    assert port == ref and port[0] == "draining"


# --------------------------------------------------------------------- gossip

def _mesh(P, n, fanout=1):
    clock = {"t": 0.0}
    agents = {}

    def post(url, body, timeout_s):
        peer = agents[url.split("/")[0]]
        peer.merge(body)
        return peer.local_digest()

    for i in range(n):
        agents[f"r{i}"] = P.fleet.StateGossip(
            f"r{i}", P.admission.AdmissionController(), fanout=fanout,
            clock=lambda: clock["t"], post=post)
    for i in range(n):
        agents[f"r{i}"].set_peers([f"r{j}" for j in range(n) if j != i])
    return agents, clock


def test_price_book_converges_within_bounded_rounds():
    def run(P):
        n, fanout = 4, 1
        agents, clock = _mesh(P, n, fanout)
        ctl0 = agents["r0"].admission
        digest, _, _ = ctl0.price("g.V().out('x').count()")
        ctl0.observe_cost(digest, "g.V().out('x').count()", 250.0)
        reached = []
        for _ in range(-(-(n - 1) // fanout) + 1):
            clock["t"] += 1.0
            reached.append([agents[name].tick() for name in sorted(agents)])
        return digest, reached, {name: a.admission.price_book.mean_cost_ms(digest)
                                 for name, a in agents.items()}

    ref, port = _both(run)
    assert port == ref
    assert all(v == pytest.approx(250.0) for v in port[2].values())


def test_local_measurements_win_over_gossip():
    def run(P):
        agents, _ = _mesh(P, 2)
        a, b = agents["r0"], agents["r1"]
        d, _, _ = a.admission.price("g.V().count()")
        a.admission.observe_cost(d, "g.V().count()", 100.0)
        b.admission.observe_cost(d, "g.V().count()", 5.0)
        a.tick()
        b.tick()
        return b.admission.price_book.mean_cost_ms(d), a.admission.price_book.mean_cost_ms(d)

    ref, port = _both(run)
    assert port == ref and port[0] == pytest.approx(5.0)


def test_brownout_rung_propagates_to_peer_state():
    def run(P):
        agents, clock = _mesh(P, 3, fanout=2)
        agents["r0"].admission.brownout.rung = 2
        clock["t"] = 7.0
        agents["r0"].tick()
        return {name: {k: v for k, v in agents[name].peer_state.get("r0", {}).items() if k != "seq"}
                for name in ("r1", "r2")}

    ref, port = _both(run)
    assert port == ref == {"r1": {"rung": 2, "ts": 7.0}, "r2": {"rung": 2, "ts": 7.0}}


def _gossip_pair(P, Q, mgr):
    """A server of package P and one of package Q over their own graphs,
    each with a gossip agent of its own package wired to the other."""
    g1 = P.Graph(dict(BASE_CFG), store_manager=mgr(P))
    _seed_graph(g1, n=4)
    g2 = Q.Graph(dict(BASE_CFG), store_manager=mgr(Q))
    s1, s2 = _served(P, g1, replica_name="r0"), _served(Q, g2, replica_name="r1")
    a1 = P.fleet.StateGossip("r0", s1.admission, timeout_s=10.0)
    a2 = Q.fleet.StateGossip("r1", s2.admission, timeout_s=10.0)
    s1.gossip, s2.gossip = a1, a2
    a1.set_peers([f"http://127.0.0.1:{s2.port}"])
    a2.set_peers([f"http://127.0.0.1:{s1.port}"])
    return (g1, g2), (s1, s2), (a1, a2)


@pytest.mark.parametrize("pair", ["port-port", "port-ref", "ref-port"])
def test_gossip_over_http_endpoint(pair):
    P, Q = {"port": PORT, "ref": REF}[pair.split("-")[0]], {"port": PORT, "ref": REF}[pair.split("-")[1]]
    shared = {}
    graphs, servers, agents = _gossip_pair(P, Q, lambda X: shared.setdefault(X.name, X.Mgr()))
    try:
        d, _, _ = servers[0].admission.price("g.V().both().count()")
        assert d == servers[1].admission.price("g.V().both().count()")[0]
        servers[0].admission.observe_cost(d, "g.V().both().count()", 99.0)
        servers[1].admission.brownout.rung = 1
        assert agents[0].tick() == 1
        assert servers[1].admission.price_book.mean_cost_ms(d) == pytest.approx(99.0)
        # the pull half: the peer's answer lands in the sender's peer_state
        assert agents[0].peer_state["r1"]["rung"] == 1
        assert agents[1].peer_state["r0"]["rung"] == 0
        # and /healthz shows the agent's peers
        assert _healthz(servers[0].port)["fleet_peers"]["r1"]["rung"] == 1
    finally:
        for s in servers:
            s.stop()
        for g in graphs:
            g.close()


# -------------------------------------------------------------------- warm-up

def _warm_cfg(P):
    return dict(BASE_CFG, **{"computer.delta": True, "metrics.enabled": True}, **P.olap_cfg)


def _assert_csr_equal(a, b):
    for f in ("vertex_ids", "out_indptr", "out_dst", "in_indptr", "in_src", "out_degree",
              "labels", "out_edge_type", "in_edge_type"):
        x, y = getattr(a, f), getattr(b, f)
        assert (x is None) == (y is None), f
        if x is not None:
            assert x.dtype == y.dtype and x.tobytes() == y.tobytes(), f


@pytest.mark.parametrize("exporter", ["ref", "port"])
def test_warmup_byte_identical_and_zero_edgestore_reads(tmp_path, exporter):
    """A port replica warmed from either package's export: its snapshot
    equals a storage re-scan byte for byte, with zero edgestore reads."""
    E = {"ref": REF, "port": PORT}[exporter]
    emgr = E.Mgr()
    g1 = E.Graph(_warm_cfg(E), store_manager=emgr)
    _seed_graph(g1, n=64)
    info = E.fleet.export_snapshot(g1, str(tmp_path), num_shards=3)
    assert (info["rows"], info["shards"], info["source"]) == (64, 3, "cold")
    g1.close()
    # the port replica opens the same rows in its own store manager
    rows = {name: {k: list(zip(r.columns, r.values)) for k, r in st._rows.items()}
            for name, st in emgr._stores.items()}
    g2 = PORT.Graph(_warm_cfg(PORT), store_manager=PORT.Mgr.from_rows(rows))
    try:
        PORT.obs.registry.reset()
        assert port_fleet.warm_replica(g2, str(tmp_path), replica="r1") is True
        assert _edgestore_touched(PORT) == [], "warm path touched storage"
        assert PORT.obs.registry.get_count("fleet.warmup.hits") == 1
        ev = PORT.obs.flight_recorder.events("fleet")[-1]
        assert (ev["action"], ev["source"], ev["replica"], ev["rows"]) == (
            "warmup", "shard-checkpoint", "r1", 64)
        _assert_csr_equal(port_delta.get_snapshot(g2).csr, port_csr.load_csr_snapshot(g2)[0])
    finally:
        g2.close()


def _warm_submit(P, tmp_path, program):
    mgr = P.Mgr()
    g1 = P.Graph(_warm_cfg(P), store_manager=mgr)
    ids = _seed_graph(g1, n=48)
    P.fleet.export_snapshot(g1, str(tmp_path / P.name))
    leader = g1.compute(executor=P.warm_executor).program(program()).submit()
    g2 = P.Graph(_warm_cfg(P), store_manager=mgr)
    try:
        assert P.fleet.warm_replica(g2, str(tmp_path / P.name))
        P.obs.registry.reset()
        warm = g2.compute(executor=P.warm_executor).program(program()).submit()
        assert _edgestore_touched(P) == []
        return leader, warm, ids
    finally:
        g1.close()
        g2.close()


def test_warm_submit_after_warmup_skips_the_scan(tmp_path):
    (rl, rw, rids), (pl, pw, pids) = _both(
        lambda P: _warm_submit(P, tmp_path, lambda: P.PageRank(max_iterations=4)))
    assert rids == pids
    assert pw.run_info["snapshot"]["path"] == "warm"
    np.testing.assert_array_equal(np.asarray(pw.states["rank"]), np.asarray(pl.states["rank"]))
    np.testing.assert_array_equal(np.asarray(rw.states["rank"]), np.asarray(rl.states["rank"]))
    np.testing.assert_allclose(np.asarray(pw.states["rank"]), np.asarray(rw.states["rank"]), rtol=1e-6)
    np.testing.assert_array_equal(pw.csr.vertex_ids, rw.csr.vertex_ids)


def test_the_pack_carries_no_weights_or_properties(tmp_path):
    """The CSR pack holds the topology, labels and edge types only, in both
    packages: a warmed replica's snapshot has no edge weights and no
    property columns (reference behaviour, kept)."""
    def run(P):
        mgr = P.Mgr()
        g1 = P.Graph(_warm_cfg(P), store_manager=mgr)
        g1.management().make_property_key("w", float)
        g1.management().make_edge_label("knows")
        tx = g1.new_transaction()
        vs = [tx.add_vertex(name=f"v{i}") for i in range(12)]
        for i in range(12):
            tx.add_edge(vs[i], "knows", vs[(i * 7 + 1) % 12], w=0.5 + i)
        tx.commit()
        csr, epoch = P.csr.load_csr_snapshot(g1, weight_key="w", property_keys=("name",))
        P.delta.get_snapshot(g1).adopt(csr, epoch)
        assert csr.out_edge_weight is not None and csr.properties is not None
        P.fleet.export_snapshot(g1, str(tmp_path / P.name))
        g2 = P.Graph(_warm_cfg(P), store_manager=mgr)
        try:
            assert P.fleet.warm_replica(g2, str(tmp_path / P.name))
            warm = P.delta.get_snapshot(g2).csr
            return (warm.out_edge_weight is None, warm.in_edge_weight is None,
                    not warm.properties, warm.num_edges)
        finally:
            g1.close()
            g2.close()

    ref, port = _both(run)
    assert port == ref == (True, True, True, 12)


def test_torn_manifest_falls_back_to_prev(tmp_path):
    def run(P):
        g1 = P.Graph(_warm_cfg(P), store_manager=P.Mgr())
        _seed_graph(g1, n=16)
        d = tmp_path / P.name
        P.fleet.export_snapshot(g1, str(d), num_shards=2)
        P.fleet.export_snapshot(g1, str(d), num_shards=2)
        (d / "manifest.json").write_text('{"torn":')
        g2 = P.Graph(_warm_cfg(P), store_manager=g1.backend.manager)
        try:
            assert P.fleet.warm_replica(g2, str(d))
            return P.delta.get_snapshot(g2).csr.num_vertices, P.obs.registry.get_count(
                "olap.checkpoint.manifest_fallback")
        finally:
            g1.close()
            g2.close()

    ref, port = _both(run)
    assert port == ref == (16, 1)


def test_warmup_without_files_is_a_clean_miss(tmp_path):
    def run(P):
        g = P.Graph(_warm_cfg(P), store_manager=P.Mgr())
        _seed_graph(g, n=4)
        try:
            return P.fleet.warm_replica(g, str(tmp_path / "nope")), P.obs.registry.get_count(
                "fleet.warmup.misses")
        finally:
            g.close()

    ref, port = _both(run)
    assert port == ref == (False, 1)


def test_the_delta_pack_is_the_warmup_fallback(tmp_path):
    def run(P):
        pack = str(tmp_path / P.name / "snap.npz")
        cfg = dict(_warm_cfg(P), **{"computer.delta-snapshot-path": pack})
        g1 = P.Graph(cfg, store_manager=P.Mgr())
        _seed_graph(g1, n=10)
        csr, epoch = P.csr.load_csr_snapshot(g1)
        P.delta.save_snapshot(pack, csr, epoch)
        g2 = P.Graph(cfg, store_manager=g1.backend.manager)
        try:
            assert P.fleet.warm_replica(g2, str(tmp_path / "none"))
            return P.obs.flight_recorder.events("fleet")[-1]["source"], P.delta.get_snapshot(g2).csr.num_edges
        finally:
            g1.close()
            g2.close()

    ref, port = _both(run)
    assert port == ref == ("delta-pack", 10)


def test_export_needs_the_delta_machinery(tmp_path):
    for P in BOTH:
        g = P.Graph(dict(BASE_CFG, **{"computer.delta": False}), store_manager=P.Mgr())
        try:
            with pytest.raises(ValueError, match="computer.delta"):
                P.fleet.export_snapshot(g, str(tmp_path))
            assert P.fleet.warm_replica(g, str(tmp_path)) is False
        finally:
            g.close()


# --------------------------------------------------------- executor cache

def _cache_graph(P):
    return P.Graph(dict(BASE_CFG, **{"computer.delta": True}, **P.olap_cfg), store_manager=P.Mgr())


def test_warm_submits_reuse_the_executor():
    def run(P):
        g = _cache_graph(P)
        ids = _seed_graph(g, n=40)
        try:
            r1 = g.compute(executor=P.warm_executor).program(P.PageRank(max_iterations=3)).submit()
            hits0 = P.obs.registry.get_count("olap.executor.cache_hits")
            r2 = g.compute(executor=P.warm_executor).program(P.PageRank(max_iterations=3)).submit()
            hits1 = P.obs.registry.get_count("olap.executor.cache_hits") - hits0
            tx = g.new_transaction()
            tx.add_edge(tx.get_vertex(ids[0]), "knows", tx.get_vertex(ids[9]))
            tx.commit()
            r3 = g.compute(executor=P.warm_executor).program(P.PageRank(max_iterations=3)).submit()
            hits2 = P.obs.registry.get_count("olap.executor.cache_hits") - hits0
            assert np.array_equal(np.asarray(r1.states["rank"]), np.asarray(r2.states["rank"]))
            return hits1, hits2, r3.run_info.get("delta", {}).get("fused"), np.asarray(r3.states["rank"])
        finally:
            g.close()

    ref, port = _both(run)
    assert port[:3] == ref[:3] == (1, 2, True)
    np.testing.assert_allclose(port[3], ref[3], rtol=1e-6)


def test_fused_results_match_fresh_executor():
    def run(P):
        g = _cache_graph(P)
        ids = _seed_graph(g, n=32)
        g.compute(executor=P.warm_executor).program(P.Degree()).submit()
        tx = g.new_transaction()
        tx.add_edge(tx.get_vertex(ids[2]), "knows", tx.get_vertex(ids[3]))
        tx.commit()
        warm = g.compute(executor=P.warm_executor).program(P.Degree()).submit()
        g2 = P.Graph(dict(BASE_CFG, **P.olap_cfg), store_manager=g.backend.manager)
        cold = g2.compute(executor="cpu").program(P.Degree()).submit()
        try:
            assert warm.by_vertex("out_degree") == cold.by_vertex("out_degree")
            return {int(k): float(v) for k, v in warm.by_vertex("out_degree").items()}
        finally:
            g.close()
            g2.close()

    ref, port = _both(run)
    assert port == ref


def test_compaction_invalidates_the_cache():
    def run(P):
        g = _cache_graph(P)
        _seed_graph(g, n=16)
        try:
            g.compute(executor=P.warm_executor).program(P.Degree()).submit()
            snap = P.delta.get_snapshot(g)
            gen, key = snap.generation, next(iter(snap._executors))
            snap.adopt(snap.csr, snap.epoch)
            return snap.generation - gen, snap.cached_executor(key) is None
        finally:
            g.close()

    ref, port = _both(run)
    assert port == ref == (1, True)


# --------------------------------------------------------- fleet fault kinds

def _journal(plan):
    return json.dumps(plan.journal, sort_keys=True)


def test_kill_and_restart_fire_once_at_scheduled_ticks():
    def run(P):
        plan = P.FaultPlan(seed=7, replica_kill_at=3, replica_restart_at=6)
        events = []
        for _ in range(10):
            events.extend(plan.fleet_hook(3))
        assert all(e["replica"] == plan.replica_target(3) for e in events)
        return [e["kind"] for e in events], _journal(plan)

    ref, port = _both(run)
    assert port == ref and port[0] == ["replica_kill", "replica_restart"]


def test_same_seed_reproduces_the_journal():
    def run(P, seed):
        plan = P.FaultPlan(seed=seed, replica_kill_at=2, replica_restart_at=5)
        for _ in range(8):
            plan.fleet_hook(3)
        return _journal(plan)

    assert run(PORT, 11) == run(PORT, 11) == run(REF, 11)
    targets = [PORT.FaultPlan(seed=s).replica_target(5) for s in range(32)]
    assert targets == [REF.FaultPlan(seed=s).replica_target(5) for s in range(32)]
    assert len(set(targets)) > 1


def test_explicit_target_overrides_hash():
    assert PORT.FaultPlan(seed=1, replica_target=2).replica_target(3) == 2
    assert REF.FaultPlan(seed=1, replica_target=2).replica_target(3) == 2


def test_partition_window_fails_storage_on_target_only():
    def run(P):
        def mk(index):
            plan = P.FaultPlan(seed=3, replica_partition_at=2, replica_partition_ops=4, replica_target=1)
            plan.arm_replica(index, 3)
            return plan

        target, other = mk(1), mk(0)
        failures = []
        for n in range(10):
            try:
                target.before_read("edgestore")
            except P.InjectedFaultError:
                failures.append(n)
            other.before_read("edgestore")
        assert other.journal == []
        return failures, _journal(target)

    ref, port = _both(run)
    assert port == ref and port[0] == [2, 3, 4, 5]


def test_from_config_reads_the_new_keys():
    keys = {
        "storage.faults.enabled": True,
        "storage.faults.replica-kill-at": 5,
        "storage.faults.replica-restart-at": 9,
        "storage.faults.replica-partition-at": 2,
        "storage.faults.replica-partition-ops": 3,
        "storage.faults.replica-target": 1,
        "storage.faults.follower-lag-at": 4,
        "storage.faults.follower-lag-pulls": 2,
    }

    def run(P):
        g = P.Graph(dict(BASE_CFG, **keys), store_manager=P.Mgr())
        try:
            plan = g.fault_plan
            return (plan.replica_kill_at, plan.replica_restart_at, plan.replica_partition_at,
                    plan.replica_partition_ops, plan.replica_target(4), plan.follower_lag_at,
                    plan.follower_lag_pulls)
        finally:
            g.close()

    ref, port = _both(run)
    assert port == ref == (5, 9, 2, 3, 1, 4, 2)


# ----------------------------------------------------------- replica identity

def test_flight_logs_and_metrics_carry_the_tag():
    def run(P):
        P.obs.set_replica("replica-9")
        try:
            event = P.obs.flight_recorder.record("fleet", action="test")
            P.obs.get_logger("test.fleet").info("tagged-record")
            rec = [r for r in P.logging.recent() if r["event"] == "tagged-record"][-1]
            text = P.obs.prometheus_text(P.obs.registry)
            tagged = (event["replica"], rec["replica"],
                      'janusgraph_replica_info{replica="replica_9"} 1' in text)
        finally:
            P.obs.set_replica("")
        return tagged, "replica" in P.obs.flight_recorder.record("fleet", action="test2")

    ref, port = _both(run)
    assert port == ref == (("replica-9", "replica-9", True), False)


def test_fleet_healthz_quorum_aggregation():
    def run(P):
        r = _ring(P, 16, ["r0", "r1", "r2"])
        statuses = [r.healthz()["status"]]
        r.mark_dead("r0")
        statuses.append(r.healthz()["status"])
        r.replicas()["r1"].health = {"status": "degraded"}
        payload = r.healthz()
        statuses.append(payload["status"])
        dumps = [e for e in P.obs.flight_recorder.events("fleet") if e.get("action") == "quorum_degraded"]
        return statuses, payload["quorum_bad"], payload["serving"], payload["replicas"]["r0"]["state"], len(dumps)

    ref, port = _both(run)
    assert port == ref == (["ok", "ok", "degraded"], 2, 2, port_fleet.DEAD, 1)


# ------------------------------------------------------------- the chaos cell

def test_kill_one_replica_mid_traffic():
    """Three port replicas over one store; kill one mid-traffic. Zero
    errors surface to well-budgeted callers, every worker finishes, the
    corpse is marked dead and the others keep serving (requests complete
    after the kill)."""
    mgr = PortMgr()
    graphs = [PortGraph(dict(BASE_CFG), store_manager=mgr) for _ in range(3)]
    ids = _seed_graph(graphs[0], n=48)
    router = port_fleet.FleetRouter(retry_budget_capacity=1e6, retry_budget_refill_per_s=1e6,
                                    backoff_base_s=0.002, backoff_max_s=0.02)
    servers = {}
    for i, g in enumerate(graphs):
        servers[f"r{i}"] = _served(PORT, g, replica_name=f"r{i}")
        router.add_replica(f"r{i}", "127.0.0.1", servers[f"r{i}"].port)
    router.probe()
    router.start_probes(interval_s=0.2)
    stop, lock = threading.Event(), threading.Lock()
    ok_times, errors = [], []

    def _worker(w):
        rng = w * 97 + 13
        while not stop.is_set():
            rng = (rng * 1103515245 + 12345) & 0x7FFFFFFF
            vid = ids[rng % len(ids)]
            try:
                got = router.submit(f"g.V({vid}).out('knows').count()", deadline_ms=30_000, key=str(vid))
                with lock:
                    ok_times.append((time.monotonic(), got))
            except Exception as e:  # noqa: BLE001 - any surfaced error fails the cell
                with lock:
                    errors.append(f"{type(e).__name__}: {e}")

    threads = [threading.Thread(target=_worker, args=(w,)) for w in range(4)]
    for th in threads:
        th.start()
    try:
        time.sleep(1.0)
        t_kill = time.monotonic()
        servers["r1"].stop()
        time.sleep(2.0)
    finally:
        stop.set()
        for th in threads:
            th.join(timeout=30.0)
        hung = sum(1 for th in threads if th.is_alive())
        router.stop()
        for name, s in servers.items():
            if name != "r1":
                s.stop()
        for g in graphs:
            g.close()
    assert errors == [], f"errors surfaced to budgeted callers: {errors[:3]}"
    assert hung == 0
    assert all(got == 1 for _t, got in ok_times)
    assert any(t < t_kill for t, _ in ok_times) and any(t > t_kill + 0.6 for t, _ in ok_times)
    assert router.replicas()["r1"].state == port_fleet.DEAD
    assert router.replicas()["r0"].state == port_fleet.SERVING
    assert any(e.get("action") == "dead" and e.get("replica") == "r1"
               for e in port_obs.flight_recorder.events("fleet"))


# ---------------------------------------------------------------- frontend

def test_frontend_routes_and_serves_fleet_healthz():
    def run(P):
        graph = P.Graph(dict(BASE_CFG), store_manager=P.Mgr())
        ids = _seed_graph(graph, n=8)
        server = _served(P, graph)
        router = P.fleet.FleetRouter()
        router.add_replica("r0", "127.0.0.1", server.port)
        router.probe()
        frontend = P.fleet.FleetFrontend(router).start()
        base = f"http://127.0.0.1:{frontend.port}"
        try:
            body = json.dumps({"gremlin": f"g.V({ids[0]}).out('knows').count()"}).encode()
            req = urllib.request.Request(base + "/gremlin", data=body, method="POST",
                                         headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=30) as resp:
                payload = json.loads(resp.read())
            health = json.loads(urllib.request.urlopen(base + "/healthz", timeout=10).read())
            assign = json.loads(urllib.request.urlopen(base + "/assign?session=s1", timeout=10).read())
            assert assign["port"] == server.port
            codes = []
            for path in ("/assign", "/fleet/metrics", "/nothing"):
                try:
                    urllib.request.urlopen(base + path, timeout=10)
                except urllib.error.HTTPError as e:
                    codes.append(e.code)
            # the driver through the frontend, and a caller error surfacing
            client = P.driver.JanusGraphClient(port=frontend.port, http_timeout_s=30)
            count = client.submit(f"g.V({ids[1]}).count()")
            with pytest.raises(P.RemoteError):
                client.submit("g.V().nope()")
            return (payload["status"]["code"], payload["result"], health["status"],
                    sorted(health["replicas"]), assign["replica"], codes, count)
        finally:
            frontend.stop()
            router.stop()
            server.stop()
            graph.close()

    ref, port = _both(run)
    assert port == ref
    assert port[0] == 200 and port[2] == "ok" and port[3] == ["r0"] and port[5] == [400, 404, 404]


def test_the_callers_deadline_reaches_the_replica():
    """The frontend reads X-Deadline-Ms and the router sizes every hop from
    the remaining budget: the replica sees the caller's deadline, and a
    served request is one route attempt."""
    graph = PortGraph(dict(BASE_CFG), store_manager=PortMgr())
    _seed_graph(graph, n=8)
    server = _served(PORT, graph, replica_name="r0")
    seen = []
    router = port_fleet.FleetRouter()
    real = router._call
    router._call = lambda h, q, g, d: (seen.append(d), real(h, q, g, d))[1]
    router.add_replica("r0", "127.0.0.1", server.port)
    frontend = port_fleet.FleetFrontend(router).start()
    try:
        client = port_driver.JanusGraphClient(port=frontend.port, http_timeout_s=30)
        assert client.submit("g.V().count()", deadline_ms=600_000.0) == 8
        assert len(seen) == 1 and 500_000.0 < seen[0] <= 600_000.0
        route = port_obs.tracer.recent("fleet.route")[-1]
        assert (route.attrs.get("verdict"), route.attrs.get("attempts"), route.attrs.get("replica")) == (
            "ok", 1, "r0")
        assert client.submit("g.V().count()") == 8
        assert seen[-1] is None
    finally:
        frontend.stop()
        router.stop()
        server.stop()
        graph.close()
