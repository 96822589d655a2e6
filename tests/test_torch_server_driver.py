"""The port's query server and driver held to the JAX package's (after the
reference's ``tests/test_server_driver.py``).

The Graph of the Gods is loaded into a reference graph behind the
reference's ``JanusGraphServer`` and into a port graph (``computer.executor``
"cpu") behind the port's. The same requests go to both over HTTP:

- read queries (the reference suite's HTTP, WebSocket, predicate,
  typed-vertex, anonymous-traversal, dialect and multi-graph queries, and a
  seeded set of step chains in both spellings): the response bodies are
  equal as GraphSON once the trace id is dropped, and the ledger's walls
  and host-to-device byte counts (each executor ships its own argument
  set: the port's segment plan, the reference's XLA operands);
- the computer steps (``pageRank()``/``page_rank()`` top 3 by name,
  ``connectedComponent()``/``connected_component()``): equal bodies; the
  ranks themselves within a relative 1e-6 (PageRank at damping 0.85 over a
  graph with dangling vertices sums in another order in each package, as
  ``tests/test_torch_fused.py`` explains; the names are equal exactly);
- writes (``addV``, the coalesce upsert, ``mergeV``, a failing request's
  rollback) in sequence on fresh graphs: equal bodies, ids included;
- hostile requests: the same HTTP status and the same body status code
  and message from both sandboxes; auth: 401 without credentials, Basic
  and token requests served, in both;
- each package's client against the other's server, HTTP and WebSocket,
  and a session's write read back after its ``g.commit()`` and not before;
- GraphBinary: the same bytes from ``binary_dumps`` in both packages, each
  package decoding the other's;
- ``/healthz``, ``/metrics``, ``/telemetry``, ``/watch/info`` and
  ``/gossip``: the same keys and status codes;
- the ``server`` subcommand and the price book across packages.

Every server binds port 0 and is stopped by a fixture finaliser; every
HTTP call and socket read has a timeout.
"""

import datetime
import json
import random
import re
import subprocess
import sys
import urllib.error
import urllib.request
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

from janusgraph_tpu import driver as ref_driver
from janusgraph_tpu import server as ref_server
from janusgraph_tpu.core import attributes as ref_attributes
from janusgraph_tpu.core import codecs as ref_codecs
from janusgraph_tpu.core import gods as ref_gods
from janusgraph_tpu.core import predicates as ref_predicates
from janusgraph_tpu.core.graph import open_graph as ref_open_graph
from janusgraph_tpu.driver import client as ref_client
from janusgraph_tpu.observability import profiler as ref_profiler
from janusgraph_tpu.observability import registry as ref_registry
from janusgraph_tpu.server import admission as ref_admission
from janusgraph_tpu.server import auth as ref_auth
from janusgraph_tpu_torch import driver
from janusgraph_tpu_torch import server
from janusgraph_tpu_torch.core import attributes, codecs, gods, predicates
from janusgraph_tpu_torch.core.graph import open_graph
from janusgraph_tpu_torch.driver import client
from janusgraph_tpu_torch.observability import profiler, registry
from janusgraph_tpu_torch.server import admission, auth

ROOT = Path(__file__).resolve().parents[1]
TIMEOUT_S = 60.0
RANK_RTOL = 1e-6

#: the reference runs its single-device executor on JAX's CPU backend
REF_CONFIG = {"ids.authority-wait-ms": 0.0, "computer.sharded-auto": False,
              "computer.delta": False}
PORT_CONFIG = {"ids.authority-wait-ms": 0.0, "computer.executor": "cpu"}

REF = SimpleNamespace(
    name="ref", open_graph=ref_open_graph, gods=ref_gods, config=REF_CONFIG,
    Manager=ref_server.JanusGraphManager, Server=ref_server.JanusGraphServer,
    Client=ref_driver.JanusGraphClient, RemoteError=ref_client.RemoteError,
    Creds=ref_server.CredentialsAuthenticator, HMAC=ref_server.HMACAuthenticator,
)
PORT = SimpleNamespace(
    name="port", open_graph=open_graph, gods=gods, config=PORT_CONFIG,
    Manager=server.JanusGraphManager, Server=server.JanusGraphServer,
    Client=driver.JanusGraphClient, RemoteError=client.RemoteError,
    Creds=server.CredentialsAuthenticator, HMAC=server.HMACAuthenticator,
)


def _gods_graph(pkg):
    g = pkg.open_graph(dict(pkg.config))
    pkg.gods.load(g)
    return g


def _serve(pkg, graphs, **kw):
    """A manager over ``graphs`` ({name: graph}) and a started server."""
    m = pkg.Manager()
    for name, g in graphs.items():
        m.put_graph(name, g)
    return pkg.Server(manager=m, **kw).start()


def _solo_graph(pkg):
    g = pkg.open_graph(dict(pkg.config))
    g.management().make_property_key("name", str)
    src = g.traversal()
    src.add_v().property("name", "solo")
    src.commit()
    return g


@pytest.fixture(scope="module")
def served():
    """The Gods (and a one-vertex graph "other") behind a server of each
    package: {"ref": (server, graph), "port": (server, graph)}."""
    out, opened = {}, []
    try:
        for pkg in (REF, PORT):
            g, other = _gods_graph(pkg), _solo_graph(pkg)
            opened += [g, other]
            out[pkg.name] = (_serve(pkg, {"graph": g, "other": other}), g)
        yield out
    finally:
        for s, _g in out.values():
            s.stop()
        for g in opened:
            g.close()


@pytest.fixture
def fresh():
    """A fresh Gods graph behind a server of each package, per test."""
    out = {}
    try:
        for pkg in (REF, PORT):
            g = _gods_graph(pkg)
            out[pkg.name] = (_serve(pkg, {"graph": g}), g)
        yield out
    finally:
        for s, g in out.values():
            s.stop()
            g.close()


def post(port, query, path="/gremlin", **fields):
    """POST one request: (HTTP status, body)."""
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}",
        data=json.dumps({"gremlin": query, **fields}).encode(),
        headers={"Content-Type": "application/json"},
    )
    try:
        with urllib.request.urlopen(req, timeout=TIMEOUT_S) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"null")


def get(port, path):
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=TIMEOUT_S) as r:
            return r.status, r.headers.get("Content-Type"), r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers.get("Content-Type"), e.read()


def normal(body):
    """The body without what differs by design: the trace id, and the
    ledger's walls and transfer bytes."""
    body = json.loads(json.dumps(body))
    status = body.get("status", {})
    status.pop("trace", None)
    led = status.get("ledger")
    if led is not None:
        for k in ("wall_ms_by_layer", "h2d_bytes", "d2h_bytes"):
            led.pop(k, None)
        if not led:
            status.pop("ledger")
    return body


def both(served_pair, query, **fields):
    ref_s, port_s = served_pair["ref"][0], served_pair["port"][0]
    return post(ref_s.port, query, **fields), post(port_s.port, query, **fields)


#: read queries of the reference suite (HTTP, WebSocket, predicates, typed
#: vertices, anonymous bodies, the dialect, element maps, multi-graph)
READ_QUERIES = [
    "g.V().has('name', 'saturn').in_('father').values('name')",
    "g.V().count()",
    "g.V().has('age', P.gt(100)).values('name')",
    "g.V().has('name', 'saturn')",
    "g.V().has('name','jupiter').out('brother').values('name')",
    "g.V().has('name','hercules').repeat(__.out('father'), times=2).values('name').to_list()",
    "g.V().has('name','hercules').union(__.out('father'), __.out('mother')).values('name')",
    "g.V().has('name','hercules').coalesce(__.out('pet'), __.out('father')).values('name')",
    "g.V().where(__.out('battled')).values('name').to_list()",
    "g.V().has('name','hercules').repeat(__.out('father'), until=__.not_(__.out('father')))"
    ".values('name')",
    "g.V().has('name','hercules').outE('battled').inV().values('name')",
    "g.V().as('a').out('father').in('father').where(neq('a')).count()",
    "g.V().hasLabel('titan').values('name')",
    "g.V().has('age', gt(3000)).values('name')",
    "g.V().has('name','hercules').outE('battled').elementMap().limit(1)",
    "g.V().has('name', 'outE').count()",
    "g.V().has('name','hercules').out_e('battled').in_v().count()",
    "g.V().where(out('father')).values('name')",
    "g.V().has('name','hercules').where(not(out('mother'))).count()",
    "g.V().has('reason', textContainsPhrase('loves waves')).count()",
    "g.V().hasLabel('god').has('age', gt(4000)).values('name')",
    "g.V().has('name','hercules').project('name', 'battles').by('name')"
    ".by(__.out('battled').count_())",
    "g.V().has('name','hercules').outE('battled').values('time')",
    "g.V().has_label('god').values('age').order()",
    "g_other.V().values('name')",
]

#: (gremlin spelling, python spelling) of the reference's fuzz pool
_STEPS = [
    ("out('{0}')", "out('{0}')"),
    ("in('{0}')", "in_('{0}')"),
    ("both('{0}')", "both('{0}')"),
    ("outE('{0}').inV()", "out_e('{0}').in_v()"),
    ("inE('{0}').outV()", "in_e('{0}').out_v()"),
    ("hasLabel('god')", "has_label('god')"),
    ("has('age', gt(100))", "has('age', P.gt(100))"),
    ("hasNot('age')", "has_not('age')"),
    ("simplePath()", "simple_path()"),
    ("dedup()", "dedup()"),
    ("limit(5)", "limit(5)"),
    ("where(out('{0}'))", "where(__.out('{0}'))"),
    ("repeat(out('{0}')).times(2)", "repeat(__.out('{0}'), times=2)"),
    ("order().by('age')", "order('age')"),
]


def _chains(n=16, seed=20260731):
    rng = random.Random(seed)
    labels = ["father", "brother", "battled", "lives", "pet", "mother"]
    out = []
    for _ in range(n):
        chain = rng.sample(_STEPS, rng.randint(1, 4))
        lbls = [rng.choice(labels) for _ in chain]
        out.append(tuple(
            "g.V()." + ".".join(s[k].format(lbl) for s, lbl in zip(chain, lbls))
            + ".values('name')" for k in (0, 1)))
    return out


CHAINS = _chains()


@pytest.mark.parametrize("query", READ_QUERIES)
def test_read_query_bodies_equal(served, query):
    (rc, rbody), (pc, pbody) = both(served, query)
    assert rc == pc == 200
    assert rbody["status"]["code"] == 200, rbody
    assert normal(pbody) == normal(rbody)


@pytest.mark.parametrize("i", range(len(CHAINS)))
def test_step_chains_equal_in_both_spellings_and_packages(served, i):
    gremlin, python = CHAINS[i]
    bodies = [normal(b) for _c, b in both(served, gremlin) + both(served, python)]
    assert bodies[0]["status"]["code"] == 200, bodies[0]
    assert bodies[1] == bodies[0]
    # the dialect's two spellings give the same elements (orders may differ
    # where no step orders them)
    p_g, p_p = bodies[1]["result"]["data"], bodies[3]["result"]["data"]
    assert sorted(p_g["@value"]) == sorted(p_p["@value"])
    assert bodies[3] == bodies[2]


@pytest.mark.parametrize("query", [
    "g.V().pageRank().order().by('pagerank', reverse=True).limit(3).values('name')",
    "g.V().page_rank().order('pagerank', reverse=True).limit(3).values('name')",
    "g.V().connectedComponent().values('component')",
    "g.V().connected_component().values('component')",
])
def test_computer_step_bodies_equal(served, query):
    (rc, rbody), (pc, pbody) = both(served, query)
    assert rc == pc == 200 and pbody["status"]["code"] == 200, pbody
    assert normal(pbody) == normal(rbody)


def test_both_spellings_of_the_computer_steps_agree(served):
    port = served["port"][0].port
    a = post(port, "g.V().pageRank().order().by('pagerank', reverse=True).limit(3)"
                   ".values('name')")[1]["result"]
    b = post(port, "g.V().page_rank().order('pagerank', reverse=True).limit(3)"
                   ".values('name')")[1]["result"]
    assert a == b and len(a["data"]["@value"]) == 3


def test_page_rank_values_within_1e_6_of_the_reference(served):
    q = ("g.V().pageRank().order().by('pagerank', reverse=True)"
         ".project('id', 'pagerank').by(id()).by('pagerank')")
    (_rc, rbody), (_pc, pbody) = both(served, q)

    def pairs(body):
        rows = driver.graphson_loads(json.dumps(body["result"]["data"]))
        return [r["id"] for r in rows], np.array([r["pagerank"] for r in rows])

    rids, rranks = pairs(rbody)
    pids, pranks = pairs(pbody)
    assert len(pids) == 12 and pids == rids
    np.testing.assert_allclose(pranks, rranks, rtol=RANK_RTOL, atol=0)


#: writes in sequence on fresh graphs: each body (new vertex ids included)
#: equal in both packages
WRITES = [
    "g.addV('person').property('name','marko').values('name')",
    "g.V().has('name','marko').count()",
    "g.addV('person').property('name','ada')",
    "g.V().has('name','nosuch').fold().coalesce(__.unfold(), __.addV('person')).label()",
    "g.V().has('name','hercules').fold().coalesce(__.unfold(), __.addV('person'))"
    ".values('name')",
    "g.mergeV({T.label: 'god', 'name': 'fortuna'}).onCreate({'age': 7}).iterate()",
    "g.V().has('name','fortuna').values('age')",
    "g.mergeV({T.label: 'god', 'name': 'fortuna'}).iterate()",
    "g.V().has('name','fortuna').count()",
    "g.addV('person').property('name','ghost').out('nothing').next()",
    "g.V().has('name','ghost').count()",
    "g.V().hasLabel('person').elementMap()",
]


def test_write_sequence_bodies_equal(fresh):
    for q in WRITES:
        (rc, rbody), (pc, pbody) = both(fresh, q)
        assert rc == pc, q
        assert normal(pbody) == normal(rbody), q


def test_read_only_endpoint_rolls_back_in_both():
    for pkg in (REF, PORT):
        g = _gods_graph(pkg)
        s = _serve(pkg, {"graph": g}, auto_commit=False)
        try:
            post(s.port, "g.addV('person').property('name','volatile').iterate()")
            code, body = post(s.port, "g.V().has('name','volatile').count()")
            assert body["result"]["data"] == {"@type": "g:Int64", "@value": 0}, pkg.name
        finally:
            s.stop()
            g.close()


#: requests both sandboxes must refuse
HOSTILE = [
    "__import__('os').system('true')",
    "().__class__.__base__.__subclasses__()",
    "g.__init__.__globals__",
    "[c for c in [1]]",
    "(lambda: 1)()",
    "g.V().to_list().__len__()",
    "g.V().nonexistent_step()",
    "open('/etc/passwd')",
    "g.V(",
]


@pytest.mark.parametrize("query", HOSTILE)
def test_hostile_requests_refused_alike(served, query):
    (rc, rbody), (pc, pbody) = both(served, query)
    assert rc == pc
    assert rbody["status"]["code"] == pbody["status"]["code"] != 200
    assert normal(pbody) == normal(rbody)


def test_over_long_query_refused_alike():
    out = []
    for pkg in (REF, PORT):
        g = _gods_graph(pkg)
        s = _serve(pkg, {"graph": g}, max_query_length=64)
        try:
            out.append(post(s.port, "g.V().has('name', '" + "x" * 100 + "').count()"))
            out.append(post(s.port, "g.V().count()"))
        finally:
            s.stop()
            g.close()
    (r_long, r_ok), (p_long, p_ok) = out[:2], out[2:]
    assert r_long[0] == p_long[0] == 200
    assert r_long[1]["status"]["code"] == p_long[1]["status"]["code"] == 413
    assert normal(r_long[1]) == normal(p_long[1])
    assert normal(r_ok[1]) == normal(p_ok[1])


def test_oversized_body_refused_alike(served):
    """A body announced past ``server.max-request-bytes`` is refused before
    it is read (the request carries only its headers: the server answers
    413 and closes, and a client still sending would see a broken pipe)."""
    import socket

    answers = []
    for k in ("ref", "port"):
        with socket.create_connection(("127.0.0.1", served[k][0].port), timeout=TIMEOUT_S) as sk:
            sk.sendall(b"POST /gremlin HTTP/1.1\r\nHost: x\r\nContent-Type: application/json"
                       b"\r\nContent-Length: %d\r\n\r\n" % (1 << 21))
            answers.append(sk.makefile("rb").readline())
    assert answers[0] == answers[1] and b" 413 " in answers[0]


def test_auth_alike():
    for pkg in (REF, PORT):
        g, creds_graph = _gods_graph(pkg), pkg.open_graph(dict(pkg.config))
        creds = pkg.Creds(creds_graph)
        creds.create_user("alice", "pw")
        s = _serve(pkg, {"graph": g}, authenticator=pkg.HMAC(creds))
        try:
            code, _body = post(s.port, "g.V().count()")
            assert code == 401, pkg.name
            assert get(s.port, "/graphs")[0] == 401
            # probes carry no credentials: served without them (200 "ok", or
            # 503 "degraded" where a breaker another test left open reads so)
            code, _t, raw = get(s.port, "/healthz")
            assert code in (200, 503) and json.loads(raw)["status"] in ("ok", "degraded")
            basic = pkg.Client(port=s.port, username="alice", password="pw",
                               http_timeout_s=TIMEOUT_S)
            assert basic.submit("g.V().count()") == 12
            basic.fetch_token()
            tok = pkg.Client(port=s.port, token=basic.token, http_timeout_s=TIMEOUT_S)
            assert tok.submit("g.V().count()") == 12
            ws = tok.ws()
            ws.sock.settimeout(TIMEOUT_S)
            try:
                assert ws.submit("g.V().count()") == 12
            finally:
                ws.close()
            with pytest.raises(urllib.error.HTTPError) as e:
                pkg.Client(port=s.port, username="alice", password="no",
                           http_timeout_s=TIMEOUT_S).submit("g.V().count()")
            assert e.value.code == 401
        finally:
            s.stop()
            g.close()
            creds_graph.close()


def test_password_hashes_and_tokens_verify_across_packages():
    assert ref_auth.verify_password("s3cret", auth.hash_password("s3cret"))
    assert auth.verify_password("s3cret", ref_auth.hash_password("s3cret"))
    assert not auth.verify_password("wrong", ref_auth.hash_password("s3cret"))
    graphs = []
    try:
        issued = {}
        for pkg, mod in ((REF, ref_auth), (PORT, auth)):
            cg = pkg.open_graph(dict(pkg.config))
            graphs.append(cg)
            creds = pkg.Creds(cg)
            creds.create_user("u|ser", "pw")
            issued[pkg.name] = mod.HMACAuthenticator(creds, secret=b"shared")
        for a, b in (("ref", "port"), ("port", "ref")):
            token = issued[a].issue_token("u|ser", "pw")
            assert issued[b].verify_token(token) == "u|ser"
        forged = issued["port"].issue_token("u|ser", "pw")[:-4] + "AAAA"
        for k in issued:
            with pytest.raises((auth.AuthenticationError, ref_auth.AuthenticationError)):
                issued[k].verify_token(forged)
    finally:
        for g in graphs:
            g.close()


@pytest.mark.parametrize("client_pkg,server_key", [(PORT, "ref"), (REF, "port")])
def test_clients_talk_to_the_other_package_server(served, client_pkg, server_key):
    s = served[server_key][0]
    c = client_pkg.Client(port=s.port, http_timeout_s=TIMEOUT_S)
    assert c.health()
    assert sorted(c.graphs()) == ["graph", "other"]
    assert c.submit("g.V().has('name', 'saturn').in_('father').values('name')") == ["jupiter"]
    assert c.submit("g.V().count()", graph="other") == 1
    vs = c.submit("g.V().has('name', 'saturn')")
    assert len(vs) == 1 and vs[0].properties["name"] == ["saturn"]
    assert c.submit("g.V().pageRank().order().by('pagerank', reverse=True).limit(3)"
                    ".values('name')") == ["tartarus", "jupiter", "pluto"]
    with pytest.raises(client_pkg.RemoteError):
        c.submit("__import__('os')")
    ws = c.ws()
    ws.sock.settimeout(TIMEOUT_S)
    try:
        assert ws.submit("g.V().count()") == 12
        assert set(ws.submit("g.V().has('name','jupiter').out('brother').values('name')")) == {
            "neptune", "pluto"}
    finally:
        ws.close()


@pytest.mark.parametrize("client_pkg,server_pkg", [
    (PORT, PORT), (PORT, REF), (REF, PORT),
])
def test_session_write_is_read_back_after_commit_only(client_pkg, server_pkg):
    g = _gods_graph(server_pkg)
    s = _serve(server_pkg, {"graph": g})
    try:
        c = client_pkg.Client(port=s.port, http_timeout_s=TIMEOUT_S)
        ws = c.ws(session=True)
        ws.sock.settimeout(TIMEOUT_S)
        try:
            ws.submit("g.V().has('name','hercules').addE('knows')"
                      ".to_(g.V().has('name','pluto').next()).iterate()")
            q = "g.V().has('name','hercules').out('knows').values('name')"
            assert ws.submit(q) == ["pluto"]  # the session sees its own write
            assert c.submit(q) == []  # a sessionless read does not
            ws.submit("g.commit()")
            assert c.submit(q) == ["pluto"]
            ws.submit("g.addV('person').property('name','sess2').iterate()")
        finally:
            ws.close()
        # a close without commit rolls back (the close is handled on the
        # server's thread)
        for _ in range(100):
            if c.submit("g.V().has('name','sess2').count()") == 0:
                break
            import time

            time.sleep(0.05)
        assert c.submit("g.V().has('name','sess2').count()") == 0
    finally:
        s.stop()
        g.close()


# ---------------------------------------------------------------- GraphBinary
def _binary_values(attrs, preds, cdc):
    d = datetime
    values = [42, -7, 3.5, "héllo", True, None, b"\x00\xff", [1, [2, 3]],
              {"k": 7, "j": [1]}, {1, 2},
              attrs.Instant(1000, 5), attrs.Char("Q"),
              d.timedelta(days=200000, microseconds=1),
              d.datetime(2026, 7, 30, 1, 2, 3, 4), d.date(2026, 7, 30),
              d.time(23, 59, 58, 999999),
              {cdc.Direction.OUT: {"id": 1}, cdc.Direction.IN: {"id": 2}, "label": "x"},
              preds.Geoshape.point(1, 2), preds.Geoshape.circle(1, 2, 50.0),
              preds.Geoshape.polygon([(0, 0), (0, 3), (3, 0)]),
              np.arange(6, dtype=np.float32).reshape(2, 3)]
    rng = np.random.default_rng(11)
    for _ in range(24):  # a seeded mix
        kind = rng.integers(5)
        if kind == 0:
            values.append(int(rng.integers(-(1 << 62), 1 << 62)))
        elif kind == 1:
            values.append(float(rng.normal()))
        elif kind == 2:
            values.append("".join(chr(int(c)) for c in rng.integers(32, 0x3000, 8)))
        elif kind == 3:
            values.append([int(x) for x in rng.integers(0, 100, 5)])
        else:
            values.append({f"k{int(x)}": float(x) for x in rng.integers(0, 9, 3)})
    return values


def test_graphbinary_bytes_equal_and_decode_across_packages():
    ref_vals = _binary_values(ref_attributes, ref_predicates, ref_codecs)
    port_vals = _binary_values(attributes, predicates, codecs)
    for rv, pv in zip(ref_vals, port_vals):
        rb, pb = ref_driver.binary_dumps(rv), driver.binary_dumps(pv)
        assert rb == pb, pv
        back_p, back_r = driver.binary_loads(rb), ref_driver.binary_loads(pb)
        if isinstance(pv, np.ndarray):
            np.testing.assert_array_equal(back_p, pv)
            np.testing.assert_array_equal(back_r, rv)
            assert back_p.dtype == pv.dtype
        else:
            assert back_p == pv and type(back_p).__name__ == type(pv).__name__
            assert back_r == rv


def test_graphbinary_elements_and_relation_ids_across_packages(served):
    rid = driver.RelationIdentifier(123456, 789, 42, 1011)
    assert ref_driver.binary_dumps(ref_driver.RelationIdentifier(123456, 789, 42, 1011)) == \
        driver.binary_dumps(rid)
    assert driver.binary_loads(driver.binary_dumps(rid)) == rid
    ref_g, port_g = served["ref"][1], served["port"][1]
    rsrc, psrc = ref_g.traversal(), port_g.traversal()
    try:
        rv = rsrc.V().has("name", "saturn").next()
        pv = psrc.V().has("name", "saturn").next()
        assert ref_driver.binary_dumps(rv) == driver.binary_dumps(pv)
        re_ = rsrc.V().has("name", "hercules").out_e("father").next()
        pe = psrc.V().has("name", "hercules").out_e("father").next()
        pb = driver.binary_dumps(pe)
        assert ref_driver.binary_dumps(re_) == pb
        back = ref_driver.binary_loads(pb)
        assert back.label == "father" and back.id.out_vertex_id == pe.out_vertex.id
    finally:
        rsrc.rollback()
        psrc.rollback()


# ------------------------------------------------------- observability routes
def _keys(obj, depth=2):
    if not isinstance(obj, dict) or depth == 0:
        return None
    return {k: _keys(v, depth - 1) for k, v in obj.items()}


def test_healthz_blocks_and_codes_equal(served):
    # the active controller is process-wide: a server another test started
    # and stopped since deregistered it; and a breaker another test file left
    # open in this process would read as degraded, so the registries start
    # clean, as the reference's suite starts them
    ref_registry.reset()
    registry.reset()
    ref_admission.set_active(served["ref"][0].admission)
    admission.set_active(served["port"][0].admission)
    for k in ("ref", "port"):  # one request each first: the counters exist
        post(served[k][0].port, "g.V().count()")
    (rcode, _rt, rraw), (pcode, _pt, praw) = (get(served[k][0].port, "/healthz")
                                              for k in ("ref", "port"))
    assert rcode == pcode == 200
    r, p = json.loads(rraw), json.loads(praw)
    assert r["status"] == p["status"] == "ok"
    assert set(p) == set(r)
    for block in ("sharded", "admission", "slo", "profiler", "spillover", "flight"):
        assert set(p[block]) == set(r[block]), block
    assert set(p["profiler"]["watchdog"]) == set(r["profiler"]["watchdog"])
    assert set(p["profiler"]["bundles"]) == set(r["profiler"]["bundles"])
    assert p["slo"]["specs"] == r["slo"]["specs"] and p["slo"]["paging"] == []
    assert p["admission"]["admitted"] >= 1 and p["admission"]["shed"] == 0


@pytest.mark.parametrize("path", [
    "/health", "/metrics", "/telemetry", "/timeseries", "/timeseries?window=x",
    "/profile", "/profile/timeline?run=x", "/profile/flame", "/profile/flame?trace=00",
    "/flight", "/debug/profile", "/debug/profile/diff?a=x", "/debug/stacks",
    "/watch/info", "/graphs", "/nowhere",
])
def test_get_routes_answer_alike(served, path):
    (rcode, rtype, rraw), (pcode, ptype, praw) = (get(served[k][0].port, path)
                                                  for k in ("ref", "port"))
    assert rcode == pcode and rtype == ptype, (rcode, pcode, rtype, ptype)
    if rtype == "application/json":
        r, p = json.loads(rraw), json.loads(praw)
        assert _keys(p, 1) is None or set(p) == set(r)
        if path == "/watch/info":
            assert p["streams"] == r["streams"] and set(p["cursors"]) == set(r["cursors"])
        if rcode != 200:
            assert p == r


def test_metrics_exposition_carries_the_request_timers(served):
    for k in ("ref", "port"):
        post(served[k][0].port, "g.V().count()")
    texts = [get(served[k][0].port, "/metrics")[2].decode() for k in ("ref", "port")]
    for text in texts:
        assert "server_request_wall" in text and "server_admission_admitted" in text


def test_gossip_without_an_agent_answers_404_in_both(served):
    assert [post(served[k][0].port, "{}", path="/gossip")[0] for k in ("ref", "port")] == [
        404, 404]


def test_token_route_without_auth_answers_401_in_both(served):
    codes = []
    for k in ("ref", "port"):
        req = urllib.request.Request(
            f"http://127.0.0.1:{served[k][0].port}/token",
            data=json.dumps({"username": "a", "password": "b"}).encode())
        try:
            urllib.request.urlopen(req, timeout=TIMEOUT_S)
        except urllib.error.HTTPError as e:
            codes.append(e.code)
    assert codes == [401, 401]


# ------------------------------------------------------ the CLI, price book
def test_server_subcommand_serves_the_gods_on_the_cpu(tmp_path):
    cfg = tmp_path / "graph.json"
    cfg.write_text(json.dumps({"computer.executor": "cpu", "ids.authority-wait-ms": 0.0}))
    proc = subprocess.Popen(
        [sys.executable, "-m", "janusgraph_tpu_torch", "server", "--port", "0",
         "--load-gods", "--config", str(cfg)],
        cwd=str(ROOT), stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        line = proc.stdout.readline()
        m = re.fullmatch(r"JanusGraph-TPU server listening on 127\.0\.0\.1:(\d+)\n", line)
        assert m, (line, proc.stderr.read() if proc.poll() is not None else "")
        c = driver.JanusGraphClient(port=int(m.group(1)), http_timeout_s=TIMEOUT_S)
        assert c.submit("g.V().pageRank().order().by('pagerank', reverse=True).limit(3)"
                        ".values('name')") == ["tartarus", "jupiter", "pluto"]
    finally:
        proc.terminate()
        proc.wait(timeout=20)
        proc.stdout.close()
        proc.stderr.close()


def test_price_book_restores_across_packages(tmp_path):
    tables = {}
    for name, mod in (("ref", ref_profiler), ("port", profiler)):
        rng = np.random.default_rng(3)
        t = mod.DigestTable(capacity=16)
        for i in range(40):
            d = f"d{int(rng.integers(6))}"
            t.observe(d, f"shape-{d}", float(rng.gamma(2.0, 3.0)), cells=int(rng.integers(9)))
        tables[name] = t
    for a, save, load in (("port", profiler, ref_profiler), ("ref", ref_profiler, profiler)):
        path = str(tmp_path / f"{a}.json")
        save.save_price_book(path, {"oltp": tables[a], "server": tables[a]})
        fresh = load.DigestTable(capacity=16)
        assert load.restore_digest_records(fresh, load.load_price_book(path)["oltp"]) == 6
        assert load.digest_records(fresh) == save.digest_records(tables[a])
        assert sorted(load.load_price_book(path)) == ["oltp", "server"]
    assert profiler.digest_records(tables["port"]) == ref_profiler.digest_records(tables["ref"])
    # a missing or foreign file restores nothing in either
    assert profiler.load_price_book(str(tmp_path / "none.json")) == {}
    (tmp_path / "v9.json").write_text(json.dumps({"version": 9, "tables": {}}))
    assert profiler.load_price_book(str(tmp_path / "v9.json")) == {}


def test_request_ledger_counts_cells_as_the_reference():
    """The per-request ledger counts the cells a local store reads and
    writes in the backend transaction, as the reference's does."""
    outs = []
    for pkg, prof in ((REF, ref_profiler), (PORT, profiler)):
        g = _gods_graph(pkg)
        try:
            with prof.ledger_scope() as led:
                g.traversal().V().has("name", "hercules").out("battled").values("name").to_list()
            with prof.ledger_scope() as wled:
                src = g.traversal()
                src.add_v("person").property("name", "nemo")
                src.commit()
            outs.append((led.to_dict(), wled.to_dict()))
        finally:
            g.close()
    assert outs[1] == outs[0]
    assert outs[1][0]["cells_read"] > 0 and outs[1][1]["cells_written"] > 0


# --------------------------------- the two pipeline cases that need a server
def test_healthz_pipeline_block_over_a_pipelined_store_client():
    """``/healthz``'s ``pipeline`` block reads the port's pipelined store
    client's counters (the reference's ``test_healthz_pipeline_block``)."""
    from janusgraph_tpu_torch.storage.inmemory import InMemoryStoreManager
    from janusgraph_tpu_torch.storage.remote import RemoteStoreManager, RemoteStoreServer

    store_server = RemoteStoreServer(InMemoryStoreManager()).start()
    mgr = RemoteStoreManager(*store_server.address)
    mgr._should_pipeline = lambda: True  # every eligible op pipelined
    try:
        mgr.open_database("edgestore").mutate(b"k", [(b"a", b"1")], [], None)
        mgr._mux.flush_stats()
        entry = server.server.healthz_snapshot()["pipeline"]["storage.remote"]
        assert entry["ops"] >= 1 and entry["wire_frames"] >= 1
        assert {"coalesce_ratio", "in_flight", "stalls", "negotiation_fallbacks"} <= set(entry)
    finally:
        mgr.close()
        store_server.stop()


@pytest.mark.parametrize("client_pkg,server_pkg", [(PORT, PORT), (PORT, REF), (REF, PORT)])
def test_ws_multiplexed_submits_share_one_socket(client_pkg, server_pkg):
    import threading

    g = server_pkg.open_graph(dict(server_pkg.config))
    tx = g.new_transaction()
    ids = [tx.add_vertex(name=f"v{i}").id for i in range(8)]
    tx.commit()
    s = _serve(server_pkg, {"graph": g}, admission_enabled=False)
    try:
        c = client_pkg.Client(port=s.port, http_timeout_s=TIMEOUT_S)
        ws = c.ws(multiplex=True)
        ws.sock.settimeout(TIMEOUT_S)
        results, errs = {}, []

        def worker(i):
            try:
                results[i] = ws.submit(f"g.V({ids[i]}).values('name')")
            except Exception as e:  # noqa: BLE001 - surfaced below
                errs.append(e)

        threads = [threading.Thread(target=worker, args=(i,)) for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(TIMEOUT_S)
        assert errs == [] and results == {i: [f"v{i}"] for i in range(8)}
        ws.close()
        serial = c.ws(multiplex=False)
        serial.sock.settimeout(TIMEOUT_S)
        assert serial.submit(f"g.V({ids[0]}).values('name')") == ["v0"]
        serial.close()
    finally:
        s.stop()
        g.close()
