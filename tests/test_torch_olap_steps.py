"""The traversal's computer steps held to the JAX package's.

Both packages build the same seeded graph through OLTP transactions (150
vertices, ``link`` edges with a float weight ``w`` and ``tie`` edges, one
isolated pair), then run ``page_rank()``, ``connected_component()``,
``peer_pressure()`` and ``shortest_path()`` inside a traversal. The
reference runs its ``TPUExecutor`` on the CPU (``computer.executor`` "tpu",
one device, no delta snapshot); the port runs ``computer.executor`` "cpu".
Ranks agree within a relative 1e-4 (the two sum in other orders); component
and cluster ids, and every path, are equal exactly. Without a CUDA card the
port's default executor ("tpu", the card) raises instead of running on the
CPU.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import janusgraph_tpu.core.traversal as ref_trav
from janusgraph_tpu.core.graph import open_graph as ref_open_graph
import janusgraph_tpu_torch.core.traversal as trav
from janusgraph_tpu_torch.core.graph import open_graph
from janusgraph_tpu_torch.olap.programs import PageRankProgram

REF_CONFIG = {"computer.sharded-auto": False, "computer.delta": False,
              "computer.spillover": False}
PORT_CONFIG = {"computer.executor": "cpu", "computer.spillover": False}
RANK_RTOL = 1e-4


def _build(open_fn, config):
    g = open_fn(dict(config))
    m = g.management()
    m.make_property_key("name", str)
    m.make_property_key("w", float)
    m.make_edge_label("link")
    m.make_edge_label("tie")
    m.make_vertex_label("node")
    rng = np.random.default_rng(5)
    tx = g.new_transaction()
    vs = [tx.add_vertex("node", name=f"n{i}") for i in range(150)]
    # three dense groups joined by a few links, and one isolated pair
    for i in range(148):
        group = i // 50
        for j in rng.choice(50, 3, replace=False):
            t = group * 50 + int(j)
            if t < 148:
                tx.add_edge(vs[i], "link", vs[t], w=float(np.round(rng.uniform(0.5, 3.0), 2)))
    tx.add_edge(vs[10], "link", vs[60], w=1.0)
    tx.add_edge(vs[70], "tie", vs[120])
    tx.add_edge(vs[148], "tie", vs[149])
    tx.commit()
    return g, [v.id for v in vs]


@pytest.fixture(scope="module")
def graphs():
    ref, rids = _build(ref_open_graph, REF_CONFIG)
    port, pids = _build(open_graph, PORT_CONFIG)
    assert rids == pids
    yield (SimpleNamespace(graph=ref, m=ref_trav, ids=rids),
           SimpleNamespace(graph=port, m=trav, ids=pids))
    ref.close()
    port.close()


def _pairs(t, key):
    """{vertex id: the step's annotation ``key``} over a traversal."""
    return {d["v"].id: d["x"] for d in t.project("v", "x").by().by(key).to_list()}


@pytest.mark.parametrize("alpha", [0.85, 0.5])
def test_page_rank_step_within_1e_4_of_reference(graphs, alpha):
    ref, port = graphs
    want = _pairs(ref.graph.traversal().V().page_rank(alpha), "pagerank")
    got = _pairs(port.graph.traversal().V().page_rank(alpha), "pagerank")
    assert sorted(got) == sorted(want) == sorted(port.ids)
    w = np.array([want[v] for v in port.ids])
    r = np.array([got[v] for v in port.ids])
    np.testing.assert_allclose(r, w, rtol=RANK_RTOL, atol=0)
    # the step reads the same ranks a direct submit of its program gives
    direct = port.graph.compute().program(
        PageRankProgram(damping=alpha, max_iterations=20)).submit()
    assert all(got[v] == direct.value("rank", v) for v in port.ids)


def test_page_rank_top10_ids_equal_reference(graphs):
    ref, port = graphs

    def top(ns):
        return ns.graph.traversal().V().page_rank().order().by(
            "pagerank", reverse=True).limit(10).id_().to_list()

    want, got = top(ref), top(port)
    rank = _pairs(port.graph.traversal().V().page_rank(), "pagerank")
    # neighbours in the order closer than the tolerance may swap; the rest
    # must hold their places
    gaps = np.diff([rank[v] for v in got])
    assert np.all(gaps <= 0)
    if np.all(-gaps > RANK_RTOL * rank[got[0]]):
        assert got == want
    else:
        assert set(got) == set(want)


def test_connected_component_step_equals_reference(graphs):
    ref, port = graphs
    want = _pairs(ref.graph.traversal().V().connected_component(), "component")
    got = _pairs(port.graph.traversal().V().connected_component(), "component")
    assert got == want
    assert len(set(got.values())) == 2  # the groups and the isolated pair
    seeds = port.ids[::37]
    assert (port.graph.traversal().V(*seeds).connected_component().values("component").to_list()
            == ref.graph.traversal().V(*seeds).connected_component().values("component").to_list())


def test_peer_pressure_step_equals_reference(graphs):
    ref, port = graphs
    want = _pairs(ref.graph.traversal().V().peer_pressure(rounds=10), "cluster")
    got = _pairs(port.graph.traversal().V().peer_pressure(rounds=10), "cluster")
    assert got == want and set(got.values()) <= set(port.ids)


def _paths(ns, **kw):
    t = ns.graph.traversal().V(ns.ids[0], ns.ids[75]).shortest_path(**kw)
    return [[v.id for v in p] for p in t.to_list()]


@pytest.mark.parametrize("kw", [
    {"max_hops": 4},
    {"max_hops": 10},
    {"weight_key": "w"},
], ids=["hops4", "hops10", "weighted"])
def test_shortest_path_step_equals_reference(graphs, kw):
    ref, port = graphs
    want, got = _paths(ref, **kw), _paths(port, **kw)
    assert got == want and len(got) > 20


def test_shortest_path_target_filter_equals_reference(graphs):
    ref, port = graphs
    targets = set(port.ids[100:110])

    def run(ns):
        m = ns.m
        t = ns.graph.traversal().V(ns.ids[60]).shortest_path(
            target=m.__.has("name", m.P.within(*[f"n{i}" for i in range(100, 110)])))
        return [[v.id for v in p] for p in t.to_list()]

    got = run(port)
    assert got == run(ref) and {p[-1] for p in got} <= targets and got


@pytest.mark.parametrize("kw", [{"max_hops": 4}, {"weight_key": "w"}], ids=["hops4", "weighted"])
def test_shortest_path_step_under_the_sharded_executor_equals_reference(monkeypatch, kw):
    """``computer.executor`` "sharded": both steps hand the executor to
    ``run_on``, whose sharded branch runs ``ShardedExecutor`` — the
    reference's over the conftest's 8 virtual devices, the port's over a
    mesh of 8 CPU slots (its default mesh needs cards). Every path is
    equal, and the port's run went through the sharded executor."""
    from janusgraph_tpu_torch.observability import registry
    from janusgraph_tpu_torch.olap import computer
    from janusgraph_tpu_torch.parallel import Mesh

    monkeypatch.setattr(computer, "default_mesh", lambda: Mesh([torch.device("cpu")] * 8))
    ref, rids = _build(ref_open_graph, dict(REF_CONFIG, **{"computer.executor": "sharded"}))
    port, pids = _build(open_graph, dict(PORT_CONFIG, **{"computer.executor": "sharded"}))
    try:
        want = _paths(SimpleNamespace(graph=ref, m=ref_trav, ids=rids), **kw)
        got = _paths(SimpleNamespace(graph=port, m=trav, ids=pids), **kw)
        run = registry.last_run("olap")
        assert run["executor"] == "sharded" and run["mesh"]["slots"] == 8
        assert got == want and len(got) > 20
    finally:
        ref.close()
        port.close()


@pytest.mark.skipif(torch.cuda.is_available(), reason="holds the CPU-only behaviour")
@pytest.mark.parametrize("step", ["page_rank", "shortest_path"])
def test_default_executor_is_the_card_and_raises_without_one(step):
    g = open_graph({"computer.spillover": False})  # computer.executor "tpu"
    try:
        t = g.traversal()
        a = t.add_v("node")
        t.add_e(a, "link", t.add_v("node"))
        t.commit()
        with pytest.raises(RuntimeError, match="no CUDA device"):
            getattr(t.V(), step)().to_list()
    finally:
        g.close()
