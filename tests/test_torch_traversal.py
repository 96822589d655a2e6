"""The port's Gremlin traversal held to the JAX package's.

Both packages build the same seeded property graph through OLTP
transactions: 200 vertices under two labels ("person" with string, int,
float, text and geo-point properties; "software" with a string and a
float), ``knows`` and ``created`` edges with float weights, and ``rated``
edges sorted by an int ``time`` key. The same calls draw the same ids in
both, so a traversal's results compare directly. Each case runs on a fresh
``graph.traversal()`` in each package (its writes are rolled back after),
and the results, with vertices as ids, edges as (out, label, in, id) and
geoshapes as their repr, must be exactly equal: ids, counts, paths and maps
take no tolerance, and the floats are the stored values or the same sums in
the same order. A case that raises must raise the same error class in both.
Spillover is off in both, so every case walks row by row.
"""

import time
from collections import Counter
from types import SimpleNamespace

import numpy as np
import pytest

import janusgraph_tpu.core.deadline as ref_deadline
import janusgraph_tpu.core.traversal as ref_trav
from janusgraph_tpu.core.codecs import Direction as RefDirection
from janusgraph_tpu.core.graph import open_graph as ref_open_graph
from janusgraph_tpu.core.predicates import Geoshape as RefGeoshape
import janusgraph_tpu_torch.core.deadline as deadline
import janusgraph_tpu_torch.core.traversal as trav
from janusgraph_tpu_torch.core.codecs import Direction
from janusgraph_tpu_torch.core.graph import open_graph
from janusgraph_tpu_torch.core.predicates import Geoshape

REF_CONFIG = {"computer.sharded-auto": False, "computer.spillover": False}
PORT_CONFIG = {"computer.executor": "cpu", "computer.spillover": False}

WORDS = ("graph", "tensor", "database", "vertex", "query", "gremlin", "card",
         "kernel", "index", "stream", "latency", "shard")


def _build(open_fn, config, geoshape):
    g = open_fn(dict(config))
    m = g.management()
    for name, dt in (("name", str), ("age", int), ("score", float), ("bio", str),
                     ("loc", geoshape), ("lang", str), ("weight", float), ("time", int)):
        m.make_property_key(name, dt)
    m.make_edge_label("knows")
    m.make_edge_label("created")
    m.make_edge_label("rated", sort_key=["time"])
    m.make_vertex_label("person")
    m.make_vertex_label("software")
    rng = np.random.default_rng(17)
    tx = g.new_transaction()
    people = []
    for i in range(160):
        words = rng.choice(len(WORDS), 3, replace=False)
        people.append(tx.add_vertex(
            "person", name=f"p{i}", age=int(rng.integers(18, 70)),
            score=float(np.round(rng.random(), 3)),
            bio=" ".join(WORDS[w] for w in words),
            loc=geoshape.point(float(np.round(rng.uniform(30, 50), 3)),
                               float(np.round(rng.uniform(-10, 20), 3)))))
    soft = [tx.add_vertex("software", name=f"s{i}", lang=("py", "cpp", "java")[i % 3],
                          score=float(np.round(rng.random(), 3))) for i in range(40)]
    tx.commit()
    tx = g.new_transaction()
    for i, p in enumerate(people):
        v = tx.get_vertex(p.id)
        for j in rng.choice(160, int(rng.integers(1, 6)), replace=False):
            tx.add_edge(v, "knows", tx.get_vertex(people[j].id),
                        weight=float(np.round(rng.random(), 2)))
        for j in rng.choice(40, int(rng.integers(0, 3)), replace=False):
            tx.add_edge(v, "created", tx.get_vertex(soft[j].id),
                        weight=float(np.round(rng.random(), 2)))
        if i < 40:
            for t in rng.choice(100, 4, replace=False):
                tx.add_edge(v, "rated", tx.get_vertex(soft[int(t) % 40].id), time=int(t))
    tx.commit()
    return g, [p.id for p in people], [s.id for s in soft]


@pytest.fixture(scope="module")
def graphs():
    ref, rp, rs = _build(ref_open_graph, REF_CONFIG, RefGeoshape)
    port, pp, ps = _build(open_graph, PORT_CONFIG, Geoshape)
    assert (rp, rs) == (pp, ps), "the two packages drew other ids"
    ref_ns = SimpleNamespace(graph=ref, P=ref_trav.P, T=ref_trav.T, __=ref_trav.__,
                             Pick=ref_trav.Pick, D=RefDirection, Geo=RefGeoshape,
                             deadline=ref_deadline, people=rp, soft=rs)
    port_ns = SimpleNamespace(graph=port, P=trav.P, T=trav.T, __=trav.__, Pick=trav.Pick,
                              D=Direction, Geo=Geoshape, deadline=deadline, people=pp, soft=ps)
    yield ref_ns, port_ns
    ref.close()
    port.close()


def _norm(x):
    kind = type(x).__name__
    if kind == "Vertex":
        return ("v", x.id)
    if kind == "Edge":
        return ("e", x.out_vertex.id, x.label, x.in_vertex.id, x.id)
    if kind == "VertexProperty":
        return ("p", x.key, _norm(x.value))
    if kind == "Geoshape":
        return ("geo", repr(x))
    if kind == "RelationIdentifier":
        return ("rid", str(x))
    if kind in ("Direction", "T", "Pick"):
        return ("enum", x.name)
    if isinstance(x, dict):
        return ("dict", sorted(((_norm(k), _norm(v)) for k, v in x.items()), key=repr))
    if isinstance(x, (set, frozenset)):
        return ("set", sorted((_norm(v) for v in x), key=repr))
    if isinstance(x, (list, tuple)):
        return [_norm(v) for v in x]
    return x


def _run(ns, case):
    g = ns.graph.traversal()
    try:
        out = case(g, ns)
        if hasattr(out, "to_list"):
            out = out.to_list()
        return ("ok", _norm(out))
    except Exception as e:  # noqa: BLE001 - the error class is the result
        return ("raises", type(e).__name__)
    finally:
        g.tx.rollback()


def _profile_steps(g, m):
    prof = g.V().has_label("person").out("knows").has("age", m.P.gt(40)).count_().profile()
    return [(c.group, c.annotations.get("traversers")) for c in prof.profiler.children]


def _deadline_spent(g, m):
    with m.deadline.deadline_scope(1.0):
        time.sleep(0.01)
        return g.V().out("knows").count()


def _deadline_kept(g, m):
    with m.deadline.deadline_scope(60_000.0):
        return g.V().out("knows").out("knows").count()


def _subgraph_size(g, m):
    t = g.V(*m.people[:5]).out_e("knows").subgraph("sg").cap("sg")
    sg = t.next()
    try:
        sub = sg.traversal()
        return sub.V().count(), sub.E().count(), sorted(sub.V().values("name").to_list())
    finally:
        sg.close()


def _sack_weights(g, m):
    return (g.with_sack(1.0).V(*m.people[:4]).out_e("knows")
            .sack(lambda s, w: s * w).by("weight").in_v().sack())


CASES = {
    # navigation
    "v_count": lambda g, m: g.V().count(),
    "label_count": lambda g, m: g.V().has_label("person").count(),
    "software_names": lambda g, m: g.V().has_label("software").values("name"),
    "out": lambda g, m: g.V(m.people[0]).out("knows").id_(),
    "in": lambda g, m: g.V(m.people[3]).in_("knows").id_(),
    "both": lambda g, m: g.V(m.people[5]).both("knows").id_(),
    "out_all_labels": lambda g, m: g.V(m.people[1]).out().id_(),
    "out_e_weights": lambda g, m: g.V(*m.people[:6]).out_e("knows").values("weight"),
    "in_e": lambda g, m: g.V(m.soft[2]).in_e(),
    "both_e_other_v": lambda g, m: g.V(m.people[7]).both_e("knows").other_v().id_(),
    "e_label_count": lambda g, m: g.E().has_label("created").count(),
    "e_has_weight": lambda g, m: g.E().has("weight", m.P.gt(0.5)).count(),
    "out_e_in_v": lambda g, m: g.V(m.people[2]).out_e("knows").in_v().values("name"),
    "out_e_out_v": lambda g, m: g.V(*m.people[:3]).out_e("knows").out_v().dedup().id_(),
    "both_v": lambda g, m: g.V(m.people[9]).out_e("created").both_v().id_(),
    "two_hops": lambda g, m: g.V(*m.people[:10]).out("knows").out("created").dedup().values("name"),
    "sort_range": lambda g, m: g.V(m.people[0]).out_e("rated", sort_range=(10, 60)).values("time"),
    "sort_range_open": lambda g, m: g.V(*m.people[:8]).out_e("rated", sort_range=(None, 30)).values("time"),
    "adjacent_has_id": lambda g, m: g.V(*m.people[:20]).out("knows").has_id(*m.people[:30:3]).id_(),
    "has_id_start": lambda g, m: g.V().has_id(m.people[3], m.soft[4]).values("name"),
    "e_by_id": lambda g, m: g.E(g.V(m.people[4]).out_e("knows").next()).in_v().id_(),
    # has(), every predicate family
    "has_eq": lambda g, m: g.V().has("age", 30).values("name"),
    "has_neq": lambda g, m: g.V().has_label("person").has("age", m.P.neq(30)).count(),
    "has_lt": lambda g, m: g.V().has("age", m.P.lt(22)).values("name"),
    "has_lte_gte": lambda g, m: g.V().has("age", m.P.gte(60)).has("age", m.P.lte(62)).values("age"),
    "has_between": lambda g, m: g.V().has("score", m.P.between(0.2, 0.25)).values("name"),
    "has_within": lambda g, m: g.V().has("age", m.P.within(21, 33, 47)).values("name"),
    "has_without": lambda g, m: g.V().has("lang", m.P.without("py", "cpp")).values("name"),
    "has_exists": lambda g, m: g.V().has("lang").count(),
    "has_not": lambda g, m: g.V().has_not("lang").count(),
    "text_contains": lambda g, m: g.V().has("bio", m.P.text_contains("graph")).values("name"),
    "text_contains_prefix": lambda g, m: g.V().has("bio", m.P.text_contains_prefix("data")).count(),
    "text_contains_regex": lambda g, m: g.V().has("bio", m.P.text_contains_regex("k.*l")).count(),
    "text_contains_fuzzy": lambda g, m: g.V().has("bio", m.P.text_contains_fuzzy("grapj")).count(),
    "text_contains_phrase": lambda g, m: g.V().has("bio", m.P.text_contains_phrase("query card")).count(),
    "text_prefix": lambda g, m: g.V().has("bio", m.P.text_prefix("stream")).values("bio"),
    "text_regex": lambda g, m: g.V().has("bio", m.P.text_regex("(index|shard) .*")).count(),
    "text_fuzzy": lambda g, m: g.V().has("name", m.P.text_fuzzy("p1")).values("name"),
    "geo_within": lambda g, m: g.V().has("loc", m.P.geo_within(m.Geo.circle(40.0, 5.0, 600.0))).values("name"),
    "geo_intersect_box": lambda g, m: g.V().has("loc", m.P.geo_intersect(m.Geo.box(35.0, 0.0, 45.0, 10.0))).count(),
    "geo_disjoint": lambda g, m: g.V().has_label("person").has("loc", m.P.geo_disjoint(m.Geo.box(35.0, 0.0, 45.0, 10.0))).count(),
    "geo_values": lambda g, m: g.V(*m.people[:5]).values("loc"),
    "mid_chain_has": lambda g, m: g.V(*m.people[:10]).out("knows").has("age", m.P.gt(40)).id_(),
    "unknown_key_raises": lambda g, m: g.V().has("nosuchkey", 1).count(),
    # order / limit / range
    "order_by_age": lambda g, m: g.V().has_label("person").order().by("age").limit(12).values("name"),
    "order_desc_range": lambda g, m: g.V().has_label("person").order().by("score", reverse=True).range_(3, 9).values("score"),
    "values_order": lambda g, m: g.V().values("age").order().limit(7),
    "tail_skip": lambda g, m: g.V().has_label("software").values("name").skip(3).tail(4),
    "dedup_count": lambda g, m: g.V(*m.people[:30]).out("knows").dedup().count(),
    # group / groupCount / project
    "group_count_key": lambda g, m: g.V().has_label("software").group_count("lang"),
    "group_count_values": lambda g, m: g.V().has_label("person").values("age").group_count(),
    "group_by": lambda g, m: g.V().has_label("software").group().by("lang").by("name"),
    "project": lambda g, m: g.V(*m.people[:5]).project("n", "a", "k").by("name").by("age").by(
        m.__.out("knows").count_()),
    "value_map": lambda g, m: g.V(*m.soft[:3]).value_map(),
    "element_map_edge": lambda g, m: g.V(m.people[0]).out_e("knows").element_map(),
    "properties_key_value": lambda g, m: g.V(m.people[0]).properties("name", "age").value(),
    "fold_unfold": lambda g, m: g.V(*m.people[:4]).values("age").fold(),
    "sum_mean_max": lambda g, m: (g.V().has_label("person").values("age").sum_(),
                                  g.V().values("score").max_(),
                                  g.V().has_label("person").values("age").mean_()),
    # repeat / until / emit
    "repeat_times": lambda g, m: g.V(m.people[0]).repeat(m.__.out("knows"), times=2).dedup().id_(),
    "repeat_modulator": lambda g, m: g.V(m.people[1]).repeat(m.__.out("knows")).times(3).count(),
    "repeat_until": lambda g, m: g.V(m.people[2]).repeat(m.__.out("knows"), max_loops=4).until(
        m.__.has("age", m.P.gt(60))).values("name"),
    "repeat_emit": lambda g, m: g.V(m.people[3]).repeat(m.__.out("knows")).emit().times(2).dedup().id_(),
    "repeat_emit_filter": lambda g, m: g.V(m.people[4]).repeat(m.__.out("knows")).emit(
        m.__.has("age", m.P.lt(30))).times(2).id_(),
    # path / select / match
    "path": lambda g, m: g.V(m.people[0]).out("knows").out("knows").path(),
    "simple_path": lambda g, m: g.V(m.people[0]).both("knows").both("knows").simple_path().path(),
    "select": lambda g, m: g.V(*m.people[:6]).as_("a").out("knows").as_("b").select("a", "b").by("name"),
    "where_neq": lambda g, m: g.V(*m.people[:10]).as_("a").out("knows").out("knows").where(
        m.P.neq("a")).dedup().id_(),
    "match": lambda g, m: g.V(*m.people[:15]).match(
        m.__.as_("a").out("knows").as_("b"),
        m.__.as_("b").out("created").as_("c")).select("a", "c"),
    # branches and filters
    "union": lambda g, m: g.V(m.people[6]).union(m.__.out("knows"), m.__.out("created")).id_(),
    "coalesce": lambda g, m: g.V(*m.people[:10]).coalesce(m.__.out("created"), m.__.constant("none")),
    "choose": lambda g, m: g.V(*m.people[:10]).choose(
        m.__.has("age", m.P.gt(40)), m.__.constant("old"), m.__.constant("young")),
    "optional": lambda g, m: g.V(*m.people[:10]).optional_(m.__.out("created")).id_(),
    "not_and_where": lambda g, m: g.V().has_label("person").not_(m.__.out("created")).where(
        m.__.out("knows")).count(),
    "is_": lambda g, m: g.V(*m.people[:20]).values("age").is_(m.P.gt(50)),
    "aggregate_cap": lambda g, m: g.V(*m.people[:5]).out("knows").aggregate("x").cap("x"),
    "local": lambda g, m: g.V(*m.people[:6]).local(m.__.out("knows").limit(1)).id_(),
    "math": lambda g, m: g.V(*m.people[:5]).values("age").math("_ * 2 + 1"),
    "tree": lambda g, m: g.V(m.people[0]).out("knows").out("knows").tree(),
    "to_bulk_set": lambda g, m: dict(g.V(*m.people[:20]).out("knows").values("age").to_bulk_set()),
    "label_step": lambda g, m: g.V(*m.soft[:2], *m.people[:2]).label(),
    # sack
    "sack": _sack_weights,
    # writes (rolled back after each case)
    "merge_v_match": lambda g, m: g.merge_v({m.T.label: "person", "name": "p7"}).id_(),
    "merge_v_create": lambda g, m: g.merge_v({m.T.label: "person", "name": "new"}).on_create(
        {"age": 5}).values("age", "name"),
    "merge_e": lambda g, m: g.merge_e({m.D.OUT: m.people[0], m.D.IN: m.people[1],
                                       m.T.label: "knows"}).on_create({"weight": 0.5}).values("weight"),
    "inject_merge_v": lambda g, m: g.inject({m.T.label: "software", "name": "s1"},
                                            {m.T.label: "software", "name": "s99"}).merge_v().values("name"),
    "add_e_then_walk": lambda g, m: g.V(m.people[10]).add_e_("knows").to_(
        g.V(m.people[11]).next()).in_v().out("knows").id_(),
    "drop_then_count": lambda g, m: (g.V(*m.people[:3]).out_e("knows").drop().iterate(),
                                     g.V(*m.people[:3]).out("knows").count()),
    # profile, deadline, subgraph
    "profile_steps": _profile_steps,
    "deadline_spent": _deadline_spent,
    "deadline_kept": _deadline_kept,
    "subgraph": _subgraph_size,
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_traversal_equals_reference(graphs, name):
    ref, port = graphs
    want = _run(ref, CASES[name])
    got = _run(port, CASES[name])
    assert got == want


def test_only_the_error_cases_raise(graphs):
    """Equal results could be the same error in both: every case returns
    in the port but the two that raise on purpose, and those raise the
    port's own errors."""
    _ref, port = graphs
    raised = {name: got[1] for name in CASES
              if (got := _run(port, CASES[name]))[0] == "raises"}
    assert raised == {"deadline_spent": "DeadlineExceededError",
                      "unknown_key_raises": "QueryError"}


def test_force_index_refuses_the_scan():
    from janusgraph_tpu_torch.exceptions import QueryError

    g = open_graph({**PORT_CONFIG, "query.force-index": True})
    try:
        t = g.traversal()
        v = t.add_v("person", name="a")
        assert t.V(v.id).values("name").to_list() == ["a"]  # ids need no index
        with pytest.raises(QueryError, match="force-index"):
            t.V().has("name", "a").count()
    finally:
        g.close()


def test_io_waits_on_the_roadmap(tmp_path):
    """Once a stub that raised; g.io() is ported now: a write and a read
    through it carry the graph, and an unknown format raises as in the
    reference."""
    from janusgraph_tpu_torch.exceptions import ConfigurationError

    g, h = open_graph(dict(PORT_CONFIG)), open_graph(dict(PORT_CONFIG))
    try:
        t = g.traversal()
        a, b = t.add_v("person", name="a"), t.add_v("person", name="b")
        t.add_e(a, "knows", b)
        t.commit()
        path = str(tmp_path / "graph.json")
        assert g.traversal().io(path).write() == {"vertices": 2, "edges": 1}
        assert h.traversal().io(path).read() == {"vertices": 2, "edges": 1}
        assert h.traversal().V().out("knows").values("name").to_list() == ["b"]
        with pytest.raises(ConfigurationError, match="unknown io format"):
            g.traversal().io(path).with_("gryo").write()
    finally:
        g.close()
        h.close()


def test_prefetch_batches_into_the_slice_cache(graphs):
    """One multi-query fills the slice cache for every vertex of a frontier
    in chunks of query.batch-size, so the expansion's get_edges read none."""
    _ref, port = graphs
    tx = port.graph.new_transaction()
    try:
        vs = [tx.get_vertex(v) for v in port.people[:50]]
        calls = Counter()
        real = tx.backend_tx.edge_store_multi_query

        def counting(keys, q):
            calls[len(keys)] += 1
            return real(keys, q)

        tx.backend_tx.edge_store_multi_query = counting
        tx.prefetch(vs, Direction.OUT, ("knows",))
        assert sum(calls.values()) == 1 and calls[50] == 1
        reads = Counter()
        real_one = tx.backend_tx.edge_store_query
        tx.backend_tx.edge_store_query = lambda q: reads.update([1]) or real_one(q)
        edges = [tx.get_edges(v, Direction.OUT, ("knows",)) for v in vs]
        assert not reads and sum(map(len, edges)) > 0
    finally:
        tx.rollback()


OPTION_CASES = {
    # an unknown key in a graph-centric has() is no match, not an error
    "ignore_unknown_key": ({"query.ignore-unknown-index-key": True},
                           lambda g, m: g.V().has("nosuchkey", 1).count()),
    # expansion without the multi-query prefetch: one slice read a vertex
    "no_batch": ({"query.batch": False},
                 lambda g, m: g.V(*m.people[:40]).out("knows").out("created").id_()),
    "small_batch": ({"query.batch-size": 7},
                    lambda g, m: g.V(*m.people[:40]).both("knows").dedup().count()),
    "traverser_budget": ({"query.max-traversers": 50},
                         lambda g, m: g.V(*m.people[:40]).out("knows").out("knows").count()),
    "repeat_loop_bound": ({"query.max-repeat-loops": 2},
                          lambda g, m: g.V(m.people[2]).repeat(m.__.out("knows")).until(
                              m.__.has("age", m.P.gt(200))).id_()),
}


@pytest.mark.parametrize("name", sorted(OPTION_CASES))
def test_query_options_equal_reference(name):
    """The query.* options the traversal reads act as the reference's: the
    same graph opened with the option in both packages gives equal results
    (or the same error)."""
    extra, case = OPTION_CASES[name]
    ref, rp, rs = _build(ref_open_graph, {**REF_CONFIG, **extra}, RefGeoshape)
    port, pp, ps = _build(open_graph, {**PORT_CONFIG, **extra}, Geoshape)
    try:
        want = _run(SimpleNamespace(graph=ref, P=ref_trav.P, __=ref_trav.__, people=rp), case)
        got = _run(SimpleNamespace(graph=port, P=trav.P, __=trav.__, people=pp), case)
        assert got == want
    finally:
        ref.close()
        port.close()


def test_slow_query_threshold_counts_slow_traversals():
    from janusgraph_tpu_torch.util.metrics import metrics

    g, people, _ = _build(open_graph, {**PORT_CONFIG, "metrics.slow-query-threshold-ms": 1e-6},
                          Geoshape)
    try:
        before = metrics.get_count("query.slow")
        g.traversal().V(*people[:5]).out("knows").count()
        assert metrics.get_count("query.slow") == before + 1
    finally:
        g.close()
