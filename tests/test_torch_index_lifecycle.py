"""The port's index lifecycle and maintenance jobs held to the JAX
package's (after ``tests/test_index_lifecycle.py``).

Each scenario runs the same calls on an in-memory graph of each package
and returns what it observed: index lookups, statuses, job metrics,
traversal results and plans. The two packages' observations are equal,
and so are their ``edgestore`` and ``graphindex`` rows after the scenario,
byte for byte: composite index rows, the index registry, the index-name
namespace and the reindexed rows. Exact equality throughout: these are
ids, bytes and counts.
"""

from types import SimpleNamespace

import pytest

from janusgraph_tpu.core import codecs as ref_codecs
from janusgraph_tpu.core import gods as ref_gods
from janusgraph_tpu.core import management as ref_management
from janusgraph_tpu.core import predicates as ref_predicates
from janusgraph_tpu.core import traversal as ref_traversal
from janusgraph_tpu.core.graph import open_graph as ref_open_graph
from janusgraph_tpu.exceptions import QueryError as RefQueryError
from janusgraph_tpu.exceptions import SchemaViolationError as RefSchemaError
from janusgraph_tpu.indexing import IndexQuery as RefIndexQuery
from janusgraph_tpu.indexing import PredicateCondition as RefPredicateCondition
from janusgraph_tpu.olap import csr as ref_csr
from janusgraph_tpu.olap import delta as ref_delta
from janusgraph_tpu.olap import input_format as ref_input_format
from janusgraph_tpu.olap import jobs as ref_jobs
from janusgraph_tpu.olap import programs as ref_programs
from janusgraph_tpu.storage import inmemory as ref_inmemory
from janusgraph_tpu.storage import kcvs as ref_kcvs
from janusgraph_tpu.storage import scan as ref_scan
from janusgraph_tpu_torch.core import codecs, gods, management, predicates, traversal
from janusgraph_tpu_torch.core.graph import open_graph
from janusgraph_tpu_torch.exceptions import QueryError, SchemaViolationError
from janusgraph_tpu_torch.indexing import IndexQuery, PredicateCondition
from janusgraph_tpu_torch.olap import csr, delta, input_format, jobs, programs
from janusgraph_tpu_torch.storage import inmemory, kcvs, scan

#: each package's modules, by the same names
REF = SimpleNamespace(
    open=ref_open_graph, config={"computer.sharded-auto": False}, codecs=ref_codecs,
    mgmt=ref_management, P=ref_traversal.P, predicates=ref_predicates, kcvs=ref_kcvs,
    inmemory=ref_inmemory, schema_error=RefSchemaError, query_error=RefQueryError,
    IndexQuery=RefIndexQuery, PredicateCondition=RefPredicateCondition, gods=ref_gods,
    scan=ref_scan, jobs=ref_jobs, csr=ref_csr, delta=ref_delta,
    input_format=ref_input_format, programs=ref_programs,
)
PORT = SimpleNamespace(
    open=open_graph, config={"computer.executor": "cpu"}, codecs=codecs,
    mgmt=management, P=traversal.P, predicates=predicates, kcvs=kcvs,
    inmemory=inmemory, schema_error=SchemaViolationError, query_error=QueryError,
    IndexQuery=IndexQuery, PredicateCondition=PredicateCondition, gods=gods,
    scan=scan, jobs=jobs, csr=csr, delta=delta, input_format=input_format,
    programs=programs,
)


def rows(graph, names=("edgestore", "graphindex")):
    """Every row of the named stores of an in-memory graph, as bytes."""
    mgr = graph.backend.manager
    return {
        name: {k: list(zip(r.columns, r.values)) for k, r in mgr.open_database(name)._rows.items()}
        for name in names
    }


def plan(t):
    """The start step's plan annotations of a traversal's profile()."""
    ann = t.profile().as_dict()["children"][0]["annotations"]
    return {k: ann[k] for k in ("access", "index", "point_lookups", "conditions_pushed")
            if k in ann}


def twin(scenario, extra=None):
    """Run ``scenario(pkg, graph)`` on a new in-memory graph of each
    package (``extra``: more options per package, {"ref": {...}, "port":
    {...}}); returns each package's (observations, rows after it)."""
    out = {}
    for name, pkg in (("ref", REF), ("port", PORT)):
        g = pkg.open(dict(pkg.config, **(extra or {}).get(name, {})))
        try:
            out[name] = (scenario(pkg, g), rows(g))
        finally:
            g.close()
    return out["ref"], out["port"]


def assert_twins(scenario, extra=None):
    """``twin``, holding the port's observations and rows equal to the
    reference's; returns the observations."""
    ref, port = twin(scenario, extra)
    assert port[0] == ref[0]
    assert port[1] == ref[1]
    return port[0]


def _seed(g, n=3):
    tx = g.new_transaction()
    vs = [tx.add_vertex(name=f"v{i}", rank=i) for i in range(n)]
    tx.commit()
    return [v.id for v in vs]


def _lookup(g, index, values):
    tx = g.new_transaction()
    try:
        return g.index_lookup(tx, index, values)
    finally:
        tx.rollback()


def test_disable_enable_composite():
    def scenario(pkg, g):
        vids = _seed(g)
        mgmt = g.management()
        mgmt.build_composite_index("byname", ["name"])
        seen = [_lookup(g, "byname", ["v1"]) == [vids[1]]]
        mgmt.update_index("byname", pkg.mgmt.SchemaAction.DISABLE_INDEX)
        seen.append(g.indexes["byname"].status)
        t = g.traversal().V().has("name", "v1")
        seen += [len(t.to_list()), plan(g.traversal().V().has("name", "v1"))]
        tx = g.new_transaction()
        nv = tx.add_vertex(name="v9")
        tx.commit()
        seen.append(_lookup(g, "byname", ["v9"]))  # writes skip a disabled index
        seen.append(mgmt.update_index("byname", pkg.mgmt.SchemaAction.REINDEX))
        seen += [g.indexes["byname"].status, _lookup(g, "byname", ["v9"]) == [nv.id]]
        seen.append(plan(g.traversal().V().has("name", "v9")))
        return seen

    seen = assert_twins(scenario)
    assert seen[0] and seen[1] == "DISABLED" and seen[3] == {"access": "full-scan"}
    assert seen[4] == [] and seen[6:8] == ["ENABLED", True]
    assert seen[8] == {"access": "composite-index", "index": "byname"}


def test_invalid_transitions():
    def scenario(pkg, g):
        mgmt = g.management()
        mgmt.make_property_key("p", str)
        mgmt.build_composite_index("pi", ["p"])
        raised = []
        for name, action in (("pi", "ENABLE_INDEX"), ("pi", "REMOVE_INDEX"),
                             ("nope", "DISABLE_INDEX")):
            with pytest.raises(pkg.schema_error) as e:
                mgmt.update_index(name, getattr(pkg.mgmt.SchemaAction, action))
            raised.append(str(e.value))
        return raised

    assert_twins(scenario)


def test_remove_composite_index():
    def scenario(pkg, g):
        vids = _seed(g)
        mgmt = g.management()
        mgmt.build_composite_index("byname", ["name"])
        mgmt.update_index("byname", pkg.mgmt.SchemaAction.DISABLE_INDEX)
        metrics = mgmt.update_index("byname", pkg.mgmt.SchemaAction.REMOVE_INDEX)
        seen = [dict(metrics.custom), metrics.rows_processed, "byname" in g.indexes,
                mgmt.await_graph_index_status("byname", "REMOVED", timeout_s=1.0)]
        mgmt.build_composite_index("byname", ["name"])  # the name is free again
        seen.append(_lookup(g, "byname", ["v0"]) == [vids[0]])
        return seen

    seen = assert_twins(scenario)
    assert seen[0]["index-entries-removed"] >= 3 and seen[2:] == [False, True, True]


def test_remove_mixed_index():
    def scenario(pkg, g):
        _seed(g)
        mgmt = g.management()
        mgmt.make_property_key("bio", str)
        tx = g.new_transaction()
        tx.add_vertex(bio="some words here")
        tx.commit()
        mgmt.build_mixed_index("bios", ["bio"], backing="search")
        t = g.traversal().V().has("bio", pkg.P.text_contains("words"))
        seen = [len(t.to_list()),
                plan(g.traversal().V().has("bio", pkg.P.text_contains("words")))]
        mgmt.update_index("bios", pkg.mgmt.SchemaAction.DISABLE_INDEX)
        mgmt.update_index("bios", pkg.mgmt.SchemaAction.REMOVE_INDEX)
        provider = g.index_providers["search"]
        q = pkg.IndexQuery(pkg.PredicateCondition("bio", pkg.predicates.Text.CONTAINS, "words"))
        seen += ["bios" in g.indexes, provider.query("bios", q)]
        return seen

    seen = assert_twins(scenario)
    assert seen == [1, {"access": "mixed-index", "index": "bios", "conditions_pushed": 1},
                    False, []]


def test_reindex_via_scan_framework():
    def scenario(pkg, g):
        vids = _seed(g, n=10)
        g.management().build_composite_index("byrank", ["rank"])
        return [_lookup(g, "byrank", [i]) == [vid] for i, vid in enumerate(vids)]

    assert all(assert_twins(scenario))


def test_ghost_vertex_remover():
    def scenario(pkg, g):
        vids = _seed(g)
        es, st = g.edge_serializer, g.system_types
        btx = g.backend.begin_transaction()
        key = g.idm.get_key(vids[0])
        q = es.get_type_slice(st.EXISTS, False)
        cols = [c for c, _ in btx.edge_store_query(pkg.kcvs.KeySliceQuery(key, q))]
        btx.mutate_edges(key, [], cols)  # a half-deleted vertex
        btx.commit()
        g.backend.clear_caches()
        metrics = g.management().ghost_vertex_removal()
        btx = g.backend.begin_transaction()
        left = btx.edge_store_query(pkg.kcvs.KeySliceQuery(key, pkg.kcvs.SliceQuery()))
        tx = g.new_transaction()
        alive = tx.get_vertex(vids[1]) is not None
        tx.rollback()
        return [len(cols), dict(metrics.custom), metrics.rows_processed, left, alive]

    seen = assert_twins(scenario)
    assert seen[0] == 1 and seen[1] == {"ghost-removed": 1} and seen[3:] == [[], True]


def test_status_watcher():
    def scenario(pkg, g):
        mgmt = g.management()
        mgmt.make_property_key("w", str)
        mgmt.build_composite_index("wi", ["w"])
        return [mgmt.await_graph_index_status("wi", "ENABLED", timeout_s=1.0),
                mgmt.await_graph_index_status("wi", "DISABLED", timeout_s=0.05)]

    assert assert_twins(scenario) == [True, False]


def test_status_survives_reopen():
    def scenario(pkg, g):
        mgmt = g.management()
        mgmt.make_property_key("k", str)
        mgmt.build_composite_index("ki", ["k"])
        mgmt.update_index("ki", pkg.mgmt.SchemaAction.DISABLE_INDEX)
        g2 = pkg.open(dict(pkg.config), store_manager=g.backend.manager)
        try:
            return g2.indexes["ki"].status
        finally:
            g2.close()

    assert assert_twins(scenario) == "DISABLED"


def test_print_schema_overview():
    def scenario(pkg, g):
        pkg.gods.load(g)
        m = g.management()
        m.make_property_key("session", str)
        m.set_ttl("session", 60)
        m.make_edge_label("fought")
        m.set_consistency("fought", pkg.codecs.Consistency.FORK)
        m.build_edge_index("fought", "byTime", ["time"])
        return m.print_schema()

    out = assert_twins(scenario)
    for text in ("--- property keys ---", "sortKey=time", "composite", "ENABLED", "titan",
                 "ttl=60s", "FORK", "on fought [time] BOTH REGISTERED"):
        assert text in out


def test_enumeration():
    def scenario(pkg, g):
        pkg.gods.load(g)
        m = g.management()
        return [sorted(e.name for e in m.property_keys()),
                sorted(e.name for e in m.edge_labels()),
                sorted(e.name for e in m.vertex_labels()),
                sorted((i.name, i.unique, i.status) for i in m.indexes()),
                m.contains("battled"), m.contains("nope"), m.get("name").name]

    seen = assert_twins(scenario)
    assert seen[3] == [("age", False, "ENABLED"), ("name", True, "ENABLED")]


def test_label_constrained_and_multi_key_composite():
    def scenario(pkg, g):
        m = g.management()
        m.make_property_key("first", str)
        m.make_property_key("last", str)
        m.make_vertex_label("person")
        m.build_composite_index("fullname", ["first", "last"])
        m.build_composite_index("personFirst", ["first"], label="person")
        tx = g.new_transaction()
        a = tx.add_vertex("person", first="ada", last="lovelace")
        tx.add_vertex(first="ada", last="byron")
        tx.add_vertex("person", first="alan", last="turing")
        tx.commit()
        P = pkg.P
        queries = [
            lambda s: s.V().has("first", "ada").has("last", "lovelace"),
            lambda s: s.V().has_label("person").has("first", "ada"),
            lambda s: s.V().has("first", "ada"),
            lambda s: s.V().has("first", P.within("ada", "alan")).has(
                "last", P.within("lovelace", "turing", "byron")),
        ]
        seen = [a.id]
        for q in queries:
            seen.append((sorted(v.id for v in q(g.traversal()).to_list()),
                         plan(q(g.traversal()))))
        return seen

    seen = assert_twins(scenario)
    assert seen[1] == ([seen[0]], {"access": "composite-index", "index": "fullname"})
    assert seen[2][1] == {"access": "composite-index", "index": "personFirst"}
    assert seen[3][1] == {"access": "full-scan"}
    assert seen[4][1] == {"access": "composite-index-union", "index": "fullname",
                          "point_lookups": 6}


def test_within_over_the_combination_cap_scans_or_forces():
    """A within() whose point lookups exceed 64 degrades to the scan, or
    under query.force-index runs uncapped."""
    def scenario(pkg, g):
        g.management().make_property_key("k", int)
        g.management().build_composite_index("ki", ["k"])
        tx = g.new_transaction()
        ids = [tx.add_vertex(k=i).id for i in range(70)]
        tx.commit()
        t = lambda s: s.V().has("k", pkg.P.within(*range(65)))  # noqa: E731
        seen = [len(t(g.traversal()).to_list()), plan(t(g.traversal()))]
        forced = pkg.open(dict(pkg.config, **{"query.force-index": True}),
                          store_manager=g.backend.manager)
        try:
            seen += [len(t(forced.traversal()).to_list()), plan(t(forced.traversal()))]
            with pytest.raises(pkg.query_error):
                forced.traversal().V().has("other", 1).to_list()
        finally:
            forced.close()
        return seen + [len(ids)]

    seen = assert_twins(scenario)
    assert seen[:2] == [65, {"access": "full-scan"}]
    assert seen[2:4] == [65, {"access": "composite-index-union", "index": "ki",
                              "point_lookups": 65}]


def test_unique_swap_in_one_transaction():
    """A value released and claimed in one transaction passes the unique
    check; a second claim of one value in a transaction raises."""
    def scenario(pkg, g):
        m = g.management()
        m.make_property_key("handle", str)
        m.build_composite_index("byHandle", ["handle"], unique=True)
        tx = g.new_transaction()
        a, b = tx.add_vertex(handle="x"), tx.add_vertex(handle="y")
        tx.commit()
        tx = g.new_transaction()
        tx.get_vertex(a.id).property("handle", "y")
        tx.get_vertex(b.id).property("handle", "x")
        tx.commit()
        seen = [_lookup(g, "byHandle", ["x"]), _lookup(g, "byHandle", ["y"])]
        tx = g.new_transaction()
        tx.add_vertex(handle="z")
        tx.add_vertex(handle="z")
        with pytest.raises(pkg.schema_error) as e:
            tx.commit()
        tx = g.new_transaction()
        tx.add_vertex(handle="x")
        with pytest.raises(pkg.schema_error) as e2:
            tx.commit()
        return seen + [[a.id, b.id], str(e.value), str(e2.value), _lookup(g, "byHandle", ["z"])]

    seen = assert_twins(scenario)
    a, b = seen[2]
    assert seen[:2] == [[b], [a]] and seen[-1] == []


def test_unique_check_takes_the_index_lock_under_lock_consistency():
    """Two graphs over one store: the second commit of a LOCK-consistency
    unique value fails, in both packages alike."""
    def scenario(pkg, g):
        m = g.management()
        m.make_property_key("email", str)
        m.set_consistency("email", pkg.codecs.Consistency.LOCK)
        m.build_composite_index("byEmail", ["email"], unique=True)
        other = pkg.open(dict(pkg.config, **{"locks.wait-ms": 1.0}),
                         store_manager=g.backend.manager)
        try:
            t1, t2 = g.new_transaction(), other.new_transaction()
            t1.add_vertex(email="a@x")
            t2.add_vertex(email="a@x")
            t1.commit()
            with pytest.raises(Exception) as e:
                t2.commit()
            return [type(e.value).__name__, _lookup(g, "byEmail", ["a@x"]) != []]
        finally:
            other.close()

    ref, port = twin(scenario)
    assert port[0] == ref[0] and port[0][1]
