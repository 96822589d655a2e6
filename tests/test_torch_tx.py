"""The port's OLTP transaction held to the JAX package's.

Both packages open an in-memory graph and run the same transactions: new
vertices with labels and properties (SINGLE, LIST and SET keys, meta
properties), edges with inline properties and sort keys, caller-chosen
vertex ids, property, edge and vertex removals, a rewrite of a loaded
edge's property. After every commit their ``edgestore`` and
``graphindex`` rows are byte-equal, and their reads (``get_vertex``,
``vertices``, ``get_properties``, ``get_edges``, ``get_edge``,
``get_vertex_label``) give the same ids and values. Rollback leaves the
store untouched in both; schema, multiplicity and read-only errors raise in
both; what reaches a layer the port lacks raises naming its ROADMAP item,
and a user log, which the port now has, commits through the WAL.
Exact equality throughout: these are bytes and ids, no tolerance applies.
"""

from types import SimpleNamespace

import pytest

from janusgraph_tpu.core import codecs as ref_codecs
from janusgraph_tpu.core.graph import open_graph as ref_open_graph
from janusgraph_tpu.exceptions import InvalidElementError as RefInvalid
from janusgraph_tpu.exceptions import ReadOnlyTransactionError as RefReadOnly
from janusgraph_tpu.exceptions import SchemaViolationError as RefSchemaError
from janusgraph_tpu_torch.core import codecs
from janusgraph_tpu_torch.core.graph import open_graph
from janusgraph_tpu_torch.exceptions import (
    ConfigurationError,
    InvalidElementError,
    ReadOnlyTransactionError,
    SchemaViolationError,
)
from janusgraph_tpu_torch.storage.inmemory import InMemoryStoreManager

REF_CONFIG = {"computer.sharded-auto": False, "graph.set-vertex-id": True}
PORT_CONFIG = {"computer.executor": "cpu", "graph.set-vertex-id": True}

REF = SimpleNamespace(open=ref_open_graph, codecs=ref_codecs, config=REF_CONFIG,
                      schema_error=RefSchemaError, invalid=RefInvalid, read_only=RefReadOnly)
PORT = SimpleNamespace(open=open_graph, codecs=codecs, config=PORT_CONFIG,
                       schema_error=SchemaViolationError, invalid=InvalidElementError,
                       read_only=ReadOnlyTransactionError)


def _rows(graph, names=("edgestore", "graphindex")):
    mgr = graph.backend.manager
    return {
        name: {k: list(zip(r.columns, r.values)) for k, r in mgr.open_database(name)._rows.items()}
        for name in names
    }


def _schema(g, pkg):
    c = pkg.codecs
    mgmt = g.management()
    mgmt.make_property_key("name", str)
    mgmt.make_property_key("tags", str, c.Cardinality.LIST)
    mgmt.make_property_key("colors", str, c.Cardinality.SET)
    mgmt.make_property_key("weight", float)
    mgmt.make_property_key("since", int)
    mgmt.make_edge_label("knows")
    mgmt.make_edge_label("rated", sort_key=["since"])
    mgmt.make_edge_label("married", c.Multiplicity.ONE2ONE)
    mgmt.make_edge_label("likes", c.Multiplicity.SIMPLE)
    mgmt.make_vertex_label("person")


def _build(pkg):
    """The same schema and three transactions on one package's graph;
    returns the graph, the vertex ids, and the rows after each commit."""
    c = pkg.codecs
    g = pkg.open(dict(pkg.config))
    _schema(g, pkg)
    after = []
    tx = g.new_transaction()
    a = tx.add_vertex("person", name="a", weight=1)
    b = tx.add_vertex("person", name="b")
    d = tx.add_vertex()
    a.property("tags", "x")
    a.property("tags", "x")
    a.property("colors", "red")
    a.property("colors", "red")
    a.property("colors", "blue", weight=0.5)
    b.property("name", "bee", weight=2.0)
    tx.add_edge(a, "knows", b, weight=0.25)
    tx.add_edge(a, "rated", d, since=2020)
    tx.add_edge(b, "rated", d, since=-7, weight=3.0)
    tx.add_edge(a, "married", b)
    tx.add_edge(d, "likes", d)
    tx.add_edge(a, "link", d)  # auto-made label
    custom = g.idm.make_vertex_id(12345, 3)
    e = tx.add_vertex(vertex_id=custom, name="custom")
    tx.add_edge(e, "knows", a)
    assert tx.has_mutations()
    tx.commit()
    after.append(_rows(g))

    tx = g.new_transaction()
    va, vb, vd = (tx.get_vertex(v.id) for v in (a, b, d))
    va.property("name", "a2")  # SINGLE: replaces the loaded cell
    for p in tx.get_properties(va, "tags"):
        p.remove()
    knows = tx.get_edges(va, c.Direction.OUT, ("knows",))[0]
    knows.set_property("weight", 0.75)  # a loaded edge is rewritten
    tx.get_edges(vb, c.Direction.OUT, ("rated",))[0].remove()
    tx.add_edge(vd, "knows", va)
    tx.commit()
    after.append(_rows(g))

    tx = g.new_transaction()
    tx.remove_vertex(tx.get_vertex(custom))
    f = tx.add_vertex("person", name="gone")
    tx.add_edge(f, "knows", tx.get_vertex(a.id))
    tx.remove_vertex(f)  # added and removed in one tx: never written
    tx.commit()
    after.append(_rows(g))
    return g, [a.id, b.id, d.id, custom], after


@pytest.fixture(scope="module")
def built():
    ref = _build(REF)
    got = _build(PORT)
    yield ref, got
    ref[0].close()
    got[0].close()


def test_transactions_write_the_reference_rows(built):
    (_r, ref_ids, ref_after), (_g, ids, after) = built
    assert ids == ref_ids
    for k, (want, have) in enumerate(zip(ref_after, after)):
        assert have == want, f"rows differ after commit {k}"


def _read(g, pkg, ids):
    c = pkg.codecs
    tx = g.new_transaction(read_only=True)
    out = {"vertices": sorted(v.id for v in tx.vertices())}
    for vid in ids:
        v = tx.get_vertex(vid)
        if v is None:
            out[vid] = None
            continue
        out[vid] = {
            "label": tx.get_vertex_label(v),
            "props": sorted((p.key, repr(p.value), p.id, sorted(p.property_values().items()))
                            for p in tx.get_properties(v)),
            "name": v.value("name"),
            "tags": v.values("tags"),
            "edges": {
                d.name: sorted((e.id, e.label, e.out_vertex.id, e.in_vertex.id,
                                sorted(e.property_values().items()))
                               for e in tx.get_edges(v, d, ()))
                for d in (c.Direction.OUT, c.Direction.IN, c.Direction.BOTH)
            },
            "knows_out": sorted(x.id for x in v.vertices(c.Direction.OUT, "knows")),
        }
        for e in tx.get_edges(v, c.Direction.OUT, ()):
            got = tx.get_edge(str(e.identifier))
            assert got is not None and got.id == e.id
    tx.rollback()
    return out


def test_reads_equal_reference(built):
    (ref, ref_ids, _), (got, ids, _) = built
    want = _read(ref, REF, ref_ids)
    have = _read(got, PORT, ids)
    assert have == want
    assert have[ids[3]] is None and have[ids[0]]["name"] == "a2"


def test_reads_inside_a_transaction_see_its_own_writes():
    for pkg in (REF, PORT):
        g = pkg.open(dict(pkg.config))
        c = pkg.codecs
        tx = g.new_transaction()
        a, b = tx.add_vertex(name="a"), tx.add_vertex()
        loop = tx.add_edge(a, "self", a)
        tx.add_edge(a, "e", b)
        assert len(tx.get_edges(a, c.Direction.BOTH, ())) == 3  # the loop twice
        assert len(tx.get_edges(a, c.Direction.OUT, ("e",))) == 1
        tx.remove_edge(loop)
        assert [e.label for e in tx.get_edges(a, c.Direction.BOTH, ())] == ["e"]
        assert sorted(v.id for v in tx.vertices()) == sorted([a.id, b.id])
        tx.commit()
        g.close()


def test_rollback_leaves_the_store_untouched():
    for pkg in (REF, PORT):
        g = pkg.open(dict(pkg.config))
        tx = g.new_transaction()
        v = tx.add_vertex(name="kept")
        tx.add_edge(v, "e", tx.add_vertex(name="other"))
        tx.commit()
        # schema is made outside the transaction, so all of it exists now
        before = _rows(g)
        epoch = g.backend.mutation_epoch()
        tx = g.new_transaction()
        tx.add_edge(tx.get_vertex(v.id), "e", tx.add_vertex(name="new"))
        tx.get_vertex(v.id).property("name", "changed")
        tx.rollback()
        assert _rows(g) == before
        assert g.backend.mutation_epoch() == epoch
        with pytest.raises(pkg.invalid):
            tx.add_vertex()
        g.close()


@pytest.mark.parametrize("case", [
    "wrong_type", "not_a_key", "not_a_label", "one2one_out", "one2one_in",
    "simple_twice", "sort_key_missing",
])
def test_schema_and_multiplicity_errors_raise_in_both(case):
    for pkg in (REF, PORT):
        g = pkg.open(dict(pkg.config))
        _schema(g, pkg)
        tx = g.new_transaction()
        a, b, c = tx.add_vertex(), tx.add_vertex(), tx.add_vertex()
        tx.add_edge(a, "married", b)
        tx.add_edge(a, "likes", b)
        tx.commit()
        before = _rows(g)
        tx = g.new_transaction()
        a, b, c = (tx.get_vertex(v.id) for v in (a, b, c))
        act = {
            "wrong_type": lambda: a.property("since", "soon"),
            "not_a_key": lambda: a.property("knows", 1),
            "not_a_label": lambda: tx.add_edge(a, "name", b),
            "one2one_out": lambda: tx.add_edge(a, "married", c),
            "one2one_in": lambda: tx.add_edge(c, "married", b),
            "simple_twice": lambda: tx.add_edge(a, "likes", b),
            "sort_key_missing": lambda: tx.add_edge(a, "rated", b),
        }[case]
        with pytest.raises(pkg.schema_error):
            act()
        tx.commit()
        assert _rows(g) == before, case
        g.close()


def test_read_only_and_custom_id_rules_raise_in_both():
    for pkg in (REF, PORT):
        g = pkg.open(dict(pkg.config))
        with pytest.raises(pkg.read_only):
            g.new_transaction(read_only=True).add_vertex()
        tx = g.new_transaction()
        with pytest.raises(pkg.invalid):
            # a partitioned-vertex id (suffix 0b010) is not a NORMAL one
            tx.add_vertex(vertex_id=g.idm.make_vertex_id(9, 0) | 0b010)
        vid = g.idm.make_vertex_id(77, 1)
        tx.add_vertex(vertex_id=vid)
        tx.commit()
        with pytest.raises(pkg.invalid):
            g.new_transaction().add_vertex(vertex_id=vid)  # exists
        g.close()
        g = pkg.open({k: v for k, v in pkg.config.items() if k != "graph.set-vertex-id"})
        with pytest.raises(pkg.invalid):
            g.new_transaction().add_vertex(vertex_id=vid)
        g.close()


def test_what_the_port_lacks_raises_naming_its_item():
    g = open_graph(dict(PORT_CONFIG))
    # a user log (log_identifier) is ported since the WAL is: the commit
    # writes the txlog's four markers (tests/test_torch_txlog.py holds them
    # to the reference)
    from janusgraph_tpu_torch.core.txlog import LogTxStatus, decode_tx_entry

    tx = g.new_transaction(log_identifier="audit")
    tx.add_vertex(name="x")
    tx.commit()
    statuses = [decode_tx_entry(m.content).status
                for m in g.log_manager.open_log("txlog").read_range(0)]
    assert statuses == [LogTxStatus.PRECOMMIT, LogTxStatus.PREFLUSH,
                        LogTxStatus.PRIMARY_SUCCESS, LogTxStatus.SECONDARY_SUCCESS]
    # a metrics group counts its commits (the registry is ported)
    from janusgraph_tpu_torch.observability import registry

    before_commits = registry.get_count("web.commit")
    g.new_transaction(metrics_group="web").commit()
    assert registry.get_count("web.commit") == before_commits + 1
    assert open_graph({"tx.read-only-default": True}).new_transaction().read_only
    # allow-pickle takes a str in both packages; fast-property, once
    # refused, is taken as the reference takes it
    with pytest.raises(ConfigurationError):
        open_graph({"attributes.allow-pickle": True})
    for opener in (open_graph, ref_open_graph):
        fast = opener({"query.fast-property": True})
        assert fast.config.get("query.fast-property") is True
        fast.close()
    wal = open_graph({"tx.log-tx": True})
    assert wal._wal_enabled
    wal.close()
    g.close()
    # a LOCK-consistency label written by the reference commits through the
    # locker in both packages, to equal rows, and leaves no lock claim
    ref = ref_open_graph(dict(REF_CONFIG))
    ref.management().make_edge_label("locked")
    ref.management().set_consistency("locked", ref_codecs.Consistency.LOCK)
    rows = {name: {k: list(zip(r.columns, r.values)) for k, r in st._rows.items()}
            for name, st in ref.backend.manager._stores.items()}
    ref.close()
    from janusgraph_tpu.storage.inmemory import InMemoryStoreManager as RefManager

    ref_mgr = RefManager()
    for name, store_rows in rows.items():
        store = ref_mgr.open_database(name)
        for key, entries in store_rows.items():
            store.mutate(key, entries, [], ref_mgr.begin_transaction())
    after = []
    for graph in (ref_open_graph(dict(REF_CONFIG, **{"locks.wait-ms": 0.0}), store_manager=ref_mgr),
                  open_graph(dict(PORT_CONFIG, **{"locks.wait-ms": 0.0}),
                             store_manager=InMemoryStoreManager.from_rows(rows))):
        tx = graph.new_transaction()
        tx.add_edge(tx.add_vertex(), "locked", tx.add_vertex())
        tx.commit()
        after.append(_rows(graph, ("edgestore", "graphindex", "edgestore_lock_")))
        graph.close()
    assert after[0] == after[1]
    assert not after[1]["edgestore_lock_"]
