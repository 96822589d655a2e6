"""Schema constraints and ``schema.default`` in the port, held to the JAX
package's, after the reference's ``tests/test_schema_constraints.py``
(``print_schema`` is management enumeration, not ported).

Each case runs on both packages with the same calls and must end the same
way: with ``schema.constraints``, a labelled element takes only declared
keys and an edge only declared connections (``add_properties``,
``add_connection``), the default label is exempt, auto schema declares on
first write (also under concurrent writers, and beside a concurrent
``set_consistency``), a rejected write declares nothing, declarations
survive a reopen, and without the option they do not bind. The schema
rows the declarations persist are byte-equal between the packages.
"""

import threading
from types import SimpleNamespace

import pytest

from janusgraph_tpu.core import codecs as ref_codecs
from janusgraph_tpu.core.graph import open_graph as ref_open_graph
from janusgraph_tpu.exceptions import SchemaViolationError as RefSchemaError
from janusgraph_tpu.storage.inmemory import InMemoryStoreManager as RefManager
from janusgraph_tpu_torch.core import codecs
from janusgraph_tpu_torch.core.graph import open_graph
from janusgraph_tpu_torch.exceptions import SchemaViolationError
from janusgraph_tpu_torch.storage.inmemory import InMemoryStoreManager

PKGS = {
    "ref": SimpleNamespace(open=ref_open_graph, Manager=RefManager, codecs=ref_codecs,
                           SchemaError=RefSchemaError),
    "port": SimpleNamespace(open=open_graph, Manager=InMemoryStoreManager, codecs=codecs,
                            SchemaError=SchemaViolationError),
}
STRICT = {"schema.default": "none", "schema.constraints": True}


@pytest.fixture(params=["ref", "port"])
def pkg(request):
    return PKGS[request.param]


def _strict_graph(pkg, store_manager=None):
    g = pkg.open(dict(STRICT), store_manager=store_manager)
    m = g.management()
    m.make_vertex_label("person")
    m.make_vertex_label("city")
    m.make_property_key("name", str)
    m.make_property_key("age", int)
    m.make_property_key("weight", float)
    m.make_edge_label("lives_in")
    m.add_properties("person", "name", "age")
    m.add_properties("lives_in", "weight")
    m.add_connection("lives_in", "person", "city")
    return g


def test_declared_writes_pass_and_undeclared_reject(pkg):
    g = _strict_graph(pkg)
    tx = g.new_transaction()
    p = tx.add_vertex("person", name="ada", age=36)
    c = tx.add_vertex("city")
    tx.add_edge(p, "lives_in", c, weight=1.0)
    tx.commit()
    tx = g.new_transaction()
    with pytest.raises(pkg.SchemaError, match="not declared"):
        tx.get_vertex(p.id).property("weight", 2.0)
    a = tx.add_vertex("person", name="a")
    with pytest.raises(pkg.SchemaError, match="connection"):
        tx.add_edge(a, "lives_in", tx.add_vertex("person", name="b"))
    with pytest.raises(pkg.SchemaError, match="not declared"):
        tx.add_edge(a, "lives_in", tx.add_vertex("city"), name="home")
    e = tx.add_edge(a, "lives_in", tx.add_vertex("city"))
    with pytest.raises(pkg.SchemaError, match="not declared"):
        e.set_property("name", "home")
    e.set_property("weight", 3.0)
    tx.commit()
    g.close()


def test_schema_default_none_refuses_undefined_types(pkg):
    g = pkg.open({"schema.default": "none"})
    tx = g.new_transaction()
    with pytest.raises(pkg.SchemaError, match="undefined vertex label"):
        tx.add_vertex("nobody")
    v = tx.add_vertex()  # the default label always exists
    with pytest.raises(pkg.SchemaError, match="undefined property key"):
        v.property("nokey", 1)
    with pytest.raises(pkg.SchemaError, match="undefined edge label"):
        tx.add_edge(v, "noedge", tx.add_vertex())
    tx.rollback()
    g.close()


def test_default_label_exempt(pkg):
    g = pkg.open(dict(STRICT))
    m = g.management()
    m.make_property_key("note", str)
    m.make_edge_label("rel")
    tx = g.new_transaction()
    a = tx.add_vertex(note="free")
    tx.add_edge(a, "rel", tx.add_vertex())
    tx.commit()
    g.close()


def test_auto_schema_auto_creates_constraints(pkg):
    g = pkg.open({"schema.default": "auto", "schema.constraints": True})
    g.management().make_vertex_label("thing")
    g.management().make_vertex_label("place")
    tx = g.new_transaction()
    t = tx.add_vertex("thing", kind="widget")
    tx.add_edge(t, "at", tx.add_vertex("place"), since=3)
    tx.commit()
    vl = g.schema_cache.get_by_name("thing")
    el = g.schema_cache.get_by_name("at")
    assert vl.allowed_property_ids == (g.schema_cache.get_by_name("kind").id,)
    assert el.allowed_property_ids == (g.schema_cache.get_by_name("since").id,)
    assert el.connections == ((vl.id, g.schema_cache.get_by_name("place").id),)
    g.close()


def test_constraints_survive_reopen(pkg):
    sm = pkg.Manager()
    _strict_graph(pkg, store_manager=sm).close()
    g2 = pkg.open(dict(STRICT), store_manager=sm)
    assert len(g2.schema_cache.get_by_name("person").allowed_property_ids) == 2
    assert len(g2.schema_cache.get_by_name("lives_in").connections) == 1
    tx = g2.new_transaction()
    p = tx.add_vertex("person", name="ok")
    with pytest.raises(pkg.SchemaError):
        tx.add_edge(p, "lives_in", tx.add_vertex("person", name="x"))
    tx.rollback()
    g2.close()


def test_declarations_write_the_reference_rows():
    rows = []
    for name in ("ref", "port"):
        sm = PKGS[name].Manager()
        _strict_graph(PKGS[name], store_manager=sm).close()
        rows.append({store: {k: list(zip(r.columns, r.values)) for k, r in
                             sm.open_database(store)._rows.items()}
                     for store in ("edgestore", "graphindex")})
    assert rows[0] == rows[1]


def test_disabled_by_default_no_enforcement(pkg):
    g = pkg.open({"schema.default": "none"})
    m = g.management()
    m.make_vertex_label("person")
    m.make_property_key("name", str)
    m.make_property_key("other", str)
    m.add_properties("person", "name")
    tx = g.new_transaction()
    tx.add_vertex("person", other="fine")
    tx.commit()
    g.close()


def test_management_refuses_wrong_kinds(pkg):
    g = _strict_graph(pkg)
    m = g.management()
    with pytest.raises(pkg.SchemaError):
        m.add_properties("name", "age")  # a key is not a label
    with pytest.raises(pkg.SchemaError):
        m.add_properties("person", "city")  # a label is not a key
    with pytest.raises(pkg.SchemaError):
        m.add_connection("person", "person", "city")
    with pytest.raises(pkg.SchemaError):
        m.add_connection("lives_in", "person", "name")
    g.close()


def test_concurrent_auto_declarations_and_modifiers_are_not_lost(pkg):
    g = pkg.open({"schema.default": "auto", "schema.constraints": True})
    g.management().make_vertex_label("thing")
    g.management().make_property_key("guarded", str)
    errors = []

    def write(key):
        try:
            tx = g.new_transaction()
            tx.add_vertex("thing", **{key: "v"})
            tx.commit()
        except Exception as e:  # noqa: BLE001
            errors.append(repr(e))

    def modify():
        try:
            g.management().set_consistency("guarded", pkg.codecs.Consistency.LOCK)
        except Exception as e:  # noqa: BLE001
            errors.append(repr(e))

    ts = [threading.Thread(target=write, args=(k,)) for k in ("alpha", "beta", "gamma")]
    ts.append(threading.Thread(target=modify))
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=60)
    assert not errors, errors
    vl = g.schema_cache.get_by_name("thing")
    assert {g.schema_cache.get_by_id(i).name for i in vl.allowed_property_ids} == {
        "alpha", "beta", "gamma"}
    assert g.management().get_consistency("guarded") is pkg.codecs.Consistency.LOCK
    g.close()


def test_rejected_type_write_leaves_no_schema_mutation(pkg):
    g = pkg.open({"schema.default": "auto", "schema.constraints": True})
    g.management().make_vertex_label("person")
    g.management().make_property_key("age", int)
    tx = g.new_transaction()
    v = tx.add_vertex("person")
    with pytest.raises(pkg.SchemaError, match="expects"):
        v.property("age", "not-a-number")
    assert g.schema_cache.get_by_name("person").allowed_property_ids == ()
    tx.rollback()
    g.close()
