"""Consistency modifiers and TTLs in the port, held to the JAX package's,
after the reference's ``tests/test_consistency.py``, ``test_schema_ttl.py``
and the TTL cases of ``test_storage_adapters.py`` (the remote-store cases
wait for #5.5, the index and ghost-remover cases for #5.2).

Each case runs on both packages with the same calls and must end the same
way: LOCK consistency rejects the stale one of two concurrent writers (two
graph instances over one store) and lets sequential commits through; FORK
gives an updated edge a fresh relation id; a TTL'd property, edge or
static vertex label stops being read once its cells expire (the expiry
stamps are rewound rather than waited for); the in-memory store's cell
TTL, the TTL store wrapper and their purges; ``set_ttl`` refuses a store
without cell TTL. Where both packages write, their rows are byte-equal
(the expiry stamps aside: they are the clock's). Exact equality throughout.
"""

import time
from types import SimpleNamespace

import pytest

from janusgraph_tpu.core import codecs as ref_codecs
from janusgraph_tpu.core.graph import open_graph as ref_open_graph
from janusgraph_tpu.exceptions import SchemaViolationError as RefSchemaError
from janusgraph_tpu.storage import kcvs as ref_kcvs
from janusgraph_tpu.storage import ttl as ref_ttl
from janusgraph_tpu.storage.inmemory import InMemoryStoreManager as RefManager
from janusgraph_tpu.storage.localstore import open_local_kcvs as ref_open_local
from janusgraph_tpu_torch.core import codecs
from janusgraph_tpu_torch.core.graph import open_graph
from janusgraph_tpu_torch.exceptions import SchemaViolationError
from janusgraph_tpu_torch.storage import kcvs, ttl
from janusgraph_tpu_torch.storage.inmemory import InMemoryStoreManager
from janusgraph_tpu_torch.storage.localstore import open_local_kcvs

PKGS = {
    "ref": SimpleNamespace(open=ref_open_graph, Manager=RefManager, codecs=ref_codecs,
                           kcvs=ref_kcvs, ttl=ref_ttl, SchemaError=RefSchemaError,
                           open_local=ref_open_local),
    "port": SimpleNamespace(open=open_graph, Manager=InMemoryStoreManager, codecs=codecs,
                            kcvs=kcvs, ttl=ttl, SchemaError=SchemaViolationError,
                            open_local=open_local_kcvs),
}
CFG = {"ids.authority-wait-ms": 0.0, "locks.wait-ms": 0.0}


@pytest.fixture(params=["ref", "port"])
def pkg(request):
    return PKGS[request.param]


def _raw_store(store):
    while hasattr(store, "wrapped"):
        store = store.wrapped
    return store


def _expire_all(g):
    """Rewind every recorded expiry by two seconds and drop the caches."""
    store = _raw_store(g.backend.edgestore)
    for k in list(store._expiry):
        store._expiry[k] -= 2_000_000_000
    g.backend.clear_caches()


# ------------------------------------------------------------ consistency
def test_consistency_roundtrip_validation_and_reopen(pkg):
    mgr = pkg.Manager()
    g = pkg.open(dict(CFG), store_manager=mgr)
    m = g.management()
    m.make_property_key("serial", int)
    m.make_edge_label("follows")
    m.set_consistency("serial", pkg.codecs.Consistency.LOCK)
    m.set_consistency("follows", pkg.codecs.Consistency.FORK)
    assert m.get_consistency("serial") is pkg.codecs.Consistency.LOCK
    assert m.get_consistency("follows") is pkg.codecs.Consistency.FORK
    with pytest.raises(pkg.SchemaError):
        m.set_consistency("serial", pkg.codecs.Consistency.FORK)
    with pytest.raises(pkg.SchemaError):
        m.get_consistency("nothing")
    g.close()
    g2 = pkg.open(dict(CFG), store_manager=mgr)
    assert g2.management().get_consistency("serial") is pkg.codecs.Consistency.LOCK
    g2.close()


def test_lock_consistency_rejects_the_stale_writer(pkg):
    mgr = pkg.Manager()
    g1 = pkg.open(dict(CFG), store_manager=mgr)
    g1.management().make_property_key("serial", int)
    g1.management().set_consistency("serial", pkg.codecs.Consistency.LOCK)
    tx = g1.new_transaction()
    v = tx.add_vertex()
    v.property("serial", 1)
    tx.commit()
    g2 = pkg.open(dict(CFG), store_manager=mgr)
    tx1, tx2 = g1.new_transaction(), g2.new_transaction()
    tx1.get_vertex(v.id).property("serial", 2)
    tx2.get_vertex(v.id).property("serial", 3)
    tx1.commit()  # the first writer wins
    rows = {k: list(r.columns) for k, r in mgr.open_database("edgestore")._rows.items()}
    with pytest.raises(Exception, match="expected value"):
        tx2.commit()
    assert {k: list(r.columns) for k, r in mgr.open_database("edgestore")._rows.items()} == rows
    g3 = pkg.open(dict(CFG), store_manager=mgr)
    assert g3.new_transaction().get_vertex(v.id).value("serial") == 2
    assert not mgr.open_database("edgestore_lock_")._rows
    for g in (g1, g2, g3):
        g.close()


def _sequential_lock_commits(pkg):
    g = pkg.open(dict(CFG, **{"graph.set-vertex-id": True}))
    g.management().make_property_key("serial", int)
    g.management().make_edge_label("owns")
    g.management().set_consistency("serial", pkg.codecs.Consistency.LOCK)
    g.management().set_consistency("owns", pkg.codecs.Consistency.LOCK)
    tx = g.new_transaction()
    v = tx.add_vertex(vertex_id=g.idm.make_vertex_id(5, 3))
    w = tx.add_vertex(vertex_id=g.idm.make_vertex_id(6, 4))
    v.property("serial", 1)
    tx.add_edge(v, "owns", w)
    tx.commit()
    for i in (2, 3, 4):
        txi = g.new_transaction()
        txi.get_vertex(v.id).property("serial", i)
        txi.commit()
    assert g.new_transaction().get_vertex(v.id).value("serial") == 4
    rows = {k: list(zip(r.columns, r.values))
            for k, r in g.backend.manager.open_database("edgestore")._rows.items()}
    g.close()
    return rows


def test_lock_consistency_sequential_commits_write_the_reference_rows():
    """Sequential LOCK commits go through, to byte-equal rows."""
    assert _sequential_lock_commits(PKGS["port"]) == _sequential_lock_commits(PKGS["ref"])


def test_fork_and_default_edge_updates(pkg):
    g = pkg.open(dict(CFG))
    m = g.management()
    m.make_property_key("since", int)
    m.make_edge_label("follows")
    m.make_edge_label("knows")
    m.set_consistency("follows", pkg.codecs.Consistency.FORK)
    tx = g.new_transaction()
    a, b = tx.add_vertex(), tx.add_vertex()
    ef = tx.add_edge(a, "follows", b, since=1)
    ek = tx.add_edge(a, "knows", b, since=1)
    tx.commit()
    tx2 = g.new_transaction()
    D = pkg.codecs.Direction
    [f2] = tx2.get_vertex(a.id).edges(D.OUT, "follows")
    [k2] = tx2.get_vertex(a.id).edges(D.OUT, "knows")
    nf = tx2.set_edge_property(f2, "since", 2)
    nk = tx2.set_edge_property(k2, "since", 2)
    assert nf.id != ef.id and nk.id == ek.id
    tx2.commit()
    tx3 = g.new_transaction()
    [f3] = tx3.get_vertex(a.id).edges(D.OUT, "follows")
    assert f3.value("since") == 2 and f3.id == nf.id
    g.close()


# ------------------------------------------------------------------- TTL
def test_ttl_roundtrip_validation_and_persistence(pkg):
    mgr = pkg.Manager()
    g = pkg.open(store_manager=mgr)
    m = g.management()
    m.make_property_key("session", str)
    m.set_ttl("session", 0)
    m.set_ttl("session", 3600)
    assert m.get_ttl("session") == 3600
    with pytest.raises(pkg.SchemaError):
        m.set_ttl("session", -1)
    with pytest.raises(pkg.SchemaError):
        m.set_ttl("nope", 10)
    m.make_vertex_label("event")
    with pytest.raises(pkg.SchemaError, match="static"):
        m.set_ttl("event", 60)
    g.close()
    g2 = pkg.open(store_manager=mgr)
    assert g2.management().get_ttl("session") == 3600
    g2.close()


def test_property_and_edge_ttl_expire(pkg):
    g = pkg.open(dict(CFG))
    m = g.management()
    m.make_property_key("session", str)
    m.make_property_key("name", str)
    m.make_edge_label("visited")
    m.set_ttl("session", 1)
    m.set_ttl("visited", 1)
    tx = g.new_transaction()
    v, w = tx.add_vertex(), tx.add_vertex()
    v.property("session", "tok")
    v.property("name", "alice")
    tx.add_edge(v, "visited", w)
    t0 = time.time_ns()
    tx.commit()
    store = _raw_store(g.backend.edgestore)
    stamps = sorted(store._expiry.values())
    assert len(stamps) == 3  # the property cell, the edge's OUT and IN cells
    assert all(t0 + 10**9 <= s <= time.time_ns() + 10**9 for s in stamps)
    D = pkg.codecs.Direction
    tx2 = g.new_transaction()
    assert tx2.get_vertex(v.id).value("session") == "tok"
    assert len(tx2.get_vertex(v.id).edges(D.OUT, "visited")) == 1
    _expire_all(g)
    tx3 = g.new_transaction()
    assert tx3.get_vertex(v.id).value("session") is None
    assert tx3.get_vertex(v.id).value("name") == "alice"
    assert tx3.get_vertex(v.id).edges(D.OUT, "visited") == []
    assert store.purge_expired() == 3 and not store._expiry
    g.close()


def test_static_vertex_label_ttl_folds_into_its_relations(pkg):
    g = pkg.open(dict(CFG))
    m = g.management()
    m.make_vertex_label("tick", static=True)
    m.set_ttl("tick", 1)
    m.make_property_key("at", int)
    tx = g.new_transaction()
    v = tx.add_vertex(label="tick")
    v.property("at", 7)
    u = tx.add_vertex()
    u.property("at", 9)
    tx.commit()
    assert len(_raw_store(g.backend.edgestore)._expiry) == 3  # exists, label, at
    assert g.new_transaction().get_vertex(v.id).value("at") == 7
    _expire_all(g)
    tx3 = g.new_transaction()
    assert tx3.get_vertex(v.id) is None
    assert tx3.get_vertex(u.id).value("at") == 9
    g.close()


def test_inmemory_cell_ttl(pkg):
    m = pkg.Manager()
    assert m.features.cell_ttl
    s = m.open_database("t")
    stx = m.begin_transaction()
    K = pkg.kcvs
    s.mutate(b"k", [(b"a", b"1", 1), (b"b", b"2", 1), (b"c", b"3"), (b"d", b"4")], [], stx)
    # a limited slice counts live cells only
    assert s.get_slice(K.KeySliceQuery(b"k", K.SliceQuery(limit=2)), stx) == [
        (b"c", b"3"), (b"d", b"4")]
    assert list(s.get_keys(K.SliceQuery(), stx)) == [(b"k", [(b"c", b"3"), (b"d", b"4")])]
    exp = time.time_ns() + 10**12
    s.mutate(b"k2", [(b"a", b"1", exp)], [b"a"], stx)  # the addition overrides
    assert s._expiry[(b"k2", b"a")] == exp
    assert s.purge_expired() == 2 and s.row_count() == 2
    s.mutate(b"k2", [(b"a", b"plain")], [], stx)  # rewritten without a TTL
    assert (b"k2", b"a") not in s._expiry


def test_ttl_store_manager(pkg):
    K = pkg.kcvs
    mgr = pkg.ttl.TTLStoreManager(pkg.Manager(), default_ttl_seconds=0.05,
                                  per_store_ttl={"permanent": 0.0})
    assert mgr.features.cell_ttl
    s, p = mgr.open_database("s"), mgr.open_database("permanent")
    tx = mgr.begin_transaction()
    s.mutate(b"k", [(b"c", b"v")], [], tx)
    mgr.mutate_many({"permanent": {b"k": K.KCVMutation(additions=[(b"c", b"v")])}}, tx)
    q = K.KeySliceQuery(b"k", K.SliceQuery())
    assert s.get_slice(q, tx) == [(b"c", b"v")]
    time.sleep(0.08)
    assert s.get_slice(q, tx) == [] and list(s.get_keys(K.SliceQuery(), tx)) == []
    assert p.get_slice(q, tx) == [(b"c", b"v")]
    assert s.purge_expired(tx) == 1 and s.purge_expired(tx) == 0
    # a graph over the wrapper takes per-cell TTLs as 3-tuples
    g = pkg.open(store_manager=pkg.ttl.TTLStoreManager(pkg.Manager()))
    g.management().make_property_key("session", str)
    g.management().set_ttl("session", 3600)
    tx = g.new_transaction()
    v = tx.add_vertex()
    v.property("session", "tok")
    tx.commit()
    assert g.new_transaction().get_vertex(v.id).value("session") == "tok"
    g.close()


def test_ttl_refused_over_the_local_store(pkg, tmp_path):
    g = pkg.open(store_manager=pkg.open_local(str(tmp_path)))
    assert not g.backend.manager.features.cell_ttl
    g.management().make_property_key("s", str)
    with pytest.raises(pkg.SchemaError, match="cell TTL"):
        g.management().set_ttl("s", 10)
    g.close()
