"""The port's transaction WAL, user logs and recovery held to the JAX
package's.

Each scenario runs on both packages over the same operations (ids are
deterministic, as ``tests/test_torch_tx.py`` shows): the WAL's status
sequence and change records of every commit; a user log processor's view
of commits and deletions; ``TransactionRecovery`` healing a failed
secondary and leaving an in-flight transaction alone; ``TornCommitRecovery``
rolling a torn commit forward (composite index rows and mixed-index
documents included) and a PRECOMMIT-only one back, idempotently. A torn
commit the reference left in a local directory, healed by the port's open,
gives rows equal to the reference's own reopen. A torn commit is staged by
a store manager whose flush applies the first half of the batch's rows and
then fails, as a crash between row writes would. Exact equality
throughout: bytes, ids and change records; every wait on a reader is
bounded.
"""

import os
import shutil
import time
from types import SimpleNamespace

import pytest

from janusgraph_tpu.core import codecs as ref_codecs
from janusgraph_tpu.core import txlog as ref_txlog
from janusgraph_tpu.core.graph import open_graph as ref_open_graph
from janusgraph_tpu.exceptions import SchemaViolationError as RefSchemaError
from janusgraph_tpu.storage.inmemory import InMemoryStoreManager as RefManager
from janusgraph_tpu_torch.core import codecs, txlog
from janusgraph_tpu_torch.core.graph import open_graph
from janusgraph_tpu_torch.exceptions import SchemaViolationError
from janusgraph_tpu_torch.storage.inmemory import InMemoryStoreManager

REF = SimpleNamespace(
    name="ref", open=ref_open_graph, codecs=ref_codecs, txlog=ref_txlog, manager=RefManager,
    schema_error=RefSchemaError,
    config={"computer.sharded-auto": False, "graph.set-vertex-id": True},
)
PORT = SimpleNamespace(
    name="port", open=open_graph, codecs=codecs, txlog=txlog, manager=InMemoryStoreManager,
    schema_error=SchemaViolationError,
    config={"computer.executor": "cpu", "graph.set-vertex-id": True},
)
BOTH = [REF, PORT]


def _wait(cond, timeout_s=5.0):
    deadline = time.monotonic() + timeout_s
    while not cond() and time.monotonic() < deadline:
        time.sleep(0.01)
    return cond()


def _change(c):
    return (c.kind, c.added, c.vertex_id, c.other_id, c.type_id, c.relation_id, c.value_enc)


def _wal(pkg, g):
    """[(tx_id, status name, user_log, changes)] in log order."""
    out = []
    for m in g.log_manager.open_log("txlog").read_range(0):
        e = pkg.txlog.decode_tx_entry(m.content, m.timestamp_ns)
        out.append((e.tx_id, e.status.name, e.user_log, [_change(c) for c in e.changes]))
    return out


def _by_tx(entries):
    """The WAL's entries grouped per transaction, tx ids dropped (they
    start from the clock), in first-seen order."""
    order, groups = [], {}
    for tx_id, status, user_log, changes in entries:
        if tx_id not in groups:
            order.append(tx_id)
            groups[tx_id] = []
        groups[tx_id].append((status, user_log, changes))
    return [groups[t] for t in order]


def _schema(g):
    m = g.management()
    m.make_property_key("name", str)
    m.make_property_key("age", int)
    m.make_edge_label("knows")
    m.build_composite_index("byName", ["name"], unique=True)


def _workload(pkg, g):
    """Three commits (adds, a property rewrite with an edge removal, a
    vertex removal) and a fourth that a unique index refuses."""
    D = pkg.codecs.Direction
    tx = g.new_transaction()
    a = tx.add_vertex("person", name="a", age=30)
    b = tx.add_vertex("person", name="b", age=40)
    tx.add_edge(a, "knows", b)
    tx.add_edge(b, "knows", a)
    tx.commit()
    tx = g.new_transaction(log_identifier="audit")
    va = tx.get_vertex(a.id)
    tx.remove_property(tx.get_properties(va, "age")[0])
    tx.add_property(va, "age", 31)
    tx.remove_edge(tx.get_edges(va, D.OUT, ("knows",))[0])
    tx.commit()
    tx = g.new_transaction()
    tx.remove_vertex(tx.get_vertex(b.id))
    tx.commit()
    tx = g.new_transaction()
    tx.add_vertex("person", name="a")
    with pytest.raises(pkg.schema_error):
        tx.commit()
    return a.id, b.id


def test_same_transactions_write_the_same_wal():
    seen = {}
    for pkg in BOTH:
        g = pkg.open(dict(pkg.config, **{"tx.log-tx": True}))
        try:
            _schema(g)
            ids = _workload(pkg, g)
            seen[pkg.name] = (ids, _by_tx(_wal(pkg, g)))
        finally:
            g.close()
    assert seen["port"] == seen["ref"]
    groups = seen["port"][1]
    full = ["PRECOMMIT", "PREFLUSH", "PRIMARY_SUCCESS", "SECONDARY_SUCCESS"]
    assert [[s for s, _u, _c in grp] for grp in groups] == [full, full, full, ["PRECOMMIT"]]
    assert groups[1][0][1] == "audit" and len(groups[0][0][2]) == 6


def test_wal_is_off_by_default_and_on_for_a_user_log():
    for pkg in BOTH:
        g = pkg.open(dict(pkg.config))
        try:
            tx = g.new_transaction()
            tx.add_vertex(name="x")
            tx.commit()
            assert g.log_manager.open_log("txlog").read_range(0) == []
            tx = g.new_transaction(log_identifier="feed")
            tx.add_vertex(name="y")
            tx.commit()
            assert [s for _t, s, _u, _c in _wal(pkg, g)] == [
                "PRECOMMIT", "PREFLUSH", "PRIMARY_SUCCESS", "SECONDARY_SUCCESS"]
        finally:
            g.close()


def test_the_user_log_processor_sees_commits_and_deletions():
    seen = {}
    for pkg in BOTH:
        g = pkg.open(dict(pkg.config))
        states = []
        try:
            g.open_log_processor("audit").add_processor(states.append).build()
            time.sleep(0.05)  # the readers start from now
            tx = g.new_transaction(log_identifier="audit")
            v = tx.add_vertex(name="hera")
            w = tx.add_vertex(name="zeus")
            tx.add_edge(v, "knows", w)
            tx.commit()
            tx = g.new_transaction(log_identifier="audit")
            tx.remove_property(tx.get_properties(tx.get_vertex(v.id), "name")[0])
            tx.remove_edge(tx.get_edges(tx.get_vertex(v.id), pkg.codecs.Direction.OUT,
                                        ("knows",))[0])
            tx.commit()
            assert _wait(lambda: len(states) == 2)
            states.sort(key=lambda s: s.timestamp_ns)
            seen[pkg.name] = [
                (sorted(map(_change, s.added)), sorted(map(_change, s.deleted)))
                for s in states
            ]
            value, _ = g.serializer.read_object(
                next(c for c in states[0].added if c.kind == "property").value_enc)
            assert value in ("hera", "zeus")
        finally:
            g.close()
    assert seen["port"] == seen["ref"]
    (added0, deleted0), (added1, deleted1) = seen["port"]
    assert len(added0) == 3 and not deleted0 and not added1 and len(deleted1) == 2


def test_transaction_recovery_heals_a_failed_secondary_and_spares_one_in_flight():
    seen = {}
    for pkg in BOTH:
        g = pkg.open(dict(pkg.config))
        try:
            tx = g.new_transaction(log_identifier="feed")
            v = tx.add_vertex(name="apollo")
            tx._fail_secondary_for_test = True
            tx.commit()
            ulog = g.log_manager.open_log("ulog_feed")
            assert ulog.read_range(0) == []
            statuses = [s for _t, s, _u, _c in _wal(pkg, g)]
            assert statuses[-1] == "SECONDARY_FAILURE"
            # a generous max commit time: still in flight, left alone
            assert g.start_transaction_recovery().run(max_commit_time_ms=60_000.0) == []
            healed = g.start_transaction_recovery().run(max_commit_time_ms=0.0)
            assert len(healed) == 1
            entries = [pkg.txlog.decode_tx_entry(m.content) for m in ulog.read_range(0)]
            assert len(entries) == 1
            last = _wal(pkg, g)[-1]
            assert last[1] == "SECONDARY_SUCCESS" and last[2].startswith("healed:")
            assert g.start_transaction_recovery().run(max_commit_time_ms=0.0) == []
            seen[pkg.name] = (v.id, [_change(c) for c in entries[0].changes])
        finally:
            g.close()
    assert seen["port"] == seen["ref"]


def test_a_failed_mixed_index_flush_is_healed_from_primary_storage():
    for pkg in BOTH:
        g = pkg.open(dict(pkg.config, **{"tx.log-tx": True}))
        try:
            g.management().make_property_key("title", str)
            g.management().build_mixed_index("titles", ["title"], mappings={"title": "STRING"})
            tx = g.new_transaction()
            v = tx.add_vertex(title="labours")
            tx._fail_mixed_for_test = True
            tx.commit()
            idx = g.indexes["titles"]
            cond = [("title", _eq(pkg), "labours")]
            assert g.mixed_index_query(g.new_transaction(), idx, cond) == []
            assert g.start_transaction_recovery().run(max_commit_time_ms=0.0)
            assert g.mixed_index_query(g.new_transaction(), idx, cond) == [v.id]
        finally:
            g.close()


def _eq(pkg):
    if pkg is REF:
        from janusgraph_tpu.core.predicates import Cmp
    else:
        from janusgraph_tpu_torch.core.predicates import Cmp
    return Cmp.EQUAL


class _TearingFlush:
    """Swap a store manager's ``mutate_many`` for one call: apply the first
    half of the batch's rows (edgestore rows, then graphindex rows, in the
    batch's order), then fail, as a crash between row writes would."""

    def __init__(self, manager):
        self.manager = manager
        self.original = manager.mutate_many
        self.rows = None
        manager.mutate_many = self

    def __call__(self, mutations, txh):
        self.manager.mutate_many = self.original
        flat = [(s, k, m) for s, rows in mutations.items() for k, m in rows.items()]
        self.rows = len(flat)
        keep = {}
        for s, k, m in flat[: len(flat) // 2]:
            keep.setdefault(s, {})[k] = m
        self.original(keep, txh)
        raise RuntimeError("crash in the middle of the flush")


def _crash(g):
    """Abandon a graph as a dead process would: its log threads stop, its
    instance stays registered, nothing else closes."""
    g.log_manager.close()


def _torn_scenario(pkg, mgr):
    """A graph with a composite and a mixed index, one clean commit, one
    torn commit and one that a unique index refuses (PRECOMMIT only)."""
    g = pkg.open(dict(pkg.config, **{"tx.log-tx": True}), store_manager=mgr)
    _schema(g)
    g.management().make_property_key("title", str)
    g.management().build_mixed_index("titles", ["title"], mappings={"title": "STRING"})
    tx = g.new_transaction()
    a = tx.add_vertex("person", name="a", age=30)
    tx.commit()
    tx = g.new_transaction(log_identifier="audit")
    b = tx.add_vertex("person", name="b", age=41, title="labours")
    c = tx.add_vertex("person", name="c")
    tx.add_edge(tx.get_vertex(a.id), "knows", b)
    tx.add_edge(b, "knows", c)
    tear = _TearingFlush(g.backend.manager)
    with pytest.raises(RuntimeError, match="crash"):
        tx.commit()
    assert tear.rows >= 4
    tx = g.new_transaction()
    tx.add_vertex("person", name="a")
    with pytest.raises(pkg.schema_error):
        tx.commit()
    _crash(g)
    return a.id, b.id, c.id


def _observe(pkg, g, ids):
    a, b, c = ids
    D = pkg.codecs.Direction
    tx = g.new_transaction(read_only=True)
    try:
        return {
            "names": [tx.get_vertex(v).value("name") for v in ids],
            "out": {v: sorted(e.in_vertex.id for e in tx.get_edges(tx.get_vertex(v), D.OUT,
                                                                   ("knows",)))
                    for v in ids},
            "byName": [g.index_lookup(tx, "byName", [n]) for n in ("a", "b", "c")],
            "titles": g.mixed_index_query(tx, g.indexes["titles"],
                                          [("title", _eq(pkg), "labours")]),
        }
    finally:
        tx.rollback()


def test_torn_commit_rolls_forward_and_a_precommit_only_one_back():
    seen = {}
    for pkg in BOTH:
        mgr = pkg.manager()
        ids = _torn_scenario(pkg, mgr)
        g = pkg.open(dict(pkg.config, **{"tx.max-commit-time-ms": 0.0}), store_manager=mgr)
        try:
            rec = g.last_torn_recovery
            assert len(rec["replayed"]) == 1 and len(rec["rolled_back"]) == 1
            obs = _observe(pkg, g, ids)
            again = pkg.txlog.TornCommitRecovery(g).run()
            assert again == {"replayed": [], "rolled_back": []}
            markers = [(s, u.split(":")[0]) for _t, s, u, _c in _wal(pkg, g)[-2:]]
            assert sorted(markers) == [("PRIMARY_SUCCESS", "healed-primary"),
                                       ("ROLLED_BACK", "rolledback")]
            seen[pkg.name] = (ids, obs)
        finally:
            g.close()
    assert seen["port"] == seen["ref"]
    (a, b, c), obs = seen["port"]
    # every write of the torn commit is back: vertices, edges, the unique
    # index rows and the mixed-index document
    assert obs["names"] == ["a", "b", "c"]
    assert obs["out"] == {a: [b], b: [c], c: []}
    assert obs["byName"] == [[a], [b], [c]] and obs["titles"] == [b]


def test_recovery_waits_for_the_max_commit_time():
    mgr = InMemoryStoreManager()
    _torn_scenario(PORT, mgr)
    g = open_graph(dict(PORT.config), store_manager=mgr)  # 10 s: in flight
    try:
        assert g.last_torn_recovery == {"replayed": [], "rolled_back": []}
        off = open_graph(dict(PORT.config, **{"tx.recover-on-open": False,
                                              "tx.max-commit-time-ms": 0.0}),
                         store_manager=mgr)
        assert off.last_torn_recovery is None
        off.close()
    finally:
        g.close()


def _kv_rows(manager, stores=("edgestore", "graphindex")):
    return {s: dict(manager.kv_manager._stores[s].mem.data) for s in stores}


def test_a_torn_commit_left_by_the_reference_heals_the_same_in_the_port(tmp_path):
    from janusgraph_tpu.storage.localstore import open_local_kcvs as ref_open_local
    from janusgraph_tpu_torch.storage.localstore import open_local_kcvs

    src = str(tmp_path / "torn")
    mgr = ref_open_local(src, fsync=False)
    ids = _torn_scenario(REF, mgr)
    mgr.close()
    healed = {}
    for pkg, opener in ((REF, ref_open_local), (PORT, open_local_kcvs)):
        d = str(tmp_path / pkg.name)
        shutil.copytree(src, d)
        m = opener(d, fsync=False)
        g = pkg.open(dict(pkg.config, **{"tx.max-commit-time-ms": 0.0}), store_manager=m)
        try:
            assert len(g.last_torn_recovery["replayed"]) == 1
            healed[pkg.name] = _kv_rows(g.backend.manager)
            obs = _observe(pkg, g, ids)
            assert obs["names"] == ["a", "b", "c"] and obs["byName"][1] == [ids[1]]
        finally:
            g.close()
    assert healed["port"] == healed["ref"]
    assert os.path.exists(os.path.join(str(tmp_path / "port"), "store.wal"))
