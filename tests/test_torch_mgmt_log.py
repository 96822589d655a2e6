"""The port's management broadcast and instance registry held to the JAX
package's.

Two instances over one store manager: a schema eviction broadcast by one
reaches the other (its index registry reloads) and every open instance
acknowledges it; a consistency change reaches the other's schema cache;
``set_config("tx.log-tx")`` turns the WAL on, ``open_instances`` lists
the registered ids and ``force_close_instance`` removes a stale one; a
duplicate instance id refuses to open unless
``graph.replace-instance-if-exists``; ``drop_graph`` clears the logs and
the registry. Each scenario runs on both packages and their observations
are equal; every wait on a reader is bounded.
"""

import time
from types import SimpleNamespace

import pytest

from janusgraph_tpu.core import codecs as ref_codecs
from janusgraph_tpu.core.graph import drop_graph as ref_drop_graph
from janusgraph_tpu.core.graph import open_graph as ref_open_graph
from janusgraph_tpu.exceptions import ConfigurationError as RefConfigError
from janusgraph_tpu.exceptions import SchemaViolationError as RefSchemaError
from janusgraph_tpu.storage.inmemory import InMemoryStoreManager as RefManager
from janusgraph_tpu_torch.core import codecs
from janusgraph_tpu_torch.core.graph import drop_graph, open_graph
from janusgraph_tpu_torch.exceptions import ConfigurationError, SchemaViolationError
from janusgraph_tpu_torch.storage.inmemory import InMemoryStoreManager

REF = SimpleNamespace(name="ref", open=ref_open_graph, drop=ref_drop_graph, codecs=ref_codecs,
                      manager=RefManager, config_error=RefConfigError,
                      schema_error=RefSchemaError, config={"computer.sharded-auto": False})
PORT = SimpleNamespace(name="port", open=open_graph, drop=drop_graph, codecs=codecs,
                       manager=InMemoryStoreManager, config_error=ConfigurationError,
                       schema_error=SchemaViolationError, config={"computer.executor": "cpu"})
BOTH = [REF, PORT]


def _wait(cond, timeout_s=5.0):
    deadline = time.monotonic() + timeout_s
    while not cond() and time.monotonic() < deadline:
        time.sleep(0.01)
    return cond()


def _pair(pkg, **extra):
    mgr = pkg.manager()
    cfg = dict(pkg.config, **extra)
    return mgr, pkg.open(dict(cfg), store_manager=mgr), pkg.open(dict(cfg), store_manager=mgr)


@pytest.mark.parametrize("pkg", BOTH, ids=lambda p: p.name)
def test_an_eviction_reaches_the_other_instance(pkg):
    _mgr, g1, g2 = _pair(pkg)
    try:
        g1.management().make_property_key("name", str)
        idx = g1.management().build_composite_index("byName", ["name"])
        assert "byName" not in g2.indexes  # g2 has not reloaded its registry
        t0 = time.monotonic()
        assert g1.management().broadcast_eviction(idx.id)  # both acknowledged
        assert time.monotonic() - t0 < g1.config.get("schema.eviction-ack-timeout-ms") / 1e3
        assert _wait(lambda: "byName" in g2.indexes)
    finally:
        g1.close()
        g2.close()


@pytest.mark.parametrize("pkg", BOTH, ids=lambda p: p.name)
def test_a_consistency_change_reaches_the_other_instance(pkg):
    Consistency = pkg.codecs.Consistency
    _mgr, g1, g2 = _pair(pkg)
    try:
        g1.management().make_property_key("serial", int)
        g1.management().broadcast_eviction(g1.schema_cache.get_by_name("serial").id)
        assert _wait(lambda: g2.schema_cache.get_by_name("serial") is not None)
        g1.management().set_consistency("serial", Consistency.LOCK)
        assert _wait(lambda: getattr(g2.schema_cache.get_by_name("serial"), "consistency",
                                     None) is Consistency.LOCK)
        assert g2.management().get_consistency("serial") is Consistency.LOCK
    finally:
        g1.close()
        g2.close()


def test_config_and_instances_behave_the_same():
    seen = {}
    for pkg in BOTH:
        mgr, g1, g2 = _pair(pkg)
        try:
            m = g1.management()
            both = sorted(m.open_instances())
            assert both == sorted([g1.instance_id, g2.instance_id])
            assert m.get_config("tx.log-tx") is False
            m.set_config("tx.log-tx", True)
            # this instance turns its WAL on at once, the other reads the
            # stored value and at its next open
            assert g1._wal_enabled and not g2._wal_enabled
            assert g2.management().get_config("tx.log-tx") is True
            with pytest.raises(pkg.config_error):
                m.set_config("log.num-buckets", 8)  # GLOBAL_OFFLINE: 2 open
            with pytest.raises(pkg.config_error):
                m.set_config("log.slice-granularity-ms", 50)  # FIXED
            with pytest.raises(pkg.config_error):
                m.set_config("storage.cdc.dir", "/x")  # LOCAL
            with pytest.raises(pkg.schema_error):
                m.force_close_instance(g1.instance_id)
            m.force_close_instance(g2.instance_id)
            assert m.open_instances() == [g1.instance_id]
            tx = g1.new_transaction()
            tx.add_vertex(name="x")
            tx.commit()
            statuses = len(g1.log_manager.open_log("txlog").read_range(0))
            g3 = pkg.open(dict(pkg.config), store_manager=mgr)
            assert g3._wal_enabled
            m.set_config("tx.max-commit-time-ms", 5.0)
            assert g3.config.get("tx.max-commit-time-ms") == 5.0
            seen[pkg.name] = (len(both), statuses, len(m.open_instances()))
            g3.close()
        finally:
            g1.close()
            g2.close()
    assert seen["port"] == seen["ref"] == (2, 4, 2)


def test_a_duplicate_instance_id_refuses_to_open():
    for pkg in BOTH:
        mgr = pkg.manager()
        cfg = dict(pkg.config, **{"graph.unique-instance-id": "node-1"})
        g = pkg.open(dict(cfg), store_manager=mgr)
        try:
            assert g.instance_id == "node-1"
            with pytest.raises(pkg.config_error, match="already registered"):
                pkg.open(dict(cfg), store_manager=mgr)
            taken = pkg.open(dict(cfg, **{"graph.replace-instance-if-exists": True}),
                             store_manager=mgr)
            assert g.management().open_instances() == ["node-1"]
            taken.close()
            assert g.management().open_instances() == []
        finally:
            g.close()
        suffixed = pkg.open(dict(pkg.config, **{"graph.unique-instance-id-suffix": "edge"}),
                            store_manager=mgr)
        assert suffixed.instance_id.endswith("-edge")
        suffixed.close()


def test_drop_graph_clears_the_logs_and_the_registry():
    for pkg in BOTH:
        mgr = pkg.manager()
        g = pkg.open(dict(pkg.config, **{"tx.log-tx": True}), store_manager=mgr)
        other = pkg.open(dict(pkg.config), store_manager=mgr)
        tx = g.new_transaction(log_identifier="feed")
        tx.add_vertex(name="x")
        tx.commit()
        assert g.log_manager.open_log("txlog").read_range(0)
        other.close()
        pkg.drop(g)
        g = pkg.open(dict(pkg.config), store_manager=mgr)
        try:
            assert g.log_manager.open_log("txlog").read_range(0) == []
            assert g.log_manager.open_log("ulog_feed").read_range(0) == []
            assert g.management().open_instances() == [g.instance_id]
            assert g.config.get("tx.log-tx") is False
        finally:
            g.close()
