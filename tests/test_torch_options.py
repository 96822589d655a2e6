"""The eight options the port once refused, and the registry as a whole,
held to the JAX package on the same inputs.

Both registries hold the same paths with the same types, defaults (but the
two the port changes on purpose), mutabilities, validators and
descriptions, so both ``config-docs`` outputs are the same text but for
those two default cells. Each option a graph consumes is driven in both
packages: ``ids.renew-timeout-ms`` bounds the wait for a stalled background
block fetch, ``ids.authority.max-retries`` bounds the claims on a contended
id store, and ``query.fast-property=False`` reads one slice per key. The
other five are taken and stored as the reference takes them.
"""

import threading
import time

import pytest

from janusgraph_tpu import cli as ref_cli
from janusgraph_tpu.core import config as ref_config
from janusgraph_tpu.core.graph import open_graph as ref_open_graph
from janusgraph_tpu.exceptions import TemporaryBackendError as RefTemporaryBackendError
from janusgraph_tpu.observability import registry as ref_registry
from janusgraph_tpu.server.manager import ConfiguredGraphFactory as RefFactory
from janusgraph_tpu_torch import cli
from janusgraph_tpu_torch.core import config
from janusgraph_tpu_torch.core.graph import open_graph
from janusgraph_tpu_torch.exceptions import TemporaryBackendError
from janusgraph_tpu_torch.observability import registry
from janusgraph_tpu_torch.server.manager import ConfiguredGraphFactory

#: defaults the port changes on purpose: path -> (reference, port)
DEFAULT_DIFFERENCES = {
    "computer.strategy": ("auto", "segsum"),
    "computer.frontier-cc-min-edges": (1 << 20, 1 << 30),
}

#: the options the port once refused, each with a value other than its
#: default
ONCE_REFUSED = {
    "ids.renew-timeout-ms": 50.0,
    "ids.authority.max-retries": 3,
    "query.fast-property": False,
    "storage.batch-loading": True,
    "storage.buffer-size": 512,
    "cache.tx-cache-size": 100,
    "computer.result-mode": "persist",
    "graph.graphname": "g2",
}

#: values each validator is probed with, by type
PROBES = {
    int: [-2, -1, 0, 1, 2, 3, 16, 17, 31, 32, 64, 1 << 20, 1 << 30, 1 << 40],
    float: [-1.0, 0.0, 0.5, 1.0, 1.5, 100.0, 1e9],
    str: ["", "auto", "segsum", "pallas", "ell", "hybrid", "segment", "tpu", "cpu",
          "sharded", "none", "memory", "persist", "blocked", "a2a", "ring", "gather",
          "always", "off", "local", "remote", "inmemory", "ms", "us", "ns", "pico",
          "global_auto", "hashed", "simple", "edgestore"],
    bool: [True, False],
}

PACKAGES = {
    "reference": (ref_open_graph, ref_registry, RefTemporaryBackendError),
    "port": (open_graph, registry, TemporaryBackendError),
}


def _accepts(opt, value):
    try:
        opt.check(value)
        return True
    except Exception:  # noqa: BLE001 - either package's ConfigurationError
        return False


def test_the_registries_hold_the_same_paths():
    assert list(config.REGISTRY) == list(ref_config.REGISTRY)


@pytest.mark.parametrize("path", sorted(ref_config.REGISTRY))
def test_each_option_is_the_references(path):
    ours, ref = config.REGISTRY[path], ref_config.REGISTRY[path]
    assert ours.datatype is ref.datatype and ours.description == ref.description
    assert ours.mutability.name == ref.mutability.name
    assert (ref.default, ours.default) == DEFAULT_DIFFERENCES.get(path, (ref.default, ref.default))
    # "segsum" is the port's name for its hand kernel: the one value only
    # the port takes
    probes = [v for v in PROBES[ref.datatype] if (path, v) != ("computer.strategy", "segsum")]
    assert [_accepts(ours, v) for v in probes] == [_accepts(ref, v) for v in probes]


def test_the_namespaces_are_the_references():
    for name in ("ROOT", "STORAGE", "IDS", "CACHE", "SCHEMA", "CLUSTER", "GRAPH", "LOG_NS",
                 "TX_NS", "INDEX_NS", "METRICS_NS", "COMPUTER_NS", "LOCK_NS", "SERVER_NS",
                 "ATTRIBUTE_NS", "QUERY_NS", "DRIVER_NS"):
        ns, ref_ns = getattr(config, name), getattr(ref_config, name)
        assert (ns.path, ns.description) == (ref_ns.path, ref_ns.description)
        assert sorted(ns.options) == sorted(ref_ns.options)
    opt = config.STORAGE.option("test-only-option", int, "registered through a namespace", 1)
    try:
        assert config.REGISTRY["storage.test-only-option"] is opt
        assert opt.mutability is config.Mutability.LOCAL
        assert config.GraphConfiguration({"storage.test-only-option": 4}).get(
            "storage.test-only-option") == 4
    finally:
        del config.REGISTRY["storage.test-only-option"]
        del config.STORAGE.options["test-only-option"]


def test_config_docs_is_the_references_text(capsys):
    """Every line is the reference's, byte for byte, but the default cells
    of the two defaults the port changes on purpose and the header's name
    of the module the table comes from."""
    assert cli.main(["config-docs"]) == 0
    ours = capsys.readouterr().out
    assert ref_cli.main(["config-docs"]) == 0
    ref = capsys.readouterr().out
    assert "(`janusgraph_tpu_torch/core/config.py`;" in ours
    ours = ours.replace("janusgraph_tpu_torch/core/config.py", "janusgraph_tpu/core/config.py")
    ours_rows, ref_rows = ours.splitlines(), ref.splitlines()
    assert len(ours_rows) == len(ref_rows) == len(config.REGISTRY) + 6
    differing = [(a, b) for a, b in zip(ours_rows, ref_rows) if a != b]
    assert [a.split(" | ")[0].lstrip("| ") for a, _ in differing] == sorted(DEFAULT_DIFFERENCES)
    for a, b in differing:
        path = a.split(" | ")[0].lstrip("| ")
        ref_default, port_default = DEFAULT_DIFFERENCES[path]
        assert a == b.replace(f"| {ref_default!r} |", f"| {port_default!r} |")


@pytest.mark.parametrize("package", PACKAGES)
def test_a_graph_opens_with_all_eight_set(package):
    opener = PACKAGES[package][0]
    g = opener(dict(ONCE_REFUSED, **{"computer.executor": "cpu"}))
    try:
        for path, value in ONCE_REFUSED.items():
            assert g.config.get(path) == value
        assert g.backend.id_authority.max_retries == 3
        assert g.id_assigner.renew_timeout_ms == 50.0
        assert g.id_assigner._relation_pool.renew_timeout_ms == 50.0
        tx = g.new_transaction()
        v = tx.add_vertex(name="a", age=3)
        tx.commit()
        tx = g.new_transaction()
        props = tx.get_properties(tx.get_vertex(v.id), "name", "age")
        assert sorted((p.value for p in props), key=str) == [3, "a"]
        tx.rollback()
    finally:
        g.close()


# ------------------------------------------------------- ids.renew-timeout-ms
def _stalled_fetch(package, timeout_ms):
    """Ids drawn from a vertex pool whose second block fetch stalls: the
    ids handed out, the error the next draw raises and how long it
    waited."""
    opener, _, temporary = PACKAGES[package]
    g = opener({"ids.block-size": 10, "ids.renew-timeout-ms": timeout_ms,
                "ids.authority-wait-ms": 0.0, "computer.executor": "cpu"})
    release = threading.Event()
    authority = g.id_assigner.authority
    inner = authority.get_id_block
    fetches = []

    def stalling(ns, partition):
        fetches.append(partition)
        if len(fetches) > 1:
            release.wait(10)
        return inner(ns, partition)

    authority.get_id_block = stalling
    pool = g.id_assigner._pool(1)
    ids = []
    try:
        while len(ids) < 50:
            try:
                ids.append(pool.next_id())
            except temporary as e:
                t0 = time.perf_counter()
                with pytest.raises(temporary) as again:
                    pool.next_id()
                return ids, str(e), str(again.value), time.perf_counter() - t0
        raise AssertionError("the stalled fetch never timed out")
    finally:
        release.set()
        g.close()


def test_a_stalled_block_fetch_raises_after_the_renew_timeout():
    ref = _stalled_fetch("reference", 50.0)
    ours = _stalled_fetch("port", 50.0)
    assert ours[:3] == ref[:3]
    assert ours[0] == list(range(1, 11))
    assert "ids.renew-timeout-ms (50ms)" in ours[1]
    assert ref[3] >= 0.045 and ours[3] >= 0.045


# -------------------------------------------------- ids.authority.max-retries
class _Contended:
    """An id store on which a rival claims every block just ahead of each
    claim: its claim column sorts first (timestamp 0), so every attempt
    loses."""

    def __init__(self, store):
        self._store = store
        self.claims = 0

    def __getattr__(self, name):
        return getattr(self._store, name)

    def mutate(self, key, additions, deletions, txh):
        for col, _ in additions:
            self.claims += 1
            rival = col[:8] + bytes(8) + b"\x01" * 16
            self._store.mutate(key, [(rival, b"")], [], txh)
        return self._store.mutate(key, additions, deletions, txh)


@pytest.mark.parametrize("retries", [1, 3])
def test_a_contended_id_store_gives_up_after_max_retries(retries):
    seen = {}
    for package, (opener, _, temporary) in PACKAGES.items():
        g = opener({"ids.authority.max-retries": retries, "ids.authority-wait-ms": 0.0,
                    "computer.executor": "cpu"})
        try:
            authority = g.backend.id_authority
            authority.store = contended = _Contended(authority.store)
            with pytest.raises(temporary) as err:
                authority.get_id_block(0, 7)
            seen[package] = (contended.claims, str(err.value))
        finally:
            g.close()
    assert seen["port"] == seen["reference"]
    assert seen["port"][0] == retries
    assert seen["port"][1].endswith(f"after {retries} attempts")


# -------------------------------------------------------- query.fast-property
def _property_reads(package, fast):
    opener, reg, _ = PACKAGES[package]
    g = opener({"query.fast-property": fast, "metrics.enabled": True,
                "cache.db-cache": False, "computer.executor": "cpu"})
    try:
        tx = g.new_transaction()
        v = tx.add_vertex(name="a", age=3, city="x", score=1.5)
        w = tx.add_vertex(name="b")
        tx.add_edge(v, "knows", w)
        tx.commit()
        out = []
        for keys in (("name", "age"), ("city",), ("score", "name", "city"), ()):
            tx = g.new_transaction()
            u = tx.get_vertex(v.id)
            before = reg.snapshot().get("storage.edgestore.getSlice", {}).get("count", 0)
            props = tx.get_properties(u, *keys)
            after = reg.snapshot()["storage.edgestore.getSlice"]["count"]
            out.append((keys, sorted((tx.schema_name(p.type_id), p.value) for p in props),
                        after - before))
            tx.rollback()
        return out
    finally:
        g.close()


@pytest.mark.parametrize("fast", [True, False])
def test_fast_property_reads_the_references_slices(fast):
    ours = _property_reads("port", fast)
    assert ours == _property_reads("reference", fast)
    slices = [n for _, _, n in ours]
    assert slices == ([1, 1, 1, 1] if fast else [2, 1, 3, 1])
    assert ours[0][1] == [("age", 3), ("name", "a")]


# ----------------------------------------------------------- graph.graphname
@pytest.mark.parametrize("package", PACKAGES)
def test_the_graph_manager_strips_the_graph_name(package):
    opener = PACKAGES[package][0]
    factory_cls = RefFactory if package == "reference" else ConfiguredGraphFactory
    mgmt = opener({"computer.executor": "cpu"})
    factory = factory_cls(mgmt)
    factory.create_configuration({"graph.graphname": "g2", "computer.executor": "cpu",
                                  "storage.batch-loading": True})
    g = factory.open("g2")
    try:
        assert g.config.get("graph.graphname") == "graph"
        assert g.config.get("storage.batch-loading") is True
    finally:
        g.close()
        mgmt.close()
