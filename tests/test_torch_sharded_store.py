"""The port's sharded store held to the JAX package's (after the sharded
cases of ``tests/test_storage_adapters.py``).

Placement is the reference's, key for key (``_shard_of``: blake2b, 4
bytes), on plain keys and on the rows a real bulk load writes, and so is
what each node holds. An ordered range scan raises
``PermanentBackendError``; a failed node raises ``TemporaryBackendError``
until healed; ``mutate_many`` routes one batch per node. A graph over
"sharded" scans through the unordered branch of ``load_csr`` and the
input format: the Graph of the Gods and a stored R-MAT graph give the
reference's CSR arrays exactly, and the Gods' PageRank sums to 1 (1e-3,
as the reference's test). A scan killed mid-stream over the sharded store
is not absorbed (the unordered branch has no retry): both packages raise.
"""

import numpy as np
import pytest

from janusgraph_tpu.core import bulk as ref_bulk
from janusgraph_tpu.core import gods as ref_gods
from janusgraph_tpu.core.graph import open_graph as ref_open_graph
from janusgraph_tpu.exceptions import TemporaryBackendError as RefTemporary
from janusgraph_tpu.olap.csr import load_csr as ref_load_csr
from janusgraph_tpu.olap.input_format import GraphInputFormat as RefInputFormat
from janusgraph_tpu.storage import sharded_store as ref_sharded
from janusgraph_tpu_torch.core import bulk, gods
from janusgraph_tpu_torch.core.graph import open_graph
from janusgraph_tpu_torch.exceptions import PermanentBackendError, TemporaryBackendError
from janusgraph_tpu_torch.olap.csr import load_csr
from janusgraph_tpu_torch.olap.generators import rmat_edges
from janusgraph_tpu_torch.olap.input_format import GraphInputFormat
from janusgraph_tpu_torch.olap.programs import PageRankProgram
from janusgraph_tpu_torch.storage import sharded_store
from janusgraph_tpu_torch.storage.kcvs import KCVMutation, KeyRangeQuery, KeySliceQuery, SliceQuery
from janusgraph_tpu_torch.storage.sharded_store import ShardedStoreManager, _shard_of

CSR_FIELDS = ("vertex_ids", "out_indptr", "out_dst", "in_indptr", "in_src", "out_degree",
              "labels", "in_edge_type", "out_edge_type")


def _node_keys(mgr, name):
    return [sorted(k for k, _ in m.open_database(name).get_keys(SliceQuery(), None))
            for m in mgr.nodes]


def test_sharded_distributes_keys():
    out = {}
    for pkg, cls in (("port", ShardedStoreManager), ("ref", ref_sharded.ShardedStoreManager)):
        mgr = cls(num_nodes=4)
        s = mgr.open_database("s")
        tx = mgr.begin_transaction()
        for i in range(64):
            s.mutate(b"key%d" % i, [(b"c", b"v%d" % i)], [], tx)
        counts = [m.open_database("s").row_count() for m in mgr.nodes]
        assert sum(counts) == 64 and all(c > 0 for c in counts)
        out[pkg] = (_node_keys(mgr, "s"), [k for k, _ in s.get_keys(SliceQuery(), tx)])
        mgr.close()
    assert out["port"] == out["ref"]
    assert len(out["port"][1]) == 64


def test_sharded_rejects_ordered_range_scan():
    mgr = ShardedStoreManager(num_nodes=2)
    s = mgr.open_database("s")
    tx = mgr.begin_transaction()
    with pytest.raises(PermanentBackendError, match="unordered scans only"):
        list(s.get_keys(KeyRangeQuery(b"a", b"z", SliceQuery()), tx))
    assert not mgr.features.ordered_scan and mgr.features.unordered_scan
    assert mgr.get_local_key_partition() is None
    mgr.close()


def test_sharded_node_failure_and_heal():
    mgr = ShardedStoreManager(num_nodes=2)
    s = mgr.open_database("s")
    tx = mgr.begin_transaction()
    s.mutate(b"k1", [(b"c", b"v")], [], tx)
    down = _shard_of(b"k1", 2)
    assert down == ref_sharded._shard_of(b"k1", 2)
    mgr.fail_node(down)
    with pytest.raises(TemporaryBackendError, match=f"node {down} unavailable"):
        s.get_slice(KeySliceQuery(b"k1", SliceQuery()), tx)
    with pytest.raises(TemporaryBackendError):
        list(s.get_keys(SliceQuery(), tx))
    mgr.heal_node(down)
    assert s.get_slice(KeySliceQuery(b"k1", SliceQuery()), tx) == [(b"c", b"v")]
    assert s.get_slice_multi([b"k1", b"k2"], SliceQuery(), tx) == {b"k1": [(b"c", b"v")], b"k2": []}
    mgr.close()


def test_sharded_mutate_many_routes_per_node():
    out = {}
    for pkg, cls, mut in (("port", ShardedStoreManager, KCVMutation),
                          ("ref", ref_sharded.ShardedStoreManager, None)):
        if mut is None:
            from janusgraph_tpu.storage.kcvs import KCVMutation as mut
        mgr = cls(num_nodes=3)
        calls = []
        for i, node in enumerate(mgr.nodes):
            inner = node.mutate_many
            node.mutate_many = lambda m, t, _i=i, _f=inner: (calls.append((_i, sorted(m))), _f(m, t))
        tx = mgr.begin_transaction()
        mgr.mutate_many({
            "a": {b"k%d" % i: mut(additions=[(b"c", b"v")]) for i in range(20)},
            "b": {b"q%d" % i: mut(additions=[(b"c", b"v")]) for i in range(20)},
        }, tx)
        assert len(list(mgr.open_database("a").get_keys(SliceQuery(), tx))) == 20
        assert len(list(mgr.open_database("b").get_keys(SliceQuery(), tx))) == 20
        out[pkg] = (sorted(calls), _node_keys(mgr, "a"), _node_keys(mgr, "b"))
        mgr.close()
    assert len(out["port"][0]) == 3  # one batch per node
    assert out["port"] == out["ref"]


def test_placement_equals_the_reference_on_a_bulk_load():
    """Every row key of a bulk-loaded graph (vertex rows and the system
    stores') lands on the node the reference puts it on."""
    g = open_graph({"storage.backend": "sharded", "computer.executor": "cpu",
                    "ids.authority-wait-ms": 0.0})
    n, src, dst = rmat_edges(9, 4, seed=3)
    vids = bulk.bulk_add_vertices(g, n)
    bulk.bulk_add_edges(g, "link", vids[src], vids[dst])
    mgr = g.backend.manager
    placed = 0
    for name in ("edgestore", "graphindex", "janusgraph_ids", "system_properties"):
        for i, keys in enumerate(_node_keys(mgr, name)):
            for k in keys:
                assert _shard_of(k, 3) == ref_sharded._shard_of(k, 3) == i
                placed += 1
    assert placed > n
    g.close()


def _sharded_graphs(scale=10, edge_factor=4, seed=5, **cfg):
    n, src, dst = rmat_edges(scale, edge_factor, seed=seed)
    graphs = []
    for opener, blk, extra in ((ref_open_graph, ref_bulk, {"computer.sharded-auto": False}),
                               (open_graph, bulk, {"computer.executor": "cpu"})):
        g = opener(dict({"storage.backend": "sharded", "ids.authority-wait-ms": 0.0},
                        **extra, **cfg))
        vids = blk.bulk_add_vertices(g, n)
        blk.bulk_add_edges(g, "link", vids[src], vids[dst])
        graphs.append(g)
    return graphs, n, len(src)


def test_a_stored_rmat_graph_over_three_nodes_scans_to_the_reference_csr():
    (rg, g), n, m = _sharded_graphs()
    rcsr, csr = ref_load_csr(rg), load_csr(g)
    assert (csr.num_vertices, csr.num_edges) == (n, m)
    for f in CSR_FIELDS:
        a, b = getattr(rcsr, f), getattr(csr, f)
        assert (a is None) == (b is None), f
        if a is not None:
            assert np.array_equal(a, b), f
    # the node rows, store by store, are the reference's
    for name in ("edgestore", "graphindex"):
        assert _node_keys(g.backend.manager, name) == _node_keys(rg.backend.manager, name)
    # the in-plan sums the edges of each row in the unordered scan's order
    res = g.compute().program(PageRankProgram(max_iterations=10)).submit()
    assert res.run_info["snapshot"]["path"] == "cold"
    assert np.array_equal(res.csr.in_src, csr.in_src)
    rg.close()
    g.close()


def test_the_input_format_reads_every_vertex_over_the_sharded_store():
    (rg, g), n, m = _sharded_graphs(scale=7)
    seen = {}
    for key, fmt in (("ref", RefInputFormat(rg)), ("port", GraphInputFormat(g))):
        verts = list(fmt.read_all(num_splits=3))
        seen[key] = sorted((sv.vertex_id, sorted((e[0], e[1]) for e in sv.edges)) for sv in verts)
    assert seen["port"] == seen["ref"]
    assert len(seen["port"]) == n and sum(len(e) for _, e in seen["port"]) == m
    rg.close()
    g.close()


def test_the_gods_over_sharded_with_pagerank():
    g = open_graph({"storage.backend": "sharded", "ids.authority-wait-ms": 0.0,
                    "computer.executor": "cpu"})
    rg = ref_open_graph({"storage.backend": "sharded", "ids.authority-wait-ms": 0.0,
                         "computer.sharded-auto": False})
    gods.load(g)
    ref_gods.load(rg)
    csr, rcsr = load_csr(g), ref_load_csr(rg)
    assert csr.num_vertices == 12 and csr.num_edges == 17
    for f in CSR_FIELDS:
        a, b = getattr(rcsr, f), getattr(csr, f)
        assert a is None and b is None or np.array_equal(a, b), f
    res = g.compute().program(PageRankProgram(max_iterations=20)).submit()
    assert abs(float(sum(res.states["rank"])) - 1.0) < 1e-3
    t = g.traversal()
    assert t.V().has("name", "hercules").out("father").values("name").to_list() == ["jupiter"]
    g.close()
    rg.close()


def test_a_scan_kill_over_the_sharded_store_propagates_in_both_packages():
    """The unordered branch has no per-range retry (the reference's
    ``_scan_rows`` retries only its ordered branch), so the injected kill
    reaches the caller of load_csr in both packages."""
    kill = {"storage.faults.enabled": True, "storage.faults.seed": 1,
            "storage.faults.scan-kill-at": 0, "storage.faults.scan-kill-after-rows": 5}
    (rg, g), _n, _m = _sharded_graphs(scale=6)
    errors = []
    for opener, graph, extra, err in (
        (ref_open_graph, rg, {"computer.sharded-auto": False}, RefTemporary),
        (open_graph, g, {"computer.executor": "cpu"}, TemporaryBackendError),
    ):
        faulty = opener(dict({"ids.authority-wait-ms": 0.0}, **extra, **kill),
                        store_manager=graph.backend.manager)
        loader = ref_load_csr if opener is ref_open_graph else load_csr
        with pytest.raises(err, match="injected scan kill #0 on edgestore after 5 rows"):
            loader(faulty)
        errors.append(faulty.fault_plan.journal)
        faulty.close()
    assert errors[0] == errors[1] == [{"kind": "scan", "n": 0, "store": "edgestore",
                                       "after_rows": 5}]
    rg.close()
    g.close()


def test_the_sharded_backend_takes_its_node_count():
    g = open_graph({"storage.backend": "sharded", "storage.sharded-nodes": 5,
                    "computer.executor": "cpu"})
    assert len(g.backend.manager.nodes) == 5
    assert g.backend.manager.name == "sharded(5xInMemoryStoreManager)"
    g.close()
    empty = sharded_store.ShardedStoreManager(num_nodes=1)
    assert empty.exists() == ref_sharded.ShardedStoreManager(num_nodes=1).exists()


def test_the_log_bus_needs_an_ordered_scan_in_both_packages():
    """A durable log reads its buckets by key range, which the sharded
    store refuses: over "sharded" a log's read raises in both packages (its
    pullers log the error each poll and go on), as the reference's do."""
    from janusgraph_tpu.exceptions import PermanentBackendError as RefPermanent

    g = open_graph({"storage.backend": "sharded", "computer.executor": "cpu"})
    rg = ref_open_graph({"storage.backend": "sharded", "computer.sharded-auto": False})
    try:
        errors = []
        for graph, err in ((g, PermanentBackendError), (rg, RefPermanent)):
            with pytest.raises(err) as e:
                graph.log_manager.open_log("txlog").read_range(0)
            errors.append(str(e.value))
        assert errors[0] == errors[1]
    finally:
        g.close()
        rg.close()
