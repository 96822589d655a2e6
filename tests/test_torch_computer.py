"""The port's stored-graph OLAP path held to the JAX package's.

Both packages open an in-memory graph, bulk-load the same scale-10 R-MAT
graph (two vertex labels, a ``link`` and a ``ring`` edge label; the ring
leaves no vertex dangling), and then:

  - their edgestore and graphindex rows are byte-equal;
  - ``load_csr``/``load_csr_snapshot`` give equal arrays under every
    filter, here and on the Graph of the Gods that the reference writes and
    the port opens from its rows (``InMemoryStoreManager.from_rows``);
  - ``graph.compute(executor="cpu").program(p).submit()`` equals the
    reference's ``graph.compute(executor="tpu")`` run on the CPU:
    PageRank bitwise at damping 0.5 (no dangling vertex) and at rtol 1e-6
    with the default damping (XLA's CPU backend contracts the update into
    an FMA, see tests/test_torch_fused.py), CC, SSSP and the k-hop count
    bitwise, ``traverse`` counts, ``paths()``, ``select()`` and MapReduce
    memory equal;
  - ``write_back`` writes byte-equal cells for the same states, and a
    reload returns them;
  - ``compute()`` raises without CUDA, and the options the port does not
    honour raise.
"""

import numpy as np
import pytest
import torch

from janusgraph_tpu.core import gods
from janusgraph_tpu.core.bulk import bulk_add_edges as ref_bulk_edges
from janusgraph_tpu.core.bulk import bulk_add_vertices as ref_bulk_vertices
from janusgraph_tpu.core.graph import open_graph as ref_open_graph
from janusgraph_tpu.olap import mapreduce as ref_mr
from janusgraph_tpu.olap import programs as ref_programs
from janusgraph_tpu.olap.csr import load_csr as ref_load_csr
from janusgraph_tpu.olap.csr import load_csr_snapshot as ref_load_csr_snapshot
from janusgraph_tpu.storage.inmemory import InMemoryStoreManager as RefStoreManager
from janusgraph_tpu_torch.core.bulk import bulk_add_edges, bulk_add_vertices
from janusgraph_tpu_torch.core.graph import open_graph
from janusgraph_tpu_torch.exceptions import ConfigurationError, TemporaryBackendError
from janusgraph_tpu_torch.olap import mapreduce
from janusgraph_tpu_torch.olap import programs
from janusgraph_tpu_torch.olap.csr import load_csr, load_csr_snapshot
from janusgraph_tpu_torch.olap.generators import rmat_edges
from janusgraph_tpu_torch.storage.inmemory import InMemoryStoreManager

CSR_FIELDS = (
    "vertex_ids", "out_indptr", "out_dst", "in_indptr", "in_src", "out_degree",
    "in_edge_weight", "out_edge_weight", "labels", "in_edge_type", "out_edge_type",
)
#: the reference on one device, no delta snapshot, the ELL strategy (the
#: port's ELL aggregation is bitwise equal to it)
REF_CONFIG = {"storage.backend": "inmemory", "computer.sharded-auto": False,
              "computer.delta": False, "computer.strategy": "ell"}
PORT_CONFIG = {"storage.backend": "inmemory", "computer.strategy": "ell",
               "computer.executor": "cpu"}


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _assert_csr_equal(want, got):
    for name in CSR_FIELDS:
        a, b = getattr(want, name), getattr(got, name)
        assert (a is None) == (b is None), name
        if a is not None:
            assert a.dtype == b.dtype, name
            np.testing.assert_array_equal(_bits(a), _bits(b), err_msg=name)
    assert set(want.properties) == set(got.properties)
    for k, a in want.properties.items():
        b = got.properties[k]
        assert a.dtype == b.dtype, k
        if a.dtype == object:
            assert list(a) == list(b), k
        else:
            np.testing.assert_array_equal(a, b, err_msg=k)


def _load(open_fn, bulk_v, bulk_e, config):
    """A scale-10 R-MAT graph plus a ring, half the vertices labelled "a"."""
    g = open_fn(config)
    n, src, dst = rmat_edges(10, seed=1)
    ring = np.arange(n)
    vids = np.concatenate([bulk_v(g, n // 2, label="a"), bulk_v(g, n - n // 2, label="b")])
    bulk_e(g, "link", vids[src], vids[dst])
    bulk_e(g, "ring", vids[ring], vids[(ring + 1) % n])
    return g, vids


def _rows(manager, names=("edgestore", "graphindex")):
    return {
        name: {k: list(zip(r.columns, r.values)) for k, r in manager.open_database(name)._rows.items()}
        for name in names
    }


@pytest.fixture(scope="module")
def graphs():
    ref, ref_vids = _load(ref_open_graph, ref_bulk_vertices, ref_bulk_edges, REF_CONFIG)
    got, vids = _load(open_graph, bulk_add_vertices, bulk_add_edges, PORT_CONFIG)
    yield ref, got, ref_vids, vids
    ref.close()
    got.close()


def test_bulk_load_writes_the_reference_rows(graphs):
    ref, got, ref_vids, vids = graphs
    np.testing.assert_array_equal(vids, ref_vids)
    assert _rows(got.backend.manager) == _rows(ref.backend.manager)


FILTERS = {
    "all": {},
    "link": {"edge_labels": ["link"]},
    "ring_and_link": {"edge_labels": ["ring", "link"]},
    "no_such_label": {"edge_labels": ["nothing"]},
    "vertices_a": {"vertex_labels": ["a"]},
    "vertices_a_link": {"vertex_labels": ["a"], "edge_labels": ["link"]},
    "weighted": {"weight_key": "link"},
    "partitions": {"partitions": [0, 3, 31]},
}


@pytest.mark.parametrize("name", list(FILTERS))
def test_load_csr_equals_reference(graphs, name):
    ref, got = graphs[:2]
    _assert_csr_equal(ref_load_csr(ref, **FILTERS[name]), load_csr(got, **FILTERS[name]))


def test_load_csr_snapshot_equals_reference(graphs):
    ref, got = graphs[:2]
    rcsr, repoch = ref_load_csr_snapshot(ref)
    csr, epoch = load_csr_snapshot(got)
    assert epoch == repoch
    _assert_csr_equal(rcsr, csr)
    rcsr, _ = ref_load_csr_snapshot(ref, edge_labels=["link"])
    csr, _ = load_csr_snapshot(got, edge_labels=["link"])
    _assert_csr_equal(rcsr, csr)


def test_scan_resumes_after_a_temporary_failure(graphs, monkeypatch):
    got = graphs[1]
    want = load_csr(got)
    store = got.backend.edgestore
    real = type(store).get_keys
    failures = {"left": 2}

    def flaky(self, query, txh):
        for i, row in enumerate(real(self, query, txh)):
            if i == 5 and failures["left"]:
                failures["left"] -= 1
                raise TemporaryBackendError("injected")
            yield row

    monkeypatch.setattr(type(store), "get_keys", flaky)
    _assert_csr_equal(want, load_csr(got))
    assert failures["left"] == 0
    failures["left"] = 10 ** 6
    with pytest.raises(TemporaryBackendError):
        load_csr(got)


def _pair(name):
    return {
        "pagerank_d05": (lambda m: m.PageRankProgram(damping=0.5, max_iterations=15, tol=0.0)),
        "pagerank": (lambda m: m.PageRankProgram(max_iterations=20)),
        "cc": (lambda m: m.ConnectedComponentsProgram()),
        "sssp": (lambda m: m.ShortestPathProgram(seed_index=3, max_iterations=4)),
        "khop": (lambda m: m.TraversalCountProgram(hops=3)),
    }[name]


@pytest.mark.parametrize("name", ["pagerank_d05", "pagerank", "cc", "sssp", "khop"])
def test_submit_equals_reference(graphs, name):
    ref, got = graphs[:2]
    make = _pair(name)
    want = ref.compute(executor="tpu").program(make(ref_programs)).submit()
    res = got.compute(executor="cpu").program(make(programs)).submit()
    _assert_csr_equal(want.csr, res.csr)
    assert set(res.states) == set(want.states)
    for k, w in want.states.items():
        w = np.asarray(w)
        assert res.states[k].dtype == w.dtype, k
        if name == "pagerank":
            np.testing.assert_allclose(res.states[k], w, rtol=1e-6, atol=1e-9)
        else:
            np.testing.assert_array_equal(_bits(res.states[k]), _bits(w), err_msg=k)
    assert res.run_info["routing"]["executor"] == "cpu"
    assert res.run_info["path"] == want.run_info["path"]
    assert res.run_info["supersteps"] == want.run_info["supersteps"]
    v = int(res.csr.vertex_ids[7])
    key = next(iter(res.states))
    assert res.by_vertex(key).keys() == want.by_vertex(key).keys()
    if name != "pagerank":
        assert res.value(key, v) == want.value(key, v)
        assert res.by_vertex(key) == want.by_vertex(key)


def test_submit_default_strategy_runs_the_kernel_route(graphs):
    """The port's default ("segsum") against the reference's ELL: a sum in
    another order, held at the kernel's tolerance."""
    ref, got = graphs[:2]
    gs = open_graph({"computer.executor": "cpu"},
                    store_manager=InMemoryStoreManager.from_rows(got.backend.manager.dump_rows()))
    res = gs.compute().program(programs.PageRankProgram(max_iterations=20)).submit()
    want = ref.compute(executor="tpu").program(ref_programs.PageRankProgram(max_iterations=20)).submit()
    assert res.run_info["strategy_resolved"] == "segsum"
    np.testing.assert_allclose(res.states["rank"], want.states["rank"], rtol=1e-4, atol=1e-6)


def test_traverse_counts_paths_and_select_equal_reference(graphs):
    ref, got = graphs[:2]
    spec = [("out", ["ring"], (), "b"), ("out", ["link"], (), "c"), ("out", ["ring"])]
    want = ref.compute(executor="tpu").vertices("a").traverse(
        *spec, paths=True, source_as="a").submit()
    res = got.compute(executor="cpu").vertices("a").traverse(
        *spec, paths=True, source_as="a").submit()
    for k, w in want.states.items():
        np.testing.assert_array_equal(_bits(res.states[k]), _bits(np.asarray(w)), err_msg=k)
    assert list(res.paths(limit=300)) == list(want.paths(limit=300))
    assert list(res.select("a", "c", limit=300)) == list(want.select("a", "c", limit=300))
    plain = got.compute(executor="cpu").traverse(("out", ["link"]), ("out", ["link"])).submit()
    ref_plain = ref.compute(executor="tpu").traverse(("out", ["link"]), ("out", ["link"])).submit()
    np.testing.assert_array_equal(plain.states["count"], np.asarray(ref_plain.states["count"]))
    with pytest.raises(ValueError, match="no reach masks"):
        plain.paths()


def test_map_reduce_memory_equals_reference(graphs):
    ref, got = graphs[:2]
    want = ref.compute(executor="tpu").program(ref_programs.ConnectedComponentsProgram()).map_reduce(
        ref_mr.ClusterCountMapReduce("component")).map_reduce(
        ref_mr.StatsMapReduce("component")).map_reduce(ref_mr.TopKMapReduce("component", 5)).submit()
    res = got.compute(executor="cpu").program(programs.ConnectedComponentsProgram()).map_reduce(
        mapreduce.ClusterCountMapReduce("component")).map_reduce(
        mapreduce.StatsMapReduce("component")).map_reduce(mapreduce.TopKMapReduce("component", 5)).submit()
    assert res.memory == want.memory


def test_write_back_writes_the_reference_cells_and_reloads(graphs):
    ref, got = graphs[:2]
    want = ref.compute(executor="tpu").program(
        ref_programs.PageRankProgram(max_iterations=10)).submit()
    res = got.compute(executor="cpu").program(programs.PageRankProgram(max_iterations=10)).submit()
    # the same states on both sides: the cells, not the ranks, are on test
    res.states["rank"] = np.asarray(want.states["rank"])
    want.write_back(["rank"])
    res.write_back(["rank"])
    assert _rows(got.backend.manager) == _rows(ref.backend.manager)
    back = load_csr(got, property_keys=("rank",))
    _assert_csr_equal(ref_load_csr(ref, property_keys=("rank",)), back)
    assert back.properties["rank"].dtype == np.float64
    np.testing.assert_array_equal(back.properties["rank"],
                                  np.asarray(want.states["rank"]).astype(np.float64))


@pytest.mark.parametrize("kind", ["list_float", "set_float", "single_int"])
def test_write_back_of_other_keys_goes_through_the_transaction(graphs, kind):
    """Non-SINGLE or non-float keys take the transactional path in both
    packages: the same cells (a SINGLE int key refuses the float values
    in both, leaving the rows as they were)."""
    from janusgraph_tpu.core.codecs import Cardinality as RefCardinality
    from janusgraph_tpu.exceptions import SchemaViolationError as RefSchemaError
    from janusgraph_tpu_torch.core.codecs import Cardinality
    from janusgraph_tpu_torch.exceptions import SchemaViolationError

    ref, got = graphs[:2]
    name = f"hops_{kind}"
    dtype, card = {"list_float": (float, "LIST"), "set_float": (float, "SET"),
                   "single_int": (int, "SINGLE")}[kind]
    ref.management().make_property_key(name, dtype, RefCardinality[card])
    got.management().make_property_key(name, dtype, Cardinality[card])
    want = ref.compute(executor="tpu").program(
        ref_programs.PageRankProgram(max_iterations=2)).submit()
    res = got.compute(executor="cpu").program(programs.PageRankProgram(max_iterations=2)).submit()
    want.states[name] = np.asarray(want.states["rank"])
    res.states[name] = np.asarray(want.states["rank"])
    if kind == "single_int":
        with pytest.raises(RefSchemaError):
            want.write_back([name])
        with pytest.raises(SchemaViolationError):
            res.write_back([name])
    else:
        want.write_back([name])
        res.write_back([name])
        back = load_csr(got, property_keys=(name,))
        np.testing.assert_array_equal(back.vertex_ids, res.csr.vertex_ids)
        assert back.properties[name][3] == float(want.states[name][3])
    assert _rows(got.backend.manager) == _rows(ref.backend.manager)


# ------------------------------------------------------- Graph of the Gods

@pytest.fixture(scope="module")
def gods_graphs():
    """The reference's Graph of the Gods, and two reopenings of its rows:
    the reference's and the port's (both then draw fresh id blocks)."""
    src = ref_open_graph()
    gods.load(src)
    rows = {name: {k: list(zip(r.columns, r.values)) for k, r in st._rows.items()}
            for name, st in src.backend.manager._stores.items()}
    src.close()
    ref_mgr = RefStoreManager()
    tx = ref_mgr.begin_transaction()
    for name, store_rows in rows.items():
        st = ref_mgr.open_database(name)
        for key, entries in store_rows.items():
            st.mutate(key, entries, [], tx)
    ref = ref_open_graph({"computer.sharded-auto": False, "computer.delta": False,
                          "computer.strategy": "ell"}, store_manager=ref_mgr)
    got = open_graph({"computer.strategy": "ell"}, store_manager=InMemoryStoreManager.from_rows(rows))
    yield ref, got
    ref.close()
    got.close()


GODS_FILTERS = {
    "all": {},
    "props_weight": {"property_keys": ("age", "name"), "weight_key": "time"},
    "battled_weight": {"edge_labels": ["battled"], "weight_key": "time"},
    "gods_only": {"vertex_labels": ["god"], "property_keys": ("name",)},
    "family": {"edge_labels": ["father", "mother", "brother"], "vertex_labels": ["god", "demigod", "titan", "human"]},
    "lives_reason_unread": {"edge_labels": ["lives"], "property_keys": ("place",)},
}


@pytest.mark.parametrize("name", list(GODS_FILTERS))
def test_gods_load_csr_equals_reference(gods_graphs, name):
    ref, got = gods_graphs
    _assert_csr_equal(ref_load_csr(ref, **GODS_FILTERS[name]), load_csr(got, **GODS_FILTERS[name]))


def test_gods_submit_and_write_back_equal_reference(gods_graphs):
    ref, got = gods_graphs
    want = ref.compute(executor="tpu").weight("time").properties("name").program(
        ref_programs.PageRankProgram(max_iterations=20)).submit()
    res = got.compute(executor="cpu").weight("time").properties("name").program(
        programs.PageRankProgram(max_iterations=20)).submit()
    _assert_csr_equal(want.csr, res.csr)
    np.testing.assert_allclose(res.states["rank"], np.asarray(want.states["rank"]), rtol=1e-6)
    res.states["rank"] = np.asarray(want.states["rank"])
    want.write_back(["rank"])
    res.write_back(["rank"])
    assert _rows(got.backend.manager) == _rows(ref.backend.manager)
    _assert_csr_equal(ref_load_csr(ref, property_keys=("rank", "age")),
                      load_csr(got, property_keys=("rank", "age")))
    counts = got.compute(executor="cpu").traverse(("in", ["father"]), ("out", ["battled"])).submit()
    ref_counts = ref.compute(executor="tpu").traverse(("in", ["father"]), ("out", ["battled"])).submit()
    np.testing.assert_array_equal(counts.states["count"], np.asarray(ref_counts.states["count"]))


# ------------------------------------------------------------ device, config

def test_compute_needs_cuda_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    g = open_graph()
    bulk_add_edges(g, "e", *np.split(bulk_add_vertices(g, 4), 2))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        g.compute()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        g.compute(executor="tpu")
    res = g.compute(executor="cpu").program(programs.PageRankProgram(max_iterations=3)).submit()
    assert res.run_info["routing"]["device"] == "cpu" and res.states["rank"].shape == (4,)
    cfg_cpu = open_graph({"computer.executor": "cpu"})
    assert cfg_cpu.compute().device.type == "cpu"


@pytest.mark.parametrize("config", [
    {"ids.renew-timeout-ms": 100.0},
    {"query.fast-property": False},
    {"storage.batch-loading": True},
    {"computer.result-mode": "persist"},
    {"no.such-option": 1},
])
def test_options_the_port_does_not_honour_raise(config):
    with pytest.raises(ConfigurationError):
        open_graph(config)


def test_sharded_executor_raises_and_config_reaches_the_executor(monkeypatch):
    from janusgraph_tpu_torch.olap import computer
    from janusgraph_tpu_torch.olap.gpu_executor import GPUExecutor

    made = []

    class Recorded(GPUExecutor):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append(self)

    monkeypatch.setattr(computer, "GPUExecutor", Recorded)
    g = open_graph({"computer.executor": "cpu", "computer.strategy": "pallas",
                    "computer.channel-cache-size": 1})
    # the sharded executor runs on the card by default (its default mesh
    # raises without one) and on the CPU when a mesh of CPU slots is given
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        g.compute(executor="sharded")
    vids = bulk_add_vertices(g, 6)
    bulk_add_edges(g, "e", vids[:3], vids[3:])
    bulk_add_edges(g, "f", vids[3:], vids[:3])
    from janusgraph_tpu_torch.parallel import Mesh

    sharded = g.compute(executor="sharded", mesh=Mesh([torch.device("cpu")] * 4)).program(
        programs.PageRankProgram(max_iterations=2)).submit()
    assert sharded.run_info["routing"]["executor"] == "sharded"
    assert sharded.run_info["executor"] == "sharded" and sharded.run_info["shards"]["count"] == 4
    res = g.compute().program(programs.PageRankProgram(max_iterations=2)).submit()
    np.testing.assert_allclose(sharded.states["rank"], res.states["rank"], rtol=1e-5, atol=1e-7)
    assert res.run_info["routing"]["requested"] == "cpu"
    assert res.run_info["strategy_resolved"] == "segsum"
    # two channels through an executor that submit() built with the
    # configured cache of one pack: the first is evicted by the second
    g.compute().traverse(("out", ["e"]), ("out", ["f"])).submit()
    ex = made[-1]
    assert ex.CHANNEL_CACHE_SIZE == 1 and GPUExecutor.CHANNEL_CACHE_SIZE == 8
    assert [c.labels for c in ex._channel_packs] == [(g.schema_cache.get_by_name("f").id,)]
