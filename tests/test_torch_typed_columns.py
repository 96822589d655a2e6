"""Float weights and typed vertex columns reaching the OLAP path, held to
the JAX package.

The same transactions in both packages write a graph whose edges carry a
``Float`` (np.float32) weight and whose vertices carry ``Int``, ``Float``,
``Long`` and ``Double`` columns. ``load_csr(weight_key=..., property_keys=
...)`` gives equal arrays, dtypes included: the weights are the written
float32s bit for bit, and only Python int/float columns become float64 (an
np.int32 or np.float32 column stays ``object`` in both packages, since
neither is a Python number). PageRank and weighted SSSP through
``graph.compute()`` on the CPU equal the reference's (SSSP bit for bit,
and scipy's Dijkstra over the same float32 weights), and a filtered OLAP
traversal over the object column counts as the reference does, its mask
equal to numpy's comparison.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import scipy.sparse as sp
from scipy.sparse.csgraph import dijkstra

from janusgraph_tpu.core.graph import open_graph as ref_open_graph
from janusgraph_tpu.core.predicates import Cmp as RefCmp
from janusgraph_tpu.olap import csr as ref_csr
from janusgraph_tpu.olap import programs as ref_programs
from janusgraph_tpu_torch.core.graph import open_graph
from janusgraph_tpu_torch.core.predicates import Cmp
from janusgraph_tpu_torch.olap import csr, programs
from janusgraph_tpu_torch.olap.programs.shortest_path import INF
from janusgraph_tpu_torch.olap.programs.olap_traversal import (
    PropertyFilter,
    evaluate_filter_mask,
)

REF = SimpleNamespace(open=ref_open_graph, executor="tpu", csr=ref_csr, programs=ref_programs,
                      Cmp=RefCmp, config={"computer.sharded-auto": False, "computer.delta": False})
PORT = SimpleNamespace(open=open_graph, executor="cpu", csr=csr, programs=programs, Cmp=Cmp,
                       config={"computer.executor": "cpu", "computer.delta": False})
KEYS = ("bucket", "score", "name", "x")


def write(g, seed, n=48, m=200):
    rng = np.random.default_rng(seed)
    bucket = rng.integers(0, 6, n).astype(np.int32)
    score = rng.random(n).astype(np.float32)
    src, dst = rng.integers(0, n, m), rng.integers(0, n, m)
    w = (1.0 - rng.random(m)).astype(np.float32)  # in (0, 1]
    tx = g.new_transaction()
    vs = [tx.add_vertex(name=i, bucket=bucket[i], score=score[i], x=float(i) / 3)
          for i in range(n)]
    for k in range(m):
        tx.add_edge(vs[int(src[k])], "link", vs[int(dst[k])], w32=w[k])
    tx.commit()
    return SimpleNamespace(bucket=bucket, score=score, src=src, dst=dst, w=w, n=n)


@pytest.fixture(scope="module", params=[0, 1])
def graphs(request):
    out = {}
    for name, pkg in (("ref", REF), ("port", PORT)):
        g = pkg.open(dict(pkg.config))
        out[name] = (g, write(g, request.param))
    yield out
    for g, _ in out.values():
        g.close()


def test_weights_and_columns_equal_reference(graphs):
    (ref, data), (port, _) = graphs["ref"], graphs["port"]
    want = ref_csr.load_csr(ref, weight_key="w32", property_keys=KEYS)
    got = csr.load_csr(port, weight_key="w32", property_keys=KEYS)
    for field in ("vertex_ids", "out_indptr", "out_dst", "in_indptr", "in_src",
                  "out_edge_weight", "in_edge_weight"):
        a, b = getattr(got, field), getattr(want, field)
        assert a.dtype == b.dtype and np.array_equal(a, b), field
    assert got.out_edge_weight.dtype == np.float32 and got.num_vertices == data.n
    # the written float32 weights, bit for bit, on their edges
    names = np.array([x for x in got.properties["name"]], dtype=np.int64)
    pos = np.repeat(np.arange(data.n), np.diff(got.out_indptr))
    have = sorted(zip(names[pos].tolist(), names[got.out_dst].tolist(),
                      got.out_edge_weight.view(np.uint32).tolist()))
    wrote = sorted(zip(data.src.tolist(), data.dst.tolist(), data.w.view(np.uint32).tolist()))
    assert have == wrote
    for key in KEYS:
        a, b = got.properties[key], want.properties[key]
        assert a.dtype == b.dtype, key
        assert [type(v).__name__ for v in a] == [type(v).__name__ for v in b], key
        assert np.array_equal(a.astype(np.float64), b.astype(np.float64)), key
    assert got.properties["bucket"].dtype == object and got.properties["score"].dtype == object
    assert got.properties["name"].dtype == np.float64 and got.properties["x"].dtype == np.float64
    assert np.array_equal(got.properties["bucket"].astype(np.int32), data.bucket[names])
    assert np.array_equal(got.properties["score"].astype(np.float32).view(np.uint32),
                          data.score[names].view(np.uint32))


def test_pagerank_equals_reference(graphs):
    (ref, _), (port, _) = graphs["ref"], graphs["port"]
    want = ref.compute(executor="tpu").weight("w32").program(
        ref_programs.PageRankProgram(max_iterations=20, tol=0.0)).submit()
    got = port.compute(executor="cpu").weight("w32").program(
        programs.PageRankProgram(max_iterations=20, tol=0.0)).submit()
    assert np.array_equal(got.csr.vertex_ids, want.csr.vertex_ids)
    np.testing.assert_allclose(got.states["rank"], want.states["rank"], rtol=1e-6, atol=0)


def test_weighted_sssp_equals_reference_and_dijkstra(graphs):
    (ref, data), (port, _) = graphs["ref"], graphs["port"]
    want = ref.compute(executor="tpu").weight("w32").program(
        ref_programs.ShortestPathProgram(seed_index=0, weighted=True)).submit()
    got = port.compute(executor="cpu").weight("w32").program(
        programs.ShortestPathProgram(seed_index=0, weighted=True)).submit()
    d, w = got.states["distance"], want.states["distance"]
    assert d.dtype == w.dtype and np.array_equal(d, w)
    c = got.csr
    src = np.repeat(np.arange(c.num_vertices), np.diff(c.out_indptr))
    # duplicate edges: the lightest one counts
    best = {}
    for a, b, x in zip(src, c.out_dst, c.out_edge_weight.astype(np.float64)):
        best[(a, b)] = min(best.get((a, b), np.inf), x)
    keys = list(best)
    adj = sp.csr_matrix(([best[k] for k in keys], ([k[0] for k in keys], [k[1] for k in keys])),
                        shape=(c.num_vertices,) * 2)
    ref_d = dijkstra(adj, indices=0)
    reach = np.isfinite(ref_d)
    assert reach.sum() > 1
    np.testing.assert_allclose(d[reach], ref_d[reach], rtol=1e-6)
    assert (d[~reach] == np.float32(INF)).all()


@pytest.mark.parametrize("k", [0, 3])
def test_filtered_traversal_over_an_object_column(graphs, k):
    (ref, _), (port, _) = graphs["ref"], graphs["port"]
    want = ref.compute(executor="tpu").traverse(
        ("out", ["link"], [("bucket", RefCmp.GREATER_THAN, k)])).submit()
    got = port.compute(executor="cpu").traverse(
        ("out", ["link"], [("bucket", Cmp.GREATER_THAN, k)])).submit()
    assert np.array_equal(got.states["count"], want.states["count"])
    col = got.csr.properties["bucket"]
    mask = evaluate_filter_mask(got.csr, [PropertyFilter("bucket", Cmp.GREATER_THAN, k)])
    assert np.array_equal(mask, (col.astype(np.int32) > k).astype(np.float32))
    assert 0 < mask.sum() < len(mask)
