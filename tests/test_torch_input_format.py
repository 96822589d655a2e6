"""The port's input format (splits and star-vertex records) held to the
JAX package's, after the reference's ``tests/test_input_format.py`` (whose
Graph of the Gods needs a unique index, ROADMAP Queue A #5.2).

Both packages build the same graph (the bulk loader's labelled vertices
and edges, then a transaction with vertex and edge properties and a
second label), and their ``splits``, ``read_split`` and ``read_all`` give
the same partitions and the same star vertices, in the same order. Exact
equality: ids, names and values.
"""

import numpy as np
import pytest

from janusgraph_tpu.core.bulk import bulk_add_edges as ref_bulk_add_edges
from janusgraph_tpu.core.bulk import bulk_add_vertices as ref_bulk_add_vertices
from janusgraph_tpu.core.graph import open_graph as ref_open_graph
from janusgraph_tpu.olap.input_format import GraphInputFormat as RefInputFormat
from janusgraph_tpu_torch.core.bulk import bulk_add_edges, bulk_add_vertices
from janusgraph_tpu_torch.core.graph import open_graph
from janusgraph_tpu_torch.olap.input_format import GraphInputFormat, load_shard_csrs


def _build(opener, bv, be, cfg):
    g = opener(cfg)
    rng = np.random.default_rng(7)
    vids = bv(g, 90, label="node")
    be(g, "link", vids[rng.integers(0, 90, 400)], vids[rng.integers(0, 90, 400)])
    mgmt = g.management()
    mgmt.make_property_key("name", str)
    mgmt.make_property_key("since", int)
    tx = g.new_transaction()
    a = tx.add_vertex("person", name="a")
    b = tx.add_vertex("person", name="b")
    tx.add_edge(a, "knows", b, since=1999)
    tx.add_edge(a, "link", tx.get_vertex(int(vids[3])))
    tx.add_property(tx.get_vertex(int(vids[5])), "name", "five")
    tx.commit()
    return g


@pytest.fixture(scope="module")
def graphs():
    ref = _build(ref_open_graph, ref_bulk_add_vertices, ref_bulk_add_edges,
                 {"computer.sharded-auto": False})
    port = _build(open_graph, bulk_add_vertices, bulk_add_edges, {"computer.executor": "cpu"})
    yield ref, port
    ref.close()
    port.close()


def _stars(records):
    return [(sv.vertex_id, sv.label, sv.properties, sv.edges) for sv in records]


@pytest.mark.parametrize("num_splits", [None, 1, 3, 7, 32, 64])
def test_splits_equal_the_reference(graphs, num_splits):
    ref, port = graphs
    got = GraphInputFormat(port).splits(num_splits)
    want = RefInputFormat(ref).splits(num_splits)
    assert [(s.split_id, s.partitions) for s in got] == [(s.split_id, s.partitions) for s in want]
    assert sorted(p for s in got for p in s.partitions) == list(range(32))


@pytest.mark.parametrize("num_splits", [None, 4])
def test_read_split_equals_the_reference(graphs, num_splits):
    ref, port = graphs
    fp, fr = GraphInputFormat(port), RefInputFormat(ref)
    seen = []
    for sp, sr in zip(fp.splits(num_splits), fr.splits(num_splits)):
        got = _stars(fp.read_split(sp))
        assert got == _stars(fr.read_split(sr))
        seen.extend(v for v, *_ in got)
    assert len(seen) == len(set(seen)) == 92


def test_read_all_equals_the_reference(graphs):
    ref, port = graphs
    stars = list(GraphInputFormat(port).read_all(num_splits=3))
    assert _stars(stars) == _stars(RefInputFormat(ref).read_all(num_splits=3))
    assert sum(len(sv.edges) for sv in stars) == 402
    by_name = {sv.properties.get("name", [None])[0]: sv for sv in stars}
    assert by_name["a"].label == "person"
    assert sorted((lbl, p) for lbl, _o, p in by_name["a"].edges) == [
        ("knows", {"since": 1999}), ("link", {})]
    assert by_name["five"].label == "node"


def test_load_shard_csrs_waits_for_multi_gpu(graphs):
    """One CSR per split of ID partitions, equal to the reference's."""
    from janusgraph_tpu.olap.input_format import load_shard_csrs as ref_load_shard_csrs

    ref, port = graphs
    got, want = load_shard_csrs(port, 4), ref_load_shard_csrs(ref, 4)
    assert len(got) == len(want) == 4
    for a, b in zip(got, want):
        for name in ("vertex_ids", "in_indptr", "in_src", "out_indptr", "out_dst"):
            np.testing.assert_array_equal(getattr(a, name), getattr(b, name), err_msg=name)
    assert sum(c.num_vertices for c in got) == port_total(port)


def port_total(graph) -> int:
    from janusgraph_tpu_torch.olap.csr import load_csr

    return load_csr(graph).num_vertices
