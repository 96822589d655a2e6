"""Indexes across the two packages on one local directory.

A directory the JAX package writes with the Graph of the Gods, a
vertex-centric index on "battled" and its reindex opens in the port with
the reference's 17 edges: the index's three copies of "battled" are no
edges, to ``load_csr`` (its arrays equal the reference's) or to an untyped
``get_edges``. A port commit into a directory whose composite indexes the
reference defined writes the index rows, so the reference finds the new
vertices through ``has()``, and a duplicate of the unique "name" raises
``SchemaViolationError`` in the port as in the reference. The other way
round holds too, and a ``localindex`` directory either package writes
answers the other's queries. Exact equality throughout: ids, arrays and
bytes.
"""

import numpy as np
import pytest

from janusgraph_tpu.core import gods as ref_gods
from janusgraph_tpu.core.codecs import Direction as RefDirection
from janusgraph_tpu.core.graph import open_graph as ref_open_graph
from janusgraph_tpu.core.traversal import P as RefP
from janusgraph_tpu.exceptions import SchemaViolationError as RefSchemaError
from janusgraph_tpu.olap.csr import load_csr as ref_load_csr
from janusgraph_tpu_torch.core.codecs import Direction
from janusgraph_tpu_torch.core.graph import open_graph
from janusgraph_tpu_torch.core.traversal import P
from janusgraph_tpu_torch.exceptions import SchemaViolationError
from janusgraph_tpu_torch.olap.csr import load_csr

CSR_FIELDS = ("vertex_ids", "out_indptr", "out_dst", "in_indptr", "in_src", "out_degree",
              "labels", "in_edge_type", "out_edge_type")


def _cfg(tmp_path):
    return {"storage.backend": "local", "storage.directory": str(tmp_path / "graph")}


def _ref(cfg):
    return ref_open_graph(dict(cfg, **{"computer.sharded-auto": False}))


def _port(cfg):
    return open_graph(dict(cfg, **{"computer.executor": "cpu"}))


def _untyped_edges(tx, direction):
    return sum(len(tx.get_edges(v, direction, ())) for v in tx.vertices())


def test_reference_relation_index_loads_with_the_reference_edges(tmp_path):
    cfg = _cfg(tmp_path)
    ref = _ref(cfg)
    ref_gods.load(ref)
    mgmt = ref.management()
    mgmt.build_edge_index("battled", "battlesByTime", ["time"])
    assert mgmt.reindex_relation_index("battlesByTime") == 3
    want = ref_load_csr(ref, property_keys=("age",))
    rtx = ref.new_transaction()
    ref_untyped = _untyped_edges(rtx, RefDirection.OUT)
    rtx.rollback()
    ref.close()
    assert want.num_edges == 17 and ref_untyped == 17

    port = _port(cfg)
    try:
        assert len(port.relation_index_ids) == 1
        got = load_csr(port, property_keys=("age",))
        assert got.num_edges == 17
        for field in CSR_FIELDS:
            np.testing.assert_array_equal(getattr(got, field), getattr(want, field))
        np.testing.assert_array_equal(got.properties["age"], want.properties["age"])
        tx = port.new_transaction()
        assert _untyped_edges(tx, Direction.OUT) == 17
        assert _untyped_edges(tx, Direction.IN) == 17
        # the index itself answers a sort range on the sort-keyed label's copy
        herc = port.traversal().V().has("name", "hercules").next()
        times = [e.value("time") for e in tx.get_edges(
            tx.get_vertex(herc.id), Direction.OUT, ("battled",), sort_range=(1, 3))]
        assert times == [1, 2]
        tx.rollback()
    finally:
        port.close()


def test_port_commit_maintains_the_reference_indexes(tmp_path):
    cfg = _cfg(tmp_path)
    ref = _ref(cfg)
    ref_gods.load(ref)
    ref.close()

    port = _port(cfg)
    try:
        tx = port.new_transaction()
        tx.add_vertex("titan", name="saturn")
        with pytest.raises(SchemaViolationError, match="unique index name"):
            tx.commit()
        tx = port.new_transaction()
        zeus2 = tx.add_vertex("god", name="zeus2", age=7)
        tx.commit()
    finally:
        port.close()

    ref = _ref(cfg)
    try:
        t = ref.traversal()
        assert [v.id for v in t.V().has("name", "zeus2").to_list()] == [zeus2.id]
        assert [v.id for v in t.V().has("age", 7).to_list()] == [zeus2.id]
        start = t.V().has("name", "zeus2").profile().as_dict()["children"][0]
        assert start["annotations"]["access"] == "composite-index"
        # the reference refuses the same duplicate
        rtx = ref.new_transaction()
        rtx.add_vertex("titan", name="saturn")
        with pytest.raises(RefSchemaError):
            rtx.commit()
    finally:
        ref.close()


def test_reference_commit_maintains_the_port_indexes(tmp_path):
    from janusgraph_tpu_torch.core import gods

    cfg = _cfg(tmp_path)
    port = _port(cfg)
    gods.load(port)
    port.close()

    ref = _ref(cfg)
    try:
        rtx = ref.new_transaction()
        v = rtx.add_vertex("god", name="zeus3", age=8)
        rtx.commit()
    finally:
        ref.close()
    port = _port(cfg)
    try:
        t = port.traversal()
        assert [x.id for x in t.V().has("age", 8).to_list()] == [v.id]
        tx = port.new_transaction()
        tx.add_vertex("god", name="zeus3")
        with pytest.raises(SchemaViolationError):
            tx.commit()
    finally:
        port.close()


@pytest.mark.parametrize("writer", ["ref", "port"])
def test_a_localindex_directory_opens_in_the_other_package(tmp_path, writer):
    cfg = dict(_cfg(tmp_path), **{
        "index.search.backend": "localindex",
        "index.search.directory": str(tmp_path / "index"),
    })
    first = _ref(cfg) if writer == "ref" else _port(cfg)
    mgmt = first.management()
    mgmt.make_property_key("bio", str)
    mgmt.make_property_key("age", int)
    mgmt.build_mixed_index("people", ["bio", "age"], backing="search")
    tx = first.new_transaction()
    ids = [tx.add_vertex(bio=b, age=a).id for b, a in (
        ("fought the nemean lion", 30), ("god of thunder and sky", 5000),
        ("three headed hound", 100))]
    tx.commit()
    first.close()

    second = _port(cfg) if writer == "ref" else _ref(cfg)
    p = P if writer == "ref" else RefP
    try:
        t = second.traversal()
        assert [v.id for v in t.V().has("bio", p.text_contains("thunder")).to_list()] == [ids[1]]
        assert sorted(v.id for v in t.V().has("age", p.lt(500)).to_list()) == sorted(
            [ids[0], ids[2]])
        assert second.index_totals("people", "bio:hound") == 1
    finally:
        second.close()
