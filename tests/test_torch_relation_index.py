"""The port's vertex-centric relation indexes held to the JAX package's
(after ``tests/test_relation_index.py``).

A relation index is built after its edge label: new edges write a copy
under the index's type id with the index's sort key in the column, and
``reindex_relation_index`` copies the edges written before it. Each
scenario runs on an in-memory graph of each package; their observations
(sort-range hits, errors, counts) are equal, and so are their
``edgestore`` and ``graphindex`` rows, byte for byte. The copies stay
invisible to untyped reads, to ``load_csr`` and to the input format.
Exact equality throughout.
"""

import pytest

from tests.test_torch_index_lifecycle import assert_twins


def _graph_with_data(pkg, g):
    m = g.management()
    m.make_property_key("time", int)
    m.make_edge_label("battled")  # no sort key at creation
    tx = g.new_transaction()
    h = tx.add_vertex()
    for t in (1, 5, 9, 12, 20):
        tx.add_edge(h, "battled", tx.add_vertex(), time=t)
    tx.commit()
    return h.id


def _indexed(pkg, g):
    hid = _graph_with_data(pkg, g)
    m = g.management()
    m.build_edge_index("battled", "battlesByTime", ["time"])
    return hid, m.reindex_relation_index("battlesByTime")


def _times(pkg, g, hid, sort_range=None, tx=None):
    own = tx is None
    tx = tx or g.new_transaction()
    try:
        es = tx.get_edges(tx.get_vertex(hid), pkg.codecs.Direction.OUT, ("battled",),
                          sort_range=sort_range)
        return sorted(e.value("time") for e in es)
    finally:
        if own:
            tx.rollback()


def test_build_reindex_and_query():
    def scenario(pkg, g):
        hid = _graph_with_data(pkg, g)
        ri = g.management().build_edge_index("battled", "battlesByTime", ["time"])
        n = g.management().reindex_relation_index("battlesByTime")
        return [ri.status, n, _times(pkg, g, hid, (5, 12))]

    assert assert_twins(scenario) == ["REGISTERED", 5, [5, 9]]


def test_new_edges_indexed_without_reindex():
    def scenario(pkg, g):
        hid, _ = _indexed(pkg, g)
        tx = g.new_transaction()
        tx.add_edge(tx.get_vertex(hid), "battled", tx.add_vertex(), time=7)
        tx.commit()
        return _times(pkg, g, hid, (6, 10))

    assert assert_twins(scenario) == [7, 9]


def test_overlay_edges_respect_index_range():
    def scenario(pkg, g):
        hid, _ = _indexed(pkg, g)
        tx = g.new_transaction()
        h = tx.get_vertex(hid)
        tx.add_edge(h, "battled", tx.add_vertex(), time=8)  # uncommitted
        tx.add_edge(h, "battled", tx.add_vertex())  # no time: not indexed
        out = _times(pkg, g, hid, (6, 10), tx=tx)
        tx.rollback()
        return out

    assert assert_twins(scenario) == [8, 9]


def test_index_cells_invisible_to_plain_reads():
    def scenario(pkg, g):
        hid, _ = _indexed(pkg, g)
        tx = g.new_transaction()
        edges = tx.get_edges(tx.get_vertex(hid), pkg.codecs.Direction.OUT, ())
        both = sum(len(tx.get_edges(v, pkg.codecs.Direction.BOTH, ())) for v in tx.vertices())
        tx.rollback()
        return [len(edges), sorted({e.label for e in edges}), both]

    assert assert_twins(scenario) == [5, ["battled"], 10]


def test_load_csr_and_the_input_format_skip_the_copies():
    def scenario(pkg, g):
        _indexed(pkg, g)
        csr = pkg.csr.load_csr(g)
        svs = list(pkg.input_format.GraphInputFormat(g).read_all())
        edges = [e for sv in svs for e in sv.edges]
        return [csr.num_edges, csr.out_dst.tolist(), len(edges), sorted({lbl for lbl, _o, _p in edges})]

    seen = assert_twins(scenario)
    assert seen[0] == 5 and seen[2:] == [5, ["battled"]]


@pytest.mark.parametrize("status", [None, "DISABLED"])
def test_a_label_without_an_enabled_index_refuses_a_range(status):
    def scenario(pkg, g):
        hid = _graph_with_data(pkg, g)
        if status:
            m = g.management()
            m.build_edge_index("battled", "battlesByTime", ["time"])
            m.reindex_relation_index("battlesByTime")
            m.set_relation_index_status("battlesByTime", status)
        with pytest.raises(pkg.query_error) as e:
            _times(pkg, g, hid, (1, 2))
        return str(e.value)

    assert "no enabled relation index" in assert_twins(scenario)


def test_build_validation():
    def scenario(pkg, g):
        m = g.management()
        m.make_property_key("note", str)  # variable width
        m.make_property_key("t", int)
        m.make_edge_label("l")
        out = []
        for args in (("nope", "x", ["t"]), ("l", "x", ["note"]), ("l", "x", [])):
            with pytest.raises(pkg.schema_error) as e:
                m.build_edge_index(*args)
            out.append(str(e.value))
        return out

    assert_twins(scenario)


def test_delete_through_an_index_routed_edge_removes_the_primary():
    def scenario(pkg, g):
        hid, _ = _indexed(pkg, g)
        tx = g.new_transaction()
        [e] = tx.get_edges(tx.get_vertex(hid), pkg.codecs.Direction.OUT, ("battled",),
                           sort_range=(5, 6))
        e.remove()
        tx.commit()
        return [_times(pkg, g, hid), _times(pkg, g, hid, (0, 50))]

    assert assert_twins(scenario) == [[1, 9, 12, 20]] * 2


def test_delete_while_disabled_leaves_no_phantom():
    def scenario(pkg, g):
        hid, _ = _indexed(pkg, g)
        m = g.management()
        m.set_relation_index_status("battlesByTime", "DISABLED")
        tx = g.new_transaction()
        [e] = [x for x in tx.get_edges(tx.get_vertex(hid), pkg.codecs.Direction.OUT,
                                       ("battled",)) if x.value("time") == 9]
        e.remove()
        tx.commit()
        m.set_relation_index_status("battlesByTime", "ENABLED")
        return _times(pkg, g, hid, (0, 50))

    assert assert_twins(scenario) == [1, 5, 12, 20]


def test_vertex_removal_strikes_the_index_cells():
    def scenario(pkg, g):
        hid, _ = _indexed(pkg, g)
        tx = g.new_transaction()
        tx.remove_vertex(tx.get_vertex(hid))
        tx.commit()
        store = g.backend.edgestore
        while hasattr(store, "wrapped"):
            store = store.wrapped
        key = g.idm.get_key(hid)
        stx = g.backend.manager.begin_transaction()
        return store.get_slice(pkg.kcvs.KeySliceQuery(key, pkg.kcvs.SliceQuery()), stx)

    assert assert_twins(scenario) == []


@pytest.mark.parametrize("direction", ["OUT", "IN"])
def test_a_one_direction_index_serves_only_its_direction(direction):
    def scenario(pkg, g):
        hid = _graph_with_data(pkg, g)
        m = g.management()
        m.build_edge_index("battled", "byTime", ["time"],
                           getattr(pkg.codecs.Direction, direction))
        m.reindex_relation_index("byTime")
        tx = g.new_transaction()
        v = tx.get_vertex(hid)
        out = []
        for d in ("OUT", "IN"):
            try:
                es = tx.get_edges(v, getattr(pkg.codecs.Direction, d), ("battled",),
                                  sort_range=(0, 10))
                out.append(sorted(e.value("time") for e in es))
            except pkg.query_error:
                out.append("refused")
        tx.rollback()
        return out

    seen = assert_twins(scenario)
    assert seen == ([[1, 5, 9], "refused"] if direction == "OUT" else ["refused", []])
