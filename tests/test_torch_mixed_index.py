"""The port's mixed-index providers and their graph integration held to
the JAX package's (after ``tests/test_mixed_index.py``).

The provider contract runs on each package's ``memindex`` and
``localindex`` over the same documents: every query, ordered page, raw
query, total and ``supports`` answer is equal in both packages, and the
two ``localindex`` stores hold the same bytes. The graph scenarios run on
both packages' graphs, with the mixed index on "memindex" or on
"localindex", and give the same hits and plans ("mixed-index" with the
number of conditions pushed). The result-set cap
(``index.search.max-result-set-size``, ``query.hard-max-limit``) clips a
query as the reference's does, and ``index.search.backend = "remote"``
raises naming ROADMAP Queue A #5.5b. Exact equality throughout.
"""

from types import SimpleNamespace

import pytest

from janusgraph_tpu import indexing as ref_indexing
from janusgraph_tpu.core import predicates as ref_predicates
from janusgraph_tpu_torch import indexing
from janusgraph_tpu_torch.core import predicates
from janusgraph_tpu_torch.exceptions import BackendError, ConfigurationError
from janusgraph_tpu_torch.core.graph import open_graph
from tests.test_torch_index_lifecycle import assert_twins, plan

R = SimpleNamespace(ix=ref_indexing, pr=ref_predicates)
T = SimpleNamespace(ix=indexing, pr=predicates)

DOCS = {
    "d1": [("name", "Hercules son of Zeus"), ("weight", 0.5), ("title", "hero"),
           ("loc", (37.97, 23.72))],
    "d2": [("name", "Zeus god of thunder"), ("weight", 2.5), ("title", "god"),
           ("loc", (52.5, 13.4))],
    "d3": [("name", "Cerberus hound"), ("weight", 1.0), ("title", "monster"),
           ("loc", (38.0, 23.7))],
}


def _provider(ns, kind, directory):
    if kind == "memindex":
        p = ns.ix.InMemoryIndexProvider()
    else:
        p = ns.ix.LocalIndexProvider(directory=directory)
    KI, M = ns.ix.KeyInformation, ns.ix.Mapping
    p.register("store", "name", KI(str, M.TEXT))
    p.register("store", "title", KI(str, M.STRING))
    p.register("store", "weight", KI(float))
    p.register("store", "loc", KI(ns.pr.Geoshape))
    muts = {"store": {}}
    for docid, fields in DOCS.items():
        m = ns.ix.IndexMutation(is_new=True)
        for f, v in fields:
            m.add(f, ns.pr.Geoshape.point(*v) if f == "loc" else v)
        muts["store"][docid] = m
    p.mutate(muts, {})
    return p


@pytest.fixture(params=["memindex", "localindex"])
def providers(request, tmp_path):
    pair = (_provider(R, request.param, str(tmp_path / "ref")),
            _provider(T, request.param, str(tmp_path / "port")))
    yield request.param, pair
    for p in pair:
        p.close()


def _both(providers, fn):
    """fn(ns, provider) on both packages; equal answers, returned once."""
    kind, (ref, port) = providers
    a, b = fn(R, ref), fn(T, port)
    assert b == a
    if kind == "localindex":
        assert dict(port._kv.mem.data) == dict(ref._kv.mem.data)
    return b


def _q(ns, key, pred, value, **kw):
    return ns.ix.IndexQuery(ns.ix.PredicateCondition(key, pred, value), **kw)


def test_text_string_and_range_queries(providers):
    def fn(ns, p):
        C, Tx = ns.pr.Cmp, ns.pr.Text
        return [sorted(p.query("store", _q(ns, "name", Tx.CONTAINS, "zeus"))),
                p.query("store", _q(ns, "title", C.EQUAL, "god")),
                sorted(p.query("store", _q(ns, "weight", C.GREATER_THAN, 0.6))),
                sorted(p.query("store", _q(ns, "weight", C.LESS_THAN_EQUAL, 1.0))),
                sorted(p.query("store", _q(ns, "loc", ns.pr.Geo.WITHIN,
                                           ns.pr.Geoshape.circle(38.0, 23.7, 100))))]

    assert _both(providers, fn) == [["d1", "d2"], ["d2"], ["d2", "d3"], ["d1", "d3"],
                                    ["d1", "d3"]]


def test_boolean_conditions(providers):
    def fn(ns, p):
        ix, C, Tx = ns.ix, ns.pr.Cmp, ns.pr.Text
        pc = ix.PredicateCondition
        return [
            p.query("store", ix.IndexQuery(ix.And((pc("name", Tx.CONTAINS, "zeus"),
                                                   pc("weight", C.GREATER_THAN, 1.0))))),
            sorted(p.query("store", ix.IndexQuery(ix.Or((pc("title", C.EQUAL, "god"),
                                                         pc("title", C.EQUAL, "hero")))))),
            p.query("store", ix.IndexQuery(ix.Not(pc("name", Tx.CONTAINS, "zeus")))),
        ]

    assert _both(providers, fn) == [["d2"], ["d1", "d2"], ["d3"]]


def test_order_limit_offset_and_stream(providers):
    def fn(ns, p):
        cond = ns.ix.PredicateCondition("weight", ns.pr.Cmp.GREATER_THAN, 0.0)
        Q, O = ns.ix.IndexQuery, ns.ix.Order
        return [p.query("store", Q(cond, orders=(O("weight"),))),
                p.query("store", Q(cond, orders=(O("weight", desc=True),))),
                p.query("store", Q(cond, limit=1, offset=1)),
                list(p.query_stream("store", Q(cond, orders=(O("weight"),)), page_size=2))]

    assert _both(providers, fn) == [["d1", "d3", "d2"], ["d2", "d3", "d1"], ["d2"],
                                    ["d1", "d3", "d2"]]


def test_mutation_update_delete_and_restore(providers):
    def fn(ns, p):
        C, Tx = ns.pr.Cmp, ns.pr.Text
        m = ns.ix.IndexMutation()
        m.delete("title", "hero")
        m.add("title", "demigod")
        p.mutate({"store": {"d1": m}}, {})
        seen = [p.query("store", _q(ns, "title", C.EQUAL, "demigod"))]
        p.mutate({"store": {"d1": ns.ix.IndexMutation(is_deleted=True)}}, {})
        seen.append(p.query("store", _q(ns, "name", Tx.CONTAINS, "hercules")))
        p.restore({"store": {"d2": [ns.ix.IndexEntry("title", "skyfather")]}}, {})
        seen += [p.query("store", _q(ns, "title", C.EQUAL, "skyfather")),
                 p.query("store", _q(ns, "name", Tx.CONTAINS, "zeus"))]
        return seen

    assert _both(providers, fn) == [["d1"], [], ["d2"], []]


def test_raw_query_totals_and_supports(providers):
    def fn(ns, p):
        KI, M, Tx = ns.ix.KeyInformation, ns.ix.Mapping, ns.pr.Text
        return [sorted(d for d, _ in p.raw_query("store", ns.ix.RawQuery("v.name:zeus"))),
                p.totals("store", ns.ix.RawQuery("name:zeus")),
                [p.supports(KI(str, m), pred)
                 for m in (M.TEXT, M.STRING, M.TEXTSTRING)
                 for pred in (Tx.CONTAINS, Tx.PREFIX)],
                p.supports(KI(float), ns.pr.Cmp.LESS_THAN),
                p.supports(KI(ns.pr.Geoshape), ns.pr.Geo.INTERSECT),
                p.supports(KI(str, M.STRING), ns.pr.Contain.IN),
                p.supports(KI(str, M.STRING), ns.pr.Contain.NOT_IN)]

    assert _both(providers, fn) == [["d1", "d2"], 2,
                                    [True, False, False, True, True, True],
                                    True, True, True, False]


def test_within_pushdown_in_the_provider(providers):
    def fn(ns, p):
        p.register("wd", "city", ns.ix.KeyInformation(str, ns.ix.Mapping.STRING))
        p.register("wd", "n", ns.ix.KeyInformation(int))
        muts = {"wd": {}}
        for d, (city, n) in {"d1": ("sf", 1), "d2": ("nyc", 2), "d3": ("ber", 3)}.items():
            m = ns.ix.IndexMutation(is_new=True)
            m.add("city", city)
            m.add("n", n)
            muts["wd"][d] = m
        p.mutate(muts, {})
        IN = ns.pr.Contain.IN
        return [sorted(p.query("wd", _q(ns, "city", IN, ("sf", "ber", "nope")))),
                sorted(p.query("wd", _q(ns, "n", IN, (2, 3))))]

    assert _both(providers, fn) == [["d1", "d3"], ["d2", "d3"]]


@pytest.mark.parametrize("writer,reader", [(R, T), (T, R)])
def test_a_localindex_survives_reopen_in_the_other_package(tmp_path, writer, reader):
    d = str(tmp_path / "idx")
    p = writer.ix.LocalIndexProvider(directory=d)
    p.register("s", "name", writer.ix.KeyInformation(str, writer.ix.Mapping.TEXT))
    p.register("s", "score", writer.ix.KeyInformation(float))
    for i in range(20):
        m = writer.ix.IndexMutation(is_new=True)
        m.add("name", f"cerberus the hound {i}")
        m.add("score", float(i))
        p.mutate({"s": {f"doc{i:02d}": m}}, {})
    p.compact()
    p.close()
    q = reader.ix.LocalIndexProvider(directory=d)
    try:
        assert sorted(q.query("s", _q(reader, "score", reader.pr.Cmp.GREATER_THAN_EQUAL,
                                      17.0))) == ["doc17", "doc18", "doc19"]
        assert len(q.query("s", _q(reader, "name", reader.pr.Text.CONTAINS, "hound"))) == 20
    finally:
        q.close()


def test_localindex_numeric_coercion_matches_the_reference(tmp_path):
    answers = []
    for ns, name in ((R, "ref"), (T, "port")):
        p = ns.ix.LocalIndexProvider(directory=str(tmp_path / name))
        p.register("s", "w", ns.ix.KeyInformation(float))
        p.register("s", "n", ns.ix.KeyInformation(int))
        m = ns.ix.IndexMutation(is_new=True)
        m.add("w", 2)
        m.add("n", 2)
        p.mutate({"s": {"d1": m}}, {})
        C = ns.pr.Cmp
        answers.append([p.query("s", _q(ns, key, pred, val)) for key, pred, val in (
            ("w", C.LESS_THAN, 3), ("w", C.GREATER_THAN, 3), ("w", C.EQUAL, 2.0),
            ("n", C.GREATER_THAN, 1.5), ("n", C.LESS_THAN, 1.5), ("n", C.EQUAL, 1.5),
            ("n", C.EQUAL, 2.0))])
        p.close()
    assert answers[1] == answers[0] == [["d1"], [], ["d1"], ["d1"], [], [], ["d1"]]


def test_localindex_rejects_a_foreign_format(tmp_path):
    import struct

    p = indexing.LocalIndexProvider(directory=str(tmp_path / "idx"))
    p.register("s", "w", indexing.KeyInformation(float))
    m = indexing.IndexMutation(is_new=True)
    m.add("w", 1.0)
    p.mutate({"s": {"d1": m}}, {})
    p._kv.insert(p._VKEY, struct.pack(">I", 1), p._tx)
    p._tx.commit()
    p.close()
    with pytest.raises(BackendError, match="format"):
        indexing.LocalIndexProvider(directory=str(tmp_path / "idx"))


# ------------------------------------------------------------ graph integration
@pytest.fixture(params=["memindex", "localindex"])
def backend(request, tmp_path):
    def cfg(name):
        if request.param == "memindex":
            return {}
        return {"index.search.backend": "localindex",
                "index.search.directory": str(tmp_path / name)}

    return {"ref": cfg("ref"), "port": cfg("port")}


def _load_people(g):
    mgmt = g.management()
    mgmt.make_property_key("bio", str)
    mgmt.make_property_key("age", int)
    mgmt.build_mixed_index("people", ["bio", "age"], backing="search")
    tx = g.new_transaction()
    ids = [tx.add_vertex(bio=b, age=a).id for b, a in (
        ("fought the nemean lion", 30), ("god of thunder and sky", 5000),
        ("three headed hound", 100))]
    tx.commit()
    return ids


def _hits(g, make):
    return sorted(v.id for v in make(g.traversal()).to_list()), plan(make(g.traversal()))


def test_traversal_pushdown(backend):
    def scenario(pkg, g):
        ids = _load_people(g)
        P = pkg.P
        return [ids] + [_hits(g, q) for q in (
            lambda s: s.V().has("bio", P.text_contains("thunder")),
            lambda s: s.V().has("age", P.lt(500)),
            lambda s: s.V().has("bio", P.text_contains("hound")).has("age", P.gt(50)),
            lambda s: s.V().has("age", P.within(30, 100)),
            lambda s: s.V().has("age", P.without(30, 100)),
        )]

    seen = assert_twins(scenario, backend)
    a, b, c = seen[0]
    assert seen[1] == ([b], {"access": "mixed-index", "index": "people", "conditions_pushed": 1})
    assert seen[3] == ([c], {"access": "mixed-index", "index": "people", "conditions_pushed": 2})
    assert seen[4][0] == [a, c] and seen[5] == ([b], {"access": "full-scan"})


def test_updates_removals_and_tx_visibility(backend):
    def scenario(pkg, g):
        a, b, c = _load_people(g)
        P = pkg.P
        tx = g.new_transaction()
        tx.add_property(tx.get_vertex(a), "bio", "slew the hydra")
        tx.commit()
        seen = [_hits(g, lambda s: s.V().has("bio", P.text_contains("hydra"))),
                _hits(g, lambda s: s.V().has("bio", P.text_contains("nemean")))]
        tx = g.new_transaction()
        tx.remove_vertex(tx.get_vertex(c))
        tx.commit()
        seen.append(_hits(g, lambda s: s.V().has("bio", P.text_contains("hound"))))
        t = g.traversal()
        t.add_v(bio="swift messenger of the gods", age=900)
        seen.append(len(t.V().has("bio", P.text_contains("messenger")).to_list()))
        t.rollback()
        seen += [sorted(vid for vid, _ in g.index_query("people", "v.bio:hydra")),
                 g.index_totals("people", "bio:god"), [a, b, c]]
        return seen

    seen = assert_twins(scenario, backend)
    a = seen[-1][0]
    assert seen[0][0] == [a] and seen[1][0] == [] and seen[2][0] == []
    assert seen[3:6] == [1, [a], 1]


def test_label_mapping_geo_and_added_keys(backend):
    def scenario(pkg, g):
        P, Geoshape = pkg.P, pkg.predicates.Geoshape
        m = g.management()
        m.make_property_key("motto", str)
        m.make_vertex_label("clan")
        m.build_mixed_index("clans", ["motto"], backing="search", label="clan")
        m.make_property_key("code", str)
        m.build_mixed_index("codes", ["code"], backing="search", mappings={"code": "STRING"})
        m.make_property_key("spot", Geoshape)
        m.build_mixed_index("places", ["spot"], backing="search")
        m.make_property_key("alpha", str)
        m.make_property_key("beta", str)
        m.build_mixed_index("ab", ["alpha"], backing="search")
        m.add_index_key("ab", "beta", mapping="TEXT")
        tx = g.new_transaction()
        tx.add_vertex("clan", motto="strength and honor")
        tx.add_vertex(motto="strength in numbers")
        tx.add_vertex(code="ABC-123")
        athens = tx.add_vertex(spot=Geoshape.point(37.97, 23.72))
        tx.add_vertex(spot=Geoshape.point(52.5, 13.4))
        tx.add_vertex(alpha="one", beta="two three")
        tx.commit()
        return [athens.id, len(g.indexes["ab"].key_ids)] + [_hits(g, q) for q in (
            lambda s: s.V().has_label("clan").has("motto", P.text_contains("strength")),
            lambda s: s.V().has("code", P.text_prefix("ABC")),
            lambda s: s.V().has("code", P.eq("ABC-123")),
            lambda s: s.V().has("spot", P.geo_within(Geoshape.circle(38.0, 23.7, 100))),
            lambda s: s.V().has("beta", P.text_contains("three")),
        )]

    seen = assert_twins(scenario, backend)
    assert seen[1] == 2 and seen[5][0] == [seen[0]]
    assert [len(h[0]) for h in seen[2:]] == [1, 1, 1, 1, 1]
    assert seen[2][1]["index"] == "clans" and seen[6][1]["index"] == "ab"


def test_reindex_and_reopen(backend):
    def scenario(pkg, g):
        tx = g.new_transaction()
        a = tx.add_vertex(story="the hydra grew two heads")
        tx.commit()
        m = g.management()
        m.build_mixed_index("stories", ["story"], backing="search")
        seen = [m.update_index("stories", pkg.mgmt.SchemaAction.REINDEX)]
        seen.append(_hits(g, lambda s: s.V().has("story", pkg.P.text_contains("hydra"))))
        g2 = pkg.open(dict(pkg.config), store_manager=g.backend.manager)
        try:
            seen.append(_hits(g2, lambda s: s.V().has("story", pkg.P.text_contains("heads"))))
        finally:
            g2.close()
        return seen + [a.id]

    seen = assert_twins(scenario, backend)
    assert seen[1][0] == seen[2][0] == [seen[3]]


def test_build_validation(backend):
    def scenario(pkg, g):
        m = g.management()
        m.make_property_key("x", str)
        out = []
        for name, keys, backing in (("bad", ["x"], "nope"), ("bad2", [], "search")):
            with pytest.raises(pkg.schema_error) as e:
                m.build_mixed_index(name, keys, backing=backing)
            out.append(str(e.value))
        m.build_mixed_index("ok", ["x"], backing="search")
        with pytest.raises(pkg.schema_error) as e:
            m.build_mixed_index("ok", ["x"], backing="search")
        return out + [str(e.value)]

    assert_twins(scenario, backend)


def test_a_failed_document_flush_never_unwinds_the_primary():
    def scenario(pkg, g):
        m = g.management()
        m.make_property_key("note", str)
        m.build_mixed_index("notes", ["note"], backing="search")
        tx = g.new_transaction()
        tx._fail_mixed_for_test = True
        v = tx.add_vertex(note="lost then found")
        tx.commit()
        seen = [_hits(g, lambda s: s.V().has("note", pkg.P.text_contains("lost")))[0]]
        tx = g.new_transaction()
        seen.append(tx.get_vertex(v.id).value("note"))
        tx.rollback()
        m.update_index("notes", pkg.mgmt.SchemaAction.REINDEX)  # heals
        seen.append(_hits(g, lambda s: s.V().has("note", pkg.P.text_contains("lost")))[0])
        return seen + [v.id]

    seen = assert_twins(scenario)
    assert seen == [[], "lost then found", [seen[3]], seen[3]]


@pytest.mark.parametrize("option", ["index.search.max-result-set-size", "query.hard-max-limit"])
def test_the_result_set_cap_clips_a_query(option):
    def scenario(pkg, g):
        g.management().make_property_key("n", int)
        g.management().build_mixed_index("ns", ["n"], backing="search")
        tx = g.new_transaction()
        for i in range(40):
            tx.add_vertex(n=i)
        tx.commit()
        capped = pkg.open(dict(pkg.config, **{option: 25}), store_manager=g.backend.manager)
        try:
            t = lambda s: s.V().has("n", pkg.P.gte(0))  # noqa: E731
            idx = capped.indexes["ns"]
            return [len(t(capped.traversal()).to_list()), plan(t(capped.traversal())),
                    len(capped.mixed_index_query(None, idx, [("n", pkg.predicates.Cmp.GREATER_THAN_EQUAL, 0)],
                                                 limit=30)),
                    len(capped.index_query("ns", "n:[0 TO 100]"))]
        finally:
            capped.close()

    seen = assert_twins(scenario)
    assert seen[0] == 25 and seen[2] == 25


def test_the_remote_provider_names_its_item():
    with pytest.raises(ConfigurationError, match=r"#5\.5b"):
        open_graph({"index.search.backend": "remote"})
    for option, value in (("index.search.hostname", "h"), ("index.search.port", 1)):
        with pytest.raises(ConfigurationError, match=r"#5\.5b"):
            open_graph({option: value})
    with pytest.raises(ConfigurationError, match=r"#5\.5b"):
        indexing.open_index_provider("remote")
