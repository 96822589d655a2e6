"""The port's Graph of the Gods held to the JAX package's (BASELINE.json
config 1).

``gods.load`` in both packages writes the same rows (schema, the unique
composite index on "name", the index on "age", 12 vertices and 17 edges),
byte for byte. PageRank through ``graph.compute().program(...).submit()``
on ``device="cpu"`` equals the reference's executor at rtol 1e-6 (the
tolerance ROADMAP states for PageRank at the default damping) and a float64
power iteration at 1e-6. The composite-index traversals give the same
results and plans in both packages. A ``write_back`` of a key an index
covers takes the transactional path, and its index follows.
"""

import numpy as np
import pytest

from janusgraph_tpu.olap import programs as ref_programs
from janusgraph_tpu_torch.olap import computer as computer_mod
from janusgraph_tpu_torch.olap import programs
from tests.test_torch_index_lifecycle import PORT, REF, plan, rows


@pytest.fixture(scope="module")
def gods_graphs():
    out = {}
    for name, pkg in (("ref", REF), ("port", PORT)):
        g = pkg.open(dict(pkg.config, **{"computer.delta": False}))
        pkg.gods.load(g)
        out[name] = g
    yield out["ref"], out["port"]
    for g in out.values():
        g.close()


def test_gods_rows_are_byte_equal(gods_graphs):
    ref, port = gods_graphs
    assert rows(port) == rows(ref)
    assert sorted(port.indexes) == sorted(ref.indexes) == ["age", "name"]
    for name in ("age", "name"):
        assert vars(port.indexes[name]) == vars(ref.indexes[name])


def _pagerank_fp64(csr, iters, damping=0.85):
    n = csr.num_vertices
    outdeg = csr.out_degree.astype(np.float64)
    seg = np.repeat(np.arange(n), np.diff(csr.in_indptr))
    rank = np.full(n, 1.0 / n)
    dangling = rank[outdeg == 0].sum()
    for _ in range(iters):
        agg = np.bincount(seg, weights=(rank / np.maximum(outdeg, 1.0))[csr.in_src], minlength=n)
        rank = (1.0 - damping) / n + damping * (agg + dangling / n)
        dangling = rank[outdeg == 0].sum()
    return rank


def test_gods_pagerank_equals_the_reference(gods_graphs):
    ref, port = gods_graphs
    want = ref.compute(executor="tpu").program(
        ref_programs.PageRankProgram(max_iterations=20, tol=0.0)).submit()
    got = port.compute(executor="cpu").program(
        programs.PageRankProgram(max_iterations=20, tol=0.0)).submit()
    np.testing.assert_array_equal(got.csr.vertex_ids, want.csr.vertex_ids)
    assert got.csr.num_vertices == 12 and got.csr.num_edges == 17
    np.testing.assert_allclose(got.states["rank"], np.asarray(want.states["rank"]), rtol=1e-6)
    np.testing.assert_allclose(got.states["rank"], _pagerank_fp64(got.csr, 20), rtol=1e-6)
    assert got.run_info["supersteps"] == want.run_info["supersteps"] == 20


@pytest.mark.parametrize("query", [
    "name_eq", "age_eq", "name_within", "label_and_name", "name_missing", "age_range",
    "name_then_out",
])
def test_gods_traversals_equal_results_and_plans(gods_graphs, query):
    def build(pkg, s):
        P = pkg.P
        return {
            "name_eq": lambda: s.V().has("name", "hercules"),
            "age_eq": lambda: s.V().has("age", 4500),
            "name_within": lambda: s.V().has("name", P.within("jupiter", "pluto", "nobody")),
            "label_and_name": lambda: s.V().has_label("god").has("name", "neptune"),
            "name_missing": lambda: s.V().has("name", "zeus"),
            "age_range": lambda: s.V().has("age", P.gt(4000)),
            "name_then_out": lambda: s.V().has("name", "hercules").out("battled"),
        }[query]()

    seen = []
    for pkg, g in zip((REF, PORT), gods_graphs):
        ids = sorted(v.id for v in build(pkg, g.traversal()).to_list())
        seen.append((ids, plan(build(pkg, g.traversal()))))
    assert seen[1] == seen[0]
    access = seen[1][1]["access"]
    assert access == {"name_within": "composite-index-union", "age_range": "full-scan"}.get(
        query, "composite-index")


def test_gods_duplicate_name_raises_in_both(gods_graphs):
    msgs = []
    for pkg, g in zip((REF, PORT), gods_graphs):
        tx = g.new_transaction()
        tx.add_vertex("god", name="jupiter")
        with pytest.raises(pkg.schema_error) as e:
            tx.commit()
        msgs.append(str(e.value))
    assert msgs[1] == msgs[0]


@pytest.mark.parametrize("kind", ["composite", "mixed"])
def test_indexed_write_back_takes_the_transactional_path(monkeypatch, kind):
    calls = []
    real_tx, real_col = computer_mod._write_back_tx, computer_mod._write_back_columnar
    monkeypatch.setattr(computer_mod, "_write_back_tx",
                        lambda *a, **k: (calls.append("tx"), real_tx(*a, **k))[1])
    monkeypatch.setattr(computer_mod, "_write_back_columnar",
                        lambda *a, **k: (calls.append("columnar"), real_col(*a, **k))[1])
    seen = []
    for pkg in (REF, PORT):
        g = pkg.open(dict(pkg.config, **{"computer.delta": False}))
        try:
            pkg.gods.load(g)
            m = g.management()
            m.make_property_key("rank", float)
            if kind == "composite":
                m.build_composite_index("byRank", ["rank"])
            else:
                m.build_mixed_index("rankIdx", ["rank"])
            make = pkg.programs.PageRankProgram(max_iterations=20, tol=0.0)
            res = g.compute(executor="tpu" if pkg is REF else "cpu").program(make).submit()
            if pkg is PORT:
                res.states["rank"] = want_ranks  # the reference's, so the cells match
            else:
                want_ranks = np.asarray(res.states["rank"])
            res.write_back(["rank"])
            ranks = np.asarray(res.states["rank"], dtype=np.float64)
            top = float(np.sort(ranks)[-3])
            hits = sorted(v.id for v in g.traversal().V().has(
                "rank", pkg.P.gte(top) if kind == "mixed" else float(ranks.max())).to_list())
            want = sorted(int(v) for v in res.csr.vertex_ids[
                ranks >= top if kind == "mixed" else ranks == ranks.max()])
            seen.append((rows(g), hits == want, plan(g.traversal().V().has(
                "rank", pkg.P.gte(top) if kind == "mixed" else float(ranks.max())))))
        finally:
            g.close()
    assert calls == ["tx"]  # the port's write_back; the reference's is not patched
    assert seen[1] == seen[0]
    assert seen[1][1] and seen[1][2]["access"] == (
        "mixed-index" if kind == "mixed" else "composite-index")
