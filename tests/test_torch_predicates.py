"""The port's predicates held to the JAX package's ``core/predicates.py``.

Seeded values (ints, floats, strings, None and mixed types; tokenized
text; points, circles, boxes, polygons and lines) go through every
predicate of both packages; the verdicts must be equal, exactly (they are
booleans). Shapes cross over as WKT, and the port's WKT and GeoJSON
round-trips must give the reference's shapes, and the Geoshape codec
writes the reference's cells. ``predicate_by_name`` names the same
predicates in both.
"""

import numpy as np
import pytest

import janusgraph_tpu.core.predicates as ref
import janusgraph_tpu_torch.core.predicates as port

WORDS = ["graph", "Graphs", "tensor", "data-base", "vertex", "query", "gremlin",
         "kernel", "index", "stream", "grap", "gaph", "Kernel_2", "ünïcode"]


def _values(rng, n=60):
    out = [None, 0, -3, 7, 7.0, 2.5, "7", "abc", True, b"x"]
    out += [int(v) for v in rng.integers(-50, 50, n // 3)]
    out += [float(np.round(v, 2)) for v in rng.uniform(-50, 50, n // 3)]
    out += [" ".join(rng.choice(WORDS, 2)) for _ in range(n // 3)]
    return out


def _pairs(a, b):
    return [(name, getattr(a, name), getattr(b, name)) for name in vars(a) if name.isupper()]


@pytest.mark.parametrize("family", ["Cmp", "Contain"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_cmp_and_contain_verdicts_equal_reference(family, seed):
    rng = np.random.default_rng(seed)
    values = _values(rng)
    conds = values[:12] if family == "Cmp" else [tuple(values[i:i + 4]) for i in range(0, 24, 4)]
    for name, r, p in _pairs(getattr(ref, family), getattr(port, family)):
        assert p.name == r.name
        for v in values:
            for c in conds:
                try:
                    want = r.evaluate(v, c)
                except TypeError as e:
                    with pytest.raises(type(e)):
                        p.evaluate(v, c)
                    continue
                assert p.evaluate(v, c) == want, (name, v, c)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_text_verdicts_equal_reference(seed):
    rng = np.random.default_rng(seed)
    texts = [" ".join(rng.choice(WORDS, int(rng.integers(1, 5)))) for _ in range(40)]
    texts += [None, 5, ""]
    conds = ["graph", "grap", "Graph", "gra", "ker.*", "k.*l", "data base", "query gremlin",
             "", "tensr", "ünïcode", "graph tensor"]
    for name, r, p in _pairs(ref.Text, port.Text):
        assert p.name == r.name
        for v in texts:
            for c in conds:
                assert p.evaluate(v, c) == r.evaluate(v, c), (name, v, c)
                assert p.is_valid_condition(c) == r.is_valid_condition(c)
    assert port.tokenize("Data-Base, query!") == ref.tokenize("Data-Base, query!")
    for a in WORDS:
        for b in WORDS:
            assert port.levenshtein(a, b) == ref.levenshtein(a, b)


def _shapes(mod, rng):
    lat, lon = (float(np.round(x, 3)) for x in rng.uniform([-60, -170], [60, 170]))
    return [
        mod.Geoshape.point(lat, lon),
        mod.Geoshape.point(lat + 0.5, lon - 0.5),
        mod.Geoshape.circle(lat, lon, float(rng.uniform(10, 500))),
        mod.Geoshape.box(lat - 1, lon - 1, lat + 1, lon + 1),
        mod.Geoshape.box(lat + 2, lon + 2, lat + 3, lon + 3),
        mod.Geoshape.polygon([(lat - 2, lon - 2), (lat - 2, lon + 2), (lat + 2, lon + 2),
                              (lat + 2, lon - 2)]),
        mod.Geoshape.line([(lat - 3, lon), (lat + 3, lon)]),
        mod.Geoshape.multipoint([(lat, lon), (lat + 5, lon + 5)]),
    ]


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_geo_verdicts_and_codecs_equal_reference(seed):
    r_shapes = _shapes(ref, np.random.default_rng(seed))
    p_shapes = _shapes(port, np.random.default_rng(seed))
    for rs, ps in zip(r_shapes, p_shapes):
        assert ps.to_wkt() == rs.to_wkt()
        assert ps.to_geojson() == rs.to_geojson()
        assert port.Geoshape.from_wkt(rs.to_wkt()).to_wkt() == rs.to_wkt()
        assert port.Geoshape.from_geojson(rs.to_geojson()).to_wkt() == rs.to_wkt()
        assert ps.bbox() == rs.bbox()
    for name, r, p in _pairs(ref.Geo, port.Geo):
        assert p.name == r.name
        for rv, pv in zip(r_shapes, p_shapes):
            for rc, pc in zip(r_shapes, p_shapes):
                assert p.evaluate(pv, pc) == r.evaluate(rv, rc), (name, rv, rc)
        assert not p.evaluate("POINT (1 2)", p_shapes[0])  # not a shape


def test_predicate_by_name_equals_reference():
    names = sorted(p.name for cls in (ref.Cmp, ref.Text, ref.Geo, ref.Contain)
                   for p in vars(cls).values() if isinstance(p, ref.Predicate))
    assert len(names) == 20
    for name in names + ["nope"]:
        r, p = ref.predicate_by_name(name), port.predicate_by_name(name)
        assert (p is None) == (r is None)
        if p is not None:
            assert p.name == r.name and type(p).__name__ == type(r).__name__


@pytest.mark.parametrize("seed", [0, 1])
def test_geoshape_cells_equal_reference(seed):
    """The Geoshape codec (type 9) writes the reference's frames and reads
    them back: every shape kind, nested collections included."""
    from janusgraph_tpu.core.attributes import Serializer as RefSerializer
    from janusgraph_tpu_torch.core.attributes import Serializer

    r_shapes = _shapes(ref, np.random.default_rng(seed))
    p_shapes = _shapes(port, np.random.default_rng(seed))
    r_shapes.append(ref.Geoshape.geometry_collection(r_shapes[:3]))
    p_shapes.append(port.Geoshape.geometry_collection(p_shapes[:3]))
    r_shapes.append(ref.Geoshape.multipolygon([r_shapes[5]]))
    p_shapes.append(port.Geoshape.multipolygon([p_shapes[5]]))
    for rs, ps in zip(r_shapes, p_shapes):
        frame = RefSerializer().write_object(rs)
        assert Serializer().write_object(ps) == frame
        back, used = Serializer().read_object(frame)
        assert used == len(frame) and back == ps
