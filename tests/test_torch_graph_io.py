"""The port's graph I/O held to the JAX package's (after
``tests/test_graph_io.py``).

The same transactions, built from seeded numpy draws in each package's own
classes, give byte-equal ``edgestore`` rows and export byte-equal GraphSON
and GraphML files; each package imports the other's file to the same rows.
The Graph of the Gods round-trips, LIST/SET keys and meta-properties
survive, a batched import that fails part-way reports the same
``committed`` counts in both packages, and the reference's GraphSON fault
is reproduced: the eight datatypes that come back as another type raise
``SchemaViolationError`` in both, unless the target declares the key
first. ``graph.io``/``g.io()`` spellings and the unknown-format error are
held too. Every file is written under ``tmp_path`` and every graph closed.
"""

import datetime as dt
import decimal
import io
import uuid
from types import SimpleNamespace

import numpy as np
import pytest

from janusgraph_tpu.core import attributes as ref_attributes
from janusgraph_tpu.core import codecs as ref_codecs
from janusgraph_tpu.core import gods as ref_gods
from janusgraph_tpu.core import io as ref_io
from janusgraph_tpu.core import predicates as ref_predicates
from janusgraph_tpu.core.graph import open_graph as ref_open_graph
from janusgraph_tpu.exceptions import ConfigurationError as RefConfigurationError
from janusgraph_tpu.exceptions import SchemaViolationError as RefSchemaViolationError
import janusgraph_tpu_torch
from janusgraph_tpu_torch.core import attributes, codecs, gods, predicates
from janusgraph_tpu_torch.core import io as port_io
from janusgraph_tpu_torch.core.graph import open_graph
from janusgraph_tpu_torch.exceptions import ConfigurationError, SchemaViolationError

REF = SimpleNamespace(open=ref_open_graph, config={"computer.sharded-auto": False}, A=ref_attributes,
                      P=ref_predicates, codecs=ref_codecs, gods=ref_gods, io=ref_io,
                      schema_error=RefSchemaViolationError, config_error=RefConfigurationError)
PORT = SimpleNamespace(open=open_graph, config={"computer.executor": "cpu"}, A=attributes,
                       P=predicates, codecs=codecs, gods=gods, io=port_io,
                       schema_error=SchemaViolationError, config_error=ConfigurationError)
BOTH = (("ref", REF), ("port", PORT))


def rows(graph, names=("edgestore",)):
    mgr = graph.backend.manager
    return {
        name: {k: list(zip(r.columns, r.values)) for k, r in mgr.open_database(name)._rows.items()}
        for name in names
    }


def typed_values(pkg, rng_seed, i):
    """One vertex's properties of every datatype that GraphSON round-trips
    in the reference, from seeded draws."""
    rng = np.random.default_rng([rng_seed, i])
    f = rng.standard_normal(4)
    micros = int(rng.integers(-(10 ** 14), 10 ** 14))
    epoch = dt.datetime(1970, 1, 1, tzinfo=dt.timezone.utc)
    return {
        "name": f"v{i}",
        "n": int(rng.integers(-(1 << 40), 1 << 40)),
        "x": float(f[0]),
        "flag": bool(f[1] > 0),
        "when": epoch + dt.timedelta(microseconds=micros),
        "inst": pkg.A.Instant(micros // 10 ** 6, int(rng.integers(0, 10 ** 9))),
        "dur": dt.timedelta(microseconds=micros),
        "day": dt.date.fromordinal(int(rng.integers(1, 700_000))),
        "tod": dt.time(int(rng.integers(0, 24)), int(rng.integers(0, 60)), 7, 123),
        "ch": pkg.A.Char(chr(int(rng.integers(65, 91)))),
        "big": pkg.A.BigInt((1 << 70) + int(rng.integers(0, 1 << 30))),
        "fl": [float(v) for v in f[:3]],
        "arr": f.astype(np.float32),
        "loc": pkg.P.Geoshape.point(float(f[2]) * 10, float(f[3]) * 10),
    }


def write_typed(pkg, g, seed=0, n=6):
    m = g.management()
    m.make_property_key("tags", str, pkg.codecs.Cardinality.LIST)
    m.make_property_key("nick", str, pkg.codecs.Cardinality.SET)
    m.make_edge_label("knows")
    m.make_vertex_label("person")
    tx = g.new_transaction()
    vs = []
    for i in range(n):
        v = tx.add_vertex("person", **typed_values(pkg, seed, i))
        tx.add_property(v, "tags", "t0", since=i)
        tx.add_property(v, "tags", "t1")
        tx.add_property(v, "nick", f"n{i % 2}")
        vs.append(v)
    rng = np.random.default_rng(seed)
    for a, b in zip(rng.integers(0, n, 2 * n), rng.integers(0, n, 2 * n)):
        tx.add_edge(vs[int(a)], "knows", vs[int(b)], w=float(rng.random()), k=int(a))
    tx.add_edge(vs[0], "knows", vs[n - 1])
    tx.commit()


def write_primitive(pkg, g, seed=0, n=8):
    tx = g.new_transaction()
    rng = np.random.default_rng(seed)
    vs = [tx.add_vertex("person" if i % 2 else None, name=f"v{i}", age=int(rng.integers(0, 99)),
                        score=float(rng.random()), ok=bool(i % 3), note="a<b&\"c\"")
          for i in range(n)]
    for a, b in zip(rng.integers(0, n, 2 * n), rng.integers(0, n, 2 * n)):
        tx.add_edge(vs[int(a)], "link", vs[int(b)], w=float(rng.random()), tag="x")
    tx.commit()


def twin(write, tmp_path, export="export_graphson", suffix="json"):
    """Write the same graph in each package and export it; returns each
    package's (rows, file text)."""
    out = {}
    for name, pkg in BOTH:
        g = pkg.open(dict(pkg.config))
        try:
            write(pkg, g)
            path = str(tmp_path / f"{name}.{suffix}")
            counts = getattr(pkg.io, export)(g, path)
            with open(path, encoding="utf-8") as f:
                out[name] = (rows(g), f.read(), counts)
        finally:
            g.close()
    return out


@pytest.mark.parametrize("seed", [0, 1])
def test_typed_graph_exports_byte_equal_graphson(tmp_path, seed):
    out = twin(lambda pkg, g: write_typed(pkg, g, seed), tmp_path)
    assert out["port"][0] == out["ref"][0]
    assert out["port"][1] == out["ref"][1]
    assert out["port"][2] == out["ref"][2] == {"vertices": 6, "edges": 13}


def test_primitive_graph_exports_byte_equal_graphml(tmp_path):
    out = twin(write_primitive, tmp_path, "export_graphml", "xml")
    assert out["port"][1] == out["ref"][1] and out["port"][0] == out["ref"][0]
    assert out["port"][2] == {"vertices": 8, "edges": 16}


@pytest.mark.parametrize("fmt,write", [("graphson", write_typed), ("graphml", write_primitive)])
def test_each_package_imports_the_others_file(tmp_path, fmt, write):
    suffix = "json" if fmt == "graphson" else "xml"
    out = twin(write, tmp_path, f"export_{fmt}", suffix)
    imported = {}
    for name, pkg in BOTH:
        other = "port" if name == "ref" else "ref"
        g = pkg.open(dict(pkg.config))
        try:
            counts = getattr(pkg.io, f"import_{fmt}")(g, str(tmp_path / f"{other}.{suffix}"),
                                                       batch_size=4)
            path = str(tmp_path / f"{name}_again.{suffix}")
            getattr(pkg.io, f"export_{fmt}")(g, path)
            with open(path, encoding="utf-8") as f:
                imported[name] = (rows(g), f.read(), counts)
        finally:
            g.close()
    assert imported["port"] == imported["ref"]
    assert imported["port"][2] == out["ref"][2]


def test_the_gods_round_trip(tmp_path):
    got = {}
    for name, pkg in BOTH:
        g, h = pkg.open(dict(pkg.config)), pkg.open(dict(pkg.config))
        try:
            pkg.gods.load(g)
            buf = io.StringIO()
            assert pkg.io.export_graphson(g, buf) == {"vertices": 12, "edges": 17}
            buf.seek(0)
            assert pkg.io.import_graphson(h, buf) == {"vertices": 12, "edges": 17}
            again = io.StringIO()
            pkg.io.export_graphson(h, again)
            t = h.traversal()
            got[name] = (buf.getvalue(), again.getvalue(), rows(h),
                         sorted(t.V().has("name", "hercules").out("father").values("name")
                                .to_list()),
                         sorted(h.traversal().V().values("age").to_list()))
        finally:
            g.close()
            h.close()
    assert got["port"] == got["ref"]
    assert got["port"][3] == ["jupiter"]


def test_list_set_and_meta_properties_survive(tmp_path):
    seen = {}
    for name, pkg in BOTH:
        g, h = pkg.open(dict(pkg.config)), pkg.open(dict(pkg.config))
        try:
            write_typed(pkg, g, seed=2, n=3)
            buf = io.StringIO()
            pkg.io.export_graphson(g, buf)
            buf.seek(0)
            pkg.io.import_graphson(h, buf)
            tx = h.new_transaction()
            v = next(v for v in tx.vertices() if v.value("name") == "v1")
            tags = sorted((p.value, sorted(p.property_values().items()))
                          for p in v.properties("tags"))
            nick = [p.value for p in v.properties("nick")]
            tx.rollback()
            card = int(h.schema_cache.get_by_name("tags").cardinality)
            seen[name] = (tags, nick, card)
        finally:
            g.close()
            h.close()
    assert seen["port"] == seen["ref"] == (
        [("t0", [("since", 1)]), ("t1", [])], ["n1"], 1)


@pytest.mark.parametrize("batch", [1, 3, 1000])
def test_partial_import_reports_committed(tmp_path, batch):
    """An edge to an unknown vertex fails the import after earlier batches
    committed; both packages raise with the same ``committed`` and keep the
    same rows."""
    lines = [
        '{"kind": "vertex", "original_id": 1, "label": "vertex", "properties": '
        '[{"key": "name", "value": "a"}]}',
        '{"kind": "vertex", "original_id": 2, "label": "vertex", "properties": []}',
        '{"kind": "edge", "label": "e", "out": 1, "in": 2, "properties": {}}',
        '{"kind": "vertex", "original_id": 3, "label": "vertex", "properties": []}',
        '{"kind": "edge", "label": "e", "out": 3, "in": 99, "properties": {}}',
    ]
    text = "\n".join(lines) + "\n"
    got = {}
    for name, pkg in BOTH:
        g = pkg.open(dict(pkg.config))
        try:
            with pytest.raises(ValueError, match="unknown vertex") as exc:
                pkg.io.import_graphson(g, io.StringIO(text), batch_size=batch)
            got[name] = (exc.value.committed, rows(g))
        finally:
            g.close()
    assert got["port"] == got["ref"]
    assert got["port"][0] == {1: {"vertices": 3, "edges": 1}, 3: {"vertices": 2, "edges": 1},
                              1000: {"vertices": 0, "edges": 0}}[batch]


#: the reference's GraphSON fault: numpy scalars come back as Python
#: numbers and UUID/Decimal/bytes as strings, so a key of these types does
#: not import its own export
FAILING = {
    "Float": lambda A: np.float32(0.1), "Int": lambda A: np.int32(7),
    "Short": lambda A: np.int16(-3), "Byte": lambda A: np.int8(5),
    "Long64": lambda A: np.int64(1 << 40), "UUID": lambda A: uuid.UUID(int=12345),
    "Decimal": lambda A: decimal.Decimal("1.50"), "Bytes": lambda A: b"\x00\x01",
}


@pytest.mark.parametrize("type_name", sorted(FAILING))
def test_the_eight_types_raise_in_both_packages(tmp_path, type_name):
    got = {}
    for name, pkg in BOTH:
        g, h = pkg.open(dict(pkg.config)), pkg.open(dict(pkg.config))
        try:
            tx = g.new_transaction()
            tx.add_vertex(name="plain")
            tx.add_vertex(p=FAILING[type_name](pkg.A))
            tx.commit()
            assert g.schema_cache.get_by_name("p").data_type.__name__ in (
                "float32", "int32", "int16", "int8", "int64", "UUID", "Decimal", "bytes")
            buf = io.StringIO()
            pkg.io.export_graphson(g, buf)
            buf.seek(0)
            with pytest.raises(pkg.schema_error, match="property p expects") as exc:
                pkg.io.import_graphson(h, buf, batch_size=1)
            got[name] = (buf.getvalue(), exc.value.committed, str(exc.value), rows(h))
        finally:
            g.close()
            h.close()
    assert got["port"] == got["ref"]
    assert got["port"][1] == {"vertices": 1, "edges": 0}


def test_a_predeclared_double_key_imports_a_float_export(tmp_path):
    """Existing definitions win: a Float export imports into a graph that
    declares the key Double, widened exactly, in both packages."""
    got = {}
    for name, pkg in BOTH:
        g, h = pkg.open(dict(pkg.config)), pkg.open(dict(pkg.config))
        try:
            tx = g.new_transaction()
            tx.add_vertex(score=np.float32(0.1), bucket=np.int32(3))
            tx.commit()
            h.management().make_property_key("score", float)
            h.management().make_property_key("bucket", int)
            path = str(tmp_path / f"{name}.json")
            janusgraph_pkg = janusgraph_tpu_torch if pkg is PORT else __import__("janusgraph_tpu")
            janusgraph_pkg.export_graphson(g, path)
            assert janusgraph_pkg.import_graphson(h, path) == {"vertices": 1, "edges": 0}
            tx = h.new_transaction()
            v = next(iter(tx.vertices()))
            got[name] = (v.value("score"), v.value("bucket"), rows(h))
            tx.rollback()
        finally:
            g.close()
            h.close()
    assert got["port"] == got["ref"]
    assert got["port"][0] == 0.10000000149011612 == float(np.float32(0.1))
    assert type(got["port"][0]) is float and got["port"][1] == 3


def test_graphml_refuses_typed_values_and_dates_come_back_aware(tmp_path):
    for _name, pkg in BOTH:
        g, h = pkg.open(dict(pkg.config)), pkg.open(dict(pkg.config))
        try:
            tx = g.new_transaction()
            tx.add_vertex(score=np.float32(0.5), when=dt.datetime(2020, 1, 2, 3, 4, 5))
            tx.commit()
            with pytest.raises(ValueError, match="primitive values only"):
                pkg.io.export_graphml(g, str(tmp_path / "x.xml"))
            assert not (tmp_path / "x.xml").exists()
            h.management().make_property_key("score", float)
            buf = io.StringIO()
            pkg.io.export_graphson(g, buf)
            buf.seek(0)
            pkg.io.import_graphson(h, buf)
            tx = h.new_transaction()
            when = next(iter(tx.vertices())).value("when")
            tx.rollback()
            assert when == dt.datetime(2020, 1, 2, 3, 4, 5, tzinfo=dt.timezone.utc)
        finally:
            g.close()
            h.close()


@pytest.mark.parametrize("spelling", ["graph_io", "g_io", "g_io_with"])
def test_io_spellings_and_the_unknown_format(tmp_path, spelling):
    got = {}
    for name, pkg in BOTH:
        g, h = pkg.open(dict(pkg.config)), pkg.open(dict(pkg.config))
        try:
            write_primitive(pkg, g, seed=3, n=5)
            if spelling == "graph_io":
                path = str(tmp_path / f"{name}.graphml")
                w = g.io("graphml").write(path)
                r = h.io("graphml").read(path, batch_size=2)
            elif spelling == "g_io":
                path = str(tmp_path / f"{name}.xml")
                w = g.traversal().io(path).write()
                r = h.traversal().io(path).read()
            else:
                path = str(tmp_path / f"{name}.data")
                w = g.traversal().io(path).with_("graphml").write()
                r = h.traversal().io(path).with_("graphml").read()
            assert w == r == {"vertices": 5, "edges": 10}
            with open(path, encoding="utf-8") as f:
                text = f.read()
            with pytest.raises(pkg.config_error, match="unknown io format"):
                g.io("gryo")
            got[name] = (text, rows(h))
        finally:
            g.close()
            h.close()
    assert got["port"] == got["ref"] and got["port"][0].startswith("<?xml")


@pytest.mark.parametrize("mode,allowed", [("auto", True), ("true", True), ("false", False)])
def test_allow_pickle_option_sets_the_graphs_pickle_mode(mode, allowed):
    """attributes.allow-pickle: "auto" allows pickle frames over a store
    that is not network-attached (the in-memory one), as in the reference;
    another value than the three is refused."""
    for _name, pkg in BOTH:
        g = pkg.open(dict(pkg.config, **{"attributes.allow-pickle": mode}))
        try:
            assert g.serializer.allow_pickle is allowed
        finally:
            g.close()
        with pytest.raises(pkg.config_error):
            pkg.open(dict(pkg.config, **{"attributes.allow-pickle": "maybe"}))
