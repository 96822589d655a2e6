"""The port's attribute serializer held to the JAX package's.

Every type id the reference registers, built from the same seeded numpy
draws in each package's own classes: the framed bytes (``write_object``)
are equal, each package reads the other's frame to an equal value, the
order-preserving keys (``write_ordered``) are equal and sort as the values
do, and a fixed-width value reads mid-stream. The framework enums, a user
enum on fresh registries, the dict, tuple, pickle and class frames, the
``allow_pickle=False`` refusals and the table that maps the reference's
class paths to the port's are held too. Exact equality throughout: these
are bytes.

Every registry here is a fresh ``Serializer()``; no test touches a module
table or a graph's registry.
"""

import datetime as dt
import decimal
import enum
import pickle
import struct
import uuid
from types import SimpleNamespace

import numpy as np
import pytest

from janusgraph_tpu.core import attributes as ref_attributes
from janusgraph_tpu.core import codecs as ref_codecs
from janusgraph_tpu.core import config as ref_config
from janusgraph_tpu.core import management as ref_management
from janusgraph_tpu.core import predicates as ref_predicates
from janusgraph_tpu.core import txlog as ref_txlog
from janusgraph_tpu.exceptions import SchemaViolationError as RefSchemaViolationError
from janusgraph_tpu.indexing import provider as ref_provider
from janusgraph_tpu.olap.csr import CSRGraph as RefCSRGraph
from janusgraph_tpu.storage import idauthority as ref_idauthority
from janusgraph_tpu.util import timestamps as ref_timestamps
from janusgraph_tpu_torch.core import attributes, codecs, config, management, predicates, txlog
from janusgraph_tpu_torch.indexing import provider
from janusgraph_tpu_torch.storage import idauthority
from janusgraph_tpu_torch.util import timestamps

REF = SimpleNamespace(A=ref_attributes, P=ref_predicates, codecs=ref_codecs, config=ref_config,
                      mgmt=ref_management, txlog=ref_txlog, provider=ref_provider,
                      ida=ref_idauthority, ts=ref_timestamps)
PORT = SimpleNamespace(A=attributes, P=predicates, codecs=codecs, config=config, mgmt=management,
                       txlog=txlog, provider=provider, ida=idauthority, ts=timestamps)

_ARRAY_DTYPES = {20: np.bool_, 21: np.int8, 22: np.int16, 23: np.int32, 24: np.int64,
                 25: np.float32, 26: np.float64, 27: np.uint8, 44: np.uint16, 45: np.uint32,
                 46: np.uint64, 47: np.float16}


def _draws(seed):
    """The seeded numbers every package's values are built from."""
    rng = np.random.default_rng(seed)
    return SimpleNamespace(
        i=[int(x) for x in rng.integers(-(1 << 62), 1 << 62, 4)],
        small=[int(x) for x in rng.integers(-100, 100, 4)],
        f=[float(x) for x in rng.standard_normal(4) * 1e3],
        micros=[int(x) for x in rng.integers(-(10 ** 15), 10 ** 15, 4)],
        u=[int(x) for x in rng.integers(0, 1 << 62, 4)],
        days=[int(x) for x in rng.integers(1, 700_000, 4)],
        nanos=[int(x) for x in rng.integers(0, 86_400 * 10 ** 9, 4)],
        arr=rng.standard_normal((2, 3)) * 50,
    )


def values(pkg, seed):
    """{type id: [values]} in ``pkg``'s own classes, from one seed."""
    A, P, d = pkg.A, pkg.P, _draws(seed)
    epoch = dt.datetime(1970, 1, 1, tzinfo=dt.timezone.utc)
    out = {
        1: [True, False],
        2: d.i + [0, -(1 << 63), (1 << 63) - 1],
        3: d.f + [0.0, -0.0, float("inf"), float("-inf")],
        4: ["", "hercules", "x" * 200, "ünï"],
        5: [b"", b"\x00\x01\xff"],
        6: [epoch + dt.timedelta(microseconds=m) for m in d.micros],
        7: [uuid.UUID(int=(u << 64) | u) for u in d.u],
        8: [d.f[:k] for k in (1, 4)],
        9: [P.Geoshape.point(12.5, -3.0), P.Geoshape.circle(1, 2, 3),
            P.Geoshape.box(-1, -2, 3, 4), P.Geoshape.polygon([(0, 0), (0, 1), (1, 1), (0, 0)])],
        10: [np.int8(x) for x in d.small],
        11: [np.int16(x * 300) for x in d.small],
        12: [np.int32(x * 10 ** 7) for x in d.small],
        13: [np.int64(x) for x in d.i],
        14: [np.float32(x) for x in d.f] + [np.float32(-0.0)],
        15: [A.Char(c) for c in "aZ€"],
        16: [A.Instant(m // 10 ** 6, (m % 10 ** 6) * 1000 + 7) for m in d.micros],
        17: [dt.timedelta(microseconds=m) for m in d.micros],
        18: [dt.date.fromordinal(x) for x in d.days],
        19: [dt.time(n // 3_600_000_000_000, n // 60_000_000_000 % 60, n // 10 ** 9 % 60,
                   n // 1000 % 10 ** 6) for n in d.nanos],
        28: [["a", "bc", ""], ["ünï"]],
        38: [A.BigInt(1 << 70), (1 << 80) + d.u[0], -(1 << 90) - d.u[1]],
        39: [decimal.Decimal(x).quantize(decimal.Decimal("0.001")) for x in d.f]
            + [decimal.Decimal("0"), decimal.Decimal("-1.500")],
        40: [{"a": 1, 2: [1.0, 2.0]}, {}],
        41: [(1, "a", 2.5), ()],
        42: [complex(d.f[0], d.f[1]), {1, 2}],
        43: [int, np.float32, dt.datetime, decimal.Decimal, uuid.UUID, A.Instant, A.Char,
             A.BigInt, P.Geoshape, pkg.codecs.Direction],
    }
    for tid, dtype in _ARRAY_DTYPES.items():
        a = d.arr if dtype is not np.bool_ else d.arr > 0
        if np.dtype(dtype).kind == "u":
            a = np.abs(a)
        out[tid] = [np.asarray(a).astype(dtype), np.asarray(a).astype(dtype).ravel()[:0]]
    return out


def enums(pkg):
    return {30: pkg.codecs.Direction, 31: pkg.codecs.RelationCategory,
            32: pkg.codecs.Cardinality, 33: pkg.codecs.Multiplicity,
            34: pkg.mgmt.SchemaAction, 35: pkg.config.Mutability, 36: pkg.txlog.LogTxStatus,
            37: pkg.provider.Mapping, 48: pkg.mgmt.SchemaStatus, 49: pkg.codecs.Consistency,
            50: pkg.ts.TimestampProviders, 51: pkg.ida.ConflictAvoidanceMode}


def same(a, b):
    """Equal values across the two packages (arrays by dtype and content,
    classes and enum members by name)."""
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return (isinstance(a, np.ndarray) and isinstance(b, np.ndarray) and a.dtype == b.dtype
                and a.shape == b.shape and np.array_equal(a, b))
    if isinstance(a, type) and isinstance(b, type):
        return a.__qualname__ == b.__qualname__
    if isinstance(a, enum.Enum) and isinstance(b, enum.Enum):
        return (type(a).__name__, a.name) == (type(b).__name__, b.name)
    if type(a).__name__ != type(b).__name__:
        return False
    if isinstance(a, float) and a != a:
        return b != b
    if type(a).__name__ == "Instant":
        return (a.seconds, a.nanos) == (b.seconds, b.nanos)
    if type(a).__name__ == "Geoshape":
        return a._geom_dict() == b._geom_dict()
    if isinstance(a, (np.floating, float)):
        return struct.pack(">d", float(a)) == struct.pack(">d", float(b))
    return a == b


TYPE_IDS = sorted(values(PORT, 0))
CASES = [(tid, i) for tid in TYPE_IDS for i in range(len(values(PORT, 0)[tid]))]


def test_registry_has_the_reference_ids():
    ref, got = ref_attributes.Serializer(), attributes.Serializer()
    assert sorted(got._by_id) == sorted(ref._by_id)
    assert len(got._by_id) == len(ref._by_id) == 50
    for tid in got._by_id:
        a, b = got._by_id[tid], ref._by_id[tid]
        assert (a.fixed_width, type(a).__name__) == (b.fixed_width, type(b).__name__), tid
    assert set(TYPE_IDS) | set(enums(PORT)) == set(got._by_id)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("tid,i", CASES, ids=[f"{t}-{i}" for t, i in CASES])
def test_frames_equal_reference(tid, i, seed):
    ref, got = ref_attributes.Serializer(), attributes.Serializer()
    rv, pv = values(REF, seed)[tid][i], values(PORT, seed)[tid][i]
    frame = ref.write_object(rv)
    assert struct.unpack(">H", frame[:2])[0] == tid
    assert got.write_object(pv) == frame
    back, used = got.read_object(frame)
    want, want_used = ref.read_object(frame)
    assert used == want_used == len(frame)
    assert same(back, want)
    again, _ = ref.read_object(got.write_object(back))
    assert same(again, want)


@pytest.mark.parametrize("tid", TYPE_IDS)
def test_ordered_keys_equal_reference_and_sort_as_values(tid):
    ref, got = ref_attributes.Serializer(), attributes.Serializer()
    rvs = values(REF, 3)[tid] + values(REF, 4)[tid]
    pvs = values(PORT, 3)[tid] + values(PORT, 4)[tid]
    keys = []
    for rv, pv in zip(rvs, pvs):
        try:
            want = ref.write_ordered(rv)
        except Exception as e:  # noqa: BLE001 — the port must refuse alike
            with pytest.raises(type(e) if not isinstance(e, ref_attributes.SerializerError)
                               else attributes.SerializerError):
                got.write_ordered(pv)
            continue
        key = got.write_ordered(pv)
        assert key == want
        keys.append((key, pv))
    sortable = {2, 3, 6, 10, 11, 12, 13, 14, 16, 18, 19, 38, 39}
    if tid in sortable:
        # sorted by key, the values never decrease
        by_key = [(v.seconds, v.nanos) if tid == 16 else v
                  for _k, v in sorted(keys, key=lambda kv: kv[0])]
        assert len(by_key) >= 4
        assert all(a <= b for a, b in zip(by_key, by_key[1:]))
        ser = got.serializer_for(pvs[0])
        for key, pv in keys:
            assert same(ser.read_ordered(key), ref.serializer_for(rvs[0]).read_ordered(key)) \
                or tid == 39


FIXED = [tid for tid in TYPE_IDS if attributes.Serializer()._by_id[tid].fixed_width]


@pytest.mark.parametrize("tid", FIXED)
def test_fixed_width_values_read_mid_stream(tid):
    """A fixed-width frame is read from the front of a longer buffer (an
    edge's inline properties, a property cell's meta block)."""
    ref, got = ref_attributes.Serializer(), attributes.Serializer()
    pvs, rvs = values(PORT, 5)[tid], values(REF, 5)[tid]
    stream = b"".join(ref.write_object(v) for v in rvs) + ref.write_object("tail")
    off, back = 0, []
    while off < len(stream):
        v, used = got.read_object(stream[off:])
        back.append(v)
        off += used
    assert off == len(stream)
    assert all(same(a, b) for a, b in zip(back, pvs)) and back[-1] == "tail"
    assert len(back) == len(pvs) + 1


@pytest.mark.parametrize("tid", sorted(enums(PORT)))
def test_framework_enums_equal_reference(tid):
    ref, got = ref_attributes.Serializer(), attributes.Serializer()
    port_cls, ref_cls = enums(PORT)[tid], enums(REF)[tid]
    assert [m.name for m in port_cls] == [m.name for m in ref_cls]
    for pm, rm in zip(port_cls, ref_cls):
        frame = ref.write_object(rm)
        assert got.write_object(pm) == frame and frame[:2] == struct.pack(">H", tid)
        assert got.read_object(frame) == (pm, len(frame))
        assert got.write_ordered(pm) == ref.write_ordered(rm)


def test_user_enum_on_fresh_registries():
    class Color(enum.Enum):
        RED = "r"
        GREEN = "g"

    ref, got = ref_attributes.Serializer(), attributes.Serializer()
    tid = attributes.USER_TYPE_ID_START + 7
    assert attributes.USER_TYPE_ID_START == ref_attributes.USER_TYPE_ID_START
    ref.register_enum(Color, tid)
    got.register_enum(Color, tid)
    for m in Color:
        assert got.write_object(m) == ref.write_object(m)
        assert got.read_object(ref.write_object(m))[0] is m
    with pytest.raises(attributes.SerializerError):
        got.register_enum(Color, tid)
    with pytest.raises(attributes.SerializerError):
        got.register_enum(Color, 0xFFFF)
    assert tid not in attributes.Serializer()._by_id


def test_dispatch_rules_equal_reference():
    """ndarray by dtype, str-lists, >64-bit ints, bool before int."""
    ref, got = ref_attributes.Serializer(), attributes.Serializer()
    for v in (True, 1, 1 << 64, -(1 << 63) - 1, ["a"], [1.0], [], np.zeros(2, np.uint16),
              np.float32(1), np.int64(2), 2.0, "c"):
        assert got.serializer_for(v).type_id == ref.serializer_for(v).type_id, v
    assert got.serializer_for(attributes.Char("c")).type_id == ref.serializer_for(
        ref_attributes.Char("c")).type_id == 15
    with pytest.raises(attributes.SerializerError):
        got.serializer_for(np.zeros(2, dtype=np.complex64))
    for py_type, name in ((bool, "Boolean"), (list, "FloatList"), (np.ndarray, "Array")):
        assert got.data_type_id(py_type) == ref.data_type_id(py_type), name
    assert got.type_for_id(14) is np.float32 and got.type_for_id(16) is attributes.Instant


def test_pickle_is_refused_without_allow_pickle():
    ref, got = ref_attributes.Serializer(), attributes.Serializer(allow_pickle=False)
    frame = ref.write_object(complex(1, 2))
    with pytest.raises(attributes.SerializerError, match="allow_pickle=False"):
        got.read_object(frame)
    with pytest.raises(attributes.SerializerError, match="disabled"):
        got.write_object(complex(1, 2))
    assert attributes.Serializer().read_object(frame)[0] == complex(1, 2)
    for v in ({"a": 1}, (1, 2)):
        with pytest.raises(attributes.SerializerError):
            got.write_ordered(v)


def test_class_cells_map_reference_paths():
    """A class cell naming a reference class with a counterpart reads as the
    port's class and is written under the reference's path; any other path
    of the reference package, a port class without a counterpart and a
    function-local class are refused."""
    ref, got = ref_attributes.Serializer(), attributes.Serializer()
    for port_cls, ref_cls in ((attributes.Instant, ref_attributes.Instant),
                              (codecs.Cardinality, ref_codecs.Cardinality),
                              (idauthority.ConflictAvoidanceMode,
                               ref_idauthority.ConflictAvoidanceMode),
                              (predicates.Geoshape, ref_predicates.Geoshape)):
        frame = ref.write_object(ref_cls)
        assert frame[2:].startswith(b"janusgraph_tpu.")
        assert got.write_object(port_cls) == frame
        assert got.read_object(frame)[0] is port_cls
    for path in (b"janusgraph_tpu.olap.csr:CSRGraph", b"janusgraph_tpu:open_graph",
                 b"janusgraph_tpu_torch.core.attributes:Instant", b"os:PathLike"):
        with pytest.raises(attributes.SerializerError):
            got.read_object(struct.pack(">H", 43) + path)
    assert ref.read_object(struct.pack(">H", 43) + b"janusgraph_tpu.olap.csr:CSRGraph")[0] \
        is RefCSRGraph

    class Local:
        pass

    from janusgraph_tpu_torch.olap.csr import CSRGraph

    for cls in (Local, CSRGraph):
        with pytest.raises(attributes.SerializerError):
            got.write_object(cls)


def test_pickles_map_reference_paths():
    ref, got = ref_attributes.Serializer(), attributes.Serializer()
    pairs = [({attributes.Instant(1, 2)}, {ref_attributes.Instant(1, 2)}),
             (frozenset([codecs.Direction.OUT]), frozenset([ref_codecs.Direction.OUT])),
             ([predicates.Geoshape.point(1, 2), codecs.Cardinality.SET],
              [ref_predicates.Geoshape.point(1, 2), ref_codecs.Cardinality.SET])]
    for pv, rv in pairs:
        payload = ref._by_id[42].write(rv)
        assert payload == pickle.dumps(rv, protocol=4)
        assert got._by_id[42].write(pv) == payload
        assert b"janusgraph_tpu_torch" not in payload
        assert got._by_id[42].read(payload) == pv
    refused = pickle.dumps(RefSchemaViolationError, protocol=4)
    with pytest.raises(attributes.SerializerError, match="no counterpart"):
        got._by_id[42].read(refused)


def test_naive_datetime_reads_back_utc_aware():
    ref, got = ref_attributes.Serializer(), attributes.Serializer()
    naive = dt.datetime(2021, 3, 4, 5, 6, 7, 8)
    assert got.write_object(naive) == ref.write_object(naive)
    back = got.read_object(got.write_object(naive))[0]
    assert back == naive.replace(tzinfo=dt.timezone.utc) and back.tzinfo is not None
