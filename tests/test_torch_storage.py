"""The port's storage read path and codecs held to the JAX package's.

The same inputs, made from a seed with numpy, go through both packages:
``IDManager`` ids and row keys, the in-memory store under one mutation
stream (slices, ordered key ranges, unordered scans), ``EdgeSerializer``
cells byte for byte and their decodes (``parse_relation``,
``bulk_decode_edges``), schema definitions, the ID authority's blocks and
pools, and the configuration's checks.
"""

import struct

import numpy as np
import pytest

from janusgraph_tpu.core import codecs as rc
from janusgraph_tpu.core import schema as rs
from janusgraph_tpu.core.attributes import Serializer as RefSerializer
from janusgraph_tpu.core.ids import IDManager as RefIDManager, VertexIDType as RefVT
from janusgraph_tpu.storage import idauthority as rida
from janusgraph_tpu.storage.inmemory import InMemoryStoreManager as RefStoreManager
from janusgraph_tpu.storage.kcvs import (
    KeyRangeQuery as RefKRQ,
    KeySliceQuery as RefKSQ,
    SliceQuery as RefSQ,
)
from janusgraph_tpu_torch.core import codecs as tc
from janusgraph_tpu_torch.core import schema as ts
from janusgraph_tpu_torch.core.attributes import Serializer
from janusgraph_tpu_torch.core.config import GraphConfiguration
from janusgraph_tpu_torch.core.ids import IDManager, VertexIDType
from janusgraph_tpu_torch.exceptions import ConfigurationError, InvalidIDError
from janusgraph_tpu_torch.storage import idauthority as tida
from janusgraph_tpu_torch.storage.inmemory import InMemoryStoreManager
from janusgraph_tpu_torch.storage.kcvs import (
    KeyRangeQuery,
    KeySliceQuery,
    SliceQuery,
    entries_in_slice,
)

# ------------------------------------------------------------------- ids

ID_TYPES = ["NORMAL", "PARTITIONED", "UNMODIFIABLE", "USER_PROPERTY_KEY",
            "USER_EDGE_LABEL", "VERTEX_LABEL", "SYSTEM_PROPERTY_KEY"]


@pytest.mark.parametrize("bits", [0, 3, 5, 16])
@pytest.mark.parametrize("kind", ID_TYPES)
def test_id_manager_equals_reference(bits, kind):
    rng = np.random.default_rng(bits * 31 + len(kind))
    ref, got = RefIDManager(partition_bits=bits), IDManager(partition_bits=bits)
    rt, tt = RefVT[kind], VertexIDType[kind]
    parts = 1 << bits
    counts = rng.integers(1, min(ref.max_count(rt), 1 << 40), 200)
    partitions = rng.integers(0, parts, 200) if not rt.is_schema else np.zeros(200, int)
    for c, p in zip(counts.tolist(), partitions.tolist()):
        vid = got.make_vertex_id(c, p, tt)
        assert vid == ref.make_vertex_id(c, p, rt)
        assert got.get_key(vid) == ref.get_key(vid)
        assert got.get_vertex_id(got.get_key(vid)) == vid
        assert got.get_partition_id(vid) == ref.get_partition_id(vid)
        assert got.get_count(vid) == ref.get_count(vid)
        assert got.id_type(vid).name == ref.id_type(vid).name
        assert got.get_canonical_vertex_id(vid) == ref.get_canonical_vertex_id(vid)
        assert got.is_user_vertex_id(vid) == ref.is_user_vertex_id(vid)
    for p in range(min(parts, 8)):
        assert got.partition_key_range(p) == ref.partition_key_range(p)
    assert got.partition_key_range(parts - 1) == ref.partition_key_range(parts - 1)
    if not rt.is_schema:
        vids = [got.make_vertex_id(c, p, tt) for c, p in zip(counts.tolist(), partitions.tolist())]
        assert got.get_keys_array(vids) == ref.get_keys_array(vids)


def test_id_manager_rejects_what_the_reference_rejects():
    got = IDManager(partition_bits=5)
    with pytest.raises(InvalidIDError):
        got.make_vertex_id(0, 0)
    with pytest.raises(InvalidIDError):
        got.make_vertex_id(1, 32)
    schema_id = got.make_schema_id(VertexIDType.USER_EDGE_LABEL, 1)
    with pytest.raises(InvalidIDError):
        got.get_keys_array([schema_id])


# ----------------------------------------------------------------- store

def _mutation_stream(seed, rows=60, steps=400):
    rng = np.random.default_rng(seed)
    keys = [bytes(rng.integers(0, 4, 3, dtype=np.uint8)) for _ in range(rows)]
    for _ in range(steps):
        key = keys[int(rng.integers(rows))]
        adds = [(bytes(rng.integers(0, 6, int(rng.integers(1, 4)), dtype=np.uint8)),
                 bytes(rng.integers(0, 256, int(rng.integers(0, 5)), dtype=np.uint8)))
                for _ in range(int(rng.integers(0, 5)))]
        dels = [bytes(rng.integers(0, 6, int(rng.integers(1, 4)), dtype=np.uint8))
                for _ in range(int(rng.integers(0, 3)))]
        yield key, adds, dels


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_inmemory_store_equals_reference(seed):
    ref_mgr, mgr = RefStoreManager(), InMemoryStoreManager()
    rs_, ts_ = ref_mgr.open_database("edgestore"), mgr.open_database("edgestore")
    rtx, ttx = ref_mgr.begin_transaction(), mgr.begin_transaction()
    rng = np.random.default_rng(100 + seed)
    for i, (key, adds, dels) in enumerate(_mutation_stream(seed)):
        rs_.mutate(key, adds, dels, rtx)
        ts_.mutate(key, adds, dels, ttx)
        if i % 25:
            continue
        lo = bytes(rng.integers(0, 6, 2, dtype=np.uint8))
        hi = bytes(rng.integers(0, 6, 2, dtype=np.uint8))
        lim = [None, 1, 3][int(rng.integers(3))]
        for sq, rsq in ((SliceQuery(lo, hi, lim), RefSQ(lo, hi, lim)),
                        (SliceQuery(lo, None), RefSQ(lo, None)),
                        (SliceQuery(), RefSQ())):
            assert ts_.get_slice(KeySliceQuery(key, sq), ttx) == rs_.get_slice(RefKSQ(key, rsq), rtx)
            assert list(ts_.get_keys(sq, ttx)) == list(rs_.get_keys(rsq, rtx))
            kl, kh = sorted([bytes(rng.integers(0, 4, 2, dtype=np.uint8)),
                             bytes(rng.integers(0, 4, 3, dtype=np.uint8))])
            assert list(ts_.get_keys(KeyRangeQuery(kl, kh, sq), ttx)) == list(
                rs_.get_keys(RefKRQ(kl, kh, rsq), rtx))
            row = ts_.get_slice(KeySliceQuery(key, SliceQuery()), ttx)
            assert entries_in_slice(row, sq) == ts_.get_slice(KeySliceQuery(key, sq), ttx)
    assert ts_.row_count() == rs_.row_count()


def test_from_rows_round_trips_a_reference_dump():
    ref_mgr = RefStoreManager()
    tx = ref_mgr.begin_transaction()
    for name in ("edgestore", "graphindex"):
        st = ref_mgr.open_database(name)
        for key, adds, dels in _mutation_stream(7, rows=20, steps=100):
            st.mutate(key, adds, dels, tx)
    rows = {
        name: {k: list(zip(r.columns, r.values)) for k, r in st._rows.items()}
        for name, st in ref_mgr._stores.items()
    }
    mgr = InMemoryStoreManager.from_rows(rows)
    assert mgr.dump_rows() == {n: dict(sorted(r.items())) for n, r in rows.items()}
    assert list(mgr.open_database("edgestore").get_keys(SliceQuery(), None)) == list(
        ref_mgr.open_database("edgestore").get_keys(RefSQ(), tx))


# ---------------------------------------------------------------- codecs

def _codecs(bits=5):
    return (
        rc.EdgeSerializer(RefSerializer(), RefIDManager(partition_bits=bits)),
        tc.EdgeSerializer(Serializer(), IDManager(partition_bits=bits)),
    )


VALUES = [True, False, 0, -7, 1 << 62, 2.5, -0.0, float("inf"), "", "hercules",
          "x" * 200, b"\x00\x01"]


@pytest.mark.parametrize("value", VALUES, ids=lambda v: repr(v)[:16])
def test_serializer_frames_equal_reference(value):
    ref, got = RefSerializer(), Serializer()
    assert got.write_object(value) == ref.write_object(value)
    assert got.read_object(ref.write_object(value)) == ref.read_object(ref.write_object(value))
    if isinstance(value, (int, float, str)) and not isinstance(value, bool):
        assert got.write_ordered(value) == ref.write_ordered(value)


def test_unported_datatype_decodes_as_a_raw_value():
    """Once a stub (a datatype the port did not decode); every datatype is
    ported now, so a UUID cell the reference wrote decodes to the
    reference's value, as a fixed-width frame read mid-stream."""
    import uuid

    framed = RefSerializer().write_object(uuid.UUID(int=0x1234_5678_9ABC))
    value, used = Serializer().read_object(framed + b"tail")
    want, want_used = RefSerializer().read_object(framed + b"tail")
    assert value == want == uuid.UUID(int=0x1234_5678_9ABC) and used == want_used == len(framed)
    assert struct.unpack(">H", framed[:2])[0] == 7
    assert Serializer().write_object(value) == framed


@pytest.mark.parametrize("seed", [0, 1])
def test_edge_cells_equal_reference(seed):
    ref, got = _codecs()
    rng = np.random.default_rng(seed)
    idm = IDManager(5)
    st_ref = rs.SystemTypes(RefIDManager(5))
    label = idm.make_schema_id(VertexIDType.USER_EDGE_LABEL, 3)
    key_id = idm.make_schema_id(VertexIDType.USER_PROPERTY_KEY, 9)
    cols = []
    for _ in range(50):
        other = idm.make_vertex_id(int(rng.integers(1, 1 << 30)), int(rng.integers(32)))
        rel = int(rng.integers(1, 1 << 40))
        sk = bytes(rng.integers(0, 256, int(rng.integers(0, 9)), dtype=np.uint8))
        props = {key_id: VALUES[int(rng.integers(len(VALUES)))]} if rng.random() < 0.5 else None
        for d in (0, 1):
            a = ref.write_edge(label, rc.Direction(d), other, rel, sk, props)
            b = got.write_edge(label, tc.Direction(d), other, rel, sk, props)
            assert a == b
            pa, pb = ref.parse_relation(a, lambda t: None), got.parse_relation(b, lambda t: None)
            assert (pa.relation_id, pa.type_id, int(pa.direction), pa.other_vertex_id,
                    pa.properties, pa.sort_key) == (
                pb.relation_id, pb.type_id, int(pb.direction), pb.other_vertex_id,
                pb.properties, pb.sort_key)
            if not sk and not props:
                cols.append(b[0])
    for x, y in zip(ref.bulk_decode_edges(cols), got.bulk_decode_edges(cols)):
        np.testing.assert_array_equal(x, y)
    # the vertex-label system edge and the type slices
    assert got.write_edge(ts.SystemTypes(idm).VERTEX_LABEL_EDGE, tc.Direction.OUT, 24, 5) == \
        ref.write_edge(st_ref.VERTEX_LABEL_EDGE, rc.Direction.OUT, 24, 5)
    def bounds(q):
        return q.start, q.end, q.limit

    for d in (0, 1, 2):
        assert bounds(got.get_type_slice(label, True, tc.Direction(d))) == bounds(
            ref.get_type_slice(label, True, rc.Direction(d)))
    assert bounds(got.get_type_slice(label, True, tc.Direction.OUT, b"\x01", 8)) == bounds(
        ref.get_type_slice(label, True, rc.Direction.OUT, b"\x01", 8))


@pytest.mark.parametrize("card", [0, 1, 2])
@pytest.mark.parametrize("value", [True, 12, 0.25, "olympus"])
def test_property_cells_equal_reference(card, value):
    ref, got = _codecs()
    idm = IDManager(5)
    key_id = idm.make_schema_id(VertexIDType.USER_PROPERTY_KEY, 4)
    a = ref.write_property(key_id, 77, value, rc.Cardinality(card))
    b = got.write_property(key_id, 77, value, tc.Cardinality(card))
    assert a == b
    pa = ref.parse_relation(a, lambda t: rc.TypeInfo(key_id, False, rc.Cardinality(card)))
    pb = got.parse_relation(b, lambda t: tc.TypeInfo(key_id, False, tc.Cardinality(card)))
    assert (pa.relation_id, pa.type_id, pa.value) == (pb.relation_id, pb.type_id, pb.value)


# ---------------------------------------------------------------- schema

def _schema_pairs():
    idm = IDManager(5)
    pk = idm.make_schema_id(VertexIDType.USER_PROPERTY_KEY, 1)
    el = idm.make_schema_id(VertexIDType.USER_EDGE_LABEL, 2)
    vl = idm.make_schema_id(VertexIDType.VERTEX_LABEL, 3)
    return [
        (rs.PropertyKey(pk, "age", int), ts.PropertyKey(pk, "age", int)),
        (rs.PropertyKey(pk, "rank", float, rc.Cardinality.LIST),
         ts.PropertyKey(pk, "rank", float, tc.Cardinality.LIST)),
        (rs.PropertyKey(pk, "ok", bool, rc.Cardinality.SET),
         ts.PropertyKey(pk, "ok", bool, tc.Cardinality.SET)),
        (rs.EdgeLabel(el, "battled", rc.Multiplicity.MULTI, (pk,)),
         ts.EdgeLabel(el, "battled", tc.Multiplicity.MULTI, (pk,))),
        (rs.EdgeLabel(el, "father", rc.Multiplicity.MANY2ONE, (), True),
         ts.EdgeLabel(el, "father", tc.Multiplicity.MANY2ONE, (), True)),
        (rs.VertexLabel(vl, "god"), ts.VertexLabel(vl, "god")),
        (rs.VertexLabel(vl, "hub", True), ts.VertexLabel(vl, "hub", True)),
    ]


@pytest.mark.parametrize("i", range(7))
def test_schema_definitions_round_trip_with_the_reference(i):
    ref_el, el = _schema_pairs()[i]
    raw = ts.encode_definition(el.definition())
    assert raw == rs.encode_definition(ref_el.definition())
    back = ts.schema_element_from_definition(el.id, el.name, ts.decode_definition(raw))
    assert back == el
    ref_back = rs.schema_element_from_definition(el.id, el.name, rs.decode_definition(raw))
    assert ref_back == ref_el
    if hasattr(el, "type_info"):
        a, b = el.type_info(), ref_el.type_info()
        assert (a.type_id, a.is_edge, int(a.cardinality), a.sort_key) == (
            b.type_id, b.is_edge, int(b.cardinality), b.sort_key)


def test_unported_datatype_definition_round_trips():
    ref_el = rs.PropertyKey(5, "place", rs._DATA_TYPES["Geoshape"])
    raw = rs.encode_definition(ref_el.definition())
    el = ts.schema_element_from_definition(5, "place", ts.decode_definition(raw))
    assert ts.encode_definition(el.definition()) == raw


# ------------------------------------------------------------ id authority

@pytest.mark.parametrize("block", [1, 7, 10_000])
def test_id_authority_hands_out_the_reference_blocks(block):
    ref_mgr, mgr = RefStoreManager(), InMemoryStoreManager()
    ra = rida.ConsistentKeyIDAuthority(ref_mgr.open_database("janusgraph_ids"),
                                       ref_mgr.begin_transaction(), block_size=block, wait_ms=0)
    ta = tida.ConsistentKeyIDAuthority(mgr.open_database("janusgraph_ids"),
                                       mgr.begin_transaction(), block_size=block, wait_ms=0)
    for ns, part in [(0, 0), (0, 3), (1, 0), (0, 0), (2, 0), (1, 0), (0, 31)]:
        a, b = ra.get_id_block(ns, part), ta.get_id_block(ns, part)
        assert (a.start, a.size) == (b.start, b.size)
    rp = rida.StandardIDPool(ra, 1, 0)
    tp = tida.StandardIDPool(ta, 1, 0)
    for count in (1, block, 3 * block + 2, 5):
        assert tp.next_ids(count) == rp.next_ids(count)
    assert [tp.next_id() for _ in range(2 * block + 3)] == [rp.next_id() for _ in range(2 * block + 3)]


def test_id_authority_refuses_another_block_size():
    mgr = InMemoryStoreManager()
    store, tx = mgr.open_database("janusgraph_ids"), mgr.begin_transaction()
    tida.ConsistentKeyIDAuthority(store, tx, block_size=10)
    with pytest.raises(ConfigurationError):
        tida.ConsistentKeyIDAuthority(store, tx, block_size=20)


# ---------------------------------------------------------------- config

@pytest.mark.parametrize("path,value,item", [
    ("graph.graphname", "g2", "Queue A #5"),
    ("ids.authority.max-retries", 3, "Queue A #5"),
    ("ids.renew-timeout-ms", 100.0, "Queue A #5"),
    ("computer.result-mode", "persist", "Queue A #5"),
    ("storage.batch-loading", True, "Queue A #5"),
    ("storage.buffer-size", 512, "Queue A #5"),
    ("query.fast-property", False, "Queue A #5"),
    ("cache.tx-cache-size", 100, "Queue A #5"),
])
def test_options_not_ported_raise_naming_the_roadmap_item(path, value, item):
    with pytest.raises(ConfigurationError, match=item):
        GraphConfiguration({path: value})


@pytest.mark.parametrize("path,value", [("cluster.num-processes", 2)])
def test_the_multi_process_option_is_taken(path, value):
    """Refused until the multi-process transport was ported: a graph
    configuration now takes it as the reference's does."""
    assert GraphConfiguration({path: value}).get(path) == value


def test_option_checks_and_defaults():
    with pytest.raises(ConfigurationError, match="unknown configuration option"):
        GraphConfiguration({"olap.nothing": 1})
    with pytest.raises(ConfigurationError):
        GraphConfiguration({"computer.strategy": "fastest"})
    with pytest.raises(ConfigurationError):
        GraphConfiguration({"ids.partition-bits": 17})
    cfg = GraphConfiguration({"computer.strategy": "pallas", "computer.delta": False,
                              "storage.distributed-load-workers": 1})
    assert cfg.get("computer.strategy") == "pallas"
    assert GraphConfiguration({}).get("computer.strategy") == "segsum"
    assert GraphConfiguration({}).get("computer.executor") == "tpu"
    assert GraphConfiguration({}).get("computer.channel-cache-size") == 8
    assert GraphConfiguration({}).get("ids.block-size") == 10_000
