"""The port's persistent local store held to the JAX package's.

The same operations through ``open_local_kcvs`` write byte-equal
``store.wal`` and ``store.snapshot`` files in both packages. A graph
directory written by either package's ``open_graph`` (transactions and the
bulk loader) opens in the other with equal rows in every store the port
reads and an equal ``load_csr``. Reopen, compaction, a torn tail and a bad
CRC (replay stops at the last whole frame, in both packages alike) and
``drop_graph`` (the store's files go, nothing else of the directory).
Exact equality throughout: these are bytes, ids and index arrays.
"""

import os

import numpy as np
import pytest

from janusgraph_tpu.core.bulk import bulk_add_edges as ref_bulk_add_edges
from janusgraph_tpu.core.bulk import bulk_add_vertices as ref_bulk_add_vertices
from janusgraph_tpu.core.graph import open_graph as ref_open_graph
from janusgraph_tpu.olap.csr import load_csr as ref_load_csr
from janusgraph_tpu.storage import localstore as ref_localstore
from janusgraph_tpu_torch.core.bulk import bulk_add_edges, bulk_add_vertices
from janusgraph_tpu_torch.core.graph import drop_graph, open_graph
from janusgraph_tpu_torch.olap.csr import load_csr
from janusgraph_tpu_torch.storage import kvstore, localstore
from janusgraph_tpu_torch.storage.kcvs import KeyRangeQuery, KeySliceQuery, SliceQuery

#: the stores the port's graph reads
GRAPH_STORES = ("edgestore", "graphindex", "janusgraph_ids")
CSR_FIELDS = ("vertex_ids", "out_indptr", "out_dst", "in_indptr", "in_src", "out_degree",
              "labels", "in_edge_type", "out_edge_type")


def _ops(mgr):
    """The same KCVS operations for either package's manager: single-row
    mutations with zero bytes in keys (the composite escape), deletions, a
    batched mutate_many across stores, a commit."""
    kcvs = mgr.kv_manager.__class__.__module__.rsplit(".", 1)[0] + ".kcvs"
    mutation = __import__(kcvs, fromlist=["KCVMutation"]).KCVMutation
    tx = mgr.begin_transaction()
    es = mgr.open_database("edgestore")
    es.mutate(b"row\x00a", [(b"c1", b"v1"), (b"c\x002", b"v2")], [], tx)
    es.mutate(b"row\x00b", [(b"c1", b"w" * 300)], [], tx)
    es.mutate(b"row\x00a", [(b"c3", b"")], [b"c1"], tx)
    mgr.mutate_many({
        "graphindex": {b"\x00sn\x00x": mutation([(b"id", b"")], [])},
        "edgestore": {b"row\x00b": mutation([], [b"c1"]), b"z": mutation([(b"", b"v")], [])},
    }, tx)
    tx.commit()


def _mem(kv_manager):
    return {name: dict(st.mem.data) for name, st in kv_manager._stores.items() if st.mem.data}


def test_same_operations_write_byte_equal_files(tmp_path):
    dirs = {}
    for name, mod in (("ref", ref_localstore), ("port", localstore)):
        d = str(tmp_path / name)
        mgr = mod.open_local_kcvs(d)
        _ops(mgr)
        mgr.close()
        with open(os.path.join(d, "store.wal"), "rb") as f:
            dirs[name] = [f.read()]
        mgr = mod.open_local_kcvs(d)
        mgr.kv_manager.compact()
        _ops(mgr)
        mgr.close()
        for fname in ("store.snapshot", "store.wal"):
            with open(os.path.join(d, fname), "rb") as f:
                dirs[name].append(f.read())
    assert dirs["ref"] == dirs["port"]
    assert all(dirs["port"])


def test_kcvs_over_the_local_store_reads_like_the_reference(tmp_path):
    ref = ref_localstore.open_local_kcvs(str(tmp_path / "ref"))
    port = localstore.open_local_kcvs(str(tmp_path / "port"))
    from janusgraph_tpu.storage import kcvs as rk

    for mgr in (ref, port):
        _ops(mgr)
    tx_r, tx_p = ref.begin_transaction(), port.begin_transaction()
    es_r, es_p = ref.open_database("edgestore"), port.open_database("edgestore")
    for key in (b"row\x00a", b"row\x00b", b"z", b"none"):
        for start, end, limit in ((b"", None, None), (b"c", b"c3", None), (b"", None, 1)):
            assert es_p.get_slice(KeySliceQuery(key, SliceQuery(start, end, limit)), tx_p) == \
                es_r.get_slice(rk.KeySliceQuery(key, rk.SliceQuery(start, end, limit)), tx_r)
    assert list(es_p.get_keys(SliceQuery(), tx_p)) == list(es_r.get_keys(rk.SliceQuery(), tx_r))
    assert list(es_p.get_keys(KeyRangeQuery(b"row", b"row\x01", SliceQuery(b"c", b"c4")), tx_p)) \
        == list(es_r.get_keys(rk.KeyRangeQuery(b"row", b"row\x01", rk.SliceQuery(b"c", b"c4")), tx_r))
    for key, col in ((b"a\x00b", b"\x00c"), (b"", b""), (b"\x00\x00", b"x")):
        comp = kvstore.encode_composite(key, col)
        assert kvstore.decode_composite(comp) == (key, col)
        from janusgraph_tpu.storage import kvstore as ref_kvstore

        assert comp == ref_kvstore.encode_composite(key, col)
    ref.close()
    port.close()


def _fill(pkg, d, tx_writes=True):
    """One graph in directory ``d``, through transactions and the bulk
    loader of package ``pkg`` ("ref" or "port")."""
    opener, bv, be = ((ref_open_graph, ref_bulk_add_vertices, ref_bulk_add_edges) if pkg == "ref"
                      else (open_graph, bulk_add_vertices, bulk_add_edges))
    cfg = {"storage.backend": "local", "storage.directory": d}
    g = opener(dict(cfg, **{"computer.sharded-auto": False}) if pkg == "ref" else cfg)
    rng = np.random.default_rng(4)
    vids = bv(g, 60)
    be(g, "link", vids[rng.integers(0, 60, 300)], vids[rng.integers(0, 60, 300)])
    if tx_writes:
        g.management().make_property_key("name", str)
        tx = g.new_transaction()
        a = tx.add_vertex("person", name="a")
        b = tx.add_vertex("person", name="b")
        tx.add_edge(a, "knows", b)
        tx.add_edge(a, "link", tx.get_vertex(int(vids[0])))
        tx.commit()
    g.close()
    return cfg


@pytest.mark.parametrize("writer", ["ref", "port"])
def test_a_directory_opens_in_the_other_package(tmp_path, writer):
    d = str(tmp_path / "graph")
    cfg = _fill(writer, d)
    port = open_graph(dict(cfg))
    ref = ref_open_graph(dict(cfg, **{"computer.sharded-auto": False}))
    try:
        rows_p = {s: dict(port.backend.manager.kv_manager._stores[s].mem.data) for s in GRAPH_STORES}
        rows_r = {s: dict(ref.backend.manager.kv_manager._stores[s].mem.data) for s in GRAPH_STORES}
        assert rows_p == rows_r and rows_p["edgestore"]
        a, b = load_csr(port), ref_load_csr(ref)
        assert a.num_vertices == 62 and a.num_edges == 302
        for field in CSR_FIELDS:
            np.testing.assert_array_equal(getattr(a, field), getattr(b, field))
        tx = port.new_transaction()
        assert sorted(v.value("name") for v in tx.vertices() if tx.get_vertex_label(v) == "person") \
            == ["a", "b"]
        tx.rollback()
    finally:
        port.close()
        ref.close()


def test_reopen_compact_and_drop(tmp_path):
    d = str(tmp_path / "graph")
    (tmp_path / "graph").mkdir()
    (tmp_path / "graph" / "keep.txt").write_text("not the store's")
    cfg = _fill("port", d)
    g = open_graph(cfg)
    before = load_csr(g)
    rows = _mem(g.backend.manager.kv_manager)
    g.backend.manager.kv_manager.compact()
    assert os.path.getsize(os.path.join(d, "store.wal")) == 0
    g.close()
    g = open_graph(cfg)
    # the snapshot holds every row; close() added only COMMIT frames and
    # the instance registry's cells: close() deregisters the instance and
    # each open registers its own id
    def registry_apart(mem):
        rest = {name: {k: v for k, v in cells.items() if b"cluster.instance." not in k}
                for name, cells in mem.items()}
        ids = sorted(k for cells in mem.values() for k in cells if b"cluster.instance." in k)
        return {name: cells for name, cells in rest.items() if cells}, ids

    now, ids = registry_apart(_mem(g.backend.manager.kv_manager))
    assert now == registry_apart(rows)[0]
    assert len(ids) == 1 and ids[0].endswith(g.instance_id.encode())
    tx = g.new_transaction()
    tx.add_vertex("person", name="c")
    tx.commit()
    g.close()
    g = open_graph(cfg)
    after = load_csr(g)
    assert after.num_vertices == before.num_vertices + 1
    assert np.isin(before.vertex_ids, after.vertex_ids).all()
    assert set(os.listdir(d)) == {"store.wal", "store.snapshot", "keep.txt"}
    drop_graph(g)
    assert os.listdir(d) == ["keep.txt"]
    assert not g._open
    g = open_graph(cfg)
    assert load_csr(g).num_vertices == 0
    g.close()


@pytest.mark.parametrize("damage", ["torn_tail", "bad_crc"])
def test_replay_stops_at_the_damaged_frame_in_both_packages(tmp_path, damage):
    d = str(tmp_path / "kv")
    mgr = localstore.open_local_kcvs(d)
    tx = mgr.begin_transaction()
    es = mgr.open_database("edgestore")
    for i in range(20):
        es.mutate(b"k%02d" % i, [(b"c", b"v%d" % i)], [], tx)
    tx.commit()
    mgr.close()
    path = os.path.join(d, "store.wal")
    with open(path, "rb") as f:
        data = f.read()
    # k19's frame, then the COMMIT frames of commit() and close(): damage
    # k19's (the composite key is the row key, its terminator, the column)
    start = data.rfind(b"edgestorek19") - 4 - 13
    end = start + 4 + 13 + len(b"edgestore") + len(b"k19\x00\x00c") + len(b"v19")
    if damage == "torn_tail":
        data = data[: end - 2]
    else:
        data = data[: end - 1] + bytes([data[end - 1] ^ 1]) + data[end:]
    with open(path, "wb") as f:
        f.write(data)
    port = localstore.LocalKVStoreManager(d)
    ref = ref_localstore.LocalKVStoreManager(d)
    assert _mem(port) == _mem(ref)
    assert sorted(_mem(port)["edgestore"]) == [b"k%02d\x00\x00c" % i for i in range(19)]
    port.close()
    ref.close()


def test_interleaved_writes_and_scans_read_like_the_reference(tmp_path):
    """Puts, deletes, re-puts of deleted keys and range scans, interleaved
    at random, read the same rows from both packages' stores, and a reopen
    replays to the same contents."""
    rng = np.random.default_rng(17)
    keys = [bytes([a, b]) for a in range(6) for b in range(6)]
    ops = []
    for _ in range(600):
        k = keys[int(rng.integers(len(keys)))]
        r = rng.random()
        if r < 0.45:
            ops.append(("put", k, bytes([int(rng.integers(256))])))
        elif r < 0.75:
            ops.append(("del", k, None))
        else:
            lo, hi = sorted(keys[int(i)] for i in rng.integers(len(keys), size=2))
            ops.append(("scan", lo, None if rng.random() < 0.2 else hi))
    seen = {}
    for name, mod in (("ref", ref_localstore), ("port", localstore)):
        d = str(tmp_path / name)
        mgr = mod.LocalKVStoreManager(d)
        st = mgr.open_database("s")
        tx = mgr.begin_transaction()
        out = []
        for op, k, v in ops:
            if op == "put":
                st.insert(k, v, tx)
            elif op == "del":
                st.delete(k, tx)
            else:
                out.append(list(st.scan(k, v, tx)))
        mgr.close()
        again = mod.LocalKVStoreManager(d)
        out.append(list(again.open_database("s").scan(b"", None, None)))
        again.close()
        seen[name] = out
    assert seen["ref"] == seen["port"]
    assert any(seen["port"][:-1]) and seen["port"][-1]
