"""The port's durable CDC log held to the JAX package's.

The batch codec writes the reference's bytes. The reference's CDC cases
run on the port: the seeded torn write of a ``FaultPlan`` (the same tail
bytes and journal as the reference's, exactly the torn frame lost on
reopen, and through a graph's ``storage.faults.cdc-torn-at``), the fault
journal's determinism, append, replay and reopen,
idempotent replay, a torn tail, sealed segments surviving the tail's loss,
the retention gap, poison refusing, ``cursor_for_epoch`` brackets, the
reader against the writer, the power-of-two segment size, and a graph's
commits streaming into the log. Replaying the log from the snapshot's
cursor and folding it (``DeltaOverlay.from_batches`` + ``materialize``)
gives a CSR array-equal to a fresh ``load_csr``, and PageRank over it is
bitwise PageRank over the scan. A CDC directory either package wrote
replays the same records in the other. Exact equality throughout: these
are bytes, ids and arrays.
"""

import os

import numpy as np
import pytest

from janusgraph_tpu.storage import cdc as ref_cdc
from janusgraph_tpu_torch.core.codecs import Direction
from janusgraph_tpu_torch.core.graph import open_graph
from janusgraph_tpu_torch.observability import registry
from janusgraph_tpu_torch.olap import delta as D
from janusgraph_tpu_torch.olap import run_on
from janusgraph_tpu_torch.olap.csr import load_csr, load_csr_snapshot
from janusgraph_tpu_torch.olap.programs import PageRankProgram
from janusgraph_tpu_torch.storage import cdc
from janusgraph_tpu_torch.storage.cdc import CDCLog, CDCReader, CDCTornWrite, TAIL_NAME
from janusgraph_tpu_torch.storage.inmemory import InMemoryStoreManager

BASE_CFG = {"locks.wait-ms": 0.0, "computer.delta": True, "computer.executor": "cpu"}


def _counter(name):
    return registry.snapshot().get(name, {}).get("count", 0)


def _batch(adds=(), dels=(), v_add=None, v_del=None):
    def _lanes(rows):
        if not rows:
            z = np.empty(0, np.int64)
            return z, z.copy(), z.copy()
        a = np.asarray(rows, np.int64).reshape(-1, 3)
        return a[:, 0].copy(), a[:, 1].copy(), a[:, 2].copy()

    a, d = _lanes(list(adds)), _lanes(list(dels))
    v_add, v_del = dict(v_add or {}), list(v_del or [])
    return {"n": len(a[0]) + len(d[0]) + len(v_add) + len(v_del),
            "add": a, "del": d, "v_add": v_add, "v_del": v_del}


def _assert_batch_equal(x, y):
    for lane in ("add", "del"):
        for i in range(3):
            np.testing.assert_array_equal(x[lane][i], y[lane][i])
    assert x["v_add"] == y["v_add"]
    assert list(x["v_del"]) == list(y["v_del"])
    assert x["n"] == y["n"]


def _seeded_batch(seed):
    rng = np.random.default_rng(seed)
    big = 1 << 60
    rows = lambda k: [tuple(int(x) for x in r) for r in rng.integers(0, big, (k, 3))]  # noqa: E731
    return _batch(adds=rows(int(rng.integers(0, 30))), dels=rows(int(rng.integers(0, 10))),
                  v_add={int(v): int(rng.integers(0, 50)) for v in rng.integers(0, big, 4)},
                  v_del=[int(v) for v in rng.integers(0, big, int(rng.integers(0, 5)))])


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_batch_codec_bytes_equal_the_reference(seed):
    b = _seeded_batch(seed)
    raw = cdc.encode_batch(100 + seed, b)
    assert raw == ref_cdc.encode_batch(100 + seed, b)
    epoch, back = cdc.decode_batch(raw)
    assert epoch == 100 + seed
    _assert_batch_equal(b, back)
    assert cdc.encode_batch(7, None) == ref_cdc.encode_batch(7, None)
    assert cdc.decode_batch(cdc.encode_batch(7, None)) == (7, None)


def test_empty_lanes_and_large_ids_survive():
    b = _batch(v_del=[3])
    assert cdc.decode_batch(cdc.encode_batch(1, b))[0] == 1
    big = (1 << 60) + 12345
    _e, back = cdc.decode_batch(cdc.encode_batch(9, _batch(adds=[(big, big - 1, 1 << 40)])))
    assert [int(back["add"][i][0]) for i in range(3)] == [big, big - 1, 1 << 40]


def _fill(log, n, start_epoch=1):
    for i in range(n):
        log.append(start_epoch + i, _batch(adds=[(i, i + 1, 1)]))


def test_append_replay_reopen(tmp_path):
    log = CDCLog(str(tmp_path), segment_records=4)
    _fill(log, 6)
    records, nxt = log.replay_from(0)
    assert len(records) == 6 and nxt == 6
    assert log.stats()["sealed_segments"] == 1
    log.close()
    with pytest.raises(CDCTornWrite):
        log.append(7, _batch())
    log2 = CDCLog(str(tmp_path), segment_records=4)
    records2, nxt2 = log2.replay_from(0)
    assert nxt2 == 6
    for (e1, b1), (e2, b2) in zip(records, records2):
        assert e1 == e2
        _assert_batch_equal(b1, b2)
    log2.close()


def test_replay_is_idempotent(tmp_path):
    log = CDCLog(str(tmp_path), segment_records=4)
    _fill(log, 5)
    r1, r2 = log.replay_from(2), log.replay_from(2)
    assert r1[1] == r2[1] == 5
    assert [e for e, _ in r1[0]] == [e for e, _ in r2[0]] == [3, 4, 5]
    log.close()


def test_torn_tail_costs_only_the_torn_suffix(tmp_path):
    log = CDCLog(str(tmp_path), segment_records=64)
    _fill(log, 3)
    log.close()
    with open(os.path.join(str(tmp_path), TAIL_NAME), "ab") as f:
        f.write(b"\x00\x01torn-partial-frame")
    before = _counter("cdc.torn_frames_dropped")
    log2 = CDCLog(str(tmp_path), segment_records=64)
    assert _counter("cdc.torn_frames_dropped") == before + 1
    records, nxt = log2.replay_from(0)
    assert len(records) == 3 and nxt == 3
    log2.append(10, _batch(adds=[(9, 9, 9)]))
    assert log2.replay_from(0)[1] == 4
    log2.close()


def test_sealed_segments_survive_tail_loss(tmp_path):
    log = CDCLog(str(tmp_path), segment_records=4)
    _fill(log, 9)  # two sealed segments and one tail record
    log.close()
    os.unlink(os.path.join(str(tmp_path), TAIL_NAME))
    log2 = CDCLog(str(tmp_path), segment_records=4)
    records, nxt = log2.replay_from(0)
    assert nxt == 8 and len(records) == 8
    log2.close()


def test_retention_prune_makes_an_honest_gap(tmp_path):
    log = CDCLog(str(tmp_path), segment_records=4, retention_segments=1)
    _fill(log, 12)  # three seals, the first two pruned
    assert log.base_cursor == 8
    assert log.replay_from(0) is None
    records, nxt = log.replay_from(8)
    assert nxt == 12 and len(records) == 4
    assert log.cursor_for_epoch(2) is None
    assert log.cursor_for_epoch(11) == 11
    log.close()


def test_poison_in_range_refuses(tmp_path):
    log = CDCLog(str(tmp_path), segment_records=64)
    log.append(1, _batch(adds=[(1, 2, 1)]))
    log.append(2, None)
    log.append(3, _batch(adds=[(3, 4, 1)]))
    assert log.replay_from(0) is None and log.replay_from(1) is None
    records, nxt = log.replay_from(2)
    assert len(records) == 1 and nxt == 3
    log.close()


def test_cursor_for_epoch_brackets(tmp_path):
    log = CDCLog(str(tmp_path), segment_records=4)
    _fill(log, 6, start_epoch=10)  # epochs 10..15
    assert [log.cursor_for_epoch(e) for e in (9, 12, 15, 99)] == [0, 3, 6, 6]
    log.close()


def test_reader_matches_writer(tmp_path):
    log = CDCLog(str(tmp_path), segment_records=4)
    _fill(log, 7)
    reader = CDCReader(str(tmp_path))
    assert reader.head_cursor() == log.head_cursor() == 7
    (rw, nw), (rr, nr) = log.replay_from(3), reader.replay_from(3)
    assert nw == nr and [e for e, _ in rw] == [e for e, _ in rr]
    for (_, b1), (_, b2) in zip(rw, rr):
        _assert_batch_equal(b1, b2)
    assert reader.cursor_for_epoch(4) == log.cursor_for_epoch(4)
    log.close()


def test_pow2_segment_size_enforced(tmp_path):
    with pytest.raises(ValueError):
        CDCLog(str(tmp_path), segment_records=7)


def _graph_chain(cdc_dir, n=24, extra=None):
    cfg = dict(BASE_CFG, **{"storage.cdc.dir": str(cdc_dir),
                            "storage.cdc.segment-records": 4}, **(extra or {}))
    g = open_graph(cfg, store_manager=InMemoryStoreManager())
    g.management().make_edge_label("link")
    tx = g.new_transaction()
    ids = [tx.add_vertex().id for _ in range(n)]
    for i in range(n - 1):
        tx.add_edge(tx.get_vertex(ids[i]), "link", tx.get_vertex(ids[i + 1]))
    tx.commit()
    return g, ids


def _burst(g, ids, seed=7, adds=10, dels=2):
    rng = np.random.default_rng(seed)
    tx = g.new_transaction()
    for _ in range(adds):
        a, b = rng.integers(0, len(ids), 2)
        tx.add_edge(tx.get_vertex(ids[int(a)]), "link", tx.get_vertex(ids[int(b)]))
    removed = 0
    for i in rng.permutation(len(ids)):
        if removed >= dels:
            break
        es = tx.get_edges(tx.get_vertex(ids[int(i)]), Direction.OUT, ("link",))
        if es:
            tx.remove_edge(es[0])
            removed += 1
    tx.commit()


def _assert_csr_equal(a, b):
    for k in ("vertex_ids", "out_indptr", "in_indptr", "out_dst", "in_src"):
        np.testing.assert_array_equal(getattr(a, k), getattr(b, k))


def test_commits_stream_into_the_log(tmp_path):
    g, ids = _graph_chain(tmp_path / "cdc")
    try:
        head0 = g.cdc_log.head_cursor()
        assert head0 > 0
        _burst(g, ids, seed=3)
        assert g.cdc_log.head_cursor() > head0
        records, _nxt = g.cdc_log.replay_from(0)
        assert all(b["n"] > 0 for _e, b in records)
    finally:
        g.close()
    assert g.cdc_log._tail_file is None  # close() closed the log


def test_fresh_scan_equivalence_from_the_snapshot_cursor(tmp_path):
    """Folding every record past the snapshot's epoch into the snapshot
    gives the fresh scan's arrays, and PageRank over them its ranks, bit
    for bit."""
    g, ids = _graph_chain(tmp_path / "cdc")
    try:
        csr0, epoch0 = load_csr_snapshot(g)
        _burst(g, ids, seed=5)
        _burst(g, ids, seed=6)
        cursor = g.cdc_log.cursor_for_epoch(epoch0)
        records, _ = g.cdc_log.replay_from(cursor)
        assert len(records) == 2
        folded = D.materialize(csr0, D.DeltaOverlay.from_batches([b for _e, b in records]),
                               idm=g.idm)
        fresh = load_csr(g)
        _assert_csr_equal(folded, fresh)
        program = PageRankProgram(max_iterations=20, tol=0.0)
        a = run_on(folded, program, device="cpu")["rank"]
        b = run_on(fresh, PageRankProgram(max_iterations=20, tol=0.0), device="cpu")["rank"]
        assert a.dtype == b.dtype and np.array_equal(a.view(np.int32), b.view(np.int32))
    finally:
        g.close()


def _records(replayed):
    records, nxt = replayed
    return nxt, [(e, {k: (tuple(map(list, b[k])) if k in ("add", "del") else b[k])
                      for k in ("n", "add", "del", "v_add", "v_del")}) for e, b in records]


@pytest.mark.parametrize("writer", ["ref", "port"])
def test_a_cdc_directory_replays_the_same_in_both(tmp_path, writer):
    """Ten seeded batches (two sealed segments and a tail of two), then a
    poison record and one more batch, written by one package: both
    packages' logs and readers replay the same records from every
    cursor, and both refuse a range holding the poison."""
    d = str(tmp_path / "cdc")
    mod = ref_cdc if writer == "ref" else cdc
    log = mod.CDCLog(d, segment_records=4)
    for i in range(10):
        log.append(i + 1, _seeded_batch(i))
    log.close()
    views = lambda: (ref_cdc.CDCLog(d, segment_records=4), CDCLog(d, segment_records=4),  # noqa: E731
                     ref_cdc.CDCReader(d), CDCReader(d))
    opened = views()
    try:
        for cursor in (0, 3, 4, 9, 10):
            got = [_records(v.replay_from(cursor)) for v in opened]
            assert all(x == got[0] for x in got) and got[0][0] == 10
        assert opened[0].stats() == opened[1].stats()
        assert {v.cursor_for_epoch(6) for v in opened} == {6}
    finally:
        opened[0].close()
        opened[1].close()
    log = mod.CDCLog(d, segment_records=4)
    log.append(11, None)
    log.append(12, _seeded_batch(12))
    log.close()
    opened = views()
    try:
        for v in opened:
            assert v.replay_from(0) is None and v.replay_from(10) is None
        got = [_records(v.replay_from(11)) for v in opened]
        assert all(x == got[0] for x in got) and got[0][0] == 12 and len(got[0][1]) == 1
    finally:
        opened[0].close()
        opened[1].close()


def _torn_write(mod, plan_mod, d):
    plan = plan_mod.FaultPlan(seed=7, cdc_torn_at=2)
    log = mod.CDCLog(str(d), segment_records=64, fault_plan=plan)
    log.append(1, _batch(adds=[(1, 2, 1)]))
    log.append(2, _batch(adds=[(2, 3, 1)]))
    with pytest.raises(mod.CDCTornWrite, match="injected torn cdc tail write"):
        log.append(3, _batch(adds=[(3, 4, 1)]))
    with pytest.raises(mod.CDCTornWrite):
        log.append(4, _batch(adds=[(4, 5, 1)]))  # the crashed writer refuses
    log.close()
    with open(os.path.join(str(d), TAIL_NAME), "rb") as f:
        tail = f.read()
    log2 = mod.CDCLog(str(d), segment_records=64)
    records, nxt = log2.replay_from(0)
    log2.close()
    return tail, nxt, [e for e, _ in records], plan.journal


def test_injected_torn_write_recovers_deterministically(tmp_path):
    from janusgraph_tpu.storage import faults as ref_faults
    from janusgraph_tpu_torch.storage import faults

    port = _torn_write(cdc, faults, tmp_path / "port")
    tail, nxt, epochs, journal = port
    assert nxt == 2, "exactly the torn frame is gone"
    assert epochs == [1, 2]
    assert journal == [{"kind": "cdc_torn_segment", "n": 2}]
    assert port == _torn_write(ref_cdc, ref_faults, tmp_path / "ref")


def test_a_graph_tears_its_cdc_log_at_the_configured_append(tmp_path):
    g = open_graph(dict(BASE_CFG, **{"storage.cdc.dir": str(tmp_path),
                                      "storage.faults.enabled": True,
                                      "storage.faults.cdc-torn-at": 1}))
    assert g.cdc_log.fault_plan is g.fault_plan
    tx = g.new_transaction()
    a, b = tx.add_vertex(), tx.add_vertex()
    tx.add_edge(a, "knows", b)
    tx.commit()
    appended = g.cdc_log.replay_from(0)[1]
    with pytest.raises(CDCTornWrite):
        g.cdc_log.append(99, _batch(adds=[(1, 2, 3)]))
    assert [e["kind"] for e in g.fault_plan.journal] == ["cdc_torn_segment"]
    g.close()
    log = CDCLog(str(tmp_path))
    assert log.replay_from(0)[1] == appended
    log.close()


def test_fault_journal_is_seed_deterministic():
    import json

    from janusgraph_tpu.storage import faults as ref_faults
    from janusgraph_tpu_torch.storage import faults

    def _run(mod):
        plan = mod.FaultPlan(seed=77, cdc_torn_at=1, follower_lag_at=1, follower_lag_pulls=2)
        for _ in range(4):
            plan.cdc_torn_write()
        for _ in range(5):
            plan.follower_lag()
        return json.dumps(plan.journal, sort_keys=True)

    assert _run(faults) == _run(faults) == _run(ref_faults)
