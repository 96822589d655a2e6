"""The port's log bus and WAL codec held to the JAX package's.

The bus (``storage/log.py``): a round trip, the bucket spread, registered
readers, a reader from now skipping history and two managers over one
store, each in both packages; with a fixed clock the same appends write
byte-equal rows. The codec (``core/txlog.py``): seeded change records and
entries encode to the reference's bytes and decode back. A txlog written
by either package into a local directory reads and decodes the same in
the other. Exact equality throughout: these are bytes; every wait on a
reader is bounded.
"""

import time

import numpy as np
import pytest

from janusgraph_tpu.core import txlog as ref_txlog
from janusgraph_tpu.core.graph import open_graph as ref_open_graph
from janusgraph_tpu.storage import log as ref_log
from janusgraph_tpu.storage.inmemory import InMemoryStoreManager as RefManager
from janusgraph_tpu.storage.localstore import open_local_kcvs as ref_open_local
from janusgraph_tpu_torch.core import txlog
from janusgraph_tpu_torch.core.graph import open_graph
from janusgraph_tpu_torch.storage import log
from janusgraph_tpu_torch.storage.inmemory import InMemoryStoreManager
from janusgraph_tpu_torch.storage.localstore import open_local_kcvs

PACKAGES = {
    "ref": (ref_log, RefManager),
    "port": (log, InMemoryStoreManager),
}


def _wait(cond, timeout_s=5.0):
    deadline = time.monotonic() + timeout_s
    while not cond() and time.monotonic() < deadline:
        time.sleep(0.01)
    return cond()


class FixedClock:
    """A timestamp provider that ticks 1 ms a call from a fixed start."""

    resolution_ns = 1

    def __init__(self, start_ns=1_700_000_000_000_000_000):
        self.now = start_ns

    def time_ns(self):
        self.now += 1_000_000
        return self.now


def _make_log(pkg, mgr=None, name="testlog", sender=b"sender01", **kw):
    mod, manager_cls = PACKAGES[pkg]
    mgr = mgr or manager_cls()
    return mod.KCVSLog(name, mgr.open_database(name), mgr.begin_transaction, sender,
                       read_interval_ms=5.0, **kw), mgr


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_round_trip_in_time_order(pkg):
    lg, _ = _make_log(pkg)
    try:
        t0 = time.time_ns()
        for i in range(10):
            lg.add(b"msg%d" % i)
        lg.flush()
        msgs = lg.read_range(t0 - 1)
        assert sorted(m.content for m in msgs) == [b"msg%d" % i for i in range(10)]
        assert [m.timestamp_ns for m in msgs] == sorted(m.timestamp_ns for m in msgs)
    finally:
        lg.close()


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_messages_spread_over_buckets(pkg):
    lg, mgr = _make_log(pkg, num_buckets=4)
    try:
        for i in range(40):
            lg.add(b"m%d" % i)
        lg.flush()
        store, stx = mgr.open_database("testlog"), mgr.begin_transaction()
        mod = PACKAGES[pkg][0]  # each log module's own query types
        scan = mod.KeyRangeQuery(b"\x00", b"\xff", mod.SliceQuery())
        buckets = {key[0] for key, _ in store.get_keys(scan, stx)}
        assert buckets == {0, 1, 2, 3}
        assert len(lg.read_range(0)) == 40
    finally:
        lg.close()


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_registered_reader_receives(pkg):
    lg, _ = _make_log(pkg)
    got = []
    try:
        lg.register_reader(PACKAGES[pkg][0].ReadMarker.from_epoch(),
                           lambda m: got.append(m.content))
        lg.add(b"hello")
        lg.add(b"world")
        lg.flush()
        assert _wait(lambda: len(got) >= 2)
        assert sorted(got) == [b"hello", b"world"]
    finally:
        lg.close()


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_reader_from_now_skips_history(pkg):
    lg, _ = _make_log(pkg)
    got = []
    try:
        lg.add_now(b"old")
        time.sleep(0.01)
        lg.register_reader(PACKAGES[pkg][0].ReadMarker.from_now(),
                           lambda m: got.append(m.content))
        time.sleep(0.05)
        lg.add_now(b"new")
        assert _wait(lambda: got)
        time.sleep(0.1)  # what else would arrive, had history leaked
        assert got == [b"new"]
    finally:
        lg.close()


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_two_managers_one_store(pkg):
    """A second log over the same store sees the first's messages: the log
    is the bus between instances."""
    a, mgr = _make_log(pkg, name="shared")
    b, _ = _make_log(pkg, mgr, name="shared", sender=b"sender02")
    try:
        t0 = time.time_ns()
        a.add_now(b"from-a")
        msgs = b.read_range(t0 - 1)
        assert [m.content for m in msgs] == [b"from-a"]
        assert msgs[0].sender == b"sender01"
    finally:
        a.close()
        b.close()


def test_close_joins_the_send_and_pull_threads():
    lg, _ = _make_log("port")
    lg.register_reader(log.ReadMarker.from_epoch(), lambda m: None)
    lg.add(b"x")
    threads = [lg._send_thread] + list(lg._readers)
    assert all(t.is_alive() for t in threads) and len(threads) == 5
    lg.close()
    assert not any(t.is_alive() for t in threads)
    assert len(lg.read_range(0)) == 1  # close() flushed the outbox


def test_a_weak_reader_ends_its_pullers_with_its_object():
    lg, _ = _make_log("port")
    import weakref

    class Sink:
        def on(self, m):
            pass

    sink = Sink()
    lg.register_reader(log.ReadMarker.from_epoch(), weakref.WeakMethod(sink.on))
    threads = list(lg._readers)
    del sink
    try:
        assert _wait(lambda: not any(t.is_alive() for t in threads))
    finally:
        lg.close()


def test_same_appends_write_byte_equal_rows():
    rows = {}
    for pkg in sorted(PACKAGES):
        lg, mgr = _make_log(pkg, timestamps=FixedClock(), num_buckets=3)
        for i in range(25):
            lg.add(b"payload-%d" % i, bucket=(i % 5 if i % 2 else None))
        lg.flush()
        lg.close()
        st = mgr.open_database("testlog")
        rows[pkg] = {k: list(zip(r.columns, r.values)) for k, r in st._rows.items()}
    assert rows["ref"] == rows["port"] and len(rows["port"]) >= 3


def _seeded_changes(seed, n=40):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        ids = [int(x) for x in rng.integers(0, 1 << 62, 4)]
        added = bool(rng.integers(0, 2))
        if i % 3:
            out.append(("edge", added, ids[0], ids[1], ids[2], ids[3], b""))
        else:
            value = bytes(rng.integers(0, 256, int(rng.integers(0, 40))).astype(np.uint8))
            out.append(("property", added, ids[0], 0, ids[2], ids[3], value))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_change_and_entry_codec_bytes_equal_the_reference(seed):
    rows = _seeded_changes(seed)
    ours = [txlog.ChangeRecord(*r) for r in rows]
    theirs = [ref_txlog.ChangeRecord(*r) for r in rows]
    data = txlog.encode_changes(ours)
    assert data == ref_txlog.encode_changes(theirs)
    assert txlog.decode_changes(data) == ours
    for status in txlog.LogTxStatus:
        for user_log in ("", "audit", "healed:0011223344556677"):
            e = txlog.TxLogEntry(1234567 + seed, status, ours, user_log)
            r = ref_txlog.TxLogEntry(1234567 + seed, ref_txlog.LogTxStatus(int(status)),
                                     theirs, user_log)
            raw = txlog.encode_tx_entry(e)
            assert raw == ref_txlog.encode_tx_entry(r)
            back = txlog.decode_tx_entry(raw, 99)
            want = ref_txlog.decode_tx_entry(raw, 99)
            assert (back.tx_id, int(back.status), back.user_log, back.timestamp_ns) == (
                want.tx_id, int(want.status), want.user_log, want.timestamp_ns)
            assert [tuple(vars(c).values()) for c in back.changes] == [
                tuple(vars(c).values()) for c in want.changes]


def _read_txlog(mod, txlog_mod, mgr):
    lg = mod.KCVSLog("txlog", mgr.open_database("txlog"), mgr.begin_transaction, b"reader00")
    out = []
    for m in lg.read_range(0):
        e = txlog_mod.decode_tx_entry(m.content, m.timestamp_ns)
        out.append((m.sender, m.timestamp_ns, e.tx_id, int(e.status), e.user_log,
                    [tuple(vars(c).values()) for c in e.changes]))
    lg.close()
    return out


@pytest.mark.parametrize("writer", ["ref", "port"])
def test_a_txlog_in_a_local_directory_reads_the_same_in_both(tmp_path, writer):
    d = str(tmp_path / "graph")
    cfg = {"storage.backend": "local", "storage.directory": d, "storage.fsync": False,
           "tx.log-tx": True, "computer.delta": False}
    if writer == "ref":
        g = ref_open_graph(dict(cfg, **{"computer.sharded-auto": False}))
    else:
        g = open_graph(dict(cfg, **{"computer.executor": "cpu"}))
    try:
        for i in range(3):
            tx = g.new_transaction(log_identifier="audit" if i == 1 else None)
            a = tx.add_vertex(name=f"a{i}")
            tx.add_edge(a, "knows", tx.add_vertex(name=f"b{i}"))
            tx.commit()
    finally:
        g.close()
    ref_mgr = ref_open_local(d, fsync=False)
    want = _read_txlog(ref_log, ref_txlog, ref_mgr)
    ref_mgr.close()
    port_mgr = open_local_kcvs(d, fsync=False)
    got = _read_txlog(log, txlog, port_mgr)
    port_mgr.close()
    assert got == want
    assert [s for *_x, s, _u, _c in got][:4] == [1, 5, 2, 3]
    assert len(got) == 12 and sum(1 for r in got if r[5]) == 3
