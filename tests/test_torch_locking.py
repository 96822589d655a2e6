"""The port's consistent-key locker held to the JAX package's, after the
reference's ``tests/test_locking.py`` (its unique-index cases wait for the
indexes, ROADMAP Queue A #5.2, and its fault-plan case for the chaos
engine, #5.5).

Each case runs on both packages' lockers over their own in-memory stores,
with the same claims, and must end the same way: local mediation,
claim-then-verify with the first unexpired claim winning, expired claims
ignored, expected-value drift failing the commit, lease expiry raising the
retriable error and leaving the target re-acquirable. At the graph level,
two graph instances over one store contend for a LOCK-consistency cell:
the second commit raises ``TemporaryLockingError`` in both packages, and a
write from a stale cached read fails its expected value.
Locking tests set ``locks.wait-ms`` small, as the reference's do.
"""

import threading
import time
from types import SimpleNamespace

import pytest

from janusgraph_tpu.core import codecs as ref_codecs
from janusgraph_tpu.core.graph import open_graph as ref_open_graph
from janusgraph_tpu.exceptions import TemporaryBackendError as RefTemporary
from janusgraph_tpu.storage import locking as ref_locking
from janusgraph_tpu.storage.inmemory import InMemoryStoreManager as RefManager
from janusgraph_tpu_torch.core import codecs
from janusgraph_tpu_torch.core.graph import open_graph
from janusgraph_tpu_torch.exceptions import TemporaryBackendError
from janusgraph_tpu_torch.storage import locking
from janusgraph_tpu_torch.storage.inmemory import InMemoryStoreManager

PKGS = {
    "ref": SimpleNamespace(lk=ref_locking, Manager=RefManager, open=ref_open_graph,
                           codecs=ref_codecs, Temporary=RefTemporary),
    "port": SimpleNamespace(lk=locking, Manager=InMemoryStoreManager, open=open_graph,
                            codecs=codecs, Temporary=TemporaryBackendError),
}


@pytest.fixture(params=["ref", "port"])
def pkg(request):
    return PKGS[request.param]


def make_locker(pkg, mgr, rid, mediator=None, **kw):
    store = mgr.open_database("test_lock_")
    return pkg.lk.ConsistentKeyLocker(
        store, mgr.begin_transaction, rid, mediator or pkg.lk.LocalLockMediator(),
        wait_ms=0.0, **kw,
    )


def test_locking_errors_sit_in_the_backend_taxonomy(pkg):
    assert issubclass(pkg.lk.TemporaryLockingError, pkg.Temporary)
    assert not issubclass(pkg.lk.PermanentLockingError, pkg.Temporary)


def test_mediator_claim_release(pkg):
    med = pkg.lk.LocalLockMediator()
    t = pkg.lk.KeyColumn(b"k", b"c")
    assert med.claim(t, "tx1", expiry=1e12)
    assert not med.claim(t, "tx2", expiry=1e12)
    assert med.claim(t, "tx1", expiry=1e12)  # re-entrant
    med.release(t, "tx2")  # not the holder: no-op
    assert not med.claim(t, "tx2", expiry=1e12)
    med.release(t, "tx1")
    assert med.claim(t, "tx2", expiry=1e12)
    # an expired claim is stealable
    t2 = pkg.lk.KeyColumn(b"k", b"d")
    assert med.claim(t2, "tx1", expiry=0.0)
    assert med.claim(t2, "tx2", expiry=1e12)


def test_single_holder_wins_and_releases(pkg):
    mgr = pkg.Manager()
    lk = make_locker(pkg, mgr, b"rid1")
    t = pkg.lk.KeyColumn(b"key", b"col")
    lk.write_lock(t, "tx1")
    lk.check_locks("tx1")
    assert lk.held_by("tx1") == [t]
    lk.delete_locks("tx1")
    assert lk.held_by("tx1") == []
    lk.write_lock(t, "tx2")
    lk.check_locks("tx2")
    lk.delete_locks("tx2")
    assert not mgr.open_database("test_lock_")._rows  # every claim deleted


def test_local_contention_fails_fast(pkg):
    mgr = pkg.Manager()
    lk = make_locker(pkg, mgr, b"rid1")
    t = pkg.lk.KeyColumn(b"key", b"col")
    lk.write_lock(t, "tx1")
    with pytest.raises(pkg.lk.TemporaryLockingError, match="local lock"):
        lk.write_lock(t, "tx2")
    lk.delete_locks("tx1")


def test_cross_process_race_first_claim_wins(pkg):
    """Two lockers with different mediators (two processes) share the lock
    store; the earlier claim wins the re-read and the loser's claim goes."""
    mgr = pkg.Manager()
    a = make_locker(pkg, mgr, b"rid_a")
    b = make_locker(pkg, mgr, b"rid_b")
    t = pkg.lk.KeyColumn(b"key", b"col")
    a.write_lock(t, "txA")
    b.write_lock(t, "txB")
    a.check_locks("txA")
    with pytest.raises(pkg.lk.TemporaryLockingError, match="lost lock race"):
        b.check_locks("txB")
    a.delete_locks("txA")
    b.delete_locks("txB")
    c = make_locker(pkg, mgr, b"rid_c")
    c.write_lock(t, "txC")
    c.check_locks("txC")
    c.delete_locks("txC")


def test_expired_remote_claim_ignored(pkg):
    mgr = pkg.Manager()
    a = make_locker(pkg, mgr, b"rid_a", expiry_ms=50.0)
    b = make_locker(pkg, mgr, b"rid_b", expiry_ms=50.0, clean_expired=True)
    t = pkg.lk.KeyColumn(b"key", b"col")
    a.write_lock(t, "txA")
    time.sleep(0.1)
    b.write_lock(t, "txB")
    b.check_locks("txB")  # a's claim is expired: b wins, and cleans it
    row = pkg.lk.lock_row_key(t)
    assert len(mgr.open_database("test_lock_")._rows[row].columns) == 1
    b.delete_locks("txB")
    a.delete_locks("txA")


def test_expected_values(pkg):
    mgr = pkg.Manager()
    lk = make_locker(pkg, mgr, b"rid1")
    t = pkg.lk.KeyColumn(b"key", b"col")
    lk.write_lock(t, "tx1", expected=[(b"col", b"v1")])
    lk.check_locks("tx1")
    lk.check_expected_values("tx1", lambda _t: [(b"col", b"v1")])
    with pytest.raises(pkg.lk.PermanentLockingError, match="expected value"):
        lk.check_expected_values("tx1", lambda _t: [(b"col", b"CHANGED")])
    lk.delete_locks("tx1")


@pytest.mark.parametrize("who", ["same_tx", "other_tx"])
def test_expired_lease_raises_and_is_reacquirable(pkg, who):
    mgr = pkg.Manager()
    skew = [0]
    lk = make_locker(pkg, mgr, b"rid1", clock_ns=lambda: time.time_ns() + skew[0])
    t = pkg.lk.KeyColumn(b"k", b"c")
    lk.write_lock(t, "tx1")
    skew[0] = 3_600 * 10**9  # the check sees the claim as an hour old
    with pytest.raises(pkg.lk.TemporaryLockingError, match="lease expired"):
        lk.check_locks("tx1")
    skew[0] = 0
    holder = "tx1" if who == "same_tx" else "tx2"
    lk.write_lock(t, holder)
    lk.check_locks(holder)
    lk.delete_locks(holder)


def _locked_graph(pkg):
    mgr = pkg.Manager()
    cfg = {"ids.authority-wait-ms": 0.0, "locks.wait-ms": 0.0}
    g1 = pkg.open(dict(cfg), store_manager=mgr)
    g1.management().make_property_key("serial", int)
    g1.management().set_consistency("serial", pkg.codecs.Consistency.LOCK)
    tx = g1.new_transaction()
    v = tx.add_vertex()
    v.property("serial", 1)
    tx.commit()
    g2 = pkg.open(dict(cfg), store_manager=mgr)
    return g1, g2, v.id


def test_graph_lock_contention_raises_temporary_locking_error(pkg):
    """Two graphs over one store share its in-process mediator: while one
    commit holds the claim on a LOCK cell (its check waits), the other's
    claim fails fast, and a retry after it succeeds."""
    g1, g2, vid = _locked_graph(pkg)
    g1.backend.edge_locker.wait_ms = 400.0
    tx1, tx2 = g1.new_transaction(), g2.new_transaction()
    tx1.get_vertex(vid).property("serial", 2)
    tx2.get_vertex(vid).property("serial", 3)
    done = []
    holder = threading.Thread(target=lambda: (tx1.commit(), done.append("tx1")))
    holder.start()
    time.sleep(0.15)
    with pytest.raises(pkg.lk.TemporaryLockingError, match="local lock contention"):
        tx2.commit()
    holder.join(timeout=30)
    assert done == ["tx1"]
    # g2's slice cache still holds the row it read before tx1's commit: a
    # write from that stale read fails the expected-value check against
    # the store, and one after the caches are dropped commits
    stale = g2.new_transaction()
    stale.get_vertex(vid).property("serial", 5)
    with pytest.raises(pkg.lk.PermanentLockingError, match="expected value"):
        stale.commit()
    g2.backend.clear_caches()
    tx3 = g2.new_transaction()
    tx3.get_vertex(vid).property("serial", 4)
    tx3.commit()
    assert g1.new_transaction().get_vertex(vid).value("serial") == 4
    assert not g1.backend.manager.open_database("edgestore_lock_")._rows
    g1.close()
    g2.close()
