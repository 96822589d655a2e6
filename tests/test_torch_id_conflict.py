"""The port's id authority under the conflict-avoidance modes, held to the
JAX package's (after the reference's ``tests/test_ids.py`` conflict cases
and ``tests/test_backend.py``'s concurrent authorities).

A tagged authority claims under its partition key plus a two-byte tag and
owns the block stripe ``local * num_tags + tag``: for the same tag, uid and
claim clock, the port writes the reference's claim rows byte for byte and
hands out the reference's blocks. Over a port storage server, authorities
with distinct tags allocate concurrently from six threads and their blocks
are disjoint by construction. The untagged mode is held over the server
sequentially: its concurrent case depends on the claim wait outlasting the
wire's write latency, and the reference's own concurrent case over a
remote store fails under the test runner's parallel load (ROADMAP Queue C
#3). Exact equality throughout."""

import threading
import time
import types

import pytest

from janusgraph_tpu.storage import idauthority as ref_ida
from janusgraph_tpu.storage.inmemory import InMemoryStoreManager as RefInMemory
from janusgraph_tpu_torch.core.graph import open_graph
from janusgraph_tpu_torch.storage import idauthority as ida
from janusgraph_tpu_torch.storage.inmemory import InMemoryStoreManager
from janusgraph_tpu_torch.storage.remote import RemoteStoreManager, RemoteStoreServer


@pytest.fixture
def server():
    srv = RemoteStoreServer(InMemoryStoreManager()).start()
    yield srv
    srv.stop()


def _claims(mod, mem_cls, mode, tag, bits, monkeypatch):
    """Blocks and id-store rows of three authorities (uids 1..3, one tag
    each for the tagged modes) under a deterministic claim clock."""
    # the claim clock of this module's authorities, on this thread only:
    # threads other tests left running keep the real clock
    clock = iter(range(10**9, 10**9 + 10_000))
    me = threading.get_ident()
    fake = types.SimpleNamespace(
        time_ns=lambda: next(clock) if threading.get_ident() == me else time.time_ns(),
        sleep=time.sleep)
    monkeypatch.setattr(mod, "time", fake)
    mgr = mem_cls()
    store, txh = mgr.open_database("janusgraph_ids"), mgr.begin_transaction()
    blocks = []
    for i, t in enumerate((tag, (tag + 1) % (1 << bits), (tag + 3) % (1 << bits))):
        auth = mod.ConsistentKeyIDAuthority(
            store, txh, block_size=100, uid=bytes([i + 1]) * 16, wait_ms=0.0,
            conflict_mode=mod.ConflictAvoidanceMode(mode), conflict_tag=t,
            conflict_tag_bits=bits,
        )
        for ns, part in ((0, 0), (0, 5), (1, 0), (0, 0)):
            b = auth.get_id_block(ns, part)
            blocks.append((b.start, b.size))
    rows = {k: list(zip(r.columns, r.values)) for k, r in store._rows.items()}
    return blocks, rows


@pytest.mark.parametrize("mode", ["none", "local_manual", "global_manual"])
@pytest.mark.parametrize("tag,bits", [(0, 2), (3, 2), (5, 4)])
def test_tagged_claim_rows_equal_the_reference(monkeypatch, mode, tag, bits):
    mine = _claims(ida, InMemoryStoreManager, mode, tag, bits, monkeypatch)
    ref = _claims(ref_ida, RefInMemory, mode, tag, bits, monkeypatch)
    assert mine == ref
    blocks, rows = mine
    starts = [s for s, _n in blocks]
    if mode != "none":
        # every tag's key carries the tag, and its blocks sit in its stripe
        assert all(len(k) in (5 + 2, len(b"\x00block_size")) for k in rows)
        assert all(((s - 1) // 100) % (1 << bits) in
                   (tag, (tag + 1) % (1 << bits), (tag + 3) % (1 << bits)) for s in starts)


def test_tag_outside_its_bits_is_refused():
    mgr = InMemoryStoreManager()
    store, txh = mgr.open_database("janusgraph_ids"), mgr.begin_transaction()
    with pytest.raises(ValueError, match="outside"):
        ida.ConsistentKeyIDAuthority(store, txh, conflict_mode=ida.ConflictAvoidanceMode(
            "local_manual"), conflict_tag=4, conflict_tag_bits=2)
    auto = ida.ConsistentKeyIDAuthority(
        store, txh, conflict_mode=ida.ConflictAvoidanceMode.GLOBAL_AUTO, conflict_tag_bits=3)
    assert auto.num_tags == 8 and 0 <= auto.tag < 8


def _disjoint(blocks):
    ids = set()
    for start, size in blocks:
        rng = set(range(start, start + size))
        assert not (ids & rng), "overlapping id blocks allocated"
        ids |= rng
    return len(ids)


@pytest.mark.parametrize("mode", ["local_manual", "global_manual"])
def test_tagged_authorities_concurrent_over_remote(server, mode):
    """Six instances, one client and one distinct tag each, claim blocks
    concurrently over the wire with the default claim wait: disjoint."""
    n_threads, per_thread = 6, 8
    out, errs = [], []
    lock = threading.Lock()

    def worker(i):
        client = RemoteStoreManager(*server.address)
        try:
            auth = ida.ConsistentKeyIDAuthority(
                client.open_database("janusgraph_ids"), client.begin_transaction(),
                block_size=50, uid=bytes([i + 1]) * 16,
                conflict_mode=ida.ConflictAvoidanceMode(mode), conflict_tag=i,
                conflict_tag_bits=3,
            )
            got = [auth.get_id_block(0, 3) for _ in range(per_thread)]
            with lock:
                out.extend((b.start, b.size) for b in got)
        except Exception as e:  # noqa: BLE001 - surfaced below
            errs.append(e)
        finally:
            client.close()

    ts = [threading.Thread(target=worker, args=(i,)) for i in range(n_threads)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(60.0)
    assert errs == []
    assert _disjoint(out) == n_threads * per_thread * 50


def test_untagged_authorities_take_turns_over_remote(server):
    """Three instances in the default mode, each over its own client,
    claiming in turn: every block starts where the last one ended."""
    clients = [RemoteStoreManager(*server.address) for _ in range(3)]
    try:
        auths = [ida.ConsistentKeyIDAuthority(
            c.open_database("janusgraph_ids"), c.begin_transaction(), block_size=50,
            uid=bytes([i + 1]) * 16) for i, c in enumerate(clients)]
        blocks = [(b.start, b.size) for _ in range(4) for a in auths
                  for b in [a.get_id_block(0, 3)]]
        assert blocks == [(1 + 50 * i, 50) for i in range(12)]
    finally:
        for c in clients:
            c.close()


def test_conflict_avoidance_config_wires_through(server):
    """The graph builds its authority from ids.authority.conflict-avoidance-*;
    two graphs with distinct manual tags over one server write vertices
    whose ids never collide, and every striped id resolves back."""
    g = open_graph({"ids.authority.conflict-avoidance-mode": "global_auto",
                    "ids.authority.conflict-avoidance-tag-bits": 3})
    auth = g.backend.id_authority
    assert auth.conflict_mode is ida.ConflictAvoidanceMode.GLOBAL_AUTO
    assert auth.num_tags == 8 and 0 <= auth.tag < 8
    g.close()
    host, port = server.address
    graphs = [open_graph({"storage.backend": "remote", "storage.hostname": host,
                          "storage.port": port, "ids.block-size": 20,
                          "ids.authority.conflict-avoidance-mode": "local_manual",
                          "ids.authority.conflict-avoidance-tag": t}) for t in (1, 6)]
    try:
        ids = []
        for g in graphs:
            tx = g.new_transaction()
            vs = [tx.add_vertex(name=f"t{g.backend.id_authority.tag}-{i}") for i in range(50)]
            tx.commit()
            ids.append([v.id for v in vs])
            assert g.backend.id_authority.tag in (1, 6)
        assert not set(ids[0]) & set(ids[1])
        tx = graphs[0].new_transaction()
        assert all(tx.get_vertex(v) is not None for v in ids[0] + ids[1])
        tx.rollback()
    finally:
        for g in graphs:
            g.close()
