"""The port's pipelined wire framing (``storage/pipeline.py``) held to the
JAX package's (after the reference's ``tests/test_pipeline.py``).

Twinned here: the negotiation and a pipelined round trip, the feature-bit
compatibility matrix, an old client against a new server, a pipelined
frame against an old server (unknown op), out-of-order completion on one
connection, coalesced ops merged and demuxed per op, threaded correctness
with coalescing, the per-op deadline (server side, behind a slow sibling)
and the deadline spent in the send queue (client side), connection loss
and recovery, the adaptive gate keeping sequential callers on the sync
path, the trace and ledger attributed per pipelined op, a serving-node
fault that fails only its own op with the breaker counting it once, and
the negotiation fallback's flight event. Beside them: the coalescing
encoder's frames (merged getSliceMulti, merged mutateMany, the batch
carrier) are byte-equal to the reference's for the same queued ops, a port
client pipelines against the reference's server, and the health block is
the reference's function of the same snapshot.

The remote index provider's cases are twinned too: its pipelined
queries and fourth capability byte, and an old-featured index server
that negotiates the pipeline off. The serving-node fault runs a second
time with the fault injector (``storage/faults.py``) in place of the hook
store.

Not twinned: the health endpoint and the driver's multiplexed web socket
(the server and the driver, ROADMAP Queue A #5.6), and the two load-sensitive
timing cases (the gate engaging under simulated storage latency and the
pipelined-beats-sync wall ratio), whose reference versions fail under the
test runner's parallel workers (ROADMAP Queue C #3): the tests here hold
results and counters, never wall-time ratios.
"""

import socket
import struct
import threading
import time

import pytest

from janusgraph_tpu.storage import pipeline as ref_pipeline
from janusgraph_tpu.storage import remote as ref_remote
from janusgraph_tpu.storage.inmemory import InMemoryStoreManager as RefInMemory
from janusgraph_tpu_torch.exceptions import (
    CircuitOpenError,
    DeadlineExceededError,
    PermanentBackendError,
    TemporaryBackendError,
)
from janusgraph_tpu_torch.observability import flight_recorder, registry, tracer
from janusgraph_tpu_torch.observability.profiler import ledger_scope
from janusgraph_tpu_torch.storage import pipeline, remote
from janusgraph_tpu_torch.storage.inmemory import InMemoryStoreManager
from janusgraph_tpu_torch.storage.kcvs import KeySliceQuery, SliceQuery
from janusgraph_tpu_torch.storage.pipeline import PIPELINE_FLAG, OpFuture, WireOp, _Entry
from janusgraph_tpu_torch.storage.remote import (
    _DEADLINE_FLAG,
    _OP_BATCH,
    _OP_GET_SLICE,
    _OP_MUTATE,
    _OP_SCAN_ALL,
    RemoteStoreManager,
    RemoteStoreServer,
    _decode_entries,
    _Reader,
    encode_deadline_prefix,
)


def _force_pipeline(mgr):
    """Bypass the adaptive gate: route every eligible op pipelined."""
    mgr._should_pipeline = lambda: True
    return mgr


class _HookStore:
    """Store wrapper calling a hook before every read and write (blocking or
    failing faults at the serving node)."""

    def __init__(self, inner, hook):
        self._inner = inner
        self._hook = hook

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def get_slice(self, query, txh):
        self._hook(query.key)
        return self._inner.get_slice(query, txh)

    def get_slice_multi(self, keys, sq, txh):
        self._hook(keys[0] if keys else b"")
        return self._inner.get_slice_multi(keys, sq, txh)

    def mutate(self, key, adds, dels, txh):
        self._hook(key)
        return self._inner.mutate(key, adds, dels, txh)


class _HookManager:
    def __init__(self, inner, hook):
        self._inner = inner
        self._hook = hook

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def open_database(self, name):
        return _HookStore(self._inner.open_database(name), self._hook)


def _gs_body(store: str, key: bytes) -> bytes:
    sb = store.encode()
    return b"".join([
        struct.pack(">I", len(sb)) + sb,
        struct.pack(">I", len(key)) + key,
        struct.pack(">I", 0) + struct.pack(">I", 0) + struct.pack(">i", -1),
    ])


def _recv_frame(sock):
    head = b""
    while len(head) < 5:
        chunk = sock.recv(5 - len(head))
        assert chunk
        head += chunk
    (blen,) = struct.unpack(">I", head[:4])
    payload = b""
    while len(payload) < blen:
        chunk = sock.recv(blen - len(payload))
        assert chunk
        payload += chunk
    return head[4], payload


@pytest.fixture
def servers():
    """``start(cls, manager, **kw)`` starts a server; all stop at teardown."""
    started = []

    def start(cls, manager, **kw):
        srv = cls(manager, **kw).start()
        started.append(srv)
        return srv

    yield start
    for srv in started:
        srv.stop()


def _raw_sock(server):
    sock = socket.create_connection(server.address, timeout=10.0)
    sock.settimeout(10.0)
    return sock


def _count(name):
    return registry.snapshot().get(name, {}).get("count", 0)


# ----------------------------------------------------------- basic contract

@pytest.mark.parametrize("server_cls", [RemoteStoreServer, ref_remote.RemoteStoreServer],
                         ids=["port_server", "ref_server"])
def test_negotiation_and_pipelined_roundtrip(servers, server_cls):
    mem = InMemoryStoreManager() if server_cls is RemoteStoreServer else RefInMemory()
    server = servers(server_cls, mem)
    mgr = _force_pipeline(RemoteStoreManager(*server.address))
    try:
        ops0 = _count("storage.remote.pipeline.ops")
        store = mgr.open_database("edgestore")
        store.mutate(b"k", [(b"a", b"1")], [], None)
        assert mgr._remote_pipeline is True
        got = store.get_slice(KeySliceQuery(b"k", SliceQuery(b"", None)), None)
        assert got == [(b"a", b"1")]
        assert mgr._mux is not None and mgr._mux._conns[0]._epoch is not None
        mgr._mux.flush_stats()
        assert _count("storage.remote.pipeline.ops") - ops0 >= 2
    finally:
        mgr.close()


@pytest.mark.parametrize("trace", [True, False])
@pytest.mark.parametrize("ledger", [True, False])
@pytest.mark.parametrize("deadline", [True, False])
@pytest.mark.parametrize("pipelined", [True, False])
def test_wire_compat_matrix(servers, trace, ledger, deadline, pipelined):
    """The client against every server feature-bit combination: the op
    stream stays compatible, each capability negotiates independently, and
    un-negotiated bits are never sent."""
    from janusgraph_tpu_torch.core.deadline import deadline_scope

    server = servers(RemoteStoreServer, InMemoryStoreManager(), trace_propagation=trace,
                     ledger_echo=ledger, deadline_propagation=deadline, pipeline=pipelined)
    mgr = _force_pipeline(RemoteStoreManager(*server.address))
    try:
        store = mgr.open_database("edgestore")
        with tracer.span("compat.root"):
            with ledger_scope():
                with deadline_scope(5_000.0):
                    store.mutate(b"k", [(b"a", b"1")], [], None)
                    got = store.get_slice(KeySliceQuery(b"k", SliceQuery(b"", None)), None)
        assert got == [(b"a", b"1")]
        assert mgr._remote_trace is trace
        assert mgr._remote_ledger is ledger
        assert mgr._remote_deadline is deadline
        assert mgr._remote_pipeline is pipelined
    finally:
        mgr.close()


def test_old_client_against_new_server(servers):
    """A pipeline-disabled client (the frames of a pre-pipeline client)
    interoperates with a new server."""
    server = servers(RemoteStoreServer, InMemoryStoreManager())
    mgr = RemoteStoreManager(*server.address, pipeline=False)
    try:
        store = mgr.open_database("edgestore")
        store.mutate(b"k", [(b"a", b"1")], [], None)
        got = store.get_slice(KeySliceQuery(b"k", SliceQuery(b"", None)), None)
        assert got == [(b"a", b"1")]
        assert mgr._mux is None  # the mux never engaged
    finally:
        mgr.close()


@pytest.mark.parametrize("server_cls", [RemoteStoreServer, ref_remote.RemoteStoreServer],
                         ids=["port_server", "ref_server"])
def test_pipelined_frame_against_old_server_is_unknown_op(servers, server_cls):
    """A 0x10-flagged frame against a pipeline=False server behaves as a
    real old server: unknown op, permanent, in the old framing; the two
    packages' servers answer with the same bytes."""
    mem = InMemoryStoreManager() if server_cls is RemoteStoreServer else RefInMemory()
    server = servers(server_cls, mem, pipeline=False)
    sock = _raw_sock(server)
    try:
        body = struct.pack(">I", 1) + _gs_body("edgestore", b"k")
        sock.sendall(struct.pack(">IB", len(body), _OP_GET_SLICE | PIPELINE_FLAG) + body)
        status, payload = _recv_frame(sock)
        assert status == 2  # permanent, unflagged (old framing)
        assert payload == b"PermanentBackendError: unknown op 18"
    finally:
        sock.close()


# ------------------------------------------------- out-of-order completion

def test_out_of_order_completion_on_one_connection(servers):
    """A batch carrier's sub-ops complete out of order: the fast op's
    response (by request id) arrives while the slow sibling is blocked."""
    release = threading.Event()
    entered = threading.Event()

    def hook(key):
        if key == b"slow":
            entered.set()
            assert release.wait(5.0)

    server = servers(RemoteStoreServer, _HookManager(InMemoryStoreManager(), hook),
                     pipeline_workers=4)
    sock = _raw_sock(server)
    try:
        subs = []
        for rid, key in ((1, b"slow"), (2, b"fast")):
            sub_body = struct.pack(">I", rid) + _gs_body("edgestore", key)
            subs.append(struct.pack(">IB", len(sub_body), _OP_GET_SLICE | PIPELINE_FLAG)
                        + sub_body)
        body = struct.pack(">I", len(subs)) + b"".join(subs)
        sock.sendall(struct.pack(">IB", len(body), _OP_BATCH | PIPELINE_FLAG) + body)
        status, payload = _recv_frame(sock)
        assert status & PIPELINE_FLAG
        (rid,) = struct.unpack_from(">I", payload, 0)
        assert rid == 2, "fast op must complete before the blocked one"
        assert entered.is_set()
        release.set()
        status, payload = _recv_frame(sock)
        (rid,) = struct.unpack_from(">I", payload, 0)
        assert rid == 1
    finally:
        release.set()
        sock.close()


# ----------------------------------------------------------------- merging

def test_coalesced_ops_merge_and_demux_per_op(servers):
    """Same-slice getSlice ops queued together merge into ONE getSliceMulti
    wire frame; each caller still gets exactly its own key's entries."""
    server = servers(RemoteStoreServer, InMemoryStoreManager())
    mgr = _force_pipeline(RemoteStoreManager(*server.address))
    try:
        store = mgr.open_database("edgestore")
        for i in range(6):
            store.mutate(f"k{i}".encode(), [(b"c", str(i).encode())], [], None)
        merged0 = _count("storage.remote.pipeline.merged_ops")
        conn = mgr._mux._conns[0]
        ep = conn._epoch
        sl = struct.pack(">I", 0) + struct.pack(">I", 0) + struct.pack(">i", -1)
        entries = []
        for i in range(4):
            key = f"k{i}".encode()
            item = WireOp(_OP_GET_SLICE, 0, b"", _gs_body("edgestore", key),
                          merge=("gs", "edgestore", key, sl))
            entries.append(_Entry(item, OpFuture()))
        buf, nops = conn._encode_batch(ep, entries)
        assert nops == 4
        assert buf[4] & ~0xF0 == 3  # ONE merged getSliceMulti, not a carrier
        ep.sock.sendall(buf)
        deadline = time.monotonic() + 5.0
        while any(not e.fut.done() for e in entries):
            assert time.monotonic() < deadline
            conn._recv_one(ep)  # drive the receive loop ourselves
        for i, e in enumerate(entries):
            payload, fields = e.fut.result(1.0)
            assert _decode_entries(_Reader(payload)) == [(b"c", str(i).encode())]
            assert fields is None  # merged ops count client-side
        mgr._mux.flush_stats()
        assert _count("storage.remote.pipeline.merged_ops") - merged0 >= 4
    finally:
        mgr.close()


class _NoSock:
    def sendall(self, _data):
        raise AssertionError("the encoder must not write")


def _batch(mod_pipeline, mod_remote):
    """The same queued batch in either package: four same-slice getSlice
    ops (one key twice), three mutates with a repeated key, an unmergeable
    scan op and a single getSlice of another slice, two ops with a spent
    and a live deadline."""
    sl = struct.pack(">I", 0) + struct.pack(">I", 0) + struct.pack(">i", -1)
    sl2 = struct.pack(">I", 1) + b"a" + struct.pack(">I", 0) + struct.pack(">i", 3)
    items = []
    for key in (b"k0", b"k1", b"k0", b"k2"):
        items.append(mod_pipeline.WireOp(mod_remote._OP_GET_SLICE, 0, b"",
                                         _gs_body("edgestore", key),
                                         merge=("gs", "edgestore", key, sl)))
    for key in (b"m0", b"m1", b"m0"):
        row = (struct.pack(">I", len(key)) + key + struct.pack(">I", 1)
               + struct.pack(">I", 1) + b"c" + struct.pack(">I", 1) + b"v"
               + struct.pack(">Q", 0) + struct.pack(">I", 0))
        items.append(mod_pipeline.WireOp(
            mod_remote._OP_MUTATE, 0, b"", struct.pack(">I", 9) + b"edgestore" + row,
            merge=("mu", "edgestore", key, row)))
    items.append(mod_pipeline.WireOp(mod_remote._OP_SCAN_ALL, 0, b"", b"scan-body"))
    items.append(mod_pipeline.WireOp(mod_remote._OP_GET_SLICE, 0, b"", b"other",
                                     merge=("gs", "edgestore", b"k9", sl2)))
    items.append(mod_pipeline.WireOp(mod_remote._OP_GET_SLICE, mod_remote._DEADLINE_FLAG,
                                     b"", b"spent", expires_at=time.monotonic() - 1.0))
    return [mod_pipeline._Entry(it, mod_pipeline.OpFuture()) for it in items]


def test_coalescing_encoder_frames_equal_the_reference():
    """The flat combiner's encoder turns the same queued ops into the same
    wire bytes as the reference's: merged getSliceMulti, mutateMany groups
    split at a repeated key, singles, all inside one batch carrier with the
    same request ids; the op whose deadline is spent is refused in both."""
    out, spent = [], []
    for mod_pipeline, mod_remote in ((pipeline, remote), (ref_pipeline, ref_remote)):
        conn = mod_pipeline.PipelinedConnection("127.0.0.1", 1, 0,
                                                batch_op=mod_remote._OP_BATCH)
        ep = mod_pipeline._Epoch(_NoSock(), 64)
        entries = _batch(mod_pipeline, mod_remote)
        buf, nops = conn._encode_batch(ep, entries)
        out.append((buf, nops, sorted(ep.pending)))
        spent.append(entries[-1].fut)
    assert out[0] == out[1]
    buf, nops, ids = out[0]
    assert buf[4] == _OP_BATCH | PIPELINE_FLAG and nops == 9 and ids == list(range(1, 6))
    with pytest.raises(DeadlineExceededError):
        spent[0].result(0.0)


def test_threaded_pipelined_correctness_and_coalescing(servers):
    """16 threads of mixed reads and writes over the pipelined path: every
    op's result is exact, and the wire carried no more frames than ops."""
    server = servers(RemoteStoreServer, InMemoryStoreManager())
    mgr = _force_pipeline(RemoteStoreManager(*server.address))
    errs = []
    ops0 = _count("storage.remote.pipeline.ops")
    frames0 = _count("storage.remote.pipeline.wire_frames")

    def worker(i):
        try:
            store = mgr.open_database("edgestore")
            for j in range(40):
                k = f"w{i}-{j:02d}".encode()
                store.mutate(k, [(b"c", str(j).encode())], [], None)
                got = store.get_slice(KeySliceQuery(k, SliceQuery(b"", None)), None)
                assert got == [(b"c", str(j).encode())], got
        except Exception as e:  # noqa: BLE001 - surfaced via errs
            errs.append(e)

    try:
        threads = [threading.Thread(target=worker, args=(i,)) for i in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60.0)
        assert errs == []
        mgr._mux.flush_stats()
        ops = _count("storage.remote.pipeline.ops") - ops0
        frames = _count("storage.remote.pipeline.wire_frames") - frames0
        assert ops >= 16 * 40 * 2
        assert frames <= ops
    finally:
        mgr.close()


# ------------------------------------------------------------- deadlines

def test_per_op_deadline_expiry_mid_pipeline(servers):
    """An op whose budget is spent while a slow sibling holds the server's
    single pipeline worker is refused with a permanent deadline error; the
    sibling completes."""
    release = threading.Event()

    def hook(key):
        if key == b"slow":
            assert release.wait(5.0)

    server = servers(RemoteStoreServer, _HookManager(InMemoryStoreManager(), hook),
                     pipeline_workers=1)
    sock = _raw_sock(server)
    try:
        sub1 = struct.pack(">I", 1) + _gs_body("edgestore", b"slow")
        sub2 = (struct.pack(">I", 2) + encode_deadline_prefix(80.0)
                + _gs_body("edgestore", b"fast"))
        subs = [
            struct.pack(">IB", len(sub1), _OP_GET_SLICE | PIPELINE_FLAG) + sub1,
            struct.pack(">IB", len(sub2), _OP_GET_SLICE | _DEADLINE_FLAG | PIPELINE_FLAG)
            + sub2,
        ]
        body = struct.pack(">I", 2) + b"".join(subs)
        sock.sendall(struct.pack(">IB", len(body), _OP_BATCH | PIPELINE_FLAG) + body)
        time.sleep(0.3)
        release.set()
        replies = {}
        for _ in range(2):
            status, payload = _recv_frame(sock)
            (rid,) = struct.unpack_from(">I", payload, 0)
            replies[rid] = (status & 0x0F, payload[4:])
        assert replies[1][0] == 0  # the slow sibling completed OK
        assert replies[2][0] == 2  # permanent: never replayed
        assert replies[2][1].startswith(b"DeadlineExceededError: ")
    finally:
        release.set()
        sock.close()


def test_deadline_expired_in_send_queue_client_side(servers):
    """An op whose deadline lapses before the pipelined send is refused
    client-side (counter + DeadlineExceededError), no wire dispatch."""
    server = servers(RemoteStoreServer, InMemoryStoreManager())
    mgr = _force_pipeline(RemoteStoreManager(*server.address))
    try:
        mux = mgr._mux_for(_OP_GET_SLICE)
        expired0 = _count("storage.remote.pipeline.expired_in_queue")
        item = WireOp(_OP_GET_SLICE, _DEADLINE_FLAG, b"", _gs_body("edgestore", b"k"),
                      expires_at=time.monotonic() - 0.001)
        fut = mux.submit(item)
        with pytest.raises(DeadlineExceededError):
            fut.result(2.0)
        assert _count("storage.remote.pipeline.expired_in_queue") == expired0 + 1
    finally:
        mgr.close()


# ------------------------------------------------------ faults and breaker

def test_fault_mid_pipeline_fails_only_its_op_and_breaker_counts_one(servers):
    """A serving-node fault on one in-flight op: the siblings complete, the
    failed op surfaces its own error, and the client breaker counts exactly
    that op (stays CLOSED below threshold); consecutive bad ops trip it."""
    from janusgraph_tpu_torch.storage.circuit import CLOSED, OPEN

    def hook(key):
        if key == b"bad":
            raise TemporaryBackendError("injected serving-node fault")

    server = servers(RemoteStoreServer, _HookManager(InMemoryStoreManager(), hook))
    mgr = _force_pipeline(RemoteStoreManager(
        *server.address, max_attempts=1, retry_time_s=0.2, breaker_enabled=True,
        breaker_failure_threshold=2, breaker_reset_ms=10_000.0,
    ))
    try:
        store = mgr.open_database("edgestore")
        store.mutate(b"good", [(b"a", b"1")], [], None)
        results = {}

        def read(key):
            try:
                results[key] = store.get_slice(KeySliceQuery(key, SliceQuery(b"", None)), None)
            except Exception as e:  # noqa: BLE001 - asserted below
                results[key] = e

        threads = [threading.Thread(target=read, args=(k,)) for k in (b"good", b"bad", b"good")]
        for t in threads:
            t.start()
        for t in threads:
            t.join(30.0)
        assert results[b"good"] == [(b"a", b"1")]
        assert isinstance(results[b"bad"], TemporaryBackendError)
        assert mgr.breaker.state == CLOSED
        for _ in range(2):
            with pytest.raises((TemporaryBackendError, CircuitOpenError, PermanentBackendError)):
                store.get_slice(KeySliceQuery(b"bad", SliceQuery(b"", None)), None)
        assert mgr.breaker.state == OPEN
        with pytest.raises(CircuitOpenError):
            store.get_slice(KeySliceQuery(b"good", SliceQuery(b"", None)), None)
    finally:
        mgr.close()


def test_injected_fault_mid_pipeline_fails_only_its_op_and_breaker_counts_one(servers):
    """The serving-node fault above, injected by a ``FaultInjectingStoreManager``
    at the server: every read of the faulted store fails, the sibling reads
    of a clean store complete, and the breaker counts the failed op once."""
    from janusgraph_tpu_torch.storage.circuit import CLOSED, OPEN
    from janusgraph_tpu_torch.storage.faults import FaultInjectingStoreManager, FaultPlan

    plan = FaultPlan(seed=5, read_error_rate=1.0, stores=("faulted",))
    server = servers(RemoteStoreServer, FaultInjectingStoreManager(InMemoryStoreManager(), plan))
    mgr = _force_pipeline(RemoteStoreManager(
        *server.address, max_attempts=1, retry_time_s=0.2, breaker_enabled=True,
        breaker_failure_threshold=2, breaker_reset_ms=10_000.0,
    ))
    try:
        good, bad = mgr.open_database("edgestore"), mgr.open_database("faulted")
        good.mutate(b"k", [(b"a", b"1")], [], None)
        results = {}

        def read(name, store):
            try:
                results[name] = store.get_slice(KeySliceQuery(b"k", SliceQuery(b"", None)), None)
            except Exception as e:  # noqa: BLE001 - asserted below
                results[name] = e

        threads = [threading.Thread(target=read, args=a)
                   for a in (("good1", good), ("bad", bad), ("good2", good))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(30.0)
        assert results["good1"] == results["good2"] == [(b"a", b"1")]
        assert isinstance(results["bad"], TemporaryBackendError)
        assert "injected read fault" in str(results["bad"])
        assert mgr.breaker.state == CLOSED
        for _ in range(2):
            with pytest.raises((TemporaryBackendError, CircuitOpenError, PermanentBackendError)):
                bad.get_slice(KeySliceQuery(b"k", SliceQuery(b"", None)), None)
        assert mgr.breaker.state == OPEN
        assert {e["kind"] for e in plan.journal} == {"read"}
        assert all(e["store"] == "faulted" for e in plan.journal)
    finally:
        mgr.close()


@pytest.mark.parametrize("server_pkg", ["port", "ref"])
def test_index_pipelined_queries_and_capability_byte(server_pkg):
    """The index tier's pipelined idempotent ops: the fourth capability
    byte engages the mux, a query rides it, the ops counter moves. The
    port's client against either package's server."""
    from janusgraph_tpu import indexing as ref_indexing
    from janusgraph_tpu_torch import indexing
    from janusgraph_tpu_torch.core.predicates import predicate_by_name

    server = (indexing if server_pkg == "port" else ref_indexing).RemoteIndexServer(
        (indexing if server_pkg == "port" else ref_indexing).InMemoryIndexProvider()
    ).start()
    host, port = server.address
    client = indexing.RemoteIndexProvider(hostname=host, port=port)
    client._should_pipeline = lambda: True
    try:
        info = indexing.KeyInformation(str, indexing.Mapping.STRING, "SINGLE")
        client.register("vidx", "name", info)
        m = indexing.IndexMutation(is_new=True)
        m.additions.append(indexing.IndexEntry("name", "hercules"))
        client.mutate({"vidx": {"d1": m}}, {"vidx": {"name": info}})
        assert client._remote_pipeline is True
        q = indexing.IndexQuery(
            indexing.PredicateCondition("name", predicate_by_name("eq"), "hercules"))
        assert client.query("vidx", q) == ["d1"]
        client._mux.flush_stats()
        assert registry.snapshot().get("index.remote.pipeline.ops", {}).get("count", 0) >= 1
    finally:
        client.close()
        server.stop()


@pytest.mark.parametrize("server_pkg", ["port", "ref"])
def test_index_old_featured_server_negotiates_pipeline_off(server_pkg):
    from janusgraph_tpu import indexing as ref_indexing
    from janusgraph_tpu_torch import indexing

    ns = indexing if server_pkg == "port" else ref_indexing
    server = ns.RemoteIndexServer(ns.InMemoryIndexProvider(), pipeline=False).start()
    host, port = server.address
    client = indexing.RemoteIndexProvider(hostname=host, port=port)
    try:
        client.features()
        assert client._remote_pipeline is False
        assert client._remote_trace is True
        assert client.exists() in (True, False)  # a plain op is unaffected
    finally:
        client.close()
        server.stop()


def test_connection_loss_fails_inflight_and_recovers(servers):
    """Killing the server fails the in-flight pipelined op with a temporary
    error; the retry guard replays it against the restarted server over a
    fresh epoch."""
    backing = InMemoryStoreManager()
    server = servers(RemoteStoreServer, backing)
    host, port = server.address
    mgr = _force_pipeline(RemoteStoreManager(host, port, retry_time_s=8.0))
    try:
        store = mgr.open_database("edgestore")
        store.mutate(b"k", [(b"a", b"1")], [], None)
        server.stop()

        def restart():
            time.sleep(0.4)
            servers(RemoteStoreServer, backing, host=host, port=port)

        t = threading.Thread(target=restart, daemon=True)
        t.start()
        got = store.get_slice(KeySliceQuery(b"k", SliceQuery(b"", None)), None)
        t.join(10.0)
        assert got == [(b"a", b"1")]
    finally:
        mgr.close()


# ---------------------------------------------------------- adaptive gate

def test_adaptive_gate_keeps_sequential_callers_on_sync_path(servers):
    """A sequential caller never engages the mux (zero extra cost)."""
    server = servers(RemoteStoreServer, InMemoryStoreManager())
    mgr = RemoteStoreManager(*server.address)
    try:
        store = mgr.open_database("edgestore")
        for i in range(20):
            store.mutate(f"k{i}".encode(), [(b"a", b"1")], [], None)
        assert mgr._mux is None  # never engaged
        assert not mgr._should_pipeline()
        assert mgr._calls_active == 0
    finally:
        mgr.close()


def test_gate_reads_concurrency_and_latency(servers):
    """The gate's rule, without timing: it engages only when more callers
    overlap than the pool has connections AND ops are latency-dominated,
    or while the mux has ops in flight."""
    server = servers(RemoteStoreServer, InMemoryStoreManager())
    mgr = RemoteStoreManager(*server.address, pool_size=2)
    try:
        gate = mgr._PIPELINE_LATENCY_GATE_S
        for active, ewma, want in ((3, 2 * gate, True), (2, 2 * gate, False),
                                   (3, gate / 2, False), (0, 0.0, False)):
            mgr._calls_active, mgr._op_ewma_s = active, ewma
            assert mgr._should_pipeline() is want
        mgr._calls_active = 0
        mgr.pipeline = False
        mgr._op_ewma_s = 2 * gate
        assert not mgr._should_pipeline()
    finally:
        mgr.close()


# -------------------------------------------------- observability plumbing

def test_trace_and_ledger_attribute_to_individual_pipelined_ops(servers):
    server = servers(RemoteStoreServer, InMemoryStoreManager())
    mgr = _force_pipeline(RemoteStoreManager(*server.address))
    try:
        store = mgr.open_database("edgestore")
        with tracer.span("pipe.root") as root:
            with ledger_scope() as led:
                store.mutate(b"k", [(b"a", b"12345")], [], None)
                store.get_slice(KeySliceQuery(b"k", SliceQuery(b"", None)), None)
        counts = led.to_dict()
        assert counts.get("cells_read") == 1 and counts.get("cells_written") == 1
        assert counts.get("bytes_read") == 6 and counts.get("bytes_written") == 6
        assert "store.remote" in counts["wall_ms_by_layer"]  # the echo merged
        deadline = time.monotonic() + 2.0
        spans = []
        while time.monotonic() < deadline:
            spans = [s for s in tracer.find_trace(root.trace_id)
                     if s.name.startswith("store.remote.")]
            if len(spans) >= 2:
                break
            time.sleep(0.01)
        assert {s.name for s in spans} == {"store.remote.mutate", "store.remote.getSlice"}
        assert all(s.attrs.get("pipelined") for s in spans)
        assert all(s.parent_span_id == root.span_id for s in spans)
    finally:
        mgr.close()


def test_negotiation_fallback_flight_event(servers):
    flight_recorder.reset()
    server = servers(RemoteStoreServer, InMemoryStoreManager(), pipeline=False)
    mgr = RemoteStoreManager(*server.address)
    mgr._should_pipeline = lambda: True  # want pipelining; the server refuses
    fallbacks0 = _count("storage.remote.pipeline.fallbacks")
    try:
        store = mgr.open_database("edgestore")
        store.mutate(b"k", [(b"a", b"1")], [], None)
        store.mutate(b"k2", [(b"a", b"1")], [], None)
        events = flight_recorder.events("pipeline_fallback")
        assert len(events) == 1 and events[0]["protocol"] == "storage.remote"
        assert _count("storage.remote.pipeline.fallbacks") == fallbacks0 + 1
        assert mgr._mux is None
    finally:
        mgr.close()


def test_pipeline_health_block_is_the_reference_function():
    """The health block over one registry snapshot: the port's function
    gives the reference's block."""
    snap = {
        "storage.remote.pipeline.ops": {"type": "counter", "count": 90},
        "storage.remote.pipeline.wire_frames": {"type": "counter", "count": 40},
        "storage.remote.pipeline.merged_ops": {"type": "counter", "count": 12},
        "storage.remote.pipeline.stalls": {"type": "counter", "count": 1},
        "storage.remote.pipeline.fallbacks": {"type": "counter", "count": 2},
        "storage.remote.pipeline.conn0.in_flight": {"type": "gauge", "value": 3.0},
        "storage.remote.pipeline.conn1.in_flight": {"type": "gauge", "value": 2.0},
        "index.remote.pipeline.ops": {"type": "counter", "count": 5},
        "unrelated.counter": {"type": "counter", "count": 7},
    }
    got = pipeline.pipeline_health_block(snap)
    assert got == ref_pipeline.pipeline_health_block(snap)
    assert got["storage.remote"]["coalesce_ratio"] == 2.25
    assert got["storage.remote"]["in_flight"] == 5.0
    assert pipeline.pipeline_health_block({}) == {}


def test_iter_batch_splits_a_carrier_as_the_reference():
    subs = [(_OP_GET_SLICE | PIPELINE_FLAG, b"\x00\x00\x00\x01abc"),
            (_OP_MUTATE | PIPELINE_FLAG, b""), (_OP_SCAN_ALL | PIPELINE_FLAG, b"x" * 300)]
    body = struct.pack(">I", len(subs)) + b"".join(
        struct.pack(">IB", len(b), raw) + b for raw, b in subs)
    assert list(pipeline.iter_batch(body)) == subs == list(ref_pipeline.iter_batch(body))
