"""The port's remote store held to the JAX package's (after the reference's
``tests/test_remote_store.py``, its multi-node cluster included: the
sharded store behind a server, a node failed and healed over the wire).

The reference's cases run against the port's server and client. Beside
them:

- the frames are byte-equal in both directions: the same calls from each
  package's client put the same bytes on the wire, and each package's
  server answers them with the same bytes;
- a wire-compatibility matrix: the port's client against the reference's
  ``RemoteStoreServer`` and the reference's client against the port's, in
  sync and pipelined framing and with each of the trace, ledger and
  deadline bits negotiated on or off; each does a round trip, a
  multi-slice read, a streamed scan and a mutation, and a negotiated trace
  or ledger shows on the serving side or in the caller's ledger;
- a port graph over a reference server: the Graph of the Gods loaded
  through it writes the rows the port writes to an in-memory store;
- ``load_csr`` over a port server equals ``load_csr`` in memory, and
  PageRank on the CPU over a port server equals the reference's ranks over
  the same server, bit for bit at damping 0.5.

Every server binds port 0 and is stopped by a fixture finaliser or a
``finally``; the cross-process server is terminated in ``finally``; every
socket wait has a timeout. Exact equality throughout.
"""

import re
import socket
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest

from janusgraph_tpu.core.deadline import deadline_scope as ref_deadline_scope
from janusgraph_tpu.core.graph import open_graph as ref_open_graph
from janusgraph_tpu.observability import tracer as ref_tracer
from janusgraph_tpu.observability.profiler import ledger_scope as ref_ledger_scope
from janusgraph_tpu.olap import programs as ref_programs
from janusgraph_tpu.storage import remote as ref_remote
from janusgraph_tpu.storage.inmemory import InMemoryStoreManager as RefInMemory
from janusgraph_tpu.storage.kcvs import KCVMutation as RefKCVMutation
from janusgraph_tpu.storage.kcvs import KeySliceQuery as RefKeySliceQuery
from janusgraph_tpu.storage.kcvs import SliceQuery as RefSliceQuery
from janusgraph_tpu_torch.core import gods
from janusgraph_tpu_torch.core.bulk import bulk_add_edges, bulk_add_vertices
from janusgraph_tpu_torch.core.deadline import deadline_scope
from janusgraph_tpu_torch.core.graph import open_graph
from janusgraph_tpu_torch.exceptions import ConfigurationError, TemporaryBackendError
from janusgraph_tpu_torch.observability import tracer
from janusgraph_tpu_torch.observability.profiler import ledger_scope
from janusgraph_tpu_torch.olap import programs
from janusgraph_tpu_torch.olap.csr import load_csr
from janusgraph_tpu_torch.storage import backend_op
from janusgraph_tpu_torch.storage.inmemory import InMemoryStoreManager
from janusgraph_tpu_torch.storage.kcvs import KCVMutation, KeySliceQuery, SliceQuery
from janusgraph_tpu_torch.storage.remote import RemoteStoreManager, RemoteStoreServer

ROOT = Path(__file__).resolve().parents[1]

#: each package's remote-store pieces, by the same names
PORT = dict(server=RemoteStoreServer, client=RemoteStoreManager, mem=InMemoryStoreManager,
            ksq=KeySliceQuery, sq=SliceQuery, mut=KCVMutation, tracer=tracer,
            ledger=ledger_scope, deadline=deadline_scope)
REF = dict(server=ref_remote.RemoteStoreServer, client=ref_remote.RemoteStoreManager,
           mem=RefInMemory, ksq=RefKeySliceQuery, sq=RefSliceQuery, mut=RefKCVMutation,
           tracer=ref_tracer, ledger=ref_ledger_scope, deadline=ref_deadline_scope)


@pytest.fixture
def servers():
    """Start servers through ``start(cls, manager, **kw)``; all stop at
    teardown."""
    started = []

    def start(cls, manager, **kw):
        srv = cls(manager, **kw).start()
        started.append(srv)
        return srv

    yield start
    for srv in started:
        srv.stop()


@pytest.fixture
def served(servers):
    server = servers(RemoteStoreServer, InMemoryStoreManager())
    client = RemoteStoreManager(*server.address)
    yield server, client
    client.close()


def _remote_cfg(server, **extra):
    host, port = server.address
    return {"storage.backend": "remote", "storage.hostname": host, "storage.port": port,
            **extra}


# ------------------------------------------------- the reference's cases

def test_features_marked_distributed(served):
    _server, client = served
    f = client.features
    assert f.distributed and f.network_attached
    assert not f.transactional  # autocommit per request (the CQL model)
    assert f.multi_query and f.batch_mutation


def test_roundtrip_and_multi_slice(served):
    _server, client = served
    store = client.open_database("edgestore")
    tx = client.begin_transaction()
    store.mutate(b"k1", [(b"a", b"1"), (b"b", b"2")], [], tx)
    store.mutate(b"k2", [(b"a", b"3")], [], tx)
    got = store.get_slice(KeySliceQuery(b"k1", SliceQuery(b"a", b"c")), tx)
    assert got == [(b"a", b"1"), (b"b", b"2")]
    multi = store.get_slice_multi([b"k1", b"k2"], SliceQuery(b"a", b"b"), tx)
    assert multi[b"k1"] == [(b"a", b"1")]
    assert multi[b"k2"] == [(b"a", b"3")]


def test_scan_streams_rows(served):
    _server, client = served
    store = client.open_database("edgestore")
    tx = client.begin_transaction()
    for i in range(500):
        store.mutate(f"k{i:04d}".encode(), [(b"c", str(i).encode())], [], tx)
    rows = list(store.get_keys(SliceQuery(b"", None), tx))
    assert len(rows) == 500
    assert rows[0][0] == b"k0000"  # in-memory backend scans ordered


def test_scan_spanning_many_chunks_parses_every_row(served):
    """Rows larger in total than the server's write batch and the client's
    receive chunk, with cells of every size from empty up: the buffered
    stream parses each exactly."""
    _server, client = served
    store = client.open_database("edgestore")
    rng = np.random.default_rng(5)
    want = []
    for i in range(60):
        cells = [(f"c{j:03d}".encode(), bytes(rng.integers(0, 256, int(rng.integers(0, 9000)),
                                                         dtype=np.uint8)))
                 for j in range(int(rng.integers(0, 40)))]
        store.mutate(f"r{i:03d}".encode(), cells, [], None)
        if cells:
            want.append((f"r{i:03d}".encode(), cells))
    assert list(store.get_keys(SliceQuery(b"", None), None)) == want


def test_server_queues_connections_it_has_not_accepted_yet():
    """A burst of connections that the server cannot accept at once (its
    accepting thread waits for the interpreter lock while handler threads
    stream scans, as with 8 loader processes) waits in the listen queue:
    with socketserver's default backlog of 5 the kernel drops the rest,
    and their clients retry 1, 3, 7, 15, 31 s later. The server here
    accepts nothing, so every connection rests in the queue."""
    server = RemoteStoreServer(InMemoryStoreManager())  # never started
    socks = []
    try:
        for _ in range(32):
            socks.append(socket.create_connection(server.address, timeout=2.0))
    finally:
        for s in socks:
            s.close()
        server._srv.server_close()
    assert len(socks) == 32


def test_retry_replays_transient_failures(served):
    calls = {"n": 0}

    def flaky():
        calls["n"] += 1
        if calls["n"] < 3:
            raise TemporaryBackendError("transient")
        return "ok"

    assert backend_op.execute(flaky, max_time_s=5.0) == "ok"
    assert calls["n"] == 3


def test_client_survives_server_restart(served, servers):
    server, client = served
    store = client.open_database("edgestore")
    tx = client.begin_transaction()
    store.mutate(b"k", [(b"a", b"1")], [], tx)
    host, port = server.address
    backing = server.manager
    server.stop()

    # restart on the same port shortly after; the client's retry/backoff
    # redials and replays
    def restart():
        time.sleep(0.5)
        servers(RemoteStoreServer, backing, host=host, port=port)

    t = threading.Thread(target=restart, daemon=True)
    t.start()
    got = store.get_slice(KeySliceQuery(b"k", SliceQuery(b"", None)), tx)
    t.join(10.0)
    assert got == [(b"a", b"1")]


def test_graph_end_to_end_over_remote(servers):
    server = servers(RemoteStoreServer, InMemoryStoreManager())
    g = open_graph(_remote_cfg(server, **{"computer.executor": "cpu"}))
    try:
        gods.load(g)
        t = g.traversal()
        assert t.V().has("name", "hercules").out("father").values("name").to_list() == ["jupiter"]
        csr = load_csr(g)
        assert csr.num_vertices == 12 and csr.num_edges == 17
    finally:
        g.close()


def test_cli_storage_server_cross_process(tmp_path):
    """Two real processes: ``python -m janusgraph_tpu_torch storage-server``
    serving a persistent store, and a graph client over the wire."""
    proc = subprocess.Popen(
        [sys.executable, "-m", "janusgraph_tpu_torch", "storage-server",
         "--port", "0", "--directory", str(tmp_path / "srv")],
        stdout=subprocess.PIPE, text=True, cwd=str(ROOT),
    )
    try:
        line = proc.stdout.readline()
        m = re.search(r"listening on ([\d.]+):(\d+)", line)
        assert m, line
        assert "local(" in line
        host, port = m.group(1), int(m.group(2))
        g = open_graph({"storage.backend": "remote", "storage.hostname": host,
                        "storage.port": port})
        try:
            tx = g.new_transaction()
            tx.add_vertex(name="networked")
            tx.commit()
            assert g.traversal().V().has("name", "networked").count() == 1
        finally:
            g.close()
        assert proc.poll() is None  # the server outlives its clients
    finally:
        proc.terminate()
        proc.wait(timeout=10)


def test_multi_node_remote_cluster(servers):
    """The sharded composite behind the server is an N-node remote
    cluster; a failed node surfaces as a temporary error over the wire,
    and the rows sit on the nodes the reference's placement picks."""
    from janusgraph_tpu.storage.sharded_store import _shard_of as ref_shard_of
    from janusgraph_tpu_torch.storage.sharded_store import ShardedStoreManager

    server = servers(RemoteStoreServer, ShardedStoreManager(num_nodes=3))
    client = RemoteStoreManager(*server.address, retry_time_s=0.3)
    try:
        assert not client.features.ordered_scan
        store = client.open_database("edgestore")
        tx = client.begin_transaction()
        for i in range(64):
            store.mutate(f"key{i}".encode(), [(b"c", b"v")], [], tx)
        rows = list(store.get_keys(SliceQuery(b"", None), tx))
        assert len(rows) == 64
        for node, mgr in enumerate(server.manager.nodes):
            for key, _ in mgr.open_database("edgestore").get_keys(SliceQuery(), None):
                assert ref_shard_of(key, 3) == node
        server.manager.fail_node(1)
        with pytest.raises(TemporaryBackendError):
            for i in range(64):
                store.get_slice(KeySliceQuery(f"key{i}".encode(), SliceQuery(b"", None)), tx)
        server.manager.heal_node(1)
        got = [store.get_slice(KeySliceQuery(f"key{i}".encode(), SliceQuery(b"", None)), tx)
               for i in range(64)]
        assert got == [[(b"c", b"v")]] * 64
    finally:
        client.close()


def test_cli_storage_server_sharded_cross_process():
    """``storage-server --sharded-nodes 3`` in its own process: a graph over
    the wire scans it through the unordered branch."""
    proc = subprocess.Popen(
        [sys.executable, "-m", "janusgraph_tpu_torch", "storage-server",
         "--port", "0", "--sharded-nodes", "3"],
        stdout=subprocess.PIPE, text=True, cwd=str(ROOT),
    )
    try:
        line = proc.stdout.readline()
        m = re.search(r"storage server \(sharded\(3\)\) listening on ([\d.]+):(\d+)", line)
        assert m, line
        g = open_graph({"storage.backend": "remote", "storage.hostname": m.group(1),
                        "storage.port": int(m.group(2)), "computer.executor": "cpu"})
        try:
            gods.load(g)
            csr = load_csr(g)
            assert (csr.num_vertices, csr.num_edges) == (12, 17)
        finally:
            g.close()
    finally:
        proc.terminate()
        proc.wait(timeout=10)


def test_cli_refuses_what_is_not_ported():
    from janusgraph_tpu_torch import cli

    assert cli.main(["storage-server", "--sharded-nodes", "0"]) == 2
    assert cli.main(["bench", "--scale", "3"]) == 2
    assert cli.main(["benchdiff", "old.json", "new.json"]) == 2


def test_parallel_multi_slice_fanout(servers):
    """storage.parallel-backend-ops: big multi-key reads split across the
    connection pool; results identical to the serial path."""
    server = servers(RemoteStoreServer, InMemoryStoreManager())
    host, port = server.address
    par = RemoteStoreManager(host, port, pool_size=4, parallel_ops=True)
    ser = RemoteStoreManager(host, port, pool_size=4, parallel_ops=False)
    try:
        store_w = par.open_database("t")
        txh = par.begin_transaction()
        keys = [f"k{i:03}".encode() for i in range(40)]
        for i, k in enumerate(keys):
            store_w.mutate(k, [(b"c", str(i).encode())], [], txh)
        q = SliceQuery()
        a = par.open_database("t").get_slice_multi(keys, q, txh)
        b = ser.open_database("t").get_slice_multi(keys, q, txh)
        assert set(a) == set(keys)
        for k in keys:
            assert list(a[k]) == list(b[k])
        assert list(a[keys[3]])  # non-empty payload round-tripped
    finally:
        par.close()
        ser.close()


def _remote_spans(trc, trace_id, want):
    deadline = time.monotonic() + 2.0
    found = []
    while time.monotonic() < deadline:
        found = [r for r in trc.find_trace(trace_id) if r.name.startswith("store.remote.")]
        if len(found) >= want:
            break
        time.sleep(0.01)
    return found


def test_trace_stitches_across_remote_store(served):
    """Ops issued inside a client span produce server-side spans sharing
    the client's trace_id, parented under the client span."""
    _server, client = served
    store = client.open_database("edgestore")
    tx = client.begin_transaction()
    with tracer.span("client.root") as root:
        store.mutate(b"k", [(b"a", b"1")], [], tx)
        store.get_slice(KeySliceQuery(b"k", SliceQuery(b"", None)), tx)
        list(store.get_keys(SliceQuery(b"", None), tx))  # streamed scan too
    remote_spans = _remote_spans(tracer, root.trace_id, 3)
    names = {s.name for s in remote_spans}
    assert {"store.remote.mutate", "store.remote.getSlice",
            "store.remote.scanAll"} <= names, names
    for s in remote_spans:
        assert s.trace_id == root.trace_id
        assert s.parent_span_id == root.span_id
    d = remote_spans[0].to_dict()
    assert d["trace_id"] == f"{root.trace_id:016x}"
    assert d["parent_span_id"] == f"{root.span_id:016x}"


def test_trace_degrades_against_old_featured_server(servers):
    """A client against an old-featured server (no trace bit) interoperates
    and degrades to unstitched spans: no flagged frames are sent."""
    server = servers(RemoteStoreServer, InMemoryStoreManager(), trace_propagation=False)
    client = RemoteStoreManager(*server.address)
    try:
        store = client.open_database("edgestore")
        tx = client.begin_transaction()
        with tracer.span("client.old-server") as root:
            store.mutate(b"k", [(b"a", b"1")], [], tx)
            got = store.get_slice(KeySliceQuery(b"k", SliceQuery(b"", None)), tx)
        assert got == [(b"a", b"1")]
        assert client._remote_trace is False  # negotiated OFF
        assert not [r for r in tracer.find_trace(root.trace_id)
                    if r.name.startswith("store.remote.")]
    finally:
        client.close()


def test_old_client_against_new_server_interoperates(served):
    """A client that never sets the trace flag against a new server."""
    server, _ = served
    old_client = RemoteStoreManager(*server.address, trace_propagation=False)
    try:
        store = old_client.open_database("edgestore")
        tx = old_client.begin_transaction()
        with tracer.span("client.legacy") as root:
            store.mutate(b"lk", [(b"a", b"1")], [], tx)
            got = store.get_slice(KeySliceQuery(b"lk", SliceQuery(b"", None)), tx)
        assert got == [(b"a", b"1")]
        assert not [r for r in tracer.find_trace(root.trace_id)
                    if r.name.startswith("store.remote.")]
        assert old_client.features.multi_query
    finally:
        old_client.close()


def test_remote_graph_refuses_pickle_by_default(servers):
    """attributes.allow-pickle=auto disables object-pickle frames over a
    remote store but keeps them for in-process graphs; 'true' opts back
    in explicitly."""
    from janusgraph_tpu_torch.core.attributes import SerializerError

    server = servers(RemoteStoreServer, InMemoryStoreManager())
    g = open_graph(_remote_cfg(server))
    assert not g.serializer.allow_pickle
    with pytest.raises(SerializerError, match="fallback disabled"):
        g.serializer.write_object(complex(1, 2))
    g.close()
    g = open_graph(dict(_remote_cfg(server), **{"attributes.allow-pickle": "true"}))
    assert g.serializer.allow_pickle
    g.close()
    local = open_graph({"storage.backend": "inmemory"})
    assert local.serializer.allow_pickle
    local.close()


@pytest.mark.parametrize("config", [
    {"storage.backend": "remote"},
    {"storage.backend": "remote", "storage.hostname": "127.0.0.1"},
    {"storage.backend": "remote", "storage.port": 8182},
])
def test_remote_without_host_or_port_raises(config):
    with pytest.raises(ConfigurationError, match="storage.hostname"):
        open_graph(config)


def test_lock_consistency_over_remote_backend(servers):
    """Two graph instances whose shared state lives behind the server: lock
    claims, expected values and data cells all ride the wire (after the
    reference's ``tests/test_consistency.py``)."""
    from janusgraph_tpu_torch.core.codecs import Consistency

    server = servers(RemoteStoreServer, InMemoryStoreManager())
    host, port = server.address
    graphs = []
    try:
        g1 = open_graph(store_manager=RemoteStoreManager(host=host, port=port))
        graphs.append(g1)
        g1.management().make_property_key("serial", int)
        g1.management().set_consistency("serial", Consistency.LOCK)
        tx = g1.new_transaction()
        v = tx.add_vertex()
        v.property("serial", 1)
        tx.commit()
        g2 = open_graph(store_manager=RemoteStoreManager(host=host, port=port))
        graphs.append(g2)
        tx1, tx2 = g1.new_transaction(), g2.new_transaction()
        tx1.get_vertex(v.id).property("serial", 2)
        tx2.get_vertex(v.id).property("serial", 3)
        tx1.commit()
        with pytest.raises(Exception):
            tx2.commit()
        g3 = open_graph(store_manager=RemoteStoreManager(host=host, port=port))
        graphs.append(g3)
        assert g3.new_transaction().get_vertex(v.id).value("serial") == 2
    finally:
        for g in graphs:
            g.close()


def test_ttl_over_remote_store(servers):
    """Cell TTLs ride the wire's expiry slot (after the reference's
    ``tests/test_schema_ttl.py``)."""
    from janusgraph_tpu_torch.core.codecs import Direction

    server = servers(RemoteStoreServer, InMemoryStoreManager())
    g = open_graph(store_manager=RemoteStoreManager(*server.address))
    try:
        g.management().make_edge_label("visited")
        g.management().set_ttl("visited", 3600)
        tx = g.new_transaction()
        a, b = tx.add_vertex(), tx.add_vertex()
        tx.add_edge(a, "visited", b)
        tx.commit()
        assert len(g.new_transaction().get_vertex(a.id).edges(Direction.OUT, "visited")) == 1
        # the edge's cells reached the server's store with their expiry
        assert server.manager.open_database("edgestore")._expiry
    finally:
        g.close()


# ------------------------------------------------------ byte equality

class _Recorder:
    """A TCP relay in front of a server that records the bytes each way."""

    def __init__(self, target):
        self.target = target
        self.up = bytearray()
        self.down = bytearray()
        self._lsock = socket.create_server(("127.0.0.1", 0))
        self._lsock.settimeout(10.0)
        self.address = self._lsock.getsockname()
        self._threads = []
        self._accept = threading.Thread(target=self._serve, daemon=True)
        self._accept.start()

    def _pump(self, src, dst, log):
        try:
            while True:
                data = src.recv(1 << 16)
                if not data:
                    break
                log += data
                dst.sendall(data)
        except OSError:
            pass
        finally:
            for s in (src, dst):
                try:
                    s.shutdown(socket.SHUT_RDWR)
                except OSError:
                    pass

    def _serve(self):
        try:
            client, _ = self._lsock.accept()
        except OSError:
            return
        upstream = socket.create_connection(self.target, timeout=10.0)
        client.settimeout(10.0)
        for a, b, log in ((client, upstream, self.up), (upstream, client, self.down)):
            t = threading.Thread(target=self._pump, args=(a, b, log), daemon=True)
            t.start()
            self._threads.append(t)

    def close(self):
        self._lsock.close()
        for t in self._threads:
            t.join(10.0)


def _drive(pkg, address):
    """The same calls through a client of ``pkg`` on ONE pooled connection:
    features, mutate, mutateMany, getSlice, getSliceMulti, exists."""
    client = pkg["client"](*address, pool_size=1, parallel_ops=False)
    try:
        store = client.open_database("edgestore")
        store.mutate(b"k1", [(b"a", b"1"), (b"b", b"22", 7)], [b"z"], None)
        m = pkg["mut"]()
        m.additions.extend([(b"c", b"3")])
        m.deletions.append(b"a")
        client.mutate_many({"edgestore": {b"k2": m}}, None)
        got = store.get_slice(pkg["ksq"](b"k1", pkg["sq"](b"a", b"c", 5)), None)
        multi = store.get_slice_multi([b"k1", b"k2"], pkg["sq"](b"", None), None)
        exists = client.exists()
        return got, multi, exists
    finally:
        client.close()


@pytest.mark.parametrize("server_pkg", ["port", "ref"])
def test_frames_are_byte_equal_both_ways(servers, server_pkg):
    """The same calls from each package's client send the same bytes, and
    each package's server answers them with the same bytes."""
    seen = {}
    for client_pkg, pkg in (("port", PORT), ("ref", REF)):
        spkg = PORT if server_pkg == "port" else REF
        server = servers(spkg["server"], spkg["mem"]())
        rec = _Recorder(server.address)
        out = _drive(pkg, rec.address)
        rec.close()
        seen[client_pkg] = (out, bytes(rec.up), bytes(rec.down))
    assert seen["port"][0] == seen["ref"][0]
    assert seen["port"][1] == seen["ref"][1]  # client -> server
    assert seen["port"][2] == seen["ref"][2]  # server -> client
    assert len(seen["port"][1]) > 100


def test_servers_answer_a_scan_and_a_features_frame_with_the_same_bytes(servers):
    """A raw features frame and a raw scan frame sent to each package's
    server over the same rows get byte-equal answers (the port's server
    batches the row frames into fewer writes, with the same bytes)."""
    answers = []
    for pkg in (PORT, REF):
        mgr = pkg["mem"]()
        st = mgr.open_database("edgestore")
        for i in range(300):
            st.mutate(f"k{i:03d}".encode(), [(b"c", bytes(i % 7) * i)], [], None)
        server = servers(pkg["server"], mgr)
        sock = socket.create_connection(server.address, timeout=10.0)
        try:
            body = b"".join([b"\x00\x00\x00\x09edgestore", b"\x00\x00\x00\x00",
                             b"\x00\x00\x00\x00", b"\xff\xff\xff\xff"])
            sock.sendall(b"\x00\x00\x00\x00\x01")  # features
            sock.sendall(len(body).to_bytes(4, "big") + b"\x06" + body)  # scanAll
            # read until the stream has been quiet for a second
            got = bytearray()
            sock.settimeout(1.0)
            try:
                while True:
                    chunk = sock.recv(1 << 16)
                    if not chunk:
                        break
                    got += chunk
            except socket.timeout:
                pass
            answers.append(bytes(got))
        finally:
            sock.close()
    assert answers[0] == answers[1]
    assert answers[0].endswith(b"\x00") and len(answers[0]) > 300 * 20


# ------------------------------------------------ wire compatibility

MATRIX = [(mode, trace, ledger, deadline) for mode in ("sync", "pipelined")
          for trace in (True, False) for ledger in (True, False) for deadline in (True, False)]


@pytest.mark.parametrize("direction", ["port_client_ref_server", "ref_client_port_server"])
@pytest.mark.parametrize("mode,trace,ledger,deadline", MATRIX)
def test_wire_compat_matrix(servers, direction, mode, trace, ledger, deadline):
    cli, srv = (PORT, REF) if direction == "port_client_ref_server" else (REF, PORT)
    backing = srv["mem"]()
    server = servers(srv["server"], backing, trace_propagation=trace, ledger_echo=ledger,
                     deadline_propagation=deadline, pipeline=(mode == "pipelined"))
    client = cli["client"](*server.address)
    if mode == "pipelined":
        client._should_pipeline = lambda: True  # past the adaptive gate
    try:
        store = client.open_database("edgestore")
        with cli["tracer"].span("compat.root") as root:
            with cli["ledger"]() as led:
                with cli["deadline"](5_000.0):
                    store.mutate(b"k", [(b"a", b"1")], [], None)
                    m = cli["mut"]()
                    m.additions.extend([(b"a", b"2"), (b"b", b"3")])
                    client.mutate_many({"edgestore": {b"k2": m}}, None)
                    got = store.get_slice(cli["ksq"](b"k", cli["sq"](b"", None)), None)
                    multi = store.get_slice_multi([b"k", b"k2"], cli["sq"](b"", None), None)
                    rows = list(store.get_keys(cli["sq"](b"", None), None))
        assert got == [(b"a", b"1")]
        assert multi == {b"k": [(b"a", b"1")], b"k2": [(b"a", b"2"), (b"b", b"3")]}
        assert rows == [(b"k", [(b"a", b"1")]), (b"k2", [(b"a", b"2"), (b"b", b"3")])]
        assert (client._remote_trace, client._remote_ledger, client._remote_deadline,
                client._remote_pipeline) == (trace, ledger, deadline, mode == "pipelined")
        assert (client._mux is not None) == (mode == "pipelined")
        # the store behind the server holds what the client wrote
        raw = backing.open_database("edgestore").get_slice(
            srv["ksq"](b"k2", srv["sq"](b"", None)), backing.begin_transaction())
        assert raw == [(b"a", b"2"), (b"b", b"3")]
        # a negotiated trace stitches the serving side's spans into the
        # client's trace; a negotiated ledger echoes the server's counts
        spans = _remote_spans(srv["tracer"], root.trace_id, 3 if trace else 0)
        assert bool(spans) == trace
        assert all(s.parent_span_id == root.span_id for s in spans)
        counts = led.to_dict()
        # getSlice 1 + getSliceMulti 3 + the scan's 3: echoed by the server
        # where the ledger bit is negotiated, else counted by the client
        assert counts.get("cells_read", 0) == 1 + 3 + 3
        assert counts.get("cells_written", 0) == 3
    finally:
        client.close()


# ------------------------------------------------------- graph level

def _rows(manager, names=("edgestore", "graphindex")):
    return {
        name: {k: list(zip(r.columns, r.values)) for k, r in manager.open_database(name)._rows.items()}
        for name in names
    }


def test_gods_over_a_reference_server_write_the_in_memory_rows(servers):
    """The Graph of the Gods loaded by the port over the reference's
    server: the rows the server's store holds are the rows the port writes
    to an in-memory store, byte for byte."""
    backing = RefInMemory()
    server = servers(ref_remote.RemoteStoreServer, backing)
    over = open_graph(_remote_cfg(server, **{"computer.executor": "cpu"}))
    local = open_graph({"computer.executor": "cpu"})
    try:
        gods.load(over)
        gods.load(local)
        assert _rows(backing) == _rows(local.backend.manager)
        t = over.traversal()
        assert t.V().has("name", "hercules").out("father").values("name").to_list() == ["jupiter"]
    finally:
        over.close()
        local.close()


def _seed(g, n=300, m=1500, seed=4):
    rng = np.random.default_rng(seed)
    vids = bulk_add_vertices(g, n, label="node")
    bulk_add_edges(g, "link", vids[rng.integers(0, n, m)], vids[rng.integers(0, n, m)])
    return vids


CSR_FIELDS = ("vertex_ids", "out_indptr", "out_dst", "in_indptr", "in_src", "labels",
              "in_edge_type", "out_edge_type", "out_degree")


def test_load_csr_over_remote_equals_in_memory(servers):
    server = servers(RemoteStoreServer, InMemoryStoreManager())
    over = open_graph(_remote_cfg(server, **{"computer.executor": "cpu"}))
    local = open_graph({"computer.executor": "cpu"})
    try:
        np.testing.assert_array_equal(_seed(over), _seed(local))
        a, b = load_csr(over), load_csr(local)
        for name in CSR_FIELDS:
            np.testing.assert_array_equal(getattr(a, name), getattr(b, name), err_msg=name)
    finally:
        over.close()
        local.close()


def test_pagerank_over_remote_equals_the_reference_over_the_same_server(servers):
    """The port writes a graph through a port server; the reference opens
    the same server; PageRank at damping 0.5 (no dangling vertex: a ring
    rides along) gives bit-equal ranks, and the default damping agrees at
    1e-6."""
    server = servers(RemoteStoreServer, InMemoryStoreManager())
    g = open_graph(_remote_cfg(server, **{"computer.executor": "cpu",
                                          "computer.strategy": "ell"}))
    ref = None
    try:
        vids = _seed(g)
        ring = np.arange(len(vids))
        bulk_add_edges(g, "ring", vids[ring], vids[(ring + 1) % len(vids)])
        ref = ref_open_graph(_remote_cfg(server, **{
            "computer.sharded-auto": False, "computer.delta": False,
            "computer.strategy": "ell"}))
        for damping, iters in ((0.5, 15), (0.85, 20)):
            mine = g.compute().program(programs.PageRankProgram(
                damping=damping, max_iterations=iters, tol=0.0)).submit()
            want = ref.compute(executor="tpu").program(ref_programs.PageRankProgram(
                damping=damping, max_iterations=iters, tol=0.0)).submit()
            np.testing.assert_array_equal(mine.csr.vertex_ids, want.csr.vertex_ids)
            w = np.asarray(want.states["rank"])
            if damping == 0.5:
                np.testing.assert_array_equal(mine.states["rank"].view(np.int32),
                                              w.view(np.int32))
            else:
                np.testing.assert_allclose(mine.states["rank"], w, rtol=1e-6, atol=0)
    finally:
        g.close()
        if ref is not None:
            ref.close()
