"""Remote KCVS over TCP: a real networked storage backend — the port's
copy of ``janusgraph_tpu/storage/remote.py``. Its frames are the
reference's byte for byte in both directions and in every negotiated
combination, so a port client talks to a reference server and a reference
client to a port server. Error frames carry ``TypeName: message`` as text
and each client maps the status to its own exception classes. Two host
costs differ, not the bytes: the server writes a scan's row frames in
256 KiB batches instead of one ``sendall`` a row, and the client parses
the row stream out of 1 MiB receive chunks instead of one ``recv`` a field.
A scan stream that breaks mid-row raises ``TemporaryBackendError`` (the
reference lets the ``ConnectionError`` out), so the CSR scan's retry
resumes the range from just past its last row.

This is the framework's cql/hbase-analogue (reference: the CQL adapter
speaks the Cassandra wire protocol to remote storage nodes —
CQLStoreManager.java:533, CQLKeyColumnValueStore.java:476; all inter-node
"communication" in the reference flows through such storage RPC, SURVEY.md
§2.4). Design is NOT a Cassandra clone: one compact length-prefixed binary
protocol carrying exactly the KCVS SPI (slice / multi-slice / mutate /
mutate-many / row scan), autocommit per request (the CQL adapter's
consistency-level model: no cross-request transaction state), row scans
STREAMED row-by-row so OLAP bulk loads don't materialize the store in
memory on either side.

Server: `RemoteStoreServer` exposes ANY KeyColumnValueStoreManager (in
memory, persistent local, sharded composite) over a socket — one thread per
connection. Client: `RemoteStoreManager` implements the full manager SPI;
every request is wrapped in the retrying backend-operation guard
(backend_op.execute), so transient connection failures replay with backoff
(reference: BackendOperation.java). Combine with ShardedStoreManager for a
multi-node remote cluster (the "multi-node without a cluster" technique
over real sockets: ``storage-server --sharded-nodes N``).

Wire format (big-endian):
  request:  [u32 body_len][u8 op][body]
  response: [u32 body_len][u8 status][body]   status: 0 ok / 1 temp / 2 perm
  scan responses stream after the status frame: ([u8 1][row])* [u8 0]
Strings/bytes are u32-length-prefixed; entry lists are u32-count prefixed.

Trace propagation (negotiated, byte-compatible): the `_OP_FEATURES`
payload of a trace-capable server carries a `"trace": true` key; only
after seeing it does a client set the high bit of the op byte
(op | 0x80) and prepend `[u8 hdr_len][TraceContext bytes]` to the body.
Old servers never receive flagged frames (the bit is gated on
negotiation), old clients never set it — mixed pairs speak the original
protocol unchanged, they just don't stitch. The server opens a child
span under the received context around each dispatched op, so one
client query yields one cross-process trace.

Resource-ledger propagation rides the same negotiation scheme on its own
bits: a ledger-capable server adds `"ledger": true` to the features
payload, and only then does a client with an ambient
:class:`~janusgraph_tpu_torch.observability.profiler.ResourceLedger` set
`op | 0x40` — "measure this op and echo the costs". The server prepends
`[u8 len][ledger block]` (observability/profiler.py tag-value codec) to
the OK response body of flagged ops and annotates its span with the same
fields; the client merges the echo into the ambient ledger (without
re-annotating — the server's span already carries the fields, keeping
the trace-totals == span-sums invariant). Old peers in either direction
never see (or send) flagged frames. Streaming scans are never flagged;
the client counts the rows it decodes instead.

Deadline propagation rides a third bit (`op | 0x20`, negotiated via
`"deadline": true`): the client prepends `[u8 len][u32 remaining_ms]` —
the ambient deadline's REMAINING budget (core/deadline.py; relative, so
host clocks never need to agree) — and the server runs the dispatched op
under a matching deadline scope. An op arriving with 0 budget is refused
before touching the store (permanent status: the client never replays
it), and the serving node's own downstream retries stop when the budget
runs out — the mechanism that kills retry storms at the bottom of the
stack instead of the top. Same compatibility discipline as the other
two bits: mixed old/new pairs speak the original protocol unchanged.

Pipelined async framing rides a fourth bit (`op | 0x10`, negotiated via
`"pipeline": true` — storage/pipeline.py): instead of one synchronous
op per round-trip under a per-connection lock, the client queues ops on
a small set of pipelined sockets; a writer thread coalesces the queue
into batched wire frames (same-store getSlice ops merge into one
getSliceMulti, same-store mutates into one mutateMany, everything else
rides a batch carrier), and responses carry per-frame request ids so
they complete out of order. The server dispatches each sub-op on a
per-connection worker pool — every op keeps its OWN trace context,
ledger echo, deadline budget, breaker accounting, and fault-injection
attribution; the carrier frame has no identity of its own. Old peers in
either direction never see a flagged frame: the synchronous path
remains byte-identical and is the negotiated fallback.
"""

from __future__ import annotations

import socket
import socketserver
import struct
import threading
from contextlib import contextmanager
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

from janusgraph_tpu_torch.exceptions import (
    PermanentBackendError,
    TemporaryBackendError,
)
from janusgraph_tpu_torch.storage import backend_op
from janusgraph_tpu_torch.storage.kcvs import (
    EntryList,
    KCVMutation,
    KeyColumnValueStore,
    KeyColumnValueStoreManager,
    KeyRangeQuery,
    KeySliceQuery,
    SliceQuery,
    StoreFeatures,
    StoreTransaction,
)

# ops
_OP_FEATURES = 1
_OP_GET_SLICE = 2
_OP_GET_SLICE_MULTI = 3
_OP_MUTATE = 4
_OP_MUTATE_MANY = 5
_OP_SCAN_ALL = 6
_OP_SCAN_RANGE = 7
_OP_CLEAR = 8
_OP_EXISTS = 9
#: batch carrier for pipelined framing: the body is [u32 nsub] followed
#: by length-prefixed pipelined sub-frames (storage/pipeline.iter_batch)
_OP_BATCH = 10

#: high bit of the op byte: the body is prefixed with
#: [u8 hdr_len][TraceContext bytes]. Sent only after the server's
#: features payload negotiated `"trace": true`.
_TRACE_FLAG = 0x80
#: second flag bit: "measure this op's resource costs and prepend a
#: ledger block to the OK response". Sent only after the server's
#: features payload negotiated `"ledger": true`.
_LEDGER_FLAG = 0x40
#: third flag bit: the body carries a deadline prefix
#: ([u8 len=4][u32 remaining_ms], after the trace prefix when both ride)
#: — "stop working on this op once the caller's budget is spent". Sent
#: only after the server's features payload negotiated
#: `"deadline": true` (same old/new byte-compat discipline as the trace
#: and ledger bits: un-negotiated peers never see a flagged frame).
_DEADLINE_FLAG = 0x20
#: fourth flag bit: pipelined framing — [u32 req_id] leads the body and
#: the response echoes it on status|0x10 (storage/pipeline.py). Sent
#: only after the server's features payload negotiated
#: `"pipeline": true` (same discipline as the other three bits).
_PIPELINE_FLAG = 0x10
_FLAG_MASK = _TRACE_FLAG | _LEDGER_FLAG | _DEADLINE_FLAG | _PIPELINE_FLAG

_OP_NAMES = {
    _OP_FEATURES: "features",
    _OP_GET_SLICE: "getSlice",
    _OP_GET_SLICE_MULTI: "getSliceMulti",
    _OP_MUTATE: "mutate",
    _OP_MUTATE_MANY: "mutateMany",
    _OP_SCAN_ALL: "scanAll",
    _OP_SCAN_RANGE: "scanRange",
    _OP_CLEAR: "clear",
    _OP_EXISTS: "exists",
    _OP_BATCH: "pipelineBatch",
}

_STATUS_OK = 0
_STATUS_TEMP = 1
_STATUS_PERM = 2


def encode_trace_prefix(ctx) -> bytes:
    """[u8 hdr_len][ctx bytes] — length-prefixed so the header codec can
    grow without another protocol negotiation."""
    raw = ctx.to_bytes()
    return bytes([len(raw)]) + raw


def split_trace_prefix(body: bytes):
    """Inverse of encode_trace_prefix: (TraceContext|None, rest-of-body).
    A malformed header degrades to an untraced frame, never an error."""
    from janusgraph_tpu_torch.observability.spans import TraceContext

    if not body:
        return None, body
    hlen = body[0]
    if len(body) < 1 + hlen:
        return None, body
    return TraceContext.from_bytes(body[1:1 + hlen]), body[1 + hlen:]


def encode_deadline_prefix(remaining_ms: float) -> bytes:
    """``[u8 len=4][u32 remaining_ms]`` — REMAINING budget, not an absolute
    instant (clocks are not comparable across hosts). Length-prefixed like
    the trace header so the codec can grow without a protocol bump; a
    spent budget clamps to 0 rather than wrapping."""
    from janusgraph_tpu_torch.core.deadline import MAX_WIRE_MS

    ms = max(0, min(int(remaining_ms), MAX_WIRE_MS))
    return bytes([4]) + struct.pack(">I", ms)


def split_deadline_prefix(body: bytes):
    """Inverse of encode_deadline_prefix: (remaining_ms|None, rest).
    Malformed prefixes degrade to an un-deadlined frame, never an error."""
    if not body:
        return None, body
    hlen = body[0]
    if hlen < 4 or len(body) < 1 + hlen:
        return None, body
    (ms,) = struct.unpack_from(">I", body, 1)
    return float(ms), body[1 + hlen:]


@contextmanager
def _deadline_guard(budget_ms):
    """Serve one dispatched op under the caller's remaining budget. A
    frame that arrives with its budget already spent (0 on the wire) is
    refused before touching the store — DeadlineExceededError serializes
    as a PERMANENT status, so the client never replays it."""
    if budget_ms is None:
        yield
        return
    from janusgraph_tpu_torch.core.deadline import deadline_scope
    from janusgraph_tpu_torch.exceptions import DeadlineExceededError

    if budget_ms <= 0:
        raise DeadlineExceededError(
            "op arrived with its caller deadline already spent"
        )
    with deadline_scope(budget_ms):
        yield


# ------------------------------------------------------------------ encoding
def _pb(out: List[bytes], b: bytes) -> None:
    out.append(struct.pack(">I", len(b)))
    out.append(b)


def _ps(out: List[bytes], s: str) -> None:
    _pb(out, s.encode())


class _Reader:
    def __init__(self, data: bytes):
        self.data = data
        self.off = 0

    def u32(self) -> int:
        (v,) = struct.unpack_from(">I", self.data, self.off)
        self.off += 4
        return v

    def u64(self) -> int:
        (v,) = struct.unpack_from(">Q", self.data, self.off)
        self.off += 8
        return v

    def u8(self) -> int:
        v = self.data[self.off]
        self.off += 1
        return v

    def bytes_(self) -> bytes:
        n = self.u32()
        v = self.data[self.off : self.off + n]
        self.off += n
        return v

    def str_(self) -> str:
        return self.bytes_().decode()


def _encode_entries(out: List[bytes], entries: EntryList) -> None:
    out.append(struct.pack(">I", len(entries)))
    for col, val in entries:
        _pb(out, col)
        _pb(out, val)


def _decode_entries(r: _Reader) -> EntryList:
    n = r.u32()
    return [(r.bytes_(), r.bytes_()) for _ in range(n)]


def _encode_additions(out: List[bytes], entries: EntryList) -> None:
    """Mutation additions: (col, val[, expire_ns]) — a u64 expiry (0 = no
    per-cell TTL) rides every entry so cell-TTL types work over the wire."""
    out.append(struct.pack(">I", len(entries)))
    for e in entries:
        _pb(out, e[0])
        _pb(out, e[1])
        out.append(struct.pack(">Q", e[2] if len(e) >= 3 else 0))


def _decode_additions(r: _Reader) -> EntryList:
    n = r.u32()
    out = []
    for _ in range(n):
        col, val = r.bytes_(), r.bytes_()
        exp = r.u64()
        out.append((col, val, exp) if exp else (col, val))
    return out


def _encode_slice(out: List[bytes], sq: SliceQuery) -> None:
    _pb(out, sq.start)
    _pb(out, sq.end if sq.end is not None else b"")
    out.append(struct.pack(">i", -1 if sq.limit is None else sq.limit))


def _decode_slice(r: _Reader) -> SliceQuery:
    start = r.bytes_()
    end = r.bytes_()
    (limit,) = struct.unpack_from(">i", r.data, r.off)
    r.off += 4
    return SliceQuery(start, end or None, None if limit < 0 else limit)


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("connection closed mid-frame")
        buf += chunk
    return bytes(buf)


#: a scan's row frames are written in batches of at least this many bytes
_SCAN_FLUSH_BYTES = 1 << 18

_U32 = struct.Struct(">I")


def _row_frame(key: bytes, entries: EntryList) -> bytes:
    """One row of a scan's stream, ``[u8 1][key][entries]``: the bytes
    ``_pb`` and ``_encode_entries`` write, in one join (the server's scan
    frames every row of the store)."""
    pack = _U32.pack
    parts = [b"\x01", pack(len(key)), key, pack(len(entries))]
    for col, val in entries:
        parts += (pack(len(col)), col, pack(len(val)), val)
    return b"".join(parts)


class _StreamReader:
    """The client's reader of a scan's row stream ``([u8 1][row])* [u8 0]``:
    it receives 1 MiB chunks and parses whole rows out of them, where a
    field-by-field ``recv`` would pay a syscall for each of a row's length
    prefixes. A row cut by the chunk's end is parsed again once the next
    chunk is in."""

    _CHUNK = 1 << 20

    def __init__(self, sock: socket.socket):
        self.sock = sock
        self.buf = b""
        self.off = 0

    def _more(self) -> None:
        """Keep the unparsed tail and append at least one more chunk."""
        chunk = self.sock.recv(self._CHUNK)
        if not chunk:
            raise ConnectionError("connection closed mid-frame")
        self.buf = self.buf[self.off:] + chunk
        self.off = 0

    def rows(self) -> Iterator[Tuple[bytes, EntryList, int]]:
        """(key, entries, key and cell bytes) for each row, to the end
        marker."""
        unpack = _U32.unpack_from
        while True:
            buf, off = self.buf, self.off
            try:
                if buf[off] == 0:
                    self.off = off + 1
                    return
                (kl,) = unpack(buf, off + 1)
                p = off + 5 + kl
                key = buf[off + 5:p]
                (n,) = unpack(buf, p)
                p += 4
                entries = []
                for _ in range(n):
                    (cl,) = unpack(buf, p)
                    p += 4
                    col = buf[p:p + cl]
                    p += cl
                    (vl,) = unpack(buf, p)
                    p += 4
                    entries.append((col, buf[p:p + vl]))
                    p += vl
                if p > len(buf):
                    raise IndexError
            except (IndexError, struct.error):
                self._more()
                continue
            self.off = p
            yield key, entries, p - off - 9 - 8 * n


# -------------------------------------------------------------------- server
class _Handler(socketserver.BaseRequestHandler):
    #: populated per flagged request by handle(); branch code accrues
    #: measured costs here and _reply prepends them to the OK frame
    _led = None
    _op_t0 = 0

    def handle(self):
        import time as _time

        mgr = self.server.manager  # type: ignore[attr-defined]
        sock = self.request
        pipe = None
        try:
            while True:
                try:
                    head = _recv_exact(sock, 5)
                except ConnectionError:
                    return
                (body_len,) = struct.unpack(">I", head[:4])
                raw = head[4]
                op = raw & ~_FLAG_MASK
                body = _recv_exact(sock, body_len) if body_len else b""
                if raw & _PIPELINE_FLAG:
                    if not getattr(self.server, "pipeline", True):
                        # a pre-pipeline server never strips the 0x10
                        # bit: the flagged op is simply unknown (byte-
                        # identical to real old-server behavior; a
                        # compliant client never sends this)
                        op = raw & ~(
                            _TRACE_FLAG | _LEDGER_FLAG | _DEADLINE_FLAG
                        )
                    else:
                        # pipelined framing (negotiated): every wire
                        # frame runs as one per-connection pool task —
                        # frames complete out of order, each sub-op
                        # replies with its own request id, and a
                        # frame's replies flush in one write
                        from janusgraph_tpu_torch.storage.pipeline import (
                            ServerPipeline,
                            _InlineReply,
                            iter_batch,
                        )

                        if pipe is None:
                            pipe = ServerPipeline(sock, workers=getattr(
                                self.server, "pipeline_workers", 4
                            ))
                        t_arr = _time.monotonic()
                        if op != _OP_BATCH and pipe.serve_inline_ok():
                            # sequential FAST traffic: serve on this
                            # thread — no pool handoff; concurrency and
                            # slow ops ride per-sub-op pool tasks below
                            self._serve_pipelined(
                                mgr, _InlineReply(pipe), raw, body, t_arr
                            )
                            pipe.note_duration(
                                _time.monotonic() - t_arr
                            )
                            continue
                        subs = (
                            list(iter_batch(body))
                            if op == _OP_BATCH else [(raw, body)]
                        )
                        for sub_raw, sub_body in subs:
                            pipe.submit_op(
                                self._serve_pipelined, mgr, sub_raw,
                                sub_body, t_arr,
                            )
                        continue
                ctx = None
                if raw & _TRACE_FLAG:
                    ctx, body = split_trace_prefix(body)
                budget_ms = None
                if raw & _DEADLINE_FLAG:
                    budget_ms, body = split_deadline_prefix(body)
                self._led = {} if raw & _LEDGER_FLAG else None
                self._op_t0 = _time.perf_counter_ns()
                try:
                    # the serving node inherits the caller's remaining
                    # budget: its own retries/backoff (e.g. a layered
                    # remote behind this manager) stop when the budget is
                    # spent, and an op arriving already-expired is refused
                    # without touching the store
                    with _deadline_guard(budget_ms):
                        if ctx is not None:
                            from janusgraph_tpu_torch.observability import tracer

                            # child span under the client's context: the
                            # storage node's ops join the caller's trace
                            with tracer.child_span(
                                ctx,
                                f"store.remote.{_OP_NAMES.get(op, op)}",
                                store_manager=getattr(mgr, "name", ""),
                            ) as sp:
                                self._dispatch(mgr, sock, op, body)
                                if self._led:
                                    # the storage node OWNS these
                                    # measurements: it annotates its own
                                    # span, the client merges the echo
                                    # without re-annotating
                                    sp.annotate(**{
                                        f"ledger.{k}": v
                                        for k, v in self._led.items()
                                        if k != "wall_ns"
                                    })
                        else:
                            self._dispatch(mgr, sock, op, body)
                # protocol boundary: the error is serialized to the client as a
                # temporary status frame, and the CLIENT retries
                except (TemporaryBackendError, ConnectionError) as e:
                    self._reply(sock, _STATUS_TEMP, str(e).encode())
                except Exception as e:  # noqa: BLE001 - protocol boundary
                    self._reply(sock, _STATUS_PERM, f"{type(e).__name__}: {e}".encode())
                finally:
                    self._led = None
        except (ConnectionResetError, BrokenPipeError):
            return
        finally:
            if pipe is not None:
                pipe.close()

    def _serve_pipelined(self, mgr, out, raw, body, t_arrival) -> None:
        """One pipelined sub-op: same per-op machinery as the sync path
        (trace child span, deadline guard, ledger echo) with the reply
        addressed by request id into the frame's reply buffer. Runs on
        a pool thread — all state is local, never on the handler
        instance."""
        import time as _time

        op = raw & ~_FLAG_MASK
        (req_id,) = struct.unpack_from(">I", body, 0)
        body = body[4:]
        ctx = None
        if raw & _TRACE_FLAG:
            ctx, body = split_trace_prefix(body)
        budget_ms = None
        if raw & _DEADLINE_FLAG:
            budget_ms, body = split_deadline_prefix(body)
            if budget_ms is not None:
                # time spent queued behind sibling sub-ops counts
                # against THIS op's budget (the sync path's dispatch
                # queue time is ~0, the pipelined path's is not)
                budget_ms -= (_time.monotonic() - t_arrival) * 1000.0
        led = {} if raw & _LEDGER_FLAG else None
        t0 = _time.perf_counter_ns()
        try:
            with _deadline_guard(budget_ms):
                if ctx is not None:
                    from janusgraph_tpu_torch.observability import tracer

                    with tracer.child_span(
                        ctx,
                        f"store.remote.{_OP_NAMES.get(op, op)}",
                        store_manager=getattr(mgr, "name", ""),
                        pipelined=True,
                    ) as sp:
                        payload = self._execute(mgr, op, body, led)
                        if led:
                            sp.annotate(**{
                                f"ledger.{k}": v
                                for k, v in led.items()
                                if k != "wall_ns"
                            })
                else:
                    payload = self._execute(mgr, op, body, led)
            if led is not None:
                from janusgraph_tpu_torch.observability.profiler import (
                    encode_ledger_block,
                )

                led["wall_ns"] = _time.perf_counter_ns() - t0
                payload = encode_ledger_block(led) + payload
            out.reply(req_id, _STATUS_OK, payload)
        # protocol boundary: the error is serialized to the client as a temporary status
        # frame addressed to this op's request id, and the CLIENT retries
        except (TemporaryBackendError, ConnectionError) as e:
            out.reply(req_id, _STATUS_TEMP, str(e).encode())
        except Exception as e:  # noqa: BLE001 - protocol boundary
            out.reply(
                req_id, _STATUS_PERM, f"{type(e).__name__}: {e}".encode()
            )

    def _reply(self, sock, status: int, body: bytes) -> None:
        if self._led is not None and status == _STATUS_OK:
            import time as _time

            from janusgraph_tpu_torch.observability.profiler import (
                encode_ledger_block,
            )

            self._led["wall_ns"] = _time.perf_counter_ns() - self._op_t0
            body = encode_ledger_block(self._led) + body
        sock.sendall(struct.pack(">IB", len(body), status) + body)

    def _dispatch(self, mgr, sock, op: int, body: bytes) -> None:
        r = _Reader(body)
        if op == _OP_FEATURES:
            f = mgr.features
            import json

            feats = {
                k: getattr(f, k)
                for k in (
                    "ordered_scan", "unordered_scan", "multi_query",
                    "batch_mutation", "key_consistent", "persists",
                    "cell_ttl", "timestamps",
                )
            }
            # protocol feature bits: this server accepts 0x80-flagged
            # frames carrying a trace header, 0x40-flagged frames asking
            # for a resource-ledger echo, 0x20-flagged frames carrying
            # a deadline prefix, and 0x10-flagged pipelined frames
            # (absent on old servers, so new clients degrade cleanly in
            # every dimension)
            if getattr(self.server, "trace_propagation", True):
                feats["trace"] = True
            if getattr(self.server, "ledger_echo", True):
                feats["ledger"] = True
            if getattr(self.server, "deadline_propagation", True):
                feats["deadline"] = True
            if getattr(self.server, "pipeline", True):
                feats["pipeline"] = True
            self._reply(sock, _STATUS_OK, json.dumps(feats).encode())
            return
        if op in (_OP_SCAN_ALL, _OP_SCAN_RANGE):
            txh = mgr.begin_transaction()
            store = mgr.open_database(r.str_())
            if op == _OP_SCAN_RANGE:
                key_start = r.bytes_()
                key_end = r.bytes_()
                sq = _decode_slice(r)
                query = KeyRangeQuery(key_start, key_end, sq)
            else:
                query = _decode_slice(r)
            # stream rows after an OK frame; [1][row]* then [0]. The row
            # frames go out in batches of _SCAN_FLUSH_BYTES: the bytes on
            # the wire are the same, the syscalls far fewer
            self._reply(sock, _STATUS_OK, b"")
            out: List[bytes] = []
            size = 0
            for key, entries in store.get_keys(query, txh):
                row = _row_frame(key, entries)
                out.append(row)
                size += len(row)
                if size >= _SCAN_FLUSH_BYTES:
                    sock.sendall(b"".join(out))
                    out, size = [], 0
            out.append(b"\x00")
            sock.sendall(b"".join(out))
            return
        self._reply(sock, _STATUS_OK, self._execute(mgr, op, body, self._led))

    def _execute(self, mgr, op: int, body: bytes, led) -> bytes:
        """One non-streaming op -> OK payload bytes. Shared by the sync
        dispatch and the pipelined per-sub-op path; raising serializes
        as a status frame in either framing."""
        r = _Reader(body)
        txh = mgr.begin_transaction()
        if op == _OP_GET_SLICE:
            store = mgr.open_database(r.str_())
            key = r.bytes_()
            sq = _decode_slice(r)
            entries = store.get_slice(KeySliceQuery(key, sq), txh)
            if led is not None:
                led["cells_read"] = len(entries)
                led["bytes_read"] = sum(
                    len(c) + len(v) for c, v in entries
                )
            out: List[bytes] = []
            _encode_entries(out, entries)
            return b"".join(out)
        if op == _OP_GET_SLICE_MULTI:
            store = mgr.open_database(r.str_())
            nkeys = r.u32()
            keys = [r.bytes_() for _ in range(nkeys)]
            sq = _decode_slice(r)
            res = store.get_slice_multi(keys, sq, txh)
            if led is not None:
                led["cells_read"] = sum(len(e) for e in res.values())
                led["bytes_read"] = sum(
                    len(c) + len(v)
                    for e in res.values() for c, v in e
                )
            out = [struct.pack(">I", len(keys))]
            for k in keys:
                _pb(out, k)
                _encode_entries(out, res.get(k, []))
            return b"".join(out)
        if op == _OP_MUTATE:
            store = mgr.open_database(r.str_())
            key = r.bytes_()
            adds = _decode_additions(r)
            ndels = r.u32()
            dels = [r.bytes_() for _ in range(ndels)]
            if led is not None:
                led["cells_written"] = len(adds) + ndels
                led["bytes_written"] = sum(
                    len(e[0]) + len(e[1]) for e in adds
                )
            store.mutate(key, adds, dels, txh)
            txh.commit()
            return b""
        if op == _OP_MUTATE_MANY:
            nstores = r.u32()
            muts: Dict[str, Dict[bytes, KCVMutation]] = {}
            for _ in range(nstores):
                sname = r.str_()
                nrows = r.u32()
                rows: Dict[bytes, KCVMutation] = {}
                for _ in range(nrows):
                    key = r.bytes_()
                    adds = _decode_additions(r)
                    ndels = r.u32()
                    dels = [r.bytes_() for _ in range(ndels)]
                    m = KCVMutation()
                    m.additions.extend(adds)
                    m.deletions.extend(dels)
                    rows[key] = m
                muts[sname] = rows
            if led is not None:
                led["cells_written"] = sum(
                    len(m.additions) + len(m.deletions)
                    for rows in muts.values() for m in rows.values()
                )
                led["bytes_written"] = sum(
                    len(e[0]) + len(e[1])
                    for rows in muts.values()
                    for m in rows.values() for e in m.additions
                )
            mgr.mutate_many(muts, txh)
            txh.commit()
            return b""
        if op == _OP_CLEAR:
            mgr.clear_storage()
            return b""
        if op == _OP_EXISTS:
            return b"\x01" if mgr.exists() else b"\x00"
        if op in (_OP_FEATURES, _OP_SCAN_ALL, _OP_SCAN_RANGE):
            # streaming/negotiation ops never ride pipelined frames
            raise PermanentBackendError(
                f"op {_OP_NAMES.get(op, op)} is not pipelineable"
            )
        raise PermanentBackendError(f"unknown op {op}")


class RemoteStoreServer:
    """Serve a KCVS manager over TCP (threaded; port 0 = ephemeral).
    ``trace_propagation=False`` serves the pre-trace features payload,
    ``ledger_echo=False`` the pre-ledger one, ``deadline_propagation=
    False`` the pre-deadline one, ``pipeline=False`` the pre-pipeline
    one — "old-featured" servers for compatibility tests and staged
    rollouts. ``pipeline_workers`` sizes the per-connection dispatch
    pool for pipelined frames (out-of-order completion depth)."""

    def __init__(self, manager, host: str = "127.0.0.1", port: int = 0,
                 trace_propagation: bool = True, ledger_echo: bool = True,
                 deadline_propagation: bool = True, pipeline: bool = True,
                 pipeline_workers: int = 4):
        class _Srv(socketserver.ThreadingTCPServer):
            allow_reuse_address = True
            daemon_threads = True
            # socketserver's backlog is 5: while the handler threads stream
            # scans, the accepting thread waits for the interpreter lock,
            # and the kernel drops the connections past the fifth, which
            # the client's kernel retries 1, 3, 7, 15, 31 s later
            request_queue_size = socket.SOMAXCONN

        self._srv = _Srv((host, port), _Handler)
        self._srv.manager = manager  # type: ignore[attr-defined]
        self._srv.trace_propagation = trace_propagation  # type: ignore[attr-defined]
        self._srv.ledger_echo = ledger_echo  # type: ignore[attr-defined]
        self._srv.deadline_propagation = deadline_propagation  # type: ignore[attr-defined]
        self._srv.pipeline = pipeline  # type: ignore[attr-defined]
        self._srv.pipeline_workers = pipeline_workers  # type: ignore[attr-defined]
        self.manager = manager
        self._thread: Optional[threading.Thread] = None

    @property
    def address(self) -> Tuple[str, int]:
        return self._srv.server_address  # type: ignore[return-value]

    def start(self) -> "RemoteStoreServer":
        self._thread = threading.Thread(
            target=self._srv.serve_forever, daemon=True, name="kcvs-server"
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        self._srv.shutdown()
        self._srv.server_close()


# -------------------------------------------------------------------- client
class _Conn:
    """One pooled connection; serialized per-request by its own lock."""

    def __init__(self, host: str, port: int, connect_timeout_s: float = 30.0):
        self.host, self.port = host, port
        self.connect_timeout_s = connect_timeout_s
        self.lock = threading.Lock()
        self.sock: Optional[socket.socket] = None

    def _connect(self):
        s = socket.create_connection(
            (self.host, self.port), timeout=self.connect_timeout_s
        )
        s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self.sock = s

    def request(self, op: int, body: bytes) -> Tuple[int, bytes, socket.socket]:
        """Send one request; return (status, body, sock) — sock is needed by
        streaming (scan) callers who continue reading row frames."""
        if self.sock is None:
            try:
                self._connect()
            except OSError as e:
                raise TemporaryBackendError(f"connect failed: {e}") from e
        try:
            self.sock.sendall(struct.pack(">IB", len(body), op) + body)
            head = _recv_exact(self.sock, 5)
            (blen,) = struct.unpack(">I", head[:4])
            status = head[4]
            payload = _recv_exact(self.sock, blen) if blen else b""
            return status, payload, self.sock
        except (OSError, ConnectionError) as e:
            # drop the broken socket so the next attempt redials
            try:
                self.sock.close()
            except OSError:
                pass
            self.sock = None
            raise TemporaryBackendError(f"request failed: {e}") from e


# hot-path handles (resolved once; per-op `from x import y` contends on
# the import lock across submitting threads)
_DEADLINE_MOD = None
_TRACER = None
_PROFILER_MOD = None


def _hot_mods():
    global _DEADLINE_MOD, _TRACER, _PROFILER_MOD
    if _DEADLINE_MOD is None:
        from janusgraph_tpu_torch.core import deadline as _d
        from janusgraph_tpu_torch.observability import tracer as _t
        from janusgraph_tpu_torch.observability import profiler as _p
        _DEADLINE_MOD, _TRACER, _PROFILER_MOD = _d, _t, _p
    return _DEADLINE_MOD, _TRACER, _PROFILER_MOD


class RemoteKCVStore(KeyColumnValueStore):
    def __init__(self, manager: "RemoteStoreManager", name: str):
        self._manager = manager
        self._name = name

    @property
    def name(self) -> str:
        return self._name

    def _count_read(self, fields, entries) -> None:
        """Fallback accounting against an old (pre-ledger) server: no echo
        came back, so count the decoded entries locally as the PRIMARY
        accrual (annotates the client-side span). A ledger-disabled client
        (resource_ledger=False — the "old client" compatibility mode)
        stays entirely ledger-oblivious."""
        if fields is not None or not self._manager.resource_ledger:
            return
        from janusgraph_tpu_torch.observability.profiler import (
            accrue,
            current_ledger,
        )

        if current_ledger() is not None:
            accrue(
                cells_read=len(entries),
                bytes_read=sum(len(c) + len(v) for c, v in entries),
            )

    def get_slice(self, query: KeySliceQuery, txh) -> EntryList:
        sl: List[bytes] = []
        _encode_slice(sl, query.slice)
        slice_bytes = b"".join(sl)
        out: List[bytes] = []
        _ps(out, self._name)
        _pb(out, query.key)
        # the merge hint lets the pipeline writer coalesce same-slice
        # getSlice ops from concurrent callers into ONE getSliceMulti
        # wire frame; the response demuxes back per key
        payload, fields = self._manager._call_ledger(
            _OP_GET_SLICE, b"".join(out) + slice_bytes,
            merge=("gs", self._name, query.key, slice_bytes),
        )
        entries = _decode_entries(_Reader(payload))
        self._count_read(fields, entries)
        return entries

    def get_slice_multi(self, keys, slice_query, txh):
        mgr = self._manager
        keys = list(keys)
        mux = (
            mgr._mux_for(_OP_GET_SLICE_MULTI)
            if (len(keys) > mgr.pipeline_multi_chunk
                and mgr._should_pipeline())
            else None
        )
        if mux is not None:
            # pipelined path under CONCURRENCY: chunk the key set into
            # sibling sub-frames gathered over the shared pipelined
            # sockets — in-flight chunks from many callers interleave
            # on few connections instead of convoying on the pool locks
            return self._slice_multi_pipelined(keys, slice_query)
        # client-side parallel multi-slice (reference: Backend.java:215-221
        # parallelizes multi-key reads on an executor; storage.
        # parallel-backend-ops): split the key set across the connection
        # pool so independent sockets serve chunks concurrently
        nconn = len(mgr._pool)
        if (mgr.parallel_ops and nconn > 1
                and len(keys) > mgr.parallel_slice_factor * nconn):
            chunk = -(-len(keys) // nconn)
            parts = [keys[i:i + chunk] for i in range(0, len(keys), chunk)]
            merged = {}
            for res in mgr._executor().map(
                lambda part: self._slice_multi_call(part, slice_query),
                parts,
            ):
                merged.update(res)
            return merged
        return self._slice_multi_call(keys, slice_query)

    def _multi_body(self, keys, slice_query) -> bytes:
        out: List[bytes] = []
        _ps(out, self._name)
        out.append(struct.pack(">I", len(keys)))
        for k in keys:
            _pb(out, k)
        _encode_slice(out, slice_query)
        return b"".join(out)

    def _slice_multi_pipelined(self, keys, slice_query):
        mgr = self._manager
        chunk = mgr.pipeline_multi_chunk
        parts = [keys[i:i + chunk] for i in range(0, len(keys), chunk)]
        results = mgr._pipe_gather(
            _OP_GET_SLICE_MULTI,
            [self._multi_body(p, slice_query) for p in parts],
        )
        merged = {}
        uncounted: List = []
        for payload, fields in results:
            res = _decode_multi_payload(payload)
            merged.update(res)
            if fields is None:
                # this chunk came back without a server echo: count its
                # decoded entries locally (per-chunk attribution)
                uncounted.extend(
                    e for entries in res.values() for e in entries
                )
        if uncounted:
            self._count_read(None, uncounted)
        return merged

    def _slice_multi_call(self, keys, slice_query):
        payload, fields = self._manager._call_ledger(
            _OP_GET_SLICE_MULTI, self._multi_body(keys, slice_query)
        )
        res = _decode_multi_payload(payload)
        self._count_read(
            fields, [e for entries in res.values() for e in entries]
        )
        return res

    def mutate(self, key, additions, deletions, txh) -> None:
        row: List[bytes] = []
        _pb(row, key)
        _encode_additions(row, additions)
        row.append(struct.pack(">I", len(deletions)))
        for col in deletions:
            _pb(row, col)
        row_bytes = b"".join(row)
        out: List[bytes] = []
        _ps(out, self._name)
        # the merge hint lets the writer fold same-store mutates from
        # concurrent callers into ONE mutateMany wire frame (the row
        # layout is shared between the two ops by construction)
        _payload, fields = self._manager._call_ledger(
            _OP_MUTATE, b"".join(out) + row_bytes,
            merge=("mu", self._name, key, row_bytes),
        )
        if fields is None and self._manager.resource_ledger:
            from janusgraph_tpu_torch.observability.profiler import (
                accrue,
                current_ledger,
            )

            if current_ledger() is not None:
                accrue(
                    cells_written=len(additions) + len(deletions),
                    bytes_written=sum(
                        len(e[0]) + len(e[1]) for e in additions
                    ),
                )

    def get_keys(self, query, txh) -> Iterator[Tuple[bytes, EntryList]]:
        out: List[bytes] = []
        _ps(out, self._name)
        if isinstance(query, KeyRangeQuery):
            op = _OP_SCAN_RANGE
            _pb(out, query.key_start)
            _pb(out, query.key_end)
            _encode_slice(out, query.slice)
        else:
            op = _OP_SCAN_ALL
            _encode_slice(out, query)
        # each scan gets a DEDICATED connection: the row stream occupies the
        # socket until exhausted, and a consumer abandoning the generator
        # mid-stream must not leave unread row bytes to desync a pooled
        # connection's next request — the private socket just closes.
        # Scans are never ledger-flagged (the row stream can't carry an
        # echo block); the client counts what it decodes instead.
        op, frame, _ = self._manager._frame(
            op, b"".join(out), allow_ledger=False
        )
        conn = _Conn(self._manager.host, self._manager.port)
        cells = scanned_bytes = 0
        try:
            status, payload, sock = conn.request(op, frame)
            if status != _STATUS_OK:
                _raise_status(status, payload)
            rows = _StreamReader(sock).rows()
            while True:
                try:
                    key, entries, nbytes = next(rows)
                except StopIteration:
                    break
                except OSError as e:
                    # a broken stream is a temporary failure: the scan's
                    # caller resumes from just past its last row
                    raise TemporaryBackendError(f"scan stream failed: {e}") from e
                cells += len(entries)
                scanned_bytes += nbytes
                yield key, entries
        finally:
            if conn.sock is not None:
                try:
                    conn.sock.close()
                except OSError:
                    pass
            if (cells or scanned_bytes) and self._manager.resource_ledger:
                from janusgraph_tpu_torch.observability.profiler import accrue

                accrue(cells_read=cells, bytes_read=scanned_bytes)


def _raise_status(status: int, payload: bytes):
    msg = payload.decode("utf-8", "replace")
    if status == _STATUS_TEMP:
        raise TemporaryBackendError(msg)
    raise PermanentBackendError(msg)


def _entries_payload(entries: EntryList) -> bytes:
    """Entries -> a single-getSlice OK payload (the pipeline demuxes a
    merged multi response into per-op payloads byte-identical to an
    unmerged reply, so callers decode one way)."""
    out: List[bytes] = []
    _encode_entries(out, entries)
    return b"".join(out)


def _decode_multi_payload(payload: bytes) -> Dict[bytes, EntryList]:
    """A getSliceMulti OK payload -> {key: entries}."""
    r = _Reader(payload)
    n = r.u32()
    res: Dict[bytes, EntryList] = {}
    for _ in range(n):
        key = r.bytes_()
        res[key] = _decode_entries(r)
    return res


class RemoteStoreManager(KeyColumnValueStoreManager):
    """Client-side manager speaking the remote KCVS protocol."""

    def __init__(self, host: str, port: int, pool_size: int = 4,
                 retry_time_s: float = 10.0,
                 backoff_base_s: Optional[float] = None,
                 backoff_max_s: Optional[float] = None,
                 parallel_ops: bool = True,
                 connect_timeout_s: float = 30.0,
                 max_attempts: int = 0,
                 parallel_slice_factor: int = 2,
                 breaker_enabled: bool = False,
                 breaker_failure_threshold: int = 5,
                 breaker_reset_ms: float = 1000.0,
                 breaker_half_open_probes: int = 1,
                 trace_propagation: bool = True,
                 resource_ledger: bool = True,
                 deadline_propagation: bool = True,
                 pipeline: bool = True,
                 pipeline_connections: int = 2,
                 pipeline_depth: int = 128,
                 pipeline_max_batch: int = 64,
                 pipeline_multi_chunk: int = 512,
                 pipeline_stall_ms: float = 200.0,
                 pipeline_coalesce_us: float = 150.0):
        self.host, self.port = host, port
        #: metrics.trace-propagation — attach the ambient TraceContext to
        #: op frames, but ONLY once the server's features payload
        #: negotiated the bit (None = not yet negotiated)
        self.trace_propagation = trace_propagation
        self._remote_trace: Optional[bool] = None
        #: metrics.resource-ledger — flag ops for a server-side cost echo
        #: (same negotiation discipline as tracing)
        self.resource_ledger = resource_ledger
        self._remote_ledger: Optional[bool] = None
        #: server.deadline.propagation — forward the ambient deadline's
        #: remaining budget on op frames (same negotiation discipline)
        self.deadline_propagation = deadline_propagation
        self._remote_deadline: Optional[bool] = None
        #: storage.remote.pipeline — route ops over pipelined async
        #: framing (storage/pipeline.py) once the server negotiates the
        #: `pipeline` feature bit; the sync pool stays the fallback for
        #: old servers, scans, and negotiation itself
        self.pipeline = pipeline
        self.pipeline_connections = pipeline_connections
        self.pipeline_depth = pipeline_depth
        self.pipeline_max_batch = pipeline_max_batch
        #: keys-per-sub-frame chunk for pipelined multi-slice reads:
        #: big prefetch batches split into chunks served concurrently
        #: by the server's per-connection pool
        self.pipeline_multi_chunk = pipeline_multi_chunk
        self.pipeline_stall_ms = pipeline_stall_ms
        self.pipeline_coalesce_us = pipeline_coalesce_us
        self._remote_pipeline: Optional[bool] = None
        self._mux = None
        self._mux_lock = threading.Lock()
        self._pipeline_fallback_noted = False
        #: concurrent _call_ledger calls right now (GIL-atomic += is
        #: fidelity enough): the ADAPTIVE routing signal — a manager
        #: with a single sequential caller takes the sync fast path
        #: (identical cost to the pre-pipeline client), and the
        #: pipelined mux engages the moment callers overlap
        self._calls_active = 0
        #: EWMA of recent op service time: pipelining pays when per-op
        #: LATENCY dominates (in-flight demand beyond the connection
        #: budget would otherwise convoy on the pool locks); against a
        #: fast backend the sync pool already schedules optimally and
        #: the mux machinery would only add CPU
        self._op_ewma_s = 0.0
        #: the KCVS client accounts cells/bytes itself (echo or local
        #: decode), so BackendTransaction must not count the same ops
        self.ledger_self_accounting = True
        self.retry_time_s = retry_time_s
        self.connect_timeout_s = connect_timeout_s
        self.max_attempts = max_attempts
        #: storage.parallel-backend-ops — client-side multi-slice fan-out
        self.parallel_ops = parallel_ops
        #: storage.remote.parallel-slice-factor — fan-out fires past
        #: factor x pool connections (below that, chunking overhead wins)
        self.parallel_slice_factor = parallel_slice_factor
        self._pool_executor = None
        self._executor_lock = threading.Lock()
        # per-CLIENT retry backoff (storage.backoff-base-ms/-max-ms):
        # tuning one graph's backend must not affect others in-process
        self.backoff_base_s = backoff_base_s
        self.backoff_max_s = backoff_max_s
        self._pool = [
            _Conn(host, port, connect_timeout_s) for _ in range(pool_size)
        ]
        self._pool_lock = threading.Lock()
        self._pool_idx = 0
        self._stores: Dict[str, RemoteKCVStore] = {}
        self._features: Optional[StoreFeatures] = None
        # circuit breaker (storage.breaker.*): a DOWN server makes every
        # attempt fail fast after the threshold instead of each caller
        # burning its full retry budget against a dead endpoint
        self.breaker = None
        if breaker_enabled:
            from janusgraph_tpu_torch.storage.circuit import CircuitBreaker

            self.breaker = CircuitBreaker(
                "storage.remote",
                failure_threshold=breaker_failure_threshold,
                reset_timeout_s=breaker_reset_ms / 1000.0,
                half_open_probes=breaker_half_open_probes,
            )

    def _executor(self):
        """Persistent fan-out pool for parallel multi-slice reads — per-call
        ThreadPoolExecutor creation would pay thread spawn/join on every
        batched backend read (hot under prefetch-heavy traversals)."""
        if self._pool_executor is None:
            from concurrent.futures import ThreadPoolExecutor

            with self._executor_lock:
                if self._pool_executor is None:
                    self._pool_executor = ThreadPoolExecutor(
                        max_workers=len(self._pool),
                        thread_name_prefix="kcvs-multislice",
                    )
        return self._pool_executor

    def _acquire(self) -> _Conn:
        with self._pool_lock:
            conn = self._pool[self._pool_idx % len(self._pool)]
            self._pool_idx += 1
            return conn

    def _frame_parts(
        self, op: int, allow_ledger: bool = True
    ) -> Tuple[int, bytes, bool, Optional[float]]:
        """(flags, trace_prefix, want_ledger, expires_at): the ambient
        trace context is encoded (trace flag) when there is one AND the
        server negotiated the trace feature bit; the ledger flag is set
        when an ambient ResourceLedger exists AND the server negotiated
        the ledger bit; the deadline flag when an ambient deadline exists
        AND the server negotiated it — the REMAINING budget is carried as
        ``expires_at`` (monotonic) and encoded at SEND time, so queue
        dwell in the pipelined path keeps charging the op. The first
        qualifying call triggers the (lazy) features negotiation; a
        server we can't reach yet just stays un-negotiated for this
        frame. ``allow_ledger=False`` for streaming ops (scans) — their
        response cannot carry a block, the client counts decoded rows
        instead."""
        if op == _OP_FEATURES:
            return 0, b"", False, None
        import time as _time

        _dl, tracer, _prof = _hot_mods()
        ctx = tracer.current_context() if self.trace_propagation else None
        led = (
            _prof.current_ledger()
            if (allow_ledger and self.resource_ledger)
            else None
        )
        budget = _dl.remaining_ms() if self.deadline_propagation else None
        if ctx is None and led is None and budget is None:
            return 0, b"", False, None
        if (self._remote_trace is None or self._remote_ledger is None
                or self._remote_deadline is None):
            try:
                _ = self.features
            # negotiation is best-effort: the frame just goes unflagged, and the op
            # itself will surface the failure through its own retry guard
            except (TemporaryBackendError, PermanentBackendError):
                return 0, b"", False, None
        flags = 0
        prefix = b""
        expires_at = None
        if budget is not None and self._remote_deadline:
            flags |= _DEADLINE_FLAG
            expires_at = _time.monotonic() + budget / 1000.0
        if ctx is not None and self._remote_trace:
            flags |= _TRACE_FLAG
            prefix = encode_trace_prefix(ctx)
        if led is not None and self._remote_ledger:
            flags |= _LEDGER_FLAG
        return flags, prefix, bool(flags & _LEDGER_FLAG), expires_at

    def _frame(
        self, op: int, body: bytes, allow_ledger: bool = True
    ) -> Tuple[int, bytes, bool]:
        """Synchronous-framing view of _frame_parts: (op|flags, body with
        prefixes prepended, want_ledger). The deadline prefix is encoded
        now — the sync path sends immediately. Trace prefix OUTSIDE the
        deadline prefix (the server strips trace first)."""
        import time as _time

        flags, prefix, want_ledger, expires_at = self._frame_parts(
            op, allow_ledger
        )
        if flags & _DEADLINE_FLAG:
            prefix = prefix + encode_deadline_prefix(
                max(0.0, (expires_at - _time.monotonic()) * 1000.0)
            )
        return op | flags, prefix + body, want_ledger

    def _call(self, op: int, body: bytes) -> bytes:
        """One wire call; a ledger echo on the response is merged into the
        ambient ledger (see _call_ledger for callers that need to know
        whether the echo happened)."""
        payload, _ = self._call_ledger(op, body)
        return payload

    def _mux_for(self, op: int):
        """The pipeline mux when this op should ride pipelined framing:
        enabled, negotiated, and not a negotiation/streaming op. Returns
        None on the sync path. A server that did NOT negotiate the bit
        notes a one-time negotiation fallback (counter + flight)."""
        if not self.pipeline or op == _OP_FEATURES:
            return None
        if self._remote_pipeline is None:
            try:
                _ = self.features
            # negotiation is best-effort: the op falls back to the sync path, whose own
            # retry guard surfaces the failure
            except (TemporaryBackendError, PermanentBackendError):
                return None
        if not self._remote_pipeline:
            if not self._pipeline_fallback_noted:
                self._pipeline_fallback_noted = True
                from janusgraph_tpu_torch.observability import (
                    flight_recorder,
                    registry,
                )

                registry.counter(
                    "storage.remote.pipeline.fallbacks"
                ).inc()
                flight_recorder.record(
                    "pipeline_fallback",
                    endpoint=f"{self.host}:{self.port}",
                    protocol="storage.remote",
                    reason="server did not negotiate the pipeline bit",
                )
            return None
        if self._mux is None:
            from janusgraph_tpu_torch.storage.pipeline import PipelineMux

            with self._mux_lock:
                if self._mux is None:
                    from janusgraph_tpu_torch.observability.profiler import (
                        split_ledger_block,
                    )

                    self._mux = PipelineMux(
                        self.host, self.port,
                        connections=self.pipeline_connections,
                        connect_timeout_s=self.connect_timeout_s,
                        depth=self.pipeline_depth,
                        max_batch=self.pipeline_max_batch,
                        stall_ms=self.pipeline_stall_ms,
                        coalesce_us=self.pipeline_coalesce_us,
                        metric_prefix="storage.remote",
                        batch_op=_OP_BATCH,
                        split_ledger=split_ledger_block,
                        encode_entries=_entries_payload,
                        decode_multi=_decode_multi_payload,
                    )
        return self._mux

    def _result_timeout(self) -> float:
        """Belt-and-suspenders bound on waiting for a pipelined response:
        the reader's socket timeout tears the connection down first in
        any real hang, failing the future with a temporary error."""
        return self.connect_timeout_s + self.retry_time_s

    #: ops slower than this engage pipelined routing under concurrency —
    #: a real storage node's service time (media + fabric RTT), not a
    #: loopback echo: against a microsecond backend the sync pool
    #: already schedules optimally and the mux would only add CPU
    _PIPELINE_LATENCY_GATE_S = 0.0006

    def _call_ledger(
        self, op: int, body: bytes, merge: Optional[tuple] = None
    ) -> Tuple[bytes, Optional[dict]]:
        self._calls_active += 1
        try:
            return self._call_ledger_inner(op, body, merge)
        finally:
            self._calls_active -= 1

    def _should_pipeline(self) -> bool:
        """Adaptive routing: pipelined framing engages when (a) callers
        overlap beyond what the sync pool can serve one-op-per-lock AND
        (b) per-op service time is latency-dominated — or when the mux
        already has ops in flight (stay engaged through a burst). A
        sequential caller, or a microsecond-fast backend, keeps the sync
        fast path and its exact pre-pipeline cost. Checked BEFORE any
        negotiation, so an idle/sequential manager performs no extra
        wire attempts (breaker accounting stays one event per op)."""
        if not self.pipeline:
            return False
        if self._mux is not None and self._mux.busy():
            return True
        return (
            self._calls_active > len(self._pool)
            and self._op_ewma_s > self._PIPELINE_LATENCY_GATE_S
        )

    def _call_ledger_inner(
        self, op: int, body: bytes, merge: Optional[tuple] = None
    ) -> Tuple[bytes, Optional[dict]]:
        mux = self._mux_for(op) if self._should_pipeline() else None
        if mux is not None:
            from janusgraph_tpu_torch.storage.pipeline import WireOp

            flags, prefix, want_ledger, expires_at = self._frame_parts(op)
            item = WireOp(
                op, flags, prefix, body, want_ledger=want_ledger,
                merge=merge, expires_at=expires_at,
            )
            timeout = self._result_timeout()

            def attempt():
                # one submit+wait is one network attempt: a per-op
                # failure (connection loss, temp status, injected fault)
                # fails THIS op's future only — sibling in-flight ops
                # complete, and the breaker counts exactly this op
                return mux.submit(item).result(timeout)

            guarded = attempt
            if self.breaker is not None:
                guarded = lambda: self.breaker.call(attempt)  # noqa: E731
            payload, fields = backend_op.execute(
                guarded,
                max_time_s=self.retry_time_s,
                base_delay_s=self.backoff_base_s,
                max_delay_s=self.backoff_max_s,
                max_attempts=self.max_attempts,
            )
            if want_ledger and fields is not None:
                from janusgraph_tpu_torch.observability.profiler import merge_echo

                # the reader thread split the echo; the MERGE happens
                # here on the caller's thread, inside its ambient ledger
                merge_echo(fields, layer="store.remote")
            return payload, fields
        op, body, want_ledger = self._frame(op, body)

        def attempt() -> bytes:
            import time as _time

            conn = self._acquire()
            with conn.lock:
                # the per-connection lock serializes request/response
                # framing on one socket — the SYNC path for sequential
                # callers, fast backends, old servers, and disabled
                # pipelining; the pipelined mux above engages when
                # latency-dominated concurrency outgrows the pool
                t0 = _time.monotonic()
                # adaptive/negotiated fallback only — conn.lock serializes sync framing
                # on this socket; latency-dominated concurrency rides the pipelined mux
                # instead
                status, payload, _sock = conn.request(op, body)
                # the true round-trip service time (lock wait excluded):
                # the adaptive gate's latency signal
                self._op_ewma_s = (
                    0.9 * self._op_ewma_s
                    + 0.1 * (_time.monotonic() - t0)
                )
            if status != _STATUS_OK:
                _raise_status(status, payload)
            return payload

        guarded = attempt
        if self.breaker is not None:
            # breaker INSIDE the retry guard: each network attempt is one
            # breaker event, and an open circuit raises CircuitOpenError
            # (permanent to the guard) so callers fail fast instead of
            # spinning out their whole backoff budget
            guarded = lambda: self.breaker.call(attempt)  # noqa: E731
        payload = backend_op.execute(
            guarded,
            max_time_s=self.retry_time_s,
            base_delay_s=self.backoff_base_s,
            max_delay_s=self.backoff_max_s,
            max_attempts=self.max_attempts,
        )
        fields = None
        if want_ledger:
            from janusgraph_tpu_torch.observability.profiler import (
                merge_echo,
                split_ledger_block,
            )

            fields, payload = split_ledger_block(payload)
            # the storage node measured (and span-annotated) these costs;
            # merge them into the caller's ledger without re-annotating
            merge_echo(fields, layer="store.remote")
        return payload, fields

    def _pipe_gather(
        self, op: int, bodies: List[bytes]
    ) -> List[Tuple[bytes, Optional[dict]]]:
        """Submit many sibling ops concurrently over the mux and gather
        (payload, fields) per op. With the breaker enabled the ops run
        through the standard guarded path serially instead, so every
        network attempt stays one breaker event."""
        mux = self._mux_for(op)
        if mux is None or self.breaker is not None:
            return [self._call_ledger(op, b) for b in bodies]
        from janusgraph_tpu_torch.storage.pipeline import WireOp

        flags, prefix, want_ledger, expires_at = self._frame_parts(op)
        items = [
            WireOp(op, flags, prefix, b, want_ledger=want_ledger,
                   expires_at=expires_at)
            for b in bodies
        ]
        futs = [mux.submit(it) for it in items]
        timeout = self._result_timeout()
        out: List[Tuple[bytes, Optional[dict]]] = []
        for it, fut in zip(items, futs):
            try:
                out.append(fut.result(timeout))
            except TemporaryBackendError:
                # replay just this op through the retry guard; siblings
                # already in flight are unaffected
                out.append(backend_op.execute(
                    lambda it=it: mux.submit(it).result(timeout),
                    max_time_s=self.retry_time_s,
                    base_delay_s=self.backoff_base_s,
                    max_delay_s=self.backoff_max_s,
                    max_attempts=self.max_attempts,
                ))
        if want_ledger:
            from janusgraph_tpu_torch.observability.profiler import merge_echo

            for _payload, fields in out:
                if fields is not None:
                    merge_echo(fields, layer="store.remote")
        return out

    @property
    def features(self) -> StoreFeatures:
        if self._features is None:
            import json

            remote = json.loads(self._call(_OP_FEATURES, b"").decode())
            # protocol capabilities, not store features: a missing key is
            # an old server — trace headers / ledger / deadline /
            # pipeline flags are never sent
            self._remote_trace = bool(remote.pop("trace", False))
            self._remote_ledger = bool(remote.pop("ledger", False))
            self._remote_deadline = bool(remote.pop("deadline", False))
            self._remote_pipeline = bool(remote.pop("pipeline", False))
            self._features = StoreFeatures(
                distributed=True,
                network_attached=True,  # peers beyond this process can write
                locking=False,       # consistent-key locker wraps this store
                transactional=False,  # autocommit per request (CQL model)
                multi_query=True,
                batch_mutation=True,
                **{k: v for k, v in remote.items()
                   if k not in ("multi_query", "batch_mutation")},
            )
        return self._features

    @property
    def name(self) -> str:
        return f"remote({self.host}:{self.port})"

    def open_database(self, name: str) -> RemoteKCVStore:
        if name not in self._stores:
            self._stores[name] = RemoteKCVStore(self, name)
        return self._stores[name]

    def begin_transaction(self, config: Optional[dict] = None) -> StoreTransaction:
        return StoreTransaction(config)

    def mutate_many(self, mutations, txh) -> None:
        out: List[bytes] = [struct.pack(">I", len(mutations))]
        for sname, rows in mutations.items():
            _ps(out, sname)
            out.append(struct.pack(">I", len(rows)))
            for key, m in rows.items():
                _pb(out, key)
                _encode_additions(out, m.additions)
                out.append(struct.pack(">I", len(m.deletions)))
                for col in m.deletions:
                    _pb(out, col)
        _payload, fields = self._call_ledger(_OP_MUTATE_MANY, b"".join(out))
        if fields is None and self.resource_ledger:
            from janusgraph_tpu_torch.observability.profiler import (
                accrue,
                current_ledger,
            )

            if current_ledger() is not None:
                accrue(
                    cells_written=sum(
                        len(m.additions) + len(m.deletions)
                        for rows in mutations.values()
                        for m in rows.values()
                    ),
                    bytes_written=sum(
                        len(e[0]) + len(e[1])
                        for rows in mutations.values()
                        for m in rows.values() for e in m.additions
                    ),
                )

    def close(self) -> None:
        if self._mux is not None:
            self._mux.close()
            self._mux = None
        if self._pool_executor is not None:
            self._pool_executor.shutdown(wait=False)
            self._pool_executor = None
        for conn in self._pool:
            with conn.lock:
                if conn.sock is not None:
                    try:
                        conn.sock.close()
                    except OSError:
                        pass
                    conn.sock = None

    def clear_storage(self) -> None:
        self._call(_OP_CLEAR, b"")

    def exists(self) -> bool:
        return self._call(_OP_EXISTS, b"") == b"\x01"
