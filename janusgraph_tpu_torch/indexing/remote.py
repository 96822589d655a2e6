"""The remote mixed-index provider — the port's copy of
``janusgraph_tpu/indexing/remote.py``: an ``IndexProvider`` served over
TCP (``RemoteIndexServer``) and its client (``RemoteIndexProvider``,
registered as ``index.search.backend = "remote"``; the reference's
deployment of an external index service, janusgraph-es).

Any in-process provider (memindex, localindex) can be served. The wire is
the remote store's (``storage/remote.py``): ``[len:4][op:1][body]`` ->
``[len:4][status:1][body]`` frames, pooled connections, the temporary /
permanent status split and the retry guard around every call, the trace,
ledger, deadline and pipeline flags negotiated by the trailing capability
bytes of the features reply. Idempotent ops (register, query, rawQuery,
totals, supports, exists) may ride pipelined frames; mutate and restore
stay synchronous and retry only the dial. Values travel in the attribute
serializer's self-describing ``[type_id:2][payload]`` frames, pickles
refused. The frames equal the reference's, so a port client talks to a
reference server and the other way round. Neither the server nor the
client imports torch.
"""

from __future__ import annotations

import socket
import socketserver
import struct
import threading
from typing import Dict, List, Optional, Tuple

from janusgraph_tpu_torch.core.attributes import Serializer
from janusgraph_tpu_torch.core.predicates import predicate_by_name
from janusgraph_tpu_torch.exceptions import (
    PermanentBackendError,
    TemporaryBackendError,
)
from janusgraph_tpu_torch.indexing.provider import (
    And,
    IndexEntry,
    IndexFeatures,
    IndexMutation,
    IndexProvider,
    IndexQuery,
    KeyInformation,
    Mapping,
    Not,
    Or,
    Order,
    PredicateCondition,
    RawQuery,
    register_index_provider,
)
from janusgraph_tpu_torch.storage import backend_op
from janusgraph_tpu_torch.storage.remote import (
    _DEADLINE_FLAG,
    _PIPELINE_FLAG,
    _FLAG_MASK,
    _LEDGER_FLAG,
    _TRACE_FLAG,
    _Conn,
    _deadline_guard,
    _pb,
    _ps,
    _raise_status,
    _Reader,
    _recv_exact,
    encode_deadline_prefix,
    encode_trace_prefix,
    split_deadline_prefix,
    split_trace_prefix,
)

_STATUS_OK = 0
_STATUS_TEMP = 1
_STATUS_PERM = 2

_OP_REGISTER = 1
_OP_MUTATE = 2
_OP_RESTORE = 3
_OP_QUERY = 4
_OP_RAW_QUERY = 5
_OP_TOTALS = 6
_OP_SUPPORTS = 7
_OP_EXISTS = 8
_OP_CLEAR = 9
_OP_FEATURES = 10
#: batch carrier for pipelined framing (storage/pipeline.iter_batch)
_OP_BATCH = 11

_OP_NAMES = {
    _OP_REGISTER: "register",
    _OP_MUTATE: "mutate",
    _OP_RESTORE: "restore",
    _OP_QUERY: "query",
    _OP_RAW_QUERY: "rawQuery",
    _OP_TOTALS: "totals",
    _OP_SUPPORTS: "supports",
    _OP_EXISTS: "exists",
    _OP_CLEAR: "clear",
    _OP_FEATURES: "features",
    _OP_BATCH: "pipelineBatch",
}

#: index ops that may ride pipelined frames: idempotent request/response
#: ops only — mutate/restore keep the sync dial-only-retry discipline
#: (their at-least-once hazards predate pipelining), and features is the
#: negotiation itself
_PIPELINEABLE_OPS = frozenset(
    (_OP_REGISTER, _OP_QUERY, _OP_RAW_QUERY, _OP_TOTALS, _OP_SUPPORTS,
     _OP_EXISTS)
)

#: one registry for the wire; user enums are not expected in index fields.
#: allow_pickle=False: a network peer must never be able to ship a pickle
#: payload into this process (see PickledObjectSerializer)
_SER = Serializer(allow_pickle=False)


# ------------------------------------------------------------------ encoding
def _pv(out: List[bytes], value) -> None:
    """Length-prefixed self-describing value frame."""
    _pb(out, _SER.write_object(value))


def _rv(r: _Reader):
    value, _ = _SER.read_object(r.bytes_())
    return value


def _encode_keyinfo(out: List[bytes], info: KeyInformation) -> None:
    out.append(struct.pack(">H", _SER.data_type_id(info.data_type)))
    _ps(out, info.mapping.value)
    _ps(out, info.cardinality)


def _decode_keyinfo(r: _Reader) -> KeyInformation:
    (tid,) = struct.unpack_from(">H", r.data, r.off)
    r.off += 2
    return KeyInformation(
        data_type=_SER.type_for_id(tid),
        mapping=Mapping(r.str_()),
        cardinality=r.str_(),
    )


def _encode_condition(out: List[bytes], cond) -> None:
    if isinstance(cond, PredicateCondition):
        out.append(b"\x00")
        _ps(out, cond.key)
        _ps(out, cond.predicate.name)
        _pv(out, cond.value)
    elif isinstance(cond, (And, Or)):
        out.append(b"\x01" if isinstance(cond, And) else b"\x02")
        out.append(struct.pack(">I", len(cond.children)))
        for c in cond.children:
            _encode_condition(out, c)
    elif isinstance(cond, Not):
        out.append(b"\x03")
        _encode_condition(out, cond.child)
    else:
        raise PermanentBackendError(
            f"unencodable condition {type(cond).__name__}"
        )


def _decode_condition(r: _Reader):
    tag = r.u8()
    if tag == 0:
        key = r.str_()
        pname = r.str_()
        pred = predicate_by_name(pname)
        if pred is None:
            raise PermanentBackendError(f"unknown predicate {pname!r}")
        return PredicateCondition(key, pred, _rv(r))
    if tag in (1, 2):
        n = r.u32()
        children = tuple(_decode_condition(r) for _ in range(n))
        return And(children) if tag == 1 else Or(children)
    if tag == 3:
        return Not(_decode_condition(r))
    raise PermanentBackendError(f"unknown condition tag {tag}")


def _encode_key_infos(out: List[bytes], key_infos) -> None:
    out.append(struct.pack(">I", len(key_infos)))
    for store, fields in key_infos.items():
        _ps(out, store)
        out.append(struct.pack(">I", len(fields)))
        for fname, info in fields.items():
            _ps(out, fname)
            _encode_keyinfo(out, info)


def _decode_key_infos(r: _Reader) -> Dict[str, Dict[str, KeyInformation]]:
    # explicit loops: the wire layout depends on strict read order, which
    # comprehension key/value evaluation order would leave implicit
    infos: Dict[str, Dict[str, KeyInformation]] = {}
    for _ in range(r.u32()):
        store = r.str_()
        fields: Dict[str, KeyInformation] = {}
        for _ in range(r.u32()):
            fname = r.str_()
            fields[fname] = _decode_keyinfo(r)
        infos[store] = fields
    return infos


def _encode_entries(out: List[bytes], entries: List[IndexEntry]) -> None:
    out.append(struct.pack(">I", len(entries)))
    for e in entries:
        _ps(out, e.field)
        _pv(out, e.value)


def _decode_entries(r: _Reader) -> List[IndexEntry]:
    entries = []
    for _ in range(r.u32()):
        field = r.str_()
        entries.append(IndexEntry(field, _rv(r)))
    return entries


def _encode_raw(out: List[bytes], q: RawQuery) -> None:
    _ps(out, q.query)
    out.append(struct.pack(">iI", -1 if q.limit is None else q.limit,
                           q.offset))


def _decode_raw(r: _Reader) -> RawQuery:
    query = r.str_()
    limit, offset = struct.unpack_from(">iI", r.data, r.off)
    r.off += 8
    return RawQuery(query, None if limit < 0 else limit, offset)


# -------------------------------------------------------------------- server
class _IndexHandler(socketserver.BaseRequestHandler):
    #: per flagged request: measured costs, prepended to the OK reply
    _led = None
    _op_t0 = 0

    def handle(self):
        import time as _time

        provider = self.server.provider  # type: ignore[attr-defined]
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
                        # pre-pipeline server: the 0x10 bit stays in the
                        # op byte -> unknown op (byte-identical old
                        # behavior; compliant clients never send this)
                        op = raw & ~(
                            _TRACE_FLAG | _LEDGER_FLAG | _DEADLINE_FLAG
                        )
                    else:
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
                            self._serve_pipelined(
                                provider, _InlineReply(pipe), raw, body,
                                t_arr,
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
                                self._serve_pipelined, provider,
                                sub_raw, sub_body, t_arr,
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
                    # inherit the caller's remaining budget (an op that
                    # arrives already-expired is refused permanently)
                    with _deadline_guard(budget_ms):
                        if ctx is not None:
                            from janusgraph_tpu_torch.observability import tracer

                            # the index node's op joins the caller's trace
                            with tracer.child_span(
                                ctx, f"index.remote.{_OP_NAMES.get(op, op)}"
                            ) as sp:
                                self._dispatch(provider, sock, op, body)
                                if self._led:
                                    # index node owns these measurements
                                    # (the client merges the echo
                                    # un-annotated)
                                    sp.annotate(**{
                                        f"ledger.{k}": v
                                        for k, v in self._led.items()
                                        if k != "wall_ns"
                                    })
                        else:
                            self._dispatch(provider, sock, op, body)
                except (TemporaryBackendError, ConnectionError) as e:
                    self._reply(sock, _STATUS_TEMP, str(e).encode())
                except Exception as e:  # noqa: BLE001 - protocol boundary
                    self._reply(
                        sock, _STATUS_PERM,
                        f"{type(e).__name__}: {e}".encode(),
                    )
                finally:
                    self._led = None
        except (ConnectionResetError, BrokenPipeError):
            return
        finally:
            if pipe is not None:
                pipe.close()

    def _serve_pipelined(self, provider, out, raw, body, t_arrival) -> None:
        """One pipelined index sub-op: per-op trace span, deadline
        guard, and ledger echo, replied by request id. Runs on a pool
        thread — all state local, never on the handler instance."""
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
                # dispatch-queue dwell counts against the op's budget
                budget_ms -= (_time.monotonic() - t_arrival) * 1000.0
        led = {} if raw & _LEDGER_FLAG else None
        t0 = _time.perf_counter_ns()
        try:
            with _deadline_guard(budget_ms):
                if ctx is not None:
                    from janusgraph_tpu_torch.observability import tracer

                    with tracer.child_span(
                        ctx, f"index.remote.{_OP_NAMES.get(op, op)}",
                        pipelined=True,
                    ) as sp:
                        payload = self._execute(provider, op, body, led)
                        if led:
                            sp.annotate(**{
                                f"ledger.{k}": v
                                for k, v in led.items()
                                if k != "wall_ns"
                            })
                else:
                    payload = self._execute(provider, op, body, led)
            if led is not None:
                from janusgraph_tpu_torch.observability.profiler import (
                    encode_ledger_block,
                )

                led["wall_ns"] = _time.perf_counter_ns() - t0
                payload = encode_ledger_block(led) + payload
            out.reply(req_id, _STATUS_OK, payload)
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

    def _dispatch(self, provider, sock, op: int, body: bytes) -> None:
        if op == _OP_FEATURES:
            self._reply(
                sock, _STATUS_OK, self._features_payload(provider)
            )
            return
        self._reply(
            sock, _STATUS_OK,
            self._execute(provider, op, body, self._led),
        )

    def _features_payload(self, provider) -> bytes:
        f = provider.features()
        out = [
            bytes([int(f.supports_document_ttl),
                   int(f.supports_custom_analyzer),
                   int(f.supports_geo),
                   int(f.supports_not_query_normal_form)]),
            struct.pack(">I", len(f.supports_cardinality)),
        ]
        for c in f.supports_cardinality:
            _ps(out, c)
        # trailing protocol-capability bytes, positional: [trace] then
        # [ledger] then [deadline] then [pipeline]. Old clients stop
        # reading after the cardinalities (or after however many
        # capability bytes they know), so extra bytes are invisible to
        # them; old servers simply end the payload earlier and new
        # clients negotiate the capability OFF. Every earlier byte is
        # always written when a later one is, so positions stay
        # unambiguous.
        trace_on = getattr(self.server, "trace_propagation", True)
        ledger_on = getattr(self.server, "ledger_echo", True)
        deadline_on = getattr(self.server, "deadline_propagation", True)
        pipeline_on = getattr(self.server, "pipeline", True)
        if trace_on or ledger_on or deadline_on or pipeline_on:
            out.append(b"\x01" if trace_on else b"\x00")
        if ledger_on or deadline_on or pipeline_on:
            out.append(b"\x01" if ledger_on else b"\x00")
        if deadline_on or pipeline_on:
            out.append(b"\x01" if deadline_on else b"\x00")
        if pipeline_on:
            out.append(b"\x01")
        return b"".join(out)

    def _execute(self, provider, op: int, body: bytes, led) -> bytes:
        """One index op -> OK payload bytes (shared by the sync
        dispatch and the pipelined per-sub-op path)."""
        r = _Reader(body)
        if op == _OP_REGISTER:
            store, key = r.str_(), r.str_()
            provider.register(store, key, _decode_keyinfo(r))
            return b""
        if op == _OP_MUTATE:
            muts: Dict[str, Dict[str, IndexMutation]] = {}
            for _ in range(r.u32()):
                store = r.str_()
                per_doc = muts.setdefault(store, {})
                for _ in range(r.u32()):
                    docid = r.str_()
                    flags = r.u8()
                    m = IndexMutation(
                        is_new=bool(flags & 1), is_deleted=bool(flags & 2)
                    )
                    m.additions.extend(_decode_entries(r))
                    m.deletions.extend(_decode_entries(r))
                    per_doc[docid] = m
            if led is not None:
                led["cells_written"] = sum(
                    len(m.additions) + len(m.deletions)
                    for per_doc in muts.values()
                    for m in per_doc.values()
                )
            provider.mutate(muts, _decode_key_infos(r))
            return b""
        if op == _OP_RESTORE:
            docs: Dict[str, Dict[str, List[IndexEntry]]] = {}
            for _ in range(r.u32()):
                store = r.str_()
                per_doc = docs.setdefault(store, {})
                for _ in range(r.u32()):
                    docid = r.str_()
                    per_doc[docid] = _decode_entries(r)
            provider.restore(docs, _decode_key_infos(r))
            return b""
        if op == _OP_QUERY:
            store = r.str_()
            cond = _decode_condition(r)
            orders = tuple(
                Order(r.str_(), bool(r.u8())) for _ in range(r.u32())
            )
            limit, offset = struct.unpack_from(">iI", r.data, r.off)
            r.off += 8
            q = IndexQuery(
                cond, orders, None if limit < 0 else limit, offset
            )
            hits = provider.query(store, q)
            if led is not None:
                led["index_hits"] = len(hits)
            out: List[bytes] = [struct.pack(">I", len(hits))]
            for h in hits:
                _ps(out, h)
            return b"".join(out)
        if op == _OP_RAW_QUERY:
            store = r.str_()
            hits = provider.raw_query(store, _decode_raw(r))
            if led is not None:
                led["index_hits"] = len(hits)
            out = [struct.pack(">I", len(hits))]
            for docid, score in hits:
                _ps(out, docid)
                out.append(struct.pack(">d", float(score)))
            return b"".join(out)
        if op == _OP_TOTALS:
            store = r.str_()
            n = provider.totals(store, _decode_raw(r))
            return struct.pack(">Q", n)
        if op == _OP_SUPPORTS:
            info = _decode_keyinfo(r)
            pred = predicate_by_name(r.str_())
            ok = pred is not None and provider.supports(info, pred)
            return b"\x01" if ok else b"\x00"
        if op == _OP_EXISTS:
            return b"\x01" if provider.exists() else b"\x00"
        if op == _OP_CLEAR:
            provider.clear_storage()
            return b""
        if op in (_OP_FEATURES, _OP_BATCH):
            raise PermanentBackendError(
                f"op {_OP_NAMES.get(op, op)} is not pipelineable"
            )
        raise PermanentBackendError(f"unknown index op {op}")


class RemoteIndexServer:
    """Serve any IndexProvider over TCP (threaded; port 0 = ephemeral).
    ``trace_propagation=False`` = the pre-trace features payload,
    ``ledger_echo=False`` the pre-ledger one, ``deadline_propagation=
    False`` the pre-deadline one ("old-featured" index servers for
    compatibility tests)."""

    def __init__(self, provider: IndexProvider, host: str = "127.0.0.1",
                 port: int = 0, trace_propagation: bool = True,
                 ledger_echo: bool = True,
                 deadline_propagation: bool = True,
                 pipeline: bool = True, pipeline_workers: int = 4):
        class _Srv(socketserver.ThreadingTCPServer):
            allow_reuse_address = True
            daemon_threads = True
            # the storage server's listen backlog (socketserver's is 5)
            request_queue_size = socket.SOMAXCONN

        self._srv = _Srv((host, port), _IndexHandler)
        self._srv.provider = provider  # type: ignore[attr-defined]
        self._srv.trace_propagation = trace_propagation  # type: ignore[attr-defined]
        self._srv.ledger_echo = ledger_echo  # type: ignore[attr-defined]
        self._srv.deadline_propagation = deadline_propagation  # type: ignore[attr-defined]
        self._srv.pipeline = pipeline  # type: ignore[attr-defined]
        self._srv.pipeline_workers = pipeline_workers  # type: ignore[attr-defined]
        self.provider = provider
        self._thread: Optional[threading.Thread] = None

    @property
    def address(self) -> Tuple[str, int]:
        return self._srv.server_address  # type: ignore[return-value]

    def start(self) -> "RemoteIndexServer":
        self._thread = threading.Thread(
            target=self._srv.serve_forever, daemon=True, name="index-server"
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        self._srv.shutdown()
        self._srv.server_close()


# -------------------------------------------------------------------- client
class RemoteIndexProvider(IndexProvider):
    """Client-side IndexProvider speaking the remote index protocol —
    the janusgraph-es analogue (RestElasticSearchClient.java:505: pooled
    REST client with request retries)."""

    name = "remote"

    def __init__(self, hostname: str = "127.0.0.1", port: int = 0,
                 pool_size: int = 4, retry_time_s: float = 10.0,
                 directory: str = None,
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
                 pipeline_coalesce_us: float = 150.0,
                 **_ignored):
        # `directory` accepted-and-ignored: open_index_provider passes the
        # local providers' kwargs through one call site (core/graph.py)
        if not hostname or int(port) <= 0:
            from janusgraph_tpu_torch.exceptions import ConfigurationError

            raise ConfigurationError(
                "index backend 'remote' requires index.search.hostname and "
                f"a positive index.search.port (got {hostname!r}:{port!r})"
            )
        self.host, self.port = hostname, int(port)
        self.retry_time_s = retry_time_s
        #: metrics.trace-propagation, gated on the server's negotiated
        #: capability byte (None = features not yet fetched)
        self.trace_propagation = trace_propagation
        self._remote_trace: Optional[bool] = None
        #: metrics.resource-ledger, gated on the second capability byte
        self.resource_ledger = resource_ledger
        self._remote_ledger: Optional[bool] = None
        #: server.deadline.propagation, gated on the third capability byte
        self.deadline_propagation = deadline_propagation
        self._remote_deadline: Optional[bool] = None
        #: index.search.pipeline, gated on the fourth capability byte:
        #: idempotent index ops (query/rawQuery/totals/supports/exists/
        #: register) ride pipelined frames once engaged; mutate/restore
        #: keep the sync dial-only-retry discipline
        self.pipeline = pipeline
        self.pipeline_connections = pipeline_connections
        self.pipeline_depth = pipeline_depth
        self.pipeline_max_batch = pipeline_max_batch
        self.pipeline_coalesce_us = pipeline_coalesce_us
        self._remote_pipeline: Optional[bool] = None
        self._mux = None
        self._mux_lock = threading.Lock()
        self._calls_active = 0
        self._op_ewma_s = 0.0
        #: the provider accounts index hits itself (echo or local
        #: fallback), so graph.mixed_index_query must not count them again
        self.ledger_self_accounting = True
        self._pool = [_Conn(self.host, self.port) for _ in range(pool_size)]
        # whether this thread's last _call carried a ledger echo (drives
        # the old-server fallback accounting in query/raw_query)
        self._tls = threading.local()
        self._pool_lock = threading.Lock()
        self._pool_idx = 0
        self._features: Optional[IndexFeatures] = None
        self._supports_memo: Dict[Tuple, bool] = {}
        # same storage.breaker.* machinery as the remote KCVS client: a
        # down index tier fails fast instead of serializing every commit
        # behind a full retry budget
        self.breaker = None
        if breaker_enabled:
            from janusgraph_tpu_torch.storage.circuit import CircuitBreaker

            self.breaker = CircuitBreaker(
                "index.remote",
                failure_threshold=breaker_failure_threshold,
                reset_timeout_s=breaker_reset_ms / 1000.0,
                half_open_probes=breaker_half_open_probes,
            )

    def _frame_parts(self, op: int):
        """Same negotiation as RemoteStoreManager._frame_parts: returns
        (flags, trace_prefix, want_ledger, expires_at); the deadline
        prefix is encoded at send time from expires_at."""
        if op == _OP_FEATURES:
            return 0, b"", False, None
        import time as _time

        from janusgraph_tpu_torch.core.deadline import remaining_ms
        from janusgraph_tpu_torch.observability import tracer
        from janusgraph_tpu_torch.observability.profiler import current_ledger

        ctx = tracer.current_context() if self.trace_propagation else None
        led = current_ledger() if self.resource_ledger else None
        budget = remaining_ms() if self.deadline_propagation else None
        if ctx is None and led is None and budget is None:
            return 0, b"", False, None
        if (self._remote_trace is None or self._remote_ledger is None
                or self._remote_deadline is None):
            try:
                self.features()
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

    def _frame(self, op: int, body: bytes):
        """Synchronous-framing view: (op|flags, body with prefixes,
        want_ledger) — trace prefix outside the deadline prefix."""
        import time as _time

        flags, prefix, want_ledger, expires_at = self._frame_parts(op)
        if flags & _DEADLINE_FLAG:
            prefix = prefix + encode_deadline_prefix(
                max(0.0, (expires_at - _time.monotonic()) * 1000.0)
            )
        return op | flags, prefix + body, want_ledger

    def _should_pipeline(self) -> bool:
        """Same adaptive gate as the remote KCVS client: engage when
        latency-dominated concurrency outgrows the pool, or while ops
        are already in flight on the mux."""
        if not self.pipeline:
            return False
        if self._mux is not None and self._mux.busy():
            return True
        from janusgraph_tpu_torch.storage.remote import RemoteStoreManager

        return (
            self._calls_active > len(self._pool)
            and self._op_ewma_s
            > RemoteStoreManager._PIPELINE_LATENCY_GATE_S
        )

    def _mux_for(self, op: int):
        """The pipeline mux when this op may ride pipelined framing
        (negotiated + enabled + idempotent op); None = sync path."""
        if not self.pipeline or op not in _PIPELINEABLE_OPS:
            return None
        if self._remote_pipeline is None:
            try:
                self.features()
            except (TemporaryBackendError, PermanentBackendError):
                return None
        if not self._remote_pipeline:
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
                        depth=self.pipeline_depth,
                        max_batch=self.pipeline_max_batch,
                        coalesce_us=self.pipeline_coalesce_us,
                        metric_prefix="index.remote",
                        batch_op=_OP_BATCH,
                        split_ledger=split_ledger_block,
                    )
        return self._mux

    def _call(self, op: int, body: bytes, idempotent: bool = True) -> bytes:
        """One wire call under the retry guard. Non-idempotent ops (mutate/
        restore: LIST-cardinality additions are not replay-safe) retry only
        the DIAL — once the request may have reached the server, a dropped
        connection surfaces as a permanent 'outcome unknown' error instead
        of an at-least-once resend duplicating index entries."""
        self._calls_active += 1
        try:
            return self._call_inner(op, body, idempotent)
        finally:
            self._calls_active -= 1

    def _call_inner(
        self, op: int, body: bytes, idempotent: bool = True
    ) -> bytes:
        mux = (
            self._mux_for(op)
            if (idempotent and self._should_pipeline()) else None
        )
        if mux is not None:
            from janusgraph_tpu_torch.storage.pipeline import WireOp

            flags, prefix, want_ledger, expires_at = self._frame_parts(op)
            item = WireOp(
                op, flags, prefix, body, want_ledger=want_ledger,
                expires_at=expires_at,
            )
            timeout = 30.0 + self.retry_time_s

            def pattempt():
                # one submit+wait = one network attempt: a failed op
                # fails only itself; siblings in flight complete
                return mux.submit(item).result(timeout)

            pguarded = pattempt
            if self.breaker is not None:
                pguarded = lambda: self.breaker.call(pattempt)  # noqa: E731
            payload, fields = backend_op.execute(
                pguarded, max_time_s=self.retry_time_s
            )
            if want_ledger:
                from janusgraph_tpu_torch.observability.profiler import (
                    merge_echo,
                )

                merge_echo(fields, layer="index.remote")
            self._tls.echoed = fields is not None
            return payload
        op, body, want_ledger = self._frame(op, body)

        def attempt() -> bytes:
            with self._pool_lock:
                conn = self._pool[self._pool_idx % len(self._pool)]
                self._pool_idx += 1
            with conn.lock:
                if conn.sock is None:
                    try:
                        conn._connect()
                    except OSError as e:
                        raise TemporaryBackendError(
                            f"connect failed: {e}"
                        ) from e
                try:
                    import time as _time

                    t0 = _time.monotonic()
                    status, payload, _sock = conn.request(op, body)
                    # adaptive-gate latency signal (lock wait excluded)
                    self._op_ewma_s = (
                        0.9 * self._op_ewma_s
                        + 0.1 * (_time.monotonic() - t0)
                    )
                except TemporaryBackendError:
                    if idempotent:
                        raise
                    raise PermanentBackendError(
                        "index mutation outcome unknown: connection lost "
                        "mid-request (not replayed; verify index state or "
                        "reindex)"
                    ) from None
            if status == _STATUS_TEMP and not idempotent:
                # a clean temporary-failure reply still means the provider
                # may have PARTIALLY applied the mutation before failing —
                # replaying would duplicate the applied entries
                raise PermanentBackendError(
                    "index mutation failed server-side with a temporary "
                    f"error (not replayed; outcome may be partial): "
                    f"{payload.decode('utf-8', 'replace')}"
                )
            if status != _STATUS_OK:
                _raise_status(status, payload)
            return payload

        guarded = attempt
        if self.breaker is not None:
            guarded = lambda: self.breaker.call(attempt)  # noqa: E731
        payload = backend_op.execute(guarded, max_time_s=self.retry_time_s)
        if want_ledger:
            from janusgraph_tpu_torch.observability.profiler import (
                merge_echo,
                split_ledger_block,
            )

            fields, payload = split_ledger_block(payload)
            # index node measured + span-annotated; merge un-annotated
            merge_echo(fields, layer="index.remote")
            self._tls.echoed = fields is not None
        else:
            self._tls.echoed = False
        return payload

    def features(self) -> IndexFeatures:
        if self._features is None:
            r = _Reader(self._call(_OP_FEATURES, b""))
            flags = [r.u8() for _ in range(4)]
            cards = tuple(r.str_() for _ in range(r.u32()))
            # trailing capability bytes, positional: [trace][ledger]; an
            # old server's payload ends earlier and the capability stays
            # off in whichever dimension is absent
            self._remote_trace = r.off < len(r.data) and r.u8() == 1
            self._remote_ledger = r.off < len(r.data) and r.u8() == 1
            self._remote_deadline = r.off < len(r.data) and r.u8() == 1
            self._remote_pipeline = r.off < len(r.data) and r.u8() == 1
            self._features = IndexFeatures(
                supports_document_ttl=bool(flags[0]),
                supports_cardinality=cards,
                supports_custom_analyzer=bool(flags[1]),
                supports_geo=bool(flags[2]),
                supports_not_query_normal_form=bool(flags[3]),
            )
        return self._features

    def register(self, store: str, key: str, info: KeyInformation) -> None:
        out: List[bytes] = []
        _ps(out, store)
        _ps(out, key)
        _encode_keyinfo(out, info)
        self._call(_OP_REGISTER, b"".join(out))

    def mutate(self, mutations, key_infos) -> None:
        out: List[bytes] = [struct.pack(">I", len(mutations))]
        for store, per_doc in mutations.items():
            _ps(out, store)
            out.append(struct.pack(">I", len(per_doc)))
            for docid, m in per_doc.items():
                _ps(out, docid)
                out.append(bytes([int(m.is_new) | (int(m.is_deleted) << 1)]))
                _encode_entries(out, m.additions)
                _encode_entries(out, m.deletions)
        _encode_key_infos(out, key_infos)
        self._call(_OP_MUTATE, b"".join(out), idempotent=False)

    def restore(self, documents, key_infos) -> None:
        out: List[bytes] = [struct.pack(">I", len(documents))]
        for store, per_doc in documents.items():
            _ps(out, store)
            out.append(struct.pack(">I", len(per_doc)))
            for docid, entries in per_doc.items():
                _ps(out, docid)
                _encode_entries(out, entries)
        _encode_key_infos(out, key_infos)
        self._call(_OP_RESTORE, b"".join(out), idempotent=False)

    def query(self, store: str, q: IndexQuery) -> List[str]:
        out: List[bytes] = []
        _ps(out, store)
        _encode_condition(out, q.condition)
        out.append(struct.pack(">I", len(q.orders)))
        for o in q.orders:
            _ps(out, o.key)
            out.append(bytes([int(o.desc)]))
        out.append(struct.pack(">iI", -1 if q.limit is None else q.limit,
                               q.offset))
        r = _Reader(self._call(_OP_QUERY, b"".join(out)))
        hits = [r.str_() for _ in range(r.u32())]
        self._count_hits(hits)
        return hits

    def _count_hits(self, hits) -> None:
        """Fallback accounting against an old (pre-ledger) index server:
        no echo came back, so the decoded hit count is the PRIMARY accrual
        (annotates the client-side span). A ledger-disabled client stays
        entirely ledger-oblivious."""
        if getattr(self._tls, "echoed", False) or not self.resource_ledger:
            return
        from janusgraph_tpu_torch.observability.profiler import (
            accrue,
            current_ledger,
        )

        if current_ledger() is not None:
            accrue(index_hits=len(hits))

    def raw_query(self, store: str, q: RawQuery) -> List[Tuple[str, float]]:
        out: List[bytes] = []
        _ps(out, store)
        _encode_raw(out, q)
        r = _Reader(self._call(_OP_RAW_QUERY, b"".join(out)))
        n = r.u32()
        hits = []
        for _ in range(n):
            docid = r.str_()
            (score,) = struct.unpack_from(">d", r.data, r.off)
            r.off += 8
            hits.append((docid, score))
        self._count_hits(hits)
        return hits

    def totals(self, store: str, q: RawQuery) -> int:
        out: List[bytes] = []
        _ps(out, store)
        _encode_raw(out, q)
        return struct.unpack(">Q", self._call(_OP_TOTALS, b"".join(out)))[0]

    def supports(self, info: KeyInformation, predicate) -> bool:
        memo_key = (
            info.data_type, info.mapping, info.cardinality, predicate.name
        )
        hit = self._supports_memo.get(memo_key)
        if hit is None:
            out: List[bytes] = []
            _encode_keyinfo(out, info)
            _ps(out, predicate.name)
            hit = self._call(_OP_SUPPORTS, b"".join(out)) == b"\x01"
            self._supports_memo[memo_key] = hit
        return hit

    def exists(self) -> bool:
        return self._call(_OP_EXISTS, b"") == b"\x01"

    def clear_storage(self) -> None:
        self._call(_OP_CLEAR, b"")

    def close(self) -> None:
        if self._mux is not None:
            self._mux.close()
            self._mux = None
        for conn in self._pool:
            with conn.lock:
                if conn.sock is not None:
                    try:
                        conn.sock.close()
                    except OSError:
                        pass
                    conn.sock = None


register_index_provider("remote", RemoteIndexProvider)
