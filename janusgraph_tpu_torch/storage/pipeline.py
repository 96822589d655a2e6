"""Pipelined async framing for the remote wire protocols — the port's copy
of ``janusgraph_tpu/storage/pipeline.py``, byte-equal on the wire in both
directions.

The synchronous framing (storage/remote.py) serializes one op per
round-trip under a per-connection lock: every getSlice pays a full wire
RTT plus two syscalls on each side, and concurrency is capped at the
pool size. This module is the amortize-per-message-cost fix (the same
principle PAPERS.md's propagation-blocking and communication-batching
papers apply to on-chip messages, applied to the wire): many in-flight
ops share few sockets, small ops coalesce into batched wire frames, and
responses complete out of order via per-frame request ids.

Wire format (negotiated — see the `pipeline` feature bit in
storage/remote.py; un-negotiated peers never see a
flagged frame):

  pipelined request:   [u32 len][u8 op|flags|0x10][u32 req_id]
                       [trace?][deadline?][payload]
  batch carrier:       [u32 len][u8 OP_BATCH|0x10][u32 nsub]
                       ([u32 sub_len][u8 op|flags|0x10][u32 req_id]
                        [trace?][deadline?][payload])*
  pipelined response:  [u32 len][u8 status|0x10][u32 req_id]
                       [ledger?][payload]

Request-id lifecycle: ids are per-connection u32 counters assigned at
encode time; the id is registered in the pending table BEFORE the frame
is written, popped when its response arrives (any order), and failed
with a TemporaryBackendError if the connection dies first. The carrier
frame has no id of its own — every reply names the individual op, so
trace contexts, ledger echoes, deadline refusals, breaker accounting,
and injected faults all attribute to the op, never the carrier.

Coalescing rules (client writer):
  * getSlice ops with the same (store, slice, trace context, flags)
    merge into ONE getSliceMulti sub-frame; the response is demuxed per
    key back to each op's future. Merged frames drop the ledger flag —
    each op falls back to counting its own decoded entries client-side,
    so per-op attribution survives the merge.
  * mutate ops with the same (store, trace context, flags) and distinct
    keys merge into ONE mutateMany sub-frame (a duplicate key starts a
    new group, preserving same-key order).
  * everything else rides the carrier as individual sub-frames — still
    one syscall per drained batch on each side.
  * merge groups never mix trace contexts; a merged frame's deadline is
    the MINIMUM of its members' budgets (never extends any op).

Backpressure: the send queue is BOUNDED (`pipeline-depth`); a submit
that blocks on a full queue past `pipeline-stall-ms` is a pipeline
stall (counter + flight event). The queue bound is the overload story —
a bounded buffer, not a hidden one.
"""

from __future__ import annotations

import queue
import socket
import struct
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

from janusgraph_tpu_torch.exceptions import (
    DeadlineExceededError,
    PermanentBackendError,
    TemporaryBackendError,
)

#: fourth flag bit of the op byte: the frame carries pipelined framing
#: ([u32 req_id] leads the body; responses echo it on status|0x10). Sent
#: only after the peer negotiated the `pipeline` capability.
PIPELINE_FLAG = 0x10

_STATUS_OK = 0
_STATUS_TEMP = 1
_STATUS_PERM = 2
#: low nibble of a pipelined status byte (high nibble carries the flag)
_STATUS_MASK = 0x0F



# hot-path module handles: resolved once, then plain global lookups —
# a `from x import y` per op would contend on the import lock across
# every submitting thread (measured at >15% CPU under load)
_R = None
_REG = None


def _remote_mod():
    global _R
    if _R is None:
        from janusgraph_tpu_torch.storage import remote
        _R = remote
    return _R


def _registry():
    global _REG
    if _REG is None:
        from janusgraph_tpu_torch.observability import registry
        _REG = registry
    return _REG


class WireOp:
    """One client op queued for pipelined submission. ``merge`` is the
    coalescing hint: None (unmergeable), ("gs", store, key, slice_bytes)
    for a getSlice, or ("mu", store, key, row_bytes) for a mutate.

    ``prefix`` carries the TRACE header only; the deadline prefix is
    encoded at frame-build time from ``expires_at`` so (a) the budget
    keeps shrinking while the op waits in the send queue, and (b) two
    ops under the same deadline scope still merge — their ambient
    remaining_ms differs by microseconds, which would defeat any
    byte-equality grouping on a pre-encoded prefix."""

    __slots__ = (
        "op", "flags", "prefix", "payload", "want_ledger", "merge",
        "expires_at",
    )

    def __init__(self, op: int, flags: int, prefix: bytes, payload: bytes,
                 want_ledger: bool = False, merge: Optional[tuple] = None,
                 expires_at: Optional[float] = None):
        self.op = op
        self.flags = flags
        self.prefix = prefix
        self.payload = payload
        self.want_ledger = want_ledger
        self.merge = merge
        self.expires_at = expires_at


class OpFuture:
    """Completion slot for one submitted op. First resolution wins
    (teardown and demux may race); ``result()`` re-raises failures.

    There is NO dedicated reader thread: ``result()`` drives the
    connection's leader/follower receive loop — the first waiter to win
    the receive lock becomes the leader, drains response frames (its own
    and every sibling's, completing their futures as they land), and on
    exit NUDGES one still-pending future so its waiter takes over
    leadership immediately (no polling gap). A single sequential caller
    therefore pays the same syscall pattern as the old synchronous path
    — send then recv on its own thread, zero handoffs — while
    concurrent callers get one leader amortizing wakeups for the whole
    in-flight set."""

    __slots__ = ("_cv", "_done", "_value", "_exc", "_nudged", "_conn",
                 "_ep")

    def __init__(self):
        self._cv = threading.Condition()
        self._done = False
        self._value = None
        self._exc: Optional[BaseException] = None
        self._nudged = False
        self._conn = None
        self._ep = None

    def bind(self, conn, ep) -> None:
        self._conn = conn
        self._ep = ep

    def set(self, value) -> None:
        with self._cv:
            if not self._done:
                self._value = value
                self._done = True
                self._cv.notify_all()

    def fail(self, exc: BaseException) -> None:
        with self._cv:
            if not self._done:
                self._exc = exc
                self._done = True
                self._cv.notify_all()

    def nudge(self) -> None:
        """Wake this future's waiter WITHOUT completing it — the
        leadership baton: 'the receive role is vacant, come drive it'."""
        with self._cv:
            self._nudged = True
            self._cv.notify_all()

    def done(self) -> bool:
        return self._done

    def wait_or_nudge(self, timeout: float) -> None:
        """Follower wait: returns on completion, on a leadership nudge
        (consumed), or after ``timeout`` (the safety net when a nudge
        target abandoned its wait)."""
        with self._cv:
            if self._nudged:
                self._nudged = False
                return
            if self._done:
                return
            self._cv.wait(timeout)
            self._nudged = False

    def result(self, timeout: Optional[float] = None):
        if not self._done and self._conn is not None:
            self._conn._await(self._ep, self, timeout)
        with self._cv:
            if not self._done:
                self._cv.wait(timeout)
            if not self._done:
                raise TemporaryBackendError(
                    "pipelined op timed out waiting for its response"
                )
            if self._exc is not None:
                raise self._exc
            return self._value


class _Pending:
    """Server-side-completion bookkeeping for one req_id."""

    __slots__ = ("kind", "future", "members", "want_ledger")

    def __init__(self, kind: str, future: Optional[OpFuture] = None,
                 members: Optional[list] = None, want_ledger: bool = False):
        self.kind = kind  # "single" | "gslice" | "mutate"
        self.future = future
        self.members = members  # [(future, key)] / [future]
        self.want_ledger = want_ledger


def _status_error(status: int, payload: bytes) -> Exception:
    msg = payload.decode("utf-8", "replace")
    if status == _STATUS_TEMP:
        return TemporaryBackendError(msg)
    return PermanentBackendError(msg)


class _Entry:
    """One queued (item, future) pair; ``sent`` flips when a combiner
    drains it onto the wire (the submitter spins on it — see submit)."""

    __slots__ = ("item", "fut", "sent")

    def __init__(self, item: WireOp, fut: OpFuture):
        self.item = item
        self.fut = fut
        self.sent = False


class _Epoch:
    """One connection lifetime: socket + bounded send queue + pending
    table. Teardown fails everything and the owning connection redials
    on the next submit."""

    __slots__ = (
        "sock", "sq", "pending", "lock", "alive", "next_id", "send_lock",
        "recv_lock", "last_frame_at", "last_window_at",
    )

    def __init__(self, sock: socket.socket, depth: int):
        self.sock = sock
        self.sq: "queue.Queue" = queue.Queue(maxsize=depth)
        self.pending: Dict[int, _Pending] = {}
        self.lock = threading.Lock()
        self.alive = True
        self.next_id = 1
        self.last_window_at = 0.0
        #: the combining lock: whoever holds it drains the send queue
        #: into batched wire frames (flat combining — no writer thread,
        #: no handoff when uncontended, amortized syscalls under load)
        self.send_lock = threading.Lock()
        #: the receive-leadership lock: the waiter holding it drains
        #: response frames for everyone (leader/follower — no reader
        #: thread, no handoff for the uncontended sequential caller)
        self.recv_lock = threading.Lock()
        self.last_frame_at = time.monotonic()


class PipelinedConnection:
    """One pipelined socket, flat-combining on the send side: the
    submitting thread that wins the send lock drains the bounded queue
    — its own op plus everything queued by contending threads — into
    coalesced wire frames, so an uncontended op pays zero thread
    handoffs and a contended burst amortizes one syscall over the whole
    batch. A reader thread completes futures by request id, in whatever
    order the server finishes. Restartable: a dead connection redials
    on the next submit, and every in-flight op fails with a
    TemporaryBackendError so the per-op retry guard replays it."""

    def __init__(self, host: str, port: int, index: int,
                 connect_timeout_s: float = 30.0, depth: int = 128,
                 max_batch: int = 64, stall_ms: float = 200.0,
                 coalesce_us: float = 150.0,
                 metric_prefix: str = "storage.remote",
                 batch_op: int = 0,
                 split_ledger: Optional[Callable] = None,
                 encode_entries: Optional[Callable] = None,
                 decode_multi: Optional[Callable] = None):
        self.host, self.port = host, port
        self.index = index
        self.connect_timeout_s = connect_timeout_s
        self.depth = depth
        self.max_batch = max_batch
        self.stall_ms = stall_ms
        #: group-commit window: with ops already in flight, the combiner
        #: yields briefly so sibling threads can enqueue before the
        #: frame seals (closed-loop callers resubmit in convoys — the
        #: window turns the convoy into one coalesced carrier). 0 = off;
        #: a truly idle connection never waits (fast path).
        self.coalesce_s = coalesce_us / 1e6
        self.metric_prefix = metric_prefix
        #: the protocol's batch-carrier opcode (store: 10, index: 11)
        self.batch_op = batch_op
        # protocol hooks (injected so this module stays codec-agnostic)
        self._split_ledger = split_ledger
        self._encode_entries = encode_entries
        self._decode_multi = decode_multi
        self._epoch: Optional[_Epoch] = None
        self._lifecycle = threading.Lock()
        self._last_stall_flight = 0.0
        self._metric_cache: Dict[str, object] = {}
        # hot-path stats accumulate as plain ints (GIL-atomic +=) and
        # flush to the locked registry every _FLUSH_EVERY ops — four
        # contended metric locks per op would serialize the very
        # concurrency this path exists to provide
        self._stat_ops = 0
        self._stat_frames = 0
        self._stat_merged = 0
        self._stat_unflushed = 0
        self._last_batch = 0
        self._last_stat_flush = time.monotonic()

    _FLUSH_EVERY = 64

    # ------------------------------------------------------------- metrics
    def _counter(self, name: str):
        c = self._metric_cache.get(name)
        if c is None:
            # graphlint: disable=JG110 -- prefix is one of two protocol literals and name a fixed counter vocabulary: bounded
            c = _registry().counter(
                f"{self.metric_prefix}.pipeline.{name}"
            )
            self._metric_cache[name] = c
        return c

    def _gauge(self, name: str):
        g = self._metric_cache.get(name)
        if g is None:
            # graphlint: disable=JG110 -- conn index is bounded by storage.remote.connection-pool-size; prefix/name are fixed sets
            g = _registry().gauge(
                f"{self.metric_prefix}.pipeline.conn{self.index}.{name}"
            )
            self._metric_cache[name] = g
        return g

    def _note(self, ops: int = 0, frames: int = 0, merged: int = 0,
              force: bool = False) -> None:
        self._stat_ops += ops
        self._stat_frames += frames
        self._stat_merged += merged
        self._stat_unflushed += ops + frames + merged
        if self._stat_unflushed >= self._FLUSH_EVERY or force or (
            self._stat_unflushed
            and time.monotonic() - self._last_stat_flush > 0.05
        ):
            self._flush_stats()

    def _flush_stats(self) -> None:
        self._stat_unflushed = 0
        self._last_stat_flush = time.monotonic()
        if self._stat_ops:
            self._counter("ops").inc(self._stat_ops)
            self._stat_ops = 0
        if self._stat_frames:
            self._counter("wire_frames").inc(self._stat_frames)
            self._stat_frames = 0
        if self._stat_merged:
            self._counter("merged_ops").inc(self._stat_merged)
            self._stat_merged = 0
        ep = self._epoch
        if ep is not None:
            self._gauge("in_flight").set(float(len(ep.pending)))
        if self._last_batch:
            self._gauge("ops_per_frame").set(float(self._last_batch))
            self._last_batch = 0

    def _set_gauges(self, in_flight: int,
                    ops_per_frame: Optional[int] = None) -> None:
        self._gauge("in_flight").set(float(in_flight))
        if ops_per_frame is not None:
            self._gauge("ops_per_frame").set(float(ops_per_frame))

    # ------------------------------------------------------------ lifecycle
    def load(self) -> int:
        ep = self._epoch
        if ep is None or not ep.alive:
            return 0
        return len(ep.pending) + ep.sq.qsize()

    def _start_epoch(self) -> _Epoch:
        try:
            sock = socket.create_connection(
                (self.host, self.port), timeout=self.connect_timeout_s
            )
        except OSError as e:
            raise TemporaryBackendError(f"connect failed: {e}") from e
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        # short recv timeout: the receive LEADER must periodically
        # re-check its own deadline and epoch health; sustained silence
        # with ops pending past connect_timeout_s tears the epoch down
        sock.settimeout(0.5)
        ep = _Epoch(sock, self.depth)
        self._epoch = ep
        return ep

    def _teardown(self, ep: _Epoch, exc: Exception) -> None:
        with ep.lock:
            was_alive = ep.alive
            ep.alive = False
            pending = list(ep.pending.values())
            ep.pending.clear()
        if not was_alive:
            pending = []
        try:
            ep.sock.close()
        except OSError:
            pass
        for p in pending:
            self._fail_pending(p, exc)
        self._drain_queue(ep, exc)
        with self._lifecycle:
            if self._epoch is ep:
                self._epoch = None
        self._set_gauges(0)

    def _drain_queue(self, ep: _Epoch, exc: Exception) -> None:
        while True:
            try:
                entry = ep.sq.get_nowait()
            except queue.Empty:
                return
            entry.sent = True
            entry.fut.fail(exc)

    @staticmethod
    def _fail_pending(p: _Pending, exc: Exception) -> None:
        if p.future is not None:
            p.future.fail(exc)
        for m in p.members or ():
            fut = m[0] if isinstance(m, tuple) else m
            fut.fail(exc)

    def close(self) -> None:
        self._flush_stats()
        ep = self._epoch
        if ep is not None:
            self._teardown(
                ep, TemporaryBackendError("pipelined connection closed")
            )

    # --------------------------------------------------------------- submit
    def submit(self, item: WireOp) -> OpFuture:
        fut = OpFuture()
        ep = self._epoch
        if ep is None or not ep.alive:
            with self._lifecycle:
                ep = self._epoch
                if ep is None or not ep.alive:
                    ep = self._start_epoch()
        fut.bind(self, ep)
        self._note(ops=1)
        # fast path: a truly idle connection (nothing in flight, nothing
        # queued) skips the queue/batch machinery — encode and send on
        # the caller thread. With ops IN FLIGHT we take the queue path
        # instead: in-flight siblings mean sibling submits are imminent
        # (closed-loop convoy), and the combiner's group-commit window
        # below coalesces them into one carrier.
        # try-acquire fast path: the immediately following try/finally releases on every
        # path
        # graphlint: disable=JG201 -- try-acquire fast path: the immediately following try/finally releases on every path
        if not ep.pending and ep.send_lock.acquire(blocking=False):
            direct = False
            try:
                if ep.sq.empty():
                    self._send_direct(ep, item, fut)
                    direct = True
            finally:
                ep.send_lock.release()
            if direct:
                return fut
        entry = _Entry(item, fut)
        try:
            ep.sq.put_nowait(entry)
        except queue.Full:
            # backpressure: the bounded queue is full — block, count the
            # stall, and surface it as a flight event (rate-limited)
            t0 = time.monotonic()
            try:
                ep.sq.put(entry, timeout=self.connect_timeout_s)
            except queue.Full:
                fut.fail(TemporaryBackendError(
                    "pipeline send queue full past the connect timeout"
                ))
                return fut
            waited_ms = (time.monotonic() - t0) * 1000.0
            if waited_ms >= self.stall_ms:
                self._counter("stalls").inc()
                now = time.monotonic()
                if now - self._last_stall_flight >= 1.0:
                    self._last_stall_flight = now
                    from janusgraph_tpu_torch.observability import flight_recorder

                    flight_recorder.record(
                        "pipeline_stall",
                        endpoint=f"{self.host}:{self.port}",
                        protocol=self.metric_prefix,
                        waited_ms=round(waited_ms, 1),
                        depth=self.depth,
                    )
        # flat combining: spin until OUR entry hits the wire — either we
        # win the send lock and drain the queue (ours plus every
        # contending thread's), or a concurrent combiner drains it for
        # us. Uncontended this is acquire/encode/sendall on the caller
        # thread; contended, one combiner amortizes one syscall over the
        # whole burst.
        while not entry.sent and not fut.done():
            # combining-loop try-acquire: the immediately following try/finally releases
            # on every path
            # graphlint: disable=JG201 -- combining-loop try-acquire: the immediately following try/finally releases on every path
            if not ep.send_lock.acquire(timeout=0.02):
                continue
            try:
                self._coalesce_window(ep)
                self._drain_and_send(ep)
            finally:
                ep.send_lock.release()
        if not ep.alive:
            # teardown raced the enqueue: make sure nothing is stranded
            self._drain_queue(
                ep, TemporaryBackendError("pipelined connection lost")
            )
        return fut

    def _send_direct(self, ep: _Epoch, item: WireOp, fut: OpFuture) -> None:
        """Encode and send ONE op as its own pipelined frame. Caller
        holds ep.send_lock."""
        _r = _remote_mod()
        now = time.monotonic()
        if item.expires_at is not None and now >= item.expires_at:
            _registry().counter(
                "storage.backend_op.deadline_expired"
            ).inc()
            self._counter("expired_in_queue").inc()
            fut.fail(DeadlineExceededError(
                "op deadline spent before the pipelined send"
            ))
            return
        prefix = item.prefix
        if item.flags & _r._DEADLINE_FLAG and item.expires_at is not None:
            prefix = prefix + _r.encode_deadline_prefix(
                max(0.0, (item.expires_at - now) * 1000.0)
            )
        pending = _Pending(
            "single", future=fut, want_ledger=item.want_ledger
        )
        req_id = self._register(ep, pending)
        body = struct.pack(">I", req_id) + prefix + item.payload
        frame = (
            struct.pack(
                ">IB", len(body), item.op | item.flags | PIPELINE_FLAG
            ) + body
        )
        try:
            # intentional: send half only under the combining lock (see _drain_and_send)
            ep.sock.sendall(frame)
        except (OSError, ConnectionError) as e:
            self._teardown(ep, TemporaryBackendError(
                f"pipelined send failed: {e}"
            ))
            return
        self._note(frames=1)

    def _coalesce_window(self, ep: _Epoch) -> None:
        """Group commit: with several ops in flight, their callers will
        resubmit as a convoy the moment the responses land — hold the
        frame open briefly so the convoy seals into ONE carrier (merged
        multi-gets, batched mutates) instead of trickling out as
        singles. ONE window per response burst: the first submitter
        after a quiet period opens it and collects the convoy;
        latecomers inside the same burst send immediately (a chain of
        back-to-back windows would serialize sends instead of batching
        them). Light concurrency (< 3 in flight) never waits."""
        if not self.coalesce_s:
            return
        in_flight = len(ep.pending)
        if in_flight < 3:
            return
        now = time.monotonic()
        if now - ep.last_window_at < 4 * self.coalesce_s:
            return
        ep.last_window_at = now
        target = min(self.max_batch, max(2, in_flight // 2))
        give_up = now + self.coalesce_s
        while ep.sq.qsize() < target and time.monotonic() < give_up:
            time.sleep(0.00005)  # park briefly; submitters fill the queue

    # ------------------------------------------------------------- combiner
    def _drain_and_send(self, ep: _Epoch) -> None:
        """Drain the send queue into coalesced wire frames (up to
        max_batch ops per frame) until empty. Caller holds ep.send_lock;
        the sendall under it is the SEND half only — never a round-trip
        — which is what retires the old one-lock-one-op design."""
        while True:
            batch: List[_Entry] = []
            while len(batch) < self.max_batch:
                try:
                    batch.append(ep.sq.get_nowait())
                except queue.Empty:
                    break
            if not batch:
                return
            for e in batch:
                e.sent = True
            buf, nops = self._encode_batch(ep, batch)
            if buf is None:
                continue
            try:
                # intentional: the combining lock serializes frame WRITES on this socket
                # (send half only, responses complete via the reader); holding it across
                # sendall is the flat-combining design
                ep.sock.sendall(buf)
            except (OSError, ConnectionError) as e2:
                self._teardown(ep, TemporaryBackendError(
                    f"pipelined send failed: {e2}"
                ))
                return
            self._last_batch = nops
            self._note(frames=1)

    def _register(self, ep: _Epoch, pending: _Pending) -> int:
        with ep.lock:
            req_id = ep.next_id
            ep.next_id = (ep.next_id + 1) & 0xFFFFFFFF or 1
            ep.pending[req_id] = pending
        return req_id

    def _encode_batch(
        self, ep: _Epoch, batch: List[_Entry]
    ) -> Tuple[Optional[bytes], int]:
        """Coalesce one drained batch into wire sub-frames, register the
        pending completions, and return (encoded buffer, op count)."""
        _r = _remote_mod()
        now = time.monotonic()
        singles: List[Tuple[WireOp, OpFuture]] = []
        groups: Dict[tuple, list] = {}
        nops = 0
        for e in batch:
            item, fut = e.item, e.fut
            if fut.done():
                continue  # failed while queued (teardown race)
            if item.expires_at is not None and now >= item.expires_at:
                # per-op deadline spent while queued: refuse client-side,
                # exactly like backend_op's pre-dispatch check — the op
                # never touches the wire
                _registry().counter(
                    "storage.backend_op.deadline_expired"
                ).inc()
                self._counter("expired_in_queue").inc()
                fut.fail(DeadlineExceededError(
                    "op deadline spent while queued in the pipeline"
                ))
                continue
            nops += 1
            if item.merge is not None:
                key = (item.merge[0], item.merge[1],
                       item.merge[3] if item.merge[0] == "gs" else b"",
                       item.prefix, item.flags & ~_r._LEDGER_FLAG)
                groups.setdefault(key, []).append((item, fut))
            else:
                singles.append((item, fut))
        subframes: List[bytes] = []

        def _budget_ms(item: WireOp) -> Optional[float]:
            if not item.flags & _r._DEADLINE_FLAG or item.expires_at is None:
                return None
            return max(0.0, (item.expires_at - now) * 1000.0)

        def _sub(raw_op: int, req_id: int, item_prefix: bytes,
                 payload: bytes, budget: Optional[float]) -> bytes:
            # the deadline prefix is encoded NOW, from the remaining
            # budget at send time: queue dwell is charged to the op
            prefix = item_prefix
            if budget is not None:
                prefix = prefix + _r.encode_deadline_prefix(budget)
            body = struct.pack(">I", req_id) + prefix + payload
            return struct.pack(">IB", len(body), raw_op | PIPELINE_FLAG) + body

        for (kind, store, _sl, prefix, gflags), members in groups.items():
            if len(members) == 1:
                singles.append(members[0])
                continue
            self._note(merged=len(members))
            budgets = [
                b for b in (_budget_ms(it) for it, _f in members)
                if b is not None
            ]
            # a merged frame's deadline is the MINIMUM of its members'
            # remaining budgets — it never extends any op's deadline
            budget = min(budgets) if budgets else None
            if kind == "gs":
                subframes.append(self._merge_gslice(
                    ep, store, prefix, gflags, members, _sub, budget
                ))
            else:
                subframes.extend(self._merge_mutate(
                    ep, store, prefix, gflags, members, _sub, budget
                ))
        for item, fut in singles:
            pending = _Pending(
                "single", future=fut, want_ledger=item.want_ledger
            )
            req_id = self._register(ep, pending)
            subframes.append(_sub(
                item.op | item.flags, req_id, item.prefix, item.payload,
                _budget_ms(item),
            ))
        if not subframes:
            return None, 0
        if len(subframes) == 1:
            return subframes[0], nops
        head = struct.pack(">I", len(subframes))
        body = head + b"".join(subframes)
        return (
            struct.pack(">IB", len(body), self.batch_op | PIPELINE_FLAG)
            + body,
            nops,
        )

    def _merge_gslice(self, ep, store, prefix, flags, members, _sub,
                      budget) -> bytes:
        """k getSlice ops, same (store, slice, context) -> one
        getSliceMulti sub-frame over the distinct keys."""
        _r = _remote_mod()
        slice_bytes = members[0][0].merge[3]
        keys: List[bytes] = []
        seen = set()
        futs: List[Tuple[OpFuture, bytes]] = []
        for item, fut in members:
            k = item.merge[2]
            if k not in seen:
                seen.add(k)
                keys.append(k)
            futs.append((fut, k))
        out: List[bytes] = []
        sb = store.encode()
        out.append(struct.pack(">I", len(sb)))
        out.append(sb)
        out.append(struct.pack(">I", len(keys)))
        for k in keys:
            out.append(struct.pack(">I", len(k)))
            out.append(k)
        out.append(slice_bytes)
        pending = _Pending("gslice", members=futs)
        req_id = self._register(ep, pending)
        # merged frames never carry the ledger flag: the echo could not
        # attribute to one op, so each member counts its own decoded
        # entries client-side instead (the documented fallback path)
        return _sub(
            _r._OP_GET_SLICE_MULTI | flags, req_id, prefix,
            b"".join(out), budget,
        )

    def _merge_mutate(self, ep, store, prefix, flags, members, _sub, budget):
        """k mutate ops, same (store, context), distinct keys -> one
        mutateMany sub-frame; a duplicate key starts a new group so
        same-key ordering is preserved."""
        from janusgraph_tpu_torch.storage import remote as _r

        frames: List[bytes] = []
        group: List[Tuple[WireOp, OpFuture]] = []
        seen: set = set()

        def _flush():
            if not group:
                return
            sb = store.encode()
            out = [struct.pack(">I", 1), struct.pack(">I", len(sb)), sb,
                   struct.pack(">I", len(group))]
            futs = []
            for item, fut in group:
                out.append(item.merge[3])  # [key][adds][ndels][dels]
                futs.append(fut)
            pending = _Pending("mutate", members=futs)
            req_id = self._register(ep, pending)
            frames.append(_sub(
                _r._OP_MUTATE_MANY | flags, req_id, prefix,
                b"".join(out), budget,
            ))
            group.clear()
            seen.clear()

        for item, fut in members:
            k = item.merge[2]
            if k in seen:
                _flush()
            seen.add(k)
            group.append((item, fut))
        _flush()
        return frames

    # ------------------------------------------------- leader/follower recv
    def _await(self, ep: _Epoch, fut: OpFuture,
               timeout: Optional[float]) -> None:
        """Drive completion of ``fut``: become the receive leader when
        the role is free (drain frames for EVERY waiter), otherwise
        follow — wait for completion or a leadership nudge. A leader
        that finishes with siblings still pending nudges one of them on
        the way out, so the receive role never sits vacant behind a
        polling interval."""
        deadline = (
            None if timeout is None else time.monotonic() + timeout
        )
        while not fut.done():
            # leader/follower try-acquire: the immediately following try/finally
            # releases (and hands leadership off) on every path
            # graphlint: disable=JG201 -- leader/follower try-acquire: the immediately following try/finally releases (and hands leadership off) on every path
            if ep.recv_lock.acquire(blocking=False):
                try:
                    while not fut.done() and ep.alive:
                        if not self._recv_one(ep):
                            break
                        if (deadline is not None
                                and time.monotonic() >= deadline):
                            break
                    # greedy drain: responses already buffered on the
                    # socket are FREE to demux now — without this, each
                    # buffered frame would cost the next leader a full
                    # thread wakeup (leadership churn serializes the
                    # response burst at one wake per op)
                    if fut.done() and ep.alive:
                        self._drain_buffered(ep)
                finally:
                    ep.recv_lock.release()
                    self._handoff(ep)
                if fut.done():
                    return
            else:
                # follower: our future completes the instant the leader
                # demuxes our frame; the timeout is only the safety net
                # for a dropped baton (nudge target stopped waiting)
                fut.wait_or_nudge(0.05)
            if not ep.alive:
                fut.fail(TemporaryBackendError("pipelined connection lost"))
                return
            if deadline is not None and time.monotonic() >= deadline:
                return  # result() raises the timeout

    def _drain_buffered(self, ep: _Epoch) -> None:
        """Demux every response frame already sitting in the socket
        buffer (bounded). Caller holds ep.recv_lock."""
        import select

        for _ in range(256):
            try:
                r, _w, _x = select.select([ep.sock], [], [], 0)
            except (OSError, ValueError):
                return
            if not r:
                return
            if not self._recv_one(ep):
                return

    def _handoff(self, ep: _Epoch) -> None:
        """Pass receive leadership: nudge one pending future's waiter so
        it contends for the (now free) recv lock immediately."""
        nxt: Optional[OpFuture] = None
        with ep.lock:
            for p in ep.pending.values():
                if p.future is not None:
                    nxt = p.future
                elif p.members:
                    m = p.members[0]
                    nxt = m[0] if isinstance(m, tuple) else m
                if nxt is not None:
                    break
        if nxt is not None:
            nxt.nudge()

    @staticmethod
    def _recv_rest(sock: socket.socket, buf: bytes, n: int,
                   budget_s: float) -> bytes:
        """Finish reading an n-byte chunk we are already committed to
        (mid-frame): short recv timeouts retry until the silence budget
        is spent — abandoning a partial frame would desync the stream,
        so past the budget the connection is torn down instead."""
        out = bytearray(buf)
        give_up = time.monotonic() + budget_s
        while len(out) < n:
            try:
                chunk = sock.recv(n - len(out))
            except socket.timeout:
                if time.monotonic() >= give_up:
                    raise ConnectionError(
                        "pipelined response stalled mid-frame"
                    ) from None
                continue
            if not chunk:
                raise ConnectionError("connection closed mid-frame")
            out += chunk
        return bytes(out)

    def _recv_one(self, ep: _Epoch) -> bool:
        """Receive and demux ONE response frame. Returns False when the
        caller should re-evaluate (clean timeout tick with no frame byte
        consumed); tears the epoch down on connection failure or
        sustained silence with ops pending."""
        sock = ep.sock
        try:
            try:
                first = sock.recv(5)
            except socket.timeout:
                # clean tick (no bytes consumed): fatal only when the
                # silence with ops pending outlives the connect timeout
                with ep.lock:
                    waiting = bool(ep.pending)
                if waiting and (
                    time.monotonic() - ep.last_frame_at
                    > self.connect_timeout_s
                ):
                    self._teardown(ep, TemporaryBackendError(
                        "pipelined response timed out"
                    ))
                return False
            if not first:
                raise ConnectionError("connection closed")
            head = self._recv_rest(sock, first, 5, self.connect_timeout_s)
            (blen,) = struct.unpack(">I", head[:4])
            status_raw = head[4]
            payload = (
                self._recv_rest(sock, b"", blen, self.connect_timeout_s)
                if blen else b""
            )
            if len(payload) < 4 or not status_raw & PIPELINE_FLAG:
                raise ConnectionError(
                    "non-pipelined frame on a pipelined connection"
                )
            (req_id,) = struct.unpack_from(">I", payload, 0)
            rest = payload[4:]
        except (OSError, ConnectionError, struct.error, ValueError) as e:
            self._teardown(ep, TemporaryBackendError(
                f"pipelined receive failed: {e}"
            ))
            return False
        ep.last_frame_at = time.monotonic()
        with ep.lock:
            pending = ep.pending.pop(req_id, None)
        if pending is not None:
            self._complete(pending, status_raw & _STATUS_MASK, rest)
        return True

    def _complete(self, p: _Pending, status: int, rest: bytes) -> None:
        if status != _STATUS_OK:
            self._fail_pending(p, _status_error(status, rest))
            return
        if p.kind == "single":
            fields = None
            if p.want_ledger and self._split_ledger is not None:
                fields, rest = self._split_ledger(rest)
            p.future.set((rest, fields))
            return
        if p.kind == "mutate":
            for fut in p.members:
                fut.set((b"", None))
            return
        # gslice: decode the multi payload once, hand each member its
        # own key's entries re-encoded as a single-slice payload — the
        # callers' decode path (and per-op fallback accounting) is
        # byte-identical to an unmerged response
        try:
            res = self._decode_multi(rest)
        except Exception as e:  # noqa: BLE001 - torn payload
            self._fail_pending(p, TemporaryBackendError(
                f"merged multi-slice payload undecodable: {e}"
            ))
            return
        for fut, key in p.members:
            fut.set((self._encode_entries(res.get(key, [])), None))


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("connection closed mid-frame")
        buf += chunk
    return bytes(buf)


class PipelineMux:
    """Connection multiplexer: many in-flight ops share few pipelined
    sockets. submit() routes to the least-loaded connection."""

    def __init__(self, host: str, port: int, connections: int = 2,
                 **conn_kwargs):
        self._conns = [
            PipelinedConnection(host, port, i, **conn_kwargs)
            for i in range(max(1, connections))
        ]
        self._rr = 0

    def submit(self, item: WireOp) -> OpFuture:
        # lock-free round robin (the GIL makes the increment atomic
        # enough: a rare duplicate index is harmless): a least-loaded
        # scan would take every connection's queue lock on every op
        self._rr = (self._rr + 1) % len(self._conns)
        return self._conns[self._rr].submit(item)

    def close(self) -> None:
        for c in self._conns:
            c.close()

    def flush_stats(self) -> None:
        """Push every connection's locally-batched counters/gauges into
        the registry NOW (they otherwise flush every 64 ops / 50 ms of
        activity / on close)."""
        for c in self._conns:
            c._flush_stats()

    def in_flight(self) -> int:
        return sum(c.load() for c in self._conns)

    def busy(self) -> bool:
        """Cheap concurrency probe (no locks): True when any connection
        has ops in flight."""
        for c in self._conns:
            ep = c._epoch
            if ep is not None and ep.pending:
                return True
        return False


# ---------------------------------------------------------------- server side
class _InlineReply:
    """Immediate reply writer for inline-served (sequential) frames."""

    __slots__ = ("_pipe",)

    def __init__(self, pipe: "ServerPipeline"):
        self._pipe = pipe

    def reply(self, req_id: int, status: int, body: bytes) -> None:
        self._pipe.write(
            struct.pack(">IB", len(body) + 4, status | PIPELINE_FLAG)
            + struct.pack(">I", req_id) + body
        )


class _ReplyBuffer:
    """Accumulates one carrier's pipelined response frames and flushes
    them in ONE write under the connection's write lock — the receive
    syscall amortization, mirrored on the reply side."""

    __slots__ = ("_pipe", "_parts", "_size")

    _FLUSH_BYTES = 1 << 16

    def __init__(self, pipe: "ServerPipeline"):
        self._pipe = pipe
        self._parts: List[bytes] = []
        self._size = 0

    def reply(self, req_id: int, status: int, body: bytes) -> None:
        frame = (
            struct.pack(">IB", len(body) + 4, status | PIPELINE_FLAG)
            + struct.pack(">I", req_id) + body
        )
        self._parts.append(frame)
        self._size += len(frame)
        if self._size >= self._FLUSH_BYTES:
            self.flush()

    def flush(self) -> None:
        if not self._parts:
            return
        buf = b"".join(self._parts)
        self._parts = []
        self._size = 0
        self._pipe.write(buf)


class ServerPipeline:
    """Per-connection server state for pipelined frames.

    Dispatch policy, tuned for the two traffic shapes:

    * **sequential** (one op in flight): serve the frame INLINE on the
      connection thread — out-of-order machinery buys nothing with a
      single outstanding op, and the worker-pool handoff would just tax
      every op with a thread wakeup. Inline is taken only when no pool
      task is active AND no further frame is already buffered on the
      socket, so a concurrent stream never lands behind an inline op it
      could have overtaken.
    * **concurrent** (frames/batches in flight): every sub-op becomes
      its own worker-pool task — ops complete out of order, a slow or
      fault-stalled op never blocks its siblings, and each reply is
      written under the connection's write lock addressed by request
      id.
    """

    #: inline-serve only while the EWMA op duration stays below this —
    #: an op that blocks the connection's read loop for longer than a
    #: pool handoff costs would serialize the stream behind it
    _INLINE_EWMA_S = 0.0001

    def __init__(self, sock: socket.socket, workers: int = 4):
        from concurrent.futures import ThreadPoolExecutor

        self._sock = sock
        try:
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        except OSError:
            pass
        self._wlock = threading.Lock()
        self._alock = threading.Lock()
        self._active = 0
        #: EWMA of recent op service time (seconds); starts optimistic
        #: so a fast sequential stream takes the inline path immediately
        self._ewma_s = 0.0
        self._pool = ThreadPoolExecutor(
            max_workers=max(1, workers), thread_name_prefix="pipe-serve"
        )

    def note_duration(self, dt_s: float) -> None:
        # GIL-atomic enough for a heuristic
        self._ewma_s = 0.8 * self._ewma_s + 0.2 * dt_s

    def serve_inline_ok(self) -> bool:
        """True when the sequential fast path applies: nothing running
        on the pool, nothing more buffered to read, and recent ops have
        been FAST — a slow op served inline would hold up the read loop
        for its whole duration (the one thing pipelining must never
        do), so slow traffic always rides the pool."""
        if self._ewma_s > self._INLINE_EWMA_S:
            return False
        with self._alock:
            if self._active:
                return False
        import select

        r, _w, _x = select.select([self._sock], [], [], 0)
        return not r

    def submit_op(self, serve: Callable, mgr, sub_raw: int,
                  sub_body: bytes, t_arrival: float) -> None:
        """Schedule one sub-op as its own pool task (out-of-order
        completion unit)."""
        with self._alock:
            self._active += 1
        self._pool.submit(self._run_op, serve, mgr, sub_raw, sub_body,
                          t_arrival)

    def _run_op(self, serve, mgr, sub_raw, sub_body, t_arrival) -> None:
        out = _ReplyBuffer(self)
        t0 = time.monotonic()
        try:
            serve(mgr, out, sub_raw, sub_body, t_arrival)
            out.flush()
        except (OSError, ConnectionError):
            pass  # connection died mid-reply; the handler loop notices
        finally:
            self.note_duration(time.monotonic() - t0)
            with self._alock:
                self._active -= 1

    def write(self, buf: bytes) -> None:
        with self._wlock:
            # intentional: the write lock serializes response frames onto the shared
            # socket; it guards the send half only, never a round-trip
            # graphlint: disable=JG203 -- intentional: the write lock serializes response frames onto the shared socket; it guards the send half only, never a round-trip
            self._sock.sendall(buf)

    def close(self) -> None:
        self._pool.shutdown(wait=False)


def iter_batch(body: bytes):
    """Yield (raw_op, sub_body) for each sub-frame of a batch carrier.
    A sub-frame is [u32 sub_len][u8 op|flags][sub_body]; sub_len counts
    the sub_body only (the op byte rides the 5-byte header, exactly like
    a top-level frame)."""
    (n,) = struct.unpack_from(">I", body, 0)
    off = 4
    for _ in range(n):
        (sub_len,) = struct.unpack_from(">I", body, off)
        raw = body[off + 4]
        yield raw, body[off + 5 : off + 5 + sub_len]
        off += 5 + sub_len


def pipeline_health_block(snapshot: dict) -> dict:
    """The health report's ``pipeline`` block: per-protocol in-flight depth
    and coalescing ratios aggregated from the remote clients' gauges and
    counters in a registry snapshot (``registry.snapshot()``). A pure
    function of the snapshot; the query server's health endpoint reads it
    once the server is ported."""
    block: Dict[str, dict] = {}
    for proto in ("storage.remote", "index.remote"):
        prefix = f"{proto}.pipeline."
        in_flight = sum(
            m.get("value", 0)
            for name, m in snapshot.items()
            if name.startswith(prefix) and name.endswith(".in_flight")
            and m.get("type") == "gauge"
        )
        counters = {
            name[len(prefix):]: m["count"]
            for name, m in snapshot.items()
            if name.startswith(prefix) and m.get("type") == "counter"
        }
        if not counters and not in_flight:
            continue
        ops = counters.get("ops", 0)
        frames = counters.get("wire_frames", 0)
        block[proto] = {
            "in_flight": in_flight,
            "ops": ops,
            "wire_frames": frames,
            "merged_ops": counters.get("merged_ops", 0),
            "coalesce_ratio": round(ops / frames, 3) if frames else None,
            "stalls": counters.get("stalls", 0),
            "expired_in_queue": counters.get("expired_in_queue", 0),
            "negotiation_fallbacks": counters.get("fallbacks", 0),
        }
    return block
