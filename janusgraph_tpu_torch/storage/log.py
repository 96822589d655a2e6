"""Durable pub/sub log on the key-column-value store itself — the port's
copy of ``janusgraph_tpu/storage/log.py``, writing the same rows.

Capability parity with the reference's KCVSLog
(reference: diskstorage/log/kcvs/KCVSLog.java:79 — time-bucketed row keys
with N buckets for write parallelism, a background send thread batching
appends, and per-bucket message-puller threads reading forward from a
ReadMarker; KCVSLogManager.java:244 — one store per log;
log/ReadMarker.java:128 — start-time / saved-position semantics;
log/MessageReader.java — the consumer SPI).

The bus carries the three control-plane feeds of the graph: the
transaction WAL (``txlog``), the management broadcast (``systemlog``) and
the user change logs (``ulog_<identifier>``). A log is one store of the
store manager (``open_database``), so over the local store its rows land
in the directory's files, which either package reads.

Storage layout:
  row key  = [bucket:1][timeslice:8 BE]      (timeslice = ts_ns // slice_ns)
  column   = [timestamp_ns:8 BE][sender:8][seq:4 BE]   — time-ordered, unique
  value    = message content

A reader is a callable, or a ``weakref.WeakMethod``: its pullers end once
the method's object is gone (the graph's management-log reader, so a graph
nobody closed does not poll forever). ``close()`` stops and joins the send
and pull threads.
"""

from __future__ import annotations

import threading
import time
import weakref
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

from janusgraph_tpu_torch.storage.kcvs import (
    KeyColumnValueStore,
    KeyRangeQuery,
    SliceQuery,
)

_SLICE_MS = 100  # default row time-granularity (log.slice-granularity-ms)


@dataclass(frozen=True)
class LogMessage:
    content: bytes
    timestamp_ns: int
    sender: bytes  # 8-byte instance rid


class ReadMarker:
    """Where a reader starts (reference: ReadMarker.java:128)."""

    def __init__(self, start_ns: Optional[int] = None):
        self.start_ns = start_ns

    @classmethod
    def from_now(cls) -> "ReadMarker":
        return cls(time.time_ns())

    @classmethod
    def from_epoch(cls) -> "ReadMarker":
        return cls(0)

    @classmethod
    def from_time_ns(cls, ts: int) -> "ReadMarker":
        return cls(ts)


class KCVSLog:
    """One named durable log over one dedicated store."""

    def __init__(
        self,
        name: str,
        store: KeyColumnValueStore,
        tx_factory: Callable,
        sender: bytes,
        num_buckets: int = 4,
        send_batch_size: int = 256,
        send_interval_ms: float = 10.0,
        read_interval_ms: float = 20.0,
        timestamps=None,
        read_lag_ms: float = -1.0,
        read_only: bool = False,
        slice_granularity_ms: int = _SLICE_MS,
    ):
        from janusgraph_tpu_torch.util.timestamps import TimestampProviders

        #: log.slice-granularity-ms — row time window (FIXED: row keys
        #: derive from it, so all writers and readers of a log must agree)
        self._slice_ns = slice_granularity_ms * 1_000_000
        self.name = name
        self.store = store
        self._tx_factory = tx_factory
        #: graph.timestamps: the resolution appended messages are stamped at
        self.timestamps = timestamps or TimestampProviders.NANO
        #: log.read-lag-ms: pullers stop this far behind now. A message is
        #: stamped at add() but flushes up to a send interval later, so a
        #: message of another sender stamped earlier but flushed later would
        #: sort below an advanced cursor and be skipped forever. Auto (-1):
        #: 3x the send interval + one resolution tick.
        if read_lag_ms < 0:
            read_lag_ms = (
                3.0 * send_interval_ms
                + self.timestamps.resolution_ns / 1e6
            )
        self._read_lag_ns = int(read_lag_ms * 1e6)
        self.read_only = read_only
        self.sender = (sender + b"\x00" * 8)[:8]
        self.num_buckets = num_buckets
        self.send_batch_size = send_batch_size
        self.send_interval_ms = send_interval_ms
        self.read_interval_ms = read_interval_ms
        self._seq = 0
        self._rr_bucket = 0
        self._outbox: List[Tuple[int, bytes, bytes]] = []  # (bucket, col, val)
        self._lock = threading.Lock()
        self._closed = threading.Event()
        self._flush_wakeup = threading.Event()
        self._send_thread: Optional[threading.Thread] = None
        self._readers: List[threading.Thread] = []

    # ------------------------------------------------------------------ write
    def _row_key(self, bucket: int, ts_ns: int) -> bytes:
        return bytes([bucket]) + (ts_ns // self._slice_ns).to_bytes(8, "big")

    def add(self, content: bytes, bucket: Optional[int] = None) -> None:
        """Append a message (batched; the send thread flushes). A partition
        key may pin the bucket so one entity's messages stay ordered."""
        if self.read_only:
            from janusgraph_tpu_torch.exceptions import PermanentBackendError

            raise PermanentBackendError(
                "storage.read-only: log appends write to the log store"
            )
        with self._lock:
            ts = self.timestamps.time_ns()
            self._seq += 1
            col = (
                ts.to_bytes(8, "big")
                + self.sender
                + (self._seq & 0xFFFFFFFF).to_bytes(4, "big")
            )
            if bucket is None:
                bucket = self._rr_bucket
                self._rr_bucket = (self._rr_bucket + 1) % self.num_buckets
            self._outbox.append((bucket % self.num_buckets, col, content))
            if len(self._outbox) >= self.send_batch_size:
                self._flush_wakeup.set()
            if self._send_thread is None:
                self._send_thread = threading.Thread(
                    target=self._send_loop, name=f"log-{self.name}-send",
                    daemon=True,
                )
                self._send_thread.start()

    def add_now(self, content: bytes, bucket: Optional[int] = None) -> None:
        """Append and flush synchronously (WAL markers need durability before
        the commit proceeds)."""
        self.add(content, bucket)
        self.flush()

    def flush(self) -> None:
        with self._lock:
            batch = self._outbox
            self._outbox = []
        if not batch:
            return
        rows: Dict[bytes, List[Tuple[bytes, bytes]]] = {}
        row_of: Dict[bytes, bytes] = {}
        for bucket, col, val in batch:
            ts = int.from_bytes(col[:8], "big")
            row = self._row_key(bucket, ts)
            rows.setdefault(row, []).append((col, val))
            row_of[col] = row
        done_rows = set()
        try:
            stx = self._tx_factory()
            for row, adds in rows.items():
                self.store.mutate(row, adds, [], stx)
                done_rows.add(row)
        except Exception:
            # durable-log promise: unwritten messages go back in the outbox
            # for the next flush instead of being dropped
            with self._lock:
                self._outbox[:0] = [
                    item for item in batch if row_of[item[1]] not in done_rows
                ]
            raise

    def _record_loop_error(self, loop: str, e: Exception) -> None:
        """The background loops keep running; the failure is on record."""
        from janusgraph_tpu_torch.observability import flight_recorder, registry

        registry.counter("storage.log.loop_errors").inc()
        flight_recorder.record(
            "thread_error", thread=f"log-{self.name}-{loop}", error=repr(e),
        )

    def _send_loop(self) -> None:
        while not self._closed.is_set():
            self._flush_wakeup.wait(self.send_interval_ms / 1000.0)
            self._flush_wakeup.clear()
            try:
                self.flush()
            except Exception as e:  # noqa: BLE001 - the sender must not die
                # flush() re-queued the batch for the next tick
                self._record_loop_error("send", e)

    # ------------------------------------------------------------------- read
    def register_reader(
        self,
        marker: ReadMarker,
        reader,
        poll_ms: Optional[float] = None,
    ) -> None:
        """Spawn one puller thread per bucket from the marker position
        (reference: KCVSLog.java:212 MessagePuller per bucket)."""
        start = marker.start_ns if marker.start_ns is not None else time.time_ns()
        for bucket in range(self.num_buckets):
            t = threading.Thread(
                target=self._pull_loop,
                args=(bucket, start, reader, poll_ms or self.read_interval_ms),
                name=f"log-{self.name}-pull-{bucket}",
                daemon=True,
            )
            t.start()
            self._readers.append(t)

    def _bucket_rows(self, bucket: int, start_ns: int, end_ns: int, stx):
        """Ordered scan of one bucket's rows in [start_ns, end_ns]: a key
        range scan, so a sparse log costs only its rows."""
        start_key = bytes([bucket]) + (start_ns // self._slice_ns).to_bytes(8, "big")
        end_key = bytes([bucket]) + (end_ns // self._slice_ns + 1).to_bytes(8, "big")
        return self.store.get_keys(
            KeyRangeQuery(start_key, end_key, SliceQuery()), stx
        )

    def read_range(
        self, start_ns: int, end_ns: Optional[int] = None
    ) -> List[LogMessage]:
        """Synchronous bounded read across all buckets, time-ordered
        (recovery and tests pull without threads)."""
        end = end_ns if end_ns is not None else time.time_ns()
        out: List[LogMessage] = []
        stx = self._tx_factory()
        for bucket in range(self.num_buckets):
            for _row, entries in self._bucket_rows(bucket, start_ns, end, stx):
                for col, val in entries:
                    ts = int.from_bytes(col[:8], "big")
                    if start_ns <= ts <= end:
                        out.append(LogMessage(val, ts, col[8:16]))
        out.sort(key=lambda m: m.timestamp_ns)
        return out

    def _pull_loop(self, bucket: int, start_ns: int, reader, poll_ms: float) -> None:
        weak = isinstance(reader, weakref.WeakMethod)
        # strictly increasing (row slice, column) cursor per bucket
        cursor = ((start_ns // self._slice_ns).to_bytes(8, "big"), b"")
        while not self._closed.is_set():
            if weak and reader() is None:
                return  # the reader's object is gone
            try:
                stx = self._tx_factory()
                # resume the ranged scan at the cursor's row; stop read-lag
                # behind now so same-tick stragglers still get consumed
                resume_ns = int.from_bytes(cursor[0], "big") * self._slice_ns
                end_ns = time.time_ns() - self._read_lag_ns
                for row, entries in self._bucket_rows(bucket, resume_ns, end_ns, stx):
                    row_slice = row[1:9]
                    for col, val in entries:
                        if (row_slice, col) <= cursor:
                            continue
                        ts = int.from_bytes(col[:8], "big")
                        if ts > end_ns:
                            # inside the lag window: revisit next poll; the
                            # cursor must not advance past it
                            continue
                        cursor = (row_slice, col)
                        if ts < start_ns:
                            continue
                        fn = reader() if weak else reader
                        if fn is None:
                            return
                        try:
                            fn(LogMessage(val, ts, col[8:16]))
                        except Exception as e:  # noqa: BLE001 - a bad consumer must not kill the puller
                            self._record_loop_error("reader", e)
                        del fn
            except Exception as e:  # noqa: BLE001 - the puller must not die
                self._record_loop_error("pull", e)
            self._closed.wait(poll_ms / 1000.0)

    def close(self) -> None:
        self._closed.set()
        self._flush_wakeup.set()
        if self._send_thread is not None:
            self._send_thread.join(timeout=2.0)
        for t in self._readers:
            t.join(timeout=2.0)
        self.flush()


class LogManager:
    """Opens named logs over dedicated stores (reference:
    KCVSLogManager.java:244)."""

    def __init__(
        self,
        store_manager,
        sender: bytes,
        num_buckets: int = 4,
        send_batch_size: int = 256,
        read_interval_ms: float = 20.0,
        send_delay_ms: float = 10.0,
        ttl_seconds: float = 0.0,
        timestamps=None,
        read_lag_ms: float = -1.0,
        read_only: bool = False,
        slice_granularity_ms: int = _SLICE_MS,
    ):
        self.slice_granularity_ms = slice_granularity_ms
        self.manager = store_manager
        self.sender = sender
        self.timestamps = timestamps
        self.read_lag_ms = read_lag_ms
        self.read_only = read_only
        self.num_buckets = num_buckets
        self.send_batch_size = send_batch_size
        self.read_interval_ms = read_interval_ms
        self.send_delay_ms = send_delay_ms
        #: log.ttl-seconds: log rows expire through the cell-TTL wrapper
        self.ttl_seconds = ttl_seconds
        self._logs: Dict[str, KCVSLog] = {}
        self._lock = threading.Lock()

    def open_log(self, name: str) -> KCVSLog:
        with self._lock:
            log = self._logs.get(name)
            if log is None:
                store = self.manager.open_database(name)
                if self.ttl_seconds > 0:
                    from janusgraph_tpu_torch.storage.ttl import TTLKCVStore

                    store = TTLKCVStore(store, self.ttl_seconds)
                log = KCVSLog(
                    name,
                    store,
                    self.manager.begin_transaction,
                    self.sender,
                    num_buckets=self.num_buckets,
                    send_batch_size=self.send_batch_size,
                    send_interval_ms=self.send_delay_ms,
                    read_interval_ms=self.read_interval_ms,
                    timestamps=self.timestamps,
                    read_lag_ms=self.read_lag_ms,
                    read_only=self.read_only,
                    slice_granularity_ms=self.slice_granularity_ms,
                )
                self._logs[name] = log
            return log

    def close(self) -> None:
        with self._lock:
            for log in self._logs.values():
                log.close()
            self._logs.clear()
