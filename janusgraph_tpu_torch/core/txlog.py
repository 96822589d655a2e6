"""Transaction WAL, user change logs, recovery and the management
broadcast, all on the durable log bus — the port's copy of
``janusgraph_tpu/core/txlog.py``, writing the same bytes.

Capability parity with the reference's tx-log framework
(reference: graphdb/database/log/TransactionLogHeader.java:274 — tx log
entry encoding [txid][status][payload]; graphdb/database/log/LogTxStatus.java
— PRECOMMIT/PRIMARY_SUCCESS/SECONDARY_SUCCESS/SECONDARY_FAILURE;
graphdb/log/StandardTransactionLogProcessor.java:90-151 — tail the txlog and
replay missing secondary persistence (fixSecondaryFailure:151);
graphdb/log/StandardLogProcessorFramework.java:248 — user change logs with
ChangeProcessor callbacks; graphdb/database/management/ManagementLogger.java
:287 — schema-cache eviction broadcast with instance acknowledgement).

Change-set payload encoding (binary, self-contained so a recovery process
can replay without the originating tx):
  [n:4 BE] then n records:
    edge:     b'E' [flag][out_vid:8][in_vid:8][type_id:8][rel_id:8]
    property: b'P' [flag][vid:8][key_id:8][rel_id:8][len:4][value-enc]
  flag: 0x01 = addition, 0x00 = deletion

Torn-commit recovery records ``torn_recovery`` flight events and the
``txlog.torn.replayed`` / ``txlog.torn.rolled_back`` counters.
"""

from __future__ import annotations

import struct
import threading
import time
import weakref
from dataclasses import dataclass, field
from enum import IntEnum
from typing import Callable, Dict, List, Optional

from janusgraph_tpu_torch.storage.log import KCVSLog, LogMessage, ReadMarker


class LogTxStatus(IntEnum):
    PRECOMMIT = 1
    PRIMARY_SUCCESS = 2
    SECONDARY_SUCCESS = 3
    SECONDARY_FAILURE = 4
    #: written immediately before the primary storage flush — the point
    #: past which a crash can leave a TORN batch (some rows applied, some
    #: not). PREFLUSH without PRIMARY_SUCCESS is the roll-forward case
    #: TornCommitRecovery replays; PRECOMMIT without PREFLUSH means the
    #: flush never started and the tx rolls back to "never happened".
    PREFLUSH = 5
    #: recovery marker: a PRECOMMIT-only tx was confirmed rolled back
    ROLLED_BACK = 6


@dataclass(frozen=True)
class ChangeRecord:
    kind: str  # 'edge' | 'property'
    added: bool
    vertex_id: int  # out-vertex for edges
    other_id: int  # in-vertex for edges, 0 for properties
    type_id: int
    relation_id: int
    value_enc: bytes = b""


@dataclass
class TxLogEntry:
    tx_id: int
    status: LogTxStatus
    changes: List[ChangeRecord] = field(default_factory=list)
    user_log: str = ""
    timestamp_ns: int = 0


def encode_changes(changes: List[ChangeRecord]) -> bytes:
    parts = [struct.pack(">I", len(changes))]
    for c in changes:
        flag = b"\x01" if c.added else b"\x00"
        if c.kind == "edge":
            parts.append(
                b"E" + flag + struct.pack(
                    ">QQQQ", c.vertex_id, c.other_id, c.type_id, c.relation_id
                )
            )
        else:
            parts.append(
                b"P" + flag + struct.pack(
                    ">QQQ", c.vertex_id, c.type_id, c.relation_id
                )
                + struct.pack(">I", len(c.value_enc)) + c.value_enc
            )
    return b"".join(parts)


def decode_changes(data: bytes) -> List[ChangeRecord]:
    (n,) = struct.unpack_from(">I", data, 0)
    off = 4
    out: List[ChangeRecord] = []
    for _ in range(n):
        kind = data[off:off + 1]
        added = data[off + 1] == 1
        off += 2
        if kind == b"E":
            ov, iv, tid, rid = struct.unpack_from(">QQQQ", data, off)
            off += 32
            out.append(ChangeRecord("edge", added, ov, iv, tid, rid))
        else:
            vid, tid, rid = struct.unpack_from(">QQQ", data, off)
            off += 24
            (vlen,) = struct.unpack_from(">I", data, off)
            off += 4
            venc = data[off:off + vlen]
            off += vlen
            out.append(ChangeRecord("property", added, vid, 0, tid, rid, venc))
    return out


def encode_tx_entry(entry: TxLogEntry) -> bytes:
    ulog = entry.user_log.encode()
    head = struct.pack(">QBH", entry.tx_id, entry.status, len(ulog)) + ulog
    if entry.status == LogTxStatus.PRECOMMIT:
        return head + encode_changes(entry.changes)
    return head


def decode_tx_entry(data: bytes, timestamp_ns: int = 0) -> TxLogEntry:
    tx_id, status, ulen = struct.unpack_from(">QBH", data, 0)
    off = 11
    ulog = data[off:off + ulen].decode()
    off += ulen
    changes: List[ChangeRecord] = []
    if status == LogTxStatus.PRECOMMIT:
        changes = decode_changes(data[off:])
    return TxLogEntry(tx_id, LogTxStatus(status), changes, ulog, timestamp_ns)


# ---------------------------------------------------------------------------
# WAL writer used by the commit pipeline


class TransactionLog:
    def __init__(self, txlog: KCVSLog):
        self.log = txlog
        self._tx_counter = int(time.time_ns() & 0x7FFFFFFF) << 20
        self._lock = threading.Lock()

    def next_tx_id(self) -> int:
        with self._lock:
            self._tx_counter += 1
            return self._tx_counter

    def precommit(
        self, tx_id: int, changes: List[ChangeRecord], user_log: str = ""
    ) -> None:
        self.log.add_now(
            encode_tx_entry(
                TxLogEntry(tx_id, LogTxStatus.PRECOMMIT, changes, user_log)
            )
        )

    def preflush(self, tx_id: int) -> None:
        """Mark the flush point: storage writes begin NOW. A crash between
        this entry and primary_success may have torn the batch."""
        self.log.add_now(
            encode_tx_entry(TxLogEntry(tx_id, LogTxStatus.PREFLUSH))
        )

    def primary_success(self, tx_id: int) -> None:
        self.log.add_now(
            encode_tx_entry(TxLogEntry(tx_id, LogTxStatus.PRIMARY_SUCCESS))
        )

    def secondary(self, tx_id: int, success: bool) -> None:
        status = (
            LogTxStatus.SECONDARY_SUCCESS
            if success
            else LogTxStatus.SECONDARY_FAILURE
        )
        self.log.add_now(encode_tx_entry(TxLogEntry(tx_id, status)))


# ---------------------------------------------------------------------------
# User CDC


@dataclass
class ChangeState:
    """What one committed transaction changed, reconstructed from the log
    (reference: core/log/ChangeState over the user log)."""

    tx_id: int
    timestamp_ns: int
    added: List[ChangeRecord]
    deleted: List[ChangeRecord]


class LogProcessorFramework:
    """Tail a user change log and dispatch ChangeState callbacks
    (reference: StandardLogProcessorFramework.java:248)."""

    def __init__(self, graph, identifier: str):
        self.graph = graph
        self.identifier = identifier
        self._processors: List[Callable[[ChangeState], None]] = []
        self._started = False

    def add_processor(self, fn: Callable[[ChangeState], None]) -> "LogProcessorFramework":
        self._processors.append(fn)
        return self

    def build(self, marker: Optional[ReadMarker] = None) -> "LogProcessorFramework":
        log = self.graph.log_manager.open_log("ulog_" + self.identifier)
        log.register_reader(marker or ReadMarker.from_now(), self._on_message)
        self._started = True
        return self

    def _on_message(self, msg: LogMessage) -> None:
        entry = decode_tx_entry(msg.content, msg.timestamp_ns)
        state = ChangeState(
            entry.tx_id,
            msg.timestamp_ns,
            [c for c in entry.changes if c.added],
            [c for c in entry.changes if not c.added],
        )
        for fn in self._processors:
            fn(state)


# ---------------------------------------------------------------------------
# Recovery


class TransactionRecovery:
    """Scan the txlog and heal transactions whose *secondary* persistence
    (user-log delivery, mixed-index documents) never completed. Primary
    storage is the source of truth: a tx without PRIMARY_SUCCESS simply never
    happened and is skipped (reference:
    StandardTransactionLogProcessor.fixSecondaryFailure:151, standalone
    process started by JanusGraphFactory.startTransactionRecovery)."""

    def __init__(self, graph, start_ns: int = 0):
        self.graph = graph
        self.start_ns = start_ns
        self.healed: List[int] = []

    def run(self, max_commit_time_ms: Optional[float] = None) -> List[int]:
        if max_commit_time_ms is None:
            max_commit_time_ms = self.graph.config.get("tx.max-commit-time-ms")
        txlog = self.graph.log_manager.open_log("txlog")
        cutoff = time.time_ns() - int(max_commit_time_ms * 1e6)
        # tx ids are only unique per writing instance — key by (sender, txid)
        by_tx: Dict[tuple, Dict[LogTxStatus, TxLogEntry]] = {}
        healed_keys = set()
        for msg in txlog.read_range(self.start_ns):
            entry = decode_tx_entry(msg.content, msg.timestamp_ns)
            if entry.status == LogTxStatus.SECONDARY_SUCCESS and entry.user_log.startswith("healed:"):
                # marker written by a recovery process on behalf of the
                # original sender (so idempotence survives sender-keying)
                healed_keys.add(
                    (bytes.fromhex(entry.user_log[7:]), entry.tx_id)
                )
                continue
            by_tx.setdefault((msg.sender, entry.tx_id), {})[entry.status] = entry
        for (sender, tx_id), entries in sorted(by_tx.items()):
            pre = entries.get(LogTxStatus.PRECOMMIT)
            if pre is None or LogTxStatus.PRIMARY_SUCCESS not in entries:
                continue  # primary never landed: nothing to heal
            if LogTxStatus.SECONDARY_SUCCESS in entries:
                continue
            if (sender, tx_id) in healed_keys:
                continue
            newest = max(e.timestamp_ns for e in entries.values())
            if newest > cutoff:
                continue  # may still be in flight
            self._fix_secondary(sender, tx_id, pre)
            self.healed.append(tx_id)
        return self.healed

    def _fix_secondary(self, sender: bytes, tx_id: int, pre: TxLogEntry) -> None:
        graph = self.graph
        # replay the user-log delivery
        if pre.user_log:
            ulog = graph.log_manager.open_log("ulog_" + pre.user_log)
            ulog.add_now(
                encode_tx_entry(
                    TxLogEntry(
                        tx_id, LogTxStatus.PRECOMMIT, pre.changes, pre.user_log
                    )
                )
            )
        # replay mixed-index documents from primary storage
        graph.restore_mixed_indexes(pre.changes)
        graph.tx_log.log.add_now(
            encode_tx_entry(
                TxLogEntry(
                    tx_id,
                    LogTxStatus.SECONDARY_SUCCESS,
                    user_log="healed:" + sender.hex(),
                )
            )
        )


# ---------------------------------------------------------------------------
# Torn-commit recovery (primary storage)


class TornCommitRecovery:
    """Heal transactions whose PRIMARY flush may have torn.

    The companion to :class:`TransactionRecovery` (which only heals
    *secondary* persistence): this one repairs primary storage itself,
    using the PREFLUSH marker to split abandoned transactions into two
    cases —

    * ``PREFLUSH`` present, ``PRIMARY_SUCCESS`` absent: the flush started
      and may have applied a prefix of the batch (non-transactional
      backends apply per-row atomically, never per-batch). The WAL's
      change records are self-contained, so the tx is **rolled forward**:
      every recorded cell is re-derived and written idempotently
      (``graph.replay_torn_changes``), then a ``PRIMARY_SUCCESS`` entry
      with a ``healed-primary:<sender>`` marker closes the tx.
    * ``PRECOMMIT`` only: the flush never began, nothing reached storage —
      the tx **rolls back** to "never happened" and a ``ROLLED_BACK``
      marker stops future recoveries from re-reporting it.

    Entries younger than ``tx.max-commit-time-ms`` are skipped (they may
    still be in flight on another instance). Runs automatically at graph
    open when the WAL is enabled (``tx.recover-on-open``).
    """

    def __init__(self, graph):
        self.graph = graph
        self.replayed: List[int] = []
        self.rolled_back: List[int] = []

    def run(self, max_commit_time_ms: Optional[float] = None) -> dict:
        if max_commit_time_ms is None:
            max_commit_time_ms = self.graph.config.get("tx.max-commit-time-ms")
        txlog = self.graph.log_manager.open_log("txlog")
        cutoff = time.time_ns() - int(max_commit_time_ms * 1e6)
        by_tx: Dict[tuple, Dict[LogTxStatus, TxLogEntry]] = {}
        handled = set()
        for msg in txlog.read_range(0):
            entry = decode_tx_entry(msg.content, msg.timestamp_ns)
            marker = entry.user_log
            if entry.status == LogTxStatus.PRIMARY_SUCCESS and (
                marker.startswith("healed-primary:")
            ):
                handled.add((bytes.fromhex(marker[15:]), entry.tx_id))
                continue
            if entry.status == LogTxStatus.ROLLED_BACK:
                if marker.startswith("rolledback:"):
                    handled.add((bytes.fromhex(marker[11:]), entry.tx_id))
                continue
            by_tx.setdefault((msg.sender, entry.tx_id), {})[entry.status] = entry
        for (sender, tx_id), entries in sorted(by_tx.items()):
            pre = entries.get(LogTxStatus.PRECOMMIT)
            if pre is None or LogTxStatus.PRIMARY_SUCCESS in entries:
                continue  # unknown origin, or committed cleanly
            if (sender, tx_id) in handled:
                continue
            newest = max(e.timestamp_ns for e in entries.values())
            if newest > cutoff:
                continue  # may still be in flight
            if LogTxStatus.PREFLUSH in entries:
                self._roll_forward(sender, tx_id, pre)
            else:
                self._roll_back(sender, tx_id)
        from janusgraph_tpu_torch.observability import registry

        if self.replayed:
            registry.counter("txlog.torn.replayed").inc(len(self.replayed))
        if self.rolled_back:
            registry.counter("txlog.torn.rolled_back").inc(
                len(self.rolled_back)
            )
        return {"replayed": self.replayed, "rolled_back": self.rolled_back}

    @staticmethod
    def _flight(action: str, tx_id: int, **detail) -> None:
        from janusgraph_tpu_torch.observability import flight_recorder, get_logger

        flight_recorder.record(
            "torn_recovery", action=action, tx_id=tx_id, **detail
        )
        get_logger("core.txlog").warning(
            "torn-recovery", action=action, tx_id=tx_id, **detail
        )

    def _roll_forward(self, sender: bytes, tx_id: int, pre: TxLogEntry) -> None:
        graph = self.graph
        self._flight("replayed", tx_id, changes=len(pre.changes))
        graph.replay_torn_changes(pre.changes)
        # secondary persistence of the healed tx: mixed-index documents are
        # re-derived from (now repaired) primary storage, and the user-log
        # delivery replays — same healing the secondary recovery applies
        graph.restore_mixed_indexes(pre.changes)
        if pre.user_log:
            ulog = graph.log_manager.open_log("ulog_" + pre.user_log)
            ulog.add_now(
                encode_tx_entry(
                    TxLogEntry(
                        tx_id, LogTxStatus.PRECOMMIT, pre.changes, pre.user_log
                    )
                )
            )
        graph.tx_log.log.add_now(
            encode_tx_entry(
                TxLogEntry(
                    tx_id,
                    LogTxStatus.PRIMARY_SUCCESS,
                    user_log="healed-primary:" + sender.hex(),
                )
            )
        )
        self.replayed.append(tx_id)

    def _roll_back(self, sender: bytes, tx_id: int) -> None:
        self._flight("rolled_back", tx_id)
        # PRECOMMIT without PREFLUSH: nothing reached storage, the tx never
        # happened — record that verdict so later recoveries skip it
        self.graph.tx_log.log.add_now(
            encode_tx_entry(
                TxLogEntry(
                    tx_id,
                    LogTxStatus.ROLLED_BACK,
                    user_log="rolledback:" + sender.hex(),
                )
            )
        )
        self.rolled_back.append(tx_id)


# ---------------------------------------------------------------------------
# Management broadcast (schema-cache eviction with acknowledgement)

_EVICT = b"EV"
_ACK = b"AK"


class ManagementLogger:
    """Broadcast schema evictions on the system log; every instance clears
    its caches and acknowledges (reference: ManagementLogger.java:287 with
    ack-tracking inner classes on the ``systemlog``)."""

    def __init__(self, graph):
        self.graph = graph
        self.log = graph.log_manager.open_log("systemlog")
        self._acks: Dict[int, set] = {}
        self._lock = threading.Lock()
        # a weak reader: the pullers end with this logger, so a graph nobody
        # closed is not kept polling (its close() joins them otherwise)
        self.log.register_reader(
            ReadMarker.from_now(), weakref.WeakMethod(self._on_message)
        )

    def broadcast_eviction(self, schema_id: int) -> int:
        evict_id = time.time_ns()
        payload = _EVICT + struct.pack(">QQ", evict_id, schema_id)
        with self._lock:
            self._acks[evict_id] = set()
        self.log.add_now(payload)
        return evict_id

    def wait_for_acks(
        self, evict_id: int, expected: int, timeout_s: float = 5.0
    ) -> bool:
        # schema.eviction-ack-poll-ms: ack-check cadence (trade latency of
        # schema-change completion against systemlog read pressure)
        poll_s = self.graph.config.get("schema.eviction-ack-poll-ms") / 1000.0
        deadline = time.monotonic() + timeout_s
        while True:
            with self._lock:
                if len(self._acks.get(evict_id, ())) >= expected:
                    return True
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                return False
            time.sleep(min(poll_s, remaining))

    def _on_message(self, msg: LogMessage) -> None:
        tag = msg.content[:2]
        if tag == _EVICT:
            evict_id, schema_id = struct.unpack_from(">QQ", msg.content, 2)
            self.graph.evict_schema_element(schema_id)
            self.log.add_now(
                _ACK
                + struct.pack(">Q", evict_id)
                + self.graph.instance_id.encode()
            )
        elif tag == _ACK:
            (evict_id,) = struct.unpack_from(">Q", msg.content, 2)
            instance = msg.content[10:].decode()
            with self._lock:
                if evict_id in self._acks:
                    self._acks[evict_id].add(instance)
