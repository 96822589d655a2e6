"""Durable segmented change-data-capture log — the port's copy of
``janusgraph_tpu/storage/cdc.py``, writing the same files byte for byte.

The graph's ``ChangeCapture`` (``olap/delta.py``) is a per-process ring: it
dies with its process and overflow sends consumers back to a full rescan.
With ``storage.cdc.dir`` every batch the capture decodes is also appended
to this on-disk, cursor-addressable log, which survives restarts; a
consumer replays it and folds the batches into its own CSR
(``DeltaOverlay.from_batches`` + ``materialize``).

Disk layout (all under one directory, ``storage.cdc.dir``):

``cdc-tail.tmp``
    The active tail: crc-framed batch records appended in epoch order. The
    tail is the uncommitted intermediate of the next sealed segment, and
    sealing commits it atomically. A crash mid-append tears at most the
    last frame; the recovery scan drops exactly the torn suffix.

``cdc-%06d.segment``
    Sealed segments: a digest-embedded header over the same framed
    payload, written through mkstemp in the target directory +
    ``os.replace``, so a sealed segment is complete and verifiable or
    absent, never torn.

``manifest.cdc.json``
    The digest-embedded manifest (sha256 over canonical JSON, ``.prev``
    demotion on rewrite) listing sealed segments with their cursor and
    epoch ranges and digests. Tail appends never touch the manifest; it
    rewrites on seal and prune only.

Record encoding rides the fixed-width bulk edge codec (``core/codecs.py``
``EDGE_COL_FIXED``): each edge-lane row is the owning vertex id (8 bytes
big-endian) followed by the 27-byte fixed column layout (category, type id,
direction, sklen=0, other vid, relation id), so encode and decode are
single vectorized numpy passes.

Cursor semantics: a cursor is the global batch ordinal (0-based).
``replay_from(cursor)`` returns every surviving record at or past the
cursor plus the next cursor; it returns ``None``, never a partial answer,
when the range is unservable: pruned past (retention), a poison record (a
commit the capture could not decode) inside the range, or a corrupt or
missing sealed segment. ``None`` means the consumer must re-bootstrap from
a snapshot whose epoch clears the gap. Seals and replays record
``cdc_seal`` / ``cdc_replay`` flight events.

Left out: the seeded torn-write fault (``CDCLog(fault_plan=)``,
``storage.faults.cdc-torn-at``), which comes with the fault injector
(ROADMAP Queue A #5.5b). A closed log refuses appends with ``CDCTornWrite``.
"""

from __future__ import annotations

import hashlib
import json
import os
import struct
import tempfile
import threading
import zlib
from typing import Dict, List, Optional, Tuple

import numpy as np

from janusgraph_tpu_torch.core.codecs import Direction, EDGE_COL_FIXED

MANIFEST_NAME = "manifest.cdc.json"
TAIL_NAME = "cdc-tail.tmp"
_LOG_KIND = "cdc-log"
_VERSION = 1

#: frame = length + crc32 over the payload, then the payload
_FRAME = struct.Struct(">II")
#: batch payload header: epoch, flags, n_add, n_del, n_vadd, n_vdel
_BHEAD = struct.Struct(">qBIIII")
_FLAG_POISON = 0x01
#: edge-lane row: owning vid (8B big-endian) + the fixed-width column
_EDGE_ROW = 8 + EDGE_COL_FIXED
#: sealed-segment header: magic, records, first_cursor, first_epoch,
#: last_epoch, sha256(payload)
_SEG_HEAD = struct.Struct(">8sIqqq32s")
_SEG_MAGIC = b"JGCDCSG1"


class CDCTornWrite(RuntimeError):
    """Raised by an append to a closed log. Reopen the log to recover."""


def _segment_name(seq: int) -> str:
    return "cdc-%06d.segment" % seq


def _manifest_digest(body: dict) -> str:
    canon = json.dumps(
        {k: v for k, v in sorted(body.items()) if k != "digest"},
        sort_keys=True,
    )
    return hashlib.sha256(canon.encode()).hexdigest()


# ---------------------------------------------------------------------------
# batch <-> bytes (the fixed-width codec lanes)
# ---------------------------------------------------------------------------

def _encode_edge_lane(src, dst, et) -> bytes:
    """(src, dst, type) int64 arrays -> rows of vid + fixed-width column
    (the exact byte layout EdgeSerializer.bulk_decode_edges consumes)."""
    m = len(src)
    if not m:
        return b""

    def _be(a):
        return (
            np.ascontiguousarray(np.asarray(a, np.int64).astype(">u8"))
            .view(np.uint8).reshape(m, 8)
        )

    rows = np.zeros((m, _EDGE_ROW), dtype=np.uint8)
    rows[:, 0:8] = _be(src)
    rows[:, 8] = 3  # edge category byte
    rows[:, 9:17] = _be(et)  # type id lane
    rows[:, 17] = int(Direction.OUT)
    rows[:, 18] = 0  # sklen = 0: the fixed-width fast path
    rows[:, 19:27] = _be(dst)  # other-vid lane
    # bytes 27:35 stay zero: relation ids do not survive netting
    return rows.tobytes()


def _decode_edge_lane(data: bytes, m: int):
    if not m:
        z = np.empty(0, dtype=np.int64)
        return z, z.copy(), z.copy()
    buf = np.frombuffer(data, dtype=np.uint8).reshape(m, _EDGE_ROW)

    def _i64(lo, hi):
        return buf[:, lo:hi].copy().view(">u8").astype(np.int64).ravel()

    return _i64(0, 8), _i64(19, 27), _i64(9, 17)  # src, dst, type


def encode_batch(epoch: int, batch: Optional[dict]) -> bytes:
    """One capture batch (or ``None`` = poison) -> payload bytes."""
    if batch is None:
        return _BHEAD.pack(int(epoch), _FLAG_POISON, 0, 0, 0, 0)
    a_src, a_dst, a_et = batch["add"]
    d_src, d_dst, d_et = batch["del"]
    v_add = batch.get("v_add") or {}
    v_del = batch.get("v_del") or []
    parts = [
        _BHEAD.pack(
            int(epoch), 0, len(a_src), len(d_src), len(v_add), len(v_del)
        ),
        _encode_edge_lane(a_src, a_dst, a_et),
        _encode_edge_lane(d_src, d_dst, d_et),
    ]
    if v_add:
        va = np.asarray(
            [[int(k), int(v)] for k, v in v_add.items()], dtype=np.int64
        )
        parts.append(np.ascontiguousarray(va.astype(">i8")).tobytes())
    if v_del:
        vd = np.asarray([int(v) for v in v_del], dtype=np.int64)
        parts.append(np.ascontiguousarray(vd.astype(">i8")).tobytes())
    return b"".join(parts)


def decode_batch(payload: bytes) -> Tuple[int, Optional[dict]]:
    """Payload bytes -> (epoch, batch-or-None-for-poison). Raises on any
    structural mismatch (the caller treats that as a torn frame)."""
    epoch, flags, n_add, n_del, n_vadd, n_vdel = _BHEAD.unpack_from(
        payload
    )
    if flags & _FLAG_POISON:
        return epoch, None
    off = _BHEAD.size
    end = off + n_add * _EDGE_ROW
    a_src, a_dst, a_et = _decode_edge_lane(payload[off:end], n_add)
    off = end
    end = off + n_del * _EDGE_ROW
    d_src, d_dst, d_et = _decode_edge_lane(payload[off:end], n_del)
    off = end
    v_add: Dict[int, int] = {}
    if n_vadd:
        end = off + n_vadd * 16
        va = (
            np.frombuffer(payload[off:end], dtype=">i8")
            .astype(np.int64).reshape(n_vadd, 2)
        )
        v_add = {int(r[0]): int(r[1]) for r in va}
        off = end
    v_del: List[int] = []
    if n_vdel:
        end = off + n_vdel * 8
        v_del = [
            int(v)
            for v in np.frombuffer(payload[off:end], dtype=">i8")
        ]
        off = end
    if off != len(payload):
        raise ValueError("cdc batch payload length mismatch")
    return epoch, {
        "n": n_add + n_del + len(v_add) + len(v_del),
        "add": (a_src, a_dst, a_et),
        "del": (d_src, d_dst, d_et),
        "v_add": v_add,
        "v_del": v_del,
    }


def _frame(payload: bytes) -> bytes:
    return _FRAME.pack(len(payload), zlib.crc32(payload)) + payload


def _iter_frames(data: bytes):
    """Yield (payload, end_offset) for every intact frame; stop silently
    at the first torn/corrupt one (crc or length mismatch)."""
    off = 0
    while off + _FRAME.size <= len(data):
        length, crc = _FRAME.unpack_from(data, off)
        end = off + _FRAME.size + length
        if end > len(data):
            return
        payload = data[off + _FRAME.size:end]
        if zlib.crc32(payload) != crc:
            return
        yield payload, end
        off = end


# ---------------------------------------------------------------------------
# the log
# ---------------------------------------------------------------------------

class CDCLog:
    """Durable, segmented, cursor-addressable change log.

    Thread-safe; ``append`` is cheap enough to sit on the commit path as
    a :meth:`ChangeCapture.add_sink` sink (one vectorized encode + one
    buffered write + flush). Segment size must be a power of two
    (``storage.cdc.segment-records``) so cursor->segment arithmetic is a
    shift.
    """

    def __init__(
        self,
        dir_path: str,
        segment_records: int = 1024,
        retention_segments: int = 64,
    ):
        if segment_records <= 0 or segment_records & (segment_records - 1):
            raise ValueError("segment_records must be a power of two")
        self.dir = str(dir_path)
        self.segment_records = int(segment_records)
        self.retention_segments = max(1, int(retention_segments))
        self._lock = threading.Lock()
        os.makedirs(self.dir, exist_ok=True)

        #: sealed-segment metadata rows (manifest mirror)
        self._segments: List[dict] = []
        #: cursors below this are unservable (pruned or lost)
        self._gap_through = 0
        #: max epoch among unservable records (a bootstrap checkpoint
        #: must clear this epoch before replay can take over)
        self._gap_epoch = -1
        #: first cursor of the tail (== end of the sealed range)
        self._sealed_through = 0
        #: in-memory tail: (cursor, epoch, batch-or-None) + raw frames
        self._tail: List[Tuple[int, int, Optional[dict]]] = []
        self._tail_raw: List[bytes] = []
        self._tail_file = None
        self._crashed = False
        self._recover()

    # ------------------------------------------------------------- recovery
    def _recover(self) -> None:
        from janusgraph_tpu_torch.observability import registry

        body = self._read_manifest()
        if body is not None:
            self._gap_through = int(body.get("pruned_through_cursor", 0))
            self._gap_epoch = int(body.get("pruned_last_epoch", -1))
            self._sealed_through = self._gap_through
            for row in body.get("segments", []):
                path = os.path.join(self.dir, row["name"])
                if not os.path.exists(path):
                    # a listed segment is gone: everything through its
                    # end is lost — honest gap, never a silent skip
                    self._segments = []
                    self._gap_through = (
                        int(row["first_cursor"]) + int(row["records"])
                    )
                    self._gap_epoch = max(
                        self._gap_epoch, int(row["last_epoch"])
                    )
                    self._sealed_through = self._gap_through
                    registry.counter("cdc.segments_lost").inc()
                    continue
                self._segments.append(dict(row))
                self._sealed_through = (
                    int(row["first_cursor"]) + int(row["records"])
                )
        # tail scan: keep the intact prefix, drop the torn suffix
        tail_path = os.path.join(self.dir, TAIL_NAME)
        good_end = 0
        if os.path.exists(tail_path):
            with open(tail_path, "rb") as f:
                data = f.read()
            cursor = self._sealed_through
            for payload, end in _iter_frames(data):
                try:
                    epoch, batch = decode_batch(payload)
                except Exception:  # torn mid-frame body
                    break
                self._tail.append((cursor, epoch, batch))
                self._tail_raw.append(_frame(payload))
                cursor += 1
                good_end = end
            if good_end < len(data):
                registry.counter("cdc.torn_frames_dropped").inc()
                with open(tail_path, "r+b") as f:
                    f.truncate(good_end)
        self._tail_file = open(tail_path, "ab")

    def _read_manifest(self) -> Optional[dict]:
        mpath = os.path.join(self.dir, MANIFEST_NAME)
        for candidate in (mpath, mpath + ".prev"):
            try:
                with open(candidate, "r", encoding="utf-8") as f:
                    body = json.load(f)
            except (OSError, ValueError):
                continue
            if body.get("kind") != _LOG_KIND:
                continue
            if body.get("digest") != _manifest_digest(body):
                continue
            return body
        return None

    def _write_manifest(self) -> None:
        body = {
            "kind": _LOG_KIND,
            "version": _VERSION,
            "segments": [dict(s) for s in self._segments],
            "pruned_through_cursor": self._gap_through,
            "pruned_last_epoch": self._gap_epoch,
        }
        body["digest"] = _manifest_digest(body)
        path = os.path.join(self.dir, MANIFEST_NAME)
        fd, tmp = tempfile.mkstemp(dir=self.dir, suffix=".json.tmp")
        try:
            with os.fdopen(fd, "w", encoding="utf-8") as f:
                json.dump(body, f)
            if os.path.exists(path):
                os.replace(path, path + ".prev")
            os.replace(tmp, path)
        except BaseException:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise

    # ------------------------------------------------------------- write side
    @property
    def cursor(self) -> int:
        """Next cursor to be assigned (== records ever appended)."""
        with self._lock:
            return self._sealed_through + len(self._tail)

    @property
    def base_cursor(self) -> int:
        """Smallest replayable cursor."""
        with self._lock:
            return self._gap_through

    def head_cursor(self) -> int:
        """Alias of :attr:`cursor` under the pull-source interface
        (CDCReader implements the same trio: replay_from /
        cursor_for_epoch / head_cursor)."""
        return self.cursor

    def append(self, epoch: int, batch: Optional[dict]) -> int:
        """Durably append one capture batch (``None`` = poison marker).
        Returns the record's cursor. The ChangeCapture sink signature."""
        from janusgraph_tpu_torch.observability import registry

        payload = encode_batch(epoch, batch)
        frame = _frame(payload)
        with self._lock:
            if self._crashed:
                raise CDCTornWrite("cdc log closed; reopen to recover")
            cur = self._sealed_through + len(self._tail)
            self._tail_file.write(frame)
            self._tail_file.flush()
            self._tail.append((cur, int(epoch), batch))
            self._tail_raw.append(frame)
            registry.counter("cdc.appends").inc()
            if len(self._tail) >= self.segment_records:
                self._seal_locked()
            return cur

    def seal(self) -> None:
        """Seal the current tail into a durable segment (no-op when the
        tail is empty). Normally automatic at the pow2 boundary."""
        with self._lock:
            if self._tail:
                self._seal_locked()

    def _seal_locked(self) -> None:
        from janusgraph_tpu_torch.observability import flight_recorder, registry

        payload = b"".join(self._tail_raw)
        epochs = [e for _, e, _ in self._tail]
        seq = (
            int(self._segments[-1]["seq"]) + 1 if self._segments else 0
        )
        name = _segment_name(seq)
        row = {
            "seq": seq,
            "name": name,
            "records": len(self._tail),
            "first_cursor": self._sealed_through,
            "first_epoch": min(epochs),
            "last_epoch": max(epochs),
            "digest": hashlib.sha256(payload).hexdigest(),
        }
        head = _SEG_HEAD.pack(
            _SEG_MAGIC,
            row["records"],
            row["first_cursor"],
            row["first_epoch"],
            row["last_epoch"],
            hashlib.sha256(payload).digest(),
        )
        path = os.path.join(self.dir, name)
        fd, tmp = tempfile.mkstemp(dir=self.dir, suffix=".segment.tmp")
        try:
            with os.fdopen(fd, "wb") as f:
                f.write(head)
                f.write(payload)
            os.replace(tmp, path)
        except BaseException:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise
        self._segments.append(row)
        self._sealed_through += len(self._tail)
        # retention: prune oldest sealed segments past the budget; the
        # pruned range becomes an honest cursor gap
        while len(self._segments) > self.retention_segments:
            old = self._segments.pop(0)
            self._gap_through = (
                int(old["first_cursor"]) + int(old["records"])
            )
            self._gap_epoch = max(self._gap_epoch, int(old["last_epoch"]))
            try:
                os.unlink(os.path.join(self.dir, old["name"]))
            except OSError:
                pass
            registry.counter("cdc.segments_pruned").inc()
        self._write_manifest()
        # truncate the tail: its frames now live in the sealed segment
        self._tail_file.close()
        tail_path = os.path.join(self.dir, TAIL_NAME)
        with open(tail_path, "wb"):
            pass
        self._tail_file = open(tail_path, "ab")
        self._tail = []
        self._tail_raw = []
        registry.counter("cdc.seals").inc()
        flight_recorder.record(
            "cdc_seal",
            seq=seq,
            records=row["records"],
            first_cursor=row["first_cursor"],
            first_epoch=row["first_epoch"],
            last_epoch=row["last_epoch"],
        )

    # ------------------------------------------------------------- read side
    def _read_segment(self, row: dict) -> Optional[List[Tuple[int, int, Optional[dict]]]]:
        """Decode one sealed segment (digest-verified). None = corrupt."""
        path = os.path.join(self.dir, row["name"])
        try:
            with open(path, "rb") as f:
                data = f.read()
        except OSError:
            return None
        if len(data) < _SEG_HEAD.size:
            return None
        magic, records, first_cursor, _fe, _le, digest = (
            _SEG_HEAD.unpack_from(data)
        )
        payload = data[_SEG_HEAD.size:]
        if (
            magic != _SEG_MAGIC
            or hashlib.sha256(payload).digest() != digest
        ):
            return None
        out: List[Tuple[int, int, Optional[dict]]] = []
        cursor = int(first_cursor)
        for frame_payload, _end in _iter_frames(payload):
            try:
                epoch, batch = decode_batch(frame_payload)
            except Exception:
                return None
            out.append((cursor, epoch, batch))
            cursor += 1
        if len(out) != int(records):
            return None
        return out

    def replay_from(
        self, cursor: int
    ) -> Optional[Tuple[List[Tuple[int, dict]], int]]:
        """Every (epoch, batch) at or past ``cursor`` in append order,
        plus the next cursor. ``None`` = unservable (pruned gap, poison
        in range, corrupt segment, or a future cursor): the caller must
        re-bootstrap from a checkpoint past :attr:`gap_epoch`.

        Replay is idempotent — the same cursor always yields the same
        records — and folding the records through ``DeltaOverlay.
        from_batches`` + ``materialize`` is bitwise-equivalent to a
        fresh scan at the final epoch (tests/test_torch_cdc.py)."""
        from janusgraph_tpu_torch.observability import flight_recorder, registry

        cursor = int(cursor)
        with self._lock:
            next_cursor = self._sealed_through + len(self._tail)
            if cursor < self._gap_through or cursor > next_cursor:
                registry.counter("cdc.replay_gaps").inc()
                flight_recorder.record(
                    "cdc_replay", action="gap", cursor=cursor,
                    base=self._gap_through, next=next_cursor,
                )
                return None
            out: List[Tuple[int, dict]] = []
            for row in self._segments:
                end = int(row["first_cursor"]) + int(row["records"])
                if end <= cursor:
                    continue
                frames = self._read_segment(row)
                if frames is None:
                    registry.counter("cdc.replay_gaps").inc()
                    flight_recorder.record(
                        "cdc_replay", action="corrupt",
                        cursor=cursor, seq=row["seq"],
                    )
                    return None
                for c, epoch, batch in frames:
                    if c < cursor:
                        continue
                    if batch is None:
                        registry.counter("cdc.replay_poisoned").inc()
                        flight_recorder.record(
                            "cdc_replay", action="poison",
                            cursor=c, epoch=epoch,
                        )
                        return None
                    out.append((epoch, batch))
            for c, epoch, batch in self._tail:
                if c < cursor:
                    continue
                if batch is None:
                    registry.counter("cdc.replay_poisoned").inc()
                    flight_recorder.record(
                        "cdc_replay", action="poison",
                        cursor=c, epoch=epoch,
                    )
                    return None
                out.append((epoch, batch))
            registry.counter("cdc.replays").inc()
            flight_recorder.record(
                "cdc_replay", action="serve", cursor=cursor,
                records=len(out), next=next_cursor,
            )
            return out, next_cursor

    def cursor_for_epoch(self, epoch: int) -> Optional[int]:
        """Smallest cursor whose replay covers every record with epoch
        past ``epoch`` — the bootstrap anchor for a follower joining
        from a checkpoint at that epoch. ``None`` when records past the
        epoch were pruned/poisoned away (bootstrap checkpoint too old)."""
        epoch = int(epoch)
        with self._lock:
            if epoch < self._gap_epoch:
                return None
            cursor = self._gap_through
            for row in self._segments:
                if int(row["last_epoch"]) <= epoch:
                    cursor = int(row["first_cursor"]) + int(row["records"])
                    continue
                frames = self._read_segment(row)
                if frames is None:
                    return None
                for c, e, _b in frames:
                    if e <= epoch:
                        cursor = c + 1
                return cursor
            for c, e, _b in self._tail:
                if e <= epoch:
                    cursor = c + 1
            return cursor

    @property
    def gap_epoch(self) -> int:
        """Max epoch among unservable (pruned/lost) records; a bootstrap
        checkpoint must be at an epoch >= this to hand off to replay."""
        with self._lock:
            return self._gap_epoch

    def last_epoch(self) -> int:
        """Epoch of the newest durable record (-1 when empty)."""
        with self._lock:
            if self._tail:
                return self._tail[-1][1]
            if self._segments:
                return int(self._segments[-1]["last_epoch"])
            return self._gap_epoch

    def stats(self) -> dict:
        with self._lock:
            return {
                "cursor": self._sealed_through + len(self._tail),
                "base_cursor": self._gap_through,
                "sealed_segments": len(self._segments),
                "tail_records": len(self._tail),
                "last_epoch": (
                    self._tail[-1][1] if self._tail
                    else int(self._segments[-1]["last_epoch"])
                    if self._segments else self._gap_epoch
                ),
            }

    def close(self) -> None:
        with self._lock:
            if self._tail_file is not None:
                self._tail_file.close()
                self._tail_file = None
                self._crashed = True


# ---------------------------------------------------------------------------
# read-only view (the follower pull plane)
# ---------------------------------------------------------------------------

class CDCReader:
    """Read-only view of a (possibly live) CDC directory, for a consumer
    that shares the writer's filesystem. Never mutates: no tail
    truncation, no file handles held; a torn tail frame simply ends the
    scan. Every call re-reads the manifest, and re-checks it after the
    tail read — if a seal landed in between (the manifest moved), the
    read retries so tail cursors never bind to a stale sealed range.

    Implements the same pull-source trio as :class:`CDCLog`
    (``replay_from`` / ``cursor_for_epoch`` / ``head_cursor``)."""

    _RETRIES = 3

    def __init__(self, dir_path: str):
        self.dir = str(dir_path)

    def _manifest_body(self) -> Optional[dict]:
        mpath = os.path.join(self.dir, MANIFEST_NAME)
        for candidate in (mpath, mpath + ".prev"):
            try:
                with open(candidate, "r", encoding="utf-8") as f:
                    body = json.load(f)
            except (OSError, ValueError):
                continue
            if body.get("kind") != _LOG_KIND:
                continue
            if body.get("digest") != _manifest_digest(body):
                continue
            return body
        return None

    def _snapshot(self):
        """One consistent (segments, gap_through, gap_epoch, tail
        records) view, retried across concurrent seals. Tail records are
        (cursor, epoch, batch-or-None) like the writer's."""
        for _ in range(self._RETRIES):
            body = self._manifest_body() or {}
            segments = list(body.get("segments", []))
            gap_through = int(body.get("pruned_through_cursor", 0))
            gap_epoch = int(body.get("pruned_last_epoch", -1))
            sealed_through = gap_through
            for row in segments:
                sealed_through = (
                    int(row["first_cursor"]) + int(row["records"])
                )
            tail: List[Tuple[int, int, Optional[dict]]] = []
            tail_path = os.path.join(self.dir, TAIL_NAME)
            data = b""
            try:
                with open(tail_path, "rb") as f:
                    data = f.read()
            except OSError:
                pass
            cursor = sealed_through
            torn = False
            for payload, _end in _iter_frames(data):
                try:
                    epoch, batch = decode_batch(payload)
                except Exception:
                    torn = True
                    break
                tail.append((cursor, epoch, batch))
                cursor += 1
            # a seal between the manifest read and the tail read would
            # re-base the tail: verify the manifest did not move
            body2 = self._manifest_body() or {}
            if len(body2.get("segments", [])) == len(segments) and int(
                body2.get("pruned_through_cursor", 0)
            ) == gap_through:
                _ = torn  # a torn suffix just ends the durable range
                return segments, gap_through, gap_epoch, tail
        return segments, gap_through, gap_epoch, tail

    def head_cursor(self) -> int:
        segments, gap_through, _ge, tail = self._snapshot()
        if tail:
            return tail[-1][0] + 1
        if segments:
            last = segments[-1]
            return int(last["first_cursor"]) + int(last["records"])
        return gap_through

    def _read_segment(self, row: dict):
        path = os.path.join(self.dir, row["name"])
        try:
            with open(path, "rb") as f:
                data = f.read()
        except OSError:
            return None
        if len(data) < _SEG_HEAD.size:
            return None
        magic, records, first_cursor, _fe, _le, digest = (
            _SEG_HEAD.unpack_from(data)
        )
        payload = data[_SEG_HEAD.size:]
        if (
            magic != _SEG_MAGIC
            or hashlib.sha256(payload).digest() != digest
        ):
            return None
        out = []
        cursor = int(first_cursor)
        for frame_payload, _end in _iter_frames(payload):
            try:
                epoch, batch = decode_batch(frame_payload)
            except Exception:
                return None
            out.append((cursor, epoch, batch))
            cursor += 1
        return out if len(out) == int(records) else None

    def replay_from(
        self, cursor: int
    ) -> Optional[Tuple[List[Tuple[int, dict]], int]]:
        """Same contract as :meth:`CDCLog.replay_from`."""
        from janusgraph_tpu_torch.observability import registry

        cursor = int(cursor)
        segments, gap_through, _gap_epoch, tail = self._snapshot()
        next_cursor = (
            tail[-1][0] + 1 if tail
            else (
                int(segments[-1]["first_cursor"])
                + int(segments[-1]["records"])
            ) if segments else gap_through
        )
        if cursor < gap_through or cursor > next_cursor:
            registry.counter("cdc.replay_gaps").inc()
            return None
        out: List[Tuple[int, dict]] = []
        for row in segments:
            end = int(row["first_cursor"]) + int(row["records"])
            if end <= cursor:
                continue
            frames = self._read_segment(row)
            if frames is None:
                registry.counter("cdc.replay_gaps").inc()
                return None
            for c, epoch, batch in frames:
                if c < cursor:
                    continue
                if batch is None:
                    registry.counter("cdc.replay_poisoned").inc()
                    return None
                out.append((epoch, batch))
        for c, epoch, batch in tail:
            if c < cursor:
                continue
            if batch is None:
                registry.counter("cdc.replay_poisoned").inc()
                return None
            out.append((epoch, batch))
        registry.counter("cdc.replays").inc()
        return out, next_cursor

    def cursor_for_epoch(self, epoch: int) -> Optional[int]:
        """Same contract as :meth:`CDCLog.cursor_for_epoch`."""
        epoch = int(epoch)
        segments, gap_through, gap_epoch, tail = self._snapshot()
        if epoch < gap_epoch:
            return None
        cursor = gap_through
        for row in segments:
            if int(row["last_epoch"]) <= epoch:
                cursor = int(row["first_cursor"]) + int(row["records"])
                continue
            frames = self._read_segment(row)
            if frames is None:
                return None
            for c, e, _b in frames:
                if e <= epoch:
                    cursor = c + 1
            return cursor
        for c, e, _b in tail:
            if e <= epoch:
                cursor = c + 1
        return cursor


class LeaderCDCState:
    """The leader-side /healthz ``cdc`` block: role + durable cursor
    frontier (a leader is never stale relative to itself)."""

    role = "leader"

    def __init__(self, log: CDCLog):
        self.log = log

    def healthz_block(self) -> dict:
        s = self.log.stats()
        return {
            "role": "leader",
            "cursor": s["cursor"],
            "lag_records": 0,
            "last_applied_epoch": s["last_epoch"],
            "staleness_s": 0.0,
            "sealed_segments": s["sealed_segments"],
            "degraded": False,
        }
