"""Persistent local ordered-KV engine — the BerkeleyJE-analogue backend;
the port's copy of ``janusgraph_tpu/storage/localstore.py``, writing and
reading the same files byte for byte (the WAL frame: a ``>I`` CRC32 of the
body, then the ``>BIII`` header and the store name, key and value; the
``store.wal`` and ``store.snapshot`` names; replay stops at a torn tail or
a bad CRC), so a directory either package wrote opens in the other.

The reference ships a local persistent backend (janusgraph-berkeleyje:
BerkeleyJEStoreManager/BerkeleyJEKeyValueStore — an ordered KV store with
durable writes, adapted to KCVS). This is its TPU-framework counterpart,
built as a log-structured engine instead of a B-tree:

  - memtable: dict + lazily-sorted key index (bisect range scans)
  - durability: append-only WAL per directory, length-framed CRC32 records
    (PUT/DEL/COMMIT); replayed on open; commit() fsyncs
  - compaction: `compact()` writes a point-in-time snapshot file and
    truncates the WAL; open loads snapshot then replays the tail

Used through OrderedKVAdapterManager (kvstore.py) it is a full persistent
KCVS backend: `open_local_kcvs(directory)`.
"""

from __future__ import annotations

import bisect
import os
import struct
import threading
import zlib
from typing import Dict, Iterator, List, Optional, Tuple

from janusgraph_tpu_torch.storage.kcvs import StoreFeatures, StoreTransaction
from janusgraph_tpu_torch.storage.kvstore import (
    OrderedKeyValueStore,
    OrderedKeyValueStoreManager,
    OrderedKVAdapterManager,
)

_OP_PUT = 1
_OP_DEL = 2
_OP_COMMIT = 3

_HDR = struct.Struct(">BIII")  # op, store_len, key_len, val_len  (+crc32 u32)


def _frame(op: int, store: bytes, key: bytes, val: bytes) -> bytes:
    body = _HDR.pack(op, len(store), len(key), len(val)) + store + key + val
    return struct.pack(">I", zlib.crc32(body) & 0xFFFFFFFF) + body


class _Memtable:
    """Sorted map with lazy key index. Thread-safe: writes and scan-snapshot
    creation take the lock; scans iterate over a point-in-time snapshot, so
    concurrent OLAP scans and OLTP writes never see a mutating dict."""

    def __init__(self):
        self.data: Dict[bytes, bytes] = {}
        self._sorted: Optional[List[bytes]] = None
        self._lock = threading.RLock()

    def put(self, key: bytes, value: bytes) -> None:
        with self._lock:
            if key not in self.data:
                self._sorted = None
            self.data[key] = value

    def get(self, key: bytes) -> Optional[bytes]:
        with self._lock:
            return self.data.get(key)

    def delete(self, key: bytes) -> None:
        with self._lock:
            if self.data.pop(key, None) is not None:
                self._sorted = None

    def sorted_keys(self) -> List[bytes]:
        with self._lock:
            if self._sorted is None:
                self._sorted = sorted(self.data)
            return self._sorted

    def scan(self, start: bytes, end: Optional[bytes]) -> Iterator[Tuple[bytes, bytes]]:
        with self._lock:
            keys = self.sorted_keys()
            lo = bisect.bisect_left(keys, start)
            hi = len(keys) if end is None else bisect.bisect_left(keys, end)
            snapshot = [
                (keys[i], self.data[keys[i]])
                for i in range(lo, hi)
                if keys[i] in self.data
            ]
        return iter(snapshot)


class LocalKVStore(OrderedKeyValueStore):
    def __init__(self, manager: "LocalKVStoreManager", name: str):
        self._manager = manager
        self._name = name
        self.mem = _Memtable()

    @property
    def name(self) -> str:
        return self._name

    def get(self, key: bytes, txh: StoreTransaction) -> Optional[bytes]:
        return self.mem.get(key)

    def insert(self, key: bytes, value: bytes, txh: StoreTransaction) -> None:
        self._manager._log(_OP_PUT, self._name, key, value)
        self.mem.put(key, value)

    def delete(self, key: bytes, txh: StoreTransaction) -> None:
        self._manager._log(_OP_DEL, self._name, key, b"")
        self.mem.delete(key)

    def scan(
        self, start: bytes, end: Optional[bytes], txh: StoreTransaction
    ) -> Iterator[Tuple[bytes, bytes]]:
        return self.mem.scan(start, end)


class _LocalTx(StoreTransaction):
    def __init__(self, manager: "LocalKVStoreManager", config=None):
        super().__init__(config)
        self._manager = manager

    def commit(self) -> None:
        self._manager._commit_mark()

    def rollback(self) -> None:
        # writes are already durable in the WAL; rollback is not supported
        # at this layer (matching autocommit-style local stores); the graph
        # layer's WAL/recovery handles logical rollback
        pass


class LocalKVStoreManager(OrderedKeyValueStoreManager):
    WAL_FILE = "store.wal"
    SNAP_FILE = "store.snapshot"

    def __init__(self, directory: str, fsync: bool = True):
        self.directory = directory
        self.fsync = fsync
        os.makedirs(directory, exist_ok=True)
        self._stores: Dict[str, LocalKVStore] = {}
        self._wal = None
        self._wal_lock = threading.Lock()
        self._recover()
        # 4MB userspace buffer: bulk loads write millions of WAL frames;
        # commit() still flushes (+fsync) so durability semantics are unchanged
        self._wal = open(self._path(self.WAL_FILE), "ab", buffering=4 << 20)

    # ------------------------------------------------------------ durability
    def _path(self, name: str) -> str:
        return os.path.join(self.directory, name)

    def _log(self, op: int, store: str, key: bytes, val: bytes) -> None:
        if self._wal is None:  # during recovery replay
            return
        with self._wal_lock:
            self._wal.write(_frame(op, store.encode(), key, val))

    def _commit_mark(self) -> None:
        if self._wal is None:
            return
        with self._wal_lock:
            self._wal.write(_frame(_OP_COMMIT, b"", b"", b""))
            self._wal.flush()
            if self.fsync:
                os.fsync(self._wal.fileno())

    def _recover(self) -> None:
        snap = self._path(self.SNAP_FILE)
        if os.path.exists(snap):
            self._replay_file(snap)
        wal = self._path(self.WAL_FILE)
        if os.path.exists(wal):
            self._replay_file(wal)

    def _replay_file(self, path: str) -> None:
        with open(path, "rb") as f:
            data = f.read()
        pos = 0
        n = len(data)
        while pos + 4 + _HDR.size <= n:
            (crc,) = struct.unpack_from(">I", data, pos)
            op, sl, kl, vl = _HDR.unpack_from(data, pos + 4)
            end = pos + 4 + _HDR.size + sl + kl + vl
            if end > n:
                break  # torn tail record
            body = data[pos + 4 : end]
            if zlib.crc32(body) & 0xFFFFFFFF != crc:
                break  # corrupt tail: stop replay (prefix is consistent)
            off = _HDR.size
            store = body[off : off + sl].decode()
            key = body[off + sl : off + sl + kl]
            val = body[off + sl + kl : off + sl + kl + vl]
            if op == _OP_PUT:
                self.open_database(store).mem.put(key, val)
            elif op == _OP_DEL:
                self.open_database(store).mem.delete(key)
            pos = end

    def compact(self) -> None:
        """Write a snapshot of all stores and truncate the WAL."""
        tmp = self._path(self.SNAP_FILE + ".tmp")
        with open(tmp, "wb") as f:
            for name, store in self._stores.items():
                for k, v in store.mem.scan(b"", None):
                    f.write(_frame(_OP_PUT, name.encode(), k, v))
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self._path(self.SNAP_FILE))
        self._wal.close()
        self._wal = open(self._path(self.WAL_FILE), "wb", buffering=4 << 20)

    # ----------------------------------------------------------------- SPI
    @property
    def features(self) -> StoreFeatures:
        return StoreFeatures(
            ordered_scan=True,
            multi_query=False,
            batch_mutation=True,
            persists=True,
            key_consistent=True,
        )

    def open_database(self, name: str) -> LocalKVStore:
        if name not in self._stores:
            self._stores[name] = LocalKVStore(self, name)
        return self._stores[name]

    def begin_transaction(self, config: Optional[dict] = None) -> StoreTransaction:
        return _LocalTx(self, config)

    def close(self) -> None:
        if self._wal is not None:
            self._commit_mark()
            self._wal.close()
            self._wal = None

    def clear_storage(self) -> None:
        # reset memtables IN PLACE: adapters (OrderedKVAdapterManager) hold
        # references to these LocalKVStore objects, so replacing the dict
        # would orphan them and a later compact() would miss their data
        for store in self._stores.values():
            store.mem = _Memtable()
        if self._wal is not None:
            self._wal.close()
        for f in (self.WAL_FILE, self.SNAP_FILE):
            p = self._path(f)
            if os.path.exists(p):
                os.unlink(p)
        self._wal = open(self._path(self.WAL_FILE), "ab", buffering=4 << 20)

    def exists(self) -> bool:
        return os.path.exists(self._path(self.WAL_FILE)) or os.path.exists(
            self._path(self.SNAP_FILE)
        )

    def remove_files(self) -> None:
        """Unlink the store's files once it is closed (``drop_graph``'s last
        step: ``close()`` appends a COMMIT frame to the WAL that
        ``clear_storage`` reopened). Nothing else of the directory is
        touched."""
        if self._wal is not None:
            raise RuntimeError("remove_files() needs a closed store")
        for f in (self.WAL_FILE, self.SNAP_FILE):
            p = self._path(f)
            if os.path.exists(p):
                os.unlink(p)


def open_local_kcvs(directory: str, fsync: bool = True) -> OrderedKVAdapterManager:
    """A persistent local KCVS backend (BerkeleyJE-analogue)."""
    return OrderedKVAdapterManager(LocalKVStoreManager(directory, fsync=fsync))
