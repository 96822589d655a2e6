"""Store-level TTL wrapper — the port's copy of
``janusgraph_tpu/storage/ttl.py``.

Capability parity with the reference's TTL emulation
(reference: diskstorage/keycolumnvalue/ttl/TTLKCVSManager.java:119 — wraps a
manager and attaches a store-wide TTL to every written cell). The reference
delegates expiry to backends with native cell TTL; here expiry is
self-contained so it works over ANY backend: each stored value is framed as
[8-byte big-endian expire-ns | payload] (expire 0 = never), reads filter and
strip expired cells lazily, and `purge_expired()` reclaims space eagerly.
"""

from __future__ import annotations

import struct
import time
from typing import Dict, Iterator, Optional, Sequence, Tuple

from janusgraph_tpu_torch.storage.kcvs import (
    EntryList,
    KCVMutation,
    KeyColumnValueStore,
    KeyColumnValueStoreManager,
    KeySliceQuery,
    SliceQuery,
    StoreFeatures,
    StoreTransaction,
)

_EXP = struct.Struct(">Q")


def _now_ns() -> int:
    return time.time_ns()


class TTLKCVStore(KeyColumnValueStore):
    def __init__(self, wrapped: KeyColumnValueStore, ttl_seconds: float):
        self.wrapped = wrapped
        self.ttl_seconds = ttl_seconds

    @property
    def name(self) -> str:
        return self.wrapped.name

    def _wrap_value(self, value: bytes, cell_expire_ns: int = 0) -> bytes:
        exp = 0 if self.ttl_seconds <= 0 else _now_ns() + int(self.ttl_seconds * 1e9)
        if cell_expire_ns:
            # per-cell TTL (3-tuple addition): the earlier deadline wins
            exp = cell_expire_ns if not exp else min(exp, cell_expire_ns)
        return _EXP.pack(exp) + value

    def _frame_addition(self, e):
        """(col, val[, expire_ns]) -> (col, framed-val): per-cell expiry is
        folded into this wrapper's own value framing, so the wrapped store
        needs no cell-TTL support of its own."""
        return (e[0], self._wrap_value(e[1], e[2] if len(e) >= 3 else 0))

    @staticmethod
    def _live(framed: bytes, now: int) -> Optional[bytes]:
        (exp,) = _EXP.unpack_from(framed)
        if exp and exp <= now:
            return None
        return framed[_EXP.size:]

    def _filter(self, entries: EntryList) -> EntryList:
        now = _now_ns()
        out: EntryList = []
        for c, v in entries:
            payload = self._live(v, now)
            if payload is not None:
                out.append((c, payload))
        return out

    def get_slice(self, query: KeySliceQuery, txh: StoreTransaction) -> EntryList:
        return self._filter(self.wrapped.get_slice(query, txh))

    def get_slice_multi(self, keys, slice_query, txh):
        res = self.wrapped.get_slice_multi(keys, slice_query, txh)
        return {k: self._filter(v) for k, v in res.items()}

    def mutate(
        self,
        key: bytes,
        additions: EntryList,
        deletions: Sequence[bytes],
        txh: StoreTransaction,
    ) -> None:
        framed = [self._frame_addition(e) for e in additions]
        self.wrapped.mutate(key, framed, deletions, txh)

    def get_keys(self, query, txh) -> Iterator[Tuple[bytes, EntryList]]:
        for key, entries in self.wrapped.get_keys(query, txh):
            live = self._filter(entries)
            if live:
                yield key, live

    def purge_expired(self, txh: StoreTransaction) -> int:
        """Eagerly delete expired cells; returns the number purged."""
        now = _now_ns()
        purged = 0
        for key, entries in self.wrapped.get_keys(SliceQuery(), txh):
            dead = [c for c, v in entries if self._live(v, now) is None]
            if dead:
                self.wrapped.mutate(key, [], dead, txh)
                purged += len(dead)
        return purged

    def close(self) -> None:
        self.wrapped.close()


class TTLStoreManager(KeyColumnValueStoreManager):
    """Wraps any manager, giving each store a TTL (default or per-store)."""

    def __init__(
        self,
        wrapped: KeyColumnValueStoreManager,
        default_ttl_seconds: float = 0.0,
        per_store_ttl: Optional[Dict[str, float]] = None,
    ):
        self.wrapped = wrapped
        self.default_ttl = default_ttl_seconds
        self.per_store_ttl = per_store_ttl or {}
        self._stores: Dict[str, TTLKCVStore] = {}

    @property
    def features(self) -> StoreFeatures:
        f = self.wrapped.features
        return StoreFeatures(**{**f.__dict__, "cell_ttl": True})

    @property
    def ledger_self_accounting(self) -> bool:
        """Pass-through: a wrapped remote client counts its own cells, so
        the backend transaction must not count them a second time."""
        return getattr(self.wrapped, "ledger_self_accounting", False)

    @property
    def name(self) -> str:
        return f"ttl({self.wrapped.name})"

    def open_database(self, name: str) -> TTLKCVStore:
        if name not in self._stores:
            ttl = self.per_store_ttl.get(name, self.default_ttl)
            self._stores[name] = TTLKCVStore(
                self.wrapped.open_database(name), ttl
            )
        return self._stores[name]

    def begin_transaction(self, config: Optional[dict] = None) -> StoreTransaction:
        return self.wrapped.begin_transaction(config)

    def mutate_many(
        self,
        mutations: Dict[str, Dict[bytes, KCVMutation]],
        txh: StoreTransaction,
    ) -> None:
        framed: Dict[str, Dict[bytes, KCVMutation]] = {}
        for store_name, rows in mutations.items():
            store = self.open_database(store_name)
            framed[store_name] = {
                key: KCVMutation(
                    additions=[
                        store._frame_addition(e) for e in mut.additions
                    ],
                    deletions=list(mut.deletions),
                )
                for key, mut in rows.items()
            }
        self.wrapped.mutate_many(framed, txh)

    def get_local_key_partition(self):
        return self.wrapped.get_local_key_partition()

    def close(self) -> None:
        self.wrapped.close()

    def clear_storage(self) -> None:
        self.wrapped.clear_storage()

    def exists(self) -> bool:
        return self.wrapped.exists()
