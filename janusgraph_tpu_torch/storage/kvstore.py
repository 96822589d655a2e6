"""Ordered key-value SPI + KCVS adapter — the port's copy of
``janusgraph_tpu/storage/kvstore.py``.

The reference's BerkeleyJE backend is an *ordered key-value* store adapted to
the KCVS contract by concatenating row key and column into one composite key
(reference: diskstorage/keycolumnvalue/keyvalue/OrderedKeyValueStoreAdapter.java:389,
KeyValueStore SPI in the same package). Same design here: an
`OrderedKeyValueStore` exposes get/insert/delete/range-scan over single keys;
`OrderedKVAdapter` layers sorted wide rows on top via an order-preserving
composite encoding, so any ordered KV engine (the persistent LocalKVStore,
an LSM, a future C++ engine) becomes a full KCVS backend.
"""

from __future__ import annotations

import abc
from typing import Dict, Iterator, Optional, Sequence, Tuple

from janusgraph_tpu_torch.storage.kcvs import (
    EntryList,
    KCVMutation,
    KeyColumnValueStore,
    KeyColumnValueStoreManager,
    KeyRangeQuery,
    KeySliceQuery,
    StoreFeatures,
    StoreTransaction,
)

# ---------------------------------------------------------------- composite
# Order-preserving prefix-free key encoding: 0x00 in the row key escapes to
# 0x00 0xFF, the key terminates with 0x00 0x00, the column follows verbatim.
# Escape (0xFF) sorts above terminator (0x00), so for any keys a < b every
# composite of a sorts before every composite of b, and within one key the
# composites sort by column — slices become contiguous KV ranges.

_TERM = b"\x00\x00"


def encode_key(key: bytes) -> bytes:
    return key.replace(b"\x00", b"\x00\xff") + _TERM


def encode_composite(key: bytes, column: bytes) -> bytes:
    return encode_key(key) + column


def decode_composite(composite: bytes) -> Tuple[bytes, bytes]:
    i = 0
    out = bytearray()
    while True:
        j = composite.index(b"\x00", i)
        out += composite[i:j]
        nxt = composite[j + 1]
        if nxt == 0x00:  # terminator
            return bytes(out), composite[j + 2:]
        out += b"\x00"  # escaped zero
        i = j + 2


# --------------------------------------------------------------------- SPI

class OrderedKeyValueStore(abc.ABC):
    """Sorted single-key/value store (reference: keyvalue/OrderedKeyValueStore.java)."""

    @property
    @abc.abstractmethod
    def name(self) -> str:
        ...

    @abc.abstractmethod
    def get(self, key: bytes, txh: StoreTransaction) -> Optional[bytes]:
        ...

    @abc.abstractmethod
    def insert(self, key: bytes, value: bytes, txh: StoreTransaction) -> None:
        ...

    @abc.abstractmethod
    def delete(self, key: bytes, txh: StoreTransaction) -> None:
        ...

    @abc.abstractmethod
    def scan(
        self, start: bytes, end: Optional[bytes], txh: StoreTransaction
    ) -> Iterator[Tuple[bytes, bytes]]:
        """Iterate (key, value) with start <= key < end in ascending order
        (end=None: to the last key)."""

    def close(self) -> None:  # pragma: no cover - trivial
        pass


class OrderedKeyValueStoreManager(abc.ABC):
    """Factory for ordered KV stores (reference: OrderedKeyValueStoreManager)."""

    @property
    @abc.abstractmethod
    def features(self) -> StoreFeatures:
        ...

    @abc.abstractmethod
    def open_database(self, name: str) -> OrderedKeyValueStore:
        ...

    @abc.abstractmethod
    def begin_transaction(self, config: Optional[dict] = None) -> StoreTransaction:
        ...

    @abc.abstractmethod
    def close(self) -> None:
        ...

    @abc.abstractmethod
    def clear_storage(self) -> None:
        ...

    def exists(self) -> bool:
        return True


# ----------------------------------------------------------------- adapter

class OrderedKVAdapter(KeyColumnValueStore):
    """KCVS emulation over an ordered KV store: row slices are contiguous
    composite-key range scans (reference: OrderedKeyValueStoreAdapter.java)."""

    def __init__(self, kv: OrderedKeyValueStore):
        self.kv = kv

    @property
    def name(self) -> str:
        return self.kv.name

    def get_slice(self, query: KeySliceQuery, txh: StoreTransaction) -> EntryList:
        prefix = encode_key(query.key)
        start = prefix + query.start
        end = None if query.end is None else prefix + query.end
        out: EntryList = []
        for ck, v in self.kv.scan(start, end, txh):
            if not ck.startswith(prefix):
                break
            out.append((ck[len(prefix):], v))
            if query.limit is not None and len(out) >= query.limit:
                break
        return out

    def mutate(
        self,
        key: bytes,
        additions: EntryList,
        deletions: Sequence[bytes],
        txh: StoreTransaction,
    ) -> None:
        prefix = encode_key(key)
        added = {c for c, _ in additions}
        for col in deletions:
            if col not in added:
                self.kv.delete(prefix + col, txh)
        for col, val in additions:
            self.kv.insert(prefix + col, val, txh)

    def get_keys(
        self, query, txh: StoreTransaction
    ) -> Iterator[Tuple[bytes, EntryList]]:
        if isinstance(query, KeyRangeQuery):
            start = encode_key(query.key_start)
            end = encode_key(query.key_end)
            sq = query.slice
        else:
            start, end, sq = b"", None, query
        # Row grouping via prefix match, not per-cell decode: within the
        # encoded-key part 0x00 is always followed by 0xFF, so the FIRST
        # b"\x00\x00" in a composite is exactly the terminator, and only
        # composites of the same row start with (encoded key + terminator) —
        # one C-level startswith per cell replaces the byte-walk decode
        # (this adapter is the OLAP full-scan hot path).
        limit = sq.limit
        contains = sq.contains
        prefix: Optional[bytes] = None
        plen = 0
        cur_key: Optional[bytes] = None
        cur_entries: EntryList = []
        for ck, v in self.kv.scan(start, end, txh):
            if prefix is None or not ck.startswith(prefix):
                if cur_entries:
                    yield cur_key, cur_entries
                t = ck.find(_TERM)
                kenc = ck[:t]
                cur_key = kenc.replace(b"\x00\xff", b"\x00")
                prefix = kenc + _TERM
                plen = len(prefix)
                cur_entries = []
            col = ck[plen:]
            if contains(col) and (limit is None or len(cur_entries) < limit):
                cur_entries.append((col, v))
        if cur_entries:
            yield cur_key, cur_entries

    def close(self) -> None:
        self.kv.close()


class OrderedKVAdapterManager(KeyColumnValueStoreManager):
    """Wraps an OrderedKeyValueStoreManager as a KCVS manager."""

    def __init__(self, kv_manager: OrderedKeyValueStoreManager):
        self.kv_manager = kv_manager
        self._stores: Dict[str, OrderedKVAdapter] = {}

    @property
    def features(self) -> StoreFeatures:
        return self.kv_manager.features

    @property
    def name(self) -> str:
        return f"kv-adapter({type(self.kv_manager).__name__})"

    def open_database(self, name: str) -> OrderedKVAdapter:
        if name not in self._stores:
            self._stores[name] = OrderedKVAdapter(
                self.kv_manager.open_database(name)
            )
        return self._stores[name]

    def begin_transaction(self, config: Optional[dict] = None) -> StoreTransaction:
        return self.kv_manager.begin_transaction(config)

    def mutate_many(
        self,
        mutations: Dict[str, Dict[bytes, KCVMutation]],
        txh: StoreTransaction,
    ) -> None:
        for store_name, rows in mutations.items():
            store = self.open_database(store_name)
            for key, mut in rows.items():
                store.mutate(key, mut.additions, mut.deletions, txh)

    def close(self) -> None:
        self.kv_manager.close()

    def clear_storage(self) -> None:
        self.kv_manager.clear_storage()

    def exists(self) -> bool:
        return self.kv_manager.exists()
