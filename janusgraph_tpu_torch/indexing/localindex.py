"""Persistent local mixed-index provider — the embedded-Lucene analogue.

Plays the role janusgraph-lucene plays for the reference (reference:
janusgraph-lucene/.../LuceneIndex.java — embedded disk-backed provider
implementing IndexProvider.java:36), built on this framework's own
log-structured ordered-KV engine (storage/localstore.py: WAL + snapshot +
compaction) instead of an external library. The ordered-KV composite-key
encoding (storage/kvstore.py encode_key: order-preserving, prefix-free)
turns every index structure into a contiguous key range:

  M <store> <field>                  -> key metadata (type/mapping)
  D <store> <docid> <field>          -> the doc's stored values (framed)
  T <store> <field> <term> <docid>   -> posting (value = u32 refcount)

Terms are namespaced by kind byte so one field can carry several index
shapes (TEXTSTRING):
  t<token>                 tokenized text      (textContains*)
  s<utf-8 value>           exact string        (eq / textPrefix / ...)
  o<order-preserving enc>  orderable scalars   (Cmp ranges via KV range scan)

Because encode_key is order-preserving, numeric/date RANGE queries are ONE
contiguous KV scan over the `o` region — the disk analogue of Lucene's
point/range trees. Geoshape values live only in the doc store and are
exact-tested (same policy as the in-memory provider). Postings carry a
refcount so LIST/SET cardinality and duplicate tokens survive partial
removals. Durability, crash recovery, and compaction are inherited from the
underlying engine's WAL.

The port's copy of ``janusgraph_tpu/indexing/localindex.py``.
"""

from __future__ import annotations

import json
import re
import struct
import threading
from collections import defaultdict
from typing import Dict, Iterator, List, Optional, Set, Tuple

from janusgraph_tpu_torch.core.predicates import (
    Contain,
    Cmp,
    Geo,
    Geoshape,
    Text,
    fuzzy_distance,
    levenshtein,
    tokenize,
)
from janusgraph_tpu_torch.exceptions import BackendError
from janusgraph_tpu_torch.indexing.provider import (
    And,
    IndexFeatures,
    IndexProvider,
    IndexQuery,
    KeyInformation,
    Mapping,
    Not,
    Or,
    PredicateCondition,
    RawQuery,
    register_index_provider,
)
from janusgraph_tpu_torch.storage.kvstore import decode_composite, encode_key

_TEXT_PREDICATES = {
    Text.CONTAINS, Text.CONTAINS_PREFIX, Text.CONTAINS_REGEX,
    Text.CONTAINS_FUZZY, Text.CONTAINS_PHRASE,
}
# Contain.NOT_IN excluded like NOT_EQUAL (matches docs lacking the field)
_STRING_PREDICATES = {Cmp.EQUAL, Contain.IN, Text.PREFIX, Text.REGEX, Text.FUZZY}
_ORDER_PREDICATES = {
    Cmp.LESS_THAN, Cmp.LESS_THAN_EQUAL,
    Cmp.GREATER_THAN, Cmp.GREATER_THAN_EQUAL,
}


def _next_prefix(key: bytes) -> bytes:
    """Smallest byte string greater than every extension of `key`."""
    b = bytearray(key)
    for i in range(len(b) - 1, -1, -1):
        if b[i] != 0xFF:
            b[i] += 1
            return bytes(b[: i + 1])
    return key + b"\xff"  # all-0xff: unbounded in practice


# leading-segment decode shares the composite codec with the KV adapter —
# decode_composite has exactly the (segment, rest-after-terminator) contract
_decode_segment = decode_composite


class LocalIndexProvider(IndexProvider):
    """Disk-backed mixed-index provider over the local ordered-KV engine
    (shorthand "localindex")."""

    name = "localindex"

    def __init__(self, directory: str = "", fsync: bool = False, **_kwargs):
        from janusgraph_tpu_torch.storage.localstore import LocalKVStoreManager

        if not directory:
            raise BackendError("localindex requires index.search.directory")
        self._mgr = LocalKVStoreManager(directory, fsync=fsync)
        self._kv = self._mgr.open_database("index")
        self._tx = self._mgr.begin_transaction()
        self._lock = threading.RLock()
        # serializer for framed doc values (self-describing, Geoshape-aware)
        from janusgraph_tpu_torch.core.attributes import Serializer

        self._ser = Serializer()
        self._infos: Dict[Tuple[str, str], KeyInformation] = {}
        self._check_format()
        self._load_meta()

    #: bump on any change to the posting/doc byte layouts; directories
    #: written by another version are refused LOUDLY instead of being
    #: decoded as garbage (no silent migration)
    FORMAT_VERSION = 2
    _VKEY = b"V"

    def _check_format(self) -> None:
        stored = self._kv.get(self._VKEY, self._tx)
        if stored is None:
            has_data = any(True for _ in self._kv.scan(b"D", b"N", self._tx))
            if has_data:
                raise BackendError(
                    "localindex directory predates format versioning — "
                    "rebuild the index (REINDEX) into a fresh directory"
                )
            self._kv.insert(
                self._VKEY, struct.pack(">I", self.FORMAT_VERSION), self._tx
            )
            self._tx.commit()
            return
        (ver,) = struct.unpack(">I", stored)
        if ver != self.FORMAT_VERSION:
            raise BackendError(
                f"localindex format v{ver} != supported v{self.FORMAT_VERSION}"
                " — rebuild the index (REINDEX) into a fresh directory"
            )

    # -------------------------------------------------------------- layout
    @staticmethod
    def _mkey(store: str, field: str) -> bytes:
        return b"M" + encode_key(store.encode()) + encode_key(field.encode())

    @staticmethod
    def _dkey(store: str, docid: str, field: str = None) -> bytes:
        k = b"D" + encode_key(store.encode()) + encode_key(docid.encode())
        return k if field is None else k + encode_key(field.encode())

    @staticmethod
    def _tprefix(store: str, field: str) -> bytes:
        return b"T" + encode_key(store.encode()) + encode_key(field.encode())

    def _pkey(self, store: str, field: str, term: bytes, docid: str) -> bytes:
        return (
            self._tprefix(store, field)
            + encode_key(term)
            + encode_key(docid.encode())
        )

    # ---------------------------------------------------------- value terms
    def _terms_for(self, info: KeyInformation, value) -> List[bytes]:
        """The posting terms one stored value contributes."""
        m = info.mapping
        if isinstance(value, str):
            if m == Mapping.DEFAULT:
                m = Mapping.TEXT
            out: List[bytes] = []
            if m in (Mapping.TEXT, Mapping.TEXTSTRING):
                out.extend(b"t" + t.encode() for t in tokenize(value))
            if m in (Mapping.STRING, Mapping.TEXTSTRING):
                out.append(b"s" + value.encode())
            return out
        if isinstance(value, Geoshape):
            return []  # exact-tested over the doc store
        try:
            # encode in the FIELD's registered value space (int values on a
            # float field must land in float-ordered bytes, matching the
            # query-side _coerce — parity with the in-memory provider)
            return [b"o" + self._ser.write_ordered(self._coerce(info, value))]
        except Exception:
            return []

    def _info(self, store: str, field: str, key_infos=None) -> KeyInformation:
        info = self._infos.get((store, field))
        if info is None:
            info = (key_infos or {}).get(store, {}).get(
                field, KeyInformation(object)
            )
        return info

    def _load_meta(self) -> None:
        for k, v in self._kv.scan(b"M", b"N", self._tx):
            store_b, rest = _decode_segment(k[1:])
            field_b, _ = _decode_segment(rest)
            meta = json.loads(v.decode())
            self._infos[(store_b.decode(), field_b.decode())] = KeyInformation(
                {"str": str, "float": float, "int": int,
                 "Geoshape": Geoshape}.get(meta["type"], object),
                Mapping(meta["mapping"]),
                meta.get("cardinality", "SINGLE"),
            )

    # ------------------------------------------------------------------ SPI
    def features(self) -> IndexFeatures:
        return IndexFeatures(
            supports_cardinality=("SINGLE", "LIST", "SET"), supports_geo=True
        )

    def register(self, store: str, key: str, info: KeyInformation) -> None:
        with self._lock:
            existing = self._infos.get((store, key))
            if existing is not None and existing.mapping != info.mapping:
                raise BackendError(
                    f"field {key} already registered with mapping "
                    f"{existing.mapping}"
                )
            if existing is None:
                self._infos[(store, key)] = info
                meta = {
                    "type": getattr(info.data_type, "__name__", "object"),
                    "mapping": info.mapping.value,
                    "cardinality": info.cardinality,
                }
                self._kv.insert(
                    self._mkey(store, key), json.dumps(meta).encode(), self._tx
                )

    # doc value (en/de)coding: [count u32] then framed values
    def _encode_values(self, values: List[object]) -> bytes:
        parts = [struct.pack(">I", len(values))]
        for v in values:
            framed = self._ser.write_object(v)
            parts.append(struct.pack(">I", len(framed)) + framed)
        return b"".join(parts)

    def _decode_values(self, data: bytes) -> List[object]:
        (n,) = struct.unpack(">I", data[:4])
        off = 4
        out = []
        for _ in range(n):
            (ln,) = struct.unpack(">I", data[off : off + 4])
            off += 4
            v, _ = self._ser.read_object(data[off : off + ln])
            off += ln
            out.append(v)
        return out

    def _doc_values(self, store: str, docid: str) -> Dict[str, List[object]]:
        prefix = self._dkey(store, docid)
        out: Dict[str, List[object]] = {}
        for k, v in self._kv.scan(prefix, _next_prefix(prefix), self._tx):
            field_b, _ = _decode_segment(k[len(prefix) :])
            out[field_b.decode()] = self._decode_values(v)
        return out

    def _posting_adjust(
        self, store: str, field: str, term: bytes, docid: str, delta: int
    ) -> None:
        key = self._pkey(store, field, term, docid)
        cur = self._kv.get(key, self._tx)
        count = (struct.unpack(">I", cur)[0] if cur else 0) + delta
        if count > 0:
            self._kv.insert(key, struct.pack(">I", count), self._tx)
        elif cur is not None:
            self._kv.delete(key, self._tx)

    def _remove_values(
        self, store: str, docid: str, field: str, values: List[object], key_infos
    ):
        """Remove a BATCH of values from one doc field: one read-modify-write
        of the doc entry, mirroring _add_values (per-value re-encoding is
        O(n^2) for LIST-cardinality docs)."""
        info = self._info(store, field, key_infos)
        vals = self._doc_values(store, docid).get(field, [])
        try:
            # hashable fast path: multiset subtraction in one pass
            from collections import Counter

            want = Counter(values)
            kept: List[object] = []
            removed: List[object] = []
            for v in vals:
                if want.get(v, 0) > 0:
                    want[v] -= 1
                    removed.append(v)
                else:
                    kept.append(v)
            vals = kept
        except TypeError:  # unhashable values: linear removal
            removed = []
            for value in values:
                try:
                    vals.remove(value)
                except ValueError:
                    continue
                removed.append(value)
        if not removed:
            return
        dkey = self._dkey(store, docid, field)
        if vals:
            self._kv.insert(dkey, self._encode_values(vals), self._tx)
        else:
            self._kv.delete(dkey, self._tx)
        for value in removed:
            for term in self._terms_for(info, value):
                self._posting_adjust(store, field, term, docid, -1)

    def _add_values(
        self, store: str, docid: str, field: str, values: List[object], key_infos
    ):
        """Append a BATCH of values to one doc field: one read-modify-write
        of the doc entry regardless of how many values the mutation carries
        (per-value re-encoding would be O(n^2) for LIST-cardinality docs)."""
        info = self._info(store, field, key_infos)
        vals = self._doc_values(store, docid).get(field, [])
        vals.extend(values)
        self._kv.insert(
            self._dkey(store, docid, field), self._encode_values(vals), self._tx
        )
        for value in values:
            for term in self._terms_for(info, value):
                self._posting_adjust(store, field, term, docid, +1)

    def _delete_doc(self, store: str, docid: str, key_infos) -> None:
        for field, vals in self._doc_values(store, docid).items():
            info = self._info(store, field, key_infos)
            for v in vals:
                for term in self._terms_for(info, v):
                    self._posting_adjust(store, field, term, docid, -1)
            self._kv.delete(self._dkey(store, docid, field), self._tx)

    @staticmethod
    def _group_by_field(entries) -> Dict[str, List[object]]:
        grouped: Dict[str, List[object]] = {}
        for e in entries:
            grouped.setdefault(e.field, []).append(e.value)
        return grouped

    def mutate(self, mutations, key_infos) -> None:
        with self._lock:
            for store, per_doc in mutations.items():
                for docid, m in per_doc.items():
                    if m.is_deleted:
                        self._delete_doc(store, docid, key_infos)
                        if not m.additions:
                            continue
                    for field, values in self._group_by_field(m.deletions).items():
                        self._remove_values(store, docid, field, values, key_infos)
                    for field, values in self._group_by_field(m.additions).items():
                        self._add_values(store, docid, field, values, key_infos)
            self._tx.commit()

    def restore(self, documents, key_infos) -> None:
        with self._lock:
            for store, per_doc in documents.items():
                for docid, entries in per_doc.items():
                    self._delete_doc(store, docid, key_infos)
                    for field, values in self._group_by_field(entries).items():
                        self._add_values(store, docid, field, values, key_infos)
            self._tx.commit()

    # ---------------------------------------------------------------- query
    def _scan_term_region(
        self, store: str, field: str, lo: bytes, hi: Optional[bytes]
    ) -> Iterator[Tuple[bytes, str]]:
        """Yield (term, docid) for postings in [prefix+lo, prefix+hi)."""
        prefix = self._tprefix(store, field)
        start = prefix + lo
        end = _next_prefix(prefix) if hi is None else prefix + hi
        for k, _v in self._kv.scan(start, end, self._tx):
            term, rest = _decode_segment(k[len(prefix) :])
            docid_b, _ = _decode_segment(rest)
            yield term, docid_b.decode()

    def _term_docs(self, store: str, field: str, term: bytes) -> Set[str]:
        ek = encode_key(term)
        return {
            d for _t, d in self._scan_term_region(
                store, field, ek, _next_prefix(ek)
            )
        }

    def _all_docids(self, store: str) -> Set[str]:
        prefix = b"D" + encode_key(store.encode())
        out: Set[str] = set()
        for k, _v in self._kv.scan(prefix, _next_prefix(prefix), self._tx):
            docid_b, _ = _decode_segment(k[len(prefix) :])
            out.add(docid_b.decode())
        return out

    def _docs_with_field(self, store: str, field: str):
        """(docid, values) pairs for docs carrying the field — ONE contiguous
        scan of the store's doc region (the exact-test fallback path), not a
        per-doc range scan."""
        prefix = b"D" + encode_key(store.encode())
        want = field.encode()
        for k, v in self._kv.scan(prefix, _next_prefix(prefix), self._tx):
            docid_b, rest = _decode_segment(k[len(prefix) :])
            field_b, _ = _decode_segment(rest)
            if field_b == want:
                yield docid_b.decode(), self._decode_values(v)

    def _coerce(self, info: KeyInformation, cond):
        """Encode query conditions in the FIELD's value space: postings were
        written with write_ordered(field-typed value), so an int condition on
        a float field must be encoded as a float (the int and double ordered
        encodings are not byte-comparable). Lossy directions are handled at
        the call sites (EQUAL: no match; ranges: floor/ceil rewrite)."""
        t = info.data_type
        if t is float and isinstance(cond, int) and not isinstance(cond, bool):
            return float(cond)
        if t is int and isinstance(cond, float) and cond.is_integer():
            return int(cond)
        return cond

    def _field_query(self, store: str, field: str, predicate, cond) -> Set[str]:
        info = self._info(store, field)
        if predicate is Contain.IN:
            out: Set[str] = set()
            for v in cond:
                out |= self._field_query(store, field, Cmp.EQUAL, v)
            return out
        if predicate is Cmp.EQUAL:
            if isinstance(cond, Geoshape):
                return {
                    d for d, vals in self._docs_with_field(store, field)
                    if any(v == cond for v in vals)
                }
            if isinstance(cond, str):
                return self._term_docs(store, field, b"s" + cond.encode())
            if (
                info.data_type is int
                and isinstance(cond, float)
                and not cond.is_integer()
            ):
                return set()  # a non-integral value never equals an int field
            try:
                term = b"o" + self._ser.write_ordered(self._coerce(info, cond))
            except Exception:
                term = None
            if term is not None:
                return self._term_docs(store, field, term)
        if predicate is Cmp.NOT_EQUAL:
            return {
                d for d, vals in self._docs_with_field(store, field)
                if any(v != cond for v in vals)
            }
        if predicate in _ORDER_PREDICATES:
            if (
                info.data_type is int
                and isinstance(cond, float)
                and not cond.is_integer()
            ):
                # exact rewrite into int space: x > 1.5 == x >= 2, etc.
                import math

                if predicate in (Cmp.GREATER_THAN, Cmp.GREATER_THAN_EQUAL):
                    predicate, cond = Cmp.GREATER_THAN_EQUAL, math.ceil(cond)
                else:
                    predicate, cond = Cmp.LESS_THAN_EQUAL, math.floor(cond)
            enc = self._ser.write_ordered(self._coerce(info, cond))
            bound = encode_key(b"o" + enc)
            region_lo, region_hi = b"o", b"p"  # the whole `o` term namespace
            if predicate is Cmp.GREATER_THAN_EQUAL:
                lo, hi = bound, encode_key(region_hi)
            elif predicate is Cmp.GREATER_THAN:
                lo, hi = _next_prefix(bound), encode_key(region_hi)
            elif predicate is Cmp.LESS_THAN:
                lo, hi = encode_key(region_lo)[:1], bound
            else:  # LESS_THAN_EQUAL
                lo, hi = encode_key(region_lo)[:1], _next_prefix(bound)
            return {d for _t, d in self._scan_term_region(store, field, lo, hi)}
        if predicate is Text.CONTAINS:
            want = tokenize(str(cond))
            if not want:
                return set()
            out: Optional[Set[str]] = None
            for t in want:
                s = self._term_docs(store, field, b"t" + t.encode())
                out = s if out is None else out & s
                if not out:
                    return set()
            return out
        if predicate is Text.CONTAINS_PREFIX:
            p = str(cond).lower().encode()
            # tokens contain no NULs, so raw prefix == encoded prefix
            return {
                d for _t, d in self._scan_term_region(
                    store, field, b"t" + p, _next_prefix(b"t" + p)
                )
            }
        if predicate in (Text.CONTAINS_REGEX, Text.CONTAINS_FUZZY):
            out: Set[str] = set()
            if predicate is Text.CONTAINS_REGEX:
                rx = re.compile(str(cond))
                match = lambda tok: rx.fullmatch(tok) is not None
            else:
                t = str(cond).lower()
                cap = fuzzy_distance(t)
                match = lambda tok: levenshtein(tok, t, cap) <= cap
            for term, d in self._scan_term_region(
                store, field, b"t", b"u"
            ):
                if match(term[1:].decode()):
                    out.add(d)
            return out
        if predicate in (
            Text.CONTAINS_PHRASE, Text.PREFIX, Text.REGEX, Text.FUZZY,
        ):
            return {
                d for d, vals in self._docs_with_field(store, field)
                if any(
                    isinstance(v, str) and predicate.evaluate(v, cond)
                    for v in vals
                )
            }
        if predicate in (Geo.INTERSECT, Geo.DISJOINT, Geo.WITHIN, Geo.CONTAINS):
            return {
                d for d, vals in self._docs_with_field(store, field)
                if any(
                    isinstance(v, Geoshape) and predicate.evaluate(v, cond)
                    for v in vals
                )
            }
        return {
            d for d, vals in self._docs_with_field(store, field)
            if any(predicate.evaluate(v, cond) for v in vals)
        }

    def _evaluate(self, store: str, cond) -> Set[str]:
        if isinstance(cond, PredicateCondition):
            return self._field_query(store, cond.key, cond.predicate, cond.value)
        if isinstance(cond, And):
            out: Optional[Set[str]] = None
            for c in cond.children:
                r = self._evaluate(store, c)
                out = r if out is None else out & r
                if not out:
                    return set()
            return out if out is not None else self._all_docids(store)
        if isinstance(cond, Or):
            out: Set[str] = set()
            for c in cond.children:
                out |= self._evaluate(store, c)
            return out
        if isinstance(cond, Not):
            return self._all_docids(store) - self._evaluate(store, cond.child)
        raise BackendError(f"unsupported condition {cond!r}")

    def query(self, store: str, q: IndexQuery) -> List[str]:
        with self._lock:
            hits = self._evaluate(store, q.condition)
            if q.orders:
                def key_for(docid, o):
                    vals = self._doc_values(store, docid).get(o.key)
                    v = vals[0] if vals else None
                    return (v is None, v)

                try:
                    result = sorted(hits)
                    for o in reversed(q.orders):
                        result = sorted(
                            result,
                            key=lambda d, _o=o: key_for(d, _o),
                            reverse=o.desc,
                        )
                except TypeError:
                    result = sorted(hits)
            else:
                result = sorted(hits)
            if q.offset:
                result = result[q.offset :]
            if q.limit is not None:
                result = result[: q.limit]
            return result

    _RAW_TERM = re.compile(r"(?:v\.)?\"?([\w.]+)\"?:(\S+)")

    def raw_query(self, store: str, q: RawQuery) -> List[Tuple[str, float]]:
        with self._lock:
            scores: Dict[str, float] = defaultdict(float)
            terms = self._RAW_TERM.findall(q.query)
            if not terms:
                raise BackendError(f"unparseable raw query {q.query!r}")
            for fieldname, term in terms:
                hits = self._field_query(store, fieldname, Text.CONTAINS, term)
                if not hits:
                    hits = self._field_query(store, fieldname, Cmp.EQUAL, term)
                for d in hits:
                    scores[d] += 1.0
            ranked = sorted(scores.items(), key=lambda kv: (-kv[1], kv[0]))
            if q.offset:
                ranked = ranked[q.offset :]
            if q.limit is not None:
                ranked = ranked[: q.limit]
            return ranked

    def totals(self, store: str, q: RawQuery) -> int:
        return len(self.raw_query(store, RawQuery(q.query, limit=None, offset=0)))

    def supports(self, info: KeyInformation, predicate) -> bool:
        m = info.mapping
        if info.data_type is str:
            eff = Mapping.TEXT if m in (Mapping.DEFAULT, Mapping.TEXT) else m
            if predicate in _TEXT_PREDICATES:
                return eff in (Mapping.TEXT, Mapping.TEXTSTRING)
            if predicate in _STRING_PREDICATES:
                return eff in (Mapping.STRING, Mapping.TEXTSTRING)
            return False
        if info.data_type is Geoshape:
            return predicate in (
                Geo.INTERSECT, Geo.DISJOINT, Geo.WITHIN, Geo.CONTAINS,
                Cmp.EQUAL, Contain.IN,
            )
        return predicate in _STRING_PREDICATES | _ORDER_PREDICATES

    def exists(self) -> bool:
        return bool(self._infos) or any(
            True for _ in self._kv.scan(b"D", b"E", self._tx)
        )

    def compact(self) -> None:
        """Snapshot + WAL truncation (inherited engine maintenance)."""
        with self._lock:
            self._mgr.compact()

    def close(self) -> None:
        with self._lock:
            self._mgr.close()

    def clear_storage(self) -> None:
        with self._lock:
            self._mgr.clear_storage()
            self._infos = {}


register_index_provider("localindex", LocalIndexProvider)
