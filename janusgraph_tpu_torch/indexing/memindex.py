"""Host in-memory mixed-index provider: full-text, range, and geo queries.

The embedded provider playing the role the Lucene module plays for the
reference (reference: janusgraph-lucene/.../LuceneIndex.java — embedded
index used wherever an external Elasticsearch isn't warranted; SPI contract
IndexProvider.java:36, behavior contract
janusgraph-backend-testutils/.../IndexProviderTest.java:1290).

Structures per (store, field):
  - inverted index  token -> {docid}           (TEXT mapping; textContains*)
  - exact index     value -> {docid}           (STRING mapping, Cmp.EQUAL)
  - every document's stored values             (filter fallback, orders)
Numeric/date range queries binary-search a sorted (value, docid) list that
is rebuilt lazily after writes. Geo queries bbox-prefilter then exact-test.
Queries under lock; snapshot semantics are per-call.

The port's copy of ``janusgraph_tpu/indexing/memindex.py``.
"""

from __future__ import annotations

import bisect
import re
import threading
from collections import defaultdict
from typing import Dict, List, Optional, Set, Tuple

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

_TEXT_PREDICATES = {
    Text.CONTAINS,
    Text.CONTAINS_PREFIX,
    Text.CONTAINS_REGEX,
    Text.CONTAINS_FUZZY,
    Text.CONTAINS_PHRASE,
}
# NOT_EQUAL is deliberately NOT index-pushable: the provider only knows
# documents that HAVE the field, while neq over the graph also matches
# vertices lacking the property — pushdown would silently drop those
# (the in-memory filter path keeps the full-scan semantics)
# Contain.NOT_IN is excluded for the same reason as NOT_EQUAL: `without`
# over the graph matches vertices LACKING the property, which no provider
# document represents. Contain.IN is a union of equality lookups.
_STRING_PREDICATES = {
    Cmp.EQUAL,
    Contain.IN,
    Text.PREFIX,
    Text.REGEX,
    Text.FUZZY,
}
_ORDER_PREDICATES = {
    Cmp.LESS_THAN,
    Cmp.LESS_THAN_EQUAL,
    Cmp.GREATER_THAN,
    Cmp.GREATER_THAN_EQUAL,
}


class _FieldIndex:
    def __init__(self, info: KeyInformation):
        self.info = info
        self.inverted: Dict[str, Set[str]] = defaultdict(set)
        self.exact: Dict[object, Set[str]] = defaultdict(set)
        self.values: Dict[str, List[object]] = defaultdict(list)
        self._sorted: Optional[List[Tuple[object, str]]] = None

    # ------------------------------------------------------------- mutation
    def _effective_mapping(self) -> Mapping:
        m = self.info.mapping
        if m == Mapping.DEFAULT:
            return Mapping.TEXT if self.info.data_type is str else Mapping.STRING
        return m

    def add(self, docid: str, value) -> None:
        self.values[docid].append(value)
        m = self._effective_mapping()
        if isinstance(value, str):
            if m in (Mapping.TEXT, Mapping.TEXTSTRING):
                for tok in tokenize(value):
                    self.inverted[tok].add(docid)
            if m in (Mapping.STRING, Mapping.TEXTSTRING):
                self.exact[value].add(docid)
        elif isinstance(value, Geoshape):
            pass  # geo: exact-test over stored values
        else:
            self.exact[value].add(docid)
        self._sorted = None

    def remove(self, docid: str, value) -> None:
        vals = self.values.get(docid)
        if vals is None:
            return
        try:
            vals.remove(value)
        except ValueError:
            return
        remaining = vals
        if not vals:
            del self.values[docid]
        # postings stay while ANY remaining value of the doc still justifies
        # them (LIST/SET cardinality, duplicate values)
        if isinstance(value, str):
            live_tokens = {
                t
                for v in remaining
                if isinstance(v, str)
                for t in tokenize(v)
            }
            for tok in tokenize(value):
                if tok in live_tokens:
                    continue
                s = self.inverted.get(tok)
                if s is not None:
                    s.discard(docid)
                    if not s:
                        del self.inverted[tok]
        if not isinstance(value, Geoshape) and value not in remaining:
            s = self.exact.get(value)
            if s is not None:
                s.discard(docid)
                if not s:
                    del self.exact[value]
        self._sorted = None

    def remove_doc(self, docid: str) -> None:
        for value in list(self.values.get(docid, ())):
            self.remove(docid, value)

    # --------------------------------------------------------------- search
    def sorted_values(self) -> List[Tuple[object, str]]:
        if self._sorted is None:
            pairs = [
                (v, docid)
                for docid, vals in self.values.items()
                for v in vals
                if not isinstance(v, Geoshape)
            ]
            # incomparable mixed types on one field are a schema bug; let the
            # TypeError surface rather than silently emptying range queries
            pairs.sort(key=lambda p: p[0])
            self._sorted = pairs
        return self._sorted

    def range_query(self, predicate, cond) -> Set[str]:
        pairs = self.sorted_values()
        keys = [p[0] for p in pairs]
        if predicate is Cmp.LESS_THAN:
            hi = bisect.bisect_left(keys, cond)
            sel = pairs[:hi]
        elif predicate is Cmp.LESS_THAN_EQUAL:
            hi = bisect.bisect_right(keys, cond)
            sel = pairs[:hi]
        elif predicate is Cmp.GREATER_THAN:
            lo = bisect.bisect_right(keys, cond)
            sel = pairs[lo:]
        else:
            lo = bisect.bisect_left(keys, cond)
            sel = pairs[lo:]
        return {d for _, d in sel}

    def query(self, predicate, cond) -> Set[str]:
        if predicate is Contain.IN:
            out: Set[str] = set()
            for v in cond:
                out |= self.query(Cmp.EQUAL, v)
            return out
        if predicate is Cmp.EQUAL:
            if isinstance(cond, Geoshape):
                return {
                    d
                    for d, vals in self.values.items()
                    if any(v == cond for v in vals)
                }
            return set(self.exact.get(cond, ()))
        if predicate is Cmp.NOT_EQUAL:
            return {
                d
                for d, vals in self.values.items()
                if any(v != cond for v in vals)
            }
        if predicate in _ORDER_PREDICATES:
            return self.range_query(predicate, cond)
        if predicate is Text.CONTAINS:
            want = tokenize(str(cond))
            if not want:
                return set()
            out: Optional[Set[str]] = None
            for t in want:
                s = self.inverted.get(t, set())
                out = set(s) if out is None else out & s
                if not out:
                    return set()
            return out
        if predicate is Text.CONTAINS_PREFIX:
            p = str(cond).lower()
            out: Set[str] = set()
            for tok, docs in self.inverted.items():
                if tok.startswith(p):
                    out |= docs
            return out
        if predicate is Text.CONTAINS_REGEX:
            rx = re.compile(str(cond))
            out = set()
            for tok, docs in self.inverted.items():
                if rx.fullmatch(tok):
                    out |= docs
            return out
        if predicate is Text.CONTAINS_FUZZY:
            t = str(cond).lower()
            cap = fuzzy_distance(t)
            out = set()
            for tok, docs in self.inverted.items():
                if levenshtein(tok, t, cap) <= cap:
                    out |= docs
            return out
        if predicate is Text.CONTAINS_PHRASE:
            return {
                d
                for d, vals in self.values.items()
                if any(
                    isinstance(v, str) and Text.CONTAINS_PHRASE.evaluate(v, cond)
                    for v in vals
                )
            }
        if predicate in (Text.PREFIX, Text.REGEX, Text.FUZZY):
            return {
                d
                for d, vals in self.values.items()
                if any(
                    isinstance(v, str) and predicate.evaluate(v, cond) for v in vals
                )
            }
        if predicate in (Geo.INTERSECT, Geo.DISJOINT, Geo.WITHIN, Geo.CONTAINS):
            return {
                d
                for d, vals in self.values.items()
                if any(
                    isinstance(v, Geoshape) and predicate.evaluate(v, cond)
                    for v in vals
                )
            }
        # unknown predicate: exact filter over stored values
        return {
            d
            for d, vals in self.values.items()
            if any(predicate.evaluate(v, cond) for v in vals)
        }


class _Store:
    def __init__(self):
        self.fields: Dict[str, _FieldIndex] = {}
        self.docs: Set[str] = set()


class InMemoryIndexProvider(IndexProvider):
    """The embedded mixed-index backend (registered as shorthand
    "memindex"; reference analogue: janusgraph-lucene embedded provider)."""

    name = "memindex"

    def __init__(self, **_kwargs):
        self._stores: Dict[str, _Store] = {}
        self._lock = threading.RLock()
        self._closed = False

    # ------------------------------------------------------------------ SPI
    def features(self) -> IndexFeatures:
        return IndexFeatures(
            supports_cardinality=("SINGLE", "LIST", "SET"), supports_geo=True
        )

    def register(self, store: str, key: str, info: KeyInformation) -> None:
        with self._lock:
            s = self._stores.setdefault(store, _Store())
            existing = s.fields.get(key)
            if existing is not None and existing.info.mapping != info.mapping:
                raise BackendError(
                    f"field {key} already registered with mapping "
                    f"{existing.info.mapping}"
                )
            if existing is None:
                s.fields[key] = _FieldIndex(info)

    def _field(self, store: str, key: str, key_infos) -> _FieldIndex:
        s = self._stores.setdefault(store, _Store())
        f = s.fields.get(key)
        if f is None:
            info = (key_infos or {}).get(store, {}).get(
                key, KeyInformation(object)
            )
            f = s.fields[key] = _FieldIndex(info)
        return f

    def mutate(self, mutations, key_infos) -> None:
        with self._lock:
            for store, per_doc in mutations.items():
                s = self._stores.setdefault(store, _Store())
                for docid, m in per_doc.items():
                    if m.is_deleted:
                        for f in s.fields.values():
                            f.remove_doc(docid)
                        s.docs.discard(docid)
                        if not m.additions:
                            continue
                    for e in m.deletions:
                        self._field(store, e.field, key_infos).remove(
                            docid, e.value
                        )
                    for e in m.additions:
                        self._field(store, e.field, key_infos).add(docid, e.value)
                        s.docs.add(docid)

    def restore(self, documents, key_infos) -> None:
        with self._lock:
            for store, per_doc in documents.items():
                s = self._stores.setdefault(store, _Store())
                for docid, entries in per_doc.items():
                    for f in s.fields.values():
                        f.remove_doc(docid)
                    s.docs.discard(docid)
                    for e in entries:
                        self._field(store, e.field, key_infos).add(docid, e.value)
                        s.docs.add(docid)

    # ---------------------------------------------------------------- query
    def _evaluate(self, s: _Store, cond, key_infos=None) -> Set[str]:
        if isinstance(cond, PredicateCondition):
            f = s.fields.get(cond.key)
            if f is None:
                return set()
            return f.query(cond.predicate, cond.value)
        if isinstance(cond, And):
            out: Optional[Set[str]] = None
            for c in cond.children:
                r = self._evaluate(s, c)
                out = r if out is None else out & r
                if not out:
                    return set()
            return out if out is not None else set(s.docs)
        if isinstance(cond, Or):
            out: Set[str] = set()
            for c in cond.children:
                out |= self._evaluate(s, c)
            return out
        if isinstance(cond, Not):
            return set(s.docs) - self._evaluate(s, cond.child)
        raise BackendError(f"unsupported condition {cond!r}")

    def query(self, store: str, q: IndexQuery) -> List[str]:
        with self._lock:
            s = self._stores.get(store)
            if s is None:
                return []
            hits = self._evaluate(s, q.condition)
            if q.orders:

                def key_for(docid, o: Order):
                    f = s.fields.get(o.key)
                    vals = f.values.get(docid) if f else None
                    v = vals[0] if vals else None
                    return (v is None, v)

                # stable multi-key mixed-direction sort: apply one stable
                # sort per key from the LAST key to the FIRST, so earlier
                # keys dominate
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
        """Minimal `field:term [field:term ...]` syntax, OR across terms,
        score = number of matching terms (reference: RawQuery — provider
        query-string search with scores)."""
        with self._lock:
            s = self._stores.get(store)
            if s is None:
                return []
            scores: Dict[str, float] = defaultdict(float)
            terms = self._RAW_TERM.findall(q.query)
            if not terms:
                raise BackendError(f"unparseable raw query {q.query!r}")
            for fieldname, term in terms:
                f = s.fields.get(fieldname)
                if f is None:
                    continue
                hits = f.query(Text.CONTAINS, term)
                if not hits:
                    hits = f.query(Cmp.EQUAL, term)
                for d in hits:
                    scores[d] += 1.0
            ranked = sorted(scores.items(), key=lambda kv: (-kv[1], kv[0]))
            if q.offset:
                ranked = ranked[q.offset :]
            if q.limit is not None:
                ranked = ranked[: q.limit]
            return ranked

    def totals(self, store: str, q: RawQuery) -> int:
        full = RawQuery(q.query, limit=None, offset=0)
        return len(self.raw_query(store, full))

    def supports(self, info: KeyInformation, predicate) -> bool:
        m = info.mapping
        if info.data_type is str:
            eff = (
                Mapping.TEXT
                if m in (Mapping.DEFAULT, Mapping.TEXT)
                else m
            )
            if predicate in _TEXT_PREDICATES:
                return eff in (Mapping.TEXT, Mapping.TEXTSTRING)
            if predicate in _STRING_PREDICATES:
                return eff in (Mapping.STRING, Mapping.TEXTSTRING)
            return False
        if info.data_type is Geoshape:
            return predicate in (
                Geo.INTERSECT,
                Geo.DISJOINT,
                Geo.WITHIN,
                Geo.CONTAINS,
                Cmp.EQUAL,
                Contain.IN,
            )
        return predicate in _STRING_PREDICATES | _ORDER_PREDICATES

    def exists(self) -> bool:
        return bool(self._stores)

    def close(self) -> None:
        self._closed = True

    def clear_storage(self) -> None:
        with self._lock:
            self._stores = {}


register_index_provider("memindex", InMemoryIndexProvider)
