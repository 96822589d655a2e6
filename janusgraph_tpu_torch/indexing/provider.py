"""Index provider SPI: the contract every mixed-index backend implements.

Capability parity with the reference's indexing SPI (reference:
diskstorage/indexing/IndexProvider.java:36 — register/mutate/query/
raw_query/totals/restore/exists/close/clearStorage + supports();
IndexMutation.java — per-document add/delete entry lists with isNew/
isDeleted; IndexTransaction.java:1 — transaction-scoped mutation buffer
flushed at commit; IndexQuery condition tree And/Or/Not/PredicateCondition
with orders and limits; RawQuery for provider-syntax string queries).

The port's copy of ``janusgraph_tpu/indexing/provider.py``. The shorthand
"remote" is registered as a factory that raises: the remote index provider
waits for ROADMAP Queue A #5.5b.

Design divergence from the reference: conditions are tiny frozen dataclasses
evaluated by each provider directly (no TinkerPop Condition hierarchy), and
document values are plain Python objects — the serializer boundary lives in
the graph layer, not here.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from enum import Enum
from typing import Callable, Dict, List, Optional, Tuple

from janusgraph_tpu_torch.core.predicates import Predicate
from janusgraph_tpu_torch.exceptions import ConfigurationError


class Mapping(Enum):
    """How a string key is indexed (reference:
    core/schema/Mapping.java — DEFAULT/TEXT/STRING/TEXTSTRING)."""

    DEFAULT = "DEFAULT"
    TEXT = "TEXT"
    STRING = "STRING"
    TEXTSTRING = "TEXTSTRING"


@dataclass(frozen=True)
class KeyInformation:
    """Per-field index metadata (reference:
    diskstorage/indexing/KeyInformation.java — data type + parameters)."""

    data_type: type
    mapping: Mapping = Mapping.DEFAULT
    cardinality: str = "SINGLE"


@dataclass(frozen=True)
class PredicateCondition:
    key: str
    predicate: Predicate
    value: object


@dataclass(frozen=True)
class And:
    children: Tuple[object, ...]


@dataclass(frozen=True)
class Or:
    children: Tuple[object, ...]


@dataclass(frozen=True)
class Not:
    child: object


@dataclass(frozen=True)
class Order:
    key: str
    desc: bool = False


@dataclass(frozen=True)
class IndexQuery:
    """reference: diskstorage/indexing/IndexQuery.java."""

    condition: object
    orders: Tuple[Order, ...] = ()
    limit: Optional[int] = None
    offset: int = 0


@dataclass(frozen=True)
class RawQuery:
    """Provider-syntax string query (reference:
    diskstorage/indexing/RawQuery.java)."""

    query: str
    limit: Optional[int] = None
    offset: int = 0


@dataclass(frozen=True)
class IndexEntry:
    field: str
    value: object


class IndexMutation:
    """Per-document pending change set (reference:
    diskstorage/indexing/IndexMutation.java)."""

    def __init__(self, is_new: bool = False, is_deleted: bool = False):
        self.additions: List[IndexEntry] = []
        self.deletions: List[IndexEntry] = []
        self.is_new = is_new
        self.is_deleted = is_deleted

    def add(self, field: str, value) -> None:
        self.additions.append(IndexEntry(field, value))

    def delete(self, field: str, value) -> None:
        self.deletions.append(IndexEntry(field, value))

    def merge(self, other: "IndexMutation") -> None:
        self.additions.extend(other.additions)
        self.deletions.extend(other.deletions)
        self.is_new = self.is_new or other.is_new
        self.is_deleted = self.is_deleted or other.is_deleted


@dataclass(frozen=True)
class IndexFeatures:
    """Capability flags (reference:
    diskstorage/indexing/IndexFeatures.java)."""

    supports_document_ttl: bool = False
    supports_cardinality: Tuple[str, ...] = ("SINGLE",)
    supports_custom_analyzer: bool = False
    supports_geo: bool = True
    supports_not_query_normal_form: bool = True


class IndexProvider:
    """The mixed-index backend SPI (reference: IndexProvider.java:36)."""

    name = "abstract"

    def features(self) -> IndexFeatures:
        return IndexFeatures()

    def register(self, store: str, key: str, info: KeyInformation) -> None:
        """Declare a field before writing documents that use it
        (reference: IndexProvider.register)."""
        raise NotImplementedError

    def mutate(
        self,
        mutations: Dict[str, Dict[str, IndexMutation]],
        key_infos: Dict[str, Dict[str, KeyInformation]],
    ) -> None:
        """Apply {store -> {docid -> mutation}} (reference:
        IndexProvider.mutate)."""
        raise NotImplementedError

    def restore(
        self,
        documents: Dict[str, Dict[str, List[IndexEntry]]],
        key_infos: Dict[str, Dict[str, KeyInformation]],
    ) -> None:
        """Overwrite documents from authoritative primary-storage state
        (reference: IndexProvider.restore — used by recovery + reindex)."""
        raise NotImplementedError

    def query(self, store: str, q: IndexQuery) -> List[str]:
        raise NotImplementedError

    #: index.search.scroll-page-size (set by open_index_provider)
    scroll_page_size = 1000

    def query_stream(
        self, store: str, q: IndexQuery, page_size: Optional[int] = None
    ):
        """Stream hits in pages — the scroll-API analogue in PURPOSE
        (reference: janusgraph-es .../ElasticSearchScroll.java:80 pages
        large result sets instead of materializing them), not in isolation
        level: this is offset-window paging, with each page reading the
        provider's CURRENT committed state. Under concurrent mutation a
        shifting window can skip or repeat a document — run sweeps that
        need exactly-once visitation (reindex/restore) against a quiesced
        index, or use a single bounded query(). The remote provider issues
        one bounded wire call per page."""
        if page_size is None:
            page_size = self.scroll_page_size
        offset = q.offset
        remaining = q.limit
        while True:
            page = page_size if remaining is None else min(page_size, remaining)
            if page <= 0:
                return
            hits = self.query(
                store, IndexQuery(q.condition, q.orders, page, offset)
            )
            yield from hits
            if len(hits) < page:
                return
            offset += len(hits)
            if remaining is not None:
                remaining -= len(hits)

    def raw_query(self, store: str, q: RawQuery) -> List[Tuple[str, float]]:
        raise NotImplementedError

    def totals(self, store: str, q: RawQuery) -> int:
        raise NotImplementedError

    def supports(self, info: KeyInformation, predicate: Predicate) -> bool:
        raise NotImplementedError

    def exists(self) -> bool:
        raise NotImplementedError

    def close(self) -> None:
        pass

    def clear_storage(self) -> None:
        raise NotImplementedError


class IndexTransaction:
    """Buffers document mutations for one graph transaction and flushes them
    in a single provider.mutate call at commit (reference:
    diskstorage/indexing/IndexTransaction.java — register/add/delete then
    flushInternal)."""

    def __init__(self, provider: IndexProvider, key_informations):
        self.provider = provider
        self._key_infos = key_informations  # {store: {field: KeyInformation}}
        self._mutations: Dict[str, Dict[str, IndexMutation]] = {}

    def _mutation(self, store: str, docid: str) -> IndexMutation:
        return self._mutations.setdefault(store, {}).setdefault(
            docid, IndexMutation()
        )

    def register(self, store: str, key: str, info: KeyInformation) -> None:
        self._key_infos.setdefault(store, {})[key] = info
        self.provider.register(store, key, info)

    def add(self, store: str, docid: str, field: str, value, is_new=False) -> None:
        m = self._mutation(store, docid)
        m.is_new = m.is_new or is_new
        m.add(field, value)

    def delete(
        self, store: str, docid: str, field: str, value, delete_all=False
    ) -> None:
        m = self._mutation(store, docid)
        m.is_deleted = m.is_deleted or delete_all
        if field is not None:
            m.delete(field, value)

    def has_mutations(self) -> bool:
        return bool(self._mutations)

    def commit(self) -> None:
        if self._mutations:
            self.provider.mutate(self._mutations, self._key_infos)
            self._mutations = {}

    def rollback(self) -> None:
        self._mutations = {}

    # queries pass straight through (reads see committed index state only,
    # matching the reference's mixed-index visibility semantics)
    def query(self, store: str, q: IndexQuery) -> List[str]:
        return self.provider.query(store, q)

    def raw_query(self, store: str, q: RawQuery):
        return self.provider.raw_query(store, q)


_PROVIDERS: Dict[str, Callable[..., IndexProvider]] = {}
_PROVIDERS_LOCK = threading.Lock()


def register_index_provider(name: str, factory) -> None:
    """Shorthand registry (reference: StandardIndexProvider.java — the
    es/lucene/solr shorthand map)."""
    with _PROVIDERS_LOCK:
        _PROVIDERS[name] = factory


def open_index_provider(
    name: str, scroll_page_size: Optional[int] = None, **kwargs
) -> IndexProvider:
    with _PROVIDERS_LOCK:
        factory = _PROVIDERS.get(name)
    if factory is None:
        raise ConfigurationError(f"unknown index backend {name!r}")
    provider = factory(**kwargs)
    if scroll_page_size:
        provider.scroll_page_size = scroll_page_size
    return provider


def _remote_not_ported(**_kwargs):
    raise ConfigurationError(
        "index backend 'remote' is not ported yet: ROADMAP.md Queue A #5.5b "
        "(the remote index provider)"
    )


register_index_provider("remote", _remote_not_ported)
