"""Mixed (full-text / range / geo) index providers — the port's copy of
``janusgraph_tpu/indexing/`` without the remote provider.

``provider.py`` holds the SPI (query trees, ``IndexMutation``,
``IndexTransaction``, the shorthand registry); ``memindex.py`` the host
in-memory provider ("memindex", the default of ``index.search.backend``);
``localindex.py`` the persistent provider ("localindex", a directory in
``index.search.directory``) whose files are byte-compatible with the
reference's. "remote" raises: the remote index provider waits for ROADMAP
Queue A #5.5b.
"""

from janusgraph_tpu_torch.indexing.provider import (
    And,
    IndexEntry,
    IndexFeatures,
    IndexMutation,
    IndexProvider,
    IndexQuery,
    IndexTransaction,
    KeyInformation,
    Mapping,
    Not,
    Or,
    Order,
    PredicateCondition,
    RawQuery,
    register_index_provider,
    open_index_provider,
)
from janusgraph_tpu_torch.indexing.memindex import InMemoryIndexProvider
from janusgraph_tpu_torch.indexing.localindex import LocalIndexProvider

__all__ = [
    "And",
    "IndexEntry",
    "IndexFeatures",
    "IndexMutation",
    "IndexProvider",
    "IndexQuery",
    "IndexTransaction",
    "InMemoryIndexProvider",
    "LocalIndexProvider",
    "KeyInformation",
    "Mapping",
    "Not",
    "Or",
    "Order",
    "PredicateCondition",
    "RawQuery",
    "register_index_provider",
    "open_index_provider",
]
