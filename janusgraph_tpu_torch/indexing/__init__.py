"""Mixed (full-text / range / geo) index providers — the port's copy of
``janusgraph_tpu/indexing/``.

``provider.py`` holds the SPI (query trees, ``IndexMutation``,
``IndexTransaction``, the shorthand registry); ``memindex.py`` the host
in-memory provider ("memindex", the default of ``index.search.backend``);
``localindex.py`` the persistent provider ("localindex", a directory in
``index.search.directory``) whose files are byte-compatible with the
reference's; ``remote.py`` the remote provider ("remote",
``RemoteIndexProvider`` on ``index.search.hostname`` and
``index.search.port``) and the server that serves any provider over TCP
(``RemoteIndexServer``).
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
from janusgraph_tpu_torch.indexing.remote import RemoteIndexProvider, RemoteIndexServer

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
    "RemoteIndexProvider",
    "RemoteIndexServer",
    "register_index_provider",
    "open_index_provider",
]
