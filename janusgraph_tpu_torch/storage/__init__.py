"""The port's storage layer (copies of ``janusgraph_tpu/storage``): the
KCVS interface, the in-memory store with cell TTL, the ordered-KV adapter
and the persistent local store, the remote store over TCP (``remote.py``
with its pipelined framing in ``pipeline.py`` and the client's circuit
breaker in ``circuit.py``), the ID authority, the slice cache, the
consistent-key locker, the TTL wrapper, the retry guard and the
backend. The package exports what the reference's does: the KCVS
interface and the in-memory store."""

from janusgraph_tpu_torch.storage.inmemory import InMemoryStoreManager  # noqa: F401
from janusgraph_tpu_torch.storage.kcvs import (  # noqa: F401
    Entry,
    EntryList,
    KCVMutation,
    KeyColumnValueStore,
    KeyColumnValueStoreManager,
    KeyRangeQuery,
    KeySliceQuery,
    SliceQuery,
    StoreFeatures,
    StoreTransaction,
)
