"""The port's storage layer (copies of ``janusgraph_tpu/storage``): the
KCVS interface, the in-memory store with cell TTL, the ordered-KV adapter
and the persistent local store, the ID authority, the slice cache, the
consistent-key locker, the TTL wrapper, the retry guard and the
backend."""

from janusgraph_tpu_torch.storage.inmemory import InMemoryStoreManager  # noqa: F401
from janusgraph_tpu_torch.storage.kcvs import (  # noqa: F401
    KCVMutation,
    KeyRangeQuery,
    KeySliceQuery,
    SliceQuery,
    StoreFeatures,
    StoreTransaction,
)
