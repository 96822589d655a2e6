"""The port's storage layer: the KCVS interface, the in-memory store, the
ID authority and the backend (copies of ``janusgraph_tpu/storage``'s read
and bulk-write path)."""

from janusgraph_tpu_torch.storage.inmemory import InMemoryStoreManager  # noqa: F401
from janusgraph_tpu_torch.storage.kcvs import (  # noqa: F401
    KCVMutation,
    KeyRangeQuery,
    KeySliceQuery,
    SliceQuery,
    StoreFeatures,
    StoreTransaction,
)
