"""The multi-device layer: the sharded BSP executor over a single-process
mesh (``sharded``, ``compat``, ``halo``, ``sharded_frontier``) and the
single-process half of the multi-host glue (``multihost``)."""

from janusgraph_tpu_torch.parallel.compat import Mesh  # noqa: F401
from janusgraph_tpu_torch.parallel.sharded import ShardedExecutor, shard_csr  # noqa: F401
