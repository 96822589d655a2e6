"""The multi-device layer: the sharded BSP executor over a mesh of device
slots (``sharded``, ``compat``, ``halo``, ``sharded_frontier``), which may
span processes, and the multi-host glue that forms the process group over
``torch.distributed`` (``multihost``)."""

from janusgraph_tpu_torch.parallel.compat import Mesh  # noqa: F401
from janusgraph_tpu_torch.parallel.sharded import ShardedExecutor, shard_csr  # noqa: F401
