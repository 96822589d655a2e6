"""janusgraph_tpu_torch — janusgraph_tpu on PyTorch and CUDA.

A second package beside ``janusgraph_tpu`` (the JAX reference). It imports
``torch`` and numpy only, never ``jax`` and nothing of ``janusgraph_tpu``:
every host-side helper it needs (the native host library, the storage read
path, the codecs, the segment-sum plan, the ELL pack) is its own copy, so
the two packages can be held against each other on the same inputs.

``open_graph`` opens a stored graph (in memory); ``graph.traversal()`` is
the Gremlin entry point over it, ``graph.compute()`` the OLAP one, and
``janusgraph_tpu_torch.olap.run_on`` the one over a CSR snapshot.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
with no CUDA device and no explicit device they raise.
"""

from janusgraph_tpu_torch.core.graph import open_graph  # noqa: F401
from janusgraph_tpu_torch.device import resolve_device  # noqa: F401
