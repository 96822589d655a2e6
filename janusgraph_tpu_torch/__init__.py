"""janusgraph_tpu_torch — the OLAP path of janusgraph_tpu on PyTorch and CUDA.

A second package beside ``janusgraph_tpu`` (the JAX reference). It imports
``torch`` and numpy only, never ``jax`` and nothing of ``janusgraph_tpu``:
every host-side helper it needs (CSR build, R-MAT generator, segment-sum
plan, ELL pack) is its own copy, so the two packages can be held against
each other on the same inputs.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
with no CUDA device and no explicit device they raise.
"""

from janusgraph_tpu_torch.device import resolve_device  # noqa: F401
