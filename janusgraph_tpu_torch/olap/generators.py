"""Synthetic graph generators — the port of the numpy R-MAT path of
``janusgraph_tpu/olap/generators.py``.

R-MAT / Kronecker generator with graph500 reference parameters
(a,b,c,d = 0.57, 0.19, 0.19, 0.05, edge factor 16), one random draw per
(edge, level). The reference prefers a native generator that draws other
edges from the same seed, so tests compare CSRs built from the same edge
lists, never generator outputs.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from janusgraph_tpu_torch.olap.csr import CSRGraph, csr_from_edges


def rmat_edges(
    scale: int,
    edge_factor: int = 16,
    a: float = 0.57,
    b: float = 0.19,
    c: float = 0.19,
    seed: int = 1,
    permute: bool = True,
) -> Tuple[int, np.ndarray, np.ndarray]:
    """Return (n, src, dst) with n = 2**scale, m = n * edge_factor edges."""
    n = 1 << scale
    m = n * edge_factor
    rng = np.random.default_rng(seed)
    src = np.zeros(m, dtype=np.int64)
    dst = np.zeros(m, dtype=np.int64)
    ab = a + b
    abc = a + b + c
    for _ in range(scale):
        r = rng.random(m)
        src_bit = r >= ab
        dst_bit = ((r >= a) & (r < ab)) | (r >= abc)
        src = (src << 1) | src_bit
        dst = (dst << 1) | dst_bit
    if permute:
        perm = rng.permutation(n)
        src = perm[src]
        dst = perm[dst]
    return n, src.astype(np.int32), dst.astype(np.int32)


def rmat_csr(
    scale: int, edge_factor: int = 16, seed: int = 1, weights: bool = False
) -> CSRGraph:
    n, src, dst = rmat_edges(scale, edge_factor, seed=seed)
    w = None
    if weights:
        w = np.random.default_rng(seed + 1).uniform(0.5, 2.0, len(src)).astype(
            np.float32
        )
    return csr_from_edges(n, src, dst, w)
