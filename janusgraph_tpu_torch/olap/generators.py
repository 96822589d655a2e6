"""Synthetic graph generators — the port of
``janusgraph_tpu/olap/generators.py``.

R-MAT / Kronecker generator with graph500 reference parameters
(a,b,c,d = 0.57, 0.19, 0.19, 0.05, edge factor 16), one random draw per
(edge, level). The reference prefers a native generator that draws other
edges from the same seed, so tests compare CSRs built from the same R-MAT
edge lists, never R-MAT generator outputs.

The LDBC-SNB-shaped and Twitter-shaped proxies are numpy only: the same
seed gives the reference's arrays.
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


def _land_edge_count(deg: np.ndarray, target: int, rng) -> np.ndarray:
    """Nudge a per-vertex degree vector until it sums to exactly ``target``
    (dataset-sized proxies must hit documented edge counts), with
    ``np.add.at``/``np.subtract.at`` (fancy-index += drops duplicates). The
    clamp to 1 after trimming can add mass back, so iterate; a target
    below ``len(deg)`` stops early."""
    n = len(deg)
    for _ in range(8):
        diff = target - int(deg.sum())
        if diff == 0:
            break
        if diff > 0:
            np.add.at(deg, rng.integers(0, n, diff), 1)
        else:
            np.subtract.at(deg, rng.integers(0, n, -diff), 1)
            np.maximum(deg, 1, out=deg)
            if int(deg.sum()) <= n:
                break
    return deg


def ldbc_snb_edges(
    scale: int,
    edge_factor: int = 18,
    intra_community: float = 0.8,
    seed: int = 7,
) -> Tuple[int, np.ndarray, np.ndarray, dict]:
    """Deterministic LDBC-SNB-shaped social network proxy at 2**scale
    vertices (see ``_snb_edges_n`` for the shape model)."""
    return _snb_edges_n(1 << scale, edge_factor, intra_community, seed)


def _snb_edges_n(
    n: int,
    edge_factor: float = 18,
    intra_community: float = 0.8,
    seed: int = 7,
) -> Tuple[int, np.ndarray, np.ndarray, dict]:
    """LDBC-SNB-shaped social network proxy: the shape the SNB
    person-knows-person network is documented to have (heavy-tailed
    degrees, strong community locality with a minority of cross-community
    edges, community-correlated attributes).

    Returns (n, src, dst, properties) with properties:
      community    (n,) int32 — community id (city/university analogue)
      country      (n,) int32 — coarser grouping correlated with community
      creation_day (n,) int32 — days-since-epoch-style attribute
    """
    rng = np.random.default_rng(seed)

    # community sizes ~ Zipf, heavy-tailed like SNB city populations
    n_comm = max(8, n >> 7)
    raw = 1.0 / np.arange(1, n_comm + 1, dtype=np.float64) ** 0.85
    comm_of = rng.choice(n_comm, size=n, p=raw / raw.sum()).astype(np.int32)

    # per-vertex out-degree: lognormal, clipped, scaled to the edge factor
    deg = rng.lognormal(mean=0.0, sigma=1.1, size=n)
    deg = np.maximum(1, (deg * (edge_factor / deg.mean()))).astype(np.int64)
    deg = np.minimum(deg, n // 4)
    deg = _land_edge_count(deg, int(round(n * edge_factor)), rng)
    m = int(deg.sum())
    src = np.repeat(np.arange(n, dtype=np.int64), deg)

    # community membership table for intra-community endpoint sampling
    order = np.argsort(comm_of, kind="stable")
    sizes = np.bincount(comm_of, minlength=n_comm).astype(np.int64)
    starts = np.concatenate([[0], np.cumsum(sizes)[:-1]])

    u = rng.random(m)
    intra = rng.random(m) < intra_community
    c_src = comm_of[src]
    # intra: a uniform member of the source's community
    pick = starts[c_src] + np.minimum(
        (u * np.maximum(sizes[c_src], 1)).astype(np.int64),
        np.maximum(sizes[c_src] - 1, 0),
    )
    dst_intra = order[pick]
    # inter: a degree-weighted global endpoint (SNB's hub overlap across
    # communities)
    cum = np.cumsum(deg)
    dst_inter = np.searchsorted(cum, rng.random(m) * cum[-1], side="right")
    dst = np.where(intra, dst_intra, dst_inter).astype(np.int64)
    # drop self-loops by nudging to the next vertex
    self_loop = dst == src
    dst[self_loop] = (dst[self_loop] + 1) % n

    props = {
        "community": comm_of,
        "country": (comm_of % 60).astype(np.int32),
        "creation_day": rng.integers(0, 3650, n).astype(np.int32),
    }
    return n, src.astype(np.int32), dst.astype(np.int32), props


def ldbc_snb_csr(scale: int, edge_factor: int = 18, seed: int = 7) -> CSRGraph:
    """CSR form of the LDBC-SNB-shaped proxy with its properties."""
    n, src, dst, props = ldbc_snb_edges(scale, edge_factor, seed=seed)
    csr = csr_from_edges(n, src, dst)
    csr.properties.update(props)
    return csr


#: published LDBC-SNB scale-factor sizes (all entity types): sf ->
#: (vertices, total edges)
LDBC_SF_SIZES = {1: (3_200_000, 17_300_000), 10: (30_000_000, 176_000_000)}


def ldbc_sf_csr(sf: int = 1, seed: int = 7, scale_down: int = 1) -> CSRGraph:
    """SF-sized SNB-shaped proxy: the documented size of scale factor
    ``sf`` (SF1: 3.2M vertices, 17.3M edges) with the ``_snb_edges_n``
    shape. ``scale_down`` divides both dimensions (the shape is
    size-invariant)."""
    nv, ne = LDBC_SF_SIZES[sf]
    nv //= scale_down
    ne //= scale_down
    n, src, dst, props = _snb_edges_n(nv, ne / nv, seed=seed)
    csr = csr_from_edges(n, src, dst)
    csr.properties.update(props)
    return csr


def twitter_edges(
    n: int,
    edge_factor: float = 35.0,
    alpha: float = 2.3,
    seed: int = 11,
) -> Tuple[int, np.ndarray, np.ndarray]:
    """Twitter-2010-shaped follower-graph proxy (the crawl: 41.6M users,
    1.47B follows, in-degree power law with exponent ~2.3, celebrity hubs
    followed by a few percent of all users), at any size:

      - in-degree ∝ Pareto(alpha-1) attachment weights: power-law
        in-degrees with exponent ~alpha and extreme hubs,
      - out-degrees lognormal-heavy,
      - no community structure (unlike the SNB proxy).
    """
    rng = np.random.default_rng(seed)
    m = int(n * edge_factor)
    out_deg = rng.lognormal(mean=0.0, sigma=1.6, size=n)
    out_deg = np.maximum(1, out_deg * (edge_factor / out_deg.mean()))
    out_deg = np.minimum(out_deg.astype(np.int64), n // 2)
    out_deg = _land_edge_count(out_deg, m, rng)
    m = int(out_deg.sum())
    src = np.repeat(np.arange(n, dtype=np.int64), out_deg)

    # attachment weights: a Pareto tail gives celebrity in-degree hubs
    w = (1.0 / rng.random(n)) ** (1.0 / (alpha - 1.0))
    cum = np.cumsum(w)
    dst = np.searchsorted(cum, rng.random(m) * cum[-1], side="right")
    dst = np.minimum(dst, n - 1).astype(np.int64)
    self_loop = dst == src
    dst[self_loop] = (dst[self_loop] + 1) % n
    return n, src.astype(np.int32), dst.astype(np.int32)


def twitter_csr(n: int, edge_factor: float = 35.0, seed: int = 11) -> CSRGraph:
    """CSR form of the Twitter-2010-shaped proxy."""
    nv, src, dst = twitter_edges(n, edge_factor, seed=seed)
    return csr_from_edges(nv, src, dst)
