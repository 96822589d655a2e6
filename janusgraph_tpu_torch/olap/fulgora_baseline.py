"""The Fulgora-analogue baseline — the port of
``janusgraph_tpu/olap/fulgora_baseline.py``.

JanusGraph's OLAP engine, Fulgora, runs a vertex program with a worker
thread pool over vertex partitions; each thread calls the program per
vertex and sends messages through per-vertex hash-map combiners, with a
barrier between supersteps (FulgoraGraphComputer, FulgoraVertexMemory).
This module is that architecture in Python: a per-vertex scalar loop,
per-worker message dicts merged at the barrier (a little generous to the
baseline: no lock contention), memory aggregators. It runs on the host
only; the ratio of a device run's edges/s to its edges/s is the frame of
the "50x over Fulgora" comparison.

CPython threads share the GIL, so the pool does not scale as a JVM's does:
the number measures the per-vertex hash-map architecture on about one core.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Tuple

import numpy as np


class FulgoraAnalogueComputer:
    """Threaded per-vertex BSP PageRank over a CSR snapshot, with
    ``PageRankProgram``'s semantics (damping, dangling mass spread
    uniformly), so its ranks compare with the executors'."""

    def __init__(self, csr, num_workers: int = 4):
        self.csr = csr
        self.num_workers = max(1, num_workers)

    def pagerank(self, iterations: int, damping: float = 0.85) -> Tuple[np.ndarray, float]:
        """Run ``iterations`` supersteps; returns (rank, wall_seconds), the
        wall covering the supersteps only (set-up excluded, as the
        executors are timed)."""
        csr = self.csr
        n = csr.num_vertices
        # adjacency as plain Python structures: the per-vertex loop sees
        # what Fulgora sees (object graphs, not arrays)
        out_indptr = csr.out_indptr
        out_dst = csr.out_dst.tolist()
        spans: List[Tuple[int, int]] = [
            (int(out_indptr[v]), int(out_indptr[v + 1])) for v in range(n)
        ]
        rank = [1.0 / n] * n

        # one vertex partition per worker
        bounds = np.linspace(0, n, self.num_workers + 1).astype(int)
        partitions = [
            range(int(bounds[i]), int(bounds[i + 1])) for i in range(self.num_workers)
        ]

        t0 = time.perf_counter()
        for _ in range(iterations):
            # per-worker message maps, merged at the barrier
            worker_maps: List[Dict[int, float]] = [{} for _ in range(self.num_workers)]
            dangling_parts = [0.0] * self.num_workers

            def execute_partition(wid: int, part) -> None:
                msgs = worker_maps[wid]
                dangling = 0.0
                for v in part:
                    lo, hi = spans[v]
                    if hi == lo:
                        dangling += rank[v]
                        continue
                    contrib = rank[v] / (hi - lo)
                    for e in range(lo, hi):
                        u = out_dst[e]
                        # hash-map SUM combiner, one slot per vertex
                        msgs[u] = msgs.get(u, 0.0) + contrib
                dangling_parts[wid] = dangling

            threads = [
                threading.Thread(target=execute_partition, args=(w, p))
                for w, p in enumerate(partitions)
            ]
            for t in threads:
                t.start()
            for t in threads:
                t.join()  # the superstep barrier

            combined: Dict[int, float] = worker_maps[0]
            for m in worker_maps[1:]:
                for u, c in m.items():
                    combined[u] = combined.get(u, 0.0) + c
            dangling = sum(dangling_parts)

            base = (1.0 - damping) / n + damping * dangling / n
            new_rank = [base] * n
            for u, agg in combined.items():
                new_rank[u] = base + damping * agg
            rank = new_rank
        wall = time.perf_counter() - t0
        return np.asarray(rank), wall


def measure_fulgora_baseline(csr, iterations: int = 2, num_workers: int = 4) -> Dict[str, float]:
    """Edges/s of the Fulgora analogue on ``csr`` over a few supersteps
    (each costs the same, so edges/s extrapolates)."""
    comp = FulgoraAnalogueComputer(csr, num_workers=num_workers)
    _rank, wall = comp.pagerank(iterations)
    return {
        "edges_per_sec": iterations * csr.num_edges / wall,
        "superstep_s": wall / iterations,
        "iterations": iterations,
        "num_workers": num_workers,
    }
