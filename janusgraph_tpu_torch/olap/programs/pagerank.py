"""PageRank as array-BSP — the port of
``janusgraph_tpu/olap/programs/pagerank.py``.

Damping, out-degree-normalized contributions, fixed-point iteration.
Dangling-vertex rank mass is redistributed uniformly each superstep; the
mass is a global aggregator computed the superstep before it is consumed.
"""

from __future__ import annotations

import torch

from janusgraph_tpu_torch.olap.vertex_program import Combiner, VertexProgram


class PageRankProgram(VertexProgram):
    compute_keys = ("rank",)
    combiner = Combiner.SUM

    def __init__(self, damping: float = 0.85, tol: float = 1e-9, max_iterations: int = 30):
        self.damping = damping
        self.tol = tol
        self.max_iterations = max_iterations

    def setup(self, graph):
        n = graph.num_vertices
        rank = graph.active * (1.0 / n)
        dangling = torch.sum(torch.where(graph.out_degree == 0, rank, 0.0))
        return {"rank": rank}, {"dangling": (Combiner.SUM, dangling)}

    def message(self, state, superstep, graph):
        return state["rank"] / torch.clamp_min(graph.out_degree, 1)

    def apply(self, state, aggregated, superstep, memory_in, graph):
        n = graph.num_vertices
        d = self.damping
        active = graph.active
        dangling = memory_in["dangling"]
        new_rank = active * ((1.0 - d) / n + d * (aggregated + dangling / n))
        delta = torch.sum(torch.abs(new_rank - state["rank"]))
        new_dangling = torch.sum(
            torch.where((graph.out_degree == 0) & (active > 0), new_rank, 0.0)
        )
        return {"rank": new_rank}, {
            "delta": (Combiner.SUM, delta),
            "dangling": (Combiner.SUM, new_dangling),
        }

    def terminate(self, memory):
        return memory.superstep > 1 and memory.get("delta", 1.0) < self.tol

    def terminate_device(self, values, steps_done):
        return torch.logical_and(
            torch.as_tensor(steps_done > 1), values["delta"] < self.tol
        )
