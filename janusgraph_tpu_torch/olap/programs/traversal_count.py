"""K-hop traversal counting — the port of
``janusgraph_tpu/olap/programs/traversal_count.py``.

g.V().out().out().out().count() as array-BSP: traverser bulks are
per-vertex counts, each hop is one SUM message round (one launch of the
segment-sum kernel under ``strategy="segsum"``), the answer is the sum of
the counts.
"""

from __future__ import annotations

import torch

from janusgraph_tpu_torch.olap.vertex_program import Combiner, VertexProgram


class TraversalCountProgram(VertexProgram):
    """After k supersteps, state['count'][i] = number of k-hop paths ending
    at vertex i; the global path count is their sum."""

    compute_keys = ("count",)
    combiner = Combiner.SUM

    def __init__(self, hops: int, labels=None):
        self.max_iterations = hops
        self.hops = hops
        self.labels = labels  # edge-label restriction applied at CSR load

    def setup(self, graph):
        counts = graph.active * 1.0
        return {"count": counts}, {"total": (Combiner.SUM, torch.sum(counts))}

    def message(self, state, superstep, graph):
        return state["count"]

    def apply(self, state, aggregated, superstep, memory_in, graph):
        return {"count": aggregated}, {"total": (Combiner.SUM, torch.sum(aggregated))}

    def terminate(self, memory):
        return memory.superstep >= self.hops

    def terminate_device(self, values, steps_done):
        return torch.as_tensor(steps_done >= self.hops)
