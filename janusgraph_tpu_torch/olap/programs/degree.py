"""Degree-count vertex program — the port of
``janusgraph_tpu/olap/programs/degree.py``.

One superstep: every vertex sends 1 along its out-edges; SUM-combining at
the receiver gives the in-degree (one launch of the segment-sum kernel
under ``strategy="segsum"``). The out-degree is already a CSR array, so
both land as compute keys in one pass. The smallest complete program: the
usual first check of a graph computer.
"""

from __future__ import annotations

import torch

from janusgraph_tpu_torch.olap.vertex_program import Combiner, VertexProgram


class DegreeCountProgram(VertexProgram):
    compute_keys = ("in_degree", "out_degree")
    combiner = Combiner.SUM
    max_iterations = 1

    def setup(self, graph):
        out_degree = graph.out_degree.to(torch.float32)
        return (
            {"in_degree": torch.zeros_like(out_degree), "out_degree": out_degree},
            {"total": (Combiner.SUM, torch.sum(out_degree))},
        )

    def message(self, state, superstep, graph):
        return torch.ones(graph.local_num_vertices, dtype=torch.float32,
                          device=graph.out_degree.device)

    def apply(self, state, aggregated, superstep, memory_in, graph):
        return (
            {"in_degree": aggregated, "out_degree": state["out_degree"]},
            {"total": (Combiner.SUM, torch.sum(aggregated))},
        )

    def terminate(self, memory):
        return memory.superstep >= 1

    def terminate_device(self, values, steps_done):
        return torch.as_tensor(steps_done >= 1)
