"""Connected components by min-label propagation — the port of
``janusgraph_tpu/olap/programs/connected_components.py``.

Every vertex starts with its own index as label and adopts the minimum
label among itself and its (undirected) neighbors until fixpoint. Labels
are float32 like the reference's device path, exact below 2^24 vertices.
"""

from __future__ import annotations

import torch

from janusgraph_tpu_torch.olap.vertex_program import Combiner, VertexProgram


class ConnectedComponentsProgram(VertexProgram):
    compute_keys = ("component",)
    combiner = Combiner.MIN
    undirected = True
    frontier_kind = "cc"

    def __init__(self, max_iterations: int = 200):
        self.max_iterations = max_iterations

    def setup(self, graph):
        # the state spans the view's whole index domain: a delta view pads
        # it past the real vertices (``local_num_vertices``)
        if graph.local_num_vertices + graph.global_offset >= (1 << 24):
            raise ValueError(
                "float32 component labels are exact below 2^24 vertices only"
            )
        labels = torch.arange(
            graph.local_num_vertices, dtype=torch.float32, device=graph.device
        ) + graph.global_offset
        changed = torch.tensor(1.0, device=graph.device)
        return {"component": labels}, {"changed": (Combiner.SUM, changed)}

    def message(self, state, superstep, graph):
        return state["component"]

    def apply(self, state, aggregated, superstep, memory_in, graph):
        old = state["component"]
        new = torch.minimum(old, aggregated)
        changed = torch.sum((new < old).to(torch.float32))
        return {"component": new}, {"changed": (Combiner.SUM, changed)}

    def terminate(self, memory):
        return memory.get("changed", 1.0) == 0.0

    def terminate_device(self, values, steps_done):
        return values["changed"] == 0.0
