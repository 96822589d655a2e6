"""Peer-pressure community detection / label propagation — the port of
``janusgraph_tpu/olap/programs/peer_pressure.py``.

Each vertex repeatedly adopts the most frequent cluster label among its
neighbors. The mode is not a per-message monoid, so the program alternates
two phases, each a monoid reduce over fixed-width messages:

  phase A (SUM, even supersteps): neighbors send a one-hot over K label
    buckets; the count vector's argmax picks the winning bucket per vertex.
  phase B (MIN, odd supersteps): neighbors send their label masked into its
    bucket slot (INF elsewhere); each vertex adopts the minimum label
    present in its winning bucket.

With K >= the number of live labels the result is the exact mode with a
min tiebreak; a smaller K trades memory for bucket collisions. The
superstep is a Python int here, so the phase is a plain branch.
"""

from __future__ import annotations

import torch

from janusgraph_tpu_torch.olap.vertex_program import INF, Combiner, VertexProgram


class PeerPressureProgram(VertexProgram):
    compute_keys = ("cluster",)
    undirected = True

    def __init__(self, num_buckets: int = 64, rounds: int = 30):
        self.K = num_buckets
        self.rounds = rounds
        self.max_iterations = rounds * 2

    def combiner_for(self, superstep: int) -> str:
        return Combiner.SUM if superstep % 2 == 0 else Combiner.MIN

    def _bucket(self, labels: torch.Tensor) -> torch.Tensor:
        return torch.remainder(labels.to(torch.int32), self.K)

    def setup(self, graph):
        labels = torch.arange(
            graph.local_num_vertices, dtype=torch.float32, device=graph.device
        ) + graph.global_offset
        changed = torch.tensor(1.0, device=graph.device)
        return (
            {"cluster": labels, "chosen": self._bucket(labels)},
            {"changed": (Combiner.SUM, changed)},
        )

    def message(self, state, superstep, graph):
        labels = state["cluster"]
        k = torch.arange(self.K, dtype=torch.int32, device=labels.device)
        onehot = self._bucket(labels)[:, None] == k[None, :]
        if superstep % 2 == 0:
            return onehot.to(torch.float32)
        return torch.where(onehot, labels[:, None], INF)

    def apply(self, state, aggregated, superstep, memory_in, graph):
        if superstep % 2 == 0:
            # argmax takes the first maximum: the lowest bucket wins a tie;
            # vertices with no neighbors keep their own bucket
            best = torch.argmax(aggregated, dim=1).to(torch.int32)
            has_neighbors = torch.sum(aggregated, dim=1) > 0
            chosen = torch.where(has_neighbors, best, state["chosen"])
            new_state = {"cluster": state["cluster"], "chosen": chosen}
            changed = torch.tensor(1.0, device=aggregated.device)
        else:
            rows = torch.arange(aggregated.shape[0], device=aggregated.device)
            candidate = aggregated[rows, state["chosen"].long()]
            new = torch.where(candidate < INF, candidate, state["cluster"])
            changed = torch.sum((new != state["cluster"]).to(torch.float32))
            new_state = {"cluster": new, "chosen": state["chosen"]}
        return new_state, {"changed": (Combiner.SUM, changed)}

    def terminate(self, memory):
        # stop after a resolve phase in which nothing changed
        return (
            memory.superstep % 2 == 0
            and memory.superstep > 1
            and memory.get("changed", 1.0) == 0.0
        )

    def terminate_device(self, values, steps_done):
        # elementwise: on a device step counter `and` would be a host sync
        after_resolve = torch.logical_and(
            torch.as_tensor(steps_done % 2 == 0), torch.as_tensor(steps_done > 1)
        )
        return torch.logical_and(after_resolve, values["changed"] == 0.0)
