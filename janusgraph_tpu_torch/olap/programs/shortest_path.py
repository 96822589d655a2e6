"""Single-source shortest path / BSP BFS — the port of
``janusgraph_tpu/olap/programs/shortest_path.py``.

Min-combined distance relaxation until fixpoint. Unweighted mode is BFS
hop counting; weighted mode adds the edge weight in flight. The executor
runs the exact ``ShortestPathProgram`` type through the frontier engine
(``olap/frontier.py``) and any other path through the dense superstep; both
give the same distances bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from janusgraph_tpu_torch.olap.vertex_program import (  # noqa: F401 (INF re-exported)
    INF,
    Combiner,
    EdgeTransform,
    VertexProgram,
)


def _where(cond: torch.Tensor, a: float, b) -> torch.Tensor:
    """``where`` with scalar branches, in float32 on ``cond``'s device."""
    return torch.where(cond, torch.tensor(a, dtype=torch.float32, device=cond.device), b)


class ShortestPathProgram(VertexProgram):
    """Min-relaxation SSSP / BFS.

    track_paths=True also keeps a predecessor per vertex so paths can be
    rebuilt on the host (``reconstruct_path``). Unweighted only: at
    superstep t the frontier is exactly {dist == t}, so the message is the
    sender's own index where it is on the frontier and INF elsewhere;
    MIN-combining yields, at each newly reached vertex, the smallest-index
    frontier neighbor as its predecessor — float32-exact below 2^24
    vertices.
    """

    compute_keys = ("distance",)
    combiner = Combiner.MIN
    frontier_kind = "sssp"
    setup_only_params = ("seed_index",)

    def __init__(
        self,
        seed_index: int,
        weighted: bool = False,
        undirected: bool = False,
        max_iterations: int = 100,
        track_paths: bool = False,
    ):
        if track_paths and weighted:
            raise ValueError(
                "track_paths requires unweighted BFS (frontier-index "
                "predecessor encoding); for weighted paths run distances "
                "to fixpoint and derive predecessors with "
                "weighted_predecessors(csr, result, seed)"
            )
        self.seed_index = seed_index
        self.weighted = weighted
        self.track_paths = track_paths
        self.edge_transform = (
            EdgeTransform.ADD_WEIGHT if weighted else EdgeTransform.NONE
        )
        self.undirected = undirected
        self.max_iterations = max_iterations
        if track_paths:
            self.compute_keys = ("distance", "predecessor")

    @staticmethod
    def _index(graph) -> torch.Tensor:
        """The global index of every row of the view's domain."""
        return torch.arange(graph.local_num_vertices, device=graph.device) + graph.global_offset

    def setup(self, graph):
        idx = self._index(graph)
        is_seed = idx == self.seed_index
        inf = torch.full((graph.local_num_vertices,), INF, dtype=torch.float32, device=graph.device)
        state = {"distance": _where(is_seed, 0.0, inf)}
        if self.track_paths:
            if graph.num_vertices >= (1 << 24):
                raise ValueError(
                    "track_paths stores vertex indices in float32 state, "
                    "exact only below 2^24 vertices; run distances without "
                    "paths at this scale"
                )
            # seed points at itself; unreached at -1
            state["predecessor"] = _where(
                is_seed, float(self.seed_index), torch.full_like(inf, -1.0)
            )
        changed = torch.tensor(1.0, device=graph.device)
        return state, {"changed": (Combiner.SUM, changed)}

    def message(self, state, superstep, graph):
        dist = state["distance"]
        if self.track_paths:
            return torch.where(dist == superstep, self._index(graph).to(dist.dtype), INF)
        if self.weighted:
            return dist
        return dist + 1.0

    def apply(self, state, aggregated, superstep, memory_in, graph):
        old = state["distance"]
        if self.track_paths:
            newly = (old >= INF) & (aggregated < INF)
            dist = torch.where(newly, superstep + 1.0, old)
            pred = torch.where(newly, aggregated, state["predecessor"])
            changed = torch.sum(newly.to(torch.float32))
            return (
                {"distance": dist, "predecessor": pred},
                {"changed": (Combiner.SUM, changed)},
            )
        new = torch.minimum(old, aggregated)
        changed = torch.sum((new < old).to(torch.float32))
        return {"distance": new}, {"changed": (Combiner.SUM, changed)}

    def terminate(self, memory):
        return memory.get("changed", 1.0) == 0.0

    def terminate_device(self, values, steps_done):
        return values["changed"] == 0.0


def reconstruct_path(result, target_index: int):
    """Walk the predecessor chain on the host: [seed, ..., target], or None
    if the target was never reached. ``result`` is the output of a
    track_paths=True run."""
    # read in place: a copy of the n-length array per target would make
    # one path per reached vertex (the shortest_path() step) O(n) each
    pred = np.asarray(result["predecessor"])
    dist = np.asarray(result["distance"])
    if target_index >= len(pred) or dist[target_index] >= INF:
        return None
    path = [int(target_index)]
    v = int(target_index)
    for _ in range(len(pred)):
        p = int(pred[v])
        if p < 0:
            return None
        if p == v:  # seed reached
            return list(reversed(path))
        path.append(p)
        v = p
    return None  # cycle guard — malformed predecessor array


def weighted_predecessors(csr, result, seed_index: int):
    """Predecessor array for a WEIGHTED run, derived on the host from the
    converged distances in one vectorized O(E) pass: v's predecessor is any
    in-neighbor u with dist[u] + w(u,v) == dist[v] (ties broken by first
    slot). The device program cannot carry predecessors in weighted mode
    (its frontier-index encoding is hop-count-based), but at a fixpoint the
    relaxation equation identifies them exactly. Returns an array shaped
    like the unweighted tracker: pred[seed] = seed, -1 where unreached,
    ready for reconstruct_path. Weights accumulate in float32 on the
    device, so the equality check allows 1e-4 relative slack."""
    dist = np.asarray(result["distance"], dtype=np.float64)
    n = csr.num_vertices
    if csr.in_edge_weight is None:
        raise ValueError(
            "weighted_predecessors needs a CSR that carries edge weights"
        )
    src = csr.in_src.astype(np.int64)
    w = csr.in_edge_weight.astype(np.float64)
    dstv = np.repeat(np.arange(n, dtype=np.int64), np.diff(csr.in_indptr))
    cand = dist[src] + w
    ok = np.abs(cand - dist[dstv]) <= 1e-4 * np.maximum(1.0, np.abs(dist[dstv]))
    ok &= dist[dstv] < INF
    ok &= src != dstv  # a self-loop must never be its own predecessor
    pred = np.full(n, -1, dtype=np.int64)
    pred[seed_index] = seed_index
    # phase 1 — strict edges (dist[u] < dist[v]): any satisfying slot is a
    # valid predecessor; chains strictly decrease in distance, so no cycles
    strict = ok & (dist[src] < dist[dstv])
    s_slots = np.nonzero(strict)[0][::-1]  # first slot wins
    mask = pred[dstv[s_slots]] == -1
    # the seed's pred stays itself even if a strict in-edge matches
    mask &= dstv[s_slots] != seed_index
    pred[dstv[s_slots][mask]] = src[s_slots][mask]
    # phase 2 — zero-weight (sub-tolerance) equality edges: BFS from the
    # already-assigned set through them, so every assignment points
    # strictly toward the seed along a real shortest path
    eq_slots = np.nonzero(ok & (dist[src] >= dist[dstv]))[0]
    if len(eq_slots):
        from collections import defaultdict, deque

        out_eq = defaultdict(list)  # u -> [v] over equality edges
        for i in eq_slots:
            out_eq[int(src[i])].append(int(dstv[i]))
        # each vertex enqueues at most once (pred guard): bounded by n
        # graphlint: disable=JG206 -- BFS work queue: each vertex enqueues at most once (pred guard), so the bound is the vertex count
        queue = deque(int(v) for v in np.nonzero(pred != -1)[0])
        while queue:
            u = queue.popleft()
            for v in out_eq.get(u, ()):
                if pred[v] == -1:
                    pred[v] = u
                    queue.append(v)
    return pred
