"""GPU executor: BSP supersteps over a device-resident CSR — the port of
``janusgraph_tpu/olap/tpu_executor.py`` (single device, host loop).

Each superstep is message -> aggregate -> apply, run eagerly on the
executor's device. The only per-superstep device->host traffic is the
handful of aggregator scalars ``program.terminate`` reads at the barrier.

Strategies (``janusgraph_tpu_torch/olap/kernels.py``):
  - "segsum"  the CUDA sorted-segment-sum kernel (the counterpart of the
              reference's "pallas"); SUM only, other monoids fall back to
              "ell"
  - "ell"     degree-bucketed ELLPACK gather + adjacent-pair tree, plain
              torch, every monoid
  - "segment" gather + index_add_/index_reduce_, plain torch

Programs whose own class declares a ``frontier_kind`` (ShortestPath "sssp",
ConnectedComponents "cc") can run through the frontier engine
(``olap/frontier.py``). Under ``frontier="auto"`` BFS/SSSP takes it at every
size; CC takes it only under ``frontier="always"``: on the H100 the dense
ELL superstep is the faster CC at graph500 scale 20 (PERF.md), and no graph
is known on which the frontier CC wins. Every other run takes the host
loop, which reads ``program.combiner_for(step)`` each superstep and fetches
the aggregators every ``sync_every`` supersteps.

Not ported yet (ROADMAP.md): the fused on-device loop, checkpoints, the
delta overlay, autotune ("auto"/"hybrid"), typed edge channels, the sddmm
mode and telemetry spans.
"""

from __future__ import annotations

import time
from typing import Dict

import numpy as np
import torch

from janusgraph_tpu_torch.device import resolve_device
from janusgraph_tpu_torch.native import segment_ids
from janusgraph_tpu_torch.olap import kernels
from janusgraph_tpu_torch.olap.csr import CSRGraph
from janusgraph_tpu_torch.olap.frontier import FrontierEngine
from janusgraph_tpu_torch.olap.vertex_program import (
    Combiner,
    Memory,
    VertexProgram,
    apply_edge_transform,
    check_weighted_transforms,
)

STRATEGIES = ("segsum", "ell", "segment")
FRONTIER_MODES = ("auto", "off", "always")


class _DeviceGraph:
    """CSR arrays on the device + static metadata: the graph view programs
    read (num_vertices / out_degree / active / ...).

    Array fields are lazy: each moves to the device on first access and is
    cached, so a strategy that never reads an O(E) array never ships it."""

    _LAZY = {
        "active": lambda csr, dev: torch.ones(csr.num_vertices, dtype=torch.float32, device=dev),
        "out_degree": lambda csr, dev: torch.as_tensor(csr.out_degree, dtype=torch.float32, device=dev),
        "in_src": lambda csr, dev: torch.as_tensor(csr.in_src, device=dev),
        "in_dst_seg": lambda csr, dev: torch.as_tensor(
            segment_ids(csr.in_indptr, csr.num_edges).astype(np.int64), device=dev
        ),
        "out_dst": lambda csr, dev: torch.as_tensor(csr.out_dst, device=dev),
        "out_src_seg": lambda csr, dev: torch.as_tensor(
            segment_ids(csr.out_indptr, csr.num_edges).astype(np.int64), device=dev
        ),
        "in_edge_weight": lambda csr, dev: (
            torch.as_tensor(csr.in_edge_weight, device=dev)
            if csr.in_edge_weight is not None else None
        ),
        "out_edge_weight": lambda csr, dev: (
            torch.as_tensor(csr.out_edge_weight, device=dev)
            if csr.out_edge_weight is not None else None
        ),
    }

    def __init__(self, csr: CSRGraph, device: torch.device):
        self._csr = csr
        self.device = device
        self.num_vertices = csr.num_vertices
        self.num_edges = csr.num_edges

    def __getattr__(self, name):
        # only reached when `name` is not an instance attribute yet
        fn = _DeviceGraph._LAZY.get(name)
        if fn is None:
            raise AttributeError(name)
        val = fn(self._csr, self.device)
        setattr(self, name, val)
        return val


def _combine(op: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    if op == Combiner.SUM:
        return a + b
    if op == Combiner.MIN:
        return torch.minimum(a, b)
    return torch.maximum(a, b)


class GPUExecutor:
    """Single-device executor on a torch device (the card by default)."""

    def __init__(
        self,
        csr: CSRGraph,
        strategy: str = "segsum",
        device=None,
        frontier: str = "auto",
    ):
        if strategy not in STRATEGIES:
            raise ValueError(f"unknown aggregation strategy: {strategy!r}")
        if frontier not in FRONTIER_MODES:
            raise ValueError(f"unknown frontier mode: {frontier!r}")
        self.device = resolve_device(device)
        self.csr = csr
        self.strategy = strategy
        self.g = _DeviceGraph(csr, self.device)
        self._ell_packs: Dict[bool, kernels.ELLPack] = {}
        self._segsum_plans: Dict[str, kernels._SegSumPlan] = {}
        self._frontier_cfg = frontier
        self._frontier_engine = None
        #: per-run record: path ("frontier" or "host-loop"), supersteps,
        #: wall_s, kernel_launches; the host loop adds strategy_resolved,
        #: the frontier path its per-hop ``tiers`` and ``hop_wall_s``
        self.last_run_info: Dict[str, object] = {}

    # ------------------------------------------------------------ structures
    def _resolve_strategy(self, op: str) -> str:
        """The strategy actually used for a combiner monoid: the segsum
        kernel is SUM-only, other monoids fall back to ELL."""
        if self.strategy == "segsum" and op != Combiner.SUM:
            return "ell"
        return self.strategy

    def _edge_view(self, undirected: bool):
        """(src, dst, w) edge arrays of one orientation view."""
        csr = self.csr
        src = csr.in_src.astype(np.int64)
        dst = segment_ids(csr.in_indptr, csr.num_edges).astype(np.int64)
        w = csr.in_edge_weight
        if undirected:
            src = np.concatenate([src, csr.out_dst.astype(np.int64)])
            dst = np.concatenate([
                dst, segment_ids(csr.out_indptr, csr.num_edges).astype(np.int64),
            ])
            w = np.concatenate([w, csr.out_edge_weight]) if w is not None else None
        return src, dst, w

    def _ell_pack(self, undirected: bool) -> kernels.ELLPack:
        pack = self._ell_packs.get(undirected)
        if pack is None:
            src, dst, w = self._edge_view(undirected)
            pack = kernels.ELLPack(src, dst, w, self.csr.num_vertices).to(self.device)
            self._ell_packs[undirected] = pack
        return pack

    def _segsum_plan(self, orientation: str) -> kernels._SegSumPlan:
        """One plan per orientation, built once."""
        plan = self._segsum_plans.get(orientation)
        if plan is None:
            csr = self.csr
            indptr = csr.in_indptr if orientation == "in" else csr.out_indptr
            plan = kernels.make_segsum_plan(
                segment_ids(indptr, csr.num_edges), csr.num_vertices
            )
            self._segsum_plans[orientation] = plan
        return plan

    # ------------------------------------------------------------ superstep
    def _aggregate(self, program: VertexProgram, op: str, outgoing: torch.Tensor):
        """(aggregated messages, the strategy that computed them)."""
        g = self.g
        n = g.num_vertices
        strategy = self._resolve_strategy(op)
        if strategy == "ell":
            return kernels.ell_aggregate(
                self._ell_pack(program.undirected), outgoing, op, program.edge_transform
            ), strategy
        if strategy == "segsum" and outgoing.ndim > 1:
            strategy = "segment"  # the kernel sums scalars only
        views = [("in", g.in_src, g.in_edge_weight)]
        if program.undirected:
            views.append(("out", g.out_dst, g.out_edge_weight))
        total = None
        for orientation, src_idx, weight in views:
            msgs = apply_edge_transform(
                torch.index_select(outgoing, 0, src_idx), weight, program.edge_transform
            )
            if strategy == "segsum":
                part = kernels.sorted_segment_sum(msgs, self._segsum_plan(orientation))
            else:
                seg = g.in_dst_seg if orientation == "in" else g.out_src_seg
                part = kernels.segment_combine(op, msgs, seg, n)
            total = part if total is None else _combine(op, total, part)
        return total, strategy

    # --------------------------------------------------------------- frontier
    @staticmethod
    def _frontier_family(program: VertexProgram):
        """The ``frontier_kind`` the program's own class declares (None for
        any other program): a subclass may override message/apply, so it
        runs dense unless it declares the kind itself."""
        return type(program).__dict__.get("frontier_kind")

    def _frontier_eligible(self, program: VertexProgram, mode: str) -> bool:
        kind = self._frontier_family(program)
        if kind is None or self.csr.num_edges >= FrontierEngine.MAX_EDGES:
            return False
        if kind == "sssp":
            # predecessor indices ride float32 — the dense setup() raises
            # at 2^24 vertices; mirror that guard instead of rounding
            return not (program.track_paths and self.csr.num_vertices >= (1 << 24))
        # labels are float32 vertex indices: exact below 2^24 only; "auto"
        # keeps CC dense (the faster path on the card)
        return mode == "always" and self.csr.num_vertices < (1 << 24)

    def frontier_engine(self) -> FrontierEngine:
        """The executor's frontier engine, built on first use."""
        if self._frontier_engine is None:
            self._frontier_engine = FrontierEngine(self)
        return self._frontier_engine

    def _run_frontier(self, program: VertexProgram) -> Dict[str, np.ndarray]:
        engine = self.frontier_engine()
        t0 = time.perf_counter()
        if self._frontier_family(program) == "cc":
            out = engine.run_cc(program)
        else:
            out = engine.run(program)
        trace = engine.last_trace
        marks = engine.last_marks
        self.last_run_info = {
            "path": "frontier",
            "supersteps": len(trace),
            "wall_s": time.perf_counter() - t0,
            "tiers": trace,
            # host clock from one hop's plan fetch to the next fetch (or
            # the result fetch): each fetch waits for the hop before it
            "hop_wall_s": [marks[i + 1] - marks[i] for i in range(len(trace))],
        }
        return out

    # ------------------------------------------------------------------ run
    def run(
        self, program: VertexProgram, sync_every: int = 1, frontier: str = None
    ) -> Dict[str, np.ndarray]:
        """Run to termination; returns the final state as numpy arrays.

        ``frontier`` (default: the executor's mode) overrides the frontier
        routing for this run: "auto" takes it for BFS/SSSP, "always" for
        CC too (and raises where the graph is outside the engine's guards),
        "off" runs dense.

        The host loop fetches the aggregators every ``sync_every``
        supersteps (and after the last); ``program.terminate`` is read only
        there, never before the first superstep: before it the aggregators
        are identity-seeded placeholders (Fulgora semantics)."""
        check_weighted_transforms(program, self.csr)
        if frontier not in (None,) + FRONTIER_MODES:
            raise ValueError(f"unknown frontier mode: {frontier!r}")
        if sync_every < 1:
            raise ValueError(f"sync_every must be >= 1, got {sync_every}")
        mode = frontier or self._frontier_cfg
        use_frontier = False
        if mode != "off" and self._frontier_family(program):
            if self._frontier_eligible(program, mode):
                use_frontier = True
            elif mode == "always":
                raise ValueError(
                    "frontier='always' but the graph exceeds the frontier "
                    f"engine's guards (|V|={self.csr.num_vertices}, "
                    f"|E|={self.csr.num_edges}; float32 label/predecessor "
                    "exactness needs |V| < 2^24, int32 expansion needs "
                    "|E| < 2^30) — use frontier='auto' or 'off'"
                )
        launches0 = kernels.sorted_segment_sum.launches
        if use_frontier:
            out = self._run_frontier(program)
        else:
            out = self._run_host_loop(program, sync_every)
        self.last_run_info["kernel_launches"] = kernels.sorted_segment_sum.launches - launches0
        return out

    def _run_host_loop(self, program: VertexProgram, sync_every: int) -> Dict[str, np.ndarray]:
        t0 = time.perf_counter()
        memory = Memory()
        state, init_metrics = program.setup(self.g)
        device_memory = {k: v for k, (_op, v) in init_metrics.items()}
        steps_done = 0
        resolved = {}
        for step in range(program.max_iterations):
            op = program.combiner_for(step)
            outgoing = program.message(state, step, self.g)
            agg, resolved[op] = self._aggregate(program, op, outgoing)
            state, metrics = program.apply(state, agg, step, device_memory, self.g)
            # an aggregator a superstep does not emit keeps its last value
            device_memory.update({k: v for k, (_op, v) in metrics.items()})
            steps_done += 1
            if steps_done % sync_every and step != program.max_iterations - 1:
                continue
            # one device->host transfer per sync for all aggregators
            names = list(device_memory)
            host = torch.stack([
                torch.as_tensor(device_memory[k], dtype=torch.float32, device=self.device)
                for k in names
            ]).cpu().tolist() if names else []
            memory.values = dict(zip(names, host))
            memory.superstep = steps_done
            if program.terminate(memory):
                break
        out = {k: v.cpu().numpy() for k, v in state.items()}
        if not resolved:
            op = program.combiner_for(0)
            resolved[op] = self._resolve_strategy(op)
        self.last_run_info = {
            "path": "host-loop",
            "supersteps": steps_done,
            "wall_s": time.perf_counter() - t0,
            # the one strategy every superstep took, or, where the phases of
            # a program took different ones, {combiner: strategy}
            "strategy_resolved": (
                next(iter(resolved.values()))
                if len(set(resolved.values())) == 1 else resolved
            ),
        }
        return out
