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

Not ported yet (ROADMAP.md): the fused on-device loop, checkpoints, the
delta overlay, autotune ("auto"/"hybrid"), the frontier engine, typed edge
channels, the sddmm mode and telemetry spans.
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
from janusgraph_tpu_torch.olap.vertex_program import (
    Combiner,
    Memory,
    VertexProgram,
    apply_edge_transform,
    check_weighted_transforms,
)

STRATEGIES = ("segsum", "ell", "segment")


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

    def __init__(self, csr: CSRGraph, strategy: str = "segsum", device=None):
        if strategy not in STRATEGIES:
            raise ValueError(f"unknown aggregation strategy: {strategy!r}")
        self.device = resolve_device(device)
        self.csr = csr
        self.strategy = strategy
        self.g = _DeviceGraph(csr, self.device)
        self._ell_packs: Dict[bool, kernels.ELLPack] = {}
        self._segsum_plans: Dict[str, kernels._SegSumPlan] = {}
        #: per-run record: path, supersteps, wall_s, strategy_resolved,
        #: kernel_launches
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
    def _aggregate(self, program: VertexProgram, op: str, outgoing: torch.Tensor) -> torch.Tensor:
        g = self.g
        n = g.num_vertices
        strategy = self._resolve_strategy(op)
        if strategy == "ell":
            return kernels.ell_aggregate(
                self._ell_pack(program.undirected), outgoing, op, program.edge_transform
            )
        views = [("in", g.in_src, g.in_edge_weight)]
        if program.undirected:
            views.append(("out", g.out_dst, g.out_edge_weight))
        total = None
        for orientation, src_idx, weight in views:
            msgs = apply_edge_transform(
                torch.index_select(outgoing, 0, src_idx), weight, program.edge_transform
            )
            if strategy == "segsum" and outgoing.ndim == 1:
                part = kernels.sorted_segment_sum(msgs, self._segsum_plan(orientation))
            else:
                seg = g.in_dst_seg if orientation == "in" else g.out_src_seg
                part = kernels.segment_combine(op, msgs, seg, n)
            total = part if total is None else _combine(op, total, part)
        return total

    def _superstep(self, program, state, step, memory_in):
        op = program.combiner
        outgoing = program.message(state, step, self.g)
        agg = self._aggregate(program, op, outgoing)
        return program.apply(state, agg, step, memory_in, self.g)

    # ------------------------------------------------------------------ run
    def run(self, program: VertexProgram) -> Dict[str, np.ndarray]:
        """Run to termination; returns the final state as numpy arrays.

        ``program.terminate`` is consulted after each superstep, never
        before the first: before it the aggregators are identity-seeded
        placeholders (Fulgora semantics)."""
        check_weighted_transforms(program, self.csr)
        launches0 = kernels.sorted_segment_sum.launches
        t0 = time.perf_counter()
        memory = Memory()
        state, init_metrics = program.setup(self.g)
        device_memory = {k: v for k, (_op, v) in init_metrics.items()}
        steps_done = 0
        for step in range(program.max_iterations):
            state, metrics = self._superstep(program, state, step, device_memory)
            # an aggregator a superstep does not emit keeps its last value
            device_memory.update({k: v for k, (_op, v) in metrics.items()})
            steps_done += 1
            # one device->host transfer per barrier for all aggregators
            names = list(device_memory)
            host = torch.stack(
                [torch.as_tensor(device_memory[k], dtype=torch.float32) for k in names]
            ).cpu().tolist() if names else []
            memory.values = dict(zip(names, host))
            memory.superstep = steps_done
            if program.terminate(memory):
                break
        out = {k: v.cpu().numpy() for k, v in state.items()}
        self.last_run_info = {
            "supersteps": steps_done,
            "wall_s": time.perf_counter() - t0,
            "strategy_resolved": self._resolve_strategy(program.combiner),
            "kernel_launches": kernels.sorted_segment_sum.launches - launches0,
        }
        return out
