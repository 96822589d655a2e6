"""GPU executor: BSP supersteps over a device-resident CSR — the port of
``janusgraph_tpu/olap/tpu_executor.py`` (single device).

Each superstep is message -> aggregate -> apply on the executor's device.

Strategies (``janusgraph_tpu_torch/olap/kernels.py``):
  - "segsum"  (default) the CUDA sorted-segment-sum kernel (the counterpart
              of the reference's "pallas") for scalar SUM; other monoids
              take "ell", as do ``[n, k]`` SUM messages (dense programs,
              sacks, PeerPressure's counts): the same bits on every call
  - "ell"     degree-bucketed ELLPACK gather + adjacent-pair tree, plain
              torch, every monoid
  - "hybrid"  exact-width ELL torso + chunked CSR tail for hubs, bitwise
              equal to "ell"
  - "segment" gather + index_add_/scatter_reduce_, plain torch (SUM
              through float atomics on the card: no fixed order)
  - "auto"    the autotuner (``olap/autotune.py``) picks ell, hybrid or
              segment from the degree histogram and the device's peaks; the
              decision is in ``last_run_info["autotune"]``

Paths of a run (``last_run_info["path"]``):
  - "frontier"  ShortestPath ("sssp") and, under ``frontier="always"``,
                ConnectedComponents ("cc") through ``olap/frontier.py``; the
                hops price on the autotuned tier ladders unless
                ``autotune=False``
  - "fused"     a program with a constant combiner and its own
                ``terminate_device`` (``fused_eligible``): the counterpart of
                the reference's ``lax.while_loop``. On the card it replays
                CUDA graphs of predicated supersteps (``_FusedLoop``) and
                fetches one (steps, stopped) pair per graph; on the CPU the
                same supersteps run eagerly
  - "host-loop" everything else (or ``fused=False``): reads
                ``program.combiner_for(step)`` and ``program.channel_for(step)``
                each superstep and fetches the aggregators every
                ``sync_every`` supersteps

Checkpoints (``checkpoint_path`` + ``checkpoint_every``) are written in the
reference's format (``olap/checkpoint.py``); a ``SuperstepPreempted`` raised
by ``fault_hook`` resumes from the last one, up to ``resume_attempts``
times, with the same bits as an uninterrupted run.

Delta overlay (``delta=`` or ``set_delta``, ``olap/delta.py``): supersteps
run over the base snapshot plus the writes pending against it. The base
aggregation runs over the base rows with any strategy, then the overlay's
lanes merge (``fused_delta_aggregate``); results cover the base vertices
plus the overlay's new ones.

Dense-feature programs (``olap/features``): ``[n, d]`` state aggregates
through the same strategies; ``message_mode == "sddmm"`` routes ELL, hybrid
and segsum/segment to the fused SDDMM aggregates; the program picks its
padded lane tier (``dim_tier=``).

Typed edge channels (``VertexProgram.edge_channels`` / ``channel_for``):
a superstep whose channel is named aggregates over that channel's edges
(``csr.channel_edges``) instead of the default view. Its structures, the
ELL pack and (for scalar SUM steps under "segsum") a segment-sum plan, are
cached per channel value in an LRU of ``CHANNEL_CACHE_SIZE`` entries
(``channel_cache_size=``, the ``computer.channel-cache-size`` option). A
scalar SUM step under "segsum" launches the kernel on the channel's plan;
every other step goes through the channel's ELL pack, as the reference's
channel steps always do. Channel programs run on the host loop.

Not ported yet (ROADMAP.md): telemetry spans.
"""

from __future__ import annotations

import gc
import time
import weakref
from collections import OrderedDict
from typing import Dict, Tuple

import numpy as np
import torch

from janusgraph_tpu_torch.device import resolve_device
from janusgraph_tpu_torch.exceptions import SuperstepPreempted
from janusgraph_tpu_torch.native import segment_ids
from janusgraph_tpu_torch.olap import autotune, kernels
from janusgraph_tpu_torch.olap.checkpoint import load_checkpoint, save_checkpoint
from janusgraph_tpu_torch.olap.csr import CSRGraph, channel_edges
from janusgraph_tpu_torch.olap.delta import (
    FusedHostView,
    OverlayView,
    fused_delta_aggregate,
    program_delta_compatible,
)
from janusgraph_tpu_torch.olap.features import kernels as fkernels
from janusgraph_tpu_torch.olap.frontier import FrontierEngine
from janusgraph_tpu_torch.olap.vertex_program import (
    Combiner,
    EdgeChannel,
    Memory,
    VertexProgram,
    apply_edge_transform,
    check_weighted_transforms,
)

STRATEGIES = ("segsum", "ell", "hybrid", "segment", "auto")
FRONTIER_MODES = ("auto", "off", "always")


class _DeviceGraph:
    """CSR arrays on the device + static metadata: the graph view programs
    read (num_vertices / local_num_vertices / out_degree / active / ...).

    Array fields are lazy: each moves to the device on first access and is
    cached, so a strategy that never reads an O(E) array never ships it.

    Over a delta overlay (``host_view``, a ``FusedHostView``) the counts and
    the ``_FUSED_FIELDS`` come from base + overlay, over the padded domain
    [0, local_num_vertices); the base index arrays are the ``base`` view's,
    moved once and shared across overlay swaps."""

    _LAZY = {
        "active": lambda csr, dev: torch.ones(csr.num_vertices, dtype=torch.float32, device=dev),
        "out_degree": lambda csr, dev: torch.as_tensor(csr.out_degree, dtype=torch.float32, device=dev),
        "in_degree": lambda csr, dev: torch.as_tensor(csr.in_degree, dtype=torch.float32, device=dev),
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

    #: fields a delta view takes from the fused host view (degrees and
    #: activity patched by the overlay)
    _FUSED_FIELDS = frozenset(("active", "out_degree", "in_degree"))

    def __init__(self, csr: CSRGraph, device: torch.device, host_view: FusedHostView = None,
                 base: "_DeviceGraph" = None):
        self._csr = csr
        self.device = device
        self._hv = host_view
        self._base = base
        if host_view is not None:
            self.num_vertices = host_view.num_vertices
            self.local_num_vertices = host_view.local_num_vertices
            self.num_edges = host_view.num_edges
        else:
            self.num_vertices = self.local_num_vertices = csr.num_vertices
            self.num_edges = csr.num_edges
        self.global_offset = 0

    def __getattr__(self, name):
        # only reached when `name` is not an instance attribute yet
        fn = _DeviceGraph._LAZY.get(name)
        if fn is None:
            raise AttributeError(name)
        if self._hv is not None and name in _DeviceGraph._FUSED_FIELDS:
            val = torch.as_tensor(
                np.asarray(getattr(self._hv, name), dtype=np.float32), device=self.device
            )
        elif self._base is not None:
            val = getattr(self._base, name)
        else:
            val = fn(self._csr, self.device)
        setattr(self, name, val)
        return val


class _ChannelPack:
    """One typed channel's aggregation structures on one device, each built
    from ``channel_edges`` on first use: the ELL pack, and the segment-sum
    plan with the channel's sources and weights in the plan's edge order.
    Dropping the object drops every tensor it moved."""

    def __init__(self, csr: CSRGraph, channel: EdgeChannel, device: torch.device):
        self.csr = csr
        self.channel = channel
        self.device = device
        self._ell = None
        self._segsum = None

    def ell(self) -> kernels.ELLPack:
        if self._ell is None:
            src, dst, w = channel_edges(self.csr, self.channel)
            self._ell = kernels.ELLPack(src, dst, w, self.csr.num_vertices).to(self.device)
        return self._ell

    def segsum(self):
        """(plan, source indices, weights or None), the last two on the
        device in the plan's edge order."""
        if self._segsum is None:
            src, dst, w = channel_edges(self.csr, self.channel)
            plan, src, w = kernels.edge_list_plan(src, dst, w, self.csr.num_vertices)
            plan.device_arrays(self.device)
            self._segsum = (
                plan, torch.as_tensor(src, device=self.device),
                torch.as_tensor(w, device=self.device) if w is not None else None,
            )
        return self._segsum


def _combine(op: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    if op == Combiner.SUM:
        return a + b
    if op == Combiner.MIN:
        return torch.minimum(a, b)
    return torch.maximum(a, b)


class _FusedLoop:
    """Static buffers and CUDA graphs of one fused program on one device.

    The buffers are the state dict, the aggregator dict (float32), the step
    counter ``steps``, its bound ``limit`` and ``status`` = (steps, stopped)
    as int64. ``step()`` is one predicated superstep, the reference's
    ``cond``/``loop`` pair: it runs when ``steps < limit`` and the program
    has not terminated (never checked before the first superstep), and
    otherwise leaves every buffer as it was. A chunk is ``length`` steps and
    then ``finish()``; on the card each chunk length of the ladder is
    captured once into a CUDA graph (all lengths share one memory pool) and
    replayed."""

    def __init__(self, executor: "GPUExecutor", program: VertexProgram, op: str,
                 state: Dict[str, torch.Tensor], mem: Dict[str, torch.Tensor]):
        dev = executor.device
        # a proxy, not a reference: the executor holds its loops, and a
        # cycle would leave a dropped executor's CUDA graphs to the cyclic
        # collector, which may free them while another graph is capturing
        self.ex = weakref.proxy(executor)
        self.program = program
        self.op = op
        self.state = {k: v.clone() for k, v in state.items()}
        self.mem = {k: v.clone() for k, v in mem.items()}
        self.steps = torch.zeros((), dtype=torch.int64, device=dev)
        self.limit = torch.zeros((), dtype=torch.int64, device=dev)
        self.status = torch.zeros(2, dtype=torch.int64, device=dev)
        #: aggregator -> its combiner monoid, learned from apply's metrics
        self.mem_ops: Dict[str, str] = {}
        #: chunk length -> (CUDA graph, kernel launches captured in it)
        self.graphs: Dict[int, Tuple[torch.cuda.CUDAGraph, int]] = {}
        #: the program objects the graphs were captured with: their device
        #: arrays (a GCN's weights) are read by every replay, so they must
        #: outlive the graphs
        self.captured_with = []
        self.pool = torch.cuda.graph_pool_handle() if dev.type == "cuda" else None

    def load(self, state, mem, steps_done: int, limit: int) -> bool:
        """Copy a run's starting point into the buffers; False where its
        shapes or keys differ from the buffers' (the loop is then rebuilt).
        Aggregators the run does not carry start at their monoid identity."""
        if set(state) != set(self.state) or not set(mem) <= set(self.mem):
            return False
        for k, buf in self.state.items():
            v = state[k]
            if v.shape != buf.shape or v.dtype != buf.dtype:
                return False
            buf.copy_(v)
        for k, buf in self.mem.items():
            if k in mem:
                buf.copy_(mem[k])
            else:
                buf.fill_(Combiner.IDENTITY[self.mem_ops[k]])
        self.steps.fill_(steps_done)
        self.limit.fill_(limit)
        return True

    def step(self, discover: bool = False) -> None:
        """One predicated superstep on the buffers. ``discover`` (eager
        only) adds a buffer, seeded with its monoid identity, for each
        aggregator apply emits that the buffers lack."""
        program, s = self.program, self.steps
        outgoing = program.message(self.state, s, self.ex.g)
        agg, _ = self.ex._aggregate(program, self.op, outgoing)
        new_state, metrics = program.apply(self.state, agg, s, self.mem, self.ex.g)
        if discover:
            for k, (o, v) in metrics.items():
                self.mem_ops[k] = o
                if k not in self.mem:
                    self.mem[k] = torch.full(
                        (), Combiner.IDENTITY[o], dtype=torch.float32, device=s.device
                    )
        # the predicate reads the buffers before this superstep's update
        run = (s < self.limit) & ((s == 0) | ~program.terminate_device(self.mem, s))
        updates = [(buf, torch.where(run, new_state[k], buf)) for k, buf in self.state.items()]
        updates += [
            (buf, torch.where(run, metrics[k][1].to(torch.float32), buf))
            for k, buf in self.mem.items() if k in metrics
        ]
        for buf, new in updates:
            buf.copy_(new)
        s.add_(run.to(s.dtype))

    def finish(self) -> None:
        """status = (steps, whether the program has terminated)."""
        s = self.steps
        stopped = (s > 0) & self.program.terminate_device(self.mem, s)
        self.status.copy_(torch.stack([s, stopped.to(torch.int64)]))

    def chunk(self, length: int, top: int) -> Tuple[float, int]:
        """Run one chunk of ``length`` steps; returns the seconds spent
        capturing and the segment-sum calls the replayed graph holds. The
        first chunk on the card captures every length of the ladder up to
        ``top`` at once, so later runs replay only."""
        if self.pool is None:
            for _ in range(length):
                self.step()
            self.finish()
            return 0.0, 0
        capture_s = 0.0
        if length not in self.graphs:
            t0 = time.perf_counter()
            size = 1
            while size <= max(top, length):
                if size not in self.graphs:
                    self.graphs[size] = self._capture(size)
                size *= 2
            capture_s = time.perf_counter() - t0
        graph, captured = self.graphs[length]
        graph.replay()
        return capture_s, captured

    def _capture(self, length: int) -> Tuple[torch.cuda.CUDAGraph, int]:
        """Capture ``length`` steps and the status into a CUDA graph, with
        any hidden host sync raising (nothing runs while capturing). The
        cyclic collector is off meanwhile: freeing another graph during a
        capture (one of a dropped object held in a reference cycle)
        invalidates the capture."""
        graph = torch.cuda.CUDAGraph()
        if not any(p is self.program for p in self.captured_with):
            self.captured_with.append(self.program)
        captured0 = kernels.sorted_segment_sum.captured
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph, pool=self.pool):
                mode = torch.cuda.get_sync_debug_mode()
                torch.cuda.set_sync_debug_mode("error")
                try:
                    for _ in range(length):
                        self.step()
                    self.finish()
                finally:
                    torch.cuda.set_sync_debug_mode(mode)
        finally:
            if collecting:
                gc.enable()
        return graph, kernels.sorted_segment_sum.captured - captured0


class GPUExecutor:
    """Single-device executor on a torch device (the card by default).

    ``autotune`` (default on) gives "auto" its decision and the frontier
    engine its tuned ladders; "auto" needs it. ``hub_cutoff``/``tail_chunk``
    fix the hybrid layout; ``autotune_persist`` (default on) keeps the last
    run's measured record beside the checkpoint file and feeds it to the
    next executor's decision. ``delta`` is an
    ``OverlayView`` of ``csr`` whose pending writes every run consumes
    (``set_delta`` swaps it)."""

    #: the longest fused chunk (CUDA graph) in supersteps; chunk lengths are
    #: the powers of two up to it, so a run that stops early computes at most
    #: MAX_CHUNK - 1 supersteps it throws away
    MAX_CHUNK = 8
    #: distinct EdgeChannel views kept on the device at once; a long-lived
    #: executor answering ad-hoc traversals would otherwise keep one O(E)
    #: pack per label set forever
    CHANNEL_CACHE_SIZE = 8

    def __init__(
        self,
        csr: CSRGraph,
        strategy: str = "segsum",
        device=None,
        frontier: str = "auto",
        autotune: bool = None,
        hub_cutoff: int = None,
        tail_chunk: int = None,
        autotune_persist: bool = None,
        delta: OverlayView = None,
        channel_cache_size: int = None,
    ):
        if strategy not in STRATEGIES:
            raise ValueError(f"unknown aggregation strategy: {strategy!r}")
        if frontier not in FRONTIER_MODES:
            raise ValueError(f"unknown frontier mode: {frontier!r}")
        self._autotune_enabled = True if autotune is None else bool(autotune)
        if strategy == "auto" and not self._autotune_enabled:
            raise ValueError(
                "strategy='auto' is the tuner's choice; with autotune=False "
                "name a strategy ('segsum', 'ell', 'hybrid' or 'segment')"
            )
        self.device = resolve_device(device)
        self.csr = csr
        self._strategy_cfg = strategy
        #: the overlay-free view, kept across overlay swaps so its arrays
        #: move to the device once
        self._base_g = _DeviceGraph(csr, self.device)
        self.g = self._base_g
        self._delta = None
        #: the padded feature dim of the current run (0: scalar program)
        self._feature_dim_run = 0
        self._hub_cutoff_cfg = hub_cutoff or None
        self._tail_chunk_cfg = tail_chunk or None
        self._autotune_persist = True if autotune_persist is None else bool(autotune_persist)
        self._measured_path = None
        #: decisions keyed (undirected, padded feature dim; 0 for scalar
        #: programs)
        self._autotune_decisions: Dict[Tuple, autotune.AutotuneDecision] = {}
        self._ell_packs: Dict[bool, kernels.ELLPack] = {}
        self._hybrid_packs: Dict[bool, kernels.HybridPack] = {}
        self._segsum_plans: Dict[str, kernels._SegSumPlan] = {}
        #: EdgeChannel value -> its _ChannelPack, least recently used first
        self._channel_packs: "OrderedDict[EdgeChannel, _ChannelPack]" = OrderedDict()
        if channel_cache_size is not None:
            if channel_cache_size < 1:
                raise ValueError("channel_cache_size must be positive")
            self.CHANNEL_CACHE_SIZE = int(channel_cache_size)
        #: (strategy, undirected) -> the sddmm row destinations on the device
        self._sddmm_rows_cache: Dict[Tuple, object] = {}
        #: keyed (program.cache_key(), monoid, strategy, the overlay's lane
        #: signature or None)
        self._fused_loops: Dict[Tuple, _FusedLoop] = {}
        self._frontier_cfg = frontier
        self._frontier_engine = None
        #: per-run record: path, supersteps, wall_s (the path's own clock),
        #: run_wall_s (all of run(), routing and resumes included),
        #: kernel_launches (eager segment-sum launches), strategy_resolved,
        #: pad_ratio/ell_pad_ratio, autotune; the host loop adds
        #: superstep_records (step, wall_ms, combiner, channel, strategy);
        #: the fused path adds chunks,
        #: host_syncs, predicated_steps, capture_s and graph_kernel_launches
        #: (segment-sum calls in the replayed graphs); the frontier path its
        #: per-hop ``tiers`` and ``hop_wall_s``; a resumed run resumes and
        #: resume_steps
        self.last_run_info: Dict[str, object] = {}
        #: the superstep fault_hook was last called at, and one record per
        #: resume of the current run
        self._hook_step = None
        self._resume_log = []
        self.set_delta(delta)

    # ----------------------------------------------------------------- delta
    def set_delta(self, delta: OverlayView) -> None:
        """Swap the pending-overlay view without rebuilding the executor:
        the base arrays, packs, plans, tuner decisions and frontier engine
        stay. ``None`` (or an empty view) returns to the base snapshot. The
        fused loops captured over the previous view bake its lane tensors'
        addresses, so they are dropped; the next run recaptures."""
        delta = delta if (delta is not None and delta.depth) else None
        if delta is not None:
            if self.csr.in_edge_weight is not None:
                raise ValueError(
                    "delta-fused runs support unfiltered weightless "
                    "snapshots only (the change capture carries no weight "
                    "column)"
                )
            if delta.csr is not self.csr:
                raise ValueError(
                    "overlay view was built over a different base snapshot "
                    "— an executor only serves overlays of its own base CSR"
                )
        if delta is self._delta:
            return
        self._delta = delta
        self.g = self._base_g if delta is None else _DeviceGraph(
            self.csr, self.device, host_view=FusedHostView(delta), base=self._base_g,
        )
        self._fused_loops = {k: lp for k, lp in self._fused_loops.items() if k[-1] is None}

    def _delta_sig(self, program: VertexProgram):
        """The overlay's lane signature for the program's edge view (part
        of the fused loops' keys), or None without an overlay. Raises where
        the lanes exceed the view's ``max_lane_cells``."""
        if self._delta is None:
            return None
        sig = self._delta.sig(bool(program.undirected))
        if sig is None:
            raise ValueError(
                "delta overlay lanes exceed max_lane_cells — materialize "
                "the overlay instead of consuming it fused"
            )
        return sig

    # -------------------------------------------------------------- autotune
    def _device_kind(self) -> str:
        if self.device.type == "cuda":
            return torch.cuda.get_device_name(self.device)
        return "cpu"

    def _autotune(self, undirected: bool) -> autotune.AutotuneDecision:
        """The cached decision for one edge view: ``autotune.decide`` over
        the view's degree statistics, this device's kind, the configured
        hybrid layout and the persisted measured record, if any."""
        key = (undirected, self._feature_dim_run)
        decision = self._autotune_decisions.get(key)
        if decision is not None:
            return decision
        measured = None
        if self._measured_path:
            measured = autotune.load_measured(self._measured_path, shard_count=1)
        stats = autotune.GraphStats.from_csr(
            self.csr, undirected=undirected, tail_chunk=self._tail_chunk_cfg or 256,
        )
        ov = {"hub_cutoff": self._hub_cutoff_cfg, "tail_chunk": self._tail_chunk_cfg}
        if self._strategy_cfg != "auto":
            ov["strategy"] = self._strategy_cfg
        decision = autotune.decide(
            stats, self._device_kind(), overrides=ov, measured=measured,
            feature_dim=self._feature_dim_run,
        )
        self._autotune_decisions[key] = decision
        return decision

    @property
    def strategy(self) -> str:
        """The configured strategy; "auto" reports its directed-view
        resolution."""
        return self._base_strategy(False)

    def _base_strategy(self, undirected: bool) -> str:
        base = self._strategy_cfg
        if base == "auto":
            base = self._autotune(undirected).strategy
        return base

    # ------------------------------------------------------------ structures
    def _resolve_strategy(self, op: str, undirected: bool = False) -> str:
        """The strategy a combiner monoid and edge view take: the segsum
        kernel is SUM-only and sums scalars only, so other monoids and a
        dense program's [n, d] rows take ELL: the same bits on every call,
        where "segment" (float atomics on the card) would not give them."""
        base = self._base_strategy(undirected)
        if base == "segsum" and (op != Combiner.SUM or self._feature_dim_run):
            return "ell"
        return base

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
            pack = kernels.ELLPack(
                src, dst, w, self.csr.num_vertices
            ).to(self.device)
            self._ell_packs[undirected] = pack
        return pack

    def _hybrid_pack(self, undirected: bool) -> kernels.HybridPack:
        """The view's HybridPack, with the configured or the tuner's hub
        cutoff and tail chunk; built and moved once."""
        pack = self._hybrid_packs.get(undirected)
        if pack is None:
            d = self._autotune(undirected)
            cutoff = self._hub_cutoff_cfg or d.hub_cutoff or 512
            chunk = self._tail_chunk_cfg or d.tail_chunk or 256
            src, dst, w = self._edge_view(undirected)
            pack = kernels.HybridPack(
                src, dst, w, self.csr.num_vertices,
                hub_cutoff=cutoff, tail_chunk=chunk,
            ).to(self.device)
            self._hybrid_packs[undirected] = pack
        return pack

    def _sddmm_rows(self, strategy: str, undirected: bool):
        """Row-destination vectors of the fused SDDMM pass, aligned with the
        strategy's pack layout; built and moved once per (strategy, view)."""
        key = (strategy, undirected)
        rows = self._sddmm_rows_cache.get(key)
        if rows is None:
            src, dst, _w = self._edge_view(undirected)
            n = self.csr.num_vertices

            def put(arrs):
                return [torch.as_tensor(a, device=self.device) for a in arrs]

            if strategy == "ell":
                rows = put(fkernels.ell_row_dsts(src, dst, n))
            else:
                pack = self._hybrid_pack(undirected)
                host = fkernels.hybrid_row_dsts(
                    src, dst, n, hub_cutoff=pack.hub_cutoff, tail_chunk=pack.tail_chunk,
                )
                rows = {k: put(v) for k, v in host.items()}
            self._sddmm_rows_cache[key] = rows
        return rows

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

    def _channel_pack(self, program: VertexProgram, name: str) -> _ChannelPack:
        """The structures of one named channel, cached per channel VALUE
        (a frozen dataclass): names like "s0" recur across programs on a
        reused executor and must not alias each other's packs. LRU-bounded
        by ``CHANNEL_CACHE_SIZE``; eviction drops the pack and its plan
        together."""
        channel = program.edge_channels[name]
        entry = self._channel_packs.get(channel)
        if entry is not None:
            self._channel_packs.move_to_end(channel)
            return entry
        entry = _ChannelPack(self.csr, channel, self.device)
        self._channel_packs[channel] = entry
        while len(self._channel_packs) > self.CHANNEL_CACHE_SIZE:
            self._channel_packs.popitem(last=False)
        return entry

    def prewarm(self, program: VertexProgram) -> None:
        """Build and move the aggregation structures a program will use, so
        their cost is paid before the first run."""
        strategy = self._resolve_strategy(program.combiner, program.undirected)
        if strategy == "ell":
            self._ell_pack(program.undirected)
        elif strategy == "hybrid":
            self._hybrid_pack(program.undirected)
        elif strategy == "segsum":
            for orientation in ("in", "out") if program.undirected else ("in",):
                self._segsum_plan(orientation).device_arrays(self.device)

    # ------------------------------------------------------------ superstep
    def _aggregate(self, program: VertexProgram, op: str, outgoing: torch.Tensor,
                   channel: str = None):
        """(aggregated messages, the strategy that computed them), over the
        named edge channel or the program's default view. Over an overlay,
        the base aggregation reads the base rows' messages (the packs'
        sentinel stays the identity), then the lanes merge."""
        if channel is not None:
            return self._channel_aggregate(program, op, outgoing, channel)
        if self._delta is None:
            return self._base_aggregate(program, op, outgoing)
        lanes = self._delta.device_args(self.device, bool(program.undirected))
        agg, strategy = self._base_aggregate(program, op, outgoing[: self.csr.num_vertices])
        return fused_delta_aggregate(lanes, outgoing, agg, op), strategy

    def _channel_aggregate(self, program: VertexProgram, op: str, outgoing: torch.Tensor,
                           name: str):
        """One superstep over a typed channel: a scalar SUM under "segsum"
        through the kernel on the channel's plan; everything else through
        the channel's ELL pack."""
        entry = self._channel_pack(program, name)
        if self._strategy_cfg == "segsum" and op == Combiner.SUM and outgoing.ndim == 1:
            plan, src_idx, weight = entry.segsum()
            msgs = apply_edge_transform(
                torch.index_select(outgoing, 0, src_idx), weight, program.edge_transform
            )
            return kernels.sorted_segment_sum(msgs, plan), "segsum"
        return kernels.ell_aggregate(
            entry.ell(), outgoing, op, program.edge_transform, program.edge_transform_cols
        ), "ell"

    def _base_aggregate(self, program: VertexProgram, op: str, outgoing: torch.Tensor):
        g = self.g
        n = self.csr.num_vertices
        strategy = self._resolve_strategy(op, program.undirected)
        if strategy == "segsum" and outgoing.ndim > 1:
            strategy = "ell"  # the kernel sums scalars only
        cols = program.edge_transform_cols
        if getattr(program, "message_mode", None) == "sddmm":
            # dense tier: per-edge dot-attention coefficients in the gather
            if strategy == "ell":
                return fkernels.sddmm_ell_aggregate(
                    self._ell_pack(False), self._sddmm_rows("ell", False), outgoing, op
                ), strategy
            if strategy == "hybrid":
                return fkernels.sddmm_hybrid_aggregate(
                    self._hybrid_pack(False), self._sddmm_rows("hybrid", False), outgoing, op
                ), strategy
            return fkernels.sddmm_segment_aggregate(
                outgoing, g.in_src, g.in_dst_seg, n
            ), "segment"
        if strategy == "ell":
            return kernels.ell_aggregate(
                self._ell_pack(program.undirected), outgoing, op, program.edge_transform, cols
            ), strategy
        if strategy == "hybrid":
            return kernels.hybrid_aggregate(
                self._hybrid_pack(program.undirected), outgoing, op, program.edge_transform, cols
            ), strategy
        views = [("in", g.in_src, g.in_edge_weight)]
        if program.undirected:
            views.append(("out", g.out_dst, g.out_edge_weight))
        total = None
        for orientation, src_idx, weight in views:
            msgs = apply_edge_transform(
                torch.index_select(outgoing, 0, src_idx), weight, program.edge_transform, cols
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
        """The executor's frontier engine, built on first use; with the
        tuner on, it takes the directed view's tier ladders."""
        if self._frontier_engine is None:
            f_schedule = e_schedule = None  # the static ladder
            if self._autotune_enabled:
                decision = self._autotune(False)
                f_schedule, e_schedule = decision.f_schedule, decision.e_schedule
            self._frontier_engine = FrontierEngine(self, f_schedule, e_schedule)
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
        self,
        program: VertexProgram,
        sync_every: int = 1,
        fused: bool = None,
        checkpoint_path: str = None,
        checkpoint_every: int = 0,
        resume: bool = False,
        frontier: str = None,
        fault_hook=None,
        resume_attempts: int = 3,
    ) -> Dict[str, np.ndarray]:
        """Run to termination; returns the final state as numpy arrays.

        ``frontier`` (default: the executor's mode) overrides the frontier
        routing for this run: "auto" takes it for BFS/SSSP, "always" for
        CC too (and raises where the graph is outside the engine's guards,
        or with checkpointing), "off" runs dense.

        ``fused`` (default: ``program.fused_eligible()``) fuses the run on
        the device; ``fused=False`` forces the host loop, which fetches the
        aggregators every ``sync_every`` supersteps (and after the last) and
        reads ``program.terminate`` only there, never before the first
        superstep.

        ``checkpoint_path`` + ``checkpoint_every=N`` save (state,
        aggregators, steps) every N supersteps; ``resume=True`` starts from
        the checkpoint if there is one. ``fault_hook(step)`` is called at
        each superstep (host loop) or each checkpoint span (fused) and may
        raise ``SuperstepPreempted``: with checkpointing on, the run then
        resumes from the last checkpoint, up to ``resume_attempts`` times."""
        check_weighted_transforms(program, self.csr)
        self._prepare_dense(program)
        if frontier not in (None,) + FRONTIER_MODES:
            raise ValueError(f"unknown frontier mode: {frontier!r}")
        if self._delta is not None:
            if not program_delta_compatible(program):
                raise ValueError(
                    "delta-fused runs support default-edge-view programs "
                    "only (typed edge channels aggregate over their own "
                    "packs and sddmm row destinations are base-layout) — "
                    "materialize the overlay for this program"
                )
            self._delta_sig(program)
            # the frontier engine walks the base adjacency; over an overlay
            # the dense path is the right one
            frontier = "off"
        if sync_every < 1:
            raise ValueError(f"sync_every must be >= 1, got {sync_every}")
        self._measured_path = (
            checkpoint_path + ".autotune.json"
            if checkpoint_path and self._autotune_persist else None
        )
        mode = frontier or self._frontier_cfg
        use_frontier = False
        if mode != "off" and self._frontier_family(program):
            if checkpoint_path:
                # the frontier loop does not checkpoint; "always" must not
                # quietly run dense under a frontier label
                if mode == "always":
                    raise ValueError(
                        "frontier='always' cannot be combined with "
                        "checkpointing (the frontier loop does not "
                        "checkpoint) — drop checkpoint_path or use "
                        "frontier='auto'"
                    )
            elif self._frontier_eligible(program, mode):
                use_frontier = True
            elif mode == "always":
                raise ValueError(
                    "frontier='always' but the graph exceeds the frontier "
                    f"engine's guards (|V|={self.csr.num_vertices}, "
                    f"|E|={self.csr.num_edges}; float32 label/predecessor "
                    "exactness needs |V| < 2^24, int32 expansion needs "
                    "|E| < 2^30) — use frontier='auto' or 'off'"
                )
        if fused is None:
            fused = program.fused_eligible()
        use_fused = (
            not use_frontier and fused
            and type(program).combiner_for is VertexProgram.combiner_for
            and type(program).channel_for is VertexProgram.channel_for
        )
        launches0 = kernels.sorted_segment_sum.launches
        t0 = time.perf_counter()
        resumes = 0
        self._resume_log = resume_steps = []
        while True:
            try:
                if use_frontier:
                    out = self._run_frontier(program)
                elif use_fused:
                    out = self._run_fused(
                        program, checkpoint_path, checkpoint_every, resume, fault_hook
                    )
                else:
                    out = self._run_host_loop(
                        program, sync_every, checkpoint_path, checkpoint_every,
                        resume, fault_hook,
                    )
                break
            except SuperstepPreempted:
                if not (checkpoint_path and checkpoint_every) or resumes >= resume_attempts:
                    raise
                # replay from the last checkpoint: its arrays are exact, so
                # the final state is the uninterrupted run's
                resumes += 1
                resume = True
                # from_step is filled in when the next attempt loads
                resume_steps.append({
                    "attempt": resumes, "at_s": round(time.perf_counter() - t0, 4),
                    "preempted_at": self._hook_step,
                })
        info = self.last_run_info
        if self._delta is not None:
            # trim the vcap padding: the real rows are the base snapshot's
            # and the overlay's new vertices (removed slots stay, inert;
            # compact_result drops them)
            out = {k: v[: self._delta.n_real] for k, v in out.items()}
            info["delta"] = {
                "overlay_depth": self._delta.depth,
                "n_extra": self._delta.n_extra,
                "removed": int(len(self._delta.removed_idx)),
                "fused": True,
            }
        info["run_wall_s"] = time.perf_counter() - t0
        info["kernel_launches"] = kernels.sorted_segment_sum.launches - launches0
        if resumes:
            info["resumes"] = resumes
            info["resume_steps"] = resume_steps
        self._finish_run(program)
        return out

    def _prepare_dense(self, program: VertexProgram) -> None:
        """The dense tier's run set-up: the tuner's feature-dim input and
        the sddmm mode's envelope."""
        self._feature_dim_run = int(getattr(program, "d_pad", 0) or 0)
        if getattr(program, "message_mode", None) == "sddmm":
            if program.undirected:
                raise ValueError(
                    "sddmm message mode aggregates over the in-CSR only — "
                    "undirected dense programs are not supported"
                )
            if type(program).channel_for is not VertexProgram.channel_for:
                raise ValueError("sddmm message mode cannot ride typed edge channels")

    def _call_hook(self, fault_hook, step: int) -> None:
        if fault_hook is not None:
            self._hook_step = step
            fault_hook(step)

    def _note_resume(self, step: int) -> None:
        """An attempt starts at ``step`` (its checkpoint's, or 0 where
        there was none yet): after a preemption, the step it resumed from."""
        if self._resume_log and "from_step" not in self._resume_log[-1]:
            self._resume_log[-1]["from_step"] = step

    def _finish_run(self, program: VertexProgram) -> None:
        """Add the pad ratio of the pack the run aggregated over and the
        tuner's decision to ``last_run_info``; persist the measured record
        beside the checkpoint file."""
        info = self.last_run_info
        undirected = bool(program.undirected)
        resolved = info.get("strategy_resolved")
        used = set(resolved.values()) if isinstance(resolved, dict) else {resolved}
        pack = None
        if "hybrid" in used:
            pack = self._hybrid_packs.get(undirected)
        elif "ell" in used:
            pack = self._ell_packs.get(undirected)
        pad_ratio = round(pack.pad_ratio, 4) if pack is not None else None
        info["pad_ratio"] = pad_ratio
        info["ell_pad_ratio"] = pad_ratio  # the reference's older key
        if self._autotune_enabled or (undirected, self._feature_dim_run) in self._autotune_decisions:
            info["autotune"] = self._autotune(undirected).as_dict()
        if self._measured_path and pad_ratio is not None and info.get("supersteps"):
            autotune.save_measured(self._measured_path, {
                "strategy": resolved if isinstance(resolved, str) else None,
                "pad_ratio": pad_ratio,
                "superstep_ms": info["wall_s"] * 1e3 / info["supersteps"],
                # per-tier roofline utilization comes with the profiler port
                "roofline_by_tier": None,
            }, shard_count=1)

    def _run_host_loop(
        self,
        program: VertexProgram,
        sync_every: int,
        checkpoint_path: str = None,
        checkpoint_every: int = 0,
        resume: bool = False,
        fault_hook=None,
    ) -> Dict[str, np.ndarray]:
        t0 = time.perf_counter()
        memory = Memory()
        state = None
        start = 0
        if resume and checkpoint_path:
            ck = load_checkpoint(checkpoint_path)
            if ck is not None:
                ck_state, ck_mem, start = ck
                state = {k: torch.as_tensor(v, device=self.device) for k, v in ck_state.items()}
                memory.values = {k: float(v) for k, v in ck_mem.items()}
                memory.superstep = start
                device_memory = {
                    k: torch.tensor(v, dtype=torch.float32, device=self.device)
                    for k, v in memory.values.items()
                }
        if state is None:
            state, init_metrics = program.setup(self.g)
            device_memory = {k: v for k, (_op, v) in init_metrics.items()}
        self._note_resume(start)
        steps_done = start
        resolved = {}
        records = []
        last_step = program.max_iterations - 1
        for step in range(start, program.max_iterations):
            self._call_hook(fault_hook, step)
            s0 = time.perf_counter()
            op = program.combiner_for(step)
            ch = program.channel_for(step)
            outgoing = program.message(state, step, self.g)
            agg, strategy = self._aggregate(program, op, outgoing, ch)
            resolved[op if ch is None else f"{op}:{ch}"] = strategy
            state, metrics = program.apply(state, agg, step, device_memory, self.g)
            # host clock of the enqueue (of the whole step where it syncs)
            records.append({"step": step, "wall_ms": (time.perf_counter() - s0) * 1e3,
                            "combiner": op, "channel": ch, "strategy": strategy})
            # an aggregator a superstep does not emit keeps its last value
            device_memory.update({k: v for k, (_op, v) in metrics.items()})
            steps_done += 1
            if steps_done % sync_every and step != last_step:
                continue
            # one device->host transfer per sync for all aggregators
            names = list(device_memory)
            host = torch.stack([
                torch.as_tensor(device_memory[k], dtype=torch.float32, device=self.device)
                for k in names
            ]).cpu().tolist() if names else []
            memory.values = dict(zip(names, host))
            memory.superstep = steps_done
            if checkpoint_path and checkpoint_every and (
                steps_done % checkpoint_every == 0 or step == last_step
            ):
                save_checkpoint(
                    checkpoint_path, {k: v.cpu().numpy() for k, v in state.items()},
                    memory.values, steps_done,
                )
            if program.terminate(memory):
                break
        out = {k: v.cpu().numpy() for k, v in state.items()}
        if not resolved:
            op = program.combiner_for(0)
            resolved[op] = self._resolve_strategy(op, program.undirected)
        self.last_run_info = {
            "path": "host-loop",
            "supersteps": steps_done,
            "wall_s": time.perf_counter() - t0,
            # the one strategy every superstep took, or, where the phases of
            # a program took different ones, {combiner: strategy}, a channel
            # step keyed "combiner:channel"
            "strategy_resolved": (
                next(iter(resolved.values()))
                if len(set(resolved.values())) == 1 else resolved
            ),
            "superstep_records": records,
        }
        return out

    # ------------------------------------------------------------------ fused
    def _fused_loop(self, program, op, state, mem, steps_done, limit) -> Tuple[_FusedLoop, bool]:
        """The cached loop of (program, monoid, strategy) loaded with this
        run's starting point, or a new one: (loop, whether it is new)."""
        key = (program.cache_key(), op, self._resolve_strategy(op, program.undirected),
               self._delta_sig(program))
        loop = self._fused_loops.get(key)
        if loop is not None and loop.load(state, mem, steps_done, limit):
            loop.program = program
            return loop, False
        loop = _FusedLoop(self, program, op, state, mem)
        loop.steps.fill_(steps_done)
        loop.limit.fill_(limit)
        self._fused_loops[key] = loop
        return loop, True

    def _run_fused(
        self,
        program: VertexProgram,
        checkpoint_path: str,
        checkpoint_every: int,
        resume: bool,
        fault_hook=None,
    ) -> Dict[str, np.ndarray]:
        """The reference's fused ``lax.while_loop`` as chunks of predicated
        supersteps. A new loop runs its first superstep eagerly, which moves
        every lazy device array, pack and plan to the device and learns the
        aggregators apply emits; then each chunk is the longest power of two
        (up to MAX_CHUNK) that fits the remaining bound, captured once as a
        CUDA graph on the card and replayed, followed by one fetch of
        (steps, stopped). The bound is max_iterations, or the next
        checkpoint, where the host saves and consults ``fault_hook``."""
        t0 = time.perf_counter()
        op = program.combiner
        max_iter = program.max_iterations
        dev = self.device
        state = mem = None
        steps_done = 0
        if resume and checkpoint_path:
            ck = load_checkpoint(checkpoint_path)
            if ck is not None:
                ck_state, ck_mem, steps_done = ck
                state = {k: torch.as_tensor(v, device=dev) for k, v in ck_state.items()}
                mem = {k: torch.as_tensor(v, dtype=torch.float32, device=dev) for k, v in ck_mem.items()}
        if state is None:
            state, init_metrics = program.setup(self.g)
            mem = {
                k: torch.as_tensor(v, dtype=torch.float32, device=dev)
                for k, (_op, v) in init_metrics.items()
            }
        self._note_resume(steps_done)
        info = {
            "path": "fused", "supersteps": steps_done, "chunks": 0, "host_syncs": 0,
            "predicated_steps": 0, "capture_s": 0.0, "graph_kernel_launches": 0,
            "strategy_resolved": self._resolve_strategy(op, program.undirected),
        }
        # the longest chunk this program can use
        top = 1 << (min(max(max_iter, 1), self.MAX_CHUNK).bit_length() - 1)
        loop = None
        while steps_done < max_iter:
            self._call_hook(fault_hook, steps_done)
            limit = max_iter
            if checkpoint_every:
                limit = min(steps_done + checkpoint_every, max_iter)
            if loop is None:
                loop, new = self._fused_loop(program, op, state, mem, steps_done, limit)
                expected = steps_done
                if new:
                    loop.step(discover=True)
                    expected += 1
            else:
                loop.limit.fill_(limit)
                expected = steps_done
            stopped = False
            while expected < limit:
                length = 1 << (min(limit - expected, self.MAX_CHUNK).bit_length() - 1)
                capture_s, captured = loop.chunk(length, top)
                info["capture_s"] += capture_s
                info["graph_kernel_launches"] += captured
                info["chunks"] += 1
                new_steps, stopped = loop.status.tolist()
                info["host_syncs"] += 1
                info["predicated_steps"] += expected + length - new_steps
                steps_done = expected = new_steps
                if stopped:
                    # terminated; any superstep of the chunk after that
                    # point was computed and discarded
                    break
            if expected > steps_done:
                # the eager first superstep was the whole span
                loop.finish()
                new_steps, stopped = loop.status.tolist()
                info["host_syncs"] += 1
                info["predicated_steps"] += expected - new_steps
                steps_done = new_steps
            if checkpoint_path and checkpoint_every:
                save_checkpoint(
                    checkpoint_path,
                    {k: v.cpu().numpy() for k, v in loop.state.items()},
                    {k: v.cpu().numpy() for k, v in loop.mem.items()},
                    steps_done,
                )
                info["host_syncs"] += 1
            if stopped or steps_done < limit:
                break
        final = loop.state if loop is not None else state
        # a copy on every device: the loop's buffers serve the next run
        out = {k: v.to("cpu", copy=True).numpy() for k, v in final.items()}
        info["host_syncs"] += 1
        info["supersteps"] = steps_done
        info["wall_s"] = time.perf_counter() - t0
        self.last_run_info = info
        return out
