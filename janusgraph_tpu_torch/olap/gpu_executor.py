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

Telemetry: every run opens an ``olap.run`` span and publishes its record
(``last_run_info``) to the process registry (``registry.last_run("olap")``,
``observability/``), as the reference's ``_finish_run`` does: per-superstep
records with flops, bytes, operational intensity and roofline utilization,
``roofline_by_tier``, ``mxu`` for dense programs, ``resources``,
``compile_cache``, ``device_memory``, ``slowest_superstep``, one
``superstep`` child span per record (at most 128), and the ``olap.*``
gauges, counters, timer and histogram. On the card each record's wall is
taken by CUDA events recorded around the superstep's launches (host loop)
or around each chunk's replay (fused), read after the run's final fetch;
nothing is recorded while a CUDA graph is being captured. A record's cost
is always the host estimate (``profiler.estimate_superstep_cost``) over
the bytes of the device arrays the superstep reads (``h2d_arg_bytes``).
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
from janusgraph_tpu_torch.observability import flight_recorder, profiler, registry, tracer
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

#: view fields an aggregation strategy reads itself (the program's own
#: reads are recorded by ``_RecordingView``): per orientation, the source
#: index, the destination segment ids and the weights
_STRATEGY_FIELDS = {
    "segsum": (("in_src", "in_edge_weight"), ("out_dst", "out_edge_weight")),
    "segment": (
        ("in_src", "in_dst_seg", "in_edge_weight"),
        ("out_dst", "out_src_seg", "out_edge_weight"),
    ),
}

#: superstep child spans a run publishes at most
_MAX_SUPERSTEP_SPANS = 128


def _nbytes(tree) -> int:
    """Bytes of the arrays in a nest of dicts, lists and tuples (tensors,
    numpy arrays, ELL and hybrid packs, segment-sum plans by the arrays
    the kernel reads); shape arithmetic only, no device sync."""
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, np.ndarray):
        return int(tree.nbytes)
    if isinstance(tree, dict):
        return sum(_nbytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_nbytes(v) for v in tree)
    if isinstance(tree, kernels._SegSumPlan):
        return _nbytes((tree.seg_ptr, tree.seg_start, tree.edge_start))
    if isinstance(tree, kernels.ELLPack):
        return _nbytes((tree.buckets, tree.row_folds, tree.unpermute))
    if isinstance(tree, kernels.HybridPack):
        return _nbytes((tree.torso, tree.tail, tree.unpermute))
    return 0


def _elapsed_ms(timer) -> float:
    """Milliseconds between a (start, end) pair of marks: CUDA events
    (read after the run's final fetch, so both have completed) or host
    ``perf_counter`` stamps."""
    start, end = timer
    if isinstance(start, float):
        return (end - start) * 1e3
    return start.elapsed_time(end)


class _RecordingView:
    """The graph view handed to message/apply on a superstep variant's
    first run: forwards every read to the executor's view and records the
    array fields the program reads (what the reference learns from its
    discovery trace), so ``h2d_arg_bytes`` counts only those."""

    def __init__(self, g, record: set):
        self._g = g
        self._rec = record

    def __getattr__(self, name):
        if name in _DeviceGraph._LAZY:
            self._rec.add(name)
        return getattr(self._g, name)


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

    def __init__(self, csr: CSRGraph, channel: EdgeChannel, device: torch.device,
                 max_capacity: int = 1 << 14):
        self.csr = csr
        self.channel = channel
        self.device = device
        self.max_capacity = max_capacity
        self._ell = None
        self._segsum = None

    # graphlint: host -- cached: built on the eager first superstep; a capture only reads the cache
    def ell(self) -> kernels.ELLPack:
        if self._ell is None:
            src, dst, w = channel_edges(self.csr, self.channel)
            self._ell = kernels.ELLPack(
                src, dst, w, self.csr.num_vertices, max_capacity=self.max_capacity,
            ).to(self.device)
        return self._ell

    # graphlint: host -- cached: built on the eager first superstep; a capture only reads the cache
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
        #: the strategy the aggregation took (learned by the eager step)
        self.strategy = None
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

    def step(self, discover: bool = False, view=None) -> None:
        """One predicated superstep on the buffers. ``discover`` (eager
        only) adds a buffer, seeded with its monoid identity, for each
        aggregator apply emits that the buffers lack, and keeps the
        strategy the aggregation took; ``view`` replaces the executor's
        graph view for message/apply (a ``_RecordingView``)."""
        program, s = self.program, self.steps
        g = self.ex.g if view is None else view
        outgoing = program.message(self.state, s, g)
        agg, strategy = self.ex._aggregate(program, self.op, outgoing)
        new_state, metrics = program.apply(self.state, agg, s, self.mem, g)
        if discover:
            self.strategy = strategy
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

    def chunk(self, length: int, top: int) -> Tuple[float, int, tuple]:
        """Run one chunk of ``length`` steps; returns the seconds spent
        capturing, the segment-sum calls the replayed graph holds and the
        (start, end) marks of the chunk's run: CUDA events recorded around
        the replay on the card (never inside a capture), host clock stamps
        on the CPU. The first chunk on the card captures every length of
        the ladder up to ``top`` at once, so later runs replay only."""
        if self.pool is None:
            t0 = time.perf_counter()
            for _ in range(length):
                self.step()
            self.finish()
            return 0.0, 0, (t0, time.perf_counter())
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
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        return capture_s, captured, (start, end)

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
        # a capture is the port's compile: counted per run as a miss of
        # the run record's compile_cache
        self.ex._captures += 1
        return graph, kernels.sorted_segment_sum.captured - captured0


class GPUExecutor:
    """Single-device executor on a torch device (the card by default).

    ``autotune`` (default on) gives "auto" its decision and the frontier
    engine its tuned ladders; with it off, "auto" takes ELL where the
    pack's estimated footprint (``ell_footprint``) fits ``ell_auto_bytes``
    and ``ell_auto_pad``, and "segment" otherwise. ``hub_cutoff``/
    ``tail_chunk`` fix the hybrid layout; ``autotune_min_gain`` and
    ``autotune_max_tiers`` are the tuner's hysteresis and ladder budget;
    ``autotune_persist`` (default on) keeps the last run's measured record
    beside the checkpoint file and feeds it to the next executor's
    decision. ``ell_max_capacity`` caps the ELL bucket width (wider rows
    split). ``frontier_f_min``/``frontier_e_min``/``frontier_tier_growth``
    shape the frontier tier ladders; ``frontier_cc_min_edges`` is the edge
    count from which ``frontier="auto"`` takes ConnectedComponents through
    the frontier engine (by default never: dense CC is the faster path on
    the card). ``features_dim_tier`` and ``features_native_matmul`` set a
    dense program's lane tier and matmul before its run. ``delta`` is an
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
    #: the ELL pack budget of "auto" without the tuner: device bytes and
    #: padded slots per edge
    ELL_AUTO_BYTES = 6 << 30
    ELL_AUTO_PAD = 3.0
    #: edge count from which frontier="auto" runs CC through the frontier
    #: engine: the engine's own limit, so by default never (the reference
    #: starts at 2^20; on the card dense CC is the faster path, ROADMAP)
    FRONTIER_CC_MIN_EDGES = FrontierEngine.MAX_EDGES

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
        ell_max_capacity: int = None,
        ell_auto_bytes: int = None,
        ell_auto_pad: float = None,
        frontier_cc_min_edges: int = None,
        frontier_f_min: int = None,
        frontier_e_min: int = None,
        frontier_tier_growth: int = None,
        autotune_min_gain: float = None,
        autotune_max_tiers: int = None,
        features_dim_tier: int = None,
        features_native_matmul: bool = None,
    ):
        if strategy not in STRATEGIES:
            raise ValueError(f"unknown aggregation strategy: {strategy!r}")
        if frontier not in FRONTIER_MODES:
            raise ValueError(f"unknown frontier mode: {frontier!r}")
        self._autotune_enabled = True if autotune is None else bool(autotune)
        #: the ELL bucket width cap (computer.ell-max-capacity)
        self._ell_capacity = ell_max_capacity or (1 << 14)
        if ell_auto_bytes is not None:
            self.ELL_AUTO_BYTES = ell_auto_bytes
        if ell_auto_pad is not None:
            self.ELL_AUTO_PAD = ell_auto_pad
        if frontier_cc_min_edges is not None:
            self.FRONTIER_CC_MIN_EDGES = frontier_cc_min_edges
        self._frontier_f_min = frontier_f_min
        self._frontier_e_min = frontier_e_min
        self._frontier_tier_growth = frontier_tier_growth
        self._autotune_min_gain = autotune_min_gain
        self._autotune_max_tiers = autotune_max_tiers
        self._features_dim_tier = features_dim_tier or 0
        self._features_native_matmul = features_native_matmul
        #: "auto" without the tuner, per (undirected, feature dim)
        self._auto_cache: Dict[Tuple, str] = {}
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
        #: per-run record, also published as registry.last_run("olap"):
        #: the reference's fields (path, supersteps, superstep_records,
        #: retraces, h2d_arg_bytes, d2h_bytes, pad_ratio/ell_pad_ratio,
        #: strategy_resolved, autotune, roofline_by_tier, roofline, mxu,
        #: resources, compile_cache, device_memory, slowest_superstep,
        #: delta, resumes, resume_steps; the fused path's first_dispatch_s
        #: and compile_in_first_dispatch; the frontier path's tiers) with
        #: wall_s the path's own clock, plus the port's own: run_wall_s (all
        #: of run(), routing and resumes included, the reference's wall_s),
        #: kernel_launches (eager segment-sum launches), the fused path's
        #: chunks, host_syncs, predicated_steps, capture_s and
        #: graph_kernel_launches (segment-sum calls in the replayed
        #: graphs), the frontier path's hop_wall_s
        self.last_run_info: Dict[str, object] = {}
        #: view fields the program reads, per superstep variant
        self._viewkeys: Dict[Tuple, frozenset] = {}
        #: per-variant (arg bytes, cost record)
        self._kernel_costs: Dict[Tuple, Tuple[int, dict]] = {}
        #: graph arguments of the last superstep variant run (bytes)
        self._last_arg_bytes = 0
        #: CUDA graphs captured by this executor's fused loops, ever
        self._captures = 0
        #: the card's memory size (torch.cuda.mem_get_info), read once
        self._bytes_limit = None
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

    # graphlint: host -- cached per edge view: decided before the first capture, read at capture
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
            self.csr, undirected=undirected, max_capacity=self._ell_capacity,
            tail_chunk=self._tail_chunk_cfg or 256,
        )
        ov = {
            "hub_cutoff": self._hub_cutoff_cfg,
            "tail_chunk": self._tail_chunk_cfg,
            "min_gain": self._autotune_min_gain,
            "budget_bytes": self.ELL_AUTO_BYTES,
            "max_pad": self.ELL_AUTO_PAD,
            "f_min": self._frontier_f_min,
            "e_min": self._frontier_e_min,
            "max_tiers": self._autotune_max_tiers,
            "tier_growth": self._frontier_tier_growth,
        }
        if self._strategy_cfg != "auto":
            ov["strategy"] = self._strategy_cfg
        if self._features_dim_tier:
            ov["feature_dim_tier"] = self._features_dim_tier
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
            if self._autotune_enabled:
                return self._autotune(undirected).strategy
            key = (undirected, self._feature_dim_run)
            base = self._auto_cache.get(key)
            if base is None:
                fp = self.ell_footprint(self.csr, self._ell_capacity, undirected)
                fits = fp["bytes"] <= self.ELL_AUTO_BYTES and fp["pad_ratio"] <= self.ELL_AUTO_PAD
                base = self._auto_cache[key] = "ell" if fits else "segment"
        return base

    @staticmethod
    # graphlint: host -- "auto"'s footprint estimate, cached in _auto_cache before the first capture
    def ell_footprint(csr: CSRGraph, max_capacity: int = 1 << 14, undirected: bool = False):
        """The ELL pack's device footprint, estimated from the degree
        histogram without building it: a vertex takes next-pow2(degree)
        slots (capped; rows past the cap split at about one slot per
        edge), 4 bytes a slot unweighted (the index) and 12 weighted
        (index, weight, validity). Undirected programs pack both
        orientations. {slots, bytes, pad_ratio}."""
        deg = np.diff(csr.in_indptr).astype(np.int64)
        edges = csr.num_edges
        if undirected:
            deg = deg + np.diff(csr.out_indptr).astype(np.int64)
            edges *= 2
        caps = np.maximum(1, 1 << np.ceil(np.log2(np.maximum(deg, 1))).astype(np.int64))
        slots = int(np.minimum(caps, max_capacity).sum())
        over = deg > max_capacity
        if over.any():
            slots += int((deg[over] - max_capacity).sum())
        per_slot = 12 if csr.in_edge_weight is not None else 4
        return {"slots": slots, "bytes": slots * per_slot, "pad_ratio": slots / max(1, edges)}

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

    # graphlint: host -- cached: built on the eager first superstep; a capture only reads the cache
    def _ell_pack(self, undirected: bool) -> kernels.ELLPack:
        pack = self._ell_packs.get(undirected)
        if pack is None:
            src, dst, w = self._edge_view(undirected)
            pack = kernels.ELLPack(
                src, dst, w, self.csr.num_vertices, max_capacity=self._ell_capacity,
            ).to(self.device)
            self._ell_packs[undirected] = pack
        return pack

    # graphlint: host -- cached: built on the eager first superstep; a capture only reads the cache
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
                hub_cutoff=cutoff, tail_chunk=chunk, max_capacity=self._ell_capacity,
            ).to(self.device)
            self._hybrid_packs[undirected] = pack
        return pack

    # graphlint: host -- cached: built on the eager first superstep; a capture only reads the cache
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
                rows = put(fkernels.ell_row_dsts(src, dst, n, max_capacity=self._ell_capacity))
            else:
                pack = self._hybrid_pack(undirected)
                host = fkernels.hybrid_row_dsts(
                    src, dst, n, hub_cutoff=pack.hub_cutoff, tail_chunk=pack.tail_chunk,
                    max_capacity=self._ell_capacity,
                )
                rows = {k: put(v) for k, v in host.items()}
            self._sddmm_rows_cache[key] = rows
        return rows

    # graphlint: host -- cached: built on the eager first superstep; a capture only reads the cache
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
        entry = _ChannelPack(self.csr, channel, self.device, self._ell_capacity)
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
        # keeps CC dense below FRONTIER_CC_MIN_EDGES (by default always:
        # the faster path on the card)
        return self.csr.num_vertices < (1 << 24) and (
            mode == "always" or self.csr.num_edges >= self.FRONTIER_CC_MIN_EDGES
        )

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
        captures0 = self._captures
        # a path that reads no graph arguments (the frontier engine ships
        # its own tiers) must not report the last run's bytes
        self._last_arg_bytes = 0
        t0 = time.perf_counter()
        # the computer.executor name of this device: "tpu" is the card
        kind = "tpu" if self.device.type == "cuda" else "cpu"
        with tracer.span(
            "olap.run", program=type(program).__name__, executor=kind,
            strategy=self._strategy_cfg,
        ) as sp:
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
                    registry.counter("olap.preemptions").inc()
                    if not (checkpoint_path and checkpoint_every) or resumes >= resume_attempts:
                        raise
                    # replay from the last checkpoint: its arrays are exact,
                    # so the final state is the uninterrupted run's
                    resumes += 1
                    resume = True
                    # from_step is filled in when the next attempt loads
                    resume_steps.append({
                        "attempt": resumes, "at_s": round(time.perf_counter() - t0, 4),
                        "preempted_at": self._hook_step,
                    })
                    registry.counter("olap.resumes").inc()
                    flight_recorder.record(
                        "olap_resume", executor=kind, attempt=resumes,
                        program=type(program).__name__,
                    )
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
            info["kernel_launches"] = kernels.sorted_segment_sum.launches - launches0
            if resumes:
                info["resumes"] = resumes
                info["resume_steps"] = resume_steps
                sp.annotate(resumes=resumes)
            run_wall_s = time.perf_counter() - t0
            info["run_wall_s"] = run_wall_s
            self._finish_run(sp, program, out, run_wall_s, self._captures - captures0)
        return out

    def _prepare_dense(self, program: VertexProgram) -> None:
        """The dense tier's run set-up: the configured lane tier and matmul
        (``features_dim_tier``/``features_native_matmul``), the tuner's
        feature-dim input and the sddmm mode's envelope."""
        if self._features_dim_tier and hasattr(program, "set_dim_tier"):
            if getattr(program, "dim_tier", 0) != self._features_dim_tier:
                program.set_dim_tier(self._features_dim_tier)
        if self._features_native_matmul is not None and hasattr(program, "set_native_matmul"):
            program.set_native_matmul(self._features_native_matmul)
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

    def _mark(self):
        """A timing mark on the executor's stream: a recorded CUDA event on
        the card, the host clock on the CPU (``_elapsed_ms`` reads a pair)."""
        if self.device.type == "cuda":
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev
        return time.perf_counter()

    # ------------------------------------------------------------ telemetry
    def _variant(self, program: VertexProgram, op: str, channel: str = None) -> Tuple:
        """A superstep variant: (program, monoid, strategy, channel value,
        overlay lane signature), the key of its view reads and its cost."""
        ch_val = program.edge_channels[channel] if channel is not None else None
        return (program.cache_key(), op, self._resolve_strategy(op, program.undirected),
                ch_val, self._delta_sig(program))

    def _view_for(self, variant: Tuple):
        """(the view message/apply get, the set it records into or None):
        a variant's first superstep records the fields the program reads."""
        if variant in self._viewkeys:
            return self.g, None
        rec = set()
        return _RecordingView(self.g, rec), rec

    def _superstep_cost(self, program: VertexProgram, variant: Tuple, strategy: str,
                        channel: str = None, rec: set = None) -> dict:
        """One variant's cost record {flops, bytes_accessed, cost_source}
        (the host estimate over its graph-argument bytes), computed once;
        ``rec`` is the field set its first superstep recorded. Sets
        ``_last_arg_bytes``."""
        if rec is not None:
            self._viewkeys[variant] = frozenset(rec)
        cached = self._kernel_costs.get(variant)
        if cached is None:
            arg_bytes = self._arg_bytes(program, strategy, channel, self._viewkeys[variant])
            cached = (arg_bytes, profiler.estimate_superstep_cost(
                self.csr.num_vertices,
                self.csr.num_edges * (2 if program.undirected else 1),
                msg_cols=getattr(program, "d_pad", 1) or 1,
                weighted=self.csr.in_edge_weight is not None,
                arg_bytes=arg_bytes,
            ))
            self._kernel_costs[variant] = cached
        self._last_arg_bytes = cached[0]
        return cached[1]

    def _arg_bytes(self, program: VertexProgram, strategy: str, channel: str,
                   used: frozenset) -> int:
        """Bytes of the device arrays one superstep reads as its graph
        arguments (the reference's ``h2d_arg_bytes``): the view fields the
        program and the strategy read, the pack or plan, the sddmm rows and
        the overlay's lanes."""
        und = bool(program.undirected)
        fields = set(used)
        structs = []
        if channel is not None:
            entry = self._channel_pack(program, channel)
            structs.append(entry.segsum() if strategy == "segsum" else entry.ell())
        elif getattr(program, "message_mode", None) == "sddmm":
            if strategy in ("ell", "hybrid"):
                structs.append(self._ell_pack(False) if strategy == "ell" else self._hybrid_pack(False))
                structs.append(self._sddmm_rows(strategy, False))
            else:
                fields.update(("in_src", "in_dst_seg"))
        elif strategy == "ell":
            structs.append(self._ell_pack(und))
        elif strategy == "hybrid":
            structs.append(self._hybrid_pack(und))
        else:
            views = _STRATEGY_FIELDS[strategy]
            fields.update(views[0] + (views[1] if und else ()))
            if strategy == "segsum":
                structs += [self._segsum_plan(o) for o in (("in", "out") if und else ("in",))]
        if self._delta is not None:
            structs.append(self._delta.device_args(self.device, und))
        return sum(_nbytes(getattr(self.g, k)) for k in sorted(fields)) + _nbytes(structs)

    def _device_memory(self, info: dict) -> dict:
        """Device-memory occupancy for the run record: the caching
        allocator's counters on the card (no sync), else the reference's
        host estimate (graph arguments + results)."""
        if self.device.type == "cuda":
            # the nested form: memory_stats() flattens it into some hundred
            # dotted keys on every call
            allocated = torch.cuda.memory_stats_as_nested_dict(self.device)["allocated_bytes"]["all"]
            if self._bytes_limit is None:
                self._bytes_limit = int(torch.cuda.mem_get_info(self.device)[1])
            return {
                "source": "device",
                "bytes_in_use": int(allocated["current"]),
                "peak_bytes_in_use": int(allocated["peak"]),
                "bytes_limit": self._bytes_limit,
            }
        return {
            "source": "host-estimate",
            "bytes_in_use": int(info.get("h2d_arg_bytes", 0)) + int(info.get("d2h_bytes", 0)),
        }

    def _finish_run(self, sp, program: VertexProgram, result: Dict[str, np.ndarray],
                    wall_s: float, captures: int) -> None:
        """Publish the finished run, as the reference's ``_finish_run``:
        enrich ``last_run_info`` (transfer bytes, pad ratio, the tuner's
        decision, per-superstep roofline records, MXU, resources, compile
        cache, device memory), attach the per-superstep child spans, set the
        OLAP gauges, persist the measured record beside the checkpoint file
        and hand the record to the registry (``registry.last_run("olap")``).
        Everything read here is on the host already: record walls are read
        after the run's final fetch."""
        info = self.last_run_info
        info["retraces"] = captures
        info["h2d_arg_bytes"] = int(self._last_arg_bytes)
        info["d2h_bytes"] = int(sum(np.asarray(v).nbytes for v in result.values()))
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

        records = info.get("superstep_records")
        if records is None:
            # frontier path: the tier trace is the per-superstep record,
            # each hop's wall the host clock between its fetches
            walls = info.get("hop_wall_s", [])
            records = [
                {
                    "step": int(t.get("hop", i)),
                    "frontier": int(t.get("frontier", 0)),
                    "edges": int(t.get("edges", 0)),
                    "e_cap": int(t.get("E_cap", 0)),
                    **({"wall_ms": walls[i] * 1e3} if i < len(walls) else {}),
                }
                for i, t in enumerate(info.get("tiers", []))
            ]
        n = self.g.num_vertices
        for i, r in enumerate(records):
            # a dense superstep touches every vertex; the frontier path
            # recorded its compacted sizes above
            r.setdefault("frontier", n)
            if pad_ratio is not None:
                r.setdefault("pad_ratio", pad_ratio)
            r.setdefault("h2d_bytes", info["h2d_arg_bytes"] if i == 0 else 0)
        info["superstep_records"] = records

        weighted = self.csr.in_edge_weight is not None
        cols = self._feature_dim_run or 1
        for r in records:
            if "flops" not in r:
                r.update(profiler.estimate_superstep_cost(
                    int(r.get("frontier", n)), int(r.get("edges", self.csr.num_edges)),
                    msg_cols=cols, weighted=weighted,
                ))
        peaks = profiler.device_peaks(self._device_kind())
        info["roofline_by_tier"] = profiler.attach_roofline(
            records, profiler.estimate_superstep_cost(
                n, self.csr.num_edges, msg_cols=cols, weighted=weighted,
                arg_bytes=info["h2d_arg_bytes"],
            ), peaks,
        )
        info["roofline"] = {
            "peak_flops": peaks["peak_flops"],
            "peak_bytes_per_s": peaks["peak_bytes_per_s"],
            "device_kind": peaks["device_kind"],
            "peaks_source": peaks["source"],
        }
        if callable(getattr(program, "matmul_flops", None)):
            edges = self.csr.num_edges * (2 if undirected else 1)
            peak, peak_source = profiler.matmul_peak(peaks, self.device.type)
            info["mxu"] = profiler.attach_mxu(
                records, float(program.matmul_flops(n, edges)), dict(peaks, peak_mxu_flops=peak),
            )
            info["mxu"]["peak_source"] = peak_source
            mean_util = info["mxu"].get("mean_utilization")
            if mean_util is not None:
                registry.set_gauge("olap.mxu.utilization", float(mean_util))
        if records:
            registry.set_gauge(
                "olap.roofline.operational_intensity",
                float(records[-1].get("operational_intensity") or 0.0),
            )
            util = records[-1].get("roofline_utilization")
            if util is not None:
                registry.set_gauge("olap.roofline.utilization", float(util))

        info["resources"] = {
            "h2d_bytes": info["h2d_arg_bytes"],
            "d2h_bytes": info["d2h_bytes"],
            "flops": sum(r.get("flops", 0.0) for r in records),
            "bytes_accessed": sum(r.get("bytes_accessed", 0.0) for r in records),
        }
        profiler.accrue(h2d_bytes=info["h2d_arg_bytes"], d2h_bytes=info["d2h_bytes"])
        profiler.accrue_wall("olap", wall_s * 1000.0)

        # a CUDA graph captured in this run is the port's compile (a miss);
        # every other dispatch replayed or ran eagerly (a hit)
        dispatches = max(len(records), 1)
        misses = min(captures, dispatches)
        info["compile_cache"] = {
            "hits": dispatches - misses,
            "misses": misses,
            "compiled_total": sum(len(lp.graphs) for lp in self._fused_loops.values()),
        }
        registry.counter("olap.compile_cache.hits").inc(dispatches - misses)
        registry.counter("olap.compile_cache.misses").inc(misses)

        info["device_memory"] = self._device_memory(info)
        registry.set_gauge("olap.device.bytes_in_use", float(info["device_memory"]["bytes_in_use"]))
        if "peak_bytes_in_use" in info["device_memory"]:
            registry.set_gauge(
                "olap.device.peak_bytes_in_use", float(info["device_memory"]["peak_bytes_in_use"])
            )

        slowest = None
        for r in records[:_MAX_SUPERSTEP_SPANS]:
            s = tracer.record_span(
                "superstep", float(r.get("wall_ms", 0.0)),
                **{k: v for k, v in r.items() if k != "wall_ms"},
            )
            if slowest is None or s.duration_ms > slowest.duration_ms:
                slowest = s
        if slowest is not None:
            info["slowest_superstep"] = {
                "step": slowest.attrs.get("step"),
                "wall_ms": round(slowest.duration_ms, 4),
                "span_id": f"{slowest.span_id:016x}",
                "trace_id": f"{slowest.trace_id:016x}",
            }
        sp.annotate(
            path=info.get("path"),
            supersteps=info.get("supersteps"),
            wall_s=round(wall_s, 4),
            retraces=captures,
            ell_pad_ratio=pad_ratio,
            h2d_arg_bytes=info["h2d_arg_bytes"],
            d2h_bytes=info["d2h_bytes"],
        )

        registry.counter("olap.runs").inc()
        registry.timer("olap.run").update(int(wall_s * 1e9))
        registry.set_gauge("olap.superstep.count", float(info.get("supersteps", 0) or 0))
        registry.set_gauge("olap.run.wall_ms", round(wall_s * 1000.0, 3))
        registry.set_gauge("olap.transfer.h2d_bytes", float(info["h2d_arg_bytes"]))
        registry.set_gauge("olap.transfer.d2h_bytes", float(info["d2h_bytes"]))
        if pad_ratio is not None:
            registry.set_gauge("olap.ell.pad_ratio", pad_ratio)
        if records:
            registry.set_gauge("olap.frontier.last", float(records[-1].get("frontier", n)))
            registry.histogram("olap.frontier.size").observe(float(records[-1].get("frontier", n)))
        if self._measured_path and records and pad_ratio is not None:
            walls = sorted(float(r.get("wall_ms", 0.0)) for r in records)
            autotune.save_measured(self._measured_path, {
                "strategy": resolved if isinstance(resolved, str) else None,
                "pad_ratio": pad_ratio,
                "superstep_ms": walls[len(walls) // 2],
                "roofline_by_tier": info["roofline_by_tier"],
            }, shard_count=1)
        registry.record_run("olap", info)

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
        #: (record, (start, end) marks) pairs, read after the final fetch
        timed = []
        variants = {}
        last_step = program.max_iterations - 1
        for step in range(start, program.max_iterations):
            self._call_hook(fault_hook, step)
            op = program.combiner_for(step)
            ch = program.channel_for(step)
            variant = variants.get((op, ch))
            if variant is None:
                variant = variants[(op, ch)] = self._variant(program, op, ch)
            view, rec = self._view_for(variant)
            mark0 = self._mark()
            outgoing = program.message(state, step, view)
            agg, strategy = self._aggregate(program, op, outgoing, ch)
            state, metrics = program.apply(state, agg, step, device_memory, view)
            mark1 = self._mark()
            resolved[op if ch is None else f"{op}:{ch}"] = strategy
            records.append({
                "step": step, "combiner": op, "channel": ch, "strategy": strategy,
                "compiled": False,
                **self._superstep_cost(program, variant, strategy, ch, rec),
            })
            timed.append((records[-1], (mark0, mark1)))
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
                ck0 = time.perf_counter()
                save_checkpoint(
                    checkpoint_path, {k: v.cpu().numpy() for k, v in state.items()},
                    memory.values, steps_done,
                )
                records[-1]["checkpoint_ms"] = round((time.perf_counter() - ck0) * 1e3, 3)
            if program.terminate(memory):
                break
        out = {k: v.cpu().numpy() for k, v in state.items()}
        # the result fetch waited for every superstep: the marks are done
        for r, timer in timed:
            r["wall_ms"] = round(_elapsed_ms(timer), 4)
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
        checkpoint, where the host saves and consults ``fault_hook``.

        One record per superstep run, as the reference's: the eager step
        its own wall, a chunk's steps its wall shared out."""
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
        cost = None
        cold = False
        first_dispatch_s = None
        records = []
        #: (records of one timed span, its (start, end) marks)
        timed = []
        while steps_done < max_iter:
            self._call_hook(fault_hook, steps_done)
            limit = max_iter
            if checkpoint_every:
                limit = min(steps_done + checkpoint_every, max_iter)
            d0 = time.perf_counter()
            spans = []  # (first step, steps, marks) run before the next fetch
            if loop is None:
                loop, new = self._fused_loop(program, op, state, mem, steps_done, limit)
                variant = self._variant(program, op)
                expected = steps_done
                if new:
                    cold = True
                    view, rec = self._view_for(variant)
                    mark0 = self._mark()
                    loop.step(discover=True, view=view)
                    spans.append((expected, 1, (mark0, self._mark())))
                    expected += 1
                    cost = self._superstep_cost(program, variant, loop.strategy, None, rec)
                else:
                    cost = self._superstep_cost(program, variant, loop.strategy)
            else:
                loop.limit.fill_(limit)
                expected = steps_done
            stopped = False
            while expected < limit:
                length = 1 << (min(limit - expected, self.MAX_CHUNK).bit_length() - 1)
                capture_s, captured, marks = loop.chunk(length, top)
                cold = cold or (capture_s > 0 and first_dispatch_s is None)
                spans.append((expected, length, marks))
                info["capture_s"] += capture_s
                info["graph_kernel_launches"] += captured
                info["chunks"] += 1
                new_steps, stopped = loop.status.tolist()
                info["host_syncs"] += 1
                info["predicated_steps"] += expected + length - new_steps
                self._fused_records(records, timed, spans, new_steps, cold)
                spans = []
                if first_dispatch_s is None:
                    first_dispatch_s = time.perf_counter() - d0
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
                self._fused_records(records, timed, spans, new_steps, cold)
                if first_dispatch_s is None:
                    first_dispatch_s = time.perf_counter() - d0
                steps_done = new_steps
            if checkpoint_path and checkpoint_every:
                ck0 = time.perf_counter()
                save_checkpoint(
                    checkpoint_path,
                    {k: v.cpu().numpy() for k, v in loop.state.items()},
                    {k: v.cpu().numpy() for k, v in loop.mem.items()},
                    steps_done,
                )
                info["host_syncs"] += 1
                if records:
                    # the save's wall, stamped on the superstep that paid it
                    records[-1]["checkpoint_ms"] = round((time.perf_counter() - ck0) * 1e3, 3)
            if stopped or steps_done < limit:
                break
        final = loop.state if loop is not None else state
        # a copy on every device: the loop's buffers serve the next run
        out = {k: v.to("cpu", copy=True).numpy() for k, v in final.items()}
        info["host_syncs"] += 1
        # the fetches waited for every span: the marks are done
        for recs, marks in timed:
            per_ms = round(_elapsed_ms(marks) / len(recs), 4)
            for r in recs:
                r["wall_ms"] = per_ms
        for r in records:
            r.update(cost)
        info["supersteps"] = steps_done
        info["wall_s"] = time.perf_counter() - t0
        info["superstep_records"] = records
        info["first_dispatch_s"] = round(first_dispatch_s or 0.0, 4)
        info["compile_in_first_dispatch"] = cold
        self.last_run_info = info
        return out

    @staticmethod
    def _fused_records(records, timed, spans, new_steps: int, cold: bool) -> None:
        """Records for the supersteps the spans since the last fetch ran:
        a span of ``count`` steps from ``first`` covers those below
        ``new_steps`` (the rest were predicated out), each with the span's
        wall shared out (``approx``, as the reference's fused records). The
        first record of a run that captured or built its loop is
        ``compiled``."""
        for first, count, marks in spans:
            ran = min(first + count, new_steps) - first
            if ran <= 0:
                continue
            recs = [
                {"step": s, "approx": True, "compiled": cold and not records and i == 0}
                for i, s in enumerate(range(first, first + ran))
            ]
            records.extend(recs)
            timed.append((recs, marks))

    # ------------------------------------------------------------ write-back
    def write_back(self, graph, result: Dict[str, np.ndarray], keys=None) -> None:
        """Persist compute-key arrays as vertex properties in batched txs
        (reference: FulgoraGraphComputer.java:359-437 VertexPropertyWriter)."""
        write_back(graph, self.csr, result, keys)


def write_back(graph, csr: CSRGraph, result: Dict[str, np.ndarray], keys=None,
               batch: int = 10_000) -> None:
    """Persist compute-key arrays as vertex properties, where the reference
    keeps this entry point (``tpu_executor.write_back``); the writers live
    in ``olap/computer.py`` beside ``ComputerResult.write_back``."""
    from janusgraph_tpu_torch.olap import computer

    computer.write_back(graph, csr, result, keys, batch)
