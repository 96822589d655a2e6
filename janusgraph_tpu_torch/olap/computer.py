"""GraphComputer facade: the user-facing OLAP entry point — the port of
``janusgraph_tpu/olap/computer.py``.

``graph.compute().program(p).submit()`` takes the CSR snapshot, runs ``p``
on a ``GPUExecutor`` built from the graph's ``computer.*`` options, and
returns a ``ComputerResult`` (state arrays, ``value``/``by_vertex``,
``paths``/``select`` after ``traverse(..., paths=True)``, MapReduce
``memory``, ``run_info``) that can ``write_back`` compute keys as vertex
properties.

The snapshot: with ``computer.delta`` (the default) an unfiltered submit
goes through the graph's warm delta snapshot (``olap/delta.py``). The
first scans the store; later ones read only the writes committed since,
from the change capture. A small overlay runs fused with the base (the
executor merges the add and tombstone lanes each superstep); a large one,
or a program that cannot consume it fused, is folded into a new base by
``materialize``. Executors over the current base are cached on the
snapshot, so a warm submit reuses their device packs and captured CUDA
graphs. ``run_info["snapshot"]`` says which path the submit took. A
filtered submit (``edges``/``vertices``/``properties``/``weight``) scans
the store through ``load_csr``. With ``storage.distributed-load-workers``
W > 1 over a "local" or "remote" store, an unfiltered submit loads through W loader
processes (``olap/distributed_load.py``; ``run_info["snapshot"]`` is
``{"path": "distributed", "workers": W}``), never through the delta
snapshot, as in the reference; a failed load raises.

Executors: "tpu" (the default; the reference's name for its one
accelerator) runs on the CUDA card and raises where there is none; "cpu"
runs the same executor's plain PyTorch versions on the CPU. "sharded"
raises (ROADMAP Queue A #4).

``write_back`` takes the columnar float path of the reference
(``tpu_executor.py`` ``_write_back_columnar``) for SINGLE float keys and
its transactional path (``_write_back_tx``, batched OLTP transactions) for
the others and for every key an index covers, so that the index follows
(composite rows, mixed-index documents): the same cells, batch for batch.

Telemetry, as the reference's: ``submit()`` runs under an ``olap.submit``
span with the ``olap.load_csr`` snapshot load, the executor's ``olap.run``
(with its per-superstep children) and one ``olap.map_reduce`` per job as
children; it records its routing (``registry.record_run("olap.routing",
...)``) and takes ``run_info`` from ``registry.last_run("olap")`` plus
``routing`` (and the port's ``snapshot``).

Left out: OLAP admission (the server's, ROADMAP Queue A #5) and sharded
routing (#4).
``run_on`` is the array-level entry point beside it.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from janusgraph_tpu_torch.device import resolve_device
from janusgraph_tpu_torch.exceptions import ConfigurationError
from janusgraph_tpu_torch.observability import registry, tracer
from janusgraph_tpu_torch.olap import delta as _delta
from janusgraph_tpu_torch.olap.csr import CSRGraph, load_csr
from janusgraph_tpu_torch.olap.gpu_executor import GPUExecutor
from janusgraph_tpu_torch.olap.vertex_program import VertexProgram

#: computer.strategy values -> the GPUExecutor strategy ("pallas" is the
#: reference's name for its hand kernel)
_STRATEGY = {"pallas": "segsum"}


@dataclass
class ComputerResult:
    states: Dict[str, np.ndarray]
    csr: CSRGraph
    graph: object = None
    #: map-reduce results keyed by each job's memory_key
    memory: Dict[str, object] = field(default_factory=dict)
    #: the run's record (registry.last_run("olap")) plus the submit()
    #: routing decision under "routing" and the snapshot path under
    #: "snapshot"
    run_info: Dict[str, object] = field(default_factory=dict)
    #: the program that produced `states` (path()/select() terminals)
    program: object = None
    #: name of path position 0 for select() (compute().traverse(source_as=))
    source_as: object = None

    def _path_index(self):
        """Memoized reverse-adjacency index shared by paths() and select()."""
        from janusgraph_tpu_torch.olap.programs.olap_traversal import build_path_index

        idx = getattr(self, "_path_index_cache", None)
        if idx is None:
            idx = build_path_index(self.csr, self.program)
            object.__setattr__(self, "_path_index_cache", idx)
        return idx

    def paths(self, limit=None):
        """Enumerate traverser paths (tuples of vertex ids, seed first) —
        requires compute().traverse(..., paths=True). Lazy generator."""
        from janusgraph_tpu_torch.olap.programs.olap_traversal import enumerate_paths

        if "reach" not in self.states:
            raise ValueError(
                "no reach masks recorded — run "
                "compute().traverse(..., paths=True)"
            )
        return enumerate_paths(
            self.csr, self.program, self.states, limit,
            path_index=self._path_index,
        )

    def select(self, *names, limit=None):
        """Project as()-labeled path positions: yields {name: vertex_id}."""
        from janusgraph_tpu_torch.olap.programs.olap_traversal import select_paths

        if "reach" not in self.states:
            raise ValueError(
                "no reach masks recorded — run "
                "compute().traverse(..., paths=True)"
            )
        return select_paths(
            self.csr, self.program, self.states, names,
            source_as=self.source_as, limit=limit,
            path_index=self._path_index,
        )

    def value(self, key: str, vertex_id: int) -> float:
        return float(self.states[key][self.csr.index_of(vertex_id)])

    def by_vertex(self, key: str) -> Dict[int, float]:
        arr = self.states[key]
        return {int(v): float(arr[i]) for i, v in enumerate(self.csr.vertex_ids)}

    def write_back(self, keys: Optional[Sequence[str]] = None) -> None:
        write_back(self.graph, self.csr, self.states, keys,
                   batch=self.graph.config.get("computer.write-back-batch"))


def executor_device(executor: str) -> torch.device:
    """The device a ``computer.executor`` value names: "tpu" (the
    reference's name for its one accelerator) is the CUDA card and raises
    where there is none, before anything loads; "cpu" runs the plain
    PyTorch versions on the CPU; "sharded" raises (ROADMAP Queue A #4)."""
    if executor == "sharded":
        raise ConfigurationError(
            "the sharded executor is not ported yet: ROADMAP.md Queue A #4 "
            "(multi-GPU)"
        )
    if executor not in ("tpu", "cpu"):
        raise ConfigurationError(f"unknown executor {executor!r}")
    if executor == "tpu" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; graph.compute(executor='cpu') "
            "runs the plain PyTorch path on the CPU"
        )
    return resolve_device(None if executor == "tpu" else "cpu")


class GraphComputer:
    """The graph.compute() front end (reference: JanusGraphComputer). Executor
    kind, aggregation strategy, sync cadence and checkpointing default to
    the graph's config (computer.* options)."""

    def __init__(self, graph, executor: str = None):
        self.graph = graph
        if executor is None:
            executor = graph.config.get("computer.executor")
        self.device = executor_device(executor)
        self.executor_kind = executor
        self._edge_labels: Optional[Sequence[str]] = None
        self._vertex_labels: Optional[Sequence[str]] = None
        self._property_keys: Sequence[str] = ()
        self._weight_key: Optional[str] = None
        self._program: Optional[VertexProgram] = None
        self._traverse_args = None
        self._map_reduces: list = []

    def edges(self, *labels: str) -> "GraphComputer":
        """GraphFilter on edge labels (reference: GraphComputer.edges)."""
        self._edge_labels = labels
        return self

    def vertices(self, *labels: str) -> "GraphComputer":
        """GraphFilter on vertex labels (reference: GraphComputer.vertices)."""
        self._vertex_labels = labels
        return self

    def map_reduce(self, mr) -> "GraphComputer":
        """Add a MapReduce job over the final vertex state."""
        self._map_reduces.append(mr)
        return self

    def properties(self, *keys: str) -> "GraphComputer":
        self._property_keys = keys
        return self

    def weight(self, key: str) -> "GraphComputer":
        self._weight_key = key
        return self

    def program(self, p: VertexProgram) -> "GraphComputer":
        self._program = p
        # an explicit program supersedes any earlier traverse() shortcut
        self._traverse_args = None
        return self

    def traverse(
        self, *spec, seed_filters=None, paths=False, source_as=None,
        sack=None, sack_init=None,
    ) -> "GraphComputer":
        """OLAP traversal shortcut: compute().traverse(("out", ["knows"]),
        ("in", None)).submit() counts traversers per vertex; spec items may
        carry has()-filters, ``seed_filters`` restricts the start set,
        ``paths=True`` records reach masks for ``paths()``/``select()``,
        ``sack="sum"|"mult"`` folds the edge weight each hop (pair with
        ``.weight(key)``). The program is built at submit() from the loaded
        snapshot (``build_olap_traversal``)."""
        self._traverse_args = (
            spec, seed_filters, paths, source_as, sack, sack_init,
        )
        self._program = None
        return self

    def _executor_kwargs(self):
        """(GPUExecutor kwargs, run kwargs) from the computer.* options."""
        cfg = self.graph.config
        strategy = cfg.get("computer.strategy")
        ex_kw = {
            "strategy": _STRATEGY.get(strategy, strategy),
            "frontier": cfg.get("computer.frontier"),
            "channel_cache_size": cfg.get("computer.channel-cache-size"),
            "autotune": cfg.get("computer.autotune"),
            "hub_cutoff": cfg.get("computer.autotune-hub-cutoff"),
            "tail_chunk": cfg.get("computer.autotune-tail-chunk"),
            "autotune_persist": cfg.get("computer.autotune-persist"),
            "ell_max_capacity": cfg.get("computer.ell-max-capacity"),
            "ell_auto_bytes": cfg.get("computer.ell-auto-budget-bytes"),
            "ell_auto_pad": cfg.get("computer.ell-auto-pad"),
            "frontier_cc_min_edges": cfg.get("computer.frontier-cc-min-edges"),
            "frontier_f_min": cfg.get("computer.frontier-f-min"),
            "frontier_e_min": cfg.get("computer.frontier-e-min"),
            "frontier_tier_growth": cfg.get("computer.frontier-tier-growth"),
            "autotune_min_gain": cfg.get("computer.autotune-min-gain"),
            "autotune_max_tiers": cfg.get("computer.autotune-max-tiers"),
            "features_dim_tier": cfg.get("computer.features-dim-tier"),
            "features_native_matmul": cfg.get("computer.features-native-matmul"),
        }
        run_kw = {
            "sync_every": cfg.get("computer.sync-every"),
            "checkpoint_every": cfg.get("computer.checkpoint-every"),
            "checkpoint_path": cfg.get("computer.checkpoint-path") or None,
            "resume_attempts": cfg.get("computer.resume-attempts"),
        }
        return ex_kw, run_kw

    def submit(self) -> ComputerResult:
        """Take the CSR snapshot, run the program, wrap the result — the
        whole pipeline under an ``olap.submit`` span."""
        with tracer.span("olap.submit", executor=self.executor_kind) as sp:
            return self._submit(sp)

    def _submit(self, sp) -> ComputerResult:
        property_keys = self._property_keys
        traverse_args = self._traverse_args
        if traverse_args is not None:
            # filters reference property names: the snapshot loads them
            from janusgraph_tpu_torch.olap.programs.olap_traversal import (
                _parse_filters,
                steps_from_spec,
            )

            spec, seed_filters = traverse_args[0], traverse_args[1]
            fkeys = {f.key for f in _parse_filters(seed_filters)}
            for st in steps_from_spec(self.graph, spec):
                fkeys.update(f.key for f in st.filters)
            property_keys = tuple(set(property_keys or ()) | fkeys)
        if self._program is None and traverse_args is None:
            raise ValueError("program() not set")
        plain = not (
            property_keys or self._weight_key or self._edge_labels or self._vertex_labels
        )
        cfg = self.graph.config
        # distributed CSR loading (storage.distributed-load-workers): N
        # worker processes scan disjoint partition sets of a shared backend
        # and the parent merges once; the raw scan carries no property,
        # weight or filter columns, so those load in-process. A distributed
        # load bypasses the warm delta snapshot, as in the reference, and a
        # failed load raises
        workers = cfg.get("storage.distributed-load-workers")
        distributed = workers > 1 and plain and cfg.get("storage.backend") in ("remote", "local")
        with tracer.span("olap.load_csr") as ls:
            delta_snap = (
                _delta.get_snapshot(self.graph) if plain and workers <= 1 else None
            )
            delta_view = None
            if delta_snap is not None:
                csr, delta_view, snapshot = delta_snap.acquire()
                ls.annotate(delta_path=snapshot["path"], overlay=snapshot.get("overlay", 0))
            elif distributed:
                from janusgraph_tpu_torch.olap.distributed_load import distributed_load_csr

                csr = distributed_load_csr(
                    dict(cfg.local), num_workers=workers,
                    timeout_s=cfg.get("storage.distributed-load-timeout-s"),
                    partition_bits=self.graph.idm.partition_bits,
                )
                snapshot = {"path": "distributed", "workers": workers}
                ls.annotate(distributed_workers=workers)
            else:
                csr = load_csr(
                    self.graph,
                    edge_labels=self._edge_labels,
                    vertex_labels=self._vertex_labels,
                    property_keys=property_keys,
                    weight_key=self._weight_key,
                )
                snapshot = {"path": "scan"}
            ls.annotate(num_vertices=csr.num_vertices, num_edges=csr.num_edges)
        if delta_view is not None:
            # a small overlay rides into the executor fused (base packs
            # untouched, lanes merged each superstep); a traversal (typed
            # channels), another program that cannot consume it, or lanes
            # over the cap fold it into new arrays first (zero store reads
            # either way)
            fuse = (
                traverse_args is None
                and _delta.program_delta_compatible(self._program)
                and delta_view.lanes(bool(self._program.undirected)) is not None
            )
            if fuse:
                sp.annotate(delta="fused", overlay=delta_view.depth)
            else:
                csr = _delta.materialize(csr, delta_view.overlay, idm=self.graph.idm)
                delta_snap.adopt(csr, delta_view.upto_epoch)
                snapshot["path"] = "materialized"
                sp.annotate(delta="materialized", overlay=delta_view.depth)
                delta_view = None
        if traverse_args is not None:
            from janusgraph_tpu_torch.olap.programs.olap_traversal import (
                build_olap_traversal,
            )

            spec, seed_filters, want_paths, source_as, sack, sack_init = (
                traverse_args
            )
            self._program = build_olap_traversal(
                self.graph, csr, spec, seed_filters=seed_filters,
                record_reach=want_paths, sack=sack, sack_init=sack_init,
            )
        sp.annotate(program=type(self._program).__name__)
        ex_kw, run_kw = self._executor_kwargs()
        # the executor is cached on the snapshot (over its current base):
        # the next submit reuses its device packs and captured graphs
        ex = _executor(csr, self.device, delta_view, delta_snap, ex_kw)
        states = ex.run(self._program, **run_kw)
        if delta_view is not None:
            # a fused run covers [base ++ new vertices] with removed slots
            # inert: compact to the live vertex set, so value()/by_vertex()/
            # write_back see exactly the live graph
            states, csr = _delta.compact_result(delta_view, states)
        if delta_snap is not None:
            # compaction is off the superstep path: after the run
            if delta_snap.maybe_compact():
                snapshot["compacted"] = dict(delta_snap.last_compaction)
        routing = {
            "requested": self.executor_kind,
            "routed": self.executor_kind,
            "reason": "single device" if self.executor_kind == "tpu" else "explicit",
            "executor": self.executor_kind,
            "device": str(self.device),
        }
        registry.record_run("olap.routing", routing)
        run_info = dict(registry.last_run("olap") or {})
        run_info["routing"] = routing
        run_info["snapshot"] = snapshot
        memory = {}
        if self._map_reduces:
            from janusgraph_tpu_torch.olap.mapreduce import run_map_reduce

            for mr in self._map_reduces:
                with tracer.span("olap.map_reduce", job=type(mr).__name__, key=mr.memory_key):
                    memory[mr.memory_key] = run_map_reduce(mr, states, csr)
        return ComputerResult(
            states=states, csr=csr, graph=self.graph, memory=memory,
            run_info=run_info, program=self._program,
            source_as=traverse_args[3] if traverse_args is not None else None,
        )


def _executor(csr, device, delta, executor_cache, ctor_kwargs) -> GPUExecutor:
    """A ``GPUExecutor`` over ``csr`` on ``device`` with ``delta``: the one
    ``executor_cache`` (a ``DeltaSnapshot``) holds for these constructor
    arguments, with its overlay swapped by ``set_delta``, or a new one
    (stored there)."""
    device = resolve_device(device)
    key = ("gpu", str(device)) + tuple(sorted(ctor_kwargs.items()))
    ex = executor_cache.cached_executor(key) if executor_cache is not None else None
    if ex is None:
        ex = GPUExecutor(csr, device=device, delta=delta, **ctor_kwargs)
        if executor_cache is not None:
            executor_cache.store_executor(key, ex, csr)
    else:
        ex.set_delta(delta)
    return ex


def write_back(graph, csr: CSRGraph, result: Dict[str, np.ndarray], keys=None,
               batch: int = 10_000) -> None:
    """Persist compute-key arrays as vertex properties: SINGLE-cardinality
    float keys as raw property cells (one cell per vertex, batched backend
    transactions, relation ids drawn in spans), every other key through
    batched OLTP transactions (``v.property(name, float(value))``, so the
    key's cardinality and type checks apply, and the commit maintains the
    indexes that cover the key); keys that do not exist yet are made as
    float keys first."""
    from janusgraph_tpu_torch.core.codecs import Cardinality

    mgmt = graph.management()
    names = list(result.keys() if keys is None else keys)
    for name in names:
        if graph.schema_cache.get_by_name(name) is None:
            mgmt.make_property_key(name, float)
    vids = csr.vertex_ids
    for name in names:
        pk = graph.schema_cache.get_by_name(name)
        indexed = any(pk.id in idx.key_ids for idx in graph.indexes.values())
        if indexed or pk.cardinality != Cardinality.SINGLE or pk.data_type is not float:
            # tx path: index maintenance and schema type checks stay enforced
            _write_back_tx(graph, vids, name, result[name], batch)
            continue
        _write_back_columnar(graph, vids, pk, result[name], batch)


def _write_back_tx(graph, vids, name, values, batch: int) -> None:
    values = np.asarray(values, dtype=np.float64)
    for lo in range(0, len(vids), batch):
        tx = graph.new_transaction(read_only=False)
        for i in range(lo, min(lo + batch, len(vids))):
            v = tx.get_vertex(int(vids[i]))
            if v is not None:
                v.property(name, float(values[i]))
        tx.commit()


def _write_back_columnar(graph, vids, pk, values, batch: int) -> None:
    if len(vids) == 0:
        return
    values = np.asarray(values, dtype=np.float64)
    es = graph.edge_serializer
    idm = graph.idm
    n = len(vids)
    spans = graph.id_assigner.assign_relation_ids(n)
    rel_ids = np.concatenate(
        [np.arange(s, s + ln, dtype=np.int64) for s, ln in spans]
    )
    # the cell layout comes from the codec: render a probe cell and check
    # that only the relation id and the float payload vary, then fill those
    # two fields vectorized
    probe_rel, probe_val = 1, 0.0
    col, probe_cell = es.write_property(pk.id, probe_rel, probe_val)
    mid = struct.pack(">H", graph.serializer.serializer_for(0.0).type_id)
    if probe_cell != struct.pack(">Q", probe_rel) + mid + struct.pack(">d", probe_val):
        raise RuntimeError("the property cell layout changed under write_back")
    keys = idm.get_keys_array(vids)
    rel_raw = rel_ids.astype(">u8").tobytes()
    val_raw = values.astype(">f8").tobytes()
    for lo in range(0, n, batch):
        hi = min(lo + batch, n)
        btx = graph.backend.begin_transaction()
        for i in range(lo, hi):
            val = (
                rel_raw[8 * i : 8 * i + 8]
                + mid
                + val_raw[8 * i : 8 * i + 8]
            )
            btx.mutate_edges(keys[i], [(col, val)], [])
        btx.commit()


def run_on(
    csr: CSRGraph,
    program: VertexProgram,
    strategy: str = "segsum",
    device=None,
    frontier: str = "auto",
    sync_every: int = 1,
    checkpoint_every: int = 0,
    checkpoint_path: str = None,
    fault_hook=None,
    resume_attempts: int = 3,
    autotune: bool = None,
    hub_cutoff: int = None,
    tail_chunk: int = None,
    autotune_persist: bool = None,
    delta=None,
    executor_cache=None,
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
) -> Dict[str, np.ndarray]:
    """Run ``program`` over ``csr`` on ``device`` (the card by default) and
    return its final state as numpy arrays. ``frontier`` ("auto", "off",
    "always") routes BFS/SSSP/CC through the frontier engine;
    ``sync_every`` is how many supersteps the host loop runs between
    fetches of the aggregators; ``checkpoint_path``/``checkpoint_every``,
    ``fault_hook`` and ``resume_attempts`` checkpoint the run and resume it
    after a ``SuperstepPreempted``; ``delta`` (an ``OverlayView`` of
    ``csr``) runs over the base plus its pending writes; the other
    arguments are the ``GPUExecutor``'s. ``executor_cache`` (a
    ``DeltaSnapshot`` whose base is ``csr``) keeps the executor, keyed by
    its constructor arguments and device, for the next call, which swaps
    its overlay instead of building another. ``features_dim_tier`` and
    ``features_native_matmul`` set a dense program's lane tier and
    ``torch.matmul`` switch (as its own ``dim_tier=``/``native_matmul=``
    do)."""
    ctor_kwargs = dict(
        strategy=strategy, frontier=frontier, autotune=autotune,
        hub_cutoff=hub_cutoff, tail_chunk=tail_chunk,
        autotune_persist=autotune_persist, channel_cache_size=channel_cache_size,
        ell_max_capacity=ell_max_capacity, ell_auto_bytes=ell_auto_bytes,
        ell_auto_pad=ell_auto_pad, frontier_cc_min_edges=frontier_cc_min_edges,
        frontier_f_min=frontier_f_min, frontier_e_min=frontier_e_min,
        frontier_tier_growth=frontier_tier_growth, autotune_min_gain=autotune_min_gain,
        autotune_max_tiers=autotune_max_tiers, features_dim_tier=features_dim_tier,
        features_native_matmul=features_native_matmul,
    )
    ex = _executor(csr, device, delta, executor_cache, ctor_kwargs)
    return ex.run(
        program, sync_every=sync_every, checkpoint_every=checkpoint_every,
        checkpoint_path=checkpoint_path, fault_hook=fault_hook,
        resume_attempts=resume_attempts,
    )
