#!/usr/bin/env python3
"""Drive janusgraph_tpu_torch on a CUDA card and hold its kernels to their
plain versions.

    python3 chip_smoke.py [--scale 20] [--seed 1]

Phases, each printing one JSON line:
  device   the card (and its name and power limit from nvidia-smi)
  build    nvcc builds the kernels from csrc/ (sm_90a)
  graph    the graph500 R-MAT graph from the native host library
           (csrc/graphcsr.cpp, built by g++; the run fails without it),
           the reference bench's draw; the R-MAT draw and build_csr timed
           native against numpy at GRAPH_TIMING_SCALE (build_csr on the
           same arrays, equal)
  kernel   sorted_segment_sum against sorted_segment_sum_plain on the card,
           at the plan shape of the graph500 R-MAT graph's in-CSR and on
           edge cases; bitwise repeat; kernel, plain and library times, each
           with the L2 flushed before every call (the kernel also back to
           back, ``kernel_ms_warm``, and after a flush that leaves the L2
           clean, ``kernel_ms_read_flush``)
  pagerank PageRank, 20 supersteps, tol=0, through run_on(strategy=
           "segsum") (the fused path): the card must run the kernel once a
           superstep, counted by the kernel's device counter; the host
           loop (fused=False) timed beside the plain-torch ELL strategy,
           which it must agree with
  profile  torch.profiler over one more host-loop PageRank run: device
           busy time against wall, and device time by kernel
  autotune the tuner's decisions for the directed and undirected views on
           this card (twice, equal), and the calibration behind its "gpu"
           constants: ELL, hybrid at two cutoffs and segment aggregates
  hybrid   hybrid_aggregate bitwise equal to ell_aggregate (SUM, MIN;
           scalar and [n, 64]), its pad ratio, buckets and time against
           ELL and the segsum kernel; PageRank under "hybrid" and "auto"
  fused    the fused loop (CUDA graphs): PageRank under segsum and ELL
           bitwise equal to the host loop, syncs, chunks, capture time,
           walls; fused_profile profiles one more run (20 kernel runs);
           CC against scipy; dense BFS against the frontier run; the 3-hop
           count (3 kernel runs)
  checkpoint  PageRank with checkpoints every 5 supersteps and one
           injected preemption at superstep 12, fused (preempted at the
           next span's start, nothing lost) and on the host loop (steps
           10 and 11 recomputed from the step-10 checkpoint): each
           auto-resumed run bitwise equal to the uninterrupted one
  cc       connected components against scipy: dense ELL (fused) under
           frontier="off" and "auto", and through the frontier engine
           ("always")
  bfs      ShortestPath from the out-degree hub, 4 hops, through the
           frontier engine on the tuned tier ladders: bitwise equal to the
           dense ELL run and to the static ladder's run, equal to scipy's
           BFS within 4 hops; bfs_4hop_wall_s (both ladders),
           pagerank_plus_bfs4_wall_s (host-loop PageRank + static ladder,
           as before the fused loop) and its fused + tuned counterpart;
           then bfs_profile over one more run
  frontier_parts  the frontier hop and its parts (plan, compaction,
           expansion, scatter-min) timed hop by hop against a bytes bound
  paths    track_paths BFS to convergence: predecessors equal the dense
           run's, 1,000 reconstructed paths are real edge chains
  khop     TraversalCount, 3 hops, segsum: one kernel run per hop, counts
           against ELL and the total against a float64 product
  peer_pressure  PeerPressure, 5 rounds, sync_every=5: segsum and segment
           strategies bitwise equal, wall and peak device memory; 2 rounds
           bitwise equal to a numpy count-and-resolve; the [E, 64] message
           gather timed against its bytes bound
  delta    the delta overlay at the reference bench's streaming shape (a
           burst of 0.5 % of the edges, seeded tombstones, lanes capped at
           2^22 cells): the kernel against its plain version on the add
           and tombstone lanes' plans; PageRank fused over base + overlay,
           3 kernel runs a superstep, bitwise equal to the host loop and
           within a relative 1e-4 of the materialized CSR's; CC and a 4-hop hub BFS bitwise equal to the
           materialized CSR's (CC also to scipy's); a vertex overlay through
           compact_result; materialize and the trade against it; the
           "gpu" lane and materialize constants; a set_delta swap
  traversal  the OLAP traversal program at full scale: the bench's
           filtered 3-hop (score > 5 on step 2) under segsum (3 kernel
           runs on the channel's plan) against ELL (rtol 1e-4, bitwise
           below 2^24) and a float64 product; a typed chain over 4 hashed
           edge types (out [0, 1], in [2], both) and a label set that
           matches no edge against float64 products built from the hashed
           types directly (not through channel_edges); sack sum
           and mult (the [n, k] SUM path) bitwise on repeat and against
           float64; the kernel on every channel plan against its plain
           version; the bench's seeded 3-hop paths (real edge chains);
           DegreeCountProgram (1 kernel run, the CSR's degrees); the
           MapReduce jobs over CC and PageRank; the Fulgora analogue's
           edges/s beside the fused PageRank's
  dense    GCN (d = 32, 2 layers) and the attention GCN under ELL and
           hybrid, bitwise equal; GCN under the default segsum (ELL)
           bitwise equal to a repeat, its host loop and ELL; the
           embedding update ELL against hybrid; scale 12 on the card
           bitwise equal to the CPU; tree_matmul against torch.matmul,
           tree_dot and the sddmm aggregates against their bounds
  ldbc     the LDBC SNB SF1-sized proxy (3.2M vertices, 17.3M edges): CC
           against scipy, the bench's filtered 3-hop (creation_day > 1825)
           held as at scale 20; the host build time
  stored   the stored-graph entry point at the reference bench's
           storage-backed size (bench.py:3704-3723): open_graph (the default
           computer.delta on, so every commit feeds the change capture),
           the columnar bulk load of the first 2,000,000 out-edges (label
           "link"), load_csr_snapshot (the written graph, edge for edge),
           graph.compute().program(PageRank(20, tol=0)).submit() on the card
           twice: cold (the store scan) and warm (no scan, the cached
           executor); 20 kernel runs each, bitwise equal to each other and
           to run_on over the loaded CSR, within 1e-4 of float64; CC
           through submit() against scipy, a 3-hop traverse() (3 kernel
           runs) equal to float64 at every vertex below 2^24 paths and
           within 1e-4 above (its write_back and reload run in indexed's
           2^17-vertex step since the sharded phase came)
  stored_local  the same graph in a persistent local directory
           (storage.backend "local", fsync on): the bulk load and close (the
           WAL's bytes); the directory is served by the remote phase below
           (whose 8-loader submit holds the stored size's distributed load);
           then on a 2^LOCAL_SCALE-vertex directory of the same draw (cut
           from the stored size for the time limit): a cold submit through
           8 loader processes (storage.distributed-load-workers; each
           replays the WAL; no probe open: submit() passes the open graph's
           partition count; each worker's replay and scan, the merge), a
           reopen (the replay) and a cold submit through the in-process
           scan, each with its CSR the written graph edge for edge and its
           ranks within 1e-6 relative of float64, 20 kernel runs; one
           transaction of 1,000 edges of a
           LOCK-consistency label against the same on a default label, no
           lock claim left, and the warm submit that reads both (fused,
           overlay 2,000); compact(), the reopen from the snapshot (the
           same cells), drop_graph (no store file left)
  remote   the remote store at the stored size, inside stored_local:
           `python -m janusgraph_tpu_torch storage-server --directory DIR`
           in its own process (its open, the replay, timed to its address
           line), then over storage.backend "remote" a cold submit through
           the in-process scan and one through 8 loader processes (each
           worker's open, scan, first partition and the merge), each with
           its CSR equal to the stored phase's as sets of vertex ids and
           edges, its ranks bitwise equal to that phase's where the arrays
           are (else within 1e-6 relative) and within 1e-6 relative of
           float64 (20 kernel runs); a 1,000-edge transaction over the
           wire and the warm fused submit (60 kernel runs) within RANK_REL
           of PageRank over a fresh scan over the wire (whose edges are the
           base's plus the commit's); a multi-slice read of 10,000
           vertices' rows and POINT_READS point reads from 8 threads with
           storage.remote.pipeline off, on, on and off, equal (walls and the
           pipeline's ops, wire frames and merged ops); the kernel against
           its plain version on the phase's in-plan; the server stopped
           (an early exit, or one that outlives SIGTERM, fails the run);
           the phase must end within REMOTE_BUDGET_S
  sharded  the same draw on storage.backend "sharded" (SHARDED_NODES
           in-memory nodes) with the seeded fault injector on
           (SHARDED_FAULTS: 1 % read and write faults, a superstep
           preemption, checkpoints every 2 supersteps): the columnar bulk
           load, a cold submit on the card through the unordered scan,
           preempted once and resumed once from its checkpoint (20 kernel
           runs plus any superstep the resume recomputed), its ranks
           bitwise equal to a fault-free run_on over its own CSR and held
           to the stored phase's (bitwise where the arrays are equal, else
           within RANK_REL of its ranks and of float64); the kernel against
           its plain version on its in-plan, timed with the L2 flushed; a
           batch of 2,000 rows read through a SHARDED_OUTAGE_S outage of
           node 1 (the retry guard replays it) and again after, equal; the
           journal by kind
  sharded_olap  the sharded BSP executor (parallel/sharded.py) on 8 slots
           of the one card (Mesh([cuda:0] * 8): every exchange runs there
           as copies, transposes and rolls; nothing crosses between
           cards): (a) at scale 14, PageRank (10 supersteps) under every
           exchange x aggregation pair within RANK_REL of the single-device
           segsum run and of float64, with its superstep ms and exchange
           elements, bytes and batches, and one blocked superstep of SUM
           and MIN against halo.replay_superstep (bitwise but the segment
           form's SUM, float atomics, within RANK_REL); (b) at the main
           scale under exchange "auto" and "blocked": each host plan's
           seconds and the shard-measure probe's, PageRank (20) fused
           bitwise equal to the host loop and within RANK_REL of the main
           run, CC (its undirected plans timed apart) equal to scipy's,
           the hub's 4-hop BFS through the sharded frontier equal to
           scipy's, the skew report; (c) a shard preemption at superstep
           4, resumed from the shard checkpoint, bitwise; (d)
           graph.compute(executor="sharded") on the stored graph (one slot)
           within RANK_REL of its single-device submit. The sharded path
           runs no hand kernel: the segment-sum kernel's device counter
           must not move across it
  multiprocess_olap  two processes on the one card, each with 4 slots of
           cuda:0, form one 8-slot mesh over torch.distributed (gloo; every
           block between them staged through pinned host memory): each
           draws the main run's graph, pins the layout sharded_olap (b)
           chose under "auto" (agg "ell"), and runs PageRank (20) on the
           host loop and fused (eager chunks: no collective between
           processes is captured), CC and the hub's 4-hop BFS through the
           sharded frontier; both processes' arrays bitwise equal to each
           other and to sharded_olap's single-process 8-slot run of that
           layout, the fused ranks to the host loop's, CC and the BFS to
           scipy's; the segment-sum kernel's counter does not move in
           either; init_process_group and plan seconds per process,
           superstep ms, transport bytes and ms a superstep
  stored_delta  the same graph, written on: (a) one OLTP transaction of
           ~2,000 edge adds, ~500 edge removals, a new vertex with an edge
           and a removed vertex, then PageRank and CC through submit() on
           the "fused" path (3 kernel runs a superstep); (b) the ranks
           within 1e-4 of run_on over a fresh scan and bitwise equal to a
           fresh executor over the same overlay, CC bitwise equal to the
           scan's and to scipy's; (c) the kernel against its plain version
           on the add and tombstone lanes' plans; (d) a bulk burst of 0.5 %
           of the edges, past computer.delta-max-overlay: the next submit
           takes the "refresh" path (materialize, zero store reads; 20
           kernel runs), its base array-equal to a fresh scan and its ranks
           bitwise equal to run_on over it; (e) refresh_csr against the
           same scan; the walls of every submit and write
  oltp     the Gremlin entry point on the same store, reopened with
           computer.spillover as two replicas of a serving fleet
           (server/fleet.py, as the ``fleet`` subcommand builds one): r0's
           snapshot exported at 4 shards (export_snapshot; its acquire is
           r0's cold scan) and r1 warmed from the files (warm_replica, zero
           edgestore reads); each a JanusGraphServer (r0 with admission,
           the metric history, SLOs, the sampling profiler and the
           watchdog, r1 with admission only; a 900 s deadline) with a
           gossip agent, behind a FleetRouter with its probe loop and a
           FleetFrontend: g.V().pageRank().order().by('pagerank',
           reverse=True).limit(10).project('id', 'pagerank') sent through
           the driver's JanusGraphClient to the frontend with the deadline
           (one fleet.route attempt; the replica that served it; its
           submit counted at one kernel run a superstep: 20 iterations at
           most, fewer where tol=1e-9 stops it; the ids and the ranks,
           after the GraphSON double, bitwise equal a direct submit's,
           within 1e-4 of float64; the replica's /healthz "ok" with
           nothing shed, the frontend's "ok" with both serving); r1's
           direct submit after the warm-up (20 kernel runs, the "warm"
           path, zero edgestore reads) bitwise equal to r0's, with the
           export's and warm-up's times and bytes; one FleetFederation
           tick over both replicas and its incident timeline (both lanes,
           r1's warm-up event; the Chrome trace validates); then the
           frontend, the probe loop, the gossip agents and r1 stop (their
           threads checked), and on r0 alone: the brownout gate (the
           ladder at rung 2 refuses a submit with no kernel run),
           connected_component() on 16 seeds against scipy,
           shortest_path(max_hops=4) from the out-degree hub (one path per
           vertex it reaches) against a scipy BFS; then the
           spillover of g.V(seeds).out('link').out('link').out('link')
           .count() (seeds drawn from --seed until scipy counts ~60,000
           paths): walked computer.spillover-min-seen times, spilled cold
           (the snapshot pack) and warm, 3 kernel runs each and equal to the
           walk, its dedup().count() and id_() variants equal to their walks,
           a spill inside a transaction of ~100 edge writes (the patched
           snapshot) equal to that transaction's walk, and a spill after the
           commit through a delta refresh equal to a fresh walk; every
           olap.spillover.fallback counter 0; last, a WebSocket session of
           the driver on r0 adds one "link" edge between two stored
           vertices, invisible to a sessionless read until its g.commit(),
           and r0 stops with its sampler, history and watchdog threads
  logs     the durable logs on the same store: two instances (one with the
           durable CDC log, storage.cdc.dir), tx.log-tx on through
           management().set_config, open_instances(); 1,000-edge commits
           with the WAL off (2) and on (10, with a user log whose processor
           must see all 10,000 edge additions; the txlog's four markers for
           each); a CDC follower bootstrapped from the snapshot's 4-shard
           CSR checkpoint pulls the CDC log from the snapshot's cursor and
           folds it (DeltaOverlay.from_batches + materialize), array-equal
           to a fresh load_csr, PageRank over it (20 kernel runs) bitwise
           equal to PageRank over the scan, the instance it serves
           submitting over its adopted snapshot (20 kernel runs, zero
           edgestore reads, bitwise equal), promote() and its flight
           events, the kernel against its plain version on its in-plan; a torn commit of 1,000 edges (half its rows
           flushed), rolled forward by a third instance's open, every edge
           read back, a second recovery that finds nothing, that instance's
           submit (20 kernel runs, a fresh scan) bitwise equal to run_on
           over a fresh load_csr; a schema eviction acknowledged by every
           open instance; every time with the card's name and power limit
  indexed  the same store reopened with the slice cache off: a
           vertex-centric "link" index by time and a transaction of 1,000
           timed edges, the warm submit through the change capture
           ("refresh") and a cold submit through a fresh scan (20 kernel
           runs each, m + 1,000 edges, equal edges, ranks within 1e-4 of
           each other and of float64), the kernel against its plain
           version on their in-plan; the relation index's reindex and a
           sort range equal to has('time', between) and to a filter; then
           on a 2^16-vertex load of the same draw: the ranks' columnar
           write_back and a reload bit for bit, a mixed index over every
           vertex's rank on a RemoteIndexServer over memindex in its own
           process (index.search.backend "remote"; the server must not
           import torch) built through the scan framework over the wire,
           the top-1,000 range query planned "mixed-index" equal to the
           snapshot's top 1,000 (the build at the stored size was cut for
           the remote phase, the row walk for the io phase), the indexed
           write-back (transactional, the index follows) beside a columnar
           one, and the mixed index's reindex
  gods     the Graph of the Gods (BASELINE.json config 1): PageRank through
           submit() (20 kernel runs) within 1e-6 of float64, the kernel on
           its in-plan, has('name', 'hercules') planned "composite-index",
           a duplicate name refused, and both spellings of the pageRank()
           top 3 served by the query server, equal to each other and to the
           submit's
  io       every datatype and graph I/O: a typed R-MAT graph (scale 12,
           edge factor 8) written through transactions, every vertex with
           one property of each datatype GraphSON round-trips, an Int and
           a Float column, every edge a Float weight; load_csr's weights
           bit for bit and its object columns, PageRank through submit()
           (20 kernel runs), weighted SSSP from the out-degree hub against
           scipy's Dijkstra (relative 1e-5, a quarter of the graph reached), a
           filtered OLAP traversal over the Int column (1 kernel run, the
           mask equal to numpy's); export_graphson and import_graphson
           into a graph that declares the Float and Int keys Double and
           Long first: every vertex equal through its name, the weights
           bit for bit, PageRank (20 kernel runs) within RANK_REL under the
           id map (the import numbers the vertices in the export's row-key
           order, so its sums run in another order); a GraphML round trip at scale 12 and its submit; the
           g.io() and graph.io() spellings; the kernel against its plain
           version on the three in-plans
  graphlint  the port's static analyzer (janusgraph_tpu_torch/analysis/) on
           the card's machine: the import sweep over every module of the
           package (any finding fails the run); then a fused PageRank (20
           supersteps) on a fresh GPUExecutor over a scale-14 R-MAT graph
           with a sys.setprofile hook active only inside each
           torch.cuda.graph block: every package def entered during the
           captures must lie in the analyzer's capture reach (run in a
           child process meanwhile); the ranks against the host loop's
           within RANK_REL; the module, finding, entered and reach counts,
           any def missed, and the seconds
  parity   the port's last host modules: a scale-14 R-MAT graph opened with
           the eight options the port once refused set off their defaults
           (PARITY_OPTIONS), metrics.enabled on and the slice cache off,
           bulk-loaded; PageRank through submit() twice (20 kernel runs
           each) within RANK_REL of float64, the kernel against its plain
           version on the graph's in-plan; the out-edges of the top 1,000
           vertices read through tx.prefetch in batches of PARITY_BATCH:
           the store-level getSliceMulti count one a batch and getSlice 0;
           two stage dicts of the submits' walls through the benchdiff
           subcommand (its verdict and exit code); within PARITY_BUDGET_S
  north_star  the north-star rung, graph500 R-MAT scale 23 (2^23 vertices,
           2^27 edges; BASELINE.json's "graph500-s23 PageRank + 4-hop
           BFS"): the native draw and build (north_star_graph); the kernel
           against its plain version and a float64 bincount on that graph's
           in-plan, timed flushed and back to back beside the plain version
           and torch.segment_reduce (kernel, case rmat_s23); PageRank (20
           supersteps, tol 0) through run_on (20 kernel runs counted) and on
           a kept executor, host loop and fused, one warm and 3 timed runs
           each, fused bitwise equal to the host loop and to run_on, within
           RANK_REL of a float64 PageRank over a scipy CSR matrix, one
           profiled run of each path (device idle share, top kernels)
           (north_star_pagerank); the out-degree hub's 4-hop BFS on the
           tuned and the static ladder, 3 timed runs each, equal to a numpy
           level-synchronous BFS and to run_on's, with both end-to-end sums
           (north_star_bfs); the device peak, the host peak RSS and the
           seconds (north_star). It leaves the allocator as it found it;
           it runs last, so that no phase's time depends on what its
           20 GB host peak leaves behind
  telemetry  the run records every run above published (the executor's
           _finish_run wrapped to time its host ms and to read the
           allocator just after): every record's roofline utilization in
           [0, 1.05], device_memory within 1 MiB of
           torch.cuda.memory_allocated(); for the fused PageRank (first
           and warm), the host-loop PageRank, the tuned BFS, a GCN layer, the delta PageRank and the
           cold and warm stored submits: supersteps, records (one per
           superstep on the dense paths), the utilization range,
           roofline_by_tier, mxu, device_memory, compile_cache and the
           publication's host ms; each submit's run_info is
           registry.last_run("olap") plus its routing; the chrome trace of
           each and the registry's Prometheus text validate
Each phase that drives a path zeroes the kernel launch counts just before
it and reads them just after. The wrapper counts its eager launches; the
fix-up kernel adds one to a device counter at every run, eager or replayed
from a CUDA graph, which is the count the checks hold (the calls each
replayed graph captured are the cross-check). Then the ``kernels`` line,
and last ``{"ok": true, "device": ...}``.
Exits non-zero, without the last line, if there is no CUDA card or any
check fails.
"""

from __future__ import annotations

import argparse
import gc
import json
import subprocess
import sys
import time

import numpy as np

#: H100 SXM published peaks (NVIDIA data sheet): HBM3 bytes/s, fp32 FLOP/s
#: outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOPS = 67e12
TOL = dict(rtol=1e-4, atol=1e-4)
#: the most relative difference two float32 PageRank runs that sum in other
#: orders may show (ranks are positive: every vertex keeps its teleport share)
RANK_REL = 1e-4
#: the graph500 scale of the indexed phase's write-back graph (its own
#: stored-size load of the R-MAT draw, cut from scale 20 to fit the time
#: limit, and from 17 to make room for the multiprocess_olap phase)
WRITE_BACK_SCALE = 16
#: the scale of stored_local's second directory (the replay, the
#: in-process submit, the LOCK commits, compact() and the snapshot reopen),
#: cut from scale 20 to make room for the sharded phase
LOCAL_SCALE = 17
#: the io phase's typed graph: R-MAT scale and edge factor 8 (4,096
#: vertices, 32,768 edges; the phase took 57-87 s of host time beside an
#: H100 at scale 14 and 47 s at scale 13, cut to make room for the sharded
#: phase; the SSSP from the hub reaches 1,271 of 4,096, past the quarter
#: it must), its GraphML graph's scale, the transactions' batch sizes, and
#: the relative tolerance of float32 SSSP against scipy's float64 Dijkstra
#: over the same float32 weights
IO_SCALE = 12
IO_GRAPHML_SCALE = 12
IO_VERTEX_BATCH = 4096
IO_EDGE_BATCH = 16384
IO_IMPORT_BATCH = 10000
SSSP_RTOL = 1e-5
#: the scale at which the graph phase times the numpy R-MAT draw and
#: build_csr against the native ones (cut from the main scale, where the
#: numpy pair took 15 s, to make room for the north-star phase)
GRAPH_TIMING_SCALE = 18


class Telemetry:
    """The run records the executor publishes, held as they appear: wraps
    ``GPUExecutor._finish_run`` to time its host ms and read the allocator
    just after it. Every record of every run is held to a roofline
    utilization in [0, 1.05] and its ``device_memory`` (where read from the
    card) to ``torch.cuda.memory_allocated()`` within 1 MiB; a ``label``
    set before a run names it for the telemetry phase."""

    def __init__(self):
        self.label = None
        self.runs = {}
        self.failures = []
        self.checked = 0
        self.publish_ms = []

    def install(self) -> None:
        import torch

        from janusgraph_tpu_torch.olap.gpu_executor import GPUExecutor

        publish = GPUExecutor._finish_run
        tel = self

        def timed(ex, *args, **kw):
            # no cyclic collection between the record's read of the
            # allocator and this one: it may free a dropped object's tensors
            collecting = gc.isenabled()
            gc.disable()
            try:
                t0 = time.perf_counter()
                publish(ex, *args, **kw)
                ms = (time.perf_counter() - t0) * 1e3
                allocated = torch.cuda.memory_allocated()
            finally:
                if collecting:
                    gc.enable()
            tel.seen(ex.last_run_info, ms, allocated)

        GPUExecutor._finish_run = timed

    def seen(self, info: dict, ms: float, allocated: int) -> None:
        self.checked += 1
        self.publish_ms.append(ms)
        utils = [r["roofline_utilization"] for r in info["superstep_records"]
                 if r.get("roofline_utilization") is not None]
        bad = [u for u in utils if not 0.0 <= u <= 1.05]
        if bad:
            self.failures.append(f"{info['path']} run {self.checked}: roofline utilization "
                                 f"{bad} outside [0, 1.05]")
        mem = info["device_memory"]
        if mem["source"] == "device" and abs(mem["bytes_in_use"] - allocated) > 1 << 20:
            self.failures.append(f"{info['path']} run {self.checked}: device_memory {mem} "
                                 f"against memory_allocated() {allocated}")
        if self.label is not None:
            self.runs[self.label] = {
                "info": info, "publish_ms": ms, "allocated": allocated,
                "utilization": [min(utils), max(utils)] if utils else None,
            }
            self.label = None

    def hold_submit(self, res) -> None:
        """A submit's run_info is the registry's record plus its routing
        (and the port's snapshot path)."""
        from janusgraph_tpu_torch.observability import registry

        own = {k: v for k, v in res.run_info.items() if k not in ("routing", "snapshot")}
        if own != registry.last_run("olap"):
            self.failures.append("a submit's run_info is not registry.last_run('olap')")
        if registry.last_run("olap.routing") != res.run_info["routing"]:
            self.failures.append("a submit's routing is not registry.last_run('olap.routing')")


TEL = Telemetry()


def telemetry_phase(emit) -> None:
    """Print each labelled run's telemetry and fail on any record that broke
    the bounds, any dense run whose records do not cover its supersteps, or
    a rendering that does not validate."""
    from janusgraph_tpu_torch.observability import prometheus_text, registry
    from janusgraph_tpu_torch.observability.exposition import validate_prometheus_text
    from janusgraph_tpu_torch.observability.timeline import chrome_trace, validate_chrome_trace

    want = ("pagerank_fused", "pagerank_fused_warm", "pagerank_host_loop", "bfs_tuned", "gcn_layer",
            "delta_pagerank", "stored_cold", "stored_warm")
    failures = list(TEL.failures)
    paths = {}
    for label in want:
        run = TEL.runs.get(label)
        if run is None:
            failures.append(f"{label}: no run was published")
            continue
        info = run["info"]
        records = info["superstep_records"]
        if info["path"] != "frontier" and len(records) != info["supersteps"]:
            failures.append(f"{label}: {len(records)} records for {info['supersteps']} supersteps")
        err = validate_chrome_trace(chrome_trace(info))
        if err is not None:
            failures.append(f"{label}: chrome trace: {err}")
        paths[label] = {
            "path": info["path"], "supersteps": info["supersteps"], "records": len(records),
            "roofline_utilization_min_max": run["utilization"],
            "roofline_by_tier": info["roofline_by_tier"], "mxu": info.get("mxu"),
            "device_memory": info["device_memory"], "memory_allocated": run["allocated"],
            "compile_cache": info["compile_cache"], "retraces": info["retraces"],
            "h2d_arg_bytes": info["h2d_arg_bytes"], "wall_s": info["wall_s"],
            "finish_run_host_ms": run["publish_ms"],
            "superstep_wall_ms": [r.get("wall_ms") for r in records[:4]],
        }
    err = validate_prometheus_text(prometheus_text(registry))
    if err is not None:
        failures.append(f"prometheus text: {err}")
    emit("telemetry", runs_checked=TEL.checked, paths=paths,
         finish_run_host_ms_max=max(TEL.publish_ms),
         finish_run_host_ms_median=float(np.median(TEL.publish_ms)),
         olap_runs=registry.get_count("olap.runs"), failures=failures)
    if failures:
        raise RuntimeError(f"telemetry: {failures}")


GRAPHLINT_SCALE = 14

#: the child that computes the capture reach beside the sweep and the run
#: (stdlib only, so it costs the card nothing): prints its JSON last
GRAPHLINT_CHILD = r"""
import json, sys, time
t0 = time.perf_counter()
from janusgraph_tpu_torch.analysis import capture_reach
reach = capture_reach([sys.argv[1]])
print(json.dumps({"reach": reach, "seconds": time.perf_counter() - t0}))
"""


def graphlint_phase(args, emit) -> dict:
    """The import sweep over the package, and the capture-context
    cross-check: the defs a real CUDA-graph capture enters against the
    analyzer's capture reach."""
    import os

    import torch

    import janusgraph_tpu_torch
    from janusgraph_tpu_torch.analysis.core import discover_files
    from janusgraph_tpu_torch.analysis.imports_check import check_imports
    from janusgraph_tpu_torch.analysis.tracing import CaptureProbe
    from janusgraph_tpu_torch.olap import GPUExecutor, rmat_csr
    from janusgraph_tpu_torch.olap.programs import PageRankProgram

    t0 = time.perf_counter()
    pkg = os.path.dirname(os.path.abspath(janusgraph_tpu_torch.__file__))
    root = os.path.dirname(pkg)
    child = subprocess.Popen(
        [sys.executable, "-c", GRAPHLINT_CHILD, os.path.relpath(pkg, root)],
        cwd=root, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
    )
    try:
        modules = len(discover_files([pkg]))
        s0 = time.perf_counter()
        findings = check_imports([pkg])
        sweep_s = time.perf_counter() - s0
        if findings:
            raise RuntimeError("graphlint import sweep: " + "; ".join(
                f"{f.path}: {f.rule_id} {f.message}" for f in findings))

        probe = CaptureProbe(pkg, cwd=root)
        real_graph = torch.cuda.graph

        class probed_graph:
            """torch.cuda.graph with the probe on inside the block only."""

            def __init__(self, *a, **kw):
                self._inner = real_graph(*a, **kw)

            def __enter__(self):
                out = self._inner.__enter__()
                probe.__enter__()
                return out

            def __exit__(self, *exc):
                probe.__exit__(*exc)
                return self._inner.__exit__(*exc)

        csr = rmat_csr(GRAPHLINT_SCALE, 16, seed=args.seed)
        program = PageRankProgram(max_iterations=20, tol=0.0)
        r0 = time.perf_counter()
        torch.cuda.graph = probed_graph
        try:
            ex = GPUExecutor(csr)
            rank = ex.run(program)["rank"]
        finally:
            torch.cuda.graph = real_graph
        run_s = time.perf_counter() - r0
        info = ex.last_run_info
        if info["path"] != "fused" or not info["capture_s"] > 0:
            raise RuntimeError(f"graphlint: the PageRank did not capture: {info['path']}")
        want = GPUExecutor(csr).run(program, fused=False)["rank"]
        rel = max_rel(rank, want)
        if not (np.isfinite(rank).all() and rel <= RANK_REL):
            raise RuntimeError(f"graphlint: fused ranks {rel} from the host loop's")
        entered = probe.keys()

        out, err = child.communicate(timeout=300)
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()
    if child.returncode != 0:
        raise RuntimeError(f"graphlint: the capture-reach child failed: {err[-2000:]}")
    got = json.loads(out.strip().splitlines()[-1])
    reach = got["reach"]
    missed = sorted(entered - set(reach))
    step = "janusgraph_tpu_torch/olap/gpu_executor.py:_FusedLoop.step"
    emit("graphlint", modules=modules, import_findings=len(findings), sweep_s=sweep_s,
         scale=GRAPHLINT_SCALE, captures=info["compile_cache"], capture_s=info["capture_s"],
         run_s=run_s, max_rel_vs_host_loop=rel, entered=len(entered), reach=len(reach),
         reach_host=sum(1 for r in reach.values() if r == "host"), missed=missed,
         analyzer_s=got["seconds"], seconds=time.perf_counter() - t0,
         entered_defs=sorted(entered))
    if step not in entered:
        raise RuntimeError("graphlint: the probe saw no superstep inside a capture")
    if missed:
        raise RuntimeError(f"graphlint: defs run under a capture that the analyzer "
                           f"missed: {missed}")
    return {"entered": len(entered), "reach": len(reach)}


#: the parity phase's R-MAT scale, and the eight options the port once
#: refused, each set off its default (the id options loose enough that the
#: bulk load never meets them)
PARITY_SCALE = 14
PARITY_OPTIONS = {
    "ids.renew-timeout-ms": 60_000.0,
    "ids.authority.max-retries": 40,
    "query.fast-property": False,
    "storage.batch-loading": True,
    "storage.buffer-size": 512,
    "cache.tx-cache-size": 100,
    "computer.result-mode": "persist",
    "graph.graphname": "parity",
}
#: vertices the prefetched read takes, in batches of query.batch-size
PARITY_PREFETCH = 1_000
PARITY_BATCH = 256
PARITY_BUDGET_S = 15.0


def parity_phase(args, emit) -> dict:
    """The port's last host modules on the card: a graph opened with the
    eight once-refused options off their defaults, ``metrics.enabled`` on
    and the slice cache off (so the metrics store sits right under the
    transaction), bulk-loaded; two PageRank submits (20 kernel runs each)
    and the kernel against its plain version on the graph's in-plan; a
    prefetched read of the top PARITY_PREFETCH vertices' out-edges, one
    store-level getSliceMulti per batch and no getSlice; two stage dicts
    of the submits' walls compared through the ``benchdiff`` subcommand."""
    import contextlib
    import io
    import os
    import tempfile

    import torch

    from janusgraph_tpu_torch import cli
    from janusgraph_tpu_torch.core.bulk import bulk_add_edges, bulk_add_vertices
    from janusgraph_tpu_torch.core.codecs import Direction
    from janusgraph_tpu_torch.core.graph import open_graph
    from janusgraph_tpu_torch.observability import registry
    from janusgraph_tpu_torch.olap import GPUExecutor, kernels, rmat_edges
    from janusgraph_tpu_torch.olap.programs import PageRankProgram

    phase_t0 = time.perf_counter()
    n, src, dst = rmat_edges(PARITY_SCALE, 16, seed=args.seed)
    g = open_graph(dict(PARITY_OPTIONS, **{"metrics.enabled": True, "cache.db-cache": False,
                                           "query.batch-size": PARITY_BATCH}))
    try:
        wrong = {k: g.config.get(k) for k, v in PARITY_OPTIONS.items() if g.config.get(k) != v}
        if wrong or g.backend.id_authority.max_retries != 40 or (
                g.id_assigner.renew_timeout_ms != 60_000.0):
            raise RuntimeError(f"parity: the options did not reach the graph: {wrong}")
        t0 = time.perf_counter()
        vids = bulk_add_vertices(g, n)
        bulk_add_edges(g, "link", vids[src], vids[dst])
        load_s = time.perf_counter() - t0

        walls, run_walls, runs, paths = [], [], [], []
        for _ in range(2):
            kernels.reset_launch_counts()
            t0 = time.perf_counter()
            res, ran = counted(lambda: g.compute().program(
                PageRankProgram(max_iterations=20, tol=0.0)).submit(), 20)
            walls.append(time.perf_counter() - t0)
            run_walls.append(res.run_info["run_wall_s"])
            runs.append(ran)
            paths.append(res.run_info["snapshot"]["path"])
        rank = res.states["rank"]
        if res.run_info["routing"]["device"] != "cuda" or res.csr.num_edges != len(src):
            raise RuntimeError(f"parity submit: {res.run_info['routing']}, "
                               f"{res.csr.num_edges} edges of {len(src)}")
        rel = max_rel(rank, pagerank_fp64(res.csr, 20))
        if not np.isfinite(rank).all() or not rel <= RANK_REL:
            raise RuntimeError(f"parity: ranks {rel} from float64")

        # the kernel against its plain version on this graph's in-plan, at
        # PageRank's messages
        ex = GPUExecutor(res.csr, strategy="segsum")
        in_plan = ex._segsum_plan("in")
        outdeg = torch.as_tensor(res.csr.out_degree, device="cuda").clamp_min(1).float()
        msg = torch.as_tensor(rank, device="cuda") / outdeg
        data = torch.index_select(msg, 0, torch.as_tensor(
            res.csr.in_src.astype(np.int64), device="cuda"))
        _p, _g, err = check_plan("parity_in", in_plan, data, kernels)
        del ex

        # a prefetched read: one multi-slice per batch through the metrics
        # store to the in-memory store's own get_slice_multi
        def count(op):
            return registry.snapshot().get(f"storage.edgestore.{op}", {}).get("count", 0)

        top = res.csr.vertex_ids[np.argsort(-rank.astype(np.float64), kind="stable")[
            :PARITY_PREFETCH]]
        tx = g.new_transaction()
        try:
            vs = [tx.get_vertex(int(v)) for v in top]
            tx.schema_by_name("link")  # the label's schema reads, before the count
            before = {op: count(op) for op in ("getSliceMulti", "getSlice")}
            t0 = time.perf_counter()
            tx.prefetch(vs, Direction.OUT, ["link"])
            prefetch_s = time.perf_counter() - t0
            gained = {op: count(op) - before[op] for op in before}
            out_edges = sum(len(tx.get_edges(v, Direction.OUT, ["link"])) for v in vs)
            after_reads = count("getSlice") - before["getSlice"]
        finally:
            tx.rollback()
        batches = -(-len(vs) // g.config.get("query.batch-size"))
        want_edges = int(res.csr.out_degree[np.searchsorted(res.csr.vertex_ids, top)].sum())
        if gained != {"getSliceMulti": batches, "getSlice": 0} or after_reads or (
                out_edges != want_edges):
            raise RuntimeError(f"parity prefetch: {gained} for {batches} batches, "
                               f"{after_reads} slices after, {out_edges} of {want_edges} edges")

        # two stage dicts of the submits' walls through the benchdiff CLI
        stages = [{"stage": "pagerank", "platform": "gpu", "device_kind": torch.cuda.get_device_name(0),
                   "scale": PARITY_SCALE, "pagerank_wall_s": w,
                   "pagerank_superstep_ms": r / 20 * 1e3, "path": p}
                  for w, r, p in zip(walls, run_walls, paths)]
        with tempfile.TemporaryDirectory() as d:
            old, new = os.path.join(d, "first.json"), os.path.join(d, "second.jsonl")
            with open(old, "w") as f:
                json.dump(stages[0], f)
            with open(new, "w") as f:
                f.write(json.dumps(stages[1]) + "\n")
            out = io.StringIO()
            with contextlib.redirect_stdout(out):
                code = cli.main(["benchdiff", old, new, "--compact"])
        report = json.loads(out.getvalue())
        if code != 0 or report["cells_compared"] != 1:
            raise RuntimeError(f"parity benchdiff: exit {code}, {report}")
        verdict = report["comparisons"][0]["verdict"]
    finally:
        g.close()
    seconds = time.perf_counter() - phase_t0
    emit("parity", scale=PARITY_SCALE, vertices=n, edges=len(src), options=PARITY_OPTIONS,
         load_s=load_s, submit_walls_s=walls, run_walls_s=run_walls, snapshot_paths=paths,
         kernel_runs=runs, max_rel_vs_fp64=rel, in_plan_max_abs_err=err,
         prefetch_vertices=len(vs), prefetch_batches=batches, prefetch_s=prefetch_s,
         store_get_slice_multi=gained["getSliceMulti"], store_get_slice=gained["getSlice"],
         prefetched_edges=out_edges, benchdiff_exit=code, benchdiff_verdict=verdict,
         benchdiff_metrics=report["comparisons"][0]["metrics"], seconds=seconds)
    if seconds > PARITY_BUDGET_S:
        raise RuntimeError(f"parity took {seconds:.1f} s, over its {PARITY_BUDGET_S} s budget")
    return {"launches": runs[0], "launches_warm": runs[1], "max_abs_err": err}


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls: inputs
    that fit the 50 MB L2 may stay there between calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def replay_ms(fn, iters: int = 20) -> float:
    """Mean device time of ``fn`` captured once into a CUDA graph and
    replayed back to back: what a superstep of the fused loop pays for it,
    without the host's launch overhead."""
    import torch

    import gc

    fn()  # everything ``fn`` reads moves to the card before the capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    gc.disable()  # a graph freed by the collector mid-capture would void it
    try:
        with torch.cuda.graph(graph):
            fn()
    finally:
        gc.enable()
    return cuda_ms(graph.replay, iters)


_FLUSH = []


def flush_buffer():
    """The 256 MB buffer ``flushed_ms`` clears, made once per process."""
    import torch

    if not _FLUSH:
        _FLUSH.append(torch.zeros(256 << 20, dtype=torch.uint8, device="cuda"))
    return _FLUSH[0]


def flushed_ms(fn, iters: int = 25, warmup: int = 2, by_reading: bool = False) -> float:
    """Median device time of one call of ``fn``, each call preceded by
    zeroing a 256 MB buffer, which evicts its inputs from the 50 MB L2 and
    leaves it full of dirty lines that ``fn`` then writes back; with
    ``by_reading`` the buffer is summed instead, which leaves clean lines.
    CUDA events bracket ``fn`` alone."""
    import torch

    buf = flush_buffer()
    for _ in range(warmup):
        fn()
    pairs = []
    for _ in range(iters):
        if by_reading:
            buf.sum()
        else:
            buf.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in pairs]))


def check_kernel_case(name, seg, num_segments, data, kernels, **plan_kw):
    """Kernel vs plain on the card at TOL, plus a bitwise repeat."""
    return check_plan(name, kernels.make_segsum_plan(seg, num_segments, **plan_kw), data, kernels)


def check_plan(name, plan, data, kernels):
    """``check_kernel_case`` on a plan already made."""
    import torch

    num_segments = plan.num_segments
    got = kernels.sorted_segment_sum(data, plan)
    again = kernels.sorted_segment_sum(data, plan)
    want = kernels.sorted_segment_sum_plain(data, plan)
    if data.is_cuda:
        torch.cuda.synchronize()
    if got.shape != (num_segments,) or not torch.isfinite(got).all():
        raise RuntimeError(f"kernel case {name}: bad output {tuple(got.shape)}")
    if not torch.equal(got.view(torch.int32), again.view(torch.int32)):
        raise RuntimeError(f"kernel case {name}: two launches differ")
    err = (got - want).abs()
    if not torch.allclose(got, want, **TOL):
        raise RuntimeError(f"kernel case {name}: max abs err {err.max().item()}")
    return plan, got, float(err.max().item()) if err.numel() else 0.0


def counted(fn, expect: int, device="cuda"):
    """Run ``fn`` and count the sorted-segment-sum runs on ``device`` by the
    kernel's device counter (``kernels.device_launches``), which sees the
    runs replayed from CUDA graphs as well as the eager ones; the count
    must be ``expect``. Returns (fn()'s result, the count)."""
    import torch

    from janusgraph_tpu_torch.olap import kernels

    before = kernels.device_launches(device)
    out = fn()
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    ran = kernels.device_launches(device) - before
    if ran != expect:
        raise RuntimeError(f"the kernel counted {ran} runs, expected {expect}")
    return out, ran


def profile_run(ex, program, emit, phase: str = "profile", **run_kw) -> int:
    """One more run under torch.profiler. Every figure comes from this one
    run: device busy time (the sum of kernel and copy time on the card)
    against the run's own wall and against the span from its first device
    event to its last, the device-to-host copies (each one a host sync),
    the segment-sum runs the card did (the kernel's device counter,
    returned), and the top entries by device time. The profiler slows the host, so the idle shares are upper
    bounds; a negative share is measurement error and is printed as it is."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from janusgraph_tpu_torch.olap import kernels

    before = kernels.device_launches("cuda")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        ex.run(program, **run_kw)
        torch.cuda.synchronize()
    runs = kernels.device_launches("cuda") - before
    device_events = [
        e for e in prof.key_averages()
        if e.device_type == torch.autograd.DeviceType.CUDA
    ]
    busy_us = sum(e.self_device_time_total for e in device_events)
    if busy_us <= 0:
        raise RuntimeError("the profiler recorded no device time")
    ranges = [
        e.time_range for e in prof.events()
        if e.device_type == torch.autograd.DeviceType.CUDA
    ]
    span_us = max(r.end for r in ranges) - min(r.start for r in ranges)
    wall_us = ex.last_run_info["wall_s"] * 1e6
    top = sorted(device_events, key=lambda e: -e.self_device_time_total)[:8]
    dtoh = sum(e.count for e in device_events if "DtoH" in e.key)
    emit(phase, wall_ms=wall_us / 1e3, device_busy_ms=busy_us / 1e3,
         device_span_ms=span_us / 1e3,
         device_idle_share=1.0 - busy_us / wall_us,
         device_idle_share_of_span=1.0 - busy_us / span_us,
         supersteps=ex.last_run_info["supersteps"], dtoh_copies=dtoh,
         segsum_kernel_runs=runs,
         by_device_time=[{"name": e.key[:60], "calls": e.count,
                          "device_ms": e.self_device_time_total / 1e3} for e in top])
    return runs


def frontier_parts(ex, seed: int, emit, hops: int = 4) -> None:
    """Replay the 4-hop BFS hop by hop through the engine's public parts
    and time each part on the card (CUDA events, back to back): the
    compaction of the mask, the capped expansion, the relaxation (expansion
    + message + scatter-min), and the whole step; the plan, which ends in
    the hop's one device->host fetch, on the host clock. Each bound counts
    the bytes the part must move at this hop (inputs read once, outputs
    written once) at the card's memory rate."""
    import torch
    from janusgraph_tpu_torch.olap.frontier import capped_expand, compact
    from janusgraph_tpu_torch.olap.vertex_program import INF

    eng = ex.frontier_engine()
    n = eng.n
    fargs = eng.fargs(False, False)
    ip, dst = fargs["out_ip"], fargs["out_dst"]
    is_seed = torch.arange(n, device="cuda") == seed
    dist = torch.where(is_seed, 0.0, torch.full((n,), INF, device="cuda"))
    mask = is_seed
    tmp = torch.full((n + 1,), INF, dtype=torch.float32, device="cuda")
    rows = []
    for t in range(hops):
        count, edges, _ = eng.plan(mask, fargs, False)
        if count == 0:
            break
        f_cap, e_cap = eng.tiers(count, edges)
        h0 = time.perf_counter()
        for _ in range(20):
            eng.plan(mask, fargs, False)
        plan_ms = (time.perf_counter() - h0) / 20 * 1e3
        idx = compact(mask, f_cap, n)
        step = lambda: eng.step(dist, None, mask, t, fargs, f_cap, e_cap, False, False, False)  # noqa: E731
        ms = {
            "compact_ms": cuda_ms(lambda: compact(mask, f_cap, n), 20),
            "expand_ms": cuda_ms(lambda: capped_expand(idx, ip, dst, e_cap, n), 20),
            "relax_ms": cuda_ms(
                lambda: eng.relax(tmp, dist, idx, ip, dst, None, e_cap, False, False), 20
            ),
            "step_ms": cuda_ms(step, 20),
        }
        # int64 offsets and indices (8 B), int32 destinations, a 1-byte mask
        need = {
            "plan": n + 8 * n,                          # mask, degrees
            "compact": n + 8 * f_cap,                   # mask; indices out
            "expand": 8 * f_cap + 16 * count + 4 * edges + 25 * e_cap,
            "relax": 8 * f_cap + 16 * count + 4 * edges + 4 * (n + 1),
            # mask + distances in, the frontier rows' offsets and their
            # edges' destinations, distances + mask out
            "step": (n + 4 * n) * 2 + 16 * count + 4 * edges,
        }
        rows.append({
            "hop": t, "frontier": count, "edges": edges, "F_cap": f_cap, "E_cap": e_cap,
            "plan_host_ms": plan_ms, **ms,
            **{f"{k}_bound_ms": b / PEAK_BYTES_PER_S * 1e3 for k, b in need.items()},
        })
        dist, _, mask = step()
    torch.cuda.synchronize()
    emit("frontier_parts", hops=rows)


def peer_pressure_numpy(csr, rounds: int, K: int = 64) -> np.ndarray:
    """PeerPressure labels after ``rounds`` rounds, in numpy: each edge
    carries a message both ways; a vertex counts its neighbours' label
    buckets (label mod K), takes the fullest bucket (the lowest on a tie),
    then adopts the smallest neighbour label in that bucket; a vertex with
    no neighbours keeps its label."""
    n = csr.num_vertices
    src = np.repeat(np.arange(n, dtype=np.int64), np.diff(csr.out_indptr))
    dst = csr.out_dst.astype(np.int64)
    send, recv = np.concatenate([src, dst]), np.concatenate([dst, src])
    labels = np.arange(n, dtype=np.int64)
    for _ in range(rounds):
        sent = labels[send]
        counts = np.bincount(recv * K + sent % K, minlength=n * K).reshape(n, K)
        chosen = np.argmax(counts, axis=1)
        hit = sent % K == chosen[recv]
        # smallest label per receiver: sort (receiver, label) keys, take
        # each receiver's first
        keys = np.sort(recv[hit] * n + sent[hit])
        rows, first = np.unique(keys // n, return_index=True)
        labels = labels.copy()
        labels[rows] = keys[first] % n
    return labels.astype(np.float32)


def peer_pressure_phase(csr, seg_ex, args, emit) -> None:
    """PeerPressure, 5 rounds, sync_every=5, as the reference's bench runs
    it: the segsum and segment strategies must give the same labels bit for
    bit (counts are small integers, min has no order); wall and peak device
    memory of each; one superstep of each phase and the [E, 64] message
    gather timed alone; and a small graph on the card against the CPU."""
    import torch
    from janusgraph_tpu_torch.olap import GPUExecutor, kernels, rmat_csr, run_on
    from janusgraph_tpu_torch.olap.programs import PeerPressureProgram

    def pp():
        return PeerPressureProgram(rounds=5)

    n, m = csr.num_vertices, csr.num_edges
    runs = {}
    for strategy in ("segsum", "segment"):
        ex = seg_ex if strategy == "segsum" else GPUExecutor(csr, strategy="segment")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        out = ex.run(pp(), sync_every=5)
        wall = time.perf_counter() - t0
        info = dict(ex.last_run_info)
        runs[strategy] = (out["cluster"], {
            "wall_s": wall, "run_wall_s": info["wall_s"], "supersteps": info["supersteps"],
            "strategy_resolved": info["strategy_resolved"],
            "max_memory_allocated": torch.cuda.max_memory_allocated(),
            "kernel_launches": kernels.launch_counts()["sorted_segment_sum"],
        })
    labels = runs["segsum"][0]
    if not np.array_equal(labels.view(np.int32), runs["segment"][0].view(np.int32)):
        raise RuntimeError("PeerPressure labels differ between segsum and segment")
    # the path as a user drives it, counted
    kernels.reset_launch_counts()
    via_run_on = run_on(csr, pp(), sync_every=5)["cluster"]
    run_on_launches = kernels.launch_counts()["sorted_segment_sum"]
    if not np.array_equal(labels.view(np.int32), via_run_on.view(np.int32)):
        raise RuntimeError("run_on's PeerPressure differs from the executor's")
    if labels.shape != (n,) or not np.all((labels >= 0) & (labels < n) & (labels == np.floor(labels))):
        raise RuntimeError("PeerPressure labels are not vertex indices")
    clusters = len(np.unique(labels))
    if not 1 <= clusters < n:
        raise RuntimeError(f"PeerPressure left {clusters} clusters of {n} vertices")
    # two rounds held against numpy, bit for bit
    t0 = time.perf_counter()
    want2 = peer_pressure_numpy(csr, rounds=2)
    numpy_s = time.perf_counter() - t0
    got2 = seg_ex.run(PeerPressureProgram(rounds=2), sync_every=2)["cluster"]
    if not np.array_equal(got2.view(np.int32), want2.view(np.int32)):
        bad = int(np.sum(got2 != want2))
        raise RuntimeError(f"PeerPressure, 2 rounds: {bad} labels differ from numpy's")

    # one superstep of each phase, and the count phase's per-edge gather
    prog = pp()
    state, _ = prog.setup(seg_ex.g)
    count_msg = prog.message(state, 0, seg_ex.g)
    label_msg = prog.message(state, 1, seg_ex.g)
    K = count_msg.shape[1]
    sum_ms = cuda_ms(lambda: seg_ex._aggregate(prog, "sum", count_msg), 3, warmup=1)
    min_ms = cuda_ms(lambda: seg_ex._aggregate(prog, "min", label_msg), 3, warmup=1)
    in_src = seg_ex.g.in_src
    gather_ms = cuda_ms(lambda: torch.index_select(count_msg, 0, in_src), 5, warmup=1)
    # indices and the [E, K] messages once each, the [n, K] table once
    gather_bytes = 4 * m + 4 * K * m + 4 * K * n
    del count_msg, label_msg, state

    small = rmat_csr(10, 16, seed=args.seed)
    on_card = run_on(small, pp(), sync_every=5)["cluster"]
    on_cpu = run_on(small, pp(), device="cpu", sync_every=5)["cluster"]
    if not np.array_equal(on_card.view(np.int32), on_cpu.view(np.int32)):
        raise RuntimeError("PeerPressure on the card differs from the CPU on a scale-10 graph")
    emit("peer_pressure", rounds=5, sync_every=5, clusters=clusters, buckets=K,
         **{s: r[1] for s, r in runs.items()}, run_on_kernel_launches=run_on_launches,
         sum_superstep_ms=sum_ms, min_superstep_ms=min_ms,
         gather_ms=gather_ms, gather_bytes=gather_bytes,
         gather_bound_ms=gather_bytes / PEAK_BYTES_PER_S * 1e3,
         small_graph_equal_to_cpu=True, two_rounds_equal_to_numpy=True,
         two_rounds_changed=int(np.sum(want2 != np.arange(n))), numpy_s=numpy_s)


def max_rel(a, b) -> float:
    """Largest |a - b| / |b| over positive ``b``, in float64."""
    b = np.asarray(b, dtype=np.float64)
    return float(np.max(np.abs(np.asarray(a, dtype=np.float64) - b) / b)) if b.size else 0.0


def bits_equal(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and a.dtype == b.dtype and np.array_equal(
        a.view(np.int32), b.view(np.int32)
    )


def gpu_constants(rows, seg_ms, n, edges) -> dict:
    """The tuner's "gpu" constants from one set of aggregate times: a
    non-negative least-squares fit of t = slots * gather + buckets * bucket
    + chunk_rows * chunk over the ELL and hybrid aggregates of ``rows``
    (each counted as the model counts it), then the segment penalty that
    makes the model give the measured segment aggregate. ``recipe`` is the
    plain reading beside it, over the directed rows: ELL's ms over its
    slots, the segment's ms per edge over that, and the first two hybrid
    packs solved for the rest (it charges ELL's launches twice, once per
    slot and once per bucket)."""
    from scipy.optimize import nnls

    a = np.array([[r["model_slots"], r["buckets"], r["chunk_rows"]] for r in rows], np.float64)
    t = np.array([r["ms"] for r in rows]) * 1e-3
    (gather, bucket, chunk), residual = nnls(a, t)
    seg_bytes = 8.0 * edges + 8.0 * n  # the model's bytes for one slot per edge
    penalty = (seg_ms * 1e-3 - bucket) / max(seg_bytes / PEAK_BYTES_PER_S, edges * gather)
    g0 = t[0] / a[0, 0]
    b0, c0 = np.linalg.solve(a[1:3, 1:], t[1:3] - a[1:3, 0] * g0)
    return {"gather_cost_s": float(gather), "bucket_overhead_s": float(bucket),
            "tail_chunk_cost_s": float(chunk), "segment_penalty": float(penalty),
            "fit_residual_s": float(residual),
            "model_ms": [float(x) * 1e3 for x in a @ np.array([gather, bucket, chunk])],
            "recipe": {"gather_cost_s": float(g0), "segment_penalty": seg_ms * 1e-3 / edges / g0,
                       "bucket_overhead_s": float(b0), "tail_chunk_cost_s": float(c0)}}


def autotune_phase(csr, kind, emit) -> dict:
    """The tuner on this card: decisions for both views (each twice), and
    the measurements its "gpu" constants come from: PageRank-shaped SUM
    aggregates of both views (ELL, and hybrid packs at several cutoffs; the
    segment aggregate, gather + index_add_, of the directed view), each
    captured into a CUDA graph and replayed, as the fused loop runs them
    (the constants in use come from these), and the directed ELL, segment
    and two hybrid packs eagerly, as the host loop runs them (printed
    beside); CUDA events, back to back."""
    import torch
    from janusgraph_tpu_torch.olap import autotune, kernels
    from janusgraph_tpu_torch.olap.gpu_executor import GPUExecutor

    decisions = {}
    for undirected in (False, True):
        stats = autotune.GraphStats.from_csr(csr, undirected=undirected)
        first, again = autotune.decide(stats, kind), autotune.decide(stats, kind)
        if first != again:
            raise RuntimeError("two autotune decisions on the same inputs differ")
        if autotune.device_class(kind) != "gpu":
            raise RuntimeError(f"{kind!r} is not priced as a GPU")
        decisions["undirected" if undirected else "directed"] = first.as_dict()
    n, m = csr.num_vertices, csr.num_edges
    ex = GPUExecutor(csr, strategy="ell")
    gen = torch.Generator(device="cuda").manual_seed(7)
    x = torch.rand(n, generator=gen, device="cuda")
    g = ex.g

    def seg_fn():
        return kernels.segment_combine(
            "sum", torch.index_select(x, 0, g.in_src), g.in_dst_seg, n)

    rows = {"replayed": [], "eager": []}
    for undirected, cutoffs in ((False, (16, 64, 1024)), (True, (8, 64))):
        stats = autotune.GraphStats.from_csr(csr, undirected=undirected)
        ell = ex._ell_pack(undirected)
        view = {"view": "undirected" if undirected else "directed"}
        row = dict(view, layout="ell", model_slots=stats.ell_slots, slots=ell.slots,
                   buckets=len(stats.degree_hist), chunk_rows=0)
        rows["replayed"].append(dict(row, ms=replay_ms(lambda: kernels.ell_aggregate(ell, x, "sum"))))
        if not undirected:
            rows["eager"].append(dict(row, ms=cuda_ms(lambda: kernels.ell_aggregate(ell, x, "sum"), 10)))
        by_cutoff = {c: rest for c, *rest in stats.hybrid_by_cutoff}
        src, dst, w = ex._edge_view(undirected)
        for cutoff in cutoffs:
            pack = kernels.HybridPack(src, dst, w, n, hub_cutoff=cutoff, tail_chunk=256).to("cuda")
            slots, _hubs, buckets, chunk_rows = by_cutoff[cutoff]
            row = dict(view, layout="hybrid", cutoff=cutoff, slots=pack.slots, model_slots=slots,
                       buckets=buckets + autotune.tail_buckets(stats.degree_hist, cutoff),
                       chunk_rows=chunk_rows, torso_buckets=len(pack.torso),
                       tail_buckets=len(pack.tail), pad_ratio=pack.pad_ratio)
            rows["replayed"].append(dict(row, ms=replay_ms(
                lambda: kernels.hybrid_aggregate(pack, x, "sum"), 10)))
            if not undirected and cutoff <= 64:
                rows["eager"].append(dict(row, ms=cuda_ms(
                    lambda: kernels.hybrid_aggregate(pack, x, "sum"), 5)))
            del pack
    seg = {"replayed": replay_ms(seg_fn), "eager": cuda_ms(seg_fn, 10)}
    constants = {mode: gpu_constants(rows[mode], seg[mode], n, m) for mode in rows}
    emit("autotune", decisions=decisions, gpu_constants=constants["replayed"],
         gpu_constants_eager=constants["eager"], edges=m, segment_ms=seg, rows=rows,
         in_use={"gather_cost_s": autotune._GATHER_COST_S["gpu"],
                 "segment_penalty": autotune._SEGMENT_PENALTY["gpu"],
                 "bucket_overhead_s": autotune._BUCKET_OVERHEAD_S["gpu"],
                 "tail_chunk_cost_s": autotune._TAIL_CHUNK_COST_S["gpu"]})
    return decisions


def hybrid_phase(csr, seg_ex, seg_rank, emit) -> None:
    """hybrid_aggregate against ell_aggregate on the card, bit for bit, for
    SUM and MIN, scalar and [n, 64] messages, at the tuner's layout; its
    time against ELL's and against the segsum path (gather + kernel), eager
    and replayed from a CUDA graph; then PageRank (fused, the second run)
    under "hybrid" and "auto" against the segsum ranks."""
    import torch
    from janusgraph_tpu_torch.olap import GPUExecutor, kernels
    from janusgraph_tpu_torch.olap.programs import ConnectedComponentsProgram, PageRankProgram

    n = csr.num_vertices
    ex = GPUExecutor(csr, strategy="hybrid")
    hyb = ex._hybrid_pack(False)
    ell = ex._ell_pack(False)
    gen = torch.Generator(device="cuda").manual_seed(11)
    checks = {}
    for shape in ((n,), (n, 64)):
        x = torch.rand(shape, generator=gen, device="cuda")
        for op in ("sum", "min"):
            a = kernels.ell_aggregate(ell, x, op)
            b = kernels.hybrid_aggregate(hyb, x, op)
            if not torch.equal(a.view(torch.int32), b.view(torch.int32)):
                raise RuntimeError(f"hybrid differs from ELL ({op}, {shape})")
            checks[f"{op}_{'x'.join(map(str, shape))}"] = True
        del x, a, b
    x = torch.rand(n, generator=gen, device="cuda")
    plan = seg_ex._segsum_plan("in")
    in_src = seg_ex.g.in_src
    fns = {
        "hybrid": lambda: kernels.hybrid_aggregate(hyb, x, "sum"),
        "ell": lambda: kernels.ell_aggregate(ell, x, "sum"),
        "segsum_path": lambda: kernels.sorted_segment_sum(torch.index_select(x, 0, in_src), plan),
    }
    times = {f"{k}_ms": cuda_ms(fn, 10) for k, fn in fns.items()}
    times.update({f"{k}_replayed_ms": replay_ms(fn) for k, fn in fns.items()})
    # what the SUM aggregate must move: each edge's source index, each
    # message and each sum once
    times["bound_ms"] = 4 * (csr.num_edges + 2 * n) / PEAK_BYTES_PER_S * 1e3
    runs = {}
    for strategy in ("hybrid", "auto"):
        rex = ex if strategy == "hybrid" else GPUExecutor(csr, strategy="auto")
        rex.run(PageRankProgram(max_iterations=20, tol=0.0))  # warm
        rank = rex.run(PageRankProgram(max_iterations=20, tol=0.0))["rank"]
        info = rex.last_run_info
        rel = float(np.max(np.abs(rank.astype(np.float64) - seg_rank) / np.abs(seg_rank)))
        if rel > 1e-4:
            raise RuntimeError(f"PageRank under {strategy!r}: max rel diff {rel} vs segsum")
        runs[strategy] = {"strategy_resolved": info["strategy_resolved"],
                          "wall_s": info["wall_s"], "path": info["path"],
                          "pad_ratio": info["pad_ratio"], "max_rel_diff_vs_segsum": rel}
    # CC: the undirected view's decision, against ELL (fused, second runs)
    cc = {}
    for strategy in ("auto", "ell"):
        cex = GPUExecutor(csr, strategy=strategy)
        want = cex.run(ConnectedComponentsProgram())["component"]
        got = cex.run(ConnectedComponentsProgram())["component"]
        cc[strategy] = {"wall_s": cex.last_run_info["wall_s"],
                        "strategy_resolved": cex.last_run_info["strategy_resolved"],
                        "decision": cex.last_run_info["autotune"]["strategy"]}
        cc[strategy + "_labels"] = got
        if not bits_equal(got, want):
            raise RuntimeError(f"two CC runs under {strategy!r} differ")
    if not bits_equal(cc.pop("auto_labels"), cc.pop("ell_labels")):
        raise RuntimeError("CC under 'auto' differs from ELL")
    runs["cc"] = cc
    emit("hybrid", bitwise_equal_to_ell=checks, pad_ratio=hyb.pad_ratio,
         ell_pad_ratio=ell.pad_ratio, hub_cutoff=hyb.hub_cutoff, tail_chunk=hyb.tail_chunk,
         torso_buckets=len(hyb.torso), tail_buckets=len(hyb.tail), **times,
         pagerank=runs)


def fused_phase(csr, seg_ex, ell_ex, host_ranks, adj, seed, emit) -> dict:
    """The fused loop on the card: PageRank (20 supersteps, tol 0) fused
    against the host loop under segsum and ELL, bitwise; CC against scipy;
    the dense 4-hop BFS against the frontier run; the 3-hop count."""
    import torch
    from scipy.sparse.csgraph import connected_components
    from janusgraph_tpu_torch.olap import kernels
    from janusgraph_tpu_torch.olap.programs import (
        ConnectedComponentsProgram,
        PageRankProgram,
        ShortestPathProgram,
        TraversalCountProgram,
    )

    def pagerank():
        return PageRankProgram(max_iterations=20, tol=0.0)

    n = csr.num_vertices
    out = {}
    for strategy, ex in (("segsum", seg_ex), ("ell", ell_ex)):
        kernels.reset_launch_counts()
        first = ex.run(pagerank())
        first_info = dict(ex.last_run_info)
        kernels.reset_launch_counts()
        TEL.label = "pagerank_fused_warm" if strategy == "segsum" else None
        rank = ex.run(pagerank())["rank"]
        info = dict(ex.last_run_info)
        launches = kernels.launch_counts()["sorted_segment_sum"]
        if info["path"] != "fused" or info["supersteps"] != 20:
            raise RuntimeError(f"fused PageRank ({strategy}): {info}")
        for got in (first["rank"], rank):
            if not bits_equal(got, host_ranks[strategy]):
                raise RuntimeError(f"fused PageRank differs from the host loop ({strategy})")
        # eager launches (the first run's eager superstep) plus the calls
        # its replayed graphs hold: a cross-check of the device count below
        expect = 20 if strategy == "segsum" else 0
        for run_info in (first_info, info):
            if run_info["kernel_launches"] + run_info["graph_kernel_launches"] != expect:
                raise RuntimeError(f"fused PageRank ({strategy}) launch counts: {run_info}")
        if launches != info["kernel_launches"]:
            raise RuntimeError(f"fused PageRank launched the kernel {launches} times eagerly")
        if info["predicated_steps"] != 0:
            raise RuntimeError(f"a bounded run discarded {info['predicated_steps']} supersteps")
        keep = ("wall_s", "chunks", "host_syncs", "predicated_steps", "capture_s",
                "kernel_launches", "graph_kernel_launches")
        out[strategy] = {**{k: info[k] for k in keep},
                         "superstep_ms": info["wall_s"] / 20 * 1e3,
                         "first_run": {k: first_info[k] for k in keep}}
    fused_runs = profile_run(seg_ex, pagerank(), emit, phase="fused_profile")
    if fused_runs != 20:
        raise RuntimeError(f"the profiled fused PageRank ran the kernel {fused_runs} times")
    out["segsum"]["kernel_runs"] = fused_runs
    # one captured chunk of 8 PageRank supersteps, replayed with its bound
    # at 0 so that every superstep is computed and discarded (the buffers
    # keep the last run's state)
    loop = next(lp for key, lp in seg_ex._fused_loops.items() if "PageRankProgram" in key[0][1])
    graph, captured = loop.graphs[8]
    loop.limit.fill_(0)
    chunk_ms = cuda_ms(graph.replay, 10)
    # per superstep: in_src once (4 B an edge); rank, out-degree, active,
    # the segment offsets and the new rank once (4 B a vertex each)
    chunk_bytes = 8 * (4 * csr.num_edges + 5 * 4 * n)
    out["chunk8"] = {"ms": chunk_ms, "kernel_launches_captured": captured,
                     "bytes": chunk_bytes, "bound_ms": chunk_bytes / PEAK_BYTES_PER_S * 1e3}

    ncomp, labels = connected_components(adj, directed=True, connection="weak")
    lowest = np.full(ncomp, n, dtype=np.int64)
    np.minimum.at(lowest, labels, np.arange(n))
    cc = {}
    for key, kw in (("fused", {}), ("fused_warm", {}), ("host_loop", {"fused": False})):
        comp = seg_ex.run(ConnectedComponentsProgram(), **kw)["component"]
        info = dict(seg_ex.last_run_info)
        if not np.array_equal(comp.astype(np.int64), lowest[labels]):
            raise RuntimeError(f"CC ({key}) differs from scipy's components")
        cc[key] = {k: info.get(k) for k in ("path", "supersteps", "wall_s", "chunks",
                                              "host_syncs", "predicated_steps")}
    if cc["fused"]["path"] != "fused" or cc["host_loop"]["path"] != "host-loop":
        raise RuntimeError(f"CC paths: {cc}")

    def bfs4():
        return ShortestPathProgram(seed_index=seed, max_iterations=4)

    frontier = seg_ex.run(bfs4())["distance"]
    dense = seg_ex.run(bfs4(), frontier="off")["distance"]
    bfs_info = dict(seg_ex.last_run_info)
    if bfs_info["path"] != "fused" or not bits_equal(dense, frontier):
        raise RuntimeError(f"dense fused BFS differs from the frontier run: {bfs_info}")

    host = seg_ex.run(TraversalCountProgram(hops=3), fused=False)["count"]
    counts, khop_runs = counted(lambda: seg_ex.run(TraversalCountProgram(hops=3))["count"], 3)
    khop = dict(seg_ex.last_run_info, kernel_runs=khop_runs)
    if (khop["path"] != "fused"
            or khop["kernel_launches"] + khop["graph_kernel_launches"] != 3
            or not bits_equal(counts, host)):
        raise RuntimeError(f"fused 3-hop count: {khop}")
    emit("fused", max_chunk=seg_ex.MAX_CHUNK, pagerank=out, cc=cc,
         dense_bfs={k: bfs_info[k] for k in ("wall_s", "supersteps", "chunks", "host_syncs",
                                              "predicated_steps")},
         khop={k: khop[k] for k in ("wall_s", "kernel_launches", "graph_kernel_launches",
                                    "kernel_runs", "chunks", "host_syncs")})
    return out


def checkpoint_phase(csr, want_rank, emit) -> None:
    """PageRank with a checkpoint every 5 supersteps and one injected
    preemption at superstep 12 or later, fused and on the host loop: each
    run resumes from its last checkpoint and must end bitwise equal to the
    uninterrupted run. The fused path consults the hook at span starts
    only, so it is preempted at 15, after that span's checkpoint, and
    recomputes nothing; the host loop is preempted at 12 and recomputes
    supersteps 10 and 11 from the step-10 checkpoint."""
    import os
    import tempfile

    from janusgraph_tpu_torch.exceptions import SuperstepPreempted
    from janusgraph_tpu_torch.olap import GPUExecutor
    from janusgraph_tpu_torch.olap.checkpoint import save_checkpoint
    from janusgraph_tpu_torch.olap.programs import PageRankProgram

    runs = {}
    with tempfile.TemporaryDirectory() as d:
        for name, fused, expect in (("fused", True, (15, 15)), ("host_loop", False, (12, 10))):
            fired = []

            def hook(step):
                if step >= 12 and not fired:
                    fired.append(step)
                    raise SuperstepPreempted(f"injected at superstep {step}")

            ex = GPUExecutor(csr, strategy="segsum")
            path = os.path.join(d, f"{name}.npz")
            rank = ex.run(PageRankProgram(max_iterations=20, tol=0.0), fused=fused,
                          checkpoint_path=path, checkpoint_every=5, fault_hook=hook)["rank"]
            info = dict(ex.last_run_info)
            steps = info.get("resume_steps") or [{}]
            got = (steps[0].get("preempted_at"), steps[0].get("from_step"))
            if not fired or info.get("resumes") != 1 or got != expect:
                raise RuntimeError(f"{name}: preempted/resumed at {got}, expected {expect}: {info}")
            if not bits_equal(rank, want_rank):
                raise RuntimeError(f"the resumed PageRank ({name}) differs from the uninterrupted run")
            runs[name] = {k: info.get(k) for k in ("path", "resumes", "resume_steps", "wall_s",
                                                    "run_wall_s", "host_syncs", "chunks")}
            runs[name]["recomputed_supersteps"] = got[0] - got[1]
            runs[name]["measured_record_written"] = os.path.exists(path + ".autotune.json")
        state = {"rank": rank}
        t0 = time.perf_counter()
        for _ in range(5):
            save_checkpoint(os.path.join(d, "save.npz"), state, {"delta": np.float32(0)}, 20)
        save_ms = (time.perf_counter() - t0) / 5 * 1e3
    emit("checkpoint", every=5, **runs, save_ms=save_ms, state_bytes=rank.nbytes,
         save_bound_ms=rank.nbytes / PEAK_BYTES_PER_S * 1e3, bitwise_equal=True)


def tier(n: int) -> int:
    """The overlay's pow2 lane tier of ``n`` cells (``delta.overlay_tier``)."""
    return 0 if n <= 0 else 1 << max(0, int(n) - 1).bit_length()


def pick_tombstones(csr, edges, burst: int, max_cells: int) -> tuple:
    """The largest power-of-two prefix of ``edges`` (edge positions in the
    out-CSR, in seeded order) whose overlay lanes fit ``max_cells`` in both
    orientations: every tombstone dirties its destination (and, for an
    undirected program, its source), and a dirty row re-aggregates all its
    surviving base edges through the live lane. Returns (count, directed
    live cells, undirected live cells)."""
    src = np.repeat(np.arange(csr.num_vertices), np.diff(csr.out_indptr))
    ind = np.diff(csr.in_indptr)
    both = ind + np.diff(csr.out_indptr)
    t = len(edges)
    while t:
        ts, td = src[edges[:t]], csr.out_dst[edges[:t]].astype(np.int64)
        live_d = int(ind[np.unique(td)].sum()) - t
        live_u = int(both[np.unique(np.concatenate([td, ts]))].sum()) - 2 * t
        cells = max(tier(burst) + tier(t) + tier(live_d),
                    tier(2 * burst) + tier(2 * t) + tier(live_u))
        if cells <= max_cells:
            return t, live_d, live_u
        t //= 2
    return 0, 0, 0


def delta_phase(csr, args, emit) -> dict:
    """The delta overlay at the reference bench's streaming shape: a burst
    of 0.5 % of the edges as uniform pairs, tombstones of existing edges,
    lanes capped at 2^22 cells. PageRank (20 supersteps, tol 0, segsum)
    over base + overlay: 3 segment-sum runs a superstep on the kernel's
    device counter (base, adds, tombstones), the fused loop bitwise equal
    to the host loop, the ranks within a relative ``RANK_REL`` of PageRank
    over the materialized CSR; the kernel against its plain version on the
    add and tombstone lanes' plans, with the cells they gather; CC
    (ELL) and a 4-hop hub BFS over the overlay bitwise equal to the
    materialized CSR's, CC equal to scipy's components; a vertex overlay
    (new vertices with edges, removed vertices with theirs) through
    compact_result against the materialized run by vertex id; the "gpu"
    lane and materialize constants and decide_delta's threshold; one
    set_delta swap and its recapture."""
    import torch
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import connected_components

    from janusgraph_tpu_torch.olap import GPUExecutor, autotune, kernels
    from janusgraph_tpu_torch.olap import delta as D
    from janusgraph_tpu_torch.olap.programs import (
        ConnectedComponentsProgram,
        PageRankProgram,
        ShortestPathProgram,
    )

    phase_t0 = time.perf_counter()
    n, m = csr.num_vertices, csr.num_edges
    rng = np.random.default_rng(args.seed + 5)
    max_cells = 1 << 22
    burst = m // 200  # 0.5 % of the edges (bench.py's streaming burst)
    zeros = np.zeros(burst, np.int64)
    a_src, a_dst = rng.integers(0, n, burst), rng.integers(0, n, burst)
    cand = rng.choice(m, 1 << 14, replace=False)
    t, live_d, live_u = pick_tombstones(csr, cand, burst, max_cells)
    src_all = np.repeat(np.arange(n, dtype=np.int64), np.diff(csr.out_indptr))
    tomb = cand[:t]
    batch = {"add": (a_src, a_dst, zeros),
             "del": (src_all[tomb], csr.out_dst[tomb].astype(np.int64), np.zeros(t, np.int64)),
             "v_add": {}, "v_del": []}
    t0 = time.perf_counter()
    overlay = D.DeltaOverlay.from_batches([batch])
    view = D.OverlayView(csr, overlay, max_lane_cells=max_cells)
    lanes = {u: view.lanes(u) for u in (False, True)}
    build_s = time.perf_counter() - t0
    if any(v is None for v in lanes.values()):
        raise RuntimeError(f"the overlay's lanes overflow {max_cells} cells")
    caps = {("undirected" if u else "directed"): {k: lanes[u]["_meta"][k] for k in ("acap", "tcap", "lcap")}
            for u in lanes}
    dirty = {("undirected" if u else "directed"): int(lanes[u]["dirty"].sum()) for u in lanes}
    t0 = time.perf_counter()
    mat = D.materialize(csr, overlay)
    materialize_s = time.perf_counter() - t0
    if mat.num_edges != view.num_edges_real:
        raise RuntimeError(f"materialized {mat.num_edges} edges, the view says {view.num_edges_real}")

    def pagerank():
        return PageRankProgram(max_iterations=20, tol=0.0)

    # base, then the overlay, on one executor: the swap keeps the plan
    dex = GPUExecutor(csr, strategy="segsum")
    dex.run(pagerank())
    dex.set_delta(view)
    t0 = time.perf_counter()
    dex.run(pagerank())  # the lanes move to the card, the loop captures
    delta_first_s = time.perf_counter() - t0
    first_capture_s = dex.last_run_info["capture_s"]
    kernels.reset_launch_counts()
    TEL.label = "delta_pagerank"
    fused, launches = counted(lambda: dex.run(pagerank())["rank"], 60)
    info = dict(dex.last_run_info)
    eager = kernels.launch_counts()["sorted_segment_sum"]
    if (info["path"] != "fused"
            or info["kernel_launches"] + info["graph_kernel_launches"] != 60 or eager != 0):
        raise RuntimeError(f"delta PageRank: {launches} kernel runs ({eager} eagerly), "
                           f"expected 3 a superstep: {info}")
    host = dex.run(pagerank(), fused=False)["rank"]
    if not bits_equal(fused, host):
        raise RuntimeError("delta PageRank: the fused loop differs from the host loop")
    if fused.shape != (n,) or not np.isfinite(fused).all():
        raise RuntimeError("delta PageRank ranks are not finite")
    # the trade: materialize, then a fresh executor over its result
    t0 = time.perf_counter()
    mex = GPUExecutor(mat, strategy="segsum")
    want = mex.run(pagerank())["rank"]
    fresh_first_s = time.perf_counter() - t0
    # warm walls swing by half from run to run: five of each, in turns
    bex = GPUExecutor(csr, strategy="segsum")
    bex.run(pagerank())
    walls = {"base": [], "delta": [], "materialized": [], "delta_host_loop": []}
    for _ in range(5):
        for key, ex, kw in (("base", bex, {}), ("delta", dex, {}), ("materialized", mex, {}),
                            ("delta_host_loop", dex, {"fused": False})):
            ex.run(pagerank(), **kw)
            walls[key].append(ex.last_run_info["wall_s"])
    wall = {k: float(np.median(v)) for k, v in walls.items()}
    del bex
    rel = max_rel(fused, want)
    if not rel <= RANK_REL:
        raise RuntimeError(f"delta PageRank vs materialized: max rel diff {rel}")

    # the lane merge alone, replayed as the fused loop runs it, beside the
    # base aggregate it follows
    g = dex.g
    x = torch.rand(view.n_pad, generator=torch.Generator(device="cuda").manual_seed(3),
                   device="cuda")
    dl = view.device_args("cuda", False)
    plan = dex._segsum_plan("in")
    base_agg = kernels.sorted_segment_sum(torch.index_select(x, 0, g.in_src), plan)
    # the kernel on each lane's plan, fed the cells the merge gathers
    msgs_ext = torch.cat([x, x.new_zeros(1)])
    lane_err = {}
    for lane in ("add", "tomb"):
        cells_in = torch.index_select(msgs_ext, 0, dl[f"{lane}_src"])
        _p, _g, lane_err[lane] = check_plan(f"delta_{lane}_lane", dl[f"{lane}_plan"],
                                            cells_in, kernels)
    merge_ms = replay_ms(lambda: D.fused_delta_aggregate(dl, x, base_agg, "sum"))
    base_ms = replay_ms(lambda: kernels.sorted_segment_sum(torch.index_select(x, 0, g.in_src), plan))
    cells = len(dl["add_src"]) + len(dl["tomb_src"])
    # the merge reads the base sums once, each cell's source, destination
    # and message once, and writes the n_pad sums
    merge_bytes = 8 * view.n_pad + 12 * cells
    lane_cost = merge_ms * 1e-3 / overlay.size
    mat_cost = materialize_s / m
    decision = autotune.decide_delta(m, n, device_kind=torch.cuda.get_device_name(0))

    # CC (ELL) and the 4-hop hub BFS over the overlay, bitwise to the
    # materialized CSR's dense runs
    cc_ex = GPUExecutor(csr, strategy="ell", delta=view)
    comp = cc_ex.run(ConnectedComponentsProgram())["component"]
    cc_info = dict(cc_ex.last_run_info)
    mat_ell = GPUExecutor(mat, strategy="ell")
    comp_mat = mat_ell.run(ConnectedComponentsProgram(), frontier="off")["component"]
    if not bits_equal(comp, comp_mat):
        raise RuntimeError("delta CC differs from CC over the materialized CSR")
    msrc = np.repeat(np.arange(n), np.diff(mat.out_indptr))
    adj = coo_matrix((np.ones(mat.num_edges), (msrc, mat.out_dst)), shape=(n, n)).tocsr()
    ncomp, labels = connected_components(adj, directed=True, connection="weak")
    lowest = np.full(ncomp, n, dtype=np.int64)
    np.minimum.at(lowest, labels, np.arange(n))
    if not np.array_equal(comp.astype(np.int64), lowest[labels]):
        raise RuntimeError("delta CC differs from scipy's components over the merged edges")
    hub = int(np.argmax(csr.out_degree))
    bfs = cc_ex.run(ShortestPathProgram(seed_index=hub, max_iterations=4))["distance"]
    bfs_info = dict(cc_ex.last_run_info)
    bfs_mat = mat_ell.run(ShortestPathProgram(seed_index=hub, max_iterations=4),
                          frontier="off")["distance"]
    if bfs_info["path"] != "fused" or not bits_equal(bfs, bfs_mat):
        raise RuntimeError(f"delta BFS differs from the materialized CSR's: {bfs_info}")
    del cc_ex, mat_ell, mex

    # a vertex overlay: 1,000 new vertices with 4 out- and 4 in-edges each,
    # and 64 removed vertices (no out-edges, 1-16 in-edges) with theirs
    ind = np.diff(csr.in_indptr)
    gone = rng.choice(np.nonzero((csr.out_degree == 0) & (ind >= 1) & (ind <= 16))[0], 64,
                      replace=False)
    # the new edges' base ends avoid the removed vertices, as the store's
    # edges do
    alive = np.setdiff1d(np.arange(n), gone)
    new = np.arange(n, n + 1000, dtype=np.int64)
    v_src = np.concatenate([np.repeat(new, 4), rng.choice(alive, 4000)])
    v_dst = np.concatenate([rng.choice(alive, 4000), np.repeat(new, 4)])
    g_dst = np.repeat(gone, ind[gone])
    g_src = np.concatenate([csr.in_src[csr.in_indptr[v]:csr.in_indptr[v + 1]] for v in gone])
    vbatch = {"add": (v_src, v_dst, np.zeros(len(v_src), np.int64)),
              "del": (g_src.astype(np.int64), g_dst.astype(np.int64), np.zeros(len(g_src), np.int64)),
              "v_add": {int(v): 0 for v in new}, "v_del": [int(v) for v in gone]}
    voverlay = D.DeltaOverlay.from_batches([vbatch])
    vview = D.OverlayView(csr, voverlay, max_lane_cells=max_cells)
    dex.set_delta(vview)  # the swap: base plan kept, loops recaptured
    vout = dex.run(pagerank())
    swap_info = dict(dex.last_run_info)
    ranks, rview = D.compact_result(vview, vout)
    vmat = D.materialize(csr, voverlay)
    vwant = GPUExecutor(vmat, strategy="segsum").run(pagerank())["rank"]
    pos = np.searchsorted(vmat.vertex_ids, rview.vertex_ids)
    if len(rview.vertex_ids) != vmat.num_vertices or not np.array_equal(
            vmat.vertex_ids[pos], rview.vertex_ids):
        raise RuntimeError("the vertex overlay's live vertices differ from the materialized set")
    vrel = max_rel(ranks["rank"], vwant[pos])
    if not vrel <= RANK_REL:
        raise RuntimeError(f"vertex-overlay PageRank vs the materialized run by id: "
                           f"max rel diff {vrel}")
    dex.set_delta(None)
    emit("delta", seconds=time.perf_counter() - phase_t0, scale=args.scale, edges=m,
         burst_adds=burst, tombstones=t,
         tombstones_why=(f"the largest power of two (from 16384 seeded candidates) whose lanes "
                         f"fit {max_cells} cells in both orientations: each tombstone dirties "
                         f"its row, which re-aggregates its surviving in-edges"),
         live_cells={"directed": live_d, "undirected": live_u}, caps=caps, dirty_rows=dirty,
         overlay_depth=overlay.size, view_build_s=build_s, materialize_s=materialize_s,
         pagerank={"kernel_runs": launches, "supersteps": info["supersteps"],
                   "median_wall_s": wall, "walls_s": walls,
                   "delta_first_run_s": delta_first_s, "first_capture_s": first_capture_s,
                   "materialize_plus_fresh_run_s": materialize_s + fresh_first_s,
                   "fresh_first_run_s": fresh_first_s,
                   "lanes_per_superstep_ms": (wall["delta"] - wall["base"]) / 20 * 1e3,
                   "base_superstep_ms": wall["base"] / 20 * 1e3,
                   "max_abs_diff_vs_materialized": float(np.abs(fused - want).max()),
                   "max_rel_diff_vs_materialized": rel},
         lane_kernel_max_abs_err=lane_err,
         merge={"replayed_ms": merge_ms, "base_segsum_replayed_ms": base_ms, "cells": cells,
                # [n, d] SUM lanes fold each destination's cells in lane
                # order: the fold's width is the most cells of one
                "fold_width": {lane: int(dl[f"{lane}_fold"].shape[1]) for lane in ("add", "tomb")},
                "bytes": merge_bytes, "bound_ms": merge_bytes / PEAK_BYTES_PER_S * 1e3,
                "calls_per_run": 20},
         gpu_constants={"lane_cost_per_record_per_step_s": lane_cost,
                        "materialize_cost_per_edge_s": mat_cost},
         in_use={"lane": autotune._DELTA_LANE_COST_S["gpu"],
                 "materialize": autotune._DELTA_MATERIALIZE_COST_S["gpu"]},
         decide_delta=decision.as_dict(),
         cc={"path": cc_info["path"], "supersteps": cc_info["supersteps"],
             "wall_s": cc_info["wall_s"], "components": int(ncomp)},
         bfs={"hub": hub, "reached": int(np.sum(bfs < 1e18)), "wall_s": bfs_info["wall_s"]},
         vertex_overlay={"new": len(new), "removed": len(gone), "n_pad": vview.n_pad,
                         "swap_capture_s": swap_info["capture_s"], "wall_s": swap_info["wall_s"],
                         "max_rel_diff_vs_materialized": vrel,
                         "delta": swap_info["delta"]})
    return {"launches": launches, "merge_ms": merge_ms, "merge_bound_ms": merge_bytes / PEAK_BYTES_PER_S * 1e3}


def dense_phase(csr, args, emit) -> dict:
    """The dense-feature tier at the bench's width (d = 32, 2 layers): GCN
    fused under ELL and hybrid, bitwise equal; under segsum (ELL) bitwise
    equal to a repeat, its host loop and the ELL run; the attention GCN (sddmm) under ELL and hybrid,
    bitwise; the embedding update (5 iterations) ELL against hybrid,
    bitwise; at scale 12 each ELL result bitwise equal to the port's CPU
    run. Per-superstep ms and peak memory of each; tree_matmul against
    torch.matmul (TF32 off) at (2^20, 32) @ (32, 32); tree_dot and the
    three sddmm aggregates against their bounds."""
    import torch

    from janusgraph_tpu_torch.olap import GPUExecutor, rmat_csr
    from janusgraph_tpu_torch.olap.features import kernels as fk
    from janusgraph_tpu_torch.olap.programs import EmbeddingUpdateProgram, GCNForwardProgram

    if torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("TF32 matmul is on; the dense tier's yardstick needs it off")
    phase_t0 = time.perf_counter()
    d = 32

    def gcn(**kw):
        return GCNForwardProgram(feature_dim=d, hidden_dim=d, out_dim=d, num_layers=2, **kw)

    def emb():
        return EmbeddingUpdateProgram(feature_dim=d, max_iterations=5)

    cases = (("gcn", gcn, "h"), ("gcn_attention", lambda: gcn(attention=True), "h"),
             ("embedding", emb, "emb"))
    n, m = csr.num_vertices, csr.num_edges
    exs = {s: GPUExecutor(csr, strategy=s) for s in ("ell", "hybrid")}
    runs, results = {}, {}
    step = torch.zeros((), dtype=torch.int64, device="cuda")

    def superstep_ms(ex, prog):
        """One superstep (message, aggregate, apply) replayed from a CUDA
        graph, and its aggregate alone: the device time a fused superstep
        takes, without the run's host set-up (the numpy features)."""
        state, _ = prog.setup(ex.g)
        agg = lambda: ex._aggregate(prog, "sum", prog.message(state, step, ex.g))[0]  # noqa: E731
        whole = replay_ms(lambda: prog.apply(state, agg(), step, {}, ex.g), 5)
        return whole, replay_ms(agg, 5)

    for name, make, key in cases:
        for strategy, ex in exs.items():
            ex.run(make())  # packs, rows and the capture
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            TEL.label = "gcn_layer" if (name, strategy) == ("gcn", "ell") else None
            out = ex.run(make())[key]
            info = dict(ex.last_run_info)
            if info["path"] != "fused" or out.shape != (n, d) or not np.isfinite(out).all():
                raise RuntimeError(f"{name} ({strategy}): {info}")
            results[(name, strategy)] = out
            whole_ms, agg_ms = superstep_ms(ex, make())
            runs[f"{name}_{strategy}"] = {
                "wall_s": info["wall_s"], "supersteps": info["supersteps"],
                "superstep_replayed_ms": whole_ms, "aggregate_replayed_ms": agg_ms,
                "capture_s": info["capture_s"],
                "max_memory_allocated": torch.cuda.max_memory_allocated(),
                "pad_ratio": info["pad_ratio"]}
        if not bits_equal(results[(name, "ell")], results[(name, "hybrid")]):
            raise RuntimeError(f"{name}: hybrid differs from ELL")
    # the default strategy: [n, d] SUM takes ELL, so the GCN
    # repeats bit for bit, its fused run equals its host loop and both
    # equal the ELL run
    seg = GPUExecutor(csr, strategy="segsum")
    h_first = seg.run(gcn())["h"]
    h_seg = seg.run(gcn())["h"]
    seg_info = dict(seg.last_run_info)
    h_host = seg.run(gcn(), fused=False)["h"]
    if (seg_info["strategy_resolved"] != "ell" or seg_info["path"] != "fused"
            or not bits_equal(h_first, h_seg) or not bits_equal(h_seg, h_host)
            or not bits_equal(h_seg, results[("gcn", "ell")])):
        raise RuntimeError(f"GCN under segsum: {seg_info['strategy_resolved']}, not bitwise "
                           f"(max abs vs ELL {np.abs(h_seg - results[('gcn', 'ell')]).max()})")
    whole_ms, agg_ms = superstep_ms(seg, gcn())
    runs["gcn_segsum"] = {"wall_s": seg_info["wall_s"], "strategy_resolved": seg_info["strategy_resolved"],
                          "superstep_replayed_ms": whole_ms, "aggregate_replayed_ms": agg_ms,
                          "bitwise_repeat_fused_host_loop_ell": True}
    del seg

    small = rmat_csr(12, 16, seed=args.seed)
    for name, make, key in cases:
        card = GPUExecutor(small, strategy="ell").run(make())[key]
        cpu = GPUExecutor(small, strategy="ell", device="cpu").run(make())[key]
        if not bits_equal(card, cpu):
            raise RuntimeError(f"{name} on the card differs from the CPU at scale 12")

    # the jnp-ported kernels alone, at the shapes the runs give them
    gen = torch.Generator(device="cuda").manual_seed(5)
    h = torch.randn(n, d, generator=gen, device="cuda")
    w = torch.randn(d, d, generator=gen, device="cuda")
    mm_bytes = 4 * (n * d + d * d + n * d)
    mm_flops = fk.matmul_flops(n, d, d)
    kern = {"tree_matmul": {
        "ms": cuda_ms(lambda: fk.tree_matmul(h, w), 5, warmup=1),
        "library_ms": cuda_ms(lambda: torch.matmul(h, w), 20),
        "calls_per_run": 2, "block_bytes": fk.MM_BLOCK_BYTES,
        "blocks": -(-n // (fk.MM_BLOCK_BYTES // (4 * d * d))),
        "bytes": mm_bytes, "flops": mm_flops,
        "bound_ms": max(mm_bytes / PEAK_BYTES_PER_S, mm_flops / PEAK_FP32_FLOPS) * 1e3}}
    tm = fk.tree_matmul(h, w)
    kern["tree_matmul"]["max_abs_diff_vs_matmul"] = float((tm - torch.matmul(h, w)).abs().max())
    ex = exs["ell"]
    src_idx = ex.g.in_src
    a = torch.index_select(h, 0, src_idx)
    b = torch.index_select(h, 0, ex.g.in_dst_seg)
    dot_bytes = 4 * (2 * m * d + m)
    kern["tree_dot"] = {
        "ms": cuda_ms(lambda: fk.tree_dot(a, b), 3, warmup=1),
        "library_ms": cuda_ms(lambda: torch.linalg.vecdot(a, b), 5, warmup=1),
        "shape": [m, d], "bytes": dot_bytes, "flops": 2.0 * m * d,
        "bound_ms": max(dot_bytes / PEAK_BYTES_PER_S, 2.0 * m * d / PEAK_FP32_FLOPS) * 1e3}
    del a, b, tm
    # sddmm: each edge's source index once, the features once, the sums once
    sd_bytes = 4 * (m + 2 * n * d)
    sd_flops = fk.sddmm_flops(m, d) + m * d
    sd_bound = max(sd_bytes / PEAK_BYTES_PER_S, sd_flops / PEAK_FP32_FLOPS) * 1e3
    hyb = exs["hybrid"]
    fns = {
        "sddmm_ell_aggregate": lambda: fk.sddmm_ell_aggregate(
            ex._ell_pack(False), ex._sddmm_rows("ell", False), h),
        "sddmm_hybrid_aggregate": lambda: fk.sddmm_hybrid_aggregate(
            hyb._hybrid_pack(False), hyb._sddmm_rows("hybrid", False), h),
        "sddmm_segment_aggregate": lambda: fk.sddmm_segment_aggregate(
            h, ex.g.in_src, ex.g.in_dst_seg, n),
    }
    for name, fn in fns.items():
        kern[name] = {"ms": cuda_ms(fn, 3, warmup=1), "library_ms": None, "bytes": sd_bytes,
                      "flops": sd_flops, "bound_ms": sd_bound, "calls_per_run": 2}
    # the run's host set-up: the reference's numpy features (2^20 x 32
    # normals), drawn on the host for the same bits
    t0 = time.perf_counter()
    gcn().setup(exs["ell"].g)
    setup_s = time.perf_counter() - t0
    emit("dense", seconds=time.perf_counter() - phase_t0, scale=args.scale, d=d, layers=2,
         embedding_iterations=5, runs=runs,
         gcn_setup_s=setup_s,
         bitwise_ell_hybrid=True, small_scale_equal_to_cpu=True, kernels=kern)
    return kern


def edge_hash(a: np.ndarray, b: np.ndarray, salt: int) -> np.ndarray:
    """A fixed 64-bit hash of each (a[i], b[i]) pair (splitmix64's finish
    over a + salt and b): the same edge hashes alike in any orientation's
    arrays, so types and weights need no second graph build."""
    with np.errstate(over="ignore"):
        h = a.astype(np.uint64) * np.uint64(0x9E3779B97F4A7C15) + np.uint64(salt)
        h ^= b.astype(np.uint64) * np.uint64(0xC2B2AE3D27D4EB4F)
        h ^= h >> np.uint64(30)
        h *= np.uint64(0xBF58476D1CE4E5B9)
        h ^= h >> np.uint64(27)
        h *= np.uint64(0x94D049BB133111EB)
        h ^= h >> np.uint64(31)
    return h


def both_orientations(csr):
    """(src, dst) of every edge as the in-CSR and the out-CSR store it."""
    n = csr.num_vertices
    rows = np.arange(n, dtype=np.int64)
    in_pair = (csr.in_src.astype(np.int64), np.repeat(rows, np.diff(csr.in_indptr)))
    out_pair = (np.repeat(rows, np.diff(csr.out_indptr)), csr.out_dst.astype(np.int64))
    return in_pair, out_pair


def channel_matrix(n, edges, channel, weighted=False):
    """The float64 (n, n) matrix of one channel's edges, rows the
    aggregating vertex: x' = M @ x is one traversal step (with
    ``weighted``, the edge weights instead of ones), and the channel's
    edge count (parallel edges merge in the matrix). ``edges`` is
    (src, dst, type, weight) of every edge once; the matrix is built from
    them directly, not through the port's ``channel_edges``: "out"
    aggregates at dst, "in" at src, "both" the sum."""
    from scipy.sparse import coo_matrix

    s, d, types, w = edges
    keep = slice(None) if channel.labels is None else np.isin(types, channel.labels)
    s, d = s[keep], d[keep]
    vals = w[keep].astype(np.float64) if weighted else np.ones(len(s))
    fwd = coo_matrix((vals, (d, s)), shape=(n, n)).tocsr()
    mat = {"out": fwd, "in": fwd.T.tocsr(), "both": fwd + fwd.T}[channel.direction]
    return mat, len(s) * (2 if channel.direction == "both" else 1)


def hold_counts(name, counts, want64, ell_counts=None):
    """Traverser counts against a float64 product (total and per vertex at
    rtol 1e-4) and, given, against the ELL strategy's: rtol 1e-4 per
    vertex, and bitwise where both are below 2^24 (every partial sum of a
    smaller count is an exact integer). Returns the record."""
    got = np.asarray(counts, dtype=np.float64)
    if counts.shape != want64.shape or not np.isfinite(got).all():
        raise RuntimeError(f"{name}: counts of shape {counts.shape} are not finite")
    total, total64 = float(got.sum()), float(want64.sum())
    if abs(total - total64) > 1e-4 * max(total64, 1.0):
        raise RuntimeError(f"{name}: total {total} differs from the float64 product's {total64}")
    if not np.allclose(got, want64, rtol=1e-4, atol=0.0):
        raise RuntimeError(f"{name}: max rel diff {max_rel(got[want64 > 0], want64[want64 > 0])} "
                           "from the float64 product")
    rec = {"total": total, "total_fp64": total64, "max_count": float(got.max()),
           "counts_over_2p24": int(np.sum(want64 >= 2.0 ** 24)),
           "max_rel_diff_vs_fp64": max_rel(got[want64 > 0], want64[want64 > 0])}
    if ell_counts is not None:
        if not np.allclose(got, ell_counts, rtol=1e-4, atol=0.0):
            raise RuntimeError(f"{name}: segsum and ELL counts differ beyond rtol 1e-4")
        small = (counts < 2.0 ** 24) & (ell_counts < 2.0 ** 24)
        if not bits_equal(counts[small], ell_counts[small]):
            raise RuntimeError(f"{name}: counts below 2^24 differ between segsum and ELL")
        rec["bitwise_vs_ell_below_2p24"] = int(small.sum())
        rec["max_rel_diff_vs_ell"] = max_rel(got[ell_counts > 0], ell_counts[ell_counts > 0])
    return rec


def channel_plan_checks(ex, prefix, kernels):
    """The segment-sum kernel against its plain version (and a bitwise
    repeat) on the plan of every channel ``ex`` holds, fed the gathered
    values of a seeded random vector, as a count step is."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(13)
    x = torch.rand(ex.csr.num_vertices, generator=gen, device="cuda")
    out = {}
    for channel, entry in ex._channel_packs.items():
        if entry._segsum is None:
            continue
        plan, src_idx, _w = entry.segsum()
        label = f"{channel.direction}{list(channel.labels) if channel.labels else ''}"
        data = torch.index_select(x, 0, src_idx)
        _p, _g, err = check_plan(f"{prefix}_{label}", plan, data, kernels)
        nbytes = plan.function_bytes()
        out[label] = {"edges": plan.num_edges, "num_ctas": plan.num_ctas, "max_abs_err": err,
                      "kernel_ms": flushed_ms(lambda: kernels.sorted_segment_sum(data, plan), iters=10),
                      "plain_ms": flushed_ms(lambda: kernels.sorted_segment_sum_plain(data, plan),
                                             iters=5),
                      "bytes": nbytes, "bound_ms": nbytes / PEAK_BYTES_PER_S * 1e3}
    return out


def filtered_3hop(csr, key, value):
    """The bench's filtered 3-hop: out, out with ``key > value``, out."""
    from janusgraph_tpu_torch.olap.programs import (
        OLAPTraversalProgram,
        PropertyFilter,
        TraversalStep,
        evaluate_filter_mask,
    )
    from janusgraph_tpu_torch.core.predicates import Cmp

    flt = (PropertyFilter(key, Cmp.GREATER_THAN, value),)
    fmask = evaluate_filter_mask(csr, flt)
    ones = np.ones(csr.num_vertices, np.float32)
    masks = np.stack([ones, fmask, ones], axis=1)

    def make():
        return OLAPTraversalProgram(
            (TraversalStep("out"), TraversalStep("out", None, flt), TraversalStep("out")),
            step_masks=masks)

    return make, fmask


def run_filtered_3hop(name, csr, adj_t, make, fmask, seg_ex, ell_ex, emit) -> int:
    """The filtered 3-hop under segsum (3 kernel runs, counted), warm and
    timed, against ELL and a float64 product; the kernel on the channel
    plan against its plain version. Returns the kernel runs."""
    from janusgraph_tpu_torch.olap import kernels

    kernels.reset_launch_counts()
    counts, runs = counted(lambda: seg_ex.run(make())["count"], 3)
    first = dict(seg_ex.last_run_info)
    again = seg_ex.run(make())["count"]
    info = dict(seg_ex.last_run_info)
    if not bits_equal(counts, again):
        raise RuntimeError(f"{name}: two segsum runs differ")
    if info["path"] != "host-loop" or info["strategy_resolved"] != "segsum":
        raise RuntimeError(f"{name}: {info['path']}, {info['strategy_resolved']}")
    ell = ell_ex.run(make())["count"]
    ell_info = dict(ell_ex.last_run_info)
    ell_ex.run(make())
    x = np.ones(csr.num_vertices)
    x = adj_t @ x
    x = (adj_t @ x) * fmask
    x = adj_t @ x
    rec = hold_counts(name, counts, x, ell)
    emit(name, kernel_runs=runs, wall_s=info["wall_s"], first_run_wall_s=first["wall_s"],
         superstep_ms=[r["wall_ms"] for r in info["superstep_records"]],
         ell_wall_s=ell_ex.last_run_info["wall_s"], ell_first_run_wall_s=ell_info["wall_s"],
         filter_selectivity=float(fmask.mean()), **rec,
         plans=channel_plan_checks(seg_ex, name, kernels))
    return runs


def traversal_phase(csr, args, seg_ex, ell_ex, adj, rank, pagerank_wall_s, emit) -> dict:
    """The OLAP traversal at full scale: the bench's filtered 3-hop (segsum
    against ELL and a float64 product), a typed channel chain with a label
    set that matches nothing, sack sum and mult (the [n, k] SUM path,
    bitwise on repeat), the bench's seeded 3-hop paths, the degree
    program, the MapReduce jobs and the Fulgora analogue's edges/s beside
    the fused PageRank's."""
    import dataclasses

    import torch
    from janusgraph_tpu_torch.olap import (
        ClusterCountMapReduce,
        EdgeChannel,
        GPUExecutor,
        StatsMapReduce,
        TopKMapReduce,
        kernels,
        measure_fulgora_baseline,
    )
    from janusgraph_tpu_torch.olap.programs import (
        ConnectedComponentsProgram,
        DegreeCountProgram,
        OLAPTraversalProgram,
        TraversalStep,
        build_path_index,
        enumerate_paths,
    )

    phase_t0 = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    n, m = csr.num_vertices, csr.num_edges
    adj_t = adj.T.tocsr()
    out = {}

    # (a) the bench's filtered 3-hop: score > 5 on step 2 (the property
    # rides a copy: the delta phase materializes the bare snapshot)
    scored = dataclasses.replace(csr, properties={
        "score": np.random.default_rng(args.scale).uniform(0, 10, n).astype(np.float32)})
    make, fmask = filtered_3hop(scored, "score", 5.0)
    out["filtered"] = run_filtered_3hop("traversal_filtered_3hop", csr, adj_t, make, fmask,
                                        seg_ex, ell_ex, emit)

    # (b) typed channels: 4 edge types and a weight from a hash of (src, dst)
    t0 = time.perf_counter()
    (ins, ind), (outs, outd) = both_orientations(csr)
    h_in, h_out = edge_hash(ins, ind, 1), edge_hash(outs, outd, 1)
    tcsr = dataclasses.replace(
        csr, properties={},
        in_edge_type=(h_in >> np.uint64(60)).astype(np.int32) & 3,
        out_edge_type=(h_out >> np.uint64(60)).astype(np.int32) & 3,
        in_edge_weight=(0.5 + (h_in & np.uint64(1023)).astype(np.float32) * (1.5 / 1024)),
        out_edge_weight=(0.5 + (h_out & np.uint64(1023)).astype(np.float32) * (1.5 / 1024)),
    )
    typed_edges = (ins, ind, tcsr.in_edge_type, tcsr.in_edge_weight)
    del outs, outd, h_in, h_out
    hash_s = time.perf_counter() - t0
    chain = [("out", (0, 1)), ("in", (2,)), ("both", None)]
    empty = [("out", (0, 1)), ("in", (7,))]

    def prog(spec, **kw):
        return OLAPTraversalProgram([TraversalStep(d, lab) for d, lab in spec], **kw)

    tex = GPUExecutor(csr=tcsr, strategy="segsum")
    kernels.reset_launch_counts()
    typed, typed_runs = counted(lambda: tex.run(prog(chain))["count"], 3)
    typed_first = tex.last_run_info["wall_s"]
    typed_again = tex.run(prog(chain))["count"]
    typed_info = dict(tex.last_run_info)
    if not bits_equal(typed, typed_again):
        raise RuntimeError("typed chain: two runs differ")
    x = np.ones(n)
    mats, edges = {}, {}
    for d, lab in chain:
        mats[(d, lab)], edges[(d, lab)] = channel_matrix(n, typed_edges, EdgeChannel(d, lab))
        x = mats[(d, lab)] @ x
    typed_rec = hold_counts("typed chain", typed, x)
    ell_tex = GPUExecutor(csr=tcsr, strategy="ell")
    typed_rec["max_rel_diff_vs_ell"] = max_rel(
        typed[typed > 0], ell_tex.run(prog(chain))["count"][typed > 0])
    none, empty_runs = counted(lambda: tex.run(prog(empty))["count"], 2)
    if none.shape != (n,) or none.any():
        raise RuntimeError("a label set that matches no edge left traversers")
    kernels.reset_launch_counts()
    typed_plans = channel_plan_checks(tex, "typed", kernels)
    emit("traversal_typed", kernel_runs=typed_runs, empty_label_kernel_runs=empty_runs,
         chain=[[d, list(lab) if lab else None] for d, lab in chain],
         hash_s=hash_s, first_run_wall_s=typed_first, wall_s=typed_info["wall_s"],
         superstep_ms=[r["wall_ms"] for r in typed_info["superstep_records"]],
         channel_edges={f"{d}{list(lab) if lab else ''}": edges[(d, lab)] for d, lab in chain},
         **typed_rec, plans=typed_plans)
    out["typed"] = typed_runs

    # (c) sacks: [n, 3] and [n, 2] SUM messages through the channels' ELL
    # packs, bitwise on repeat, against float64 products
    sacks = {}
    for sack in ("sum", "mult"):
        res = tex.run(prog(chain, sack=sack))
        info = dict(tex.last_run_info)
        again = tex.run(prog(chain, sack=sack))
        if not all(bits_equal(res[k], again[k]) for k in ("count", "sack")):
            raise RuntimeError(f"sack {sack}: two runs differ")
        if {r["strategy"] for r in info["superstep_records"]} != {"ell"}:
            raise RuntimeError(f"sack {sack}: {info['superstep_records']}")
        c = np.ones(n)
        sk = np.zeros(n) if sack == "sum" else np.ones(n)
        for d, lab in chain:
            a = mats[(d, lab)]
            wmat, _e = channel_matrix(n, typed_edges, EdgeChannel(d, lab), weighted=True)
            sk = a @ sk + wmat @ c if sack == "sum" else wmat @ sk
            c = a @ c
        got = res["sack"].astype(np.float64)
        if not np.allclose(got, sk, rtol=1e-4, atol=0.0) or not np.allclose(
                res["count"], c, rtol=1e-4, atol=0.0):
            raise RuntimeError(f"sack {sack}: max rel diff {max_rel(got[sk > 0], sk[sk > 0])}")
        sacks[sack] = {"wall_s": tex.last_run_info["wall_s"], "first_run_wall_s": info["wall_s"],
                       "total": float(got.sum()), "total_fp64": float(sk.sum()),
                       "max_rel_diff_vs_fp64": max_rel(got[sk > 0], sk[sk > 0]),
                       "superstep_ms": [r["wall_ms"] for r in tex.last_run_info["superstep_records"]]}
    # one sack step's aggregate alone (the "both" channel's ELL pack, [n, 3])
    pack = tex._channel_pack(prog(chain, sack="sum"), "s2").ell()
    msgs = torch.rand((n, 3), generator=torch.Generator(device="cuda").manual_seed(2), device="cuda")
    cols = prog(chain, sack="sum").edge_transform_cols
    agg_fn = lambda: kernels.ell_aggregate(pack, msgs, "sum", "none", cols)  # noqa: E731
    e_both = edges[("both", None)]
    # each edge's source index and weight once, the [n, 3] messages and sums once
    agg_bytes = 8 * e_both + 2 * 12 * n
    agg_flops = 4.0 * e_both * 3
    sacks["ell_aggregate_both_n3"] = {
        "ms": cuda_ms(agg_fn, 5, warmup=1), "replayed_ms": replay_ms(agg_fn, 5),
        "slots": pack.slots, "pad_ratio": pack.pad_ratio, "edges": e_both,
        "bytes": agg_bytes, "flops": agg_flops,
        "bound_ms": max(agg_bytes / PEAK_BYTES_PER_S, agg_flops / PEAK_FP32_FLOPS) * 1e3}
    emit("traversal_sack", **sacks)
    del tex, ell_tex, mats, pack, msgs

    # (d) the bench's seeded 3-hop paths
    pseeds = tuple(int(v) for v in np.random.default_rng(7).choice(n, 8, replace=False))
    pprog = OLAPTraversalProgram([TraversalStep("out")] * 3, seed_indices=pseeds, record_reach=True)
    seg_ex.run(pprog)
    t0 = time.perf_counter()
    res = seg_ex.run(pprog)
    device_wall = time.perf_counter() - t0
    t0 = time.perf_counter()
    index = build_path_index(csr, pprog)
    index_s = time.perf_counter() - t0
    sample = list(enumerate_paths(csr, pprog, res, limit=10_000, path_index=index))
    enum_wall = time.perf_counter() - t0
    if not sample:
        raise RuntimeError("seeded 3-hop: no path enumerated")
    p = np.asarray(sample, dtype=np.int64)
    src_all = np.repeat(np.arange(n, dtype=np.int64), np.diff(csr.out_indptr))
    keys = np.sort(src_all * n + csr.out_dst.astype(np.int64))
    hops = (p[:, :-1] * n + p[:, 1:]).ravel()
    pos = np.minimum(np.searchsorted(keys, hops), len(keys) - 1)
    reach = res["reach"] > 0
    if (not np.all(keys[pos] == hops) or not np.all(np.isin(p[:, 0], pseeds))
            or not all(reach[p[:, k], k].all() for k in range(4))):
        raise RuntimeError("seeded 3-hop: a path is no chain of real edges through the reach masks")
    emit("traversal_paths", seeds=len(pseeds), paths_enumerated=len(sample),
         paths_total=float(res["count"].astype(np.float64).sum()),
         device_wall_s=device_wall, enum_wall_s=enum_wall, path_index_s=index_s)

    # (e) the degree program: one superstep, one kernel run
    kernels.reset_launch_counts()
    deg, deg_runs = counted(lambda: seg_ex.run(DegreeCountProgram()), 1)
    if not bits_equal(deg["in_degree"], csr.in_degree.astype(np.float32)) or not bits_equal(
            deg["out_degree"], csr.out_degree.astype(np.float32)):
        raise RuntimeError("DegreeCountProgram differs from the CSR's degrees")
    deg_info = dict(seg_ex.last_run_info)

    # (f) MapReduce over CC's components and the PageRank ranks
    comp = seg_ex.run(ConnectedComponentsProgram())
    t0 = time.perf_counter()
    clusters = ClusterCountMapReduce("component").execute(comp, csr)
    stats = StatsMapReduce("rank").execute({"rank": rank}, csr)
    top = TopKMapReduce("rank", 10).execute({"rank": rank}, csr)
    mr_s = time.perf_counter() - t0
    labels, sizes = np.unique(comp["component"], return_counts=True)
    want_top = np.argsort(-rank.astype(np.float64), kind="stable")[:10]
    if (clusters["count"] != len(labels)
            or clusters["sizes"] != {float(a): float(b) for a, b in zip(labels, sizes)}
            or abs(stats["sum"] - float(rank.astype(np.float64).sum())) > 1e-9
            or stats["count"] != n
            or sorted(v for _i, v in top) != sorted(float(rank[i]) for i in want_top)):
        raise RuntimeError("MapReduce results differ from numpy's")

    # (g) the Fulgora analogue, one superstep on the card's host
    fb = measure_fulgora_baseline(csr, iterations=1)
    pr_eps = 20 * m / pagerank_wall_s
    torch.cuda.synchronize()
    emit("traversal_extras", degree={"kernel_runs": deg_runs, "wall_s": deg_info["wall_s"],
                                     "path": deg_info["path"]},
         mapreduce={"components": clusters["count"], "top1": top[0], "stats": stats,
                    "host_s": mr_s},
         fulgora={**fb, "fused_pagerank_edges_per_s": pr_eps,
                  "fused_pagerank_over_fulgora": pr_eps / fb["edges_per_sec"]},
         phase_seconds=time.perf_counter() - phase_t0,
         max_memory_allocated=torch.cuda.max_memory_allocated())
    out["degree"] = deg_runs
    out["fulgora_ratio"] = pr_eps / fb["edges_per_sec"]
    return out


def ldbc_phase(emit) -> int:
    """The LDBC SNB SF1-sized proxy (3.2M vertices, 17.3M edges): CC
    against scipy's components, and the bench's filtered 3-hop
    (creation_day > 1825) through the kernel, held as at scale 20."""
    import torch
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import connected_components

    from janusgraph_tpu_torch.olap import GPUExecutor, ldbc_sf_csr
    from janusgraph_tpu_torch.olap.programs import ConnectedComponentsProgram

    phase_t0 = time.perf_counter()
    t0 = time.perf_counter()
    lcsr = ldbc_sf_csr(sf=1)
    build_s = time.perf_counter() - t0
    n, m = lcsr.num_vertices, lcsr.num_edges
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    src = np.repeat(np.arange(n), np.diff(lcsr.out_indptr))
    adj = coo_matrix((np.ones(m), (src, lcsr.out_dst)), shape=(n, n)).tocsr()
    del src
    seg_ex = GPUExecutor(lcsr, strategy="segsum")
    ell_ex = GPUExecutor(lcsr, strategy="ell")
    cc_first = seg_ex.run(ConnectedComponentsProgram(max_iterations=64))["component"]
    comp = seg_ex.run(ConnectedComponentsProgram(max_iterations=64))["component"]
    cc_info = dict(seg_ex.last_run_info)
    ncomp, labels = connected_components(adj, directed=True, connection="weak")
    lowest = np.full(ncomp, n, dtype=np.int64)
    np.minimum.at(lowest, labels, np.arange(n))
    if not bits_equal(cc_first, comp) or not np.array_equal(comp.astype(np.int64), lowest[labels]):
        raise RuntimeError("CC on the SF1 proxy differs from scipy's components")
    emit("ldbc", vertices=n, edges=m, host_build_s=build_s, components=int(ncomp),
         cc={"path": cc_info["path"], "supersteps": cc_info["supersteps"],
             "wall_s": cc_info["wall_s"], "strategy_resolved": cc_info["strategy_resolved"]})
    make, fmask = filtered_3hop(lcsr, "creation_day", 1825)
    runs = run_filtered_3hop("ldbc_filtered_3hop", lcsr, adj.T.tocsr(), make, fmask,
                             seg_ex, ell_ex, emit)
    torch.cuda.synchronize()
    emit("ldbc_done", seconds=time.perf_counter() - phase_t0,
         max_memory_allocated=torch.cuda.max_memory_allocated())
    return runs


def pagerank_fp64(csr, iters: int, damping: float = 0.85) -> np.ndarray:
    """PageRank in float64 numpy with the port's program's steps: the
    dangling mass of the step before, spread evenly."""
    n = csr.num_vertices
    outdeg = csr.out_degree.astype(np.float64)
    dangling_mask = outdeg == 0
    seg = np.repeat(np.arange(n), np.diff(csr.in_indptr))
    rank = np.full(n, 1.0 / n)
    dangling = rank[dangling_mask].sum()
    for _ in range(iters):
        msg = rank / np.maximum(outdeg, 1.0)
        agg = np.bincount(seg, weights=msg[csr.in_src], minlength=n)
        rank = (1.0 - damping) / n + damping * (agg + dangling / n)
        dangling = rank[dangling_mask].sum()
    return rank


def pagerank_fp64_csr(csr, iters: int, damping: float = 0.85) -> np.ndarray:
    """``pagerank_fp64`` as matrix-vector products with scipy CSR matrices
    made straight from ``in_indptr``/``in_src`` (row = destination): no
    per-edge segment ids and no COO, so it stays cheap at 2^27 edges. The
    rows are cut into one block a host thread (scipy's product releases the
    interpreter lock). The same steps and dangling rule; each row sums its
    edges in the in-CSR's order, as ``np.bincount`` does."""
    import os
    from concurrent.futures import ThreadPoolExecutor

    from scipy.sparse import csr_matrix

    n = csr.num_vertices
    ip = csr.in_indptr
    bounds = np.linspace(0, n, min(8, os.cpu_count() or 1) + 1).astype(np.int64)
    blocks = [
        csr_matrix((np.ones(ip[hi] - ip[lo]), csr.in_src[ip[lo]:ip[hi]], ip[lo:hi + 1] - ip[lo]),
                   shape=(hi - lo, n))
        for lo, hi in zip(bounds[:-1], bounds[1:])
    ]
    outdeg = csr.out_degree.astype(np.float64)
    dangling_mask = outdeg == 0
    rank = np.full(n, 1.0 / n)
    dangling = rank[dangling_mask].sum()
    with ThreadPoolExecutor(len(blocks)) as pool:
        for _ in range(iters):
            msg = rank / np.maximum(outdeg, 1.0)
            agg = np.concatenate(list(pool.map(lambda b: b @ msg, blocks)))
            rank = (1.0 - damping) / n + damping * (agg + dangling / n)
            dangling = rank[dangling_mask].sum()
    return rank


def bfs_numpy(csr, seed: int, hops: int) -> np.ndarray:
    """Hop distances from ``seed`` within ``hops`` hops over the out-edges
    (inf where unreached), level-synchronous in numpy: each level gathers
    its frontier's out-edges from ``out_indptr``/``out_dst`` and marks the
    unreached ones."""
    n = csr.num_vertices
    dist = np.full(n, np.inf)
    dist[seed] = 0.0
    frontier = np.array([seed], dtype=np.int64)
    for t in range(hops):
        starts = csr.out_indptr[frontier]
        degs = csr.out_indptr[frontier + 1] - starts
        total = int(degs.sum())
        if total == 0:
            break
        # position of each gathered edge: its row's start plus its rank in
        # the row
        offsets = np.repeat(starts - (np.cumsum(degs) - degs), degs)
        offsets += np.arange(total, dtype=np.int64)
        seen = np.zeros(n, dtype=bool)
        seen[csr.out_dst[offsets]] = True
        del offsets
        frontier = np.flatnonzero(seen & np.isinf(dist))
        if not len(frontier):
            break
        dist[frontier] = t + 1
    return dist


def host_peak_rss_bytes() -> int:
    """This process's peak resident set: VmHWM in /proc/self/status, or
    where that kernel does not report it (the card's sandboxed machine),
    getrusage's ru_maxrss (KiB on Linux)."""
    import resource

    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmHWM:"):
                return int(line.split()[1]) * 1024
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024


def wall_stats(walls) -> dict:
    """The walls of repeated runs with their median, min and max."""
    return {"walls_s": [float(w) for w in walls], "median_s": float(np.median(walls)),
            "min_s": float(min(walls)), "max_s": float(max(walls))}


#: the north-star rung: BASELINE.json's metric is "graph500-s23 PageRank +
#: 4-hop BFS"; the timed repeats of each run (never fewer than 3; the
#: smoke's time limit keeps it at 3, bin/torch_north_star.py takes 5), and
#: the kernel's back-to-back iterations
NORTH_STAR_SCALE = 23
NORTH_STAR_REPEATS = 3
NORTH_STAR_WARM_ITERS = 20


def north_star_phase(args, emit, device, scale: int = NORTH_STAR_SCALE,
                     repeats: int = NORTH_STAR_REPEATS) -> dict:
    """The main path at the north-star scale: graph500 R-MAT ``scale``
    (edge factor 16, ``args.seed``; the native host library only), the
    segment-sum kernel on its in-plan, PageRank (20 supersteps, tol 0) and
    the out-degree hub's 4-hop BFS, each held against a host reference
    that stays cheap at 2^27 edges. On a CPU ``device`` the kernels' plain
    versions run and no device time is taken (None: not measured). Any
    failed hold raises. Before it returns it drops everything it put on the
    device, and the allocator must hold what it held before."""
    import torch

    from janusgraph_tpu_torch import native
    from janusgraph_tpu_torch.native import segment_ids
    from janusgraph_tpu_torch.olap import GPUExecutor, csr_from_edges, kernels, rmat_edges, run_on
    from janusgraph_tpu_torch.olap.programs import PageRankProgram, ShortestPathProgram
    from janusgraph_tpu_torch.olap.vertex_program import INF

    if repeats < 3:
        raise ValueError(f"the north-star phase times at least 3 repeats, got {repeats}")
    dev = torch.device(device)
    card = dev.type == "cuda"
    phase_t0 = time.perf_counter()
    if card:
        # the process's lifetime caches (the L2 flush buffer, the kernel's
        # run counter) exist before the phase reads the allocator
        flush_buffer()
        kernels._device_counter(dev)
        gc.collect()
        torch.cuda.synchronize(dev)
        mem_before = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    if not native.available():
        raise RuntimeError("the north-star graph needs the native host library")

    # ----------------------------------------------------------- the graph
    t0 = time.perf_counter()
    n, src, dst = rmat_edges(scale, 16, seed=args.seed)
    draw_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    csr = csr_from_edges(n, src, dst)
    build_s = time.perf_counter() - t0
    del src, dst
    m = csr.num_edges
    emit("north_star_graph", scale=scale, vertices=n, edges=m, device=str(dev),
         max_in_degree=int(csr.in_degree.max()), max_out_degree=int(csr.out_degree.max()),
         rmat_s=draw_s, build_csr_s=build_s)

    marks = {"graph": time.perf_counter()}
    # ------------------------------------------- the kernel on its in-plan
    # the kept executor's own plan (built once: at 2^27 edges a plan takes
    # seconds of host time)
    ex = GPUExecutor(csr, strategy="segsum", device=dev)
    t0 = time.perf_counter()
    plan = ex._segsum_plan("in")
    plan_s = time.perf_counter() - t0
    seg = segment_ids(csr.in_indptr, m)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    data = torch.rand(m, generator=gen, device=dev)
    case = f"rmat_s{scale}"
    _plan, got, max_err = check_plan(case, plan, data, kernels)
    # the plan-free hold: a float64 bincount over the CSR's own segment ids
    want64 = np.bincount(seg, weights=data.cpu().numpy().astype(np.float64), minlength=n)
    diff64 = np.abs(got.cpu().numpy() - want64)
    err64 = float(diff64.max())
    if not (diff64 <= TOL["atol"] + TOL["rtol"] * np.abs(want64)).all():
        raise RuntimeError(f"kernel case {case}: max abs err {err64} from a float64 bincount")
    del seg, want64, diff64, got, _plan
    nbytes = plan.function_bytes()
    bound_ms = max(nbytes / PEAK_BYTES_PER_S, m / PEAK_FP32_FLOPS) * 1e3
    timed = dict.fromkeys(("kernel_ms", "kernel_ms_warm", "plain_ms", "library_ms"))
    if card:
        lengths = torch.as_tensor(csr.in_degree.astype(np.int64), device=dev)
        timed = {
            "kernel_ms": flushed_ms(lambda: kernels.sorted_segment_sum(data, plan)),
            "kernel_ms_warm": cuda_ms(lambda: kernels.sorted_segment_sum(data, plan),
                                      NORTH_STAR_WARM_ITERS),
            "plain_ms": flushed_ms(lambda: kernels.sorted_segment_sum_plain(data, plan)),
            "library_ms": flushed_ms(
                lambda: torch.segment_reduce(data, "sum", lengths=lengths)),
        }
        del lengths
    kernel_line = {
        "edges": m, "segments": n, "items_per_cta": plan.items_per_cta,
        "num_ctas": plan.num_ctas, "max_segment_cta_span": plan.max_segment_cta_span(),
        "plan_s": plan_s, "max_abs_err": max_err, "max_abs_err_vs_fp64": err64, **timed,
        "bytes": nbytes, "bound_ms": bound_ms, "bound_by": "bytes",
        "share_of_bound": bound_ms / timed["kernel_ms"] if card else None,
    }
    emit("kernel", case=case, device=str(dev), **kernel_line)
    del data, plan

    marks["kernel"] = time.perf_counter()
    # ------------------------------------------------------------ PageRank
    def pagerank():
        return PageRankProgram(max_iterations=20, tol=0.0)

    t0 = time.perf_counter()
    result, launches = counted(
        lambda: run_on(csr, pagerank(), strategy="segsum", device=dev), 20, dev)
    run_on_wall = time.perf_counter() - t0
    rank = result["rank"]
    walls = {"host_loop": [], "fused": []}
    ranks = {}
    for path, fused in (("host_loop", False), ("fused", True)):
        ex.run(pagerank(), fused=fused)  # warm: the plan, the captures
        for _ in range(repeats):
            out, _runs = counted(lambda: ex.run(pagerank(), fused=fused), 20, dev)
            info = ex.last_run_info
            if info["path"] != ("fused" if fused else "host-loop") or info["supersteps"] != 20:
                raise RuntimeError(f"north-star PageRank ({path}): {info['path']}, "
                                   f"{info['supersteps']} supersteps")
            walls[path].append(info["wall_s"])
            if path in ranks and not bits_equal(out["rank"], ranks[path]):
                raise RuntimeError(f"north-star PageRank ({path}): two runs differ")
            ranks[path] = out["rank"]
    if not bits_equal(ranks["fused"], ranks["host_loop"]):
        raise RuntimeError("north-star PageRank: the fused ranks differ from the host loop's")
    if not bits_equal(rank, ranks["host_loop"]):
        raise RuntimeError("north-star PageRank: run_on's ranks differ from the kept executor's")
    t0 = time.perf_counter()
    want = pagerank_fp64_csr(csr, 20)
    fp64_s = time.perf_counter() - t0
    rel = max_rel(rank, want)
    mass = float(rank.astype(np.float64).sum())
    if rank.shape != (n,) or not np.isfinite(rank).all():
        raise RuntimeError("north-star PageRank: ranks are not finite")
    if rel > RANK_REL or abs(mass - 1.0) > 1e-3:
        raise RuntimeError(f"north-star PageRank: max rel {rel} from float64, mass {mass}")
    del want, ranks
    prof = {"host_loop": {}, "fused": {}}
    if card:
        # one profiled run of each path: the device idle share at this scale
        for path, fused in (("host_loop", False), ("fused", True)):
            prof_runs = profile_run(ex, pagerank(), lambda _phase, **f: prof[path].update(f),
                                    fused=fused)
            if prof_runs != 20:
                raise RuntimeError(f"north-star PageRank ({path}, profiled): {prof_runs} kernel runs")
    pr = {}
    for path, v in walls.items():
        st = wall_stats(v)
        pr[path] = {**st, "superstep_ms": st["median_s"] / 20 * 1e3,
                    "edges_per_s": 20 * m / st["median_s"],
                    "edges_per_s_min_max": [20 * m / st["max_s"], 20 * m / st["min_s"]]}
    emit("north_star_pagerank", scale=scale, supersteps=20, kernel_launches=launches,
         run_on_wall_s=run_on_wall, repeats=repeats, **pr, max_rel_vs_fp64=rel,
         rank_sum=mass, fp64_host_s=fp64_s,
         profile={path: {k: p.get(k) for k in (
             "wall_ms", "device_busy_ms", "device_span_ms", "device_idle_share",
             "device_idle_share_of_span", "dtoh_copies", "by_device_time")}
             for path, p in prof.items()})

    marks["pagerank"] = time.perf_counter()
    # --------------------------------------------------- BFS, 4 hops, hub
    seed = int(np.argmax(csr.out_degree))

    def bfs4():
        return ShortestPathProgram(seed_index=seed, max_iterations=4)

    t0 = time.perf_counter()
    hops = bfs_numpy(csr, seed, 4)
    host_bfs_s = time.perf_counter() - t0
    expect = np.where(hops <= 4, hops, INF).astype(np.float32)
    del hops
    dist_run_on, bfs_launches = counted(lambda: run_on(csr, bfs4(), device=dev)["distance"], 0, dev)
    static_ex = GPUExecutor(csr, strategy="segsum", autotune=False, device=dev)
    bfs = {}
    for ladder, bex in (("tuned", ex), ("static", static_ex)):
        bex.run(bfs4())  # warm: the engine's pointer arrays
        bwalls, hop_walls = [], []
        for _ in range(repeats):
            dist = bex.run(bfs4())["distance"]
            info = bex.last_run_info
            source = {t["tier_source"] for t in info["tiers"]}
            if info["path"] != "frontier" or source != {"autotune" if ladder == "tuned" else "static"}:
                raise RuntimeError(f"north-star BFS ({ladder}): {info['path']}, tiers {source}")
            if not np.array_equal(dist, expect):
                raise RuntimeError(f"north-star BFS ({ladder}): distances differ from the host BFS")
            if not bits_equal(dist, dist_run_on):
                raise RuntimeError(f"north-star BFS ({ladder}): differs from run_on's")
            bwalls.append(info["wall_s"])
            hop_walls.append(info["hop_wall_s"])
        at = int(np.argsort(bwalls)[len(bwalls) // 2])
        bfs[ladder] = {**wall_stats(bwalls), "hops": info["supersteps"],
                       "tiers": [{k: t[k] for k in ("hop", "frontier", "edges", "F_cap", "E_cap",
                                                    "tier_source")} for t in info["tiers"]],
                       "hop_wall_s": hop_walls[at], "median_run": at}
    del static_ex, bex
    emit("north_star_bfs", scale=scale, seed=seed, seed_out_degree=int(csr.out_degree[seed]),
         reached=int(np.sum(expect < INF)), kernel_launches=bfs_launches, repeats=repeats,
         host_bfs_s=host_bfs_s, **bfs,
         pagerank_plus_bfs4_wall_s=pr["host_loop"]["median_s"] + bfs["static"]["median_s"],
         fused_pagerank_plus_tuned_bfs4_wall_s=pr["fused"]["median_s"] + bfs["tuned"]["median_s"])

    marks["bfs"] = time.perf_counter()
    # -------------------------------- leave the device as the phase found it
    del ex, csr, result, rank, dist, dist_run_on, expect
    gc.collect()
    mem = dict.fromkeys(("max_memory_allocated", "peak_over_start", "allocated_after"))
    if card:
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        after = torch.cuda.memory_allocated(dev)
        peak = torch.cuda.max_memory_allocated(dev)
        mem = {"max_memory_allocated": peak, "peak_over_start": peak - mem_before,
               "allocated_after": after}
        if after != mem_before:
            raise RuntimeError(f"north-star phase left {after - mem_before} B on the device")
    marks["release"] = time.perf_counter()
    seconds = marks["release"] - phase_t0
    # each part's seconds, host references and device runs together
    section_s, last = {}, phase_t0
    for name, t in marks.items():
        section_s[name], last = t - last, t
    emit("north_star", scale=scale, seconds=seconds, section_s=section_s,
         host_peak_rss=host_peak_rss_bytes(), **mem)
    return {"launches": launches, "seconds": seconds, "kernel": kernel_line,
            "pagerank": pr, "bfs": bfs}


def stored_phase(csr, args, emit) -> dict:
    """The stored-graph OLAP path at the reference bench's storage-backed
    size (bench.py:3704-3723, streaming_freshness): the first 2,000,000
    out-edges of the graph500 R-MAT graph in source order, label "link",
    written by the columnar bulk loader into an in-memory store, loaded by
    the edgestore scan, and run through graph.compute().submit() on the
    card (the ranks' write_back and reload run on the indexed phase's
    2^17-vertex graph)."""
    import torch
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import connected_components

    from janusgraph_tpu_torch.core.bulk import bulk_add_edges, bulk_add_vertices
    from janusgraph_tpu_torch.core.graph import open_graph
    from janusgraph_tpu_torch.olap import GPUExecutor, kernels, run_on
    from janusgraph_tpu_torch.olap.csr import load_csr_snapshot
    from janusgraph_tpu_torch.olap.programs import (
        ConnectedComponentsProgram,
        PageRankProgram,
    )

    phase_t0 = time.perf_counter()
    n = csr.num_vertices
    cap = min(2_000_000, csr.num_edges)
    src = np.repeat(np.arange(n), np.diff(csr.out_indptr))[:cap]
    dst = np.asarray(csr.out_dst[:cap], dtype=np.int64)
    g = open_graph({"storage.backend": "inmemory"})
    t0 = time.perf_counter()
    vids = bulk_add_vertices(g, n)
    bulk_v_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    bulk_add_edges(g, "link", vids[src], vids[dst])
    bulk_e_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    loaded, epoch = load_csr_snapshot(g)
    load_s = time.perf_counter() - t0
    _check_written(loaded, vids, src, dst, "load_csr")

    emit("stored_load", vertices=n, edges=cap, bulk_vertices_s=bulk_v_s,
         bulk_edges_s=bulk_e_s, load_csr_s=load_s, epoch=epoch,
         capture_decode_s=g.change_capture.decode_s)

    def pagerank():
        # tol=0: all 20 supersteps run (this graph converges below the
        # default tol of 1e-9 in fewer)
        return PageRankProgram(max_iterations=20, tol=0.0)

    # cold: the snapshot scans the store and builds the executor (its
    # first superstep eager); warm: no scan, the cached executor replays
    # its captured graphs, so the device counter holds the count
    walls, run_walls, submit_runs, results = [], [], [], []
    for path in ("cold", "warm"):
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        TEL.label = f"stored_{path}"
        res, runs = counted(lambda: g.compute().program(pagerank()).submit(), 20)
        walls.append(time.perf_counter() - t0)
        TEL.hold_submit(res)
        run_walls.append(res.run_info["run_wall_s"])
        submit_runs.append(runs)
        results.append(res)
        if res.run_info["snapshot"]["path"] != path:
            raise RuntimeError(f"submit() took {res.run_info['snapshot']}, expected {path}")
        if path == "cold" and kernels.launch_counts()["sorted_segment_sum"] < 1:
            raise RuntimeError("submit(): the segment sum was not launched eagerly")
    first, warm = results
    if warm.csr is not first.csr:
        raise RuntimeError("the warm submit did not run over the cold submit's snapshot")
    info = dict(warm.run_info)
    if info["routing"]["device"] != "cuda" or info["supersteps"] != 20:
        raise RuntimeError(f"submit() did not run 20 supersteps on the card: {info}")
    rank = warm.states["rank"]
    if not bits_equal(rank, first.states["rank"]):
        raise RuntimeError("two submits of PageRank differ")
    direct = run_on(loaded, pagerank())["rank"]
    if not bits_equal(rank, direct):
        raise RuntimeError("submit()'s ranks differ from run_on over the loaded CSR")
    want = pagerank_fp64(loaded, 20)
    rel = float(np.max(np.abs(rank.astype(np.float64) - want) / want))
    if not np.isfinite(rank).all() or rel > RANK_REL:
        raise RuntimeError(f"submit()'s ranks: max rel diff {rel} from float64")

    # the segment sum against its plain version on the plans submit() ran,
    # built by the executor's own code from the CSR submit() loaded: the
    # in-plan fed PageRank's messages (rank / out-degree at each in-edge's
    # source), and below the "link" channel's plan of the traverse
    ex = GPUExecutor(warm.csr, strategy="segsum")
    in_plan = ex._segsum_plan("in")
    outdeg = torch.as_tensor(warm.csr.out_degree, device="cuda").clamp_min(1).float()
    msg = torch.as_tensor(rank, device="cuda") / outdeg
    in_src = torch.as_tensor(warm.csr.in_src.astype(np.int64), device="cuda")
    data = torch.index_select(msg, 0, in_src)
    _p, _g, in_err = check_plan("stored_in", in_plan, data, kernels)
    nbytes = in_plan.function_bytes()
    plan_checks = {"in": {
        "edges": in_plan.num_edges, "num_ctas": in_plan.num_ctas, "max_abs_err": in_err,
        "kernel_ms": flushed_ms(lambda: kernels.sorted_segment_sum(data, in_plan), iters=10),
        "plain_ms": flushed_ms(lambda: kernels.sorted_segment_sum_plain(data, in_plan), iters=5),
        "bytes": nbytes, "bound_ms": nbytes / PEAK_BYTES_PER_S * 1e3}}
    del ex, msg, in_src, data

    lsrc = np.repeat(np.arange(n), np.diff(loaded.out_indptr))
    adj = coo_matrix((np.ones(cap), (lsrc, loaded.out_dst)), shape=(n, n)).tocsr()
    del lsrc
    t0 = time.perf_counter()
    comp = g.compute().program(ConnectedComponentsProgram()).submit()
    cc_wall = time.perf_counter() - t0
    ncomp, labels = connected_components(adj, directed=True, connection="weak")
    lowest = np.full(ncomp, n, dtype=np.int64)
    np.minimum.at(lowest, labels, np.arange(n))
    if not np.array_equal(comp.states["component"].astype(np.int64), lowest[labels]):
        raise RuntimeError("submit()'s CC differs from scipy's components")

    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    trav, trav_runs = counted(lambda: g.compute().traverse(
        ("out", ["link"]), ("out", ["link"]), ("out", ["link"])).submit(), 3)
    trav_wall = time.perf_counter() - t0
    tex = GPUExecutor(trav.csr, strategy="segsum")
    for name in trav.program.edge_channels:
        tex._channel_pack(trav.program, name).segsum()
    plan_checks.update(channel_plan_checks(tex, "stored", kernels))
    del tex
    x = np.ones(n)
    for _ in range(3):
        x = adj.T @ x
    # float32 counts are exact integers below 2^24: there every vertex's
    # count equals the float64 product's; above it the float32 sums round,
    # and the counts and the total are held at the kernel's tolerance
    counts = trav.states["count"]
    total = float(counts.astype(np.float64).sum())
    exact = x < 2.0 ** 24
    if not np.array_equal(counts[exact].astype(np.float64), x[exact]):
        raise RuntimeError("traverse(): 3-hop counts below 2^24 differ from float64")
    if not np.allclose(counts, x, rtol=1e-4, atol=0) or abs(total - x.sum()) > 1e-4 * x.sum():
        raise RuntimeError(f"traverse(): 3-hop total {total} against {x.sum()}")

    torch.cuda.synchronize()
    emit("stored", vertices=n, edges=cap, source="bench.py:3704-3723",
         bulk_vertices_s=bulk_v_s, bulk_edges_s=bulk_e_s, load_csr_s=load_s,
         epoch=epoch, submit_first_wall_s=walls[0], submit_warm_wall_s=walls[1],
         submit_cold_run_wall_s=run_walls[0], submit_warm_run_wall_s=run_walls[1],
         run_wall_s=info["wall_s"], path=info["path"],
         strategy_resolved=info["strategy_resolved"],
         kernel_runs_per_submit=submit_runs, max_rel_diff_vs_fp64=rel,
         cc_wall_s=cc_wall, cc_supersteps=comp.run_info["supersteps"],
         components=int(ncomp), traverse_wall_s=trav_wall, traverse_kernel_runs=trav_runs,
         total_3hop=total, total_3hop_fp64=float(x.sum()),
         max_vertex_3hop=float(counts.max()), vertices_exact_3hop=int(exact.sum()),
         plan_checks=plan_checks, seconds=time.perf_counter() - phase_t0)
    return {"graph": g, "loaded": loaded, "rank": rank, "rank64": want,
            "walls": walls, "run_walls": run_walls,
            "launches": submit_runs[0], "launches_warm": submit_runs[1],
            "launches_traverse": trav_runs,
            "max_abs_err": max(c["max_abs_err"] for c in plan_checks.values())}


def _held_to(ref_csr, ref_rank, want64, label, rel=1e-6):
    """A check of a submit's load and ranks against a reference load of the
    same graph (``ref_csr``, ``ref_rank``) and float64 PageRank
    (``want64``): the same vertex ids and edges (as sets); ranks bitwise
    equal to the reference's where the CSR arrays are equal, else within
    ``rel`` relative of them; within ``rel`` relative of float64 either
    way."""

    def edge_key(c):
        s = np.repeat(np.arange(c.num_vertices, dtype=np.int64), np.diff(c.out_indptr))
        return np.sort(s * c.num_vertices + c.out_dst)

    ref_edges = edge_key(ref_csr)

    def held(res, name=label):
        got = res.csr
        if not np.array_equal(got.vertex_ids, ref_csr.vertex_ids):
            raise RuntimeError(f"{name}: the loaded vertex ids are not the reference load's")
        if not np.array_equal(edge_key(got), ref_edges):
            raise RuntimeError(f"{name}: the loaded edges are not the reference load's")
        differ = [f for f in ("out_indptr", "out_dst", "in_indptr", "in_src")
                  if not np.array_equal(getattr(got, f), getattr(ref_csr, f))]
        rank = res.states["rank"]
        if not np.isfinite(rank).all():
            raise RuntimeError(f"{name}: ranks are not finite")
        rel_ref = max_rel(rank, ref_rank)
        rel64 = float(np.max(np.abs(rank.astype(np.float64) - want64) / want64))
        if rel64 > rel:
            raise RuntimeError(f"{name}: ranks rel {rel64} of float64")
        if not differ:
            if not bits_equal(rank, ref_rank):
                raise RuntimeError(f"{name}: equal CSR arrays, ranks not bitwise equal")
            held_by = "bitwise"
        elif rel_ref > rel:
            raise RuntimeError(f"{name}: ranks rel {rel_ref} of the reference load's")
        else:
            held_by = f"rel {rel:g}"
        return {"csr_arrays_equal": not differ, "csr_arrays_differ": differ,
                "ranks_held": held_by, "max_rel_vs_reference": rel_ref,
                "max_rel_vs_fp64": rel64}

    return held


def _check_written(loaded, vids, src, dst, label):
    """Fails unless ``loaded`` is the graph written as vertices ``vids`` and
    edges ``vids[src] -> vids[dst]``: vertex i of the loaded CSR is
    vids[order[i]] (the scan sorts by vertex id), and its out-edges are the
    written edges mapped through the same order, as a set."""
    n = len(vids)
    if loaded.num_vertices != n or loaded.num_edges != len(src):
        raise RuntimeError(f"{label}: {loaded.num_vertices} v, {loaded.num_edges} e loaded, "
                           f"{n} v, {len(src)} e written")
    order = np.argsort(vids, kind="stable")
    if not np.array_equal(loaded.vertex_ids, vids[order]):
        raise RuntimeError(f"{label}: the vertex ids are not the written ones")
    rank_of = np.empty(n, dtype=np.int64)
    rank_of[order] = np.arange(n)
    got_src = np.repeat(np.arange(n, dtype=np.int64), np.diff(loaded.out_indptr))
    key = lambda a, b: np.sort(a.astype(np.int64) * n + b)  # noqa: E731
    if not np.array_equal(key(got_src, loaded.out_dst), key(rank_of[src], rank_of[dst])):
        raise RuntimeError(f"{label}: the edges are not the written ones")


def _submit_counted(held):
    """``submit(graph, label, path)``: a cold PageRank(20, tol=0) submit on
    the card, 20 kernel runs, through the expected snapshot path, its load
    and ranks checked by ``held``; (result, runs, record)."""
    from janusgraph_tpu_torch.olap import kernels
    from janusgraph_tpu_torch.olap.programs import PageRankProgram

    def submit(graph, label, path):
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        res, runs = counted(lambda: graph.compute().program(
            PageRankProgram(max_iterations=20, tol=0.0)).submit(), 20)
        wall = time.perf_counter() - t0
        if res.run_info["snapshot"]["path"] != path:
            raise RuntimeError(f"{label}: submit() took {res.run_info['snapshot']}, expected {path}")
        if kernels.launch_counts()["sorted_segment_sum"] < 1:
            raise RuntimeError(f"{label}: the segment sum was not launched")
        if res.run_info["routing"]["device"] != "cuda" or res.run_info["supersteps"] != 20:
            raise RuntimeError(f"{label}: not 20 supersteps on the card: {res.run_info}")
        return res, runs, {"submit_wall_s": wall, "run_wall_s": res.run_info["run_wall_s"],
                           "kernel_runs": runs, **held(res, label)}

    return submit


def _write_local(directory, csr, scale_edges):
    """Open a local directory (fsync on), bulk-load the draw's vertices and
    first ``scale_edges`` out-edges (label "link") and close it; the
    written vertex ids, the edges' source and target indexes into them,
    and a record of the walls and the WAL's bytes."""
    import os

    from janusgraph_tpu_torch.core.bulk import bulk_add_edges, bulk_add_vertices
    from janusgraph_tpu_torch.core.graph import open_graph

    n = csr.num_vertices
    src = np.repeat(np.arange(n), np.diff(csr.out_indptr))[:scale_edges]
    dst = np.asarray(csr.out_dst[:scale_edges], dtype=np.int64)
    g = open_graph({"storage.backend": "local", "storage.directory": directory})
    t0 = time.perf_counter()
    vids = bulk_add_vertices(g, n)
    bulk_v_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    bulk_add_edges(g, "link", vids[src], vids[dst])
    bulk_e_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    g.close()
    close_s = time.perf_counter() - t0
    return vids, src, dst, {"bulk_vertices_s": bulk_v_s, "bulk_edges_s": bulk_e_s,
                            "close_s": close_s,
                            "wal_bytes": os.path.getsize(os.path.join(directory, "store.wal"))}


def stored_local_phase(stored, csr, args, emit, remote=None) -> dict:
    """The stored phase's graph in a persistent local directory
    (storage.backend "local", storage.fsync on): the columnar bulk load and
    close (the WAL's bytes); then ``remote(directory, held, submit)`` (the
    remote phase: a storage server in its own process over this directory,
    its loads, 8 loader processes among them, held to the stored phase's
    CSR and ranks). The rest runs on a 2^LOCAL_SCALE-vertex directory of
    the same draw (the first out-edges in source order at the stored
    size's edges per vertex), written the same way: a reopen (the WAL
    replay) and a cold submit through the in-process scan, its load the
    written graph and its ranks within 1e-6 relative of float64; a cold
    submit through 8 loader processes (storage.distributed-load-workers;
    each replays the WAL) held the same way; a transaction of 1,000 edges of a LOCK-consistency
    label against the same on a default label and the warm submit that
    reads both; compact(), the reopen from the snapshot, drop_graph. Its
    ``seconds`` leave the remote phase out."""
    import os
    import shutil
    import tempfile

    import torch

    from janusgraph_tpu_torch.core.codecs import Consistency
    from janusgraph_tpu_torch.core.graph import drop_graph, open_graph
    from janusgraph_tpu_torch.observability import registry
    from janusgraph_tpu_torch.olap import kernels, rmat_csr
    from janusgraph_tpu_torch.olap.programs import PageRankProgram

    phase_t0 = time.perf_counter()
    n = csr.num_vertices
    cap = min(2_000_000, csr.num_edges)
    td = tempfile.mkdtemp(prefix="stored_local_")
    directory = os.path.join(td, "graph")
    small_dir = os.path.join(td, "small")
    cfg = {"storage.backend": "local", "storage.directory": small_dir}

    def pagerank():
        return PageRankProgram(max_iterations=20, tol=0.0)

    try:
        # (1) the stored size: load and persist (the 8-loader submit runs
        # on the 2^LOCAL_SCALE directory below and over the wire in the
        # remote phase, for the smoke's time limit)
        _vids, _src, _dst, stored_load = _write_local(directory, csr, cap)
        held = _held_to(stored["loaded"], stored["rank"], stored["rank64"], "stored")
        submit = _submit_counted(held)

        # (2) the remote phase over the same directory
        remote_out, remote_s = None, 0.0
        if remote is not None:
            t0 = time.perf_counter()
            remote_out = remote(directory, held, submit)
            remote_s = time.perf_counter() - t0
        shutil.rmtree(directory, ignore_errors=True)

        # (3) the 2^LOCAL_SCALE directory: reopen (the WAL replay), a cold
        # submit through the in-process scan, its load the written graph
        small = rmat_csr(LOCAL_SCALE, 16, seed=args.seed)
        sn = small.num_vertices
        scap = min(2_000_000 >> (20 - LOCAL_SCALE), small.num_edges)
        vids, ssrc, sdst, small_load = _write_local(small_dir, small, scap)
        del small

        def held_written(res, label):
            _check_written(res.csr, vids, ssrc, sdst, label)
            rank = res.states["rank"]
            want64 = pagerank_fp64(res.csr, 20)
            rel64 = float(np.max(np.abs(rank.astype(np.float64) - want64) / want64))
            if not np.isfinite(rank).all() or rel64 > 1e-6:
                raise RuntimeError(f"{label}: ranks rel {rel64} of float64")
            return {"load_held": "the written graph", "max_rel_vs_fp64": rel64}

        # a cold submit through 8 loader processes (the card's machine has
        # 8 cores), each of which replays the store
        per_w = {}
        for w in (8,):
            t0 = time.perf_counter()
            gw = open_graph(dict(cfg, **{"storage.distributed-load-workers": w}))
            open_s = time.perf_counter() - t0
            res, _runs, rec = _submit_counted(held_written)(gw, f"workers={w}", "distributed")
            rec.update(open_s=open_s, load=registry.last_run("olap.distributed_load"))
            if rec["load"]["workers"] != w or rec["load"]["probed"]:
                raise RuntimeError(f"workers={w}: the load ran {rec['load']}")
            per_w[w] = rec
            del res
            gw.close()
        t0 = time.perf_counter()
        g = open_graph(cfg)
        replay_s = time.perf_counter() - t0

        res1, runs1, w1 = _submit_counted(held_written)(g, "workers=1", "cold")
        rank1 = res1.states["rank"]
        del res1

        # (4) a LOCK-consistency label against a default one, 1,000 edges a
        # transaction, then the warm submit that reads both
        mgmt = g.management()
        mgmt.make_edge_label("locked_link")
        mgmt.set_consistency("locked_link", Consistency.LOCK)
        mgmt.make_edge_label("plain_link")
        rng = np.random.default_rng(args.seed)
        commits = {}
        for label in ("locked_link", "plain_link"):
            a = vids[rng.integers(0, sn, 1000)]
            b = vids[rng.integers(0, sn, 1000)]
            tx = g.new_transaction()
            for x, y in zip(a.tolist(), b.tolist()):
                tx.add_edge(tx.get_vertex(x), label, tx.get_vertex(y))
            t0 = time.perf_counter()
            tx.commit()
            commits[label] = time.perf_counter() - t0
        lock_rows = sum(1 for _ in g.backend.manager.open_database("edgestore_lock_").kv.scan(
            b"", None, None))
        if lock_rows:
            raise RuntimeError(f"{lock_rows} lock claims left after the commits")
        kernels.reset_launch_counts()
        before = kernels.device_launches("cuda")
        t0 = time.perf_counter()
        warm = g.compute().program(pagerank()).submit()
        torch.cuda.synchronize()
        warm_wall = time.perf_counter() - t0
        warm_runs = kernels.device_launches("cuda") - before
        # (on a graph this small the overlay may compact after the run)
        warm_path = {k: warm.run_info["snapshot"].get(k) for k in ("path", "overlay")}
        if warm_path != {"path": "fused", "overlay": 2000} or warm_runs < 20:
            raise RuntimeError(f"the warm submit after the commits: {warm.run_info['snapshot']}, "
                               f"{warm_runs} kernel runs")
        wrank = warm.states["rank"]
        if (wrank.shape != rank1.shape or not np.isfinite(wrank).all()
                or abs(float(wrank.astype(np.float64).sum()) - 1.0) > 1e-3
                or bits_equal(wrank, rank1)):
            raise RuntimeError("the warm submit's ranks do not show the writes")
        del warm

        # (5) compact, reopen from the snapshot, drop
        kv = g.backend.manager.kv_manager
        cells = {name: len(st.mem.data) for name, st in kv._stores.items()}
        t0 = time.perf_counter()
        kv.compact()
        compact_s = time.perf_counter() - t0
        snapshot_bytes = os.path.getsize(os.path.join(small_dir, "store.snapshot"))
        g.close()
        t0 = time.perf_counter()
        g = open_graph(cfg)
        snapshot_reopen_s = time.perf_counter() - t0
        again = {name: len(st.mem.data) for name, st in g.backend.manager.kv_manager._stores.items()}
        if {k: v for k, v in again.items() if v} != {k: v for k, v in cells.items() if v}:
            raise RuntimeError(f"the reopen from the snapshot holds {again}, not {cells}")
        drop_graph(g)
        left = sorted(f for f in os.listdir(small_dir) if f.startswith("store."))
        if left:
            raise RuntimeError(f"drop_graph left {left}")
    finally:
        shutil.rmtree(td, ignore_errors=True)

    emit("stored_local", vertices=n, edges=cap, fsync=True, **stored_load, workers=per_w,
         small={"vertices": sn, "edges": scap, **small_load, "replay_s": replay_s,
                "cells": cells, "workers_1": w1,
                "locked_commit_s": commits["locked_link"],
                "plain_commit_s": commits["plain_link"],
                "warm_after_commits_wall_s": warm_wall,
                "warm_after_commits_kernel_runs": warm_runs, "compact_s": compact_s,
                "snapshot_bytes": snapshot_bytes, "snapshot_reopen_s": snapshot_reopen_s},
         cut=f"the directory's in-process reopen and submit, LOCK commits, compact(), "
             f"snapshot reopen and drop on a 2^{LOCAL_SCALE}-vertex directory (the smoke's "
             "time limit; the 8-loader submit and the remote phase keep the stored size)",
         seconds=time.perf_counter() - phase_t0 - remote_s)
    return {"launches": runs1, "launches_by_workers": {w: r["kernel_runs"] for w, r in per_w.items()},
            "launches_locked_warm": warm_runs, "remote": remote_out}


#: the remote phase's limits: the storage server's start (its replay of the
#: directory included), and the budget of the whole phase
SERVER_START_S = 120.0
REMOTE_BUDGET_S = 120.0
#: the remote phase's point reads from 8 threads (2.6-3.4 s for 10,000 on
#: the H100's host, cut to make room in the phase's budget)
POINT_READS = 2_000


def start_storage_server(directory):
    """``python -m janusgraph_tpu_torch storage-server --port 0 --directory
    DIR`` in its own process (no CUDA context: the server never touches the
    card); returns (the process, host, port, seconds to its address line).
    Fails, with the process killed, if the line does not come within
    SERVER_START_S."""
    import os
    import re
    import threading

    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    env["PYTHONPATH"] = os.pathsep.join(p for p in (root, env.get("PYTHONPATH")) if p)
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "janusgraph_tpu_torch", "storage-server", "--port", "0",
         "--directory", directory],
        stdout=subprocess.PIPE, text=True, cwd=root, env=env,
    )
    line = []
    reader = threading.Thread(target=lambda: line.append(proc.stdout.readline()), daemon=True)
    reader.start()
    reader.join(SERVER_START_S)
    m = re.search(r"listening on ([\d.]+):(\d+)", line[0]) if line else None
    if m is None:
        proc.kill()
        proc.wait(30)
        raise RuntimeError(f"the storage server printed no address within {SERVER_START_S} s "
                           f"(exit {proc.returncode}): {line}")
    return proc, m.group(1), int(m.group(2)), time.perf_counter() - t0


def stop_storage_server(proc) -> dict:
    """Stop the server: it must still be running (an early exit fails the
    run) and must be gone after SIGTERM."""
    early = proc.poll()
    proc.terminate()
    try:
        proc.wait(30)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait(30)
        raise RuntimeError("the server outlived SIGTERM")
    if early is not None:
        raise RuntimeError(f"the server exited early with {early}")
    return {"exit": proc.returncode}


#: a remote index server over memindex in its own process: it prints its
#: address and whether torch was imported, then serves until terminated
INDEX_SERVER = (
    "import sys, time\n"
    "from janusgraph_tpu_torch.indexing import InMemoryIndexProvider, RemoteIndexServer\n"
    "srv = RemoteIndexServer(InMemoryIndexProvider()).start()\n"
    "print('index server listening on %s:%d torch=%s' % (*srv.address, 'torch' in sys.modules),"
    " flush=True)\n"
    "while True:\n"
    "    time.sleep(3600)\n"
)


def start_index_server():
    """INDEX_SERVER in its own process (no CUDA context); returns (the
    process, host, port, seconds to its address line, whether it imported
    torch). Fails, with the process killed, if the line does not come
    within SERVER_START_S."""
    import os
    import re
    import threading

    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    env["PYTHONPATH"] = os.pathsep.join(p for p in (root, env.get("PYTHONPATH")) if p)
    t0 = time.perf_counter()
    proc = subprocess.Popen([sys.executable, "-c", INDEX_SERVER], stdout=subprocess.PIPE,
                            text=True, cwd=root, env=env)
    line = []
    reader = threading.Thread(target=lambda: line.append(proc.stdout.readline()), daemon=True)
    reader.start()
    reader.join(SERVER_START_S)
    m = re.search(r"listening on ([\d.]+):(\d+) torch=(\w+)", line[0]) if line else None
    if m is None:
        proc.kill()
        proc.wait(30)
        raise RuntimeError(f"the index server printed no address within {SERVER_START_S} s "
                           f"(exit {proc.returncode}): {line}")
    return proc, m.group(1), int(m.group(2)), time.perf_counter() - t0, m.group(3) == "True"


def remote_phase(directory, held, submit, args, emit) -> dict:
    """The remote store at the stored size, over the directory the
    stored_local phase wrote (the stored phase's graph): a storage server
    in its own process, then through storage.backend "remote" a cold
    submit over the in-process scan and one through 8 loader processes,
    each held as stored_local holds its loads (20 kernel runs); a
    1,000-edge transaction over the wire and the warm fused submit that
    reads it (60 kernel runs) against a fresh scan over the wire; the same
    multi-slice read of 10,000 vertices' rows and point reads of the first
    POINT_READS of those rows from 8 threads with storage.remote.pipeline
    off, on, on and off (equal; walls and the pipeline's counters of each
    run); the kernel against its plain version on this phase's in-plan;
    the server stopped."""
    import threading

    import torch

    from janusgraph_tpu_torch.core.graph import open_graph
    from janusgraph_tpu_torch.observability import registry
    from janusgraph_tpu_torch.olap import GPUExecutor, kernels, run_on
    from janusgraph_tpu_torch.olap.csr import load_csr_snapshot
    from janusgraph_tpu_torch.olap.programs import PageRankProgram
    from janusgraph_tpu_torch.storage.kcvs import KeySliceQuery, SliceQuery
    from janusgraph_tpu_torch.storage.remote import RemoteStoreManager

    phase_t0 = time.perf_counter()
    proc, host, port, server_open_s = start_storage_server(directory)
    cfg = {"storage.backend": "remote", "storage.hostname": host, "storage.port": port}
    graphs = []
    try:
        # (2) a cold submit through the in-process scan over the wire
        t0 = time.perf_counter()
        g = open_graph(cfg)
        graphs.append(g)
        open_s = time.perf_counter() - t0
        res1, runs1, w1 = submit(g, "remote", "cold")
        w1["open_s"] = open_s
        base = res1.csr

        # (3) a cold submit through 8 loader processes over the wire: their
        # configs carry the server's address, none opens a directory
        t0 = time.perf_counter()
        gw = open_graph(dict(cfg, **{"storage.distributed-load-workers": 8}))
        graphs.append(gw)
        gw_open_s = time.perf_counter() - t0
        res8, runs8, w8 = submit(gw, "remote workers=8", "distributed")
        w8.update(open_s=gw_open_s, load=registry.last_run("olap.distributed_load"))
        if w8["load"]["workers"] != 8 or w8["load"]["probed"]:
            raise RuntimeError(f"remote workers=8: the load ran {w8['load']}")
        del res8
        gw.close()

        # (4) 1,000 edges committed over the wire, the warm fused submit
        # that reads them, and a fresh scan over the wire to hold it to
        rng = np.random.default_rng(args.seed + 16)
        n = base.num_vertices
        a_idx, b_idx = rng.integers(0, n, 1000), rng.integers(0, n, 1000)
        vids = base.vertex_ids
        tx = g.new_transaction()
        for x, y in zip(vids[a_idx].tolist(), vids[b_idx].tolist()):
            tx.add_edge(tx.get_vertex(x), "link", tx.get_vertex(y))
        t0 = time.perf_counter()
        tx.commit()
        commit_s = time.perf_counter() - t0
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        warm, warm_runs = counted(lambda: g.compute().program(
            PageRankProgram(max_iterations=20, tol=0.0)).submit(), 60)
        warm_wall = time.perf_counter() - t0
        if warm.run_info["snapshot"] != {"path": "fused", "overlay": 1000}:
            raise RuntimeError(f"remote warm submit: {warm.run_info['snapshot']}")
        t0 = time.perf_counter()
        fresh, _epoch = load_csr_snapshot(g)
        fresh_scan_s = time.perf_counter() - t0
        if not np.array_equal(fresh.vertex_ids, warm.csr.vertex_ids):
            raise RuntimeError("remote: the fresh scan's vertices are not the warm submit's")

        def edge_key(c):
            s_ = np.repeat(np.arange(c.num_vertices, dtype=np.int64), np.diff(c.out_indptr))
            return np.sort(s_ * c.num_vertices + c.out_dst)

        want_edges = np.sort(np.concatenate([edge_key(base), a_idx.astype(np.int64) * n + b_idx]))
        if not np.array_equal(edge_key(fresh), want_edges):
            raise RuntimeError("remote: the fresh scan's edges are not the base plus the commit")
        want = run_on(fresh, PageRankProgram(max_iterations=20, tol=0.0))["rank"]
        rel_fresh = max_rel(warm.states["rank"], want)
        if not np.isfinite(warm.states["rank"]).all() or not rel_fresh <= RANK_REL:
            raise RuntimeError(f"remote warm submit vs a fresh scan: max rel {rel_fresh}")
        del warm, want

        # (5) the same reads with the pipeline on and off: one multi-slice
        # of 10,000 vertices' whole rows, and point reads of the first
        # POINT_READS of the same rows from 8 threads; equal results, walls
        # and counters, no gate on their ratio. The settings run off, on,
        # on, off, so neither always runs first
        keys = [g.idm.get_key(int(v)) for v in vids[rng.choice(n, min(n, 10_000), replace=False)]]
        point_keys = keys[:POINT_READS]
        row_q = SliceQuery(bytes([0]), bytes([4]))
        reads = {True: [], False: []}
        for pipe in (False, True, True, False):
            client = RemoteStoreManager(host, port, pipeline=pipe)
            try:
                store = client.open_database("edgestore")
                before = {k: registry.snapshot().get(f"storage.remote.pipeline.{k}", {}).get(
                    "count", 0) for k in ("ops", "wire_frames", "merged_ops")}
                t0 = time.perf_counter()
                multi = store.get_slice_multi(keys, row_q, None)
                multi_s = time.perf_counter() - t0
                point, errs = {}, []

                def worker(part):
                    try:
                        for k in part:
                            point[k] = store.get_slice(KeySliceQuery(k, row_q), None)
                    except Exception as e:  # noqa: BLE001 - raised below
                        errs.append(e)

                threads = [threading.Thread(target=worker, args=(point_keys[i::8],))
                           for i in range(8)]
                t0 = time.perf_counter()
                for t in threads:
                    t.start()
                for t in threads:
                    t.join(300)
                point_s = time.perf_counter() - t0
                if errs or len(point) != len(point_keys):
                    raise RuntimeError(f"remote point reads (pipeline={pipe}): {errs[:1]}")
                if client._mux is not None:
                    client._mux.flush_stats()
                counters = {k: registry.snapshot().get(f"storage.remote.pipeline.{k}", {}).get(
                    "count", 0) - v for k, v in before.items()}
                reads[pipe].append({"multi": multi, "point": point, "multi_s": multi_s,
                                    "point_s": point_s,
                                    "mux_engaged": client._mux is not None, **counters})
            finally:
                client.close()
        first = reads[True][0]
        if any(r["multi"] != first["multi"] or r["point"] != first["point"]
               for r in reads[True] + reads[False]) or any(
                first["multi"][k] != first["point"][k] for k in point_keys):
            raise RuntimeError("remote: the pipelined and sync reads differ")
        cells = sum(len(v) for v in first["multi"].values())
        # each key: the first run's value, then the second's
        read_rec = {("pipeline_on" if p else "pipeline_off"): {
            k: [r[k] for r in runs] for k in runs[0] if k not in ("multi", "point")}
            for p, runs in reads.items()}
        del reads, first

        # (6) the kernel against its plain version on this phase's in-plan,
        # PageRank's messages at the cold submit's ranks
        ex = GPUExecutor(base, strategy="segsum")
        in_plan = ex._segsum_plan("in")
        outdeg = torch.as_tensor(base.out_degree, device="cuda").clamp_min(1).float()
        msg = torch.as_tensor(res1.states["rank"], device="cuda") / outdeg
        data = torch.index_select(msg, 0, torch.as_tensor(base.in_src.astype(np.int64),
                                                          device="cuda"))
        _p, _g, in_err = check_plan("remote_in", in_plan, data, kernels)
        nbytes = in_plan.function_bytes()
        plan_check = {
            "edges": in_plan.num_edges, "num_ctas": in_plan.num_ctas, "max_abs_err": in_err,
            "kernel_ms": flushed_ms(lambda: kernels.sorted_segment_sum(data, in_plan), iters=10),
            "plain_ms": flushed_ms(lambda: kernels.sorted_segment_sum_plain(data, in_plan),
                                   iters=5),
            "bytes": nbytes, "bound_ms": nbytes / PEAK_BYTES_PER_S * 1e3}
        del ex, msg, data, res1
        torch.cuda.synchronize()
    finally:
        for gr in graphs:
            if gr._open:
                gr.close()
        stopped = stop_storage_server(proc)
    seconds = time.perf_counter() - phase_t0
    emit("remote", vertices=int(base.num_vertices), edges=int(base.num_edges),
         server_open_s=server_open_s, server=stopped, workers_1=w1, workers=w8,
         commit_1000_edges_s=commit_s, warm_fused_wall_s=warm_wall,
         warm_fused_kernel_runs=warm_runs, fresh_scan_s=fresh_scan_s,
         max_rel_warm_vs_fresh=rel_fresh,
         reads={"keys": len(keys), "point_keys": len(point_keys), "cells": cells, **read_rec},
         plan_check=plan_check, budget_s=REMOTE_BUDGET_S, seconds=seconds)
    if seconds > REMOTE_BUDGET_S:
        raise RuntimeError(f"the remote phase took {seconds:.1f} s, past its {REMOTE_BUDGET_S} s")
    return {"launches": runs1, "launches_w8": runs8, "launches_warm": warm_runs,
            "max_abs_err": in_err}


#: the sharded phase's deployment: three storage nodes, the fault injector
#: on with 1% read and write faults and one superstep preemption, and
#: checkpoints every 2 supersteps for the executor's auto-resume (no scan
#: kill: over an unordered store the scan has no retry, in both packages)
SHARDED_NODES = 3
SHARDED_FAULTS = {
    "storage.faults.enabled": True,
    "storage.faults.read-error-rate": 0.01,
    "storage.faults.write-error-rate": 0.01,
    "storage.faults.preempt-superstep": 3,
    "computer.checkpoint-every": 2,
    "storage.backoff-base-ms": 1.0,
    "storage.backoff-max-ms": 4.0,
}
#: the node outage of the sharded phase's reads: node 1 is healed this long
#: after it failed, while the retry guard replays the read
SHARDED_OUTAGE_S = 0.25


def sharded_phase(stored, csr, args, emit) -> dict:
    """The sharded store at the stored size under seeded faults: the
    stored phase's draw (its vertices and first 2,000,000 "link" out-edges)
    bulk-loaded into storage.backend "sharded" (SHARDED_NODES in-memory
    nodes) with the fault injector on (SHARDED_FAULTS, seeded with
    --seed); a cold graph.compute().program(PageRank(20, tol=0)).submit()
    on the card, whose unordered scan loads the CSR and whose run the
    plan preempts once at a checkpoint boundary and the executor resumes
    once; its ranks bitwise equal to a fault-free run_on over the submit's
    own CSR, and held to the stored phase's (bitwise where the CSR arrays
    are equal, else within RANK_REL of its ranks and of float64); the
    kernel's device
    count; the kernel against its plain version on this in-plan, timed with
    the L2 flushed; a batch of rows read while node 1 is down (healed
    SHARDED_OUTAGE_S later, the retry guard replaying the read) and again
    after, equal; the journal's counts by kind."""
    import collections
    import os
    import shutil
    import tempfile
    import threading

    import torch

    from janusgraph_tpu_torch.core.bulk import bulk_add_edges, bulk_add_vertices
    from janusgraph_tpu_torch.core.graph import open_graph
    from janusgraph_tpu_torch.exceptions import TemporaryBackendError
    from janusgraph_tpu_torch.observability import registry
    from janusgraph_tpu_torch.olap import GPUExecutor, kernels, run_on
    from janusgraph_tpu_torch.olap.programs import PageRankProgram
    from janusgraph_tpu_torch.storage.kcvs import SliceQuery
    from janusgraph_tpu_torch.storage.sharded_store import _shard_of

    phase_t0 = time.perf_counter()
    n = csr.num_vertices
    cap = min(2_000_000, csr.num_edges)
    src = np.repeat(np.arange(n), np.diff(csr.out_indptr))[:cap]
    dst = np.asarray(csr.out_dst[:cap], dtype=np.int64)
    td = tempfile.mkdtemp(prefix="sharded_")
    cfg = {"storage.backend": "sharded", "storage.sharded-nodes": SHARDED_NODES,
           "storage.faults.seed": args.seed,
           "computer.checkpoint-path": os.path.join(td, "pagerank.npz"), **SHARDED_FAULTS}

    def pagerank():
        return PageRankProgram(max_iterations=20, tol=0.0)

    def retries():
        return registry.snapshot().get("storage.backend_op.retries", {}).get("count", 0)

    g = None
    try:
        # (1)-(2) open over three nodes, the faults on; the columnar bulk load
        t0 = time.perf_counter()
        g = open_graph(cfg)
        open_s = time.perf_counter() - t0
        plan, mgr = g.fault_plan, g.backend.manager.wrapped
        if type(mgr).__name__ != "ShardedStoreManager" or len(mgr.nodes) != SHARDED_NODES:
            raise RuntimeError(f"the graph opened {g.backend.manager.name}")
        retries0 = retries()
        t0 = time.perf_counter()
        vids = bulk_add_vertices(g, n)
        bulk_v_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        bulk_add_edges(g, "link", vids[src], vids[dst])
        bulk_e_s = time.perf_counter() - t0
        load_retries = retries() - retries0
        node_rows = [m.open_database("edgestore").row_count() for m in mgr.nodes]

        # (3) the cold submit: the unordered scan, the run preempted at a
        # checkpoint boundary and resumed from it
        kernels.reset_launch_counts()
        before = kernels.device_launches("cuda")
        t0 = time.perf_counter()
        res = g.compute().program(pagerank()).submit()
        torch.cuda.synchronize()
        submit_wall = time.perf_counter() - t0
        runs = kernels.device_launches("cuda") - before
        info = res.run_info
        resumed = info.get("resume_steps", [])
        if (info["snapshot"]["path"] != "cold" or info["routing"]["device"] != "cuda"
                or info["supersteps"] != 20 or info.get("resumes") != 1 or len(resumed) != 1):
            raise RuntimeError(f"the faulted submit: {info['snapshot']}, "
                               f"{info.get('resumes')} resumes, {info['supersteps']} supersteps")
        supersteps = [e for e in plan.journal if e["kind"] == "superstep"]
        if len(supersteps) != 1 or supersteps[0]["step"] != resumed[0]["preempted_at"]:
            raise RuntimeError(f"the preemptions journaled: {supersteps}, resumed {resumed}")
        # (6) the device count: 20 supersteps, plus any the resume recomputed
        recomputed = resumed[0]["preempted_at"] - resumed[0]["from_step"]
        if runs != 20 + recomputed or kernels.launch_counts()["sorted_segment_sum"] < 1:
            raise RuntimeError(f"the faulted submit ran the kernel {runs} times "
                               f"({recomputed} supersteps recomputed)")
        rank = res.states["rank"]
        loaded = res.csr

        # (4) a fault-free run over the same snapshot: bitwise
        clean = run_on(loaded, pagerank())["rank"]
        if not np.isfinite(rank).all() or not bits_equal(rank, clean):
            raise RuntimeError("the resumed submit's ranks differ from a fault-free run_on")

        # (5) against the stored phase: the same vertices and edges; the
        # unordered scan orders a row's in-edges by node, so the arrays may
        # differ, and then the ranks are held within RANK_REL of that
        # phase's and of float64, as that phase holds its own
        vs_stored = _held_to(stored["loaded"], stored["rank"], stored["rank64"], "sharded",
                             rel=RANK_REL)(res)

        # (7) the kernel against its plain version on this in-plan
        ex = GPUExecutor(loaded, strategy="segsum")
        in_plan = ex._segsum_plan("in")
        outdeg = torch.as_tensor(loaded.out_degree, device="cuda").clamp_min(1).float()
        msg = torch.as_tensor(rank, device="cuda") / outdeg
        data = torch.index_select(msg, 0, torch.as_tensor(loaded.in_src.astype(np.int64),
                                                          device="cuda"))
        _p, _g, in_err = check_plan("sharded_in", in_plan, data, kernels)
        nbytes = in_plan.function_bytes()
        plan_check = {
            "edges": in_plan.num_edges, "num_ctas": in_plan.num_ctas, "max_abs_err": in_err,
            "kernel_ms": flushed_ms(lambda: kernels.sorted_segment_sum(data, in_plan), iters=10),
            "plain_ms": flushed_ms(lambda: kernels.sorted_segment_sum_plain(data, in_plan),
                                   iters=5),
            "bytes": nbytes, "bound_ms": nbytes / PEAK_BYTES_PER_S * 1e3}
        del ex, msg, data, res, clean
        torch.cuda.synchronize()

        # (8) rows read while node 1 is down and again after it heals: the
        # retry guard replays the read through the outage
        rng = np.random.default_rng(args.seed + 17)
        keys = [g.idm.get_key(int(v)) for v in loaded.vertex_ids[rng.choice(n, 2000, replace=False)]]
        on_node1 = sum(1 for k in keys if _shard_of(k, SHARDED_NODES) == 1)
        row_q = SliceQuery(bytes([0]), bytes([4]))
        store = g.backend.manager.open_database("edgestore")
        tx = g.backend.manager.begin_transaction()
        mgr.fail_node(1)
        try:
            mgr.open_database("edgestore").get_slice_multi(keys, row_q, tx)
            raise RuntimeError("a read of node 1's rows passed while it was down")
        except TemporaryBackendError as e:
            if "node 1 unavailable" not in str(e):
                raise
        healer = threading.Timer(SHARDED_OUTAGE_S, mgr.heal_node, args=(1,))
        r0 = retries()
        t0 = time.perf_counter()
        healer.start()
        try:
            during = g.backend.guard(lambda: store.get_slice_multi(keys, row_q, tx))
        finally:
            healer.join()
            mgr.heal_node(1)
        outage_read_s = time.perf_counter() - t0
        outage_retries = retries() - r0
        r0 = retries()
        t0 = time.perf_counter()
        after = g.backend.guard(lambda: store.get_slice_multi(keys, row_q, tx))
        healed_read_s = time.perf_counter() - t0
        healed_retries = retries() - r0
        if during != after or len(after) != len(keys) or not all(after.values()):
            raise RuntimeError("the rows read through the outage differ from those after it")
        if outage_retries < 1:
            raise RuntimeError("the read through the outage was not retried")
        journal = dict(collections.Counter(e["kind"] for e in plan.journal))
        counters = plan.counters()
    finally:
        if g is not None and g._open:
            g.close()
        shutil.rmtree(td, ignore_errors=True)
    emit("sharded", vertices=n, edges=cap, nodes=SHARDED_NODES, node_rows=node_rows,
         faults={k: v for k, v in cfg.items() if k.startswith("storage.faults")},
         open_s=open_s, bulk_vertices_s=bulk_v_s, bulk_edges_s=bulk_e_s,
         load_retries=load_retries, submit_wall_s=submit_wall,
         run_wall_s=info["run_wall_s"], resume_steps=resumed, kernel_runs=runs,
         supersteps_recomputed=recomputed, vs_stored=vs_stored, plan_check=plan_check,
         node_outage={"node": 1, "heal_after_s": SHARDED_OUTAGE_S, "keys": len(keys),
                      "keys_on_node": on_node1, "read_s": outage_read_s,
                      "guard_retries": outage_retries, "healed_read_s": healed_read_s,
                      "healed_retries": healed_retries},
         journal_by_kind=journal, plan_counters=counters,
         seconds=time.perf_counter() - phase_t0)
    return {"launches": runs, "max_abs_err": in_err, "plan_check": plan_check}


SHARDED_SLOTS = 8
#: the scale of part (a), every exchange x aggregation pair (the
#: reference's multichip dryrun ran its pairs at scale 14)
SHARDED_PAIR_SCALE = 14
SHARDED_PAIRS = (
    ("a2a", "ell"), ("a2a", "segment"), ("gather", "segment"), ("ring", "segment"),
    ("blocked", "ell"), ("blocked", "segment"),
)


def passthrough_program(op):
    """A one-superstep program whose state after it is the aggregate of
    its setup values (apply returns the aggregate): pins a sharded
    superstep to the blocked plan's numpy replay."""
    import torch

    from janusgraph_tpu_torch.olap.vertex_program import VertexProgram

    class Passthrough(VertexProgram):
        compute_keys = ("x",)
        max_iterations = 1
        combiner = op

        @staticmethod
        def values(n, active):
            return ((np.arange(n) % 89 + 1.0) / 7.0 * active).astype(np.float32)

        def setup(self, graph):
            x = self.values(graph.local_num_vertices, graph.active.cpu().numpy())
            return {"x": torch.as_tensor(x, device=graph.device)}, {}

        def message(self, state, step, graph):
            return state["x"]

        def apply(self, state, agg, step, mem, graph):
            return {"x": agg}, {}

        def terminate(self, memory):
            return False

    return Passthrough()


def sharded_olap_phase(stored, csr, rank, cc_want, bfs_seed, bfs_want, args, emit,
                       card: str) -> dict:
    """The sharded BSP executor (parallel/sharded.py) on one card: S =
    SHARDED_SLOTS slots of Mesh([cuda:0] * S), so every exchange runs on
    the card as copies, transposes and rolls between the slots' stacked
    blocks (nothing here crosses between cards). (a) at scale
    SHARDED_PAIR_SCALE, PageRank for 10 supersteps under every exchange x
    aggregation pair, each within RANK_REL of the single-device segsum run
    and of float64, with its superstep ms and exchange volume, and one
    blocked superstep of SUM and of MIN against the plan's numpy replay
    (bitwise but for the segment form's SUM, whose float atomics meet it
    within RANK_REL); (b) at the main run's scale under exchange "auto"
    and "blocked": each host plan's build seconds and the shard-measure
    probe's, PageRank for 20 supersteps fused bitwise equal to the host
    loop and within RANK_REL of the main run's ranks, CC equal to scipy's,
    the hub's 4-hop BFS through the sharded frontier equal to scipy's, the
    skew report; (c) a shard preemption at superstep 4 of (b)'s PageRank
    resumed from the shard checkpoint, bitwise equal to the uninterrupted
    run; (d) graph.compute(executor="sharded") on the stored graph (the
    default mesh: one slot on the card) within RANK_REL of the stored
    phase's single-device submit. The sharded path launches no hand
    kernel: the segment-sum kernel's device counter must not move across
    the sharded runs."""
    import shutil
    import tempfile

    import torch

    from janusgraph_tpu_torch.olap import GPUExecutor, kernels, rmat_csr
    from janusgraph_tpu_torch.olap.programs import (
        ConnectedComponentsProgram,
        PageRankProgram,
        ShortestPathProgram,
    )
    from janusgraph_tpu_torch.olap.vertex_program import INF, Combiner
    from janusgraph_tpu_torch.parallel import Mesh, ShardedExecutor, halo
    from janusgraph_tpu_torch.storage.faults import FaultPlan

    phase_t0 = time.perf_counter()
    mesh = Mesh([torch.device("cuda", 0)] * SHARDED_SLOTS)
    kernel_runs = 0

    def sharded_run(ex, program, **kw):
        """One sharded run; the segment-sum kernel must not run in it."""
        nonlocal kernel_runs
        before = kernels.device_launches("cuda")
        out = ex.run(program, **kw)
        torch.cuda.synchronize()
        ran = kernels.device_launches("cuda") - before
        kernel_runs += ran
        if ran:
            raise RuntimeError(f"the sharded path ran the segment-sum kernel {ran} times")
        return out

    def walls(info):
        recs = [r["wall_ms"] for r in info["superstep_records"][1:]] or [0.0]
        return float(np.mean(recs))

    # ---------------------------------------------- (a) every pair, s14
    small = rmat_csr(SHARDED_PAIR_SCALE, 16, seed=args.seed)
    single = GPUExecutor(small, strategy="segsum").run(PageRankProgram(max_iterations=10, tol=0.0))
    small64 = pagerank_fp64(small, 10)
    pairs = {}
    for exchange, agg in SHARDED_PAIRS:
        ex = ShardedExecutor(small, mesh=mesh, exchange=exchange, agg=agg)
        t0 = time.perf_counter()
        got = sharded_run(ex, PageRankProgram(max_iterations=10, tol=0.0), fused=False)["rank"]
        first_s = time.perf_counter() - t0
        got = sharded_run(ex, PageRankProgram(max_iterations=10, tol=0.0), fused=False)["rank"]
        info = ex.last_run_info
        rel, rel64 = max_rel(got, single["rank"]), max_rel(got, small64)
        if not np.isfinite(got).all() or rel > RANK_REL or rel64 > RANK_REL:
            raise RuntimeError(f"sharded {exchange}/{agg}: rel {rel} vs segsum, {rel64} vs fp64")
        row = {"superstep_ms": walls(info), "first_run_s": first_s, "rel_vs_segsum": rel,
               "rel_vs_fp64": rel64, "path": info["path"], **info["exchange"]}
        if exchange == "blocked":
            sc = ex._sharded(False)
            for op in (Combiner.SUM, Combiner.MIN):
                prog = passthrough_program(op)
                out = sharded_run(ex, prog, fused=False, frontier="off")["x"]
                want = halo.replay_superstep(
                    sc.blocked_plan, prog.values(sc.padded_n, sc.active), op,
                    has_weight=sc.has_weight, agg=agg)[: sc.real_n]
                exact = bits_equal(out, want)
                # equal entries (the MIN identity included) count 0
                with np.errstate(invalid="ignore"):
                    err = float(np.max(np.where(
                        out == want, 0.0, np.abs(out.astype(np.float64) - want))))
                # the packed form and every MIN are bitwise; the segment
                # form's SUM adds through float atomics on the card
                if not exact and (agg == "ell" or op == Combiner.MIN
                                  or max_rel(out[want > 0], want[want > 0]) > RANK_REL):
                    raise RuntimeError(f"blocked/{agg} {op} superstep vs replay: max abs {err}")
                row[f"replay_{op}"] = {"bitwise": exact, "max_abs_err": err}
        pairs[f"{exchange}/{agg}"] = row
        del ex
    emit("sharded_olap_pairs", scale=SHARDED_PAIR_SCALE, slots=SHARDED_SLOTS,
         vertices=small.num_vertices, edges=small.num_edges, pairs=pairs, card=card)

    # ------------------------------------------ (b) the main run's scale
    n = csr.num_vertices
    big = {}
    bfs_expect = np.where(bfs_want <= 4, bfs_want, INF).astype(np.float32)
    kept = None
    for exchange in ("auto", "blocked"):
        if exchange == "blocked" and (big["auto"]["exchange"], big["auto"]["agg"]) == (
                "blocked", "ell"):
            # "auto" took this layout on this card: the same run
            big["blocked"] = {"same_as": "auto"}
            continue
        ex = ShardedExecutor(csr, mesh=mesh, exchange=exchange, agg="ell")
        if kept is not None:
            # the host plans are per edge view and layout: the second
            # executor reuses the first one's views and builds its own
            # layout's plans on them
            ex._sharded_cache = kept._sharded_cache
        plans = {}
        t0 = time.perf_counter()
        sc = ex._sharded(False)
        plans["shard_csr_s"] = time.perf_counter() - t0  # 0 where reused
        if exchange == "auto":
            t0 = time.perf_counter()
            ex._resolve_exchange(False)
            plans["decide_sharded_s"] = time.perf_counter() - t0
        steps = (("exchange_plan_s", sc.ensure_exchange_plan), ("ell_s", sc.ensure_ell)) \
            if ex.exchange == "a2a" else (("blocked_plan_s", sc.ensure_blocked_plan),
                                          ("blocked_ell_s", sc.ensure_blocked_ell))
        for key, fn in steps:
            t0 = time.perf_counter()
            fn()
            plans[key] = time.perf_counter() - t0
        t0 = time.perf_counter()
        ex._measured_walls(sc)
        plans["shard_measure_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        host = sharded_run(ex, PageRankProgram(max_iterations=20, tol=0.0), fused=False)["rank"]
        host_s = time.perf_counter() - t0
        host_info = dict(ex.last_run_info)
        t0 = time.perf_counter()
        fused = sharded_run(ex, PageRankProgram(max_iterations=20, tol=0.0))["rank"]
        fused_first_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        fused = sharded_run(ex, PageRankProgram(max_iterations=20, tol=0.0))["rank"]
        fused_s = time.perf_counter() - t0
        fused_info = dict(ex.last_run_info)
        if fused_info["path"] != "fused" or not bits_equal(fused, host):
            raise RuntimeError(f"sharded {exchange}: the fused PageRank differs from the host loop")
        rel = max_rel(fused, rank)
        if not np.isfinite(fused).all() or rel > RANK_REL:
            raise RuntimeError(f"sharded {exchange}: PageRank rel {rel} vs the single-device run")
        # CC aggregates over both orientations: its own edge view, plans
        # and probe, built here and timed apart from its run
        t0 = time.perf_counter()
        und = ex._sharded(True)
        ex._graph_args(und, True)
        ex._measured_walls(und)
        cc_plans_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        comp = sharded_run(ex, ConnectedComponentsProgram())["component"]
        cc_s = time.perf_counter() - t0
        cc_info = dict(ex.last_run_info)
        if not np.array_equal(comp.astype(np.int64), cc_want):
            raise RuntimeError(f"sharded {exchange}: CC labels differ from scipy's components")
        bfs = ShortestPathProgram(seed_index=bfs_seed, max_iterations=4)
        sharded_run(ex, bfs)  # the frontier plan's build and placement
        t0 = time.perf_counter()
        dist = sharded_run(ex, bfs)["distance"]
        bfs_s = time.perf_counter() - t0
        bfs_info = dict(ex.last_run_info)
        if bfs_info["path"] != "frontier" or not np.array_equal(dist, bfs_expect):
            raise RuntimeError(f"sharded {exchange}: the 4-hop BFS differs from scipy's")
        shards = host_info["shards"]
        if exchange == "auto":
            # what multiprocess_olap holds its two-process run to
            auto_run = {"exchange": ex.exchange, "agg": ex.agg, "host_rank": host,
                        "rank": fused, "component": comp, "distance": dist,
                        "host_superstep_ms": walls(host_info),
                        "fused_superstep_ms": fused_s / 20 * 1e3}
        big[exchange] = {
            "exchange": ex.exchange, "agg": ex.agg, "autotune": host_info.get("autotune"),
            "plans": plans, "pagerank_host_s": host_s,
            "pagerank_host_superstep_ms": walls(host_info),
            "pagerank_fused_first_s": fused_first_s, "pagerank_fused_s": fused_s,
            "pagerank_fused_superstep_ms": fused_s / 20 * 1e3,
            "fused_chunks": fused_info["chunks"], "fused_host_syncs": fused_info["host_syncs"],
            "rel_vs_single_device": rel, "exchange_info": host_info["exchange"],
            "h2d_arg_bytes": host_info["h2d_arg_bytes"],
            "device_memory": host_info["device_memory"],
            "cc_plans_s": cc_plans_s, "cc_s": cc_s, "cc_supersteps": cc_info["supersteps"],
            "cc_path": cc_info["path"],
            "bfs_s": bfs_s, "bfs_tiers": bfs_info["tiers"],
            "reached": int(np.sum(dist < INF)),
            "skew": {k: shards[k] for k in ("skew", "cost_source", "slowest_shard")},
            "measured_ms": [p["measured_ms"] for p in shards["per_shard"]],
            "edges_by_shard": [p["edges"] for p in shards["per_shard"]],
        }
        kept = ex  # (c) preempts the last layout run here
        del ex
    emit("sharded_olap", scale=args.scale, slots=SHARDED_SLOTS, vertices=n,
         edges=csr.num_edges, runs=big, card=card)

    # ------------------------------- (c) a shard preemption, resumed
    td = tempfile.mkdtemp(prefix="sharded_olap_")
    try:
        clean = sharded_run(kept, PageRankProgram(max_iterations=20, tol=0.0))["rank"]
        plan = FaultPlan(seed=args.seed, shard_preempt_superstep=4)
        t0 = time.perf_counter()
        resumed = sharded_run(kept, PageRankProgram(max_iterations=20, tol=0.0),
                              checkpoint_every=2, shard_checkpoint_dir=td,
                              fault_hook=plan.sharded_hook)["rank"]
        resume_s = time.perf_counter() - t0
        info = dict(kept.last_run_info)
        if [e["kind"] for e in plan.journal] != ["shard_preempt"] or info.get("resumes") != 1:
            raise RuntimeError(f"the shard preemption was not resumed once: {plan.journal}")
        if not bits_equal(resumed, clean):
            raise RuntimeError("the resumed sharded PageRank differs from the uninterrupted run")
    finally:
        shutil.rmtree(td, ignore_errors=True)
    preempt = {"preempted_shard": plan.journal[0]["shard"], "resumes": info["resumes"],
               "resume_ms": info["resume_ms"], "checkpoint": info["checkpoint"],
               "wall_s": resume_s, "path": info["path"]}
    del kept
    torch.cuda.empty_cache()

    # ------------------------- (d) the stored graph, the default mesh
    g = stored["graph"]
    t0 = time.perf_counter()
    res = g.compute(executor="sharded").program(PageRankProgram(max_iterations=20, tol=0.0))
    before = kernels.device_launches("cuda")
    res = res.submit()
    torch.cuda.synchronize()
    stored_runs = kernels.device_launches("cuda") - before
    stored_s = time.perf_counter() - t0
    routing = res.run_info["routing"]
    srel = max_rel(res.states["rank"], stored["rank"])
    if (routing["executor"] != "sharded" or res.run_info["mesh"]["slots"] != 1
            or stored_runs or srel > RANK_REL):
        raise RuntimeError(f"the sharded submit: {routing}, {stored_runs} kernel runs, rel {srel}")
    emit("sharded_olap_faults", preempt=preempt,
         stored_submit={"wall_s": stored_s, "rel_vs_single_device": srel, "routing": routing,
                        "mesh": res.run_info["mesh"], "exchange": res.run_info["exchange"],
                        "snapshot": res.run_info["snapshot"]},
         segsum_kernel_runs=kernel_runs + stored_runs, card=card,
         seconds=time.perf_counter() - phase_t0)
    return {"seconds": time.perf_counter() - phase_t0, "kernel_runs": kernel_runs + stored_runs,
            "auto": auto_run}


#: slots of cuda:0 each multiprocess_olap process holds (two processes:
#: SHARDED_SLOTS in all), and the seconds a process may take
MULTIPROC_LOCAL_SLOTS = SHARDED_SLOTS // 2
MULTIPROC_TIMEOUT_S = 120

#: one process of multiprocess_olap: argv = rank, coordinator port, scale,
#: seed, exchange, agg, hub, the graph's in_src crc32, output directory
MULTIPROC_CHILD = r"""
import json, os, sys, time, zlib
sys.path.insert(0, os.getcwd())
rank, port, scale, seed = (int(a) for a in sys.argv[1:5])
exchange, agg, hub, crc, out_dir = sys.argv[5], sys.argv[6], int(sys.argv[7]), int(sys.argv[8]), sys.argv[9]
import numpy as np
import torch

from janusgraph_tpu_torch import native
from janusgraph_tpu_torch.olap import kernels, rmat_csr
from janusgraph_tpu_torch.olap.programs import (
    ConnectedComponentsProgram, PageRankProgram, ShortestPathProgram,
)
from janusgraph_tpu_torch.parallel import ShardedExecutor
from janusgraph_tpu_torch.parallel.multihost import (
    global_mesh, init_multihost, shutdown_multihost,
)

t0 = time.perf_counter()
init_multihost(f"127.0.0.1:{port}", num_processes=2, process_id=rank, timeout_s=90)
init_s = time.perf_counter() - t0
if not native.available():
    raise RuntimeError("the native host library is not built")
t0 = time.perf_counter()
csr = rmat_csr(scale, 16, seed=seed)
graph_s = time.perf_counter() - t0
if zlib.crc32(csr.in_src.tobytes()) != crc:
    raise RuntimeError("this process drew another graph than the parent's")
mesh = global_mesh(devices=[torch.device("cuda", 0)] * %(slots)d)
ex = ShardedExecutor(csr, mesh=mesh, exchange=exchange, agg=agg)
t0 = time.perf_counter()
sc = ex._sharded(False)
if exchange == "a2a":
    sc.ensure_exchange_plan()
    sc.ensure_ell()
else:
    sc.ensure_blocked_plan()
    sc.ensure_blocked_ell()
ex._measured_walls(sc)
ex._graph_args(sc, False)
plan_s = time.perf_counter() - t0
torch.cuda.synchronize()
eager0 = kernels.launch_counts()["sorted_segment_sum"]
dev0 = kernels.device_launches("cuda")

def run(program, **kw):
    t = time.perf_counter()
    res = ex.run(program, **kw)
    torch.cuda.synchronize()
    return res, time.perf_counter() - t, dict(ex.last_run_info)

def per_step(info, key):
    recs = [r[key] for r in info["superstep_records"][1:] if key in r] or [0.0]
    return float(np.mean(recs))

host, host_s, host_info = run(PageRankProgram(max_iterations=20, tol=0.0), fused=False)
run(PageRankProgram(max_iterations=20, tol=0.0))
fused, fused_s, fused_info = run(PageRankProgram(max_iterations=20, tol=0.0))
if fused_info["path"] != "fused" or fused_info["fused_mode"] != "eager":
    raise RuntimeError(f"the fused PageRank ran {fused_info['path']}/{fused_info['fused_mode']}")
t0 = time.perf_counter()
und = ex._sharded(True)
ex._graph_args(und, True)
ex._measured_walls(und)
cc_plans_s = time.perf_counter() - t0
comp, cc_s, cc_info = run(ConnectedComponentsProgram())
bfs = ShortestPathProgram(seed_index=hub, max_iterations=4)
run(bfs)  # the frontier plan's build and placement
dist, bfs_s, bfs_info = run(bfs)
if bfs_info["path"] != "frontier":
    raise RuntimeError(f"the BFS ran {bfs_info['path']}")
kernel_runs = kernels.device_launches("cuda") - dev0
eager_runs = kernels.launch_counts()["sorted_segment_sum"] - eager0
np.savez(os.path.join(out_dir, f"proc{rank}.npz"), host_rank=host["rank"], rank=fused["rank"],
         component=comp["component"], distance=dist["distance"])
print(json.dumps({
    "process": rank, "init_process_group_s": init_s, "graph_s": graph_s, "plan_s": plan_s,
    "cc_plans_s": cc_plans_s, "segsum_kernel_runs": kernel_runs + eager_runs,
    "mesh": host_info["mesh"], "processes": host_info["processes"],
    "transport": host_info["transport"], "staged_through_host": host_info["staged_through_host"],
    "pagerank_host_s": host_s, "pagerank_host_superstep_ms": per_step(host_info, "wall_ms"),
    "pagerank_host_transport_bytes_per_superstep": per_step(host_info, "transport_bytes"),
    "pagerank_host_transport_ms_per_superstep": per_step(host_info, "transport_ms"),
    "pagerank_host_transport_bytes": host_info["transport_bytes"],
    "pagerank_host_transport_s": host_info["transport_s"],
    "pagerank_fused_s": fused_s, "pagerank_fused_superstep_ms": fused_s / 20 * 1e3,
    "fused_mode": fused_info["fused_mode"], "fused_chunks": fused_info["chunks"],
    "pagerank_fused_transport_bytes": fused_info["transport_bytes"],
    "pagerank_fused_transport_s": fused_info["transport_s"],
    "cc_s": cc_s, "cc_supersteps": cc_info["supersteps"], "cc_path": cc_info["path"],
    "cc_transport_bytes": cc_info["transport_bytes"], "cc_transport_s": cc_info["transport_s"],
    "bfs_s": bfs_s, "bfs_hops": bfs_info["supersteps"],
    "bfs_transport_bytes": bfs_info["transport_bytes"], "bfs_transport_s": bfs_info["transport_s"],
    "skew": host_info["shards"]["skew"],
}), flush=True)
shutdown_multihost()
""" % {"slots": MULTIPROC_LOCAL_SLOTS}


def single_process_auto_run(csr, bfs_seed) -> dict:
    """What sharded_olap (b) hands multiprocess_olap, for a run of that
    phase alone: the layout "auto" picks on SHARDED_SLOTS slots of the
    card (agg "ell") and that layout's PageRank (20, host loop and fused),
    CC and 4-hop BFS from ``bfs_seed``."""
    import torch

    from janusgraph_tpu_torch.olap.programs import (
        ConnectedComponentsProgram,
        PageRankProgram,
        ShortestPathProgram,
    )
    from janusgraph_tpu_torch.parallel import Mesh, ShardedExecutor

    ex = ShardedExecutor(csr, mesh=Mesh([torch.device("cuda", 0)] * SHARDED_SLOTS),
                         exchange="auto", agg="ell")
    host = ex.run(PageRankProgram(max_iterations=20, tol=0.0), fused=False)["rank"]
    host_ms = float(np.mean([r["wall_ms"] for r in ex.last_run_info["superstep_records"][1:]]))
    ex.run(PageRankProgram(max_iterations=20, tol=0.0))
    t0 = time.perf_counter()
    fused = ex.run(PageRankProgram(max_iterations=20, tol=0.0))["rank"]
    fused_s = time.perf_counter() - t0
    comp = ex.run(ConnectedComponentsProgram())["component"]
    dist = ex.run(ShortestPathProgram(seed_index=bfs_seed, max_iterations=4))["distance"]
    out = {"exchange": ex.exchange, "agg": ex.agg, "host_rank": host, "rank": fused,
           "component": comp, "distance": dist, "host_superstep_ms": host_ms,
           "fused_superstep_ms": fused_s / 20 * 1e3}
    del ex
    torch.cuda.empty_cache()
    return out


def multiprocess_olap_phase(csr, single, bfs_seed, cc_want, bfs_want, args, emit,
                            card: str) -> dict:
    """Two processes on the one card form one mesh of SHARDED_SLOTS slots
    (MULTIPROC_LOCAL_SLOTS of cuda:0 each) over torch.distributed's gloo
    backend, every block between them staged through pinned host memory
    (MULTIPROC_CHILD is one process). Each draws the main run's graph
    (the same crc32 of its in-CSR as this process's), pins the layout
    sharded_olap (b) chose under "auto" (``single``: that run's layout
    and arrays), and runs PageRank (20) on the host loop and fused (its
    chunks eager: no collective between processes is captured), CC and
    the hub's 4-hop BFS. Both processes' arrays are held bitwise to each
    other and to ``single``, the fused ranks to the host loop's, CC and
    the BFS to scipy's; the segment-sum kernel's counter must not move in
    either process. A process that fails, differs or outlives
    MULTIPROC_TIMEOUT_S fails the phase."""
    import os
    import shutil
    import socket
    import tempfile
    import zlib

    from janusgraph_tpu_torch.olap.vertex_program import INF

    phase_t0 = time.perf_counter()
    td = tempfile.mkdtemp(prefix="multiprocess_olap_")
    sock = socket.socket()
    sock.bind(("127.0.0.1", 0))
    port = sock.getsockname()[1]
    sock.close()
    script = os.path.join(td, "child.py")
    with open(script, "w") as f:
        f.write(MULTIPROC_CHILD)
    argv = [str(port), str(args.scale), str(args.seed), single["exchange"], single["agg"],
            str(bfs_seed), str(zlib.crc32(csr.in_src.tobytes())), td]
    env = dict(os.environ, PYTHONPATH=os.getcwd())
    procs = []
    try:
        for rank in (0, 1):
            procs.append(subprocess.Popen([sys.executable, script, str(rank), *argv],
                                          stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                          env=env, cwd=os.getcwd()))
        deadline = time.monotonic() + MULTIPROC_TIMEOUT_S
        outs = []
        for p in procs:
            out, err = p.communicate(timeout=max(1.0, deadline - time.monotonic()))
            outs.append((p.returncode, out.decode(), err.decode()))
        for rank, (rc, out, err) in enumerate(outs):
            if rc != 0:
                raise RuntimeError(f"multiprocess_olap process {rank} exited {rc}:\n"
                                   f"{out[-2000:]}\n{err[-4000:]}")
        procs_out = [json.loads(out.strip().splitlines()[-1]) for _rc, out, _err in outs]
        arrays = [dict(np.load(os.path.join(td, f"proc{r}.npz"))) for r in (0, 1)]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        shutil.rmtree(td, ignore_errors=True)
    for key in ("host_rank", "rank", "component", "distance"):
        if not (bits_equal(arrays[0][key], arrays[1][key])
                and bits_equal(arrays[0][key], single[key])):
            raise RuntimeError(f"multiprocess_olap: {key} differs between the processes or from "
                               "the single-process 8-slot run")
    got = arrays[0]
    if not bits_equal(got["rank"], got["host_rank"]):
        raise RuntimeError("multiprocess_olap: the fused PageRank differs from the host loop")
    if not np.array_equal(got["component"].astype(np.int64), cc_want):
        raise RuntimeError("multiprocess_olap: CC labels differ from scipy's components")
    if not np.array_equal(got["distance"], np.where(bfs_want <= 4, bfs_want, INF).astype(np.float32)):
        raise RuntimeError("multiprocess_olap: the 4-hop BFS differs from scipy's")
    for p in procs_out:
        if p["segsum_kernel_runs"] or p["processes"] != 2 or p["transport"] != "gloo":
            raise RuntimeError(f"multiprocess_olap process {p['process']}: {p}")
    seconds = time.perf_counter() - phase_t0
    emit("multiprocess_olap", scale=args.scale, processes=2, slots=SHARDED_SLOTS,
         local_slots=MULTIPROC_LOCAL_SLOTS, exchange=single["exchange"], agg=single["agg"],
         vertices=csr.num_vertices, edges=csr.num_edges, per_process=procs_out,
         single_process={"host_superstep_ms": single["host_superstep_ms"],
                         "fused_superstep_ms": single["fused_superstep_ms"]},
         bitwise_vs_single_process=True, card=card, seconds=seconds)
    return {"seconds": seconds, "kernel_runs": sum(p["segsum_kernel_runs"] for p in procs_out)}


def stored_delta_phase(stored, args, emit) -> dict:
    """OLTP writes and a bulk burst on the stored phase's graph, read back by
    warm submits through the delta snapshot: (a) one transaction, then
    PageRank and CC on the "fused" path; (b) against a fresh scan and a
    fresh executor over the same overlay; (c) the kernel on the lanes'
    plans; (d) a bulk burst past computer.delta-max-overlay and the
    "refresh" submit; (e) refresh_csr against the same scan."""
    import torch
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import connected_components

    from janusgraph_tpu_torch.core.bulk import bulk_add_edges
    from janusgraph_tpu_torch.core.codecs import Direction
    from janusgraph_tpu_torch.olap import GPUExecutor, kernels, run_on
    from janusgraph_tpu_torch.olap import delta as D
    from janusgraph_tpu_torch.olap.csr import load_csr_snapshot, refresh_csr
    from janusgraph_tpu_torch.olap.programs import (
        ConnectedComponentsProgram,
        PageRankProgram,
    )

    phase_t0 = time.perf_counter()
    g, base = stored["graph"], stored["loaded"]
    snap = D.get_snapshot(g)
    cap = g.change_capture
    if snap is None or snap.csr is None:
        raise RuntimeError("the stored phase left no warm snapshot")
    # nothing was written to this graph since the cold scan (the stored
    # phase only reads after it), so ``base`` is the structure at this epoch
    cold_epoch, refresh_epoch = snap.epoch, g.backend.mutation_epoch()
    vids = base.vertex_ids
    n = base.num_vertices
    out_deg, in_deg = np.diff(base.out_indptr), np.diff(base.in_indptr)
    # a removed edge dirties both its ends for an undirected program, and a
    # dirty row re-aggregates all its surviving edges through the live
    # lane: removals touch only vertices of degree <= 16 (in + out), so the
    # lanes stay under computer.delta-max-lane-cells and the overlay rides
    # fused (a hub's removal would make the submit materialize instead)
    low = (in_deg + out_deg) <= 16
    rng = np.random.default_rng(args.seed + 8)
    in_rows = np.repeat(np.arange(n), in_deg)
    nbr_low = np.ones(n, dtype=bool)
    np.logical_and.at(nbr_low, in_rows, low[base.in_src])
    gone = int(rng.choice(np.flatnonzero((out_deg == 0) & (in_deg >= 1) & low & nbr_low)))
    hub = int(np.argmax(out_deg))
    alive = np.setdiff1d(np.arange(n), [gone])
    a_src, a_dst = rng.choice(alive, 2000), rng.choice(alive, 2000)
    e_src = np.repeat(np.arange(n), out_deg)
    cand = rng.permutation(np.flatnonzero(
        low[e_src] & low[base.out_dst] & (base.out_dst != gone)))
    _u, first = np.unique(e_src[cand], return_index=True)  # one removal a row
    dels = cand[np.sort(first)][:500]
    del in_rows, nbr_low, e_src

    def pagerank():
        return PageRankProgram(max_iterations=20, tol=0.0)

    # (a) one OLTP transaction: edge adds between existing vertices, edge
    # removals, a new vertex with an edge to the hub, a removed vertex
    t0 = time.perf_counter()
    tx = g.new_transaction()
    for s_, d_ in zip(a_src, a_dst):
        tx.add_edge(tx.get_vertex(int(vids[s_])), "link", tx.get_vertex(int(vids[d_])))
    for e in dels:
        row = int(np.searchsorted(base.out_indptr, e, side="right")) - 1
        target = int(vids[base.out_dst[e]])
        tx.remove_edge(next(x for x in tx.get_edges(tx.get_vertex(int(vids[row])),
                                                       Direction.OUT, ("link",))
                            if x.in_vertex.id == target))
    nv = tx.add_vertex()
    tx.add_edge(nv, "link", tx.get_vertex(int(vids[hub])))
    tx.remove_vertex(tx.get_vertex(int(vids[gone])))
    build_s = time.perf_counter() - t0
    decode0 = cap.decode_s
    t0 = time.perf_counter()
    tx.commit()
    commit_s = time.perf_counter() - t0
    oltp_decode_s = cap.decode_s - decode0
    overlay, upto = D.overlay_since(g, snap.epoch)
    if overlay.size > snap.max_overlay or len(overlay.new_vertices) != 1 or len(overlay.removed) != 1:
        raise RuntimeError(f"the OLTP burst's overlay: {overlay.size} records, "
                           f"{overlay.new_vertices}, {overlay.removed}")

    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    res, fused_runs = counted(lambda: g.compute().program(pagerank()).submit(), 60)
    TEL.hold_submit(res)
    fused_wall = time.perf_counter() - t0
    info = dict(res.run_info)
    if info["snapshot"] != {"path": "fused", "overlay": overlay.size} or not info["delta"]["fused"]:
        raise RuntimeError(f"the warm submit after the transaction: {info['snapshot']}, "
                           f"{info.get('delta')}")
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    comp = g.compute().program(ConnectedComponentsProgram()).submit()
    cc_wall = time.perf_counter() - t0
    if comp.run_info["snapshot"]["path"] != "fused":
        raise RuntimeError(f"CC after the transaction: {comp.run_info['snapshot']}")

    # (b) against the repack (a fresh scan) and a fresh executor over the
    # same overlay
    t0 = time.perf_counter()
    fresh, _e = load_csr_snapshot(g)
    scan_s = time.perf_counter() - t0
    live = res.csr.vertex_ids
    pos = np.searchsorted(fresh.vertex_ids, live)
    if len(live) != fresh.num_vertices or not np.array_equal(fresh.vertex_ids[pos], live):
        raise RuntimeError("the fused submit's live vertices are not the scan's")
    want = run_on(fresh, pagerank())["rank"]
    rel = max_rel(res.states["rank"], want[pos])
    if not np.isfinite(res.states["rank"]).all() or not rel <= RANK_REL:
        raise RuntimeError(f"fused submit vs the repack: max rel diff {rel}")
    view = D.OverlayView(snap.csr, overlay, max_lane_cells=snap.max_lane_cells)
    fex = GPUExecutor(snap.csr, strategy="segsum", delta=view)
    own, _rv = D.compact_result(view, fex.run(pagerank()))
    if not bits_equal(own["rank"], res.states["rank"]):
        raise RuntimeError("the cached executor's fused ranks differ from a fresh executor's")
    del fex
    # component labels are vertex indices, in the view's index space for
    # the fused run and the scan's for the repack: held as the vertex ids
    # they name
    fsrc = np.repeat(np.arange(fresh.num_vertices), np.diff(fresh.out_indptr))
    adj = coo_matrix((np.ones(fresh.num_edges), (fsrc, fresh.out_dst)),
                     shape=(fresh.num_vertices,) * 2).tocsr()
    ncomp, labels = connected_components(adj, directed=True, connection="weak")
    lowest = np.full(ncomp, fresh.num_vertices, dtype=np.int64)
    np.minimum.at(lowest, labels, np.arange(fresh.num_vertices))
    cc_fused = view.vertex_ids[comp.states["component"].astype(np.int64)]
    cc_scan = fresh.vertex_ids[run_on(fresh, ConnectedComponentsProgram())["component"]
                               .astype(np.int64)]
    if not np.array_equal(comp.csr.vertex_ids, live) or not np.array_equal(cc_fused, cc_scan[pos]):
        raise RuntimeError("fused CC differs from CC over the repack")
    if not np.array_equal(cc_scan, fresh.vertex_ids[lowest[labels]]):
        raise RuntimeError("CC over the repack differs from scipy's components")
    del adj, fsrc

    # (c) the kernel on the add and tombstone lanes' plans, fed the cells
    # the merge gathers
    dl = view.device_args("cuda", False)
    x = torch.rand(view.n_pad, generator=torch.Generator(device="cuda").manual_seed(7),
                   device="cuda")
    msgs_ext = torch.cat([x, x.new_zeros(1)])
    lanes = {}
    for lane in ("add", "tomb"):
        plan = dl[f"{lane}_plan"]
        cells = torch.index_select(msgs_ext, 0, dl[f"{lane}_src"])
        _p, _g, err = check_plan(f"stored_{lane}_lane", plan, cells, kernels)
        nbytes = plan.function_bytes()
        lanes[lane] = {
            "cells": plan.num_edges, "segments": plan.num_segments, "num_ctas": plan.num_ctas,
            "max_abs_err": err,
            "kernel_ms": flushed_ms(lambda: kernels.sorted_segment_sum(cells, plan), iters=10),
            "plain_ms": flushed_ms(lambda: kernels.sorted_segment_sum_plain(cells, plan), iters=5),
            "bytes": nbytes, "bound_ms": nbytes / PEAK_BYTES_PER_S * 1e3}
    lane_meta = {k: v for k, v in view.lanes(False)["_meta"].items() if k in ("acap", "tcap", "lcap")}
    del dl, msgs_ext, x, view

    # (d) a bulk burst of 0.5 % of the edges (the reference bench's
    # streaming burst), past computer.delta-max-overlay: the next submit
    # folds the overlay into a new base, zero store reads
    # (past the overlay cap at any scale: at scale 20 the 0.5 % is 10,000)
    burst = max(base.num_edges // 200, snap.max_overlay + 1)
    b_src, b_dst = rng.choice(alive, burst), rng.choice(alive, burst)
    decode0 = cap.decode_s
    t0 = time.perf_counter()
    bulk_add_edges(g, "link", vids[b_src], vids[b_dst])
    bulk_s = time.perf_counter() - t0
    bulk_decode_s = cap.decode_s - decode0
    depth = cap.depth_since(snap.epoch)
    mem_before = torch.cuda.memory_allocated()
    gen0 = snap.generation
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    res_r, refresh_runs = counted(lambda: g.compute().program(pagerank()).submit(), 20)
    TEL.hold_submit(res_r)
    refresh_wall = time.perf_counter() - t0
    mem_after = torch.cuda.memory_allocated()
    if res_r.run_info["snapshot"] != {"path": "refresh", "overlay": depth} or (
            snap.generation != gen0 + 1 or res_r.csr is not snap.csr):
        raise RuntimeError(f"the submit after the bulk burst: {res_r.run_info['snapshot']}")
    compaction = dict(snap.last_compaction)
    t0 = time.perf_counter()
    fresh2, _e2 = load_csr_snapshot(g)
    scan2_s = time.perf_counter() - t0
    for k in ("vertex_ids", "out_indptr", "out_dst", "in_indptr", "in_src"):
        if not np.array_equal(getattr(snap.csr, k), getattr(fresh2, k)):
            raise RuntimeError(f"the compacted base's {k} differs from a fresh scan's")
    if not bits_equal(res_r.states["rank"], run_on(fresh2, pagerank())["rank"]):
        raise RuntimeError("the refresh submit's ranks differ from run_on over the scan")

    # (e) refresh_csr: the rows touched since the structure of ``base``
    # re-read; the scan orders a row's in-edges by the sources' row keys,
    # refresh_csr by their index, so in_src is held row by row as sets
    t0 = time.perf_counter()
    refreshed, _e3 = refresh_csr(g, base, refresh_epoch)
    refresh_csr_s = time.perf_counter() - t0
    for k in ("vertex_ids", "out_indptr", "out_dst", "in_indptr", "out_edge_type"):
        if not np.array_equal(getattr(refreshed, k), getattr(fresh2, k)):
            raise RuntimeError(f"refresh_csr's {k} differs from a fresh scan's")
    rows = np.repeat(np.arange(fresh2.num_vertices), np.diff(fresh2.in_indptr))
    in_rows = [a.in_src[np.lexsort((a.in_src, rows))] for a in (refreshed, fresh2)]
    if not np.array_equal(*in_rows):
        raise RuntimeError("refresh_csr's in-rows differ from a fresh scan's")
    emit("stored_delta", vertices=n, edges=base.num_edges,
         oltp={"edge_adds": len(a_src), "edge_removals": len(dels), "new_vertices": 1,
               "removed_vertices": 1, "removed_vertex_in_degree": int(in_deg[gone]),
               "build_s": build_s, "commit_s": commit_s,
               "writes_per_s": (len(a_src) + len(dels) + 2) / (build_s + commit_s),
               "capture_decode_s": oltp_decode_s},
         overlay_depth=overlay.size, lane_caps=lane_meta,
         fused_submit={"wall_s": fused_wall, "run_wall_s": info["run_wall_s"],
                       "kernel_runs": fused_runs, "capture_s": info.get("capture_s"),
                       "max_rel_diff_vs_repack": rel},
         cc_submit={"wall_s": cc_wall, "run_wall_s": comp.run_info["run_wall_s"],
                    "components": int(ncomp)},
         lanes=lanes, scan_s=scan_s,
         bulk_burst={"edges": burst, "s": bulk_s, "capture_decode_s": bulk_decode_s,
                     "overlay_depth": depth},
         refresh_submit={"wall_s": refresh_wall, "run_wall_s": res_r.run_info["run_wall_s"],
                         "kernel_runs": refresh_runs, "compaction": compaction,
                         "device_bytes_before": mem_before, "device_bytes_after": mem_after},
         scan2_s=scan2_s,
         refresh_csr={"s": refresh_csr_s, "tracker_served": g.backend.touched_since(
             refresh_epoch) is not None, "cold_epoch_served": g.backend.touched_count_since(
             cold_epoch) is not None},
         capture_decode_s_total=cap.decode_s, capture_poisoned=cap.poisoned,
         seconds=time.perf_counter() - phase_t0)
    g.close()
    if g._delta_snapshot is not None or snap.csr is not None or snap._executors:
        raise RuntimeError("close() left the delta snapshot behind")
    return {"launches": fused_runs, "launches_refresh": refresh_runs,
            "max_abs_err": max(v["max_abs_err"] for v in lanes.values())}


def spill_seeds(csr, rng, want_paths: int = 60_000, max_seeds: int = 64):
    """Start vertices drawn from ``rng`` whose 3-hop out-path total, counted
    with scipy from the CSR, reaches about ``want_paths`` and stays below
    2^24 (the float32 count exactness the spillover refuses past): (seed
    indices, the total)."""
    from scipy.sparse import csr_matrix

    n = csr.num_vertices
    adj = csr_matrix((np.ones(csr.num_edges), csr.out_dst, csr.out_indptr), shape=(n, n))
    paths3 = adj @ (adj @ (adj @ np.ones(n)))
    cand = rng.permutation(np.flatnonzero((paths3 > 0) & (paths3 <= want_paths / 4)))
    seeds, total = [], 0.0
    for i in cand:
        if total >= want_paths or len(seeds) == max_seeds:
            break
        seeds.append(int(i))
        total += paths3[i]
    if not seeds or total >= 2 ** 24:
        raise RuntimeError(f"spill seeds: {len(seeds)} seeds, {total} paths")
    return np.asarray(seeds), float(total), adj


#: the query server's deadline for the smoke's requests: the page_rank()
#: top 10's host walk took 76.5 s at the stored size on the H100's machine
#: (PERF.md §5), and the host's speed varies by up to 1.4x between calls
SERVER_DEADLINE_MS = 900_000.0


def start_query_server(graphs):
    """The port's query server over ``graphs`` ({name: graph}) with its
    defaults (admission, the metric history, SLOs, the sampling profiler,
    the watchdog) but an explicit deadline, and a driver client whose own
    deadline and socket timeout match; returns (server, client)."""
    from janusgraph_tpu_torch.driver import JanusGraphClient
    from janusgraph_tpu_torch.server import JanusGraphManager, JanusGraphServer

    manager = JanusGraphManager()
    for name, g in graphs.items():
        manager.put_graph(name, g)
    server = JanusGraphServer(manager=manager, max_deadline_ms=SERVER_DEADLINE_MS).start()
    client = JanusGraphClient(port=server.port, deadline_ms=SERVER_DEADLINE_MS,
                              http_timeout_s=SERVER_DEADLINE_MS / 1e3 + 60.0)
    return server, client


def stop_query_server(server) -> None:
    """Stop the server; fail unless its HTTP, sampler, history and watchdog
    threads have ended."""
    from janusgraph_tpu_torch.observability import history, sampling_profiler, watchdog

    threads = {"http": server._thread, "profiler": sampling_profiler._thread,
               "history": history._thread, "watchdog": watchdog._thread}
    server.stop()
    alive = [k for k, t in threads.items() if t is not None and t.is_alive()]
    if alive:
        raise RuntimeError(f"threads still running after server.stop(): {alive}")


def get_healthz(server) -> dict:
    """GET /healthz; a 503 carries a degraded verdict, not an error."""
    import json
    import urllib.error
    import urllib.request

    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{server.port}/healthz",
                                    timeout=60) as resp:
            return json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return json.loads(e.read())


#: the top 10 by rank with each vertex's id and rank, in the Gremlin
#: spelling the server's dialect translates
TOP10_QUERY = ("g.V().pageRank().order().by('pagerank', reverse=True).limit(10)"
               ".project('id', 'pagerank').by(id()).by('pagerank')")


def server_top10(g, server, client, emit, phase_t0, fleet=None) -> dict:
    """The page_rank() top 10 sent through the query server: its kernel
    runs, ids and ranks held to a direct submit as the in-process step was,
    and the server's own view (its span, /healthz). With ``fleet`` (from
    ``start_fleet``) ``client`` talks to the fleet's frontend: the request
    must be one route attempt, the replica that served it reads as
    ``server``, and the frontend's /healthz must be "ok" too."""
    import torch

    from janusgraph_tpu_torch.observability import registry, tracer
    from janusgraph_tpu_torch.olap import kernels
    from janusgraph_tpu_torch.olap.programs import PageRankProgram

    # The step's program is PageRank(damping 0.85, 20 iterations) at the
    # default tol of 1e-9, which this sparse graph meets in fewer
    # supersteps: the kernel runs once a superstep the run reports, and
    # once in each superstep the fused loop computed past the stop and
    # discarded (predicated_steps)
    before = kernels.device_launches("cuda")
    t0 = time.perf_counter()
    rows = client.submit(TOP10_QUERY)
    client_wall = time.perf_counter() - t0
    torch.cuda.synchronize()
    pr_runs = kernels.device_launches("cuda") - before
    request = tracer.recent("server.request")[-1]
    routed = None
    if fleet is not None:
        route = tracer.recent("fleet.route")[-1]
        routed = {k: route.attrs.get(k) for k in ("verdict", "attempts", "replica")}
        routed["route_ms"] = route.duration_ms
        if routed["verdict"] != "ok" or routed["attempts"] != 1:
            raise RuntimeError(f"the top 10 through the fleet frontend: {routed}")
        server = fleet["servers"][routed["replica"]]
        front = get_healthz(fleet["frontend"])
        routed["frontend_healthz"] = {"status": front["status"], "serving": front["serving"],
                                      "total": front["total"], "quorum_bad": front["quorum_bad"]}
        if front["status"] != "ok" or front["serving"] != len(fleet["servers"]):
            raise RuntimeError(f"the frontend's /healthz after the top 10: {routed}")
    step_run = registry.last_run("olap")
    step_run_wall, pr_steps = step_run["wall_s"], step_run["supersteps"]
    discarded = step_run.get("predicated_steps", 0)
    if pr_runs != pr_steps + discarded or not 2 <= pr_steps <= 20:
        raise RuntimeError(f"pageRank() through the server: {pr_runs} kernel runs for "
                           f"{pr_steps} supersteps and {discarded} discarded")
    health = get_healthz(server)
    adm = health["admission"] or {}
    prof = health["profiler"]
    if health["status"] != "ok" or adm.get("admitted", 0) < 1 or adm.get("shed", 1) != 0:
        raise RuntimeError(f"/healthz after the top 10: {health['status']}, admission {adm}, "
                           f"slo {health['slo']}")
    direct = g.compute().program(PageRankProgram(max_iterations=20)).submit()
    if direct.run_info["supersteps"] != pr_steps:
        raise RuntimeError(f"the direct submit ran {direct.run_info['supersteps']} supersteps")
    csr = direct.csr
    rank = direct.states["rank"]
    top = [int(r["id"]) for r in rows]
    pos = np.searchsorted(csr.vertex_ids, top)
    # the ranks the server sent (float32 annotations as GraphSON doubles)
    # are the direct submit's, bit for bit
    if len(rows) != 10 or not bits_equal(
            np.array([r["pagerank"] for r in rows], np.float32), rank[pos]):
        raise RuntimeError("pageRank()'s ranks through the server differ from the direct submit's")
    # ties broken by id on both sides (the step sorts stably in scan order)
    order = np.lexsort((csr.vertex_ids, -rank.astype(np.float64)))[:10]
    got = sorted(zip((-rank[pos]).tolist(), top))
    want = sorted(zip((-rank[order]).tolist(), csr.vertex_ids[order].tolist()))
    if got != want or not np.array_equal(csr.vertex_ids[pos], top):
        raise RuntimeError(f"pageRank() top 10 {got} against the direct submit's {want}")
    want64 = pagerank_fp64(csr, pr_steps)
    rel = max_rel(rank[pos], want64[pos])
    if not rel <= RANK_REL:
        raise RuntimeError(f"pageRank() top 10: max rel diff {rel} from float64")
    emit("server_top10", vertices=csr.num_vertices, edges=csr.num_edges, query=TOP10_QUERY,
         client_wall_s=client_wall, server_eval_ms=request.duration_ms,
         run_wall_s=step_run_wall, host_walk_s=client_wall - step_run_wall,
         kernel_runs=pr_runs, supersteps=pr_steps, discarded_supersteps=discarded,
         max_rel_diff_vs_fp64=rel, ids=top,
         healthz={"status": health["status"], "admitted": adm["admitted"],
                  "shed": adm["shed"], "brownout_rung": adm["brownout_rung"],
                  "profiler_overhead_cpu_pct": prof["overhead_cpu_pct"],
                  "profiler_overhead_wall_pct": prof["overhead_wall_pct"],
                  "profiler_samples": prof.get("samples"),
                  "slo": {a["name"]: a["severity"] for a in health["slo"]["alerts"]},
                  "slo_worst": health["slo"]["worst"]},
         fleet=routed, seconds=time.perf_counter() - phase_t0)
    return {"launches": pr_runs, "csr": csr, "replica": routed and routed["replica"]}


def server_brownout(g, server, emit) -> None:
    """The brownout gate on the card: the active controller's ladder driven
    to rung 2 through its own API refuses a submit before any scan or
    kernel run, and comes back down."""
    import torch

    from janusgraph_tpu_torch.exceptions import ServerOverloadedError
    from janusgraph_tpu_torch.observability import flight_recorder, registry
    from janusgraph_tpu_torch.olap import kernels
    from janusgraph_tpu_torch.olap.programs import PageRankProgram
    from janusgraph_tpu_torch.server import admission

    ctl = admission.active()
    if ctl is not server.admission:
        raise RuntimeError("the server's admission controller is not the active one")
    ladder = ctl.brownout
    dwell = ladder.dwell_s
    ladder.dwell_s = 0.0  # climb two rungs now, not two dwell periods apart
    try:
        for _ in range(2 * ladder.enter_sheds):
            ladder.note_shed()
        rung = ladder.rung
        refused = registry.snapshot().get("server.admission.olap_refused", {}).get("count", 0)
        runs = len(registry.runs("olap"))
        before = kernels.device_launches("cuda")
        t0 = time.perf_counter()
        try:
            g.compute().program(PageRankProgram(max_iterations=20)).submit()
        except ServerOverloadedError as e:
            refusal = str(e)
        else:
            raise RuntimeError(f"a submit at brownout rung {rung} was admitted")
        refuse_ms = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        launched = kernels.device_launches("cuda") - before
        after = registry.snapshot().get("server.admission.olap_refused", {}).get("count", 0)
        if rung != admission.RUNG_REFUSE_OLAP or launched or after != refused + 1 or (
                len(registry.runs("olap")) != runs):
            raise RuntimeError(f"brownout gate: rung {rung}, {launched} kernel runs, "
                               f"olap_refused {refused} -> {after}")
        while ladder.rung:
            ladder.note_underload()
    finally:
        ladder.dwell_s = dwell
    moves = [(e["direction"], e["rung"]) for e in flight_recorder.events("brownout")][-4:]
    emit("server_brownout", rung=rung, kernel_runs=launched, olap_refused=after - refused,
         refuse_ms=refuse_ms, refusal=refusal, ladder=moves, rung_after=ladder.rung)


def server_session(server, client, csr, rng, emit) -> None:
    """One edge between two stored vertices through a WebSocket session:
    a sessionless read does not see it until the session commits."""
    a, b = (int(v) for v in csr.vertex_ids[rng.choice(csr.num_vertices, 2, replace=False)])
    read = f"g.V({a}).out('link').hasId({b}).count()"
    before = client.submit(read)
    ws = client.ws(session=True)
    ws.sock.settimeout(120.0)
    try:
        t0 = time.perf_counter()
        ws.submit(f"g.V({a}).addE('link').to_(g.V({b}).next()).iterate()")
        add_ms = (time.perf_counter() - t0) * 1e3
        in_session = ws.submit(read)
        t0 = time.perf_counter()
        unseen = client.submit(read)
        read_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        ws.submit("g.commit()")
        commit_ms = (time.perf_counter() - t0) * 1e3
    finally:
        ws.close()
    seen = client.submit(read)
    if (in_session, unseen, seen) != (before + 1, before, before + 1):
        raise RuntimeError(f"the session's edge: before {before}, in the session {in_session}, "
                           f"sessionless {unseen} before the commit and {seen} after")
    emit("server_session", edge=[a, b], add_ms=add_ms, sessionless_read_ms=read_ms,
         commit_ms=commit_ms, counts=[before, in_session, unseen, seen])


def open_oltp_graph(stored, **options):
    """The stored graph reopened over its store with computer.spillover
    (and ``options``)."""
    from janusgraph_tpu_torch.core.graph import open_graph

    # a V() traversal holds every vertex: 2^20 and more here, past the
    # default query.max-traversers budget of a million
    return open_graph({"computer.spillover": True, "query.max-traversers": 1 << 22, **options},
                      store_manager=stored["graph"].backend.manager)


#: the shard count of the oltp phase's snapshot export (the warm-up's files)
FLEET_SHARDS = 4
#: the fleet router's probe and the gossip agents' socket timeout here: a
#: replica busy in the top 10's host walk may answer /healthz late, and two
#: missed probes mark it dead (server.fleet.probe-timeout-s is 2 s)
FLEET_PROBE_TIMEOUT_S = 30.0


def edgestore_reads() -> int:
    """Every edgestore call the registry has counted: a graph opened with
    metrics.enabled counts its own (the oltp phase's r1)."""
    from janusgraph_tpu_torch.observability import registry

    return sum(int(v.get("count", 0)) for k, v in registry.snapshot().items()
               if k.startswith("storage.edgestore."))


def start_fleet(g0, g1, card: str) -> dict:
    """A two-replica fleet in process, as the ``fleet`` subcommand builds
    one: r0 serves ``g0``; r1 serves ``g1`` (the same store, metrics.enabled
    on so its store reads are counted), warmed with ``warm_replica`` from
    r0's ``export_snapshot`` written at FLEET_SHARDS shards to a temporary
    directory, with zero edgestore reads. Each replica runs a
    JanusGraphServer with the fleet runner's settings: replica 0 owns the
    process-wide planes (the metric history, the SLO engine, the sampling
    profiler, the watchdog, the bundle directory), r1 runs none; r1 starts
    first, so r0's admission controller is the process's active one. A
    gossip agent on each, a FleetRouter with its probe loop, a
    FleetFrontend, and a driver client on the frontend with the smoke's
    deadline. Returns the fleet's parts and the warm-up's record."""
    import os
    import shutil
    import tempfile

    from janusgraph_tpu_torch.driver import JanusGraphClient
    from janusgraph_tpu_torch.observability import set_replica
    from janusgraph_tpu_torch.server import (FleetFrontend, FleetRouter, JanusGraphManager,
                                             JanusGraphServer, StateGossip, export_snapshot,
                                             warm_replica)

    cfg = g0.config
    set_replica("fleet-frontend")
    warm_dir = tempfile.mkdtemp(prefix="jg_fleet_")
    try:
        # the export's acquire is r0's cold scan: the one the top 10 paid
        t0 = time.perf_counter()
        exported = export_snapshot(g0, warm_dir, num_shards=FLEET_SHARDS)
        export_s = time.perf_counter() - t0
        written = sum(os.path.getsize(os.path.join(warm_dir, f)) for f in os.listdir(warm_dir))
        files = sorted(os.listdir(warm_dir))
        reads0 = edgestore_reads()
        t0 = time.perf_counter()
        warmed = warm_replica(g1, warm_dir, replica="r1")
        warm_s = time.perf_counter() - t0
        warm_reads = edgestore_reads() - reads0
    finally:
        shutil.rmtree(warm_dir, ignore_errors=True)
    if not warmed or warm_reads or exported["source"] != "cold":
        raise RuntimeError(f"the warm-up: warmed {warmed}, {warm_reads} edgestore reads, "
                           f"export {exported}")
    router = FleetRouter(vnodes=cfg.get("server.fleet.vnodes"),
                         candidates=cfg.get("server.fleet.candidates"),
                         probe_timeout_s=FLEET_PROBE_TIMEOUT_S,
                         trend_windows=cfg.get("server.fleet.trend-windows"))
    servers, gossips = {}, {}
    for name, g in (("r1", g1), ("r0", g0)):
        manager = JanusGraphManager()
        manager.put_graph("graph", g)
        owner = name == "r0"
        servers[name] = JanusGraphServer(
            manager=manager, replica_name=name, max_deadline_ms=SERVER_DEADLINE_MS,
            history_enabled=owner and g.config.get("metrics.history-enabled"),
            slo_enabled=owner and g.config.get("metrics.slo-enabled"),
            profiler_enabled=owner and g.config.get("metrics.profile-enabled"),
            watchdog_enabled=owner and g.config.get("server.watchdog-enabled"),
            bundle_dir=g.config.get("metrics.bundle-dir") if owner else "",
        ).start()
        gossips[name] = StateGossip(name, servers[name].admission,
                                    fanout=cfg.get("server.fleet.gossip-fanout"),
                                    timeout_s=FLEET_PROBE_TIMEOUT_S)
        servers[name].gossip = gossips[name]
    for name in ("r0", "r1"):
        router.add_replica(name, "127.0.0.1", servers[name].port)
        gossips[name].set_peers([f"http://127.0.0.1:{servers[o].port}"
                                 for o in ("r0", "r1") if o != name])
        gossips[name].start(interval_s=cfg.get("server.fleet.gossip-interval-s"))
    router.probe()
    router.start_probes(interval_s=cfg.get("server.fleet.probe-interval-s"))
    frontend = FleetFrontend(router).start()
    client = JanusGraphClient(port=frontend.port, deadline_ms=SERVER_DEADLINE_MS,
                              http_timeout_s=SERVER_DEADLINE_MS / 1e3 + 60.0)
    warmup = {"card": card, "shards": FLEET_SHARDS, "files": files, "bytes_written": written,
              "export_s": export_s, "warm_s": warm_s, "rows": exported["rows"],
              "edges": exported["edges"], "warm_edgestore_reads": warm_reads}
    return {"servers": servers, "gossips": gossips, "router": router, "frontend": frontend,
            "client": client, "warmup": warmup}


def stop_fleet(fleet, keep: str = "") -> None:
    """Stop the frontend, the probe loop, the gossip agents and every
    replica but ``keep`` (whose server and planes go on, to be stopped by
    ``stop_query_server``); fail unless every one of their threads has
    ended."""
    from janusgraph_tpu_torch.observability import set_replica

    threads = {"frontend": fleet["frontend"]._thread, "probes": fleet["router"]._probe_thread}
    threads.update({f"gossip_{n}": a._thread for n, a in fleet["gossips"].items()})
    threads.update({f"http_{n}": s._thread for n, s in fleet["servers"].items() if n != keep})
    try:
        fleet["frontend"].stop()
        fleet["router"].stop()
        for agent in fleet["gossips"].values():
            agent.stop()
        for name, server in fleet["servers"].items():
            if name != keep:
                server.stop()
            server.gossip = None
    finally:
        set_replica("")
    for t in threads.values():
        if t is not None:
            t.join(timeout=FLEET_PROBE_TIMEOUT_S + 5.0)
    alive = [k for k, t in threads.items() if t is not None and t.is_alive()]
    if alive:
        raise RuntimeError(f"threads still running after the fleet stopped: {alive}")


def fleet_warm(g0, g1, fleet, emit) -> dict:
    """r1's direct submit over its warmed snapshot against r0's direct
    submit: PageRank(20, tol=0) on each, 20 kernel runs each on the card,
    r1's on the "warm" path with zero edgestore reads, the ranks bit for
    bit and the same vertex ids."""
    from janusgraph_tpu_torch.olap.programs import PageRankProgram

    def pagerank():
        return PageRankProgram(max_iterations=20, tol=0.0)

    t0 = time.perf_counter()
    res0, runs0 = counted(lambda: g0.compute().program(pagerank()).submit(), 20)
    r0_s = time.perf_counter() - t0
    reads0 = edgestore_reads()
    t0 = time.perf_counter()
    res1, runs1 = counted(lambda: g1.compute().program(pagerank()).submit(), 20)
    r1_s = time.perf_counter() - t0
    reads = edgestore_reads() - reads0
    path = res1.run_info["snapshot"]["path"]
    if path != "warm" or reads or not np.array_equal(res1.csr.vertex_ids, res0.csr.vertex_ids):
        raise RuntimeError(f"r1's submit after the warm-up: path {path}, {reads} edgestore reads")
    if not bits_equal(res1.states["rank"], res0.states["rank"]):
        raise RuntimeError("r1's ranks after the warm-up differ from r0's")
    emit("fleet_warm", **fleet["warmup"], r0_submit_s=r0_s, r1_submit_s=r1_s,
         r1_run_wall_s=res1.run_info["run_wall_s"], r1_path=path, kernel_runs=runs1,
         r1_edgestore_reads=reads, ranks="r1 bitwise equal to r0")
    return {"launches": runs1}


def fleet_federation(fleet, emit) -> None:
    """One FleetFederation tick over the two replicas (their history
    windows merged, none missing) and the incident timeline: both
    replicas' lanes, r1's warm-up event among them, a Chrome trace that
    validates."""
    from janusgraph_tpu_torch.observability import timeline
    from janusgraph_tpu_torch.observability.federation import FleetFederation

    fed = FleetFederation(fleet["router"], timeout_s=FLEET_PROBE_TIMEOUT_S)
    t0 = time.perf_counter()
    window = fed.tick()
    tick_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    report = fed.incident(window_s=0)
    incident_s = time.perf_counter() - t0
    lanes = sorted({e["lane"] for e in report["events"]})
    warmups = [e for e in report["events"]
               if e.get("category") == "fleet" and e.get("action") == "warmup"]
    if window["partial"] or window["replicas"] != ["r0", "r1"] or not window["counters"]:
        raise RuntimeError(f"the federation's window: partial {window['partial']}, "
                           f"replicas {window['replicas']}, {len(window['counters'])} counters")
    if report["partial"] or not {"r0", "r1"} <= set(lanes) or [
            e["lane"] for e in warmups[-1:]] != ["r1"]:
        raise RuntimeError(f"the incident: partial {report['partial']}, lanes {lanes}, "
                           f"warm-ups {warmups[-1:]}")
    timeline.validate_chrome_trace(report["trace"])
    fed.stop()
    emit("fleet_federation", tick_s=tick_s, incident_s=incident_s,
         window={"replicas": window["replicas"], "counters": len(window["counters"]),
                 "series": len(window["series"]),
                 "admitted": window["counters"].get("server.admission.admitted", 0),
                 "routed": window["counters"].get("fleet.router.routed", 0)},
         incident={"events": len(report["events"]), "lanes": lanes,
                   "phases": [p["phase"] for p in report["phases"]],
                   "warmup": {k: warmups[-1].get(k) for k in ("lane", "rows", "edges")}},
         offsets={n: o["offset_s"] for n, o in report["offsets"].items()})


def oltp_phase(stored, args, emit, card: str) -> dict:
    """The Gremlin entry point on the stored graph the phases before wrote
    (the bulk-loaded graph500 graph, its written-back ranks and the delta
    phase's writes), reopened over the same store with computer.spillover
    twice and served by a two-replica fleet (``start_fleet``: r1 warmed
    from r0's snapshot export): the pageRank() top 10 through the fleet's
    frontend and the driver against a direct submit, r1's warm submit
    against r0's (``fleet_warm``), one federation tick and the incident
    timeline (``fleet_federation``); then the frontend, the probe loop,
    the gossip agents and r1 stop, and against r0 alone: the brownout
    gate, in process the connected_component() and shortest_path() steps
    against scipy and the OLTP->OLAP spillover of a 3-hop count (walked,
    spilled, spilled inside a transaction, spilled after its commit
    through a delta refresh), and last a WebSocket session's edge; r0
    stops with its planes. Every time is printed with the card's name and
    power limit (``card``)."""
    phase_t0 = time.perf_counter()
    g = open_oltp_graph(stored)
    g1 = open_oltp_graph(stored, **{"metrics.enabled": True})
    planner = g.spillover_planner
    # -- a two-replica fleet (r1 warmed from r0's export); the top 10 by
    # rank through its frontend, r1's warm submit against r0's, one
    # federation tick; then r0's brownout gate; the fleet stays up for the
    # rest of the phase
    fleet = start_fleet(g, g1, card)
    server = fleet["servers"]["r0"]
    try:
        try:
            top10 = server_top10(g, server, fleet["client"], emit, phase_t0, fleet=fleet)
            warm = fleet_warm(g, g1, fleet, emit)
            fleet_federation(fleet, emit)
        finally:
            # the rest goes on against r0 alone: the fleet's probes and
            # gossip would take the interpreter from the steps' row walks
            stop_fleet(fleet, keep="r0")
        server_brownout(g, server, emit)
        csr = top10["csr"]
        pr_runs = top10["launches"]
        out = oltp_steps(g, csr, planner, args, emit, phase_t0)
        # the session talks to r0 itself, as a WebSocket client of a fleet
        # does (the frontend routes HTTP requests only)
        from janusgraph_tpu_torch.driver import JanusGraphClient

        client = JanusGraphClient(port=server.port, deadline_ms=SERVER_DEADLINE_MS,
                                  http_timeout_s=SERVER_DEADLINE_MS / 1e3 + 60.0)
        server_session(server, client, csr, np.random.default_rng(args.seed + 11), emit)
    finally:
        stop_query_server(server)
    g1.close()
    g.close()
    return {"launches": pr_runs, "launches_spill": out["launches_spill"],
            "launches_warm": warm["launches"], "replica": top10["replica"]}


def oltp_steps(g, csr, planner, args, emit, phase_t0) -> dict:
    """The oltp phase's in-process steps: connected_component(),
    shortest_path() and the spillover, on the stored graph ``g``."""
    from scipy.sparse.csgraph import connected_components, dijkstra

    from janusgraph_tpu_torch.core.codecs import Direction
    from janusgraph_tpu_torch.core.traversal import GraphTraversalSource
    from janusgraph_tpu_torch.observability import registry

    def count(name):
        return registry.snapshot().get(name, {}).get("count", 0)

    # -- connected_component() on seeds, shortest_path() from the hub
    n = csr.num_vertices
    rng = np.random.default_rng(args.seed + 10)
    seeds, paths_total, adj = spill_seeds(csr, rng)
    cc_seeds = rng.choice(n, 16, replace=False)
    t0 = time.perf_counter()
    comps = g.traversal().V(*csr.vertex_ids[cc_seeds].tolist()).connected_component() \
        .values("component").to_list()
    cc_wall = time.perf_counter() - t0
    ncomp, labels = connected_components(adj, directed=True, connection="weak")
    lowest = np.full(ncomp, n, dtype=np.int64)
    np.minimum.at(lowest, labels, np.arange(n))
    if comps != csr.vertex_ids[lowest[labels[cc_seeds]]].tolist():
        raise RuntimeError("connected_component() differs from scipy's components")
    hub = int(np.argmax(csr.out_degree))
    hops = dijkstra(adj, directed=True, unweighted=True, indices=hub, limit=4)
    reach = np.flatnonzero((hops <= 4) & (np.arange(n) != hub))
    t0 = time.perf_counter()
    paths = g.traversal().V(int(csr.vertex_ids[hub])).shortest_path(max_hops=4).to_list()
    sp_wall = time.perf_counter() - t0
    ends = np.searchsorted(csr.vertex_ids, [p[-1].id for p in paths])
    if sorted(ends.tolist()) != reach.tolist() or any(
            len(p) != hops[e] + 1 or p[0].id != csr.vertex_ids[hub] for p, e in zip(paths, ends)):
        raise RuntimeError("shortest_path() paths differ from scipy's BFS")
    emit("oltp_computer_steps",
         connected_component={"wall_s": cc_wall, "seeds": len(cc_seeds)},
         shortest_path={"wall_s": sp_wall, "hub_out_degree": int(csr.out_degree[hub]),
                        "paths": len(paths), "max_len": max(map(len, paths), default=0)},
         seconds=time.perf_counter() - phase_t0)

    # -- the spillover: walk the 3-hop count on the row path until the
    # digest table promotes it, then spill
    seed_ids = csr.vertex_ids[seeds].tolist()

    def chain(src=None):
        return (src or g.traversal()).V(*seed_ids).out("link").out("link").out("link")

    def walk(build):
        """One run on the row path: (result, ms)."""
        planner.enabled = False
        try:
            t0 = time.perf_counter()
            out = build()
            return out, (time.perf_counter() - t0) * 1e3
        finally:
            planner.enabled = True

    def spill(build):
        spilled = count("olap.spillover.spilled")
        t0 = time.perf_counter()
        out, runs = counted(build, 3)
        wall = time.perf_counter() - t0
        if count("olap.spillover.spilled") != spilled + 1:
            raise RuntimeError("the promoted chain did not spill")
        return out, wall, runs

    min_seen = g.config.get("computer.spillover-min-seen")
    planner.enabled = True
    t0 = time.perf_counter()
    for _ in range(min_seen):  # the row path: each walk feeds the digest table
        walked = chain().count()
    walk_ms = (time.perf_counter() - t0) / min_seen * 1e3
    if walked != round(paths_total):
        raise RuntimeError(f"the walk counted {walked} paths, scipy {paths_total}")
    first, first_wall, first_runs = spill(lambda: chain().count())
    warm, warm_wall, warm_runs = spill(lambda: chain().count())
    warm_run_wall = registry.last_run("olap")["wall_s"]
    if not first == warm == walked:
        raise RuntimeError(f"spilled counts {first}, {warm} against the walk's {walked}")
    variants = {}
    for name, build in (("dedup_count", lambda: chain().dedup().count()),
                        ("id", lambda: sorted(chain().id_().to_list()))):
        for _ in range(min_seen):
            want_v = build()
        got_v, wall_v, _r = spill(build)
        if got_v != want_v:
            raise RuntimeError(f"the spilled {name} differs from the walk's")
        variants[name] = {"wall_s": wall_v, "size": got_v if name == "dedup_count" else len(got_v)}

    # -- inside a transaction: ~100 edge writes around the seeds, spilled
    # over the patched snapshot, against that transaction's walk
    tx = g.new_transaction()
    src = GraphTraversalSource(g, tx)

    def step_out(vs):
        return np.unique(csr.out_dst[np.concatenate(
            [np.arange(csr.out_indptr[v], csr.out_indptr[v + 1]) for v in vs])])

    hop1 = step_out(seeds)
    removed = 0
    for v in np.concatenate([hop1, np.setdiff1d(step_out(hop1), hop1)]):
        edges = tx.get_edges(tx.get_vertex(int(csr.vertex_ids[v])), Direction.OUT, ("link",))
        if edges:
            tx.remove_edge(edges[0])
            removed += 1
            if removed == 50:
                break
    ends_to = rng.choice(n, 50)
    for s_, d_ in zip(rng.choice(hop1, 50), ends_to):
        tx.add_edge(tx.get_vertex(int(csr.vertex_ids[s_])), "link",
                    tx.get_vertex(int(csr.vertex_ids[d_])))
    in_tx, tx_wall, tx_runs = spill(lambda: chain(src).count())
    tx_walk, tx_walk_ms = walk(lambda: chain(src).count())
    if in_tx != tx_walk or in_tx == walked:
        raise RuntimeError(f"in-transaction spill {in_tx}, its walk {tx_walk}, before {walked}")
    patched = registry.last_run("olap.spillover")["spillover"]["overlay"]

    # -- committed: the next spill refreshes the snapshot from the change
    # capture (materialize, zero store reads)
    tx.commit()
    refreshes = count("olap.spillover.delta_refreshes")
    after, after_wall, after_runs = spill(lambda: chain().count())
    fresh_walk, fresh_ms = walk(lambda: chain().count())
    if count("olap.spillover.delta_refreshes") != refreshes + 1:
        raise RuntimeError("the spill after the commit did not refresh from the capture")
    if after != fresh_walk or after != in_tx:
        raise RuntimeError(f"spill after commit {after}, fresh walk {fresh_walk}, in tx {in_tx}")
    fallbacks = {k: v.get("count", 0) for k, v in registry.snapshot().items()
                 if k.startswith("olap.spillover.fallback")}
    if any(fallbacks.values()):
        raise RuntimeError(f"spillover fell back: {fallbacks}")
    emit("oltp", vertices=n, edges=csr.num_edges, spillover={
        "seeds": len(seeds), "paths_3hop": paths_total, "walk_ms_mean": walk_ms,
        "min_seen": min_seen, "first_spill_wall_s": first_wall,
        "warm_spill_wall_s": warm_wall, "warm_spill_run_wall_s": warm_run_wall,
        "kernel_runs": [first_runs, warm_runs, tx_runs, after_runs], "variants": variants,
        "in_tx": {"edges_added": len(ends_to), "edges_removed": removed, "overlay": patched,
                  "wall_s": tx_wall, "count": in_tx, "walk_ms": tx_walk_ms},
        "after_commit": {"wall_s": after_wall, "walk_ms": fresh_ms},
        "delta_refreshes": count("olap.spillover.delta_refreshes"), "fallbacks": fallbacks,
    }, seconds=time.perf_counter() - phase_t0)
    return {"launches_spill": warm_runs}


class TearingFlush:
    """Swap a store manager's ``mutate_many`` for one call: apply the first
    half of the batch's rows (in the batch's order), then fail, as a crash
    between row writes would."""

    def __init__(self, manager):
        self.manager, self.original, self.rows = manager, manager.mutate_many, 0
        manager.mutate_many = self

    def __call__(self, mutations, txh):
        self.manager.mutate_many = self.original
        flat = [(s, k, m) for s, rows in mutations.items() for k, m in rows.items()]
        self.rows = len(flat)
        keep = {}
        for s, k, m in flat[: len(flat) // 2]:
            keep.setdefault(s, {})[k] = m
        self.original(keep, txh)
        raise RuntimeError("crash in the middle of the flush")


def logs_phase(stored, args, emit, card: str) -> dict:
    """The durable logs on the stored graph the phases before wrote: (1) two
    instances over its store manager, one with the durable CDC log
    (storage.cdc.dir), tx.log-tx on through management().set_config,
    open_instances() listing both; (2) a snapshot, two 1,000-edge commits
    with the WAL off and ten with it on and a user log, a log processor
    that must see all 10,000 edge additions, the txlog's four markers for
    each; (3) a CDC follower (server/fleet.py CDCFollower) bootstrapped
    from the snapshot saved as a 4-shard CSR checkpoint, pulling the 12
    records from the snapshot's cursor and folding them (DeltaOverlay
    .from_batches + materialize): its CSR array-equal to a fresh load_csr,
    PageRank over it on the card (20 kernel runs) bitwise equal to PageRank
    over the scan, the instance it serves (g1, its adopted snapshot)
    submitting on the card with zero edgestore reads (20 kernel runs,
    bitwise equal), promote() with its flight events, and the kernel
    against its plain version on the folded in-plan; (4) a torn commit of 1,000 edges (half
    its rows flushed, PRECOMMIT and PREFLUSH in the txlog), a third
    instance whose open rolls it forward, every edge readable, a second
    recovery that finds nothing, and that instance's submit on the card
    (20 kernel runs) bitwise equal to run_on over a fresh scan; (5) a
    schema eviction acknowledged by every open instance. Every time is
    printed with the card's name and power limit (``card``)."""
    import os
    import shutil
    import tempfile

    import torch

    from janusgraph_tpu_torch.core.codecs import Direction
    from janusgraph_tpu_torch.core.graph import open_graph
    from janusgraph_tpu_torch.core.txlog import LogTxStatus, TornCommitRecovery, decode_tx_entry
    from janusgraph_tpu_torch.observability import flight_recorder
    from janusgraph_tpu_torch.olap import GPUExecutor, kernels, run_on
    from janusgraph_tpu_torch.olap.csr import load_csr, load_csr_snapshot
    from janusgraph_tpu_torch.olap.programs import PageRankProgram
    from janusgraph_tpu_torch.olap.sharded_checkpoint import save_csr_checkpoint
    from janusgraph_tpu_torch.server.fleet import CDCFollower

    phase_t0 = time.perf_counter()
    mgr = stored["graph"].backend.manager
    cdc_dir = tempfile.mkdtemp(prefix="jg_cdc_")
    rng = np.random.default_rng(args.seed + 13)

    def pagerank():
        return PageRankProgram(max_iterations=20, tol=0.0)

    # -- (1) two instances; the WAL on through the management API
    # g1 counts its store reads (metrics.enabled): it serves the follower's
    # state in (3)
    g1 = open_graph({"metrics.enabled": True}, store_manager=mgr)
    g2 = open_graph({"storage.cdc.dir": cdc_dir}, store_manager=mgr)
    m2 = g2.management()
    instances = sorted(m2.open_instances())
    if instances != sorted([g1.instance_id, g2.instance_id]):
        raise RuntimeError(f"open_instances() {instances}")
    t0 = time.perf_counter()
    csr0, epoch0 = load_csr_snapshot(g2)
    snapshot_s = time.perf_counter() - t0
    live = csr0.vertex_ids

    def burst(graph, log_identifier=None):
        """One transaction of 1,000 "link" edges between live vertices: its
        commit's wall, and the transaction."""
        tx = graph.new_transaction(log_identifier=log_identifier)
        for s_, d_ in zip(rng.choice(live, 1000), rng.choice(live, 1000)):
            tx.add_edge(tx.get_vertex(int(s_)), "link", tx.get_vertex(int(d_)))
        t0 = time.perf_counter()
        tx.commit()
        return time.perf_counter() - t0, tx

    wal_off_s = [burst(g2)[0] for _ in range(2)]
    m2.set_config("tx.log-tx", True)
    if not (g2._wal_enabled and m2.get_config("tx.log-tx")):
        raise RuntimeError("set_config('tx.log-tx', True) did not turn the WAL on")

    # -- (2) ten WAL-on commits with a user log, and its processor
    seen = {"edges": 0, "states": 0, "first": None, "last": None}

    def on_state(state):
        seen["edges"] += sum(1 for c in state.added if c.kind == "edge")
        seen["states"] += 1
        seen["first"] = seen["first"] or time.perf_counter()
        seen["last"] = time.perf_counter()

    g2.open_log_processor("smoke").add_processor(on_state).build()
    time.sleep(0.1)  # the processor reads from now
    wal_t0 = time.time_ns()
    wal_on_s, commit_ends = [], []
    for _ in range(10):
        wall, _tx = burst(g2, "smoke")
        wal_on_s.append(wall)
        commit_ends.append(time.perf_counter())
    deadline = time.perf_counter() + 30.0
    while seen["edges"] < 10_000 and time.perf_counter() < deadline:
        time.sleep(0.005)
    if seen["edges"] != 10_000 or seen["states"] != 10:
        raise RuntimeError(f"the log processor saw {seen['edges']} edge additions in "
                           f"{seen['states']} transactions, not 10,000 in 10")
    by_tx = {}
    for msg in g2.log_manager.open_log("txlog").read_range(wal_t0):
        e = decode_tx_entry(msg.content, msg.timestamp_ns)
        by_tx.setdefault((msg.sender, e.tx_id), []).append(e.status)
    full = [LogTxStatus.PRECOMMIT, LogTxStatus.PREFLUSH, LogTxStatus.PRIMARY_SUCCESS,
            LogTxStatus.SECONDARY_SUCCESS]
    if len(by_tx) != 10 or any(v != full for v in by_tx.values()):
        raise RuntimeError(f"the txlog holds {by_tx}")

    # -- (3) a CDC follower over the durable log: bootstrapped from the
    # snapshot's shard checkpoint, it pulls the 12 records, folds them
    # (DeltaOverlay.from_batches + materialize) and adopts the result into
    # g1's snapshot; then promote()
    ckpt_dir = tempfile.mkdtemp(prefix="jg_follow_")
    t0 = time.perf_counter()
    save_csr_checkpoint(ckpt_dir, csr0, epoch0, num_shards=FLEET_SHARDS)
    checkpoint_s = time.perf_counter() - t0
    checkpoint_bytes = sum(os.path.getsize(os.path.join(ckpt_dir, f)) for f in os.listdir(ckpt_dir))
    follower = CDCFollower(g2.cdc_log, ckpt_dir, graph=g1, idm=g2.idm, name="follower",
                           max_staleness_ms=g1.config.get("server.fleet.follower-max-staleness-ms"))
    t0 = time.perf_counter()
    booted = follower.bootstrap()
    bootstrap_s = time.perf_counter() - t0
    cursor = follower.cursor
    if not booted or cursor != g2.cdc_log.cursor_for_epoch(epoch0):
        raise RuntimeError(f"the follower's bootstrap: {booted}, cursor {cursor}")
    t0 = time.perf_counter()
    pulled = follower.pull()
    pull_s = time.perf_counter() - t0
    staleness_s = follower.staleness_s()
    if not pulled["ok"] or pulled["applied"] != 12 or follower.lag_records():
        raise RuntimeError(f"the follower's pull: {pulled}, lag {follower.lag_records()}")
    folded = follower.csr
    t0 = time.perf_counter()
    fresh = load_csr(g2)
    fresh_s = time.perf_counter() - t0
    for k in ("vertex_ids", "out_indptr", "in_indptr", "out_dst", "in_src", "out_edge_type"):
        if not np.array_equal(getattr(folded, k), getattr(fresh, k)):
            raise RuntimeError(f"the follower's CSR's {k} differs from a fresh load_csr")
    if fresh.num_edges != csr0.num_edges + 12_000:
        raise RuntimeError(f"{fresh.num_edges} edges after 12,000 on {csr0.num_edges}")
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    folded_rank, folded_runs = counted(lambda: run_on(folded, pagerank())["rank"], 20)
    folded_run_s = time.perf_counter() - t0
    fresh_rank, _r = counted(lambda: run_on(fresh, pagerank())["rank"], 20)
    if not np.isfinite(folded_rank).all() or not bits_equal(folded_rank, fresh_rank):
        raise RuntimeError("PageRank over the follower's CSR differs from the fresh scan's")
    # g1 serves the follower's state: its submit reads no edgestore row
    reads0 = edgestore_reads()
    t0 = time.perf_counter()
    served, follower_runs = counted(lambda: g1.compute().program(pagerank()).submit(), 20)
    follower_submit_s = time.perf_counter() - t0
    follower_reads = edgestore_reads() - reads0
    if served.run_info["snapshot"]["path"] != "warm" or follower_reads or not bits_equal(
            served.states["rank"], fresh_rank):
        raise RuntimeError(f"g1's submit over the follower's state: "
                           f"{served.run_info['snapshot']}, {follower_reads} edgestore reads")
    seq0 = flight_recorder.last_seq
    t0 = time.perf_counter()
    promoted = follower.promote()
    promote_s = time.perf_counter() - t0
    promote_events = [(e["category"], e.get("action")) for e in flight_recorder.events()
                      if e["seq"] > seq0]
    if not promoted["ok"] or follower.role != "leader" or not {
            ("follower_promote", None), ("cdc_replay", "caught_up")} <= set(promote_events):
        raise RuntimeError(f"promote(): {promoted}, role {follower.role}, "
                           f"events {promote_events}")
    follower_block = follower.healthz_block()
    follower.unregister_watchdog()
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    ex = GPUExecutor(folded, strategy="segsum")
    in_plan = ex._segsum_plan("in")
    data = torch.rand(in_plan.num_edges, generator=torch.Generator(device="cuda").manual_seed(
        args.seed + 13), device="cuda")
    _p, _g, plan_err = check_plan("logs_in", in_plan, data, kernels)
    del ex, data
    cdc_stats = g2.cdc_log.stats()
    cdc_bytes = sum(os.path.getsize(os.path.join(cdc_dir, f)) for f in os.listdir(cdc_dir))

    # -- (4) a torn commit, and the third instance's open that heals it
    tear = TearingFlush(mgr)
    tx = g2.new_transaction()
    torn_edges = {}
    for s_, d_ in zip(rng.choice(live, 1000), rng.choice(live, 1000)):
        e = tx.add_edge(tx.get_vertex(int(s_)), "link", tx.get_vertex(int(d_)))
        torn_edges[e.id] = int(s_)
    torn_t0 = time.time_ns()
    try:
        tx.commit()
    except RuntimeError as err:
        if "crash" not in str(err):
            raise
    else:
        raise RuntimeError("the torn commit committed")
    torn_status = {}
    for msg in g2.log_manager.open_log("txlog").read_range(torn_t0):
        e = decode_tx_entry(msg.content)
        torn_status.setdefault(e.tx_id, []).append(e.status.name)
    if list(torn_status.values()) != [["PRECOMMIT", "PREFLUSH"]]:
        raise RuntimeError(f"the torn commit's txlog: {torn_status}")
    torn_tx_id = next(iter(torn_status))
    # the crash: the instance's threads stop, nothing else closes
    g2.log_manager.close()
    g2.cdc_log.close()
    t0 = time.perf_counter()
    g3 = open_graph({"tx.max-commit-time-ms": 0.0}, store_manager=mgr)
    reopen_s = time.perf_counter() - t0
    report = g3.last_torn_recovery
    if report != {"replayed": [torn_tx_id], "rolled_back": []}:
        raise RuntimeError(f"the recovery at open: {report}")
    t0 = time.perf_counter()
    again = TornCommitRecovery(g3).run()
    again_s = time.perf_counter() - t0
    if again != {"replayed": [], "rolled_back": []}:
        raise RuntimeError(f"a second recovery: {again}")
    tx = g3.new_transaction(read_only=True)
    found = set()
    for src in set(torn_edges.values()):
        found.update(e.id for e in tx.get_edges(tx.get_vertex(src), Direction.OUT, ("link",))
                     if e.id in torn_edges)
    tx.rollback()
    if len(found) != len(torn_edges):
        raise RuntimeError(f"{len(found)} of the torn commit's {len(torn_edges)} edges read back")
    t0 = time.perf_counter()
    res, recovered_runs = counted(lambda: g3.compute().program(pagerank()).submit(), 20)
    submit_s = time.perf_counter() - t0
    fresh3 = load_csr(g3)
    want3, _r = counted(lambda: run_on(fresh3, pagerank())["rank"], 20)
    path = res.run_info["snapshot"]["path"]
    if path != "cold" or res.csr.num_edges != fresh.num_edges + 1000:
        raise RuntimeError(f"the recovered submit: {res.run_info['snapshot']}, "
                           f"{res.csr.num_edges} edges")
    if not bits_equal(res.states["rank"], want3):
        raise RuntimeError("the recovered graph's submit differs from run_on over a fresh scan")

    # -- (5) the schema eviction broadcast; the dead instance force-closed
    m3 = g3.management()
    m3.force_close_instance(g2.instance_id)
    expected = sorted(m3.open_instances())
    if expected != sorted([g1.instance_id, g3.instance_id]):
        raise RuntimeError(f"open_instances() after the force-close: {expected}")
    key = m3.make_property_key("logs_note", str)
    ml = g3.management_logger
    timeout_s = g3.config.get("schema.eviction-ack-timeout-ms") / 1000.0
    t0 = time.perf_counter()
    evict_id = ml.broadcast_eviction(key.id)
    acked = ml.wait_for_acks(evict_id, len(expected), timeout_s)
    ack_s = time.perf_counter() - t0
    acks = sorted(ml._acks[evict_id])
    if not acked or acks != expected:
        raise RuntimeError(f"the eviction was acknowledged by {acks} of {expected}")
    # the stored graph's later phases run with the WAL off, as before
    m3.set_config("tx.log-tx", False)
    m3.set_config("tx.max-commit-time-ms", 10_000.0)
    g3.close()
    g1.close()
    shutil.rmtree(cdc_dir, ignore_errors=True)
    emit("logs", card=card, vertices=csr0.num_vertices, edges_before=csr0.num_edges,
         instances=len(instances), snapshot_s=snapshot_s,
         commit_1000_edges_s={"wal_off": wal_off_s, "wal_on": wal_on_s},
         processor={"edges": seen["edges"], "transactions": seen["states"],
                    "first_seen_after_commit_start_s": seen["first"] - (
                        commit_ends[0] - wal_on_s[0]),
                    "drain_after_last_commit_s": seen["last"] - commit_ends[-1]},
         txlog_markers=[s.name for s in full],
         cdc={"records": pulled["applied"], "cursor": cursor, "segments": cdc_stats[
             "sealed_segments"], "tail_records": cdc_stats["tail_records"], "bytes": cdc_bytes,
              "fresh_load_csr_s": fresh_s},
         follower={"checkpoint_shards": FLEET_SHARDS, "checkpoint_s": checkpoint_s,
                   "checkpoint_bytes": checkpoint_bytes, "bootstrap_s": bootstrap_s,
                   "pull_s": pull_s, "applied": pulled["applied"],
                   "staleness_s_after_pull": staleness_s, "promote_s": promote_s,
                   "promote_ms": promoted["promote_ms"], "promote_events": promote_events,
                   "healthz": follower_block, "submit_s": follower_submit_s,
                   "submit_kernel_runs": follower_runs, "submit_edgestore_reads": follower_reads,
                   "submit_ranks": "bitwise equal to run_on over a fresh scan"},
         folded={"kernel_runs": folded_runs, "run_on_wall_s": folded_run_s,
                 "ranks": "bitwise equal to the fresh scan's", "in_plan_max_abs_err": plan_err},
         torn={"tx_id": torn_tx_id, "rows": tear.rows, "rows_flushed": tear.rows // 2,
               "reopen_s": reopen_s, "report": report, "second_run": again,
               "second_run_s": again_s, "edges_read_back": len(found)},
         recovered_submit={"wall_s": submit_s, "path": path, "kernel_runs": recovered_runs,
                           "ranks": "bitwise equal to run_on over a fresh scan"},
         eviction={"acks": acks, "ack_s": ack_s, "timeout_s": timeout_s},
         seconds=time.perf_counter() - phase_t0)
    return {"launches": folded_runs, "launches_recovered": recovered_runs,
            "launches_follower": follower_runs, "max_abs_err": plan_err}


def indexed_phase(stored, args, emit) -> dict:
    """Indexes on the stored graph the phases before wrote, reopened over
    the same store: (1) a vertex-centric index on "link" by time, a
    transaction of 1,000 timed edges, the warm submit through the change
    capture and a cold submit through a fresh scan, each over the written
    edges and not the index's copies, then the relation index's reindex
    and a sort-range read from the vertex with the most timed edges; (2)
    the ranks written back columnar and reloaded bit for bit, a mixed index
    over every vertex's rank on a RemoteIndexServer over memindex in its
    own process (index.search.backend "remote"; the server must not import
    torch), built through the scan framework over the wire, a range query
    that plans "mixed-index" and finds the snapshot's top 1,000, a
    write_back of the indexed rank through the transactional path, which
    the index follows, then the mixed index's reindex. Step (2) runs on a
    2^16-vertex graph of the same R-MAT draw (``WRITE_BACK_SCALE``): at the
    stored size the build takes 77-85 s, the write-back ~250 s and the
    reindex 65-77 s of host time on the H100's machine (PERF.md §5-6),
    which with the phases before would pass the smoke's time limit (the
    build moved there for the remote phase, the columnar write-back and
    reload and the remote index in place of the in-process one for the
    sharded phase)."""
    import torch

    from janusgraph_tpu_torch.core.bulk import bulk_add_edges, bulk_add_vertices
    from janusgraph_tpu_torch.core.codecs import Direction
    from janusgraph_tpu_torch.core.graph import open_graph
    from janusgraph_tpu_torch.core.traversal import P
    from janusgraph_tpu_torch.olap import GPUExecutor, kernels, rmat_csr, run_on
    from janusgraph_tpu_torch.olap import computer as computer_mod
    from janusgraph_tpu_torch.olap import delta as D
    from janusgraph_tpu_torch.olap.csr import load_csr
    from janusgraph_tpu_torch.olap.programs import PageRankProgram

    phase_t0 = time.perf_counter()
    mgr = stored["graph"].backend.manager
    # a V() traversal holds every vertex; the transaction's 1,000 edges pass
    # the overlay cap, so the warm submit folds the captured overlay into a
    # new base (the "refresh" path: zero store reads, one kernel run a
    # superstep); the slice cache is off: the backfill, the reindex and
    # the write-back each read every vertex once, so every read would miss
    # it and churn it (PERF.md §6)
    cfg = {"query.max-traversers": 1 << 22, "computer.delta-max-overlay": 512,
           "cache.db-cache": False}
    g = open_graph(cfg, store_manager=mgr)
    mgmt = g.management()

    def pagerank():
        return PageRankProgram(max_iterations=20, tol=0.0)

    def top_query(vertex_ids, ranks):
        """t, the 1,000th-largest rank, and the ids of the vertices at or
        above it."""
        t = float(np.sort(ranks[~np.isnan(ranks)])[-1000])
        return t, set(vertex_ids[ranks >= t].tolist())

    def rank_query(pred, graph=g):
        """The vertex ids with a rank ``pred`` accepts, the wall and the
        start step's plan."""
        q = graph.traversal().V().has("rank", pred).id_()
        t0 = time.perf_counter()
        got = set(q.to_list())
        return got, time.perf_counter() - t0, dict(q._start.plan)

    # -- (1) the vertex-centric index and 1,000 timed edges
    mgmt.make_property_key("time", int)
    mgmt.build_edge_index("link", "linkByTime", ["time"], Direction.BOTH)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    base_res, base_runs = counted(lambda: g.compute().program(pagerank()).submit(), 20)
    base_wall = time.perf_counter() - t0
    if base_res.run_info["snapshot"]["path"] != "cold":
        raise RuntimeError(f"the first submit: {base_res.run_info['snapshot']}")
    n, m = base_res.csr.num_vertices, base_res.csr.num_edges
    snap = D.get_snapshot(g)
    rng = np.random.default_rng(args.seed + 12)
    live = base_res.csr.vertex_ids
    # sources among 50 vertices, so the one with the most timed edges has
    # a range worth reading
    e_src = rng.choice(rng.choice(len(live), 50, replace=False), 1000)
    e_dst = rng.choice(len(live), 1000)
    e_time = rng.integers(0, 1_000_000, 1000)
    t0 = time.perf_counter()
    tx = g.new_transaction()
    for s_, d_, t_ in zip(e_src, e_dst, e_time):
        tx.add_edge(tx.get_vertex(int(live[s_])), "link", tx.get_vertex(int(live[d_])),
                    time=int(t_))
    tx.commit()
    commit_s = time.perf_counter() - t0
    overlay, _upto = D.overlay_since(g, snap.epoch)
    if len(overlay.add) != 1000 or len(overlay.tomb) or overlay.new_vertices or overlay.removed:
        raise RuntimeError(f"the capture holds {len(overlay.add)} adds, {len(overlay.tomb)} "
                           "tombstones: the index copies are no edges")
    t0 = time.perf_counter()
    warm, warm_runs = counted(lambda: g.compute().program(pagerank()).submit(), 20)
    warm_wall = time.perf_counter() - t0
    if warm.run_info["snapshot"] != {"path": "refresh", "overlay": 1000}:
        raise RuntimeError(f"the warm submit: {warm.run_info['snapshot']}")
    g2 = open_graph(cfg, store_manager=mgr)
    t0 = time.perf_counter()
    cold, cold_runs = counted(lambda: g2.compute().program(pagerank()).submit(), 20)
    cold_wall = time.perf_counter() - t0
    if cold.run_info["snapshot"]["path"] != "cold":
        raise RuntimeError(f"the cold submit: {cold.run_info['snapshot']}")
    for res in (warm, cold):
        if res.csr.num_edges != m + 1000:
            raise RuntimeError(f"a submit saw {res.csr.num_edges} edges, not m + 1,000 = {m + 1000}")
    # edge for edge: the base folded from the capture holds the scan's
    # edges. A row's edges are in (type, destination) order in the folded
    # base and in cell order in the scan, which puts a cell with
    # properties (the timed edges) apart, so the rows are held as sorted
    # (source, type, destination) keys
    def edge_keys(c):
        src_ = np.repeat(np.arange(c.num_vertices, dtype=np.int64), np.diff(c.out_indptr))
        return np.sort((src_ * (1 << 20) + c.out_edge_type.astype(np.int64)) * (1 << 21)
                       + c.out_dst)

    for k in ("vertex_ids", "out_indptr", "in_indptr"):
        if not np.array_equal(getattr(warm.csr, k), getattr(cold.csr, k)):
            raise RuntimeError(f"the warm submit's {k} differs from the cold scan's")
    if not np.array_equal(edge_keys(warm.csr), edge_keys(cold.csr)):
        raise RuntimeError("the warm submit's edges differ from the cold scan's")
    want = run_on(cold.csr, pagerank())["rank"]
    rel = max_rel(warm.states["rank"], want)
    if not np.isfinite(warm.states["rank"]).all() or not rel <= RANK_REL:
        raise RuntimeError(f"the warm submit against a fresh scan: max rel diff {rel}")
    if not bits_equal(cold.states["rank"], want):
        raise RuntimeError("the cold submit's ranks differ from run_on over its scan")
    rel64 = max_rel(cold.states["rank"], pagerank_fp64(cold.csr, 20))
    if not rel64 <= RANK_REL:
        raise RuntimeError(f"the cold submit: max rel diff {rel64} from float64")
    # the kernel against its plain version on the in-plan these submits ran
    ex = GPUExecutor(cold.csr, strategy="segsum")
    in_plan = ex._segsum_plan("in")
    data = torch.rand(in_plan.num_edges, generator=torch.Generator(device="cuda").manual_seed(
        args.seed + 12), device="cuda")
    _p, _g, in_err = check_plan("indexed_in", in_plan, data, kernels)
    del ex, data
    g2.close()

    t0 = time.perf_counter()
    copied = mgmt.reindex_relation_index("linkByTime")
    relindex_s = time.perf_counter() - t0
    if copied != 1000:
        raise RuntimeError(f"the relation index copied {copied} edges, not the 1,000 timed ones")
    hub = int(np.bincount(e_src).argmax())
    times = np.sort(e_time[e_src == hub])
    lo, hi = int(times[0]), int(times[len(times) // 2]) + 1
    tx = g.new_transaction()
    v = tx.get_vertex(int(live[hub]))
    want_ids = sorted(e.id for e in tx.get_edges(v, Direction.OUT, ("link",))
                      if e.value("time") is not None and lo <= e.value("time") < hi)
    t0 = time.perf_counter()
    ranged = sorted(e.id for e in tx.get_edges(v, Direction.OUT, ("link",), sort_range=(lo, hi)))
    range_s = time.perf_counter() - t0
    tx.rollback()
    t0 = time.perf_counter()
    has_between = sorted(e.id for e in g.traversal().V(int(live[hub])).out_e("link")
                         .has("time", P.between(lo, hi)).to_list())
    has_s = time.perf_counter() - t0
    if not ranged == has_between == want_ids or not want_ids:
        raise RuntimeError(f"outE('link') in [{lo}, {hi}): the index {len(ranged)}, has() "
                           f"{len(has_between)}, the filter {len(want_ids)}")
    emit("indexed_relation", edges_before=m, timed_edges=1000, commit_s=commit_s,
         snapshot_submit={"wall_s": base_wall, "kernel_runs": base_runs},
         warm_submit={"wall_s": warm_wall, "run_wall_s": warm.run_info["run_wall_s"],
                      "kernel_runs": warm_runs, "path": warm.run_info["snapshot"]["path"]},
         cold_submit={"wall_s": cold_wall, "run_wall_s": cold.run_info["run_wall_s"],
                      "kernel_runs": cold_runs},
         max_rel_diff_vs_scan=rel, max_rel_diff_vs_fp64=rel64, in_plan_max_abs_err=in_err,
         relindex_reindex_s=relindex_s, relindex_copied=copied,
         hub_timed_edges=len(times), range_hits=len(ranged), sort_range_s=range_s,
         has_between_s=has_s, seconds=time.perf_counter() - phase_t0)

    # -- (2) the mixed index and the write-backs on the 2^16-vertex graph,
    # loaded as the stored phase loads its own: the first out-edges in
    # source order at the stored size's edges per vertex, label "link";
    # the index lives on a RemoteIndexServer over memindex in its own
    # process (index.search.backend "remote")
    g.close()
    small = rmat_csr(WRITE_BACK_SCALE, 16, seed=args.seed)
    sn = small.num_vertices
    scap = min(2_000_000 >> (20 - WRITE_BACK_SCALE), small.num_edges)
    ssrc = np.repeat(np.arange(sn), np.diff(small.out_indptr))[:scap]
    proc, host, port, index_open_s, index_torch = start_index_server()
    try:
        if index_torch:
            raise RuntimeError("the remote index server imported torch")
        gw = open_graph(dict(cfg, **{"index.search.backend": "remote",
                                      "index.search.hostname": host,
                                      "index.search.port": port}))
        svids = bulk_add_vertices(gw, sn)
        bulk_add_edges(gw, "link", svids[ssrc], svids[np.asarray(small.out_dst[:scap])])
        del small, ssrc
        first, first_runs = counted(lambda: gw.compute().program(pagerank()).submit(), 20)
        t0 = time.perf_counter()
        first.write_back(["rank"])  # the key has no index yet: the columnar path
        columnar_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        back = load_csr(gw, property_keys=("rank",))
        reload_s = time.perf_counter() - t0
        got = back.properties["rank"]
        if got.dtype != np.float64 or not np.array_equal(
                got, first.states["rank"].astype(np.float64)):
            raise RuntimeError("the reloaded ranks are not the written ones")
        del back, got
        t0 = time.perf_counter()
        gw.management().build_mixed_index("rankIdx", ["rank"])  # backfills over the wire
        small_build_s = time.perf_counter() - t0
        if gw.indexes["rankIdx"].status != "ENABLED":
            raise RuntimeError(f"rankIdx is {gw.indexes['rankIdx'].status}")
        t1, want1 = top_query(first.csr.vertex_ids, first.states["rank"].astype(np.float64))
        got1, index_wall, plan1 = rank_query(P.gte(t1), gw)
        if plan1.get("access") != "mixed-index" or plan1.get("index") != "rankIdx":
            raise RuntimeError(f"the range query planned {plan1}")
        if got1 != want1:
            raise RuntimeError(f"rank >= t: the index found {len(got1)}, the snapshot "
                               f"{len(want1)}")
        emit("indexed_mixed", vertices=sn, ranks=sn, backend="remote",
             server_open_s=index_open_s, server_imported_torch=index_torch,
             build_s=small_build_s, hits=len(got1), index_query_s=index_wall, plan=plan1,
             seconds=time.perf_counter() - phase_t0)
        # new ranks to write: PageRank at damping 0.5 over the same snapshot
        second, second_runs = counted(lambda: gw.compute().program(
            PageRankProgram(damping=0.5, max_iterations=20, tol=0.0)).submit(), 20)
        tx_calls, columnar_calls = [], []
        wb_tx, wb_col = computer_mod._write_back_tx, computer_mod._write_back_columnar
        computer_mod._write_back_tx = lambda *a, **k: (tx_calls.append(1), wb_tx(*a, **k))[1]
        computer_mod._write_back_columnar = lambda *a, **k: (columnar_calls.append(1),
                                                             wb_col(*a, **k))[1]
        try:
            t0 = time.perf_counter()
            second.write_back(["rank"])
            write_back_s = time.perf_counter() - t0
        finally:
            computer_mod._write_back_tx, computer_mod._write_back_columnar = wb_tx, wb_col
        if tx_calls != [1] or columnar_calls:
            raise RuntimeError(f"write_back of the indexed key: {len(tx_calls)} transactional, "
                               f"{len(columnar_calls)} columnar")
        # the mixed index's reindex through the scan framework, on this
        # graph: at the stored size it repeats the build's full scan
        # (64.9-77.4 s)
        t0 = time.perf_counter()
        reindexed = gw.management().reindex("rankIdx")
        reindex_s = time.perf_counter() - t0
        if reindexed < sn:
            raise RuntimeError(f"reindex processed {reindexed} rows for {sn} ranks")
        t2, want2 = top_query(second.csr.vertex_ids, second.states["rank"].astype(np.float64))
        got2, index_wall2, plan2 = rank_query(P.gte(t2), gw)
        if got2 != want2 or plan2.get("access") != "mixed-index":
            raise RuntimeError(f"after write_back the index found {len(got2)} of the top "
                               f"{len(want2)} ({plan2})")
        gw.close()
    finally:
        server = stop_storage_server(proc)
    emit("indexed", vertices=n, edges=m + 1000, mixed_build_s=small_build_s,
         index_query_s=index_wall, relindex_reindex_s=relindex_s, index_server=server,
         write_back={"vertices": sn, "edges": scap, "indexed_s": write_back_s,
                     "columnar_s": columnar_s, "reload_s": reload_s,
                     "build_s": small_build_s, "reindex_s": reindex_s,
                     "reindex_rows": reindexed, "kernel_runs": [first_runs, second_runs],
                     "index_query_after_s": index_wall2, "hits_after": len(got2)},
         cut=f"the mixed index (on a remote index server), its build, range query and "
             f"reindex, and the columnar and indexed write-backs with the reload, on a "
             f"2^{WRITE_BACK_SCALE}-vertex graph of the same R-MAT draw (the smoke's time "
             "limit)",
         seconds=time.perf_counter() - phase_t0)
    return {"launches": warm_runs, "launches_cold": cold_runs, "launches_snapshot": base_runs,
            "max_abs_err": in_err}


#: the pageRank() top 3 in the Gremlin and the Python spelling
GODS_TOP3 = ("g.V().pageRank().order().by('pagerank', reverse=True).limit(3).values('name')",
             "g.V().page_rank().order('pagerank', reverse=True).limit(3).values('name')")


def gods_phase(args, emit) -> dict:
    """The Graph of the Gods (BASELINE.json config 1): open_graph(),
    gods.load, PageRank through submit() on the card against a float64
    power iteration, the name index's plan and its unique check, and the
    pageRank() top 3 in both spellings through the query server."""
    import torch

    from janusgraph_tpu_torch.core import gods
    from janusgraph_tpu_torch.core.graph import open_graph
    from janusgraph_tpu_torch.exceptions import SchemaViolationError
    from janusgraph_tpu_torch.olap import GPUExecutor, kernels
    from janusgraph_tpu_torch.olap.programs import PageRankProgram

    t0 = time.perf_counter()
    g = open_graph()
    gods.load(g)
    load_s = time.perf_counter() - t0
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    res, runs = counted(lambda: g.compute().program(
        PageRankProgram(max_iterations=20, tol=0.0)).submit(), 20)
    wall = time.perf_counter() - t0
    if res.run_info["routing"]["device"] != "cuda" or res.csr.num_vertices != 12 or (
            res.csr.num_edges != 17):
        raise RuntimeError(f"the Gods submit: {res.run_info['routing']}, "
                           f"{res.csr.num_vertices} v, {res.csr.num_edges} e")
    rank = res.states["rank"]
    rel = max_rel(rank, pagerank_fp64(res.csr, 20))
    if not np.isfinite(rank).all() or not rel <= 1e-6:
        raise RuntimeError(f"the Gods' ranks: max rel diff {rel} from float64")
    ex = GPUExecutor(res.csr, strategy="segsum")
    in_plan = ex._segsum_plan("in")
    data = torch.rand(in_plan.num_edges, generator=torch.Generator(device="cuda").manual_seed(
        args.seed), device="cuda")
    _p, _g, err = check_plan("gods_in", in_plan, data, kernels)
    del ex
    t = g.traversal()
    herc = t.V().has("name", "hercules").values("age").to_list()
    plan = g.traversal().V().has("name", "hercules").profile().as_dict()["children"][0][
        "annotations"]
    if herc != [30] or plan.get("access") != "composite-index" or plan.get("index") != "name":
        raise RuntimeError(f"has('name', 'hercules'): {herc}, {plan}")
    tx = g.new_transaction()
    tx.add_vertex("god", name="jupiter")
    try:
        tx.commit()
    except SchemaViolationError:
        duplicate = "raised"
    else:
        raise RuntimeError("a duplicate name was accepted")
    top = res.csr.vertex_ids[np.argsort(-rank.astype(np.float64), kind="stable")[:3]]
    tx = g.new_transaction()
    top_names = [tx.get_vertex(int(v)).value("name") for v in top]
    tx.rollback()
    # both spellings of the pageRank() top 3 through the query server
    server, client = start_query_server({"graph": g})
    try:
        before = kernels.device_launches("cuda")
        t0 = time.perf_counter()
        served = [client.submit(q) for q in GODS_TOP3]
        served_s = time.perf_counter() - t0
        served_runs = kernels.device_launches("cuda") - before
    finally:
        stop_query_server(server)
    if served[0] != served[1] or served[0] != top_names or not served_runs:
        raise RuntimeError(f"the served top 3 {served} against the submit's {top_names}, "
                           f"{served_runs} kernel runs")
    emit("gods", vertices=12, edges=17, load_s=load_s, submit_wall_s=wall,
         run_wall_s=res.run_info["run_wall_s"], kernel_runs=runs, max_rel_diff_vs_fp64=rel,
         in_plan_max_abs_err=err, plan=plan, duplicate_name=duplicate, top3=top_names,
         served_top3_s=served_s, served_kernel_runs=served_runs)
    g.close()
    return {"launches": runs, "max_abs_err": err}


def io_phase(args, emit, card: str) -> dict:
    """Every datatype and graph I/O on the card (``IO_SCALE``, R-MAT edge
    factor 8): (1) a typed source graph written through transactions in
    batches, each vertex with a Long ``name`` (its index), one property of
    every datatype GraphSON round-trips in the reference (Date, Instant,
    Duration, LocalDate, LocalTime, Char, BigInteger, FloatList, a float32
    Array, Geoshape, String, Boolean), an Int ``bucket`` and a Float
    ``score``, each edge a Float ``w32`` weight in (0, 1]; (2) load_csr
    with the weights (the written float32s, bit for bit) and the typed
    columns (object columns equal to what was written), PageRank through
    submit() (20 kernel runs), weighted SSSP against scipy's Dijkstra over
    the same float32 weights, and a filtered OLAP traversal
    has("bucket", gt(k)) whose mask equals numpy's; (3) export_graphson,
    import_graphson into a graph that declares w32/score Double and bucket
    Long first (the reference's "existing definitions win": both packages
    refuse the Float and Int values otherwise), equal counts, every
    vertex's properties equal to the source's through ``name``, the
    imported weights equal bit for bit under the id map and PageRank over
    the import (20 kernel runs) within RANK_REL of the source's under the
    map (the import numbers the vertices in the export's row-key order, so
    its CSR is the source's permuted); (4) a GraphML round trip at
    ``IO_GRAPHML_SCALE`` with primitive properties and a submit over the
    import; (5) the g.io(path).write()/.read() and graph.io("graphml")
    spellings on a small graph; (6) the kernel against its plain version
    on the imported in-plan. Every time is printed with the card's name
    and power limit (``card``)."""
    import datetime as dt
    import os
    import shutil
    import tempfile

    import scipy.sparse as sp
    import torch
    from scipy.sparse.csgraph import dijkstra

    from janusgraph_tpu_torch import export_graphson, import_graphson
    from janusgraph_tpu_torch.core.attributes import BigInt, Char, Instant
    from janusgraph_tpu_torch.core.graph import open_graph
    from janusgraph_tpu_torch.core.io import export_graphml, import_graphml
    from janusgraph_tpu_torch.core.predicates import Cmp, Geoshape
    from janusgraph_tpu_torch.olap import GPUExecutor, kernels, rmat_edges
    from janusgraph_tpu_torch.olap.csr import load_csr
    from janusgraph_tpu_torch.olap.programs import PageRankProgram, ShortestPathProgram
    from janusgraph_tpu_torch.olap.programs.olap_traversal import (
        PropertyFilter,
        evaluate_filter_mask,
    )
    from janusgraph_tpu_torch.olap.programs.shortest_path import INF

    phase_t0 = time.perf_counter()
    work = tempfile.mkdtemp(prefix="jg_io_")
    rng = np.random.default_rng(args.seed + 15)
    n, src, dst = rmat_edges(IO_SCALE, edge_factor=8, seed=args.seed)
    m = len(src)
    w32 = (1.0 - rng.random(m)).astype(np.float32)  # in (0, 1]
    bucket = rng.integers(0, 16, n).astype(np.int32)
    score = rng.random(n).astype(np.float32)
    micros = rng.integers(-(10 ** 14), 10 ** 14, n)
    nanos = rng.integers(0, 10 ** 9, n)
    coords = rng.uniform(-80, 80, (n, 2))
    epoch = dt.datetime(1970, 1, 1, tzinfo=dt.timezone.utc)

    def props(i):
        us = int(micros[i])
        return {
            "name": i, "bucket": bucket[i], "score": score[i],
            "when": epoch + dt.timedelta(microseconds=us),
            "inst": Instant(us // 10 ** 6, int(nanos[i])),
            "dur": dt.timedelta(microseconds=us),
            "day": dt.date.fromordinal(1 + i % 700_000),
            "tod": dt.time(i % 24, i % 60, i % 59, i % 1_000_000),
            "ch": Char(chr(65 + i % 26)),
            "big": BigInt((1 << 70) + i),
            "fl": [float(coords[i, 0]), float(coords[i, 1])],
            "arr": coords[i].astype(np.float32),
            "loc": Geoshape.point(float(coords[i, 0]), float(coords[i, 1])),
            "label_s": f"v{i}",
            "even": i % 2 == 0,
        }

    def same(a, b):
        if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
            return (isinstance(a, np.ndarray) and isinstance(b, np.ndarray)
                    and a.dtype == b.dtype and np.array_equal(a, b))
        return a == b

    def pagerank():
        return PageRankProgram(max_iterations=20, tol=0.0)

    def in_plan_err(name, c):
        ex = GPUExecutor(c, strategy="segsum")
        plan = ex._segsum_plan("in")
        data = torch.rand(plan.num_edges, generator=torch.Generator(
            device="cuda").manual_seed(args.seed), device="cuda")
        return check_plan(name, plan, data, kernels)[2]

    # -- (1) the typed source graph, through transactions in batches
    t0 = time.perf_counter()
    g = open_graph({"query.max-traversers": 1 << 22})
    vids = np.empty(n, dtype=np.int64)
    for lo in range(0, n, IO_VERTEX_BATCH):
        tx = g.new_transaction()
        vs = [tx.add_vertex(**props(i)) for i in range(lo, min(n, lo + IO_VERTEX_BATCH))]
        tx.commit()
        vids[lo:lo + len(vs)] = [v.id for v in vs]
    vertices_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for lo in range(0, m, IO_EDGE_BATCH):
        tx = g.new_transaction()
        hi = min(m, lo + IO_EDGE_BATCH)
        ends = {int(v): tx.get_vertex(int(v)) for v in np.unique(
            np.concatenate([vids[src[lo:hi]], vids[dst[lo:hi]]]))}
        for k in range(lo, hi):
            tx.add_edge(ends[int(vids[src[k]])], "link", ends[int(vids[dst[k]])], w32=w32[k])
        tx.commit()
    edges_s = time.perf_counter() - t0
    types = {k: g.schema_cache.get_by_name(k).data_type.__name__ for k in props(0)}

    # -- (2) the source graph on the card
    t0 = time.perf_counter()
    keys = ("name", "bucket", "score")
    csr = load_csr(g, weight_key="w32", property_keys=keys)
    load_s = time.perf_counter() - t0
    names = csr.properties["name"].astype(np.int64)
    if not np.array_equal(np.sort(names), np.arange(n)) or csr.num_edges != m:
        raise RuntimeError(f"load_csr: {csr.num_vertices} v, {csr.num_edges} e")
    if csr.out_edge_weight.dtype != np.float32:
        raise RuntimeError(f"weights load as {csr.out_edge_weight.dtype}")
    row = np.repeat(np.arange(n), np.diff(csr.out_indptr))

    def edge_bits(c, nm):
        """(source name, destination name, weight bits), sorted."""
        r = np.repeat(np.arange(c.num_vertices), np.diff(c.out_indptr))
        a = np.stack([nm[r], nm[c.out_dst], c.out_edge_weight.astype(np.float32)
                      .view(np.uint32).astype(np.int64)])
        return a[:, np.lexsort(a[::-1])]

    written = np.stack([src.astype(np.int64), dst.astype(np.int64),
                        w32.view(np.uint32).astype(np.int64)])
    written = written[:, np.lexsort(written[::-1])]
    if not np.array_equal(edge_bits(csr, names), written):
        raise RuntimeError("the loaded weights are not the written float32s")
    for key, want in (("bucket", bucket), ("score", score)):
        col = csr.properties[key]
        if col.dtype != object or type(col[0]) is not type(want[0]) or not np.array_equal(
                col.astype(want.dtype).view(np.uint32 if key == "score" else np.int32),
                want[names].view(np.uint32 if key == "score" else np.int32)):
            raise RuntimeError(f"the {key} column: {col.dtype}, {type(col[0])}")
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    res, pr_runs = counted(lambda: g.compute().program(pagerank()).submit(), 20)
    submit_s = time.perf_counter() - t0
    if res.run_info["routing"]["device"] != "cuda":
        raise RuntimeError(f"the source submit: {res.run_info['routing']}")
    src_rank = res.states["rank"]
    rel = max_rel(src_rank, pagerank_fp64(res.csr, 20))
    if not np.isfinite(src_rank).all() or not rel <= 1e-5:
        raise RuntimeError(f"source PageRank: max rel diff {rel} from float64")
    if not np.array_equal(res.csr.vertex_ids, csr.vertex_ids):
        raise RuntimeError("the submit's snapshot orders the vertices otherwise than load_csr")
    src_rank_by_name = np.empty(n, dtype=np.float32)
    src_rank_by_name[names] = src_rank
    # weighted SSSP from the out-degree hub, against scipy over the float32s
    seed_index = int(np.argmax(np.diff(csr.out_indptr)))
    t0 = time.perf_counter()
    sssp = g.compute().weight("w32").program(
        ShortestPathProgram(seed_index=seed_index, weighted=True)).submit()
    sssp_s = time.perf_counter() - t0
    # parallel edges: scipy would sum them, so keep the lightest of each
    coo = sp.coo_matrix((csr.out_edge_weight.astype(np.float64), (row, csr.out_dst)),
                        shape=(n, n))
    order = np.lexsort((coo.data, coo.col, coo.row))
    r_, c_, d_ = coo.row[order], coo.col[order], coo.data[order]
    first = np.ones(len(r_), dtype=bool)
    first[1:] = (r_[1:] != r_[:-1]) | (c_[1:] != c_[:-1])
    lightest = sp.csr_matrix((d_[first], (r_[first], c_[first])), shape=(n, n))
    want_d = dijkstra(lightest, indices=seed_index)
    got_d = sssp.states["distance"]
    if not np.array_equal(sssp.csr.vertex_ids, csr.vertex_ids):
        raise RuntimeError("the SSSP snapshot orders the vertices otherwise than load_csr")
    reach = np.isfinite(want_d)
    away = reach & (want_d > 0)
    sssp_rel = max_rel(got_d[away], want_d[away])
    if not sssp_rel <= SSSP_RTOL or not (got_d[~reach] == np.float32(INF)).all() or (
            got_d[seed_index] != 0 or away.sum() < n // 4):
        raise RuntimeError(f"weighted SSSP: max rel diff {sssp_rel} from Dijkstra "
                           f"({int(reach.sum())} reached)")
    # the OLAP traversal's has("bucket", gt(k)) over the object column
    k = 7
    t0 = time.perf_counter()
    trav, trav_runs = counted(lambda: g.compute().traverse(
        ("out", ["link"], [("bucket", Cmp.GREATER_THAN, k)])).submit(), 1)
    trav_s = time.perf_counter() - t0
    tc = trav.csr
    mask = evaluate_filter_mask(tc, [PropertyFilter("bucket", Cmp.GREATER_THAN, k)])
    want_mask = (tc.properties["bucket"].astype(np.int32) > k).astype(np.float32)
    want_count = np.diff(tc.in_indptr).astype(np.float32) * want_mask
    if not np.array_equal(mask, want_mask) or not np.array_equal(
            trav.states["count"], want_count):
        raise RuntimeError("has('bucket', gt(k)): the mask or the counts differ from numpy")
    emit("io_source", vertices=n, edges=m, types=types, vertices_s=vertices_s,
         edges_s=edges_s, load_csr_s=load_s, submit_s=submit_s, kernel_runs=pr_runs,
         pagerank_max_rel_vs_fp64=rel, sssp_s=sssp_s, sssp_reached=int(reach.sum()),
         sssp_max_rel_vs_dijkstra=sssp_rel, sssp_rtol=SSSP_RTOL, traversal_s=trav_s,
         traversal_kernel_runs=trav_runs, mask_kept=int(mask.sum()), card=card,
         seconds=time.perf_counter() - phase_t0)

    # -- (3) the GraphSON round trip
    path = os.path.join(work, "graph.json")
    t0 = time.perf_counter()
    exported = export_graphson(g, path)
    export_s = time.perf_counter() - t0
    size = os.path.getsize(path)
    h = open_graph({"query.max-traversers": 1 << 22})
    hm = h.management()
    hm.make_property_key("w32", float)
    hm.make_property_key("score", float)
    hm.make_property_key("bucket", int)
    t0 = time.perf_counter()
    imported = import_graphson(h, path, batch_size=IO_IMPORT_BATCH)
    import_s = time.perf_counter() - t0
    if imported != exported or exported != {"vertices": n, "edges": m}:
        raise RuntimeError(f"GraphSON: exported {exported}, imported {imported}")
    t0 = time.perf_counter()
    want_props = {}
    tx = g.new_transaction()
    for v in tx.vertices():
        p = {q.key: q.value for q in v.properties()}
        want_props[p["name"]] = p
    tx.rollback()
    tx = h.new_transaction()
    checked = 0
    for v in tx.vertices():
        p = {q.key: q.value for q in v.properties()}
        want = want_props[p["name"]]
        if p.keys() != want.keys() or not all(same(p[key], want[key]) for key in p):
            raise RuntimeError(f"vertex {p['name']}: {p} != {want}")
        checked += 1
    tx.rollback()
    compare_s = time.perf_counter() - t0
    if checked != n:
        raise RuntimeError(f"compared {checked} of {n} vertices")
    icsr = load_csr(h, weight_key="w32", property_keys=("name",))
    inames = icsr.properties["name"].astype(np.int64)
    if icsr.out_edge_weight.dtype != np.float32 or not np.array_equal(
            edge_bits(icsr, inames), written):
        raise RuntimeError("the imported weights are not the source's float32s")
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    ires, ipr_runs = counted(lambda: h.compute().program(pagerank()).submit(), 20)
    isubmit_s = time.perf_counter() - t0
    if not np.array_equal(ires.csr.vertex_ids, icsr.vertex_ids):
        raise RuntimeError("the import's submit orders the vertices otherwise than load_csr")
    irank_by_name = np.empty(n, dtype=np.float32)
    irank_by_name[inames] = ires.states["rank"]
    # the import assigns its ids in the export's order (the source's row-key
    # order, not its id order), so its CSR is the source's with the vertices
    # permuted: each in-segment sums its edges in another order and at
    # other merge-path splits, so the ranks agree to RANK_REL, not bit for bit
    bitwise = bits_equal(irank_by_name, src_rank_by_name)
    rank_rel = max_rel(irank_by_name, src_rank_by_name)
    permuted = not np.array_equal(inames, names)
    if not rank_rel <= RANK_REL or not (bitwise or permuted):
        raise RuntimeError(f"PageRank over the GraphSON import: max rel {rank_rel} from the "
                           f"source's (bitwise {bitwise}, permuted {permuted})")
    # (6) the kernel against its plain version on the source's and the
    # import's in-plans
    err = max(in_plan_err("io_source_in", csr), in_plan_err("io_import_in", icsr))
    emit("io_graphson", vertices=n, edges=m, export_s=export_s, bytes=size,
         import_s=import_s, compare_s=compare_s, vertices_compared=checked,
         submit_s=isubmit_s, kernel_runs=ipr_runs, ranks_bitwise=bitwise,
         ranks_max_rel=rank_rel, vertex_order_permuted=permuted,
         in_plan_max_abs_err=err, card=card, seconds=time.perf_counter() - phase_t0)
    g.close()
    h.close()

    # -- (4) GraphML at a smaller scale, primitive properties only
    gn, gsrc, gdst = rmat_edges(IO_GRAPHML_SCALE, edge_factor=8, seed=args.seed + 1)
    gm = open_graph({"query.max-traversers": 1 << 22})
    tx = gm.new_transaction()
    gvs = [tx.add_vertex("node", name=i, x=float(i) / 7, tag=f"n{i}", even=i % 2 == 0)
           for i in range(gn)]
    for k in range(len(gsrc)):
        tx.add_edge(gvs[int(gsrc[k])], "link", gvs[int(gdst[k])], w=float(k) / 3)
    tx.commit()
    del gvs
    xml = os.path.join(work, "graph.xml")
    t0 = time.perf_counter()
    xml_out = export_graphml(gm, xml)
    xml_export_s = time.perf_counter() - t0
    gi = open_graph({"query.max-traversers": 1 << 22})
    t0 = time.perf_counter()
    xml_in = import_graphml(gi, xml, batch_size=IO_IMPORT_BATCH)
    xml_import_s = time.perf_counter() - t0
    if xml_in != xml_out or xml_out != {"vertices": gn, "edges": len(gsrc)}:
        raise RuntimeError(f"GraphML: exported {xml_out}, imported {xml_in}")
    kernels.reset_launch_counts()
    xres, xml_runs = counted(lambda: gi.compute().program(pagerank()).submit(), 20)
    if xres.csr.num_edges != len(gsrc) or not np.isfinite(xres.states["rank"]).all():
        raise RuntimeError(f"the GraphML import's submit: {xres.csr.num_edges} edges")
    err = max(err, in_plan_err("io_graphml_in", xres.csr))
    emit("io_graphml", vertices=gn, edges=len(gsrc), export_s=xml_export_s,
         bytes=os.path.getsize(xml), import_s=xml_import_s, kernel_runs=xml_runs,
         in_plans_max_abs_err=err, card=card,
         seconds=time.perf_counter() - phase_t0)
    gm.close()
    gi.close()

    # -- (5) the g.io() and graph.io() spellings on a small graph
    small = open_graph()
    t = small.traversal()
    people = [t.add_v("person", name=f"p{i}", age=20 + i) for i in range(16)]
    for i in range(16):
        t.add_e(people[i], "knows", people[(i * 5 + 1) % 16])
    t.commit()
    spelled = {}
    for spelling, fname in (("g_io_graphson", "s.json"), ("g_io_graphml", "s.xml"),
                            ("graph_io_graphml", "s.graphml")):
        target = open_graph()
        p = os.path.join(work, fname)
        if spelling == "graph_io_graphml":
            wrote, read = small.io("graphml").write(p), target.io("graphml").read(p)
        else:
            wrote, read = small.traversal().io(p).write(), target.traversal().io(p).read()
        ages = sorted(target.traversal().V().values("age").to_list())
        if not wrote == read == {"vertices": 16, "edges": 16} or ages != list(range(20, 36)):
            raise RuntimeError(f"{spelling}: wrote {wrote}, read {read}, ages {ages}")
        spelled[spelling] = read
        target.close()
    small.close()
    shutil.rmtree(work, ignore_errors=True)
    emit("io", vertices=n, edges=m, kernel_runs={"source": pr_runs, "import": ipr_runs,
                                                  "graphml": xml_runs, "traversal": trav_runs},
         graphson_bytes=size, spellings=spelled, card=card,
         seconds=time.perf_counter() - phase_t0)
    return {"launches": pr_runs, "launches_import": ipr_runs, "launches_graphml": xml_runs,
            "launches_traversal": trav_runs, "max_abs_err": err}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scale", type=int, default=20)
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2

    from janusgraph_tpu_torch import _build, native
    from janusgraph_tpu_torch.native import segment_ids
    from janusgraph_tpu_torch.observability import profiler
    from janusgraph_tpu_torch.olap import (
        GPUExecutor,
        csr_from_edges,
        rmat_csr,
        rmat_edges,
        run_on,
    )
    from janusgraph_tpu_torch.olap import kernels
    from janusgraph_tpu_torch.olap.programs import (
        ConnectedComponentsProgram,
        PageRankProgram,
        ShortestPathProgram,
        TraversalCountProgram,
        reconstruct_path,
    )
    from janusgraph_tpu_torch.olap.vertex_program import INF

    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    TEL.install()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    emit("device", kind=kind, count=torch.cuda.device_count(), nvidia_smi=smi,
         torch=torch.__version__, cuda=torch.version.cuda, peaks=profiler.device_peaks())

    # ---------------------------------------------------------------- build
    _build.load_library()
    info = _build.build_info
    ptxas = [ln.strip() for ln in info["log"].splitlines() if "registers" in ln or "spill" in ln]
    emit("build", seconds=round(info["seconds"], 3), cached=info["cached"], ptxas=ptxas)

    # ------------------------------------------------------- graph (host)
    # the native host library draws the reference bench's graph; the numpy
    # versions are timed beside it (the R-MAT draw is another stream, the
    # CSR build the same arrays)
    if not native.available():
        raise RuntimeError(f"the native host library did not build: {_build.host_build_info}")
    t0 = time.perf_counter()
    csr = rmat_csr(args.scale, 16, seed=args.seed)
    host_s = time.perf_counter() - t0
    n, m = csr.num_vertices, csr.num_edges
    timing_scale = min(args.scale, GRAPH_TIMING_SCALE)
    t0 = time.perf_counter()
    timing_n, gsrc, gdst = rmat_edges(timing_scale, 16, seed=args.seed)
    rmat_native_s = time.perf_counter() - t0
    with native.numpy_only():
        t0 = time.perf_counter()
        rmat_edges(timing_scale, 16, seed=args.seed)
        rmat_numpy_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    built = native.build_csr(timing_n, gsrc, gdst)
    build_native_s = time.perf_counter() - t0
    with native.numpy_only():
        t0 = time.perf_counter()
        built_np = native.build_csr(timing_n, gsrc, gdst)
        build_numpy_s = time.perf_counter() - t0
    if not all(np.array_equal(a, b) for a, b in zip(built, built_np)):
        raise RuntimeError("build_csr: native and numpy arrays differ")
    del gsrc, gdst, built, built_np
    emit("graph", scale=args.scale, vertices=n, edges=m, native=native.available(),
         host_library_build_s=_build.host_build_info["seconds"],
         host_library_cached=_build.host_build_info["cached"],
         max_in_degree=int(csr.in_degree.max()), host_s=host_s, timing_scale=timing_scale,
         rmat_native_s=rmat_native_s, rmat_numpy_s=rmat_numpy_s,
         build_csr_native_s=build_native_s, build_csr_numpy_s=build_numpy_s)

    # ------------------------------------------------ kernel vs plain, card
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    # PageRank's messages are positive; so are these (no cancellation, so
    # fp32 sums in two orders stay inside the reference's rtol)
    data = torch.rand(m, generator=gen, device=dev)
    seg = segment_ids(csr.in_indptr, m)
    plan, got, max_err = check_kernel_case("rmat", seg, n, data, kernels)
    want64 = np.bincount(seg, weights=data.cpu().numpy().astype(np.float64), minlength=n)
    err64 = float(np.abs(got.cpu().numpy() - want64).max())
    lengths = torch.as_tensor(csr.in_degree.astype(np.int64), device=dev)
    kernel_ms = flushed_ms(lambda: kernels.sorted_segment_sum(data, plan))
    kernel_ms_warm = cuda_ms(lambda: kernels.sorted_segment_sum(data, plan), 50)
    kernel_ms_read_flush = flushed_ms(lambda: kernels.sorted_segment_sum(data, plan),
                                      by_reading=True)
    plain_ms = flushed_ms(lambda: kernels.sorted_segment_sum_plain(data, plan))
    library_ms = flushed_ms(lambda: torch.segment_reduce(data, "sum", lengths=lengths))
    # the bound counts what the sum needs (values and sums once, the n + 1
    # segment offsets once), whatever layout a kernel reads
    nbytes = plan.function_bytes()
    bound_ms = max(nbytes / PEAK_BYTES_PER_S, m / PEAK_FP32_FLOPS) * 1e3
    kernel_bytes = plan.kernel_read_bytes()
    emit("kernel", case="rmat", edges=m, segments=n, items_per_cta=plan.items_per_cta,
         num_ctas=plan.num_ctas, max_segment_cta_span=plan.max_segment_cta_span(),
         ctas_per_sm=_build.load_library().jg_segsum_ctas_per_sm(plan.items_per_cta),
         max_abs_err=max_err, max_abs_err_vs_fp64=err64, kernel_ms=kernel_ms,
         kernel_ms_warm=kernel_ms_warm, kernel_ms_read_flush=kernel_ms_read_flush,
         plain_ms=plain_ms, library_ms=library_ms,
         bytes=nbytes, bound_ms=bound_ms, bound_by="bytes",
         share_of_bound=bound_ms / kernel_ms, kernel_bytes=kernel_bytes,
         kernel_bytes_per_s=kernel_bytes / (kernel_ms * 1e-3))

    rng = np.random.default_rng(args.seed)
    hub = np.concatenate([
        np.sort(rng.integers(0, 7, 500)), np.full(200_000, 7),
        np.sort(rng.integers(8, 5000, 20_000)),
    ])
    n_u, src_u, dst_u = rmat_edges(max(args.scale - 2, 8), 16, seed=args.seed, permute=False)
    unpermuted = csr_from_edges(n_u, src_u, dst_u)
    cases = {
        # name: (segment ids, segments, plan arguments, data offset)
        "empty_segments_and_tiles": (np.array([0, 0, 5, 1030, 3100]), 4000, {}, 0),
        "hub_over_many_blocks": (hub, 5000, {}, 0),
        "hub_over_many_ctas_small": (hub, 5000, {"items_per_cta": 256}, 0),
        "no_edges": (np.zeros(0, dtype=np.int64), 3000, {}, 0),
        "random_multi_tile": (np.sort(rng.integers(0, 2500, 9000)), 2500, {}, 0),
        "empty_run_1e5": (np.concatenate([
            np.sort(rng.integers(0, 5, 4000)), np.sort(rng.integers(100_005, 100_010, 4000)),
        ]), 100_010, {}, 0),
        "one_segment_owns_all": (np.full(300_000, 3), 10, {}, 0),
        "unaligned_edge_count": (np.sort(rng.integers(0, 50_000, 1_000_003)), 50_000, {}, 0),
        # data starting 4 bytes past a 16-byte boundary: the copies' ends
        # are plain loads
        "misaligned_data_view": (np.sort(rng.integers(0, 50_000, 1_000_003)), 50_000, {}, 1),
        "rmat_unpermuted_in_csr": (segment_ids(unpermuted.in_indptr, unpermuted.num_edges),
                                   n_u, {}, 0),
    }
    for name, (cseg, ns, kw, offset) in cases.items():
        cdata = torch.rand(len(cseg) + offset, generator=gen, device=dev)[offset:]
        cplan, _g, err = check_kernel_case(name, cseg, ns, cdata, kernels, **kw)
        case_ms = flushed_ms(lambda: kernels.sorted_segment_sum(cdata, cplan))
        emit("kernel", case=name, edges=len(cseg), segments=ns, max_abs_err=err,
             items_per_cta=cplan.items_per_cta, num_ctas=cplan.num_ctas,
             max_segment_cta_span=cplan.max_segment_cta_span(), kernel_ms=case_ms)

    # ------------------------------------------- main path: PageRank, s20
    def pagerank():
        return PageRankProgram(max_iterations=20, tol=0.0)

    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    TEL.label = "pagerank_fused"
    result, main_launches = counted(lambda: run_on(csr, pagerank(), strategy="segsum"), 20)
    first_wall = time.perf_counter() - t0
    launches = kernels.launch_counts()
    rank = result["rank"]
    # the wrapper counts its one eager launch (superstep 0); the other 19
    # replay from CUDA graphs, which the kernel's device counter sees
    if launches["sorted_segment_sum"] < 1:
        raise RuntimeError(f"main path: {launches} eager launches, expected 1 a run")
    if rank.shape != (n,) or not np.isfinite(rank).all():
        raise RuntimeError("PageRank ranks are not finite")
    if abs(float(rank.astype(np.float64).sum()) - 1.0) > 1e-3:
        raise RuntimeError(f"PageRank mass {rank.sum()} is not 1")

    # the host loop, timed as in the slices before the fused loop
    timed, execs = {}, {}
    for strategy in ("segsum", "ell"):
        ex = GPUExecutor(csr, strategy=strategy)
        ex.run(pagerank(), fused=False)  # warm: plan/pack build and transfer
        TEL.label = "pagerank_host_loop" if strategy == "segsum" else None
        out = ex.run(pagerank(), fused=False)
        info = dict(ex.last_run_info)
        if info["supersteps"] != 20 or info["path"] != "host-loop":
            raise RuntimeError(f"{strategy}: {info}")
        if strategy == "segsum" and info["kernel_launches"] != info["supersteps"]:
            raise RuntimeError(f"kernel_launches {info['kernel_launches']} != supersteps")
        timed[strategy] = (info, out["rank"])
        execs[strategy] = ex
        if strategy == "segsum":
            profile_run(ex, pagerank(), emit, fused=False)
    if not bits_equal(rank, timed["segsum"][1]):
        raise RuntimeError("run_on's fused PageRank differs from the host loop")
    ell_rank = timed["ell"][1]
    rel = float(np.max(np.abs(rank.astype(np.float64) - ell_rank) / np.abs(ell_rank)))
    if rel > 1e-4:
        raise RuntimeError(f"segsum vs ell PageRank max rel diff {rel}")
    seg_info = timed["segsum"][0]
    emit("pagerank", scale=args.scale, supersteps=20, kernel_launches=main_launches,
         eager_kernel_launches=launches["sorted_segment_sum"],
         first_run_wall_s_profiled=first_wall, wall_s=seg_info["wall_s"],
         superstep_ms=seg_info["wall_s"] / 20 * 1e3,
         edges_per_s=20 * m / seg_info["wall_s"],
         ell_wall_s=timed["ell"][0]["wall_s"],
         ell_superstep_ms=timed["ell"][0]["wall_s"] / 20 * 1e3,
         max_rel_diff_vs_ell=rel, rank_sum=float(rank.astype(np.float64).sum()))

    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import connected_components, shortest_path

    src = np.repeat(np.arange(n), np.diff(csr.out_indptr))
    adj = coo_matrix((np.ones(m), (src, csr.out_dst)), shape=(n, n)).tocsr()
    seg_ex = execs["segsum"]
    seed = int(np.argmax(csr.out_degree))

    # ------------------------------- autotune, hybrid, fused, checkpoints
    autotune_phase(csr, kind, emit)
    hybrid_phase(csr, seg_ex, rank.astype(np.float64), emit)
    kernels.reset_launch_counts()
    fused = fused_phase(csr, seg_ex, execs["ell"],
                        {s: timed[s][1] for s in timed}, adj, seed, emit)
    fused_launches = fused["segsum"]["kernel_runs"]
    checkpoint_phase(csr, rank, emit)

    # ------------------------------------ connected components, both paths
    ncomp, labels = connected_components(adj, directed=True, connection="weak")
    first = np.full(ncomp, n, dtype=np.int64)
    np.minimum.at(first, labels, np.arange(n))
    cc = {}
    # the first dense run also builds the undirected ELL pack; the second
    # times the run alone; "auto" keeps CC dense, "always" takes the
    # frontier engine
    modes = (("dense_first", "off"), ("dense", "off"), ("auto", "auto"), ("always", "always"))
    for key, mode in modes:
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        comp = seg_ex.run(ConnectedComponentsProgram(), frontier=mode)["component"]
        wall = time.perf_counter() - t0
        info = dict(seg_ex.last_run_info)
        if not np.array_equal(comp.astype(np.int64), first[labels]):
            raise RuntimeError(f"CC (frontier={mode}) labels differ from scipy's components")
        cc[key] = {"path": info["path"], "supersteps": info["supersteps"], "wall_s": wall,
                    "run_wall_s": info["wall_s"],
                    "strategy_resolved": info.get("strategy_resolved"),
                    "kernel_launches": kernels.launch_counts()["sorted_segment_sum"]}
    for key in ("dense_first", "dense", "auto"):
        if cc[key]["path"] != "fused" or cc[key]["strategy_resolved"] != "ell":
            raise RuntimeError(f"CC ({key}) did not run dense through ELL: {cc}")
    if cc["always"]["path"] != "frontier":
        raise RuntimeError(f"CC (frontier='always') did not take the frontier engine: {cc}")
    emit("cc", components=int(ncomp), **cc, always_tiers=seg_ex.last_run_info["tiers"])

    # ------------------------------------------------ BFS, 4 hops, frontier
    want = shortest_path(adj, method="D", directed=True, unweighted=True, indices=seed)

    def bfs4():
        return ShortestPathProgram(seed_index=seed, max_iterations=4)

    # the path as a user drives it, counted; then one warm and one timed
    # run on a kept executor
    kernels.reset_launch_counts()
    dist_run_on = run_on(csr, bfs4())["distance"]
    bfs_launches = kernels.launch_counts()["sorted_segment_sum"]
    seg_ex.run(bfs4())  # warm: the engine's pointer arrays
    TEL.label = "bfs_tuned"
    dist = seg_ex.run(bfs4())["distance"]
    info = dict(seg_ex.last_run_info)
    if info["path"] != "frontier" or not 1 <= info["supersteps"] <= 4:
        raise RuntimeError(f"BFS did not take the frontier engine: {info}")
    if not np.array_equal(dist.view(np.int32), dist_run_on.view(np.int32)):
        raise RuntimeError("run_on's BFS differs from the executor's")
    if {t["tier_source"] for t in info["tiers"]} != {"autotune"}:
        raise RuntimeError(f"BFS did not price on the tuned ladders: {info['tiers']}")
    dense = execs["ell"].run(bfs4(), frontier="off")["distance"]
    if execs["ell"].last_run_info["path"] != "fused":
        raise RuntimeError("frontier='off' did not run dense")
    if not np.array_equal(dist.view(np.int32), dense.view(np.int32)):
        raise RuntimeError("frontier BFS differs from the dense ELL run")
    expect = np.where(want <= 4, want, INF).astype(np.float32)
    if not np.array_equal(dist, expect):
        raise RuntimeError("BFS distances differ from scipy's")
    # the static ladder (autotune=False), as before the tuned ladders
    static_ex = GPUExecutor(csr, strategy="segsum", autotune=False)
    static_ex.run(bfs4())  # warm
    static_dist = static_ex.run(bfs4())["distance"]
    static = dict(static_ex.last_run_info)
    if not bits_equal(static_dist, dist) or {t["tier_source"] for t in static["tiers"]} != {"static"}:
        raise RuntimeError("the static-ladder BFS differs from the tuned one")
    emit("bfs", seed=seed, seed_out_degree=int(csr.out_degree[seed]),
         hops=info["supersteps"], reached=int(np.sum(dist < INF)),
         tiers=info["tiers"], hop_wall_s=info["hop_wall_s"],
         bfs_4hop_wall_s=info["wall_s"], static_tiers=static["tiers"],
         static_hop_wall_s=static["hop_wall_s"], static_bfs_4hop_wall_s=static["wall_s"],
         # as before the fused loop: host-loop PageRank + static ladder
         pagerank_plus_bfs4_wall_s=seg_info["wall_s"] + static["wall_s"],
         fused_pagerank_plus_tuned_bfs4_wall_s=fused["segsum"]["wall_s"] + info["wall_s"],
         dense_wall_s=execs["ell"].last_run_info["wall_s"], kernel_launches=bfs_launches)
    profile_run(seg_ex, bfs4(), emit, phase="bfs_profile")
    frontier_parts(seg_ex, seed, emit)

    # ------------------------------------- BFS with paths, to convergence
    def tracked():
        return ShortestPathProgram(seed_index=seed, track_paths=True)

    res = seg_ex.run(tracked())
    info = dict(seg_ex.last_run_info)
    dense = execs["ell"].run(tracked(), frontier="off")
    for key in ("distance", "predecessor"):
        if not np.array_equal(res[key].view(np.int32), dense[key].view(np.int32)):
            raise RuntimeError(f"tracked BFS {key} differs from the dense run")
    if info["path"] != "frontier" or not np.array_equal(
        res["distance"], np.where(np.isfinite(want), want, INF).astype(np.float32)
    ):
        raise RuntimeError("tracked BFS distances differ from scipy's")
    reached = np.nonzero(res["distance"] < INF)[0]
    # 1,000 targets (every reached vertex on a graph that reaches fewer)
    targets = np.random.default_rng(args.seed).choice(reached, min(1000, len(reached)), replace=False)
    for v in targets:
        path = reconstruct_path(res, int(v))
        if path is None or path[0] != seed or path[-1] != v or len(path) != res["distance"][v] + 1:
            raise RuntimeError(f"path to {v} is not a chain of length dist: {path}")
        for a, b in zip(path, path[1:]):
            if not np.any(csr.out_dst[csr.out_indptr[a]:csr.out_indptr[a + 1]] == b):
                raise RuntimeError(f"path to {v}: {a}->{b} is not an edge")
    emit("paths", hops=info["supersteps"], reached=len(reached), paths_checked=len(targets),
         wall_s=info["wall_s"], dense_wall_s=execs["ell"].last_run_info["wall_s"],
         dense_supersteps=execs["ell"].last_run_info["supersteps"])

    # ------------------------------------------- 3-hop traversal count
    kernels.reset_launch_counts()
    counts, khop_launches = counted(
        lambda: run_on(csr, TraversalCountProgram(hops=3), strategy="segsum")["count"], 3)
    khop_eager = kernels.launch_counts()["sorted_segment_sum"]
    if khop_eager < 1:
        raise RuntimeError(f"3-hop count: {khop_eager} eager launches, expected 1 a run")
    seg_ex.run(TraversalCountProgram(hops=3))  # warm
    timed_counts = seg_ex.run(TraversalCountProgram(hops=3))["count"]
    khop_info = dict(seg_ex.last_run_info)
    if (khop_info["kernel_launches"] + khop_info["graph_kernel_launches"] != 3
            or not np.array_equal(timed_counts, counts)):
        raise RuntimeError(f"3-hop count on the kept executor: {khop_info}")
    ell_counts = execs["ell"].run(TraversalCountProgram(hops=3))["count"]
    if counts.shape != (n,) or not np.isfinite(counts).all():
        raise RuntimeError("3-hop counts are not finite")
    if not np.allclose(counts, ell_counts, **TOL):
        raise RuntimeError("3-hop counts differ from the ELL strategy's")
    x = np.ones(n)
    for _ in range(3):
        x = adj.T @ x
    total = float(counts.astype(np.float64).sum())
    if abs(total - float(x.sum())) > 1e-4 * float(x.sum()):
        raise RuntimeError(f"3-hop total {total} differs from the product's {x.sum()}")
    emit("khop", hops=3, kernel_launches=khop_launches,
         wall_s=khop_info["wall_s"],
         total_paths=total, total_paths_fp64=float(x.sum()),
         max_rel_diff_vs_ell=float(np.max(np.abs(counts - ell_counts) / np.maximum(ell_counts, 1))),
         ell_wall_s=execs["ell"].last_run_info["wall_s"])

    traversal = traversal_phase(csr, args, seg_ex, execs["ell"], adj, rank,
                                fused["segsum"]["wall_s"], emit)
    peer_pressure_phase(csr, seg_ex, args, emit)
    del seg_ex, execs, fused
    kernels.reset_launch_counts()
    delta = delta_phase(csr, args, emit)
    dense_phase(csr, args, emit)
    ldbc_launches = ldbc_phase(emit)
    stored = stored_phase(csr, args, emit)
    stored_local = stored_local_phase(
        stored, csr, args, emit,
        remote=lambda *a: remote_phase(*a, args=args, emit=emit))
    remote = stored_local["remote"]
    kernels.reset_launch_counts()
    sharded = sharded_phase(stored, csr, args, emit)
    kernels.reset_launch_counts()
    sharded_olap = sharded_olap_phase(stored, csr, rank, first[labels], seed, want, args, emit,
                                      smi)
    kernels.reset_launch_counts()
    multiproc = multiprocess_olap_phase(csr, sharded_olap["auto"], seed, first[labels], want,
                                        args, emit, smi)
    kernels.reset_launch_counts()
    stored_delta = stored_delta_phase(stored, args, emit)
    kernels.reset_launch_counts()
    oltp = oltp_phase(stored, args, emit, smi)
    kernels.reset_launch_counts()
    logs = logs_phase(stored, args, emit, smi)
    kernels.reset_launch_counts()
    indexed = indexed_phase(stored, args, emit)
    gods_run = gods_phase(args, emit)
    kernels.reset_launch_counts()
    io_run = io_phase(args, emit, smi)
    graphlint_phase(args, emit)
    kernels.reset_launch_counts()
    parity = parity_phase(args, emit)
    # the north-star rung runs last: at scale 23 it peaks at about 20 GB of
    # host memory and 11 GB on the card, and no phase's time should depend
    # on what that leaves behind
    kernels.reset_launch_counts()
    north_star = north_star_phase(args, emit, dev)
    telemetry_phase(emit)
    print(json.dumps({"kernels": [{
        "name": "sorted_segment_sum",
        "route": "cuda",
        "source": "janusgraph_tpu_torch/csrc/segsum.cu",
        "replaces": "janusgraph_tpu/olap/kernels.py:764",
        # counted by the kernel's device counter (CUDA-graph replays
        # included): run_on's PageRank, a fused PageRank on a kept
        # executor, run_on's 3-hop count
        "launches": main_launches,
        "launches_fused": fused_launches,
        "launches_khop": khop_launches,
        # the north-star rung (scale 23): run_on's PageRank, and the kernel
        # against its plain version on that graph's in-plan
        "launches_north_star": north_star["launches"],
        **{f"{k}_north_star": north_star["kernel"][v] for k, v in (
            ("max_abs_err", "max_abs_err"), ("ms", "kernel_ms"), ("plain_ms", "plain_ms"),
            ("bound_ms", "bound_ms"), ("library_ms", "library_ms"))},
        # the delta PageRank: base, adds and tombstones each superstep
        "launches_delta": delta["launches"],
        # the filtered 3-hop (scale 20), the typed chain, the degree
        # program and the SF1 proxy's filtered 3-hop, each on its
        # channel's plan
        "launches_traversal": traversal["filtered"],
        "launches_typed": traversal["typed"],
        "launches_degree": traversal["degree"],
        "launches_ldbc": ldbc_launches,
        # graph.compute().program(PageRank(20, tol=0)).submit() over the stored
        # graph, first and warm, and its 3-hop traverse()
        "launches_stored": stored["launches"],
        "launches_stored_warm": stored["launches_warm"],
        "launches_stored_traverse": stored["launches_traverse"],
        # the same graph in a local directory: the cold submit after a
        # reopen (in-process scan), through 8 loader processes,
        # and the warm submit after the LOCK-consistency commit
        "launches_stored_local": stored_local["launches"],
        **{f"launches_stored_local_w{w}": r
           for w, r in stored_local["launches_by_workers"].items()},
        "launches_stored_local_locked": stored_local["launches_locked_warm"],
        # the same directory served by a storage server in its own process
        # (storage.backend "remote"): the cold submit over the in-process
        # scan, through 8 loader processes, and the warm fused submit after
        # a 1,000-edge commit over the wire
        "launches_remote": remote["launches"],
        "launches_remote_w8": remote["launches_w8"],
        "launches_remote_warm": remote["launches_warm"],
        "max_abs_err_remote": remote["max_abs_err"],
        # over the sharded store (three nodes) with the fault injector on:
        # the cold submit, preempted once and resumed from its checkpoint
        # (20 supersteps plus any the resume recomputed)
        "launches_sharded": sharded["launches"],
        "max_abs_err_sharded": sharded["max_abs_err"],
        # the sharded executor on 8 slots of the card, in one process and
        # over two processes (gloo): no hand kernel on either path
        "launches_sharded_olap": sharded_olap["kernel_runs"],
        "launches_multiprocess_olap": multiproc["kernel_runs"],
        # after an OLTP transaction, PageRank through submit() on the
        # "fused" path (base, adds and tombstones each superstep), and
        # after a bulk burst on the "refresh" path (the compacted base)
        "launches_stored_delta": stored_delta["launches"],
        "launches_stored_refresh": stored_delta["launches_refresh"],
        # g.V().page_rank()...limit(10) over the reopened stored graph (its
        # first submit, over the snapshot the fleet's export scanned), and a
        # spilled 3-hop count (one run a hop on the "link" channel's plan)
        "launches_oltp_page_rank": oltp["launches"],
        "launches_oltp_spill": oltp["launches_spill"],
        # the same top 10 as served through the two-replica fleet's
        # frontend (the runs above), and the warmed replica r1's direct
        # submit over the snapshot warm_replica installed from r0's export
        "launches_fleet_top10": oltp["launches"],
        "launches_fleet_warm": oltp["launches_warm"],
        # over the stored graph with a mixed index on its ranks and a
        # vertex-centric index on "link": the submit that built the warm
        # snapshot, the warm submit after 1,000 timed edges (the "refresh"
        # path, from the change capture) and a cold submit (a fresh scan);
        # and the Graph of the Gods' PageRank
        # the durable logs: PageRank over the CSR the CDC follower folded
        # (run_on), the submit of the instance the follower serves (its
        # adopted snapshot) and of the instance that rolled the torn
        # commit forward
        "launches_logs_folded": logs["launches"],
        "launches_follower": logs["launches_follower"],
        "launches_logs_recovered": logs["launches_recovered"],
        "launches_indexed": indexed["launches"],
        "launches_indexed_cold": indexed["launches_cold"],
        "launches_indexed_snapshot": indexed["launches_snapshot"],
        "launches_gods": gods_run["launches"],
        # the io phase: PageRank through submit() over the typed source
        # graph, over its GraphSON import and over a GraphML import, and
        # the filtered OLAP traversal over the Int column
        "launches_io": io_run["launches"],
        "launches_io_import": io_run["launches_import"],
        "launches_io_graphml": io_run["launches_graphml"],
        "launches_io_traversal": io_run["launches_traversal"],
        "max_abs_err_io": io_run["max_abs_err"],
        # the kernel against its plain version on the indexed graph's and
        # the Gods' in-plans
        "max_abs_err_indexed": indexed["max_abs_err"],
        "max_abs_err_logs": logs["max_abs_err"],
        "max_abs_err_gods": gods_run["max_abs_err"],
        # the parity phase: PageRank through submit() over a graph opened
        # with the eight once-refused options, the metrics store on and the
        # slice cache off (cold and warm), and the kernel on its in-plan
        "launches_parity": parity["launches"],
        "launches_parity_warm": parity["launches_warm"],
        "max_abs_err_parity": parity["max_abs_err"],
        # the kernel against its plain version on the stored path's in-plan
        # and "link" channel plan
        "max_abs_err_stored": stored["max_abs_err"],
        # the kernel against its plain version on the add and tombstone
        # lanes' plans of the stored graph's overlay
        "max_abs_err_stored_lanes": stored_delta["max_abs_err"],
        "max_abs_err": max_err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "bytes",
        "library_ms": library_ms,
        "kernel_ms_warm": kernel_ms_warm,
        "share_of_bound": bound_ms / kernel_ms,
        "held_by": "kernel",
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
