"""Typed configuration: the options the port honours and the merged view
of local and cluster-global values — the port's copy of
``GraphConfiguration`` and ``ConfigOption`` from
``janusgraph_tpu/core/config.py``.

The registry holds only the options the stored-graph OLAP path (with the
local store and distributed loading), the backend's cache, retry guard and
lockers, the transaction and its schema checks, the indexes (the
``memindex`` and ``localindex`` providers and the scan framework), the
traversal and the spillover planner read, with the reference's names,
types, defaults, mutability levels and validators
(``tests/test_torch_config_registry.py`` holds them to it). Two defaults differ on purpose (ROADMAP "Deliberate
differences"): ``computer.strategy`` is "segsum", the port's hand-kernel
route (the reference defaults to "auto"), and
``computer.frontier-cc-min-edges`` keeps CC dense. The reference's values
all stay valid, and "pallas", the reference's name for its hand kernel,
means "segsum".

``computer.executor`` keeps the reference's values: "tpu" is the one
accelerator, here the CUDA card; "cpu" is ``GPUExecutor(device="cpu")``,
the plain PyTorch versions on the CPU (not the reference's numpy
``CPUExecutor``).

The remote store's options are the reference's: ``storage.hostname``,
``storage.port``, the client's pool, pipeline and breaker
(``storage.connection-pool-size``, ``storage.parallel-backend-ops``,
``storage.remote.*``, ``storage.breaker.*``), the propagation switches
(``metrics.trace-propagation``, ``metrics.resource-ledger``,
``server.deadline.propagation``), and the id layer's placement
(``ids.placement``, ``ids.placement-key``) and conflict avoidance
(``ids.authority.conflict-avoidance-*``).

The sharded store's node count (``storage.sharded-nodes``), the remote
index provider's (``index.search.hostname``, ``-port``, ``-pool-size``,
``-retry-time-ms``, ``-pipeline``) and the chaos engine's
``storage.faults.*`` (``enabled``, ``seed``, the read and write error
rates, latency and overload, ``torn-mutation-at``, ``lock-expiry-at``,
``scan-kill-at``/``-after-rows``, ``preempt-superstep``, ``cdc-torn-at``,
``stall-lock-at``/``-ms``, ``wedge-thread-at``, ``stores``) are the
reference's.

The query server's and its driver's options are the reference's:
``server.*`` (the endpoint, auth, limits, the stall watchdog, admission
and brownout, deadlines), ``metrics.history-*``, ``slo-*``,
``profile-*``, ``bundle-*`` and ``stream-*`` (the metric history, SLOs,
continuous profiling, bundles and the telemetry stream),
``computer.price-book-path`` and ``driver.*``. So are the serving
fleet's: ``server.fleet.*`` (the router, probes, gossip, drain, warm-up,
the CDC follower, the federation and its push mode), ``metrics.fleet-*``
(the federation's retention and outlier detector) and the fault kinds
the fleet and its follower consume, ``storage.faults.replica-*`` and
``follower-lag-*``.

Every other option of the reference raises ``ConfigurationError`` naming
the ROADMAP item that brings it, as do ``computer.executor`` = "sharded"
and ``storage.faults.shard-*`` (the sharded executor, #4). Nothing is
ignored. :func:`describe_options` renders the registry as the
reference's config table (the ``config-docs`` subcommand).

The durable logs' options (``log.*``, ``tx.log-tx``,
``tx.max-commit-time-ms``, ``tx.recover-on-open``, ``storage.cdc.*``,
``schema.eviction-ack-*``, ``graph.timestamps`` and the instance-id
options) are the reference's. ``GraphConfiguration.set_global`` is the
management write of a cluster option (``management().set_config``), and
``InstanceRegistry`` keeps the open instances' ids in the global config
(``generate_instance_id`` makes one).
"""

from __future__ import annotations

import json
import os
import threading
import time
import uuid
from enum import Enum
from typing import Any, Callable, Dict, List, Optional

from janusgraph_tpu_torch.exceptions import ConfigurationError


class Mutability(Enum):
    """reference: ConfigOption.Type (ConfigOption.java:36)."""

    LOCAL = "local"  # only settable in local config at open
    MASKABLE = "maskable"  # local config may override the global value
    GLOBAL = "global"  # cluster-wide, changeable online via management
    GLOBAL_OFFLINE = "global_offline"  # cluster-wide, all instances closed
    FIXED = "fixed"  # frozen once the cluster is initialised


class ConfigOption:
    def __init__(
        self,
        path: str,
        datatype: type,
        description: str,
        default: Any = None,
        mutability: Mutability = Mutability.LOCAL,
        verifier: Optional[Callable[[Any], bool]] = None,
    ):
        self.path = path
        self.datatype = datatype
        self.description = description
        self.default = default
        self.mutability = mutability
        self.verifier = verifier

    def check(self, value: Any) -> Any:
        if value is None:
            raise ConfigurationError(f"{self.path}: value may not be None")
        if self.datatype is float and isinstance(value, int):
            value = float(value)
        if not isinstance(value, self.datatype):
            raise ConfigurationError(
                f"{self.path}: expected {self.datatype.__name__}, "
                f"got {type(value).__name__} ({value!r})"
            )
        if self.verifier is not None and not self.verifier(value):
            raise ConfigurationError(f"{self.path}: invalid value {value!r}")
        refused = _REFUSED_VALUES.get(self.path)
        if refused is not None and refused[0](value):
            raise ConfigurationError(
                f"{self.path}={value!r} is not ported yet: {refused[1]}"
            )
        return value


#: flat path -> option registry
REGISTRY: Dict[str, ConfigOption] = {}


def _option(path, datatype, description, default,
            mutability=Mutability.MASKABLE, verifier=None) -> None:
    REGISTRY[path] = ConfigOption(path, datatype, description, default, mutability, verifier)


_ROADMAP_MULTI = "ROADMAP.md Queue A #4 (multi-GPU)"
_ROADMAP_HOST = "ROADMAP.md Queue A #5 (the host system beyond OLAP)"

#: honoured options whose value the port refuses: path -> (refuses, item)
_REFUSED_VALUES: Dict[str, tuple] = {
    "computer.executor": (lambda v: v == "sharded", _ROADMAP_MULTI),
}

#: options of the reference the port does not honour yet, by path or by
#: path prefix (the longest match names the item)
_NOT_PORTED: Dict[str, str] = {
    "computer.sharded-auto": _ROADMAP_MULTI,
    "computer.shard-": _ROADMAP_MULTI,
    "computer.exchange": _ROADMAP_MULTI,
    "computer.agg": _ROADMAP_MULTI,
    # the rest of computer.* (the result mode); the rest of query.* serves
    # the indexes
    "computer.": _ROADMAP_HOST,
    "metrics.": _ROADMAP_HOST,
    "cluster.": _ROADMAP_MULTI,
    # the fault kinds whose consumer, the sharded executor, is not ported
    # (shard preemption, collective timeout, halo drop, straggler skew)
    "storage.faults.shard-": _ROADMAP_MULTI,
    "storage.": _ROADMAP_HOST,
    "ids.": _ROADMAP_HOST,
    "cache.": _ROADMAP_HOST,
    "schema.": _ROADMAP_HOST,
    "graph.": _ROADMAP_HOST,
    "index.": _ROADMAP_HOST,
    "locks.": _ROADMAP_HOST,
    "query.": _ROADMAP_HOST,
}

_option("storage.backend", str, "store manager shorthand", "inmemory", Mutability.LOCAL)
_option(
    "storage.directory", str, "data directory for persistent backends", "",
    Mutability.LOCAL,
)
_option(
    "storage.fsync", bool,
    "fsync WAL appends on the persistent local backend (localstore). "
    "Default True: matches the backend's own durable default", True,
    Mutability.LOCAL,
)
_option(
    "storage.sharded-nodes", int, "node count for the sharded backend", 3,
    Mutability.LOCAL, lambda v: v > 0,
)
# ---- the chaos engine (storage/faults.py): every decision is a pure
# function of (seed, kind, op index), so one seed gives one fault sequence
_option(
    "storage.faults.enabled", bool,
    "wrap the data-plane stores in the seeded deterministic fault injector "
    "(storage/faults.py FaultInjectingStoreManager); the plan is exposed as "
    "graph.fault_plan", False, Mutability.LOCAL,
)
_option(
    "storage.faults.seed", int,
    "chaos seed: every fault decision is a pure function of (seed, kind, op "
    "index)", 0, Mutability.LOCAL, lambda v: v >= 0,
)
_option(
    "storage.faults.read-error-rate", float,
    "probability of an injected TemporaryBackendError per data-plane read "
    "(absorbed by the retry guard)", 0.0, Mutability.LOCAL, lambda v: 0.0 <= v <= 1.0,
)
_option(
    "storage.faults.write-error-rate", float,
    "probability of an injected TemporaryBackendError per data-plane "
    "mutation (raised before anything applies, so retries are safe)", 0.0,
    Mutability.LOCAL, lambda v: 0.0 <= v <= 1.0,
)
_option(
    "storage.faults.latency-ms", float,
    "injected latency spike length for reads the latency-rate selects", 0.0,
    Mutability.LOCAL, lambda v: v >= 0,
)
_option(
    "storage.faults.latency-rate", float,
    "probability of a latency spike per data-plane read", 0.0,
    Mutability.LOCAL, lambda v: 0.0 <= v <= 1.0,
)
_option(
    "storage.faults.overload-at", int,
    "data-plane read index at which an injected latency storm begins (-1 = "
    "off)", -1, Mutability.LOCAL, lambda v: v >= -1,
)
_option(
    "storage.faults.overload-ops", int,
    "reads the overload storm covers once it begins", 0, Mutability.LOCAL,
    lambda v: v >= 0,
)
_option(
    "storage.faults.overload-latency-ms", float,
    "per-read stall length inside the overload storm", 0.0, Mutability.LOCAL,
    lambda v: v >= 0,
)
_option(
    "storage.faults.torn-mutation-at", int,
    "mutate_many call index at which to crash after applying a prefix of the "
    "batch (-1 = off): the torn commit TornCommitRecovery heals on reopen",
    -1, Mutability.LOCAL, lambda v: v >= -1,
)
_option(
    "storage.faults.lock-expiry-at", int,
    "lock-check index at which the locker's clock is skewed so the holder's "
    "lease reads as expired (-1 = off)", -1, Mutability.LOCAL, lambda v: v >= -1,
)
_option(
    "storage.faults.scan-kill-at", int,
    "row-scan index at which the stream is killed mid-flight (-1 = off)", -1,
    Mutability.LOCAL, lambda v: v >= -1,
)
_option(
    "storage.faults.scan-kill-after-rows", int,
    "rows the killed scan yields before dying", 8, Mutability.LOCAL,
    lambda v: v >= 0,
)
_option(
    "storage.faults.preempt-superstep", int,
    "OLAP superstep at which SuperstepPreempted is raised once (-1 = off), "
    "absorbed by the executor's checkpoint auto-resume", -1,
    Mutability.LOCAL, lambda v: v >= -1,
)
_option(
    "storage.faults.cdc-torn-at", int,
    "CDC tail-append index at which a torn partial frame hits disk and the "
    "writer dies (CDCTornWrite; -1 = off)", -1, Mutability.LOCAL, lambda v: v >= -1,
)
_option(
    "storage.faults.stores", str,
    "comma-separated store names the injector targets (empty = the data "
    "plane: edgestore,graphindex)", "edgestore,graphindex", Mutability.LOCAL,
)
_option(
    "storage.read-only", bool,
    "open the storage backend read-only: every mutation attempt raises", False,
    Mutability.LOCAL,
)
_option(
    "storage.scan-retries", int,
    "per-partition retry budget for temporary failures mid-scan (resume "
    "from just past the last row)", 3, verifier=lambda v: v >= 0,
)
_option(
    "storage.scan-batch-size", int, "rows per scan-framework batch", 4096,
    verifier=lambda v: v > 0,
)
_option(
    "storage.scan-parallelism", int,
    "worker threads assembling scan batches (0 = one per partition)", 0,
    verifier=lambda v: v >= 0,
)
_option(
    "storage.distributed-load-workers", int,
    "worker PROCESSES for distributed CSR loading at graph.compute() "
    "(olap/distributed_load.py): each scans a disjoint storage-partition "
    "range of a shared backend (storage.backend 'local') and the parent "
    "merges once; 0/1 = in-process loader. Raw-scan loads only: property, "
    "weight and label-filtered snapshots load in-process", 0,
    verifier=lambda v: v >= 0,
)
_option(
    "storage.distributed-load-timeout-s", float,
    "shared deadline for the distributed-load worker pool (a hung worker "
    "fails the load rather than leaking scanners past it)", 600.0,
    verifier=lambda v: v > 0,
)
_option(
    "storage.retry-time-ms", float,
    "time budget for retrying temporary backend failures with backoff",
    10_000.0,
)
_option(
    "storage.backoff-base-ms", float,
    "initial backoff of the temporary-failure retry guard (backend_op)",
    50.0, verifier=lambda v: v > 0,
)
_option(
    "storage.backoff-max-ms", float,
    "backoff ceiling of the temporary-failure retry guard (backend_op)",
    2000.0, verifier=lambda v: v > 0,
)
_option(
    "storage.write-attempts", int,
    "cap the retry guard's replay count in addition to its time budget "
    "(0 = time budget only)", 0, verifier=lambda v: v >= 0,
)
_option("storage.hostname", str, "remote storage server host", "", Mutability.LOCAL)
_option("storage.port", int, "remote storage server port", 0, Mutability.LOCAL)
_option(
    "storage.connection-pool-size", int, "client connections to a remote backend", 4,
    verifier=lambda v: v > 0,
)
_option(
    "storage.parallel-backend-ops", bool,
    "parallelize multi-key slice reads on a worker pool", True, Mutability.LOCAL,
)
_option(
    "storage.remote.connect-timeout-ms", float,
    "TCP connect timeout of the remote storage client", 30_000.0,
    verifier=lambda v: v > 0,
)
_option(
    "storage.remote.parallel-slice-factor", int,
    "client-side multi-slice fan-out fires when the key count exceeds "
    "factor x pool connections (read in RemoteStoreManager multi-slice)", 2,
    verifier=lambda v: v >= 1,
)
_option(
    "storage.remote.pipeline", bool,
    "pipelined async wire framing against the remote KCVS server "
    "(storage/pipeline.py): per-frame request ids, out-of-order completion, "
    "op coalescing into batched wire frames and few-socket connection "
    "multiplexing, negotiated through the server's 'pipeline' feature bit "
    "(un-negotiated peers keep the synchronous framing byte for byte). "
    "Routing is adaptive: a sequential caller or a microsecond-fast backend "
    "stays on the sync pool; latency-dominated concurrency beyond the pool "
    "size engages the mux", True,
)
_option(
    "storage.remote.pipeline-connections", int,
    "pipelined sockets per remote store client", 2, verifier=lambda v: v >= 1,
)
_option(
    "storage.remote.pipeline-depth", int,
    "bound of the pipelined send queue per connection: submits past it block "
    "(backpressure, counted as pipeline stalls)", 128, verifier=lambda v: v >= 1,
)
_option(
    "storage.remote.pipeline-max-batch", int,
    "most ops coalesced into one pipelined wire frame", 64, verifier=lambda v: v >= 1,
)
_option(
    "storage.remote.pipeline-multi-chunk", int,
    "pipelined multi-slice reads split into chunks of this many keys, "
    "gathered concurrently as sibling sub-frames", 512, verifier=lambda v: v >= 1,
)
_option(
    "storage.remote.pipeline-stall-ms", float,
    "a submit blocked on the full pipeline queue past this long counts as a "
    "pipeline stall (counter + flight event)", 200.0, verifier=lambda v: v >= 0,
)
_option(
    "storage.remote.pipeline-coalesce-us", float,
    "group-commit window: with >=3 ops in flight the combiner holds a frame "
    "open this long (once per response burst) so convoyed resubmits seal into "
    "one carrier; 0 disables the window", 150.0, verifier=lambda v: v >= 0,
)
_option(
    "storage.breaker.enabled", bool,
    "circuit breaker on the remote store client (storage/circuit.py): "
    "consecutive temporary failures trip it open and callers fail fast "
    "instead of burning retry budget against a dead endpoint", False,
)
_option(
    "storage.breaker.failure-threshold", int,
    "consecutive temporary failures that trip the breaker open", 5,
    verifier=lambda v: v > 0,
)
_option(
    "storage.breaker.reset-ms", float,
    "open-state dwell time before the breaker half-opens for probes", 1000.0,
    verifier=lambda v: v > 0,
)
_option(
    "storage.breaker.half-open-probes", int,
    "concurrent probe calls admitted while half-open; one success closes, "
    "one failure re-opens", 1, verifier=lambda v: v > 0,
)
_option(
    "ids.placement", str,
    "vertex partition placement strategy ('simple'|'property'; "
    "core/placement.py)", "simple",
    verifier=lambda v: v in ("simple", "property"),
)
_option(
    "ids.placement-key", str,
    "property whose hashed value picks the partition ('property' strategy)",
    "", Mutability.LOCAL,
)
_option(
    "ids.authority.conflict-avoidance-mode", str,
    "id-block claim contention avoidance: none | local_manual | "
    "global_manual | global_auto; the tagged modes stripe the block space so "
    "allocators never race on one claim key", "none", Mutability.GLOBAL_OFFLINE,
    lambda v: v in ("none", "local_manual", "global_manual", "global_auto"),
)
_option(
    "ids.authority.conflict-avoidance-tag", int,
    "this instance's claim tag for the manual conflict-avoidance modes", 0,
    Mutability.LOCAL, lambda v: v >= 0,
)
_option(
    "ids.authority.conflict-avoidance-tag-bits", int,
    "bits of claim-tag space (num tags = 2^bits): the id-space striping "
    "factor of the tagged modes", 4, Mutability.FIXED, lambda v: 0 < v <= 16,
)
_option(
    "metrics.trace-propagation", bool,
    "attach the ambient span's TraceContext to outbound remote-store op "
    "frames (gated on the server's negotiated feature bit, so mixed old/new "
    "deployments stay wire-compatible)", True,
)
_option(
    "server.deadline.propagation", bool,
    "forward the ambient deadline's remaining budget on remote-store op "
    "frames (gated on the server's negotiated feature bit)", True,
)
_option("cache.db-cache", bool, "enable the store-level slice cache", True, Mutability.LOCAL)
_option(
    "cache.db-cache-size", int, "slice cache entry budget", 65536,
    verifier=lambda v: v > 0,
)
_option(
    "cache.db-cache-time-ms", float,
    "slice cache TTL bounding cross-instance staleness (0 = no expiry)",
    10_000.0,
)
_option(
    "cache.db-cache-clean-wait-ms", float,
    "grace period after a row invalidation during which the slice cache "
    "refuses to re-admit that row", 0.0, verifier=lambda v: v >= 0,
)
_option(
    "cache.edgestore-fraction", float,
    "share of cache.db-cache-size given to the edgestore; the rest goes to "
    "the graph-index store", 0.8, verifier=lambda v: 0.0 < v < 1.0,
)
_option(
    "locks.wait-ms", float, "claim re-read wait of the consistent-key locker", 1.0,
    Mutability.GLOBAL_OFFLINE,
)
_option(
    "locks.expiry-ms", float, "lock claims older than this are expired", 10_000.0,
    Mutability.GLOBAL_OFFLINE,
)
_option("locks.retries", int, "lock acquisition attempts", 3, verifier=lambda v: v > 0)
_option(
    "locks.clean-expired", bool,
    "delete expired lock-claim columns encountered during lock checks "
    "(dead holders' claims otherwise linger)", False,
)
_option(
    "schema.default", str, "auto-create schema on first use ('auto'|'none')", "auto",
    verifier=lambda v: v in ("auto", "none"),
)
_option(
    "schema.constraints", bool,
    "enforce label property/connection constraints on writes (with "
    "schema.default=auto missing constraints are auto-created, with 'none' "
    "they reject)", False, Mutability.GLOBAL_OFFLINE,
)
_option(
    "ids.partition-bits", int, "bits of the vertex id reserved for the partition",
    5, Mutability.FIXED, lambda v: 0 <= v <= 16,
)
_option(
    "ids.block-size", int, "ids leased per authority block", 10_000,
    Mutability.GLOBAL_OFFLINE, lambda v: v > 0,
)
_option(
    "ids.authority-wait-ms", float,
    "claim-verification wait for the consistent-key id authority", 0.5,
    Mutability.GLOBAL_OFFLINE,
)
_option(
    "ids.renew-percentage", float,
    "fraction of an id block remaining that triggers background renewal",
    0.3, verifier=lambda v: 0.0 < v < 1.0,
)
_option(
    "computer.executor", str,
    "default executor for graph.compute(): 'tpu' (the card), 'cpu' (the "
    "plain versions on the CPU), 'sharded' (not ported)",
    "tpu", verifier=lambda v: v in ("tpu", "cpu", "sharded"),
)
_option(
    "computer.strategy", str,
    "aggregation route ('segsum'|'pallas' the hand kernel, 'auto', 'ell', "
    "'hybrid', 'segment')", "segsum",
    verifier=lambda v: v in ("segsum", "auto", "ell", "hybrid", "segment", "pallas"),
)
_option(
    "computer.autotune", bool,
    "the tuner behind computer.strategy='auto' and the frontier ladders", True,
)
_option(
    "computer.autotune-hub-cutoff", int,
    "hybrid-format degree cutoff (0 = the tuner searches)", 0,
    verifier=lambda v: v >= 0,
)
_option(
    "computer.autotune-tail-chunk", int,
    "hybrid tail chunk width (power of two)", 256,
    verifier=lambda v: v > 0 and (v & (v - 1)) == 0,
)
_option(
    "computer.autotune-persist", bool,
    "keep the measured tuner record next to the checkpoint file", True,
)
_option(
    "computer.write-back-batch", int,
    "vertices per transaction when persisting compute keys", 10_000,
    verifier=lambda v: v > 0,
)
_option(
    "computer.sync-every", int,
    "supersteps between host aggregator fetches (host-loop programs)", 1,
    verifier=lambda v: v > 0,
)
_option(
    "computer.checkpoint-every", int,
    "supersteps between OLAP state checkpoints (0 = no checkpointing)", 0,
    verifier=lambda v: v >= 0,
)
_option(
    "computer.checkpoint-path", str,
    "directory/file for OLAP superstep checkpoints", "", Mutability.LOCAL,
)
_option(
    "computer.resume-attempts", int,
    "checkpoint auto-resume budget per OLAP run", 3, verifier=lambda v: v >= 0,
)
_option(
    "computer.frontier", str,
    "frontier compaction for ShortestPath/CC ('auto', 'always', 'off')",
    "auto", verifier=lambda v: v in ("auto", "off", "always"),
)
_option(
    "computer.channel-cache-size", int,
    "typed edge-channel views kept device-resident (LRU)", 8,
    verifier=lambda v: v > 0,
)
_option(
    "computer.delta", bool,
    "incremental delta-CSR (olap/delta.py): commit-side change capture feeds "
    "the warm snapshot behind submit(), which then skips the store scan; "
    "pending writes are consumed fused or folded in with zero store reads",
    True,
)
_option(
    "computer.delta-capture-limit", int,
    "change-capture ring size (records); past it the oldest batches drop and "
    "older snapshots reload in full", 1 << 16, verifier=lambda v: v >= 0,
)
_option(
    "computer.delta-max-overlay", int,
    "pending records beyond which a warm submit folds the overlay into the "
    "base arrays instead of consuming it fused", 4096, verifier=lambda v: v >= 0,
)
_option(
    "computer.delta-max-lane-cells", int,
    "cap on the fused overlay's total lane cells; past it the overlay "
    "materializes instead", 1 << 16, verifier=lambda v: v >= 0,
)
_option(
    "computer.delta-compact-threshold", int,
    "overlay depth (records) at which the warm snapshot folds the overlay "
    "into the base after a run (0 = autotune.decide_delta prices it for the "
    "device)", 0, verifier=lambda v: v >= 0,
)
_option(
    "computer.delta-snapshot-path", str,
    "file the compacted base CSR is saved to (tmp+rename npz); empty = in "
    "memory only", "", Mutability.LOCAL,
)
_option(
    "computer.ell-max-capacity", int,
    "ELL bucket capacity cap; larger degrees row-split (supernode bound)",
    1 << 14, verifier=lambda v: v >= 8,
)
_option(
    "computer.ell-auto-budget-bytes", int,
    "device budget the auto strategy lets the ELL pack use before falling "
    "back to segment reduction (with computer.autotune off; the tuner's "
    "budget otherwise)", 6 << 30, verifier=lambda v: v > 0,
)
_option(
    "computer.ell-auto-pad", float, "padding-ratio ceiling for the auto ELL strategy",
    3.0, verifier=lambda v: v >= 1.0,
)
_option(
    "computer.frontier-cc-min-edges", int,
    "edge count from which frontier='auto' runs ConnectedComponents through "
    "the frontier engine (the default, the engine's 2^30 edge limit, keeps "
    "CC dense: the faster path on the card; the reference defaults to 2^20)",
    1 << 30, verifier=lambda v: v >= 0,
)
_option(
    "computer.frontier-f-min", int,
    "smallest frontier-compaction tier (vertex cap)", 1 << 10, verifier=lambda v: v > 0,
)
_option(
    "computer.frontier-e-min", int,
    "smallest frontier-expansion tier (edge cap)", 1 << 13, verifier=lambda v: v > 0,
)
_option(
    "computer.frontier-tier-growth", int,
    "growth factor between frontier tier capacities (the static ladder; the "
    "tuner's largest growth)", 4, verifier=lambda v: v >= 2,
)
_option(
    "computer.autotune-min-gain", float,
    "modeled superstep-time gain the hybrid layout must show over ELL before "
    "the tuner picks it", 0.05, verifier=lambda v: 0.0 <= v < 1.0,
)
_option(
    "computer.autotune-max-tiers", int,
    "frontier tier-ladder length budget per cap axis", 8, verifier=lambda v: v >= 2,
)
_option(
    "computer.features-dim-tier", int,
    "forced padded feature-dim lane tier for dense programs (power of two; "
    "0 = the smallest tier that fits)", 0,
    verifier=lambda v: v >= 0 and (v & (v - 1)) == 0,
)
_option(
    "computer.features-native-matmul", bool,
    "dense programs' transforms through torch.matmul (TF32 off) instead of "
    "the fixed-order tree contraction", False,
)
_option(
    "computer.spillover", bool,
    "OLTP->OLAP spillover: recurring expensive multi-hop traversal shapes "
    "(promoted from the digest table's measured mean cost) compile to an "
    "OLAPTraversalProgram over a cached CSR snapshot, with tx-overlay "
    "reconciliation for read-your-writes (olap/spillover.py; hook: "
    "GraphTraversal._execute). An unsupported step, overlay overflow or "
    "staleness breach falls back to the row walk; an error of the device "
    "run reaches the caller", True,
)
_option(
    "computer.spillover-min-cost-ms", float,
    "measured mean wall (digest table) a traversal shape must exceed before "
    "the spillover planner promotes it", 25.0, verifier=lambda v: v >= 0,
)
_option(
    "computer.spillover-min-seen", int,
    "executions of a shape the digest table must have observed before the "
    "spillover planner considers promotion", 3, verifier=lambda v: v >= 1,
)
_option(
    "computer.spillover-min-hops", int,
    "expansion steps a chain needs before spillover is considered", 2,
    verifier=lambda v: v >= 1,
)
_option(
    "computer.spillover-max-overlay", int,
    "uncommitted tx mutations beyond which spillover falls back to the row "
    "walk instead of patching the snapshot", 4096, verifier=lambda v: v >= 0,
)
_option(
    "computer.spillover-max-staleness", int,
    "committed writes since the spillover snapshot was packed beyond which "
    "spillover refuses (counter olap.spillover.stale) and repacks on the "
    "next attempt; within it the snapshot refreshes from the change capture",
    4096, verifier=lambda v: v >= 0,
)
_option(
    "query.force-index", bool,
    "refuse traversals that would fall back to a full graph scan (a V() "
    "start step that no index answers)", False,
)
_option(
    "query.hard-max-limit", int,
    "clamp on index-query limits (reference: query.hard-max-limit)",
    1 << 20, verifier=lambda v: v > 0,
)
_option(
    "attributes.allow-pickle", str,
    "arbitrary-object pickle frames in the attribute serializer: 'auto' "
    "permits them only when the backing store is in-process/local-disk "
    "(a remote KCVS peer must never be able to plant a pickle payload "
    "that executes on read); 'true'/'false' force the choice",
    "auto", Mutability.LOCAL, lambda v: v in ("auto", "true", "false"),
)
_option("index.search.backend", str, "mixed index provider shorthand", "memindex",
        Mutability.LOCAL)
_option("index.search.directory", str, "index data directory", "", Mutability.LOCAL)
_option(
    "index.search.hostname", str,
    "remote index server host (backend=remote)", "127.0.0.1", Mutability.LOCAL,
)
_option(
    "index.search.port", int, "remote index server port (backend=remote)", 0,
    Mutability.LOCAL,
)
_option(
    "index.search.pool-size", int, "client connections to the remote index server",
    4, Mutability.LOCAL, lambda v: v > 0,
)
_option(
    "index.search.retry-time-ms", float,
    "retry budget for temporary remote-index failures", 10_000.0,
    Mutability.MASKABLE, lambda v: v > 0,
)
_option(
    "index.search.pipeline", bool,
    "pipelined framing against the remote index server for idempotent ops "
    "(query, rawQuery, totals, supports, exists, register), negotiated by "
    "the fourth capability byte; mutate and restore stay synchronous", True,
    Mutability.MASKABLE,
)
_option(
    "index.search.fsync", bool, "fsync the persistent local index provider", False,
    Mutability.LOCAL,
)
_option(
    "index.search.scroll-page-size", int,
    "page size of IndexProvider.query_stream scroll-style paging", 1000,
    verifier=lambda v: v > 0,
)
_option(
    "index.search.max-result-set-size", int,
    "hard cap on mixed-index hits per query (read in mixed_index_query)",
    50_000, verifier=lambda v: v > 0,
)
_option(
    "query.ignore-unknown-index-key", bool,
    "graph-centric queries over a property key absent from the schema: "
    "false raises QueryError, true treats the condition as unsatisfiable",
    False,
)
_option(
    "query.max-repeat-loops", int,
    "graph-wide bound on until-only repeat() loops", 64, verifier=lambda v: v > 0,
)
_option(
    "query.max-traversers", int,
    "frontier-size budget per traversal execution (0 = unlimited): an "
    "exploding chain raises QueryError instead of consuming the process",
    1_000_000, verifier=lambda v: v >= 0,
)
_option(
    "query.batch", bool,
    "batched multi-query prefetch in traversal expansion steps (off = one "
    "slice read per vertex)", True,
)
_option(
    "query.batch-size", int,
    "multi-query prefetch chunk: vertices per batched multi-slice call",
    2500, verifier=lambda v: v > 0,
)
_option(
    "metrics.slow-query-threshold-ms", float,
    "traversal executions slower than this bump the query.slow counter "
    "(0 = off)", 0.0, verifier=lambda v: v >= 0,
)
_option(
    "metrics.digest-top-k", int,
    "capacity of the bounded query-digest table (top-K shapes by total "
    "cost), which spillover promotion reads", 128, Mutability.LOCAL,
    lambda v: v > 0,
)
_option(
    "metrics.enabled", bool, "collect per-store operation metrics", False,
    Mutability.LOCAL,
)
_option(
    "metrics.merge-stores", bool,
    "report store metrics under one 'stores' bucket instead of per-store names",
    False, Mutability.LOCAL,
)
_option(
    "metrics.prefix", str, "prefix prepended to every emitted metric name",
    "janusgraph", Mutability.LOCAL,
)
_option(
    "metrics.console-interval-ms", float,
    "periodic console metrics reporter (0 = off; util/metrics.py)", 0.0,
    Mutability.LOCAL, lambda v: v >= 0,
)
_option(
    "metrics.csv-interval-ms", float, "periodic CSV metrics reporter (0 = off)", 0.0,
    Mutability.LOCAL, lambda v: v >= 0,
)
_option(
    "metrics.csv-directory", str, "directory the CSV reporter writes into", "",
    Mutability.LOCAL,
)
_option(
    "metrics.slow-op-threshold-ms", float,
    "spans slower than this land in the always-on slow-op ring (0 = off)", 100.0,
    verifier=lambda v: v >= 0,
)
_option(
    "metrics.span-buffer", int, "completed root-span trees retained", 256,
    Mutability.LOCAL, lambda v: v > 0,
)
_option(
    "metrics.slow-op-buffer", int, "slow-op events retained in the ring", 128,
    Mutability.LOCAL, lambda v: v > 0,
)
_option(
    "metrics.flight-buffer", int, "events retained in the flight recorder ring", 512,
    Mutability.LOCAL, lambda v: v > 0,
)
_option(
    "metrics.flight-dump-dir", str,
    "directory flight-recorder dumps are written to (empty = the system temp dir)",
    "", Mutability.LOCAL,
)
_option(
    "metrics.resource-ledger", bool,
    "propagate the resource-ledger flag over the remote store protocol "
    "(gated on the server's negotiated feature bit): the server echoes each "
    "op's costs into the caller's ledger (observability/profiler.py)", True,
)
_option(
    "metrics.structured-logging", bool,
    "write structured JSON log records to stderr (observability/logging.py)", False,
    Mutability.LOCAL,
)
_option(
    "metrics.roofline-peak-flops", float,
    "peak device flops/s for the roofline model (0 = the device table)", 0.0,
    Mutability.LOCAL, lambda v: v >= 0,
)
_option(
    "metrics.roofline-peak-bytes-per-s", float,
    "peak device memory bytes/s for the roofline model (0 = the device table)",
    0.0, Mutability.LOCAL, lambda v: v >= 0,
)
_option(
    "metrics.roofline-peak-mxu-flops", float,
    "peak matmul flops/s, the denominator of the dense tier's mxu_utilization "
    "(0 = the unit the matmuls run on)", 0.0, Mutability.LOCAL, lambda v: v >= 0,
)
_option(
    "tx.read-only-default", bool,
    "new transactions default to read-only (read in new_transaction)", False,
)
_option(
    "tx.log-tx", bool, "write the WAL transaction log", False, Mutability.GLOBAL,
)
_option(
    "tx.max-commit-time-ms", float,
    "recovery considers a tx abandoned after this long", 10_000.0,
    Mutability.GLOBAL,
)
_option(
    "tx.recover-on-open", bool,
    "run torn-commit recovery at graph open when the WAL is enabled: "
    "PREFLUSH-without-PRIMARY_SUCCESS transactions older than "
    "tx.max-commit-time-ms are rolled forward, PRECOMMIT-only ones rolled "
    "back (core/txlog.py TornCommitRecovery)", True,
)
_option(
    "log.num-buckets", int, "write-parallelism buckets per log partition", 4,
    Mutability.GLOBAL_OFFLINE, lambda v: v > 0,
)
_option(
    "log.send-batch-size", int, "max messages per batched log append", 256,
    verifier=lambda v: v > 0,
)
_option(
    "log.read-lag-ms", float,
    "pullers stop this far behind now so a message of another sender stamped "
    "earlier but flushed later is never skipped past the cursor; -1 = auto "
    "(3x log.send-delay-ms + one graph.timestamps tick)", -1.0,
)
_option("log.read-interval-ms", float, "poll interval of log message pullers", 20.0)
_option(
    "log.send-delay-ms", float,
    "max buffering delay before a log batch is flushed (the send thread)",
    10.0, verifier=lambda v: v >= 0,
)
_option(
    "log.ttl-seconds", float,
    "expire log rows after this long (0 = keep; through the cell-TTL "
    "wrapper)", 0.0, Mutability.GLOBAL_OFFLINE, lambda v: v >= 0,
)
_option(
    "log.slice-granularity-ms", int,
    "time window of one log row (FIXED: row keys derive from it)", 100,
    Mutability.FIXED, lambda v: v > 0,
)
_option(
    "storage.cdc.dir", str,
    "directory of the durable segmented change-capture log (storage/cdc.py "
    "CDCLog); empty = no durable CDC. Requires computer.delta", "",
    Mutability.LOCAL,
)
_option(
    "storage.cdc.segment-records", int,
    "records per sealed CDC segment (power of two); the tail seals at this "
    "boundary", 1024, Mutability.LOCAL, lambda v: v > 0 and v & (v - 1) == 0,
)
_option(
    "storage.cdc.retention-segments", int,
    "sealed CDC segments retained before the oldest is pruned (an honest "
    "cursor gap)", 64, Mutability.LOCAL, lambda v: v >= 1,
)
_option(
    "schema.eviction-ack-timeout-ms", float,
    "how long a schema change waits for every open instance to acknowledge "
    "the cache-eviction broadcast", 5000.0, verifier=lambda v: v > 0,
)
_option(
    "schema.eviction-ack-poll-ms", float,
    "polling cadence while a schema change waits for eviction acks", 5.0,
    verifier=lambda v: v > 0,
)
_option(
    "graph.timestamps", str,
    "resolution of storage-visible timestamps stamped onto log messages: "
    "nano | micro | milli", "nano", Mutability.GLOBAL_OFFLINE,
    lambda v: v in ("nano", "micro", "milli"),
)
_option(
    "graph.unique-instance-id", str,
    "cluster-unique id of this open instance (generated when empty)", "",
    Mutability.LOCAL,
)
_option(
    "graph.unique-instance-id-suffix", str,
    "discriminator appended to generated instance ids", "", Mutability.LOCAL,
)
_option(
    "graph.use-hostname-for-unique-instance-id", bool,
    "base generated instance ids on the host name", False, Mutability.LOCAL,
)
_option(
    "graph.replace-instance-if-exists", bool,
    "re-register over a stale instance id instead of refusing to open", False,
    Mutability.LOCAL,
)
_option(
    "graph.set-vertex-id", bool,
    "allow callers to supply their own vertex ids (tx.add_vertex(vertex_id="
    "...)); custom ids bypass the id authority", False, Mutability.FIXED,
)


# ---- the query server, its driver and the observability plane they
# ---- read (server/, driver/client.py, observability/timeseries.py,
# ---- slo.py, continuous.py, stream.py): the reference's options
_option(
    "computer.price-book-path", str,
    "file for persisting the digest-table price books (tmp+rename JSON, "
    "same discipline as the autotune record) so spillover promotion and "
    "admission pricing warm-start across restarts; empty = derive "
    "<computer.checkpoint-path>.pricebook.json when a checkpoint path is "
    "set, else no persistence (observability/profiler.save_price_book, "
    "loaded at graph open)", "", Mutability.LOCAL,
)
_option("server.host", str, "bind address", "127.0.0.1", Mutability.LOCAL)
_option("server.port", int, "bind port", 8182, Mutability.LOCAL)
_option("server.auth.enabled", bool, "require HMAC token auth", False, Mutability.LOCAL)
_option("server.auth.secret", str, "HMAC token signing secret", "", Mutability.LOCAL)
_option(
    "server.max-query-length", int,
    "refuse submitted queries longer than this many characters (bounds "
    "AST parse cost; read in the server eval path)", 65536,
    Mutability.MASKABLE, lambda v: v > 0,
)
_option(
    "server.request-timeout-s", float,
    "per-connection socket timeout of the HTTP/WS handlers AND the "
    "default wall-clock deadline on query evaluation when the client "
    "sends no X-Deadline-Ms (overridable via server.deadline.default-ms; "
    "0 = neither: idle WebSocket sessions live indefinitely)", 120.0,
    Mutability.MASKABLE, lambda v: v >= 0,
)
_option(
    "server.auto-commit", bool,
    "commit each successful request's transaction (the reference Gremlin "
    "Server's sessionless semantics — mutating queries like mergeV/addV "
    "persist); false rolls every request back, making the endpoint "
    "read-only (read in JanusGraphServer.execute)", True,
    Mutability.MASKABLE,
)
_option(
    "server.max-request-bytes", int,
    "reject HTTP bodies/WS frames larger than this (server/server.py)",
    1 << 20, Mutability.LOCAL, lambda v: v > 0,
)
_option(
    "server.auth.token-ttl-ms", float,
    "HMAC token lifetime (server/auth.py TokenAuthenticator)", 3_600_000.0,
    Mutability.LOCAL, lambda v: v > 0,
)
_option(
    "server.auth.credentials-db", str,
    "name of the credentials graph/store for SASL-style user auth",
    "credentials", Mutability.LOCAL,
)
_option(
    "metrics.history-enabled", bool,
    "retain a bounded in-process ring of periodic registry snapshots "
    "(counter/timer deltas per window, window percentiles; "
    "observability/timeseries.py — served at GET /timeseries and "
    "`janusgraph_tpu timeseries`; the query server owns the sampling "
    "thread)", True, Mutability.LOCAL,
)
_option(
    "metrics.history-interval-s", float,
    "seconds between history samples (one ring window per sample)",
    5.0, Mutability.LOCAL, lambda v: v > 0,
)
_option(
    "metrics.history-retention", int,
    "history windows retained (retention wall = this x "
    "history-interval-s; default 360 x 5 s = 30 min)",
    360, Mutability.LOCAL, lambda v: v > 0,
)
_option(
    "metrics.slo-enabled", bool,
    "evaluate the declarative SLO specs with multi-window burn-rate "
    "alerting over the metrics history (observability/slo.py; alerts "
    "become flight slo_burn events, observability.slo.* gauges, and the "
    "/healthz slo block — a page-severity burn reports degraded)",
    True, Mutability.LOCAL,
)
_option(
    "metrics.slo-availability-objective", float,
    "availability SLO: target non-shed fraction of arriving requests "
    "(good/bad from the admission counters)", 0.999,
    Mutability.LOCAL, lambda v: 0 < v < 1,
)
_option(
    "metrics.slo-latency-objective", float,
    "latency SLO: target fraction of requests under their class "
    "threshold", 0.99, Mutability.LOCAL, lambda v: 0 < v < 1,
)
_option(
    "metrics.slo-latency-threshold-ms", float,
    "latency SLO floor threshold; per-digest classes are additionally "
    "priced at 4x their measured mean cost from the admission price "
    "book, never below this floor", 250.0,
    Mutability.LOCAL, lambda v: v > 0,
)
_option(
    "metrics.slo-freshness-max-staleness", float,
    "OLAP freshness SLO: committed writes the spillover CSR snapshot "
    "may trail before freshness burns at page rate "
    "(olap.spillover.staleness gauge)", 10_000.0,
    Mutability.LOCAL, lambda v: v > 0,
)
_option(
    "metrics.slo-fast-windows", int,
    "history windows in the fast burn-rate window (reaction time)",
    3, Mutability.LOCAL, lambda v: v > 0,
)
_option(
    "metrics.slo-slow-windows", int,
    "history windows in the slow burn-rate window (blip veto); alerts "
    "require BOTH windows past the threshold", 36,
    Mutability.LOCAL, lambda v: v > 0,
)
_option(
    "metrics.slo-page-burn", float,
    "burn rate at which an SLO pages (error budget spent at this "
    "multiple of the sustainable rate; 14.4 = a 30-day budget in 2 "
    "days)", 14.4, Mutability.LOCAL, lambda v: v > 0,
)
_option(
    "metrics.slo-ticket-burn", float,
    "burn rate at which an SLO opens a ticket-severity alert", 6.0,
    Mutability.LOCAL, lambda v: v > 0,
)
_option(
    "metrics.profile-enabled", bool,
    "run the always-on sampling profiler (observability/continuous.py "
    "SamplingProfiler): a daemon thread folds sys._current_frames() "
    "stacks into collapsed-stack flame windows sealed in lockstep with "
    "the metrics-history interval; self-measured overhead (wall AND "
    "CPU) is exported and gated <1% CPU in the saturation bench",
    True, Mutability.LOCAL,
)
_option(
    "metrics.profile-hz", float,
    "sampling-profiler rate in passes per second (each pass costs one "
    "sys._current_frames() walk; 20 Hz keeps the self-measured CPU "
    "overhead well under the 1% gate)", 20.0,
    Mutability.LOCAL, lambda v: 0 < v <= 1000,
)
_option(
    "metrics.profile-windows", int,
    "flame windows retained in the profiler ring (retention wall = "
    "this x history-interval-s when history drives the sealing)", 60,
    Mutability.LOCAL, lambda v: v > 0,
)
_option(
    "metrics.bundle-dir", str,
    "directory for anomaly forensics bundles (flame windows + flight "
    "ring + timeseries tail + all-thread stacks + active requests), "
    "written tmp+rename atomic on SLO page / watchdog stall / "
    "unhandled server error; empty = bundles off", "",
    Mutability.LOCAL,
)
_option(
    "metrics.bundle-retention", int,
    "forensics bundles kept on disk (oldest pruned first)", 8,
    Mutability.LOCAL, lambda v: v > 0,
)
_option(
    "metrics.bundle-min-interval-s", float,
    "rate limit between bundle captures (an anomaly storm must not "
    "turn the forensics plane into its own I/O incident)", 30.0,
    Mutability.LOCAL, lambda v: v >= 0,
)
_option(
    "metrics.stream-depth", int,
    "per-subscriber queue depth on the telemetry bus "
    "(observability/stream.py): events past it DROP-OLDEST into the "
    "subscriber's dropped counter — a slow /watch client or push peer "
    "costs itself data, never stalls a producer (graphlint JG113)",
    256, Mutability.LOCAL, lambda v: v >= 1,
)
_option(
    "metrics.stream-heartbeat-s", float,
    "default idle-gap heartbeat cadence on /watch sessions (the client "
    "may request its own, clamped to [0.2, 30]); heartbeats carry the "
    "subscriber's drop counter so a quiet stream and a dead peer are "
    "distinguishable", 5.0,
    Mutability.LOCAL, lambda v: 0.2 <= v <= 30.0,
)
_option(
    "server.watchdog-enabled", bool,
    "run the runtime stall watchdog (observability/continuous.py "
    "StallWatchdog): scans instrumented-lock wait tables and "
    "registered progress sources (active requests, supersteps, CDC "
    "pulls) and flights stall/lock_convoy events carrying the owner's "
    "sampled stack — the runtime twin of graphlint's static lock "
    "rules", True, Mutability.LOCAL,
)
_option(
    "server.watchdog-interval-s", float,
    "seconds between watchdog scan passes", 1.0,
    Mutability.LOCAL, lambda v: v > 0,
)
_option(
    "server.watchdog-stall-s", float,
    "waiting/no-progress threshold past which the watchdog flights a "
    "stall or lock_convoy event (edge-triggered per episode) and "
    "captures a forensics bundle", 5.0,
    Mutability.LOCAL, lambda v: v > 0,
)
_option(
    "server.admission.enabled", bool,
    "cost-aware admission control in front of every query request "
    "(server/admission.py AdmissionController: adaptive AIMD concurrency "
    "limit, bounded cost-priority wait queue, load shedding with "
    "Retry-After, brownout ladder); observability endpoints always "
    "bypass it", True, Mutability.LOCAL,
)
_option(
    "server.admission.initial-limit", int,
    "starting concurrent-request limit of the AIMD controller", 8,
    Mutability.LOCAL, lambda v: v > 0,
)
_option(
    "server.admission.min-limit", int,
    "floor the multiplicative decrease never drops the limit below", 1,
    Mutability.LOCAL, lambda v: v > 0,
)
_option(
    "server.admission.max-limit", int,
    "ceiling the additive increase never raises the limit above", 64,
    Mutability.LOCAL, lambda v: v > 0,
)
_option(
    "server.admission.queue-bound", int,
    "bounded wait-queue depth; arrivals past it are shed with "
    "429/503 + Retry-After (decorrelated jitter)", 32,
    Mutability.LOCAL, lambda v: v >= 0,
)
_option(
    "server.admission.window", int,
    "completed requests per AIMD decision window (the window's median "
    "latency is compared against the baseline)", 32,
    Mutability.LOCAL, lambda v: v > 0,
)
_option(
    "server.admission.latency-threshold", float,
    "multiplicative-decrease trigger: window median latency above "
    "threshold x baseline shrinks the limit; below it the limit grows "
    "by one", 2.0, Mutability.LOCAL, lambda v: v > 1.0,
)
_option(
    "server.admission.default-cost-ms", float,
    "wait-queue price of a query shape the digest price book has not "
    "measured yet (unknown shapes are assumed mid-priced, not free)",
    25.0, Mutability.LOCAL, lambda v: v > 0,
)
_option(
    "server.admission.cheap-cost-ms", float,
    "known-cheap threshold: under brownout rung 3 only digests with a "
    "measured mean cost at or below this are admitted", 5.0,
    Mutability.LOCAL, lambda v: v > 0,
)
_option(
    "server.admission.brownout-window-s", float,
    "sliding window over shed events that drives brownout escalation",
    5.0, Mutability.LOCAL, lambda v: v > 0,
)
_option(
    "server.admission.brownout-enter-sheds", int,
    "sheds within the brownout window that escalate the ladder one rung "
    "(1: shed span retention, 2: refuse OLAP submits, 3: admit only "
    "known-cheap digests)", 8, Mutability.LOCAL, lambda v: v > 0,
)
_option(
    "server.admission.brownout-exit-s", float,
    "shed-free time that de-escalates the ladder one rung (hysteresis: "
    "exiting is deliberately slower than entering)", 10.0,
    Mutability.LOCAL, lambda v: v > 0,
)
_option(
    "server.admission.brownout-dwell-s", float,
    "minimum time between rung transitions in either direction (keeps "
    "the ladder from flapping)", 2.0, Mutability.LOCAL, lambda v: v >= 0,
)
_option(
    "server.admission.retry-after-base-s", float,
    "base of the decorrelated-jitter Retry-After hint on shed "
    "responses", 0.25, Mutability.LOCAL, lambda v: v > 0,
)
_option(
    "server.admission.retry-after-max-s", float,
    "ceiling of the decorrelated-jitter Retry-After hint", 8.0,
    Mutability.LOCAL, lambda v: v > 0,
)
_option(
    "server.deadline.default-ms", float,
    "deadline applied to a request whose client sent no X-Deadline-Ms "
    "header / WS deadline field (0 = derive from server.request-"
    "timeout-s; read in server/server.py)", 0.0,
    Mutability.LOCAL, lambda v: v >= 0,
)
_option(
    "server.deadline.max-ms", float,
    "clamp on client-supplied deadlines — a client cannot buy more "
    "server time than the operator allows (0 = no clamp)", 600_000.0,
    Mutability.LOCAL, lambda v: v >= 0,
)
_option(
    "driver.retry-budget-capacity", float,
    "token-bucket capacity of the driver's per-connection retry budget: "
    "each retry of a shed (429/503) response spends one token, so "
    "client retries cannot stampede a recovering server (0 = never "
    "retry; read in driver/client.py)", 8.0,
    Mutability.LOCAL, lambda v: v >= 0,
)
_option(
    "driver.retry-budget-refill-per-s", float,
    "token refill rate of the driver retry budget", 0.5,
    Mutability.LOCAL, lambda v: v >= 0,
)
_option(
    "driver.failover-retry-budget-capacity", float,
    "token-bucket capacity of the fleet router's retry-elsewhere budget "
    "(server/fleet.FleetRouter): each re-route of a shed/draining/dead "
    "replica spends one token, so a fleet-wide incident cannot multiply "
    "into a retry stampede against the survivors (0 = never re-route)",
    16.0, Mutability.LOCAL, lambda v: v >= 0,
)
_option(
    "driver.failover-retry-budget-refill-per-s", float,
    "token refill rate of the fleet failover budget", 2.0,
    Mutability.LOCAL, lambda v: v >= 0,
)
_option(
    "driver.failover-backoff-base-s", float,
    "base of the jittered backoff slept before retrying a request on "
    "another replica (decorrelated like the shed Retry-After)", 0.02,
    Mutability.LOCAL, lambda v: v > 0,
)
_option(
    "driver.failover-backoff-max-s", float,
    "ceiling of the fleet failover backoff", 0.5,
    Mutability.LOCAL, lambda v: v > 0,
)
_option(
    "driver.ws-multiplex", bool,
    "multiplex concurrent submits over one WebSocket connection: each "
    "request carries a client-assigned id echoed in its response, so "
    "many in-flight queries share the socket and complete out of order "
    "(JanusGraphClient.ws; degrades to serial round-trips against an "
    "old server that does not echo ids)", True, Mutability.LOCAL,
)
_option(
    "storage.faults.stall-lock-at", int,
    "instrumented-lock acquisition index at which the holder stalls "
    "for faults.stall-lock-ms (-1 = off) — the stall-watchdog "
    "certification fault: the watchdog must flight a lock_convoy "
    "carrying the holder's sampled stack and capture a forensics "
    "bundle (observability/continuous.py)", -1,
    Mutability.LOCAL, lambda v: v >= -1,
)
_option(
    "storage.faults.stall-lock-ms", float,
    "how long the chosen holder keeps the instrumented lock", 0.0,
    Mutability.LOCAL, lambda v: v >= 0,
)
_option(
    "storage.faults.wedge-thread-at", int,
    "worker-op index at which the worker thread wedges (-1 = off); "
    "the watchdog's progress checker must flight a stall", -1,
    Mutability.LOCAL, lambda v: v >= -1,
)

# ---- the serving fleet, its CDC follower and the fleet federation
# (server/fleet.py, observability/federation.py), and the fault kinds
# they consume (storage/faults.py): the reference's options
_option(
    "storage.faults.replica-kill-at", int,
    "fleet tick index at which the seeded-chosen serving replica is "
    "killed mid-traffic (-1 = off; the fleet chaos driver consults "
    "FaultPlan.fleet_hook and executes the decision — server/fleet.py)",
    -1, Mutability.LOCAL, lambda v: v >= -1,
)
_option(
    "storage.faults.replica-restart-at", int,
    "fleet tick index at which the killed replica rejoins the fleet "
    "(-1 = never; rejoin exercises the shard-checkpoint warm-up path)",
    -1, Mutability.LOCAL, lambda v: v >= -1,
)
_option(
    "storage.faults.replica-partition-at", int,
    "data-plane op index at which the target replica's storage "
    "partition window begins (-1 = off): the router still sees the "
    "replica, the replica cannot reach storage — breaker trips, "
    "/healthz degrades, the router must route around it",
    -1, Mutability.LOCAL, lambda v: v >= -1,
)
_option(
    "storage.faults.replica-partition-ops", int,
    "data-plane ops the partition window covers once it begins", 0,
    Mutability.LOCAL, lambda v: v >= 0,
)
_option(
    "storage.faults.replica-target", int,
    "explicit victim replica index for the replica fault kinds "
    "(-1 = seed-hashed, the shard-preemption discipline)", -1,
    Mutability.LOCAL, lambda v: v >= -1,
)
_option(
    "storage.faults.follower-lag-at", int,
    "follower pull index at which the lag window begins (-1 = off): "
    "the follower stops applying for faults.follower-lag-pulls pulls, "
    "so staleness grows past the priced bound and the router must "
    "route freshness-hinted traffic back to the leader", -1,
    Mutability.LOCAL, lambda v: v >= -1,
)
_option(
    "storage.faults.follower-lag-pulls", int,
    "pulls the injected follower lag window covers once it begins", 0,
    Mutability.LOCAL, lambda v: v >= 0,
)
_option(
    "metrics.fleet-retention", int,
    "merged fleet windows the federation retains (one window per "
    "federation-interval-s tick; observability/federation.py)", 360,
    Mutability.LOCAL, lambda v: v >= 1,
)
_option(
    "metrics.fleet-outlier-metric", str,
    "timer whose per-replica windowed p99 the cross-replica outlier "
    "detector compares against the fleet median",
    "server.request.wall", Mutability.LOCAL,
)
_option(
    "metrics.fleet-outlier-factor", float,
    "outlier threshold: a replica whose windowed p99 exceeds this "
    "multiple of the fleet median raises a replica_outlier flight "
    "event and burns the fleet_latency_outlier ticket budget", 3.0,
    Mutability.LOCAL, lambda v: v > 1.0,
)
_option(
    "metrics.fleet-outlier-min-count", int,
    "minimum per-replica observations in a window before it joins the "
    "outlier comparison (small windows make noisy percentiles)", 20,
    Mutability.LOCAL, lambda v: v >= 1,
)
_option(
    "server.fleet.replica-name", str,
    "this replica's fleet identity: rides /healthz, flight events, "
    "structured logs, and /metrics (janusgraph_replica_info) so "
    "cross-replica incident timelines merge by replica "
    "(observability/identity.py; '' = untagged single process)", "",
    Mutability.LOCAL,
)
_option(
    "server.fleet.replicas", int,
    "replica count the `janusgraph_tpu_torch fleet` runner starts over ONE "
    "shared storage backend (server/fleet.py)", 3,
    Mutability.LOCAL, lambda v: v >= 1,
)
_option(
    "server.fleet.vnodes", int,
    "virtual nodes per replica on the router's consistent-hash ring — "
    "more vnodes = smoother key spread, slightly larger ring", 16,
    Mutability.LOCAL, lambda v: v >= 1,
)
_option(
    "server.fleet.candidates", int,
    "ring candidates the router least-loaded-tie-breaks between "
    "(power-of-two-choices over the consistent hash; 1 = pure hash)",
    2, Mutability.LOCAL, lambda v: v >= 1,
)
_option(
    "server.fleet.probe-interval-s", float,
    "per-replica /healthz probe cadence of the fleet router", 1.0,
    Mutability.LOCAL, lambda v: v > 0,
)
_option(
    "server.fleet.probe-timeout-s", float,
    "socket timeout on every router probe / gossip hop (a dead "
    "replica costs one bounded wait, never a hung prober)", 2.0,
    Mutability.LOCAL, lambda v: v > 0,
)
_option(
    "server.fleet.gossip-interval-s", float,
    "push-pull state-gossip cadence (price-book records + brownout "
    "rung to fanout peers per round; server/fleet.StateGossip)", 2.0,
    Mutability.LOCAL, lambda v: v > 0,
)
_option(
    "server.fleet.gossip-fanout", int,
    "peers contacted per gossip round — on a full mesh of N a new fact "
    "reaches everyone within ceil((N-1)/fanout) push rounds", 2,
    Mutability.LOCAL, lambda v: v >= 1,
)
_option(
    "server.fleet.drain-timeout-s", float,
    "graceful-drain wait for in-flight sessions to finish before the "
    "replica retires anyway (sessions still open after it are handed "
    "off as failed-over, not lost silently)", 10.0,
    Mutability.LOCAL, lambda v: v > 0,
)
_option(
    "server.fleet.warmup-dir", str,
    "shard-checkpoint directory a joining replica hydrates its "
    "snapshot-CSR cache from (server/fleet.warm_replica; '' = cold "
    "start, or the computer.delta-snapshot-path pack as fallback)", "",
    Mutability.LOCAL,
)
_option(
    "server.fleet.follower-pull-interval-s", float,
    "cadence at which a follower replica pulls delta records from the "
    "leader's durable CDC log (server/fleet.CDCFollower); each pull "
    "folds the netted batches through materialize, O(delta)", 0.5,
    Mutability.LOCAL, lambda v: v > 0,
)
_option(
    "server.fleet.follower-max-staleness-ms", float,
    "priced staleness bound for follower reads (the SLO "
    "freshness spec's ceiling): past it the follower's /healthz "
    "reports degraded and the router stops preferring it for "
    "staleness-hinted requests", 10_000.0,
    Mutability.LOCAL, lambda v: v > 0,
)
_option(
    "server.fleet.trend-windows", int,
    "per-replica goodput windows the router fetches from /timeseries "
    "to slope-sharpen its least-loaded tie-break (0 = off: plain "
    "occupancy ordering)", 8,
    Mutability.LOCAL, lambda v: v >= 0,
)
_option(
    "server.fleet.federation-enabled", bool,
    "run the fleet observability federation on the frontend: scrape "
    "every replica's /timeseries?raw=1 each interval, serve merged "
    "/fleet/timeseries + /fleet/metrics + /fleet/incident, evaluate "
    "fleet-level SLOs (observability/federation.py)", True,
    Mutability.LOCAL,
)
_option(
    "server.fleet.federation-interval-s", float,
    "federation scrape cadence — each tick merges one fleet window "
    "(counters sum, gauges keyed per replica, histogram buckets add) "
    "and doubles as the clock-offset probe", 2.0,
    Mutability.LOCAL, lambda v: v > 0,
)
_option(
    "server.fleet.federation-timeout-s", float,
    "socket timeout per federation scrape target (a dead "
    "replica costs one bounded wait and a partial:true window, never "
    "a hung scraper)", 2.0,
    Mutability.LOCAL, lambda v: v > 0,
)
_option(
    "server.fleet.push-enabled", bool,
    "negotiate the push-mode federation transport: replicas whose "
    "/watch/info advertises the capability stream sealed windows and "
    "flight events over a /watch subscription instead of being "
    "scraped each tick; peers without it keep the exact poll-mode "
    "scrape path byte-compatibly (observability/federation.py)",
    True, Mutability.LOCAL,
)
_option(
    "server.fleet.push-ship-bundles", bool,
    "fetch forensics bundles announced on a pushed replica's bundle "
    "stream into the frontend's fleet store, so a replica's evidence "
    "survives its death (served at /fleet/bundles)", True,
    Mutability.LOCAL,
)
_option(
    "server.fleet.push-bundle-retention", int,
    "shipped bundles the frontend's fleet store retains fleet-wide "
    "(oldest dropped first)", 16,
    Mutability.LOCAL, lambda v: v >= 1,
)
_option(
    "server.fleet.push-bundle-min-interval-s", float,
    "per-replica rate bound between off-host bundle fetches (a bundle "
    "storm on one replica must not monopolize the frontend)", 5.0,
    Mutability.LOCAL, lambda v: v >= 0,
)



def describe_options() -> str:
    """Render the registry as a config-reference table, the reference's
    rows for every option the port registers."""
    lines = ["| option | type | mutability | default | description |", "|---|---|---|---|---|"]
    for path in sorted(REGISTRY):
        o = REGISTRY[path]
        lines.append(
            f"| {o.path} | {o.datatype.__name__} | {o.mutability.value} "
            f"| {o.default!r} | {o.description} |"
        )
    return "\n".join(lines)


def _lookup(path: str) -> ConfigOption:
    opt = REGISTRY.get(path)
    if opt is not None:
        return opt
    match = max((p for p in _NOT_PORTED if path.startswith(p)), key=len, default=None)
    if match is not None:
        raise ConfigurationError(
            f"configuration option {path} is not ported yet: {_NOT_PORTED[match]}"
        )
    raise ConfigurationError(f"unknown configuration option: {path}")


class GraphConfiguration:
    """The merged view: local config + KCVS-stored global config.

    Merge semantics at open (reference:
    GraphDatabaseConfigurationBuilder.java:41):
      * FIXED options: first opener writes its local value to the global
        store; afterwards the stored value wins — a conflicting local value
        is an error.
      * GLOBAL / GLOBAL_OFFLINE: stored value wins; local value used only to
        initialise an unset stored value.
      * MASKABLE: local value if present, else stored value, else default.
      * LOCAL: local value, else default.
    """

    def __init__(self, local: Dict[str, Any], backend=None):
        self.local: Dict[str, Any] = {}
        for k, v in local.items():
            self.local[k] = _lookup(k).check(v)
        self.backend = backend

    # -- global store access ------------------------------------------------
    @staticmethod
    def _encode(value: Any) -> bytes:
        return json.dumps(value).encode()

    @staticmethod
    def _decode(raw: bytes) -> Any:
        return json.loads(raw.decode())

    def _stored(self, path: str) -> Any:
        if self.backend is None:
            return None
        raw = self.backend.get_global_config(path)
        return None if raw is None else self._decode(raw)

    def _store(self, path: str, value: Any) -> None:
        if self.backend is not None:
            self.backend.set_global_config(path, self._encode(value))

    def attach_backend(self, backend) -> None:
        """Bind the opened backend, then reconcile cluster-global options."""
        self.backend = backend
        for path, value in list(self.local.items()):
            opt = REGISTRY[path]
            if opt.mutability is Mutability.FIXED:
                stored = self._stored(path)
                if stored is None:
                    self._store(path, value)
                elif stored != value:
                    raise ConfigurationError(
                        f"{path} is FIXED: cluster value {stored!r} != "
                        f"local value {value!r}"
                    )
            elif opt.mutability in (Mutability.GLOBAL, Mutability.GLOBAL_OFFLINE):
                if self._stored(path) is None:
                    self._store(path, value)

    # -- reads --------------------------------------------------------------
    def get(self, path: str) -> Any:
        opt = _lookup(path)
        if opt.mutability in (
            Mutability.FIXED,
            Mutability.GLOBAL,
            Mutability.GLOBAL_OFFLINE,
        ):
            stored = self._stored(path)
            if stored is not None:
                # GLOBAL/FIXED: the stored cluster value wins over local
                return opt.check(stored)
        if opt.mutability is Mutability.MASKABLE:
            if path in self.local:
                return self.local[path]
            stored = self._stored(path)
            if stored is not None:
                return opt.check(stored)
            return opt.default
        if path in self.local:
            return self.local[path]
        return opt.default

    # -- management writes --------------------------------------------------
    def set_global(self, path: str, value: Any, open_instances: int = 1) -> None:
        """The management write of a cluster option (reference:
        ManagementSystem.set)."""
        opt = _lookup(path)
        value = opt.check(value)
        if opt.mutability is Mutability.FIXED:
            raise ConfigurationError(f"{path} is FIXED and cannot be changed")
        if opt.mutability is Mutability.LOCAL:
            raise ConfigurationError(f"{path} is LOCAL; set it in the local config")
        if opt.mutability is Mutability.GLOBAL_OFFLINE and open_instances > 1:
            raise ConfigurationError(
                f"{path} is GLOBAL_OFFLINE: requires all other instances closed "
                f"({open_instances} open)"
            )
        self._store(path, value)


# ---------------------------------------------------------------------------
# Instance registry (reference: StandardJanusGraph.java:176-185 — instances
# register a unique id in the global config; management lists and
# force-closes them)

_INSTANCE_PREFIX = "cluster.instance."


def generate_instance_id(suffix: str = "", use_hostname: bool = False) -> str:
    """A cluster-unique instance id: the pid and a random tail, on the host
    name with ``graph.use-hostname-for-unique-instance-id``, with
    ``graph.unique-instance-id-suffix`` appended."""
    if use_hostname:
        import socket

        base = socket.gethostname().replace(".", "-")
        core = f"{base}-{os.getpid():x}-{uuid.uuid4().hex[:6]}"
    else:
        core = f"{os.getpid():x}-{uuid.uuid4().hex[:12]}"
    return f"{core}-{suffix}" if suffix else core


class InstanceRegistry:
    """The open instances' ids, as cells of the global config."""

    def __init__(self, backend):
        self.backend = backend
        self._lock = threading.Lock()

    def register(self, instance_id: str) -> None:
        with self._lock:
            if self.backend.get_global_config(_INSTANCE_PREFIX + instance_id):
                raise ConfigurationError(
                    f"instance id already registered: {instance_id} "
                    "(another instance with this id is open; use "
                    "management().force_close_instance to evict a stale one)"
                )
            self.backend.set_global_config(
                _INSTANCE_PREFIX + instance_id,
                json.dumps({"ts": time.time()}).encode(),
            )

    def deregister(self, instance_id: str) -> None:
        with self._lock:
            self.backend.del_global_config(_INSTANCE_PREFIX + instance_id)

    def open_instances(self) -> List[str]:
        return [
            name[len(_INSTANCE_PREFIX):]
            for name in self.backend.list_global_config(_INSTANCE_PREFIX)
        ]
