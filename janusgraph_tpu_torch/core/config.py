"""Typed configuration: the option registry and the merged view of local
and cluster-global values — the port's copy of
``janusgraph_tpu/core/config.py``.

The registry holds every option of the reference, registered through the
reference's namespaces (``ConfigNamespace``, ``ROOT`` … ``DRIVER_NS``)
with its name, type, default, mutability, validator and description
(``tests/test_torch_config_registry.py`` holds them to it), so
:func:`describe_options` (the ``config-docs`` subcommand) renders the
reference's table. An unknown path raises ``ConfigurationError``.

Two defaults differ on purpose (ROADMAP "Deliberate differences"):
``computer.strategy`` is "segsum", the port's hand-kernel route (the
reference defaults to "auto"), and ``computer.frontier-cc-min-edges``
keeps CC dense. The reference's values all stay valid, and "pallas", the
reference's name for its hand kernel, means "segsum".
``computer.executor`` keeps the reference's values: "tpu" is the one
accelerator, here the CUDA card; "cpu" is ``GPUExecutor(device="cpu")``,
the plain PyTorch versions on the CPU (not the reference's numpy
``CPUExecutor``); "sharded" is the mesh, and a graph opened with
``cluster.num-processes`` above 1 forms the process group
(``parallel/multihost.init_multihost``).

``storage.batch-loading``, ``storage.buffer-size``,
``cache.tx-cache-size``, ``computer.result-mode`` and ``graph.graphname``
are taken and stored as the reference takes them: its graph open has no
consumer for them (the server's graph manager reads ``graph.graphname``).

``GraphConfiguration.set_global`` is the management write of a cluster
option (``management().set_config``), and ``InstanceRegistry`` keeps the
open instances' ids in the global config (``generate_instance_id`` makes
one).
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
        return value


class ConfigNamespace:
    """A node in the option tree; options register themselves under it
    (reference: ConfigNamespace.java:26)."""

    def __init__(self, name: str, description: str = "", parent: Optional["ConfigNamespace"] = None):
        self.name = name
        self.description = description
        self.parent = parent
        self.children: Dict[str, ConfigNamespace] = {}
        self.options: Dict[str, ConfigOption] = {}
        if parent is not None:
            parent.children[name] = self

    @property
    def path(self) -> str:
        parts: List[str] = []
        ns: Optional[ConfigNamespace] = self
        while ns is not None and ns.parent is not None:
            parts.append(ns.name)
            ns = ns.parent
        return ".".join(reversed(parts))

    def option(
        self,
        name: str,
        datatype: type,
        description: str,
        default: Any = None,
        mutability: Mutability = Mutability.LOCAL,
        verifier: Optional[Callable[[Any], bool]] = None,
    ) -> ConfigOption:
        full = f"{self.path}.{name}" if self.path else name
        opt = ConfigOption(full, datatype, description, default, mutability, verifier)
        self.options[name] = opt
        REGISTRY[full] = opt
        return opt


#: flat path -> option registry (reference: ROOT_NS tree)
REGISTRY: Dict[str, ConfigOption] = {}

ROOT = ConfigNamespace("root")
STORAGE = ConfigNamespace("storage", "storage backend", ROOT)
IDS = ConfigNamespace("ids", "id allocation", ROOT)
CACHE = ConfigNamespace("cache", "database caches", ROOT)
SCHEMA = ConfigNamespace("schema", "schema handling", ROOT)
CLUSTER = ConfigNamespace("cluster", "cluster-wide topology", ROOT)
GRAPH = ConfigNamespace("graph", "graph instance", ROOT)
LOG_NS = ConfigNamespace("log", "durable logs", ROOT)
TX_NS = ConfigNamespace("tx", "transactions", ROOT)
INDEX_NS = ConfigNamespace("index", "mixed index providers", ROOT)
METRICS_NS = ConfigNamespace("metrics", "metrics collection", ROOT)
COMPUTER_NS = ConfigNamespace("computer", "OLAP graph computer", ROOT)
LOCK_NS = ConfigNamespace("locks", "distributed locking", ROOT)
SERVER_NS = ConfigNamespace("server", "server endpoint", ROOT)
ATTRIBUTE_NS = ConfigNamespace("attributes", "attribute serialization", ROOT)

STORAGE.option("backend", str, "store manager shorthand", "inmemory")
STORAGE.option("directory", str, "data directory for persistent backends", "")
STORAGE.option("hostname", str, "remote storage server host", "")
STORAGE.option("port", int, "remote storage server port", 0)
STORAGE.option(
    "connection-pool-size", int, "client connections to a remote backend", 4,
    Mutability.MASKABLE, lambda v: v > 0,
)
STORAGE.option(
    "retry-time-ms", float,
    "time budget for retrying temporary backend failures with backoff",
    10_000.0, Mutability.MASKABLE,
)
STORAGE.option(
    "sharded-nodes", int, "node count for the sharded backend", 3,
    verifier=lambda v: v > 0,
)
STORAGE.option(
    "batch-loading", bool,
    "disable consistency checks for bulk loads", False,
)
STORAGE.option(
    "buffer-size", int, "mutation buffer flush batch size", 1024,
    verifier=lambda v: v > 0,
)
STORAGE.option(
    "parallel-backend-ops", bool,
    "parallelize multi-key slice reads on a worker pool", True,
)
IDS.option(
    "partition-bits", int, "bits of the vertex id reserved for the partition",
    5, Mutability.FIXED, lambda v: 0 <= v <= 16,
)
IDS.option(
    "block-size", int, "ids leased per authority block", 10_000,
    Mutability.GLOBAL_OFFLINE, lambda v: v > 0,
)
IDS.option(
    "authority-wait-ms", float,
    "claim-verification wait for the consistent-key id authority", 0.5,
    Mutability.GLOBAL_OFFLINE,
)
IDS.option(
    "authority.conflict-avoidance-mode", str,
    "id-block claim contention avoidance (reference: "
    "ConflictAvoidanceMode.java:76): none | local_manual | global_manual "
    "| global_auto — tagged modes stripe the block space so allocators "
    "never race on one claim key",
    "none", Mutability.GLOBAL_OFFLINE,
    lambda v: v in ("none", "local_manual", "global_manual", "global_auto"),
)
IDS.option(
    "authority.conflict-avoidance-tag", int,
    "this instance's claim tag for the manual conflict-avoidance modes",
    0, Mutability.LOCAL, lambda v: v >= 0,
)
IDS.option(
    "authority.conflict-avoidance-tag-bits", int,
    "bits of claim-tag space (num tags = 2^bits); governs the id-space "
    "striping factor of tagged modes",
    4, Mutability.FIXED, lambda v: 0 < v <= 16,
)
CACHE.option("db-cache", bool, "enable the store-level slice cache", True)
CACHE.option(
    "db-cache-size", int, "slice cache entry budget", 65536,
    Mutability.MASKABLE, lambda v: v > 0,
)
CACHE.option(
    "db-cache-time-ms", float,
    "slice cache TTL bounding cross-instance staleness (0 = no expiry)",
    10_000.0, Mutability.MASKABLE,
)
CACHE.option(
    "tx-cache-size", int, "per-transaction vertex cache size", 20000,
    Mutability.MASKABLE, lambda v: v > 0,
)
SCHEMA.option(
    "default", str, "auto-create schema on first use ('auto'|'none')", "auto",
    Mutability.MASKABLE, lambda v: v in ("auto", "none"),
)
SCHEMA.option(
    "constraints", bool,
    "enforce label property/connection constraints on writes (reference: "
    "schema.constraints + SchemaManager.addProperties/addConnection; "
    "with schema.default=auto missing constraints are auto-created, with "
    "'none' they reject)", False, Mutability.GLOBAL_OFFLINE,
)
CLUSTER.option(
    "max-partitions", int,
    "virtual partitions for graph sharding (OLAP shard granularity)",
    32, Mutability.FIXED, lambda v: v > 0,
)
GRAPH.option(
    "graphname", str, "name of this graph for multi-graph management", "graph",
)
GRAPH.option(
    "unique-instance-id", str,
    "cluster-unique id of this open instance (auto-generated when empty)", "",
)
GRAPH.option(
    "unique-instance-id-suffix", str,
    "discriminator appended to auto-generated instance ids (reference: "
    "computeUniqueInstanceId; read in generate_instance_id)", "",
)
GRAPH.option(
    "use-hostname-for-unique-instance-id", bool,
    "base auto-generated instance ids on the host name so registry "
    "entries are operator-recognizable", False,
)
STORAGE.option(
    "write-attempts", int,
    "cap the retry guard's replay COUNT in addition to its time budget "
    "(0 = time budget only; reference: storage.write-attempts; read by "
    "the remote client's backend_op.execute calls)",
    0, Mutability.MASKABLE, lambda v: v >= 0,
)
LOCK_NS.option(
    "clean-expired", bool,
    "delete expired lock-claim columns encountered during lock checks "
    "(dead holders' claims otherwise linger; reference: "
    "ConsistentKeyLocker CLEAN_EXPIRED)", False, Mutability.MASKABLE,
)
METRICS_NS.option(
    "merge-stores", bool,
    "report store metrics under one 'stores' bucket instead of "
    "per-store names (reference: metrics.merge-stores)", False,
)
GRAPH.option(
    "set-vertex-id", bool,
    "allow callers to supply their own vertex ids "
    "(tx.add_vertex(vertex_id=...); bulk loaders needing deterministic "
    "ids — reference: graph.set-vertex-id). Custom ids bypass the id "
    "authority; collision avoidance is the operator's responsibility",
    False, Mutability.FIXED,
)
GRAPH.option(
    "timestamps", str,
    "resolution of storage-visible timestamps (reference: "
    "TimestampProviders + graph.timestamps): nano | micro | milli — "
    "stamped onto durable-log messages; coarser values trade ordering "
    "granularity for cross-instance clock tolerance",
    "nano", Mutability.GLOBAL_OFFLINE,
    lambda v: v in ("nano", "micro", "milli"),
)
LOG_NS.option(
    "num-buckets", int, "write-parallelism buckets per log partition", 4,
    Mutability.GLOBAL_OFFLINE, lambda v: v > 0,
)
LOG_NS.option(
    "send-batch-size", int, "max messages per batched log append", 256,
    Mutability.MASKABLE, lambda v: v > 0,
)
LOG_NS.option(
    "read-lag-ms", float,
    "pullers stop this far behind now so a cross-sender message stamped "
    "earlier but flushed later (stamp-to-flush delay <= the send "
    "interval) is never skipped past the cursor; -1 = auto (3x "
    "log.send-delay-ms + one graph.timestamps tick; reference: KCVSLog "
    "read-lag-time)", -1.0, Mutability.MASKABLE,
)
LOG_NS.option(
    "read-interval-ms", float, "poll interval of log message pullers", 20.0,
    Mutability.MASKABLE,
)
TX_NS.option("log-tx", bool, "write the WAL transaction log", False, Mutability.GLOBAL)
TX_NS.option(
    "max-commit-time-ms", float,
    "recovery considers a tx abandoned after this long", 10_000.0,
    Mutability.GLOBAL,
)
IDS.option(
    "renew-timeout-ms", float,
    "bound the wait for an in-flight background id-block fetch "
    "(0 = wait forever; reference: ids.renew-timeout; read in "
    "StandardIDPool.next_id)", 0.0, Mutability.MASKABLE, lambda v: v >= 0,
)
IDS.option(
    "authority.max-retries", int,
    "id-block claim attempts before giving up (each pays authority-wait)",
    20, Mutability.MASKABLE, lambda v: v > 0,
)
STORAGE.option(
    "read-only", bool,
    "open the storage backend read-only: every mutation attempt raises "
    "(reference: storage.read-only)", False,
)
STORAGE.option(
    "remote.connect-timeout-ms", float,
    "TCP connect timeout of the remote storage/index clients",
    30_000.0, Mutability.MASKABLE, lambda v: v > 0,
)
CACHE.option(
    "db-cache-clean-wait-ms", float,
    "grace period after a row invalidation during which the slice cache "
    "refuses to re-admit that row — covers eventually-consistent backends "
    "still propagating the write (reference: cache.db-cache-clean-wait)",
    0.0, Mutability.MASKABLE, lambda v: v >= 0,
)
COMPUTER_NS.option(
    "frontier-cc-min-edges", int,
    "edge count above which frontier='auto' engages the compacted path "
    "for ConnectedComponents (below it the dense superstep is cheaper "
    "than 2 host round trips/hop)", 1 << 30,
    Mutability.MASKABLE, lambda v: v >= 0,
)
COMPUTER_NS.option(
    "frontier-f-min", int,
    "smallest frontier-compaction tier (vertex cap) — smaller recompiles "
    "more tiers, larger wastes work on tiny frontiers", 1 << 10,
    Mutability.MASKABLE, lambda v: v > 0,
)
COMPUTER_NS.option(
    "frontier-e-min", int,
    "smallest frontier-expansion tier (edge cap)", 1 << 13,
    Mutability.MASKABLE, lambda v: v > 0,
)
ATTRIBUTE_NS.option(
    "allow-pickle", str,
    "arbitrary-object pickle frames in the attribute serializer: 'auto' "
    "permits them only when the backing store is in-process/local-disk "
    "(a remote KCVS peer must never be able to plant a pickle payload "
    "that executes on read); 'true'/'false' force the choice",
    "auto", Mutability.LOCAL, lambda v: v in ("auto", "true", "false"),
)
INDEX_NS.option("search.backend", str, "mixed index provider shorthand", "memindex")
INDEX_NS.option("search.directory", str, "index data directory", "")
INDEX_NS.option(
    "search.hostname", str,
    "remote index server host (backend=remote; reference: index.[X].hostname)",
    "127.0.0.1",
)
INDEX_NS.option(
    "search.port", int, "remote index server port (backend=remote)", 0
)
METRICS_NS.option("enabled", bool, "collect per-store operation metrics", False)
COMPUTER_NS.option(
    "result-mode", str, "olap result mode ('memory'|'persist')", "memory",
    Mutability.MASKABLE, lambda v: v in ("memory", "persist"),
)
COMPUTER_NS.option(
    "strategy", str,
    "device aggregation kernel ('auto'|'ell'|'hybrid'|'segment'|'pallas'); "
    "'auto' consults the profiler-driven autotuner (olap/autotune.py, "
    "gated by computer.autotune)", "segsum",
    Mutability.MASKABLE,
    lambda v: v in ("segsum", "auto", "ell", "hybrid", "segment", "pallas"),
)
COMPUTER_NS.option(
    "autotune", bool,
    "profiler-driven autotuning behind computer.strategy='auto': choose "
    "ell/hybrid/segment, the hybrid hub cutoff, and the frontier tier "
    "schedules from the degree histogram + device roofline peaks "
    "(olap/autotune.decide; decision recorded in run_info['autotune']). "
    "False falls back to the legacy ELL footprint-budget heuristic", True,
    Mutability.MASKABLE,
)
COMPUTER_NS.option(
    "autotune-hub-cutoff", int,
    "hybrid-format degree cutoff between the exact-width ELL torso and "
    "the chunked CSR tail (0 = let the tuner search the pow2 candidates; "
    "read in TPUExecutor._autotune/_hybrid_pack)", 0,
    Mutability.MASKABLE, lambda v: v >= 0,
)
COMPUTER_NS.option(
    "autotune-tail-chunk", int,
    "hybrid tail chunk width (power of two): hub edge ranges are gathered "
    "in chunks of this many slots, so per-hub padding is bounded by one "
    "chunk (olap/kernels.py HybridPack)", 256,
    Mutability.MASKABLE, lambda v: v > 0 and (v & (v - 1)) == 0,
)
COMPUTER_NS.option(
    "autotune-min-gain", float,
    "fractional modeled superstep-time gain the hybrid layout must show "
    "over pure ELL before the tuner picks it (hysteresis against churning "
    "packs for marginal wins; olap/autotune.decide)", 0.05,
    Mutability.MASKABLE, lambda v: 0.0 <= v < 1.0,
)
COMPUTER_NS.option(
    "autotune-max-tiers", int,
    "frontier tier-ladder length budget per cap axis — each tier is one "
    "compiled executable; the tuner picks the smallest pow2 growth that "
    "fits (olap/autotune.decide_tiers)", 8,
    Mutability.MASKABLE, lambda v: v >= 2,
)
COMPUTER_NS.option(
    "autotune-persist", bool,
    "serialize the last measured autotune record next to the checkpoint "
    "file (<checkpoint-path>.autotune.json) and feed it back into "
    "decide() on the next executor lifetime, so achieved-bandwidth "
    "calibration survives process restarts (needs computer."
    "checkpoint-path; olap/autotune.save_measured/load_measured)", True,
    Mutability.MASKABLE,
)
COMPUTER_NS.option(
    "features-dim-tier", int,
    "forced padded feature-dim lane tier for dense-feature programs "
    "(power of two >= the program's logical feature dim; 0 = pick the "
    "smallest FEATURE_TIERS entry that fits; olap/features/kernels."
    "pick_feature_tier)", 0,
    Mutability.MASKABLE, lambda v: v >= 0 and (v & (v - 1)) == 0,
)
COMPUTER_NS.option(
    "features-native-matmul", bool,
    "use the backend's native dot (the MXU path) for dense-feature "
    "programs' dense transforms instead of the deterministic tree "
    "contraction — peak matmul throughput at the cost of the "
    "cross-executor bitwise guarantee (olap/features/kernels."
    "tree_matmul)", False, Mutability.MASKABLE,
)
COMPUTER_NS.option(
    "ell-max-capacity", int,
    "ELL bucket capacity cap; larger degrees row-split (supernode bound)",
    1 << 14, Mutability.MASKABLE, lambda v: v >= 8,
)
COMPUTER_NS.option(
    "executor", str,
    "default executor for graph.compute(): 'tpu' (single device), "
    "'sharded' (mesh over every visible device), 'cpu' (scalar oracle)",
    "tpu", Mutability.MASKABLE, lambda v: v in ("tpu", "cpu", "sharded"),
)
COMPUTER_NS.option(
    "exchange", str,
    "sharded-executor message exchange: 'blocked' (propagation-blocked "
    "halo exchange — destination-binned combiner-merged bins in one "
    "all_to_all, parallel/halo.py), 'a2a' (eager boundary-bucket "
    "all_to_all of raw source values), 'ring' (ppermute streaming), "
    "'gather' (full all_gather, debug), or 'auto' (olap/autotune."
    "decide_sharded picks per shard count from boundary/halo widths)",
    "auto", Mutability.MASKABLE,
    lambda v: v in ("a2a", "ring", "gather", "blocked", "auto"),
)
COMPUTER_NS.option(
    "agg", str,
    "sharded-executor local aggregation: uniform degree-bucketed ELL or "
    "flat segment reduction (ring/gather require 'segment'; "
    "exchange='blocked' fuses binning into either form)", "ell",
    Mutability.MASKABLE, lambda v: v in ("ell", "segment"),
)
COMPUTER_NS.option(
    "sharded-auto", bool,
    "route graph.compute() submits from the default 'tpu' executor to "
    "the sharded mesh executor whenever more than one device is visible "
    "(multi-chip as the default fast path); a routed run that fails "
    "falls back to the single-device executor and records the reason in "
    "run_info['routing']", True, Mutability.MASKABLE,
)
COMPUTER_NS.option(
    "shard-measure", bool,
    "measure per-shard superstep walls with the host probe (each "
    "shard's real aggregation workload timed shard-by-shard) and feed "
    "them into the skew report and per-shard roofline as cost_source="
    "'measured'; off = plan-derived estimates only", True,
    Mutability.MASKABLE,
)
COMPUTER_NS.option(
    "write-back-batch", int,
    "vertices per transaction when persisting compute keys", 10_000,
    Mutability.MASKABLE, lambda v: v > 0,
)
COMPUTER_NS.option(
    "sync-every", int,
    "supersteps between host aggregator fetches (host-loop programs)", 1,
    Mutability.MASKABLE, lambda v: v > 0,
)
COMPUTER_NS.option(
    "checkpoint-every", int,
    "supersteps between OLAP state checkpoints (0 = no checkpointing)", 0,
    Mutability.MASKABLE, lambda v: v >= 0,
)
COMPUTER_NS.option(
    "checkpoint-path", str, "directory/file for OLAP superstep checkpoints", "",
)
COMPUTER_NS.option(
    "shard-checkpoint-path", str,
    "directory for SHARDED checkpoints (per-shard state slices + an "
    "atomically committed manifest; olap/sharded_checkpoint.py) — the "
    "multi-chip auto-resume consistency cut. Empty = fall back to the "
    "single-file computer.checkpoint-path format", "",
)
COMPUTER_NS.option(
    "shard-checkpoint-every", int,
    "supersteps between sharded-checkpoint manifests (0 = use "
    "computer.checkpoint-every; read in GraphComputer._submit)", 0,
    Mutability.MASKABLE, lambda v: v >= 0,
)
COMPUTER_NS.option(
    "spillover", bool,
    "OLTP->OLAP spillover: recurring expensive multi-hop traversal shapes "
    "(promoted from the digest table's measured mean cost) compile to "
    "frontier-expansion/SpGEMM supersteps over a cached CSR snapshot, with "
    "tx-overlay reconciliation for read-your-writes (olap/spillover.py; "
    "hook: GraphTraversal._execute). Any unsupported step, overlay "
    "overflow, staleness breach, or rung-2 brownout falls back to the "
    "row-by-row walk with a spillover_fallback flight event", True,
    Mutability.MASKABLE,
)
COMPUTER_NS.option(
    "spillover-min-cost-ms", float,
    "measured mean wall (digest table) a traversal shape must exceed "
    "before the spillover planner promotes it to the OLAP executor "
    "(olap/spillover.SpilloverPlanner)", 25.0,
    Mutability.MASKABLE, lambda v: v >= 0,
)
COMPUTER_NS.option(
    "spillover-min-seen", int,
    "executions of a shape the digest table must have observed before the "
    "spillover planner considers promotion — one slow outlier is not a "
    "recurring shape (olap/spillover.SpilloverPlanner)", 3,
    Mutability.MASKABLE, lambda v: v >= 1,
)
COMPUTER_NS.option(
    "spillover-min-hops", int,
    "expansion steps a chain needs before spillover is even considered; "
    "single-hop traversals stay on the multiquery-batched row path "
    "(olap/spillover.py eligibility precheck)", 2,
    Mutability.MASKABLE, lambda v: v >= 1,
)
COMPUTER_NS.option(
    "spillover-max-overlay", int,
    "uncommitted tx mutations (added/deleted edges, new/removed vertices) "
    "beyond which spillover falls back to the row walk instead of patching "
    "the snapshot — overlay reconciliation cost must stay small relative "
    "to the spilled run (olap/spillover.py)", 4096,
    Mutability.MASKABLE, lambda v: v >= 0,
)
COMPUTER_NS.option(
    "spillover-max-staleness", int,
    "committed writes since the CSR snapshot was packed beyond which "
    "spillover refuses (falls back, counter olap.spillover.stale, snapshot "
    "dropped for repack); within the bound the snapshot is incrementally "
    "refreshed via the mutation-epoch tracker (olap/spillover.py; "
    "groundwork for streaming delta-CSR freshness)", 4096,
    Mutability.MASKABLE, lambda v: v >= 0,
)
COMPUTER_NS.option(
    "delta", bool,
    "incremental delta-CSR (olap/delta.py): commit-side change capture "
    "feeds a bounded overlay (edge adds, tombstones, vertex add/remove) "
    "that GraphComputer.submit() and the spillover snapshot consume "
    "instead of re-scanning the store — warm submits skip the scan "
    "entirely, small overlays are consumed FUSED with the base CSR "
    "inside the superstep, larger ones fold into fresh arrays with zero "
    "store reads. Off = every snapshot is a full scan + pack", True,
    Mutability.MASKABLE,
)
COMPUTER_NS.option(
    "delta-capture-limit", int,
    "change-capture ring size (records); past it the oldest batches "
    "drop and snapshots older than the drop point fall back to a full "
    "reload (olap/delta.ChangeCapture)", 1 << 16,
    Mutability.MASKABLE, lambda v: v >= 0,
)
COMPUTER_NS.option(
    "delta-max-overlay", int,
    "pending records beyond which a warm submit stops consuming the "
    "overlay fused and folds it into the base arrays instead (still "
    "zero store reads; olap/delta.DeltaSnapshot)", 4096,
    Mutability.MASKABLE, lambda v: v >= 0,
)
COMPUTER_NS.option(
    "delta-max-lane-cells", int,
    "cap on the fused overlay's total lane cells (add + tombstone + "
    "dirty-row live lanes) — a tombstoned hub destination makes the "
    "live lane O(degree); past the cap the overlay materializes "
    "instead (olap/delta.OverlayView)", 1 << 16,
    Mutability.MASKABLE, lambda v: v >= 0,
)
COMPUTER_NS.option(
    "delta-compact-threshold", int,
    "overlay depth (records) at which the warm snapshot folds the "
    "overlay back into the base pack off the superstep path (0 = let "
    "olap/autotune.decide_delta price delta-vs-repack per device)", 0,
    Mutability.MASKABLE, lambda v: v >= 0,
)
COMPUTER_NS.option(
    "delta-snapshot-path", str,
    "file for persisting the compacted base CSR pack (tmp+rename npz, "
    "same discipline as checkpoints) so a restarted process warm-starts "
    "from the pack instead of a cold scan; empty = in-memory only "
    "(olap/delta.save_snapshot)", "",
)
COMPUTER_NS.option(
    "price-book-path", str,
    "file for persisting the digest-table price books (tmp+rename JSON, "
    "same discipline as the autotune record) so spillover promotion and "
    "admission pricing warm-start across restarts; empty = derive "
    "<computer.checkpoint-path>.pricebook.json when a checkpoint path is "
    "set, else no persistence (observability/profiler.save_price_book, "
    "loaded at graph open)", "",
)
COMPUTER_NS.option(
    "shard-checkpoint-shards", int,
    "state-slice count when a NON-mesh executor (the CPU oracle) writes "
    "the sharded checkpoint format (0 = single-file format; the sharded "
    "executor always slices by its mesh size)", 0,
    Mutability.MASKABLE, lambda v: v >= 0,
)
STORAGE.option(
    "scan-batch-size", int, "rows per scan-framework batch", 4096,
    Mutability.MASKABLE, lambda v: v > 0,
)
STORAGE.option(
    "distributed-load-workers", int,
    "worker PROCESSES for distributed CSR loading at graph.compute() "
    "(olap/distributed_load.py): each scans a disjoint storage-partition "
    "range of a SHARED backend (storage.backend 'remote' or 'local') and "
    "the parent merges once; 0/1 = in-process loader. Raw-scan loads "
    "only — property/weight/label-filtered snapshots fall back",
    0, Mutability.MASKABLE, lambda v: v >= 0,
)
STORAGE.option(
    "distributed-load-timeout-s", float,
    "shared deadline for the distributed-load worker pool (a hung worker "
    "fails the load rather than leaking scanners past it)", 600.0,
    Mutability.MASKABLE, lambda v: v > 0,
)
STORAGE.option(
    "scan-parallelism", int,
    "worker threads assembling scan batches (0 = one per partition)", 0,
    Mutability.MASKABLE, lambda v: v >= 0,
)
IDS.option(
    "placement", str,
    "vertex partition placement strategy ('simple'|'property')", "simple",
    Mutability.MASKABLE, lambda v: v in ("simple", "property"),
)
IDS.option(
    "placement-key", str,
    "property whose hashed value picks the partition ('property' strategy)",
    "",
)
IDS.option(
    "renew-percentage", float,
    "fraction of an id block remaining that triggers background renewal",
    0.3, Mutability.MASKABLE, lambda v: 0.0 < v < 1.0,
)
LOCK_NS.option(
    "wait-ms", float, "claim re-read wait of the consistent-key locker", 1.0,
    Mutability.GLOBAL_OFFLINE,
)
LOCK_NS.option(
    "expiry-ms", float, "lock claims older than this are expired", 10_000.0,
    Mutability.GLOBAL_OFFLINE,
)
LOCK_NS.option(
    "retries", int, "lock acquisition attempts", 3, Mutability.MASKABLE,
    lambda v: v > 0,
)
SERVER_NS.option("host", str, "bind address", "127.0.0.1")
SERVER_NS.option("port", int, "bind port", 8182)
SERVER_NS.option("auth.enabled", bool, "require HMAC token auth", False)
SERVER_NS.option("auth.secret", str, "HMAC token signing secret", "")

# ---- round-4 vocabulary growth: every option below is READ at a concrete
# ---- site (named in its description) — no dead knobs
QUERY_NS = ConfigNamespace("query", "query execution", ROOT)

QUERY_NS.option(
    "fast-property", bool,
    "prefetch the whole property range in one slice on a keyed property "
    "read so the row cache serves later reads (reference: "
    "query.fast-property / PROPERTY_PREFETCHING; read in tx.get_properties)",
    True, Mutability.MASKABLE,
)
METRICS_NS.option(
    "slow-query-threshold-ms", float,
    "traversal executions slower than this bump the query.slow counter "
    "(0 = off; read in GraphTraversal._execute)", 0.0,
    Mutability.MASKABLE, lambda v: v >= 0,
)
SERVER_NS.option(
    "max-query-length", int,
    "refuse submitted queries longer than this many characters (bounds "
    "AST parse cost; read in the server eval path)", 65536,
    Mutability.MASKABLE, lambda v: v > 0,
)
SERVER_NS.option(
    "request-timeout-s", float,
    "per-connection socket timeout of the HTTP/WS handlers AND the "
    "default wall-clock deadline on query evaluation when the client "
    "sends no X-Deadline-Ms (overridable via server.deadline.default-ms; "
    "0 = neither: idle WebSocket sessions live indefinitely)", 120.0,
    Mutability.MASKABLE, lambda v: v >= 0,
)
# ---- round-5 batch: remaining reference-vocabulary knobs that were
# ---- hard-coded constants; each names its read site
QUERY_NS.option(
    "max-traversers", int,
    "frontier-size budget per traversal execution (0 = unlimited): an "
    "exploding chain — e.g. unbounded repeat().emit() on a cyclic label "
    "doubles the frontier every loop — raises QueryError instead of "
    "consuming the process (the role of the reference Gremlin Server's "
    "evaluationTimeout, as a SIZE bound since Python threads cannot be "
    "interrupted; read in GraphTraversal._execute + the repeat loop)",
    1_000_000, Mutability.MASKABLE, lambda v: v >= 0,
)
QUERY_NS.option(
    "ignore-unknown-index-key", bool,
    "graph-centric queries over a property key absent from the schema: "
    "false (reference default) raises QueryError, true treats the "
    "condition as unsatisfiable (reference: "
    "query.ignore-unknown-index-key; read in the V().has() start-step "
    "fold)", False, Mutability.MASKABLE,
)
INDEX_NS.option(
    "search.scroll-page-size", int,
    "page size of IndexProvider.query_stream scroll-style paging "
    "(reference: the ES scroll window, ElasticSearchScroll.java:80; "
    "read in provider.query_stream)", 1000,
    Mutability.MASKABLE, lambda v: v > 0,
)
SCHEMA.option(
    "eviction-ack-poll-ms", float,
    "polling cadence while a schema change waits for cache-eviction "
    "acks (read in ManagementLogger.wait_for_acks)", 5.0,
    Mutability.MASKABLE, lambda v: v > 0,
)
LOG_NS.option(
    "slice-granularity-ms", int,
    "time window of one log row: messages within a window share a "
    "sorted row, bounding per-row width vs row count (FIXED — row keys "
    "are derived from it; read at KCVSLog construction)", 100,
    Mutability.FIXED, lambda v: v > 0,
)
STORAGE.option(
    "remote.parallel-slice-factor", int,
    "client-side multi-slice fan-out fires when the key count exceeds "
    "factor x pool connections (read in RemoteStoreManager multi-slice)",
    2, Mutability.MASKABLE, lambda v: v >= 1,
)
STORAGE.option(
    "remote.pipeline", bool,
    "pipelined async wire framing against the remote KCVS server "
    "(storage/pipeline.py): per-frame request ids, out-of-order "
    "completion, op coalescing into batched wire frames, and few-socket "
    "connection multiplexing — negotiated via the server's 'pipeline' "
    "feature bit, so un-negotiated peers keep the synchronous framing "
    "byte-for-byte. Routing is adaptive: a sequential caller or a "
    "microsecond-fast backend stays on the sync pool; latency-dominated "
    "concurrency beyond the pool size engages the mux", True,
    Mutability.MASKABLE,
)
STORAGE.option(
    "remote.pipeline-connections", int,
    "pipelined sockets per remote store client — many in-flight ops "
    "share these few connections (read in RemoteStoreManager)", 2,
    Mutability.MASKABLE, lambda v: v >= 1,
)
STORAGE.option(
    "remote.pipeline-depth", int,
    "bound of the pipelined send queue per connection: submits past it "
    "block (backpressure, counted as pipeline stalls) — the JG206 "
    "bounded-buffer discipline on the wire path", 128,
    Mutability.MASKABLE, lambda v: v >= 1,
)
STORAGE.option(
    "remote.pipeline-max-batch", int,
    "most ops coalesced into one pipelined wire frame (batch carrier / "
    "merged multi)", 64, Mutability.MASKABLE, lambda v: v >= 1,
)
STORAGE.option(
    "remote.pipeline-multi-chunk", int,
    "pipelined multi-slice reads split into chunks of this many keys, "
    "gathered concurrently as sibling sub-frames (server works them in "
    "parallel)", 512, Mutability.MASKABLE, lambda v: v >= 1,
)
STORAGE.option(
    "remote.pipeline-stall-ms", float,
    "a submit blocked on the full pipeline queue past this long counts "
    "as a pipeline stall (counter + flight event)", 200.0,
    Mutability.MASKABLE, lambda v: v >= 0,
)
STORAGE.option(
    "remote.pipeline-coalesce-us", float,
    "group-commit window: with >=3 ops in flight the combiner holds a "
    "frame open this long (once per response burst) so convoyed "
    "resubmits seal into one coalesced carrier; 0 disables the window "
    "(ops still batch when they queue naturally)", 150.0,
    Mutability.MASKABLE, lambda v: v >= 0,
)
COMPUTER_NS.option(
    "frontier-tier-growth", int,
    "growth factor between frontier tier capacities — one compiled "
    "executable per tier, so smaller factors mean tighter capacity fit "
    "but more compiles (read in the frontier tier ladder)", 4,
    Mutability.MASKABLE, lambda v: v >= 2,
)
SERVER_NS.option(
    "auto-commit", bool,
    "commit each successful request's transaction (the reference Gremlin "
    "Server's sessionless semantics — mutating queries like mergeV/addV "
    "persist); false rolls every request back, making the endpoint "
    "read-only (read in JanusGraphServer.execute)", True,
    Mutability.MASKABLE,
)
TX_NS.option(
    "read-only-default", bool,
    "new transactions default to read-only (pairs with storage.read-only "
    "replicas; read in new_transaction)", False, Mutability.MASKABLE,
)
SCHEMA.option(
    "eviction-ack-timeout-ms", float,
    "how long a schema change waits for every open instance to "
    "acknowledge the cache-eviction broadcast (reference: "
    "ManagementLogger ack tracking)", 5000.0,
    Mutability.MASKABLE, lambda v: v > 0,
)
QUERY_NS.option(
    "batch", bool,
    "batched multiQuery prefetch in traversal expansion steps (off = one "
    "slice read per vertex; reference: query.batch; read in the "
    "expansion step + tx.prefetch)", True, Mutability.MASKABLE,
)
QUERY_NS.option(
    "max-repeat-loops", int,
    "graph-wide bound on until-only repeat() loops (cycles would never "
    "drain; read in GraphTraversal.repeat)", 64,
    Mutability.MASKABLE, lambda v: v > 0,
)

# ---- robustness: chaos engine, circuit breaker, self-healing paths ------
STORAGE.option(
    "faults.enabled", bool,
    "wrap the data-plane stores in the seeded deterministic fault "
    "injector (storage/faults.py FaultInjectingStoreManager); the plan "
    "is exposed as graph.fault_plan", False,
)
STORAGE.option(
    "faults.seed", int,
    "chaos seed: every fault decision is a pure function of "
    "(seed, kind, op index), so one seed reproduces one fault sequence",
    0, Mutability.LOCAL, lambda v: v >= 0,
)
STORAGE.option(
    "faults.read-error-rate", float,
    "probability of an injected TemporaryBackendError per data-plane "
    "read (absorbed by the backend_op retry guard)", 0.0,
    Mutability.LOCAL, lambda v: 0.0 <= v <= 1.0,
)
STORAGE.option(
    "faults.write-error-rate", float,
    "probability of an injected TemporaryBackendError per data-plane "
    "mutation (raised BEFORE anything applies, so retries are safe)",
    0.0, Mutability.LOCAL, lambda v: 0.0 <= v <= 1.0,
)
STORAGE.option(
    "faults.latency-ms", float,
    "injected latency spike length for reads the latency-rate selects",
    0.0, Mutability.LOCAL, lambda v: v >= 0,
)
STORAGE.option(
    "faults.latency-rate", float,
    "probability of a latency spike per data-plane read", 0.0,
    Mutability.LOCAL, lambda v: 0.0 <= v <= 1.0,
)
STORAGE.option(
    "faults.torn-mutation-at", int,
    "mutate_many call index at which to CRASH after applying a prefix of "
    "the batch (-1 = off) — the torn-commit case TornCommitRecovery "
    "heals on reopen", -1, Mutability.LOCAL, lambda v: v >= -1,
)
STORAGE.option(
    "faults.lock-expiry-at", int,
    "lock-check index at which the locker's clock is skewed so the "
    "holder's lease reads as expired (-1 = off)", -1,
    Mutability.LOCAL, lambda v: v >= -1,
)
STORAGE.option(
    "faults.scan-kill-at", int,
    "row-scan index at which the stream is killed mid-flight (-1 = off) "
    "— absorbed by StandardScanner's per-partition retry + resume", -1,
    Mutability.LOCAL, lambda v: v >= -1,
)
STORAGE.option(
    "faults.scan-kill-after-rows", int,
    "rows the killed scan yields before dying", 8,
    Mutability.LOCAL, lambda v: v >= 0,
)
STORAGE.option(
    "faults.preempt-superstep", int,
    "OLAP superstep at which SuperstepPreempted is raised once (-1 = "
    "off) — absorbed by the executors' checkpoint auto-resume", -1,
    Mutability.LOCAL, lambda v: v >= -1,
)
STORAGE.option(
    "faults.shard-preempt-superstep", int,
    "sharded-executor superstep at which ONE shard is preempted "
    "mid-superstep (ShardPreempted; -1 = off) — absorbed by the "
    "cross-shard auto-resume rolling every shard back to the last "
    "complete manifest (the consistency cut)", -1,
    Mutability.LOCAL, lambda v: v >= -1,
)
STORAGE.option(
    "faults.shard-preempt-shard", int,
    "which shard the scheduled shard preemption hits (-1 = pick "
    "deterministically from the seed)", -1,
    Mutability.LOCAL, lambda v: v >= -1,
)
STORAGE.option(
    "faults.shard-collective-timeout-at", int,
    "cross-shard collective index (one per superstep barrier) at which "
    "CollectiveTimeout is raised once (-1 = off)", -1,
    Mutability.LOCAL, lambda v: v >= -1,
)
STORAGE.option(
    "faults.shard-halo-drop-at", int,
    "halo-exchange index at which a destination-binned halo batch is "
    "dropped (HaloDropped; -1 = off)", -1,
    Mutability.LOCAL, lambda v: v >= -1,
)
STORAGE.option(
    "faults.shard-straggler-ms", float,
    "injected per-shard latency skew length (straggler simulation; "
    "pairs with shard-straggler-rate)", 0.0,
    Mutability.LOCAL, lambda v: v >= 0,
)
STORAGE.option(
    "faults.shard-straggler-rate", float,
    "probability a given (superstep, shard) pair runs shard-straggler-ms "
    "late — decisions are pure in the absolute pair, so auto-resume "
    "replays see identical skew", 0.0,
    Mutability.LOCAL, lambda v: 0.0 <= v <= 1.0,
)
STORAGE.option(
    "faults.replica-kill-at", int,
    "fleet tick index at which the seeded-chosen serving replica is "
    "killed mid-traffic (-1 = off; the fleet chaos driver consults "
    "FaultPlan.fleet_hook and executes the decision — server/fleet.py)",
    -1, Mutability.LOCAL, lambda v: v >= -1,
)
STORAGE.option(
    "faults.replica-restart-at", int,
    "fleet tick index at which the killed replica rejoins the fleet "
    "(-1 = never; rejoin exercises the shard-checkpoint warm-up path)",
    -1, Mutability.LOCAL, lambda v: v >= -1,
)
STORAGE.option(
    "faults.replica-partition-at", int,
    "data-plane op index at which the target replica's storage "
    "partition window begins (-1 = off): the router still sees the "
    "replica, the replica cannot reach storage — breaker trips, "
    "/healthz degrades, the router must route around it",
    -1, Mutability.LOCAL, lambda v: v >= -1,
)
STORAGE.option(
    "faults.replica-partition-ops", int,
    "data-plane ops the partition window covers once it begins", 0,
    Mutability.LOCAL, lambda v: v >= 0,
)
STORAGE.option(
    "faults.replica-target", int,
    "explicit victim replica index for the replica fault kinds "
    "(-1 = seed-hashed, the shard-preemption discipline)", -1,
    Mutability.LOCAL, lambda v: v >= -1,
)
STORAGE.option(
    "faults.cdc-torn-at", int,
    "CDC tail-append index at which a torn partial frame hits disk and "
    "the writer 'dies' (CDCTornWrite; -1 = off) — reopening the log "
    "must drop exactly the torn suffix, never a sealed segment", -1,
    Mutability.LOCAL, lambda v: v >= -1,
)
STORAGE.option(
    "faults.follower-lag-at", int,
    "follower pull index at which the lag window begins (-1 = off): "
    "the follower stops applying for faults.follower-lag-pulls pulls, "
    "so staleness grows past the priced bound and the router must "
    "route freshness-hinted traffic back to the leader", -1,
    Mutability.LOCAL, lambda v: v >= -1,
)
STORAGE.option(
    "faults.follower-lag-pulls", int,
    "pulls the injected follower lag window covers once it begins", 0,
    Mutability.LOCAL, lambda v: v >= 0,
)
STORAGE.option(
    "faults.stall-lock-at", int,
    "instrumented-lock acquisition index at which the holder stalls "
    "for faults.stall-lock-ms (-1 = off) — the stall-watchdog "
    "certification fault: the watchdog must flight a lock_convoy "
    "carrying the holder's sampled stack and capture a forensics "
    "bundle (observability/continuous.py)", -1,
    Mutability.LOCAL, lambda v: v >= -1,
)
STORAGE.option(
    "faults.stall-lock-ms", float,
    "how long the chosen holder keeps the instrumented lock", 0.0,
    Mutability.LOCAL, lambda v: v >= 0,
)
STORAGE.option(
    "faults.wedge-thread-at", int,
    "worker-op index at which the worker thread wedges (-1 = off); "
    "the watchdog's progress checker must flight a stall", -1,
    Mutability.LOCAL, lambda v: v >= -1,
)
STORAGE.option(
    "faults.stores", str,
    "comma-separated store names the injector targets (empty = the "
    "data plane: edgestore,graphindex). System stores stay exempt so "
    "chaos never corrupts the recovery machinery itself",
    "edgestore,graphindex", Mutability.LOCAL,
)
STORAGE.option(
    "cdc.dir", str,
    "directory of the durable segmented change-capture log "
    "(storage/cdc.py CDCLog); empty = no durable CDC — the capture "
    "stays the PR 14 in-process ring. Requires computer.delta", "",
    Mutability.LOCAL,
)
STORAGE.option(
    "cdc.segment-records", int,
    "records per sealed CDC segment (power of two — cursor->segment "
    "arithmetic stays a shift); the tail seals automatically at this "
    "boundary", 1024, Mutability.LOCAL,
    lambda v: v > 0 and v & (v - 1) == 0,
)
STORAGE.option(
    "cdc.retention-segments", int,
    "sealed CDC segments retained before the oldest is pruned; pruning "
    "creates an honest cursor gap (followers behind it re-bootstrap "
    "from a checkpoint)", 64, Mutability.LOCAL, lambda v: v >= 1,
)
STORAGE.option(
    "breaker.enabled", bool,
    "circuit breaker on the remote store client and remote index "
    "provider (storage/circuit.py): consecutive temporary failures trip "
    "it open and callers fail fast instead of burning retry budget "
    "against a dead endpoint", False, Mutability.MASKABLE,
)
STORAGE.option(
    "breaker.failure-threshold", int,
    "consecutive temporary failures that trip the breaker open", 5,
    Mutability.MASKABLE, lambda v: v > 0,
)
STORAGE.option(
    "breaker.reset-ms", float,
    "open-state dwell time before the breaker half-opens for probes",
    1000.0, Mutability.MASKABLE, lambda v: v > 0,
)
STORAGE.option(
    "breaker.half-open-probes", int,
    "concurrent probe calls admitted while half-open; one success "
    "closes, one failure re-opens", 1,
    Mutability.MASKABLE, lambda v: v > 0,
)
STORAGE.option(
    "scan-retries", int,
    "per-partition retry budget of StandardScanner for temporary "
    "failures mid-scan (resume from the last fully processed batch)", 3,
    Mutability.MASKABLE, lambda v: v >= 0,
)
TX_NS.option(
    "recover-on-open", bool,
    "run torn-commit recovery at graph open when the WAL is enabled: "
    "PREFLUSH-without-PRIMARY_SUCCESS transactions older than "
    "tx.max-commit-time-ms are rolled forward, PRECOMMIT-only ones "
    "rolled back (core/txlog.py TornCommitRecovery)", True,
    Mutability.MASKABLE,
)
COMPUTER_NS.option(
    "resume-attempts", int,
    "checkpoint auto-resume budget per OLAP run: how many "
    "SuperstepPreempted events the executors absorb by reloading the "
    "last checkpoint before giving up", 3,
    Mutability.MASKABLE, lambda v: v >= 0,
)

STORAGE.option(
    "fsync", bool,
    "fsync WAL appends on the persistent local backend (localstore). "
    "Default True: matches the backend's own durable default", True,
)
STORAGE.option(
    "backoff-base-ms", float,
    "initial backoff of the temporary-failure retry guard (backend_op)",
    50.0, Mutability.MASKABLE, lambda v: v > 0,
)
STORAGE.option(
    "backoff-max-ms", float,
    "backoff ceiling of the temporary-failure retry guard (backend_op)",
    2000.0, Mutability.MASKABLE, lambda v: v > 0,
)
CACHE.option(
    "edgestore-fraction", float,
    "share of cache.db-cache-size given to the edgestore; the rest goes to "
    "the graph-index store (Backend.java:107's 80/20 split)", 0.8,
    Mutability.MASKABLE, lambda v: 0.0 < v < 1.0,
)
LOG_NS.option(
    "send-delay-ms", float,
    "max buffering delay before a log batch is flushed (KCVSLog sender)",
    10.0, Mutability.MASKABLE, lambda v: v >= 0,
)
LOG_NS.option(
    "ttl-seconds", float,
    "expire log rows after this long (0 = keep; requires a cell-TTL "
    "backend; read in Backend.get_log)", 0.0,
    Mutability.GLOBAL_OFFLINE, lambda v: v >= 0,
)
COMPUTER_NS.option(
    "frontier", str,
    "frontier compaction for ShortestPath/CC ('auto' sizes by graph, "
    "'always' forces it, 'off' disables; olap/frontier.py)",
    "auto", Mutability.MASKABLE, lambda v: v in ("auto", "off", "always"),
)
COMPUTER_NS.option(
    "ell-auto-budget-bytes", int,
    "HBM budget the auto strategy lets the ELL pack use before falling "
    "back to segment reduction (TPUExecutor._auto_strategy)",
    6 << 30, Mutability.MASKABLE, lambda v: v > 0,
)
COMPUTER_NS.option(
    "ell-auto-pad", float,
    "padding-ratio ceiling for the auto ELL strategy", 3.0,
    Mutability.MASKABLE, lambda v: v >= 1.0,
)
COMPUTER_NS.option(
    "channel-cache-size", int,
    "typed edge-channel ELL views kept device-resident (LRU)", 8,
    Mutability.MASKABLE, lambda v: v > 0,
)
SERVER_NS.option(
    "max-request-bytes", int,
    "reject HTTP bodies/WS frames larger than this (server/server.py)",
    1 << 20, Mutability.LOCAL, lambda v: v > 0,
)
SERVER_NS.option(
    "auth.token-ttl-ms", float,
    "HMAC token lifetime (server/auth.py TokenAuthenticator)", 3_600_000.0,
    Mutability.LOCAL, lambda v: v > 0,
)
SERVER_NS.option(
    "auth.credentials-db", str,
    "name of the credentials graph/store for SASL-style user auth",
    "credentials",
)
INDEX_NS.option(
    "search.pool-size", int,
    "client connections to the remote index server", 4,
    Mutability.LOCAL, lambda v: v > 0,
)
INDEX_NS.option(
    "search.retry-time-ms", float,
    "retry budget for temporary remote-index failures", 10_000.0,
    Mutability.MASKABLE, lambda v: v > 0,
)
INDEX_NS.option(
    "search.pipeline", bool,
    "pipelined async framing against the remote index server for "
    "idempotent ops (query/rawQuery/totals/supports/exists/register), "
    "negotiated via the fourth trailing capability byte; mutate and "
    "restore keep the sync dial-only-retry discipline. Same adaptive "
    "engagement rule as storage.remote.pipeline", True,
    Mutability.MASKABLE,
)
INDEX_NS.option(
    "search.fsync", bool, "fsync the persistent local index provider", False,
)
INDEX_NS.option(
    "search.max-result-set-size", int,
    "hard cap on mixed-index hits per query (reference: "
    "index.[X].max-result-set-size; read in IndexSerializer.query)",
    50_000, Mutability.MASKABLE, lambda v: v > 0,
)
QUERY_NS.option(
    "batch-size", int,
    "multiQuery prefetch chunk: vertices per batched multi-slice call "
    "(tx.prefetch; reference: query.batch)", 2500,
    Mutability.MASKABLE, lambda v: v > 0,
)
QUERY_NS.option(
    "force-index", bool,
    "refuse traversals that would fall back to a full graph scan "
    "(reference: query.force-index)", False, Mutability.MASKABLE,
)
QUERY_NS.option(
    "hard-max-limit", int,
    "clamp on index-query limits (reference: query.hard-max-limit)",
    1 << 20, Mutability.MASKABLE, lambda v: v > 0,
)
CLUSTER.option(
    "coordinator-address", str,
    "jax.distributed coordinator host:port for multi-host runs "
    "(parallel/multihost.init_multihost; env JAX_COORDINATOR_ADDRESS wins)",
    "",
)
CLUSTER.option(
    "num-processes", int,
    "process count of the multi-host run (0 = single-process)", 0,
    Mutability.LOCAL, lambda v: v >= 0,
)
CLUSTER.option(
    "process-id", int, "this host's process index in the multi-host run", 0,
    Mutability.LOCAL, lambda v: v >= 0,
)
GRAPH.option(
    "replace-instance-if-exists", bool,
    "re-register over a stale instance id instead of refusing to open "
    "(instance registry in core/graph.py)", False,
)
METRICS_NS.option(
    "prefix", str, "prefix prepended to every emitted metric name",
    "janusgraph",
)
METRICS_NS.option(
    "console-interval-ms", float,
    "periodic console metrics reporter (0 = off; util/metrics.py)", 0.0,
    Mutability.LOCAL, lambda v: v >= 0,
)
METRICS_NS.option(
    "csv-interval-ms", float,
    "periodic CSV metrics reporter (0 = off)", 0.0,
    Mutability.LOCAL, lambda v: v >= 0,
)
METRICS_NS.option(
    "csv-directory", str, "directory the CSV reporter writes into", "",
)
METRICS_NS.option(
    "slow-op-threshold-ms", float,
    "spans slower than this land in the always-on slow-op ring buffer "
    "(0 = off; observability/spans.py — surfaced at GET /telemetry)",
    100.0, Mutability.MASKABLE, lambda v: v >= 0,
)
METRICS_NS.option(
    "span-buffer", int,
    "completed root-span trees retained for GET /telemetry",
    256, Mutability.LOCAL, lambda v: v > 0,
)
METRICS_NS.option(
    "slow-op-buffer", int,
    "slow-op events retained in the ring buffer",
    128, Mutability.LOCAL, lambda v: v > 0,
)

# ---- distributed tracing + flight recorder ------------------------------
METRICS_NS.option(
    "trace-propagation", bool,
    "attach the ambient span's TraceContext to outbound remote-store and "
    "remote-index op frames (gated on the peer's negotiated feature bit, "
    "so mixed old/new deployments stay wire-compatible; read at graph "
    "open into RemoteStoreManager/RemoteIndexProvider)", True,
    Mutability.MASKABLE,
)
METRICS_NS.option(
    "flight-buffer", int,
    "events retained in the black-box flight recorder ring "
    "(observability/flight.py; served at GET /flight and summarized in "
    "GET /healthz)", 512, Mutability.LOCAL, lambda v: v > 0,
)
METRICS_NS.option(
    "flight-dump-dir", str,
    "directory flight-recorder dumps are written to on an unhandled "
    "server error, the /healthz ok->degraded flip, or on demand "
    "(empty = the system temp dir)", "", Mutability.LOCAL,
)
# ---- profiling & cost attribution ---------------------------------------
METRICS_NS.option(
    "resource-ledger", bool,
    "accrue per-query resource costs (cells read/written, bytes moved, "
    "index hits, retries, wall by layer) into the ambient ResourceLedger "
    "and propagate the ledger flag over the remote-store/index protocols "
    "(gated on the peer's negotiated feature bit, so mixed old/new "
    "deployments stay wire-compatible; observability/profiler.py)", True,
    Mutability.MASKABLE,
)
METRICS_NS.option(
    "digest-top-k", int,
    "capacity of the bounded query-digest table (top-K shapes by total "
    "cost with p50/p95 wall; served at GET /profile and "
    "`janusgraph_tpu top`)", 128, Mutability.LOCAL, lambda v: v > 0,
)
METRICS_NS.option(
    "roofline-peak-flops", float,
    "peak device flops/s for the roofline model (0 = auto-detect from "
    "the device kind; observability/profiler.py device table)", 0.0,
    Mutability.LOCAL, lambda v: v >= 0,
)
METRICS_NS.option(
    "roofline-peak-bytes-per-s", float,
    "peak device memory bandwidth in bytes/s for the roofline model "
    "(0 = auto-detect from the device kind)", 0.0,
    Mutability.LOCAL, lambda v: v >= 0,
)
METRICS_NS.option(
    "roofline-peak-mxu-flops", float,
    "peak dense-matmul (MXU systolic array) flops/s — the denominator of "
    "the dense-feature tier's per-superstep mxu_utilization (0 = "
    "auto-detect from the device kind)", 0.0,
    Mutability.LOCAL, lambda v: v >= 0,
)
# ---- time-series history + SLO/burn-rate engine -------------------------
METRICS_NS.option(
    "history-enabled", bool,
    "retain a bounded in-process ring of periodic registry snapshots "
    "(counter/timer deltas per window, window percentiles; "
    "observability/timeseries.py — served at GET /timeseries and "
    "`janusgraph_tpu timeseries`; the query server owns the sampling "
    "thread)", True, Mutability.LOCAL,
)
METRICS_NS.option(
    "history-interval-s", float,
    "seconds between history samples (one ring window per sample)",
    5.0, Mutability.LOCAL, lambda v: v > 0,
)
METRICS_NS.option(
    "history-retention", int,
    "history windows retained (retention wall = this x "
    "history-interval-s; default 360 x 5 s = 30 min)",
    360, Mutability.LOCAL, lambda v: v > 0,
)
METRICS_NS.option(
    "slo-enabled", bool,
    "evaluate the declarative SLO specs with multi-window burn-rate "
    "alerting over the metrics history (observability/slo.py; alerts "
    "become flight slo_burn events, observability.slo.* gauges, and the "
    "/healthz slo block — a page-severity burn reports degraded)",
    True, Mutability.LOCAL,
)
METRICS_NS.option(
    "slo-availability-objective", float,
    "availability SLO: target non-shed fraction of arriving requests "
    "(good/bad from the admission counters)", 0.999,
    Mutability.LOCAL, lambda v: 0 < v < 1,
)
METRICS_NS.option(
    "slo-latency-objective", float,
    "latency SLO: target fraction of requests under their class "
    "threshold", 0.99, Mutability.LOCAL, lambda v: 0 < v < 1,
)
METRICS_NS.option(
    "slo-latency-threshold-ms", float,
    "latency SLO floor threshold; per-digest classes are additionally "
    "priced at 4x their measured mean cost from the admission price "
    "book, never below this floor", 250.0,
    Mutability.LOCAL, lambda v: v > 0,
)
METRICS_NS.option(
    "slo-freshness-max-staleness", float,
    "OLAP freshness SLO: committed writes the spillover CSR snapshot "
    "may trail before freshness burns at page rate "
    "(olap.spillover.staleness gauge)", 10_000.0,
    Mutability.LOCAL, lambda v: v > 0,
)
METRICS_NS.option(
    "slo-fast-windows", int,
    "history windows in the fast burn-rate window (reaction time)",
    3, Mutability.LOCAL, lambda v: v > 0,
)
METRICS_NS.option(
    "slo-slow-windows", int,
    "history windows in the slow burn-rate window (blip veto); alerts "
    "require BOTH windows past the threshold", 36,
    Mutability.LOCAL, lambda v: v > 0,
)
METRICS_NS.option(
    "slo-page-burn", float,
    "burn rate at which an SLO pages (error budget spent at this "
    "multiple of the sustainable rate; 14.4 = a 30-day budget in 2 "
    "days)", 14.4, Mutability.LOCAL, lambda v: v > 0,
)
METRICS_NS.option(
    "slo-ticket-burn", float,
    "burn rate at which an SLO opens a ticket-severity alert", 6.0,
    Mutability.LOCAL, lambda v: v > 0,
)
METRICS_NS.option(
    "fleet-retention", int,
    "merged fleet windows the federation retains (one window per "
    "federation-interval-s tick; observability/federation.py)", 360,
    Mutability.LOCAL, lambda v: v >= 1,
)
METRICS_NS.option(
    "fleet-outlier-metric", str,
    "timer whose per-replica windowed p99 the cross-replica outlier "
    "detector compares against the fleet median",
    "server.request.wall", Mutability.LOCAL,
)
METRICS_NS.option(
    "fleet-outlier-factor", float,
    "outlier threshold: a replica whose windowed p99 exceeds this "
    "multiple of the fleet median raises a replica_outlier flight "
    "event and burns the fleet_latency_outlier ticket budget", 3.0,
    Mutability.LOCAL, lambda v: v > 1.0,
)
METRICS_NS.option(
    "fleet-outlier-min-count", int,
    "minimum per-replica observations in a window before it joins the "
    "outlier comparison (small windows make noisy percentiles)", 20,
    Mutability.LOCAL, lambda v: v >= 1,
)
METRICS_NS.option(
    "structured-logging", bool,
    "emit one-line JSON log records (with ambient trace_id/span_id) to "
    "stderr from the server, retry guard, circuit breaker, and chaos "
    "sites (observability/logging.py; records always land in the "
    "in-process ring regardless)", False, Mutability.LOCAL,
)
# ---- continuous profiling plane (sampler, watchdog, bundles) ------------
METRICS_NS.option(
    "profile-enabled", bool,
    "run the always-on sampling profiler (observability/continuous.py "
    "SamplingProfiler): a daemon thread folds sys._current_frames() "
    "stacks into collapsed-stack flame windows sealed in lockstep with "
    "the metrics-history interval; self-measured overhead (wall AND "
    "CPU) is exported and gated <1% CPU in the saturation bench",
    True, Mutability.LOCAL,
)
METRICS_NS.option(
    "profile-hz", float,
    "sampling-profiler rate in passes per second (each pass costs one "
    "sys._current_frames() walk; 20 Hz keeps the self-measured CPU "
    "overhead well under the 1% gate)", 20.0,
    Mutability.LOCAL, lambda v: 0 < v <= 1000,
)
METRICS_NS.option(
    "profile-windows", int,
    "flame windows retained in the profiler ring (retention wall = "
    "this x history-interval-s when history drives the sealing)", 60,
    Mutability.LOCAL, lambda v: v > 0,
)
METRICS_NS.option(
    "bundle-dir", str,
    "directory for anomaly forensics bundles (flame windows + flight "
    "ring + timeseries tail + all-thread stacks + active requests), "
    "written tmp+rename atomic on SLO page / watchdog stall / "
    "unhandled server error; empty = bundles off", "",
    Mutability.LOCAL,
)
METRICS_NS.option(
    "bundle-retention", int,
    "forensics bundles kept on disk (oldest pruned first)", 8,
    Mutability.LOCAL, lambda v: v > 0,
)
METRICS_NS.option(
    "bundle-min-interval-s", float,
    "rate limit between bundle captures (an anomaly storm must not "
    "turn the forensics plane into its own I/O incident)", 30.0,
    Mutability.LOCAL, lambda v: v >= 0,
)
# ---- streaming telemetry bus (push transport) ---------------------------
METRICS_NS.option(
    "stream-depth", int,
    "per-subscriber queue depth on the telemetry bus "
    "(observability/stream.py): events past it DROP-OLDEST into the "
    "subscriber's dropped counter — a slow /watch client or push peer "
    "costs itself data, never stalls a producer (graphlint JG113)",
    256, Mutability.LOCAL, lambda v: v >= 1,
)
METRICS_NS.option(
    "stream-heartbeat-s", float,
    "default idle-gap heartbeat cadence on /watch sessions (the client "
    "may request its own, clamped to [0.2, 30]); heartbeats carry the "
    "subscriber's drop counter so a quiet stream and a dead peer are "
    "distinguishable", 5.0,
    Mutability.LOCAL, lambda v: 0.2 <= v <= 30.0,
)


# ---- overload defense: admission control, deadlines, retry budgets ------
DRIVER_NS = ConfigNamespace("driver", "remote driver client", ROOT)

SERVER_NS.option(
    "watchdog-enabled", bool,
    "run the runtime stall watchdog (observability/continuous.py "
    "StallWatchdog): scans instrumented-lock wait tables and "
    "registered progress sources (active requests, supersteps, CDC "
    "pulls) and flights stall/lock_convoy events carrying the owner's "
    "sampled stack — the runtime twin of graphlint's static lock "
    "rules", True, Mutability.LOCAL,
)
SERVER_NS.option(
    "watchdog-interval-s", float,
    "seconds between watchdog scan passes", 1.0,
    Mutability.LOCAL, lambda v: v > 0,
)
SERVER_NS.option(
    "watchdog-stall-s", float,
    "waiting/no-progress threshold past which the watchdog flights a "
    "stall or lock_convoy event (edge-triggered per episode) and "
    "captures a forensics bundle", 5.0,
    Mutability.LOCAL, lambda v: v > 0,
)
SERVER_NS.option(
    "admission.enabled", bool,
    "cost-aware admission control in front of every query request "
    "(server/admission.py AdmissionController: adaptive AIMD concurrency "
    "limit, bounded cost-priority wait queue, load shedding with "
    "Retry-After, brownout ladder); observability endpoints always "
    "bypass it", True, Mutability.LOCAL,
)
SERVER_NS.option(
    "admission.initial-limit", int,
    "starting concurrent-request limit of the AIMD controller", 8,
    Mutability.LOCAL, lambda v: v > 0,
)
SERVER_NS.option(
    "admission.min-limit", int,
    "floor the multiplicative decrease never drops the limit below", 1,
    Mutability.LOCAL, lambda v: v > 0,
)
SERVER_NS.option(
    "admission.max-limit", int,
    "ceiling the additive increase never raises the limit above", 64,
    Mutability.LOCAL, lambda v: v > 0,
)
SERVER_NS.option(
    "admission.queue-bound", int,
    "bounded wait-queue depth; arrivals past it are shed with "
    "429/503 + Retry-After (decorrelated jitter)", 32,
    Mutability.LOCAL, lambda v: v >= 0,
)
SERVER_NS.option(
    "admission.window", int,
    "completed requests per AIMD decision window (the window's median "
    "latency is compared against the baseline)", 32,
    Mutability.LOCAL, lambda v: v > 0,
)
SERVER_NS.option(
    "admission.latency-threshold", float,
    "multiplicative-decrease trigger: window median latency above "
    "threshold x baseline shrinks the limit; below it the limit grows "
    "by one", 2.0, Mutability.LOCAL, lambda v: v > 1.0,
)
SERVER_NS.option(
    "admission.default-cost-ms", float,
    "wait-queue price of a query shape the digest price book has not "
    "measured yet (unknown shapes are assumed mid-priced, not free)",
    25.0, Mutability.LOCAL, lambda v: v > 0,
)
SERVER_NS.option(
    "admission.cheap-cost-ms", float,
    "known-cheap threshold: under brownout rung 3 only digests with a "
    "measured mean cost at or below this are admitted", 5.0,
    Mutability.LOCAL, lambda v: v > 0,
)
SERVER_NS.option(
    "admission.brownout-window-s", float,
    "sliding window over shed events that drives brownout escalation",
    5.0, Mutability.LOCAL, lambda v: v > 0,
)
SERVER_NS.option(
    "admission.brownout-enter-sheds", int,
    "sheds within the brownout window that escalate the ladder one rung "
    "(1: shed span retention, 2: refuse OLAP submits, 3: admit only "
    "known-cheap digests)", 8, Mutability.LOCAL, lambda v: v > 0,
)
SERVER_NS.option(
    "admission.brownout-exit-s", float,
    "shed-free time that de-escalates the ladder one rung (hysteresis: "
    "exiting is deliberately slower than entering)", 10.0,
    Mutability.LOCAL, lambda v: v > 0,
)
SERVER_NS.option(
    "admission.brownout-dwell-s", float,
    "minimum time between rung transitions in either direction (keeps "
    "the ladder from flapping)", 2.0, Mutability.LOCAL, lambda v: v >= 0,
)
SERVER_NS.option(
    "admission.retry-after-base-s", float,
    "base of the decorrelated-jitter Retry-After hint on shed "
    "responses", 0.25, Mutability.LOCAL, lambda v: v > 0,
)
SERVER_NS.option(
    "admission.retry-after-max-s", float,
    "ceiling of the decorrelated-jitter Retry-After hint", 8.0,
    Mutability.LOCAL, lambda v: v > 0,
)
SERVER_NS.option(
    "fleet.replica-name", str,
    "this replica's fleet identity: rides /healthz, flight events, "
    "structured logs, and /metrics (janusgraph_replica_info) so "
    "cross-replica incident timelines merge by replica "
    "(observability/identity.py; '' = untagged single process)", "",
    Mutability.LOCAL,
)
SERVER_NS.option(
    "fleet.replicas", int,
    "replica count the `janusgraph_tpu fleet` runner starts over ONE "
    "shared storage backend (server/fleet.py)", 3,
    Mutability.LOCAL, lambda v: v >= 1,
)
SERVER_NS.option(
    "fleet.vnodes", int,
    "virtual nodes per replica on the router's consistent-hash ring — "
    "more vnodes = smoother key spread, slightly larger ring", 16,
    Mutability.LOCAL, lambda v: v >= 1,
)
SERVER_NS.option(
    "fleet.candidates", int,
    "ring candidates the router least-loaded-tie-breaks between "
    "(power-of-two-choices over the consistent hash; 1 = pure hash)",
    2, Mutability.LOCAL, lambda v: v >= 1,
)
SERVER_NS.option(
    "fleet.probe-interval-s", float,
    "per-replica /healthz probe cadence of the fleet router", 1.0,
    Mutability.LOCAL, lambda v: v > 0,
)
SERVER_NS.option(
    "fleet.probe-timeout-s", float,
    "socket timeout on every router probe / gossip hop (JG208: a dead "
    "replica costs one bounded wait, never a hung prober)", 2.0,
    Mutability.LOCAL, lambda v: v > 0,
)
SERVER_NS.option(
    "fleet.gossip-interval-s", float,
    "push-pull state-gossip cadence (price-book records + brownout "
    "rung to fanout peers per round; server/fleet.StateGossip)", 2.0,
    Mutability.LOCAL, lambda v: v > 0,
)
SERVER_NS.option(
    "fleet.gossip-fanout", int,
    "peers contacted per gossip round — on a full mesh of N a new fact "
    "reaches everyone within ceil((N-1)/fanout) push rounds", 2,
    Mutability.LOCAL, lambda v: v >= 1,
)
SERVER_NS.option(
    "fleet.drain-timeout-s", float,
    "graceful-drain wait for in-flight sessions to finish before the "
    "replica retires anyway (sessions still open after it are handed "
    "off as failed-over, not lost silently)", 10.0,
    Mutability.LOCAL, lambda v: v > 0,
)
SERVER_NS.option(
    "fleet.warmup-dir", str,
    "shard-checkpoint directory a joining replica hydrates its "
    "snapshot-CSR cache from (server/fleet.warm_replica; '' = cold "
    "start, or the computer.delta-snapshot-path pack as fallback)", "",
    Mutability.LOCAL,
)
SERVER_NS.option(
    "fleet.follower-pull-interval-s", float,
    "cadence at which a follower replica pulls delta records from the "
    "leader's durable CDC log (server/fleet.CDCFollower); each pull "
    "folds the netted batches through materialize, O(delta)", 0.5,
    Mutability.LOCAL, lambda v: v > 0,
)
SERVER_NS.option(
    "fleet.follower-max-staleness-ms", float,
    "priced staleness bound for follower reads (the PR 13 SLO "
    "freshness spec's ceiling): past it the follower's /healthz "
    "reports degraded and the router stops preferring it for "
    "staleness-hinted requests", 10_000.0,
    Mutability.LOCAL, lambda v: v > 0,
)
SERVER_NS.option(
    "fleet.trend-windows", int,
    "per-replica goodput windows the router fetches from /timeseries "
    "to slope-sharpen its least-loaded tie-break (0 = off: plain "
    "occupancy ordering, the PR 15 behaviour)", 8,
    Mutability.LOCAL, lambda v: v >= 0,
)
SERVER_NS.option(
    "fleet.federation-enabled", bool,
    "run the fleet observability federation on the frontend: scrape "
    "every replica's /timeseries?raw=1 each interval, serve merged "
    "/fleet/timeseries + /fleet/metrics + /fleet/incident, evaluate "
    "fleet-level SLOs (observability/federation.py)", True,
    Mutability.LOCAL,
)
SERVER_NS.option(
    "fleet.federation-interval-s", float,
    "federation scrape cadence — each tick merges one fleet window "
    "(counters sum, gauges keyed per replica, histogram buckets add) "
    "and doubles as the clock-offset probe", 2.0,
    Mutability.LOCAL, lambda v: v > 0,
)
SERVER_NS.option(
    "fleet.federation-timeout-s", float,
    "socket timeout per federation scrape target (JG208: a dead "
    "replica costs one bounded wait and a partial:true window, never "
    "a hung scraper)", 2.0,
    Mutability.LOCAL, lambda v: v > 0,
)
SERVER_NS.option(
    "fleet.push-enabled", bool,
    "negotiate the push-mode federation transport: replicas whose "
    "/watch/info advertises the capability stream sealed windows and "
    "flight events over a /watch subscription instead of being "
    "scraped each tick; peers without it keep the exact poll-mode "
    "scrape path byte-compatibly (observability/federation.py)",
    True, Mutability.LOCAL,
)
SERVER_NS.option(
    "fleet.push-ship-bundles", bool,
    "fetch forensics bundles announced on a pushed replica's bundle "
    "stream into the frontend's fleet store, so a replica's evidence "
    "survives its death (served at /fleet/bundles)", True,
    Mutability.LOCAL,
)
SERVER_NS.option(
    "fleet.push-bundle-retention", int,
    "shipped bundles the frontend's fleet store retains fleet-wide "
    "(oldest dropped first)", 16,
    Mutability.LOCAL, lambda v: v >= 1,
)
SERVER_NS.option(
    "fleet.push-bundle-min-interval-s", float,
    "per-replica rate bound between off-host bundle fetches (a bundle "
    "storm on one replica must not monopolize the frontend)", 5.0,
    Mutability.LOCAL, lambda v: v >= 0,
)
SERVER_NS.option(
    "deadline.propagation", bool,
    "forward the ambient request deadline's remaining budget on "
    "remote-store/index op frames (gated on the peer's negotiated "
    "feature bit, so mixed old/new deployments stay wire-compatible; "
    "read at graph open into RemoteStoreManager/RemoteIndexProvider)",
    True, Mutability.MASKABLE,
)
SERVER_NS.option(
    "deadline.default-ms", float,
    "deadline applied to a request whose client sent no X-Deadline-Ms "
    "header / WS deadline field (0 = derive from server.request-"
    "timeout-s; read in server/server.py)", 0.0,
    Mutability.LOCAL, lambda v: v >= 0,
)
SERVER_NS.option(
    "deadline.max-ms", float,
    "clamp on client-supplied deadlines — a client cannot buy more "
    "server time than the operator allows (0 = no clamp)", 600_000.0,
    Mutability.LOCAL, lambda v: v >= 0,
)
DRIVER_NS.option(
    "retry-budget-capacity", float,
    "token-bucket capacity of the driver's per-connection retry budget: "
    "each retry of a shed (429/503) response spends one token, so "
    "client retries cannot stampede a recovering server (0 = never "
    "retry; read in driver/client.py)", 8.0,
    Mutability.LOCAL, lambda v: v >= 0,
)
DRIVER_NS.option(
    "retry-budget-refill-per-s", float,
    "token refill rate of the driver retry budget", 0.5,
    Mutability.LOCAL, lambda v: v >= 0,
)
DRIVER_NS.option(
    "failover-retry-budget-capacity", float,
    "token-bucket capacity of the fleet router's retry-elsewhere budget "
    "(server/fleet.FleetRouter): each re-route of a shed/draining/dead "
    "replica spends one token, so a fleet-wide incident cannot multiply "
    "into a retry stampede against the survivors (0 = never re-route)",
    16.0, Mutability.LOCAL, lambda v: v >= 0,
)
DRIVER_NS.option(
    "failover-retry-budget-refill-per-s", float,
    "token refill rate of the fleet failover budget", 2.0,
    Mutability.LOCAL, lambda v: v >= 0,
)
DRIVER_NS.option(
    "failover-backoff-base-s", float,
    "base of the jittered backoff slept before retrying a request on "
    "another replica (decorrelated like the shed Retry-After)", 0.02,
    Mutability.LOCAL, lambda v: v > 0,
)
DRIVER_NS.option(
    "failover-backoff-max-s", float,
    "ceiling of the fleet failover backoff", 0.5,
    Mutability.LOCAL, lambda v: v > 0,
)
DRIVER_NS.option(
    "ws-multiplex", bool,
    "multiplex concurrent submits over one WebSocket connection: each "
    "request carries a client-assigned id echoed in its response, so "
    "many in-flight queries share the socket and complete out of order "
    "(JanusGraphClient.ws; degrades to serial round-trips against an "
    "old server that does not echo ids)", True, Mutability.LOCAL,
)
STORAGE.option(
    "faults.overload-at", int,
    "data-plane read index at which an injected latency STORM begins "
    "(-1 = off): the next faults.overload-ops reads each stall "
    "faults.overload-latency-ms — the seeded saturation scenario the "
    "admission controller is tested against", -1,
    Mutability.LOCAL, lambda v: v >= -1,
)
STORAGE.option(
    "faults.overload-ops", int,
    "reads the overload storm covers once it begins", 0,
    Mutability.LOCAL, lambda v: v >= 0,
)
STORAGE.option(
    "faults.overload-latency-ms", float,
    "per-read stall length inside the overload storm", 0.0,
    Mutability.LOCAL, lambda v: v >= 0,
)



def describe_options() -> str:
    """Render the registry as a config-reference table, the reference's
    rows: equal to the reference's text but for the default cells of the
    two defaults the port changes on purpose."""
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
    if opt is None:
        raise ConfigurationError(f"unknown configuration option: {path}")
    return opt


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
