"""The graph: open, wiring, ID assignment, schema persistence and the
commit — the port's copy of the part of ``janusgraph_tpu/core/graph.py``
that the stored-graph OLAP path, the transaction and the traversal run.

``open_graph(config, store_manager=None)`` opens a ``JanusGraphTPU`` over
the store manager that ``storage.backend`` names in the store-manager
table (``register_store_manager`` adds to it): "inmemory", "remote" and
"sharded" (see below) or "local", a persistent directory (``storage.directory``, ``storage.fsync``;
``storage/localstore.py``), whose files the JAX package reads and writes
too. ``store_manager`` overrides the table (e.g.
``InMemoryStoreManager.from_rows`` of a graph the JAX package wrote).
``drop_graph`` destroys a graph's storage and closes it. The graph holds
``config``, ``backend``, ``idm``, ``serializer``, ``edge_serializer``,
``system_types``, ``schema_cache`` and ``id_assigner`` (vertex, relation
and schema id pools), and offers ``management()``, ``new_transaction()``,
``traversal()``, ``compute()``, ``io()`` (GraphSON and GraphML,
``core/io.py``) and ``close()``. The serializer takes its pickle mode from
``attributes.allow-pickle`` ("auto": allowed unless the store manager is
network-attached). Data goes in through OLTP
transactions (``core/tx.py``, serialized by ``commit_tx`` under the
graph-wide commit lock into the reference's cells) and the columnar bulk
loader (``core/bulk.py``), and out through ``load_csr`` and
``ComputerResult.write_back``. With ``computer.delta`` (the default) every
committed edgestore batch also streams into the graph's ``ChangeCapture``
(``olap/delta.py``), which the warm delta snapshot behind ``submit()``
reads instead of the store.

The commit takes consistent-key locks on every cell it touches of a
LOCK-consistency type, verified with their expected values inside the
backend transaction's commit (``storage/locking.py``), and writes the
cells of a type or static vertex label with a TTL with their expiry
(stores with cell TTL only: ``set_ttl`` refuses others). The backend
reads through the slice cache (``cache.*``) and the retry guard
(``storage.retry-time-ms`` ...); ``storage.read-only`` refuses writes.

Telemetry at open, as the reference's: the tracer's slow-op threshold and
buffers, the flight recorder's ring and dump directory, the roofline peak
overrides and structured logging (``metrics.*``); with ``metrics.enabled``
the backend instruments its raw stores and the console and CSV reporters
start (``util/metrics.py``), stopped again by ``close()``.

``traversal()`` is the Gremlin entry point (``core/traversal.py``); with
``computer.spillover`` (the default, as the reference's) the graph holds a
``SpilloverPlanner`` that runs promoted hot multi-hop chains on the OLAP
engine (``olap/spillover.py``).

Indexes, as the reference's: composite indexes (rows in ``graphindex``,
``core/index.py``), mixed indexes (documents in an index provider,
``indexing/``: "memindex" or the "localindex" directory, opened once per
store manager and shared by every graph over it) and vertex-centric
relation indexes (copies of an edge under the index's type id). The
commit writes composite rows and checks unique keys under the commit lock
before the flush, and flushes mixed-index documents after the primary
store; ``index_lookup``, ``mixed_index_query``, ``index_query`` and
``index_totals`` read them.

The durable logs, as the reference's (``storage/log.py``,
``core/txlog.py``): each open registers its ``instance_id`` in the
instance registry (``graph.replace-instance-if-exists`` takes over a stale
one) and opens a ``LogManager`` over the store manager. With ``tx.log-tx``
(GLOBAL; ``management().set_config``) or a transaction's
``log_identifier`` the commit writes the WAL: PRECOMMIT with the change
records before the lock, PREFLUSH just before the flush, PRIMARY_SUCCESS
after it, then the user log ``ulog_<id>`` and SECONDARY_SUCCESS or
_FAILURE; nothing after the primary flush raises. At open, with the WAL on
and ``tx.recover-on-open``, ``TornCommitRecovery`` rolls a torn commit
forward (``replay_torn_changes``, ``restore_mixed_indexes``) or back
(``last_torn_recovery``). ``open_log_processor`` tails a user log,
``start_transaction_recovery`` heals failed secondaries, and a schema
change broadcasts its eviction on ``systemlog`` to every open instance
(``management_logger``). With ``storage.cdc.dir`` every batch of the
change capture is also appended to the durable CDC log (``cdc_log``,
``storage/cdc.py``).

"remote" opens a ``RemoteStoreManager`` (``storage/remote.py``) on
``storage.hostname`` and ``storage.port``, a storage server in another
process (``python -m janusgraph_tpu_torch storage-server``) or the
reference's; without both it raises ``ConfigurationError``. The id
authority claims under the ``ids.authority.conflict-avoidance-*`` mode and
tag, and new vertices take their partition from the ``ids.placement``
strategy (``core/placement.py``).

"sharded" opens a ``ShardedStoreManager`` (``storage/sharded_store.py``)
of ``storage.sharded-nodes`` in-memory nodes; it scans unordered, so
``load_csr`` and the input format take their unordered branch. With
``storage.faults.enabled`` the graph wraps whichever manager it opened
(any backend, "remote" and "sharded" included) in the seeded fault
injector (``storage/faults.py``) and holds its plan as ``fault_plan``:
the lockers read the plan's clock (the lease-expiry fault), the CDC log
its torn-write decision, and ``compute()`` passes its superstep hook to
the executor. ``index.search.backend = "remote"`` opens the remote index
provider (``indexing/remote.py``) on ``index.search.hostname`` and
``index.search.port``.
"""

from __future__ import annotations

import logging
import struct
import threading
import time
from typing import Dict, List, Optional

from janusgraph_tpu_torch.core.attributes import Serializer
from janusgraph_tpu_torch.core.codecs import (
    Cardinality,
    Consistency,
    Direction,
    EdgeSerializer,
)
from janusgraph_tpu_torch.core.config import (
    GraphConfiguration,
    InstanceRegistry,
    generate_instance_id,
)
from janusgraph_tpu_torch.core.ids import IDManager, VertexIDType
from janusgraph_tpu_torch.core.index import IndexSerializer
from janusgraph_tpu_torch.core.management import (
    INDEX_NAME_PREFIX,
    INDEX_REGISTRY_KEY,
    RELINDEX_REGISTRY_KEY,
    SCHEMA_NAME_INDEX_PREFIX,
    ManagementSystem,
)
from janusgraph_tpu_torch.core.schema import (
    EdgeLabel,
    IndexDefinition,
    PropertyKey,
    RelationIndex,
    SchemaCache,
    SystemTypes,
    decode_definition,
    encode_definition,
    schema_element_from_definition,
    VertexLabel,
)
from janusgraph_tpu_torch.core.tx import Transaction
from janusgraph_tpu_torch.core.elements import Edge, VertexProperty
from janusgraph_tpu_torch.exceptions import ConfigurationError, SchemaViolationError
from janusgraph_tpu_torch.storage.backend import Backend, GlobalConfigStore
from janusgraph_tpu_torch.storage.idauthority import (
    ConsistentKeyIDAuthority,
    StandardIDPool,
)
from janusgraph_tpu_torch.storage.inmemory import InMemoryStoreManager
from janusgraph_tpu_torch.storage.kcvs import KeyRangeQuery, KeySliceQuery, SliceQuery

_logger = logging.getLogger(__name__)

def _open_local(cfg):
    from janusgraph_tpu_torch.storage.localstore import open_local_kcvs

    directory = cfg.get("storage.directory")
    if not directory:
        raise ConfigurationError("storage.backend=local requires storage.directory")
    return open_local_kcvs(directory, fsync=cfg.get("storage.fsync"))


def _open_sharded(cfg):
    from janusgraph_tpu_torch.storage.sharded_store import ShardedStoreManager

    return ShardedStoreManager(num_nodes=cfg.get("storage.sharded-nodes"))


def _open_remote(cfg):
    from janusgraph_tpu_torch.storage.remote import RemoteStoreManager

    host = cfg.get("storage.hostname")
    port = cfg.get("storage.port")
    if not host or not port:
        raise ConfigurationError(
            "storage.backend=remote requires storage.hostname + storage.port"
        )
    return RemoteStoreManager(
        host,
        port,
        pool_size=cfg.get("storage.connection-pool-size"),
        retry_time_s=cfg.get("storage.retry-time-ms") / 1000.0,
        backoff_base_s=cfg.get("storage.backoff-base-ms") / 1000.0,
        backoff_max_s=cfg.get("storage.backoff-max-ms") / 1000.0,
        parallel_ops=cfg.get("storage.parallel-backend-ops"),
        connect_timeout_s=cfg.get("storage.remote.connect-timeout-ms") / 1000.0,
        max_attempts=cfg.get("storage.write-attempts"),
        parallel_slice_factor=cfg.get("storage.remote.parallel-slice-factor"),
        breaker_enabled=cfg.get("storage.breaker.enabled"),
        breaker_failure_threshold=cfg.get("storage.breaker.failure-threshold"),
        breaker_reset_ms=cfg.get("storage.breaker.reset-ms"),
        breaker_half_open_probes=cfg.get("storage.breaker.half-open-probes"),
        trace_propagation=cfg.get("metrics.trace-propagation"),
        resource_ledger=cfg.get("metrics.resource-ledger"),
        deadline_propagation=cfg.get("server.deadline.propagation"),
        pipeline=cfg.get("storage.remote.pipeline"),
        pipeline_connections=cfg.get("storage.remote.pipeline-connections"),
        pipeline_depth=cfg.get("storage.remote.pipeline-depth"),
        pipeline_max_batch=cfg.get("storage.remote.pipeline-max-batch"),
        pipeline_multi_chunk=cfg.get("storage.remote.pipeline-multi-chunk"),
        pipeline_stall_ms=cfg.get("storage.remote.pipeline-stall-ms"),
        pipeline_coalesce_us=cfg.get("storage.remote.pipeline-coalesce-us"),
    )


# reference: StandardStoreManager.java:82 shorthand registry. Factories take
# the GraphConfiguration.
_STORE_MANAGERS = {
    "inmemory": lambda cfg: InMemoryStoreManager(),
    "local": _open_local,
    "sharded": _open_sharded,
    "remote": _open_remote,
}


def register_store_manager(name: str, factory) -> None:
    """Register a storage adapter shorthand: ``factory(cfg)`` returns a
    store manager (reference: StandardStoreManager.java:82)."""
    _STORE_MANAGERS[name] = factory


def open_graph(config: Optional[dict] = None, store_manager=None) -> "JanusGraphTPU":
    """JanusGraphFactory.open equivalent."""
    return JanusGraphTPU(config, store_manager=store_manager)


def drop_graph(graph: "JanusGraphTPU") -> None:
    """DESTROY the graph's storage and close it (reference:
    JanusGraphFactory.drop). Irreversible. The store manager clears every
    store, the logs (``txlog``, ``systemlog``, the user logs) and the
    instance registry (a cell of ``system_properties``) with them; a local
    directory loses its ``store.wal`` and ``store.snapshot`` (nothing else
    of the directory is touched, a ``storage.cdc.dir`` neither). The
    mixed-index providers attached to the store manager are cleared too,
    so a re-open starts from nothing. The delta snapshot and the cached
    executors go with ``close()``.

    Storage is cleared BEFORE close(): the local backend's clear_storage
    reopens its WAL handle, and only the following close() releases it.
    The local store's files are then unlinked (the reference leaves a WAL
    that holds only the frames its close() appends)."""
    manager = graph.backend.manager
    providers = graph.index_providers
    try:
        manager.clear_storage()
        for provider in providers.values():
            try:
                provider.clear_storage()
            except NotImplementedError:
                pass
        providers.clear()
    finally:
        if graph._open:
            graph.close()
    kv = getattr(manager, "kv_manager", None)
    if hasattr(kv, "remove_files"):
        kv.remove_files()


class _MultiIndexTransaction:
    """Fans commit/rollback out to one IndexTransaction per provider."""

    def __init__(self, txs):
        self._txs = txs

    def has_mutations(self) -> bool:
        return any(t.has_mutations() for t in self._txs)

    def commit(self) -> None:
        for t in self._txs:
            t.commit()

    def rollback(self) -> None:
        for t in self._txs:
            t.rollback()


class VertexIDAssigner:
    """Maps new elements to IDs: the placement strategy's partition for
    normal vertices (round robin by default, ``core/placement.py``),
    canonical-partition ids for partitioned (vertex-cut) labels (reference:
    idassigner/VertexIDAssigner.java + placement strategies)."""

    def __init__(
        self,
        authority: ConsistentKeyIDAuthority,
        idm: IDManager,
        renew_fraction: Optional[float] = None,
        placement=None,
        renew_timeout_ms: float = 0.0,
    ):
        from janusgraph_tpu_torch.core.placement import SimpleBulkPlacementStrategy

        self.authority = authority
        self.idm = idm
        self.renew_fraction = renew_fraction  # ids.renew-percentage
        self.renew_timeout_ms = renew_timeout_ms  # ids.renew-timeout-ms
        self.placement = placement or SimpleBulkPlacementStrategy()
        self._vertex_pools: Dict[int, StandardIDPool] = {}
        self._relation_pool = StandardIDPool(
            authority, ConsistentKeyIDAuthority.NS_RELATION, 0,
            renew_fraction=renew_fraction, renew_timeout_ms=renew_timeout_ms,
        )
        self._schema_pool = StandardIDPool(
            authority, ConsistentKeyIDAuthority.NS_SCHEMA, 0,
            renew_fraction=renew_fraction, renew_timeout_ms=renew_timeout_ms,
        )
        self._rr = 0
        self._lock = threading.Lock()

    def _pool(self, partition: int) -> StandardIDPool:
        with self._lock:
            pool = self._vertex_pools.get(partition)
            if pool is None:
                pool = StandardIDPool(
                    self.authority, ConsistentKeyIDAuthority.NS_VERTEX, partition,
                    renew_fraction=self.renew_fraction,
                    renew_timeout_ms=self.renew_timeout_ms,
                )
                self._vertex_pools[partition] = pool
            return pool

    def assign_vertex_id(
        self,
        partitioned: bool = False,
        label=None,
        props: Optional[dict] = None,
    ) -> int:
        with self._lock:
            partition = self.placement.partition_for(
                label, props, self.idm.num_partitions
            )
            if partition is None:
                partition = self._rr % self.idm.num_partitions
                self._rr += 1
        count = self._pool(partition).next_id()
        if partitioned:
            canonical = count % self.idm.num_partitions
            return self.idm.make_vertex_id(
                count, canonical, VertexIDType.PARTITIONED
            )
        return self.idm.make_vertex_id(count, partition)

    def assign_relation_id(self) -> int:
        return self.idm.make_relation_id(self._relation_pool.next_id())

    def assign_relation_ids(self, count: int):
        """Bulk relation-id spans for columnar writers: [(start, len), ...]."""
        return self._relation_pool.next_ids(count)

    def assign_schema_id(self, id_type: VertexIDType) -> int:
        return self.idm.make_schema_id(id_type, self._schema_pool.next_id())


class JanusGraphTPU:
    def __init__(self, config: Optional[dict] = None, store_manager=None):
        self.config = GraphConfiguration(dict(config or {}))
        cfg = self.config
        if store_manager is None:
            backend_name = cfg.get("storage.backend")
            factory = _STORE_MANAGERS.get(backend_name)
            if factory is None:
                raise ConfigurationError(f"unknown storage backend {backend_name!r}")
            store_manager = factory(cfg)
        # the chaos engine (storage.faults.*): the seeded fault injector
        # wraps the data-plane stores of whatever manager the graph opened;
        # the plan rides on the graph so the OLAP computer, the lockers and
        # the CDC log consult it too
        self.fault_plan = None
        if cfg.get("storage.faults.enabled"):
            from janusgraph_tpu_torch.storage.faults import (
                FaultInjectingStoreManager,
                FaultPlan,
            )

            self.fault_plan = FaultPlan.from_config(cfg)
            store_manager = FaultInjectingStoreManager(store_manager, self.fault_plan)
        pickle_mode = cfg.get("attributes.allow-pickle")
        if pickle_mode == "auto":
            # a network-attached KCVS store is a trust boundary: any
            # co-writer could plant a pickle frame that executes on read,
            # so auto disables object-pickle payloads there (asked of the
            # resolved store manager, as the reference does)
            allow_pickle = not store_manager.features.network_attached
        else:
            allow_pickle = pickle_mode == "true"
        self.serializer = Serializer(allow_pickle=allow_pickle)
        # reconcile cluster-global options BEFORE building the backend so
        # stored GLOBAL/FIXED values govern its construction
        cfg.attach_backend(GlobalConfigStore(
            store_manager, read_only=cfg.get("storage.read-only")
        ))
        ttl_ms = cfg.get("cache.db-cache-time-ms")
        self.backend = Backend(
            store_manager,
            cache_enabled=cfg.get("cache.db-cache"),
            cache_size=cfg.get("cache.db-cache-size"),
            id_block_size=cfg.get("ids.block-size"),
            id_conflict_mode=cfg.get("ids.authority.conflict-avoidance-mode"),
            id_conflict_tag=cfg.get("ids.authority.conflict-avoidance-tag"),
            id_conflict_tag_bits=cfg.get("ids.authority.conflict-avoidance-tag-bits"),
            id_max_retries=cfg.get("ids.authority.max-retries"),
            cache_clean_wait_seconds=cfg.get("cache.db-cache-clean-wait-ms") / 1000.0,
            read_only=cfg.get("storage.read-only"),
            cache_ttl_seconds=(ttl_ms / 1000.0) if ttl_ms > 0 else None,
            metrics_enabled=cfg.get("metrics.enabled"),
            metrics_merge_stores=cfg.get("metrics.merge-stores"),
            edgestore_cache_fraction=cfg.get("cache.edgestore-fraction"),
            retry_time_s=cfg.get("storage.retry-time-ms") / 1000.0,
            backoff_base_s=cfg.get("storage.backoff-base-ms") / 1000.0,
            backoff_max_s=cfg.get("storage.backoff-max-ms") / 1000.0,
            retry_attempts=cfg.get("storage.write-attempts"),
        )
        self.idm = IDManager(partition_bits=cfg.get("ids.partition-bits"))
        self.edge_serializer = EdgeSerializer(self.serializer, self.idm)
        self.system_types = SystemTypes(self.idm)
        self.instance_id = cfg.get("graph.unique-instance-id") or generate_instance_id(
            suffix=cfg.get("graph.unique-instance-id-suffix"),
            use_hostname=cfg.get("graph.use-hostname-for-unique-instance-id"),
        )
        self.backend.id_authority.wait_ms = cfg.get("ids.authority-wait-ms")
        self.backend.configure_lockers(
            wait_ms=cfg.get("locks.wait-ms"),
            expiry_ms=cfg.get("locks.expiry-ms"),
            retries=cfg.get("locks.retries"),
            clean_expired=cfg.get("locks.clean-expired"),
        )
        if self.fault_plan is not None:
            # lease-expiry fault: the scheduled lock check reads a skewed
            # clock, so the holder's claim looks expired
            for locker in (self.backend.edge_locker, self.backend.index_locker):
                locker.clock_ns = self.fault_plan.lock_clock_ns
        from janusgraph_tpu_torch.core.placement import make_placement_strategy

        self.id_assigner = VertexIDAssigner(
            self.backend.id_authority, self.idm,
            renew_fraction=cfg.get("ids.renew-percentage"),
            renew_timeout_ms=cfg.get("ids.renew-timeout-ms"),
            placement=make_placement_strategy(
                cfg.get("ids.placement"), cfg.get("ids.placement-key")
            ),
        )
        self.index_serializer = IndexSerializer(self.serializer)
        # mixed-index providers: shared per store manager, standing in for
        # the external index services' durability across a graph's reopen
        # (reference: Backend.java:167 Map<String,IndexProvider>)
        from janusgraph_tpu_torch.indexing import open_index_provider

        shared = getattr(store_manager, "_shared_index_providers", None)
        if shared is None:
            shared = {}
            store_manager._shared_index_providers = shared
        if "search" not in shared:
            shared["search"] = open_index_provider(
                cfg.get("index.search.backend"),
                directory=cfg.get("index.search.directory"),
                hostname=cfg.get("index.search.hostname"),
                port=cfg.get("index.search.port"),
                fsync=cfg.get("index.search.fsync"),
                pool_size=cfg.get("index.search.pool-size"),
                retry_time_s=cfg.get("index.search.retry-time-ms") / 1000.0,
                scroll_page_size=cfg.get("index.search.scroll-page-size"),
                breaker_enabled=cfg.get("storage.breaker.enabled"),
                breaker_failure_threshold=cfg.get("storage.breaker.failure-threshold"),
                breaker_reset_ms=cfg.get("storage.breaker.reset-ms"),
                breaker_half_open_probes=cfg.get("storage.breaker.half-open-probes"),
                trace_propagation=cfg.get("metrics.trace-propagation"),
                resource_ledger=cfg.get("metrics.resource-ledger"),
                deadline_propagation=cfg.get("server.deadline.propagation"),
                pipeline=cfg.get("index.search.pipeline"),
            )
        self.index_providers: Dict[str, object] = shared
        # {index_name: {field: KeyInformation}} for provider.mutate calls
        self._mixed_key_infos: Dict[str, Dict[str, object]] = {}
        self.schema_cache = SchemaCache(
            self._load_schema_by_name, self._load_schema_by_id
        )
        self.auto_schema = cfg.get("schema.default") == "auto"
        # cached: read on every property and edge write (GLOBAL_OFFLINE, so
        # immutable while the graph is open)
        self.schema_constraints = bool(cfg.get("schema.constraints"))
        #: serializes the schema fields' read-modify-writes (auto-created
        #: constraints arrive from concurrent writer transactions)
        self._schema_rmw_lock = threading.Lock()
        self.indexes: Dict[str, IndexDefinition] = {}
        #: {edge label id: (RelationIndex, ...)} and the indexes' type ids
        self.relation_indexes: Dict[int, tuple] = {}
        self.relation_index_ids = frozenset()
        #: commits are serialized graph-wide (reference: commit_tx)
        self._commit_lock = threading.Lock()
        #: the index registry's reload (also from the management log's
        #: reader thread) and registrations are serialized, so a reload that
        #: read the registry before a new index cannot overwrite it
        self._index_registry_lock = threading.RLock()
        self._load_index_registry()
        # delta-CSR change capture (computer.delta; olap/delta.py): every
        # committed edgestore batch streams into a bounded ring, so the
        # warm snapshot behind submit() refreshes from the records alone
        self.change_capture = None
        self._delta_snapshot = None
        if cfg.get("computer.delta"):
            from janusgraph_tpu_torch.olap.delta import ChangeCapture

            self.change_capture = ChangeCapture(
                self, limit=cfg.get("computer.delta-capture-limit")
            )
            self.backend.register_change_capture(self.change_capture.on_commit)
        # the durable CDC log (storage.cdc.dir; storage/cdc.py): every
        # decoded capture batch also appends to a segmented on-disk log
        self.cdc_log = None
        if self.change_capture is not None and cfg.get("storage.cdc.dir"):
            from janusgraph_tpu_torch.storage.cdc import CDCLog

            self.cdc_log = CDCLog(
                cfg.get("storage.cdc.dir"),
                segment_records=cfg.get("storage.cdc.segment-records"),
                retention_segments=cfg.get("storage.cdc.retention-segments"),
                fault_plan=self.fault_plan,
            )
            self.change_capture.add_sink(self.cdc_log.append)
        # resolved ONCE at open: these sit on the traversal's hottest paths
        self._slow_query_threshold_ms = cfg.get("metrics.slow-query-threshold-ms")
        self._query_batch = cfg.get("query.batch")
        self._max_traversers = cfg.get("query.max-traversers")
        self._configure_telemetry()
        # OLTP->OLAP spillover planner (computer.spillover; olap/
        # spillover.py): promoted hot multi-hop traversal shapes run as an
        # OLAPTraversalProgram over a cached CSR snapshot
        self.spillover_planner = None
        if cfg.get("computer.spillover"):
            from janusgraph_tpu_torch.olap.spillover import SpilloverPlanner

            self.spillover_planner = SpilloverPlanner(self)
        self._open_logs(store_manager)

    def _open_logs(self, store_manager) -> None:
        """The instance registry, the log bus, the management logger's
        reader and torn-commit recovery (reference: StandardJanusGraph's
        open, Backend.java:267,312,316). A failure closes what it opened."""
        from janusgraph_tpu_torch.storage.log import LogManager
        from janusgraph_tpu_torch.util.timestamps import TimestampProviders

        cfg = self.config
        self.instance_registry = InstanceRegistry(self.backend)
        self._registered = False
        if not self.backend.read_only:
            if cfg.get("graph.replace-instance-if-exists"):
                # take over a stale registration instead of refusing to open
                self.instance_registry.deregister(self.instance_id)
            self.instance_registry.register(self.instance_id)
            self._registered = True
        self.log_manager = LogManager(
            store_manager,
            sender=self.backend.rid,
            timestamps=TimestampProviders.of(cfg.get("graph.timestamps")),
            read_lag_ms=cfg.get("log.read-lag-ms"),
            read_only=cfg.get("storage.read-only"),
            num_buckets=cfg.get("log.num-buckets"),
            send_batch_size=cfg.get("log.send-batch-size"),
            read_interval_ms=cfg.get("log.read-interval-ms"),
            send_delay_ms=cfg.get("log.send-delay-ms"),
            ttl_seconds=cfg.get("log.ttl-seconds"),
            slice_granularity_ms=cfg.get("log.slice-granularity-ms"),
        )
        self._tx_log = None
        self._mgmt_logger = None
        self._tx_log_lock = threading.Lock()
        #: tx.log-tx, resolved at open and on this instance's set_config
        #: (a GLOBAL read goes to the store)
        self._wal_enabled = bool(cfg.get("tx.log-tx"))
        self._open = True
        self.last_torn_recovery = None
        try:
            # the schema-eviction broadcast's reader, registered from now
            # (reference: StandardJanusGraph.java:187-189)
            _ = self.management_logger
            # torn-commit recovery: roll forward or back the txlog entries a
            # crashed instance left in PREFLUSH or PRECOMMIT state
            if (
                self._wal_enabled
                and cfg.get("tx.recover-on-open")
                and not self.backend.read_only
            ):
                from janusgraph_tpu_torch.core.txlog import TornCommitRecovery

                self.last_torn_recovery = TornCommitRecovery(self).run()
            # the multi-process run from the cluster.* options (the
            # environment wins inside init_multihost); a single-process
            # open never touches torch.distributed
            if cfg.get("cluster.num-processes") > 1:
                from janusgraph_tpu_torch.parallel.multihost import init_multihost

                init_multihost(config=cfg)
        except BaseException:
            self.close()
            raise

    def _configure_telemetry(self) -> None:
        """Apply the metrics.* options to the process-wide tracer, flight
        recorder, roofline peaks, digest table (with its price book), the
        server's history, profiler, watchdog, bundles and telemetry bus, and
        the logger; with metrics.enabled, start the periodic reporters
        (last: an open that fails leaks no thread)."""
        from janusgraph_tpu_torch.observability import flight_recorder, profiler, tracer

        cfg = self.config
        tracer.configure(
            slow_threshold_ms=cfg.get("metrics.slow-op-threshold-ms"),
            max_roots=cfg.get("metrics.span-buffer"),
            slow_buffer=cfg.get("metrics.slow-op-buffer"),
        )
        flight_recorder.configure(
            capacity=cfg.get("metrics.flight-buffer"),
            dump_dir=cfg.get("metrics.flight-dump-dir"),
        )
        profiler.configure_roofline(
            peak_flops=cfg.get("metrics.roofline-peak-flops"),
            peak_bytes_per_s=cfg.get("metrics.roofline-peak-bytes-per-s"),
            peak_mxu_flops=cfg.get("metrics.roofline-peak-mxu-flops"),
        )
        profiler.digest_table.configure(capacity=cfg.get("metrics.digest-top-k"))
        # the plane the query server reads is only sized here: the history
        # sampler, the profiler and the watchdog threads are the server's
        # (JanusGraphServer.start), and the telemetry bus taps its sources
        # on the first subscribe
        from janusgraph_tpu_torch.observability import (
            bundle_writer,
            history,
            sampling_profiler,
            telemetry_bus,
            watchdog,
        )

        history.configure(
            capacity=cfg.get("metrics.history-retention"),
            interval_s=cfg.get("metrics.history-interval-s"),
        )
        sampling_profiler.configure(
            hz=cfg.get("metrics.profile-hz"),
            max_windows=cfg.get("metrics.profile-windows"),
        )
        watchdog.configure(
            interval_s=cfg.get("server.watchdog-interval-s"),
            stall_s=cfg.get("server.watchdog-stall-s"),
        )
        bundle_writer.configure(
            directory=cfg.get("metrics.bundle-dir"),
            retention=cfg.get("metrics.bundle-retention"),
            min_interval_s=cfg.get("metrics.bundle-min-interval-s"),
        )
        telemetry_bus.configure(depth=cfg.get("metrics.stream-depth"))
        # the price book (computer.price-book-path, else next to the
        # checkpoints): warm-start the traversal's shape table so the
        # spillover's promotion and the server's pricing survive restarts
        self._price_book_path = cfg.get("computer.price-book-path") or (
            cfg.get("computer.checkpoint-path") + ".pricebook.json"
            if cfg.get("computer.checkpoint-path")
            else ""
        )
        if self._price_book_path:
            profiler.restore_digest_records(
                profiler.digest_table,
                profiler.load_price_book(self._price_book_path).get("oltp"),
            )
        if cfg.get("metrics.structured-logging"):
            import sys

            from janusgraph_tpu_torch.observability import logging as slog

            slog.configure(stream=sys.stderr)
        self._metric_reporters = []
        if cfg.get("metrics.enabled"):
            from janusgraph_tpu_torch.util.metrics import PeriodicReporter, metrics

            prefix = cfg.get("metrics.prefix")
            if cfg.get("metrics.console-interval-ms") > 0:
                self._metric_reporters.append(PeriodicReporter(
                    metrics, cfg.get("metrics.console-interval-ms"), "console", prefix=prefix,
                ).start())
            if cfg.get("metrics.csv-interval-ms") > 0:
                self._metric_reporters.append(PeriodicReporter(
                    metrics, cfg.get("metrics.csv-interval-ms"), "csv",
                    directory=cfg.get("metrics.csv-directory"), prefix=prefix,
                ).start())

    # ------------------------------------------------------------- lifecycle
    def management(self) -> ManagementSystem:
        return ManagementSystem(self)

    def io(self, format: str = "graphson"):
        """TinkerPop-style io facade (reference: graph.io(IoCore.graphml())
        .writeGraph(path)): ``graph.io("graphml").write(path)`` /
        ``.read(path)``. Formats: graphson (typed, schema-carrying,
        line-delimited) | graphml (TinkerPop XML, primitives only)."""
        from janusgraph_tpu_torch.core import io as _io_mod

        try:
            writer = getattr(_io_mod, f"export_{format}")
            reader = getattr(_io_mod, f"import_{format}")
        except AttributeError:
            raise ConfigurationError(
                f"unknown io format {format!r} (graphson|graphml)"
            )

        class _Io:
            def write(self, path_or_file, _g=self):
                return writer(_g, path_or_file)

            def read(self, path_or_file, _g=self, **kw):
                return reader(_g, path_or_file, **kw)

        return _Io()

    def new_transaction(
        self,
        read_only: Optional[bool] = None,
        log_identifier: Optional[str] = None,
        metrics_group: Optional[str] = None,
    ) -> Transaction:
        """An OLTP transaction. ``read_only`` defaults to
        tx.read-only-default; ``metrics_group`` counts its commits as
        ``<group>.commit``; ``log_identifier`` names the user log
        (``ulog_<id>``) the commit writes its changes to, through the WAL."""
        if read_only is None:
            read_only = self.config.get("tx.read-only-default")
        return Transaction(
            self,
            read_only=read_only,
            log_identifier=log_identifier,
            metrics_group=metrics_group,
        )

    def get_or_create_vertex_label(self, name: str) -> VertexLabel:
        el = self.schema_cache.get_by_name(name)
        if isinstance(el, VertexLabel):
            return el
        if el is not None:
            raise SchemaViolationError(f"{name} exists and is not a vertex label")
        if not self.auto_schema and name != "vertex":
            raise SchemaViolationError(f"undefined vertex label: {name}")
        return self.management().make_vertex_label(name)

    def evict_schema_element(self, sid: int) -> None:
        """Drop a schema element from every cache layer of this instance
        and reload the index registry: the management log's receiver (a
        schema change broadcasts it to every open instance) and the
        changing instance's own eviction."""
        self.schema_cache.invalidate_id(sid)
        self.backend.clear_caches()
        self._load_index_registry()

    def schema_changed(self, sid: int) -> None:
        """A schema element changed: evict it here, then broadcast the
        eviction to every open instance over the management log
        (reference: ManagementLogger.java:287)."""
        self.evict_schema_element(sid)
        self.management_logger.broadcast_eviction(sid)

    # --------------------------------------------------------------- the logs
    @property
    def tx_log(self):
        from janusgraph_tpu_torch.core.txlog import TransactionLog

        with self._tx_log_lock:
            if self._tx_log is None:
                self._tx_log = TransactionLog(self.log_manager.open_log("txlog"))
            return self._tx_log

    @property
    def management_logger(self):
        from janusgraph_tpu_torch.core.txlog import ManagementLogger

        with self._tx_log_lock:
            if self._mgmt_logger is None:
                self._mgmt_logger = ManagementLogger(self)
            return self._mgmt_logger

    def open_log_processor(self, identifier: str):
        """Tail the user log ``ulog_<identifier>`` (reference:
        JanusGraphFactory.openTransactionLog → LogProcessorFramework)."""
        from janusgraph_tpu_torch.core.txlog import LogProcessorFramework

        return LogProcessorFramework(self, identifier)

    def start_transaction_recovery(self, start_ns: int = 0):
        """Heal transactions whose secondary persistence failed (reference:
        JanusGraphFactory.startTransactionRecovery)."""
        from janusgraph_tpu_torch.core.txlog import TransactionRecovery

        return TransactionRecovery(self, start_ns)

    def _on_global_config_change(self, path: str, value) -> None:
        """Refresh the GLOBAL options resolved at open when this instance
        changes them (other instances read the stored value at reopen)."""
        if path == "tx.log-tx":
            self._wal_enabled = bool(value)

    def traversal(self):
        """The Gremlin entry point: ``g = graph.traversal()``, then
        ``g.V()...`` (``core/traversal.py``)."""
        from janusgraph_tpu_torch.core.traversal import GraphTraversalSource

        return GraphTraversalSource(self)

    def compute(self, executor: str = None, mesh=None):
        """OLAP entry point (reference: JanusGraph.compute()). Defaults the
        executor to the computer.executor config option: "tpu", the card;
        "cpu", the plain versions on the CPU; "sharded", the sharded
        executor over ``mesh`` (default: one slot per visible card)."""
        from janusgraph_tpu_torch.olap.computer import GraphComputer

        return GraphComputer(self, executor=executor, mesh=mesh)

    def close(self) -> None:
        """Deregister the instance, close the logs, the CDC log and the
        store; the delta snapshot, the spillover snapshot and their cached
        executors (and with them their device memory) go with it."""
        if self._open:
            for r in self._metric_reporters:
                try:
                    r.stop(final_flush=r.mode == "csv")
                except OSError:
                    pass  # reporting must never block close
            if getattr(self, "_price_book_path", ""):
                from janusgraph_tpu_torch.observability import profiler

                profiler.save_price_book(
                    self._price_book_path, {"oltp": profiler.digest_table},
                )
            if self._delta_snapshot is not None:
                self._delta_snapshot.close()
                self._delta_snapshot = None
            if self.spillover_planner is not None:
                self.spillover_planner.close()
            if self._registered:
                self.instance_registry.deregister(self.instance_id)
            self.log_manager.close()
            if self.cdc_log is not None:
                self.cdc_log.close()
            self.backend.register_change_capture(None)
            self.backend.close()
            self._open = False

    # ----------------------------------------------------------------- commit
    def commit_tx(self, tx: Transaction) -> None:
        """Serialize a transaction's mutations and flush them, under the
        graph-wide commit lock, in the reference's order: existence and
        label cells of new vertices, deleted relations (so a later
        addition of the same column wins under the mutation merge), added
        relations, then the existence and label cells of removed
        vertices, then the index rows; mixed-index documents flush after
        the primary store. With the WAL on (``tx.log-tx`` or the
        transaction's ``log_identifier``) the txlog brackets it: PRECOMMIT
        before the lock, PREFLUSH inside the flush, PRIMARY_SUCCESS, the
        user log and the secondary marker after it."""
        es = self.edge_serializer
        st = self.system_types
        btx = tx.backend_tx
        # -- 0. WAL PRECOMMIT with the change records, before storage is
        # touched (reference: StandardJanusGraph.commit :698-703)
        wal_enabled = self._wal_enabled or bool(tx.log_identifier)
        tx_id = 0
        changes = []
        if wal_enabled:
            changes = self._change_records(tx)
            tx_id = self.tx_log.next_tx_id()
            self.tx_log.precommit(tx_id, changes, tx.log_identifier or "")
        with self._commit_lock:
            # -- 0.5 LOCK-consistency claims for the touched cells of LOCK
            # types; verified and released by btx.commit() (a failed
            # commit's rollback releases them)
            self._register_consistency_locks(tx)
            # -- 1. vertex existence + label cells for new vertices
            for vid, label_id in tx._new_vertex_labels.items():
                if vid in tx._removed_vertices:
                    continue
                adds = [
                    es.write_property(
                        st.EXISTS, self.id_assigner.assign_relation_id(), True
                    ),
                    es.write_edge(
                        st.VERTEX_LABEL_EDGE,
                        Direction.OUT,
                        label_id,
                        self.id_assigner.assign_relation_id(),
                    ),
                ]
                # vertex-label TTL: the existence and label cells expire,
                # so the whole vertex does; its relations become ghosts
                vl = tx.schema_by_id(label_id) if label_id else None
                vttl = getattr(vl, "ttl_seconds", 0)
                if vttl:
                    vexp = time.time_ns() + int(vttl * 1e9)
                    adds = [(c, v, vexp) for c, v in adds]
                btx.mutate_edges(self.idm.get_key(vid), adds, [])
            # -- 2. deleted relations FIRST
            for rel in tx._deleted:
                self._write_relation(tx, rel, delete=True)
            # -- 3. added relations
            seen = set()
            for rels in tx._added.values():
                for rel in rels:
                    if rel.is_removed or rel.id in seen:
                        continue
                    seen.add(rel.id)
                    self._write_relation(tx, rel, delete=False)
            # -- 4. removed vertices: existence + label cells
            for vid in tx._removed_vertices:
                if vid in tx._new_vertex_labels:
                    continue  # never persisted
                dels = []
                key = self.idm.get_key(vid)
                for q in (
                    es.get_type_slice(st.EXISTS, False),
                    es.get_type_slice(st.VERTEX_LABEL_EDGE, True, Direction.OUT),
                ):
                    # graphlint: disable=JG403 -- intentional: commit flushes under _commit_lock for unique-index safety (see step 6 below); serializing committers is the design, not an accident
                    for col, _ in btx.edge_store_query(KeySliceQuery(key, q)):
                        dels.append(col)
                if dels:
                    btx.mutate_edges(key, [], dels)
            # -- 5. composite index rows and unique checks
            self._apply_index_updates(tx, btx)
            # -- 5.5 mixed-index document mutations, derived while the tx
            # state is still consistent (flushed after the primary commit:
            # reference prepareCommit :645-663, storage-then-indexes
            # :759-766)
            index_tx = self._prepare_mixed_index_updates(tx)
            # -- 6. flush while still holding the lock (unique-index
            # safety). The WAL's PREFLUSH goes in after the lock checks
            # pass, just before the batch reaches storage: a crash past it
            # may leave a torn batch that TornCommitRecovery rolls forward;
            # a failure before it left storage untouched
            btx.commit(
                preflush=(lambda: self.tx_log.preflush(tx_id)) if wal_enabled else None
            )
        # -- 6.5 mixed-index documents: secondary persistence; a failure
        # never unwinds the committed primary (recovery heals it with the
        # WAL on, reindex without)
        secondary_ok = True
        if index_tx is not None and index_tx.has_mutations():
            try:
                if getattr(tx, "_fail_mixed_for_test", False):
                    raise RuntimeError("injected mixed-index failure")
                index_tx.commit()
            except Exception:
                secondary_ok = False
                _logger.error(
                    "mixed-index persistence failed for a committed "
                    "transaction%s; primary storage is authoritative — run "
                    "transaction recovery (WAL on) or reindex to heal",
                    "" if wal_enabled else " (WAL off: no automatic heal)",
                    exc_info=True,
                )
        # -- 7. WAL PRIMARY_SUCCESS, then the user log and the secondary
        # marker (reference: :752-813). The primary has committed: nothing
        # past this point may raise, or the caller would roll back a
        # durably committed transaction
        if wal_enabled:
            try:
                self.tx_log.primary_success(tx_id)
            except Exception:
                # recovery sees PRECOMMIT without PRIMARY_SUCCESS; the
                # committed data itself is safe
                return
            try:
                if not secondary_ok:
                    raise RuntimeError("mixed-index persistence failed")
                if tx.log_identifier:
                    from janusgraph_tpu_torch.core.txlog import (
                        LogTxStatus,
                        TxLogEntry,
                        encode_tx_entry,
                    )

                    if getattr(tx, "_fail_secondary_for_test", False):
                        raise RuntimeError("injected secondary failure")
                    ulog = self.log_manager.open_log("ulog_" + tx.log_identifier)
                    ulog.add_now(encode_tx_entry(TxLogEntry(
                        tx_id, LogTxStatus.PRECOMMIT, changes, tx.log_identifier,
                    )))
                self.tx_log.secondary(tx_id, success=True)
            except Exception:
                try:
                    self.tx_log.secondary(tx_id, success=False)
                except Exception:
                    pass  # recovery treats a missing marker as a failure too

    def _change_records(self, tx: Transaction):
        """The transaction's mutations as self-contained change records,
        the WAL's payload (reference: TransactionLogHeader): additions in
        the commit's order, then deletions."""
        from janusgraph_tpu_torch.core.txlog import ChangeRecord

        records = []

        def record(rel, added: bool):
            if isinstance(rel, Edge):
                records.append(ChangeRecord(
                    "edge", added, rel.out_vertex.id, rel.in_vertex.id,
                    rel.type_id, rel.id,
                ))
            else:
                records.append(ChangeRecord(
                    "property", added, rel.vertex.id, 0, rel.type_id, rel.id,
                    self.serializer.write_object(rel.value),
                ))

        seen = set()
        for rels in tx._added.values():
            for rel in rels:
                if rel.is_removed or rel.id in seen:
                    continue
                seen.add(rel.id)
                record(rel, added=True)
        for rel in tx._deleted:
            record(rel, added=False)
        return records

    # ------------------------------------------------------------- recovery
    def restore_mixed_indexes(self, changes) -> None:
        """Recovery hook: re-derive the mixed-index documents of every
        vertex a transaction touched from primary storage and overwrite the
        provider's copy (reference: fixSecondaryFailure:151 →
        IndexSerializer.reindexElement → IndexProvider.restore)."""
        from janusgraph_tpu_torch.indexing import IndexEntry

        touched = set()
        for c in changes:
            touched.add(c.vertex_id)
            if c.kind != "property":
                touched.add(c.other_id)
        if not touched:
            return
        tx = self.new_transaction(read_only=True)
        try:
            per_provider: Dict[str, dict] = {}
            for idx in self.indexes.values():
                if not idx.mixed or idx.status == "DISABLED":
                    continue
                fields = self.mixed_index_fields(idx, register=True)
                docs = per_provider.setdefault(idx.backing, {}).setdefault(idx.name, {})
                for vid in touched:
                    v = tx.get_vertex(vid)
                    entries = []
                    if v is not None and self._matches_label(tx, idx, vid):
                        for fname, (_kid, _info) in fields.items():
                            for p in tx.get_properties(v, fname):
                                entries.append(IndexEntry(fname, p.value))
                    docs[str(vid)] = entries
            for backing, documents in per_provider.items():
                self.index_providers[backing].restore(documents, self._mixed_key_infos)
        finally:
            tx.rollback()

    def replay_torn_changes(self, changes) -> None:
        """Idempotently re-apply a torn transaction's WAL change records to
        primary storage (TornCommitRecovery's roll-forward).

        Cell-exact where a surviving twin exists: an edge with one of its
        two cells present gets the missing cell re-serialized from the
        surviving copy (sort key and inline properties included). A
        relation with no surviving cell replays from the record itself
        (identity, value and endpoints; inline edge properties and sort
        keys are not in the WAL payload). A new vertex's existence cell is
        restored; composite-index rows of replayed property values are
        re-added afterwards (``_replay_index_entries``)."""
        es = self.edge_serializer
        idm = self.idm
        btx = self.backend.begin_transaction()
        tx = self.new_transaction(read_only=True)
        touched_props: Dict[int, set] = {}
        exists_vids = set()
        try:
            for c in changes:
                if c.kind == "edge":
                    self._replay_edge(tx, btx, c)
                    if c.added:
                        exists_vids.update((c.vertex_id, c.other_id))
                else:
                    self._replay_property(tx, btx, c)
                    if c.added:
                        touched_props.setdefault(c.vertex_id, set()).add(c.type_id)
                        exists_vids.add(c.vertex_id)
            # the torn batch may have dropped a new vertex's existence cell
            # (system cells are no change records): restore it, with the
            # default label (the label edge's identity is not recorded)
            st = self.system_types
            exists_q = es.get_type_slice(st.EXISTS, False)
            for vid in sorted(exists_vids):
                key = idm.get_key(vid)
                if btx.edge_store_query(KeySliceQuery(key, exists_q)):
                    continue
                btx.mutate_edges(key, [es.write_property(
                    st.EXISTS, self.id_assigner.assign_relation_id(), True
                )], [])
            btx.commit()
        finally:
            tx.rollback()
        self._replay_index_entries(touched_props)

    def _find_relation_cell(self, tx, btx, vid: int, type_id: int, rel_id: int,
                            is_edge: bool, direction=None):
        """The stored cell of one relation on one row: (entry, parsed) or
        (None, None)."""
        es = self.edge_serializer
        q = es.get_type_slice(type_id, is_edge)
        key = self.idm.get_key(vid)
        for entry in btx.edge_store_query(KeySliceQuery(key, q)):
            rc = es.parse_relation(entry, tx._codec_schema)
            if rc.relation_id != rel_id:
                continue
            if direction is not None and rc.direction != direction:
                continue
            return entry, rc
        return None, None

    def _replay_edge(self, tx, btx, c) -> None:
        es = self.edge_serializer
        idm = self.idm
        out_cell, out_rc = self._find_relation_cell(
            tx, btx, c.vertex_id, c.type_id, c.relation_id, True, Direction.OUT,
        )
        in_cell, in_rc = self._find_relation_cell(
            tx, btx, c.other_id, c.type_id, c.relation_id, True, Direction.IN,
        )
        if not c.added:
            if out_cell is not None:
                btx.mutate_edges(idm.get_key(c.vertex_id), [], [out_cell[0]])
            if in_cell is not None:
                btx.mutate_edges(idm.get_key(c.other_id), [], [in_cell[0]])
            return
        label = tx.schema_by_id(c.type_id)
        unidirected = getattr(label, "unidirected", False)
        survivor = out_rc or in_rc
        sort_key = survivor.sort_key if survivor is not None else b""
        props = (survivor.properties or None) if survivor is not None else None
        if out_cell is None:
            btx.mutate_edges(idm.get_key(c.vertex_id), [es.write_edge(
                c.type_id, Direction.OUT, c.other_id, c.relation_id, sort_key, props,
            )], [])
        if in_cell is None and not unidirected:
            btx.mutate_edges(idm.get_key(c.other_id), [es.write_edge(
                c.type_id, Direction.IN, c.vertex_id, c.relation_id, sort_key, props,
            )], [])

    def _replay_property(self, tx, btx, c) -> None:
        es = self.edge_serializer
        cell, _rc = self._find_relation_cell(
            tx, btx, c.vertex_id, c.type_id, c.relation_id, False
        )
        if not c.added:
            if cell is not None:
                btx.mutate_edges(self.idm.get_key(c.vertex_id), [], [cell[0]])
            return
        if cell is not None:
            return  # this cell survived the tear
        pk = tx.schema_by_id(c.type_id)
        card = pk.cardinality if isinstance(pk, PropertyKey) else Cardinality.SINGLE
        value, _ = self.serializer.read_object(c.value_enc)
        btx.mutate_edges(self.idm.get_key(c.vertex_id), [
            es.write_property(c.type_id, c.relation_id, value, card)
        ], [])

    def _replay_index_entries(self, touched: Dict[int, set]) -> None:
        """Re-add the composite-index rows of replayed property values (the
        graphindex half of a torn batch; additions only: stale entries of
        replayed deletions are healed by reindex, as in the reference)."""
        if not touched:
            return
        tx = self.new_transaction(read_only=True)
        btx = self.backend.begin_transaction()
        try:
            for idx in self.indexes.values():
                if idx.mixed or idx.status in ("DISABLED", "INSTALLED"):
                    continue
                kid_set = set(idx.key_ids)
                for vid, kids in sorted(touched.items()):
                    if not (kid_set & kids):
                        continue
                    if idx.label_constraint is not None and not (
                        self._matches_label(tx, idx, vid)
                    ):
                        continue
                    after = self._index_values_committed(tx, idx, vid)
                    if after is None:
                        continue
                    for row, adds, _dels in self.index_serializer.index_updates(
                        idx, vid, None, after
                    ):
                        if adds:
                            btx.mutate_index(row, adds, [])
            btx.commit()
        finally:
            tx.rollback()

    def _relation_cells(self, tx: Transaction, rel):
        """[(vertex-key, (column, value))] a relation serializes to: an
        edge's OUT cell, then its IN cell (none for a unidirected label); a
        property's one cell."""
        es = self.edge_serializer
        if isinstance(rel, Edge):
            label = tx.schema_by_id(rel.type_id)
            cells = [(
                self.idm.get_key(rel.out_vertex.id),
                es.write_edge(
                    rel.type_id, Direction.OUT, rel.in_vertex.id,
                    rel.id, rel._sort_key, rel._props or None,
                ),
            )]
            if not (isinstance(label, EdgeLabel) and label.unidirected):
                cells.append((
                    self.idm.get_key(rel.in_vertex.id),
                    es.write_edge(
                        rel.type_id, Direction.IN, rel.out_vertex.id,
                        rel.id, rel._sort_key, rel._props or None,
                    ),
                ))
            return cells
        pk = tx.schema_by_id(rel.type_id)
        card = (
            pk.cardinality if isinstance(pk, PropertyKey) else Cardinality.SINGLE
        )
        return [(
            self.idm.get_key(rel.vertex.id),
            es.write_property(
                rel.type_id, rel.id, rel.value, card,
                meta=getattr(rel, "_meta", None) or None,
            ),
        )]

    def _register_consistency_locks(self, tx: Transaction) -> None:
        """One consistent-key lock claim for every cell the commit touches
        of a type with LOCK consistency (reference:
        StandardJanusGraph.prepareCommit acquiring edge locks). The
        expected value comes from the transaction's own mutations: a
        deleted relation's cell must still hold its encoding, an added
        cell's column must be absent. So a concurrent commit that changed a
        touched cell after this transaction read it fails the
        expected-value pass inside btx.commit()."""
        # (key, cell column) -> expected value bytes | None (absent)
        cells: dict = {}

        def touch(rel, deleted: bool):
            el = tx.schema_by_id(rel.type_id)
            if getattr(el, "consistency", None) != Consistency.LOCK:
                return
            for key, (col, val) in self._relation_cells(tx, rel):
                if deleted:
                    cells[(key, col)] = val
                else:
                    cells.setdefault((key, col), None)

        for rel in tx._deleted:
            touch(rel, True)
        for rels in tx._added.values():
            for rel in rels:
                if not rel.is_removed:
                    touch(rel, False)
        for (key, col) in sorted(cells):
            val = cells[(key, col)]
            tx.backend_tx.acquire_edge_lock(
                key, col, expected=[(col, val)] if val is not None else []
            )

    def _write_relation(self, tx: Transaction, rel, delete: bool) -> None:
        expire = 0
        if not delete:
            el = tx.schema_by_id(rel.type_id)
            ttl = getattr(el, "ttl_seconds", 0)
            # a (static) TTL'd vertex label folds into its relations' TTL:
            # static vertices gain relations only in their creating
            # transaction, so _new_vertex_labels covers them
            vids = (
                [rel.out_vertex.id, rel.in_vertex.id]
                if isinstance(rel, Edge)
                else [rel.vertex.id]
            )
            for vid in vids:
                lbl_id = tx._new_vertex_labels.get(vid)
                if lbl_id:
                    vttl = getattr(tx.schema_by_id(lbl_id), "ttl_seconds", 0)
                    if vttl:
                        ttl = vttl if not ttl else min(ttl, vttl)
            if ttl:
                expire = time.time_ns() + int(ttl * 1e9)
        cells = self._relation_cells(tx, rel)
        if isinstance(rel, Edge):
            cells = cells + self._relation_index_cells(tx, rel, delete)
        for key, cell in cells:
            if delete:
                tx.backend_tx.mutate_edges(key, [], [cell[0]])
            elif expire:
                # cell-TTL entry (column, value, expire_ns), kept by stores
                # with cell TTL; set_ttl refuses TTL'd types on others
                tx.backend_tx.mutate_edges(key, [(cell[0], cell[1], expire)], [])
            else:
                tx.backend_tx.mutate_edges(key, [cell], [])

    def _relation_index_cells(
        self, tx: Transaction, rel, for_delete: bool = False
    ) -> list:
        """Extra cells an edge writes for each RelationTypeIndex on its
        label (reference: RelationTypeIndex — the index is itself a
        relation type; its cells duplicate the edge under the index's type
        id with the index sort key in the column). Edges missing an indexed
        sort-key property are skipped (they are simply not indexed).
        Deletions target the cells of EVERY index regardless of status —
        a DISABLED index must not orphan cells that would resurface as
        phantom edges on re-enable."""
        out = []
        ris = self.relation_indexes.get(rel.type_id, ())
        if not ris:
            return out
        es = self.edge_serializer
        ser = self.serializer
        for ri in ris:
            if not for_delete and ri.status not in ("REGISTERED", "ENABLED"):
                continue
            sk = ri.sort_key_bytes(ser, rel._props)
            if sk is None:
                continue
            if ri.direction in (int(Direction.OUT), int(Direction.BOTH)):
                out.append((
                    self.idm.get_key(rel.out_vertex.id),
                    es.write_edge(
                        ri.id, Direction.OUT, rel.in_vertex.id,
                        rel.id, sk, rel._props or None,
                    ),
                ))
            if ri.direction in (int(Direction.IN), int(Direction.BOTH)):
                out.append((
                    self.idm.get_key(rel.in_vertex.id),
                    es.write_edge(
                        ri.id, Direction.IN, rel.out_vertex.id,
                        rel.id, sk, rel._props or None,
                    ),
                ))
        return out

    def _matches_label(self, tx, idx: IndexDefinition, vid: int) -> bool:
        if idx.label_constraint is None:
            return True
        v = tx._vertex_handle(vid)
        return tx.get_vertex_label(v) == idx.label_constraint

    def mixed_index_fields(self, idx: IndexDefinition, register: bool = False):
        """{field_name: (key_id, KeyInformation)}; the provider store name is
        the index name (reference: IndexSerializer.getStoreName)."""
        from janusgraph_tpu_torch.indexing import KeyInformation, Mapping

        fields = {}
        for kid in idx.key_ids:
            pk = self.schema_cache.get_by_id(kid)
            if not isinstance(pk, PropertyKey):
                continue
            info = KeyInformation(
                pk.data_type,
                Mapping(idx.mapping_for(kid)),
                pk.cardinality.name,
            )
            fields[pk.name] = (kid, info)
        if register:
            provider = self.index_providers[idx.backing]
            infos = self._mixed_key_infos.setdefault(idx.name, {})
            for fname, (_kid, info) in fields.items():
                if fname not in infos:
                    infos[fname] = info
                    provider.register(idx.name, fname, info)
        return fields

    # ---------------------------------------------------------- index updates
    def _apply_index_updates(self, tx: Transaction, btx) -> None:
        if not self.indexes:
            return
        # vertices whose properties changed in this tx
        changed: set = set()
        for vid, rels in tx._added.items():
            if any(isinstance(r, VertexProperty) and not r.is_removed for r in rels):
                changed.add(vid)
        for rel in tx._deleted:
            if isinstance(rel, VertexProperty):
                changed.add(rel.vertex.id)
        changed.update(tx._removed_vertices)
        if not changed:
            return

        for idx in list(self.indexes.values()):
            if idx.mixed:
                continue  # document updates prepared separately (step 5.5)
            if idx.status in ("DISABLED", "INSTALLED"):
                continue  # writes flow only to REGISTERED/ENABLED indexes
            # phase 1: compute every vertex's (before, after) transition so
            # unique checks can see sibling mutations in this same tx —
            # both new claims and releases of previously-owned values
            transitions = []
            for vid in changed:
                before = self._index_values_committed(tx, idx, vid)
                after = (
                    None
                    if vid in tx._removed_vertices
                    else self._index_values_current(tx, idx, vid)
                )
                if idx.label_constraint is not None and (before or after):
                    v = tx._vertex_handle(vid)
                    if tx.get_vertex_label(v) != idx.label_constraint:
                        continue
                if before == after:
                    continue
                transitions.append((vid, before, after))

            if idx.unique:
                releasing = {t[1]: t[0] for t in transitions if t[1] is not None}
                claims: Dict[tuple, int] = {}
                for vid, _before, after in transitions:
                    if after is None:
                        continue
                    # distributed claim: lock the unique index row and pin
                    # the slice observed now — commit re-verifies it
                    # (reference: prepareCommit lock acquisition :561-605 →
                    # BackendTransaction.acquireIndexLock → ConsistentKeyLocker)
                    row = self.index_serializer.index_row_key(idx, after)
                    col = b"\x00"
                    expected = btx.index_query_uncached(
                        KeySliceQuery(row, SliceQuery(col, col + b"\x00"))
                    )
                    btx.acquire_index_lock(row, col, expected)
                    prior = claims.get(after)
                    if prior is not None and prior != vid:
                        raise SchemaViolationError(
                            f"unique index {idx.name} violated within "
                            f"transaction for values {after!r}"
                        )
                    claims[after] = vid
                    # committed owner is fine if it releases the value in
                    # this same tx (e.g. remove-then-readd)
                    existing = self.index_serializer.query(
                        idx, after, btx, uncached=True
                    )
                    conflict = [
                        owner
                        for owner in existing
                        if owner != vid and releasing.get(after) != owner
                    ]
                    if conflict:
                        raise SchemaViolationError(
                            f"unique index {idx.name} violated for values "
                            f"{after!r}"
                        )

            # phase 2: emit mutations — ALL deletions before ALL additions,
            # so a value released by one vertex and claimed by another in the
            # same tx (same row/column on unique indexes) nets to the claim
            # under temporal merge, regardless of vertex iteration order
            pending = []
            for vid, before, after in transitions:
                pending.extend(
                    self.index_serializer.index_updates(idx, vid, before, after)
                )
            # index entries of TTL'd key types expire with their data cells
            # (earliest deadline wins) — otherwise expired properties leave
            # phantom index hits + permanent index garbage
            idx_ttl = 0
            for key_id in idx.key_ids:
                kt = getattr(tx.schema_by_id(key_id), "ttl_seconds", 0)
                if kt:
                    idx_ttl = kt if not idx_ttl else min(idx_ttl, kt)
            idx_expire = 0
            if idx_ttl:
                idx_expire = time.time_ns() + int(idx_ttl * 1e9)
            for row, _adds, dels in pending:
                if dels:
                    btx.mutate_index(row, [], dels)
            for row, adds, _dels in pending:
                if adds:
                    if idx_expire:
                        adds = [(e[0], e[1], idx_expire) for e in adds]
                    btx.mutate_index(row, adds, [])

    def _index_values_committed(self, tx, idx: IndexDefinition, vid: int):
        """Value tuple from committed storage only (pre-tx state)."""
        es = self.edge_serializer
        values = []
        for key_id in idx.key_ids:
            q = es.get_type_slice(key_id, False)
            entries = tx._read_slice(vid, q)
            if not entries:
                return None
            rc = es.parse_relation(entries[0], tx._codec_schema)
            values.append(rc.value)
        return tuple(values)

    def _index_values_current(self, tx, idx: IndexDefinition, vid: int):
        """Value tuple as visible in the tx (committed minus deleted plus
        added)."""
        v = tx._vertex_handle(vid)
        values = []
        for key_id in idx.key_ids:
            el = self.schema_cache.get_by_id(key_id)
            props = tx.get_properties(v, el.name)
            if not props:
                return None
            values.append(props[0].value)
        return tuple(values)

    # ------------------------------------------------------- mixed index I/O
    def _mixed_indexes(self):
        return [
            i
            for i in self.indexes.values()
            if i.mixed and i.status in ("REGISTERED", "ENABLED")
        ]

    def _committed_key_values(self, tx, key_id: int, vid: int) -> List[object]:
        """All committed values of one property key on one vertex."""
        es = self.edge_serializer
        q = es.get_type_slice(key_id, False)
        out = []
        for e in tx._read_slice(vid, q):
            rc = es.parse_relation(e, tx._codec_schema)
            out.append(rc.value)
        return out

    def _prepare_mixed_index_updates(self, tx: Transaction):
        """Build the IndexTransaction holding this tx's document mutations
        (reference: IndexSerializer.getIndexUpdates mixed-index branch)."""
        mixed = self._mixed_indexes()
        if not mixed:
            return None
        # {vid: {touched property key ids}} — the diff only needs to look at
        # keys the tx actually wrote, not every indexed field
        touched: Dict[int, set] = {}
        for vid, rels in tx._added.items():
            for r in rels:
                if isinstance(r, VertexProperty) and not r.is_removed:
                    touched.setdefault(vid, set()).add(r.type_id)
        for rel in tx._deleted:
            if isinstance(rel, VertexProperty):
                touched.setdefault(rel.vertex.id, set()).add(rel.type_id)
        for vid in tx._removed_vertices:
            touched.setdefault(vid, set())
        if not touched:
            return None
        from janusgraph_tpu_torch.indexing import IndexTransaction

        # one IndexTransaction per backing provider would be more faithful;
        # a single one keyed by store (= index name) is equivalent here
        # because every store name is globally unique
        txs: Dict[str, IndexTransaction] = {}
        for idx in mixed:
            provider = self.index_providers[idx.backing]
            itx = txs.get(idx.backing)
            if itx is None:
                itx = txs[idx.backing] = IndexTransaction(
                    provider, self._mixed_key_infos
                )
            fields = self.mixed_index_fields(idx, register=True)
            for vid, touched_kids in touched.items():
                docid = str(vid)
                if vid in tx._removed_vertices:
                    itx.delete(idx.name, docid, None, None, delete_all=True)
                    continue
                if not self._matches_label(tx, idx, vid):
                    continue
                v = tx._vertex_handle(vid)
                for fname, (kid, _info) in fields.items():
                    if kid not in touched_kids:
                        continue
                    before = self._committed_key_values(tx, kid, vid)
                    after = [p.value for p in tx.get_properties(v, fname)]
                    for val in before:
                        if val not in after:
                            itx.delete(idx.name, docid, fname, val)
                    for val in after:
                        if val not in before:
                            itx.add(
                                idx.name, docid, fname, val, is_new=not before
                            )
        if len(txs) == 1:
            return next(iter(txs.values()))
        if not txs:
            return None
        return _MultiIndexTransaction(list(txs.values()))

    def mixed_index_query(
        self,
        tx: Transaction,
        idx: IndexDefinition,
        conditions,
        orders=(),
        limit=None,
        offset=0,
    ) -> List[int]:
        """Query a mixed index with [(key_name, Predicate, value)] conditions
        (reference: IndexSerializer.query mixed branch → IndexProvider.query)."""
        from janusgraph_tpu_torch.indexing import (
            And,
            IndexQuery,
            Order,
            PredicateCondition,
        )

        if idx.status != "ENABLED":
            raise SchemaViolationError(
                f"index {idx.name} is {idx.status}, not ENABLED"
            )
        cond = And(
            tuple(
                PredicateCondition(k, p, val) for k, p, val in conditions
            )
        )
        q = IndexQuery(
            cond,
            tuple(Order(k, desc) for k, desc in orders),
            self._clamp_index_limit(limit),
            offset,
        )
        provider = self.index_providers[idx.backing]
        from janusgraph_tpu_torch.observability import registry, span as _span
        from janusgraph_tpu_torch.observability.profiler import accrue

        with _span("index.mixed-query", index=idx.name,
                   conditions=len(conditions)):
            with registry.time("query.index.mixed"):
                hits = [int(d) for d in provider.query(idx.name, q)]
            # remote providers account hits at the wire (echo/fallback);
            # counting here too would double them
            if not getattr(provider, "ledger_self_accounting", False):
                accrue(index_hits=len(hits))
            return hits

    def _clamp_index_limit(self, limit):
        """index.search.max-result-set-size + query.hard-max-limit: every
        mixed-index query gets a bounded limit (reference:
        index.[X].max-result-set-size, query.hard-max-limit)."""
        cap = min(
            self.config.get("index.search.max-result-set-size"),
            self.config.get("query.hard-max-limit"),
        )
        return cap if limit is None else min(limit, cap)

    def index_query(self, index_name: str, query: str, limit=None, offset=0):
        """Direct provider-syntax query returning [(vertex_id, score)]
        (reference: core/schema/JanusGraphIndexQuery /
        graphdb/query/graph/IndexQueryBuilder — `v.name:hercules` strings)."""
        from janusgraph_tpu_torch.indexing import RawQuery

        idx = self.indexes.get(index_name)
        if idx is None or not idx.mixed:
            raise SchemaViolationError(f"{index_name} is not a mixed index")
        provider = self.index_providers[idx.backing]
        hits = provider.raw_query(
            idx.name, RawQuery(query, self._clamp_index_limit(limit), offset)
        )
        return [(int(d), score) for d, score in hits]

    def index_totals(self, index_name: str, query: str) -> int:
        from janusgraph_tpu_torch.indexing import RawQuery

        idx = self.indexes.get(index_name)
        if idx is None or not idx.mixed:
            raise SchemaViolationError(f"{index_name} is not a mixed index")
        return self.index_providers[idx.backing].totals(
            idx.name, RawQuery(query)
        )

    # -------------------------------------------------------- index-based read
    def index_lookup(self, tx: Transaction, index_name: str, values) -> List[int]:
        idx = self.indexes.get(index_name)
        if idx is None:
            raise SchemaViolationError(f"unknown index {index_name}")
        from janusgraph_tpu_torch.observability import registry, span as _span
        from janusgraph_tpu_torch.observability.profiler import accrue

        with _span("index.lookup", index=index_name):
            with registry.time("query.index.composite"):
                hits = self.index_serializer.query(
                    idx, values, tx.backend_tx
                )
            accrue(index_hits=len(hits))
            return hits

    # ------------------------------------------------------ schema persistence
    def persist_schema_element(self, el) -> None:
        es = self.edge_serializer
        st = self.system_types
        btx = self.backend.begin_transaction()
        key = self.idm.get_key(el.id)
        rid = self.id_assigner.assign_relation_id
        adds = [
            es.write_property(st.EXISTS, rid(), True),
            es.write_property(st.SCHEMA_NAME, rid(), el.name),
            es.write_property(
                st.SCHEMA_DEF, rid(), encode_definition(el.definition())
            ),
        ]
        btx.mutate_edges(key, adds, [])
        # name -> id lookup row (index names live in their own namespace)
        prefix = (
            INDEX_NAME_PREFIX
            if isinstance(el, IndexDefinition)
            else SCHEMA_NAME_INDEX_PREFIX
        )
        btx.mutate_index(
            prefix + el.name.encode(),
            [(struct.pack(">Q", el.id), b"")],
            [],
        )
        btx.commit()
        self.schema_cache.invalidate(el.name)

    def update_schema_element(self, el) -> None:
        """Replace an existing element's stored definition (reference:
        ManagementSystem updateSchemaVertex — rewrite the definition
        property), then evict caches and broadcast."""
        es = self.edge_serializer
        st = self.system_types
        btx = self.backend.begin_transaction()
        key = self.idm.get_key(el.id)
        q = es.get_type_slice(st.SCHEMA_DEF, False)
        old = btx.edge_store_query(KeySliceQuery(key, q))
        dels = [col for col, _ in old]
        add = es.write_property(
            st.SCHEMA_DEF,
            self.id_assigner.assign_relation_id(),
            encode_definition(el.definition()),
        )
        btx.mutate_edges(key, [add], dels)
        btx.commit()
        self.schema_cache.invalidate(el.name)
        self.schema_cache.invalidate_id(el.id)
        if isinstance(el, IndexDefinition):
            self.register_index(el)
        self.schema_changed(el.id)

    def _load_schema_by_name(self, name: str):
        btx = self.backend.begin_transaction()
        entries = btx.index_query(
            KeySliceQuery(SCHEMA_NAME_INDEX_PREFIX + name.encode(), SliceQuery())
        )
        if not entries:
            return None
        (sid,) = struct.unpack(">Q", entries[0][0])
        return self._load_schema_by_id(sid)

    def _load_schema_by_id(self, sid: int):
        es = self.edge_serializer
        st = self.system_types
        btx = self.backend.begin_transaction()
        key = self.idm.get_key(sid)
        name = None
        definition = None
        for q, want in (
            (es.get_type_slice(st.SCHEMA_NAME, False), "name"),
            (es.get_type_slice(st.SCHEMA_DEF, False), "def"),
        ):
            entries = btx.edge_store_query(KeySliceQuery(key, q))
            if not entries:
                return None
            rc = es.parse_relation(entries[0], st.type_info)
            if want == "name":
                name = rc.value
            else:
                definition = decode_definition(rc.value)
        return schema_element_from_definition(sid, name, definition)

    def load_all_schema_elements(self) -> List:
        """Scan the schema-name index prefix (management enumeration)."""
        out = []
        btx = self.backend.begin_transaction()
        store = self.backend.indexstore
        it = store.get_keys(
            KeyRangeQuery(
                SCHEMA_NAME_INDEX_PREFIX,
                SCHEMA_NAME_INDEX_PREFIX + b"\xff",
                SliceQuery(),
            ),
            btx.store_tx,
        )
        for _key, entries in it:
            for col, _ in entries:
                (sid,) = struct.unpack(">Q", col)
                el = self.schema_cache.get_by_id(sid)
                if el is not None:
                    out.append(el)
        return out

    def register_index(self, idx: IndexDefinition) -> None:
        # copy-on-write: readers always see a consistent dict
        with self._index_registry_lock:
            self.indexes = {**self.indexes, idx.name: idx}

    def _load_index_registry(self) -> None:
        with self._index_registry_lock:
            self._load_index_registry_locked()

    def _load_index_registry_locked(self) -> None:
        btx = self.backend.begin_transaction()
        entries = btx.index_query(KeySliceQuery(INDEX_REGISTRY_KEY, SliceQuery()))
        fresh: Dict[str, IndexDefinition] = {}
        for col, _ in entries:
            (sid,) = struct.unpack(">Q", col)
            el = self.schema_cache.get_by_id(sid)
            if isinstance(el, IndexDefinition):
                fresh[el.name] = el
        # atomic swap: commit threads iterate a snapshot, never a dict being
        # mutated by the systemlog reader thread
        self.indexes = fresh
        # relation-type (vertex-centric) indexes, grouped by edge label
        rentries = btx.index_query(
            KeySliceQuery(RELINDEX_REGISTRY_KEY, SliceQuery())
        )
        by_label: Dict[int, tuple] = {}
        rel_ids = set()
        for col, _ in rentries:
            (sid,) = struct.unpack(">Q", col)
            el = self.schema_cache.get_by_id(sid)
            if isinstance(el, RelationIndex):
                by_label[el.label_id] = by_label.get(el.label_id, ()) + (el,)
                rel_ids.add(el.id)
        self.relation_indexes = by_label
        #: type ids whose cells are index copies — excluded from untyped
        #: edge enumeration (reference: RelationTypeIndex types are
        #: invisible system relation types)
        self.relation_index_ids = frozenset(rel_ids)
