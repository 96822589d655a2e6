"""The graph: open, wiring, ID assignment, schema persistence and the
commit — the port's copy of the part of ``janusgraph_tpu/core/graph.py``
that the stored-graph OLAP path, the transaction and the traversal run.

``open_graph(config, store_manager=None)`` opens a ``JanusGraphTPU`` over
the store manager that ``storage.backend`` names in the store-manager
table (``register_store_manager`` adds to it): "inmemory", or "local", a
persistent directory (``storage.directory``, ``storage.fsync``;
``storage/localstore.py``), whose files the JAX package reads and writes
too. ``store_manager`` overrides the table (e.g.
``InMemoryStoreManager.from_rows`` of a graph the JAX package wrote).
``drop_graph`` destroys a graph's storage and closes it. The graph holds
``config``, ``backend``, ``idm``, ``serializer``, ``edge_serializer``,
``system_types``, ``schema_cache`` and ``id_assigner`` (vertex, relation
and schema id pools), and offers ``management()``, ``new_transaction()``,
``traversal()``, ``compute()`` and ``close()``. Data goes in through OLTP
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

Left out (ROADMAP Queue A #5): indexes and index providers (the port
makes none, so commits maintain none and traversals scan), graph I/O
(``g.io()``), the WAL, logs and schema broadcast (a schema change evicts
in-process only), the instance registry, fault injection and the
"sharded" and "remote" stores (#5.5; their factories raise).
"""

from __future__ import annotations

import struct
import threading
import time
from typing import Dict, Optional

from janusgraph_tpu_torch.core.attributes import Serializer
from janusgraph_tpu_torch.core.codecs import (
    Cardinality,
    Consistency,
    Direction,
    EdgeSerializer,
)
from janusgraph_tpu_torch.core.config import GraphConfiguration
from janusgraph_tpu_torch.core.ids import IDManager, VertexIDType
from janusgraph_tpu_torch.core.management import (
    SCHEMA_NAME_INDEX_PREFIX,
    ManagementSystem,
)
from janusgraph_tpu_torch.core.schema import (
    EdgeLabel,
    PropertyKey,
    SchemaCache,
    SystemTypes,
    decode_definition,
    encode_definition,
    schema_element_from_definition,
    VertexLabel,
)
from janusgraph_tpu_torch.core.tx import Transaction
from janusgraph_tpu_torch.core.elements import Edge
from janusgraph_tpu_torch.exceptions import ConfigurationError, SchemaViolationError
from janusgraph_tpu_torch.storage.backend import Backend, GlobalConfigStore
from janusgraph_tpu_torch.storage.idauthority import (
    ConsistentKeyIDAuthority,
    StandardIDPool,
)
from janusgraph_tpu_torch.storage.inmemory import InMemoryStoreManager
from janusgraph_tpu_torch.storage.kcvs import KeySliceQuery, SliceQuery


def _open_local(cfg):
    from janusgraph_tpu_torch.storage.localstore import open_local_kcvs

    directory = cfg.get("storage.directory")
    if not directory:
        raise ConfigurationError("storage.backend=local requires storage.directory")
    return open_local_kcvs(directory, fsync=cfg.get("storage.fsync"))


def _not_ported_store(name):
    def factory(cfg):
        raise ConfigurationError(
            f"storage.backend={name!r} is not ported yet: ROADMAP.md Queue A "
            "#5.5 (the remote and sharded stores)"
        )

    return factory


# reference: StandardStoreManager.java:82 shorthand registry. Factories take
# the GraphConfiguration.
_STORE_MANAGERS = {
    "inmemory": lambda cfg: InMemoryStoreManager(),
    "local": _open_local,
    "sharded": _not_ported_store("sharded"),
    "remote": _not_ported_store("remote"),
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
    store; a local directory loses its ``store.wal`` and
    ``store.snapshot`` (nothing else of the directory is touched). The
    delta snapshot and the cached executors go with ``close()``. The
    reference also clears the mixed-index providers, the logs and the
    instance registry, which the port does not have (ROADMAP Queue A #5).

    Storage is cleared BEFORE close(): the local backend's clear_storage
    reopens its WAL handle, and only the following close() releases it.
    The local store's files are then unlinked (the reference leaves a WAL
    that holds only the frames its close() appends)."""
    manager = graph.backend.manager
    try:
        manager.clear_storage()
    finally:
        if graph._open:
            graph.close()
    kv = getattr(manager, "kv_manager", None)
    if hasattr(kv, "remove_files"):
        kv.remove_files()


class VertexIDAssigner:
    """Maps new elements to IDs: round-robin partition placement for normal
    vertices, canonical-partition ids for partitioned (vertex-cut) labels
    (reference: idassigner/VertexIDAssigner.java)."""

    def __init__(
        self,
        authority: ConsistentKeyIDAuthority,
        idm: IDManager,
        renew_fraction: Optional[float] = None,
    ):
        self.authority = authority
        self.idm = idm
        self.renew_fraction = renew_fraction  # ids.renew-percentage
        self._vertex_pools: Dict[int, StandardIDPool] = {}
        self._relation_pool = StandardIDPool(
            authority, ConsistentKeyIDAuthority.NS_RELATION, 0,
            renew_fraction=renew_fraction,
        )
        self._schema_pool = StandardIDPool(
            authority, ConsistentKeyIDAuthority.NS_SCHEMA, 0,
            renew_fraction=renew_fraction,
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
                )
                self._vertex_pools[partition] = pool
            return pool

    def assign_vertex_id(self, partitioned: bool = False) -> int:
        with self._lock:
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
        self.serializer = Serializer()
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
        self.backend.id_authority.wait_ms = cfg.get("ids.authority-wait-ms")
        self.backend.configure_lockers(
            wait_ms=cfg.get("locks.wait-ms"),
            expiry_ms=cfg.get("locks.expiry-ms"),
            retries=cfg.get("locks.retries"),
            clean_expired=cfg.get("locks.clean-expired"),
        )
        self.id_assigner = VertexIDAssigner(
            self.backend.id_authority, self.idm,
            renew_fraction=cfg.get("ids.renew-percentage"),
        )
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
        #: relation-type index ids (no relation indexes in the port)
        self.relation_index_ids = frozenset()
        #: commits are serialized graph-wide (reference: commit_tx)
        self._commit_lock = threading.Lock()
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
        self._open = True

    def _configure_telemetry(self) -> None:
        """Apply the metrics.* options to the process-wide tracer, flight
        recorder, roofline peaks and logger; with metrics.enabled, start the
        periodic reporters (last: an open that fails leaks no thread)."""
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

    def new_transaction(
        self,
        read_only: Optional[bool] = None,
        log_identifier: Optional[str] = None,
        metrics_group: Optional[str] = None,
    ) -> Transaction:
        """An OLTP transaction. ``read_only`` defaults to
        tx.read-only-default; ``metrics_group`` counts its commits as
        ``<group>.commit``; ``log_identifier`` (the WAL's user log) raises
        until the WAL is ported."""
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
        """Drop a changed schema element from every cache layer of this
        instance (the reference broadcasts this over its management log to
        every open instance; the port evicts in-process, ROADMAP Queue A
        #5.3)."""
        self.schema_cache.invalidate_id(sid)
        self.backend.clear_caches()

    def traversal(self):
        """The Gremlin entry point: ``g = graph.traversal()``, then
        ``g.V()...`` (``core/traversal.py``)."""
        from janusgraph_tpu_torch.core.traversal import GraphTraversalSource

        return GraphTraversalSource(self)

    def compute(self, executor: str = None):
        """OLAP entry point (reference: JanusGraph.compute()). Defaults the
        executor to the computer.executor config option: "tpu", the card;
        "cpu", the plain versions on the CPU."""
        from janusgraph_tpu_torch.olap.computer import GraphComputer

        return GraphComputer(self, executor=executor)

    def close(self) -> None:
        """Close the store; the delta snapshot, the spillover snapshot and
        their cached executors (and with them their device memory) go with
        it."""
        if self._open:
            for r in self._metric_reporters:
                try:
                    r.stop(final_flush=r.mode == "csv")
                except OSError:
                    pass  # reporting must never block close
            if self._delta_snapshot is not None:
                self._delta_snapshot.close()
                self._delta_snapshot = None
            if self.spillover_planner is not None:
                self.spillover_planner.close()
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
        vertices."""
        es = self.edge_serializer
        st = self.system_types
        btx = tx.backend_tx
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
                    for col, _ in btx.edge_store_query(KeySliceQuery(key, q)):
                        dels.append(col)
                if dels:
                    btx.mutate_edges(key, [], dels)
            # -- 5. index updates: the port makes no indexes
            # (core/management.py), so there is nothing to maintain
            assert not self.relation_index_ids
            # -- 6. flush while still holding the lock
            btx.commit()

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
        for key, cell in self._relation_cells(tx, rel):
            if delete:
                tx.backend_tx.mutate_edges(key, [], [cell[0]])
            elif expire:
                # cell-TTL entry (column, value, expire_ns), kept by stores
                # with cell TTL; set_ttl refuses TTL'd types on others
                tx.backend_tx.mutate_edges(key, [(cell[0], cell[1], expire)], [])
            else:
                tx.backend_tx.mutate_edges(key, [cell], [])

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
        # name -> id lookup row
        btx.mutate_index(
            SCHEMA_NAME_INDEX_PREFIX + el.name.encode(),
            [(struct.pack(">Q", el.id), b"")],
            [],
        )
        btx.commit()
        self.schema_cache.invalidate(el.name)

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
