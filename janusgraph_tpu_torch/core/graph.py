"""The graph: open, wiring, ID assignment and schema persistence — the
port's copy of the part of ``janusgraph_tpu/core/graph.py`` that the
stored-graph OLAP path and the traversal run.

``open_graph(config, store_manager=None)`` opens a ``JanusGraphTPU`` over
an in-memory store (or over ``store_manager``, e.g.
``InMemoryStoreManager.from_rows`` of a graph the JAX package wrote). It
holds ``config``, ``backend``, ``idm``, ``serializer``,
``edge_serializer``, ``system_types``, ``schema_cache`` and ``id_assigner``
(vertex, relation and schema id pools), and offers ``management()``,
``new_transaction()``, ``traversal()``, ``compute()`` and ``close()``.
Data goes in through OLTP transactions (``core/tx.py``, serialized by
``commit_tx`` under the graph-wide commit lock into the reference's cells)
and the columnar bulk loader (``core/bulk.py``), and out through
``load_csr`` and ``ComputerResult.write_back``. With ``computer.delta`` (the default) every
committed edgestore batch also streams into the graph's ``ChangeCapture``
(``olap/delta.py``), which the warm delta snapshot behind ``submit()``
reads instead of the store.

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
(``g.io()``), the WAL, logs and schema broadcast, lock-consistency claims,
cell TTLs, the instance registry, fault injection and the other store
backends.
"""

from __future__ import annotations

import struct
import threading
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
from janusgraph_tpu_torch.exceptions import SchemaViolationError
from janusgraph_tpu_torch.storage.backend import Backend, GlobalConfigStore
from janusgraph_tpu_torch.storage.idauthority import (
    ConsistentKeyIDAuthority,
    StandardIDPool,
)
from janusgraph_tpu_torch.storage.inmemory import InMemoryStoreManager
from janusgraph_tpu_torch.storage.kcvs import KeySliceQuery, SliceQuery


def open_graph(config: Optional[dict] = None, store_manager=None) -> "JanusGraphTPU":
    """JanusGraphFactory.open equivalent."""
    return JanusGraphTPU(config, store_manager=store_manager)


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
            # only "inmemory" passes the option's check
            store_manager = InMemoryStoreManager()
        self.serializer = Serializer()
        # reconcile cluster-global options BEFORE building the backend so
        # stored GLOBAL/FIXED values govern its construction
        cfg.attach_backend(GlobalConfigStore(store_manager))
        self.backend = Backend(
            store_manager, id_block_size=cfg.get("ids.block-size"),
            metrics_enabled=cfg.get("metrics.enabled"),
            metrics_merge_stores=cfg.get("metrics.merge-stores"),
        )
        self.idm = IDManager(partition_bits=cfg.get("ids.partition-bits"))
        self.edge_serializer = EdgeSerializer(self.serializer, self.idm)
        self.system_types = SystemTypes(self.idm)
        self.backend.id_authority.wait_ms = cfg.get("ids.authority-wait-ms")
        self.id_assigner = VertexIDAssigner(
            self.backend.id_authority, self.idm,
            renew_fraction=cfg.get("ids.renew-percentage"),
        )
        self.schema_cache = SchemaCache(
            self._load_schema_by_name, self._load_schema_by_id
        )
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
        return self.management().make_vertex_label(name)

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
            self._refuse_unported(tx)
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

    def _refuse_unported(self, tx: Transaction) -> None:
        """LOCK consistency needs the consistent-key locker and a TTL a
        store with cell TTLs; neither is ported, so a commit that reaches
        one raises before anything is written."""
        added = {
            rel.type_id for rels in tx._added.values() for rel in rels
            if not rel.is_removed
        }
        for tid in added | {rel.type_id for rel in tx._deleted}:
            el = tx.schema_by_id(tid)
            if getattr(el, "consistency", None) == Consistency.LOCK:
                raise NotImplementedError(
                    f"{el.name} has LOCK consistency: the consistent-key "
                    "locker is not ported yet (ROADMAP.md Queue A #5)"
                )
        for sid in added | set(tx._new_vertex_labels.values()):
            el = tx.schema_by_id(sid)
            if getattr(el, "ttl_seconds", 0):
                raise NotImplementedError(
                    f"{el.name} has a TTL: cell TTLs need a store that keeps "
                    "them, which is not ported yet (ROADMAP.md Queue A #5)"
                )

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

    def _write_relation(self, tx: Transaction, rel, delete: bool) -> None:
        for key, cell in self._relation_cells(tx, rel):
            if delete:
                tx.backend_tx.mutate_edges(key, [], [cell[0]])
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
