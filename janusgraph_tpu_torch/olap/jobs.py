"""OLAP maintenance jobs: index repair/removal and ghost-vertex purging.

Capability parity with the reference's scan-framework jobs
(reference: graphdb/olap/job/IndexRepairJob.java:48 — REINDEX re-derives
index entries for every vertex; IndexRemoveJob.java — deletes an index's
stored data; GhostVertexRemover.java:44 — purges half-deleted vertices;
all run over StandardScanner, or Hadoop MR at cluster scale via
MapReduceIndexManagement.java:276).

The port's copy of ``janusgraph_tpu/olap/jobs.py``. Jobs are
batch-oriented ScanJobs over the edgestore; rows arrive as raw relation
cells, decoded with the same EdgeSerializer the OLTP path uses, and
mutations flow through a backend transaction (composite) or an
IndexProvider.restore call (mixed)."""

from __future__ import annotations

import struct
from typing import Dict, List, Optional, Tuple

from janusgraph_tpu_torch.core.codecs import Direction
from janusgraph_tpu_torch.core.schema import IndexDefinition, PropertyKey
from janusgraph_tpu_torch.storage.kcvs import KeyRangeQuery, SliceQuery
from janusgraph_tpu_torch.storage.scan import ScanJob, ScanMetrics, StandardScanner


def _codec_schema(graph):
    def lookup(type_id: int):
        info = graph.system_types.type_info(type_id)
        if info is not None:
            return info
        el = graph.schema_cache.get_by_id(type_id)
        if el is None:
            raise KeyError(type_id)
        return el.type_info()

    return lookup


class _VertexRowJob(ScanJob):
    """Base for jobs iterating live vertex rows: declares the EXISTS slice as
    the primary query, skips schema vertices and ghosts (reference:
    VertexJobConverter.java:123-143 ghost check + conversion)."""

    def __init__(self, graph):
        self.graph = graph
        self.es = graph.edge_serializer
        self.st = graph.system_types
        self.idm = graph.idm
        self.schema = _codec_schema(graph)
        self.exists_q = self.es.get_type_slice(self.st.EXISTS, False)
        self.label_q = self.es.get_type_slice(
            self.st.VERTEX_LABEL_EDGE, True, Direction.OUT
        )

    def vertex_label(self, entries) -> Optional[str]:
        for e in entries:
            rc = self.es.parse_relation(e, self.schema)
            el = self.graph.schema_cache.get_by_id(rc.other_vertex_id)
            if el is not None:
                return el.name
        return "vertex"


class IndexRepairJob(_VertexRowJob):
    """Re-derive one index's entries for every live vertex (reference:
    graphdb/olap/job/IndexRepairJob.java:48). Composite rows are written
    through a backend tx; mixed documents are batched and pushed with
    IndexProvider.restore (the reference's reindexElement path)."""

    def __init__(self, graph, index: IndexDefinition):
        super().__init__(graph)
        self.index = index
        self.key_slices: List[Tuple[int, str, SliceQuery]] = []
        for kid in index.key_ids:
            pk = graph.schema_cache.get_by_id(kid)
            if isinstance(pk, PropertyKey):
                self.key_slices.append(
                    (kid, pk.name, self.es.get_type_slice(kid, False))
                )
        self._docs: Dict[str, list] = {}
        self._btx = None

    def get_queries(self) -> List[SliceQuery]:
        qs = [self.exists_q, self.label_q]
        qs.extend(q for _, _, q in self.key_slices)
        return qs

    def setup(self, metrics: ScanMetrics) -> None:
        if not self.index.mixed:
            self._btx = self.graph.backend.begin_transaction()

    def process(self, rows, metrics: ScanMetrics) -> None:
        from janusgraph_tpu_torch.indexing import IndexEntry

        idx = self.index
        for key, by_query in rows:
            vid = self.idm.get_vertex_id(key)
            if self.idm.is_schema_vertex_id(vid):
                continue
            if not by_query.get(self.exists_q):
                metrics.increment("ghost-skipped")
                continue
            if idx.label_constraint is not None:
                label = self.vertex_label(by_query.get(self.label_q, ()))
                if label != idx.label_constraint:
                    continue
            values: Dict[int, list] = {}
            for kid, _name, q in self.key_slices:
                vals = []
                for e in by_query.get(q, ()):
                    rc = self.es.parse_relation(e, self.schema)
                    vals.append(rc.value)
                values[kid] = vals
            if idx.mixed:
                entries = []
                for kid, name, _q in self.key_slices:
                    entries.extend(IndexEntry(name, v) for v in values[kid])
                if entries:
                    self._docs[str(vid)] = entries
                    metrics.increment("documents-added")
            else:
                tup = tuple(
                    values[kid][0] if values[kid] else None
                    for kid in idx.key_ids
                )
                if any(v is None for v in tup):
                    continue
                for row, adds, _dels in self.graph.index_serializer.index_updates(
                    idx, vid, None, tup
                ):
                    if adds:
                        self._btx.mutate_index(row, adds, [])
                        metrics.increment("index-entries-added")
            metrics.add_rows(1)

    def teardown(self, metrics: ScanMetrics) -> None:
        if self.index.mixed:
            if self._docs:
                self.graph.mixed_index_fields(self.index, register=True)
                self.graph.index_providers[self.index.backing].restore(
                    {self.index.name: self._docs}, self.graph._mixed_key_infos
                )
        elif self._btx is not None:
            self._btx.commit()


class IndexRemoveJob:
    """Delete an index's stored data (reference:
    graphdb/olap/job/IndexRemoveJob.java). Composite indexes scan the
    `graphindex` store for the index-id key prefix — not the edgestore — so
    this is a key-range delete, not a ScanJob over vertices. Mixed indexes
    clear the provider's store."""

    def __init__(self, graph, index: IndexDefinition):
        self.graph = graph
        self.index = index

    def run(self) -> ScanMetrics:
        metrics = ScanMetrics()
        idx = self.index
        if idx.mixed:
            provider = self.graph.index_providers[idx.backing]
            # drop only this index's store (the provider may back others)
            if hasattr(provider, "_stores"):
                provider._stores.pop(idx.name, None)
            metrics.increment("stores-cleared")
            return metrics
        btx = self.graph.backend.begin_transaction()
        prefix = struct.pack(">Q", idx.id)
        store = self.graph.backend.indexstore
        if self.graph.backend.manager.features.ordered_scan:
            it = store.get_keys(
                KeyRangeQuery(prefix, prefix + b"\xff" * 17, SliceQuery()),
                btx.store_tx,
            )
        else:
            it = (
                (k, es)
                for k, es in store.get_keys(SliceQuery(), btx.store_tx)
                if k.startswith(prefix)
            )
        for key, entries in it:
            cols = [col for col, _ in entries]
            if cols:
                btx.mutate_index(key, [], cols)
                metrics.increment("index-entries-removed", len(cols))
            metrics.add_rows(1)
        btx.commit()
        return metrics


class GhostVertexRemover(_VertexRowJob):
    """Purge rows of half-deleted vertices: any non-schema row whose EXISTS
    cell is gone but that still has relation cells (reference:
    graphdb/olap/job/GhostVertexRemover.java:44 — ghosts arise from
    concurrent deletion and writes under eventual consistency)."""

    GHOST_REMOVED = "ghost-removed"

    def __init__(self, graph):
        super().__init__(graph)
        self._btx = None
        self.full_row = SliceQuery()

    def get_queries(self) -> List[SliceQuery]:
        return [self.full_row, self.exists_q]

    def setup(self, metrics: ScanMetrics) -> None:
        self._btx = self.graph.backend.begin_transaction()

    def process(self, rows, metrics: ScanMetrics) -> None:
        for key, by_query in rows:
            vid = self.idm.get_vertex_id(key)
            if self.idm.is_schema_vertex_id(vid):
                continue
            if by_query.get(self.exists_q):
                metrics.add_rows(1)
                continue
            cols = [col for col, _ in by_query.get(self.full_row, ())]
            if cols:
                self._btx.mutate_edges(key, [], cols)
                metrics.increment(self.GHOST_REMOVED)
            metrics.add_rows(1)

    def teardown(self, metrics: ScanMetrics) -> None:
        if self._btx is not None:
            self._btx.commit()


def run_scan_job(
    graph,
    job: ScanJob,
    num_workers: int = None,
    batch_size: int = None,
) -> ScanMetrics:
    """Run a ScanJob over the edgestore, partition-parallel (reference:
    Backend.buildEdgeScanJob → StandardScanner; partition ranges =
    IDManager key ranges, the same structure the OLAP loaders split by).
    Worker count and batch size default to the graph's registered config
    (storage.scan-parallelism / storage.scan-batch-size)."""
    cfg = getattr(graph, "config", None)
    if num_workers is None:
        num_workers = cfg.get("storage.scan-parallelism") if cfg else 1
        if not num_workers:  # 0 = one worker per partition
            num_workers = graph.idm.num_partitions
    if batch_size is None:
        batch_size = cfg.get("storage.scan-batch-size") if cfg else 4096
    btx = graph.backend.begin_transaction()
    scanner = StandardScanner(
        graph.backend.edgestore,
        btx.store_tx,
        ordered_scan=graph.backend.manager.features.ordered_scan,
        retries=cfg.get("storage.scan-retries") if cfg else 3,
    )
    ranges = [
        graph.idm.partition_key_range(p)
        for p in range(graph.idm.num_partitions)
    ]
    return scanner.execute(
        job, key_ranges=ranges, num_workers=num_workers, batch_size=batch_size
    )
