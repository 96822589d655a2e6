"""Distributed bulk input format — the port's copy of
``janusgraph_tpu/olap/input_format.py``'s splits and record reader.

Capability parity with the reference's Hadoop integration
(reference: janusgraph-hadoop .../formats/util/HadoopInputFormat.java:34 +
HadoopRecordReader.java:111 — partition the edgestore into input splits and
deserialize raw rows into star vertices via
JanusGraphVertexDeserializer.java). Splits are ID-partition ranges (the
same unit ``load_csr(partitions=...)`` and the distributed loader scan),
and records are ``StarVertex`` (adjacency and properties of one vertex).
An external engine can consume splits independently: each split reads
only its own key ranges.

``DistributedIndexManagement`` runs an index's ``IndexRepairJob``
(``olap/jobs.py``) over the splits on worker threads, one scanner per
split, and merges their metrics.

``load_shard_csrs`` loads one CSR per split (a shard's partitions), the
sharded executor's per-slot input.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional, Tuple

from janusgraph_tpu_torch.core.codecs import Direction
from janusgraph_tpu_torch.storage.kcvs import KeyRangeQuery, KeySliceQuery


@dataclass
class StarVertex:
    """One vertex with its full adjacency star (reference: TinkerPop
    StarVertex as produced by JanusGraphVertexDeserializer)."""

    vertex_id: int
    label: str = "vertex"
    properties: Dict[str, List[object]] = field(default_factory=dict)
    #: out-edges as (edge_label, other_vertex_id, edge_properties)
    edges: List[Tuple[str, int, Dict[str, object]]] = field(default_factory=list)


@dataclass(frozen=True)
class InputSplit:
    """A unit of distributed read work: a set of ID partitions
    (reference: HadoopInputFormat.getSplits — one split per token range)."""

    split_id: int
    partitions: Tuple[int, ...]


class GraphInputFormat:
    """Splits + record reading over a graph's edgestore."""

    def __init__(self, graph):
        self.graph = graph
        self.idm = graph.idm
        self.es = graph.edge_serializer
        self.st = graph.system_types

    def splits(self, num_splits: Optional[int] = None) -> List[InputSplit]:
        """Group the ID partitions into ``num_splits`` splits, partition p
        to split p % num_splits (default: one split per partition)."""
        nparts = self.idm.num_partitions
        if num_splits is None or num_splits >= nparts:
            return [InputSplit(p, (p,)) for p in range(nparts)]
        num_splits = max(1, num_splits)
        out: List[InputSplit] = []
        for s in range(num_splits):
            parts = tuple(range(nparts))[s::num_splits]
            if parts:
                out.append(InputSplit(s, parts))
        return out

    # ------------------------------------------------------------- reading
    def read_split(self, split: InputSplit) -> Iterator[StarVertex]:
        """Deserialize every live vertex row in the split into a StarVertex
        (reference: HadoopRecordReader -> JanusGraphVertexDeserializer)."""
        g = self.graph
        btx = g.backend.begin_transaction()
        store_tx = btx.store_tx
        store = g.backend.edgestore
        schema = _codec_schema(g)
        exists_q = self.es.get_type_slice(self.st.EXISTS, False)
        label_q = self.es.get_type_slice(self.st.VERTEX_LABEL_EDGE, True, Direction.OUT)
        prop_q, edge_q = self.es.user_relations_bounds()
        relidx_ids = getattr(g, "relation_index_ids", frozenset())
        ordered = g.backend.manager.features.ordered_scan
        ranges = [self.idm.partition_key_range(p) for p in split.partitions]

        def rows():
            if ordered:
                for start, end in ranges:
                    yield from store.get_keys(KeyRangeQuery(start, end, exists_q), store_tx)
            else:
                # unordered backends (the sharded store): one full scan,
                # filtered to the split's ranges here
                for key, entries in store.get_keys(exists_q, store_tx):
                    if any(s <= key < e for s, e in ranges):
                        yield key, entries

        for key, _exist in rows():
            vid = self.idm.get_vertex_id(key)
            if not self.idm.is_user_vertex_id(vid):
                continue
            sv = StarVertex(vertex_id=self.idm.get_canonical_vertex_id(vid))
            for e in store.get_slice(KeySliceQuery(key, label_q), store_tx):
                rc = self.es.parse_relation(e, self.st.type_info)
                el = g.schema_cache.get_by_id(rc.other_vertex_id)
                if el is not None:
                    sv.label = el.name
            for e in store.get_slice(KeySliceQuery(key, prop_q), store_tx):
                try:
                    rc = self.es.parse_relation(e, schema)
                except KeyError:
                    continue
                pk = g.schema_cache.get_by_id(rc.type_id)
                if pk is not None:
                    sv.properties.setdefault(pk.name, []).append(rc.value)
            for e in store.get_slice(KeySliceQuery(key, edge_q), store_tx):
                try:
                    rc = self.es.parse_relation(e, schema)
                except KeyError:
                    continue
                if not rc.is_edge or rc.direction != Direction.OUT:
                    continue
                if rc.type_id in relidx_ids:
                    continue  # relation-index copies are not edges
                el = g.schema_cache.get_by_id(rc.type_id)
                props = {}
                for tid, val in (rc.properties or {}).items():
                    pk = g.schema_cache.get_by_id(tid)
                    if pk is not None:
                        props[pk.name] = val
                sv.edges.append(
                    (el.name if el else str(rc.type_id), rc.other_vertex_id, props)
                )
            yield sv

    def read_all(self, num_splits: Optional[int] = None) -> Iterator[StarVertex]:
        for split in self.splits(num_splits):
            yield from self.read_split(split)


def load_shard_csrs(graph, num_shards: int):
    """One CSRGraph per shard of ID partitions — the bulk path feeding each
    mesh slot or host its own slice (reference: backend-specific binary
    input formats feeding SparkGraphComputer executors)."""
    from janusgraph_tpu_torch.olap.csr import load_csr

    fmt = GraphInputFormat(graph)
    return [load_csr(graph, partitions=list(split.partitions)) for split in fmt.splits(num_shards)]


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


class DistributedIndexManagement:
    """Worker-parallel index maintenance across input splits
    (reference: MapReduceIndexManagement.java:276 running IndexRepairJob /
    IndexRemoveJob as Hadoop MR jobs)."""

    def __init__(self, graph, num_workers: int = 4):
        self.graph = graph
        self.num_workers = num_workers

    def reindex(self, index_name: str):
        """REINDEX across splits in parallel; returns merged ScanMetrics."""
        from janusgraph_tpu_torch.olap.jobs import IndexRepairJob
        from janusgraph_tpu_torch.storage.scan import ScanMetrics, StandardScanner

        g = self.graph
        idx = g.indexes.get(index_name)
        if idx is None:
            raise KeyError(f"no index named {index_name!r}")
        fmt = GraphInputFormat(g)
        splits = fmt.splits(self.num_workers)
        merged = ScanMetrics()

        def run_split(split: InputSplit) -> ScanMetrics:
            job = IndexRepairJob(g, idx)
            btx = g.backend.begin_transaction()
            scanner = StandardScanner(
                g.backend.edgestore,
                btx.store_tx,
                ordered_scan=g.backend.manager.features.ordered_scan,
            )
            ranges = [
                g.idm.partition_key_range(p) for p in split.partitions
            ]
            return scanner.execute(job, key_ranges=ranges, num_workers=1)

        from janusgraph_tpu_torch.observability import capture_scope

        # pool workers start from an empty contextvars context; without
        # the capture the per-split scan spans detach from the caller's
        # trace and ledger/deadline attribution is lost (JG402)
        with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
            for metrics in pool.map(capture_scope(run_split), splits):
                merged.merge(metrics)
        return merged
