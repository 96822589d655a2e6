"""Full-table parallel scan framework — the substrate for ALL OLAP.

Capability parity with the reference's scanner
(reference: diskstorage/keycolumnvalue/scan/StandardScanner.java:39,
StandardScannerExecutor.java:98-216 row assembly + processor pipeline,
ScanJob.java:32 SPI, ScanMetrics.java:81), re-shaped for batch work — the
port's copy of ``janusgraph_tpu/storage/scan.py``:

A `ScanJob` declares the column slices it needs; the scanner streams every
row (optionally one partition key-range at a time), assembles the per-row
slice results, and feeds (key, {query: entries}) to the job. Jobs are
expected to be *batch-oriented* — the OLAP CSR loader consumes whole
partitions and vectorizes with numpy — so unlike the reference's
one-vertex-at-a-time Processor threads, the unit of work here is a
partition chunk, which is also the natural unit for sharding.
"""

from __future__ import annotations

import threading
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from janusgraph_tpu_torch.exceptions import TemporaryBackendError
from janusgraph_tpu_torch.storage.kcvs import (
    EntryList,
    KeyColumnValueStore,
    KeyRangeQuery,
    KeySliceQuery,
    SliceQuery,
    StoreTransaction,
)


@dataclass
class ScanMetrics:
    """Progress counters (reference: scan/ScanMetrics.java)."""

    rows_processed: int = 0
    rows_skipped: int = 0
    custom: Dict[str, int] = field(default_factory=dict)
    _lock: threading.Lock = field(default_factory=threading.Lock, repr=False)

    def increment(self, name: str, delta: int = 1) -> None:
        with self._lock:
            self.custom[name] = self.custom.get(name, 0) + delta

    def add_rows(self, processed: int, skipped: int = 0) -> None:
        with self._lock:
            self.rows_processed += processed
            self.rows_skipped += skipped

    def merge(self, other: "ScanMetrics") -> None:
        with self._lock:
            self.rows_processed += other.rows_processed
            self.rows_skipped += other.rows_skipped
            for k, v in other.custom.items():
                self.custom[k] = self.custom.get(k, 0) + v


class ScanJob:
    """SPI for whole-store scans (reference: ScanJob.java:32)."""

    def get_queries(self) -> List[SliceQuery]:
        """Column slices to fetch per row; the first is the primary query —
        rows with no entries for it are skipped."""
        raise NotImplementedError

    def setup(self, metrics: ScanMetrics) -> None:
        pass

    def process(
        self,
        rows: List[Tuple[bytes, Dict[SliceQuery, EntryList]]],
        metrics: ScanMetrics,
    ) -> None:
        """Process a batch of assembled rows. Called concurrently from worker
        threads for different batches."""
        raise NotImplementedError

    def teardown(self, metrics: ScanMetrics) -> None:
        pass


class StandardScanner:
    """Runs ScanJobs over a store with partition-parallel workers."""

    def __init__(
        self,
        store: KeyColumnValueStore,
        txh: StoreTransaction,
        ordered_scan: bool = True,
        retries: int = 3,
    ):
        self.store = store
        self.txh = txh
        self.ordered_scan = ordered_scan
        #: per-partition retry budget for TemporaryBackendErrors mid-scan
        #: (a killed scan worker, a flaking shard): the range resumes from
        #: just past the last FULLY PROCESSED batch's key, so every row
        #: reaches the job exactly once (storage.scan-retries)
        self.retries = retries

    def execute(
        self,
        job: ScanJob,
        key_ranges: Optional[Sequence[Tuple[bytes, bytes]]] = None,
        num_workers: int = 1,
        batch_size: int = 4096,
    ) -> ScanMetrics:
        """Scan rows (optionally restricted to key ranges, e.g. one range per
        graph partition) and feed batches to the job.

        With `key_ranges`, ranges are scanned in parallel across
        `num_workers` threads — the analogue of the reference's
        DataPuller-per-query pipeline, except parallelism follows the
        partition structure that the OLAP loaders also split by.
        """
        metrics = ScanMetrics()
        queries = job.get_queries()
        if not queries:
            raise ValueError("ScanJob declared no queries")
        from janusgraph_tpu_torch.observability import capture_scope, registry, span

        with span(
            "store.scan", job=type(job).__name__, store=self.store.name,
            workers=num_workers,
        ) as sp, registry.time("storage.scan"):
            job.setup(metrics)
            try:
                if key_ranges is None:
                    self._scan_range(job, queries, None, metrics, batch_size)
                elif not self.ordered_scan:
                    # unordered backend: ONE full scan routed against the
                    # union of ranges (a per-range scan would re-read the
                    # whole store P times)
                    self._scan_unordered(
                        job, queries, key_ranges, metrics, batch_size
                    )
                elif num_workers <= 1 or len(key_ranges) <= 1:
                    for rng in key_ranges:
                        self._scan_range(job, queries, rng, metrics, batch_size)
                else:
                    # capture_scope: worker threads re-enter this span's
                    # context so per-range store reads stay attributed to
                    # the scan's trace/ledger/deadline (JG402 handoff)
                    scan_range = capture_scope(self._scan_range)
                    with ThreadPoolExecutor(max_workers=num_workers) as pool:
                        futs = [
                            pool.submit(
                                scan_range, job, queries, rng, metrics,
                                batch_size,
                            )
                            for rng in key_ranges
                        ]
                        for f in futs:
                            f.result()
            finally:
                job.teardown(metrics)
                sp.annotate(rows=metrics.rows_processed)
        return metrics

    def _scan_unordered(
        self,
        job: ScanJob,
        queries: List[SliceQuery],
        key_ranges: Sequence[Tuple[bytes, bytes]],
        metrics: ScanMetrics,
        batch_size: int,
    ) -> None:
        """One full unordered scan with client-side range filtering
        (reference: the CQL token-range getKeys path)."""
        primary, rest = queries[0], queries[1:]
        batch: List[Tuple[bytes, Dict[SliceQuery, EntryList]]] = []
        for key, primary_entries in self.store.get_keys(primary, self.txh):
            if not any(lo <= key < hi for lo, hi in key_ranges):
                continue
            slices: Dict[SliceQuery, EntryList] = {primary: primary_entries}
            for q in rest:
                slices[q] = self.store.get_slice(KeySliceQuery(key, q), self.txh)
            batch.append((key, slices))
            if len(batch) >= batch_size:
                job.process(batch, metrics)
                metrics.add_rows(len(batch))
                batch = []
        if batch:
            job.process(batch, metrics)
            metrics.add_rows(len(batch))

    def _scan_range(
        self,
        job: ScanJob,
        queries: List[SliceQuery],
        key_range: Optional[Tuple[bytes, bytes]],
        metrics: ScanMetrics,
        batch_size: int,
    ) -> None:
        """One partition range, with retry + resume: a TemporaryBackendError
        mid-stream (killed worker, flaking shard, injected chaos) re-issues
        the range from just past the last batch handed to the job. Rows of a
        PARTIAL batch are dropped and re-read — the job sees every row
        exactly once. Full unbounded scans (key_range=None) cannot resume
        precisely on an unordered backend and propagate the error."""
        primary, rest = queries[0], queries[1:]
        resume_after: Optional[bytes] = None
        attempt = 0
        while True:
            try:
                if key_range is None:
                    row_iter = self.store.get_keys(primary, self.txh)
                else:
                    start = (
                        key_range[0] if resume_after is None else resume_after
                    )
                    row_iter = self.store.get_keys(
                        KeyRangeQuery(start, key_range[1], primary), self.txh
                    )
                batch: List[Tuple[bytes, Dict[SliceQuery, EntryList]]] = []
                for key, primary_entries in row_iter:
                    slices: Dict[SliceQuery, EntryList] = {
                        primary: primary_entries
                    }
                    for q in rest:
                        slices[q] = self.store.get_slice(
                            KeySliceQuery(key, q), self.txh
                        )
                    batch.append((key, slices))
                    if len(batch) >= batch_size:
                        job.process(batch, metrics)
                        metrics.add_rows(len(batch))
                        # smallest key strictly after the processed prefix
                        resume_after = key + b"\x00"
                        batch = []
                if batch:
                    job.process(batch, metrics)
                    metrics.add_rows(len(batch))
                return
            except TemporaryBackendError:
                attempt += 1
                if key_range is None or attempt > self.retries:
                    raise
                from janusgraph_tpu_torch.observability import registry

                metrics.increment("scan.retries")
                registry.counter("storage.scan.retries").inc()
