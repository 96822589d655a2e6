"""The port's scan framework, its jobs and the readers of a graph that
carries a relation index, held to the JAX package's.

After ``tests/test_backend.py:151-190``: ``StandardScanner`` feeds every
row once (whole store, partition ranges on worker threads, an unordered
scan routed against the ranges, rows without the primary slice skipped,
a range resumed after a temporary failure) with the same rows as the
reference's. After ``tests/test_schema_ttl.py:186-260``: composite index
entries of a TTL'd key expire with their cells, and the ghost remover
reclaims an expired static vertex. After ``tests/test_input_format.py:72``:
``DistributedIndexManagement`` reindexes over input splits. Then the
readers of ``relation_index_ids`` on a graph whose "link" edges carry a
vertex-centric index: the cold scan (numpy and native), ``refresh_csr``,
the change capture and the input format each skip the index copies, and
their arrays equal the reference's. Exact equality throughout.
"""

import threading

import numpy as np
import pytest

from janusgraph_tpu_torch import native
from janusgraph_tpu_torch.exceptions import TemporaryBackendError
from janusgraph_tpu_torch.storage import scan
from tests.test_torch_index_lifecycle import PORT, REF, assert_twins, rows

CSR_FIELDS = ("vertex_ids", "out_indptr", "out_dst", "in_indptr", "in_src", "out_degree",
              "labels", "in_edge_type", "out_edge_type")


def _counting_job(pkg, query):
    class CountingJob(pkg.scan.ScanJob):
        def __init__(self):
            self.rows, self.lock = [], threading.Lock()
            self.setup_called = self.teardown_called = False

        def get_queries(self):
            return [query]

        def setup(self, metrics):
            self.setup_called = True

        def process(self, batch, metrics):
            with self.lock:
                self.rows.extend((k, tuple(v[query])) for k, v in batch)

        def teardown(self, metrics):
            self.teardown_called = True

    return CountingJob()


def _scan_case(pkg, case):
    mgr = pkg.inmemory.InMemoryStoreManager()
    store = mgr.open_database("s")
    tx = mgr.begin_transaction()
    SQ = pkg.kcvs.SliceQuery
    if case == "partitioned":
        for i in range(64):
            store.mutate(bytes([i]) + b"x", [(b"c", b"v")], [], tx)
        ranges = [(bytes([lo]), bytes([lo + 16])) for lo in range(0, 64, 16)]
        job = _counting_job(pkg, SQ())
        metrics = pkg.scan.StandardScanner(store, tx).execute(
            job, key_ranges=ranges, num_workers=4, batch_size=5)
    elif case == "skip":
        store.mutate(b"a", [(b"\x01", b"v")], [], tx)
        store.mutate(b"b", [(b"\x99", b"v")], [], tx)
        job = _counting_job(pkg, SQ(b"\x00", b"\x50"))
        metrics = pkg.scan.StandardScanner(store, tx).execute(job)
    else:
        for i in range(100):
            store.mutate(i.to_bytes(4, "big"), [(b"c", b"v%d" % i)], [], tx)
        job = _counting_job(pkg, SQ())
        ranges = [(i.to_bytes(4, "big"), (i + 50).to_bytes(4, "big")) for i in (0, 50)]
        if case == "unordered":
            metrics = pkg.scan.StandardScanner(store, tx, ordered_scan=False).execute(
                job, key_ranges=ranges, batch_size=7)
        else:
            metrics = pkg.scan.StandardScanner(store, tx).execute(job, batch_size=7)
    return sorted(job.rows), metrics.rows_processed, job.setup_called, job.teardown_called


@pytest.mark.parametrize("case", ["all", "partitioned", "skip", "unordered"])
def test_scanner_feeds_the_rows_of_the_reference(case):
    want, got = _scan_case(REF, case), _scan_case(PORT, case)
    assert got == want
    assert got[1] == len(got[0]) and got[2] and got[3]
    assert got[1] == {"all": 100, "partitioned": 64, "skip": 1, "unordered": 100}[case]


def test_a_range_resumes_after_a_temporary_failure():
    mgr = PORT.inmemory.InMemoryStoreManager()
    store = mgr.open_database("s")
    tx = mgr.begin_transaction()
    for i in range(40):
        store.mutate(bytes([i]), [(b"c", b"v")], [], tx)
    real = store.get_keys
    calls = {"n": 0}

    def flaky(query, txh):
        calls["n"] += 1
        for i, item in enumerate(real(query, txh)):
            if calls["n"] == 1 and i == 12:
                raise TemporaryBackendError("injected")
            yield item

    store.get_keys = flaky
    job = _counting_job(PORT, PORT.kcvs.SliceQuery())
    metrics = scan.StandardScanner(store, tx, retries=2).execute(
        job, key_ranges=[(b"\x00", b"\xff")], batch_size=5)
    assert [k for k, _ in sorted(job.rows)] == [bytes([i]) for i in range(40)]
    assert metrics.rows_processed == 40 and metrics.custom == {"scan.retries": 1}


def _expire(g):
    for s in (g.backend.edgestore, g.backend.indexstore):
        store = s
        while hasattr(store, "wrapped"):
            store = store.wrapped
        for k in list(store._expiry):
            store._expiry[k] -= 2_000_000_000
    g.backend.clear_caches()


def test_ttl_index_entries_expire_with_their_cells():
    def scenario(pkg, g):
        m = g.management()
        m.make_property_key("session", str)
        m.build_composite_index("bySession", ["session"])
        m.set_ttl("session", 1)
        tx = g.new_transaction()
        v = tx.add_vertex()
        v.property("session", "tok")
        tx.commit()
        seen = [[x.id for x in g.traversal().V().has("session", "tok").to_list()] == [v.id]]
        _expire(g)
        return seen + [g.traversal().V().has("session", "tok").to_list()]

    assert assert_twins(scenario) == [True, []]


def test_the_ghost_remover_reclaims_an_expired_static_vertex():
    def scenario(pkg, g):
        m = g.management()
        m.make_vertex_label("tick", static=True)
        m.set_ttl("tick", 1)
        m.make_property_key("at", int)
        tx = g.new_transaction()
        v = tx.add_vertex(label="tick")
        v.property("at", 7)
        w = tx.add_vertex()
        w.property("at", 9)
        tx.commit()
        _expire(g)
        metrics = pkg.jobs.run_scan_job(g, pkg.jobs.GhostVertexRemover(g))
        tx = g.new_transaction()
        seen = [dict(metrics.custom), tx.get_vertex(v.id) is None,
                tx.get_vertex(w.id).value("at")]
        tx.rollback()
        return seen

    # the label's TTL expires every cell of the vertex, so no ghost row stays
    assert assert_twins(scenario) == [{}, True, 9]


@pytest.mark.parametrize("workers", [1, 3])
def test_distributed_index_management_reindexes_over_splits(workers):
    def scenario(pkg, g):
        pkg.gods.load(g)
        g.management().build_composite_index("age_idx2", ["age"])
        dim = pkg.input_format.DistributedIndexManagement(g, num_workers=workers)
        metrics = dim.reindex("age_idx2")
        t = g.traversal()
        return [metrics.rows_processed, dict(metrics.custom),
                t.V().has("age", 10000).values("name").to_list(), rows(g)]

    seen = assert_twins(scenario)
    assert seen[1]["index-entries-added"] == 6 and seen[2] == ["saturn"]


def test_repair_and_remove_jobs_run_directly():
    def scenario(pkg, g):
        pkg.gods.load(g)
        idx = g.indexes["age"]
        repaired = pkg.jobs.run_scan_job(g, pkg.jobs.IndexRepairJob(g, idx), num_workers=2,
                                         batch_size=3)
        removed = pkg.jobs.IndexRemoveJob(g, idx).run()
        return [repaired.rows_processed, dict(repaired.custom), removed.rows_processed,
                dict(removed.custom), rows(g)]

    seen = assert_twins(scenario)
    assert seen[1]["index-entries-added"] == 6 and seen[3]["index-entries-removed"] == 6


# ---------------------------------------------- readers of relation_index_ids

def _linked(pkg, g):
    """A ring of "link" edges with a time, under a relation index, then a
    later transaction of new and removed edges."""
    m = g.management()
    m.make_property_key("time", int)
    m.make_edge_label("link")
    tx = g.new_transaction()
    vs = [tx.add_vertex() for _ in range(12)]
    for i in range(12):
        tx.add_edge(vs[i], "link", vs[(i + 1) % 12], time=i)
        tx.add_edge(vs[i], "link", vs[(i + 5) % 12], time=100 + i)
    tx.commit()
    m.build_edge_index("link", "linkByTime", ["time"])
    m.reindex_relation_index("linkByTime")
    return [v.id for v in vs]


def _later_writes(pkg, g, vids):
    tx = g.new_transaction()
    for i in range(0, 12, 3):
        tx.add_edge(tx.get_vertex(vids[i]), "link", tx.get_vertex(vids[(i + 7) % 12]), time=50 + i)
    e = tx.get_edges(tx.get_vertex(vids[1]), pkg.codecs.Direction.OUT, ("link",))[0]
    e.remove()
    tx.commit()


def _csr_arrays(c):
    return {f: np.asarray(getattr(c, f)).tolist() for f in CSR_FIELDS}


@pytest.mark.parametrize("native_scan", [True, False])
def test_the_cold_scan_skips_the_copies(native_scan):
    def scenario(pkg, g):
        _linked(pkg, g)
        if pkg is PORT and not native_scan:
            with native.numpy_only():
                c = pkg.csr.load_csr(g)
        else:
            c = pkg.csr.load_csr(g)
        return [len(g.relation_index_ids), c.num_edges, _csr_arrays(c)]

    assert assert_twins(scenario)[:2] == [1, 24]


def test_refresh_csr_skips_the_copies():
    def scenario(pkg, g):
        vids = _linked(pkg, g)
        base, epoch = pkg.csr.load_csr_snapshot(g)
        _later_writes(pkg, g, vids)
        fresh, upto = pkg.csr.refresh_csr(g, base, epoch)
        cold = pkg.csr.load_csr(g)
        assert _csr_arrays(fresh) == _csr_arrays(cold)
        return [fresh.num_edges, _csr_arrays(fresh)]

    assert assert_twins(scenario)[0] == 27


def test_the_change_capture_skips_the_copies():
    def scenario(pkg, g):
        vids = _linked(pkg, g)
        base, epoch = pkg.csr.load_csr_snapshot(g)
        _later_writes(pkg, g, vids)
        overlay, _ = pkg.delta.overlay_since(g, epoch)
        merged = pkg.delta.materialize(base, overlay, g.idm)
        cold = pkg.csr.load_csr(g)
        for f in ("vertex_ids", "out_indptr", "out_dst", "in_indptr", "in_src"):
            np.testing.assert_array_equal(getattr(merged, f), getattr(cold, f))
        return [overlay.add.tolist(), overlay.tomb.tolist(), merged.num_edges]

    seen = assert_twins(scenario)
    assert len(seen[0]) == 4 and len(seen[1]) == 1 and seen[2] == 27


def test_the_input_format_skips_the_copies():
    def scenario(pkg, g):
        _linked(pkg, g)
        svs = list(pkg.input_format.GraphInputFormat(g).read_all(num_splits=3))
        return sorted((sv.vertex_id, sorted((lbl, o, sorted(p.items())) for lbl, o, p in sv.edges))
                      for sv in svs)

    seen = assert_twins(scenario)
    assert sum(len(e) for _v, e in seen) == 24
