"""The port's fault injector held to the JAX package's (after
``tests/test_chaos.py``).

The same ``FaultPlan`` arguments give the same decisions, counters and
journal in both packages, kind by kind; the fault-injecting store kills a
scan that ``StandardScanner`` resumes (every row once) or that exhausts
its retries; a PageRank preempted by the plan's ``olap_hook`` resumes
from its checkpoint bitwise equal to the uninterrupted run, and without
checkpoints the preemption reaches the caller; the injected lock-lease
expiry kills one commit, which the workload retries. Journals, counters,
rows and ranks are compared exactly; the port's PageRank against the
reference's at rtol 1e-6 (the two executors round ``(1-d)/n + d*y``
differently, see ``tests/test_torch_fused.py``).
"""

import numpy as np
import pytest

from janusgraph_tpu.core.graph import JanusGraphTPU as RefGraph
from janusgraph_tpu.exceptions import TemporaryBackendError as RefTemporary
from janusgraph_tpu.olap.computer import run_on as ref_run_on
from janusgraph_tpu.olap.csr import load_csr as ref_load_csr
from janusgraph_tpu.olap.programs.pagerank import PageRankProgram as RefPR
from janusgraph_tpu.storage import faults as ref_faults
from janusgraph_tpu.storage.inmemory import InMemoryStoreManager as RefInMemory
from janusgraph_tpu.storage.scan import StandardScanner as RefScanner
from janusgraph_tpu_torch.core.graph import JanusGraphTPU
from janusgraph_tpu_torch.exceptions import (
    InjectedCrashError,
    InjectedFaultError,
    PermanentBackendError,
    SuperstepPreempted,
    TemporaryBackendError,
    TemporaryLockingError,
)
from janusgraph_tpu_torch.olap.computer import run_on
from janusgraph_tpu_torch.olap.csr import load_csr
from janusgraph_tpu_torch.olap.programs import PageRankProgram
from janusgraph_tpu_torch.storage import faults
from janusgraph_tpu_torch.storage.inmemory import InMemoryStoreManager
from janusgraph_tpu_torch.storage.kcvs import KCVMutation, SliceQuery
from janusgraph_tpu_torch.storage.scan import StandardScanner

SEED = 20260804


def _drive_reads(plan, errors, n=400):
    hits = []
    for i in range(n):
        try:
            plan.before_read("edgestore")
        except errors:
            hits.append(i)
    return hits


def test_fault_plan_same_seed_same_decisions():
    a = _drive_reads(faults.FaultPlan(seed=7, read_error_rate=0.05), TemporaryBackendError)
    b = _drive_reads(faults.FaultPlan(seed=7, read_error_rate=0.05), TemporaryBackendError)
    c = _drive_reads(faults.FaultPlan(seed=8, read_error_rate=0.05), TemporaryBackendError)
    ref = _drive_reads(ref_faults.FaultPlan(seed=7, read_error_rate=0.05), RefTemporary)
    assert a == b == ref
    assert a, "a 5% rate over 400 ops should fire at least once"
    assert a != c


def _drive_journal(mod, errors):
    plan = mod.FaultPlan(seed=3, read_error_rate=0.04, write_error_rate=0.04)
    for _ in range(100):
        for hook in (plan.before_read, plan.before_write):
            try:
                hook("edgestore")
            except errors:
                pass
    return plan.journal, plan.counters()


def test_fault_plan_journal_is_deterministic():
    port = _drive_journal(faults, TemporaryBackendError)
    assert port == _drive_journal(faults, TemporaryBackendError)
    assert port == _drive_journal(ref_faults, RefTemporary)
    assert port[0]


def _every_decision(mod):
    """Every pure decision of the plan, scheduled kinds and hooks alike;
    returns (what each call answered, the journal, the counters)."""
    plan = mod.FaultPlan(
        seed=11, read_error_rate=0.03, write_error_rate=0.03, latency_rate=0.02,
        latency_ms=0.01, torn_mutation_at=5, lock_expiry_at=4, scan_kill_at=2,
        scan_kill_after_rows=3, preempt_superstep=2, overload_at=7, overload_ops=2,
        overload_latency_ms=0.01, shard_preempt_superstep=3, collective_timeout_at=1,
        halo_drop_at=2, straggler_ms=0.01, straggler_rate=0.3, replica_kill_at=2,
        replica_restart_at=4, replica_partition_at=3, replica_partition_ops=2,
        replica_target=-1, cdc_torn_at=2, follower_lag_at=1, follower_lag_pulls=2,
        stall_lock_at=2, stall_lock_ms=1.0, wedge_thread_at=3,
    )
    plan.arm_replica(plan.replica_target(3), 3)
    seen = []

    def call(fn, *a):
        try:
            out = fn(*a)
            seen.append(("ok", out if not isinstance(out, int) or out < 10**15 else "clock"))
        except Exception as e:  # noqa: BLE001 - the exception's class is the decision
            seen.append(("raised", type(e).__name__))

    for i in range(12):
        call(plan.before_read, "edgestore")
        call(plan.before_write, "graphindex")
        call(plan.mutate_many_decision)
        call(plan.scan_decision)
        call(plan.cdc_torn_write)
        call(plan.follower_lag)
        call(plan.stalled_lock, "lk")
        call(plan.wedge_thread)
        call(plan.fleet_hook, 3)
        call(plan.sharded_hook, i, 4)
        call(plan.olap_hook, i)
        call(plan.straggler_decisions, i, 4)
        seen.append(("clock", plan.lock_clock_ns() > 0))
    return seen, plan.journal, plan.counters()


def test_every_decision_equals_the_reference():
    assert _every_decision(faults) == _every_decision(ref_faults)


def test_injected_errors_sit_in_the_backend_taxonomy():
    assert issubclass(InjectedFaultError, TemporaryBackendError)
    assert issubclass(InjectedCrashError, PermanentBackendError)
    plan = faults.FaultPlan(seed=1, torn_mutation_at=0)
    mgr = faults.FaultInjectingStoreManager(InMemoryStoreManager(), plan)
    tx = mgr.begin_transaction()
    muts = {"edgestore": {bytes([0, i]): KCVMutation(additions=[(b"c", b"v")]) for i in range(6)}}
    with pytest.raises(InjectedCrashError, match="torn after 3/6"):
        mgr.mutate_many(muts, tx)
    raw = mgr.wrapped.open_database("edgestore")
    assert [k for k, _ in raw.get_keys(SliceQuery(), tx)] == [bytes([0, i]) for i in range(3)]
    assert plan.journal == [{"kind": "torn", "n": 0, "applied_rows": 3, "total_rows": 6}]
    # system stores pass through untouched
    assert type(mgr.open_database("janusgraph_ids")).__name__ != "FaultInjectingStore"
    assert mgr.name == "faulty(InMemoryStoreManager)"


class _CollectJob:
    def __init__(self):
        self.keys = []

    def get_queries(self):
        return [SliceQuery()]

    def setup(self, metrics):
        pass

    def process(self, rows, metrics):
        self.keys.extend(k for k, _slices in rows)

    def teardown(self, metrics):
        pass


def _killed_scan(mod, mgr_cls, scanner_cls):
    plan = mod.FaultPlan(seed=1, scan_kill_at=0, scan_kill_after_rows=5)
    mgr = mod.FaultInjectingStoreManager(mgr_cls(), plan)
    raw = mgr.wrapped.open_database("edgestore")
    tx = mgr.begin_transaction()
    keys = [bytes([0, i]) for i in range(32)]
    for k in keys:
        raw.mutate(k, [(b"c", b"v")], [], tx)
    job = _CollectJob()
    metrics = scanner_cls(mgr.open_database("edgestore"), tx, retries=3).execute(
        job, key_ranges=[(bytes([0]), bytes([1]))], batch_size=4
    )
    return sorted(job.keys), metrics.rows_processed, metrics.custom.get("scan.retries", 0), plan.journal


def test_scanner_resumes_after_injected_kill():
    keys, rows, retries, journal = _killed_scan(faults, InMemoryStoreManager, StandardScanner)
    assert keys == [bytes([0, i]) for i in range(32)], "every row exactly once despite the kill"
    assert rows == 32 and retries >= 1
    assert any(e["kind"] == "scan" for e in journal)
    assert (keys, rows, retries, journal) == _killed_scan(ref_faults, RefInMemory, RefScanner)


def test_scanner_exhausts_retries_and_raises():
    class _Plan(faults.FaultPlan):
        def scan_decision(self):
            n = self._tick("scan")
            return n, n <= 1  # kill scans 0 and 1: with retries=1 the second surfaces

    plan = _Plan(seed=1, scan_kill_after_rows=0)
    mgr = faults.FaultInjectingStoreManager(InMemoryStoreManager(), plan)
    tx = mgr.begin_transaction()
    raw = mgr.wrapped.open_database("edgestore")
    for i in range(8):
        raw.mutate(bytes([0, i]), [(b"c", b"v")], [], tx)
    scanner = StandardScanner(mgr.open_database("edgestore"), tx, retries=1)
    with pytest.raises(TemporaryBackendError):
        scanner.execute(_CollectJob(), key_ranges=[(bytes([0]), bytes([1]))])
    assert [e["kind"] for e in plan.journal] == ["scan", "scan"]


def _tiny_graph(graph_cls, mgr_cls, config, n=16):
    # irregular degrees: a regular graph's uniform rank is already
    # PageRank's fixed point and the run would stop before the preemption
    g = graph_cls(dict(config, **{"ids.authority-wait-ms": 0.0}), store_manager=mgr_cls())
    tx = g.new_transaction()
    vs = [tx.add_vertex() for _ in range(n)]
    for i in range(n):
        tx.add_edge(vs[i], "knows", vs[(i + 1) % n])
        if i % 3 == 0:
            tx.add_edge(vs[i], "knows", vs[0])
        if i % 4 == 1:
            tx.add_edge(vs[i], "knows", vs[(i * i + 2) % n])
    tx.commit()
    return g


@pytest.mark.parametrize("fused", [False, True], ids=["host-loop", "fused"])
def test_preempted_pagerank_resumes_bitwise_identical(tmp_path, fused):
    g = _tiny_graph(JanusGraphTPU, InMemoryStoreManager, {"computer.executor": "cpu"})
    rg = _tiny_graph(RefGraph, RefInMemory, {"computer.sharded-auto": False})
    csr, rcsr = load_csr(g), ref_load_csr(rg)
    for f in ("vertex_ids", "in_indptr", "in_src", "out_indptr", "out_dst"):
        assert np.array_equal(getattr(csr, f), getattr(rcsr, f)), f
    at, iters = (4, 10) if fused else (5, 12)
    baseline = run_on(csr, PageRankProgram(max_iterations=iters), device="cpu")
    plan = faults.FaultPlan(seed=SEED, preempt_superstep=at)
    ex_kw = {} if fused else {"sync_every": 1}
    from janusgraph_tpu_torch.olap.gpu_executor import GPUExecutor

    ex = GPUExecutor(csr, device="cpu")
    faulted = ex.run(
        PageRankProgram(max_iterations=iters), fused=fused,
        checkpoint_path=str(tmp_path / "pr.npz"), checkpoint_every=2,
        fault_hook=plan.olap_hook, **ex_kw,
    )
    ref_plan = ref_faults.FaultPlan(seed=SEED, preempt_superstep=at)
    ref_out = ref_run_on(
        rcsr, RefPR(max_iterations=iters), "cpu",
        checkpoint_path=str(tmp_path / "ref.npz"), checkpoint_every=2,
        fault_hook=ref_plan.olap_hook,
    )
    assert plan.journal == ref_plan.journal == [{"kind": "superstep", "n": 0, "step": at}]
    for key in baseline:
        assert baseline[key].dtype == faulted[key].dtype
        assert np.array_equal(baseline[key], faulted[key]), key
    np.testing.assert_allclose(faulted["rank"], ref_out["rank"], rtol=1e-6)
    g.close()
    rg.close()


def test_preemption_without_checkpointing_propagates():
    """The host loop consults the hook every superstep (as the reference's
    "cpu" executor), so the preemption reaches the caller."""
    from janusgraph_tpu_torch.olap.gpu_executor import GPUExecutor

    g = _tiny_graph(JanusGraphTPU, InMemoryStoreManager, {"computer.executor": "cpu"}, n=8)
    csr = load_csr(g)
    plan = faults.FaultPlan(seed=SEED, preempt_superstep=2)
    with pytest.raises(SuperstepPreempted):
        GPUExecutor(csr, device="cpu").run(
            PageRankProgram(max_iterations=8), fused=False, fault_hook=plan.olap_hook
        )
    ref_plan = ref_faults.FaultPlan(seed=SEED, preempt_superstep=2)
    from janusgraph_tpu.exceptions import SuperstepPreempted as RefPreempted

    with pytest.raises(RefPreempted):
        ref_run_on(ref_load_csr(_tiny_graph(RefGraph, RefInMemory, {}, n=8)),
                   RefPR(max_iterations=8), "cpu", fault_hook=ref_plan.olap_hook)
    assert plan.journal == ref_plan.journal == [{"kind": "superstep", "n": 0, "step": 2}]
    g.close()


_LOCK_CFG = {
    "ids.authority-wait-ms": 0.0,
    "locks.wait-ms": 0.0,
    "storage.faults.enabled": True,
    "storage.faults.seed": SEED,
    "storage.faults.lock-expiry-at": 2,
    "tx.log-tx": False,
}


def _lock_expiry_run(graph_cls, mgr_cls, config, locking_error):
    graph = graph_cls(dict(_LOCK_CFG, **config), store_manager=mgr_cls())
    mgmt = graph.management()
    mgmt.make_property_key("uid", int)
    mgmt.build_composite_index("byU", ["uid"], unique=True)
    expired = []
    for i in range(6):
        tx = graph.new_transaction()
        tx.add_vertex(uid=i)
        try:
            tx.commit()
        except locking_error as e:
            expired.append((i, "lease expired" in str(e)))
            tx2 = graph.new_transaction()
            tx2.add_vertex(uid=i)
            tx2.commit()  # re-acquirable at once
    tx = graph.new_transaction(read_only=True)
    found = [bool(graph.index_lookup(tx, "byU", (i,))) for i in range(6)]
    tx.rollback()
    out = (expired, found, graph.fault_plan.journal)
    graph.close()
    return out


def test_injected_lock_expiry_is_retried_by_workload():
    from janusgraph_tpu.exceptions import TemporaryLockingError as RefLocking

    port = _lock_expiry_run(JanusGraphTPU, InMemoryStoreManager, {"computer.executor": "cpu"},
                            TemporaryLockingError)
    expired, found, journal = port
    assert len(expired) == 1 and expired[0][1]
    assert all(found)
    assert [e["kind"] for e in journal] == ["lock"]
    assert port == _lock_expiry_run(RefGraph, RefInMemory, {"computer.sharded-auto": False},
                                    RefLocking)


def test_the_fault_options_reach_the_plan():
    g = JanusGraphTPU({
        "computer.executor": "cpu", "storage.faults.enabled": True,
        "storage.faults.seed": 9, "storage.faults.read-error-rate": 0.5,
        "storage.faults.scan-kill-at": 3, "storage.faults.stores": "edgestore",
        "storage.faults.cdc-torn-at": 4, "storage.faults.overload-at": 2,
    })
    plan = g.fault_plan
    assert (plan.seed, plan.read_error_rate, plan.scan_kill_at, plan.stores,
            plan.cdc_torn_at, plan.overload_at) == (9, 0.5, 3, ("edgestore",), 4, 2)
    assert isinstance(g.backend.manager, faults.FaultInjectingStoreManager)
    assert g.backend.edge_locker.clock_ns == plan.lock_clock_ns
    g.close()
    assert JanusGraphTPU({"computer.executor": "cpu"}).fault_plan is None
