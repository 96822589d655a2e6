"""The port's chaos soak held to the JAX package's (after the soak of
``tests/test_chaos.py`` and the ``chaos`` subcommand).

A seeded plan on the in-memory backend drives a 200-transaction OLTP
workload and a PageRank submit through read and write faults, a lock-lease
expiry, a scan kill the CSR load absorbs, a superstep preemption the
executor's checkpoint auto-resume absorbs, and a torn batch that crashes
a commit. The faulted submit's states equal a fault-free ``run_on`` over
the same snapshot bit for bit; a reopen's torn-commit recovery replays
the torn transaction (its vertex, properties and edge), a second pass
heals nothing, and the rest of the workload completes. The same seed
gives the same journal and crash point twice, and the same journal, crash
point and counters as the reference's soak. The ``chaos`` subcommand's
report has the reference's keys and, seed for seed, its values (the
transaction ids and walls aside). Exact equality throughout.
"""

import json

import numpy as np
import pytest

from janusgraph_tpu import cli as ref_cli
from janusgraph_tpu.core.graph import JanusGraphTPU as RefGraph
from janusgraph_tpu.exceptions import InjectedCrashError as RefCrash
from janusgraph_tpu.exceptions import TemporaryBackendError as RefTemporary
from janusgraph_tpu.olap.programs.pagerank import PageRankProgram as RefPR
from janusgraph_tpu.storage.inmemory import InMemoryStoreManager as RefInMemory
from janusgraph_tpu_torch import cli
from janusgraph_tpu_torch.core.codecs import Direction
from janusgraph_tpu_torch.core.graph import JanusGraphTPU
from janusgraph_tpu_torch.core.txlog import TornCommitRecovery
from janusgraph_tpu_torch.exceptions import InjectedCrashError, TemporaryBackendError
from janusgraph_tpu_torch.olap.computer import run_on
from janusgraph_tpu_torch.olap.csr import load_csr
from janusgraph_tpu_torch.olap.programs import PageRankProgram
from janusgraph_tpu_torch.storage.inmemory import InMemoryStoreManager

SEED = 20260804
N_TXS = 200
_SOAK_CFG = {
    "ids.authority-wait-ms": 0.0,
    "locks.wait-ms": 0.0,
    "tx.log-tx": True,
    "tx.max-commit-time-ms": 0.0,
    "cache.db-cache-time-ms": 600_000.0,  # no TTL churn mid-soak
    "storage.scan-parallelism": 1,  # sequential scans: deterministic ticks
    "storage.backoff-base-ms": 1.0,
    "storage.backoff-max-ms": 4.0,
    "computer.checkpoint-every": 2,
}
_FAULT_CFG = {
    "storage.faults.enabled": True,
    "storage.faults.seed": SEED,
    "storage.faults.read-error-rate": 0.01,
    "storage.faults.write-error-rate": 0.01,
    "storage.faults.torn-mutation-at": 150,
    "storage.faults.lock-expiry-at": 60,
    "storage.faults.scan-kill-at": 40,
    "storage.faults.scan-kill-after-rows": 1,
    "storage.faults.preempt-superstep": 3,
}
PORT = dict(graph=JanusGraphTPU, mgr=InMemoryStoreManager, temporary=TemporaryBackendError,
            crash=InjectedCrashError, pr=PageRankProgram, cfg={"computer.executor": "cpu"})
#: the reference's jitted executor ("tpu" on the CPU), which the port's
#: GPUExecutor ports: both consult the fault hook at chunk boundaries
#: (supersteps 0, 2, 4 with checkpoints every 2), where the reference's
#: numpy "cpu" executor consults it every superstep
REF = dict(graph=RefGraph, mgr=RefInMemory, temporary=RefTemporary, crash=RefCrash, pr=RefPR,
           cfg={"computer.executor": "tpu", "computer.sharded-auto": False})


def _write_tx(pkg, graph, i):
    """One workload transaction, re-run on a temporary fault (a lease
    expiry kills the whole transaction); an injected crash propagates."""
    for attempt in range(12):
        tx = graph.new_transaction()
        try:
            v = tx.add_vertex(uid=i, name=f"v{i}")
            if i > 0:
                prev = graph.index_lookup(tx, "byUid", (i - 1,))
                if prev:
                    pv = tx.get_vertex(prev[0])
                    if pv is not None:
                        tx.add_edge(v, "next", pv)
            tx.commit()
            return
        except pkg["temporary"]:
            if tx.is_open:
                tx.rollback()
            if attempt == 11:
                raise
        except BaseException:
            if tx.is_open:
                tx.rollback()
            raise


def _run_soak_until_crash(pkg, mgr, tmp_path, tag):
    """Schema, 120 transactions, a chaos PageRank submit (scan kill,
    preemption, auto-resume), then transactions until the scheduled torn
    batch crashes a commit. The graph is abandoned unclosed: the crash."""
    cfg = {**_SOAK_CFG, **_FAULT_CFG, **pkg["cfg"],
           "computer.checkpoint-path": str(tmp_path / f"soak-{tag}.npz")}
    graph = pkg["graph"](cfg, store_manager=mgr)
    plan = graph.fault_plan
    assert plan is not None and plan.seed == SEED
    mgmt = graph.management()
    mgmt.make_property_key("uid", int)
    mgmt.make_property_key("name", str)
    mgmt.build_composite_index("byUid", ["uid"], unique=True)
    for i in range(120):
        _write_tx(pkg, graph, i)
    result = graph.compute().program(pkg["pr"](max_iterations=8)).submit()
    crashed_i = None
    try:
        for i in range(120, N_TXS):
            _write_tx(pkg, graph, i)
    except pkg["crash"]:
        crashed_i = i
    return graph, plan, crashed_i, result


def test_chaos_soak_end_to_end(tmp_path):
    mgr = InMemoryStoreManager()
    g1, plan, crashed_i, result = _run_soak_until_crash(PORT, mgr, tmp_path, "a")
    assert result.states["rank"].shape[0] == 120
    # the preempted-and-resumed submit equals a fault-free run over the
    # same snapshot, bit for bit
    assert result.run_info["snapshot"]["path"] == "cold"
    clean = run_on(result.csr, PageRankProgram(max_iterations=8), device="cpu")
    for key in clean:
        assert clean[key].dtype == result.states[key].dtype
        assert np.array_equal(clean[key], result.states[key]), key
    assert result.run_info["resumes"] == 1
    kinds = [e["kind"] for e in plan.journal]
    assert crashed_i is not None, "the scheduled torn batch never fired"
    for kind in ("torn", "lock", "superstep", "scan"):
        assert kind in kinds, kind

    # reopen with faults off: torn-commit recovery rolls the torn batch forward
    graph2 = JanusGraphTPU({**_SOAK_CFG, **PORT["cfg"]}, store_manager=mgr)
    rec = graph2.last_torn_recovery
    assert rec is not None and len(rec["replayed"]) == 1, rec
    tx = graph2.new_transaction(read_only=True)
    ids = graph2.index_lookup(tx, "byUid", (crashed_i,))
    assert len(ids) == 1
    v = tx.get_vertex(ids[0])
    assert tx.get_properties(v, "name")[0].value == f"v{crashed_i}"
    assert tx.get_edges(v, Direction.OUT, ("next",)), "the torn transaction's edge is replayed"
    tx.rollback()
    assert TornCommitRecovery(graph2).run() == {"replayed": [], "rolled_back": []}
    for i in range(crashed_i + 1, N_TXS):
        _write_tx(PORT, graph2, i)
    tx = graph2.new_transaction(read_only=True)
    for i in range(N_TXS):
        assert graph2.index_lookup(tx, "byUid", (i,)), f"uid {i} missing"
    tx.rollback()
    csr = load_csr(graph2)
    assert csr.num_vertices == N_TXS and csr.num_edges == N_TXS - 1
    clean = run_on(csr, PageRankProgram(max_iterations=8), device="cpu")
    assert clean["rank"].dtype == result.states["rank"].dtype
    graph2.close()
    g1.log_manager.close()


def test_chaos_soak_same_seed_reproduces_the_reference_fault_sequence(tmp_path):
    """Two port soaks with one seed give the same journal and crash point,
    and so does the reference's soak: the same decisions at the same op
    indexes, with the same counters."""
    runs = []
    for tag, pkg in (("b1", PORT), ("b2", PORT), ("ref", REF)):
        g, plan, crash, _ = _run_soak_until_crash(pkg, pkg["mgr"](), tmp_path, tag)
        runs.append((crash, plan.journal, plan.counters()))
        g.log_manager.close()
    assert runs[0] == runs[1]
    assert runs[0][1], "the soak must inject faults"
    assert runs[0] == runs[2]


_SAME_KEYS = ("seed", "txs", "crashed_at", "vertices_present", "injected", "ops_observed",
              "journal", "retries")


@pytest.mark.parametrize("seed,txs,rate", [(42, 60, 0.01), (7, 90, 0.05)])
def test_the_chaos_subcommand_reports_as_the_reference(capsys, seed, txs, rate):
    from janusgraph_tpu_torch.observability import registry
    from janusgraph_tpu.observability import registry as ref_registry

    argv = ["chaos", "--seed", str(seed), "--txs", str(txs), "--error-rate", str(rate),
            "--compact"]
    reports = []
    for main, reg in ((cli.main, registry), (ref_cli.main, ref_registry)):
        reg.reset()
        assert main(argv) == 0
        reports.append(json.loads(capsys.readouterr().out.strip().splitlines()[-1]))
    port, ref = reports
    assert sorted(port) == sorted(ref)
    assert {k: port[k] for k in _SAME_KEYS} == {k: ref[k] for k in _SAME_KEYS}
    assert port["vertices_present"] == txs
    assert len(port["torn_recovery"]["replayed"]) == len(ref["torn_recovery"]["replayed"])
