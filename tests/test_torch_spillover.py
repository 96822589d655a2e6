"""The port's OLTP->OLAP spillover held to its row walk and to the JAX
package's spillover.

Hot multi-hop traversal shapes compile to an ``OLAPTraversalProgram`` over
a cached CSR snapshot and must be set-equal to the step-by-step walk of the
same traversal with the planner off: counts and id lists exactly, also
mid-transaction (the tx overlay) and across snapshot staleness (a refresh
within the bound, a refusal and repack beyond it). The cases are those of
``tests/test_spillover.py`` that need no server or price book, run with
``computer.executor`` "cpu". Beside them: the port's spilled results equal
the JAX package's spilled results on the same graph, and an error of the
device run reaches the caller (the reference would fall back to the row
walk) while an unsupported step still falls back.

The digest table is process-global, so every test resets it (both
packages') and uses its own graph and planner.
"""

import random

import pytest

from janusgraph_tpu.core.graph import open_graph as ref_open_graph
from janusgraph_tpu.observability import registry as ref_registry
from janusgraph_tpu.observability.profiler import digest_table as ref_digest_table
from janusgraph_tpu_torch.core.codecs import Direction
from janusgraph_tpu_torch.core.graph import open_graph
from janusgraph_tpu_torch.core.traversal import GraphTraversalSource
from janusgraph_tpu_torch.observability import flight_recorder, registry
from janusgraph_tpu_torch.observability.profiler import digest_table
from janusgraph_tpu_torch.olap import gpu_executor
from janusgraph_tpu_torch.olap import spillover as sp

SPILL_CFG = {
    "computer.executor": "cpu",
    "computer.spillover": True,
    # promote on the FIRST observation so tests teach a shape with one
    # row-wise run and spill from the second on
    "computer.spillover-min-cost-ms": 0.0,
    "computer.spillover-min-seen": 1,
}
REF_SPILL_CFG = {
    "schema.default": "auto",
    "computer.spillover": True,
    "computer.spillover-min-cost-ms": 0.0,
    "computer.spillover-min-seen": 1,
    "computer.sharded-auto": False,
}


def _social_graph(extra_cfg=None, open_fn=open_graph, base_cfg=SPILL_CFG):
    g = open_fn({**base_cfg, **(extra_cfg or {})})
    tx = g.new_transaction()
    people = [tx.add_vertex("person", name=f"p{i}") for i in range(12)]
    places = [tx.add_vertex("place", name=f"c{i}") for i in range(3)]
    rng = random.Random(11)
    for i, v in enumerate(people):
        for j in rng.sample(range(12), 4):
            tx.add_edge(v, "knows", people[j])
        tx.add_edge(v, "lives", places[i % 3])
    # a self-loop and a parallel edge: multiplicity edge cases the count
    # vector must reproduce exactly
    tx.add_edge(people[0], "knows", people[0])
    tx.add_edge(people[1], "knows", people[2])
    tx.add_edge(people[1], "knows", people[2])
    tx.commit()
    return g, [v.id for v in people], [v.id for v in places]


def _count(reg, name):
    return reg.snapshot().get(name, {}).get("count", 0)


def _spill_count(reg=registry):
    return _count(reg, "olap.spillover.spilled")


def _norm(out):
    return sorted(getattr(x, "id", x) for x in out) if isinstance(out, list) else out


def _ab(g, build, as_count=False, reg=registry):
    """(row result, spilled result, engaged): run once to teach the digest
    table, then A/B the spilled run against the disabled-planner walk. List
    results compare as sorted ids (set/multiset equality is the contract;
    order is not)."""
    planner = g.spillover_planner
    planner.enabled = True
    run = (lambda t: t.count()) if as_count else (lambda t: t.to_list())
    run(build())  # teach
    before = _spill_count(reg)
    spilled = run(build())
    engaged = _spill_count(reg) > before
    planner.enabled = False
    try:
        row = run(build())
    finally:
        planner.enabled = True
    return _norm(row), _norm(spilled), engaged


@pytest.fixture(autouse=True)
def _fresh_tables():
    digest_table.reset()
    ref_digest_table.reset()
    yield
    digest_table.reset()
    ref_digest_table.reset()


CHAINS = {
    "out_out": lambda t: t.V().out("knows").out("knows"),
    "out_3": lambda t: t.V().out("knows").out("knows").out("knows"),
    "in_in": lambda t: t.V().in_("knows").in_("knows"),
    "both_both": lambda t: t.V().both("knows").both("knows"),
    "all_labels": lambda t: t.V().out().out(),
    "knows_lives": lambda t: t.V().out("knows").out("lives"),
    "dedup": lambda t: t.V().out("knows").out("knows").dedup(),
    "id": lambda t: t.V().out("knows").out("knows").id_(),
    "dedup_id": lambda t: t.V().out("knows").out("knows").dedup().id_(),
    "seed_label": lambda t: t.V().has_label("person").out("knows").out("knows"),
    "mid_label": lambda t: t.V().out("knows").has_label("person").out("lives"),
}


# ----------------------------------------------------------- set equality
@pytest.mark.parametrize("name", list(CHAINS))
def test_spilled_results_set_equal(name):
    g, _people, _places = _social_graph()
    try:
        row, spilled, engaged = _ab(g, lambda: CHAINS[name](g.traversal()))
        assert engaged, "spillover did not engage on a promoted shape"
        assert row == spilled
    finally:
        g.close()


@pytest.mark.parametrize("name", ["out_3", "both_both", "dedup_id", "mid_label"])
def test_spilled_results_equal_reference_spilled(name):
    """The same graph in both packages (the same ids), both spilled: the
    port's results equal the JAX package's."""
    g, people, _ = _social_graph()
    ref, ref_people, _ = _social_graph(open_fn=ref_open_graph, base_cfg=REF_SPILL_CFG)
    try:
        assert people == ref_people
        _r, got, engaged = _ab(g, lambda: CHAINS[name](g.traversal()))
        _r, want, ref_engaged = _ab(ref, lambda: CHAINS[name](ref.traversal()),
                                    reg=ref_registry)
        assert engaged and ref_engaged and got == want
        _r, got_n, _e = _ab(g, lambda: CHAINS[name](g.traversal()), as_count=True)
        _r, want_n, _e = _ab(ref, lambda: CHAINS[name](ref.traversal()), as_count=True,
                             reg=ref_registry)
        assert got_n == want_n
    finally:
        g.close()
        ref.close()


def test_spilled_count_terminal_and_count_step():
    g, people, _places = _social_graph()
    try:
        row, spilled, engaged = _ab(
            g, lambda: g.traversal().V().out("knows").out("knows"), as_count=True)
        assert engaged and row == spilled
        # count as a STEP: spilled chain yields one int traverser
        row2, spilled2, engaged2 = _ab(
            g, lambda: g.traversal().V().out("knows").out("knows").count_())
        assert engaged2 and row2 == spilled2
        # seeded start with DUPLICATE ids: seed multiplicity preserved
        row3, spilled3, engaged3 = _ab(
            g, lambda: g.traversal().V(people[0], people[0], people[1]).out("knows").out("knows"),
            as_count=True)
        assert engaged3 and row3 == spilled3
        # trailing edge expansion with a count terminal
        row4, spilled4, engaged4 = _ab(
            g, lambda: g.traversal().V().out("knows").out_e("knows"), as_count=True)
        assert engaged4 and row4 == spilled4
    finally:
        g.close()


# -------------------------------------------------- tx-overlay read-your-writes
def test_overlay_uncommitted_adds_and_deletes():
    """The SAME transaction holds uncommitted adds AND deletes on the
    traversed edges: the spilled result must be read-your-writes set-equal
    to the row walk."""
    g, people, _places = _social_graph()
    try:
        _ab(g, lambda: g.traversal().V().out("knows").out("knows"))
        tx = g.new_transaction()
        v0 = tx.get_vertex(people[0])
        v1 = tx.get_vertex(people[1])
        nv = tx.add_vertex("person", name="fresh")
        tx.add_edge(v0, "knows", nv)
        tx.add_edge(nv, "knows", v1)
        tx.add_edge(v1, "knows", v0)
        es = tx.get_edges(v1, Direction.OUT, ("knows",))
        tx.remove_edge(es[0])
        tx.remove_vertex(tx.get_vertex(people[11]))

        def build():
            return GraphTraversalSource(g, tx).V().out("knows").out("knows")

        planner = g.spillover_planner
        before = _spill_count()
        spilled = build().count()
        assert _spill_count() > before, "overlay run did not spill"
        planner.enabled = False
        try:
            row = build().count()
        finally:
            planner.enabled = True
        assert spilled == row
        block = registry.last_run("olap.spillover")["spillover"]
        assert block["fallback"] is None
        assert block["overlay"]["added"] == 3
        assert block["overlay"]["new_vertices"] == 1
        assert block["overlay"]["removed"] == 1
        assert block["overlay"]["deleted"] >= 1
        spilled_ids = sorted(build().dedup().id_().to_list())
        planner.enabled = False
        try:
            row_ids = sorted(build().dedup().id_().to_list())
        finally:
            planner.enabled = True
        assert spilled_ids == row_ids
    finally:
        g.close()


def test_overlay_overflow_falls_back():
    g, people, _places = _social_graph({"computer.spillover-max-overlay": 2})
    try:
        _ab(g, lambda: g.traversal().V().out("knows").out("knows"))
        tx = g.new_transaction()
        v0 = tx.get_vertex(people[0])
        for i in range(4):
            tx.add_edge(v0, "knows", tx.get_vertex(people[i + 1]))
        before = _spill_count()
        c = GraphTraversalSource(g, tx).V().out("knows").out("knows").count()
        assert _spill_count() == before, "overflowed overlay still spilled"
        g.spillover_planner.enabled = False
        try:
            row = GraphTraversalSource(g, tx).V().out("knows").out("knows").count()
        finally:
            g.spillover_planner.enabled = True
        assert c == row
        assert any(e.get("reason") == "overlay-overflow"
                   for e in flight_recorder.events("spillover_fallback"))
    finally:
        g.close()


# ----------------------------------------------------------- fallback paths
def test_unsupported_step_falls_back_transparently():
    """A promoted digest whose chain carries an unsupported step runs
    row-by-row with a spillover_fallback flight event and zero errors."""
    g, _people, _places = _social_graph()
    try:
        def build():
            return g.traversal().V().out("knows").out("knows").values("name")

        build().to_list()  # teach: digest observed once
        shape, digest = sp.traversal_digest(build())
        planner = g.spillover_planner
        with planner._lock:
            assert planner._check_promotion(digest, shape)
        before = flight_recorder.counts().get("spillover_fallback", 0)
        spilled_view = build().to_list()
        planner.enabled = False
        try:
            row_view = build().to_list()
        finally:
            planner.enabled = True
        assert sorted(spilled_view) == sorted(row_view)
        assert flight_recorder.counts()["spillover_fallback"] > before
        assert any(e["digest"] == digest and str(e.get("reason", "")).startswith("unsupported:")
                   for e in flight_recorder.events("spillover_fallback"))
    finally:
        g.close()


def test_device_run_error_reaches_the_caller(monkeypatch):
    """An error raised inside the device run (here injected into the
    executor's run, standing for a kernel that failed to build or launch,
    or a CUDA error) is not hidden behind the row walk: it reaches the
    caller, and no fallback is counted. Recognition refusals still fall
    back."""
    g, _people, _places = _social_graph()
    try:
        def build():
            return g.traversal().V().out("knows").out("knows")

        build().count()  # teach both shapes
        build().dedup().id_().to_list()
        fallbacks = _count(registry, "olap.spillover.fallback")

        def broken(self, program, **kw):
            raise RuntimeError("CUDA error: an illegal memory access was encountered")

        monkeypatch.setattr(gpu_executor.GPUExecutor, "run", broken)
        with pytest.raises(RuntimeError, match="illegal memory access"):
            build().count()
        with pytest.raises(RuntimeError, match="illegal memory access"):
            build().dedup().id_().to_list()
        assert _count(registry, "olap.spillover.fallback") == fallbacks
        # an unsupported step never reaches the device: it walks the rows
        names = g.traversal().V().out("knows").out("knows").values("name").to_list()
        monkeypatch.undo()
        assert len(names) == build().count() == len(build().to_list()) > 0
    finally:
        g.close()


def test_compile_error_still_falls_back(monkeypatch):
    """A planner defect before the device run (here in compile) degrades
    to the row walk with an error fallback, as in the reference."""
    g, _people, _places = _social_graph()
    try:
        def build():
            return g.traversal().V().out("knows").out("knows")

        row = build().count()  # teach
        monkeypatch.setattr(sp.SpilloverPlanner, "_compile",
                            lambda *a: (_ for _ in ()).throw(ValueError("defect")))
        before = _count(registry, "olap.spillover.fallback.error")
        assert build().count() == row
        assert _count(registry, "olap.spillover.fallback.error") == before + 1
    finally:
        g.close()


def test_default_executor_without_a_card_raises_not_falls_back():
    """computer.executor "tpu" is the card; on a machine without one a
    promoted spill raises (no quiet CPU run, no fallback)."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("holds the CPU-only behaviour")
    g, _people, _places = _social_graph({"computer.executor": "tpu"})
    try:
        t = g.traversal()
        t.V().out("knows").out("knows").count()  # teach
        with pytest.raises(RuntimeError, match="no CUDA device"):
            g.traversal().V().out("knows").out("knows").count()
    finally:
        g.close()


def test_staleness_guard_refuses_then_repacks():
    g, people, _places = _social_graph({"computer.spillover-max-staleness": 0})
    try:
        def build():
            return g.traversal().V().out("knows").out("knows")

        row, spilled, engaged = _ab(g, build, as_count=True)
        assert engaged and row == spilled
        tx = g.new_transaction()
        tx.add_edge(tx.get_vertex(people[0]), "knows", tx.get_vertex(people[5]))
        tx.commit()
        stale_before = _count(registry, "olap.spillover.stale")
        c1 = build().count()  # falls back: snapshot beyond the bound
        assert _count(registry, "olap.spillover.stale") == stale_before + 1
        packs_before = _count(registry, "olap.spillover.packs")
        before = _spill_count()
        c2 = build().count()  # repacked: spills again, fresh snapshot
        assert _spill_count() > before
        assert _count(registry, "olap.spillover.packs") == packs_before + 1
        g.spillover_planner.enabled = False
        try:
            row2 = build().count()
        finally:
            g.spillover_planner.enabled = True
        assert c1 == c2 == row2
    finally:
        g.close()


def test_refresh_within_staleness_bound():
    g, people, _places = _social_graph({"computer.spillover-max-staleness": 10_000})
    try:
        def build():
            return g.traversal().V().out("knows").out("knows")

        _ab(g, build, as_count=True)
        tx = g.new_transaction()
        tx.add_edge(tx.get_vertex(people[2]), "knows", tx.get_vertex(people[3]))
        tx.commit()
        refreshes = _count(registry, "olap.spillover.delta_refreshes")
        before = _spill_count()
        c = build().count()
        assert _spill_count() > before
        assert _count(registry, "olap.spillover.refreshes") >= 1
        # the change capture served the refresh (zero store reads)
        assert _count(registry, "olap.spillover.delta_refreshes") == refreshes + 1
        g.spillover_planner.enabled = False
        try:
            row = build().count()
        finally:
            g.spillover_planner.enabled = True
        assert c == row
    finally:
        g.close()


def test_refresh_without_a_capture_rereads_the_rows():
    g, people, _places = _social_graph({"computer.delta": False})
    try:
        def build():
            return g.traversal().V().out("knows").out("knows")

        _ab(g, build, as_count=True)
        tx = g.new_transaction()
        tx.remove_edge(tx.get_edges(tx.get_vertex(people[4]), Direction.OUT, ("knows",))[0])
        tx.commit()
        delta_refreshes = _count(registry, "olap.spillover.delta_refreshes")
        refreshes = _count(registry, "olap.spillover.refreshes")
        c = build().count()
        assert _count(registry, "olap.spillover.refreshes") == refreshes + 1
        assert _count(registry, "olap.spillover.delta_refreshes") == delta_refreshes
        g.spillover_planner.enabled = False
        try:
            assert c == build().count()
        finally:
            g.spillover_planner.enabled = True
    finally:
        g.close()


# -------------------------------------------------------------- promotion
def test_promotion_policy_thresholds():
    g, _people, _places = _social_graph({
        "computer.spillover-min-seen": 3,
        "computer.spillover-min-cost-ms": 0.0,
    })
    try:
        def build():
            return g.traversal().V().out("knows").out("knows")

        base = _spill_count()
        for _ in range(2):
            build().to_list()
        assert _spill_count() == base, "promoted below min-seen"
        build().to_list()  # 3rd observation crosses min-seen
        before = _spill_count()
        build().to_list()
        assert _spill_count() > before
        shape, digest = sp.traversal_digest(build())
        snap = g.spillover_planner.promotion_snapshot()
        assert digest in snap and snap[digest]["spilled"] >= 1
    finally:
        g.close()


def test_min_cost_gate_keeps_cheap_shapes_on_row_path():
    g, _people, _places = _social_graph({
        "computer.spillover-min-cost-ms": 1e9,
        "computer.spillover-min-seen": 1,
    })
    try:
        base = _spill_count()
        for _ in range(3):
            g.traversal().V().out("knows").out("knows").to_list()
        assert _spill_count() == base
    finally:
        g.close()


def test_single_hop_never_considered():
    g, _people, _places = _social_graph()
    try:
        base = _spill_count()
        for _ in range(3):
            g.traversal().V().out("knows").to_list()
        assert _spill_count() == base
    finally:
        g.close()


# --------------------------------------------------------------- planner unit
def test_recognize_vocabulary():
    g, _people, _places = _social_graph()
    try:
        t = g.traversal().V().out("knows").out("knows")
        plan, reason = sp.recognize(t)
        assert plan is not None and len(plan.hops) == 2
        # property has() head is unsupported
        t = g.traversal().V().has("name", "p0").out("knows").out("knows")
        plan, reason = sp.recognize(t)
        assert plan is None and reason.startswith("seed-filter")
        # mid-chain order() is unsupported
        plan, reason = sp.recognize(g.traversal().V().out("knows").out("knows").order())
        assert plan is None
        # repeat() is unsupported (no _expand_meta on the repeat step)
        plan, reason = sp.recognize(g.traversal().V().repeat(lambda x: x.out("knows"), times=2))
        assert plan is None
        # edge expansion mid-chain is unsupported
        plan, reason = sp.recognize(g.traversal().V().out_e("knows").in_v())
        assert plan is None
    finally:
        g.close()


def test_spillover_disabled_config():
    g, _people, _places = _social_graph({"computer.spillover": False})
    try:
        assert g.spillover_planner is None
        base = _spill_count()
        for _ in range(3):
            g.traversal().V().out("knows").out("knows").count()
        assert _spill_count() == base
    finally:
        g.close()


def test_close_drops_the_snapshot_and_executor():
    g, _people, _places = _social_graph()
    planner = g.spillover_planner
    _ab(g, lambda: g.traversal().V().out("knows").out("knows"))
    assert planner._csr is not None and planner._ex is not None
    g.close()
    assert planner._csr is None and planner._ex is None


def test_digest_table_equals_reference():
    """The same observations give the reference's shapes, digests, top-K
    ranking (with its eviction) and records, exactly."""
    from janusgraph_tpu.observability import profiler as ref_profiler
    from janusgraph_tpu_torch.observability import profiler

    ref_t, t = ref_profiler.DigestTable(capacity=4), profiler.DigestTable(capacity=4)
    plans = [{"access": "ids"}, {"access": "full-scan"}, None]
    labels = [["out(knows)", "out(knows)"], ["has(age)", "values"], ["in(a,b)", "count"],
              ["adjacentVertexHasId(1, 2)", "id_"], ["range(1,5)"], []]
    for i in range(40):
        lb, plan = labels[i % len(labels)], plans[i % len(plans)]
        shape = profiler.traversal_shape(lb, plan)
        assert shape == ref_profiler.traversal_shape(lb, plan)
        digest = profiler.shape_digest(shape)
        assert digest == ref_profiler.shape_digest(shape)
        wall = float(i % 7) * 1.5 + 0.25
        t.observe(digest, shape, wall, cells=i)
        ref_t.observe(digest, shape, wall, cells=i)
    assert len(t) == len(ref_t) == 4
    assert t.top(10) == ref_t.top(10)
    assert profiler.digest_records(t) == ref_profiler.digest_records(ref_t)
    for e in t.top(10):
        assert t.mean_cost_ms(e["digest"]) == ref_t.mean_cost_ms(e["digest"])


def test_spilled_run_on_the_sharded_executor(monkeypatch):
    """computer.executor = "sharded": the spilled program runs on the
    sharded executor over the default mesh (here 8 CPU slots) and the
    results equal the row walk's."""
    import torch

    from janusgraph_tpu_torch.olap import computer
    from janusgraph_tpu_torch.parallel import Mesh, sharded

    monkeypatch.setattr(computer, "default_mesh", lambda: Mesh([torch.device("cpu")] * 8))
    runs = []
    real_run = sharded.ShardedExecutor.run

    def counted(self, *a, **kw):
        runs.append(self.num_shards)
        return real_run(self, *a, **kw)

    monkeypatch.setattr(sharded.ShardedExecutor, "run", counted)
    g, _people, _places = _social_graph({"computer.executor": "sharded"})
    try:
        for name in ("out_3", "knows_lives"):
            row, spilled, engaged = _ab(g, lambda: CHAINS[name](g.traversal()))
            assert engaged and row == spilled, name
        assert runs and set(runs) == {8}
    finally:
        g.close()
