"""The port's OLAP traversal program held against the JAX package's.

Two graphs: the Graph of the Gods, opened and scanned by the reference
(``load_csr``) and carried across with ``csr_from_arrays``, and a seeded
random graph built by both packages from the same edge list. The
reference runs ``TPUExecutor`` on JAX's CPU backend and ``CPUExecutor`` (its
float64 oracle). Counts are small integers: bitwise everywhere. Sacks are
bitwise against ``CPUExecutor`` on weights that are exact in float32 (sums
and products of quarters), and at rtol 1e-6 against ``TPUExecutor`` on
uniform weights (XLA may contract a multiply into an add)."""

import dataclasses

import numpy as np
import pytest
import torch

import janusgraph_tpu.olap as ref
from janusgraph_tpu.core import gods
from janusgraph_tpu.core.graph import open_graph
from janusgraph_tpu.core.predicates import Cmp as RefCmp, Text as RefText
from janusgraph_tpu.olap.csr import load_csr
from janusgraph_tpu.olap.cpu_executor import CPUExecutor
from janusgraph_tpu.olap.programs import OLAPTraversalProgram as RefOLAP
from janusgraph_tpu.olap.programs import olap_traversal as R
from janusgraph_tpu.olap.programs.gcn import GCNForwardProgram as RefGCN
from janusgraph_tpu.olap.tpu_executor import TPUExecutor
from janusgraph_tpu_torch.exceptions import SuperstepPreempted
from janusgraph_tpu_torch.olap import GPUExecutor, csr_from_arrays, csr_from_edges, run_on
from janusgraph_tpu_torch.olap.programs import (
    GCNForwardProgram,
    OLAPTraversalProgram,
    PeerPressureProgram,
    PropertyFilter,
    TraversalStep,
    build_olap_traversal,
    build_path_index,
    enumerate_paths,
    evaluate_filter_mask,
    group_count_by_label,
    select_paths,
    steps_from_spec,
)
from janusgraph_tpu_torch.predicates import Cmp

CSR_FIELDS = ("vertex_ids", "out_indptr", "out_dst", "in_indptr", "in_src", "out_degree",
              "in_edge_weight", "out_edge_weight", "properties", "labels", "in_edge_type",
              "out_edge_type")


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _equal(got, want):
    assert set(got) == set(want)
    for k in got:
        w = np.asarray(want[k])
        assert got[k].dtype == w.dtype, k
        np.testing.assert_array_equal(_bits(got[k]), _bits(w), err_msg=k)


@pytest.fixture(scope="module")
def world():
    """(reference graph, reference CSR, the port's copy of it)."""
    g = open_graph()
    gods.load(g)
    rc = load_csr(g, property_keys=("age", "name"), weight_key="time")
    pc = csr_from_arrays(**{f: getattr(rc, f) for f in CSR_FIELDS})
    yield g, rc, pc
    g.close()


def _oltp_count(g, spec, seed_name=None):
    t = g.traversal()
    trav = t.V() if seed_name is None else t.V().has("name", seed_name)
    for item in spec:
        direction, labels = (item, ()) if isinstance(item, str) else (item[0], item[1] or ())
        trav = {"out": trav.out, "in": trav.in_, "both": trav.both}[direction](*labels)
    return trav.count()


GODS_SPECS = [
    [("out", ["father"]), ("out", ["father"])],
    [("out", ["brother"]), ("out", ["lives"])],
    [("out", None), ("in", None)],
    [("both", ["brother"]), ("both", ["brother"]), ("both", ["brother"])],
    [("in", ["battled"])],
]


@pytest.mark.parametrize("strategy", ["segsum", "ell"])
@pytest.mark.parametrize("spec", range(len(GODS_SPECS)))
def test_gods_counts_bitwise(world, spec, strategy):
    g, rc, pc = world
    spec = GODS_SPECS[spec]
    steps = steps_from_spec(g, spec)  # the reference's graph, duck-typed
    rsteps = R.steps_from_spec(g, spec)
    assert [(s.direction, s.labels, s.as_label) for s in steps] == [
        (s.direction, s.labels, s.as_label) for s in rsteps]
    got = GPUExecutor(pc, strategy=strategy, device="cpu").run(OLAPTraversalProgram(steps))
    want = TPUExecutor(rc).run(RefOLAP(rsteps))
    _equal(got, want)
    oracle = CPUExecutor(rc).run(RefOLAP(rsteps))["count"]
    np.testing.assert_array_equal(got["count"], oracle.astype(np.float32))
    assert int(got["count"].sum()) == _oltp_count(g, spec)


def test_gods_seeded_by_vertex_id(world):
    g, rc, pc = world
    herc = g.traversal().V().has("name", "hercules").next().id
    got = run_on(pc, build_olap_traversal(g, pc, [("out", ["battled"])], seeds=[herc]),
                 device="cpu")
    want = TPUExecutor(rc).run(R.build_olap_traversal(g, rc, [("out", ["battled"])], seeds=[herc]))
    _equal(got, want)
    assert int(got["count"].sum()) == 3
    names = rc.properties["name"]
    assert {names[i] for i in np.nonzero(got["count"])[0]} == {"nemean", "hydra", "cerberus"}


FILTER_CASES = [
    ((), [("out", ["father"], [("age", "gt", 100)])]),
    ([("age", "gt", 100)], [("out", ["brother"]), ("out", ["lives"])]),
    ((), [("out", None, [("age", "gte", 30)]), ("out", None)]),
    ((), [("out", ["battled"], [("name", "neq", "hydra")]), ("in", ["battled"])]),
]
_CMP = {"gt": "GREATER_THAN", "gte": "GREATER_THAN_EQUAL", "neq": "NOT_EQUAL"}


def _with(cmp, seed_filters, spec):
    """The case with its predicate names bound to ``cmp``'s singletons."""
    def bind(filters):
        return [(k, getattr(cmp, _CMP[p]), v) for k, p, v in filters]

    return bind(seed_filters), [
        (it[0], it[1], bind(it[2])) if len(it) > 2 else it for it in spec
    ]


@pytest.mark.parametrize("case", range(len(FILTER_CASES)))
def test_gods_filtered_runs_bitwise(world, case):
    g, rc, pc = world
    seed_f, spec = _with(Cmp, *FILTER_CASES[case])
    rseed_f, rspec = _with(RefCmp, *FILTER_CASES[case])
    prog = build_olap_traversal(g, pc, spec, seed_filters=seed_f)
    rprog = R.build_olap_traversal(g, rc, rspec, seed_filters=rseed_f)
    for strategy in ("segsum", "ell"):
        got = GPUExecutor(pc, strategy=strategy, device="cpu").run(prog)
        _equal(got, TPUExecutor(rc).run(rprog))
    # step filters are part of the superstep (the seed mask only of setup)
    plain = OLAPTraversalProgram([TraversalStep(s.direction, s.labels) for s in prog.steps])
    assert (prog.cache_key() != plain.cache_key()) == any(s.filters for s in prog.steps)


def test_text_predicates_duck_typed(world):
    """A reference Text predicate goes through the scalar evaluate() path."""
    g, rc, pc = world
    flt = (PropertyFilter("name", RefText.CONTAINS_PREFIX, "her"),)
    mask = evaluate_filter_mask(pc, flt)
    np.testing.assert_array_equal(mask, R.evaluate_filter_mask(rc, (R.PropertyFilter(
        "name", RefText.CONTAINS_PREFIX, "her"),)))
    assert {pc.properties["name"][i] for i in np.nonzero(mask)[0]} == {"hercules"}
    spec = [("out", ["battled"], [("name", RefText.CONTAINS_REGEX, "h.*")])]
    got = run_on(pc, build_olap_traversal(g, pc, spec, seed_filters=[
        ("name", RefText.CONTAINS_PREFIX, "her")]), device="cpu")
    want = TPUExecutor(rc).run(R.build_olap_traversal(g, rc, spec, seed_filters=[
        ("name", RefText.CONTAINS_PREFIX, "her")]))
    _equal(got, want)
    assert int(got["count"].sum()) == 1  # hercules -> hydra


def test_missing_property_and_label_and_masks_refused(world):
    g, _rc, pc = world
    with pytest.raises(ValueError, match="not loaded"):
        evaluate_filter_mask(pc, (PropertyFilter("nope", Cmp.EQUAL, 1),))
    with pytest.raises(ValueError, match="unknown edge label"):
        steps_from_spec(g, [("out", ["knowz"])])
    with pytest.raises(ValueError, match="step_masks"):
        OLAPTraversalProgram([TraversalStep("out", None, (PropertyFilter("age", Cmp.EQUAL, 1),))])
    with pytest.raises(ValueError, match="at least one"):
        OLAPTraversalProgram([])
    with pytest.raises(ValueError, match="direction"):
        TraversalStep("sideways")


def _random(n=200, m=900, seed=9, labels=3, weights=None):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, m).astype(np.int32)
    dst = rng.integers(0, n, m).astype(np.int32)
    et = rng.integers(0, labels, m).astype(np.int32)
    if weights == "quarters":
        w = (rng.integers(2, 9, m) / 4).astype(np.float32)
    elif weights == "uniform":
        w = rng.uniform(0.5, 2.0, m).astype(np.float32)
    else:
        w = None
    score = rng.uniform(0, 10, n)
    pc = csr_from_edges(n, src, dst, w, edge_types=et)
    rc = ref.csr_from_edges(n, src, dst, w, edge_types=et)
    pc.properties["score"] = score
    rc.properties["score"] = score
    return pc, rc, (src, dst, et)


@pytest.mark.parametrize("strategy", ["segsum", "ell", "hybrid", "auto"])
def test_random_graph_filtered_and_seeded(strategy):
    pc, rc, (src, dst, et) = _random()
    flt = (PropertyFilter("score", Cmp.GREATER_THAN, 5.0),)
    rflt = (R.PropertyFilter("score", RefCmp.GREATER_THAN, 5.0),)
    mask = evaluate_filter_mask(pc, flt)
    np.testing.assert_array_equal(mask, R.evaluate_filter_mask(rc, rflt))
    ones = np.ones(200, np.float32)
    masks = np.stack([ones, mask, ones], axis=1)
    seeds = (3, 17, 17, 150)
    spec = [("out", None), ("out", (0, 2)), ("both", (1,))]
    prog = OLAPTraversalProgram([TraversalStep(d, lab, flt if i == 1 else ())
                                 for i, (d, lab) in enumerate(spec)],
                                seed_indices=seeds, seed_mask=(mask > 0) | (ones > 0),
                                step_masks=masks, record_reach=True)
    rprog = RefOLAP([R.TraversalStep(d, lab, rflt if i == 1 else ())
                     for i, (d, lab) in enumerate(spec)],
                    seed_indices=seeds, seed_mask=np.ones(200, np.float32),
                    step_masks=masks, record_reach=True)
    got = GPUExecutor(pc, strategy=strategy, device="cpu").run(prog)
    _equal(got, TPUExecutor(rc).run(rprog))
    # numpy oracle: seeded counts, masked after step 2
    c = np.isin(np.arange(200), seeds).astype(np.float64)
    for i, (d, lab) in enumerate(spec):
        sel = np.ones(len(et), bool) if lab is None else np.isin(et, lab)
        nxt = np.zeros(200)
        if d in ("out", "both"):
            np.add.at(nxt, dst[sel], c[src[sel]])
        if d in ("in", "both"):
            np.add.at(nxt, src[sel], c[dst[sel]])
        c = nxt * (masks[:, i] if i == 1 else 1.0)
    np.testing.assert_array_equal(got["count"], c.astype(np.float32))


@pytest.mark.parametrize("chain", [
    [("out", ["father"]), ("out", ["father"])],
    [("out", ["battled"]), ("in", ["battled"]), ("out", ["father"])],
    [("both", ["brother"]), ("out", ["lives"])],
    [("out", ["battled"], [("name", "neq", "hydra")]), ("in", ["battled"])],
])
def test_gods_paths_equal_reference(world, chain):
    g, rc, pc = world
    _sf, spec = _with(Cmp, (), chain)
    _rsf, rspec = _with(RefCmp, (), chain)
    prog = build_olap_traversal(g, pc, spec, record_reach=True)
    rprog = R.build_olap_traversal(g, rc, rspec, record_reach=True)
    got = run_on(pc, prog, device="cpu")
    want = TPUExecutor(rc).run(rprog)
    _equal(got, want)
    paths = sorted(enumerate_paths(pc, prog, got))
    assert paths == sorted(R.enumerate_paths(rc, rprog, {k: np.asarray(v) for k, v in want.items()}))
    assert paths and len(paths) == int(got["count"].sum())


def test_random_paths_equal_enumeration_and_reference():
    pc, rc, (src, dst, et) = _random(n=60, m=200, seed=17, labels=1)
    seeds = tuple(int(s) for s in np.random.default_rng(17).choice(60, 5, replace=False))
    prog = OLAPTraversalProgram([TraversalStep("out")] * 3, seed_indices=seeds, record_reach=True)
    got = GPUExecutor(pc, device="cpu").run(prog)
    adj = [[] for _ in range(60)]
    for s, d in zip(src, dst):
        adj[s].append(int(d))
    want = sorted((a, b, c, d) for a in seeds for b in adj[a] for c in adj[b] for d in adj[c])
    index = build_path_index(pc, prog)
    assert sorted(enumerate_paths(pc, prog, got, path_index=index)) == want
    assert sorted(enumerate_paths(pc, prog, got, path_index=lambda: index)) == want
    rprog = RefOLAP([R.TraversalStep("out")] * 3, seed_indices=seeds, record_reach=True)
    assert sorted(R.enumerate_paths(rc, rprog, CPUExecutor(rc).run(rprog))) == want
    assert len(want) == int(got["count"].sum())
    first = list(enumerate_paths(pc, prog, got))
    assert list(enumerate_paths(pc, prog, got, limit=2)) == first[:2]
    assert list(enumerate_paths(pc, prog, got, limit=0)) == []


def test_select_paths_equal_reference(world):
    g, rc, pc = world
    spec = [("out", ["father"], (), "f"), ("out", ["father"], (), "gf")]
    prog = build_olap_traversal(g, pc, spec, record_reach=True)
    rprog = R.build_olap_traversal(g, rc, spec, record_reach=True)
    got = run_on(pc, prog, device="cpu")
    want = CPUExecutor(rc).run(rprog)
    rows = list(select_paths(pc, prog, got, ("me", "f", "gf"), source_as="me"))
    assert rows == list(R.select_paths(rc, rprog, want, ("me", "f", "gf"), source_as="me"))
    assert rows and all(set(r) == {"me", "f", "gf"} for r in rows)
    with pytest.raises(ValueError, match="match no as"):
        list(select_paths(pc, prog, got, ("nope",)))
    dup = build_olap_traversal(g, pc, [("out", None, (), "x"), ("out", None, (), "x")],
                               record_reach=True)
    with pytest.raises(ValueError, match="duplicate as"):
        list(select_paths(pc, dup, run_on(pc, dup, device="cpu"), ("x",)))


@pytest.mark.parametrize("strategy", ["segsum", "ell", "hybrid"])
@pytest.mark.parametrize("sack", ["sum", "mult"])
def test_sack_bitwise_against_cpu_executor(sack, strategy):
    pc, rc, _ = _random(n=120, m=500, seed=5, weights="quarters")
    spec = [("out", None), ("both", (0, 1)), ("in", (2,))]
    prog = OLAPTraversalProgram([TraversalStep(d, lab) for d, lab in spec], sack=sack)
    rprog = RefOLAP([R.TraversalStep(d, lab) for d, lab in spec], sack=sack)
    ex = GPUExecutor(pc, strategy=strategy, device="cpu")
    got = ex.run(prog)
    want = CPUExecutor(rc).run(rprog)
    for k in ("count", "sack"):
        assert want[k].dtype == np.float64
        np.testing.assert_array_equal(_bits(got[k]), _bits(want[k].astype(np.float32)), err_msg=k)
    assert got["sack"].any()
    # [n, 2] / [n, 3] SUM messages: never the kernel, never "segment"
    assert {r["strategy"] for r in ex.last_run_info["superstep_records"]} == {"ell"}


@pytest.mark.parametrize("sack", ["sum", "mult"])
def test_sack_close_to_tpu_executor(sack):
    pc, rc, _ = _random(n=120, m=500, seed=6, weights="uniform")
    spec = [("out", None), ("out", None), ("both", (1,))]
    got = run_on(pc, OLAPTraversalProgram([TraversalStep(d, lab) for d, lab in spec], sack=sack),
                 device="cpu")
    want = TPUExecutor(rc).run(RefOLAP([R.TraversalStep(d, lab) for d, lab in spec], sack=sack))
    np.testing.assert_array_equal(got["count"], np.asarray(want["count"]))
    np.testing.assert_allclose(got["sack"], np.asarray(want["sack"]), rtol=1e-6)


def test_gods_sack_with_filters(world):
    g, rc, pc = world
    spec = [("out", ["battled"], [("name", Cmp.EQUAL, "hydra")])]
    got = run_on(pc, build_olap_traversal(g, pc, spec, sack="sum"), device="cpu")
    want = TPUExecutor(rc).run(R.build_olap_traversal(
        g, rc, [("out", ["battled"], [("name", RefCmp.EQUAL, "hydra")])], sack="sum"))
    _equal(got, want)
    assert got["count"].sum() == 1 and got["sack"].sum() == 2.0  # hercules -> hydra, time 2


def test_group_count_by_label_equal_reference(world):
    g, rc, pc = world
    got = run_on(pc, build_olap_traversal(g, pc, ["out"]), device="cpu")["count"]
    assert group_count_by_label(g, pc, got) == R.group_count_by_label(
        g, rc, CPUExecutor(rc).run(R.build_olap_traversal(g, rc, ["out"]))["count"])
    assert sum(group_count_by_label(g, pc, got).values()) == pc.num_edges
    bare = csr_from_edges(3, [0], [1])
    with pytest.raises(ValueError, match="label column"):
        group_count_by_label(g, bare, np.ones(3))


class _Preempt:
    def __init__(self, at):
        self.at, self.fired = at, False

    def __call__(self, step):
        if step == self.at and not self.fired:
            self.fired = True
            raise SuperstepPreempted(f"at {step}")


def test_checkpointed_traversal_resumes_bitwise(tmp_path):
    pc, _rc, _ = _random(weights="uniform")
    flt = (PropertyFilter("score", Cmp.LESS_THAN, 7.0),)
    masks = np.stack([np.ones(200, np.float32), evaluate_filter_mask(pc, flt),
                      np.ones(200, np.float32), np.ones(200, np.float32)], axis=1)

    def prog():
        return OLAPTraversalProgram(
            [TraversalStep("out"), TraversalStep("in", (0, 1), flt), TraversalStep("both"),
             TraversalStep("out", (2,))], step_masks=masks, record_reach=True, sack="mult")

    want = GPUExecutor(pc, device="cpu").run(prog())
    ex = GPUExecutor(pc, device="cpu")
    hook = _Preempt(3)
    got = ex.run(prog(), checkpoint_path=str(tmp_path / "ck.npz"), checkpoint_every=2,
                 fault_hook=hook)
    assert hook.fired and ex.last_run_info["resumes"] == 1
    assert ex.last_run_info["resume_steps"][0]["from_step"] == 2
    _equal(got, want)


def test_default_strategy_sends_rows_to_a_bitwise_path():
    """Under "segsum" an [n, k] SUM takes ELL, never "segment", whose
    float atomics have no fixed order on the card: the default GCN, a sack traversal and PeerPressure's
    count phase equal strategy="ell" bit for bit."""
    pc, rc, _ = _random(n=300, m=3000, seed=4, weights="uniform")

    def gcn():
        return GCNForwardProgram(feature_dim=8, hidden_dim=8, out_dim=8, num_layers=2, seed=3)

    ex = GPUExecutor(pc, device="cpu")
    h = ex.run(gcn())["h"]
    assert ex.last_run_info["strategy_resolved"] == "ell"
    np.testing.assert_array_equal(_bits(h), _bits(GPUExecutor(pc, strategy="ell", device="cpu").run(gcn())["h"]))
    np.testing.assert_array_equal(_bits(h), _bits(np.asarray(TPUExecutor(rc, strategy="ell").run(
        RefGCN(feature_dim=8, hidden_dim=8, out_dim=8, num_layers=2, seed=3))["h"])))
    assert _bits(ex.run(gcn(), fused=False)["h"]).tolist() == _bits(h).tolist()

    sack = OLAPTraversalProgram([TraversalStep("out"), TraversalStep("both")], sack="sum")
    got = ex.run(sack)
    assert {r["strategy"] for r in ex.last_run_info["superstep_records"]} == {"ell"}
    _equal(got, GPUExecutor(pc, strategy="ell", device="cpu").run(sack))

    pp = ex.run(PeerPressureProgram(rounds=2), sync_every=2)
    resolved = ex.last_run_info["strategy_resolved"]
    assert resolved == "ell"
    _equal(pp, GPUExecutor(pc, strategy="ell", device="cpu").run(PeerPressureProgram(rounds=2),
                                                                  sync_every=2))
    # "segment", named by the caller, stays the atomics path
    seg = GPUExecutor(pc, strategy="segment", device="cpu")
    seg.run(gcn())
    assert seg.last_run_info["strategy_resolved"] == "segment"


def test_tree_matmul_native_turns_tf32_off_for_its_call():
    from janusgraph_tpu_torch.olap.features import kernels as fk

    seen = []
    real = torch.matmul
    prev = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.matmul = lambda a, b: (seen.append(torch.backends.cuda.matmul.allow_tf32), real(a, b))[1]
        h, w = torch.ones(4, 2), torch.ones(2, 3)
        assert fk.tree_matmul(h, w, native=True).tolist() == [[2.0] * 3] * 4
        assert seen == [False] and torch.backends.cuda.matmul.allow_tf32 is True
    finally:
        torch.matmul = real
        torch.backends.cuda.matmul.allow_tf32 = prev


def test_program_cache_key_value_equal(world):
    g, _rc, _pc = world
    a = OLAPTraversalProgram(steps_from_spec(g, [("out", ["father"])]))
    b = OLAPTraversalProgram(steps_from_spec(g, [("out", ["father"])]))
    c = OLAPTraversalProgram(steps_from_spec(g, [("in", ["father"])]))
    d = OLAPTraversalProgram(steps_from_spec(g, [("out", ["father"])]), seed_indices=[1])
    assert a.cache_key() == b.cache_key() == d.cache_key() != c.cache_key()
    assert a.channel_for(5) == "s0" and dataclasses.is_dataclass(a.steps[0])


@pytest.mark.parametrize("name", ["EQUAL", "NOT_EQUAL", "LESS_THAN", "LESS_THAN_EQUAL",
                                  "GREATER_THAN", "GREATER_THAN_EQUAL"])
def test_cmp_predicates_equal_reference(name):
    mine, theirs = getattr(Cmp, name), getattr(RefCmp, name)
    assert repr(mine) == repr(theirs)
    for value, cond in ((3, 5), (5, 5), (7, 5), (None, 5), (None, None), ("a", 5), (2.5, 2.5)):
        assert mine.evaluate(value, cond) == theirs.evaluate(value, cond), (value, cond)
    col = np.array([1.0, np.nan, 5.0, 9.0])
    with np.errstate(invalid="ignore"):
        np.testing.assert_array_equal(mine._fn(col, 5.0), theirs._fn(col, 5.0))
