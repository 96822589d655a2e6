"""The port's autotuner and peak table held against the JAX package's.

``GraphStats``, ``decide(...).as_dict()``, ``decide_tiers`` and
``pick_tier`` must equal the reference's field for field for the CPU and
the TPU kinds (graphs made with numpy from a seed: directed, undirected,
weighted; forced strategy and cutoff, ``min_gain``, a measured record,
a feature dim). The measured-record files are read across packages in both
directions. The H100 is priced as a GPU from its own table row."""

import json

import numpy as np
import pytest

import janusgraph_tpu.olap as ref
from janusgraph_tpu.observability import profiler as ref_profiler
from janusgraph_tpu.olap import autotune as ref_at
from janusgraph_tpu_torch.observability import profiler
from janusgraph_tpu_torch.olap import autotune, csr_from_edges

KINDS = ["cpu", "TPU v5 lite", "TPU v4"]
H100 = "NVIDIA H100 80GB HBM3"


def skewed(n=600, m=12000, seed=7, weights=False):
    rng = np.random.default_rng(seed)
    dst = (rng.zipf(1.35, m) % n).astype(np.int32)
    src = rng.integers(0, n, m).astype(np.int32)
    w = rng.uniform(0.25, 2.0, m).astype(np.float32) if weights else None
    return ref.csr_from_edges(n, src, dst, w), csr_from_edges(n, src, dst, w)


def supernode(n=300):
    rng = np.random.default_rng(2)
    dst = np.concatenate([np.zeros(5000, np.int32), (rng.zipf(1.4, 3000) % n).astype(np.int32)])
    src = rng.integers(0, n, len(dst)).astype(np.int32)
    return ref.csr_from_edges(n, src, dst), csr_from_edges(n, src, dst)


GRAPHS = {
    "skewed": lambda: skewed(),
    "weighted": lambda: skewed(seed=3, weights=True),
    "large": lambda: skewed(n=3000, m=60000, seed=5),
    "supernode": supernode,
}

#: (overrides, measured, feature_dim, stats kwargs)
VARIANTS = {
    "default": ({}, None, 0, {}),
    "forced_segment": ({"strategy": "segment"}, None, 0, {}),
    "forced_hybrid_cutoff": ({"strategy": "hybrid", "hub_cutoff": 64}, None, 0, {}),
    "forced_cutoff": ({"hub_cutoff": 32, "min_gain": 0.0}, None, 0, {}),
    "min_gain": ({"min_gain": 0.5}, None, 0, {}),
    "tiny_budget": ({"budget_bytes": 1024}, None, 0, {}),
    "tail_chunk": ({"tail_chunk": 32}, None, 0, {"tail_chunk": 32}),
    "measured": ({}, {"superstep_ms": 12.5, "pad_ratio": 1.47}, 0, {}),
    "feature_dim": ({}, None, 20, {}),
    "max_capacity": ({}, None, 0, {"max_capacity": 64}),
}


def _stats_pair(graph, undirected, **kw):
    rcsr, pcsr = GRAPHS[graph]()
    return (
        ref_at.GraphStats.from_csr(rcsr, undirected=undirected, **kw),
        autotune.GraphStats.from_csr(pcsr, undirected=undirected, **kw),
    )


@pytest.mark.parametrize("undirected", [False, True], ids=["directed", "undirected"])
@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_graph_stats_equal_reference(graph, undirected):
    want, got = _stats_pair(graph, undirected)
    assert got.__dict__ == want.__dict__


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("undirected", [False, True], ids=["directed", "undirected"])
def test_decide_equals_reference(variant, kind, undirected):
    ov, measured, feature_dim, stats_kw = VARIANTS[variant]
    for graph in ("skewed", "weighted", "supernode"):
        rs, ps = _stats_pair(graph, undirected, **stats_kw)
        want = ref_at.decide(rs, kind, overrides=ov, measured=measured, feature_dim=feature_dim)
        got = autotune.decide(ps, kind, overrides=ov, measured=measured, feature_dim=feature_dim)
        assert got.as_dict() == want.as_dict(), (graph, variant)
        assert got.modeled_ms == want.modeled_ms
        assert got == autotune.decide(ps, kind, overrides=ov, measured=measured,
                                      feature_dim=feature_dim)


#: graph500-sized degree summaries (n = 2^scale, m = 16 n): too large to
#: build a CSR for in a test, so the stats come from seeded power-law degree
#: arrays through ``from_degrees``; the north-star rung is scale 23
DEGREE_SCALES = {"powerlaw_s22": 22, "powerlaw_s23": 23}


def _degree_stats_pair(scale):
    n = 1 << scale
    deg = np.random.default_rng(scale).zipf(2.0, n) - 1
    return (
        ref_at.GraphStats.from_degrees(deg, 16 * n, False),
        autotune.GraphStats.from_degrees(deg, 16 * n, False),
    )


@pytest.mark.parametrize("graph", sorted(GRAPHS) + sorted(DEGREE_SCALES))
def test_decide_tiers_and_pick_tier_equal_reference(graph):
    if graph in DEGREE_SCALES:
        rs, ps = _degree_stats_pair(DEGREE_SCALES[graph])
        assert ps.__dict__ == rs.__dict__
        f_sched, e_sched = autotune.decide_tiers(ps)
        scale = DEGREE_SCALES[graph]
        # growth 4 from the 2^14 floor; the top tier is m itself (at scale
        # 23: 2^14, 2^16, ..., 2^26, 2^27)
        assert e_sched == tuple(1 << k for k in range(14, scale + 4, 2)) + (1 << (scale + 4),)
        assert f_sched[0] == 1 << 10 and f_sched[-1] == 1 << scale
    else:
        rs, ps = _stats_pair(graph, False)
    for ov in ({}, {"max_tiers": 3}, {"tier_growth": 4}, {"f_min": 64, "e_min": 256}):
        want = ref_at.decide_tiers(rs, ov)
        assert autotune.decide_tiers(ps, ov) == want
        mid = want[1][1] if len(want[1]) > 2 else None
        if mid is not None:
            measured = {"roofline_by_tier": {str(mid): {"roofline_utilization": 0.0}}}
            got = autotune.decide_tiers(ps, ov, measured)
            assert got == ref_at.decide_tiers(rs, ov, measured) and mid not in got[1]
        for sched, hi in ((want[0], rs.num_vertices), (want[1], rs.num_edges)):
            for need in (1, 2, sched[0], sched[0] + 1, hi // 2, hi, 10 ** 9):
                assert autotune.pick_tier(need, sched, hi) == ref_at.pick_tier(need, sched, hi)


@pytest.mark.parametrize("d,forced", [(1, 0), (8, 0), (9, 0), (600, 0), (20, 32)])
def test_feature_tier_equals_reference(d, forced):
    from janusgraph_tpu.olap.features.kernels import pick_feature_tier

    assert autotune.pick_feature_tier(d, forced) == pick_feature_tier(d, forced)
    with pytest.raises(ValueError):
        autotune.pick_feature_tier(0)
    with pytest.raises(ValueError):
        autotune.pick_feature_tier(20, 24)


@pytest.mark.parametrize("kind", KINDS + [H100, "v5p", "unknown accelerator"])
def test_device_peaks_equal_reference_and_h100_row(kind):
    got = profiler.device_peaks(kind)
    if "h100" in kind.lower():
        assert got["source"] == "table:h100"
        assert (got["peak_flops"], got["peak_bytes_per_s"], got["peak_mxu_flops"]) == (
            67e12, 3.35e12, 494.7e12)
        assert autotune.device_class(kind) == "gpu"
    else:
        assert got == ref_profiler.device_peaks(kind)
        assert autotune.device_class(kind) == ("tpu" if "tpu" in kind.lower() else "cpu")


def test_configure_roofline_override_and_current_device(monkeypatch):
    monkeypatch.setattr(profiler, "_ROOFLINE_OVERRIDE", dict.fromkeys(profiler._ROOFLINE_OVERRIDE, 0.0))
    profiler.configure_roofline(peak_bytes_per_s=1e12)
    got = profiler.device_peaks(H100)
    assert got["peak_bytes_per_s"] == 1e12 and got["source"] == "config"
    # no CUDA here: the current device is asked of torch, which says "cpu"
    assert profiler.device_peaks()["device_kind"] == "cpu"


def test_h100_decision_prices_as_gpu():
    _rs, ps = _stats_pair("large", False)
    d = autotune.decide(ps, H100)
    assert d.device_kind == H100 and d == autotune.decide(ps, H100)
    assert d.strategy in ("ell", "hybrid", "segment")
    # the gpu constants, not the cpu ones, price every layout
    cpu = autotune.decide(ps, "cpu")
    assert d.modeled_ms != cpu.modeled_ms


# --------------------------------------------------- measured persistence
def test_measured_files_cross_packages(tmp_path):
    rec = {"strategy": "hybrid", "pad_ratio": 1.02, "superstep_ms": 3.5,
           "roofline_by_tier": None}
    port_file = str(tmp_path / "port.autotune.json")
    ref_file = str(tmp_path / "ref.autotune.json")
    autotune.save_measured(port_file, rec)
    ref_at.save_measured(ref_file, rec)
    with open(port_file) as a, open(ref_file) as b:
        assert json.load(a) == json.load(b)
    assert ref_at.load_measured(port_file) == autotune.load_measured(ref_file)
    assert autotune.load_measured(ref_file)["pad_ratio"] == 1.02
    # a multi-shard record written by the reference survives a port save
    ref_at.save_measured(port_file, dict(rec, exchange="blocked"), shard_count=4)
    autotune.save_measured(port_file, dict(rec, superstep_ms=2.0))
    assert ref_at.load_measured(port_file, shard_count=4)["exchange"] == "blocked"
    assert ref_at.load_measured(port_file)["superstep_ms"] == 2.0
    # v1 files answer shard_count=1 only; unknown or torn files answer None
    v1 = tmp_path / "v1.json"
    v1.write_text(json.dumps({"version": 1, **rec}))
    assert autotune.load_measured(str(v1)) == ref_at.load_measured(str(v1))
    assert autotune.load_measured(str(v1), shard_count=2) is None
    bad = tmp_path / "bad.json"
    bad.write_text("{not json")
    assert autotune.load_measured(str(bad)) is None
    assert autotune.load_measured(str(tmp_path / "missing.json")) is None
    no_cal = tmp_path / "nocal.json"
    autotune.save_measured(str(no_cal), {"strategy": "ell"})
    assert autotune.load_measured(str(no_cal)) is None
