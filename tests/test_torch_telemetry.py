"""The port's telemetry modules (``janusgraph_tpu_torch/observability/``,
``util/metrics.py``) held to the JAX package's: the same calls go through
both packages' registries, tracers, flight recorders, ledgers, roofline
helpers and renderers, and give the same numbers and bytes."""

import json
import threading

import numpy as np
import pytest

import janusgraph_tpu.observability as R
from janusgraph_tpu.observability import exposition as r_expo
from janusgraph_tpu.observability import flight as r_flight
from janusgraph_tpu.observability import profiler as r_prof
from janusgraph_tpu.observability import timeline as r_timeline
from janusgraph_tpu.observability.metrics_core import (
    Histogram as RHistogram,
    TelemetryRegistry as RRegistry,
)

import janusgraph_tpu_torch.observability as P
from janusgraph_tpu_torch.observability import exposition as p_expo
from janusgraph_tpu_torch.observability import flight as p_flight
from janusgraph_tpu_torch.observability import logging as p_logging
from janusgraph_tpu_torch.observability import profiler as p_prof
from janusgraph_tpu_torch.observability import timeline as p_timeline
from janusgraph_tpu_torch.observability.metrics_core import (
    BUCKET_BOUNDS,
    Histogram as PHistogram,
    TelemetryRegistry as PRegistry,
)


@pytest.fixture(autouse=True)
def _reset_port_telemetry():
    P.tracer.reset()
    P.tracer.configure(slow_threshold_ms=100.0, max_roots=256, slow_buffer=128)
    yield
    P.tracer.reset()
    P.tracer.configure(slow_threshold_ms=100.0, max_roots=256, slow_buffer=128)
    p_prof.configure_roofline(0.0, 0.0, 0.0)
    r_prof.configure_roofline(0.0, 0.0, 0.0)


def _same_calls(reg):
    """One sequence of registry calls, run on either package's registry."""
    for i in range(1, 50):
        reg.counter("storage.edgestore.getSlice.calls").inc(i % 3)
        reg.timer("tx.commit").update(1_000 * i * i)
        reg.histogram("olap.frontier.size").observe(float(i * 17))
    reg.set_gauge("olap.run.wall_ms", 12.5)
    reg.set_gauge("olap.ell.pad_ratio", 1.5171)
    reg.gauge("olap.device.bytes_in_use").set(2.0 ** 33)
    with reg.time("storage.mutateMany"):
        pass
    reg.record_run("olap", {"path": "fused", "supersteps": 3})
    return reg


def _stable_snapshot(reg):
    snap = reg.snapshot()
    # the one timer timed with the wall clock differs run to run
    snap.pop("storage.mutateMany")
    return snap


def test_bucket_ladder_equal():
    from janusgraph_tpu.observability.metrics_core import BUCKET_BOUNDS as RB

    assert list(BUCKET_BOUNDS) == list(RB)


@pytest.mark.parametrize("values", [
    [float(v) for v in range(1, 1001)],
    [1e-7, 3.5, 3.5, 2.0 ** 40, 17.0],
    list(np.random.default_rng(3).lognormal(2.0, 3.0, 500)),
])
def test_histogram_percentiles_equal(values):
    p, r = PHistogram(), RHistogram()
    for v in values:
        p.observe(v)
        r.observe(v)
    for q in (0.0, 0.5, 0.9, 0.95, 0.99, 1.0):
        assert p.percentile(q) == r.percentile(q)
    assert p.summary() == r.summary()
    assert p.cumulative_buckets() == r.cumulative_buckets()


def test_timer_percentiles_equal():
    p, r = PRegistry(), RRegistry()
    for reg in (p, r):
        t = reg.timer("storage.edgestore.getSlice")
        for ns in (1_000, 10_000, 100_000, 1_000_000, 10_000_000):
            t.update(ns)
    pt, rt = p.timer("storage.edgestore.getSlice"), r.timer("storage.edgestore.getSlice")
    for q in (0.5, 0.95, 0.99):
        assert pt.percentile_ms(q) == rt.percentile_ms(q)
    entry = p.snapshot()["storage.edgestore.getSlice"]
    assert entry["count"] == 5
    assert 0 < entry["p50_ms"] <= entry["p95_ms"] <= entry["p99_ms"]
    assert "p95_ms" in p.report()


def test_snapshot_equal_and_name_sorted():
    p, r = _same_calls(PRegistry()), _same_calls(RRegistry())
    assert _stable_snapshot(p) == _stable_snapshot(r)
    names = list(p.snapshot())
    assert names == sorted(names)
    assert p.get_count("storage.edgestore.getSlice.calls") == r.get_count(
        "storage.edgestore.getSlice.calls"
    )


def test_run_records_and_reset():
    p = PRegistry()
    p.record_run("olap", {"path": "fused", "supersteps": 3})
    p.record_run("olap", {"path": "host-loop", "supersteps": 5})
    assert p.last_run("olap")["supersteps"] == 5
    assert [run["path"] for run in p.runs("olap")] == ["fused", "host-loop"]
    p.reset()
    assert p.last_run("olap") is None


def test_prometheus_text_byte_equal():
    p, r = PRegistry(), RRegistry()
    for reg in (p, r):
        _same_calls(reg)
        reg.reset()  # the wall-clocked timer out, then the same calls again
        for i in range(1, 50):
            reg.counter("storage.edgestore.getSlice.calls").inc(i % 3)
            reg.timer("tx.commit").update(1_000 * i * i)
            reg.histogram("olap.frontier.size").observe(float(i * 17))
        reg.set_gauge("olap.run.wall_ms", 12.5)
    text = p_expo.prometheus_text(p)
    assert text == r_expo.prometheus_text(r)
    assert p_expo.validate_prometheus_text(text) is None
    assert r_expo.validate_prometheus_text(text) is None
    assert p_expo.prometheus_text(p, prefix="jg") == r_expo.prometheus_text(r, prefix="jg")


def test_json_snapshot_carries_runs_and_spans():
    reg = _same_calls(PRegistry())
    with P.tracer.span("olap.run", program="PageRankProgram"):
        P.tracer.record_span("superstep", 1.0, step=0)
    snap = p_expo.json_snapshot(reg, P.tracer)
    assert snap["runs"]["olap"][0]["supersteps"] == 3
    assert any(s["name"] == "olap.run" for s in snap["spans"])
    json.dumps(snap, default=str)


def test_util_metrics_is_the_registry():
    from janusgraph_tpu_torch.util.metrics import metrics

    assert metrics is P.registry


def _tree(span):
    return {"name": span.name, "attrs": dict(span.attrs),
            "children": [_tree(c) for c in span.children]}


def test_span_nesting_and_record_span_equal():
    trees = []
    for tracer in (P.tracer, R.tracer):
        with tracer.span("outer", kind="test") as o:
            with tracer.span("inner") as i:
                i.annotate(x=1, arr=np.float32(2.5))
            s = tracer.record_span("superstep", 5.0, step=0, frontier=10)
        assert s in o.children
        assert s.duration_ms == pytest.approx(5.0, rel=0.01)
        assert o.duration_ms >= o.children[0].duration_ms
        assert all(c.trace_id == o.trace_id for c in o.children)
        json.dumps(o.to_dict())
        trees.append(_tree(tracer.recent("outer")[-1]))
    R.tracer.reset()
    assert trees[0] == trees[1]
    assert trees[0]["children"][0]["attrs"] == {"x": 1, "arr": 2.5}


def test_find_trace_and_child_span_join():
    with P.tracer.span("root") as root:
        ctx = root.context()
    with P.tracer.child_span(P.TraceContext.from_header(ctx.to_header()), "remote.part"):
        pass
    found = P.tracer.find_trace(root.trace_id)
    assert {s.name for s in found} == {"root", "remote.part"}
    joined = [s for s in found if s.name == "remote.part"][0]
    assert joined.parent_span_id == root.span_id


def test_slow_op_ring_and_flight_feed():
    P.flight_recorder.reset()
    P.tracer.configure(slow_threshold_ms=1e-6, slow_buffer=3)
    for i in range(5):
        with P.tracer.span(f"slow.thing{i}", tag="x"):
            pass
    events = P.tracer.slow_ops()
    assert [e["name"] for e in events] == ["slow.thing2", "slow.thing3", "slow.thing4"]
    # every slow span also lands in the flight recorder
    assert [e["name"] for e in P.flight_recorder.events("slow_span")][-3:] == [
        "slow.thing2", "slow.thing3", "slow.thing4"
    ]
    P.tracer.configure(slow_threshold_ms=0.0)  # 0 = off
    with P.tracer.span("fast.thing"):
        pass
    assert len(P.tracer.slow_ops()) == 3
    P.flight_recorder.reset()


def test_capture_scope_carries_the_span_across_threads():
    out = []
    with P.tracer.span("pool.submit") as sp:
        work = P.capture_scope(lambda: out.append(P.tracer.current()))
        t = threading.Thread(target=work)
        t.start()
        t.join()
    assert out == [sp]


def _masked(events):
    return [{k: v for k, v in e.items() if k not in ("ts", "mono")} for e in events]


def test_flight_ring_bound_and_ordered_dump(tmp_path):
    rings = []
    for mod in (p_flight, r_flight):
        fr = mod.FlightRecorder(capacity=4, dump_dir=str(tmp_path / mod.__name__))
        for i in range(10):
            fr.record("checkpoint", action="save", steps=i, weight=np.float32(0.5))
        fr.record("olap_resume", executor="cpu", attempt=1, program="PageRankProgram")
        assert fr.capacity == 4 and fr.occupancy == 4
        assert fr.counts() == {"checkpoint": 10, "olap_resume": 1}
        evs = fr.events()
        assert [e["seq"] for e in evs] == [8, 9, 10, 11]
        assert [e["steps"] for e in fr.events("checkpoint")] == [7, 8, 9]
        rings.append(_masked(evs))
        path = fr.dump(reason="test")
        with open(path) as f:
            payload = json.load(f)
        assert payload["reason"] == "test" and payload["total_recorded"] == 11
        seqs = [e["seq"] for e in payload["events"]]
        assert seqs == sorted(seqs)
        assert _masked(payload["events"]) == rings[-1]
    assert rings[0] == rings[1]


def test_structured_log_carries_the_trace():
    p_logging.reset()
    log = P.get_logger("olap")
    with P.tracer.span("olap.submit") as sp:
        rec = log.info("submitted", program="PageRankProgram")
    assert rec["trace_id"] == f"{sp.trace_id:016x}"
    assert p_logging.recent()[-1]["event"] == "submitted"
    p_logging.reset()


def _run_record():
    """A host-loop run record with a checkpoint save and a resume."""
    recs = []
    for s in range(4):
        r = {"step": s, "wall_ms": 0.5 + s, "combiner": "sum", "channel": None,
             "compiled": s == 0, "frontier": 256, "pad_ratio": 1.5171,
             "h2d_bytes": 15500 if s == 0 else 0}
        recs.append(r)
    recs[1]["checkpoint_ms"] = 0.25
    p_prof.attach_roofline(recs, p_prof.estimate_superstep_cost(256, 2048, arg_bytes=15500),
                           p_prof.device_peaks("cpu"))
    return {"path": "host-loop", "supersteps": 4, "wall_s": 0.012, "resumes": 1,
            "resume_steps": [{"attempt": 1, "at_s": 0.004, "from_step": 2}],
            "superstep_records": recs}


def test_chrome_trace_equal_and_valid():
    run = _run_record()
    doc = p_timeline.chrome_trace(run)
    assert doc == r_timeline.chrome_trace(run)
    assert p_timeline.validate_chrome_trace(doc) is None
    assert r_timeline.validate_chrome_trace(doc) is None
    json.dumps(doc)
    reg = PRegistry()
    reg.record_run("olap", run)
    assert p_timeline.render_run(reg) == doc


def test_ledger_scope_nesting_and_accrue():
    results = []
    for obs, prof in ((P, p_prof), (R, r_prof)):
        assert prof.current_ledger() is None
        prof.accrue(h2d_bytes=5)  # outside a scope: nothing
        with obs.tracer.span("request") as sp:
            with prof.ledger_scope() as outer:
                prof.accrue(cells_read=3, h2d_bytes=100)
                with prof.ledger_scope() as inner:
                    prof.accrue(cells_read=2, d2h_bytes=8)
                    prof.accrue_wall("olap", 1.5)
                    assert prof.current_ledger() is inner
                assert inner.to_dict() == {
                    "cells_read": 2, "d2h_bytes": 8, "wall_ms_by_layer": {"olap": 1.5}
                }
                prof.accrue_wall("olap", 0.5)
            assert prof.current_ledger() is None
        results.append((outer.to_dict(), outer.op_cells(),
                        {k: v for k, v in sp.attrs.items() if k.startswith("ledger.")}))
    R.tracer.reset()
    assert results[0] == results[1]
    assert results[0][0] == {"cells_read": 5, "h2d_bytes": 100, "d2h_bytes": 8,
                             "wall_ms_by_layer": {"olap": 2.0}}


@pytest.mark.parametrize("override", [
    (0.0, 0.0, 0.0),
    (1e12, 2e11, 3e12),
    (0.0, 4e11, 0.0),
])
@pytest.mark.parametrize("kind", ["cpu", "TPU v5 lite", "NVIDIA H100 80GB HBM3"])
def test_roofline_point_with_config_override(override, kind):
    p_prof.configure_roofline(*override)
    r_prof.configure_roofline(*override)
    pp = p_prof.device_peaks(kind)
    if "H100" not in kind:
        assert pp == r_prof.device_peaks(kind)
    for flops, nbytes, wall in ((2.2e7, 1.4e8, 0.26), (5.0, 12.0, 0.0), (3e9, 1e6, 2.0)):
        assert p_prof.roofline_point(flops, nbytes, wall, pp) == r_prof.roofline_point(
            flops, nbytes, wall, pp
        )
    if override[1]:
        assert pp["peak_bytes_per_s"] == override[1] and pp["source"] == "config"


@pytest.mark.parametrize("weighted,cols,arg_bytes", [
    (False, 1, 0), (True, 1, 15500), (False, 32, 1 << 20),
])
def test_estimate_attach_roofline_and_mxu_equal(weighted, cols, arg_bytes):
    assert p_prof.estimate_superstep_cost(
        1 << 10, 1 << 14, msg_cols=cols, weighted=weighted, arg_bytes=arg_bytes
    ) == r_prof.estimate_superstep_cost(
        1 << 10, 1 << 14, msg_cols=cols, weighted=weighted, arg_bytes=arg_bytes
    )
    peaks = p_prof.device_peaks("cpu")

    def records():
        out = [{"step": i, "wall_ms": 0.1 * (i + 1), "e_cap": 1 << (10 + i % 2)} for i in range(4)]
        out.append({"step": 4, "wall_ms": 0.3})  # a dense record
        return out

    pr, rr = records(), records()
    cost = p_prof.estimate_superstep_cost(1 << 10, 1 << 14, msg_cols=cols, weighted=weighted)
    assert p_prof.attach_roofline(pr, cost, peaks) == r_prof.attach_roofline(rr, cost, peaks)
    assert pr == rr
    assert p_prof.attach_mxu(pr, 4.2e6, peaks) == r_prof.attach_mxu(rr, 4.2e6, peaks)
    assert pr == rr


def test_matmul_peak_names_the_unit():
    peaks = p_prof.device_peaks("NVIDIA H100 80GB HBM3")
    assert p_prof.matmul_peak(peaks, "cuda") == (67e12, "fp32 (TF32 off)")
    assert peaks["peak_mxu_flops"] == 494.7e12  # the tuner's table row stays
    cpu = p_prof.device_peaks("cpu")
    assert p_prof.matmul_peak(cpu, "cpu") == (cpu["peak_mxu_flops"], "table:cpu")
    p_prof.configure_roofline(peak_mxu_flops=1e14)
    assert p_prof.matmul_peak(peaks, "cuda") == (1e14, "config")


def test_flame_lines_equal():
    with P.tracer.span("olap.submit") as root:
        with p_prof.ledger_scope():
            with P.tracer.span("olap.load_csr"):
                p_prof.accrue(cells_read=7)
            with P.tracer.span("olap.run; x"):
                P.tracer.record_span("superstep", 2.0, step=0)
                P.tracer.record_span("superstep", 3.0, step=1)
    roots = P.tracer.find_trace(root.trace_id)
    lines = p_prof.flame_lines(roots)
    assert lines == r_prof.flame_lines(roots)
    assert lines[0].startswith("olap.submit ")
    assert any(line.startswith("olap.submit;olap.load_csr(cells_read:7) ") for line in lines)
    assert sum(1 for line in lines if ";olap.run_x;superstep " in line) == 2
    assert p_prof.flame_text(P.tracer, root.trace_id) == "\n".join(lines)
