"""Superstep timelines: render OLAP run records to Chrome-trace JSON —
the port's copy of ``janusgraph_tpu/observability/timeline.py``.

Every run of the executor records a structured ``run_info`` (per-superstep
walls, checkpoint saves and resumes) into the registry's run log
(``registry.runs("olap")``). This module turns one such record into the
catapult / Chrome-trace event format (``{"traceEvents": [...]}``, what
``chrome://tracing`` and https://ui.perfetto.dev load):

- row (tid) 0 is the host superstep lane: one ``X`` slice per superstep
  record, duration from its measured ``wall_ms`` (fused-path records are
  amortized chunk shares and carry ``approx: true`` through to the event
  args);
- checkpoint saves render as slices on the ``checkpoint`` lane at the
  superstep that paid them (``checkpoint_ms`` markers the executor
  stamps onto the saving record); resumes render at the front of the lane
  (``resume_ms`` total — the replay happened before the recorded steps).

Sharded runs add one lane per shard: a ``compute`` slice scaled by the
shard's measured/modeled share of the superstep wall, then an
``exchange`` slice covering the remainder (collective + barrier wait),
annotated with the run's exchange mode, bytes and batches — the
straggler shard is the lane whose compute slice pushes everyone's
exchange right. A run over several processes names each lane's process.

Timestamps are cumulative microseconds from run start (catapult's unit).
"""

from __future__ import annotations

import json
from typing import List, Optional

PID = 1  # one process lane per rendered run


def _meta(name: str, tid: int, label: str) -> dict:
    return {
        "ph": "M", "pid": PID, "tid": tid, "name": name,
        "args": {"name": label},
    }


def _slice(name, ts_us, dur_us, tid, args=None, cat="olap") -> dict:
    ev = {
        "name": name, "ph": "X", "cat": cat, "pid": PID, "tid": tid,
        "ts": round(ts_us, 3), "dur": round(max(dur_us, 0.0), 3),
    }
    if args:
        ev["args"] = args
    return ev


_ARG_KEYS = (
    "frontier", "edges", "e_cap", "pad_ratio", "combiner", "channel",
    "compiled", "approx", "flops", "bytes_accessed",
    "operational_intensity", "roofline_utilization", "h2d_bytes",
)

#: lanes: 0 = host supersteps, 1 = checkpoint/resume control, 2+ = shards
TID_HOST = 0
TID_CONTROL = 1
TID_SHARD0 = 2


def timeline_events(run: dict) -> List[dict]:
    """Catapult events for ONE run record (the ``registry.runs("olap")``
    vocabulary the executor publishes)."""
    records = run.get("superstep_records") or []
    wall_ms = float(run.get("wall_s", 0.0)) * 1000.0
    n = max(len(records), 1)
    fallback_ms = wall_ms / n if wall_ms > 0 else 1.0
    path = run.get("path", "unknown")
    executor = run.get("executor", "tpu")
    events: List[dict] = [
        _meta("process_name", TID_HOST,
              f"olap {executor} ({path})"),
        _meta("thread_name", TID_HOST, "supersteps"),
    ]
    shards = (run.get("shards") or {}).get("per_shard") or []
    exchange = run.get("exchange") or {}
    for s, row in enumerate(shards):
        # a run over several processes names each shard's process
        where = f" (process {row['process']})" if "process" in row else ""
        events.append(_meta("thread_name", TID_SHARD0 + s, f"shard {s}{where}"))
    need_control = bool(
        run.get("resumes") or
        any("checkpoint_ms" in r for r in records)
    )
    if need_control:
        events.append(_meta("thread_name", TID_CONTROL, "checkpoint"))

    ts = 0.0
    # resumes replayed BEFORE the recorded (post-resume) steps: one slice
    # at the front of the control lane keeps the run's wall honest
    resumes = int(run.get("resumes", 0) or 0)
    if resumes:
        resume_ms = float(run.get("resume_ms", 0.0) or 0.0)
        events.append(_slice(
            f"resume x{resumes}", 0.0, resume_ms * 1000.0, TID_CONTROL,
            args={"resumes": resumes, "resume_ms": resume_ms,
                  "steps": run.get("resume_steps")},
        ))
        ts = resume_ms * 1000.0

    # shard compute shares: each shard's measured/modeled wall over the
    # slowest shard's (the barrier pace-setter)
    shard_share = []
    if shards:
        walls = [float(r.get("measured_ms") or r.get("modeled_ms") or 0.0) for r in shards]
        top = max(walls) if max(walls) > 0 else 1.0
        shard_share = [w / top for w in walls]
    ex_args = {
        "mode": exchange.get("mode"),
        "agg": exchange.get("agg"),
        "elems_per_superstep": exchange.get("elems_per_superstep"),
        "bytes_per_superstep": exchange.get("bytes_per_superstep"),
        "batches": exchange.get("batches_per_superstep"),
    }
    ex_args = {k: v for k, v in ex_args.items() if v is not None}

    for i, r in enumerate(records):
        dur_us = float(r.get("wall_ms", fallback_ms)) * 1000.0
        args = {k: r[k] for k in _ARG_KEYS if k in r}
        step = int(r.get("step", i))
        events.append(_slice(
            f"superstep {step}", ts, dur_us, TID_HOST, args=args,
        ))
        for s, share in enumerate(shard_share):
            comp_us = dur_us * share
            events.append(_slice(
                "compute", ts, comp_us, TID_SHARD0 + s,
                args={"share": round(share, 4), "cost_source": shards[s].get("cost_source")},
            ))
            events.append(_slice(
                "exchange", ts + comp_us, dur_us - comp_us, TID_SHARD0 + s,
                args=ex_args, cat="exchange",
            ))
        ck_ms = r.get("checkpoint_ms")
        if ck_ms is not None:
            # the save ran at the END of this superstep's boundary; its
            # wall is part of the recorded step wall, so overlay it at the
            # slice tail
            ck_us = float(ck_ms) * 1000.0
            events.append(_slice(
                "checkpoint_save", ts + max(dur_us - ck_us, 0.0), ck_us,
                TID_CONTROL,
                args={"step": step, "checkpoint_ms": ck_ms},
            ))
        ts += dur_us
    return events


def chrome_trace(run: dict) -> dict:
    """The full Chrome-trace document for one run record."""
    meta_keys = (
        "path", "executor", "supersteps", "wall_s", "resumes",
        "resume_ms", "strategy_resolved", "pad_ratio", "retraces",
    )
    return {
        "traceEvents": timeline_events(run),
        "displayTimeUnit": "ms",
        "otherData": {k: run[k] for k in meta_keys if k in run},
    }


def render_run(registry, run: int = -1, kind: str = "olap") -> Optional[dict]:
    """Render the ``run``-th retained record (negative = from the end,
    default last). None when no such record is retained."""
    runs = registry.runs(kind)
    if not runs:
        return None
    try:
        rec = runs[run]
    except IndexError:
        return None
    return chrome_trace(rec)


def validate_chrome_trace(doc) -> Optional[str]:
    """Light validity check (tests + CLI): the document must be
    JSON-serializable, carry a ``traceEvents`` list, and every event must
    have the catapult-required fields with sane values. Returns an error
    string or None."""
    try:
        json.dumps(doc)
    except (TypeError, ValueError) as e:
        return f"not JSON-serializable: {e}"
    if not isinstance(doc, dict) or not isinstance(
        doc.get("traceEvents"), list
    ):
        return "missing traceEvents list"
    for ev in doc["traceEvents"]:
        ph = ev.get("ph")
        if ph not in ("X", "M", "i", "B", "E", "C"):
            return f"unknown phase {ph!r}"
        if "name" not in ev or "pid" not in ev or "tid" not in ev:
            return f"event missing name/pid/tid: {ev}"
        if ph == "X":
            if not isinstance(ev.get("ts"), (int, float)):
                return f"X event without numeric ts: {ev}"
            if not isinstance(ev.get("dur"), (int, float)) or ev["dur"] < 0:
                return f"X event without non-negative dur: {ev}"
    return None
