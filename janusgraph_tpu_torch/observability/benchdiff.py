"""Bench regression sentinel: compare bench artifacts, verdict deltas —
the port's copy of ``janusgraph_tpu/observability/benchdiff.py`` (stdlib
only, the same names, verdicts, thresholds and report keys).

- an **artifact** is any of the shapes a bench writes: one stage dict, a
  supervisor wrapper with a ``tail`` of per-stage JSON lines, a ``.jsonl``
  of stage lines, or a list of stage dicts. :func:`load_stages`
  normalizes all of them to a stage-dict list.

- stages are matched by **cell**: ``(stage, scale, platform/device_kind,
  host-fallback flag, cpu_count)`` — a CPU-fallback number must never
  gate a device number and vice versa.

- each stage has **headline metrics** with an explicit better-direction
  (lower for walls/latencies/pad, higher for goodput/speedups); unknown
  stages fall back to suffix conventions (``*_ms``/``*_wall_s`` lower,
  ``*_per_s``/``*speedup*`` higher).

- :func:`compare` computes per-metric deltas and classifies each as
  ``improve`` / ``regress`` / ``noise`` against a relative threshold
  (default 10%). The stage verdict is ``regress`` if ANY headline metric
  regressed, else ``improve`` if any improved, else ``noise``; a
  regression between two stages that embed sampling-profiler data also
  carries the top frame deltas (``observability/continuous.flamediff``).

- :func:`best_prior` picks, among prior artifacts matching a cell, the
  stage with the best primary (first headline) metric, so a slow round
  followed by another slow round still flags.

``python -m janusgraph_tpu_torch benchdiff <old> <new> [--fail-on-regress]``
is the CI entry point and ``bin/torch_benchdiff.sh`` wraps it.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Tuple

LOWER = "lower"
HIGHER = "higher"

#: per-stage headline metrics, primary first: (metric key, better-dir).
#: Only keys PRESENT in both stages are compared.
HEADLINES: Dict[str, List[Tuple[str, str]]] = {
    "pagerank": [
        ("pagerank_superstep_ms", LOWER),
        ("pagerank_wall_s", LOWER),
        ("ell_pad_ratio", LOWER),
        ("edges_per_sec", HIGHER),
    ],
    "bfs": [("bfs_4hop_wall_s", LOWER)],
    "bfs_dense": [
        ("bfs_dense_4hop_wall_s", LOWER),
        ("bfs_frontier_speedup", HIGHER),
    ],
    "oltp": [
        ("oltp_write_per_s", HIGHER),
        ("oltp_read_per_s", HIGHER),
        ("oltp_3hop_ms", LOWER),
    ],
    "oltp_pipeline": [("pipelined_speedup", HIGHER)],
    "oltp_spillover": [
        ("spill_3hop_speedup", HIGHER),
        ("spill_4hop_speedup", HIGHER),
    ],
    "streaming_freshness": [
        ("refresh_speedup", HIGHER),
        ("refresh_median_ms", LOWER),
        ("staleness_window_ms", LOWER),
        ("writes_per_s", HIGHER),
    ],
    "dense_gcn": [
        ("superstep_ms", LOWER),
        ("mxu_utilization", HIGHER),
    ],
    "workload": [("wall_s", LOWER)],
    "dataset": [("wall_s", LOWER)],
    "saturate": [
        ("peak_goodput_per_s", HIGHER),
        ("goodput_2x_over_peak", HIGHER),
    ],
    "fleet_chaos": [
        ("failover_p99_ms", LOWER),
        ("goodput_during_kill_over_prekill", HIGHER),
        ("goodput_recovered_over_prekill", HIGHER),
        ("pre_kill_goodput_per_s", HIGHER),
    ],
    # PR 18: leader-kill failover certified from the durable CDC log —
    # promotion latency first (the availability gap), then the staleness
    # ceiling followers actually served at, then the read share they
    # absorbed (the scale-out payoff)
    "fleet_cdc_failover": [
        ("promote_ms", LOWER),
        ("staleness_p99_ms", LOWER),
        ("follower_read_share", HIGHER),
    ],
    # PR 19: seeded stall forensics — detection latency is the headline
    # (stall onset -> lock_convoy flight event); everything else in the
    # stage is boolean acceptance, not a trend
    "fleet_stall_forensics": [("detect_ms", LOWER)],
    # PR 20: streaming telemetry — push-mode event freshness first (the
    # latency collapse push exists for), then the bus's own CPU bill;
    # loss/duplication in the stage are boolean acceptance, not trends
    "fleet_push_poll": [
        ("push_event_p99_ms", LOWER),
        ("bus_cpu_overhead_pct", LOWER),
        ("push_vs_poll_speedup", HIGHER),
    ],
    "multichip_ab": [("superstep_ms", LOWER)],
    "chaos": [("recovery_open_ms", LOWER)],
    "smoke": [],
}

#: suffix conventions for stages without an explicit headline list
_SUFFIX_DIRS = (
    ("_ms", LOWER), ("_wall_s", LOWER), ("_pad_ratio", LOWER),
    ("_per_s", HIGHER), ("_per_sec", HIGHER), ("speedup", HIGHER),
    ("goodput", HIGHER), ("utilization", HIGHER),
)

#: default relative noise threshold (see module doc)
NOISE_THRESHOLD = 0.10


def headline_metrics(stage: dict) -> List[Tuple[str, str]]:
    """(key, better-dir) pairs for one stage dict, primary first."""
    explicit = HEADLINES.get(str(stage.get("stage", "")))
    if explicit is not None:
        return [m for m in explicit if _numeric(stage.get(m[0]))]
    out = []
    for key in sorted(stage):
        if not _numeric(stage.get(key)):
            continue
        for suffix, direction in _SUFFIX_DIRS:
            if key.endswith(suffix) or suffix in key:
                out.append((key, direction))
                break
    return out


def _numeric(v) -> bool:
    return isinstance(v, (int, float)) and not isinstance(v, bool)


# ------------------------------------------------------------------ loading
def load_stages(path: str) -> List[dict]:
    """Every stage dict found in one artifact file (see module doc for
    the accepted shapes). Unparseable lines are skipped, not fatal."""
    stages: List[dict] = []
    with open(path) as f:
        raw = f.read()
    if path.endswith(".jsonl"):
        docs = _parse_lines(raw)
    else:
        try:
            docs = [json.loads(raw)]
        except json.JSONDecodeError:
            docs = _parse_lines(raw)
    for doc in docs:
        stages.extend(_stages_of(doc))
    return stages


def _parse_lines(raw: str) -> List[dict]:
    out = []
    for ln in raw.splitlines():
        ln = ln.strip()
        if not ln:
            continue
        try:
            out.append(json.loads(ln))
        except json.JSONDecodeError:
            continue
    return out


def _stages_of(doc) -> List[dict]:
    if isinstance(doc, list):
        out = []
        for d in doc:
            out.extend(_stages_of(d))
        return out
    if not isinstance(doc, dict):
        return []
    if "stage" in doc:
        return [doc]
    out = []
    for key in ("stages", "parsed"):
        if key in doc:
            out.extend(_stages_of(doc[key]))
    # supervisor wrappers carry stage JSON objects embedded in a `tail`
    # text blob: recover whole JSON objects from it
    tail = doc.get("tail")
    if isinstance(tail, str):
        out.extend(s for s in _scan_json_objects(tail) if "stage" in s)
    return out


def _scan_json_objects(text: str) -> List[dict]:
    """Top-level JSON objects embedded anywhere in a text blob."""
    decoder = json.JSONDecoder()
    out = []
    i = 0
    n = len(text)
    while i < n:
        j = text.find("{", i)
        if j < 0:
            break
        try:
            obj, end = decoder.raw_decode(text, j)
        except json.JSONDecodeError:
            i = j + 1
            continue
        if isinstance(obj, dict):
            out.append(obj)
        i = end
    return out


# --------------------------------------------------------------------- cells
#: cell component names, aligned with cell_key()'s tuple order — the
#: no_baseline note names which of these a near-miss differs on
CELL_FIELDS = ("stage", "scale", "platform", "host_fallback", "cpu_count")


def cell_key(stage: dict) -> Tuple:
    """The comparability cell: (stage, scale, platform, host-fallback,
    host cpu_count). cpu_count joined after the SATURATE r01->r03
    424->360 ops/s mystery turned out to be a 1-core runner: throughput
    cells from hosts with different core counts are not comparable, so
    they must not verdict against each other. Artifacts predating the
    field carry cpu_count=None and keep matching each other."""
    return (
        str(stage.get("stage", "")),
        stage.get("scale"),
        str(stage.get("platform", stage.get("device_kind", "")) or ""),
        bool(stage.get("host_fallback", False)),
        stage.get("cpu_count"),
    )


def nearest_cell_mismatch(
    stages: List[dict], cell: Tuple
) -> Optional[str]:
    """When no prior artifact matches a cell exactly, name the key
    component(s) the CLOSEST near-miss differs on (same stage name,
    fewest differing components) — so a no_baseline verdict says
    "prior cells exist but differ on cpu_count" instead of leaving the
    operator to diff tuples by hand."""
    best_diff: Optional[List[str]] = None
    for s in stages:
        k = cell_key(s)
        if k == cell or k[0] != cell[0]:
            continue
        diff = [
            CELL_FIELDS[i]
            for i in range(1, len(CELL_FIELDS))
            if k[i] != cell[i]
        ]
        if best_diff is None or len(diff) < len(best_diff):
            best_diff = diff
    if not best_diff:
        return None
    return "nearest prior cell differs on: " + ", ".join(best_diff)


def best_prior(
    stages: List[dict], cell: Tuple
) -> Optional[dict]:
    """Best prior stage for a cell: the one with the best PRIMARY
    headline metric (ties/absence resolve to the last seen)."""
    candidates = [s for s in stages if cell_key(s) == cell]
    if not candidates:
        return None
    best = None
    best_val = None
    best_dir = None
    for s in candidates:
        metrics = headline_metrics(s)
        if not metrics:
            best = s  # keep SOMETHING comparable (e.g. smoke)
            continue
        key, direction = metrics[0]
        v = s[key]
        if best_val is None or (
            v < best_val if direction == LOWER else v > best_val
        ):
            best, best_val, best_dir = s, v, direction
    del best_dir
    return best


# ------------------------------------------------------------------ compare
def compare(
    old: dict, new: dict, threshold: float = NOISE_THRESHOLD
) -> dict:
    """Per-metric deltas + verdict for two stage dicts of one cell."""
    metrics = []
    verdicts = set()
    for key, direction in headline_metrics(new):
        if not _numeric(old.get(key)):
            continue
        ov, nv = float(old[key]), float(new[key])
        delta = nv - ov
        rel = delta / abs(ov) if ov else (0.0 if nv == 0 else float("inf"))
        worse = rel > 0 if direction == LOWER else rel < 0
        if abs(rel) <= threshold:
            verdict = "noise"
        elif worse:
            verdict = "regress"
        else:
            verdict = "improve"
        verdicts.add(verdict)
        metrics.append({
            "metric": key,
            "better": direction,
            "old": ov,
            "new": nv,
            "delta": round(delta, 6),
            "delta_pct": (
                round(rel * 100.0, 2) if rel != float("inf") else None
            ),
            "verdict": verdict,
        })
    if "regress" in verdicts:
        overall = "regress"
    elif "improve" in verdicts:
        overall = "improve"
    elif metrics:
        overall = "noise"
    else:
        overall = "incomparable"
    out = {
        "verdict": overall,
        "threshold_pct": round(threshold * 100.0, 2),
        "cell": list(cell_key(new)),
        "metrics": metrics,
    }
    if overall == "regress":
        deltas = _frame_deltas(old, new)
        if deltas:
            out["frame_deltas"] = deltas
    return out


def _frame_deltas(old: dict, new: dict, top: int = 3) -> List[dict]:
    """Top frame-level flame deltas between two stages that both embed
    profile data (``flame``/``stacks`` blocks from the continuous
    sampling profiler) — WHERE the regressed time went, not just that it
    went. Empty when either side carries no profile."""
    try:
        from janusgraph_tpu_torch.observability.continuous import flamediff

        return flamediff(old, new, top=top)
    except Exception:  # noqa: BLE001 - sentinel never fails a bench
        return []


def diff_artifacts(
    old_path: str, new_path: str, threshold: float = NOISE_THRESHOLD
) -> dict:
    """Compare every cell present in BOTH artifacts. The `benchdiff`
    subcommand's payload: per-cell comparison blocks + roll-up counts."""
    old_stages = load_stages(old_path)
    new_stages = load_stages(new_path)
    comparisons = []
    seen = set()
    for s in new_stages:
        cell = cell_key(s)
        if cell in seen:
            continue
        seen.add(cell)
        prior = best_prior(old_stages, cell)
        if prior is None:
            continue
        comparisons.append(compare(prior, s, threshold))
    counts: Dict[str, int] = {}
    for c in comparisons:
        counts[c["verdict"]] = counts.get(c["verdict"], 0) + 1
    return {
        "old": os.path.basename(old_path),
        "new": os.path.basename(new_path),
        "cells_compared": len(comparisons),
        "counts": counts,
        "regressed": counts.get("regress", 0) > 0,
        "comparisons": comparisons,
    }


# ----------------------------------------------------- bench-side attachment
class BaselineIndex:
    """Prior-artifact stages indexed once per process: a bench attaches a
    regression block to every stage it emits through this. Nothing in the
    port calls it yet: it waits for the port's own benchmark, whose
    harness will attach the block as the reference's ``bench.py`` does."""

    def __init__(self, search_dirs: List[str]):
        self.search_dirs = search_dirs
        self._stages: Optional[List[dict]] = None

    def stages(self) -> List[dict]:
        if self._stages is None:
            stages: List[dict] = []
            for d in self.search_dirs:
                if not os.path.isdir(d):
                    continue
                for fn in sorted(os.listdir(d)):
                    if not (fn.endswith(".json") or fn.endswith(".jsonl")):
                        continue
                    try:
                        stages.extend(load_stages(os.path.join(d, fn)))
                    except OSError:
                        continue
            self._stages = stages
        return self._stages

    def attach_regression(
        self, stage: dict, threshold: float = NOISE_THRESHOLD
    ) -> dict:
        """Mutates ``stage``: adds the ``regression`` verdict block (or a
        no-op note when no prior artifact matches its cell). Never
        raises — the sentinel must not fail a bench run."""
        try:
            if not headline_metrics(stage):
                return stage
            cell = cell_key(stage)
            prior = best_prior(self.stages(), cell)
            if prior is None or prior is stage:
                note = "no prior artifact matches this cell"
                mismatch = nearest_cell_mismatch(self.stages(), cell)
                if mismatch:
                    note = f"{note} ({mismatch})"
                stage["regression"] = {
                    "verdict": "no_baseline",
                    "note": note,
                    "cell": list(cell),
                }
                return stage
            stage["regression"] = compare(prior, stage, threshold)
        except Exception as e:  # noqa: BLE001 - sentinel never fails a bench
            stage["regression"] = {
                "verdict": "error", "note": f"{type(e).__name__}: {e}"[:200],
            }
        return stage
