"""Exposition renderers: Prometheus text format + JSON snapshot — the
port's copy of ``janusgraph_tpu/observability/exposition.py``.

``prometheus_text`` renders the registry in the text exposition format
(one ``# TYPE`` per family; counters as ``_total``, timers as
``_seconds`` histograms with cumulative ``le`` buckets, value histograms
raw, gauges as-is); ``validate_prometheus_text`` checks a rendering.

``json_snapshot`` bundles the metric snapshot, recent span trees, the
slow-op log and the structured run records.
"""

from __future__ import annotations

import re
from typing import Optional

_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")


def _pname(prefix: str, name: str) -> str:
    out = _NAME_RE.sub("_", f"{prefix}_{name}" if prefix else name)
    if not out or not (out[0].isalpha() or out[0] in "_:"):
        out = "_" + out
    return out


def _fmt(v: float) -> str:
    # integral values print as ints: keeps counter samples exact
    if float(v).is_integer() and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


def _histogram_lines(lines, name, buckets, total_count, total_sum, scale=1.0):
    """Cumulative `le` buckets + +Inf + _sum/_count for one histogram.
    `scale` converts the stored unit (e.g. ns -> seconds: 1e-9)."""
    lines.append(f"# TYPE {name} histogram")
    for le, cum in buckets:
        lines.append(f'{name}_bucket{{le="{repr(le * scale)}"}} {cum}')
    lines.append(f'{name}_bucket{{le="+Inf"}} {total_count}')
    lines.append(f"{name}_sum {repr(total_sum * scale)}")
    lines.append(f"{name}_count {total_count}")


def prometheus_text(registry, prefix: str = "janusgraph") -> str:
    from janusgraph_tpu_torch.observability.identity import replica_name

    counters, timers, histograms, gauges = registry.metric_objects()
    lines = []
    replica = replica_name()
    if replica:
        # the fleet identity rides /metrics as a Prometheus info metric
        # (the k8s `*_info` convention): scrapes from N replicas stay
        # distinguishable even behind one relabeling-free scrape target
        n = _pname(prefix, "replica_info")
        lines.append(f"# TYPE {n} gauge")
        lines.append(
            f'{n}{{replica="{_NAME_RE.sub("_", replica)}"}} 1'
        )
    for name in sorted(counters):
        n = _pname(prefix, name) + "_total"
        lines.append(f"# TYPE {n} counter")
        lines.append(f"{n} {counters[name].count}")
    for name in sorted(gauges):
        n = _pname(prefix, name)
        lines.append(f"# TYPE {n} gauge")
        lines.append(f"{n} {_fmt(gauges[name].value)}")
    for name in sorted(timers):
        t = timers[name]
        _histogram_lines(
            lines, _pname(prefix, name) + "_seconds",
            t.cumulative_buckets(), t.count, t.total, scale=1e-9,
        )
    for name in sorted(histograms):
        h = histograms[name]
        _histogram_lines(
            lines, _pname(prefix, name),
            h.cumulative_buckets(), h.count, h.total,
        )
    return "\n".join(lines) + "\n"


def json_snapshot(registry, tracer=None, span_limit: int = 32) -> dict:
    """Everything in one JSON-friendly dict: metric snapshot, recent span
    trees (newest last, bounded), slow-op events, structured run logs."""
    out = {"metrics": registry.snapshot()}
    runs = {}
    for kind in ("olap",):
        rs = registry.runs(kind)
        if rs:
            runs[kind] = rs
    out["runs"] = runs
    if tracer is not None:
        roots = tracer.recent()
        out["spans"] = [r.to_dict() for r in roots[-span_limit:]]
        out["slow_ops"] = tracer.slow_ops()
    return out


def validate_prometheus_text(text: str) -> Optional[str]:
    """Light validity check used by tests/CLI: returns an error string or
    None. Checks sample-line syntax, histogram bucket monotonicity and
    that `+Inf` matches `_count`."""
    sample_re = re.compile(
        r"^[a-zA-Z_:][a-zA-Z0-9_:]*(\{[^{}]*\})? -?[0-9.eE+-]+(Inf|nan)?$"
    )
    buckets: dict = {}
    counts: dict = {}
    for ln in text.splitlines():
        if not ln or ln.startswith("#"):
            continue
        if not sample_re.match(ln):
            return f"malformed sample line: {ln!r}"
        name_part, value = ln.rsplit(" ", 1)
        if "_bucket{" in name_part:
            base = name_part.split("_bucket{", 1)[0]
            buckets.setdefault(base, []).append(float(value))
        elif name_part.endswith("_count") and base_of(name_part) in buckets:
            counts[base_of(name_part)] = float(value)
    for base, cums in buckets.items():
        if any(lo > hi for lo, hi in zip(cums, cums[1:])):
            return f"non-monotone buckets for {base}"
        if base in counts and cums and cums[-1] != counts[base]:
            return f"+Inf bucket != _count for {base}"
    return None


def base_of(name_part: str) -> str:
    return name_part[: -len("_count")]
