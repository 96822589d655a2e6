"""Query profiling: a nested timer/annotation tree over traversal execution
— the port's copy of ``janusgraph_tpu/core/profile.py``.

Capability parity with the reference's profiler
(reference: graphdb/query/profile/QueryProfiler.java:122 — nested profiler
groups annotated with condition/ordering/limit/index; SimpleQueryProfiler.java:116
concrete impl; bridged to Gremlin .profile() by
graphdb/tinkerpop/profile/TP3ProfileWrapper.java)."""

from __future__ import annotations

import time
from typing import Dict, List, Optional


class QueryProfiler:
    """One profiled group: wall time, annotations, children (reference:
    SimpleQueryProfiler.java:116)."""

    def __init__(self, group: str = "query"):
        self.group = group
        self.annotations: Dict[str, object] = {}
        self.children: List["QueryProfiler"] = []
        self._t0: Optional[int] = None
        self.elapsed_ns: int = 0

    # -------------------------------------------------------------- recording
    def add_nested(self, group: str) -> "QueryProfiler":
        child = QueryProfiler(group)
        self.children.append(child)
        return child

    def annotate(self, key: str, value) -> "QueryProfiler":
        self.annotations[key] = value
        return self

    def start(self) -> "QueryProfiler":
        self._t0 = time.perf_counter_ns()
        return self

    def stop(self) -> "QueryProfiler":
        if self._t0 is not None:
            self.elapsed_ns += time.perf_counter_ns() - self._t0
            self._t0 = None
        return self

    def __enter__(self) -> "QueryProfiler":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # -------------------------------------------------------------- reporting
    @property
    def elapsed_ms(self) -> float:
        return self.elapsed_ns / 1e6

    def as_dict(self) -> dict:
        return {
            "group": self.group,
            "elapsed_ms": self.elapsed_ms,
            "annotations": dict(self.annotations),
            "children": [c.as_dict() for c in self.children],
        }

    def render(self, indent: int = 0) -> str:
        pad = "  " * indent
        ann = ", ".join(f"{k}={v}" for k, v in self.annotations.items())
        line = f"{pad}{self.group:30} {self.elapsed_ms:10.3f}ms"
        if ann:
            line += f"  [{ann}]"
        lines = [line]
        for c in self.children:
            lines.append(c.render(indent + 1))
        return "\n".join(lines)

    def total_child_ms(self) -> float:
        return sum(c.elapsed_ms for c in self.children)


class TraversalMetrics:
    """The object .profile() returns: the profiler tree plus traverser
    counts (reference: TP3 TraversalMetrics via TP3ProfileWrapper), and
    — beyond reference parity — a ``resources`` block fed by the
    per-query ResourceLedger (cells read/written, bytes moved, index
    hits, retries, wall by layer; observability/profiler.py), the same
    cost vocabulary OLAP run records report."""

    def __init__(
        self, profiler: QueryProfiler, result: list,
        resources: Optional[dict] = None,
    ):
        self.profiler = profiler
        self.result = result
        self.resources: dict = resources or {}

    @property
    def elapsed_ms(self) -> float:
        return self.profiler.elapsed_ms

    def as_dict(self) -> dict:
        return self.profiler.as_dict()

    def __str__(self) -> str:
        return self.profiler.render()
