"""JG106: telemetry recording inside a CUDA-graph capture. Every call below
runs at CAPTURE time — the counter bumps once per capture instead of once
per superstep, and a span timing a captured body measures the capture, not
the replay. Translates tests/fixtures/graphlint/bad_trace_telemetry.py."""

import torch

from janusgraph_tpu_torch.observability import span
from janusgraph_tpu_torch.util.metrics import metrics


def superstep(state):
    metrics.counter("olap.superstep").inc()  # expect: JG106
    with span("olap.superstep.body", step=0):  # expect: JG106
        out = state * 2.0
    metrics.timer("olap.superstep.wall").update(3)  # expect: JG106
    return out


def body(state):
    with metrics.time("olap.agg"):  # expect: JG106
        return state + 1.0


fn = torch.cuda.make_graphed_callables(body, (torch.ones(1),))


def capture(state: torch.Tensor):
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        out = superstep(state)
    metrics.counter("olap.captures").inc()  # host code: must NOT fire
    return g, out
