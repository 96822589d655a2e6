"""JG108: profiler / resource-ledger / cost-model calls inside a CUDA-graph
capture. Each call below fires at CAPTURE time — one ledger accrual (or
digest observation, or cost estimate) per capture instead of per replay,
with capture-time values. Translates
tests/fixtures/graphlint/bad_trace_profiler.py."""

import torch

from janusgraph_tpu_torch.observability.profiler import (
    accrue,
    current_ledger,
    digest_table,
    estimate_superstep_cost,
)


def superstep(state):
    accrue(cells_read=1)  # expect: JG108
    digest_table.observe("ab12cd34", "V>out>count", 1.0)  # expect: JG108
    return state * 2.0


def body(state):
    ledger = current_ledger()  # expect: JG108
    ledger.add(bytes_read=4)  # expect: JG108
    cost = estimate_superstep_cost(8, 16)  # expect: JG108
    return state + cost["flops"]


fn = torch.cuda.make_graphed_callables(body, (torch.ones(1),))


def capture(state: torch.Tensor):
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        out = superstep(state)
    return g, out
