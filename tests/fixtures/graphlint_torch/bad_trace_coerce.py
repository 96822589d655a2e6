"""JG101 fixture: Python coercion of / branching on tensors under a CUDA-graph
capture. Translates tests/fixtures/graphlint/bad_trace_coerce.py.

Never imported — parsed by graphlint only (tests/test_torch_graphlint.py).
"""
import torch


def coerces(x, y):
    a = float(x)  # expect: JG101
    b = int(x + y)  # expect: JG101
    c = bool(y)  # expect: JG101
    return a + b + c


def branches(x, flag):
    if x > 0:  # expect: JG101
        return x
    while flag:  # expect: JG101
        x = x - 1
    assert x >= 0  # expect: JG101
    return x


def clean(x, w):
    # none of these may fire: static attrs and methods, is-checks
    if x.ndim == 3:
        x = x.sum(dim=-1)
    if w is not None:
        x = x * w
    if x.device.type == "cuda" and x.dim() == 1 and len(x) > 1:
        x = x + 1
    return torch.where(x > 0, x, 0.0)


def step(state, k):
    y = state * k
    if y.sum() > 0:  # expect: JG101
        return y
    return -y


graphed = torch.cuda.make_graphed_callables(
    (coerces, branches, clean), ((torch.ones(1), torch.ones(1)),) * 3
)


def run(x: torch.Tensor):
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        y = step(x, 2.0)
    return g, y
