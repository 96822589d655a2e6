"""JG105 fixture: host syncs inside a CUDA-graph capture.
Translates tests/fixtures/graphlint/bad_trace_hostsync.py.

Never imported — parsed by graphlint only (tests/test_torch_graphlint.py).
"""
import torch


def syncs(x, y, ev):
    a = x.item()  # expect: JG105
    b = y.tolist()  # expect: JG105
    c = x.cpu()  # expect: JG105
    d = y.numpy()  # expect: JG105
    e = x.to("cpu")  # expect: JG105
    torch.cuda.synchronize()  # expect: JG105
    ev.synchronize()  # expect: JG105
    return a, b, c, d, e


def host(x):
    # host-side sync is fine: must NOT fire
    return x.item()


def capture(x: torch.Tensor, y: torch.Tensor, ev):
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        out = syncs(x, y, ev)
    return g, out, host(x)
