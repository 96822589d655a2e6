"""Marker fixture: `# graphlint: traced` opts helpers into the capture
rules, `# graphlint: host` opts helpers out of capture propagation
(parse-only). Translates tests/fixtures/graphlint/bad_trace_marker.py."""
import numpy as np
import torch


# graphlint: traced
def marked_helper(msgs):
    pad = np.zeros(4)  # expect: JG102
    return torch.as_tensor(pad) + msgs


# graphlint: host -- builds static numpy constants on purpose
def host_constants(k):
    return np.arange(k)  # must NOT fire: host-marked, numpy is the point


def body(x):
    masks = host_constants(4)
    return x * torch.as_tensor(masks, device=x.device)


def capture(x: torch.Tensor):
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        y = body(x)
    return g, y
