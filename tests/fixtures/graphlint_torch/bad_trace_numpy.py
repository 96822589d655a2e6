"""JG102 fixture: numpy calls inside a CUDA-graph capture (parse-only).
Translates tests/fixtures/graphlint/bad_trace_numpy.py."""
import numpy as np
import torch


def uses_numpy(x):
    y = np.asarray(x)  # expect: JG102
    z = np.concatenate([y, y])  # expect: JG102
    return torch.as_tensor(z)


def host_side(x):
    # numpy on host (not a capture context): must NOT fire
    return np.asarray(x).sum()


def kernel_body(a, b):
    return a + np.float32(b)  # expect: JG102


_fn = torch.cuda.make_graphed_callables(kernel_body, (torch.ones(1), torch.ones(1)))


def capture(x: torch.Tensor):
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        y = uses_numpy(x)
    return g, y, host_side(x)
