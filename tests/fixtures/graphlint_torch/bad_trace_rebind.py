"""JG104 fixture: a tensor the captured body reads, rebound after the capture
(the replay keeps reading the old storage). Translates
tests/fixtures/graphlint/bad_trace_donate.py (a donated buffer reused): the
port's counterpart of a dead buffer is a stale one.

Never imported — parsed by graphlint only (tests/test_torch_graphlint.py).
"""
import torch


class Loop:
    def __init__(self, n):
        self.state = torch.zeros(n, device="cuda")
        self.steps = torch.zeros((), dtype=torch.int64, device="cuda")
        self.scale = 2.0  # a host float: rebinding it is no hazard
        self.graph = None

    def step(self):
        self.state.mul_(self.scale)
        self.steps.add_(1)

    def capture(self):
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            self.step()
        return self.graph

    def reset(self, start):
        self.state = start.clone()  # expect: JG104
        self.scale = 3.0

    def reload(self, start):
        # in place: the captured storage takes the new values
        self.state.copy_(start)
        self.steps.fill_(0)
