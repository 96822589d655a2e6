"""The capture region: clean by itself (parse-only)."""
import torch

from .helpers import scale_rows
from .view import View


class Loop:
    def __init__(self, program, n, deg):
        self.program = program
        self.view = View(deg)
        self.state = torch.zeros(n, device="cuda")
        self.steps = torch.zeros((), dtype=torch.int64, device="cuda")

    def step(self):
        program, s = self.program, self.steps
        out = program.message(self.state, s)
        width = self.view.degree
        self.state.copy_(scale_rows(out, s) / width)
        s.add_(1)

    def capture(self):
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            self.step()
        return graph
