"""JG103 fixture: recapture hazards (parse-only). Translates
tests/fixtures/graphlint/bad_trace_retrace.py: a per-call capture is the
port's retrace."""
import torch


def dropped(step, x):
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):  # expect: JG103
        step(x)
    g.replay()


def inline(step, x):
    with torch.cuda.graph(torch.cuda.CUDAGraph()):  # expect: JG103
        step(x)


class Cache:
    def __init__(self, step):
        self.step = step
        self.graphs = {}
        self.graph = None

    def _capture(self, length):
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(length):
                self.step()
        return graph

    def by_value(self, n_active):
        # one capture per distinct data-derived value
        self.graphs[n_active] = self._capture(n_active)  # expect: JG103

    def discard(self):
        self._capture(4)  # expect: JG103

    def per_item(self, lengths):
        for length in lengths:
            self.graph = self._capture(length)  # expect: JG103
            self.graph.replay()

    def graphed_per_item(self, fns, xs):
        out = []
        for f, x in zip(fns, xs):
            g = torch.cuda.make_graphed_callables(f, (x,))  # expect: JG103
            out.append(g(x))
        return out

    def fine(self, top):
        # the power-of-two ladder fills a cache keyed by its loop variable,
        # and a constant key: must NOT fire
        size = 1
        while size <= top:
            if size not in self.graphs:
                self.graphs[size] = self._capture(size)
            size *= 2
        self.graphs["warm"] = self._capture(1)
        self.graph = self._capture(top)
        return self.graph
