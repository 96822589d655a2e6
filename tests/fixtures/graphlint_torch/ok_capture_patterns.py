"""Known non-findings: capture idioms the port uses that no capture rule
may flag (parse-only). The power-of-two capture ladder (a cache fill
keyed by its loop variable), a branch on the host capture guard, an
attribute counter bumped under the guard, and a captured body that reads
only ``.shape`` and ``.dtype``."""
import torch


def launch(data):
    out = data * 2.0
    if torch.cuda.is_current_stream_capturing():
        # recorded into a graph: counted apart from eager launches
        launch.captured += 1
    else:
        launch.launches += 1
    return out


launch.launches = 0
launch.captured = 0


class Loop:
    def __init__(self, n):
        self.state = torch.zeros(n, device="cuda")
        self.steps = torch.zeros((), dtype=torch.int64, device="cuda")
        self.graphs = {}
        self.pool = torch.cuda.graph_pool_handle()

    def step(self):
        s = self.steps
        if self.state.shape[0] > 1 and self.state.dtype == torch.float32:
            new = launch(self.state)
        else:
            new = self.state
        self.state.copy_(torch.where(s < 4, new, self.state))
        s.add_(1)

    def load(self, start):
        self.state.copy_(start)
        self.steps.fill_(0)

    def chunk(self, length, top):
        if length not in self.graphs:
            size = 1
            while size <= max(top, length):
                if size not in self.graphs:
                    self.graphs[size] = self._capture(size)
                size *= 2
        self.graphs[length].replay()

    def _capture(self, length):
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=self.pool):
            mode = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode("error")
            try:
                for _ in range(length):
                    self.step()
            finally:
                torch.cuda.set_sync_debug_mode(mode)
        return graph


def shapes_only(x: torch.Tensor):
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        if x.shape[0] > 8 and x.dtype == torch.float32:
            y = x[: x.shape[0] // 2]
        else:
            y = x
        z = torch.zeros(x.shape, dtype=x.dtype, device=x.device)
    return g, y, z
