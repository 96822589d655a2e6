"""L-layer GCN forward pass as a dense-feature vertex program — the port of
``janusgraph_tpu/olap/programs/gcn.py``.

Each superstep is one layer: gather the neighbours' feature rows (plus the
vertex's own), mean-normalize by in-degree, then ``act(norm @ W_l + b_l)``.
``attention=True`` gathers in the sddmm mode (per-edge dot-attention
coefficients ``<h_src, h_dst>`` in the same pass). Weights are seeded from
numpy as in the reference (or passed in), embedded into (d_pad, d_pad)
blocks with zero padding and stacked; the superstep picks layer l by the
step counter, on the device in the fused loop, with no host sync.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from janusgraph_tpu_torch.olap.features.dense_program import DenseVertexProgram, MessageMode
from janusgraph_tpu_torch.olap.features.kernels import (
    matmul_flops,
    pad_features,
    pick_feature_tier,
    sddmm_flops,
)
from janusgraph_tpu_torch.olap.vertex_program import Combiner


def layer_of(stack: torch.Tensor, superstep) -> torch.Tensor:
    """``stack[superstep]`` for a Python int or a device step counter,
    without reading the counter on the host. The index is clamped to the
    last layer: a predicated superstep past the run's end computes a
    layer it then discards, and must not index out of bounds."""
    step = torch.as_tensor(superstep, device=stack.device).reshape(1)
    return torch.index_select(stack, 0, torch.clamp(step, 0, stack.shape[0] - 1))[0]


class GCNForwardProgram(DenseVertexProgram):
    """Forward pass of an L-layer GCN (default 2) over the snapshot.

    State: ``h``, the (n, d_pad) feature block after the layers run so far.
    ``terminate`` stops after ``num_layers`` supersteps; the device
    predicate mirrors it, so the fused path applies."""

    feature_keys = ("h",)
    array_params = ("_w_stack", "_b_stack")

    def __init__(
        self,
        feature_dim: int = 16,
        hidden_dim: int = 16,
        out_dim: int = 16,
        num_layers: int = 2,
        seed: int = 7,
        activation: str = "relu",
        attention: bool = False,
        weighted: bool = False,
        weights: Optional[Sequence[np.ndarray]] = None,
        dim_tier: int = 0,
        native_matmul: bool = False,
    ):
        if attention and weighted:
            raise ValueError("attention and weighted are mutually exclusive")
        if attention:
            self.message_mode = MessageMode.SDDMM
        elif weighted:
            self.message_mode = MessageMode.WEIGHTED
        super().__init__(feature_dim, dim_tier=dim_tier, native_matmul=native_matmul)
        self.hidden_dim = int(hidden_dim)
        self.out_dim = int(out_dim)
        self.num_layers = int(num_layers)
        if self.num_layers < 1:
            raise ValueError("num_layers must be >= 1")
        self.seed = int(seed)
        self.activation = activation
        self.max_iterations = self.num_layers
        self._dims = [self.feature_dim] + [self.hidden_dim] * (self.num_layers - 1) + [self.out_dim]
        self._max_dim = max(self._dims)
        self.d_pad = pick_feature_tier(self._max_dim, self.dim_tier)
        self._build_weights(weights)

    def _build_weights(self, weights) -> None:
        """Stack per-layer (d_pad, d_pad)/(d_pad,) weight/bias blocks: real
        coefficients in the top-left (d_l, d_{l+1}) corner, zeros in the
        padding so padded feature columns stay zero through the layers."""
        dp = self.d_pad
        rng = np.random.default_rng(self.seed)
        w_stack = np.zeros((self.num_layers, dp, dp), dtype=np.float32)
        b_stack = np.zeros((self.num_layers, dp), dtype=np.float32)
        for layer in range(self.num_layers):
            d_in, d_out = self._dims[layer], self._dims[layer + 1]
            if weights is not None:
                w = np.asarray(weights[layer], dtype=np.float32)
                if w.shape != (d_in, d_out):
                    raise ValueError(f"layer {layer} weights {w.shape} != ({d_in}, {d_out})")
            else:
                w = (rng.standard_normal((d_in, d_out)) / np.sqrt(d_in)).astype(np.float32)
            w_stack[layer, :d_in, :d_out] = w
            b_stack[layer, :d_out] = (rng.standard_normal(d_out) * 0.01).astype(np.float32)
        self._w_stack = w_stack
        self._b_stack = b_stack
        self._device_arrays = {}

    def setup(self, graph):
        n = graph.num_vertices
        rng = np.random.default_rng(self.seed + 1)
        x = rng.standard_normal((n, self.feature_dim)).astype(np.float32)
        h = pad_features(x, self.d_pad)
        # rows past the real vertices (a delta view's padded domain) are
        # zero, drawn after the real rows so the features match the
        # reference's whatever the padding
        local = graph.local_num_vertices
        if local > n:
            h = np.vstack([h, np.zeros((local - n, h.shape[1]), h.dtype)])
        return {"h": torch.as_tensor(h, device=graph.device)}, {
            "h_norm": (Combiner.SUM, float(np.abs(h).sum())),
        }

    def message(self, state, superstep, graph):
        return state["h"]

    def apply(self, state, aggregated, superstep, memory_in, graph):
        h = state["h"]
        indeg = graph.in_degree.to(h.dtype)
        # mean aggregation with a self loop: (sum_in + h) / (indeg + 1)
        norm = (aggregated + h) / (torch.clamp_min(indeg, 0.0) + 1.0)[:, None]
        w = layer_of(self.device_array("_w_stack", h.device), superstep)
        b = layer_of(self.device_array("_b_stack", h.device), superstep)
        h2 = self.dense_layer(norm, w, b, self.activation)
        return {"h": h2}, {"h_norm": (Combiner.SUM, torch.sum(torch.abs(h2)))}

    def terminate(self, memory):
        return memory.superstep >= self.num_layers

    def terminate_device(self, values, steps_done):
        return torch.as_tensor(steps_done >= self.num_layers)

    def matmul_flops(self, num_vertices: int, num_edges: int) -> float:
        flops = matmul_flops(num_vertices, self.d_pad, self.d_pad)
        if self.message_mode == MessageMode.SDDMM:
            flops += sddmm_flops(num_edges, self.d_pad)
        return flops
