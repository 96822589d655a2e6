"""node2vec-style embedding update as a dense-feature vertex program — the
port of ``janusgraph_tpu/olap/programs/embedding.py``.

Each superstep is one embedding sweep: gather the neighbours' rows
(uniform, walk-weighted or dot-attention scored), mean-normalize into a
positive pull, and push away from the mean of a negative-sampling table
(pre-reduced on the host into one (d_pad,) constant)::

    emb' = (1 - decay) * emb + lr * (pos_mean - neg_mean)

Every op that feeds the state is elementwise or rides the fixed-tree
kernels, so the update has the reference's bits on both packed layouts.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from janusgraph_tpu_torch.olap.features.dense_program import DenseVertexProgram, MessageMode
from janusgraph_tpu_torch.olap.features.kernels import pad_features
from janusgraph_tpu_torch.olap.kernels import fp_fence
from janusgraph_tpu_torch.olap.vertex_program import Combiner


class EmbeddingUpdateProgram(DenseVertexProgram):
    """Iterative embedding refinement (node2vec/DeepWalk-shaped).

    State: ``emb``, the (n, d_pad) embedding block. ``mode`` picks the
    gather: "copy" (uniform neighbours), "weighted" (the CSR's weight
    column) or "sddmm" (similarity-scored neighbours). ``neg_table`` is the
    (K, feature_dim) negative-sample side input, seeded when omitted."""

    feature_keys = ("emb",)
    array_params = ("_neg_pad",)

    def __init__(
        self,
        feature_dim: int = 16,
        lr: float = 0.05,
        decay: float = 0.01,
        negatives: int = 8,
        seed: int = 11,
        max_iterations: int = 5,
        tol: float = 0.0,
        mode: str = MessageMode.COPY,
        neg_table: Optional[np.ndarray] = None,
        dim_tier: int = 0,
        native_matmul: bool = False,
    ):
        self.message_mode = mode
        super().__init__(feature_dim, dim_tier=dim_tier, native_matmul=native_matmul)
        self.lr = float(lr)
        self.decay = float(decay)
        self.negatives = int(negatives)
        self.seed = int(seed)
        self.max_iterations = int(max_iterations)
        self.tol = float(tol)
        if neg_table is None:
            rng = np.random.default_rng(self.seed)
            neg_table = rng.standard_normal((self.negatives, self.feature_dim)) * 0.1
        neg_table = np.asarray(neg_table, dtype=np.float32)
        if neg_table.shape[1] != self.feature_dim:
            raise ValueError(
                f"neg_table width {neg_table.shape[1]} != feature_dim {self.feature_dim}"
            )
        self._neg_table = neg_table
        # a constant of the run: pre-reduced on the host (f64 mean, f32
        # result), the reference's bits
        self._neg_mean = np.mean(neg_table.astype(np.float64), axis=0).astype(np.float32)

    @property
    def _neg_pad(self) -> np.ndarray:
        return pad_features(self._neg_mean[None, :], self.d_pad)[0]

    def setup(self, graph):
        n = graph.num_vertices
        rng = np.random.default_rng(self.seed + 1)
        emb = (rng.standard_normal((n, self.feature_dim)) / np.sqrt(self.feature_dim)).astype(
            np.float32
        )
        emb = pad_features(emb, self.d_pad)
        # zero rows for a padded domain (see GCNForwardProgram.setup)
        local = graph.local_num_vertices
        if local > n:
            emb = np.vstack([emb, np.zeros((local - n, emb.shape[1]), emb.dtype)])
        return {"emb": torch.as_tensor(emb, device=graph.device)}, {
            "delta": (Combiner.SUM, float("inf")),
        }

    def message(self, state, superstep, graph):
        return state["emb"]

    def apply(self, state, aggregated, superstep, memory_in, graph):
        emb = state["emb"]
        indeg = graph.in_degree.to(emb.dtype)
        pos = aggregated / torch.clamp_min(indeg, 1.0)[:, None]
        neg = self.device_array("_neg_pad", emb.device)
        # both products fenced, so the final add rounds as the reference's
        # separately-rounded mul + add
        keep = fp_fence((1.0 - self.decay) * emb)
        push = fp_fence(self.lr * (pos - neg[None, :]))
        emb2 = keep + push
        # convergence metric only (not in the bitwise contract); tol=0.0
        # never triggers it
        delta = torch.sum(torch.abs(emb2 - emb))
        return {"emb": emb2}, {"delta": (Combiner.SUM, delta)}

    def terminate(self, memory):
        return memory.superstep >= 1 and memory.get("delta", 1.0) < self.tol

    def terminate_device(self, values, steps_done):
        return torch.logical_and(torch.as_tensor(steps_done >= 1), values["delta"] < self.tol)
