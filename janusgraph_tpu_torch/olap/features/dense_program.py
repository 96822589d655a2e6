"""DenseVertexProgram — the ``[n, d]`` feature-block vertex-program contract,
the port of ``janusgraph_tpu/olap/features/dense_program.py``.

Extends ``VertexProgram`` with the dense tier's vocabulary:

  feature_keys    state entries that are (n, d_pad) feature blocks
  feature_dim     the logical feature width d
  d_pad           d padded to a power-of-two lane tier (``FEATURE_TIERS``);
                  padded columns are zero and stay zero
  message_mode    copy | weighted | sddmm (``MessageMode``)
  dense_layer()   the post-aggregate matmul + bias + activation
  matmul_flops()  the flops of one superstep's dense work

Combiners apply elementwise over the d columns; sddmm is SUM-only.
"""

from __future__ import annotations

import hashlib
from typing import Tuple

import numpy as np

from janusgraph_tpu_torch.olap.features.kernels import (
    dense_transform,
    matmul_flops,
    pad_features,
    pick_feature_tier,
    sddmm_flops,
)
from janusgraph_tpu_torch.olap.vertex_program import Combiner, EdgeTransform, VertexProgram


class MessageMode:
    """How an edge transforms the source's feature row in flight."""

    COPY = "copy"
    WEIGHTED = "weighted"
    SDDMM = "sddmm"

    ALL = (COPY, WEIGHTED, SDDMM)


class DenseVertexProgram(VertexProgram):
    """Base class of dense-feature programs. Subclasses set
    ``feature_keys``, pick a ``message_mode`` and implement
    setup/message/apply over (n, d_pad) blocks."""

    feature_keys: Tuple[str, ...] = ()
    message_mode: str = MessageMode.COPY
    combiner = Combiner.SUM
    #: numpy arrays the superstep reads (weights, side inputs): their
    #: contents are part of ``cache_key``, so two programs with equal
    #: scalars and different arrays never share a fused loop
    array_params: Tuple[str, ...] = ()

    def __init__(self, feature_dim: int, dim_tier: int = 0, native_matmul: bool = False):
        self.feature_dim = int(feature_dim)
        self.dim_tier = int(dim_tier or 0)
        self.native_matmul = bool(native_matmul)
        if self.message_mode not in MessageMode.ALL:
            raise ValueError(f"unknown message_mode {self.message_mode!r}")
        if self.message_mode == MessageMode.WEIGHTED:
            self.edge_transform = EdgeTransform.MUL_WEIGHT
        if self.message_mode == MessageMode.SDDMM and self.combiner != Combiner.SUM:
            raise ValueError("sddmm programs must use the SUM combiner")
        self.d_pad = pick_feature_tier(self.feature_dim, self.dim_tier)
        #: device -> the array parameters as tensors there
        self._device_arrays = {}

    def cache_key(self) -> Tuple:
        digest = hashlib.sha1()
        for name in self.array_params:
            a = np.ascontiguousarray(getattr(self, name))
            digest.update(f"{name}{a.dtype}{a.shape}".encode())
            digest.update(a.tobytes())
        return super().cache_key() + (digest.hexdigest(),)

    def device_array(self, name: str, device):
        """An array parameter as a tensor on ``device``, moved once (the
        first, eager superstep moves it, never a CUDA graph capture)."""
        import torch

        arrs = self._device_arrays.setdefault(str(device), {})
        if name not in arrs:
            arrs[name] = torch.as_tensor(getattr(self, name), device=device)
        return arrs[name]

    def pad_block(self, h: np.ndarray) -> np.ndarray:
        """Zero-pad an (n, feature_dim) host block to (n, d_pad)."""
        return pad_features(h, self.d_pad)

    def dense_layer(self, h, w, b=None, activation: str = "identity"):
        """The post-aggregate dense transform, honouring ``native_matmul``."""
        return dense_transform(h, w, b, activation, native=self.native_matmul)

    def matmul_flops(self, num_vertices: int, num_edges: int) -> float:
        """Flops of one superstep's dense work; the base counts the sddmm
        coefficient pass only."""
        if self.message_mode == MessageMode.SDDMM:
            return sddmm_flops(num_edges, self.d_pad)
        return 0.0

    @staticmethod
    def layer_flops(n: int, d_in: int, d_out: int) -> float:
        return matmul_flops(n, d_in, d_out)
