"""VertexProgram SPI on PyTorch — the port of
``janusgraph_tpu/olap/vertex_program.py``.

A superstep is

    aggregated[i] = combine({ transform(message(src), w_e) for e=(src, i) })
    state', metrics = apply(state, aggregated, superstep, memory)

with ``combine`` a segment-reduction monoid and per-vertex state a dict of
tensors. Programs are written against torch directly (the reference passes
an ``xp`` array module; here every hook takes tensors on the executor's
device). Global aggregators flow as ``metrics`` return values
``{name: (op, scalar tensor)}``; the executor fetches them at the barrier
and hands the previous superstep's values back in as ``memory_in``.

Typed edge views (``EdgeChannel``) pick the edges a superstep aggregates
over (``VertexProgram.channel_for``); per-column transforms
(``edge_transform_cols``) let one message column ride the edge weight while
another passes untransformed (the OLAP traversal's sack).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from functools import lru_cache
from types import MappingProxyType
from typing import Dict, Mapping, Optional, Tuple

import torch


class Combiner:
    """Message combination monoids (reference: MessageCombiner)."""

    SUM = "sum"
    MIN = "min"
    MAX = "max"

    IDENTITY = {"sum": 0.0, "min": float("inf"), "max": float("-inf")}


#: "unreached" / "no message" value of the MIN-combined programs; the
#: frontier engine's reached-ness tests compare against this same constant,
#: so it must stay identical to the reference's
INF = 1e18


class EdgeTransform:
    """How an edge modifies the message it carries."""

    NONE = "none"
    MUL_WEIGHT = "mul"   # msg * w  (e.g. weighted pagerank)
    ADD_WEIGHT = "add"   # msg + w  (e.g. shortest path)


def check_weighted_transforms(program, csr) -> None:
    """Executors call this at run() entry: a program declaring weight
    transforms (a scalar ``edge_transform`` or per-column
    ``edge_transform_cols``) over a weightless CSR would otherwise silently
    compute as if no transform existed (every executor skips transforms
    when weights are absent)."""
    cols = getattr(program, "edge_transform_cols", None)
    wants_weights = bool(cols and any(t != EdgeTransform.NONE for t in cols)) or getattr(
        program, "edge_transform", EdgeTransform.NONE
    ) != EdgeTransform.NONE
    if wants_weights and csr.in_edge_weight is None and csr.out_edge_weight is None:
        raise ValueError(
            f"{type(program).__name__} declares weight-dependent edge "
            "transforms but the CSR snapshot carries no edge weights"
        )


@lru_cache(maxsize=64)
def _col_masks(cols: Tuple[str, ...], device, dtype) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-column {0,1} MUL and ADD masks of ``cols`` on ``device``: moved
    once, so a superstep's transform copies nothing from the host."""
    mul = [1.0 if t == EdgeTransform.MUL_WEIGHT else 0.0 for t in cols]
    add = [1.0 if t == EdgeTransform.ADD_WEIGHT else 0.0 for t in cols]
    return (
        torch.tensor(mul, dtype=dtype, device=device),
        torch.tensor(add, dtype=dtype, device=device),
    )


def apply_edge_transform(msgs: torch.Tensor, w, transform: str, cols=None) -> torch.Tensor:
    """Apply a program's in-flight edge transform. ``msgs``: (..., k) or
    (...) per-edge messages; ``w``: per-edge weights broadcastable to
    ``msgs`` minus its column axis (None = pass through).

    With ``cols`` (``program.edge_transform_cols``) the messages are
    k-column, the last axis the column axis in every layout, and column j
    rides its own transform: ``where(mul_j, msgs * w, msgs) + w * add_j``.
    The where-select, not ``msgs * (1 + (w - 1) * mul_j)``: the algebraic
    form absorbs |w - 1| below float32 eps and mis-scales tiny weights."""
    if w is None:
        return msgs
    if cols is not None:
        k = msgs.shape[-1]
        if len(cols) != k:
            raise ValueError(f"edge_transform_cols has {len(cols)} entries for {k}-column messages")
        mul, add = _col_masks(tuple(cols), msgs.device, msgs.dtype)
        wb = w[..., None]
        return torch.where(mul > 0, msgs * wb, msgs) + wb * add
    if transform == EdgeTransform.MUL_WEIGHT:
        return msgs * (w[..., None] if msgs.ndim > w.ndim else w)
    if transform == EdgeTransform.ADD_WEIGHT:
        return msgs + (w[..., None] if msgs.ndim > w.ndim else w)
    return msgs


@dataclass(frozen=True)
class EdgeChannel:
    """A typed edge view for one message round (the reference's TinkerPop
    MessageScope.Local carrying a per-step traversal like
    ``__.out('knows')``).

    direction: traverser movement along the edge —
        "out"  src -> dst  (aggregate at dst over in-edges; the default)
        "in"   dst -> src  (aggregate at src over out-edges)
        "both" both orientations
    labels: edge type ids to include (None = all); needs the CSR's per-edge
        type arrays (``in_edge_type``/``out_edge_type``).
    """

    direction: str = "out"
    labels: Optional[Tuple[int, ...]] = None


@dataclass
class Memory:
    """Host-side view of the global aggregators, updated at each superstep
    barrier from the reduced metrics (reference: FulgoraMemory.java:45)."""

    values: Dict[str, float] = field(default_factory=dict)
    superstep: int = 0

    def get(self, key: str, default: float = 0.0) -> float:
        return self.values.get(key, default)

    def reduce_in(self, metrics: Dict[str, Tuple[str, float]]) -> None:
        for k, (_op, v) in metrics.items():
            self.values[k] = float(v)
        self.superstep += 1


class VertexProgram:
    """Array-BSP vertex program on torch tensors.

    Class attributes:
      compute_keys    — state entries the run returns
      combiner        — Combiner monoid (or override combiner_for per phase)
      edge_transform  — EdgeTransform applied to messages in flight
      edge_transform_cols — per-column EdgeTransforms for (n, k) messages
                        (overrides edge_transform; SUM only)
      edge_channels   — named EdgeChannels; ``channel_for`` picks one per
                        superstep
      undirected      — aggregate over both edge orientations
      max_iterations  — hard superstep cap
      frontier_kind   — "sssp" or "cc" where the frontier engine can run
                        the program; read from the program's own class
                        only, so a subclass (which may override message or
                        apply) runs dense unless it declares it again
    """

    compute_keys: Tuple[str, ...] = ()
    combiner: str = Combiner.SUM
    edge_transform: str = EdgeTransform.NONE
    edge_transform_cols: Optional[Tuple[str, ...]] = None
    undirected: bool = False
    max_iterations: int = 100
    frontier_kind = None
    #: immutable default: a program with channels shadows it with its own
    #: dict, so no declaration leaks across classes
    edge_channels: Mapping[str, EdgeChannel] = MappingProxyType({})

    def combiner_for(self, superstep: int) -> str:
        """Monoid for a given superstep — overridable for phase-alternating
        programs (e.g. peer pressure's count-then-resolve phases)."""
        return self.combiner

    def channel_for(self, superstep: int) -> Optional[str]:
        """The name of the edge channel a superstep aggregates over; None
        is the program's default view (the in-CSR, or both orientations
        when ``undirected``)."""
        return None

    def setup(self, graph) -> Tuple[Dict[str, torch.Tensor], Dict[str, Tuple[str, object]]]:
        """Return (initial state, initial metrics)."""
        raise NotImplementedError

    def message(self, state: Dict[str, torch.Tensor], superstep: int, graph) -> torch.Tensor:
        """Per-vertex outgoing message tensor (n,) or (n, k)."""
        raise NotImplementedError

    def apply(
        self,
        state: Dict[str, torch.Tensor],
        aggregated: torch.Tensor,
        superstep: int,
        memory_in: Dict[str, torch.Tensor],
        graph,
    ) -> Tuple[Dict[str, torch.Tensor], Dict[str, Tuple[str, torch.Tensor]]]:
        """Fold aggregated messages into new state; emit metrics."""
        raise NotImplementedError

    def terminate(self, memory: Memory) -> bool:
        raise NotImplementedError

    def terminate_device(self, values: Dict[str, torch.Tensor], steps_done) -> torch.Tensor:
        """Termination predicate on device scalars, read by the fused loop
        (``steps_done`` is a device step counter there, so the predicate must
        stay elementwise: no ``bool()``, no ``and``). Default: never stop
        early."""
        return torch.tensor(False)

    #: parameters consumed only by setup() (the initial state), not by the
    #: superstep: left out of cache_key, so a new seed reuses the captured
    #: fused loop
    setup_only_params: Tuple[str, ...] = ()

    # graphlint: host -- a hash of the program's static parameters: host data whenever it runs
    def cache_key(self) -> Tuple:
        """Identity of the program's superstep: its class and the scalar
        parameters the superstep reads."""
        return (
            type(self).__module__,
            type(self).__qualname__,
            tuple(sorted(
                (k, v) for k, v in self.__dict__.items()
                if isinstance(v, (int, float, bool, str, tuple))
                and k not in self.setup_only_params
            )),
        )

    def fused_eligible(self) -> bool:
        """Whether run() may fuse the iteration on the device: a constant
        combiner monoid, a constant edge channel and an overridden
        terminate_device (the default never stops early, which would change
        the meaning of a program that relies on the host's terminate())."""
        return (
            type(self).combiner_for is VertexProgram.combiner_for
            and type(self).channel_for is VertexProgram.channel_for
            and type(self).terminate_device is not VertexProgram.terminate_device
        )
