"""The device mesh of the sharded executor — the port's counterpart of the
reference's ``jax.sharding.Mesh`` plus its ``shard_map`` shim
(``janusgraph_tpu/parallel/compat.py``).

A ``Mesh`` is a 1-D axis of S slots, each a ``torch.device``; a device may
repeat, so ``Mesh([torch.device("cuda", 0)] * 8)`` places 8 shards on one
card and ``Mesh([torch.device("cpu")] * 8)`` is the tests' counterpart of
the reference's 8 virtual host devices. The default mesh is one slot per
visible CUDA card, and raises where there is none.

Every per-shard array of the executor is padded to one shape (SPMD), so
the slots that share a device keep their arrays stacked on a leading axis:
one launch serves them all. Consecutive slots on one device form a
*group*; the executor runs its superstep body once per group and meets the
other groups only in the collectives below, which take one tensor per
group (leading axis = the group's slots) and return one per group:

  * ``all_to_all``  [Sg, S, ...] -> [Sh, S, ...]: out[s][q] = in[q][s],
    the bucket transpose of ``lax.all_to_all(split_axis=0, concat_axis=0)``
  * ``ppermute``    [Sg, ...] rolled one slot along the axis (slot s
    receives slot s - 1's block), the ring's ``lax.ppermute``
  * ``all_gather``  [Sg, ...] -> [S, ...] on every group
  * ``reduce``      [Sg] partials -> one scalar per group (``psum``,
    ``pmin``, ``pmax``)

Within one group a collective is a transpose, a roll or a reduction along
the stacked axis. Across groups it moves each block with an explicit
``Tensor.to(device)`` copy. That case has run only on the CPU (a mesh of
``torch.device("cpu")`` and ``torch.device("cpu", 0)`` slots, which torch
counts as two devices); no machine with more than one card has run it.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence, Tuple

import torch


@dataclass(frozen=True)
class MeshGroup:
    """A run of consecutive slots [lo, hi) on one device."""

    device: torch.device
    lo: int
    hi: int

    @property
    def size(self) -> int:
        return self.hi - self.lo


def _normalize(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"mesh slot {dev} requested but CUDA is not available")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def default_devices() -> List[torch.device]:
    """One slot per visible CUDA card; raises without one (pass a mesh of
    ``torch.device("cpu")`` slots to run on the CPU)."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available for the default mesh; pass "
            "mesh=Mesh([torch.device('cpu')] * S) to run on the CPU"
        )
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


class Mesh:
    """A 1-D mesh of S device slots along ``axis``."""

    def __init__(self, devices: Sequence = None, axis: str = "p"):
        devs = [_normalize(d) for d in (default_devices() if devices is None else devices)]
        if not devs:
            raise ValueError("a mesh needs at least one slot")
        self.devices: Tuple[torch.device, ...] = tuple(devs)
        self.axis = axis
        self.size = len(devs)
        groups: List[MeshGroup] = []
        for i, d in enumerate(devs):
            if groups and groups[-1].device == d:
                groups[-1] = MeshGroup(d, groups[-1].lo, i + 1)
            else:
                groups.append(MeshGroup(d, i, i + 1))
        self.groups: Tuple[MeshGroup, ...] = tuple(groups)

    @property
    def home(self) -> torch.device:
        """Slot 0's device: where host-visible scalars are gathered."""
        return self.devices[0]

    @property
    def kind(self) -> str:
        """The slots' device kind (the card's name, or "cpu")."""
        dev = self.home
        return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"

    def __repr__(self) -> str:
        return f"Mesh({list(map(str, self.devices))}, axis={self.axis!r})"

    # ------------------------------------------------------------ collectives
    def all_to_all(self, parts: List[torch.Tensor]) -> List[torch.Tensor]:
        """[Sg, S, ...] per group -> [Sh, S, ...] per group with
        out[s][q] = in[q][s]."""
        if len(self.groups) == 1:
            return [parts[0].transpose(0, 1)]
        out = []
        for h in self.groups:
            cols = [p[:, h.lo:h.hi].to(h.device) for p in parts]
            out.append(torch.cat(cols, dim=0).transpose(0, 1))
        return out

    def ppermute(self, parts: List[torch.Tensor]) -> List[torch.Tensor]:
        """Roll the stacked slot blocks one slot along the axis."""
        if len(self.groups) == 1:
            return [torch.roll(parts[0], 1, 0)]
        out = []
        for i, g in enumerate(self.groups):
            prev = parts[i - 1][-1:].to(g.device)
            out.append(torch.cat([prev, parts[i][:-1]], dim=0))
        return out

    def all_gather(self, parts: List[torch.Tensor]) -> List[torch.Tensor]:
        """[Sg, ...] per group -> the whole [S, ...] stack on each group."""
        if len(self.groups) == 1:
            return [parts[0]]
        return [torch.cat([p.to(g.device) for p in parts], dim=0) for g in self.groups]

    def reduce(self, op: str, parts: List[torch.Tensor]) -> List[torch.Tensor]:
        """[Sg] per-slot partials -> the mesh-wide sum/min/max ("sum",
        "min", "max"), one scalar per group: the psum/pmin/pmax barrier."""
        stacked = (
            parts[0] if len(self.groups) == 1
            else torch.cat([p.to(self.home) for p in parts])
        )
        if op == "sum":
            total = torch.sum(stacked)
        elif op == "min":
            total = torch.amin(stacked)
        else:
            total = torch.amax(stacked)
        if len(self.groups) == 1:
            return [total]
        return [total.to(g.device) for g in self.groups]


def lockstep(mesh: Mesh, bodies: list) -> list:
    """Run one generator per group in lockstep: each yields a collective
    request ``(name, payload)`` (or ``("reduce", op, payload)``), receives
    its group's share of the result and finally returns its value. Every
    group asks for the same collectives in the same order, as the
    reference's shard_map bodies do."""
    requests = [next(b) for b in bodies]
    while True:
        head = requests[0]
        if head[0] == "reduce":
            results = mesh.reduce(head[1], [r[2] for r in requests])
        else:
            results = getattr(mesh, head[0])([r[1] for r in requests])
        done, nxt = [], []
        for b, res in zip(bodies, results):
            try:
                nxt.append(b.send(res))
            except StopIteration as stop:
                done.append(stop.value)
        if done:
            if len(done) != len(bodies):
                raise RuntimeError("the groups of a mesh left the superstep at different points")
            return done
        requests = nxt
