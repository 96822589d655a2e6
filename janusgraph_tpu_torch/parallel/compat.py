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
one launch serves them all. Consecutive slots on one device of one
process form a *group*; the executor runs its superstep body once per
group of its own process (the mesh's ``local_groups``) and meets the other
groups only in the collectives below, which take one tensor per local
group (leading axis = the group's slots) and return one per local group:

  * ``all_to_all``  [Sg, S, ...] -> [Sh, S, ...]: out[s][q] = in[q][s],
    the bucket transpose of ``lax.all_to_all(split_axis=0, concat_axis=0)``
  * ``ppermute``    [Sg, ...] rolled one slot along the axis (slot s
    receives slot s - 1's block), the ring's ``lax.ppermute``
  * ``all_gather``  [Sg, ...] -> [S, ...] on every group
  * ``reduce``      [Sg] partials -> one scalar per group (``psum``,
    ``pmin``, ``pmax``)

Within one group a collective is a transpose, a roll or a reduction along
the stacked axis. Across groups of one process it moves each block with an
explicit ``Tensor.to(device)`` copy. That case has run only on the CPU (a
mesh of ``torch.device("cpu")`` and ``torch.device("cpu", 0)`` slots,
which torch counts as two devices).

A mesh may span processes (``parallel/multihost.global_mesh``): every
process holds the same slot list, process by process, with the same number
of slots each, so slot k lives on process k // (S / processes). The blocks
that cross a process go over the ``torch.distributed`` group that
``multihost.init_multihost`` formed, whose backend is gloo: CPU tensors
only, so a CUDA block is copied into pinned host memory first and back to
its device after (``staged_through_host``). ``reduce`` gathers all S
partials in slot order onto the local home and folds them there with the
single-process mesh's one op, so a run over two processes gives the bits
of the run over one. ``transport`` counts the bytes this process sent to
other processes and the seconds its collectives took, staging included.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import List, Sequence, Tuple

import torch


@dataclass(frozen=True)
class MeshGroup:
    """A run of consecutive slots [lo, hi) on one device of one process."""

    device: torch.device
    lo: int
    hi: int
    process: int = 0

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


def _group_rank() -> Tuple[int, int]:
    """(rank, world size) of the initialized process group, else (0, 1)."""
    from janusgraph_tpu_torch.parallel.multihost import process_count, process_index

    return process_index(), process_count()


class Mesh:
    """A 1-D mesh of S device slots along ``axis``. ``processes`` gives
    each slot's process (default: every slot is this process's); a slot of
    another process is only named here, never touched."""

    def __init__(self, devices: Sequence = None, axis: str = "p", processes: Sequence = None):
        devices = list(default_devices() if devices is None else devices)
        if not devices:
            raise ValueError("a mesh needs at least one slot")
        if processes is None:
            procs = [0] * len(devices)
            rank, world = 0, 1
        else:
            procs = [int(p) for p in processes]
            if len(procs) != len(devices):
                raise ValueError(f"{len(devices)} slots but {len(procs)} process ids")
            rank, world = _group_rank()
            if max(procs) + 1 != world or procs != sorted(procs):
                raise ValueError(
                    f"a mesh over processes {sorted(set(procs))} needs them in order and "
                    f"an initialized group of that size (this one: {world})"
                )
            counts = [procs.count(p) for p in range(world)]
            if len(set(counts)) != 1:
                raise ValueError(f"every process must hold as many slots: {counts}")
        devs = [
            _normalize(d) if p == rank else torch.device(d) for d, p in zip(devices, procs)
        ]
        self.devices: Tuple[torch.device, ...] = tuple(devs)
        self.axis = axis
        self.size = len(devs)
        #: the process of each slot, the group's rank of this one and the
        #: number of processes the mesh spans
        self.process_of: Tuple[int, ...] = tuple(procs)
        self.process_id = rank
        self.processes = max(procs) + 1
        self.local_size = procs.count(rank)
        self.local_lo = procs.index(rank)
        groups: List[MeshGroup] = []
        for i, (d, p) in enumerate(zip(devs, procs)):
            if groups and (groups[-1].device, groups[-1].process) == (d, p):
                groups[-1] = MeshGroup(d, groups[-1].lo, i + 1, p)
            else:
                groups.append(MeshGroup(d, i, i + 1, p))
        self.groups: Tuple[MeshGroup, ...] = tuple(groups)
        #: the groups whose bodies this process runs
        self.local_groups: Tuple[MeshGroup, ...] = tuple(g for g in groups if g.process == rank)
        #: bytes this process sent to others, seconds in those collectives
        #: (staging included) and their count
        self.transport = {"bytes": 0, "seconds": 0.0, "calls": 0}

    @property
    def home(self) -> torch.device:
        """This process's first slot's device (slot 0's on one process):
        where host-visible scalars are gathered."""
        return self.local_groups[0].device

    @property
    def spans_processes(self) -> bool:
        return self.processes > 1

    @property
    def staged_through_host(self) -> bool:
        """Whether blocks that cross a process are copied through host
        memory (CUDA slots over gloo)."""
        return self.spans_processes and any(g.device.type == "cuda" for g in self.local_groups)

    @property
    def kind(self) -> str:
        """The slots' device kind (the card's name, or "cpu")."""
        dev = self.home
        return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"

    def __repr__(self) -> str:
        procs = f", processes={self.processes}" if self.spans_processes else ""
        return f"Mesh({list(map(str, self.devices))}, axis={self.axis!r}{procs})"

    # ------------------------------------------------------ process transport
    def _to_host(self, t: torch.Tensor) -> torch.Tensor:
        if t.device.type == "cuda":
            buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            buf.copy_(t)
            return buf
        return t.contiguous()

    def _empty(self, shape, dtype) -> torch.Tensor:
        return torch.empty(shape, dtype=dtype, pin_memory=self.staged_through_host)

    def _local_block(self, parts: List[torch.Tensor]) -> torch.Tensor:
        """The local groups' blocks stacked in slot order, on the host."""
        host = [self._to_host(p) for p in parts]
        return host[0] if len(host) == 1 else torch.cat(host, 0)

    def _scatter_local(self, block: torch.Tensor) -> List[torch.Tensor]:
        """Split a host [local slots, ...] block back over the local
        groups' devices."""
        base = self.local_lo
        return [
            block[g.lo - base : g.hi - base].to(g.device, non_blocking=True)
            for g in self.local_groups
        ]

    def _count(self, t0: float, sent: int) -> None:
        self.transport["seconds"] += time.perf_counter() - t0
        self.transport["bytes"] += int(sent)
        self.transport["calls"] += 1

    def _gather_procs(self, block: torch.Tensor) -> torch.Tensor:
        """Every process's equal-shaped block, concatenated in process
        (so slot) order."""
        import torch.distributed as dist

        out = self._empty((self.processes * block.shape[0],) + tuple(block.shape[1:]), block.dtype)
        dist.all_gather(list(out.chunk(self.processes)), block)
        return out

    def gather_rows(self, parts: List[torch.Tensor]) -> torch.Tensor:
        """The local groups' row blocks of every process, concatenated in
        slot order on the host: the whole [S * rows, ...] array on every
        process (the reference's ``process_allgather(tiled=True)``)."""
        if not self.spans_processes:
            return torch.cat([p.to("cpu", copy=True) for p in parts])
        t0 = time.perf_counter()
        block = self._local_block(parts)
        out = self._gather_procs(block)
        self._count(t0, block.numel() * block.element_size() * (self.processes - 1))
        return out

    # ------------------------------------------------------------ collectives
    def all_to_all(self, parts: List[torch.Tensor]) -> List[torch.Tensor]:
        """[Sg, S, ...] per group -> [Sh, S, ...] per group with
        out[s][q] = in[q][s]."""
        if self.spans_processes:
            return self._all_to_all_procs(parts)
        if len(self.groups) == 1:
            return [parts[0].transpose(0, 1)]
        out = []
        for h in self.groups:
            cols = [p[:, h.lo:h.hi].to(h.device) for p in parts]
            out.append(torch.cat(cols, dim=0).transpose(0, 1))
        return out

    def _all_to_all_procs(self, parts):
        import torch.distributed as dist

        t0 = time.perf_counter()
        P, L = self.processes, self.local_size
        x = self._local_block(parts)
        tail = tuple(x.shape[2:])
        # [P (destination process), L (source slot), L (destination slot), ...]
        send = x.reshape((L, P, L) + tail).transpose(0, 1).contiguous()
        recv = self._empty(send.shape, send.dtype)
        dist.all_to_all_single(recv, send)
        # recv[p][q][s]: source slot q of process p to local slot s
        out = self._empty((L, P * L) + tail, recv.dtype)
        out.copy_(recv.reshape((P * L, L) + tail).transpose(0, 1))
        self._count(t0, send.numel() * send.element_size() * (P - 1) // P)
        return self._scatter_local(out)

    def ppermute(self, parts: List[torch.Tensor]) -> List[torch.Tensor]:
        """Roll the stacked slot blocks one slot along the axis."""
        if self.spans_processes:
            return self._ppermute_procs(parts)
        if len(self.groups) == 1:
            return [torch.roll(parts[0], 1, 0)]
        out = []
        for i, g in enumerate(self.groups):
            prev = parts[i - 1][-1:].to(g.device)
            out.append(torch.cat([prev, parts[i][:-1]], dim=0))
        return out

    def _ppermute_procs(self, parts):
        import torch.distributed as dist

        t0 = time.perf_counter()
        P, rank = self.processes, self.process_id
        x = self._local_block(parts)
        last = x[-1:].contiguous()
        # the last slot's block goes to the next process only; the first
        # slot takes the previous process's last block
        nxt, prv = (rank + 1) % P, (rank - 1) % P
        recv = self._empty(last.shape, last.dtype)
        dist.all_to_all_single(
            recv, last,
            output_split_sizes=[1 if p == prv else 0 for p in range(P)],
            input_split_sizes=[1 if p == nxt else 0 for p in range(P)],
        )
        rolled = self._empty(x.shape, x.dtype)
        rolled[:1].copy_(recv)
        rolled[1:].copy_(x[:-1])
        self._count(t0, last.numel() * last.element_size())
        return self._scatter_local(rolled)

    def all_gather(self, parts: List[torch.Tensor]) -> List[torch.Tensor]:
        """[Sg, ...] per group -> the whole [S, ...] stack on each group."""
        if self.spans_processes:
            full = self.gather_rows(parts)
            return [full.to(g.device, non_blocking=True) for g in self.local_groups]
        if len(self.groups) == 1:
            return [parts[0]]
        return [torch.cat([p.to(g.device) for p in parts], dim=0) for g in self.groups]

    def reduce(self, op: str, parts: List[torch.Tensor]) -> List[torch.Tensor]:
        """[Sg] per-slot partials -> the mesh-wide sum/min/max ("sum",
        "min", "max"), one scalar per group: the psum/pmin/pmax barrier.
        Every partial of the mesh meets on the (local) home in slot order
        and folds in one op there, however many processes hold them."""
        groups = self.local_groups
        if self.spans_processes:
            stacked = self.gather_rows(parts).to(self.home)
        elif len(groups) == 1:
            stacked = parts[0]
        else:
            stacked = torch.cat([p.to(self.home) for p in parts])
        if op == "sum":
            total = torch.sum(stacked)
        elif op == "min":
            total = torch.amin(stacked)
        else:
            total = torch.amax(stacked)
        if len(groups) == 1:
            return [total]
        return [total.to(g.device) for g in groups]


def lockstep(mesh: Mesh, bodies: list) -> list:
    """Run one generator per local group in lockstep: each yields a
    collective request ``(name, payload)`` (or ``("reduce", op,
    payload)``), receives its group's share of the result and finally
    returns its value. Every group of every process asks for the same
    collectives in the same order, as the reference's shard_map bodies
    do."""
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
