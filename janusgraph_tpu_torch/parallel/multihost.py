"""Multi-host execution — the port of ``janusgraph_tpu/parallel/multihost.py``.

The reference scales OLAP past one machine through JAX's multi-controller
runtime: every host runs the same program over one global mesh. The port
does the same over ``torch.distributed``: every process runs the same
program over one ``parallel/compat.Mesh`` whose slots span the processes,
and the mesh's collectives move the blocks that cross a process over the
group's gloo backend (CUDA blocks staged through pinned host memory). So:

  1. ``init_multihost()`` resolves the coordinator, the process count and
     the process id from its arguments, the environment
     (``JAX_COORDINATOR_ADDRESS``, ``JAX_NUM_PROCESSES``, ``JAX_PROCESS_ID``,
     the reference's names) or the graph's ``cluster.*`` options, in that
     order, and forms the group (``init_process_group("gloo")`` over
     ``tcp://<coordinator>``, with a finite timeout: a missing peer raises).
     One process is a no-op returning 0; an initialized process returns
     its rank. ``shutdown_multihost()`` destroys the group.
  2. ``global_mesh()`` — one mesh over every process's slots, process by
     process, so shard k lives on process k // local slots
     (``host_shard_range``'s assignment).
  3. ``host_partition_range()`` / ``host_shard_range()`` — which storage
     partitions and mesh shards a host owns (contiguous blocks, the
     remainder on the leading hosts), by default this process's of the
     group.

NCCL between cards is ROADMAP.md Queue A #4c: gloo carries every
collective here, also on one card shared by several processes (where
NCCL refuses two ranks).
"""

from __future__ import annotations

import datetime
import os
from typing import Optional, Sequence, Tuple

#: the reference's ``jax.distributed.initialize`` gives up after 300 s
DEFAULT_TIMEOUT_S = 300.0


def _resolve(coordinator_address, num_processes, process_id, config):
    cfg_addr = cfg_procs = cfg_pid = None
    if config is not None:
        cfg_addr = config.get("cluster.coordinator-address") or None
        cfg_procs = config.get("cluster.num-processes") or None
        cfg_pid = config.get("cluster.process-id")
    coordinator_address = (
        coordinator_address or os.environ.get("JAX_COORDINATOR_ADDRESS") or cfg_addr
    )
    if num_processes is None:
        env = os.environ.get("JAX_NUM_PROCESSES")
        num_processes = int(env) if env is not None else (cfg_procs or 1)
    if process_id is None:
        env = os.environ.get("JAX_PROCESS_ID")
        process_id = int(env) if env is not None else (cfg_pid or 0)
    return coordinator_address, int(num_processes), int(process_id)


def _initialized() -> bool:
    import torch.distributed as dist

    return dist.is_available() and dist.is_initialized()


def process_index() -> int:
    """This process's rank in the group (0 without one)."""
    import torch.distributed as dist

    return dist.get_rank() if _initialized() else 0


def process_count() -> int:
    """The group's size (1 without one)."""
    import torch.distributed as dist

    return dist.get_world_size() if _initialized() else 1


def init_multihost(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    config=None,
    timeout_s: float = DEFAULT_TIMEOUT_S,
) -> int:
    """Form the process group of a multi-process run; returns the process
    id. With one process (or no configuration at all) a no-op returning
    0, so library code can call it unconditionally; in a process whose
    group is formed, a no-op returning its rank."""
    if _initialized():
        return process_index()
    coordinator_address, num_processes, process_id = _resolve(
        coordinator_address, num_processes, process_id, config
    )
    if num_processes <= 1:
        return 0
    if not coordinator_address:
        raise ValueError(
            "multi-host run needs a coordinator address "
            "(JAX_COORDINATOR_ADDRESS or coordinator_address=)"
        )
    import torch.distributed as dist

    from janusgraph_tpu_torch.observability import flight_recorder

    # the black box carries the cluster-formation timeline: a wedged
    # coordinator (or a host missing) is the first question an incident
    # review asks
    flight_recorder.record(
        "multihost", action="init", processes=num_processes, process_id=process_id,
    )
    try:
        dist.init_process_group(
            "gloo", init_method=f"tcp://{coordinator_address}",
            world_size=num_processes, rank=process_id,
            timeout=datetime.timedelta(seconds=timeout_s),
        )
    except Exception as e:
        flight_recorder.record(
            "multihost", action="init_failed", processes=num_processes,
            process_id=process_id, error=f"{type(e).__name__}: {e}"[:200],
        )
        raise
    flight_recorder.record(
        "multihost", action="init_ok", processes=num_processes, process_id=process_id,
    )
    return process_id


def shutdown_multihost() -> None:
    """Destroy the process group (a no-op without one)."""
    import torch.distributed as dist

    if _initialized():
        dist.destroy_process_group()


def global_mesh(axis: str = "p", devices: Optional[Sequence] = None):
    """The mesh over every process's slots, process by process: this
    process contributes ``devices`` (default one slot per visible card),
    every process as many. Without a group, the local mesh."""
    from janusgraph_tpu_torch.parallel.compat import Mesh, _normalize, default_devices

    local = [_normalize(d) for d in (default_devices() if devices is None else devices)]
    if process_count() <= 1:
        return Mesh(local, axis)
    import torch.distributed as dist

    lists = [None] * process_count()
    dist.all_gather_object(lists, [str(d) for d in local])
    counts = [len(x) for x in lists]
    if len(set(counts)) != 1:
        raise ValueError(f"the processes hold unequal slot counts: {counts}")
    slots = [d for x in lists for d in x]
    procs = [p for p, x in enumerate(lists) for _ in x]
    return Mesh(slots, axis, processes=procs)


def host_partition_range(
    num_partitions: int,
    process_id: Optional[int] = None,
    num_processes: Optional[int] = None,
) -> Tuple[int, int]:
    """[lo, hi) storage-partition ids this host loads (contiguous blocks,
    remainder spread over the leading hosts); by default this process's
    of the group (process 0 of 1 without one)."""
    if process_id is None:
        process_id = process_index()
    if num_processes is None:
        num_processes = process_count()
    base, extra = divmod(num_partitions, num_processes)
    lo = process_id * base + min(process_id, extra)
    hi = lo + base + (1 if process_id < extra else 0)
    return lo, hi


def host_shard_range(
    num_shards: int,
    process_id: Optional[int] = None,
    num_processes: Optional[int] = None,
) -> Tuple[int, int]:
    """[lo, hi) mesh shards whose blocked-plan blocks this host builds
    (``halo.BlockedPlan.build_local``): the same contiguous assignment as
    ``host_partition_range``, so a host's loaded partitions are exactly the
    source-side edge sets of its shards."""
    return host_partition_range(num_shards, process_id, num_processes)
