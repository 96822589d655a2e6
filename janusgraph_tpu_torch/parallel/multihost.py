"""Multi-host execution: the single-process half — the port of
``janusgraph_tpu/parallel/multihost.py``.

The reference scales OLAP past one machine through JAX's multi-controller
runtime: every host runs the same program over one global mesh. The port's
single-process mesh (``parallel/compat.Mesh``) is the whole of this slice;
the transport between processes over ``torch.distributed`` (gloo on the
CPU, NCCL between cards) is ROADMAP.md Queue A #4b. So:

  1. ``init_multihost()`` resolves the process count and id from its
     arguments, the environment (``JAX_COORDINATOR_ADDRESS``,
     ``JAX_NUM_PROCESSES``, ``JAX_PROCESS_ID``, the reference's names) or
     the graph's ``cluster.*`` options, in that order of precedence for the
     environment over the options. One process is a no-op returning 0;
     more than one raises without a coordinator address, and with one
     raises naming Queue A #4b.
  2. ``global_mesh()`` is the local mesh (one slot per visible card).
  3. ``host_partition_range()`` / ``host_shard_range()`` — which storage
     partitions and mesh shards a host owns (contiguous blocks, the
     remainder on the leading hosts), the same split the reference uses.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

_MULTI_PROCESS = "ROADMAP.md Queue A #4b (the multi-process transport)"


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


def init_multihost(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    config=None,
) -> int:
    """The process id of this host in the run. With one process (or no
    configuration at all) a no-op returning 0, so library code can call it
    unconditionally."""
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
    from janusgraph_tpu_torch.observability import flight_recorder

    flight_recorder.record(
        "multihost", action="init_failed",
        processes=num_processes, process_id=process_id,
        error=f"a run of {num_processes} processes is not ported yet",
    )
    raise NotImplementedError(
        f"a run of {num_processes} processes is not ported yet: {_MULTI_PROCESS}"
    )


def global_mesh(axis: str = "p"):
    """The mesh over every device of the run: with one process, the local
    mesh (one slot per visible card)."""
    from janusgraph_tpu_torch.parallel.compat import Mesh

    return Mesh(None, axis)


def host_partition_range(
    num_partitions: int,
    process_id: Optional[int] = None,
    num_processes: Optional[int] = None,
) -> Tuple[int, int]:
    """[lo, hi) storage-partition ids this host loads (contiguous blocks,
    remainder spread over the leading hosts). The defaults are the
    single-process run's: process 0 of 1."""
    if process_id is None:
        process_id = 0
    if num_processes is None:
        num_processes = 1
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
