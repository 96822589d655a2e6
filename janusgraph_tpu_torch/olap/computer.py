"""``run_on`` — the port of ``janusgraph_tpu/olap/computer.py::run_on`` for
the single-device executor (the ``GraphComputer`` front end over storage is
not ported yet)."""

from __future__ import annotations

from typing import Dict

import numpy as np

from janusgraph_tpu_torch.olap.csr import CSRGraph
from janusgraph_tpu_torch.olap.gpu_executor import GPUExecutor
from janusgraph_tpu_torch.olap.vertex_program import VertexProgram


def run_on(
    csr: CSRGraph,
    program: VertexProgram,
    strategy: str = "segsum",
    device=None,
    frontier: str = "auto",
    sync_every: int = 1,
    checkpoint_every: int = 0,
    checkpoint_path: str = None,
    fault_hook=None,
    resume_attempts: int = 3,
    autotune: bool = None,
    hub_cutoff: int = None,
    tail_chunk: int = None,
    autotune_persist: bool = None,
    delta=None,
) -> Dict[str, np.ndarray]:
    """Run ``program`` over ``csr`` on ``device`` (the card by default) and
    return its final state as numpy arrays. ``frontier`` ("auto", "off",
    "always") routes BFS/SSSP/CC through the frontier engine;
    ``sync_every`` is how many supersteps the host loop runs between
    fetches of the aggregators; ``checkpoint_path``/``checkpoint_every``,
    ``fault_hook`` and ``resume_attempts`` checkpoint the run and resume it
    after a ``SuperstepPreempted``; ``delta`` (an ``OverlayView`` of
    ``csr``) runs over the base plus its pending writes; the other
    arguments are the ``GPUExecutor``'s tuner options. A dense program
    takes its lane tier and ``torch.matmul`` switch itself (``dim_tier=``,
    ``native_matmul=``)."""
    ex = GPUExecutor(
        csr, strategy=strategy, device=device, frontier=frontier,
        autotune=autotune, hub_cutoff=hub_cutoff, tail_chunk=tail_chunk,
        autotune_persist=autotune_persist, delta=delta,
    )
    return ex.run(
        program, sync_every=sync_every, checkpoint_every=checkpoint_every,
        checkpoint_path=checkpoint_path, fault_hook=fault_hook,
        resume_attempts=resume_attempts,
    )
