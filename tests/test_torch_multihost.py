"""The single-process half of the port's multi-host glue
(``janusgraph_tpu_torch/parallel/multihost.py``), held to the reference's:
the no-op init, the refusal of a run of several processes (ROADMAP Queue
A #4b), the partition ranges, the global mesh and a sharded run over a
mesh of 8 CPU slots against the reference's CPU oracle — the twins of
``tests/test_multihost.py``. The reference's two-process test has no twin
yet: its transport is #4b."""

import numpy as np
import pytest
import torch

from janusgraph_tpu.olap.cpu_executor import CPUExecutor
from janusgraph_tpu.olap.generators import rmat_csr as ref_rmat_csr
from janusgraph_tpu.olap.programs import PageRankProgram as RefPageRankProgram
from janusgraph_tpu.parallel import multihost as ref_multihost
from janusgraph_tpu_torch.core.config import GraphConfiguration
from janusgraph_tpu_torch.olap.generators import rmat_csr
from janusgraph_tpu_torch.olap.programs import PageRankProgram
from janusgraph_tpu_torch.parallel import Mesh, ShardedExecutor
from janusgraph_tpu_torch.parallel.multihost import (
    global_mesh,
    host_partition_range,
    init_multihost,
)


def test_single_process_init_is_noop(monkeypatch):
    for var in ("JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES", "JAX_PROCESS_ID"):
        monkeypatch.delenv(var, raising=False)
    assert init_multihost() == 0
    assert init_multihost(num_processes=1, process_id=0) == 0
    assert init_multihost(config=GraphConfiguration({"cluster.num-processes": 1})) == 0


def test_multiprocess_without_coordinator_raises(monkeypatch):
    monkeypatch.delenv("JAX_COORDINATOR_ADDRESS", raising=False)
    with pytest.raises(ValueError):
        init_multihost(num_processes=4, process_id=1)
    with pytest.raises(ValueError):
        ref_multihost.init_multihost(num_processes=4, process_id=1)


def test_multiprocess_with_coordinator_names_the_transport_item(monkeypatch):
    """Several processes with a coordinator: the transport between them is
    ROADMAP Queue A #4b, and the refusal says so (the option refuses too)."""
    monkeypatch.delenv("JAX_NUM_PROCESSES", raising=False)
    with pytest.raises(NotImplementedError, match="Queue A #4b"):
        init_multihost("localhost:1234", num_processes=2, process_id=0)
    monkeypatch.setenv("JAX_COORDINATOR_ADDRESS", "localhost:1234")
    monkeypatch.setenv("JAX_NUM_PROCESSES", "2")
    with pytest.raises(NotImplementedError, match="Queue A #4b"):
        init_multihost()


def test_partition_ranges_cover_exactly():
    for nproc in (1, 3, 8):
        covered = []
        for pid in range(nproc):
            lo, hi = host_partition_range(32, pid, nproc)
            assert (lo, hi) == ref_multihost.host_partition_range(32, pid, nproc)
            covered.extend(range(lo, hi))
        assert covered == list(range(32))
    assert host_partition_range(32) == (0, 32)


def test_sharded_executor_on_global_mesh(monkeypatch):
    """The global mesh is the local one: one slot per card (so it needs a
    card); a sharded run over 8 CPU slots meets the reference's oracle."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        global_mesh()
    mesh = Mesh([torch.device("cpu")] * 8)
    assert mesh.size == 8 and len(mesh.groups) == 1
    got = ShardedExecutor(rmat_csr(10, 8), mesh=mesh).run(PageRankProgram(max_iterations=6, tol=0.0))
    want = CPUExecutor(ref_rmat_csr(10, 8)).run(RefPageRankProgram(max_iterations=6, tol=0.0))
    np.testing.assert_allclose(got["rank"], want["rank"], rtol=1e-5, atol=1e-8)
