"""The port's multi-host glue (``janusgraph_tpu_torch/parallel/
multihost.py``) in one process, held to the reference's: the no-op init,
a group whose peer never comes (it raises within its timeout and the
flight recorder says so), the partition ranges, the global mesh, the
mesh's groups keyed by process and device, the fused loop's refusal to
capture a mesh over processes, and a sharded run over a mesh of 8 CPU
slots against the reference's CPU oracle — the twins of
``tests/test_multihost.py``. The two-process runs are in
``tests/test_torch_multihost_2proc.py``."""

import socket
import time

import numpy as np
import pytest
import torch

from janusgraph_tpu.olap.cpu_executor import CPUExecutor
from janusgraph_tpu.olap.generators import rmat_csr as ref_rmat_csr
from janusgraph_tpu.olap.programs import PageRankProgram as RefPageRankProgram
from janusgraph_tpu.parallel import multihost as ref_multihost
from janusgraph_tpu_torch.core.config import GraphConfiguration
from janusgraph_tpu_torch.olap.generators import rmat_csr
from janusgraph_tpu_torch.observability import flight_recorder
from janusgraph_tpu_torch.olap.programs import PageRankProgram
from janusgraph_tpu_torch.parallel import Mesh, ShardedExecutor, compat
from janusgraph_tpu_torch.parallel.multihost import (
    global_mesh,
    host_partition_range,
    init_multihost,
    process_count,
)
from janusgraph_tpu_torch.parallel.sharded import captures_chunks


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


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_multiprocess_with_coordinator_names_the_transport_item(monkeypatch):
    """Several processes with a coordinator form the gloo group, so a
    process whose peer never comes raises within the group's timeout
    instead of hanging, from its arguments and from the environment alike;
    the flight recorder holds the reference's init and init_failed
    events, and no group is left behind."""
    monkeypatch.delenv("JAX_NUM_PROCESSES", raising=False)
    monkeypatch.delenv("JAX_PROCESS_ID", raising=False)
    seq0 = flight_recorder.last_seq
    t0 = time.monotonic()
    with pytest.raises(Exception):
        init_multihost(f"127.0.0.1:{_free_port()}", num_processes=2, process_id=0, timeout_s=2)
    monkeypatch.setenv("JAX_COORDINATOR_ADDRESS", f"127.0.0.1:{_free_port()}")
    monkeypatch.setenv("JAX_NUM_PROCESSES", "2")
    monkeypatch.setenv("JAX_PROCESS_ID", "1")
    with pytest.raises(Exception):
        init_multihost(timeout_s=2)
    assert time.monotonic() - t0 < 60
    events = [e for e in flight_recorder.events("multihost") if e["seq"] > seq0]
    assert [(e["action"], e["processes"], e["process_id"]) for e in events] == [
        ("init", 2, 0), ("init_failed", 2, 0), ("init", 2, 1), ("init_failed", 2, 1),
    ]
    assert all(e["error"] for e in events if e["action"] == "init_failed")
    assert process_count() == 1


def test_partition_ranges_cover_exactly():
    for nproc in (1, 3, 8):
        covered = []
        for pid in range(nproc):
            lo, hi = host_partition_range(32, pid, nproc)
            assert (lo, hi) == ref_multihost.host_partition_range(32, pid, nproc)
            covered.extend(range(lo, hi))
        assert covered == list(range(32))
    assert host_partition_range(32) == (0, 32)


def test_open_graph_with_processes_needs_a_coordinator_as_the_reference(monkeypatch):
    """``cluster.num-processes`` above 1 is honoured: the open forms the
    group, so without a coordinator address both packages' opens raise
    the same ValueError."""
    from janusgraph_tpu.core.graph import open_graph as ref_open_graph
    from janusgraph_tpu_torch.core.graph import open_graph

    for var in ("JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES", "JAX_PROCESS_ID"):
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(ValueError, match="coordinator address"):
        ref_open_graph({"cluster.num-processes": 2})
    with pytest.raises(ValueError, match="coordinator address"):
        open_graph({"cluster.num-processes": 2, "computer.executor": "cpu"})
    assert process_count() == 1


def test_mesh_groups_are_keyed_by_process_and_device(monkeypatch):
    """Equal devices of two processes are two groups; this process runs
    only its own, and its first slot is its home. One process keeps the
    groups it always had."""
    one = Mesh([torch.device("cpu")] * 4 + [torch.device("cpu", 0)] * 2)
    assert [(g.lo, g.hi, g.process) for g in one.groups] == [(0, 4, 0), (4, 6, 0)]
    assert one.local_groups == one.groups and not one.spans_processes
    assert one.home == torch.device("cpu") and one.processes == 1
    monkeypatch.setattr(compat, "_group_rank", lambda: (1, 2))
    mesh = Mesh([torch.device("cpu")] * 4, processes=[0, 0, 1, 1])
    assert [(g.lo, g.hi, g.process) for g in mesh.groups] == [(0, 2, 0), (2, 4, 1)]
    assert [(g.lo, g.hi) for g in mesh.local_groups] == [(2, 4)]
    assert mesh.spans_processes and mesh.process_id == 1 and mesh.local_lo == 2
    assert not mesh.staged_through_host
    with pytest.raises(ValueError, match="as many slots"):
        Mesh([torch.device("cpu")] * 3, processes=[0, 0, 1])
    with pytest.raises(ValueError, match="in order"):
        Mesh([torch.device("cpu")] * 4, processes=[0, 1, 0, 1])


def test_fused_loop_never_captures_a_mesh_over_processes(monkeypatch):
    """The fused loop captures chunks into CUDA graphs only on one card of
    one process: a mesh over two processes runs them eagerly, since its
    exchanges go through the host."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    card = torch.device("cuda", 0)
    assert captures_chunks(Mesh([card] * 8))
    assert not captures_chunks(Mesh([torch.device("cpu")] * 8))
    assert not captures_chunks(Mesh([card] * 4 + [torch.device("cuda", 1)] * 4))
    monkeypatch.setattr(compat, "_group_rank", lambda: (0, 2))
    spans = Mesh([card] * 8, processes=[0] * 4 + [1] * 4)
    assert len(spans.local_groups) == 1 and spans.home.type == "cuda"
    assert spans.staged_through_host and not captures_chunks(spans)


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
