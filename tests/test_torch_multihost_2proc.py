"""Two processes over ``torch.distributed`` (gloo) form one sharded mesh —
the port's twins of ``tests/test_multihost_2proc.py``.

Each test starts two child processes on a free localhost port, with no
CUDA card visible and with ``jax`` and ``janusgraph_tpu`` blocked in
``sys.modules``, so a stray import of the reference fails the child. Every
child forms the group with a timeout of tens of seconds (a wedged peer
fails the test) and is killed if it outlives ``communicate``'s timeout.

  * the psum twin: 2 processes x 2 CPU slots = a 4-slot global mesh;
    ``init_multihost``'s rank, the slots in process order, the local
    groups, ``host_partition_range`` without explicit ids, and a 5-step
    power iteration whose ``all_gather`` and ``reduce("sum")`` cross the
    process boundary, against numpy at rtol 1e-5;
  * the production twin: the reference test's graph (120 vertices, 500
    random "link" edges, ``default_rng(42)``) written through the port
    into the port's storage server; each child loads its own partitions
    with the port's loader worker, meets its peer's split, merges both
    and runs ``ShardedExecutor`` over the global mesh: fused PageRank (8
    supersteps, tol 0) under exchange "a2a" and "blocked" (agg "ell"),
    CC and an unweighted 4-hop BFS. Both children's arrays are bitwise
    equal to each other and to the single-process run over a mesh of 4
    CPU slots on the same CSR; the parent holds the ranks to the
    reference's ``CPUExecutor`` over the reference's ``load_csr`` of the
    same store at the reference test's rtol 1e-4, atol 1e-6, and CC and
    BFS exactly;
  * ``cluster.*`` through ``open_graph``: the options form the group,
    and the environment wins over them;
  * the shard faults over the two processes: a shard preemption, a
    collective timeout and a dropped halo batch, each seeded alike in
    both processes, roll both back to the shard checkpoint that process 0
    alone wrote, and the resumed runs equal the uninterrupted one bit for
    bit, in both processes.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: seconds a child may take; each test's two children finish in ~5-15 s
CHILD_TIMEOUT_S = 120

_PRELUDE = r"""
import json, os, sys, time
sys.modules["jax"] = None
sys.modules["janusgraph_tpu"] = None
sys.path.insert(0, %(repo)r)
pid = int(sys.argv[1]); port = sys.argv[2]
"""


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _run_pair(tmp_path, name, body, extra_args=(), env_for=None):
    """Run ``body`` in two child processes (pid 0 and 1); their stdout,
    each child's return code checked."""
    script = tmp_path / f"{name}.py"
    script.write_text((_PRELUDE + body) % {"repo": _REPO})
    port = _free_port()
    base = {
        k: v for k, v in os.environ.items()
        if k not in ("PYTHONPATH", "JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES",
                     "JAX_PROCESS_ID")
    }
    # one compute thread a child: the runs are tiny, and the suite's other
    # workers share the cores
    base.update(PYTHONPATH=_REPO, CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1")
    procs = []
    try:
        for pid in (0, 1):
            env = dict(base, **(env_for(pid, port) if env_for else {}))
            procs.append(subprocess.Popen(
                [sys.executable, str(script), str(pid), str(port), *map(str, extra_args)],
                env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            ))
        outs = []
        for p in procs:
            out, err = p.communicate(timeout=CHILD_TIMEOUT_S)
            outs.append((p.returncode, out.decode(), err.decode()))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rc, out, err in outs:
        assert rc == 0, f"child failed rc={rc}\nstdout:{out}\nstderr:{err[-4000:]}"
    return [out for _rc, out, _err in outs]


def _result(out: str) -> dict:
    return json.loads([ln for ln in out.splitlines() if ln.startswith("{")][-1])


_PSUM = r"""
import numpy as np
import torch
from janusgraph_tpu_torch.parallel.multihost import (
    global_mesh, host_partition_range, init_multihost, shutdown_multihost,
)

got = init_multihost(coordinator_address=f"127.0.0.1:{port}", num_processes=2,
                     process_id=pid, timeout_s=60)
assert got == pid
assert init_multihost() == pid  # a second call: the rank, no new group
mesh = global_mesh(devices=[torch.device("cpu")] * 2)
assert mesh.size == 4 and mesh.process_of == (0, 0, 1, 1), mesh
assert [(g.lo, g.hi, g.process) for g in mesh.local_groups] == [(2 * pid, 2 * pid + 2, pid)]
assert host_partition_range(8) == ((0, 4) if pid == 0 else (4, 8))

# PageRank-style power iteration: A column-sharded, one x block a slot;
# the partial mat-vecs meet in an all_gather across the processes and the
# partial masses in a psum
n = 16
rng = np.random.default_rng(0)
A = (rng.random((n, n)) < 0.3).astype(np.float32)
A = A / np.maximum(A.sum(axis=0, keepdims=True), 1.0)
x0 = np.full((n,), 1.0 / n, dtype=np.float32)
blk = n // mesh.size
lo = 2 * pid
cols = torch.as_tensor(A.reshape(n, mesh.size, blk).transpose(1, 0, 2)[lo:lo + 2])
x = torch.as_tensor(x0)
for _ in range(5):
    xb = x.reshape(mesh.size, blk)[lo:lo + 2]
    partial = torch.einsum("snb,sb->sn", cols, xb)
    full = mesh.all_gather([partial])[0].sum(0)
    mass = mesh.reduce("sum", [xb.sum(1)])[0]
    x = full
expect = x0.copy()
for _ in range(5):
    mass_want = float(expect.sum())
    expect = A @ expect
np.testing.assert_allclose(x.numpy(), expect, rtol=1e-5)
np.testing.assert_allclose(float(mass), mass_want, rtol=1e-5)
assert mesh.transport["calls"] == 10 and mesh.transport["bytes"] > 0
print(json.dumps({"pid": pid, "sum": float(x.sum())}), flush=True)
shutdown_multihost()
"""


def test_two_process_distributed_mesh(tmp_path):
    outs = _run_pair(tmp_path, "psum", _PSUM)
    res = [_result(o) for o in outs]
    assert [r["pid"] for r in res] == [0, 1]
    assert res[0]["sum"] == res[1]["sum"]


_PROD = r"""
store_port = int(sys.argv[3]); tmpdir = sys.argv[4]
import numpy as np
import torch
from janusgraph_tpu_torch.parallel.multihost import (
    global_mesh, host_partition_range, init_multihost, shutdown_multihost,
)

init_multihost(coordinator_address=f"127.0.0.1:{port}", num_processes=2, process_id=pid,
               timeout_s=60)
mesh = global_mesh(devices=[torch.device("cpu")] * 2)
assert mesh.size == 4

# 1. this host scans only its own partitions of the shared store, through
# the loader worker's entry
from janusgraph_tpu_torch.olap.distributed_load import _worker_main

cfg = {"storage.backend": "remote", "storage.hostname": "127.0.0.1", "storage.port": store_port}
lo, hi = host_partition_range(32)
mine = os.path.join(tmpdir, f"part{pid}.npz")
assert _worker_main(["--config", json.dumps(cfg),
                     "--partitions", ",".join(str(p) for p in range(lo, hi)),
                     "--out", mine]) == 0
open(mine + ".done", "w").close()

# 2. meet the peer's split, then merge: every host builds the same CSR
other = os.path.join(tmpdir, f"part{1 - pid}.npz")
deadline = time.monotonic() + 60
while not os.path.exists(other + ".done"):
    if time.monotonic() > deadline:
        raise RuntimeError("the peer's split never arrived")
    time.sleep(0.05)
from janusgraph_tpu_torch.core.ids import IDManager
from janusgraph_tpu_torch.olap.csr import build_csr_from_raw

raws = []
for path in sorted([mine, other]):
    with np.load(path) as z:
        raws.append({
            "vertex_id_list": z["vertex_id_list"], "vertex_labels": z["vertex_labels"],
            "src": z["src"], "dst": z["dst"],
            "etype": z["etype"] if bool(z["has_etype"][0]) else None,
            "weights": None, "raw_props": {},
        })
csr = build_csr_from_raw(IDManager(partition_bits=5), raws)

# 3. the production executor over the two-process mesh, and the same runs
# over one process's mesh of 4 CPU slots
from janusgraph_tpu_torch.olap.programs import (
    ConnectedComponentsProgram, PageRankProgram, ShortestPathProgram,
)
from janusgraph_tpu_torch.parallel import Mesh, ShardedExecutor

seed = int(np.argmax(csr.out_degree))
one = Mesh([torch.device("cpu")] * 4)
out, infos = {}, {}
for exchange in ("a2a", "blocked"):
    ex = ShardedExecutor(csr, mesh=mesh, exchange=exchange, agg="ell")
    ref = ShardedExecutor(csr, mesh=one, exchange=exchange, agg="ell")
    runs = {
        "rank": (PageRankProgram(max_iterations=8, tol=0.0), {"fused": True}),
        "component": (ConnectedComponentsProgram(), {}),
        "distance": (ShortestPathProgram(seed_index=seed, max_iterations=4), {}),
    }
    for key, (program, kw) in runs.items():
        got = ex.run(program, **kw)[key]
        info = ex.last_run_info
        if key == "rank":
            pagerank_record = info
        want = ref.run(program, **kw)[key]
        assert got.tobytes() == want.tobytes(), (exchange, key)
        out[f"{exchange}_{key}"] = got
        infos[f"{exchange}_{key}"] = {
            k: info.get(k) for k in ("path", "fused_mode", "processes", "process_id",
                                     "transport", "transport_bytes", "staged_through_host")
        }
        infos[f"{exchange}_{key}"]["records_with_transport"] = sum(
            "transport_bytes" in r for r in info["superstep_records"])
# the timeline names each shard lane's process
from janusgraph_tpu_torch.observability.timeline import timeline_events

lanes = [e["args"]["name"] for e in timeline_events(pagerank_record)
         if e.get("name") == "thread_name" and e["args"]["name"].startswith("shard")]
assert lanes == [f"shard {s} (process {s // 2})" for s in range(4)], lanes
np.savez(os.path.join(tmpdir, f"out{pid}.npz"), vertex_ids=csr.vertex_ids, **out)
print(json.dumps({"pid": pid, "n": csr.num_vertices, "m": csr.num_edges, "seed": seed,
                  "runs": infos}), flush=True)
shutdown_multihost()
"""


def test_two_process_production_sharded_executor(tmp_path):
    from janusgraph_tpu.core.graph import open_graph as ref_open_graph
    from janusgraph_tpu.olap.cpu_executor import CPUExecutor
    from janusgraph_tpu.olap.csr import load_csr as ref_load_csr
    from janusgraph_tpu.olap.programs import (
        ConnectedComponentsProgram,
        PageRankProgram,
        ShortestPathProgram,
    )
    from janusgraph_tpu_torch.core.graph import open_graph
    from janusgraph_tpu_torch.storage.inmemory import InMemoryStoreManager
    from janusgraph_tpu_torch.storage.remote import RemoteStoreServer

    server = RemoteStoreServer(InMemoryStoreManager()).start()
    try:
        host, store_port = server.address
        cfg = {"storage.backend": "remote", "storage.hostname": host, "storage.port": store_port}
        g = open_graph(dict(cfg, **{"computer.executor": "cpu"}))
        rng = np.random.default_rng(42)
        tx = g.new_transaction()
        vs = [tx.add_vertex() for _ in range(120)]
        for _ in range(500):
            a, b = rng.integers(0, len(vs), 2)
            if a != b:
                tx.add_edge(vs[a], "link", vs[b])
        tx.commit()
        g.close()

        outs = _run_pair(tmp_path, "prod", _PROD, extra_args=(store_port, tmp_path))
        ref_graph = ref_open_graph(cfg)
        try:
            ref_csr = ref_load_csr(ref_graph)
        finally:
            ref_graph.close()
    finally:
        server.stop()

    res = [_result(o) for o in outs]
    assert res[0]["runs"] == {k: dict(v, process_id=0) for k, v in res[1]["runs"].items()}
    for key, info in res[0]["runs"].items():
        assert info["processes"] == 2 and info["transport"] == "gloo", (key, info)
        assert not info["staged_through_host"] and info["transport_bytes"] > 0
        assert info["records_with_transport"] > 0
    assert res[0]["runs"]["a2a_rank"]["path"] == "fused"
    assert res[0]["runs"]["a2a_rank"]["fused_mode"] == "eager"
    assert res[0]["runs"]["a2a_distance"]["path"] == "frontier"
    arrs = [dict(np.load(tmp_path / f"out{pid}.npz")) for pid in (0, 1)]
    assert arrs[0].keys() == arrs[1].keys()
    for key in arrs[0]:
        assert arrs[0][key].tobytes() == arrs[1][key].tobytes(), key

    # the reference's oracle over the reference's scan of the same store
    got = arrs[0]
    assert np.array_equal(got["vertex_ids"], ref_csr.vertex_ids)
    assert (res[0]["n"], res[0]["m"]) == (ref_csr.num_vertices, ref_csr.num_edges)
    cpu = CPUExecutor(ref_csr)
    want_rank = cpu.run(PageRankProgram(max_iterations=8, tol=0.0))["rank"]
    want_cc = cpu.run(ConnectedComponentsProgram())["component"]
    want_bfs = cpu.run(ShortestPathProgram(seed_index=res[0]["seed"], max_iterations=4))["distance"]
    for exchange in ("a2a", "blocked"):
        np.testing.assert_allclose(
            got[f"{exchange}_rank"].astype(np.float64), want_rank, rtol=1e-4, atol=1e-6)
        assert np.array_equal(got[f"{exchange}_component"], np.asarray(want_cc))
        # the reference's CPU oracle holds distances in float64, the port's
        # runs in float32 (INF included)
        assert np.array_equal(got[f"{exchange}_distance"], np.asarray(want_bfs, np.float32))


_CLUSTER = r"""
import torch
from janusgraph_tpu_torch.core.graph import open_graph
from janusgraph_tpu_torch.parallel.multihost import (
    process_count, process_index, shutdown_multihost,
)

options = json.loads(sys.argv[3])
g = open_graph(dict(options, **{"computer.executor": "cpu", "cluster.process-id": int(
    options["cluster.process-id"][pid])}))
try:
    assert process_count() == 2 and process_index() == pid, (process_count(), process_index())
    # the group carries a collective between the two opens
    t = torch.tensor([pid + 1.0])
    torch.distributed.all_reduce(t)
    assert float(t) == 3.0
finally:
    g.close()
print(json.dumps({"pid": pid, "rank": process_index(), "world": process_count()}), flush=True)
shutdown_multihost()
"""


def test_cluster_options_form_the_group_through_open_graph(tmp_path):
    """``cluster.num-processes``, ``-process-id`` and
    ``-coordinator-address`` of two in-memory graphs form one group."""
    port = _free_port()
    options = {"cluster.num-processes": 2, "cluster.process-id": [0, 1],
               "cluster.coordinator-address": f"127.0.0.1:{port}"}
    outs = _run_pair(tmp_path, "cluster", _CLUSTER, extra_args=(json.dumps(options),))
    assert [_result(o) for o in outs] == [{"pid": p, "rank": p, "world": 2} for p in (0, 1)]


def test_the_environment_wins_over_the_cluster_options(tmp_path):
    """The options name the wrong coordinator and swapped process ids;
    ``JAX_COORDINATOR_ADDRESS`` and ``JAX_PROCESS_ID`` win, as in the
    reference's ``init_multihost``."""
    wrong = _free_port()
    options = {"cluster.num-processes": 2, "cluster.process-id": [1, 0],
               "cluster.coordinator-address": f"127.0.0.1:{wrong}"}

    def env_for(pid, port):
        return {"JAX_COORDINATOR_ADDRESS": f"127.0.0.1:{port}", "JAX_PROCESS_ID": str(pid)}

    outs = _run_pair(tmp_path, "cluster_env", _CLUSTER, extra_args=(json.dumps(options),),
                     env_for=env_for)
    assert [_result(o) for o in outs] == [{"pid": p, "rank": p, "world": 2} for p in (0, 1)]


_FAULTS = r"""
ck_root = sys.argv[3]
import numpy as np
import torch
from janusgraph_tpu_torch.olap.generators import rmat_csr
from janusgraph_tpu_torch.olap.programs import PageRankProgram
from janusgraph_tpu_torch.parallel import ShardedExecutor
from janusgraph_tpu_torch.parallel.multihost import (
    global_mesh, init_multihost, shutdown_multihost,
)
from janusgraph_tpu_torch.storage.faults import FaultPlan

init_multihost(f"127.0.0.1:{port}", num_processes=2, process_id=pid, timeout_s=60)
csr = rmat_csr(8, 8, seed=3)
ex = ShardedExecutor(csr, mesh=global_mesh(devices=[torch.device("cpu")] * 2), exchange="blocked")
for fused in (True, False):
    clean = ex.run(PageRankProgram(max_iterations=10, tol=0.0), fused=fused)["rank"]
    kinds = {
        "shard_preempt": {"shard_preempt_superstep": 4},
        "collective": {"collective_timeout_at": 3},
        "halo_drop": {"halo_drop_at": 2},
    }
    out = {}
    for kind, kw in kinds.items():
        plan = FaultPlan(seed=7, **kw)
        got = ex.run(PageRankProgram(max_iterations=10, tol=0.0), fused=fused,
                     checkpoint_every=2,
                     shard_checkpoint_dir=os.path.join(ck_root, f"{kind}_{fused}"),
                     fault_hook=plan.sharded_hook)["rank"]
        info = ex.last_run_info
        assert [e["kind"] for e in plan.journal] == [kind], plan.journal
        assert info["resumes"] == 1 and info["checkpoint"]["format"] == "sharded", info
        assert got.tobytes() == clean.tobytes(), (kind, fused)
        out[kind] = [e.get("shard", e.get("step")) for e in plan.journal]
    print(json.dumps({"pid": pid, "fused": fused, "faults": out}), flush=True)
shutdown_multihost()
"""


def test_two_process_shard_faults_resume_bitwise(tmp_path):
    ck_root = tmp_path / "ck"
    ck_root.mkdir()
    outs = _run_pair(tmp_path, "faults", _FAULTS, extra_args=(ck_root,))
    per = [[json.loads(ln) for ln in o.splitlines() if ln.startswith("{")] for o in outs]
    assert [len(p) for p in per] == [2, 2]
    for a, b in zip(*per):
        assert a["faults"] == b["faults"] and (a["pid"], b["pid"]) == (0, 1)
    # one writer: every manifest directory holds process 0's files only
    assert sorted(p.name for p in ck_root.iterdir()) == sorted(
        f"{k}_{f}" for k in ("shard_preempt", "collective", "halo_drop") for f in (True, False))
