"""Distributed CSR loading in the port, after the reference's
``tests/test_distributed_load.py``.

N real loader processes scan disjoint partition sets of one local
directory, or of a storage server's store over the wire, and the parent
merges: the result equals the single-process
``load_csr`` of both packages on the same directory (vertex ids, labels
and the edge set; the merge keeps partition order, so the arrays too).
Cross-partition edges survive, a private backend is refused, the
partition count comes from the stored config, ``submit()`` with 3 workers
gives the 1-worker ranks on ``device="cpu"``, a failed or hung worker
raises with no fallback, rows the parent writes after a distributed
submit survive a reopen, and every process's replay stops at a torn WAL
tail. Exact equality throughout; the ranks are bitwise because the CSR
arrays are. Loads use tiny graphs, at most 3 workers and an explicit
timeout.
"""

import os

import numpy as np
import pytest

from janusgraph_tpu.core.graph import open_graph as ref_open_graph
from janusgraph_tpu.olap.csr import load_csr as ref_load_csr
from janusgraph_tpu_torch.core.bulk import bulk_add_edges, bulk_add_vertices
from janusgraph_tpu_torch.core.graph import open_graph
from janusgraph_tpu_torch.observability import registry
from janusgraph_tpu_torch.olap.csr import load_csr
from janusgraph_tpu_torch.olap.distributed_load import distributed_load_csr
from janusgraph_tpu_torch.olap.programs import PageRankProgram

TIMEOUT_S = 120.0
CSR_FIELDS = ("vertex_ids", "out_indptr", "out_dst", "in_indptr", "in_src", "labels",
              "in_edge_type", "out_edge_type")


def _seed(g, n=400, m=2500, seed=3):
    rng = np.random.default_rng(seed)
    vids = bulk_add_vertices(g, n, label="node")
    bulk_add_edges(g, "link", vids[rng.integers(0, n, m)], vids[rng.integers(0, n, m)])
    return vids


def _csr_sets(csr):
    src = np.repeat(csr.vertex_ids, np.diff(csr.out_indptr))
    dst = csr.vertex_ids[csr.out_dst]
    return set(csr.vertex_ids.tolist()), set(zip(src.tolist(), dst.tolist()))


def _local(tmp_path, name="store", **extra):
    return {"storage.backend": "local", "storage.directory": str(tmp_path / name), **extra}


def test_local_directory_load_equals_the_single_scan(tmp_path):
    cfg = _local(tmp_path)
    g = open_graph(cfg)
    _seed(g, n=120, m=700, seed=9)
    oracle = load_csr(g)
    g.close()
    ref = ref_open_graph(dict(cfg, **{"computer.sharded-auto": False}))
    ref_oracle = ref_load_csr(ref)
    ref.close()
    csr = distributed_load_csr(cfg, num_workers=3, timeout_s=TIMEOUT_S)
    assert _csr_sets(csr) == _csr_sets(oracle) == _csr_sets(ref_oracle)
    for field in CSR_FIELDS:
        np.testing.assert_array_equal(getattr(csr, field), getattr(oracle, field))
        np.testing.assert_array_equal(getattr(csr, field), getattr(ref_oracle, field))
    rec = registry.last_run("olap.distributed_load")
    assert rec["workers"] == 3 and rec["partitions"] == 32
    assert len(rec["worker_open_s"]) == len(rec["worker_scan_s"]) == 3
    assert all(0 < f <= t for f, t in zip(rec["worker_first_partition_s"], rec["worker_scan_s"]))


def test_cross_partition_edges_survive_the_split(tmp_path):
    """Edges whose source and destination live in different workers'
    partition sets are kept by the merge."""
    cfg = _local(tmp_path)
    g = open_graph(cfg)
    vids = _seed(g, n=300, m=1500)
    parts = {g.idm.get_partition_id(int(v)) for v in vids}
    assert len(parts) > 8
    oracle = load_csr(g)
    g.close()
    csr = distributed_load_csr(cfg, num_workers=2, timeout_s=TIMEOUT_S)
    assert csr.num_edges == oracle.num_edges == 1500
    assert _csr_sets(csr) == _csr_sets(oracle)


@pytest.mark.parametrize("backend", ["inmemory"])
def test_rejects_a_backend_that_is_not_shared_local(backend):
    with pytest.raises(ValueError, match="SHARED backend"):
        distributed_load_csr({"storage.backend": backend})


def test_two_workers_over_a_storage_server_equal_the_single_scan():
    """Two loader processes scan a port storage server's store over the
    wire (their config carries the host and port, no directory): the
    merged CSR equals the single in-process scan over the same server, and
    a submit with two workers gives its ranks."""
    from janusgraph_tpu_torch.storage.inmemory import InMemoryStoreManager
    from janusgraph_tpu_torch.storage.remote import RemoteStoreServer

    server = RemoteStoreServer(InMemoryStoreManager()).start()
    host, port = server.address
    cfg = {"storage.backend": "remote", "storage.hostname": host, "storage.port": port,
           "computer.executor": "cpu"}
    g = None
    try:
        g = open_graph(cfg)
        _seed(g, n=200, m=900, seed=11)
        oracle = load_csr(g)
        one = g.compute().program(PageRankProgram(max_iterations=8)).submit()
        g.close()
        csr = distributed_load_csr(cfg, num_workers=2, timeout_s=TIMEOUT_S)
        assert _csr_sets(csr) == _csr_sets(oracle)
        for field in CSR_FIELDS:
            np.testing.assert_array_equal(getattr(csr, field), getattr(oracle, field))
        rec = registry.last_run("olap.distributed_load")
        assert rec["workers"] == 2 and rec["partitions"] == 32 and rec["probed"]
        g = open_graph(dict(cfg, **{"storage.distributed-load-workers": 2}))
        two = g.compute().program(PageRankProgram(max_iterations=8)).submit()
        assert two.run_info["snapshot"] == {"path": "distributed", "workers": 2}
        assert not registry.last_run("olap.distributed_load")["probed"]
        np.testing.assert_array_equal(two.states["rank"], one.states["rank"])
    finally:
        if g is not None and g._open:
            g.close()
        server.stop()


#: a fresh interpreter's prelude in which ``import torch`` fails
_NO_TORCH = 'import sys; sys.modules["torch"] = None; '


def test_the_storage_server_and_a_loader_worker_import_no_torch(tmp_path):
    """Neither process touches the card, and neither loads torch: the
    storage server (``python -m janusgraph_tpu_torch storage-server``) and
    a loader worker over it both run in interpreters where ``import
    torch`` fails, and the worker's partitions hold the single scan's
    edges."""
    import json
    import re
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (root, os.environ.get("PYTHONPATH")) if p))
    server = subprocess.Popen(
        [sys.executable, "-c", _NO_TORCH + "import runpy; sys.argv = ['x', 'storage-server', "
         "'--port', '0']; runpy.run_module('janusgraph_tpu_torch', run_name='__main__')"],
        stdout=subprocess.PIPE, text=True, env=env)
    g = None
    try:
        m = re.search(r"listening on ([\d.]+):(\d+)", server.stdout.readline())
        assert m, "the storage server printed no address"
        cfg = {"storage.backend": "remote", "storage.hostname": m.group(1),
               "storage.port": int(m.group(2)), "computer.executor": "cpu"}
        g = open_graph(cfg)
        _seed(g, n=120, m=500, seed=5)
        oracle = load_csr(g)
        g.close()
        out = str(tmp_path / "part.npz")
        worker = subprocess.run(
            [sys.executable, "-c", _NO_TORCH + "import runpy; sys.argv = ['x'] + sys.argv[1:]; "
             "runpy.run_module('janusgraph_tpu_torch.olap.distributed_load', "
             "run_name='__main__')",
             "--config", json.dumps(cfg), "--partitions", ",".join(map(str, range(32))),
             "--out", out],
            env=env, capture_output=True, text=True, timeout=TIMEOUT_S)
        assert worker.returncode == 0, worker.stderr[-2000:]
        assert server.poll() is None, "the storage server exited"
        with np.load(out) as z:
            got = set(zip(z["src"].tolist(), z["dst"].tolist()))
            assert set(z["vertex_id_list"].tolist()) == _csr_sets(oracle)[0]
        assert got == _csr_sets(oracle)[1]
    finally:
        if g is not None and g._open:
            g.close()
        server.terminate()
        server.wait(timeout=30)


def test_partition_bits_resolved_from_stored_config(tmp_path):
    """The FIXED partition count lives in the backend's global config; a
    caller dict omitting it must not lose partitions."""
    g = open_graph(_local(tmp_path, "pb7", **{"ids.partition-bits": 7}))
    _seed(g, n=300, m=1000, seed=5)
    oracle = load_csr(g)
    g.close()
    csr = distributed_load_csr(_local(tmp_path, "pb7"), num_workers=3, timeout_s=TIMEOUT_S)
    assert registry.last_run("olap.distributed_load")["partitions"] == 128
    assert csr.num_vertices == oracle.num_vertices == 300
    assert csr.num_edges == oracle.num_edges


def test_submit_with_three_workers_gives_the_one_worker_ranks(tmp_path):
    cfg = _local(tmp_path, **{"computer.executor": "cpu"})
    g = open_graph(cfg)
    _seed(g, n=200, m=1000)
    one = g.compute().program(PageRankProgram(max_iterations=10)).submit()
    g.close()
    assert one.run_info["snapshot"]["path"] == "cold"
    g = open_graph(dict(cfg, **{"storage.distributed-load-workers": 3}))
    three = g.compute().program(PageRankProgram(max_iterations=10)).submit()
    assert three.run_info["snapshot"] == {"path": "distributed", "workers": 3}
    for field in CSR_FIELDS:
        np.testing.assert_array_equal(getattr(three.csr, field), getattr(one.csr, field))
    np.testing.assert_array_equal(three.states["rank"], one.states["rank"])
    assert abs(float(three.states["rank"].sum()) - 1.0) < 1e-5
    # a filtered submit carries property columns the raw scan has not:
    # it loads in-process
    props = g.compute().program(PageRankProgram(max_iterations=2)).properties("name").submit()
    assert props.run_info["snapshot"] == {"path": "scan"}
    # rows the parent writes after the distributed submit (the workers
    # appended to the shared WAL while its handle was open) survive a reopen
    tx = g.new_transaction()
    tx.add_edge(tx.add_vertex("node"), "link", tx.add_vertex("node"))
    tx.commit()
    g.close()
    g = open_graph(cfg)
    again = load_csr(g)
    g.close()
    assert again.num_vertices == 202 and again.num_edges == 1001


def _broken_package(tmp_path):
    """A directory whose ``janusgraph_tpu_torch`` raises on import."""
    stub = tmp_path / "broken" / "janusgraph_tpu_torch"
    stub.mkdir(parents=True)
    (stub / "__init__.py").write_text("raise RuntimeError('a broken loader')\n")
    return str(tmp_path / "broken")


def test_a_failed_or_hung_worker_raises_with_no_fallback(tmp_path, monkeypatch):
    cfg = _local(tmp_path, **{"computer.executor": "cpu",
                              "storage.distributed-load-workers": 2,
                              "storage.distributed-load-timeout-s": TIMEOUT_S})
    g = open_graph(cfg)
    _seed(g, n=50, m=200)
    # every worker imports the broken package first: the load raises, and
    # submit() does not fall back to the in-process scan
    monkeypatch.setenv("PYTHONPATH", _broken_package(tmp_path))
    with pytest.raises(RuntimeError, match=r"loader workers failed/hung: \[0, 1\]"):
        g.compute().program(PageRankProgram(max_iterations=2)).submit()
    monkeypatch.delenv("PYTHONPATH")
    # a deadline no worker can meet: killed, and the load raises
    with pytest.raises(RuntimeError, match="failed/hung"):
        distributed_load_csr(dict(cfg), num_workers=2, timeout_s=0.05)
    g.close()


def test_every_replay_stops_at_a_torn_tail(tmp_path):
    cfg = _local(tmp_path)
    g = open_graph(cfg)
    _seed(g, n=100, m=400)
    oracle = load_csr(g)
    g.close()
    # a crash mid-append: the first 10 bytes of a frame
    with open(os.path.join(cfg["storage.directory"], "store.wal"), "ab") as f:
        f.write(b"\x00\x01\x02\x03\x01\x00\x00\x00\x09\x00")
    csr = distributed_load_csr(cfg, num_workers=2, timeout_s=TIMEOUT_S)
    g = open_graph(cfg)
    for field in CSR_FIELDS:
        np.testing.assert_array_equal(getattr(csr, field), getattr(oracle, field))
        np.testing.assert_array_equal(getattr(load_csr(g), field), getattr(oracle, field))
    g.close()
    ref = ref_open_graph(dict(cfg, **{"computer.sharded-auto": False}))
    assert _csr_sets(ref_load_csr(ref)) == _csr_sets(oracle)
    ref.close()


def test_the_worker_entry_point_writes_its_partitions(tmp_path):
    """``python -m janusgraph_tpu_torch.olap.distributed_load`` in-process:
    one scan a partition, each partition's offsets recorded."""
    import json

    from janusgraph_tpu_torch.olap.distributed_load import _worker_main

    cfg = _local(tmp_path)
    g = open_graph(cfg)
    _seed(g, n=80, m=300)
    g.close()
    out = str(tmp_path / "part.npz")
    assert _worker_main(["--config", json.dumps(cfg), "--partitions", "0,5,31",
                         "--out", out]) == 0
    with np.load(out) as z:
        assert z["partitions"].tolist() == [0, 5, 31]
        assert z["vertex_counts"].sum() == len(z["vertex_id_list"])
        assert z["edge_counts"].sum() == len(z["src"]) == len(z["etype"])
        assert bool(z["has_etype"][0]) == (len(z["src"]) > 0)
        assert len(z["scan_s"]) == 3 and float(z["open_s"]) > 0


def test_a_relative_directory_loads_the_callers_store(tmp_path, monkeypatch):
    """The workers run in a temporary directory: a relative
    ``storage.directory`` still names the caller's store, through
    ``distributed_load_csr`` and through ``submit()``, which passes the
    open graph's stored partition count instead of a probe open."""
    monkeypatch.chdir(tmp_path)
    g = open_graph({"storage.backend": "local", "storage.directory": "rel",
                    "ids.partition-bits": 7})
    _seed(g, n=150, m=800, seed=11)
    oracle = load_csr(g)
    g.close()
    cfg = {"storage.backend": "local", "storage.directory": "rel"}
    csr = distributed_load_csr(cfg, num_workers=2, timeout_s=TIMEOUT_S)
    assert registry.last_run("olap.distributed_load")["probed"] is True
    for field in CSR_FIELDS:
        np.testing.assert_array_equal(getattr(csr, field), getattr(oracle, field))
    ref = ref_open_graph(dict(cfg, **{"computer.sharded-auto": False}))
    assert _csr_sets(ref_load_csr(ref)) == _csr_sets(csr)
    ref.close()
    g = open_graph(dict(cfg, **{"storage.distributed-load-workers": 2,
                                "computer.executor": "cpu"}))
    res = g.compute().program(PageRankProgram(max_iterations=3)).submit()
    g.close()
    load = registry.last_run("olap.distributed_load")
    assert load["probed"] is False and load["partitions"] == 128
    assert res.csr.num_vertices == 150 and res.csr.num_edges == 800
    assert sorted(os.listdir(tmp_path)) == ["rel"]


def test_the_worker_refuses_a_directory_with_no_store(tmp_path):
    """Opening an empty directory would make a fresh graph and scan
    nothing: the worker exits non-zero and creates nothing."""
    import json

    from janusgraph_tpu_torch.olap.distributed_load import _worker_main

    missing = tmp_path / "missing"
    out = tmp_path / "part.npz"
    cfg = {"storage.backend": "local", "storage.directory": str(missing)}
    assert _worker_main(["--config", json.dumps(cfg), "--partitions", "0",
                         "--out", str(out)]) == 2
    assert not missing.exists() and not out.exists()
