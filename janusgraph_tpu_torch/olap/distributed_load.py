"""Multi-process distributed CSR loading — the port's copy of
``janusgraph_tpu/olap/distributed_load.py``, the Hadoop/Spark input-format
analogue over real processes.

The split unit is the storage partition: N worker processes each open the
shared backend (a storage server, ``storage.backend`` "remote", or a
persistent local directory; an in-memory store is private to its process
and refused), run the raw partition scan
(``csr._scan_raw``, no endpoint validation, since an edge's destination
may live in another worker's partitions) over the partitions p with
``p % N == w``, and ship their arrays back through npz files; the parent
merges and validates once (``csr.build_csr_from_raw``). A worker scans
its partitions one at a time and reports where each begins, and the
parent merges them in partition order (the reference concatenates the
workers' outputs in worker order): the merged arrays are the single
scan's wherever the scan's own chunking keeps row order (a graph whose
edges all have fixed-width cells), so the in-CSR's rows keep the single
scan's order, and a program's sums with it. The partition count is the
graph's stored ``ids.partition-bits``: the open graph's, where the caller
passes it, else read by one probe open of the graph. The workers share
one deadline; a failed or hung worker kills the rest and raises, with no
fallback to the in-process scan.

Each worker opens the graph itself. Over a local directory it replays the
whole store (the WAL and snapshot) before it scans its own partitions;
over a storage server it replays nothing: its config carries the server's
host and port, it opens no directory, and its scans stream over the wire
from the one store the server holds. Every
worker's environment has ``CUDA_VISIBLE_DEVICES`` empty: the loaders
create no CUDA context, and the parent runs the program on the card. A
worker opens the graph without change capture and the spillover planner,
so it never imports torch (its start would take seconds more). The
workers find this package through ``PYTHONPATH`` (the package's root is
appended to the caller's) and run in the load's temporary directory, so
a local store's directory is made absolute first; a worker refuses a local
directory that holds no store rather than open an empty one.

Besides the reference's outputs, the load records its split into
``registry.record_run("olap.distributed_load", ...)``: the probe open,
the workers' wall, each worker's open (the replay), scan and first
partition's scan, and the merge.

Worker entry: ``python -m janusgraph_tpu_torch.olap.distributed_load
--config ... --partitions 0,1,2 --out part.npz``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time
from typing import List, Optional, Sequence

import numpy as np


def _worker_main(argv: Optional[Sequence[str]] = None) -> int:
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--config", required=True, help="graph config JSON")
    ap.add_argument("--partitions", required=True, help="comma-separated ids")
    ap.add_argument("--out", required=True, help="output npz path")
    args = ap.parse_args(argv)

    from janusgraph_tpu_torch.core.graph import open_graph
    from janusgraph_tpu_torch.olap.csr import _scan_raw

    cfg = json.loads(args.config)
    directory = cfg.get("storage.directory")
    if cfg.get("storage.backend") == "local" and not (
        directory
        and any(os.path.exists(os.path.join(directory, f)) for f in ("store.wal", "store.snapshot"))
    ):
        # opening would create an empty store there and scan nothing
        print(f"loader: no stored graph at {directory!r}", file=sys.stderr)
        return 2
    # a loader only scans: no change capture and no spillover planner,
    # whose modules need torch (its start would take seconds longer)
    cfg.update({"computer.delta": False, "computer.spillover": False})
    t0 = time.perf_counter()
    graph = open_graph(cfg)
    open_s = time.perf_counter() - t0
    try:
        partitions = [int(p) for p in args.partitions.split(",") if p != ""]
        # one scan a partition, so the parent can put the partitions back
        # in order: the arrays then concatenate as the single scan's
        raws, scan_s = [], []
        for p in partitions:
            t0 = time.perf_counter()
            raws.append(_scan_raw(graph, None, None, {}, None, [p]))
            scan_s.append(time.perf_counter() - t0)
        cat = lambda key, dtype: np.concatenate(  # noqa: E731
            [np.asarray(r[key], dtype=dtype) for r in raws]
        ) if raws else np.empty(0, dtype)
        np.savez(
            args.out,
            vertex_id_list=cat("vertex_id_list", np.int64),
            vertex_labels=cat("vertex_labels", np.int64),
            src=cat("src", np.int64),
            dst=cat("dst", np.int64),
            etype=np.concatenate([
                r["etype"] if r["etype"] is not None else np.zeros(len(r["src"]), np.int32)
                for r in raws
            ]) if raws else np.empty(0, np.int32),
            has_etype=np.asarray([any(r["etype"] is not None for r in raws)]),
            partitions=np.asarray(partitions, dtype=np.int64),
            vertex_counts=np.asarray([len(r["vertex_id_list"]) for r in raws], dtype=np.int64),
            edge_counts=np.asarray([len(r["src"]) for r in raws], dtype=np.int64),
            open_s=np.asarray(open_s),
            scan_s=np.asarray(scan_s, dtype=np.float64),
        )
    finally:
        graph.close()
    return 0


def distributed_load_csr(
    config: dict,
    num_workers: int = 4,
    timeout_s: float = 600.0,
    partition_bits: Optional[int] = None,
):
    """Load a CSR snapshot with N worker processes over a SHARED backend
    (``storage.backend`` "remote", a storage server, or "local", a
    persistent directory; an in-memory backend would give each worker an
    empty private store, which is rejected). ``partition_bits`` is the open
    graph's ``idm.partition_bits`` where the caller holds one; without it
    one probe open reads the stored value (over "remote", from the
    server). Returns the merged, validated CSRGraph."""
    backend = config.get("storage.backend", "inmemory")
    if backend not in ("remote", "local"):
        raise ValueError(
            "distributed_load_csr needs a SHARED backend "
            "(storage.backend='remote' or 'local'); "
            f"got {backend!r} whose state is private to each process"
        )
    from janusgraph_tpu_torch.core.graph import open_graph
    from janusgraph_tpu_torch.core.ids import IDManager
    from janusgraph_tpu_torch.observability import registry

    # the workers run in a temporary directory: a relative store path
    # must name the caller's store, not an empty one there
    config = dict(config)
    if backend == "local" and config.get("storage.directory"):
        config["storage.directory"] = os.path.abspath(config["storage.directory"])
    # the partition count is the cluster's stored FIXED value, which can
    # differ from (or be absent in) the caller's dict: without the open
    # graph's value, resolve it as the workers will, by opening the graph
    t0 = time.perf_counter()
    pb = partition_bits
    if pb is None:
        probe = open_graph(config)
        try:
            pb = probe.idm.partition_bits
        finally:
            probe.close()
    probe_s = time.perf_counter() - t0
    num_partitions = 1 << pb
    num_workers = max(1, min(num_workers, num_partitions))
    assignments: List[List[int]] = [[] for _ in range(num_workers)]
    for p in range(num_partitions):
        assignments[p % num_workers].append(p)

    package_root = os.path.dirname(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    )
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [p for p in (env.get("PYTHONPATH"), package_root) if p]
    )
    # the loaders never touch the card: no CUDA context per worker
    env["CUDA_VISIBLE_DEVICES"] = ""
    cfg_json = json.dumps(config)

    with tempfile.TemporaryDirectory() as td:
        procs = []
        outs = []
        t0 = time.perf_counter()
        try:
            for w, parts in enumerate(assignments):
                out = os.path.join(td, f"part{w}.npz")
                outs.append(out)
                procs.append(subprocess.Popen(
                    [
                        sys.executable, "-m",
                        "janusgraph_tpu_torch.olap.distributed_load",
                        "--config", cfg_json,
                        "--partitions", ",".join(map(str, parts)),
                        "--out", out,
                    ],
                    cwd=td, env=env,
                ))
            # ONE shared deadline (not timeout_s per worker), and a hung or
            # failed worker must not leak the others past this function:
            # they would keep scanning and writing into a deleted directory
            deadline = time.monotonic() + timeout_s
            failed = []
            for w, proc in enumerate(procs):
                remaining = max(0.1, deadline - time.monotonic())
                try:
                    rc = proc.wait(timeout=remaining)
                except subprocess.TimeoutExpired:
                    failed.append(w)
                    continue
                if rc != 0:
                    failed.append(w)
            if failed:
                raise RuntimeError(f"loader workers failed/hung: {failed}")
        finally:
            for proc in procs:
                if proc.poll() is None:
                    proc.kill()
            for proc in procs:
                if proc.poll() is None:
                    try:
                        proc.wait(timeout=10)
                    except subprocess.TimeoutExpired:
                        pass
        workers_s = time.perf_counter() - t0

        t0 = time.perf_counter()
        by_partition, seconds = {}, []
        for out in outs:
            with np.load(out) as z:
                etype = z["etype"] if bool(z["has_etype"][0]) else None
                vo = np.concatenate([[0], np.cumsum(z["vertex_counts"])])
                eo = np.concatenate([[0], np.cumsum(z["edge_counts"])])
                for i, p in enumerate(z["partitions"].tolist()):
                    e = slice(eo[i], eo[i + 1])
                    by_partition[p] = {
                        "vertex_id_list": z["vertex_id_list"][vo[i]:vo[i + 1]],
                        "vertex_labels": z["vertex_labels"][vo[i]:vo[i + 1]],
                        "src": z["src"][e],
                        "dst": z["dst"][e],
                        "etype": etype[e] if etype is not None else None,
                        "weights": None,
                        "raw_props": {},
                    }
                seconds.append((float(z["open_s"]), z["scan_s"]))

    from janusgraph_tpu_torch.olap.csr import build_csr_from_raw

    # partition order, as the single scan reads them
    raws = [by_partition[p] for p in sorted(by_partition)]
    csr = build_csr_from_raw(IDManager(partition_bits=pb), raws)
    registry.record_run("olap.distributed_load", {
        "workers": num_workers, "partitions": num_partitions,
        "probed": partition_bits is None, "probe_s": probe_s, "workers_wall_s": workers_s,
        "worker_open_s": [o for o, _ in seconds],
        "worker_scan_s": [float(sc.sum()) for _, sc in seconds],
        # a store's first scan in a process also builds its key index
        "worker_first_partition_s": [float(sc[0]) if len(sc) else 0.0 for _, sc in seconds],
        "merge_s": time.perf_counter() - t0,
    })
    return csr


if __name__ == "__main__":
    sys.exit(_worker_main())
