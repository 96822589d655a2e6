"""The ``fleet`` subcommand on the card, without the rest of the smoke: a
stored R-MAT graph served by ``python -m janusgraph_tpu_torch fleet``, on
this tree's ``janusgraph_tpu_torch``.

Draws the R-MAT graph (the native host library; scale 16 by default, a
sixteenth of the smoke's stored size), bulk-loads every edge (label
"link") into a local directory and serves it with ``python -m
janusgraph_tpu_torch storage-server --directory DIR`` in its own process.
A graph over that store (``storage.backend`` "remote") in this process
exports its snapshot at 4 shards (``export_snapshot``: its cold scan over
the wire). Then ``python -m janusgraph_tpu_torch fleet --replicas 2`` runs
in its own process over the same store, with ``server.fleet.warmup-dir``
naming the export: r1 warms from the files, r0 scans when first asked.
Through the fleet's frontend, the driver's ``JanusGraphClient`` sends the
``pageRank()`` top 10 with a 900 s deadline; its ids and ranks must equal
a direct submit in this process bit for bit (the same stored graph, the
same program, the card both times). Then ``python -m janusgraph_tpu_torch
incident`` against the frontend (both replicas' lanes, r1's warm-up of
the whole graph), ``top`` against r0 (the fleet process's digest table
holds the top 10's shape), and the frontend's ``/healthz`` (both serving;
its router's count says which replica served the request); the fleet and
the storage server stop. Run from the root of the tree, on a
machine with a CUDA card:

    python3 bin/torch_fleet.py [--scale 16] [--seed 1]

It prints the card's name and power limit, then one JSON line per step
as the smoke does, and fails as the smoke does.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request


def run_cli(root, *argv, timeout=120):
    """One operator tool of the port in its own process: its exit code and
    stdout."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(p for p in (root, env.get("PYTHONPATH")) if p)
    proc = subprocess.run([sys.executable, "-m", "janusgraph_tpu_torch", *argv], cwd=root,
                          env=env, capture_output=True, text=True, timeout=timeout)
    if proc.returncode:
        raise RuntimeError(f"{argv[0]} exited {proc.returncode}: {proc.stderr[-2000:]}")
    return proc.stdout


def start_fleet(root, config_path, start_s=300.0):
    """``python -m janusgraph_tpu_torch fleet --port 0 --replicas 2`` in
    its own process: (the process, the replicas' {name: "host:port"}, the
    frontend's "host:port", seconds to its last start-up line)."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(p for p in (root, env.get("PYTHONPATH")) if p)
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "janusgraph_tpu_torch", "fleet", "--port", "0", "--replicas", "2",
         "--config", config_path], stdout=subprocess.PIPE, text=True, cwd=root, env=env)
    lines = []

    def read():
        for line in proc.stdout:
            lines.append(line)
            if line.startswith("fleet frontend listening"):
                return

    reader = threading.Thread(target=read, daemon=True)
    reader.start()
    reader.join(start_s)
    front = re.search(r"fleet frontend listening on ([\d.]+:\d+) \((\d+) replicas\)",
                      lines[-1]) if lines else None
    if front is None:
        proc.kill()
        proc.wait(30)
        raise RuntimeError(f"the fleet printed no frontend within {start_s} s: {lines}")
    replicas = dict(re.findall(r"replica (r\d+): ([\d.]+:\d+)", "".join(lines)))
    return proc, replicas, front.group(1), time.perf_counter() - t0


def stop_fleet(proc) -> int:
    early = proc.poll()
    proc.terminate()
    try:
        proc.wait(60)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait(30)
        raise RuntimeError("the fleet outlived SIGTERM")
    if early is not None:
        raise RuntimeError(f"the fleet exited early with {early}")
    return proc.returncode


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scale", type=int, default=16)
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args()

    root = os.getcwd()
    sys.path.insert(0, root)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("torch_fleet: no CUDA device", file=sys.stderr)
        return 2
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(root, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)

    from janusgraph_tpu_torch import _build
    from janusgraph_tpu_torch.core.graph import open_graph
    from janusgraph_tpu_torch.driver import JanusGraphClient
    from janusgraph_tpu_torch.olap import rmat_csr
    from janusgraph_tpu_torch.olap.programs import PageRankProgram
    from janusgraph_tpu_torch.server import export_snapshot

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    _build.load_library()
    t_all = time.perf_counter()
    work = tempfile.mkdtemp(prefix="jg_fleet_cli_")
    directory, warm_dir = os.path.join(work, "db"), os.path.join(work, "warm")
    csr = rmat_csr(args.scale, 16, seed=args.seed)
    _vids, _src, _dst, written = smoke._write_local(directory, csr, csr.num_edges)
    server, host, port, server_start_s = smoke.start_storage_server(directory)
    fleet = g = None
    try:
        cfg = {"storage.backend": "remote", "storage.hostname": host, "storage.port": port}
        g = open_graph(cfg)
        t0 = time.perf_counter()
        exported = export_snapshot(g, warm_dir, num_shards=smoke.FLEET_SHARDS)
        export_s = time.perf_counter() - t0
        export_bytes = sum(os.path.getsize(os.path.join(warm_dir, f)) for f in os.listdir(warm_dir))
        config_path = os.path.join(work, "fleet.json")
        with open(config_path, "w") as f:
            json.dump({**cfg, "server.fleet.warmup-dir": warm_dir,
                       "server.fleet.probe-timeout-s": smoke.FLEET_PROBE_TIMEOUT_S,
                       "server.deadline.max-ms": smoke.SERVER_DEADLINE_MS}, f)
        fleet, replicas, frontend, fleet_start_s = start_fleet(root, config_path)
        fhost, fport = frontend.split(":")
        client = JanusGraphClient(host=fhost, port=int(fport), deadline_ms=smoke.SERVER_DEADLINE_MS,
                                  http_timeout_s=smoke.SERVER_DEADLINE_MS / 1e3 + 60.0)
        t0 = time.perf_counter()
        rows = client.submit(smoke.TOP10_QUERY)
        top10_s = time.perf_counter() - t0
        # the same program over the same stored graph on the card here
        direct = g.compute().program(PageRankProgram(max_iterations=20)).submit()
        rank, ids = direct.states["rank"], direct.csr.vertex_ids
        top = [int(r["id"]) for r in rows]
        pos = np.searchsorted(ids, top)
        order = np.lexsort((ids, -rank.astype(np.float64)))[:10]
        if len(rows) != 10 or not np.array_equal(ids[pos], top) or not smoke.bits_equal(
                np.array([r["pagerank"] for r in rows], np.float32), rank[pos]) or sorted(
                zip((-rank[pos]).tolist(), top)) != sorted(
                zip((-rank[order]).tolist(), ids[order].tolist())):
            raise RuntimeError(f"the fleet's top 10 {top} against the direct submit's "
                               f"{ids[order].tolist()}")
        health = json.loads(urllib.request.urlopen(f"http://{frontend}/healthz",
                                                   timeout=60).read())
        if health["status"] != "ok" or health["serving"] != 2:
            raise RuntimeError(f"the frontend's /healthz: {health['status']}, "
                               f"{health['serving']} serving")
        incident = json.loads(run_cli(root, "incident", "--url", frontend, "--window", "0",
                                      "--json"))
        warmups = [e for e in incident["events"]
                   if e.get("category") == "fleet" and e.get("action") == "warmup"]
        # (the merge keys each event's ring as "source" and drops it, so the
        # warm-up's own "source" field does not reach the report: the
        # reference's federation does the same)
        if incident["replicas"] != ["r0", "r1"] or [
                (e["lane"], e["rows"], e["edges"]) for e in warmups] != [
                ("r1", csr.num_vertices, csr.num_edges)]:
            raise RuntimeError(f"incident: replicas {incident['replicas']}, warm-ups {warmups}")
        # the router counts each replica's served requests (the frontend's
        # /healthz member blocks)
        routed = {name: m["stats"]["ok"] for name, m in health["replicas"].items()}
        served_by = [name for name, n in routed.items() if n]
        # the digest table is the fleet process's: either replica serves it
        digests = json.loads(run_cli(root, "top", "--url", replicas["r0"], "--json"))["digests"]
        top10_digest = [d for d in digests if "pagerank" in d["shape"].lower() and d["count"] >= 1]
        if served_by not in (["r0"], ["r1"]) or sum(routed.values()) != 1 or not top10_digest:
            raise RuntimeError(f"routed {routed}; top: {digests}")
        smoke.emit("fleet_cli", nvidia_smi=smi, scale=args.scale, vertices=csr.num_vertices,
                   edges=csr.num_edges, load=written, storage_server_start_s=server_start_s,
                   export={"s": export_s, "bytes": export_bytes, "shards": smoke.FLEET_SHARDS,
                           "source": exported["source"]},
                   fleet_start_s=fleet_start_s, top10_s=top10_s, top10_ids=top,
                   direct_submit_supersteps=direct.run_info["supersteps"],
                   served_by=served_by[0],
                   frontend_healthz={"status": health["status"], "serving": health["serving"]},
                   incident={"events": len(incident["events"]),
                             "lanes": sorted({e["lane"] for e in incident["events"]}),
                             "phases": [p["phase"] for p in incident["phases"]]},
                   routed=routed,
                   top=[{k: d[k] for k in ("digest", "count", "total_ms", "shape")}
                        for d in top10_digest])
    finally:
        fleet_exit = stop_fleet(fleet) if fleet is not None else None
        if g is not None:
            g.close()
        stopped = smoke.stop_storage_server(server)
        shutil.rmtree(work, ignore_errors=True)
    smoke.emit("fleet_cli_done", fleet_exit=fleet_exit, storage_server=stopped,
               seconds=time.perf_counter() - t_all, nvidia_smi=smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
