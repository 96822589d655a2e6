"""Time the remote store's clients of both packages against both servers,
on the CPU: the pipelined client and the sync one, in alternating order.

    python tests/compare_remote_clients.py [--rounds 4] [--rows 10000] [--cells 8]

Each server (the port's ``RemoteStoreServer`` and the JAX package's, each
over its own in-memory store holding the same ``--rows`` rows of
``--cells`` cells) is read by each client (the port's
``RemoteStoreManager`` and the reference's) with the pipeline on and off:
one multi-slice of every row, then 2,000 point reads of the first rows
from 8 threads. Each client runs the pipeline on first in one round and
off first in the next, so neither setting always runs first. Every client
must read the same cells. Prints one JSON line per run and a summary line
of medians.

This is a comparison with the reference (like the tests, it imports both
packages); nothing of the port imports it.
"""

import argparse
import json
import os
import platform
import statistics
import sys
import threading
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from janusgraph_tpu.storage import remote as ref_remote  # noqa: E402
from janusgraph_tpu.storage.inmemory import InMemoryStoreManager as RefInMemory
from janusgraph_tpu.storage.kcvs import KeySliceQuery as RefKSQ, SliceQuery as RefSQ
from janusgraph_tpu_torch.storage import remote
from janusgraph_tpu_torch.storage.inmemory import InMemoryStoreManager
from janusgraph_tpu_torch.storage.kcvs import KeySliceQuery, SliceQuery

POINT_READS = 2_000
THREADS = 8

CLIENTS = {
    "port": (remote.RemoteStoreManager, KeySliceQuery, SliceQuery),
    "reference": (ref_remote.RemoteStoreManager, RefKSQ, RefSQ),
}


def _fill(manager, rows, cells):
    store = manager.open_database("edgestore")
    tx = manager.begin_transaction()
    keys = [i.to_bytes(8, "big") for i in range(rows)]
    for k in keys:
        store.mutate(k, [(bytes([1]) + j.to_bytes(4, "big"), b"v" * 16) for j in range(cells)],
                     [], tx)
    return keys


def _read(client_name, host, port, keys, pipe):
    cls, ksq, sq = CLIENTS[client_name]
    client = cls(host, port, pipeline=pipe)
    try:
        store = client.open_database("edgestore")
        q = sq(bytes([0]), bytes([4]))
        t0 = time.perf_counter()
        multi = store.get_slice_multi(keys, q, None)
        multi_s = time.perf_counter() - t0
        point, errs = {}, []
        point_keys = keys[:POINT_READS]

        def worker(part):
            try:
                for k in part:
                    point[k] = store.get_slice(ksq(k, q), None)
            except Exception as e:  # noqa: BLE001 - raised below
                errs.append(e)

        threads = [threading.Thread(target=worker, args=(point_keys[i::THREADS],))
                   for i in range(THREADS)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(300)
        point_s = time.perf_counter() - t0
        if errs or len(point) != len(point_keys):
            raise RuntimeError(f"{client_name} pipeline={pipe}: {errs[:1]}")
        cells = {k: [tuple(e) for e in v] for k, v in multi.items()}
        if any(cells[k] != [tuple(e) for e in point[k]] for k in point_keys):
            raise RuntimeError(f"{client_name} pipeline={pipe}: point reads differ")
        engaged = getattr(client, "_mux", None) is not None
        return cells, {"multi_s": multi_s, "point_s": point_s, "mux_engaged": engaged}
    finally:
        client.close()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--rows", type=int, default=10_000)
    ap.add_argument("--cells", type=int, default=8)
    args = ap.parse_args(argv)
    managers = {"port": InMemoryStoreManager(), "reference": RefInMemory()}
    keys = [_fill(m, args.rows, args.cells) for m in managers.values()][0]
    servers = {"port": remote.RemoteStoreServer(managers["port"]),
               "reference": ref_remote.RemoteStoreServer(managers["reference"])}
    walls, want = {}, None
    try:
        for srv in servers.values():
            srv.start()
        for r in range(args.rounds):
            for server_name, srv in servers.items():
                host, port = srv.address
                for i, client_name in enumerate(CLIENTS):
                    # on first in one round, off first in the next
                    for pipe in ((True, False) if (r + i) % 2 == 0 else (False, True)):
                        cells, rec = _read(client_name, host, port, keys, pipe)
                        want = cells if want is None else want
                        if cells != want:
                            raise RuntimeError("the clients read different cells")
                        rec.update(round=r, server=server_name, client=client_name,
                                   pipeline=pipe)
                        print(json.dumps(rec), flush=True)
                        walls.setdefault((server_name, client_name, pipe), []).append(rec)
    finally:
        for srv in servers.values():
            srv.stop()
    summary = {
        f"{s}/{c}/{'on' if p else 'off'}": {
            "multi_s_median": statistics.median(r["multi_s"] for r in recs),
            "point_s_median": statistics.median(r["point_s"] for r in recs),
            "runs": len(recs),
            "mux_engaged": recs[0]["mux_engaged"],
        }
        for (s, c, p), recs in sorted(walls.items())
    }
    print(json.dumps({"summary": summary, "rows": args.rows, "cells": args.cells,
                      "point_reads": POINT_READS, "threads": THREADS,
                      "host": f"{platform.processor() or platform.machine()}, "
                              f"{os.cpu_count()} cpus"}))


if __name__ == "__main__":
    main()
