"""The sharded BSP executor on one card, without the rest of the smoke:
``chip_smoke.py``'s ``sharded_olap`` phase alone, with what it reads from
the phases before it, on this tree's ``janusgraph_tpu_torch``.

Draws the scale-20 R-MAT graph (the native host library), builds the
kernels, runs the main path's single-device PageRank (20 supersteps, the
segment-sum kernel) and scipy's components and the out-degree hub's BFS,
the stored phase (the first 2,000,000 out-edges, label "link", in
memory), then the sharded_olap phase: every exchange x aggregation pair at
scale 14 on 8 slots of the card, the scale-20 runs under exchange "auto"
and "blocked", a shard preemption resumed from the shard checkpoint, and
graph.compute(executor="sharded") on the stored graph (``chip_smoke.py``
``sharded_olap_phase`` says what it holds). Run from the root of the tree,
on a machine with a CUDA card:

    python3 bin/torch_sharded_olap.py [--scale 20] [--seed 1]

It prints the card's name and power limit, then each phase's JSON line as
the smoke does, and fails as the smoke does.
"""

from __future__ import annotations

import argparse
import importlib.util
import os
import subprocess
import sys
import time

import numpy as np


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scale", type=int, default=20)
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args()

    root = os.getcwd()
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        print("torch_sharded_olap: no CUDA device", file=sys.stderr)
        return 2
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(root, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)

    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import connected_components, shortest_path

    from janusgraph_tpu_torch import _build
    from janusgraph_tpu_torch.olap import rmat_csr, run_on
    from janusgraph_tpu_torch.olap.programs import PageRankProgram

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    smoke.TEL.install()
    _build.load_library()
    t0 = time.perf_counter()
    csr = rmat_csr(args.scale, 16, seed=args.seed)
    n, m = csr.num_vertices, csr.num_edges
    rank = run_on(csr, PageRankProgram(max_iterations=20, tol=0.0), strategy="segsum")["rank"]
    src = np.repeat(np.arange(n), np.diff(csr.out_indptr))
    adj = coo_matrix((np.ones(m), (src, csr.out_dst)), shape=(n, n)).tocsr()
    ncomp, labels = connected_components(adj, directed=True, connection="weak")
    first = np.full(ncomp, n, dtype=np.int64)
    np.minimum.at(first, labels, np.arange(n))
    seed = int(np.argmax(csr.out_degree))
    want = shortest_path(adj, method="D", directed=True, unweighted=True, indices=seed)
    smoke.emit("sharded_olap_setup", seconds=time.perf_counter() - t0)
    stored = smoke.stored_phase(csr, args, smoke.emit)
    out = smoke.sharded_olap_phase(stored, csr, rank, first[labels], seed, want, args,
                                   smoke.emit, smi)
    stored["graph"].close()
    smoke.emit("sharded_olap_done", seconds=out["seconds"], kernel_runs=out["kernel_runs"],
               nvidia_smi=smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
