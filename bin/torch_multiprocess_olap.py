"""Two processes on one card over torch.distributed, without the rest of
the smoke: ``chip_smoke.py``'s ``multiprocess_olap`` phase alone, with
what it reads from the phases before it, on this tree's
``janusgraph_tpu_torch``.

Draws the scale-20 R-MAT graph (the native host library), builds the
kernels, computes scipy's components and the out-degree hub's BFS, runs
the single-process sharded executor on 8 slots of the card under
exchange "auto" (what ``sharded_olap`` (b) computes:
``chip_smoke.single_process_auto_run``), then the phase: two processes
with 4 slots of the card each form one 8-slot mesh over gloo and run
that layout's PageRank, CC and BFS, held bitwise to the single-process
run (``chip_smoke.py`` ``multiprocess_olap_phase`` says what it holds).
Run from the root of the tree, on a machine with a CUDA card:

    python3 bin/torch_multiprocess_olap.py [--scale 20] [--seed 1]

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
        print("torch_multiprocess_olap: no CUDA device", file=sys.stderr)
        return 2
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(root, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)

    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import connected_components, shortest_path

    from janusgraph_tpu_torch import _build, native
    from janusgraph_tpu_torch.olap import kernels, rmat_csr

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    _build.load_library()
    if not native.available():
        raise RuntimeError(f"the native host library did not build: {_build.host_build_info}")
    t0 = time.perf_counter()
    csr = rmat_csr(args.scale, 16, seed=args.seed)
    n, m = csr.num_vertices, csr.num_edges
    src = np.repeat(np.arange(n), np.diff(csr.out_indptr))
    adj = coo_matrix((np.ones(m), (src, csr.out_dst)), shape=(n, n)).tocsr()
    ncomp, labels = connected_components(adj, directed=True, connection="weak")
    first = np.full(ncomp, n, dtype=np.int64)
    np.minimum.at(first, labels, np.arange(n))
    seed = int(np.argmax(csr.out_degree))
    want = shortest_path(adj, method="D", directed=True, unweighted=True, indices=seed)
    single = smoke.single_process_auto_run(csr, seed)
    smoke.emit("multiprocess_olap_setup", seconds=time.perf_counter() - t0,
               exchange=single["exchange"], agg=single["agg"])
    kernels.reset_launch_counts()
    out = smoke.multiprocess_olap_phase(csr, single, seed, first[labels], want, args,
                                        smoke.emit, smi)
    smoke.emit("multiprocess_olap_done", seconds=out["seconds"], kernel_runs=out["kernel_runs"],
               nvidia_smi=smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
