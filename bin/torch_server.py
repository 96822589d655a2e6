"""The query server on the stored graph on the card, without the rest of
the smoke: ``chip_smoke.py``'s ``stored`` phase, then the ``oltp`` phase's
server steps alone, on this tree's ``janusgraph_tpu_torch``.

Draws the scale-20 R-MAT graph (the native host library), builds the
kernels, runs the stored phase (the first 2,000,000 out-edges, label
"link", in memory), reopens the graph over the same store and serves it
with the port's ``JanusGraphServer`` (its defaults and a 900 s deadline):
the ``pageRank()`` top 10 through the driver's ``JanusGraphClient`` held
to a direct submit (``server_top10``), the brownout gate refusing a submit
with no kernel run (``server_brownout``), and a WebSocket session's edge
read back after its commit and not before (``server_session``); then the
server stops with its threads (``chip_smoke.py`` says what each holds).
Run from the root of the tree, on a machine with a CUDA card:

    python3 bin/torch_server.py [--scale 20] [--seed 1]

It prints the card's name and power limit, then each step's JSON line as
the smoke does, and fails as the smoke does.
"""

from __future__ import annotations

import argparse
import importlib.util
import os
import subprocess
import sys
import time


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scale", type=int, default=20)
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args()

    root = os.getcwd()
    sys.path.insert(0, root)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("torch_server: no CUDA device", file=sys.stderr)
        return 2
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(root, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)

    from janusgraph_tpu_torch import _build
    from janusgraph_tpu_torch.olap import rmat_csr

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    smoke.TEL.install()
    _build.load_library()
    csr = rmat_csr(args.scale, 16, seed=args.seed)
    stored = smoke.stored_phase(csr, args, smoke.emit)
    t0 = time.perf_counter()
    g = smoke.open_oltp_graph(stored)
    server, client = smoke.start_query_server({"graph": g})
    try:
        top10 = smoke.server_top10(g, server, client, smoke.emit, t0)
        smoke.server_brownout(g, server, smoke.emit)
        smoke.server_session(server, client, top10["csr"],
                             np.random.default_rng(args.seed + 11), smoke.emit)
    finally:
        smoke.stop_query_server(server)
    g.close()
    stored["graph"].close()
    smoke.emit("server_done", launches=top10["launches"], seconds=time.perf_counter() - t0,
               nvidia_smi=smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
