"""The remote store at the stored size on the card, without the rest of the
smoke: ``chip_smoke.py``'s ``stored``, ``stored_local`` and ``remote``
phases alone, on this tree's ``janusgraph_tpu_torch``.

Draws the scale-20 R-MAT graph (the native host library), builds the
kernels, then runs the stored phase (the first 2,000,000 out-edges, label
"link"), the stored_local phase (the same graph in a local directory) and,
inside it after its 8-loader submit, the remote phase: a storage server in
its own process over that directory and the graph over
``storage.backend`` "remote" (``chip_smoke.py`` ``remote_phase`` says what
it holds). Run from the root of the tree, on a machine with a CUDA card:

    python3 bin/torch_remote_store.py [--scale 20] [--seed 1]

It prints the card's name and power limit, then each phase's JSON line as
the smoke does, and fails as the smoke does.
"""

from __future__ import annotations

import argparse
import importlib.util
import os
import subprocess
import sys


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scale", type=int, default=20)
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args()

    root = os.getcwd()
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        print("torch_remote_store: no CUDA device", file=sys.stderr)
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
    out = smoke.stored_local_phase(
        stored, csr, args, smoke.emit,
        remote=lambda *a: smoke.remote_phase(*a, args=args, emit=smoke.emit))
    stored["graph"].close()
    smoke.emit("remote_store_done", launches=out["remote"], nvidia_smi=smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
