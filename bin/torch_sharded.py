"""The sharded store under seeded faults at the stored size on the card,
without the rest of the smoke: ``chip_smoke.py``'s ``stored`` and
``sharded`` phases alone, on this tree's ``janusgraph_tpu_torch``.

Draws the scale-20 R-MAT graph (the native host library), builds the
kernels, then runs the stored phase (the first 2,000,000 out-edges, label
"link", in memory) and the sharded phase: the same draw bulk-loaded into
``storage.backend`` "sharded" (three nodes) with the fault injector on, a
cold PageRank submit on the card preempted once and resumed from its
checkpoint, held bitwise to a fault-free run over its own CSR and to the
stored phase's ranks, the kernel against its plain version on its
in-plan, and a node outage absorbed by the retry guard
(``chip_smoke.py`` ``sharded_phase`` says what it holds). Run from the
root of the tree, on a machine with a CUDA card:

    python3 bin/torch_sharded.py [--scale 20] [--seed 1]

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
        print("torch_sharded: no CUDA device", file=sys.stderr)
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
    out = smoke.sharded_phase(stored, csr, args, smoke.emit)
    stored["graph"].close()
    smoke.emit("sharded_done", launches=out["launches"], max_abs_err=out["max_abs_err"],
               nvidia_smi=smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
