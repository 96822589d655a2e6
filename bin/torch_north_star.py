"""The north-star rung without the rest of the smoke: ``chip_smoke.py``'s
``north_star`` phase alone, at one or more graph500 scales, on this tree's
``janusgraph_tpu_torch``.

For each scale it draws the R-MAT graph (edge factor 16, the native host
library), holds the segment-sum kernel to its plain version on the graph's
in-plan, and times PageRank (20 supersteps, host loop and fused) and the
out-degree hub's 4-hop BFS (tuned and static tier ladders), each held to
its host reference (``chip_smoke.py`` ``north_star_phase`` says what it
holds). Run from the root of the tree, on a machine with a CUDA card:

    python3 bin/torch_north_star.py [--scales 22 23] [--repeats 5] [--seed 1]

It prints the card's name and power limit, then the phase's JSON lines for
each scale, and fails as the smoke does. ``--device cpu`` runs the plain
versions on the CPU (no device times; a small ``--scales`` there).
"""

from __future__ import annotations

import argparse
import contextlib
import importlib.util
import os
import subprocess
import sys


@contextlib.contextmanager
def cpu_runs_counted():
    """On the CPU the kernel's plain version runs where the card runs the
    kernel, and no device counter sees it: while the block runs, count the
    calls of ``kernels.sorted_segment_sum`` as the CPU's kernel runs, which
    the phase's ``counted`` reads through ``kernels.device_launches("cpu")``."""
    import torch

    from janusgraph_tpu_torch.olap import kernels

    real, real_runs = kernels.sorted_segment_sum, kernels.device_launches
    calls = [0]

    def counting(data, plan):
        calls[0] += 1
        return real(data, plan)

    def device_launches(device):
        return calls[0] if torch.device(device).type == "cpu" else real_runs(device)

    counting.launches, counting.captured = real.launches, real.captured
    kernels.sorted_segment_sum, kernels.device_launches = counting, device_launches
    try:
        yield
    finally:
        kernels.sorted_segment_sum, kernels.device_launches = real, real_runs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scales", type=int, nargs="+", default=[22, 23])
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    root = os.getcwd()
    sys.path.insert(0, root)
    import torch

    if args.device != "cpu" and not torch.cuda.is_available():
        print("torch_north_star: no CUDA device", file=sys.stderr)
        return 2
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(root, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)

    if args.device != "cpu":
        from janusgraph_tpu_torch import _build

        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60,
        ).stdout.strip().splitlines()[0]
        print(smi, flush=True)
        _build.load_library()
        # every run record is held as the smoke holds it (roofline
        # utilization in [0, 1.05], device memory against the allocator)
        smoke.TEL.install()
    on_cpu = cpu_runs_counted() if args.device == "cpu" else contextlib.nullcontext()
    with on_cpu:
        for scale in args.scales:
            smoke.north_star_phase(args, smoke.emit, args.device, scale=scale,
                                   repeats=args.repeats)
    if smoke.TEL.failures:
        raise RuntimeError(f"run records: {smoke.TEL.failures}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
