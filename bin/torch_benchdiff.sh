#!/usr/bin/env bash
# benchdiff wrapper for the PyTorch/CUDA port: the bench regression
# sentinel as a CI gate. Compares two bench artifacts cell-by-cell (stage,
# scale, platform, host-fallback, cpu count) and exits nonzero on any
# regressed headline metric.
#
# Usage:
#   bin/torch_benchdiff.sh OLD.json NEW.json                    # report only
#   bin/torch_benchdiff.sh OLD.json NEW.json --fail-on-regress  # CI gate
#   bin/torch_benchdiff.sh OLD.jsonl NEW.jsonl --threshold 15   # 15% noise band
#
# Accepts every artifact shape: a single stage dict, a supervisor wrapper
# with stage lines embedded in its `tail`, per-stage JSONL, or a list of
# stage dicts.
# Exit codes: 0 ok / 1 regression (with --fail-on-regress) /
# 2 bad arguments / 3 no comparable cells.
set -euo pipefail

REPO_ROOT="$(cd "$(dirname "${BASH_SOURCE[0]}")/.." && pwd)"
cd "$REPO_ROOT"

exec python -m janusgraph_tpu_torch benchdiff "$@"
