#!/usr/bin/env bash
# graphlint for the port: capture-safety / lock-discipline /
# padding-invariant analysis for janusgraph_tpu_torch. Exits nonzero on
# error findings.
#
# Usage:
#   bin/torch_graphlint.sh                      # the package, under its baseline.json
#   bin/torch_graphlint.sh --changed-only       # merge-base diff + working tree
#   bin/torch_graphlint.sh --format json        # machine-readable report (v2 keys)
#   bin/torch_graphlint.sh --check-imports      # + syntax/import sweep
#   bin/torch_graphlint.sh --stats              # call-graph + per-rule counts
#   bin/torch_graphlint.sh janusgraph_tpu_torch/olap  # scoped scan
#
# With no paths the suppression ratchet is on: a rule whose suppression
# count grows past janusgraph_tpu_torch/analysis/baseline.json fails the
# run. Re-bank the budget after removing suppressions:
#   bin/torch_graphlint.sh --write-baseline janusgraph_tpu_torch/analysis/baseline.json
# Inspect the budget table:
#   bin/torch_graphlint.sh --report-suppressions
#
# All flags pass through to `python -m janusgraph_tpu_torch.analysis`
# (see --help / --list-rules). Suppress a finding in code with
#   # graphlint: disable=JGnnn -- <why>
# Mark a cached helper that a capture only reads with
#   # graphlint: host -- <why>  (README.md, "graphlint for the port")
set -euo pipefail

REPO_ROOT="$(cd "$(dirname "${BASH_SOURCE[0]}")/.." && pwd)"
cd "$REPO_ROOT"

exec python -m janusgraph_tpu_torch.analysis "$@"
