"""graphlint for the port: static analysis of janusgraph_tpu_torch.

Whole-program: a package-wide symbol table and call graph
(``analysis/callgraph.py``) let capture taint, blocking-under-lock, and the
concurrency rules reason across module boundaries.

Four rule families guard the invariants the runtime cannot check for us:

* **Capture safety** (JG1xx) — the fused loops record supersteps into CUDA
  graphs (``with torch.cuda.graph(...)``); host code there runs once, at
  capture, never at replay. A Python coercion of a tensor, a stray
  ``numpy`` call, a metric, a log record or a rebound buffer inside a
  captured body is a host sync the capture cannot hold or a value frozen
  into every replay.
* **Lock discipline** (JG2xx) — the OLTP storage stack (lockers, caches,
  logs, managers) is lock-based; inconsistent acquisition order or blocking
  I/O under a lock is a latent deadlock at the million-user traffic goal.
* **Padding/shape invariants** (JG3xx) — kernels rely on power-of-two
  capacity tiers and sentinel-padded fixed shapes; a non-power-of-two tier,
  a literal fill that drifts from the documented sentinel, or a
  data-dependent shape under capture silently corrupts results or breaks
  the capture.
* **Concurrency / context-loss** (JG4xx) — the serving fleet mixes
  request threads, a probe thread, and scan/reindex pools; the call graph
  computes what runs on a spawned thread so cross-thread attribute races,
  contextvar state dropped at pool boundaries, cross-module
  blocking-under-lock, and leaked threads all become findings.

Everything here is stdlib-only (``ast`` + ``tokenize``): importing this
package never imports torch/numpy, so the analyzer runs fast anywhere.

Usage::

    python -m janusgraph_tpu_torch.analysis [paths ...] [--format json] [--stats]
    python -m janusgraph_tpu_torch.analysis   # the package, under analysis/baseline.json
    bin/torch_graphlint.sh --changed-only

Suppression: append ``# graphlint: disable=JG101`` to the flagged line (or
put it on a comment line directly above); ``# graphlint: disable-file=JG203``
anywhere in a file disables a rule file-wide. Mark a helper that only ever
runs under a capture with ``# graphlint: traced`` on (or above) its ``def``
line to opt it into the capture rules.
"""

from janusgraph_tpu_torch.analysis.core import (  # noqa: F401
    Analyzer,
    Finding,
    RULES,
    Rule,
    SEV_ERROR,
    SEV_WARNING,
    analyze_paths,
    capture_reach,
)
from janusgraph_tpu_torch.analysis.reporting import to_json, to_text  # noqa: F401

__all__ = [
    "Analyzer",
    "Finding",
    "Rule",
    "RULES",
    "SEV_ERROR",
    "SEV_WARNING",
    "analyze_paths",
    "capture_reach",
    "to_json",
    "to_text",
]
