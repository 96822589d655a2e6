"""The gate on the port's tree: graphlint for the port over
janusgraph_tpu_torch/.

A module-scoped fixture runs each analyzer (the port's and the
reference's) over the package ONCE; the tests then hold the tree to zero
unsuppressed findings, a clean import sweep, a reason on every
suppression, a banked baseline equal to the tree's counts, and the
reference's findings for every rule the port did not re-aim. The capture
contexts are held to what runs: the real capture sites are found, and the
defs the fused loops enter on the CPU (the same Python a capture runs) all
lie within the analyzer's capture reach. No test here asserts a wall-clock
budget.
"""

from __future__ import annotations

import ast
import os
import re
import subprocess
import sys

import numpy as np
import pytest

from janusgraph_tpu_torch.analysis import Analyzer, capture_reach
from janusgraph_tpu_torch.analysis.core import _DISABLE_FILE_RE, _DISABLE_RE

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGE = os.path.join(REPO, "janusgraph_tpu_torch")
REAIMED = {f"JG10{i}" for i in range(1, 9)} | {"JG303"}
_GRAPHLINT_RE = re.compile(r"#\s*graphlint:\s*(disable(-file)?=|traced|host|handoff|wallclock)")


@pytest.fixture(scope="module")
def lint():
    """Both analyzers over the package, once; display paths from the repo."""
    from janusgraph_tpu.analysis import Analyzer as Reference

    cwd = os.getcwd()
    os.chdir(REPO)
    try:
        port = Analyzer()
        found, _n = port.analyze_paths(["janusgraph_tpu_torch"], keep_suppressed=True)
        ref_found, _n = Reference().analyze_paths(
            ["janusgraph_tpu_torch"], keep_suppressed=True
        )
        reach = capture_reach(["janusgraph_tpu_torch"])
    finally:
        os.chdir(cwd)
    return {"found": found, "stats": port.last_stats, "ref": ref_found, "reach": reach}


def _comments():
    """(display path, line number, text) of every graphlint comment in the
    port's modules outside the analyzer itself."""
    out = []
    for root, dirs, files in os.walk(PACKAGE):
        dirs[:] = sorted(d for d in dirs if d not in ("__pycache__", "analysis", "_build"))
        for fn in sorted(files):
            if not fn.endswith(".py"):
                continue
            p = os.path.join(root, fn)
            with open(p, encoding="utf-8") as f:
                for i, line in enumerate(f, start=1):
                    if _GRAPHLINT_RE.search(line):
                        out.append((os.path.relpath(p, REPO), i, line))
    return out


def test_port_tree_has_zero_unsuppressed_findings(lint):
    live = [f for f in lint["found"] if not f.suppressed]
    assert live == [], "graphlint found issues:\n" + "\n".join(
        f"{f.path}:{f.line}: {f.rule_id} {f.message}" for f in live
    )


def test_port_import_sweep_clean():
    from janusgraph_tpu_torch.analysis.imports_check import check_imports

    findings = check_imports([PACKAGE])
    assert findings == [], "\n".join(
        f"{f.path}: {f.rule_id} {f.message}" for f in findings
    )


def test_port_suppressions_carry_justification():
    bad = []
    for root, dirs, files in os.walk(PACKAGE):
        dirs[:] = [d for d in dirs if d != "__pycache__"]
        for fn in files:
            if not fn.endswith(".py"):
                continue
            p = os.path.join(root, fn)
            with open(p, encoding="utf-8") as f:
                for i, line in enumerate(f, start=1):
                    if (_DISABLE_RE.search(line) or _DISABLE_FILE_RE.search(line)) and (
                        " -- " not in line
                    ):
                        bad.append(f"{p}:{i}")
    assert bad == [], f"suppressions without justification: {bad}"


def test_baseline_json_equals_the_trees_suppression_counts(lint):
    from janusgraph_tpu_torch.analysis.baseline import load_baseline
    from janusgraph_tpu_torch.analysis.cli import default_baseline

    assert load_baseline(default_baseline()) == lint["stats"]["suppressions_by_rule"]


def test_stack_agnostic_findings_match_the_reference_on_the_port_tree(lint):
    """For every rule the port did not re-aim, the port's analyzer and the
    reference's give the same findings over the port's tree, suppressed
    ones included: the capture dispatch widens only the JG1xx/JG303
    propagation, never the call graph the other families read."""
    def key(findings):
        return sorted(
            (f.rule_id, f.severity, f.path, f.line, f.col, f.message, f.suppressed)
            for f in findings if f.rule_id not in REAIMED
        )

    port, ref = key(lint["found"]), key(lint["ref"])
    assert port, "the port's tree lost its suppressed findings"
    assert port == ref, (
        f"port only: {sorted(set(port) - set(ref))}; "
        f"reference only: {sorted(set(ref) - set(port))}"
    )
    # the reference's trace rules find nothing in the port: it has no jit
    assert not [f for f in lint["ref"] if f.rule_id in REAIMED]


def test_every_port_only_comment_is_listed_in_the_readme():
    """A graphlint comment in the port is the reference's own (same text)
    or a port-only one that the README's "graphlint for the port" section
    lists by file."""
    ref_texts = set()
    ref_root = os.path.join(REPO, "janusgraph_tpu")
    for root, dirs, files in os.walk(ref_root):
        dirs[:] = [d for d in dirs if d != "__pycache__"]
        for fn in files:
            if fn.endswith(".py"):
                with open(os.path.join(root, fn), encoding="utf-8") as f:
                    ref_texts |= {
                        line[line.index("# graphlint"):].strip()
                        for line in f if _GRAPHLINT_RE.search(line)
                    }
    with open(os.path.join(REPO, "README.md"), encoding="utf-8") as f:
        readme = f.read()
    start = readme.index("### graphlint for the port")
    ends = [i for i in (readme.find("\n## ", start), readme.find("\n### ", start + 1)) if i > 0]
    section = readme[start:min(ends)] if ends else readme[start:]
    comments = _comments()
    assert len(comments) > 60
    port_only = [
        (path, i) for path, i, line in comments
        if line[line.index("# graphlint"):].strip() not in ref_texts
    ]
    assert port_only
    missing = sorted({
        path for path, _i in port_only
        if path.split("janusgraph_tpu_torch/", 1)[1] not in section
    })
    assert missing == [], f"port-only comments not listed in the README: {missing}"


def test_the_capture_sites_are_capture_contexts(lint):
    """Both `with torch.cuda.graph(...)` blocks of the port are capture
    regions, and the walk reaches the loops' supersteps, the aggregation
    and the programs' message/apply through the call graph."""
    from janusgraph_tpu_torch.analysis import callgraph, core

    sites = []
    for rel in ("olap/gpu_executor.py", "parallel/sharded.py"):
        path = os.path.join(PACKAGE, rel)
        with open(path, encoding="utf-8") as f:
            lines = [i for i, line in enumerate(f, start=1)
                     if line.strip().startswith("with torch.cuda.graph(")]
        assert len(lines) == 1, (rel, lines)
        mod, err = core.load_module(path, path)
        assert err is None
        regions = {
            td.node.lineno for td in callgraph.propagate_traced(
                [mod], callgraph.CallGraph([mod]))[path].values()
            if isinstance(td.node, ast.With)
        }
        assert regions == set(lines), (rel, regions)
        sites.append(rel)
    reach = lint["reach"]
    for qname in (
        "olap/gpu_executor.py:_FusedLoop.step",
        "olap/gpu_executor.py:_FusedLoop.finish",
        "olap/gpu_executor.py:GPUExecutor._aggregate",
        "olap/kernels.py:sorted_segment_sum",
        "parallel/sharded.py:_ShardedFusedLoop.step",
        "parallel/sharded.py:_ShardedFusedLoop.finish",
        "parallel/sharded.py:ShardedExecutor._superstep",
        "olap/programs/pagerank.py:PageRankProgram.message",
        "olap/programs/pagerank.py:PageRankProgram.apply",
        "olap/programs/connected_components.py:ConnectedComponentsProgram.apply",
    ):
        assert f"janusgraph_tpu_torch/{qname}" in reach, qname
    assert reach["janusgraph_tpu_torch/olap/kernels.py:_SegSumPlan.device_arrays"] == "host"


def _probe_loops(loops, probe):
    for loop in loops:
        with probe:
            loop.step()
            loop.finish()


def test_cpu_fused_loops_stay_within_the_capture_reach(lint):
    """The fused loops' step() and finish() — the Python a capture runs —
    enter only defs the analyzer puts in its capture reach, for each
    program on the fused path under each aggregation strategy, and for the
    sharded loop on a CPU mesh."""
    from janusgraph_tpu_torch.analysis.tracing import CaptureProbe
    from janusgraph_tpu_torch.olap import GPUExecutor, csr_from_edges
    from janusgraph_tpu_torch.olap.programs import (
        ConnectedComponentsProgram, GCNForwardProgram, PageRankProgram,
        TraversalCountProgram,
    )
    from janusgraph_tpu_torch.parallel import Mesh, ShardedExecutor
    import torch

    rng = np.random.default_rng(7)
    n, e = 300, 2400
    csr = csr_from_edges(n, rng.integers(0, n, e).astype(np.int32),
                         rng.integers(0, n, e).astype(np.int32))
    probe = CaptureProbe(PACKAGE, cwd=REPO)
    programs = [
        PageRankProgram(max_iterations=3), ConnectedComponentsProgram(max_iterations=3),
        TraversalCountProgram(hops=2),
        GCNForwardProgram(feature_dim=8, hidden_dim=8, out_dim=8),
    ]
    for strategy in ("segsum", "ell", "hybrid", "segment", "auto"):
        ex = GPUExecutor(csr, strategy=strategy, device="cpu", hub_cutoff=8, tail_chunk=8)
        for program in programs:
            # each loop right after its own run, as its captures would see
            # the executor (a dense program's run sets its lane tier)
            ex.run(program)
            assert ex.last_run_info["path"] == "fused"
            _probe_loops([lp for lp in ex._fused_loops.values() if lp.program is program],
                         probe)
    for exchange in ("a2a", "blocked", "ring", "gather"):
        sharded = ShardedExecutor(csr, mesh=Mesh([torch.device("cpu")] * 4), exchange=exchange,
                                  agg="ell" if exchange in ("a2a", "blocked") else "segment")
        sharded.run(PageRankProgram(max_iterations=3), fused=True)
        assert sharded.last_run_info["path"] == "fused"
        _probe_loops(sharded._fused_loops.values(), probe)
    entered = probe.keys()
    assert len(entered) > 20
    missed = sorted(entered - set(lint["reach"]))
    assert missed == [], f"entered under the fused loop, not in the capture reach: {missed}"


def test_module_entrypoint_exits_zero_on_the_package():
    """`python -m janusgraph_tpu_torch.analysis` with no arguments lints
    the package under its own baseline.json and exits 0."""
    proc = subprocess.run(
        [sys.executable, "-m", "janusgraph_tpu_torch.analysis"],
        capture_output=True, text=True, cwd=REPO, timeout=600,
    )
    assert proc.returncode == 0, proc.stdout[-4000:] + proc.stderr[-4000:]
    assert "graphlint: 0 error(s)" in proc.stdout
    assert "suppression ratchet" not in proc.stderr
