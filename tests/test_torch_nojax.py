"""The port stands alone: it imports neither jax nor the JAX package.

One check runs the port with both blocked in a fresh interpreter; the other
scans every port module and chip_smoke.py for such imports. The module name
``janusgraph_tpu_torch`` starts with ``janusgraph_tpu``, so the scan matches
the exact module name or its dotted prefix, never the bare prefix."""

import ast
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "janusgraph_tpu")

BLOCKED_RUN = r"""
import sys
sys.modules["jax"] = None
sys.modules["janusgraph_tpu"] = None
import numpy as np
import janusgraph_tpu_torch
from janusgraph_tpu_torch.olap import GPUExecutor, csr_from_edges, run_on
from janusgraph_tpu_torch.olap.programs import (
    PageRankProgram, ShortestPathProgram, TraversalCountProgram,
)
rng = np.random.default_rng(0)
src = rng.integers(0, 50, 300).astype(np.int32)
dst = rng.integers(0, 50, 300).astype(np.int32)
csr = csr_from_edges(50, src, dst)
out = run_on(csr, PageRankProgram(max_iterations=10), device="cpu")
ex = GPUExecutor(csr, device="cpu")
dist = ex.run(ShortestPathProgram(seed_index=0, max_iterations=4))["distance"]
assert ex.last_run_info["path"] == "frontier" and dist[0] == 0.0
paths = run_on(csr, TraversalCountProgram(hops=3), device="cpu")["count"].sum()
hyb = GPUExecutor(csr, strategy="hybrid", device="cpu", hub_cutoff=4, tail_chunk=4)
fused = hyb.run(PageRankProgram(max_iterations=10))["rank"]
assert hyb.last_run_info["path"] == "fused" and hyb.last_run_info["strategy_resolved"] == "hybrid"
assert np.array_equal(fused, GPUExecutor(csr, strategy="ell", device="cpu").run(
    PageRankProgram(max_iterations=10), fused=False)["rank"])
auto = GPUExecutor(csr, strategy="auto", device="cpu")
auto.run(PageRankProgram(max_iterations=3))
assert auto.last_run_info["autotune"]["device_kind"] == "cpu"
from janusgraph_tpu_torch.olap.delta import DeltaOverlay, OverlayView, materialize
from janusgraph_tpu_torch.olap.programs import ConnectedComponentsProgram, GCNForwardProgram
z = np.zeros(5, dtype=np.int64)
ov = DeltaOverlay.from_batches([{"add": (np.arange(5), np.arange(5) + 60, z),
                                 "del": (src[:3].astype(np.int64), dst[:3].astype(np.int64), z[:3]),
                                 "v_add": {60 + i: 0 for i in range(5)}, "v_del": []}])
view = OverlayView(csr, ov)
cc = GPUExecutor(csr, strategy="ell", device="cpu", delta=view).run(ConnectedComponentsProgram())
mat = run_on(materialize(csr, ov), ConnectedComponentsProgram(), device="cpu", frontier="off")
assert np.array_equal(cc["component"], mat["component"]) and len(mat["component"]) == 55
h = run_on(csr, GCNForwardProgram(feature_dim=8, hidden_dim=8, out_dim=8), strategy="ell",
           device="cpu")["h"]
assert h.shape == (50, 8) and np.isfinite(h).all()
from janusgraph_tpu_torch.olap import (
    ClusterCountMapReduce, FulgoraAnalogueComputer, ldbc_snb_csr, twitter_csr,
)
from janusgraph_tpu_torch.olap.programs import (
    DegreeCountProgram, OLAPTraversalProgram, TraversalStep, enumerate_paths,
)
tcsr = csr_from_edges(50, src, dst, edge_types=(src % 3).astype(np.int32))
tp = OLAPTraversalProgram([TraversalStep("out", (0,)), TraversalStep("both")], record_reach=True)
st = run_on(tcsr, tp, device="cpu")
assert int(st["count"].sum()) == len(list(enumerate_paths(tcsr, tp, st))) > 0
assert np.array_equal(run_on(csr, DegreeCountProgram(), device="cpu")["in_degree"], csr.in_degree)
assert ClusterCountMapReduce("component").execute(cc, csr)["count"] >= 1
assert ldbc_snb_csr(6).num_vertices == 64 and twitter_csr(64, 4).num_edges == 256
assert abs(FulgoraAnalogueComputer(csr, 2).pagerank(2)[0].sum() - 1.0) < 1e-6
loaded = sorted(m for m, mod in sys.modules.items() if mod is not None and (
    m == "jax" or m.startswith("jax.")
    or m == "janusgraph_tpu" or m.startswith("janusgraph_tpu.")))
print("OK", round(float(out["rank"].sum()), 4), paths > 0, loaded)
"""


def _forbidden(name):
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


def test_forbidden_matches_exact_names_only():
    assert _forbidden("jax") and _forbidden("jax.numpy")
    assert _forbidden("janusgraph_tpu") and _forbidden("janusgraph_tpu.olap.csr")
    assert not _forbidden("janusgraph_tpu_torch") and not _forbidden("janusgraph_tpu_torch.olap")
    assert not _forbidden("jaxtyping")


def test_port_runs_with_jax_blocked():
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run(
        [sys.executable, "-c", BLOCKED_RUN], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "OK 1.0 True []", proc.stdout


def _port_files():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, dirs, names in os.walk(os.path.join(ROOT, "janusgraph_tpu_torch")):
        dirs[:] = [d for d in dirs if d != "_build"]  # build output, not source
        files +=[os.path.join(dirpath, n) for n in names if n.endswith(".py")]
    return files


def _imported_names(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.lineno, node.module
        elif (
            isinstance(node, ast.Call)
            and getattr(node.func, "id", getattr(node.func, "attr", None))
            in ("__import__", "import_module")
            and node.args
            and isinstance(node.args[0], ast.Constant)
            and isinstance(node.args[0].value, str)
        ):
            yield node.lineno, node.args[0].value


def test_no_port_file_imports_jax_or_reference():
    files = _port_files()
    assert len(files) > 10 and os.path.exists(files[0])
    bad = []
    for path in files:
        with open(path) as f:
            tree = ast.parse(f.read(), filename=path)
        bad += [
            f"{os.path.relpath(path, ROOT)}:{line} imports {name}"
            for line, name in _imported_names(tree)
            if _forbidden(name)
        ]
    assert not bad, bad
