"""graphlint for the port (janusgraph_tpu_torch/analysis/): rules, fixtures,
CLI and baseline.

Three jobs:

1. **Stack-agnostic rules, held to the reference.** For every fixture of
   ``tests/fixtures/graphlint/`` that exercises a rule other than
   JG101–108/JG303, and for ``xmod_pkg/``, the port's analyzer and the
   reference's give identical findings.
2. **Re-aimed rules.** JG101–108 and JG303 look at CUDA-graph captures in
   the port: each torch fixture of ``tests/fixtures/graphlint_torch/``
   fires exactly where its ``# expect: JGnnn`` markers say, and the capture
   idioms the port relies on (the capture ladder, the capture guard, an
   attribute counter, a shapes-only body) fire nothing.
3. **The CLI and the ratchet** behave as the reference's: suppression,
   ``disable-file``, JSON round trip and determinism, ``--select``/
   ``--ignore``, the ``-m`` entry point, ``--changed-only`` with merge-base,
   ``--stats``, ``--write-baseline``/``--baseline``/``--report-suppressions``.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys

import pytest

from janusgraph_tpu_torch.analysis import Analyzer, RULES, analyze_paths
from janusgraph_tpu_torch.analysis.cli import filter_changed, main as cli_main
from janusgraph_tpu_torch.analysis.imports_check import check_imports
from janusgraph_tpu_torch.analysis.reporting import from_json, to_json

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF_FIXTURES = os.path.join(REPO, "tests", "fixtures", "graphlint")
REF_XMOD = os.path.join(REF_FIXTURES, "xmod_pkg")
FIXTURES = os.path.join(REPO, "tests", "fixtures", "graphlint_torch")
XMOD = os.path.join(FIXTURES, "xmod_capture")

#: the rules re-aimed at CUDA-graph capture; every other rule is the
#: reference's, unchanged in behaviour
REAIMED = {f"JG10{i}" for i in range(1, 9)} | {"JG303"}

_EXPECT_RE = re.compile(r"#\s*expect:\s*([A-Z0-9, ]+)")
_EXPECT_FILE_RE = re.compile(r"#\s*expect-file:\s*([A-Z0-9, ]+)")


def _expectations(path):
    """((line, rule) set, file-level rule set) parsed from fixture markers."""
    per_line, per_file = set(), set()
    with open(path, encoding="utf-8") as f:
        for i, line in enumerate(f, start=1):
            m = _EXPECT_FILE_RE.search(line)
            if m:
                per_file.update(
                    r.strip() for r in m.group(1).split(",") if r.strip()
                )
                continue
            m = _EXPECT_RE.search(line)
            if m:
                for rule in m.group(1).split(","):
                    if rule.strip():
                        per_line.add((i, rule.strip()))
    return per_line, per_file


def _fires_exactly(path, findings, drop=frozenset()):
    per_line, per_file = _expectations(path)
    per_line = {(line, r) for line, r in per_line if r not in drop}
    per_file = per_file - set(drop)
    got_lines = {(f.line, f.rule_id) for f in findings}
    got_rules = {f.rule_id for f in findings}
    missing = per_line - got_lines
    assert not missing, f"expected findings did not fire: {sorted(missing)}"
    for rule in per_file:
        assert rule in got_rules, f"{rule} did not fire anywhere in {path}"
    unexpected = {
        (line, r) for line, r in got_lines
        if (line, r) not in per_line and r not in per_file
    }
    assert not unexpected, f"unexpected findings: {sorted(unexpected)}"


def _rules_of(path):
    per_line, per_file = _expectations(path)
    return {r for _l, r in per_line} | per_file


def _key(findings):
    return [
        (f.rule_id, f.severity, f.line, f.col, f.message)
        for f in findings if f.rule_id not in REAIMED
    ]


# ------------------------------------------------- held to the reference
REF_FILES = sorted(fn for fn in os.listdir(REF_FIXTURES) if fn.startswith("bad_"))
#: the reference fixtures of the rules that stay as they are, and its
#: cross-module package
AGNOSTIC = [
    fn for fn in REF_FILES
    if _rules_of(os.path.join(REF_FIXTURES, fn)) - REAIMED
] + ["suppressed_ok.py", "xmod_pkg"]


@pytest.mark.parametrize("fixture", AGNOSTIC)
def test_stack_agnostic_rules_match_the_reference(fixture):
    from janusgraph_tpu.analysis import analyze_paths as reference

    path = os.path.join(REF_FIXTURES, fixture)
    got = _key(analyze_paths([path]))
    assert got == _key(reference([path]))
    if fixture.endswith(".py"):
        _fires_exactly(path, analyze_paths([path]), drop=REAIMED)


def test_reference_fixtures_are_sorted_into_both_halves():
    """Every reference bad_* fixture is either held to the reference or
    translated into a torch fixture — none is dropped."""
    translated = {
        "bad_trace_donate.py": "bad_trace_rebind.py",
        "bad_trace_retrace.py": "bad_trace_recapture.py",
    }
    for fn in REF_FILES:
        if fn in AGNOSTIC:
            continue
        assert _rules_of(os.path.join(REF_FIXTURES, fn)) <= REAIMED
        assert os.path.exists(os.path.join(FIXTURES, translated.get(fn, fn))), fn


def test_reaimed_rules_see_no_capture_in_jax_code():
    """The reference's JAX fixtures hold no CUDA-graph capture: jit, scan,
    cond, checkpoint and switch are not capture contexts in the port, so
    the re-aimed rules fire only in the one def an explicit
    `# graphlint: traced` marker opts in."""
    got = analyze_paths([REF_FIXTURES])
    assert [
        (os.path.basename(f.path), f.line, f.rule_id)
        for f in got if f.rule_id in REAIMED
    ] == [("bad_trace_marker.py", 9, "JG102")]


def test_jax_call_names_are_ordinary_functions(tmp_path):
    p = tmp_path / "names.py"
    p.write_text(
        "import numpy as np\n\n\n"
        "def body(x):\n"
        "    return np.asarray(x).sum()\n\n\n"
        "def run_all(store, x):\n"
        "    store.scan(body, x)\n"
        "    checkpoint(body)\n"
        "    cond(x, body, body)\n"
        "    switch(x, [body])\n"
        "    jit(body)\n"
    )
    assert analyze_paths([str(p)]) == []


def test_rule_descriptions():
    """JG101–108 and JG303 describe the capture hazard; every other rule
    keeps the reference's description word for word."""
    from janusgraph_tpu.analysis import RULES as REF_RULES

    assert set(RULES) == set(REF_RULES)
    for rid, rule in RULES.items():
        assert rule.severity == REF_RULES[rid].severity
        if rid in REAIMED:
            assert "captur" in rule.summary, rid
            assert "jit" not in rule.summary, rid
        else:
            assert rule.summary == REF_RULES[rid].summary, rid


# ------------------------------------------------------ re-aimed rules
TORCH_FILES = sorted(fn for fn in os.listdir(FIXTURES) if fn.startswith("bad_"))


def test_torch_fixture_inventory_covers_the_reaimed_rules():
    covered = set()
    for fn in TORCH_FILES:
        covered |= _rules_of(os.path.join(FIXTURES, fn))
    for fn in sorted(os.listdir(XMOD)):
        covered |= _rules_of(os.path.join(XMOD, fn))
    assert REAIMED <= covered, f"without fixtures: {sorted(REAIMED - covered)}"
    assert len(TORCH_FILES) == 10


@pytest.mark.parametrize("fixture", TORCH_FILES)
def test_torch_fixture_fires_exactly_where_expected(fixture):
    path = os.path.join(FIXTURES, fixture)
    _fires_exactly(path, analyze_paths([path]))


def test_known_non_findings():
    """The capture ladder's cache fill, a branch on
    is_current_stream_capturing(), an attribute counter, and a captured
    body that reads only .shape and .dtype fire nothing, while the file's
    capture regions are found."""
    path = os.path.join(FIXTURES, "ok_capture_patterns.py")
    analyzer = Analyzer()
    assert analyzer.analyze_paths([path])[0] == []
    assert analyzer.last_stats["traced_defs"] >= 4  # 2 regions, step, launch


def test_capture_contexts_cross_modules():
    """A capture in loop.py reaches an imported helper, every override of
    a method called on an untyped receiver, and a property read — and the
    findings exist only whole-program."""
    findings = analyze_paths([XMOD])
    got = {(os.path.basename(f.path), f.line, f.rule_id) for f in findings}
    want = set()
    for fn in sorted(os.listdir(XMOD)):
        per_line, _pf = _expectations(os.path.join(XMOD, fn))
        want |= {(fn, line, rule) for line, rule in per_line}
    assert want and got == want, (
        f"missing: {sorted(want - got)}; unexpected: {sorted(got - want)}"
    )


@pytest.mark.parametrize("fn", sorted(os.listdir(XMOD)))
def test_cross_module_findings_vanish_module_locally(fn):
    assert analyze_paths([os.path.join(XMOD, fn)]) == []


@pytest.mark.parametrize("fn", [
    "kernels.py", "helpers.py", "registry.py", "wire.py", "racy.py",
    "pump.py",
])
def test_reference_cross_module_findings_vanish_module_locally(fn):
    assert analyze_paths([os.path.join(REF_XMOD, fn)]) == []


def test_capture_reach_names_the_defs_a_capture_runs():
    from janusgraph_tpu_torch.analysis import capture_reach

    cwd = os.getcwd()
    os.chdir(REPO)
    try:
        reach = capture_reach([os.path.relpath(XMOD, REPO)])
    finally:
        os.chdir(cwd)
    rel = os.path.relpath(XMOD, REPO)
    assert set(reach) == {
        f"{rel}/loop.py:Loop.step",
        f"{rel}/helpers.py:scale_rows",
        f"{rel}/programs.py:Program.message",
        f"{rel}/programs.py:Doubling.message",
        f"{rel}/programs.py:Padded.message",
        f"{rel}/view.py:View.degree",
    }


def test_capture_probe_records_entered_defs(tmp_path):
    """CaptureProbe keys match capture_reach's; a generator expression or a
    lambda counts as the def it sits in; code outside the package and
    module-level code are left out."""
    from janusgraph_tpu_torch.analysis.tracing import CaptureProbe

    pkg = tmp_path / "probepkg"
    pkg.mkdir()
    (pkg / "__init__.py").write_text("")
    (pkg / "mod.py").write_text(
        "class K:\n"
        "    def run(self, xs):\n"
        "        return sum(x for x in xs) + (lambda: 1)()\n\n\n"
        "def outer():\n"
        "    def inner():\n"
        "        return 2\n"
        "    return inner()\n"
    )
    sys.path.insert(0, str(tmp_path))
    try:
        from probepkg import mod

        probe = CaptureProbe(str(pkg), cwd=str(tmp_path))
        with probe:
            mod.K().run([1, 2])
            mod.outer()
            json.dumps([1])
    finally:
        sys.path.remove(str(tmp_path))
        sys.modules.pop("probepkg.mod", None)
        sys.modules.pop("probepkg", None)
    assert probe.keys() == {
        "probepkg/mod.py:K.run",
        "probepkg/mod.py:outer",
        "probepkg/mod.py:outer.<locals>.inner",
    }


# ------------------------------------------------ suppression and reports
def test_suppression_comments_silence_findings():
    path = os.path.join(REF_FIXTURES, "suppressed_ok.py")
    assert analyze_paths([path]) == []
    kept, _n = Analyzer().analyze_paths([path], keep_suppressed=True)
    assert {f.rule_id for f in kept} == {"JG301", "JG203"}
    assert all(f.suppressed for f in kept)


def test_capture_rule_suppression(tmp_path):
    p = tmp_path / "mod.py"
    p.write_text(
        "import torch\n\n\n"
        "def body(x):\n"
        "    # graphlint: disable=JG105 -- test\n"
        "    return x.cpu()\n\n\n"
        "def run(x: torch.Tensor):\n"
        "    g = torch.cuda.CUDAGraph()\n"
        "    with torch.cuda.graph(g):\n"
        "        body(x)\n"
        "    return g\n"
    )
    assert analyze_paths([str(p)]) == []
    kept, _n = Analyzer().analyze_paths([str(p)], keep_suppressed=True)
    assert [(f.rule_id, f.line, f.suppressed) for f in kept] == [("JG105", 6, True)]


def test_disable_file_suppresses_whole_file(tmp_path):
    p = tmp_path / "mod.py"
    p.write_text(
        "# graphlint: disable-file=JG301 -- test\n"
        "E_CAP = 3000\nF_MIN = 999\n"
    )
    assert analyze_paths([str(p)]) == []


def test_json_reporter_round_trip(capsys):
    path = os.path.join(REF_FIXTURES, "bad_shape_tier.py")
    rc = cli_main(["--json", path])
    out = capsys.readouterr().out
    assert rc == 1
    data = json.loads(out)
    assert data["tool"] == "graphlint"
    assert data["counts"]["errors"] >= 2
    loaded = from_json(out)
    direct = analyze_paths([path])
    assert [f.to_dict() for f in loaded] == [f.to_dict() for f in direct]
    assert to_json(loaded, data["files_scanned"]) == out.rstrip("\n")


def test_cli_select_and_ignore(capsys):
    path = os.path.join(REF_FIXTURES, "bad_lock_blocking.py")
    assert cli_main(["--select", "JG3", path]) == 0  # JG203 filtered out
    capsys.readouterr()
    assert cli_main(["--ignore", "JG203", path]) == 0
    capsys.readouterr()
    assert cli_main([path]) == 1
    capsys.readouterr()
    hostsync = os.path.join(FIXTURES, "bad_trace_hostsync.py")
    assert cli_main(["--select", "JG105", hostsync]) == 1
    capsys.readouterr()
    assert cli_main(["--ignore", "JG1", hostsync]) == 0


def test_cli_module_entrypoint_subprocess():
    """`python -m janusgraph_tpu_torch.analysis` runs with torch, jax and
    the JAX package unimportable (the analyzer needs none of them; the
    port's package itself imports numpy, not torch)."""
    code = (
        "import sys, runpy\n"
        "for m in ('torch', 'jax', 'janusgraph_tpu'):\n"
        "    sys.modules[m] = None\n"
        "sys.argv = ['graphlint', sys.argv[1]]\n"
        "runpy.run_module('janusgraph_tpu_torch.analysis', run_name='__main__')\n"
    )
    ok = subprocess.run(
        [sys.executable, "-c", code, os.path.join(FIXTURES, "ok_capture_patterns.py")],
        capture_output=True, text=True, cwd=REPO, timeout=300,
    )
    assert ok.returncode == 0, ok.stdout + ok.stderr
    assert "graphlint: 0 error(s)" in ok.stdout
    bad = subprocess.run(
        [sys.executable, "-m", "janusgraph_tpu_torch.analysis",
         os.path.join(FIXTURES, "bad_trace_numpy.py")],
        capture_output=True, text=True, cwd=REPO, timeout=300,
    )
    assert bad.returncode == 1, bad.stdout + bad.stderr
    assert "JG102" in bad.stdout


def test_list_rules(capsys):
    assert cli_main(["--list-rules"]) == 0
    out = capsys.readouterr().out
    assert all(rid in out for rid in RULES)


def test_check_imports_catches_syntax_error(tmp_path):
    pkg = tmp_path / "brokenpkg"
    pkg.mkdir()
    (pkg / "__init__.py").write_text("")
    (pkg / "ok.py").write_text("X = 1\n")
    (pkg / "bad.py").write_text("def broken(:\n")
    findings = check_imports([str(pkg)])
    assert any(f.rule_id == "JG001" and f.path.endswith("bad.py")
               for f in findings)


def test_check_imports_catches_import_error(tmp_path):
    pkg = tmp_path / "imppkg"
    pkg.mkdir()
    (pkg / "__init__.py").write_text("")
    (pkg / "boom.py").write_text("import not_a_real_module_xyz\n")
    findings = check_imports([str(pkg)])
    assert any(f.rule_id == "JG002" and "boom" in f.message
               for f in findings)


def test_changed_only_filter():
    changed = [
        "janusgraph_tpu_torch/olap/kernels.py",
        "janusgraph_tpu/olap/kernels.py",
        "tests/test_torch_graphlint.py",
        "janusgraph_tpu_torch/missing_file.py",
    ]
    cwd = os.getcwd()
    os.chdir(REPO)
    try:
        out = filter_changed(["janusgraph_tpu_torch"], changed)
    finally:
        os.chdir(cwd)
    assert out == ["janusgraph_tpu_torch/olap/kernels.py"]


def test_json_report_byte_identical_across_processes():
    """Determinism: two CLI runs under different hash seeds produce
    byte-identical JSON, over both cross-module packages."""
    for pkg, at_least in ((REF_XMOD, 4), (XMOD, 4)):
        outs = []
        for seed in ("0", "424242"):
            env = dict(os.environ, PYTHONHASHSEED=seed)
            proc = subprocess.run(
                [sys.executable, "-m", "janusgraph_tpu_torch.analysis",
                 "--format", "json", pkg],
                capture_output=True, text=True, cwd=REPO, env=env, timeout=300,
            )
            assert proc.returncode == 1, proc.stdout + proc.stderr
            outs.append(proc.stdout)
        assert outs[0] == outs[1]
        assert json.loads(outs[0])["counts"]["errors"] >= at_least


def test_json_schema_v2_stable_keys(capsys):
    rc = cli_main([
        "--format", "json", os.path.join(FIXTURES, "bad_trace_recapture.py"),
    ])
    out = capsys.readouterr().out
    assert rc == 1
    data = json.loads(out)
    assert data["schema_version"] == 2
    assert data["findings"], "recapture fixture produced no findings"
    for f in data["findings"]:
        assert {"file", "line", "rule", "severity", "col", "message",
                "suppressed"} <= set(f)
        assert f["file"] == f["path"]


def test_handoff_marker_silences_jg402(tmp_path):
    with open(os.path.join(REF_FIXTURES, "bad_thread_ambient.py"),
              encoding="utf-8") as f:
        src = f.read()
    marked = src.replace(
        "return list(pool.map(work, items))",
        "return list(pool.map(work, items))  # graphlint: handoff",
    )
    assert marked != src
    p = tmp_path / "mod.py"
    p.write_text(marked)
    assert analyze_paths([str(p)]) == []


def test_stats_reports_callgraph_and_rule_counts(capsys):
    rc = cli_main([REF_XMOD, "--stats"])
    data = json.loads(capsys.readouterr().out)
    assert rc == 1
    assert data["files_scanned"] == 7
    assert data["callgraph"]["modules"] == 7
    assert data["callgraph"]["functions"] >= 12
    assert data["findings_by_rule"]["JG403"] == 2
    assert data["findings_by_rule"]["JG401"] == 1
    assert data["findings_by_rule"]["JG202"] == 1
    assert data["traced_defs"] == 0  # jit is no capture
    rc = cli_main([XMOD, "--stats"])
    data = json.loads(capsys.readouterr().out)
    assert rc == 1
    assert data["findings_by_rule"] == {"JG101": 2, "JG102": 1, "JG105": 1}
    # the region, step, the helper, three message overrides, the property
    assert data["traced_defs"] == 7


# --------------------------------------------------- suppression ratchet
def test_suppression_baseline_ratchet(tmp_path, capsys):
    from janusgraph_tpu_torch.analysis.baseline import (
        compare, load_baseline, write_baseline,
    )

    path = os.path.join(REF_FIXTURES, "suppressed_ok.py")
    base = str(tmp_path / "base.json")
    assert cli_main([path, "--write-baseline", base]) == 0
    capsys.readouterr()
    budget = load_baseline(base)
    assert set(budget) == {"JG203", "JG301"}
    assert all(n >= 1 for n in budget.values())

    assert cli_main([path, "--baseline", base]) == 0
    capsys.readouterr()
    with open(base, encoding="utf-8") as f:
        first = f.read()
    write_baseline(base, budget)
    with open(base, encoding="utf-8") as f:
        assert f.read() == first

    zero = str(tmp_path / "zero.json")
    write_baseline(zero, {})
    assert cli_main([path, "--baseline", zero]) == 1
    err = capsys.readouterr().err
    assert "suppression ratchet" in err

    regs, imps = compare({"JG203": 2}, {"JG203": 1, "JG110": 3})
    assert regs == [("JG203", 2, 1)]
    assert imps == [("JG110", 0, 3)]


def test_report_suppressions_budget_table(capsys):
    path = os.path.join(REF_FIXTURES, "suppressed_ok.py")
    assert cli_main([path, "--report-suppressions"]) == 0
    out = capsys.readouterr().out
    assert "suppression budget:" in out
    assert "JG203" in out and "JG301" in out


def test_default_baseline_is_the_packages():
    from janusgraph_tpu_torch.analysis.baseline import load_baseline
    from janusgraph_tpu_torch.analysis.cli import default_baseline

    base = default_baseline()
    assert base == os.path.join(REPO, "janusgraph_tpu_torch", "analysis", "baseline.json")
    assert sum(load_baseline(base).values()) > 0


def test_changed_only_uses_merge_base(tmp_path):
    from janusgraph_tpu_torch.analysis.cli import changed_python_files

    def git(*args):
        return subprocess.run(
            ["git", *args], cwd=tmp_path, check=True,
            capture_output=True, text=True,
        ).stdout

    git("init", "-q")
    git("config", "user.email", "t@example.com")
    git("config", "user.name", "t")
    (tmp_path / "a.py").write_text("A = 1\n")
    git("add", "a.py")
    git("commit", "-qm", "base")
    trunk = git("rev-parse", "--abbrev-ref", "HEAD").strip()
    git("checkout", "-qb", "feature")
    (tmp_path / "b.py").write_text("B = 2\n")
    git("add", "b.py")
    git("commit", "-qm", "feature work")
    (tmp_path / "c.py").write_text("C = 3\n")

    files = changed_python_files(str(tmp_path), base_ref=trunk)
    assert files == ["b.py", "c.py"]
    assert "a.py" not in files
