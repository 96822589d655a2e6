"""graphlint CLI: `python -m janusgraph_tpu_torch.analysis [paths ...]`.

Exit codes: 0 clean, 1 error findings (or warnings with --strict), 2 usage
error. Stdlib-only — never imports torch/numpy, so it is safe in any hook.
With no paths it lints the janusgraph_tpu_torch package against the
package's own suppression budget (``analysis/baseline.json``) unless
``--baseline`` names another.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
from typing import List, Optional, Sequence

from janusgraph_tpu_torch.analysis.baseline import (
    compare,
    load_baseline,
    report_table,
    write_baseline,
)
from janusgraph_tpu_torch.analysis.core import Analyzer
from janusgraph_tpu_torch.analysis.reporting import (
    list_rules_text,
    summarize,
    to_json,
    to_text,
)


def _default_target() -> str:
    """The janusgraph_tpu_torch package directory itself."""
    return os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def default_baseline() -> str:
    """The package's banked suppression budget (``analysis/baseline.json``)."""
    return os.path.join(os.path.dirname(os.path.abspath(__file__)), "baseline.json")


def _git(args: List[str], repo_root: Optional[str]) -> Optional[str]:
    try:
        proc = subprocess.run(
            ["git"] + args, cwd=repo_root or os.getcwd(),
            capture_output=True, text=True, timeout=30,
        )
    except (OSError, subprocess.SubprocessError):
        return None
    return proc.stdout if proc.returncode == 0 else None


def merge_base(
    repo_root: Optional[str] = None, base_ref: Optional[str] = None
) -> Optional[str]:
    """The merge-base commit against the mainline (explicit ``base_ref``,
    else the first of origin/main, origin/master, main, master that
    resolves). None when git or the ref is unavailable."""
    candidates = (
        [base_ref] if base_ref
        else ["origin/main", "origin/master", "main", "master"]
    )
    for ref in candidates:
        out = _git(["merge-base", "HEAD", ref], repo_root)
        if out and out.strip():
            return out.strip()
    return None


def changed_python_files(
    repo_root: Optional[str] = None, base_ref: Optional[str] = None
) -> Optional[List[str]]:
    """The .py files a review would see as changed: everything different
    from the merge-base with the mainline (the branch's own commits) PLUS
    staged/unstaged/untracked work. None when git is unavailable (caller
    falls back to a full run). Deleted files are excluded — there is
    nothing left to lint."""
    # -uall: list files inside untracked directories individually
    status = _git(["status", "--porcelain", "-uall"], repo_root)
    if status is None:
        return None
    files = set()
    for line in status.splitlines():
        if len(line) < 4:
            continue
        path = line[3:].strip()
        if " -> " in path:  # rename: lint the new side
            path = path.split(" -> ", 1)[1]
        path = path.strip('"')
        if path.endswith(".py") and line[:2].strip() != "D":
            files.add(path)
    base = merge_base(repo_root, base_ref)
    if base is not None:
        diff = _git(
            ["diff", "--name-only", "--diff-filter=d", base, "HEAD"],
            repo_root,
        )
        for path in (diff or "").splitlines():
            path = path.strip().strip('"')
            if path.endswith(".py"):
                files.add(path)
    return sorted(files)


def filter_changed(paths: Sequence[str], changed: Sequence[str]) -> List[str]:
    """Changed files that fall under any of the requested paths."""
    roots = [os.path.abspath(p) for p in paths]
    out = []
    for c in changed:
        ac = os.path.abspath(c)
        if not os.path.exists(ac):
            continue
        for r in roots:
            if ac == r or ac.startswith(r.rstrip(os.sep) + os.sep):
                out.append(c)
                break
    return sorted(set(out))


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m janusgraph_tpu_torch.analysis",
        description="graphlint: capture-safety, lock-discipline, and "
        "padding-invariant analysis for janusgraph_tpu_torch",
    )
    p.add_argument(
        "paths", nargs="*",
        help="files/directories to analyze (default: the "
        "janusgraph_tpu_torch package, under its baseline.json)",
    )
    p.add_argument(
        "--json", action="store_true",
        help="JSON report on stdout (alias for --format json)",
    )
    p.add_argument(
        "--format", choices=("text", "json"), default=None,
        help="report format (default text); json carries the stable "
        "file/line/rule/severity keys (schema v2)",
    )
    p.add_argument(
        "--check-imports", action="store_true",
        help="also py_compile every file and import every package module "
        "(catches syntax errors and circular imports in rarely-run "
        "modules)",
    )
    p.add_argument(
        "--changed-only", action="store_true",
        help="only lint .py files changed vs the mainline merge-base "
        "plus uncommitted work (the incremental edit loop)",
    )
    p.add_argument(
        "--diff-base", default=None, metavar="REF",
        help="mainline ref for --changed-only's merge-base (default: "
        "origin/main, falling back to origin/master/main/master)",
    )
    p.add_argument(
        "--baseline", default=None, metavar="PATH",
        help="suppression-ratchet CI mode: fail if any rule's "
        "suppression count exceeds the budget recorded in PATH (default "
        "with no paths: the package's analysis/baseline.json)",
    )
    p.add_argument(
        "--write-baseline", default=None, metavar="PATH",
        help="record current per-rule suppression counts to PATH "
        "(bank the ratchet)",
    )
    p.add_argument(
        "--report-suppressions", action="store_true",
        help="print the per-rule suppression budget table",
    )
    p.add_argument(
        "--stats", action="store_true",
        help="emit a JSON stats report (per-rule finding/suppression "
        "counts, call-graph size) instead of the findings listing",
    )
    p.add_argument(
        "--select", default=None,
        help="comma-separated rule-id prefixes to enable (e.g. JG1,JG203)",
    )
    p.add_argument(
        "--ignore", default=None,
        help="comma-separated rule-id prefixes to disable",
    )
    p.add_argument(
        "--strict", action="store_true",
        help="exit nonzero on warnings too",
    )
    p.add_argument(
        "--show-suppressed", action="store_true",
        help="include suppressed findings (marked) in the report",
    )
    p.add_argument("--list-rules", action="store_true")
    return p


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    if args.list_rules:
        print(list_rules_text())
        return 0

    paths = list(args.paths) or [_default_target()]
    if not args.paths and args.baseline is None and not args.write_baseline:
        args.baseline = default_baseline()
    for p in paths:
        if not os.path.exists(p):
            print(f"graphlint: path does not exist: {p}", file=sys.stderr)
            return 2

    if args.changed_only:
        changed = changed_python_files(base_ref=args.diff_base)
        if changed is None:
            print(
                "graphlint: --changed-only needs git; running full scan",
                file=sys.stderr,
            )
        else:
            paths = filter_changed(paths, changed)
            if not paths:
                print("graphlint: no changed python files under the "
                      "requested paths")
                return 0

    analyzer = Analyzer(
        select=args.select.split(",") if args.select else None,
        ignore=args.ignore.split(",") if args.ignore else None,
    )
    findings, files_scanned = analyzer.analyze_paths(
        paths, keep_suppressed=args.show_suppressed
    )
    if args.check_imports:
        from janusgraph_tpu_torch.analysis.imports_check import check_imports

        findings.extend(check_imports(paths))
        findings.sort(key=lambda f: f.sort_key())

    stats = analyzer.last_stats or {}
    suppressions = dict(stats.get("suppressions_by_rule", {}))

    if args.stats:
        import json as _json

        print(_json.dumps(stats, indent=2, sort_keys=True))
    elif args.json or args.format == "json":
        print(to_json(findings, files_scanned))
    else:
        print(to_text(findings, files_scanned))

    rc = 0
    counts = summarize(findings)
    if counts["errors"]:
        rc = 1
    if args.strict and counts["warnings"]:
        rc = 1

    budget = None
    if args.baseline:
        try:
            budget = load_baseline(args.baseline)
        except (OSError, ValueError, KeyError) as e:
            print(f"graphlint: cannot read baseline: {e}", file=sys.stderr)
            return 2
        regressions, improvements = compare(suppressions, budget)
        for rule, used, allowed in regressions:
            print(
                f"graphlint: suppression ratchet: {rule} has {used} "
                f"suppression(s), budget is {allowed} — fix the finding "
                "or re-bank with --write-baseline",
                file=sys.stderr,
            )
        if improvements and not regressions:
            freed = sum(a - u for _r, u, a in improvements)
            print(
                f"graphlint: suppression budget has {freed} unused "
                "slot(s); tighten with --write-baseline",
                file=sys.stderr,
            )
        if regressions:
            rc = max(rc, 1)

    if args.report_suppressions:
        print(report_table(suppressions, budget))

    if args.write_baseline:
        write_baseline(args.write_baseline, suppressions)
        print(
            f"graphlint: wrote baseline ({sum(suppressions.values())} "
            f"suppression(s)) to {args.write_baseline}",
            file=sys.stderr,
        )

    return rc


if __name__ == "__main__":  # pragma: no cover
    sys.exit(main())
