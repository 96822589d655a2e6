"""`--check-imports`: py_compile + import sweep.

Rarely-tested modules (`server/`, `driver/`) historically only failed at
runtime: a syntax error or circular import sat undetected until a server
actually started. This sweep (a) compiles every file (JG001) and (b)
imports every module of the target package in sorted order (JG002), so
those failures surface in tier-1 instead of in production.
"""

from __future__ import annotations

import importlib
import os
import sys
import traceback
from typing import List, Optional, Tuple

from janusgraph_tpu_torch.analysis.core import Finding, RULES


def _module_name_for(abspath: str) -> Optional[Tuple[str, str]]:
    """(module_name, sys.path root) for a file inside a package tree, by
    walking up while __init__.py exists."""
    d, fn = os.path.split(os.path.abspath(abspath))
    if not fn.endswith(".py"):
        return None
    parts = [] if fn == "__init__.py" else [fn[:-3]]
    while os.path.isfile(os.path.join(d, "__init__.py")):
        d, base = os.path.split(d)
        parts.insert(0, base)
    if not parts:
        return None
    return ".".join(parts), d


def check_imports(paths, display_of=None) -> List[Finding]:
    """py_compile + import every module under `paths` (files or dirs).

    `display_of`: optional {abspath: display path} mapping for reporting.
    """
    from janusgraph_tpu_torch.analysis.core import discover_files

    findings: List[Finding] = []
    display_of = display_of or {}
    pairs = discover_files(list(paths))
    roots = set()
    modules = []
    for ap, disp in pairs:
        disp = display_of.get(ap, disp)
        try:
            with open(ap, "rb") as f:
                compile(f.read(), ap, "exec")  # py_compile minus the .pyc
        except SyntaxError as e:
            findings.append(Finding(
                "JG001", RULES["JG001"].severity, disp, e.lineno or 1, 0,
                f"does not compile: {e.msg}",
            ))
            continue
        except (OSError, ValueError) as e:
            findings.append(Finding(
                "JG001", RULES["JG001"].severity, disp, 1, 0,
                f"unreadable: {e}",
            ))
            continue
        named = _module_name_for(ap)
        if named is not None:
            modules.append((named[0], disp))
            roots.add(named[1])

    inserted = []
    for root in roots:
        if root not in sys.path:
            sys.path.insert(0, root)
            inserted.append(root)
    try:
        for modname, disp in sorted(set(modules)):
            try:
                importlib.import_module(modname)
            except Exception as e:  # noqa: BLE001 - any import failure counts
                tb = traceback.format_exception_only(type(e), e)[-1].strip()
                findings.append(Finding(
                    "JG002", RULES["JG002"].severity, disp, 1, 0,
                    f"import of `{modname}` failed: {tb}",
                ))
    finally:
        for root in inserted:
            try:
                sys.path.remove(root)
            except ValueError:
                pass
    return findings
