"""JG305 — non-atomic checkpoint/manifest writes.

Every durability file in the tree — single-file checkpoints
(olap/checkpoint.py), sharded slices + manifests
(olap/sharded_checkpoint.py), persisted autotune records
(olap/autotune.save_measured) — commits through the same discipline:
write a ``tempfile.mkstemp`` sibling, demote the previous file to
``.prev``, then ``os.replace`` the tmp onto the committed name. The whole
torn-write recovery story (``.prev`` fallback per slice and per manifest;
a crash costs one interval) rests on the committed name NEVER holding a
partially written file.

``open(path, "w")`` on a checkpoint-suffixed path breaks that invariant
silently: the code works until the first crash mid-write, and then the
loss lands exactly where the recovery machinery expects integrity. This
rule flags any builtin ``open`` call in a write mode ("w"/"a"/"x"/"+")
whose path expression mentions a checkpoint-ish name — an identifier or
string literal containing ``checkpoint``, ``manifest``, or ``.ckpt`` —
or a CDC log path: ``-segment`` / ``.segment`` / ``.cdc``
names, which carry the same digest-embedded tmp+rename contract
(storage/cdc.py; a torn sealed segment would silently break replay).

The atomic idiom passes by construction: ``mkstemp`` returns an fd (no
path-taking ``open``), and intermediate names in the tmp+rename dance are
conventionally ``tmp``-named. Protocol boundaries that genuinely must
stream to the committed name (none in this tree today) should carry a
justified ``# graphlint: disable=JG305 -- why`` suppression.
"""

from __future__ import annotations

import ast
import re
from typing import List, Optional

from janusgraph_tpu_torch.analysis.core import Finding, RULES

_CKPT_NAME_RE = re.compile(
    r"checkpoint|manifest|\.ckpt|-segment|\.segment|\.cdc",
    re.IGNORECASE,
)
#: the tmp+rename idiom names its intermediate file; a path expression
#: that is explicitly a temp sibling is the ATOMIC discipline, not a
#: violation of it
_TMP_NAME_RE = re.compile(r"(^|_)tmp|temp(_|$)|\.tmp", re.IGNORECASE)

_WRITE_MODE_RE = re.compile(r"[wax+]")


def _mentions(node: ast.AST, pattern: re.Pattern) -> bool:
    for sub in ast.walk(node):
        if isinstance(sub, ast.Name) and pattern.search(sub.id):
            return True
        if isinstance(sub, ast.Attribute) and pattern.search(sub.attr):
            return True
        if isinstance(sub, ast.Constant) and isinstance(sub.value, str) and (
            pattern.search(sub.value)
        ):
            return True
    return False


def _write_mode(call: ast.Call) -> Optional[str]:
    """The mode string when it is a literal naming a write mode."""
    mode = None
    if len(call.args) >= 2:
        mode = call.args[1]
    for kw in call.keywords:
        if kw.arg == "mode":
            mode = kw.value
    if mode is None:
        return None  # bare open(path) reads — harmless
    if isinstance(mode, ast.Constant) and isinstance(mode.value, str):
        return mode.value if _WRITE_MODE_RE.search(mode.value) else None
    return None


def check_module(mod) -> List[Finding]:
    findings: List[Finding] = []
    for node in ast.walk(mod.tree):
        if not isinstance(node, ast.Call):
            continue
        fn = node.func
        is_open = (isinstance(fn, ast.Name) and fn.id == "open") or (
            isinstance(fn, ast.Attribute) and fn.attr == "open"
            and isinstance(fn.value, ast.Name) and fn.value.id == "io"
        )
        if not is_open or not node.args:
            continue
        mode = _write_mode(node)
        if mode is None:
            continue
        path_expr = node.args[0]
        if not _mentions(path_expr, _CKPT_NAME_RE):
            continue
        if _mentions(path_expr, _TMP_NAME_RE):
            continue
        findings.append(Finding(
            "JG305", RULES["JG305"].severity, mod.path,
            node.lineno, node.col_offset,
            f"open(..., {mode!r}) writes directly to a checkpoint/"
            "manifest/CDC-segment path — durability files must commit "
            "via tmp + rename "
            "(tempfile.mkstemp + os.replace with a .prev demotion), or a "
            "crash mid-write leaves a torn file at the committed name",
        ))
    return findings
