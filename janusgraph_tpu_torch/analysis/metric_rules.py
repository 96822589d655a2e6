"""JG110/JG111 — metric-plane hygiene rules.

JG110 — metric/series names built from non-literal parts.

The telemetry registry (observability/metrics_core.py) never evicts: a
metric name, once created, lives for the process. A name built with an
f-string interpolation or ``+`` concatenation over a NON-LITERAL part
(``f"query.{digest}"``, ``"latency." + user_key``) therefore turns any
unbounded value domain into unbounded registry growth — memory that
never comes back, ``/metrics`` exposition that grows without bound, and
a history ring (observability/timeseries.py) whose every window pays for
every name ever seen. This is the classic label-cardinality explosion,
enforced at the construction site.

Bounded derived names are legitimate and carry a justified
``# graphlint: disable=JG110 -- why`` suppression: query digests (the
top-K-evicted price book bounds them — metrics.digest-top-k), breaker /
store / fault-kind / shed-reason names (small declared sets), per-
connection indices (bounded by the pool size). The suppression's WHY
must name the bound.

Flagged: calls to ``counter`` / ``timer`` / ``histogram`` / ``gauge`` /
``set_gauge`` whose name argument is an f-string containing a
non-constant interpolation, or a ``+`` concatenation with a non-constant
operand (recursively). A name passed through a bare variable is NOT
flagged — the rule targets the construction idiom itself, and
taint-tracking every string variable would drown the signal in noise.

JG111 — ``time.time()`` subtraction used as a duration.

The wall clock is not monotonic: NTP slews and steps it, and a leap or
DST correction can move it backwards mid-measurement. A duration
computed as a wall-clock delta can therefore go negative or jump by
seconds — and a negative "latency" fed into a histogram, a backoff
computation, or an SLO window silently corrupts the statistic. Duration
and interval math must use ``time.monotonic()`` (or ``perf_counter``).

Flagged: any ``-`` expression where an operand is a direct
``time.time()`` call, or a name assigned from ``time.time()`` in the
same function (or module) scope. Wall stamps subtracted for EVENT
STAMPING or cross-process offset math (clock-skew estimation, trace-axis
placement — observability/federation.py is the canonical case) are
legitimate and exempt via a ``# graphlint: wallclock -- why`` marker on
the line (or a comment line directly above).
"""

from __future__ import annotations

import ast
from typing import List

from janusgraph_tpu_torch.analysis.core import RULES, Finding

#: registry accessor methods whose FIRST argument is a metric name
_METRIC_METHODS = {"counter", "timer", "histogram", "gauge", "set_gauge"}


def _dynamic_name_expr(node) -> bool:
    """True when this expression BUILDS a string from non-literal parts:
    an f-string with a real interpolation, or a ``+`` chain with any
    non-constant operand."""
    if isinstance(node, ast.JoinedStr):
        return any(
            isinstance(v, ast.FormattedValue)
            and not isinstance(v.value, ast.Constant)
            for v in node.values
        )
    if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Add):
        return _nonliteral_part(node.left) or _nonliteral_part(node.right)
    return False


def _nonliteral_part(node) -> bool:
    """A ``+`` operand that is not (recursively) constant-string."""
    if isinstance(node, ast.Constant):
        return False
    if isinstance(node, ast.JoinedStr):
        return _dynamic_name_expr(node)
    if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Add):
        return _nonliteral_part(node.left) or _nonliteral_part(node.right)
    return True


def _is_walltime_call(node) -> bool:
    """A direct ``time.time()`` call expression."""
    return (
        isinstance(node, ast.Call)
        and not node.args and not node.keywords
        and isinstance(node.func, ast.Attribute)
        and node.func.attr == "time"
        and isinstance(node.func.value, ast.Name)
        and node.func.value.id == "time"
    )


def _scope_nodes(scope):
    """Walk one lexical scope WITHOUT descending into nested function
    scopes (a nested def is its own scope with its own name bindings)."""
    stack = list(ast.iter_child_nodes(scope))
    while stack:
        node = stack.pop()
        yield node
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            continue
        stack.extend(ast.iter_child_nodes(node))


def _walltime_duration_findings(mod) -> List[Finding]:
    """JG111: per lexical scope, collect names bound to ``time.time()``
    and flag every subtraction with a wall-clock operand, unless the
    line carries a ``# graphlint: wallclock`` marker."""
    findings: List[Finding] = []
    if "time.time" not in mod.source:
        # Cheap text gate: the rule only ever fires on modules that call
        # time.time(), and the per-scope double walk below is the most
        # expensive part of this pass — skip it for the common case.
        return findings
    exempt = mod.suppressions.wallclock_lines
    for scope in ast.walk(mod.tree):
        if not isinstance(scope, (ast.Module, ast.FunctionDef,
                                  ast.AsyncFunctionDef)):
            continue
        wall_names = set()
        for node in _scope_nodes(scope):
            if isinstance(node, ast.Assign) and _is_walltime_call(
                node.value
            ):
                for target in node.targets:
                    if isinstance(target, ast.Name):
                        wall_names.add(target.id)
        for node in _scope_nodes(scope):
            if not (
                isinstance(node, ast.BinOp)
                and isinstance(node.op, ast.Sub)
            ):
                continue
            operands = (node.left, node.right)
            if not any(
                _is_walltime_call(o)
                or (isinstance(o, ast.Name) and o.id in wall_names)
                for o in operands
            ):
                continue
            if node.lineno in exempt:
                continue
            findings.append(Finding(
                "JG111", RULES["JG111"].severity, mod.path,
                node.lineno, node.col_offset,
                "time.time() subtraction used as a duration: the wall "
                "clock steps under NTP, so this delta can go negative "
                "or jump — use time.monotonic()/perf_counter for "
                "interval math, or mark event-stamp/offset math with "
                "`# graphlint: wallclock -- why`",
            ))
    return findings


def check_module(mod) -> List[Finding]:
    findings: List[Finding] = []
    findings.extend(_walltime_duration_findings(mod))
    for node in ast.walk(mod.tree):
        if not isinstance(node, ast.Call) or not node.args:
            continue
        if not isinstance(node.func, ast.Attribute):
            continue
        if node.func.attr not in _METRIC_METHODS:
            continue
        # receiver-agnostic on purpose: the method-name set is specific
        # enough, and registry handles travel under many local names
        name_arg = node.args[0]
        if _dynamic_name_expr(name_arg):
            # anchor at the CALL, so a suppression comment directly above
            # the call line covers multi-line argument layouts too
            findings.append(Finding(
                "JG110", RULES["JG110"].severity, mod.path,
                node.lineno, node.col_offset,
                f"metric name passed to .{node.func.attr}() is built "
                "from non-literal parts (f-string interpolation or + "
                "concatenation): the registry never evicts, so an "
                "unbounded value domain here is unbounded memory and "
                "exposition growth — use a literal name, or suppress "
                "with the bound that makes the label set finite "
                "(e.g. the top-K-evicted digest table)",
            ))
    return findings
