"""JG112/JG113 — background-thread and fan-out queue discipline.

JG112 — background-thread run loops must record their own death.

A daemon thread running a loop (``while not stop.wait(...)``) is the
process's most failure-prone shape: an exception anywhere in the loop
body unwinds the target function and the thread exits — silently. The
interpreter prints nothing for daemon threads, no metric moves, and
every consumer of the thread's output (the metrics-history ring, the
sampling profiler's flame windows, a CDC puller's cursor) simply stops
advancing while dashboards keep rendering the stale tail. A
silently-dead sampler is a LYING profiler — the continuous-profiling
plane (observability/continuous.py) exists to catch exactly this class
of wedge at runtime, and this rule is its static twin: the run loop
must catch broad exceptions and RECORD them (a flight event, a log
call, a counter — anything observable) before dying or continuing.

Flagged, for every function used as a ``threading.Thread(target=...,
daemon=True)`` target that contains a ``while`` loop (the long-running
run-loop shape; a ``for`` over a finite work list is a fork-join pump
whose lifetime is bounded by its input, not a forever-loop):

- the ``def`` line, when the function has NO broad except handler at
  all (bare ``except:``, ``except Exception``, or ``except
  BaseException``, including tuples) — the first exception kills the
  thread with no record;
- each broad handler whose body does literally nothing (only ``pass`` /
  ``continue`` / ``break`` / a bare constant) — the failure is
  swallowed unrecorded, which hides both one-off deaths and a
  continuously-failing loop burning CPU forever.

A handler that calls ANYTHING (``flight_recorder.record(...)``,
``logger.warning(...)``, ``counter.inc()``, a sink callable), raises,
or stores the error for later surfacing (``self._error = e``) passes:
the rule demands observability, not a particular vocabulary — choosing
a meaningful record is the author's job, having one is the contract.

Resolution is module-local and name-based: ``target=_loop`` matches any
``def _loop`` in the module (including the common closure-in-``start()``
idiom), ``target=self._run`` matches a method ``def _run``. Targets the
module does not define (``serve_forever`` on an stdlib server) are out
of scope. Joined worker pools (no ``daemon=True``) are exempt — their
exceptions are the spawner's problem at ``join()`` time, and flagging
them would punish fork-join parallelism.

JG113 — fan-out publish must have a drop/accounting path.

The telemetry bus's publish shape — ``for sub in subscribers:
sub.queue.put(event)`` — is a convoy waiting to happen: ``Queue.put()``
blocks when the queue is full, so ONE wedged consumer stalls the
publish loop, which stalls every OTHER subscriber's delivery, which
stalls the PRODUCER that called publish (a flight-recorder ``record()``
or a history sampler tick). The runtime symptom is the lock-convoy
wedge the stall watchdog hunts; this rule is the static twin for the
queue-fan-out variant.

Flagged, for every ``.put(...)`` / ``.put_nowait(...)`` call lexically
inside a ``for`` loop (the fan-out shape — one producer iterating
consumers):

- blocking ``.put(...)`` (no ``block=False`` and no ``timeout=``) —
  unconditionally: an unbounded wait inside a fan-out loop convoys the
  remaining subscribers behind the slowest one;
- ``.put_nowait(...)`` / ``.put(..., block=False)`` NOT guarded by a
  ``try`` whose handler catches ``Full`` (or ``queue.Full``, or a
  broad except) with an observable body (the JG112 vocabulary: a call,
  a raise, an assignment — a ``dropped`` counter is the canonical
  choice): an uncaught ``Full`` unwinds the publish loop mid-fan-out
  (later subscribers silently miss the event), and a swallowed one
  hides the drop the accounting contract exists to surface.

A bounded ``.put(..., timeout=...)`` passes the convoy check (the wait
is priced) but still needs the ``Full`` handler — the timeout's whole
point is that it CAN expire. Drop-oldest designs (popleft-then-append
under the consumer lock, observability/stream.py) never block and
never raise, so they are invisible to this rule by construction.
"""

from __future__ import annotations

import ast
from typing import Dict, List

from janusgraph_tpu_torch.analysis.core import RULES, Finding

_BROAD = {"Exception", "BaseException"}


def _scope_nodes(scope) -> List[ast.AST]:
    """All nodes in ``scope`` without descending into nested function /
    class definitions (their loops and handlers are their own story)."""
    out: List[ast.AST] = []
    stack = list(ast.iter_child_nodes(scope))
    while stack:
        node = stack.pop()
        out.append(node)
        if isinstance(
            node,
            (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda, ast.ClassDef),
        ):
            continue
        stack.extend(ast.iter_child_nodes(node))
    return out


def _is_broad_handler(handler: ast.ExceptHandler) -> bool:
    t = handler.type
    if t is None:
        return True
    if isinstance(t, ast.Name) and t.id in _BROAD:
        return True
    if isinstance(t, ast.Tuple):
        return any(
            isinstance(e, ast.Name) and e.id in _BROAD for e in t.elts
        )
    return False


def _handler_does_nothing(handler: ast.ExceptHandler) -> bool:
    """True when the handler body is only pass/continue/break/constant —
    no call, no raise, no assignment: nothing observable survives."""
    for stmt in handler.body:
        if isinstance(stmt, (ast.Pass, ast.Continue, ast.Break)):
            continue
        if isinstance(stmt, ast.Expr) and isinstance(
            stmt.value, ast.Constant
        ):
            continue
        return False
    return True


def _thread_call_target(node: ast.Call):
    """The ``target=`` expression of a ``Thread(..., daemon=True)``
    call, or None when this is not a daemon-thread construction."""
    fn = node.func
    named_thread = (
        isinstance(fn, ast.Name) and fn.id == "Thread"
    ) or (
        isinstance(fn, ast.Attribute) and fn.attr == "Thread"
    )
    if not named_thread:
        return None
    target = None
    daemon = False
    for kw in node.keywords:
        if kw.arg == "target":
            target = kw.value
        elif kw.arg == "daemon" and isinstance(kw.value, ast.Constant):
            daemon = bool(kw.value.value)
    return target if daemon else None


def _target_names(expr) -> List[str]:
    """Local def names a target expression can resolve to."""
    if isinstance(expr, ast.Name):
        return [expr.id]
    if (
        isinstance(expr, ast.Attribute)
        and isinstance(expr.value, ast.Name)
        and expr.value.id == "self"
    ):
        return [expr.attr]
    return []


def _catches_full(handler: ast.ExceptHandler) -> bool:
    """True when the handler would catch ``queue.Full`` — an explicit
    ``Full`` / ``queue.Full`` (possibly in a tuple) or a broad except."""
    if _is_broad_handler(handler):
        return True
    t = handler.type

    def _is_full(e) -> bool:
        if isinstance(e, ast.Name) and e.id == "Full":
            return True
        return isinstance(e, ast.Attribute) and e.attr == "Full"

    if t is None:
        return True
    if _is_full(t):
        return True
    if isinstance(t, ast.Tuple):
        return any(_is_full(e) for e in t.elts)
    return False


def _put_is_blocking(call: ast.Call) -> bool:
    """True when a ``.put(...)`` call can block indefinitely: no
    ``block=False`` (keyword or second positional) and no ``timeout=``."""
    if len(call.args) >= 2:
        blk = call.args[1]
        if isinstance(blk, ast.Constant) and blk.value is False:
            return False
    if len(call.args) >= 3:
        # put(item, block, timeout) — a timeout bounds the wait
        return False
    for kw in call.keywords:
        if (
            kw.arg == "block"
            and isinstance(kw.value, ast.Constant)
            and kw.value.value is False
        ):
            return False
        if kw.arg == "timeout":
            return False
    return True


def _fanout_puts(loop: ast.For):
    """Yield ``(call, guarded)`` for every ``.put`` / ``.put_nowait``
    call lexically inside ``loop``, where ``guarded`` means an enclosing
    ``try`` catches ``Full`` with an observable handler body. Does not
    descend into nested defs/lambdas/classes (their fan-outs are their
    own story, found via their own enclosing loops)."""

    def visit(node: ast.AST, guarded: bool):
        if isinstance(
            node,
            (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda, ast.ClassDef),
        ):
            return
        if isinstance(node, ast.Try):
            inner = guarded or any(
                _catches_full(h) and not _handler_does_nothing(h)
                for h in node.handlers
            )
            for stmt in node.body:
                yield from visit(stmt, inner)
            # handler/else/finally bodies sit OUTSIDE the try's guard
            for h in node.handlers:
                for stmt in h.body:
                    yield from visit(stmt, guarded)
            for stmt in node.orelse + node.finalbody:
                yield from visit(stmt, guarded)
            return
        if (
            isinstance(node, ast.Call)
            and isinstance(node.func, ast.Attribute)
            and node.func.attr in ("put", "put_nowait")
        ):
            yield node, guarded
        for child in ast.iter_child_nodes(node):
            yield from visit(child, guarded)

    for child in ast.iter_child_nodes(loop):
        yield from visit(child, False)


def _check_fanout_queues(mod) -> List[Finding]:
    """JG113: blocking or unaccounted queue puts inside fan-out loops."""
    findings: List[Finding] = []
    if ".put" not in mod.source:
        return findings
    reported = set()
    for node in ast.walk(mod.tree):
        if not isinstance(node, ast.For):
            continue
        for call, guarded in _fanout_puts(node):
            if id(call) in reported:
                # nested loops walk the same call twice; one finding
                reported.add(id(call))
                continue
            reported.add(id(call))
            method = call.func.attr
            if method == "put" and _put_is_blocking(call):
                findings.append(
                    Finding(
                        "JG113", RULES["JG113"].severity, mod.path,
                        call.lineno, call.col_offset,
                        "blocking put() inside a fan-out loop: one full "
                        "subscriber queue convoys every later subscriber "
                        "AND the producer — use put_nowait() (or "
                        "block=False) and account the Full as a drop",
                    )
                )
            elif not guarded:
                findings.append(
                    Finding(
                        "JG113", RULES["JG113"].severity, mod.path,
                        call.lineno, call.col_offset,
                        f"{method}() inside a fan-out loop without an "
                        f"accounted Full path: an uncaught queue.Full "
                        f"unwinds the loop mid-fan-out and later "
                        f"subscribers silently miss the event — catch "
                        f"Full and record the drop (a dropped counter / "
                        f"flight event)",
                    )
                )
    return findings


def check_module(mod) -> List[Finding]:
    findings: List[Finding] = []
    findings.extend(_check_fanout_queues(mod))
    # text pre-gate: no thread construction, no JG112 work
    if "Thread(" not in mod.source:
        return findings

    # every def in the module (module-level, methods, closures) by name —
    # the closure-in-start() idiom means targets are often nested defs
    defs: Dict[str, List[ast.AST]] = {}
    for node in ast.walk(mod.tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            defs.setdefault(node.name, []).append(node)

    targeted: List[ast.AST] = []
    seen = set()
    for node in ast.walk(mod.tree):
        if not isinstance(node, ast.Call):
            continue
        target = _thread_call_target(node)
        if target is None:
            continue
        for name in _target_names(target):
            for fn in defs.get(name, []):
                if id(fn) not in seen:
                    seen.add(id(fn))
                    targeted.append(fn)

    for fn in targeted:
        scope = _scope_nodes(fn)
        has_loop = any(isinstance(n, ast.While) for n in scope)
        if not has_loop:
            continue
        broad = [
            n
            for n in scope
            if isinstance(n, ast.ExceptHandler) and _is_broad_handler(n)
        ]
        if not broad:
            findings.append(
                Finding(
                    "JG112", RULES["JG112"].severity, mod.path,
                    fn.lineno, fn.col_offset,
                    f"thread run loop {fn.name!r} has no broad except: "
                    f"the first exception kills the thread silently — "
                    f"wrap the loop body and record the failure (flight "
                    f"event / log / counter) before the thread dies",
                )
            )
            continue
        for handler in broad:
            if _handler_does_nothing(handler):
                findings.append(
                    Finding(
                        "JG112", RULES["JG112"].severity, mod.path,
                        handler.lineno, handler.col_offset,
                        f"broad except in thread run loop {fn.name!r} "
                        f"swallows the failure unrecorded (body is only "
                        f"pass/continue) — record it (flight event / "
                        f"log / counter) so a dead or flailing loop is "
                        f"observable",
                    )
                )
    return findings
