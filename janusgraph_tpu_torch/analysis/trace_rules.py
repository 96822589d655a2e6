"""JG1xx capture-safety rules for the port's CUDA-graph paths.

A capture context (``tracing.py``) is the body of a ``with
torch.cuda.graph(...)`` block, a callable given to
``make_graphed_callables``, a def marked ``# graphlint: traced``, and
everything they call. Its host code runs once, at capture; a replay runs
only the kernels it recorded.

JG101  Python coercion (`float()/int()/bool()`) of, or `if`/`while`/`assert`
       branching on, a tensor inside a capture context: a device-to-host
       sync. Under ``set_sync_debug_mode("error")`` the capture raises;
       without it the capture stalls and the branch taken at capture is
       frozen into every replay.
JG102  numpy call inside a capture context: it runs once, at capture, and
       its result is a constant of every replay (``# graphlint: host`` on a
       helper that builds cached constants on purpose stops propagation).
JG103  recapture hazards: a graph captured and not kept (a fresh
       ``CUDAGraph()`` that never leaves its def, a discarded capture
       result), a capture result kept under a key that is neither a
       constant nor the loop variable of the loop that fills the cache
       (the power-of-two ladder ``graphs[size] = capture(size)`` is a cache
       fill), and a capture inside a loop body kept under one name (every
       iteration recaptures).
JG104  rebinding a captured tensor: a ``self`` attribute bound to a tensor
       and read by a captured body, rebound (``self.x = new``) anywhere but
       ``__init__``. The graph recorded the old storage's address; every
       replay keeps reading it. Write in place (``copy_``/``fill_``).
JG105  host sync in a capture context: `.item()`/`.tolist()` on a tensor,
       `.cpu()`, `.numpy()`, `.to("cpu")`, `torch.cuda.synchronize()`,
       `Event.synchronize()`/`Stream.synchronize()`.
JG106  telemetry recording inside a capture context: a metric/span call on
       the observability registry/tracer (`metrics.counter(...).inc()`,
       `with span("...")`, `registry.time(...)`, ...) runs at CAPTURE time —
       it records once per capture, never per replay. Record from host
       code after the replay (see GPUExecutor._run_fused, which stamps each
       chunk with CUDA events around the replay).
JG107  structured-log / flight-recorder call inside a capture context:
       `flight_recorder.record(...)`, `recorder.dump(...)`, or a
       `logger.info/warning/error(...)` fires once per CAPTURE with
       capture-time values. Same fix as JG106.
JG108  profiler / resource-ledger / cost-model call inside a capture
       context: `accrue(...)`, `ledger.add(...)`, `digest_table.observe(...)`,
       `harvest_cost(...)` / `estimate_superstep_cost(...)` accrue once per
       CAPTURE with capture-time values. Same family as JG106/JG107.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set

from janusgraph_tpu_torch.analysis.core import Finding, RULES
from janusgraph_tpu_torch.analysis.tracing import (
    CAPTURE_CALL_NAMES,
    TaintWalker,
    find_traced_defs,
    is_capture_call,
    module_index,
    terminal_name,
)


def _finding(rule: str, mod, node: ast.AST, message: str) -> Finding:
    return Finding(
        rule, RULES[rule].severity, mod.path,
        getattr(node, "lineno", 1), getattr(node, "col_offset", 0), message,
    )


def _is_constant_expr(node: ast.AST) -> bool:
    if isinstance(node, ast.Constant):
        return True
    if isinstance(node, (ast.Tuple, ast.List, ast.Set)):
        return all(_is_constant_expr(e) for e in node.elts)
    if isinstance(node, ast.UnaryOp):
        return _is_constant_expr(node.operand)
    return False


def _check_traced_bodies(mod, traced) -> List[Finding]:
    out: List[Finding] = []
    for td in traced.values():
        if isinstance(td.node, ast.Lambda):
            continue
        walker = TaintWalker(td, mod)
        walker.run()
        name = td.name
        for kind, node, detail in walker.events:
            if kind == "coerce":
                out.append(_finding(
                    "JG101", mod, node,
                    f"`{detail}()` applied to a tensor in capture context "
                    f"`{name}` — a host sync the capture cannot hold; keep "
                    f"it on the device or hoist it to host code",
                ))
            elif kind == "branch":
                out.append(_finding(
                    "JG101", mod, node,
                    f"branch on a tensor in capture context `{name}` — a "
                    f"host sync, and the branch taken at capture is frozen "
                    f"into every replay; use torch.where instead of Python "
                    f"control flow",
                ))
            elif kind == "hostsync":
                out.append(_finding(
                    "JG105", mod, node,
                    f"`{detail}` in capture context `{name}` — a host sync "
                    f"inside a captured body",
                ))
        # numpy calls anywhere in the captured body (taint-independent:
        # numpy output is a host constant, frozen at capture)
        for sub in ast.walk(td.node):
            if not isinstance(sub, ast.Call):
                continue
            root = sub.func
            while isinstance(root, ast.Attribute):
                root = root.value
            if isinstance(root, ast.Name) and root.id in mod.numpy_names:
                out.append(_finding(
                    "JG102", mod, sub,
                    f"numpy call `{ast.unparse(sub.func)}` inside capture "
                    f"context `{name}` — it runs once, at capture, and its "
                    f"result is frozen into every replay; use torch on the "
                    f"device (or build the constant before the capture)",
                ))
    return out


# ------------------------------------------------------------------ JG103
def _capture_defs(mod) -> Set[str]:
    """Names of the module's defs that hold a capture region (the port's
    ``_capture``): a call to one captures a graph."""
    names = set()
    for node in ast.walk(mod.tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            for sub in ast.walk(node):
                if isinstance(sub, ast.With) and any(
                    is_capture_call(it.context_expr) for it in sub.items
                ):
                    names.add(node.name)
                    break
    return names


def _loop_vars(loop: ast.AST) -> Set[str]:
    """The variables a loop iterates: a for target's names, or the names a
    while test reads that its body rebinds."""
    if isinstance(loop, (ast.For, ast.AsyncFor)):
        return {n.id for n in ast.walk(loop.target) if isinstance(n, ast.Name)}
    tested = {n.id for n in ast.walk(loop.test) if isinstance(n, ast.Name)}
    bound = set()
    for sub in ast.walk(loop):
        if isinstance(sub, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
            targets = sub.targets if isinstance(sub, ast.Assign) else [sub.target]
            for t in targets:
                if isinstance(t, ast.Name):
                    bound.add(t.id)
    return tested & bound


def _escapes(fn: ast.AST, name: str, capture_call: ast.Call) -> bool:
    """Does the local ``name`` leave its def: returned, yielded, stored in
    an attribute/subscript/container, or passed to another call?"""
    for sub in ast.walk(fn):
        if isinstance(sub, (ast.Return, ast.Yield, ast.YieldFrom)):
            if sub.value is not None and any(
                isinstance(n, ast.Name) and n.id == name
                for n in ast.walk(sub.value)
            ):
                return True
        elif isinstance(sub, ast.Assign):
            if any(
                isinstance(n, ast.Name) and n.id == name
                for n in ast.walk(sub.value)
            ) and not all(isinstance(t, ast.Name) for t in sub.targets):
                return True
        elif isinstance(sub, ast.Call) and sub is not capture_call:
            if any(
                isinstance(a, ast.Name) and a.id == name
                for a in list(sub.args) + [k.value for k in sub.keywords]
            ):
                return True
    return False


def _check_recapture(mod) -> List[Finding]:
    """JG103: graphs not kept, kept under a non-constant key, or captured
    in a loop body."""
    out: List[Finding] = []
    capture_defs = _capture_defs(mod)
    index = module_index(mod)

    class V(ast.NodeVisitor):
        def __init__(self):
            self.loops: List[ast.AST] = []
            self.stmts: List[ast.stmt] = []

        def _loop(self, node):
            self.loops.append(node)
            self.generic_visit(node)
            self.loops.pop()

        visit_For = _loop
        visit_AsyncFor = _loop
        visit_While = _loop

        def visit_FunctionDef(self, node):
            # a def inside a loop resets loop context for its body
            saved, self.loops = self.loops, []
            self.generic_visit(node)
            self.loops = saved

        visit_AsyncFunctionDef = visit_FunctionDef

        def generic_visit(self, node):
            if isinstance(node, ast.stmt):
                self.stmts.append(node)
                super().generic_visit(node)
                self.stmts.pop()
            else:
                super().generic_visit(node)

        def visit_With(self, node):
            for item in node.items:
                call = item.context_expr
                if not is_capture_call(call) or not call.args:
                    continue
                g = call.args[0]
                fn = index.enclosing_def(node)
                if isinstance(g, ast.Call) or (
                    isinstance(g, ast.Name) and fn is not None
                    and not _escapes(fn, g.id, call)
                ):
                    out.append(_finding(
                        "JG103", mod, call,
                        "captured CUDA graph is not kept — it is dropped "
                        "when its def returns, so every call recaptures; "
                        "keep the graph (return it or store it) and replay "
                        "it",
                    ))
                elif self.loops:
                    out.append(_finding(
                        "JG103", mod, call,
                        "CUDA graph captured inside a loop body — every "
                        "iteration recaptures; capture once before the "
                        "loop and replay inside it",
                    ))
            self.generic_visit(node)

        visit_AsyncWith = visit_With

        def visit_Call(self, node):
            t = terminal_name(node.func)
            is_self_call = (
                isinstance(node.func, ast.Attribute)
                and isinstance(node.func.value, ast.Name)
                and node.func.value.id == "self"
            )
            captures = t in CAPTURE_CALL_NAMES or (
                t in capture_defs
                and (isinstance(node.func, ast.Name) or is_self_call)
            )
            if captures and self.stmts:
                self._check_kept(node, self.stmts[-1])
            self.generic_visit(node)

        def _check_kept(self, call, stmt):
            what = f"`{ast.unparse(call.func)}(...)`"
            if isinstance(stmt, ast.Expr) and stmt.value is call:
                out.append(_finding(
                    "JG103", mod, call,
                    f"{what} captures a CUDA graph and drops it — the next "
                    f"call recaptures; keep the result and replay it",
                ))
                return
            if not isinstance(stmt, ast.Assign) or stmt.value is not call:
                return
            for tgt in stmt.targets:
                if isinstance(tgt, ast.Subscript):
                    key = tgt.slice
                    loop_vars = set()
                    for loop in self.loops:
                        loop_vars |= _loop_vars(loop)
                    if _is_constant_expr(key) or (
                        isinstance(key, ast.Name) and key.id in loop_vars
                    ):
                        continue  # a constant key, or the ladder's cache fill
                    out.append(_finding(
                        "JG103", mod, call,
                        f"{what} is kept under the non-constant key "
                        f"`{ast.unparse(key)}` — one capture per distinct "
                        f"value; key the cache by a bounded ladder (the "
                        f"loop variable that fills it) or a constant",
                    ))
                elif self.loops:
                    out.append(_finding(
                        "JG103", mod, call,
                        f"{what} inside a loop body is kept under one name "
                        f"— every iteration recaptures and drops the last "
                        f"graph; capture once, or fill a cache keyed by the "
                        f"loop variable",
                    ))

    V().visit(mod.tree)
    return out


# ------------------------------------------------------------------ JG104
def _check_rebound_capture_state(mod, traced) -> List[Finding]:
    """JG104: a tensor attribute read by a captured body and rebound."""
    out: List[Finding] = []
    index = module_index(mod)
    #: id(ClassDef) -> {attr: name of a capture context that reads it}
    reads: Dict[int, Dict[str, str]] = {}
    classes: Dict[int, ast.ClassDef] = {}
    for td in traced.values():
        if isinstance(td.node, ast.Lambda) or not td.tensor_attrs:
            continue
        region = isinstance(td.node, ast.With)
        owner = td.owner if region else td.node
        cls = index.class_of.get(id(owner), (None, False))[0]
        first = owner.args.posonlyargs + owner.args.args
        if cls is None or not first or not (region or td.is_method):
            continue
        self_name = first[0].arg
        classes[id(cls)] = cls
        for sub in ast.walk(td.node):
            if (
                isinstance(sub, ast.Attribute)
                and isinstance(sub.ctx, ast.Load)
                and isinstance(sub.value, ast.Name)
                and sub.value.id == self_name
                and sub.attr in td.tensor_attrs
            ):
                reads.setdefault(id(cls), {}).setdefault(sub.attr, td.name)
    for cid, attrs in sorted(reads.items(), key=lambda kv: classes[kv[0]].lineno):
        cls = classes[cid]
        for meth in cls.body:
            if not isinstance(meth, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            if meth.name == "__init__":
                continue
            for sub in ast.walk(meth):
                if isinstance(sub, ast.Assign):
                    targets = sub.targets
                elif isinstance(sub, ast.AnnAssign) and sub.value is not None:
                    targets = [sub.target]
                else:
                    continue
                for t in targets:
                    if (
                        isinstance(t, ast.Attribute)
                        and isinstance(t.value, ast.Name)
                        and t.value.id == "self"
                        and t.attr in attrs
                    ):
                        out.append(_finding(
                            "JG104", mod, sub,
                            f"`self.{t.attr}` is read by the captured body "
                            f"`{attrs[t.attr]}` and rebound here — the "
                            f"graph recorded the old storage, so every "
                            f"replay keeps reading it; write it in place "
                            f"(`self.{t.attr}.copy_(...)`)",
                        ))
    return out


#: receiver names that identify the telemetry layer (the observability
#: singletons and their conventional aliases)
_TELEMETRY_ROOTS = {"metrics", "registry", "tracer", "telemetry"}
#: method names that record into that layer
_TELEMETRY_RECORDERS = {
    "counter", "timer", "histogram", "gauge", "time", "span",
    "record_span", "record_run", "inc", "update", "observe", "set_gauge",
    "annotate",
}
#: bare-name calls from `from janusgraph_tpu_torch.observability import span`
_SPAN_BARE_NAMES = {"span", "record_span"}


def _chain_names(node: ast.AST) -> Set[str]:
    """Every Name id and Attribute attr along a call/attribute chain:
    `metrics.counter("x").inc` -> {"metrics", "counter", "inc"}."""
    out: Set[str] = set()
    while node is not None:
        if isinstance(node, ast.Attribute):
            out.add(node.attr)
            node = node.value
        elif isinstance(node, ast.Call):
            node = node.func
        elif isinstance(node, ast.Name):
            out.add(node.id)
            return out
        else:
            return out
    return out


def _check_telemetry_in_trace(mod, traced) -> List[Finding]:
    """JG106: metric/span recording calls inside captured bodies. The
    receiver chain must touch a telemetry root name — `.update()` on a
    dict never matches."""
    out: List[Finding] = []
    for td in traced.values():
        name = td.name
        for sub in ast.walk(td.node):
            if not isinstance(sub, ast.Call):
                continue
            t = terminal_name(sub.func)
            hit = isinstance(sub.func, ast.Name) and t in _SPAN_BARE_NAMES
            if (
                not hit
                and isinstance(sub.func, ast.Attribute)
                and t in _TELEMETRY_RECORDERS
            ):
                hit = bool(_chain_names(sub.func.value) & _TELEMETRY_ROOTS)
            if hit:
                out.append(_finding(
                    "JG106", mod, sub,
                    f"telemetry call `{ast.unparse(sub.func)}` inside "
                    f"capture context `{name}` — it records once per "
                    f"capture, never per replay; record host-side after "
                    f"the replay",
                ))
    return out


#: receiver names identifying the flight recorder / structured-log layer
_FLIGHT_ROOTS = {"flight", "recorder", "flight_recorder"}
_FLIGHT_RECORDERS = {"record", "dump"}
#: structured-logger receivers (observability.logging.get_logger naming
#: conventions) and their emit methods
_LOGGER_ROOTS = {"logger", "log", "slog", "structured_logger"}
_LOGGER_EMITTERS = {"debug", "info", "warning", "error", "exception",
                    "critical"}


def _check_flight_in_trace(mod, traced) -> List[Finding]:
    """JG107: flight-recorder records / structured-log emits inside
    captured bodies. Receiver-chain matched like JG106, so `math.log(x)`
    or a dict's `.update()` never hit."""
    out: List[Finding] = []
    for td in traced.values():
        name = td.name
        for sub in ast.walk(td.node):
            if not isinstance(sub, ast.Call) or not isinstance(
                sub.func, ast.Attribute
            ):
                continue
            t = terminal_name(sub.func)
            chain = _chain_names(sub.func.value)
            hit = (
                (t in _FLIGHT_RECORDERS and chain & _FLIGHT_ROOTS)
                or (t in _LOGGER_EMITTERS and chain & _LOGGER_ROOTS)
            )
            if hit:
                out.append(_finding(
                    "JG107", mod, sub,
                    f"flight/log call `{ast.unparse(sub.func)}` inside "
                    f"capture context `{name}` — it fires once per capture "
                    f"with capture-time values; emit host-side after the "
                    f"replay",
                ))
    return out


#: receiver names identifying the profiler / resource-ledger layer
#: (observability/profiler.py singletons and conventional aliases)
_PROFILER_ROOTS = {"profiler", "ledger", "digest_table", "resource_ledger"}
#: recording/harvest methods on those receivers
_PROFILER_RECORDERS = {
    "accrue", "accrue_wall", "add", "add_wall", "merge", "merge_echo",
    "observe", "harvest_cost", "estimate_superstep_cost",
    "attach_roofline",
}
#: bare-name calls from `from ...profiler import accrue` etc.
_PROFILER_BARE_NAMES = {
    "accrue", "accrue_wall", "ledger_scope", "current_ledger",
    "merge_echo", "harvest_cost", "estimate_superstep_cost",
    "attach_roofline",
}


def _check_profiler_in_trace(mod, traced) -> List[Finding]:
    """JG108: ledger/digest/cost-model calls inside captured bodies.
    Receiver-chain matched like JG106 — a set's `.add()` or a dict's
    `.merge()` never hit unless the chain touches a profiler root."""
    out: List[Finding] = []
    for td in traced.values():
        name = td.name
        for sub in ast.walk(td.node):
            if not isinstance(sub, ast.Call):
                continue
            t = terminal_name(sub.func)
            hit = (
                isinstance(sub.func, ast.Name)
                and t in _PROFILER_BARE_NAMES
            )
            if (
                not hit
                and isinstance(sub.func, ast.Attribute)
                and t in _PROFILER_RECORDERS
            ):
                hit = bool(_chain_names(sub.func.value) & _PROFILER_ROOTS)
            if hit:
                out.append(_finding(
                    "JG108", mod, sub,
                    f"profiler/ledger call `{ast.unparse(sub.func)}` "
                    f"inside capture context `{name}` — it accrues once "
                    f"per capture with capture-time values, never per "
                    f"replay; accrue host-side after the replay",
                ))
    return out


def check_module(mod, traced: Optional[dict] = None) -> List[Finding]:
    """`traced` is the precomputed capture-context map for this module —
    the analyzer computes it ONCE per module via the whole-program call
    graph (callgraph.propagate_traced), so cross-module chains reach
    here; standalone callers omit it and get the module-local view."""
    if traced is None:
        traced = find_traced_defs(mod)
    out = _check_traced_bodies(mod, traced)
    out.extend(_check_recapture(mod))
    out.extend(_check_rebound_capture_state(mod, traced))
    out.extend(_check_telemetry_in_trace(mod, traced))
    out.extend(_check_flight_in_trace(mod, traced))
    out.extend(_check_profiler_in_trace(mod, traced))
    return out
