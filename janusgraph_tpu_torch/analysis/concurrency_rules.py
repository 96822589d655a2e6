"""JG4xx concurrency rules: race-checking the serving fleet statically.

The codebase is a multi-threaded serving system — flat-combining pipeline
senders, per-connection server pools, the fleet router/gossip/drain
machinery, the metrics-history sampler — and the bug class that bites this
architecture is (a) shared state touched from both request paths and
background threads and (b) contextvar-scoped ambience (trace spans,
profiler ledger, request deadline) silently lost across thread handoffs.
These rules run over the whole-program call graph (analysis/callgraph.py):

JG401  an instance/object attribute is mutated both from a thread-entry
       context (``threading.Thread(target=…)``, pool ``submit``/``map``)
       and from a non-thread context, with NO lock held in common across
       the mutation sites. Identity is lexical, same as the JG2xx lock
       ids: ``self.attr`` in class C of module M is ``M:C.attr``; a
       non-self receiver uses its variable name (``M:handle.attr``) —
       heuristic, documented as such. Objects that are provably fresh in
       the mutating function (constructed from a literal or a CapWords
       constructor call) never participate.
JG402  a contextvar / ambient-scope accessor (deadline ``remaining_ms``/
       ``expired``/``check``, profiler ``current_ledger``/``accrue``,
       tracer ``span``/``current_context``, or a raw ``.get()`` on a
       module-level ``ContextVar``) is reachable from a thread-entry
       context without an explicit handoff. Reachability walks the call
       graph from the entry def; a function that re-enters scope
       explicitly (``deadline_scope``/``_deadline_guard``/``child_span``/
       ``ledger_scope``/``contextvars.copy_context``/``capture_scope``)
       or carries a ``# graphlint: handoff`` marker stops the walk — the
       fresh thread re-establishes its own ambience below that point.
       A submit site whose target is already wrapped (``ctx.run``,
       ``capture_scope(...)``) never produces an entry at all.
JG403  blocking call while holding a lock, transitively through the
       cross-module call graph — emitted by lock_rules.finalize_cross_
       module (registered here for the family table).
JG404  ``threading.Thread(...)`` created with neither ``daemon=`` nor a
       join/stop path: exempt when the creating function joins it
       (structured fork-join) or the enclosing class has a shutdown-
       family method (``close``/``stop``/``shutdown``/``drain``/
       ``join``/``__exit__``) that joins a thread. A non-daemon thread
       with no shutdown path keeps the process alive forever on exit.
"""

from __future__ import annotations

import ast
import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Set, Tuple

from janusgraph_tpu_torch.analysis.callgraph import CallGraph, FuncNode
from janusgraph_tpu_torch.analysis.core import Finding, ModuleInfo, RULES
from janusgraph_tpu_torch.analysis.lock_rules import _lock_id, is_lock_expr
from janusgraph_tpu_torch.analysis.tracing import terminal_name

#: pool-ish receiver names whose .submit/.map fan work onto threads
_POOL_NAME_RE = re.compile(r"(pool|executor|workers)$", re.IGNORECASE)

#: functions that re-establish ambient scope for the current thread —
#: below one of these, a fresh thread has its OWN deadline/span/ledger
#: and JG402 stops walking
_REENTRY_CALLS = {
    "deadline_scope", "_deadline_guard", "child_span", "ledger_scope",
    "copy_context", "capture_scope",
}

#: bare-name ambient accessors (from `from ...deadline import remaining_ms`
#: style imports, the dominant idiom in the tree)
_AMBIENT_BARE = {
    "current_deadline", "remaining_ms", "expired", "deadline_check",
    "current_ledger", "accrue", "accrue_wall", "span", "current_context",
}
#: attribute-form accessors require the receiver chain to touch one of
#: these roots (module aliases of the deadline/profiler/tracer layers),
#: so `job.span` or `ledger.accrue` on an explicit object never hit
_AMBIENT_ATTRS = _AMBIENT_BARE
_AMBIENT_ROOTS = {
    "tracer", "_dl", "deadline", "_prof", "profiler", "spans", "_spans",
    "_tracing",
}

_MUTATOR_METHODS = {
    "append", "extend", "add", "discard", "remove", "clear", "pop",
    "popleft", "appendleft", "update", "setdefault", "insert",
}

_SHUTDOWN_NAMES = {
    "close", "stop", "shutdown", "drain", "join", "terminate", "__exit__",
    "stop_event", "request_stop",
}

_FRESH_VALUE_TYPES = (
    ast.List, ast.Dict, ast.Set, ast.Tuple, ast.Constant, ast.ListComp,
    ast.DictComp, ast.SetComp, ast.GeneratorExp,
)


def _finding(rule: str, mod: ModuleInfo, node: ast.AST,
             message: str) -> Finding:
    return Finding(
        rule, RULES[rule].severity, mod.path,
        getattr(node, "lineno", 1), getattr(node, "col_offset", 0), message,
    )


def _chain_names(node: ast.AST) -> Set[str]:
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


# --------------------------------------------------------------- entry sites
@dataclass
class ThreadEntry:
    """One place work is handed to another thread."""

    mod: ModuleInfo
    call: ast.Call  # the Thread(...)/submit(...) call
    target: Optional[ast.AST]  # the target/fn expression, if any
    entry: Optional[FuncNode]  # resolved entry def, if resolvable
    kind: str  # "thread" | "submit" | "map"


def _thread_target(call: ast.Call) -> Optional[ast.AST]:
    for kw in call.keywords:
        if kw.arg == "target":
            return kw.value
    return None


def find_thread_entries(
    modules: Sequence[ModuleInfo], cg: CallGraph
) -> List[ThreadEntry]:
    entries: List[ThreadEntry] = []
    for mod in modules:
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Call):
                continue
            t = terminal_name(node.func)
            if t == "Thread":
                target = _thread_target(node)
                entry = (
                    cg.resolve_ref(target, mod)
                    if target is not None else []
                )
                entries.append(ThreadEntry(
                    mod, node, target, entry[0] if entry else None, "thread",
                ))
            elif (
                t in ("submit", "map")
                and isinstance(node.func, ast.Attribute)
                and node.args
            ):
                recv = terminal_name(node.func.value)
                if recv is None or not _POOL_NAME_RE.search(recv):
                    continue
                target = node.args[0]
                entry = cg.resolve_ref(target, mod)
                entries.append(ThreadEntry(
                    mod, node, target, entry[0] if entry else None,
                    "submit" if t == "submit" else "map",
                ))
    return entries


def _thread_reachable(
    entries: Sequence[ThreadEntry], cg: CallGraph,
    stop_at_reentry: bool = False,
    reenters: Optional[Dict[str, bool]] = None,
) -> Set[str]:
    """Qnames reachable from any thread entry over the call graph."""
    seen: Set[str] = set()
    queue = [e.entry for e in entries if e.entry is not None]
    while queue:
        fn = queue.pop()
        if fn.qname in seen:
            continue
        seen.add(fn.qname)
        if stop_at_reentry and reenters and reenters.get(fn.qname):
            continue
        for callee, _call in cg.callees(fn):
            if callee.qname not in seen:
                queue.append(callee)
    return seen


# ------------------------------------------------------------------- JG401
@dataclass
class _MutSite:
    fn: FuncNode
    node: ast.AST
    locks: frozenset
    thread_side: bool
    desc: str


class _MutScanner(ast.NodeVisitor):
    """Held-lock-aware mutation scan of one function body."""

    def __init__(self, mod: ModuleInfo, fn: FuncNode):
        self.mod = mod
        self.fn = fn
        self.held: List[str] = []
        #: (attr expression, node, desc) mutations with held-lock snapshot
        self.muts: List[Tuple[ast.Attribute, ast.AST, frozenset, str]] = []
        #: bare names assigned from provably-fresh values in this function
        self.fresh: Set[str] = set()

    def visit_With(self, node: ast.With):
        pushed = 0
        for item in node.items:
            lock = is_lock_expr(item.context_expr)
            if lock is not None:
                self.held.append(_lock_id(self.mod, self.fn.cls, lock))
                pushed += 1
        for stmt in node.body:
            self.visit(stmt)
        for _ in range(pushed):
            self.held.pop()

    def visit_FunctionDef(self, node):
        return  # nested defs are their own FuncNodes

    visit_AsyncFunctionDef = visit_FunctionDef
    visit_Lambda = visit_FunctionDef

    def _record(self, attr: ast.Attribute, node: ast.AST, desc: str):
        self.muts.append((attr, node, frozenset(self.held), desc))

    def _mut_target(self, tgt: ast.AST, node: ast.AST, op: str):
        if isinstance(tgt, ast.Attribute):
            self._record(tgt, node, f"{op} {tgt.attr}")
        elif isinstance(tgt, ast.Subscript) and isinstance(
            tgt.value, ast.Attribute
        ):
            self._record(tgt.value, node, f"{op} {tgt.value.attr}[...]")
        elif isinstance(tgt, (ast.Tuple, ast.List)):
            for e in tgt.elts:
                self._mut_target(e, node, op)

    def visit_Assign(self, node: ast.Assign):
        if (
            len(node.targets) == 1
            and isinstance(node.targets[0], ast.Name)
            and (
                isinstance(node.value, _FRESH_VALUE_TYPES)
                or (
                    isinstance(node.value, ast.Call)
                    and (terminal_name(node.value.func) or "")[:1].isupper()
                )
            )
        ):
            self.fresh.add(node.targets[0].id)
        for tgt in node.targets:
            self._mut_target(tgt, node, "assign to")
        self.generic_visit(node)

    def visit_AugAssign(self, node: ast.AugAssign):
        self._mut_target(node.target, node, "augment")
        self.generic_visit(node)

    def visit_Delete(self, node: ast.Delete):
        for tgt in node.targets:
            self._mut_target(tgt, node, "delete")
        self.generic_visit(node)

    def visit_Call(self, node: ast.Call):
        f = node.func
        if (
            isinstance(f, ast.Attribute)
            and f.attr in _MUTATOR_METHODS
            and isinstance(f.value, ast.Attribute)
        ):
            self._record(f.value, node, f"{f.attr}() on {f.value.attr}")
        self.generic_visit(node)


def _attr_identity(
    attr: ast.Attribute, mod: ModuleInfo, fn: FuncNode, fresh: Set[str]
) -> Optional[str]:
    """Lexical shared-object identity of a mutated attribute, or None if
    the receiver is provably function-local."""
    recv = attr.value
    if isinstance(recv, ast.Name):
        if recv.id == "self":
            if fn.cls is None:
                return None
            return f"{mod.path}:{fn.cls}.{attr.attr}"
        if recv.id in fresh:
            return None  # built fresh in this function: not shared
        return f"{mod.path}:{recv.id}.{attr.attr}"
    # deeper chains (self.x.y = ...) key on the full receiver text
    if (
        isinstance(recv, ast.Attribute)
        and isinstance(recv.value, ast.Name)
        and recv.value.id == "self"
        and fn.cls is not None
    ):
        return f"{mod.path}:{fn.cls}.{recv.attr}.{attr.attr}"
    return None


def _check_shared_mutation(
    modules: Sequence[ModuleInfo], cg: CallGraph,
    thread_qnames: Set[str],
) -> List[Finding]:
    by_mod = {m.path: m for m in modules}
    sites: Dict[str, List[_MutSite]] = {}
    for fn in sorted(cg.funcs.values(), key=lambda f: f.qname):
        if fn.name in ("__init__", "__post_init__", "__new__"):
            continue
        mod = by_mod.get(fn.mod.path)
        if mod is None:
            continue
        scanner = _MutScanner(mod, fn)
        for stmt in getattr(fn.node, "body", []):
            scanner.visit(stmt)
        for attr, node, locks, desc in scanner.muts:
            ident = _attr_identity(attr, mod, fn, scanner.fresh)
            if ident is None:
                continue
            sites.setdefault(ident, []).append(_MutSite(
                fn, node, locks, fn.qname in thread_qnames, desc,
            ))
    out: List[Finding] = []
    for ident in sorted(sites):
        group = sites[ident]
        t_sites = [s for s in group if s.thread_side]
        m_sites = [s for s in group if not s.thread_side]
        if not t_sites or not m_sites:
            continue
        common = frozenset.intersection(*(s.locks for s in group))
        if common:
            continue
        # precision gate: require lock evidence SOMEWHERE in the group.
        # A class with no locking anywhere is usually instance-confined
        # (each thread builds its own traversal/scanner); a class that
        # locks some mutation sites but not all is the real race shape
        # (sampler vs reset, probe vs mark_dead).
        if not any(s.locks for s in group):
            continue
        # report at an UNGUARDED site (prefer thread-side: the sampler/
        # probe thread racing the request path is the canonical shape) —
        # pointing at a lock-guarded line would send the reader to the
        # one site that is fine
        unguarded = [s for s in group if not s.locks]
        pool = [s for s in unguarded if s.thread_side] or unguarded or t_sites
        report = sorted(pool, key=lambda s: s.node.lineno)[0]
        attr_disp = ident.split(":", 1)[1]
        others = [s for s in group if s.thread_side != report.thread_side]
        other = sorted(others, key=lambda s: s.node.lineno)[0]
        here = (
            "on a thread-entry path" if report.thread_side
            else "outside any thread context"
        )
        there = (
            "from non-thread context" if report.thread_side
            else "on a thread-entry path"
        )
        out.append(_finding(
            "JG401", report.fn.mod, report.node,
            f"`{attr_disp}` is mutated here {here} ({report.desc}) and "
            f"{there} at line {other.node.lineno} with no common lock "
            f"across the mutation sites — concurrent mutation races; "
            f"guard every site with one lock or confine the state to "
            f"one thread",
        ))
    return out


# ------------------------------------------------------------------- JG402
def _contextvar_names(mod: ModuleInfo) -> Set[str]:
    """Module-level names bound to ContextVar(...)."""
    out: Set[str] = set()
    for node in ast.iter_child_nodes(mod.tree):
        if (
            isinstance(node, ast.Assign)
            and isinstance(node.value, ast.Call)
            and terminal_name(node.value.func) == "ContextVar"
        ):
            for tgt in node.targets:
                if isinstance(tgt, ast.Name):
                    out.add(tgt.id)
    return out


def _fn_reenters(fn: FuncNode, mod: ModuleInfo) -> bool:
    if fn.lineno in mod.suppressions.handoff_lines:
        return True
    for sub in CallGraph._own_body_walk(fn.node):
        if isinstance(sub, ast.Call):
            if terminal_name(sub.func) in _REENTRY_CALLS:
                return True
    return False


def _ambient_sites(
    fn: FuncNode, mod: ModuleInfo, cvars: Set[str]
) -> List[Tuple[ast.AST, str]]:
    out: List[Tuple[ast.AST, str]] = []
    for sub in CallGraph._own_body_walk(fn.node):
        if not isinstance(sub, ast.Call):
            continue
        f = sub.func
        t = terminal_name(f)
        if isinstance(f, ast.Name):
            if t in _AMBIENT_BARE:
                out.append((sub, f"{t}()"))
        elif isinstance(f, ast.Attribute):
            if t == "get" and isinstance(f.value, ast.Name) and (
                f.value.id in cvars
            ):
                out.append((sub, f"{f.value.id}.get()"))
            elif t in _AMBIENT_ATTRS and (
                _chain_names(f.value) & _AMBIENT_ROOTS
            ):
                try:
                    out.append((sub, f"{ast.unparse(f)}()"))
                except Exception:  # pragma: no cover
                    out.append((sub, f"{t}()"))
    return out


def _check_ambient_loss(
    modules: Sequence[ModuleInfo], entries: Sequence[ThreadEntry],
    cg: CallGraph,
) -> List[Finding]:
    by_mod = {m.path: m for m in modules}
    cvars_of = {m.path: _contextvar_names(m) for m in modules}
    reenters: Dict[str, bool] = {}
    for fn in cg.funcs.values():
        mod = by_mod.get(fn.mod.path)
        reenters[fn.qname] = _fn_reenters(fn, mod) if mod else False

    out: List[Finding] = []
    reported: Set[Tuple[str, int, int]] = set()
    for e in sorted(
        [e for e in entries if e.entry is not None],
        key=lambda e: (e.mod.path, e.call.lineno),
    ):
        # the submit line itself may declare the handoff
        if e.call.lineno in e.mod.suppressions.handoff_lines:
            continue
        seen: Set[str] = set()
        queue: List[Tuple[FuncNode, int]] = [(e.entry, 0)]
        while queue:
            fn, depth = queue.pop()
            if fn.qname in seen or depth > 8:
                continue
            seen.add(fn.qname)
            if reenters.get(fn.qname):
                continue  # explicit re-entry: safe below this point
            mod = by_mod.get(fn.mod.path)
            if mod is None:
                continue
            for node, desc in _ambient_sites(
                fn, mod, cvars_of.get(fn.mod.path, set())
            ):
                key = (fn.mod.path, node.lineno, node.col_offset)
                if key in reported:
                    continue
                reported.add(key)
                out.append(_finding(
                    "JG402", mod, node,
                    f"ambient-scope access `{desc}` runs on a fresh "
                    f"thread (entered via {e.entry.qname}, spawned at "
                    f"{e.mod.path}:{e.call.lineno}) — contextvars don't "
                    f"cross thread boundaries, so the deadline/span/"
                    f"ledger read here is empty; capture the scope at "
                    f"the spawn site (contextvars.copy_context() / "
                    f"capture_scope) or re-enter it explicitly, then "
                    f"mark the handoff",
                ))
            for callee, _call in cg.callees(fn):
                if callee.qname not in seen:
                    queue.append((callee, depth + 1))
    return out


# ------------------------------------------------------------------- JG404
def _joins_in(node: ast.AST) -> bool:
    for sub in ast.walk(node):
        if isinstance(sub, ast.Call) and terminal_name(sub.func) == "join":
            return True
    return False


def _check_thread_lifecycle(
    modules: Sequence[ModuleInfo], entries: Sequence[ThreadEntry],
    cg: CallGraph,
) -> List[Finding]:
    out: List[Finding] = []
    for e in entries:
        if e.kind != "thread":
            continue
        daemon = None
        for kw in e.call.keywords:
            if kw.arg == "daemon":
                daemon = kw.value
        if daemon is not None and not (
            isinstance(daemon, ast.Constant) and daemon.value is False
        ):
            continue  # daemon=True (or dynamic): reaped at exit
        encl = cg.enclosing(e.call)
        if encl is not None and _joins_in(encl.node):
            continue  # structured fork-join in the same function
        # shutdown-family method on the enclosing class that joins
        if encl is not None and encl.cls is not None:
            sym = cg.symbols.get(e.mod.path)
            cls = sym.classes.get(encl.cls) if sym else None
            if cls is not None and any(
                name in _SHUTDOWN_NAMES and _joins_in(meth)
                for name, meth in cls.methods.items()
            ):
                continue
        out.append(_finding(
            "JG404", e.mod, e.call,
            "threading.Thread without daemon= and without a join/stop "
            "path — a non-daemon thread with no shutdown route keeps "
            "the process alive after main exits; pass daemon=True for "
            "a best-effort background loop, or join it from a "
            "close()/stop()/shutdown() method",
        ))
    return out


# ------------------------------------------------------------- entry point
def check_program(
    modules: Sequence[ModuleInfo], cg: CallGraph
) -> List[Finding]:
    """Run the JG4xx family over the whole analyzed set."""
    entries = find_thread_entries(modules, cg)
    thread_qnames = _thread_reachable(entries, cg)
    out = _check_shared_mutation(modules, cg, thread_qnames)
    out.extend(_check_ambient_loss(modules, entries, cg))
    out.extend(_check_thread_lifecycle(modules, entries, cg))
    out.sort(key=Finding.sort_key)
    return out
