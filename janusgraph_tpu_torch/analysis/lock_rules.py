"""JG2xx lock-discipline rules for the OLTP storage/server layers.

JG201  `lock.acquire()` without a guaranteed release: prefer `with`; a bare
       acquire is only accepted inside a `finally` block (the re-acquire
       idiom) or when the immediately following statement is a `try` whose
       `finally` releases the same lock.
JG202  inconsistent acquisition order: every `with <lock>` nesting (plus
       same-module transitive acquisitions through local calls) contributes
       an edge lock_A -> lock_B to a global graph; any cycle is a potential
       deadlock under concurrent callers.
JG203  blocking call while holding a lock: `time.sleep`, socket I/O,
       subprocess waits, and RPC sends — directly in the `with` body or
       transitively through same-module calls (resolved by name:
       `self.m()` to the enclosing class, bare `f()` to module defs,
       `other.m()` only when the method name is unique in the module).
JG403  graphlint v2: the same hazard when the blocking path crosses a
       MODULE boundary — a call made while holding a lock resolves
       through the whole-program call graph (analysis/callgraph.py) to a
       def in another analyzed module whose transitive closure blocks.
       JG203 keeps the module-local cases byte-for-byte (no coverage
       regressions); JG403 is strictly additive on top. The cross-module
       closure also feeds the callee's transitive lock acquisitions into
       the global acquisition-order graph, so the JG202 cycle check runs
       over the real cross-module graph.

Lock identity is lexical: `self._lock` inside class C of module M is the
lock "M:C.self._lock". That maps each *instance* attribute to one node per
class, which is exactly the granularity deadlock ordering cares about.
"""

from __future__ import annotations

import ast
import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

from janusgraph_tpu_torch.analysis.core import Finding, RULES
from janusgraph_tpu_torch.analysis.tracing import terminal_name

_LOCK_NAME_RE = re.compile(
    r"(lock|guard|mutex)$|(^|_)(lock|guard|cv|cond|condition|mutex)(s)?($|_)",
    re.IGNORECASE,
)

#: (receiver-root, terminal) call patterns that block the calling thread
_BLOCKING_CALLS = {
    ("time", "sleep"),
    ("socket", "create_connection"),
    ("socket", "getaddrinfo"),
    ("subprocess", "run"),
    ("subprocess", "check_call"),
    ("subprocess", "check_output"),
    ("requests", "get"),
    ("requests", "post"),
    ("requests", "request"),
}
#: terminal method names that block regardless of receiver (socket/RPC verbs)
_BLOCKING_METHODS = {
    "sendall", "recv", "recv_into", "accept", "connect", "serve_forever",
    "urlopen",
}


def _finding(rule: str, mod, node, message: str) -> Finding:
    return Finding(
        rule, RULES[rule].severity, mod.path,
        getattr(node, "lineno", 1), getattr(node, "col_offset", 0), message,
    )


def is_lock_expr(node: ast.AST) -> Optional[str]:
    """Textual lock expression ('self._lock') when `node` names a lock."""
    t = terminal_name(node)
    if t is None or not _LOCK_NAME_RE.search(t):
        return None
    try:
        return ast.unparse(node)
    except Exception:  # pragma: no cover - unparse is total on exprs
        return t


def _is_blocking_call(call: ast.Call) -> bool:
    t = terminal_name(call.func)
    if t in _BLOCKING_METHODS:
        # ''.join-style false positives: require a non-literal receiver
        return not isinstance(call.func, ast.Constant)
    if isinstance(call.func, ast.Attribute):
        root = call.func.value
        root_name = terminal_name(root)
        if root_name and (root_name, t) in _BLOCKING_CALLS:
            return True
    return False


# ------------------------------------------------------------------ lock graph
@dataclass
class LockGraph:
    """Global acquisition-order graph accumulated across modules."""

    #: (from_lock, to_lock) -> (path, line) of the first edge occurrence
    edges: Dict[Tuple[str, str], Tuple[str, int]] = field(default_factory=dict)

    def add_edge(self, a: str, b: str, path: str, line: int) -> None:
        if a == b:
            return  # re-entrant same-lock nesting: RLock idiom, not ordering
        self.edges.setdefault((a, b), (path, line))

    def order_findings(self) -> List[Finding]:
        adj: Dict[str, Set[str]] = {}
        for (a, b) in self.edges:
            adj.setdefault(a, set()).add(b)
        findings = []
        seen_cycles = set()
        for start in sorted(adj):
            # DFS from each node looking for a path back to it
            stack = [(start, [start])]
            visited = set()
            while stack:
                node, path = stack.pop()
                for nxt in sorted(adj.get(node, ())):
                    if nxt == start and len(path) > 1:
                        cyc = frozenset(path)
                        if cyc in seen_cycles:
                            continue
                        seen_cycles.add(cyc)
                        loc_path, loc_line = self.edges[(path[-1], start)]
                        findings.append(Finding(
                            "JG202", RULES["JG202"].severity, loc_path,
                            loc_line, 0,
                            "inconsistent lock order (deadlock risk): "
                            + " -> ".join(path + [start]),
                        ))
                    elif nxt not in path and (node, nxt) not in visited:
                        visited.add((node, nxt))
                        stack.append((nxt, path + [nxt]))
        findings.sort(key=Finding.sort_key)
        return findings


# ------------------------------------------------------- per-module analysis
@dataclass
class _FnInfo:
    node: ast.AST
    cls: Optional[str]
    #: locks this function acquires directly (with-statements)
    acquires: Set[str] = field(default_factory=set)
    #: does the body contain a direct blocking call?
    blocks: bool = False
    #: call sites: (callee key candidates, locks held at the site, node)
    calls: List[Tuple[List[str], Tuple[str, ...], ast.Call]] = field(
        default_factory=list
    )
    #: direct (held, acquired, node) nesting pairs
    nest: List[Tuple[str, str, ast.AST]] = field(default_factory=list)
    #: direct blocking calls under a held lock: (held, node, desc)
    blocked: List[Tuple[str, ast.Call, str]] = field(default_factory=list)


def _lock_id(mod, cls: Optional[str], expr: str) -> str:
    return f"{mod.path}:{cls or '<module>'}.{expr}"


class _FnScanner(ast.NodeVisitor):
    """Scan one function body: with-lock nesting, acquire/release calls,
    blocking calls, and call sites with held-lock context."""

    def __init__(self, mod, info: _FnInfo):
        self.mod = mod
        self.info = info
        self.held: List[str] = []
        self.finally_depth = 0
        self.findings: List[Finding] = []

    # -- helpers
    def _callee_keys(self, call: ast.Call) -> List[str]:
        """Resolution keys for a call: 'self:<name>' (same class),
        'mod:<name>' (module function), 'any:<name>' (unique-name match)."""
        f = call.func
        if isinstance(f, ast.Name):
            return [f"mod:{f.id}"]
        if isinstance(f, ast.Attribute):
            if isinstance(f.value, ast.Name) and f.value.id == "self":
                return [f"self:{f.attr}", f"any:{f.attr}"]
            return [f"any:{f.attr}"]
        return []

    # -- visitors
    def visit_With(self, node: ast.With):
        pushed = 0
        for item in node.items:
            lock = is_lock_expr(item.context_expr)
            if lock is not None:
                lid = _lock_id(self.mod, self.info.cls, lock)
                self.info.acquires.add(lid)
                for held in self.held:
                    self.info.nest.append((held, lid, item.context_expr))
                self.held.append(lid)
                pushed += 1
        for stmt in node.body:
            self.visit(stmt)
        for _ in range(pushed):
            self.held.pop()

    def visit_Try(self, node: ast.Try):
        for stmt in node.body:
            self.visit(stmt)
        for h in node.handlers:
            for stmt in h.body:
                self.visit(stmt)
        for stmt in node.orelse:
            self.visit(stmt)
        self.finally_depth += 1
        for stmt in node.finalbody:
            self.visit(stmt)
        self.finally_depth -= 1

    def visit_FunctionDef(self, node):
        return  # nested defs get their own scan

    visit_AsyncFunctionDef = visit_FunctionDef
    visit_Lambda = visit_FunctionDef

    def visit_Call(self, node: ast.Call):
        t = terminal_name(node.func)
        if t == "acquire" and isinstance(node.func, ast.Attribute):
            lock = is_lock_expr(node.func.value)
            if lock is not None:
                self._check_bare_acquire(node, lock)
        if _is_blocking_call(node):
            self.info.blocks = True
            if self.held:
                try:
                    desc = ast.unparse(node.func)
                except Exception:  # pragma: no cover
                    desc = t or "?"
                self.info.blocked.append((self.held[-1], node, desc))
        keys = self._callee_keys(node)
        if keys:
            self.info.calls.append((keys, tuple(self.held), node))
        self.generic_visit(node)

    # -- JG201
    def _check_bare_acquire(self, node: ast.Call, lock: str):
        if self.finally_depth > 0:
            return  # `finally: lock.acquire()` re-acquire idiom
        # accept when the next sibling statement is try/finally releasing it
        stmt = self._stmt_of.get(id(node))
        ok = False
        if stmt is not None:
            nxt = self._next_stmt.get(id(stmt))
            if isinstance(nxt, ast.Try):
                for fstmt in ast.walk(ast.Module(body=nxt.finalbody, type_ignores=[])):
                    if (
                        isinstance(fstmt, ast.Call)
                        and terminal_name(fstmt.func) == "release"
                        and isinstance(fstmt.func, ast.Attribute)
                        and is_lock_expr(fstmt.func.value) == lock
                    ):
                        ok = True
        if not ok:
            self.findings.append(_finding(
                "JG201", self.mod, node,
                f"`{lock}.acquire()` without a `with` block or an "
                f"immediately following try/finally release — an exception "
                f"between acquire and release leaks the lock",
            ))

    # statement bookkeeping for the JG201 next-sibling check
    def scan(self, body: List[ast.stmt]):
        self._stmt_of: Dict[int, ast.stmt] = {}
        self._next_stmt: Dict[int, ast.stmt] = {}

        # One linear walk. `_stmt_of` maps every node to its statement in
        # the OUTERMOST block (setdefault under the top-down walk), and
        # `_next_stmt` links siblings within every nested block — the same
        # final maps the old per-block recursion produced, without
        # re-walking each nested block once per ancestor statement.
        for i, stmt in enumerate(body):
            if i + 1 < len(body):
                self._next_stmt[id(stmt)] = body[i + 1]
            for sub in ast.walk(stmt):
                self._stmt_of.setdefault(id(sub), stmt)
                for fld in ("body", "orelse", "finalbody"):
                    blk = getattr(sub, fld, None)
                    if isinstance(blk, list) and blk and isinstance(
                        blk[0], ast.stmt
                    ):
                        for j in range(len(blk) - 1):
                            self._next_stmt[id(blk[j])] = blk[j + 1]
        for stmt in body:
            self.visit(stmt)


@dataclass
class ModuleScan:
    """Per-module scan state kept for the cross-module finalize pass."""

    mod: object
    fns: List[_FnInfo]
    #: (line, col) of call sites already flagged JG203 by the local pass,
    #: so the cross-module pass never double-reports them as JG403
    flagged_sites: Set[Tuple[int, int]] = field(default_factory=set)


def check_module(mod, graph: LockGraph, collector=None) -> List[Finding]:
    """Module-local JG201/JG202-edges/JG203 — behavior identical to v1.

    When `collector` (a list) is given, the per-function scan state is
    appended as a ModuleScan so finalize_cross_module can run the
    whole-program closure afterwards.
    """
    findings: List[Finding] = []
    fns: List[_FnInfo] = []
    by_key: Dict[str, List[_FnInfo]] = {}
    name_counts: Dict[str, int] = {}

    def walk_defs(node, cls: Optional[str]):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.ClassDef):
                walk_defs(child, child.name)
            elif isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                info = _FnInfo(child, cls)
                fns.append(info)
                name_counts[child.name] = name_counts.get(child.name, 0) + 1
                walk_defs(child, cls)  # nested defs belong to the same class

    walk_defs(mod.tree, None)

    for info in fns:
        scanner = _FnScanner(mod, info)
        scanner.scan(list(info.node.body))
        findings.extend(scanner.findings)
        name = info.node.name
        if info.cls is not None:
            by_key.setdefault(f"self:{name}@{info.cls}", []).append(info)
        else:
            by_key.setdefault(f"mod:{name}", []).append(info)
        by_key.setdefault(f"name:{name}", []).append(info)

    def resolve(keys: List[str], cls: Optional[str]) -> List[_FnInfo]:
        for key in keys:
            if key.startswith("self:") and cls is not None:
                hit = by_key.get(f"{key}@{cls}")
                if hit:
                    return hit
            elif key.startswith("mod:"):
                hit = by_key.get(key)
                if hit:
                    return hit
            elif key.startswith("any:"):
                name = key[4:]
                if name_counts.get(name) == 1:
                    return by_key.get(f"name:{name}", [])
        return []

    # transitive closure of `acquires` and `blocks` through local calls
    changed = True
    passes = 0
    while changed and passes < 30:
        changed = False
        passes += 1
        for info in fns:
            for keys, _held, _node in info.calls:
                for callee in resolve(keys, info.cls):
                    if callee is info:
                        continue
                    if not callee.acquires <= info.acquires:
                        info.acquires |= callee.acquires
                        changed = True
                    if callee.blocks and not info.blocks:
                        info.blocks = True
                        changed = True

    flagged: Set[Tuple[int, int]] = set()
    for info in fns:
        # direct nesting edges
        for held, acquired, node in info.nest:
            graph.add_edge(held, acquired, mod.path, node.lineno)
        # transitive edges + JG203 through calls made while holding a lock
        for keys, held, node in info.calls:
            if not held:
                continue
            for callee in resolve(keys, info.cls):
                if callee is info:
                    continue
                for acq in sorted(callee.acquires):
                    graph.add_edge(held[-1], acq, mod.path, node.lineno)
                if callee.blocks:
                    try:
                        desc = ast.unparse(node.func)
                    except Exception:  # pragma: no cover
                        desc = keys[0]
                    findings.append(_finding(
                        "JG203", mod, node,
                        f"`{desc}()` can block (transitively) while "
                        f"holding `{held[-1].rsplit('.', 1)[-1]}` — a "
                        f"blocked holder stalls every contender",
                    ))
                    flagged.add((node.lineno, node.col_offset))
        # direct blocking calls under a lock
        for held, node, desc in info.blocked:
            findings.append(_finding(
                "JG203", mod, node,
                f"blocking call `{desc}` while holding "
                f"`{held.rsplit('.', 1)[-1]}` — move the wait outside the "
                f"critical section",
            ))
            flagged.add((node.lineno, node.col_offset))
    if collector is not None:
        collector.append(ModuleScan(mod=mod, fns=fns, flagged_sites=flagged))
    return findings


# ------------------------------------------------- cross-module finalize (v2)
def finalize_cross_module(scans: List[ModuleScan], cg,
                          graph: LockGraph) -> List[Finding]:
    """Whole-program closure over the call graph: JG403 + cross-module
    lock-order edges.

    Runs a global acquires/blocks fixpoint over callgraph edges (the
    module-local fixpoint in check_module is its depth-0 restriction),
    then revisits every call site made while holding a lock. A callee in
    ANOTHER module contributes its transitive acquisitions as order
    edges and, if its closure blocks, a JG403 finding; same-module sites
    the local pass already resolved are skipped, so JG203 output is
    unchanged and JG403 is purely additive.
    """
    findings: List[Finding] = []
    info_of: Dict[int, _FnInfo] = {}
    scan_of: Dict[int, ModuleScan] = {}
    for scan in scans:
        for info in scan.fns:
            info_of[id(info.node)] = info
            scan_of[id(info.node)] = scan

    # global fixpoint: merge callee acquires/blocks through cg edges
    changed = True
    passes = 0
    while changed and passes < 30:
        changed = False
        passes += 1
        for scan in scans:
            for info in scan.fns:
                fn = cg.node_for(info.node)
                if fn is None:
                    continue
                for callee, _call in cg.callees(fn):
                    ci = info_of.get(id(callee.node))
                    if ci is None or ci is info:
                        continue
                    if not ci.acquires <= info.acquires:
                        info.acquires |= ci.acquires
                        changed = True
                    if ci.blocks and not info.blocks:
                        info.blocks = True
                        changed = True

    for scan in scans:
        mod = scan.mod
        for info in scan.fns:
            fn = cg.node_for(info.node)
            if fn is None:
                continue
            held_at = {id(node): held for _k, held, node in info.calls}
            for callee, call in cg.callees(fn):
                held = held_at.get(id(call))
                if not held:
                    continue
                ci = info_of.get(id(callee.node))
                if ci is None or ci is info:
                    continue
                cross = scan_of[id(callee.node)].mod.path != mod.path
                if not cross:
                    continue  # module-local pass owns same-module sites
                for acq in sorted(ci.acquires):
                    graph.add_edge(held[-1], acq, mod.path, call.lineno)
                site = (call.lineno, call.col_offset)
                if ci.blocks and site not in scan.flagged_sites:
                    try:
                        desc = ast.unparse(call.func)
                    except Exception:  # pragma: no cover
                        desc = callee.name
                    findings.append(_finding(
                        "JG403", mod, call,
                        f"`{desc}()` can block (transitively, via "
                        f"{callee.qname}) while holding "
                        f"`{held[-1].rsplit('.', 1)[-1]}` — the blocking "
                        f"path crosses a module boundary; a blocked "
                        f"holder stalls every contender",
                    ))
                    scan.flagged_sites.add(site)
    findings.sort(key=Finding.sort_key)
    return findings
