"""Whole-program symbol table + call graph for graphlint v2.

graphlint v1 analyzed one module at a time, so every transitive rule
(JG1xx taint, JG2xx lock/blocking closure) stopped at module boundaries.
This module builds the package-wide layer those families now consume:

* **Symbol table** per module: top-level defs, classes with their
  methods, and import aliasing (``import a.b as c``, ``from a.b import f
  as g``, relative imports resolved against the importing module's
  package path).
* **Function registry**: every ``def`` at any nesting depth becomes a
  :class:`FuncNode` with a stable qualified name
  (``path.py:Class.method`` / ``path.py:outer.<locals>.inner``).
* **Bounded call resolution** (:meth:`CallGraph.resolve`), in strictly
  decreasing confidence order:

  1. lexically visible local defs (nested-scope chain),
  2. same-module top-level defs / classes (a class resolves to its
     ``__init__``),
  3. imported symbols and ``module.attr`` calls through the import
     aliases,
  4. ``self.m()`` to the enclosing class (following single-inheritance
     base names resolvable in the analyzed set),
  5. typed receivers: ``v = ClassName(...)`` in the same function, or
     ``self.attr`` whose class assigned ``self.attr = ClassName(...)``
     in any of its own methods,
  6. the receiver-name fallback: a method name that is **unique across
     the entire analyzed set** resolves to that one def.

  Anything else resolves to nothing — unresolved calls simply end the
  transitive walk (documented unsoundness; see README.md, "graphlint for
  the port").

* **Decorator unwrapping**: a decorated def registers under its own
  name, so calls to ``@functools.wraps``-style wrapped functions and
  ``@contextmanager`` factories resolve to the decorated body.

Interprocedural capture-context propagation (:func:`propagate_traced`)
rides the same graph, widened by virtual dispatch
(:meth:`CallGraph.resolve_dispatch`) and property reads: code reached
from a CUDA-graph capture marks the callee a capture context with exactly
the tainted argument positions — the same-module taint is the depth-1
case of this walk. The rule families other than JG1xx/JG303 read only
:meth:`CallGraph.resolve` and :meth:`CallGraph.callees`, which the
widening leaves untouched.

Everything here is stdlib-only and deterministic: iteration orders are
sorted, so the same tree always yields the same graph (and the same
byte-identical JSON report downstream).
"""

from __future__ import annotations

import ast
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Set, Tuple

from janusgraph_tpu_torch.analysis.core import ModuleInfo
from janusgraph_tpu_torch.analysis.tracing import terminal_name


def module_dotted(path: str) -> str:
    """Display path -> dotted module name (``a/b/c.py`` -> ``a.b.c``;
    ``a/b/__init__.py`` -> ``a.b``)."""
    p = path.replace("\\", "/")
    if p.endswith(".py"):
        p = p[:-3]
    parts = [seg for seg in p.split("/") if seg and seg != "."]
    if parts and parts[-1] == "__init__":
        parts = parts[:-1]
    return ".".join(parts)


@dataclass
class ClassInfo:
    name: str
    node: ast.ClassDef
    #: method name -> def node
    methods: Dict[str, ast.AST] = field(default_factory=dict)
    #: textual base-class names (``Base``, ``mod.Base``)
    bases: List[str] = field(default_factory=list)
    #: self.<attr> -> class-name expression text it was constructed from
    attr_types: Dict[str, str] = field(default_factory=dict)


@dataclass
class FuncNode:
    """One function definition anywhere in the analyzed set."""

    qname: str  # "display/path.py:Class.method" (stable, sorted-unique)
    mod: ModuleInfo
    node: ast.AST  # FunctionDef | AsyncFunctionDef
    cls: Optional[str]  # nearest enclosing class name, if any

    @property
    def name(self) -> str:
        return getattr(self.node, "name", "<lambda>")

    @property
    def lineno(self) -> int:
        return getattr(self.node, "lineno", 1)


@dataclass
class ModuleSymbols:
    """Import aliases + top-level defs/classes of one module."""

    mod: ModuleInfo
    dotted: str
    #: local alias -> dotted target module ("import a.b as c")
    import_mods: Dict[str, str] = field(default_factory=dict)
    #: local alias -> (dotted module, symbol) ("from a.b import f as g")
    import_syms: Dict[str, Tuple[str, str]] = field(default_factory=dict)
    #: top-level function name -> def node
    defs: Dict[str, ast.AST] = field(default_factory=dict)
    #: top-level class name -> ClassInfo
    classes: Dict[str, ClassInfo] = field(default_factory=dict)


def _rel_target(mod_dotted: str, is_pkg: bool, level: int,
                name: Optional[str]) -> str:
    """Resolve a relative import to a dotted target module."""
    parts = mod_dotted.split(".") if mod_dotted else []
    if not is_pkg:
        parts = parts[:-1]  # the module's own name is not a package level
    drop = level - 1
    if drop:
        parts = parts[:-drop] if drop <= len(parts) else []
    if name:
        parts = parts + name.split(".")
    return ".".join(parts)


def _collect_symbols(mod: ModuleInfo) -> ModuleSymbols:
    dotted = module_dotted(mod.path)
    is_pkg = mod.path.replace("\\", "/").endswith("__init__.py")
    sym = ModuleSymbols(mod=mod, dotted=dotted)
    # imports anywhere in the module (function-local imports are the
    # repo's dominant idiom for heavy deps)
    for node in ast.walk(mod.tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                sym.import_mods[alias.asname or alias.name.split(".")[0]] = (
                    alias.name if alias.asname else alias.name.split(".")[0]
                )
        elif isinstance(node, ast.ImportFrom):
            target = (
                _rel_target(dotted, is_pkg, node.level, node.module)
                if node.level else (node.module or "")
            )
            for alias in node.names:
                if alias.name == "*":
                    continue
                sym.import_syms[alias.asname or alias.name] = (
                    target, alias.name
                )
    for child in ast.iter_child_nodes(mod.tree):
        if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
            sym.defs[child.name] = child
        elif isinstance(child, ast.ClassDef):
            info = ClassInfo(name=child.name, node=child)
            for b in child.bases:
                t = terminal_name(b)
                if t:
                    info.bases.append(t)
            for sub in ast.iter_child_nodes(child):
                if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    info.methods[sub.name] = sub
            # receiver typing: self.<attr> = ClassName(...) in any method
            for meth in info.methods.values():
                for stmt in ast.walk(meth):
                    if not (
                        isinstance(stmt, ast.Assign)
                        and isinstance(stmt.value, ast.Call)
                    ):
                        continue
                    ctor = terminal_name(stmt.value.func)
                    if not ctor or not ctor[:1].isupper():
                        continue  # heuristics: classes are CapWords here
                    for tgt in stmt.targets:
                        if (
                            isinstance(tgt, ast.Attribute)
                            and isinstance(tgt.value, ast.Name)
                            and tgt.value.id == "self"
                        ):
                            info.attr_types.setdefault(tgt.attr, ctor)
            sym.classes[child.name] = info
    return sym


class CallGraph:
    """Whole-program call graph over a set of parsed modules."""

    def __init__(self, modules: Sequence[ModuleInfo]):
        self.modules = list(modules)
        self.symbols: Dict[str, ModuleSymbols] = {}
        #: dotted module name -> ModuleSymbols (exact and unique-suffix)
        self._by_dotted: Dict[str, ModuleSymbols] = {}
        #: id(def node) -> FuncNode
        self.funcs: Dict[int, FuncNode] = {}
        self.by_qname: Dict[str, FuncNode] = {}
        #: method/function name -> [FuncNode ...] across the package
        self._by_name: Dict[str, List[FuncNode]] = {}
        #: id(node) -> enclosing FuncNode (for any ast node)
        self._enclosing: Dict[int, FuncNode] = {}
        #: id(def node) -> parent def node id (lexical scope chain)
        self._parent_fn: Dict[int, Optional[int]] = {}
        #: caller qname -> [(callee FuncNode, call node)]
        self._edges: Dict[str, List[Tuple[FuncNode, ast.Call]]] = {}
        #: per-function local receiver types: id(fn) -> {var: class name}
        self._local_types: Dict[int, Dict[str, str]] = {}
        for mod in self.modules:
            self.symbols[mod.path] = _collect_symbols(mod)
        self._index_dotted()
        for mod in self.modules:
            self._register_funcs(mod)
        for fn in self.funcs.values():
            self._by_name.setdefault(fn.name, []).append(fn)
        for lst in self._by_name.values():
            lst.sort(key=lambda f: f.qname)
        self._build_edges()

    # ------------------------------------------------------------- indexing
    def _index_dotted(self) -> None:
        suffix_count: Dict[str, int] = {}
        suffix_map: Dict[str, ModuleSymbols] = {}
        for sym in self.symbols.values():
            parts = sym.dotted.split(".")
            for i in range(len(parts)):
                suf = ".".join(parts[i:])
                suffix_count[suf] = suffix_count.get(suf, 0) + 1
                suffix_map[suf] = sym
        self._by_dotted = {
            suf: sym for suf, sym in suffix_map.items()
            if suffix_count[suf] == 1
        }

    def module_named(self, dotted: str) -> Optional[ModuleSymbols]:
        """Find an analyzed module by dotted name, matching the longest
        unique suffix (fixture packages under deep display paths resolve
        the same way the real package does)."""
        return self._by_dotted.get(dotted)

    def _register_funcs(self, mod: ModuleInfo) -> None:
        def walk(node, scope: List[str], cls: Optional[str],
                 parent_fn: Optional[ast.AST]):
            for child in ast.iter_child_nodes(node):
                if isinstance(child, ast.ClassDef):
                    walk(child, scope + [child.name], child.name, parent_fn)
                elif isinstance(
                    child, (ast.FunctionDef, ast.AsyncFunctionDef)
                ):
                    qname = f"{mod.path}:{'.'.join(scope + [child.name])}"
                    fn = FuncNode(qname=qname, mod=mod, node=child, cls=cls)
                    self.funcs[id(child)] = fn
                    self.by_qname[qname] = fn
                    self._parent_fn[id(child)] = (
                        id(parent_fn) if parent_fn is not None else None
                    )
                    for sub in ast.walk(child):
                        self._enclosing.setdefault(id(sub), fn)
                    # nested defs keep the enclosing class for `self`
                    walk(child, scope + [child.name, "<locals>"], cls, child)

        walk(mod.tree, [], None, None)

    # ------------------------------------------------------ local type maps
    def _local_types_of(self, fn: FuncNode) -> Dict[str, str]:
        cached = self._local_types.get(id(fn.node))
        if cached is not None:
            return cached
        types: Dict[str, str] = {}
        for stmt in ast.walk(fn.node):
            if not (
                isinstance(stmt, ast.Assign)
                and isinstance(stmt.value, ast.Call)
                and len(stmt.targets) == 1
                and isinstance(stmt.targets[0], ast.Name)
            ):
                continue
            ctor = terminal_name(stmt.value.func)
            if ctor and ctor[:1].isupper():
                types[stmt.targets[0].id] = ctor
        self._local_types[id(fn.node)] = types
        return types

    # ------------------------------------------------------------ resolution
    def enclosing(self, node: ast.AST) -> Optional[FuncNode]:
        return self._enclosing.get(id(node))

    def _resolve_class(
        self, name: str, sym: ModuleSymbols
    ) -> Optional[Tuple[ModuleSymbols, ClassInfo]]:
        """A class name visible in `sym`'s module: local, or imported."""
        info = sym.classes.get(name)
        if info is not None:
            return sym, info
        imp = sym.import_syms.get(name)
        if imp is not None:
            target = self.module_named(imp[0])
            if target is not None:
                info = target.classes.get(imp[1])
                if info is not None:
                    return target, info
        return None

    def _class_method(
        self, sym: ModuleSymbols, info: ClassInfo, meth: str,
        _depth: int = 0,
    ) -> Optional[FuncNode]:
        """Method lookup following resolvable base classes (bounded)."""
        node = info.methods.get(meth)
        if node is not None:
            return self.funcs.get(id(node))
        if _depth >= 4:
            return None
        for base in info.bases:
            hit = self._resolve_class(base, sym)
            if hit is not None:
                found = self._class_method(hit[0], hit[1], meth, _depth + 1)
                if found is not None:
                    return found
        return None

    def _resolve_symbol(
        self, sym: ModuleSymbols, name: str
    ) -> Optional[FuncNode]:
        """A bare name in module scope: top-level def, class (its
        __init__), or an imported symbol from an analyzed module."""
        node = sym.defs.get(name)
        if node is not None:
            return self.funcs.get(id(node))
        hit = self._resolve_class(name, sym)
        if hit is not None:
            return self._class_method(hit[0], hit[1], "__init__")
        imp = sym.import_syms.get(name)
        if imp is not None:
            target = self.module_named(imp[0])
            if target is not None and imp[1] != name:
                return self._resolve_symbol(target, imp[1])
            if target is not None:
                node = target.defs.get(imp[1])
                if node is not None:
                    return self.funcs.get(id(node))
                chit = target.classes.get(imp[1])
                if chit is not None:
                    return self._class_method(target, chit, "__init__")
            # `from a import b` where a.b is itself an analyzed module
            submod = self.module_named(
                f"{imp[0]}.{imp[1]}" if imp[0] else imp[1]
            )
            if submod is not None:
                return None  # a module object, not a callable
        return None

    def resolve(self, call: ast.Call, mod: ModuleInfo,
                fallback: bool = True) -> List[FuncNode]:
        """Best-effort callee candidates for one call site (possibly
        empty). Bounded: at most one candidate except for the documented
        unique-name fallback (which is also a single candidate).
        ``fallback=False`` disables that last-resort name match — the
        capture propagation (:meth:`resolve_dispatch`) starts from it,
        because a tensor method (``msgs.take(idx)``) colliding with a
        uniquely-named host def would otherwise teleport capture taint
        into unrelated code."""
        return self.resolve_ref(call.func, mod, self.enclosing(call),
                                fallback=fallback)

    def resolve_ref(
        self, f: ast.AST, mod: ModuleInfo, encl: Optional[FuncNode] = None,
        fallback: bool = True,
    ) -> List[FuncNode]:
        """Resolve a function REFERENCE expression (not necessarily a
        call) — the form thread targets take: ``Thread(target=self._loop)``
        / ``pool.submit(worker, ...)``."""
        sym = self.symbols[mod.path]
        if encl is None:
            encl = self.enclosing(f)
        if isinstance(f, ast.Name):
            # lexical chain of nested defs first
            fn_id = id(encl.node) if encl is not None else None
            seen = set()
            while fn_id is not None and fn_id not in seen:
                seen.add(fn_id)
                holder = self.funcs.get(fn_id)
                if holder is not None:
                    for child in ast.iter_child_nodes(holder.node):
                        if isinstance(
                            child, (ast.FunctionDef, ast.AsyncFunctionDef)
                        ) and child.name == f.id:
                            got = self.funcs.get(id(child))
                            return [got] if got else []
                fn_id = self._parent_fn.get(fn_id)
            hit = self._resolve_symbol(sym, f.id)
            return [hit] if hit else []
        if isinstance(f, ast.Attribute):
            meth = f.attr
            recv = f.value
            # self.m()
            if (
                isinstance(recv, ast.Name) and recv.id == "self"
                and encl is not None and encl.cls is not None
            ):
                chit = self._resolve_class(encl.cls, sym)
                if chit is not None:
                    got = self._class_method(chit[0], chit[1], meth)
                    if got is not None:
                        return [got]
                if not fallback:
                    return []
                return self._unique_name(meth, exclude_cls=None)
            # module alias: mod.f() / pkg.mod.Class(...)
            root = recv
            chain = [meth]
            while isinstance(root, ast.Attribute):
                chain.append(root.attr)
                root = root.value
            if isinstance(root, ast.Name):
                target = self._module_for_alias(sym, root.id, chain[1:][::-1])
                if target is not None:
                    node = target.defs.get(meth)
                    if node is not None:
                        got = self.funcs.get(id(node))
                        return [got] if got else []
                    chit = target.classes.get(meth)
                    if chit is not None:
                        got = self._class_method(target, chit, "__init__")
                        return [got] if got else []
                # typed local receiver: v = ClassName(...); v.m()
                if isinstance(recv, ast.Name) and encl is not None:
                    tname = self._local_types_of(encl).get(recv.id)
                    if tname:
                        chit = self._resolve_class(tname, sym)
                        if chit is not None:
                            got = self._class_method(chit[0], chit[1], meth)
                            if got is not None:
                                return [got]
            # typed instance attribute: self.attr.m()
            if (
                isinstance(recv, ast.Attribute)
                and isinstance(recv.value, ast.Name)
                and recv.value.id == "self"
                and encl is not None and encl.cls is not None
            ):
                chit = self._resolve_class(encl.cls, sym)
                if chit is not None:
                    tname = chit[1].attr_types.get(recv.attr)
                    if tname:
                        t2 = self._resolve_class(tname, chit[0])
                        if t2 is not None:
                            got = self._class_method(t2[0], t2[1], meth)
                            if got is not None:
                                return [got]
            # bounded receiver-name fallback: package-wide unique name
            if not fallback:
                return []
            return self._unique_name(meth, exclude_cls=None)
        return []

    def _module_for_alias(
        self, sym: ModuleSymbols, root: str, mids: List[str]
    ) -> Optional[ModuleSymbols]:
        """`root(.mid)*` as a module reference through the import table."""
        base = sym.import_mods.get(root)
        if base is None:
            imp = sym.import_syms.get(root)
            if imp is not None:
                base = f"{imp[0]}.{imp[1]}" if imp[0] else imp[1]
        if base is None:
            return None
        dotted = ".".join([base] + mids) if mids else base
        got = self.module_named(dotted)
        if got is not None:
            return got
        return self.module_named(base) if not mids else None

    def _unique_name(
        self, name: str, exclude_cls: Optional[str]
    ) -> List[FuncNode]:
        """The documented fallback: a def name unique across the whole
        analyzed set resolves by name alone. Dunder and ultra-generic
        names never resolve this way."""
        if name.startswith("__") or name in _GENERIC_NAMES:
            return []
        cands = self._by_name.get(name, [])
        return [cands[0]] if len(cands) == 1 else []

    # ---------------------------------------------------------------- edges
    def _build_edges(self) -> None:
        for fn in self.funcs.values():
            out: List[Tuple[FuncNode, ast.Call]] = []
            for sub in self._own_body_walk(fn.node):
                if isinstance(sub, ast.Call):
                    for callee in self.resolve(sub, fn.mod):
                        if callee.node is not fn.node:
                            out.append((callee, sub))
            self._edges[fn.qname] = out

    @staticmethod
    def _own_body_walk(fn_node: ast.AST):
        """Walk a def's body without descending into nested defs (those
        are their own FuncNodes)."""
        stack = list(ast.iter_child_nodes(fn_node))
        while stack:
            node = stack.pop()
            if isinstance(
                node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)
            ):
                continue
            yield node
            stack.extend(ast.iter_child_nodes(node))

    # ------------------------------------------------- capture dispatch
    def _hierarchy(self) -> None:
        """Subclass and property indexes, built on first use (only the
        capture propagation needs them)."""
        if getattr(self, "_children", None) is not None:
            return
        self._children: Dict[int, List[Tuple[ModuleSymbols, ClassInfo]]] = {}
        self._class_key: Dict[int, Tuple[ModuleSymbols, ClassInfo]] = {}
        for path in sorted(self.symbols):
            sym = self.symbols[path]
            for name in sorted(sym.classes):
                info = sym.classes[name]
                self._class_key[id(info.node)] = (sym, info)
                for base in info.bases:
                    hit = self._resolve_class(base, sym)
                    if hit is not None and hit[1] is not info:
                        self._children.setdefault(id(hit[1].node), []).append(
                            (sym, info)
                        )
        self._properties: Dict[str, List[FuncNode]] = {}
        for fn in sorted(self.funcs.values(), key=lambda f: f.qname):
            if fn.cls is not None and any(
                terminal_name(d) in ("property", "cached_property")
                for d in getattr(fn.node, "decorator_list", ())
            ):
                self._properties.setdefault(fn.name, []).append(fn)

    def _method_class(
        self, fn: FuncNode
    ) -> Optional[Tuple[ModuleSymbols, ClassInfo]]:
        sym = self.symbols.get(fn.mod.path)
        if sym is None or fn.cls is None:
            return None
        info = sym.classes.get(fn.cls)
        if info is None or info.methods.get(fn.name) is not fn.node:
            return None
        return sym, info

    def _descends(self, info: ClassInfo, root: ClassInfo) -> bool:
        """Is ``info`` ``root`` or one of its analyzed subclasses?"""
        stack, seen = [root], set()
        while stack:
            cur = stack.pop()
            if cur is info:
                return True
            if id(cur.node) in seen:
                continue
            seen.add(id(cur.node))
            stack.extend(i for _s, i in self._children.get(id(cur.node), []))
        return False

    def overrides(self, fn: FuncNode) -> List[FuncNode]:
        """``fn`` and every override of it in the analyzed subclasses of its
        class (virtual dispatch: a call that resolves to a base method may
        run any of them)."""
        self._hierarchy()
        out = [fn]
        home = self._method_class(fn)
        if home is None:
            return out
        stack, seen = [home], set()
        while stack:
            _sym, info = stack.pop()
            if id(info.node) in seen:
                continue
            seen.add(id(info.node))
            for child in self._children.get(id(info.node), []):
                node = child[1].methods.get(fn.name)
                got = self.funcs.get(id(node)) if node is not None else None
                if got is not None and got not in out:
                    out.append(got)
                stack.append(child)
        return sorted(out, key=lambda f: f.qname)

    def resolve_dispatch(
        self, call: ast.Call, mod: ModuleInfo, receiver_is_tensor: bool
    ) -> List[FuncNode]:
        """Callees of one call site for the capture propagation: what
        :meth:`resolve` finds without its name fallback, widened by virtual
        dispatch to every override of a resolved method; then, for an
        untyped receiver that is not a tensor (a tensor's methods are
        torch's), the name fallback widened to a class hierarchy — every
        method of that name when they all override one analyzed base
        (``program.message(...)`` reaches each program's ``message``)."""
        hits = self.resolve(call, mod, fallback=False)
        if hits:
            out: List[FuncNode] = []
            for h in hits:
                for o in self.overrides(h):
                    if o not in out:
                        out.append(o)
            return out
        f = call.func
        if not isinstance(f, ast.Attribute) or receiver_is_tensor:
            return []
        root = f.value
        while isinstance(root, ast.Attribute):
            root = root.value
        sym = self.symbols[mod.path]
        if isinstance(root, ast.Name) and (
            root.id in sym.import_mods or root.id in mod.torch_names
            or root.id in mod.numpy_names
        ):
            return []  # `torch.where(...)`: a module the set does not hold
        name = f.attr
        if name.startswith("__") or name in _GENERIC_NAMES:
            return []
        cands = [c for c in self._by_name.get(name, []) if c.cls is not None]
        if len(cands) == 1:
            return self.overrides(cands[0])
        if not cands:
            return []
        self._hierarchy()
        homes = [self._method_class(c) for c in cands]
        if any(h is None for h in homes):
            return []
        for root in homes:
            if all(self._descends(h[1], root[1]) for h in homes):
                return cands
        return []

    def properties_named(
        self, attr: ast.Attribute, mod: ModuleInfo
    ) -> List[FuncNode]:
        """Property getters an attribute load may run: the enclosing class's
        own (``self.x``), else every property of that name."""
        self._hierarchy()
        cands = self._properties.get(attr.attr)
        if not cands:
            return []
        encl = self.enclosing(attr)
        if (
            isinstance(attr.value, ast.Name) and attr.value.id == "self"
            and encl is not None and encl.cls is not None
        ):
            chit = self._resolve_class(encl.cls, self.symbols[mod.path])
            if chit is not None:
                got = self._class_method(chit[0], chit[1], attr.attr)
                return [got] if got is not None and got in cands else []
        return list(cands)

    def callees(self, fn: FuncNode) -> List[Tuple[FuncNode, ast.Call]]:
        return self._edges.get(fn.qname, [])

    def node_for(self, def_node: ast.AST) -> Optional[FuncNode]:
        return self.funcs.get(id(def_node))

    def stats(self) -> Dict[str, int]:
        return {
            "modules": len(self.modules),
            "functions": len(self.funcs),
            "call_edges": sum(len(v) for v in self._edges.values()),
            "classes": sum(
                len(s.classes) for s in self.symbols.values()
            ),
        }


#: method names too generic for the unique-name fallback even when the
#: analyzed set happens to define them exactly once
_GENERIC_NAMES = {
    "get", "put", "set", "add", "run", "close", "open", "read", "write",
    "send", "recv", "start", "stop", "update", "append", "pop", "clear",
    "items", "keys", "values", "join", "submit", "result", "wait", "acquire",
    "release", "copy", "encode", "decode", "next", "reset", "flush", "name",
}


# ---------------------------------------------------------------------------
# Interprocedural capture-context propagation (JG1xx across modules)
# ---------------------------------------------------------------------------

def propagate_traced(
    modules: Sequence[ModuleInfo], cg: CallGraph
) -> Dict[str, dict]:
    """Compute each module's capture-context map with cross-module taint.

    Starts from the per-module discovery (``find_traced_defs`` — the
    depth-1 case), then fixpoints over the call graph: a capture context
    calling a function in ANOTHER analyzed module, a method (through
    ``self``, a typed receiver, or virtual dispatch over a class
    hierarchy: :meth:`CallGraph.resolve_dispatch`) or reading a property
    marks the callee a capture context with exactly the argument positions
    that are tainted at the call site. ``# graphlint: host`` on the callee
    stops propagation, same as the module-local walk; constructors never
    become capture contexts.

    Returns {module display path: {id(node): TracedDef}}.
    """
    from janusgraph_tpu_torch.analysis.tracing import TaintWalker, find_traced_defs

    seeds: Dict[str, Dict[int, Optional[Set[int]]]] = {
        m.path: {} for m in modules
    }
    by_path = {m.path: m for m in modules}
    traced: Dict[str, dict] = {}

    def seed(callee: FuncNode, tainted_idx: Set[int]) -> bool:
        tmod = by_path.get(callee.mod.path)
        if tmod is None or callee.name == "__init__":
            return False
        if callee.lineno in tmod.suppressions.host_lines:
            return False
        if callee.lineno in tmod.suppressions.traced_lines:
            # explicitly marked defs pin their own taint choice — call
            # sites don't widen it
            return False
        table = seeds[callee.mod.path]
        present = id(callee.node) in table
        cur = table.get(id(callee.node))
        if present and cur is None:
            return False  # already fully tainted
        nxt = set(tainted_idx) if cur is None else cur | set(tainted_idx)
        if present and nxt == cur:
            return False
        table[id(callee.node)] = nxt
        return True

    for _round in range(16):
        changed = False
        for mod in modules:
            traced[mod.path] = find_traced_defs(mod, seeds=seeds[mod.path])
        for mod in modules:
            for td in traced[mod.path].values():
                if isinstance(td.node, ast.Lambda):
                    continue
                walker = TaintWalker(td, mod)
                walker.run()
                for call, tainted_idx in walker.all_calls:
                    recv_tensor = isinstance(
                        call.func, ast.Attribute
                    ) and walker.is_tainted(call.func.value)
                    for callee in cg.resolve_dispatch(call, mod, recv_tensor):
                        if (
                            callee.mod.path == mod.path
                            and isinstance(call.func, ast.Name)
                        ):
                            continue  # the module-local fixpoint owns these
                        changed |= seed(callee, tainted_idx)
                for attr in walker.attr_loads:
                    if walker.is_tainted(attr.value):
                        continue  # a tensor's attribute, not a property
                    for getter in cg.properties_named(attr, mod):
                        changed |= seed(getter, set())
        if not changed:
            break
    return traced


def capture_reach(
    modules: Sequence[ModuleInfo], traced: Dict[str, dict], cg: CallGraph
) -> Dict[str, str]:
    """{qualified def name: reason} for every def that runs inside a
    capture context (the regions themselves are parts of defs, not defs):
    each traced def, and each ``# graphlint: host`` def a traced def calls
    or reads (a cached constructor of host data whose hit path runs at capture; the rules
    skip its body and the walk stops there, so a callee of it entered
    under a real capture is a cache miss at capture)."""
    from janusgraph_tpu_torch.analysis.tracing import TaintWalker

    by_path = {m.path: m for m in modules}
    out: Dict[str, str] = {}
    for path in sorted(traced):
        mod = by_path[path]
        for td in traced[path].values():
            fn = cg.node_for(td.node)
            if fn is not None:
                out.setdefault(fn.qname, td.reason)
            if isinstance(td.node, ast.Lambda):
                continue
            walker = TaintWalker(td, mod)
            walker.run()
            hits: List[FuncNode] = []
            for call, _idx in walker.all_calls:
                recv_tensor = isinstance(
                    call.func, ast.Attribute
                ) and walker.is_tainted(call.func.value)
                hits.extend(cg.resolve_dispatch(call, mod, recv_tensor))
            for attr in walker.attr_loads:
                if not walker.is_tainted(attr.value):
                    hits.extend(cg.properties_named(attr, mod))
            for callee in hits:
                if callee.lineno in callee.mod.suppressions.host_lines:
                    out.setdefault(callee.qname, "host")
    return dict(sorted(out.items()))
