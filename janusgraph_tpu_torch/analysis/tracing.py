"""Capture-context discovery + tensor taint for the JG1xx/JG303 rules.

The port compiles no superstep with a tracer: its compile is a CUDA-graph
capture. Host code inside a capture runs ONCE, at capture, and never at
replay — a metric, a log record, a numpy constant or a branch taken there
is frozen into every replay, and a device-to-host sync raises (or, outside
``set_sync_debug_mode("error")``, silently stalls the capture).

A *capture context* (the port's traced context) is:

* the body of a ``with torch.cuda.graph(...)`` block — a region of the
  def that holds it, not the whole def;
* a function passed to ``torch.cuda.make_graphed_callables(...)``;
* a def marked ``# graphlint: traced``;
* anything these call, through the call graph
  (``callgraph.propagate_traced``), with parameter-position taint.

Inside a capture context, *tainted* names approximate device tensors: the
parameter positions that receive tainted arguments (counted over the
call's arguments, so a method's ``self`` is never one of them), results
of ``torch`` calls other than host queries
(``torch.cuda.is_current_stream_capturing()`` is a host bool), ``self``
attributes that the class binds to a tensor (``self.steps =
torch.zeros(...)``, ``self.state = {k: v.clone() ...}``), and anything
computed from those. Static metadata (``.shape``/``.dtype``/``.device``,
``.dim()``/``.numel()``, ``len()``) does not propagate taint — ``if
x.ndim == 2:`` is legal and common under capture. A tuple assigned from a
tuple display taints element by element.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass, field
from typing import Dict, FrozenSet, List, Optional, Set, Tuple

#: call names that capture their function-valued arguments
CAPTURE_CALL_NAMES = {"make_graphed_callables"}

#: attributes that are static under capture (reading them breaks no rule
#: and yields a host value)
STATIC_ATTRS = {
    "shape", "ndim", "dtype", "device", "layout", "is_cuda", "is_sparse",
    "requires_grad", "size",
}

#: tensor methods whose result is host metadata, not a tensor
STATIC_METHODS = {
    "size", "dim", "numel", "nelement", "is_contiguous", "stride",
    "element_size", "data_ptr", "get_device", "is_floating_point",
    "is_complex", "storage_offset", "ndimension",
}

#: builtins whose result is host metadata whatever their argument
STATIC_BUILTINS = {"len", "isinstance", "hasattr", "callable", "type", "id"}

#: torch calls that return host values (a bool, a device, a handle), not
#: tensors: a branch on them is static
HOST_QUERIES = {
    "is_current_stream_capturing", "is_available", "device_count",
    "current_device", "get_device_name", "get_device_properties",
    "get_device_capability", "get_sync_debug_mode", "set_sync_debug_mode",
    "is_tensor", "is_storage", "is_floating_point", "is_complex", "numel",
    "device", "dtype", "finfo", "iinfo", "get_default_dtype",
    "is_grad_enabled", "is_inference_mode_enabled", "current_stream",
    "default_stream", "stream", "Event", "Stream", "graph_pool_handle",
    "CUDAGraph", "graph", "no_grad", "inference_mode", "manual_seed",
    "set_grad_enabled", "is_initialized", "get_rank", "get_world_size",
    "memory_allocated", "max_memory_allocated", "Size",
}

#: tensor methods whose result is a tensor: a ``self`` attribute bound
#: from one is a device buffer
TENSOR_METHODS = {
    "clone", "to", "cuda", "contiguous", "detach", "float", "double",
    "half", "bfloat16", "long", "int", "bool", "view", "reshape", "expand",
    "expand_as", "new_zeros", "new_ones", "new_empty", "new_full",
    "new_tensor", "pin_memory",
}


def terminal_name(node: ast.AST) -> Optional[str]:
    """`torch.cuda.graph` -> 'graph', `graph` -> 'graph'."""
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Name):
        return node.id
    return None


def dotted(node: ast.AST) -> Optional[str]:
    """`torch.cuda.graph` -> 'torch.cuda.graph'; None past a call/subscript."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if not isinstance(node, ast.Name):
        return None
    parts.append(node.id)
    return ".".join(reversed(parts))


def call_root(node: ast.AST) -> Optional[str]:
    """The Name an attribute/call chain starts from (`torch.cuda.x()` ->
    'torch')."""
    while isinstance(node, (ast.Attribute, ast.Call, ast.Subscript)):
        node = node.func if isinstance(node, ast.Call) else node.value
    return node.id if isinstance(node, ast.Name) else None


def is_capture_call(call: ast.AST) -> bool:
    """``torch.cuda.graph(...)`` (any alias ending in ``cuda.graph``): a
    ``with`` on it captures."""
    name = dotted(call.func) if isinstance(call, ast.Call) else None
    return name is not None and (name == "cuda.graph" or name.endswith(".cuda.graph"))


def is_torch_call(call: ast.Call, mod) -> bool:
    """A call rooted at a torch module alias that yields a tensor."""
    return (
        call_root(call.func) in mod.torch_names
        and terminal_name(call.func) not in HOST_QUERIES
    )


def _is_tensor_expr(node: ast.AST, mod) -> bool:
    """Does the expression build a device tensor (or a container of them)?"""
    if isinstance(node, ast.Call):
        if is_torch_call(node, mod):
            return True
        return (
            isinstance(node.func, ast.Attribute)
            and node.func.attr in TENSOR_METHODS
        )
    if isinstance(node, (ast.ListComp, ast.SetComp, ast.GeneratorExp)):
        return _is_tensor_expr(node.elt, mod)
    if isinstance(node, ast.DictComp):
        return _is_tensor_expr(node.value, mod)
    return False


def class_tensor_attrs(cls: ast.ClassDef, mod) -> FrozenSet[str]:
    """``self`` attributes a class binds to device tensors in any of its
    methods: the state a captured body reads."""
    out: Set[str] = set()
    for meth in ast.iter_child_nodes(cls):
        if not isinstance(meth, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        for node in ast.walk(meth):
            if isinstance(node, ast.Assign):
                targets, value = node.targets, node.value
            elif isinstance(node, ast.AnnAssign) and node.value is not None:
                targets, value = [node.target], node.value
                ann = dotted(node.annotation) or ""
                if ann.endswith("Tensor"):
                    value = None  # annotated a tensor: bound whatever the value
            else:
                continue
            if value is not None and not _is_tensor_expr(value, mod):
                continue
            for t in targets:
                if (
                    isinstance(t, ast.Attribute)
                    and isinstance(t.value, ast.Name)
                    and t.value.id == "self"
                ):
                    out.add(t.attr)
    return frozenset(out)


@dataclass
class TracedDef:
    node: ast.AST  # FunctionDef | Lambda | With (a capture region)
    #: None = taint every parameter (a captured callable); otherwise the
    #: set of ARGUMENT positions that receive tainted arguments at call
    #: sites (a method's ``self`` is not counted)
    tainted_params: Optional[Set[int]] = None
    reason: str = "capture"
    #: the def's (or the region's def's) class: ``self`` attributes bound
    #: to tensors there are tainted
    tensor_attrs: FrozenSet[str] = field(default_factory=frozenset)
    #: the first parameter is ``self``/``cls`` (a method of a class)
    is_method: bool = False
    #: the def a capture region sits in (None for defs and lambdas)
    owner: Optional[ast.AST] = None

    @property
    def name(self) -> str:
        if isinstance(self.node, ast.With):
            return f"{getattr(self.owner, 'name', '<module>')}:capture"
        return getattr(self.node, "name", "<lambda>")


class _ScopeIndex(ast.NodeVisitor):
    """Index every FunctionDef by name within its lexical scope chain, so a
    Name reference at a call site resolves to the nearest enclosing-scope
    def of that name; also records each def's class and each node's
    enclosing def."""

    def __init__(self):
        self.defs_in_scope: Dict[int, Dict[str, ast.AST]] = {}
        self.parent_scope: Dict[int, Optional[ast.AST]] = {}
        self.scope_of: Dict[int, ast.AST] = {}  # node id -> enclosing scope
        #: id(def) -> (nearest enclosing ClassDef or None, is a method)
        self.class_of: Dict[int, Tuple[Optional[ast.ClassDef], bool]] = {}
        self._stack: List[ast.AST] = []
        self._classes: List[Optional[ast.ClassDef]] = [None]

    def visit(self, node):
        if self._stack:
            self.scope_of[id(node)] = self._stack[-1]
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            scope = self._stack[-1] if self._stack else None
            self.defs_in_scope.setdefault(id(scope), {})[node.name] = node
            self.parent_scope[id(node)] = scope
            cls = self._classes[-1]
            direct = cls is not None and node in cls.body
            static = any(
                terminal_name(d) == "staticmethod" for d in node.decorator_list
            )
            self.class_of[id(node)] = (cls, direct and not static)
        if isinstance(node, ast.ClassDef):
            self._classes.append(node)
            self.generic_visit(node)
            self._classes.pop()
        elif isinstance(
            node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda, ast.Module)
        ):
            self._stack.append(node)
            self.generic_visit(node)
            self._stack.pop()
        else:
            self.generic_visit(node)

    def resolve(self, at: ast.AST, name: str) -> Optional[ast.AST]:
        scope = self.scope_of.get(id(at))
        seen = set()
        while id(scope) not in seen:
            seen.add(id(scope))
            hit = self.defs_in_scope.get(id(scope), {}).get(name)
            if hit is not None:
                return hit
            scope = self.parent_scope.get(id(scope)) if not isinstance(
                scope, ast.Module
            ) else None
            if scope is None:
                hit = self.defs_in_scope.get(id(None), {}).get(name)
                return hit

    def enclosing_def(self, node: ast.AST) -> Optional[ast.AST]:
        scope = self.scope_of.get(id(node))
        while isinstance(scope, ast.Lambda):
            scope = self.scope_of.get(id(scope))
        if isinstance(scope, (ast.FunctionDef, ast.AsyncFunctionDef)):
            return scope
        return None


def _candidate_fns(arg: ast.AST) -> List[ast.AST]:
    """Function references one argument of make_graphed_callables names:
    a Name, ``self.method``, ``partial(f, ...)``, or a tuple/list of them."""
    if isinstance(arg, (ast.Name, ast.Attribute, ast.Lambda)):
        return [arg]
    if isinstance(arg, (ast.Tuple, ast.List)):
        return [r for e in arg.elts for r in _candidate_fns(e)]
    if isinstance(arg, ast.Call) and terminal_name(arg.func) == "partial" and arg.args:
        return _candidate_fns(arg.args[0])
    return []


def module_index(mod) -> _ScopeIndex:
    """The module's scope index, built once and kept on the module."""
    index = getattr(mod, "_scope_index", None)
    if index is None:
        index = _ScopeIndex()
        index.visit(mod.tree)
        mod._scope_index = index
    return index


def _module_roots(mod) -> list:
    """(node, tainted, reason, owner) for the module's own capture
    contexts — markers, capture regions, graphed callables — found once
    and kept on the module."""
    roots = getattr(mod, "_capture_roots", None)
    if roots is not None:
        return roots
    roots = []
    if "graph" not in mod.source and not mod.suppressions.traced_lines:
        mod._capture_roots = roots  # no capture, no graphed callable, no marker
        return roots
    index = module_index(mod)
    for node in ast.walk(mod.tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            if node.lineno in mod.suppressions.traced_lines:
                # explicit marker: capture context, but taint no params —
                # marked helpers usually mix tensors with static config
                roots.append((node, set(), "marker", None))
        elif isinstance(node, ast.With):
            if any(is_capture_call(it.context_expr) for it in node.items):
                roots.append((node, set(), "capture", index.enclosing_def(node)))
        elif (
            isinstance(node, ast.Call)
            and terminal_name(node.func) in CAPTURE_CALL_NAMES
            and node.args
        ):
            for ref in _candidate_fns(node.args[0]):
                if isinstance(ref, ast.Lambda):
                    roots.append((ref, None, "graphed-lambda", None))
                    continue
                fn = None
                if isinstance(ref, ast.Name):
                    fn = index.resolve(ref, ref.id)
                elif (
                    isinstance(ref.value, ast.Name) and ref.value.id == "self"
                ):
                    encl = index.enclosing_def(node)
                    cls = index.class_of.get(id(encl), (None, False))[0]
                    if cls is not None:
                        fn = next(
                            (m for m in cls.body
                             if isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef))
                             and m.name == ref.attr),
                            None,
                        )
                if fn is not None:
                    roots.append((fn, None, "graphed-callable", None))
    mod._capture_roots = roots
    return roots


def find_traced_defs(mod, seeds=None) -> Dict[int, TracedDef]:
    """All capture contexts of a module: {id(node): TracedDef}, where node
    is a def, a lambda, or the ``with`` block of a capture region.

    ``seeds`` is the cross-module extension point: a mapping {id(def
    node): tainted argument positions or None} injected by the call-graph
    fixpoint (callgraph.propagate_traced) for defs reached from a capture
    context in ANOTHER module (or through a method call). The
    module-local walk below is exactly the depth-1 case of that walk.
    """
    traced: Dict[int, TracedDef] = {}
    roots = _module_roots(mod)
    if not roots and not seeds:
        return traced
    index = module_index(mod)
    attrs_cache = mod.__dict__.setdefault("_tensor_attrs", {})

    def class_info(def_node) -> Tuple[FrozenSet[str], bool]:
        cls, is_method = index.class_of.get(id(def_node), (None, False))
        if cls is None:
            return frozenset(), False
        attrs = attrs_cache.get(id(cls))
        if attrs is None:
            attrs = attrs_cache[id(cls)] = class_tensor_attrs(cls, mod)
        return attrs, is_method

    def mark(node, tainted: Optional[Set[int]], reason: str, owner=None):
        cur = traced.get(id(node))
        if cur is None:
            attrs, is_method = class_info(owner if owner is not None else node)
            if isinstance(node, ast.With):
                # a region's `self` is its def's first parameter
                attrs = attrs if is_method else frozenset()
                is_method = False
            traced[id(node)] = TracedDef(
                node, tainted, reason, attrs, is_method, owner
            )
        elif cur.tainted_params is not None:
            if tainted is None:
                cur.tainted_params = None
            else:
                cur.tainted_params |= tainted

    if seeds:
        # cross-module seeds first, so the local fixpoint extends them
        by_id = mod.__dict__.get("_defs_by_id")
        if by_id is None:
            by_id = mod._defs_by_id = {
                id(n): n for n in ast.walk(mod.tree)
                if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
            }
        for key in sorted(seeds, key=lambda k: by_id[k].lineno if k in by_id else 0):
            node = by_id.get(key)
            if node is not None:
                tp = seeds[key]
                mark(
                    node, None if tp is None else set(tp),
                    "called-from-capture",
                )

    for node, tainted, reason, owner in roots:
        mark(node, None if tainted is None else set(tainted), reason, owner)

    # propagate: a capture context calling a same-module def by bare Name
    # makes the callee a capture context too, tainting only the argument
    # positions that are tainted at the call site. Fixpoint over the
    # (small) traced set.
    changed = True
    passes = 0
    while changed and passes < 20:
        changed = False
        passes += 1
        for td in list(traced.values()):
            if isinstance(td.node, ast.Lambda):
                continue
            taint = TaintWalker(td, mod)
            taint.run()
            for call, tainted_idx in taint.local_calls:
                fname = terminal_name(call.func)
                if fname is None:
                    continue
                fn = index.resolve(call, fname)
                if fn is None or not isinstance(
                    fn, (ast.FunctionDef, ast.AsyncFunctionDef)
                ):
                    continue
                if fn.lineno in mod.suppressions.host_lines:
                    continue  # explicit host helper: no capture propagation
                prev = traced.get(id(fn))
                before = (
                    None if prev is None
                    else (None if prev.tainted_params is None
                          else frozenset(prev.tainted_params))
                )
                mark(fn, set(tainted_idx), "called-from-capture")
                after = traced[id(fn)].tainted_params
                after_k = None if after is None else frozenset(after)
                if prev is None or before != after_k:
                    changed = True
    return traced


def _tensor_check(test: ast.AST) -> Tuple[Optional[str], bool]:
    """(name, True) for `isinstance(name, ...Tensor)`, (name, False) for
    its negation; (None, False) otherwise."""
    positive = True
    if isinstance(test, ast.UnaryOp) and isinstance(test.op, ast.Not):
        test, positive = test.operand, False
    if (
        isinstance(test, ast.Call)
        and terminal_name(test.func) == "isinstance"
        and len(test.args) == 2
        and isinstance(test.args[0], ast.Name)
    ):
        kinds = test.args[1]
        elts = kinds.elts if isinstance(kinds, ast.Tuple) else [kinds]
        if any((dotted(e) or "").endswith("Tensor") for e in elts):
            return test.args[0].id, positive
    return None, False


def _leaves(body: List[ast.stmt]) -> bool:
    """Does a block always leave the def (ends in return or raise)?"""
    return bool(body) and isinstance(body[-1], (ast.Return, ast.Raise))


class TaintWalker:
    """Single forward pass over one capture context's body, tracking
    tainted names and recording (a) rule-relevant events for
    trace_rules/shape_rules, (b) calls with their tainted argument
    positions and (c) attribute loads (property reads) for the
    cross-module fixpoint."""

    def __init__(self, td: TracedDef, mod):
        self.td = td
        self.mod = mod
        self.tainted: Set[str] = set()
        fn = td.node
        self.self_name: Optional[str] = None
        if isinstance(fn, ast.With):
            params: List[str] = []
            owner = td.owner
            if isinstance(owner, (ast.FunctionDef, ast.AsyncFunctionDef)):
                if td.tensor_attrs:
                    first = owner.args.posonlyargs + owner.args.args
                    if first:
                        self.self_name = first[0].arg
                # the region starts from its def's taint: the tensors the
                # def builds (or takes, annotated) before it captures
                pre = TaintWalker(TracedDef(
                    owner, set(), "capture", td.tensor_attrs,
                    self.self_name is not None,
                ), mod)
                pre.run()
                self.tainted = set(pre.tainted)
        else:
            args = fn.args
            params = (
                [a.arg for a in args.posonlyargs]
                + [a.arg for a in args.args]
                + ([args.vararg.arg] if args.vararg else [])
                + [a.arg for a in args.kwonlyargs]
                + ([args.kwarg.arg] if args.kwarg else [])
            )
            if td.is_method and params:
                self.self_name = params[0]
                params = params[1:]
        if td.tainted_params is None:
            self.tainted |= set(params)
        else:
            self.tainted |= {
                p for i, p in enumerate(params) if i in td.tainted_params
            }
        if not isinstance(fn, (ast.With, ast.Lambda)):
            # a parameter annotated as a tensor is one, whoever calls
            for a in fn.args.posonlyargs + fn.args.args + fn.args.kwonlyargs:
                if a.arg != self.self_name and a.annotation is not None and (
                    "Tensor" in ast.unparse(a.annotation)
                ):
                    self.tainted.add(a.arg)
        #: (Name call node, tainted positional indices) for local-def calls
        self.local_calls: List[Tuple[ast.Call, Set[int]]] = []
        #: every call node with its tainted positional indices — Name AND
        #: Attribute receivers, for the cross-module call-graph fixpoint
        self.all_calls: List[Tuple[ast.Call, Set[int]]] = []
        #: attribute loads that are not a call's callee (property reads)
        self.attr_loads: List[ast.Attribute] = []
        #: events: ("coerce"|"branch"|"hostsync", node, detail)
        self.events: List[Tuple[str, ast.AST, str]] = []

    # ------------------------------------------------------------ expression
    def is_tainted(self, node: ast.AST) -> bool:
        if isinstance(node, ast.Name):
            return node.id in self.tainted
        if isinstance(node, ast.Attribute):
            if node.attr in STATIC_ATTRS:
                return False
            if (
                isinstance(node.value, ast.Name)
                and node.value.id == self.self_name
            ):
                return node.attr in self.td.tensor_attrs
            return self.is_tainted(node.value)
        if isinstance(node, ast.Subscript):
            return self.is_tainted(node.value) or self.is_tainted(node.slice)
        if isinstance(node, ast.Call):
            t = terminal_name(node.func)
            if isinstance(node.func, ast.Attribute) and t in STATIC_METHODS:
                return False
            if isinstance(node.func, ast.Name) and t in STATIC_BUILTINS:
                return False
            if is_torch_call(node, self.mod):
                return True
            if call_root(node.func) in self.mod.torch_names:
                return False  # a host query
            if isinstance(node.func, ast.Attribute) and self.is_tainted(
                node.func.value
            ):
                return True
            return any(self.is_tainted(a) for a in node.args) or any(
                self.is_tainted(kw.value) for kw in node.keywords
            )
        if isinstance(node, (ast.BinOp,)):
            return self.is_tainted(node.left) or self.is_tainted(node.right)
        if isinstance(node, ast.UnaryOp):
            return self.is_tainted(node.operand)
        if isinstance(node, ast.BoolOp):
            return any(self.is_tainted(v) for v in node.values)
        if isinstance(node, ast.Compare):
            return self.is_tainted(node.left) or any(
                self.is_tainted(c) for c in node.comparators
            )
        if isinstance(node, ast.IfExp):
            return any(
                self.is_tainted(n) for n in (node.test, node.body, node.orelse)
            )
        if isinstance(node, (ast.Tuple, ast.List, ast.Set)):
            return any(self.is_tainted(e) for e in node.elts)
        if isinstance(node, ast.Dict):
            return any(
                v is not None and self.is_tainted(v)
                for v in list(node.keys) + list(node.values)
            )
        if isinstance(node, ast.Starred):
            return self.is_tainted(node.value)
        if isinstance(node, (ast.ListComp, ast.SetComp, ast.DictComp, ast.GeneratorExp)):
            return any(self.is_tainted(g.iter) for g in node.generators)
        if isinstance(node, ast.Slice):
            return any(
                p is not None and self.is_tainted(p)
                for p in (node.lower, node.upper, node.step)
            )
        return False

    def _branch_test_tainted(self, test: ast.AST) -> bool:
        """Is a branch test tainted, ignoring identity checks (`x is None`),
        isinstance and a host key's membership in a dict of buffers (`k in
        self.mem`) — all static under capture."""
        if isinstance(test, ast.Compare) and all(
            isinstance(op, (ast.Is, ast.IsNot)) for op in test.ops
        ):
            return False
        if (
            isinstance(test, ast.Compare)
            and all(isinstance(op, (ast.In, ast.NotIn)) for op in test.ops)
            and not self.is_tainted(test.left)
        ):
            return False
        if isinstance(test, ast.BoolOp):
            return any(self._branch_test_tainted(v) for v in test.values)
        if isinstance(test, ast.UnaryOp) and isinstance(test.op, ast.Not):
            return self._branch_test_tainted(test.operand)
        return self.is_tainted(test)

    # ------------------------------------------------------------- statements
    def run(self):
        for stmt in getattr(self.td.node, "body", []):
            self._stmt(stmt)

    def _assign_target(self, target: ast.AST, tainted: bool):
        if isinstance(target, ast.Name):
            if tainted:
                self.tainted.add(target.id)
            else:
                self.tainted.discard(target.id)
        elif isinstance(target, (ast.Tuple, ast.List)):
            for e in target.elts:
                self._assign_target(e, tainted)
        elif isinstance(target, ast.Starred):
            self._assign_target(target.value, tainted)
        # attribute/subscript stores don't change name taint

    def _assign(self, target: ast.AST, value: ast.AST):
        """`a, b = x, y` taints pairwise; anything else as one value."""
        if (
            isinstance(target, (ast.Tuple, ast.List))
            and isinstance(value, (ast.Tuple, ast.List))
            and len(target.elts) == len(value.elts)
            and not any(isinstance(e, ast.Starred) for e in target.elts + value.elts)
        ):
            for t, v in zip(target.elts, value.elts):
                self._assign(t, v)
            return
        self._assign_target(target, self.is_tainted(value))

    def _scan_expr(self, node: ast.AST):
        """Record rule events, calls and attribute loads in one expression."""
        callees = set()
        for sub in ast.walk(node):
            if isinstance(sub, ast.Call):
                callees.add(id(sub.func))
        for sub in ast.walk(node):
            if isinstance(sub, ast.Attribute):
                if isinstance(sub.ctx, ast.Load) and id(sub) not in callees:
                    self.attr_loads.append(sub)
                continue
            if not isinstance(sub, ast.Call):
                continue
            t = terminal_name(sub.func)
            if t in ("float", "int", "bool", "complex") and isinstance(
                sub.func, ast.Name
            ):
                if any(self.is_tainted(a) for a in sub.args):
                    self.events.append(("coerce", sub, t))
            elif isinstance(sub.func, ast.Attribute):
                if t in ("item", "tolist"):
                    if self.is_tainted(sub.func.value):
                        self.events.append(("hostsync", sub, t))
                elif t in ("cpu", "numpy", "synchronize"):
                    self.events.append(("hostsync", sub, t))
                elif t == "to" and any(
                    isinstance(a, ast.Constant) and a.value == "cpu"
                    for a in list(sub.args) + [kw.value for kw in sub.keywords]
                ):
                    self.events.append(("hostsync", sub, 'to("cpu")'))
            if isinstance(sub.func, (ast.Name, ast.Attribute)):
                idx = {
                    i for i, a in enumerate(sub.args) if self.is_tainted(a)
                }
                if isinstance(sub.func, ast.Name):
                    self.local_calls.append((sub, idx))
                self.all_calls.append((sub, idx))

    def _stmt(self, stmt: ast.AST):
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            return  # nested defs analyzed via their own traced entries
        if isinstance(stmt, ast.Assign):
            self._scan_expr(stmt.value)
            for t in stmt.targets:
                if not isinstance(t, ast.Name):
                    self._scan_expr(t)
                self._assign(t, stmt.value)
            return
        if isinstance(stmt, ast.AnnAssign):
            if stmt.value is not None:
                self._scan_expr(stmt.value)
                self._assign(stmt.target, stmt.value)
            return
        if isinstance(stmt, ast.AugAssign):
            self._scan_expr(stmt.value)
            if self.is_tainted(stmt.value):
                self._assign_target(stmt.target, True)
            return
        if isinstance(stmt, (ast.If, ast.While)):
            self._scan_expr(stmt.test)
            if self._branch_test_tainted(stmt.test):
                self.events.append(
                    ("branch", stmt, ast.dump(stmt.test)[:40])
                )
            name, positive = _tensor_check(stmt.test)
            if name is None or isinstance(stmt, ast.While):
                for s in stmt.body:
                    self._stmt(s)
                for s in stmt.orelse:
                    self._stmt(s)
                return
            # `if isinstance(x, torch.Tensor): ... else: <host branch>`:
            # x is no tensor on the branch the check rules out, nor after
            # the if when the tensor branch always leaves the def
            was = name in self.tainted
            tensor_part, host_part = (
                (stmt.body, stmt.orelse) if positive else (stmt.orelse, stmt.body)
            )
            for s in tensor_part:
                self._stmt(s)
            self.tainted.discard(name)
            for s in host_part:
                self._stmt(s)
            if was and not _leaves(tensor_part):
                self.tainted.add(name)
            return
        if isinstance(stmt, ast.Assert):
            self._scan_expr(stmt.test)
            if self._branch_test_tainted(stmt.test):
                self.events.append(("branch", stmt, "assert"))
            return
        if isinstance(stmt, ast.For):
            self._scan_expr(stmt.iter)
            # iterating a tensor unrolls over its rows at capture, but
            # iterating a dict of buffers is idiomatic in every executor
            # here (`for k, buf in self.state.items()`), and the two are
            # indistinguishable statically — so loop targets stay untainted
            self._assign_target(stmt.target, False)
            for s in stmt.body:
                self._stmt(s)
            for s in stmt.orelse:
                self._stmt(s)
            return
        if isinstance(stmt, (ast.Return, ast.Expr)):
            if getattr(stmt, "value", None) is not None:
                self._scan_expr(stmt.value)
            return
        if isinstance(stmt, (ast.With, ast.AsyncWith)):
            for item in stmt.items:
                self._scan_expr(item.context_expr)
            for s in stmt.body:
                self._stmt(s)
            return
        if isinstance(stmt, ast.Try):
            for part in (stmt.body, stmt.orelse, stmt.finalbody):
                for s in part:
                    self._stmt(s)
            for h in stmt.handlers:
                for s in h.body:
                    self._stmt(s)
            return
        # fallback: scan any expressions hanging off the statement
        for sub in ast.iter_child_nodes(stmt):
            if isinstance(sub, ast.expr):
                self._scan_expr(sub)


class CaptureProbe:
    """A ``sys.setprofile`` hook that records every def of one package
    entered while it is active — the check that the capture-context
    discovery matches what really runs under a capture (enter it inside
    the ``with torch.cuda.graph(...)`` block). Keys match
    :func:`janusgraph_tpu_torch.analysis.capture_reach`'s:
    ``display/path.py:Qual.name``, paths relative to ``cwd``; a generator
    expression or lambda counts as the def it sits in."""

    def __init__(self, package_dir: str, cwd: Optional[str] = None):
        import os

        self._root = os.path.realpath(package_dir) + os.sep
        self._cwd = os.path.realpath(cwd or os.getcwd())
        self._codes: Set[object] = set()
        self._prev = None

    def _hook(self, frame, event, _arg):
        if event == "call":
            code = frame.f_code
            if code not in self._codes:
                self._codes.add(code)

    def __enter__(self) -> "CaptureProbe":
        import sys

        self._prev = sys.getprofile()
        sys.setprofile(self._hook)
        return self

    def __exit__(self, *exc) -> None:
        import sys

        sys.setprofile(self._prev)

    def keys(self) -> Set[str]:
        import os

        out: Set[str] = set()
        for code in self._codes:
            path = os.path.realpath(code.co_filename)
            if not path.startswith(self._root) or path == os.path.realpath(__file__):
                continue  # another package, or the probe's own __exit__
            parts = getattr(code, "co_qualname", code.co_name).split(".")
            while parts and parts[-1].startswith("<"):
                parts.pop()  # <genexpr>/<lambda>/<locals>: the enclosing def
            if not parts:
                continue  # module-level code
            disp = os.path.relpath(path, self._cwd)
            if disp.startswith(".."):
                disp = path
            out.add(f"{disp}:{'.'.join(parts)}")
        return out
