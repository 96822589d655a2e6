"""JG204 — swallowed backend errors; JG206 — unbounded queues;
JG207 — synchronous remote round-trips in loops; JG208 — outbound
socket/HTTP calls without an explicit timeout; JG209 — row-wise
multi-hop adjacency expansion.

JG204: the exception taxonomy (janusgraph_tpu_torch/exceptions.py) splits
backend failures into temporary (retriable) and permanent; the whole
self-healing stack — backend_op retries, circuit breaking, torn-commit
recovery — hangs off that split. An ``except`` clause that catches
``BackendError`` / ``TemporaryBackendError`` (or their locking
subclasses) and neither re-raises nor routes the operation back through
``backend_op.execute`` silently deletes a failure the recovery machinery
was built to absorb: the caller sees success, the data may be gone.

A handler passes when its body contains a ``raise`` on some path or a call
to ``backend_op.execute`` / bare ``execute``. Protocol boundaries that
serialize the error to a peer instead should carry a justified
``# graphlint: disable=JG204 -- why`` suppression.

JG206: a ``queue.Queue()`` / ``collections.deque()`` constructed without
a ``maxsize`` / ``maxlen`` bound (absent, 0, or None) is an overload
hazard: under sustained load an unbounded buffer converts backpressure
into unbounded memory growth and latency convoys — exactly the collapse
mode the admission controller's BOUNDED wait queue exists to prevent
(server/admission.py; every in-tree ring — spans, flight recorder, logs —
is a ``deque(maxlen=...)`` for the same reason). Where a bound is
structurally guaranteed (e.g. a BFS work queue that enqueues each vertex
at most once), carry a justified ``# graphlint: disable=JG206 -- why``
suppression instead of a fake numeric bound.

JG207: a ``for``/``while`` loop whose body performs one synchronous
remote round-trip per iteration (``conn.request(...)`` on a conn-named
receiver, or the remote clients' ``_call``/``_call_ledger``) pays a full
wire RTT per element — the one-op-per-round-trip shape the pipelined
framing (storage/pipeline.py) exists to retire. Batch the ops
(``get_slice_multi`` / ``mutate_many``), or submit them all and gather
futures over the pipelined mux. Cold paths where the iteration count is
structurally tiny (e.g. a fixed handful of schema registrations) carry a
justified ``# graphlint: disable=JG207 -- why`` suppression. Calls
inside a nested function/lambda defined in the loop body are NOT
flagged — deferred submission is exactly the fix.

JG208: an outbound connection or HTTP request made without a finite
timeout — ``urllib.request.urlopen``, ``socket.create_connection``,
``http.client.HTTP(S)Connection``, or a ``requests.<verb>`` call with
the ``timeout`` argument absent or ``None`` — waits forever on a dead
or PARTITIONED peer: the exact failure mode the serving fleet's router
probes, gossip rounds, and drain handoffs (server/fleet.py) must survive
(a replica that looks alive but cannot answer would otherwise hang the
router thread that probed it). Pass an explicit finite timeout; where an
outer mechanism provably bounds the wait (e.g. an alarm/watchdog owns
the socket), carry a justified ``# graphlint: disable=JG208 -- why``
suppression.

JG209: a ``for`` loop that iterates an adjacency read (``get_edges`` /
``adjacency_edges``) and performs FURTHER per-vertex adjacency reads in
its body is the row-wise multi-hop expansion shape — one store round per
neighbor per hop, when a batched path exists (the traversal engine's
multiquery ``tx.prefetch`` before each expansion) and recurring hot
chains spill to frontier supersteps over the CSR snapshot entirely
(olap/spillover.py). Single-level per-vertex enumeration (exports, a
one-hop scan) is NOT flagged; structurally tiny fan-outs carry a
justified ``# graphlint: disable=JG209 -- why`` suppression.
"""

from __future__ import annotations

import ast
from typing import List, Set, Tuple

from janusgraph_tpu_torch.analysis.core import Finding, RULES
from janusgraph_tpu_torch.analysis.tracing import terminal_name

#: exception names whose swallowing loses a retriable/recoverable failure
BACKEND_ERROR_NAMES = {
    "BackendError",
    "TemporaryBackendError",
    "TemporaryLockingError",
}


def _caught_names(type_node) -> Set[str]:
    """Terminal names of the exception classes an except clause catches."""
    if type_node is None:
        return set()
    nodes = (
        list(type_node.elts) if isinstance(type_node, ast.Tuple) else [type_node]
    )
    out = set()
    for n in nodes:
        t = terminal_name(n)
        if t:
            out.add(t)
    return out


def _handler_routes_or_reraises(handler: ast.ExceptHandler) -> bool:
    for node in ast.walk(handler):
        if isinstance(node, ast.Raise):
            return True
        if isinstance(node, ast.Call):
            t = terminal_name(node.func)
            if t == "execute":
                f = node.func
                if isinstance(f, ast.Name):
                    return True  # bare execute(...) import style
                if isinstance(f, ast.Attribute) and (
                    terminal_name(f.value) == "backend_op"
                ):
                    return True
    return False


#: queue-constructor vocabulary: {callable name: bounding kwarg}. The
#: deque bound may also ride as the SECOND positional argument; Queue's
#: as the first.
_QUEUE_CTORS = {
    "Queue": ("maxsize", 0),
    "LifoQueue": ("maxsize", 0),
    "PriorityQueue": ("maxsize", 0),
    "deque": ("maxlen", 1),
}


def _is_unbounded_literal(node) -> bool:
    """True for the explicitly-unbounded spellings: 0 and None."""
    return isinstance(node, ast.Constant) and node.value in (0, None)


def _unbounded_queue_call(node: ast.Call):
    """Return the flagged constructor name when this call builds an
    unbounded queue/deque (bound absent, 0, or None); None otherwise."""
    name = terminal_name(node.func)
    spec = _QUEUE_CTORS.get(name or "")
    if spec is None:
        return None
    kwarg, pos = spec
    # qualified calls must come off the expected module to avoid flagging
    # unrelated Queue classes (multiprocessing.Queue is bounded-ish but
    # foreign; only queue.* / collections.* spellings are in scope here)
    f = node.func
    if isinstance(f, ast.Attribute):
        owner = terminal_name(f.value)
        if owner not in ("queue", "collections"):
            return None
    bound = None
    if len(node.args) > pos:
        bound = node.args[pos]
    for kw in node.keywords:
        if kw.arg == kwarg:
            bound = kw.value
    if bound is None or _is_unbounded_literal(bound):
        return name
    return None


#: remote-client method names whose per-iteration use is one RTT each
_ROUNDTRIP_METHODS = {"_call", "_call_ledger"}

#: JG208 vocabulary: outbound-call spellings and where their timeout may
#: ride. ``positional`` is the 0-based index a positional timeout may
#: occupy (None = keyword-only in practice).
_OUTBOUND_CALLS = {
    "urlopen": 1,               # urlopen(url, data=None, timeout=...)
    "create_connection": 1,     # create_connection(addr, timeout=...)
    "HTTPConnection": None,     # ctor: timeout keyword
    "HTTPSConnection": None,
}

#: requests-style verb methods (requests.get/post/... have NO default
#: timeout — the library's most famous footgun)
_REQUESTS_VERBS = {"get", "post", "put", "patch", "delete", "head",
                   "options", "request"}


def _timeout_of(node: ast.Call, positional) -> Tuple[bool, object]:
    """(present, value_node) for the call's timeout argument."""
    for kw in node.keywords:
        if kw.arg == "timeout":
            return True, kw.value
    if positional is not None and len(node.args) > positional:
        return True, node.args[positional]
    return False, None


def _untimed_outbound_call(node: ast.Call):
    """The offending callable name when this call opens an outbound
    socket/HTTP request without a finite timeout; None otherwise."""
    name = terminal_name(node.func)
    if name in _OUTBOUND_CALLS:
        positional = _OUTBOUND_CALLS[name]
    elif (
        name in _REQUESTS_VERBS
        and isinstance(node.func, ast.Attribute)
        and terminal_name(node.func.value) == "requests"
    ):
        # requests.<verb>(...) — attribute calls off a receiver whose
        # terminal name is `requests` (module or session variables named
        # otherwise are out of scope: name-based like the other rules)
        positional = None
    else:
        return None
    present, value = _timeout_of(node, positional)
    if not present:
        return name
    if isinstance(value, ast.Constant) and value.value is None:
        return name  # timeout=None: the explicitly-unbounded spelling
    return None

#: per-vertex adjacency-read vocabulary (JG209): the store reads a
#: row-by-row multi-hop expansion pays once per neighbor per hop
_ADJACENCY_METHODS = {"get_edges", "adjacency_edges"}


def _is_adjacency_call(node: ast.Call) -> bool:
    return terminal_name(node.func) in _ADJACENCY_METHODS


def _contains_adjacency_call(node) -> bool:
    for n in ast.walk(node):
        if isinstance(n, ast.Call) and _is_adjacency_call(n):
            return True
    return False


def _is_roundtrip_call(node: ast.Call) -> bool:
    t = terminal_name(node.func)
    if t in _ROUNDTRIP_METHODS:
        return True
    if t == "request" and isinstance(node.func, ast.Attribute):
        recv = terminal_name(node.func.value)
        return bool(recv) and "conn" in recv.lower()
    return False


def _loop_body_calls(loop) -> "list":
    """Calls lexically inside the loop body, excluding nested function/
    class scopes (a deferred call is the pipelined fix, not the bug)."""
    out = []
    stack = list(loop.body) + list(getattr(loop, "orelse", []))
    while stack:
        n = stack.pop()
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                          ast.ClassDef, ast.Lambda)):
            continue
        if isinstance(n, ast.Call):
            out.append(n)
        stack.extend(ast.iter_child_nodes(n))
    return out


def check_module(mod) -> List[Finding]:
    findings: List[Finding] = []
    for node in ast.walk(mod.tree):
        if isinstance(node, ast.For) and _contains_adjacency_call(
            node.iter
        ):
            # JG209: the row-wise multi-hop shape — expanding the
            # NEIGHBORS of an adjacency read with further per-vertex
            # adjacency reads (one store round per neighbor per hop)
            for call in _loop_body_calls(node):
                if _is_adjacency_call(call):
                    findings.append(Finding(
                        "JG209", RULES["JG209"].severity, mod.path,
                        call.lineno, call.col_offset,
                        "per-neighbor adjacency read inside an "
                        "adjacency-expansion loop: a row-wise multi-hop "
                        "walk — batch with the multiquery prefetch, or "
                        "let the spillover planner (olap/spillover.py) "
                        "run the chain as frontier supersteps over the "
                        "CSR snapshot",
                    ))
        if isinstance(node, (ast.For, ast.While)):
            for call in _loop_body_calls(node):
                if _is_roundtrip_call(call):
                    findings.append(Finding(
                        "JG207", RULES["JG207"].severity, mod.path,
                        call.lineno, call.col_offset,
                        "synchronous remote round-trip per loop "
                        "iteration: one full wire RTT per element — "
                        "batch (get_slice_multi/mutate_many) or gather "
                        "over the pipelined mux; suppress with "
                        "justification when N is structurally tiny",
                    ))
        if isinstance(node, ast.Call):
            offender = _untimed_outbound_call(node)
            if offender is not None:
                findings.append(Finding(
                    "JG208", RULES["JG208"].severity, mod.path,
                    node.lineno, node.col_offset,
                    f"{offender}() without a finite timeout: a dead or "
                    "partitioned peer hangs this caller forever — pass "
                    "an explicit timeout (router probes, gossip, and "
                    "drain handoffs all bound theirs), or suppress with "
                    "justification where an outer mechanism provably "
                    "bounds the wait",
                ))
            name = _unbounded_queue_call(node)
            if name is not None:
                kwarg = _QUEUE_CTORS[name][0]
                findings.append(Finding(
                    "JG206", RULES["JG206"].severity, mod.path,
                    node.lineno, node.col_offset,
                    f"{name}() without a {kwarg} bound: an unbounded "
                    "buffer turns overload backpressure into memory "
                    "growth and latency convoys — size it, or suppress "
                    "with a justification when a bound is structurally "
                    "guaranteed",
                ))
            continue
        if not isinstance(node, ast.ExceptHandler):
            continue
        caught = _caught_names(node.type) & BACKEND_ERROR_NAMES
        if not caught:
            continue
        if _handler_routes_or_reraises(node):
            continue
        names = "/".join(sorted(caught))
        findings.append(Finding(
            "JG204", RULES["JG204"].severity, mod.path,
            node.lineno, node.col_offset,
            f"except clause swallows {names} without re-raising or routing "
            "through backend_op.execute — a dropped temporary failure "
            "silently loses the retry/recovery path (the caller sees "
            "success, the operation did not happen)",
        ))
    return findings
