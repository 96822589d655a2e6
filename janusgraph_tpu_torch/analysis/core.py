"""graphlint core: rule registry, findings, suppressions, and the Analyzer.

The analyzer is one pass per file (parse + per-module rule visitors) plus
one cross-file pass (the lock-order graph, which only becomes a finding
once every module's acquisition edges are known).
"""

from __future__ import annotations

import ast
import os
import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

SEV_ERROR = "error"
SEV_WARNING = "warning"


@dataclass(frozen=True)
class Rule:
    id: str
    severity: str
    summary: str


#: Rule registry. Severity here is the default; findings carry their own so
#: a rule can downgrade heuristic hits (e.g. transitive blocking calls).
RULES: Dict[str, Rule] = {
    r.id: r
    for r in [
        # -- import/syntax sweep (--check-imports) --------------------------
        Rule("JG001", SEV_ERROR, "file does not compile (syntax error)"),
        Rule("JG002", SEV_ERROR, "module fails to import"),
        # -- trace safety ---------------------------------------------------
        Rule("JG101", SEV_ERROR,
             "Python coercion or branch on a tensor inside a CUDA-graph "
             "capture context (a device-to-host sync: the capture raises, "
             "or the branch taken at capture is frozen into every replay)"),
        Rule("JG102", SEV_ERROR,
             "numpy call inside a CUDA-graph capture context (it runs "
             "once, at capture; its result is frozen into every replay)"),
        Rule("JG103", SEV_ERROR,
             "recapture hazard: a CUDA graph captured and not kept, kept "
             "under a non-constant key, or captured inside a loop body"),
        Rule("JG104", SEV_ERROR,
             "tensor read by a captured body and later rebound "
             "(self.x = new) instead of written in place (copy_): every "
             "replay reads the old storage"),
        Rule("JG105", SEV_ERROR,
             "host sync inside a CUDA-graph capture context (.item()/"
             ".tolist()/.cpu()/.numpy()/.to(\"cpu\")/synchronize())"),
        Rule("JG106", SEV_ERROR,
             "metric/span recording call inside a CUDA-graph capture "
             "context (records once per CAPTURE, never per replay; "
             "coercing a tensor attribute value forces a host sync — "
             "record from host code after the replay)"),
        Rule("JG107", SEV_ERROR,
             "structured-log or flight-recorder call inside a CUDA-graph "
             "capture context (the record is emitted once per CAPTURE "
             "with capture-time values, and coercing a tensor field "
             "forces a host sync — log/record from host code after the "
             "replay)"),
        Rule("JG108", SEV_ERROR,
             "profiler/ledger/cost-model call inside a CUDA-graph capture "
             "context (ledger accruals and digest-table observations fire "
             "once per CAPTURE with capture-time values, never per replay "
             "— accrue/observe/harvest from host code after the replay)"),
        Rule("JG110", SEV_ERROR,
             "metric/series name built from non-literal parts (f-string "
             "interpolation or + concatenation): the registry never "
             "evicts, so an unbounded value domain in a metric name is "
             "unbounded memory and exposition growth — use literal "
             "names, or carry a justified suppression naming the bound "
             "(e.g. digests from the top-K-evicted price book)"),
        Rule("JG111", SEV_ERROR,
             "time.time() subtraction used as a duration: the wall clock "
             "steps under NTP slew/step and DST, so a wall-clock delta "
             "can go negative or jump — durations and interval math must "
             "use time.monotonic() (or perf_counter); wall stamps for "
             "EVENT STAMPING or cross-process offset math are exempt via "
             "`# graphlint: wallclock -- why`"),
        Rule("JG112", SEV_ERROR,
             "background-thread run loop dies or swallows silently: a "
             "daemon thread's loop must catch broad exceptions AND "
             "record them (flight event, log call, counter — anything "
             "observable) before dying or continuing; a silently-dead "
             "sampler is a lying profiler, and `except Exception: pass` "
             "hides the death the stall watchdog exists to catch"),
        Rule("JG113", SEV_ERROR,
             "fan-out publish into subscriber queues without a "
             "drop/accounting path: a blocking put() inside a fan-out "
             "loop convoys EVERY subscriber behind the slowest one "
             "(one wedged consumer stalls the producer and so the "
             "whole bus); use put_nowait()/put(block=False) with a "
             "caught queue.Full that RECORDS the drop — a slow "
             "consumer must cost itself data, never stall producers"),
        # -- lock discipline ------------------------------------------------
        Rule("JG201", SEV_ERROR,
             "lock.acquire() without with/try-finally release on all paths"),
        Rule("JG202", SEV_ERROR,
             "inconsistent lock acquisition order (deadlock risk)"),
        Rule("JG203", SEV_ERROR,
             "blocking call (sleep / socket / RPC) while holding a lock"),
        Rule("JG204", SEV_ERROR,
             "except clause swallows BackendError/TemporaryBackendError "
             "without re-raising or routing through backend_op.execute "
             "(a dropped temporary failure loses the retry/recovery path)"),
        Rule("JG206", SEV_ERROR,
             "unbounded queue: queue.Queue()/collections.deque() without "
             "a maxsize/maxlen bound — under overload an unbounded "
             "buffer converts backpressure into memory growth and "
             "latency convoys (the serving path sheds load instead; "
             "suppress with justification where a bound is structurally "
             "guaranteed)"),
        Rule("JG207", SEV_ERROR,
             "synchronous remote round-trip inside a loop: a per-"
             "iteration blocking wire call (conn.request / _call / "
             "_call_ledger) pays one full RTT per element — batch the "
             "ops (get_slice_multi / mutate_many) or gather them over "
             "the pipelined mux (storage/pipeline.py) so fixed per-"
             "message cost amortizes; suppress with justification on "
             "cold paths where N is structurally tiny"),
        Rule("JG208", SEV_ERROR,
             "outbound socket/HTTP call without an explicit timeout: "
             "urlopen / socket.create_connection / HTTP(S)Connection / "
             "requests.<verb> with no finite timeout turns a dead or "
             "partitioned peer into a hung caller — every remote hop "
             "(router probes, gossip, drain handoff, driver requests) "
             "must bound its wait (timeout=None is the explicitly-"
             "unbounded spelling, not a bound); suppress with "
             "justification where an outer mechanism provably bounds "
             "the wait"),
        Rule("JG209", SEV_ERROR,
             "multi-hop adjacency expansion as a Python loop over "
             "per-vertex store reads: an adjacency read (get_edges / "
             "adjacency_edges) inside a loop that itself iterates an "
             "adjacency read pays one store round per NEIGHBOR per hop "
             "— use the multiquery prefetch batch (tx.prefetch before "
             "the expansion, the traversal engine's own path) or the "
             "OLAP spillover planner (olap/spillover.py), which executes "
             "the whole chain as frontier supersteps over the CSR "
             "snapshot; suppress with justification where the fan-out "
             "is structurally tiny"),
        # -- concurrency (whole-program, graphlint v2) ----------------------
        Rule("JG401", SEV_ERROR,
             "shared attribute mutated from both a thread-entry context "
             "(Thread target / pool submit) and a non-thread context "
             "with no common lock across the mutation sites — concurrent "
             "mutation races; guard every site with one lock or confine "
             "the state to a single thread"),
        Rule("JG402", SEV_ERROR,
             "ambient contextvar scope (deadline / tracer span / "
             "profiler ledger) accessed on a fresh thread without an "
             "explicit handoff — contextvars don't cross thread "
             "boundaries, so the read silently yields the empty default; "
             "capture with contextvars.copy_context()/capture_scope at "
             "the spawn site, re-enter the scope explicitly, or mark "
             "`# graphlint: handoff` naming the mechanism"),
        Rule("JG403", SEV_ERROR,
             "blocking call while holding a lock, transitively through "
             "the cross-module call graph (the JG203 hazard where the "
             "blocking path crosses a module boundary)"),
        Rule("JG404", SEV_ERROR,
             "threading.Thread created without daemon= and without a "
             "join/stop path reachable from a shutdown/close method — "
             "the thread outlives the process's intent to exit"),
        # -- padding / shape invariants -------------------------------------
        Rule("JG301", SEV_ERROR,
             "capacity tier constant is not a power of two (ELL/frontier "
             "tiers and hybrid tail chunk widths must stay power-of-two "
             "for bounded padding, executable reuse, and the hybrid "
             "tail's aligned-subtree bitwise contract)"),
        Rule("JG302", SEV_ERROR,
             "integer padding fill uses a bare literal instead of the "
             "documented sentinel name"),
        Rule("JG303", SEV_ERROR,
             "data-dependent output shape inside a CUDA-graph capture "
             "context (nonzero/unique/masked_select/argwhere/1-arg where/"
             "boolean-mask indexing/repeat_interleave without "
             "output_size: each sizes its output on the host)"),
        Rule("JG304", SEV_ERROR,
             "feature-dim padding tier is not a power of two (dense-tier "
             "feature blocks pad to pow2 lane tiers so tree_dot/"
             "tree_matmul contractions are complete trees and rows stay "
             "VPU/MXU lane-aligned; 0 means auto-pick)"),
        Rule("JG305", SEV_ERROR,
             "direct open-for-write on a checkpoint/manifest/CDC-segment "
             "path: durability files must go through atomic tmp + rename "
             "(tempfile.mkstemp + os.replace, previous file demoted to "
             ".prev) — a crash mid-open(path, 'w') leaves a torn file AT "
             "THE COMMITTED NAME, exactly the loss the checkpoint format "
             "exists to prevent"),
    ]
}


@dataclass
class Finding:
    rule_id: str
    severity: str
    path: str  # repo-relative (or as-given) path
    line: int
    col: int
    message: str
    suppressed: bool = False

    def sort_key(self):
        return (self.path, self.line, self.col, self.rule_id)

    def to_dict(self) -> dict:
        # "file"/"line"/"rule"/"severity" are the STABLE keys tooling may
        # depend on (schema v2); "path" is the v1 spelling, kept so old
        # consumers keep working
        return {
            "rule": self.rule_id,
            "severity": self.severity,
            "file": self.path,
            "path": self.path,
            "line": self.line,
            "col": self.col,
            "message": self.message,
            "suppressed": self.suppressed,
        }


# ---------------------------------------------------------------- suppression
_DISABLE_RE = re.compile(
    r"#\s*graphlint:\s*disable=([A-Za-z0-9_,\s]+?)(?:\s+--|\s*$|#)"
)
_DISABLE_FILE_RE = re.compile(
    r"#\s*graphlint:\s*disable-file=([A-Za-z0-9_,\s]+?)(?:\s+--|\s*$|#)"
)
_TRACED_RE = re.compile(r"#\s*graphlint:\s*traced\b")
_HOST_RE = re.compile(r"#\s*graphlint:\s*host\b")
_HANDOFF_RE = re.compile(r"#\s*graphlint:\s*handoff\b")
_WALLCLOCK_RE = re.compile(r"#\s*graphlint:\s*wallclock\b")


def _parse_ids(blob: str) -> set:
    return {p.strip().upper() for p in blob.split(",") if p.strip()}


class Suppressions:
    """Per-file suppression state parsed from comments.

    ``# graphlint: disable=JG101`` on the flagged line or on a comment line
    directly above suppresses that line; ``disable-file=`` anywhere in the
    file suppresses the rule file-wide. ``disable=all`` works for both.
    """

    def __init__(self, source: str):
        self.line_rules: Dict[int, set] = {}
        self.file_rules: set = set()
        self.traced_lines: set = set()
        #: defs here compute HOST constants even when called from a traced
        #: body (e.g. lru-cached numpy masks) — propagation skips them
        self.host_lines: set = set()
        #: lines marked `# graphlint: handoff` — an explicit statement
        #: that ambient scope (deadline/span/ledger) is re-established
        #: across a thread boundary here; JG402's walk stops at a marked
        #: def or spawn site
        self.handoff_lines: set = set()
        #: lines marked `# graphlint: wallclock` — an explicit statement
        #: that a time.time() subtraction is event-stamp/offset math over
        #: wall timestamps, not a duration; JG111 skips these
        self.wallclock_lines: set = set()
        for i, line in enumerate(source.splitlines(), start=1):
            if "graphlint" not in line:
                continue
            m = _DISABLE_FILE_RE.search(line)
            if m:
                self.file_rules |= _parse_ids(m.group(1))
                continue
            m = _DISABLE_RE.search(line)
            if m:
                ids = _parse_ids(m.group(1))
                self.line_rules.setdefault(i, set()).update(ids)
                if line.lstrip().startswith("#"):
                    # comment-only line: also covers the line below
                    self.line_rules.setdefault(i + 1, set()).update(ids)
            if _TRACED_RE.search(line):
                self.traced_lines.add(i)
                if line.lstrip().startswith("#"):
                    self.traced_lines.add(i + 1)
            if _HOST_RE.search(line):
                self.host_lines.add(i)
                if line.lstrip().startswith("#"):
                    self.host_lines.add(i + 1)
            if _HANDOFF_RE.search(line):
                self.handoff_lines.add(i)
                if line.lstrip().startswith("#"):
                    self.handoff_lines.add(i + 1)
            if _WALLCLOCK_RE.search(line):
                self.wallclock_lines.add(i)
                if line.lstrip().startswith("#"):
                    self.wallclock_lines.add(i + 1)

    def is_suppressed(self, rule_id: str, line: int) -> bool:
        if "ALL" in self.file_rules or rule_id in self.file_rules:
            return True
        ids = self.line_rules.get(line)
        return ids is not None and (rule_id in ids or "ALL" in ids)


# -------------------------------------------------------------------- modules
@dataclass
class ModuleInfo:
    """One parsed source file plus everything rule visitors need."""

    path: str  # display path (repo-relative when possible)
    abspath: str
    source: str
    tree: ast.Module
    suppressions: Suppressions
    #: names bound to the numpy module (``np``/``numpy``) at module level
    numpy_names: set = field(default_factory=set)
    #: names bound to the torch module or one of its submodules
    #: (``torch``, ``F`` for ``torch.nn.functional``)
    torch_names: set = field(default_factory=set)

    @property
    def rel_segments(self) -> Tuple[str, ...]:
        return tuple(self.path.replace(os.sep, "/").split("/"))


def _collect_numpy_names(tree: ast.Module) -> set:
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                if alias.name.split(".")[0] == "numpy":
                    names.add(alias.asname or alias.name.split(".")[0])
        elif isinstance(node, ast.ImportFrom):
            if node.module and node.module.split(".")[0] == "numpy":
                for alias in node.names:
                    names.add(alias.asname or alias.name)
    return names


def _collect_torch_names(tree: ast.Module) -> set:
    """Names bound to torch modules (``import torch``, ``from torch import
    nn``, ``import torch.nn.functional as F``)."""
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                if alias.name.split(".")[0] == "torch":
                    names.add(alias.asname or "torch")
        elif isinstance(node, ast.ImportFrom) and not node.level and node.module:
            if node.module.split(".")[0] == "torch":
                names.update(alias.asname or alias.name for alias in node.names)
    return names


def load_module(abspath: str, display: Optional[str] = None) -> Tuple[Optional[ModuleInfo], Optional[Finding]]:
    """Parse one file. Returns (module, None) or (None, JG001 finding)."""
    display = display or abspath
    with open(abspath, "rb") as f:
        raw = f.read()
    try:
        source = raw.decode("utf-8")
    except UnicodeDecodeError:
        source = raw.decode("utf-8", errors="replace")
    try:
        tree = ast.parse(source, filename=abspath)
    except SyntaxError as e:
        return None, Finding(
            "JG001", SEV_ERROR, display, e.lineno or 1, e.offset or 0,
            f"syntax error: {e.msg}",
        )
    mod = ModuleInfo(
        path=display,
        abspath=abspath,
        source=source,
        tree=tree,
        suppressions=Suppressions(source),
    )
    mod.numpy_names = _collect_numpy_names(tree)
    if "torch" in source:
        mod.torch_names = _collect_torch_names(tree)
    return mod, None


def discover_files(paths: Sequence[str]) -> List[Tuple[str, str]]:
    """Expand files/directories into sorted (abspath, display) pairs."""
    out = []
    cwd = os.getcwd()
    for p in paths:
        ap = os.path.abspath(p)
        if os.path.isfile(ap):
            out.append(ap)
        else:
            for root, dirs, files in os.walk(ap):
                dirs[:] = sorted(
                    d for d in dirs
                    if not d.startswith(".") and d != "__pycache__"
                )
                for fn in sorted(files):
                    if fn.endswith(".py"):
                        out.append(os.path.join(root, fn))
    uniq = sorted(set(out))
    pairs = []
    for ap in uniq:
        disp = os.path.relpath(ap, cwd)
        if disp.startswith(".."):
            disp = ap
        pairs.append((ap, disp))
    return pairs


# ------------------------------------------------------------------- analyzer
class Analyzer:
    """Runs every rule family over a set of paths and filters findings."""

    def __init__(
        self,
        select: Optional[Sequence[str]] = None,
        ignore: Optional[Sequence[str]] = None,
    ):
        self.select = [s.upper() for s in select] if select else None
        self.ignore = [s.upper() for s in ignore] if ignore else []
        #: populated by analyze_paths: per-rule counts + call-graph size
        self.last_stats: Optional[dict] = None

    def _wanted(self, rule_id: str) -> bool:
        if any(rule_id.startswith(p) for p in self.ignore):
            return False
        if self.select is not None:
            return any(rule_id.startswith(p) for p in self.select)
        return True

    def analyze_paths(
        self, paths: Sequence[str], keep_suppressed: bool = False
    ) -> Tuple[List[Finding], int]:
        """Returns (findings, files_scanned). Suppressed findings are kept
        (marked) only when `keep_suppressed`.

        graphlint v2 pass order: modules load first, then the whole-program
        layer (call graph + interprocedural traced map) is computed ONCE,
        then per-module families run with that context, then the three
        cross-module passes (lock-closure JG403, acquisition-order JG202,
        concurrency JG4xx). ``self.last_stats`` captures per-rule counts
        and the call-graph size for ``--stats``.
        """
        import gc

        # A batch pass allocates millions of short-lived AST nodes; in a
        # long-lived host process (a test runner, an IDE daemon) every
        # generational collection those allocations trigger re-traces the
        # host's entire live heap, which can triple the pass's wall time.
        # Freeze the pre-existing heap for the duration: our own garbage
        # stays collectable, the host's objects stop being traced.
        gc.collect()
        gc.freeze()
        try:
            return self._analyze(paths, keep_suppressed)
        finally:
            gc.unfreeze()

    def _analyze(
        self, paths: Sequence[str], keep_suppressed: bool
    ) -> Tuple[List[Finding], int]:
        from janusgraph_tpu_torch.analysis import (
            callgraph,
            checkpoint_rules,
            concurrency_rules,
            lock_rules,
            metric_rules,
            robustness_rules,
            shape_rules,
            thread_rules,
            trace_rules,
        )

        findings: List[Finding] = []
        modules: List[ModuleInfo] = []
        pairs = discover_files(paths)
        for ap, disp in pairs:
            mod, err = load_module(ap, disp)
            if err is not None:
                findings.append(err)
                continue
            modules.append(mod)

        cg = callgraph.CallGraph(modules)
        traced_maps = callgraph.propagate_traced(modules, cg)

        lock_graph = lock_rules.LockGraph()
        scans: List[lock_rules.ModuleScan] = []
        for mod in modules:
            traced = traced_maps.get(mod.path)
            findings.extend(trace_rules.check_module(mod, traced))
            findings.extend(shape_rules.check_module(mod, traced))
            findings.extend(lock_rules.check_module(mod, lock_graph, scans))
            findings.extend(robustness_rules.check_module(mod))
            findings.extend(checkpoint_rules.check_module(mod))
            findings.extend(metric_rules.check_module(mod))
            findings.extend(thread_rules.check_module(mod))
        findings.extend(
            lock_rules.finalize_cross_module(scans, cg, lock_graph)
        )
        findings.extend(concurrency_rules.check_program(modules, cg))
        findings.extend(lock_graph.order_findings())

        out = []
        suppressed_counts: Dict[str, int] = {}
        finding_counts: Dict[str, int] = {}
        seen = set()
        mods_by_path = {m.path: m for m in modules}
        for f in findings:
            if not self._wanted(f.rule_id):
                continue
            # a node inside a nested traced def is walked by both the inner
            # and outer context — report it once
            key = (f.rule_id, f.path, f.line, f.col)
            if key in seen:
                continue
            seen.add(key)
            mod = mods_by_path.get(f.path)
            if mod is not None and mod.suppressions.is_suppressed(
                f.rule_id, f.line
            ):
                suppressed_counts[f.rule_id] = (
                    suppressed_counts.get(f.rule_id, 0) + 1
                )
                if keep_suppressed:
                    f.suppressed = True
                    out.append(f)
                continue
            finding_counts[f.rule_id] = finding_counts.get(f.rule_id, 0) + 1
            out.append(f)
        out.sort(key=Finding.sort_key)
        self.last_stats = {
            "files_scanned": len(pairs),
            "callgraph": cg.stats(),
            "findings_by_rule": dict(sorted(finding_counts.items())),
            "suppressions_by_rule": dict(sorted(suppressed_counts.items())),
            "traced_defs": sum(len(t) for t in traced_maps.values()),
        }
        return out, len(pairs)


def analyze_paths(paths: Sequence[str], **kw) -> List[Finding]:
    """Convenience: default analyzer, non-suppressed findings only."""
    findings, _ = Analyzer(**kw).analyze_paths(paths)
    return findings


def capture_reach(paths: Sequence[str]) -> Dict[str, str]:
    """{qualified def name: reason} for every def the capture contexts of
    ``paths`` reach (``path.py:Class.method``, the key a profiler hook
    builds from a frame's file and ``co_qualname``): the call graph and the
    capture propagation only, none of the rule passes."""
    from janusgraph_tpu_torch.analysis import callgraph

    modules = []
    for ap, disp in discover_files(paths):
        mod, _err = load_module(ap, disp)
        if mod is not None:
            modules.append(mod)
    cg = callgraph.CallGraph(modules)
    traced = callgraph.propagate_traced(modules, cg)
    return callgraph.capture_reach(modules, traced, cg)
