"""Query server: HTTP + WebSocket endpoint over the traversal DSL — the
port's copy of ``janusgraph_tpu/server/server.py``.

Capability parity with the reference's server
(reference: janusgraph-server .../JanusGraphServer.java:44-49 — a Gremlin
Server hosting named graphs/traversal sources with WS+HTTP channelizers,
JanusGraphWsAndHttpChannelizer.java; auth per auth.py). Protocol shape
mirrors the Gremlin Server HTTP API: POST a JSON request containing a query
string, get back {"result": {"data": ...}, "status": {...}} with
GraphSON-typed data. The same JSON request/response flows over the
WebSocket endpoint (RFC6455 implemented inline — no external ws library in
the image).

Queries are evaluated against a sandboxed namespace holding ONLY the
registered traversal sources (g_<name>, or `g` for the default graph) and
the predicate vocabulary P — the analogue of the reference's
gremlin-groovy sandbox. A bare traversal result is auto-iterated
(`.to_list()`), like Gremlin Server does.
"""

from __future__ import annotations

import ast
import base64
import hashlib
import json
import re
import select
import struct
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from janusgraph_tpu_torch.driver.graphson import graphson_dumps
from janusgraph_tpu_torch.exceptions import QueryError
from janusgraph_tpu_torch.server.auth import AuthenticationError


class QueryTooLongError(ValueError):
    """Submitted query exceeds server.max-query-length (maps to 413)."""
from janusgraph_tpu_torch.server.manager import JanusGraphManager

_WS_MAGIC = "258EAFA5-E914-47DA-95CA-C5AB0DC85B11"

#: AST node whitelist for the query DSL: expressions built from names,
#: attribute/method chains, calls, literals and containers — no statements,
#: comprehensions, lambdas, subscript tricks or operators beyond
#: comparison/arith on literals. Combined with the dunder ban this closes
#: the classic `().__class__.__bases__` escape hatches of raw eval.
_ALLOWED_NODES = (
    ast.Expression, ast.Call, ast.Attribute, ast.Name, ast.Load,
    ast.Constant, ast.List, ast.Tuple, ast.Dict, ast.Set, ast.keyword,
    ast.UnaryOp, ast.USub, ast.BinOp, ast.Add, ast.Sub, ast.Mult, ast.Div,
    ast.Starred,
)


class QueryRejected(Exception):
    pass


def _validate_query(query: str) -> ast.Expression:
    try:
        tree = ast.parse(query, mode="eval")
    except SyntaxError as e:
        raise QueryRejected(f"syntax error: {e}") from None
    for node in ast.walk(tree):
        if not isinstance(node, _ALLOWED_NODES):
            raise QueryRejected(
                f"disallowed construct: {type(node).__name__}"
            )
        if isinstance(node, ast.Attribute) and node.attr.startswith("_"):
            raise QueryRejected(f"disallowed attribute: {node.attr}")
        if isinstance(node, ast.Name) and node.id.startswith("__"):
            # the bare anonymous-traversal source is the ONE sanctioned
            # dunder name (TinkerPop's __; it carries no object internals)
            if node.id != "__":
                raise QueryRejected(f"disallowed name: {node.id}")
    return tree


def _evaluate(query: str, namespace: dict):
    from janusgraph_tpu_torch.core.traversal import GraphTraversal

    tree = _validate_query(query)
    result = eval(  # noqa: S307 - AST-whitelisted DSL, empty builtins
        compile(tree, "<query>", "eval"), {"__builtins__": {}}, namespace
    )
    if isinstance(result, GraphTraversal):
        result = result.to_list()
    return result


#: last /healthz verdict, for edge-triggered flight dumps (the ok ->
#: degraded FLIP is the incident boundary worth a black-box snapshot;
#: staying degraded must not dump once per probe)
_HEALTH_STATE = {"status": None}
_HEALTH_LOCK = threading.Lock()


def healthz_snapshot() -> dict:
    """The /healthz payload: ok/degraded from the process registry.

    Degraded when any circuit breaker is not CLOSED (state gauge != 0) —
    the storage or index tier is failing over RIGHT NOW. Injected-fault,
    retry, and recovery counters ride along as context: high retry counts
    with ok status mean the self-healing paths are absorbing trouble.
    The ``flight`` block summarizes the black-box recorder (occupancy,
    per-category counts, last dump path); the ok->degraded flip itself
    triggers a flight dump so the events leading up to the degradation
    are on disk before anyone asks.

    The ``sharded`` block covers the multi-chip plane: shard-level
    injected faults (shard preemptions, collective timeouts, halo drops,
    stragglers), checkpoint manifest/slice fallbacks, cross-shard
    auto-resumes, and the last run's straggler skew gauge
    (``olap.shard.skew`` — modeled slowest-shard/mean; 1.0 = balanced).

    The ``admission`` block covers the overload-defense front door
    (server/admission.py): current AIMD limit and baseline, in-flight and
    queued requests, brownout rung, and shed/admit/timeout counters. A
    shed user request is a 503 whose body says ``"status": "shed"``; THIS
    endpoint's 503 says ``"status": "degraded"`` — and /healthz (with
    /metrics, /telemetry, /flight, /profile, /timeseries) BYPASSES
    admission entirely, because a saturated server you cannot observe is
    the classic outage-amplifier.

    The ``slo`` block is the burn-rate engine's verdict
    (observability/slo.py): per-spec severity and fast/slow burn over
    the metrics history. A PAGE-severity burn makes this endpoint report
    degraded — which rides the existing ok->degraded flight-dump edge
    trigger, so the event ring is on disk the moment an SLO starts
    burning at page rate.

    The ``profiler`` block is the continuous profiling plane
    (observability/continuous.py): sampler liveness, flame windows
    retained, self-measured overhead (CPU and wall pct), the watchdog's
    state, and forensics-bundle counts. A sampler thread that DIED
    while enabled reports degraded on its own — a silently-dead
    profiler keeps serving stale flame windows, which is worse than no
    profiler. The ok->degraded flip also captures a forensics bundle
    (when metrics.bundle-dir is set), so an SLO page ships its own
    evidence.
    """
    from janusgraph_tpu_torch.observability import (
        bundle_writer,
        flight_recorder,
        registry,
        sampling_profiler,
        slo_engine,
        watchdog,
    )
    from janusgraph_tpu_torch.server import admission as _admission

    snap = registry.snapshot()
    breakers = {
        name: m["value"]
        for name, m in snap.items()
        if name.startswith("breaker.") and name.endswith(".state")
        and m["type"] == "gauge"
        # fleet router breakers describe PEER replicas (server/fleet.py),
        # not this process's storage/index tier — an in-process router
        # failing over around a dead peer must not read as THIS replica
        # degrading
        and not name.startswith("breaker.fleet.")
    }
    slo_block = slo_engine.snapshot()
    # the continuous profiling plane's verdict: a sampler thread that
    # died while enabled is a LYING profiler — flame windows stop while
    # dashboards keep rendering the stale ring — so that alone degrades
    profiler_block = sampling_profiler.status()
    profiler_block["watchdog"] = watchdog.state()
    profiler_block["bundles"] = bundle_writer.status()
    profiler_dead = bool(
        profiler_block["enabled"] and not profiler_block["alive"]
    )
    degraded = (
        any(v != 0.0 for v in breakers.values())
        or bool(slo_block["paging"])
        or profiler_dead
    )
    counters = {
        name: m["count"]
        for name, m in snap.items()
        if m["type"] == "counter" and (
            name.startswith("chaos.injected.")
            or name.startswith("storage.backend_op.")
            or name.startswith("storage.scan.")
            or name.startswith("txlog.torn.")
            or name.startswith("olap.checkpoint.")
            or name.startswith("olap.sharded.")
            or name in ("olap.preemptions", "olap.resumes")
            or (name.startswith("breaker.") and not name.endswith(".state"))
        )
    }
    shard_fault_kinds = (
        "shard_preempt", "collective", "halo_drop", "straggler"
    )
    skew = snap.get("olap.shard.skew")
    sharded = {
        "faults": {
            k: counters.get(f"chaos.injected.{k}", 0)
            for k in shard_fault_kinds
        },
        "manifest_fallbacks": counters.get(
            "olap.checkpoint.manifest_fallback", 0
        ),
        "shard_fallbacks": counters.get("olap.checkpoint.shard_fallback", 0),
        "resumes": counters.get("olap.sharded.resumes", 0),
        "skew": (
            skew["value"] if skew and skew["type"] == "gauge" else None
        ),
    }
    ctl = _admission.active()
    admission_block = ctl.snapshot() if ctl is not None else None
    if admission_block is not None:
        adm_counters = {
            name: m["count"]
            for name, m in snap.items()
            if m["type"] == "counter"
            and name.startswith("server.admission.")
        }
        admission_block["shed"] = adm_counters.get(
            "server.admission.shed", 0
        )
        admission_block["admitted"] = adm_counters.get(
            "server.admission.admitted", 0
        )
        admission_block["queue_timeouts"] = adm_counters.get(
            "server.admission.queue_timeouts", 0
        )
    status = "degraded" if degraded else "ok"
    with _HEALTH_LOCK:
        flipped = _HEALTH_STATE["status"] == "ok" and status == "degraded"
        _HEALTH_STATE["status"] = status
    if flipped:
        flight_recorder.record(
            "health", transition="ok->degraded",
            breakers={k: v for k, v in breakers.items() if v != 0.0},
            slo_paging=slo_block["paging"],
            profiler_dead=profiler_dead,
        )
        flight_recorder.dump(reason="healthz-degraded")
        # an SLO page (or any other degradation) is a forensics moment:
        # capture the full bundle on the same edge trigger (no-op unless
        # metrics.bundle-dir is configured; rate-limited regardless)
        bundle_writer.capture(reason="healthz-degraded")
    # the remote wire-protocol clients' pipelined-framing state: per
    # protocol (storage.remote / index.remote) in-flight depth,
    # coalescing ratio, stalls, and negotiation fallbacks (absent keys =
    # the pipelined path has not engaged in this process)
    from janusgraph_tpu_torch.storage.pipeline import pipeline_health_block

    # the OLTP->OLAP spillover plane (olap/spillover.py): spilled/
    # fallback/staleness counters and the promoted-digest census, so an
    # operator can see whether the optimizer is engaging — and why not
    spill_counters = {
        name: m["count"]
        for name, m in snap.items()
        if m["type"] == "counter" and name.startswith("olap.spillover.")
    }
    promoted_gauge = snap.get("olap.spillover.promoted_digests")
    from janusgraph_tpu_torch.olap.spillover import promoted_digests

    spillover_block = {
        "spilled": spill_counters.get("olap.spillover.spilled", 0),
        "fallbacks": spill_counters.get("olap.spillover.fallback", 0),
        "stale": spill_counters.get("olap.spillover.stale", 0),
        "packs": spill_counters.get("olap.spillover.packs", 0),
        "refreshes": spill_counters.get("olap.spillover.refreshes", 0),
        "promotions": spill_counters.get("olap.spillover.promotions", 0),
        "promoted_digests": sorted(promoted_digests()),
        "promoted_count": (
            promoted_gauge["value"]
            if promoted_gauge and promoted_gauge["type"] == "gauge"
            else 0.0
        ),
        "fallback_reasons": {
            name[len("olap.spillover.fallback."):]: count
            for name, count in spill_counters.items()
            if name.startswith("olap.spillover.fallback.")
        },
    }

    return {
        "status": status,
        "breakers": breakers,
        "counters": counters,
        "sharded": sharded,
        "admission": admission_block,
        "slo": slo_block,
        "spillover": spillover_block,
        "pipeline": pipeline_health_block(snap),
        "flight": flight_recorder.health_block(),
        "profiler": profiler_block,
    }


def _timeout_payload(e) -> dict:
    """Structured evaluation-timeout response (the request's deadline was
    spent — queued too long, or the evaluation/storage layers aborted)."""
    return {
        "result": {"data": None},
        "status": {
            "code": 504, "status": "timeout",
            "message": f"{type(e).__name__}: {e}",
        },
    }


class JanusGraphServer:
    """HTTP + WS query server over a JanusGraphManager registry."""

    def __init__(
        self,
        manager: Optional[JanusGraphManager] = None,
        default_graph: str = "graph",
        authenticator=None,
        host: str = "127.0.0.1",
        port: int = 0,
        max_request_bytes: int = 1 << 20,
        max_query_length: int = 65536,
        request_timeout_s: float = 120.0,
        auto_commit: bool = True,
        admission=None,
        admission_enabled: bool = True,
        default_deadline_ms: float = 0.0,
        max_deadline_ms: float = 600_000.0,
        ws_workers: int = 4,
        history_enabled: bool = True,
        slo_enabled: bool = True,
        slo_specs=None,
        replica_name: str = "",
        profiler_enabled: bool = True,
        watchdog_enabled: bool = True,
        bundle_dir: str = "",
    ):
        self.manager = manager or JanusGraphManager.get_instance()
        self.default_graph = default_graph
        self.authenticator = authenticator
        self.host = host
        self._port = port
        #: server.max-request-bytes — HTTP body / WS frame size ceiling
        self.max_request_bytes = max_request_bytes
        #: server.max-query-length — bounds AST parse cost
        self.max_query_length = max_query_length
        #: server.request-timeout-s — per-connection socket timeout AND
        #: the default wall-clock evaluation deadline (see _deadline_ms)
        self.request_timeout_s = request_timeout_s
        #: server.auto-commit — sessionless per-request commit on success
        self.auto_commit = auto_commit
        #: server.deadline.default-ms — deadline when the client sends
        #: none (0 = derive from request_timeout_s)
        self.default_deadline_ms = default_deadline_ms
        #: server.deadline.max-ms — clamp on client-supplied deadlines
        self.max_deadline_ms = max_deadline_ms
        #: per-connection worker pool size for id-tagged (multiplexed)
        #: WS requests — id-less and in-session requests stay serial
        self.ws_workers = ws_workers
        #: server.admission.* — the cost-aware front door (None = open)
        if admission is None and admission_enabled:
            from janusgraph_tpu_torch.server.admission import AdmissionController

            admission = AdmissionController()
        self.admission = admission
        #: metrics.history-enabled — this server owns the sampler thread
        self.history_enabled = history_enabled
        #: metrics.slo-* — burn-rate engine evaluated per history window
        self.slo_enabled = slo_enabled
        self.slo_specs = slo_specs
        #: metrics.profile-enabled — the always-on sampling profiler;
        #: this server owns the sampler thread (continuous.py)
        self.profiler_enabled = profiler_enabled
        #: server.watchdog-* — the runtime stall watchdog
        self.watchdog_enabled = watchdog_enabled
        #: metrics.bundle-dir — where anomaly forensics bundles land
        #: ('' keeps bundle_writer's current directory, e.g. test-set)
        self.bundle_dir = bundle_dir
        self._profiler_started = False
        self._watchdog_started = False
        #: active-request table for forensics bundles: thread-id ->
        #: {query, graph, since}; completed count feeds the watchdog's
        #: progress checker
        self._active_requests: dict = {}
        self._completed_requests = 0
        self._history_started = False
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None
        #: server.fleet.replica-name — this replica's fleet identity
        #: (rides /healthz; the CLI runners also set the process-wide
        #: telemetry tag, observability/identity.py)
        self.replica_name = replica_name
        #: replication state surfaced as the /healthz ``cdc`` block: a
        #: server/fleet.CDCFollower (follower role) or a storage/cdc.
        #: LeaderCDCState (leader with a durable log); None = no CDC
        self.cdc_state = None
        #: graceful-drain mode: True stops admitting NEW sessionless
        #: requests and session opens (shed with status "draining", which
        #: the fleet router treats as retry-elsewhere) while in-flight
        #: sessions finish — see drain()
        self.draining = False
        self._sessions_lock = threading.Lock()
        self._open_sessions = 0
        self._sessions_drained = threading.Condition(self._sessions_lock)
        #: the replica's gossip agent (server/fleet.StateGossip) when the
        #: fleet runner wired one; POST /gossip merges into it
        self.gossip = None

    def _deadline_ms(self, requested) -> Optional[float]:
        """Effective deadline budget for one request: the client's
        X-Deadline-Ms / WS ``deadline`` field (clamped to server.deadline.
        max-ms), else server.deadline.default-ms, else server.request-
        timeout-s — so the old socket timeout is also a wall-clock bound
        on query EVALUATION, not just on reads. None = no deadline."""
        budget = None
        if requested is not None:
            try:
                budget = float(requested)
            except (TypeError, ValueError):
                budget = None
        if budget is not None and budget > 0:
            if self.max_deadline_ms > 0:
                budget = min(budget, self.max_deadline_ms)
            return budget
        if self.default_deadline_ms > 0:
            return self.default_deadline_ms
        if self.request_timeout_s and self.request_timeout_s > 0:
            return self.request_timeout_s * 1000.0
        return None

    # ------------------------------------------------------------ lifecycle
    @property
    def port(self) -> int:
        return self._httpd.server_address[1] if self._httpd else self._port

    def start(self) -> "JanusGraphServer":
        server = self

        class Handler(_Handler):
            jg_server = server
            # socket read timeout; 0 = disabled (None = stdlib no-timeout)
            timeout = server.request_timeout_s or None

        class _Httpd(ThreadingHTTPServer):
            # a deep accept backlog: admission control (shed + Retry-After)
            # is the designed overload response — kernel RSTs from a
            # 5-deep listen queue must not preempt it
            request_queue_size = 128

        self._httpd = _Httpd((self.host, self._port), Handler)
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True
        )
        self._thread.start()
        if self.admission is not None:
            # register process-globally so other layers (the OLAP
            # computer's brownout refusal) can consult the ladder
            from janusgraph_tpu_torch.server import admission as _admission

            _admission.set_active(self.admission)
            # price-book warm-start: the persisted server-side table
            # (computer.price-book-path, shared with the OLTP table's
            # file) prices known shapes correctly from request one
            path = self._price_book_path()
            if path:
                from janusgraph_tpu_torch.observability import profiler as _prof

                _prof.restore_digest_records(
                    self.admission.price_book,
                    _prof.load_price_book(path).get("server"),
                )
        # the observability plane's history sampler: one daemon thread on
        # the server's side of the house (never on a request path), plus
        # the SLO engine evaluated after each window lands. The engine
        # prices per-digest latency thresholds from THIS server's
        # admission price book.
        from janusgraph_tpu_torch.observability import history, slo_engine

        if self.slo_enabled:
            from janusgraph_tpu_torch.observability.slo import default_specs

            slo_engine.specs = list(
                self.slo_specs if self.slo_specs is not None
                else default_specs()
            )
            slo_engine.price_book_fn = (
                (lambda: self.admission.price_book)
                if self.admission is not None else None
            )
            slo_engine.install()
        if self.history_enabled and not history.running:
            history.start()
            self._history_started = True
        # the continuous profiling plane (observability/continuous.py):
        # sampler + watchdog threads are the server's, like the history
        # sampler; bundles get this server's active-request table
        from janusgraph_tpu_torch.observability import (
            bundle_writer,
            sampling_profiler,
            watchdog,
        )

        if self.bundle_dir:
            bundle_writer.configure(directory=self.bundle_dir)
        bundle_writer.set_request_table(self.active_request_table)
        if self.profiler_enabled and not sampling_profiler.alive:
            sampling_profiler.start()
            self._profiler_started = True
        if self.watchdog_enabled and not watchdog.alive:
            watchdog.register_progress("server.requests", self._progress)
            watchdog.start()
            self._watchdog_started = True
        return self

    def _price_book_path(self) -> str:
        """The default graph's resolved price-book path ('' = none)."""
        try:
            g = self.manager.get_graph(self.default_graph)
        except Exception:  # noqa: BLE001 - no default graph registered
            return ""
        return getattr(g, "_price_book_path", "") or ""

    def active_request_table(self) -> list:
        """Snapshot of in-flight requests (forensics-bundle content)."""
        with self._sessions_lock:
            return [dict(v) for v in self._active_requests.values()]

    def _progress(self) -> dict:
        """Watchdog progress source: active requests whose completed
        count stops moving for the stall window is a wedged server."""
        with self._sessions_lock:
            return {
                "active": len(self._active_requests),
                "progress": self._completed_requests,
            }

    def stop(self) -> None:
        from janusgraph_tpu_torch.observability import (
            bundle_writer,
            history,
            sampling_profiler,
            slo_engine,
            watchdog,
        )

        if self._watchdog_started:
            watchdog.unregister_progress("server.requests")
            watchdog.stop()
            self._watchdog_started = False
        if self._profiler_started:
            sampling_profiler.stop()
            self._profiler_started = False
        bundle_writer.set_request_table(None)
        if self.slo_enabled:
            slo_engine.uninstall()
        if self._history_started:
            history.stop()
            self._history_started = False
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        if self.admission is not None:
            from janusgraph_tpu_torch.server import admission as _admission

            if _admission.active() is self.admission:
                _admission.set_active(None)
            path = self._price_book_path()
            if path:
                from janusgraph_tpu_torch.observability import profiler as _prof

                _prof.save_price_book(
                    path, {"server": self.admission.price_book}
                )

    # ------------------------------------------------------------ execution
    def _namespace(self, query: str, graph_name: Optional[str]) -> dict:
        from janusgraph_tpu_torch.server.gremlin_compat import compat_namespace

        ns = compat_namespace()  # P, __, and bare Gremlin predicates
        name = graph_name or self.default_graph
        g = self.manager.get_graph(name)
        if g is None:
            raise KeyError(f"graph {name!r} not registered")
        ns["g"] = g.traversal()
        # only open sources the query actually references (each source holds
        # an open transaction)
        for other in set(re.findall(r"\bg_([A-Za-z0-9]\w*)", query)):
            og = self.manager.get_graph(other)
            if og is not None:
                ns[f"g_{other}"] = og.traversal()
        return ns

    def _prepare(self, query: str) -> str:
        """Shared request preamble: length guard + dialect translation
        (one implementation for the sessionless and in-session paths)."""
        from janusgraph_tpu_torch.server.gremlin_compat import translate

        if len(query) > self.max_query_length:
            raise QueryTooLongError(
                f"query length {len(query)} exceeds server.max-query-length "
                f"({self.max_query_length})"
            )
        return translate(query)  # Gremlin dialect -> DSL (lexical only)

    def execute(self, query: str, graph_name: Optional[str] = None):
        from janusgraph_tpu_torch.core.traversal import GraphTraversalSource

        query = self._prepare(query)
        ns = self._namespace(query, graph_name)
        ok = False
        try:
            result = _evaluate(query, ns)
            ok = True
            return result
        finally:
            for v in ns.values():
                if isinstance(v, GraphTraversalSource):
                    # sessionless semantics (the reference's Gremlin Server
                    # commits each successful request's tx automatically;
                    # errors roll back) — server.auto-commit=false restores
                    # the read-only-endpoint behavior. Release WITHOUT
                    # reopening (source.commit()/rollback() would start a
                    # fresh tx).
                    if ok and self.auto_commit:
                        v.tx.commit()
                    else:
                        v.tx.rollback()

    # ---------------------------------------------------------------- drain
    def drain(self, timeout_s: float = 10.0) -> int:
        """Graceful retirement, phase one: stop admitting new sessionless
        requests and session opens (they shed with status ``"draining"``
        so a fleet router retries them elsewhere), then wait up to
        ``timeout_s`` for in-flight sessions to close. Returns the number
        of sessions still open when the wait ends (0 = fully drained —
        the caller may stop() the server without losing a session). The
        crash path never runs this — that distinction is the flight
        record: ``fleet/drain`` vs ``fleet/dead``."""
        from janusgraph_tpu_torch.observability import flight_recorder

        self.draining = True
        flight_recorder.record(
            "fleet", action="drain_begin",
            server=self.replica_name or f"{self.host}:{self.port}",
            open_sessions=self.open_sessions,
        )
        deadline = time.monotonic() + max(0.0, timeout_s)
        with self._sessions_drained:
            while self._open_sessions > 0:
                wait = deadline - time.monotonic()
                if wait <= 0:
                    break
                self._sessions_drained.wait(wait)
            remaining = self._open_sessions
        flight_recorder.record(
            "fleet", action="drain_end",
            server=self.replica_name or f"{self.host}:{self.port}",
            remaining=remaining,
        )
        return remaining

    @property
    def open_sessions(self) -> int:
        with self._sessions_lock:
            return self._open_sessions

    # ------------------------------------------------------------- sessions
    def open_session(self) -> dict:
        """State for one in-session WS connection (the reference Gremlin
        Server's session mode): namespaces (one per referenced graph)
        persist across messages, so ONE transaction spans requests until
        the query itself commits (`g.commit()`) or rolls back — no
        per-request auto-commit. Close with close_session."""
        if self.draining:
            # new sessions are the one thing a draining replica must
            # refuse outright — in-flight sessions keep working
            raise PermissionError(
                "replica is draining: no new sessions "
                "(reconnect to another fleet member)"
            )
        with self._sessions_lock:
            self._open_sessions += 1
        return {"_counted": True}

    def execute_session(
        self, query: str, graph_name: Optional[str], session: dict
    ):
        if not self.auto_commit:
            # server.auto-commit=false is the READ-ONLY endpoint mode;
            # a session's explicit g.commit() would bypass it
            raise PermissionError(
                "sessions are disabled on a read-only endpoint "
                "(server.auto-commit=false)"
            )
        query = self._prepare(query)
        # ONE traversal source (= one transaction) per GRAPH for the whole
        # session, however the graph is addressed (default, the graph
        # request field, or a g_<name> reference in any later message) —
        # the namespace is rebuilt per message, the sources persist
        sources = session.setdefault("_sources", {})

        def source_of(name):
            if name not in sources:
                graph = self.manager.get_graph(name)
                if graph is None:
                    raise KeyError(f"graph {name!r} not registered")
                sources[name] = graph.traversal()
            return sources[name]

        from janusgraph_tpu_torch.server.gremlin_compat import compat_namespace

        ns = compat_namespace()
        ns["g"] = source_of(graph_name or self.default_graph)
        for other in set(re.findall(r"\bg_([A-Za-z0-9]\w*)", query)):
            if self.manager.get_graph(other) is not None:
                ns[f"g_{other}"] = source_of(other)
        return _evaluate(query, ns)

    def close_session(self, session: dict) -> None:
        """Roll back every open session transaction (connection closed
        without commit — the reference's session close semantics)."""
        for src in session.get("_sources", {}).values():
            try:
                src.tx.rollback()
            except Exception:  # noqa: BLE001 - already closed
                pass
        counted = session.pop("_counted", False)
        session.clear()
        if counted:
            with self._sessions_drained:
                self._open_sessions = max(0, self._open_sessions - 1)
                self._sessions_drained.notify_all()

    def authenticate_request(self, headers) -> Optional[str]:
        """Returns username, or raises. None when auth is disabled."""
        if self.authenticator is None:
            return None
        header = headers.get("Authorization", "")
        if header.startswith("Basic "):
            try:
                raw = base64.b64decode(header[6:]).decode()
                user, pw = raw.split(":", 1)
            except Exception:
                raise AuthenticationError("malformed basic auth")
            return self.authenticator.credentials.authenticate(user, pw)
        if header.startswith("Token "):
            return self.authenticator.verify_token(header[6:])
        raise AuthenticationError("missing Authorization header")


class _Handler(BaseHTTPRequestHandler):
    jg_server: JanusGraphServer = None
    protocol_version = "HTTP/1.1"

    def log_message(self, *args):  # silence default stderr chatter
        pass

    # --------------------------------------------------------------- helpers
    def _send_json(
        self, code: int, payload: dict, extra_headers: Optional[dict] = None
    ) -> None:
        body = payload if isinstance(payload, bytes) else json.dumps(payload).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        for k, v in (extra_headers or {}).items():
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(body)

    def _auth(self) -> bool:
        try:
            self.jg_server.authenticate_request(self.headers)
            return True
        except AuthenticationError as e:
            self._send_json(401, {"status": {"code": 401, "message": str(e)}})
            return False

    def _run_request(
        self,
        req: dict,
        session: Optional[dict] = None,
        trace_header: Optional[str] = None,
        deadline_header: Optional[str] = None,
    ) -> dict:
        import time as _time

        from janusgraph_tpu_torch.core.deadline import deadline_scope, remaining_ms
        from janusgraph_tpu_torch.exceptions import DeadlineExceededError
        from janusgraph_tpu_torch.observability import tracer
        from janusgraph_tpu_torch.observability.profiler import ledger_scope
        from janusgraph_tpu_torch.observability.spans import TraceContext
        from janusgraph_tpu_torch.server.admission import ShedError

        server = self.jg_server
        query = req.get("gremlin", "")
        graph = req.get("graph")
        # every request runs under a wall-clock deadline: the client's
        # X-Deadline-Ms header (WS "deadline" field), else the server
        # defaults (server.deadline.default-ms / request-timeout-s). The
        # scope is ambient, so the traversal layer, backend_op retries,
        # and the remote KCVS/index protocols (deadline feature bit) all
        # inherit the same budget.
        budget_ms = server._deadline_ms(
            deadline_header if deadline_header is not None
            else req.get("deadline")
        )
        # graceful drain: NEW sessionless work is refused with a
        # structured "draining" shed (the fleet router's retry-elsewhere
        # signal); requests on an EXISTING session run to completion so
        # the session can finish and close
        if server.draining and session is None:
            from janusgraph_tpu_torch.observability import registry as _reg

            _reg.counter("server.drain.refused").inc()
            return {
                "result": {"data": None},
                "status": {
                    "code": 503, "status": "draining",
                    "retry_after_s": 0.05,
                    "message": "replica is draining; retry elsewhere",
                },
            }
        with deadline_scope(budget_ms):
            # admission BEFORE any work: price the query's shape from the
            # measured price book, then admit / queue / shed
            ctl = server.admission
            ticket = None
            digest = ""
            if ctl is not None:
                digest, price_ms, known = ctl.price(query)
                try:
                    rem = remaining_ms()
                    ticket = ctl.acquire(
                        price_ms=price_ms, known=known, digest=digest,
                        timeout_s=(
                            rem / 1000.0 if rem is not None else None
                        ),
                    )
                except ShedError as e:
                    # shed-503, distinguishable from a degraded /healthz
                    # 503 by status "shed"; retry_after_s rides the body
                    # and do_POST mirrors it into a Retry-After header
                    return {
                        "result": {"data": None},
                        "status": {
                            "code": 503, "status": "shed",
                            "reason": e.reason,
                            "retry_after_s": e.retry_after_s,
                            "message": str(e),
                        },
                    }
                except DeadlineExceededError as e:
                    return _timeout_payload(e)
            t0 = _time.perf_counter()
            cells = 0
            try:
                # the request runs under a server span; when the driver
                # sent a trace header the span joins the caller's trace,
                # and everything below — store ops over the remote KCVS
                # protocol included — stitches into ONE tree. It also
                # runs under a fresh ResourceLedger whose totals are
                # echoed to the driver in status.ledger.
                ctx = (
                    TraceContext.from_header(trace_header)
                    if trace_header else None
                )
                with tracer.child_span(
                    ctx, "server.request",
                    graph=graph or server.default_graph,
                    session=session is not None,
                ) as sp:
                    if ctl is not None and ctl.span_retention_shed():
                        # brownout rung 1: run unsampled — the root ring
                        # stops retaining trees for traffic the server is
                        # actively shedding
                        sp.sampled = False
                    with ledger_scope() as led:
                        payload = self._execute_request(
                            req, query, graph, session, sp
                        )
                # echo the trace id so the caller can pull the stitched
                # trace from GET /telemetry
                payload["status"]["trace"] = f"{sp.trace_id:016x}"
                cells = led.op_cells()
                resources = led.to_dict()
                if resources:
                    payload["status"]["ledger"] = resources
            finally:
                wall_ms = (_time.perf_counter() - t0) * 1000.0
                from janusgraph_tpu_torch.observability import registry

                # the latency SLO's signal: every request wall lands in
                # the aggregate timer, and — when the shape is priced —
                # in its digest-class timer, each class held to a
                # book-priced threshold (observability/slo.py). Digest
                # labels are bounded by the top-K-evicted price book.
                registry.timer("server.request.wall").update(
                    int(wall_ms * 1e6)
                )
                if ctl is not None:
                    if ticket is not None:
                        ctl.release(ticket, wall_ms)
                    # feed the measured cost back into the price book so
                    # the NEXT request of this shape is priced by data
                    ctl.observe_cost(digest, query, wall_ms, cells=cells)
                    if digest and (
                        ctl.price_book.mean_cost_ms(digest) is not None
                    ):
                        registry.timer(
                            "server.request.digest." + digest
                        ).update(int(wall_ms * 1e6))
        return payload

    def _execute_request(self, req, query, graph, session, sp) -> dict:
        from janusgraph_tpu_torch.core import deadline as _deadline
        from janusgraph_tpu_torch.exceptions import DeadlineExceededError

        server = self.jg_server
        me = threading.get_ident()
        # the active-request table: what a forensics bundle shows as
        # "in flight right now", and the watchdog's progress signal
        with server._sessions_lock:
            server._active_requests[me] = {
                "thread": threading.current_thread().name,
                "graph": graph or server.default_graph,
                "query": query[:200],
                "since": time.time(),
            }
        try:
            return self._execute_request_inner(req, query, graph, session, sp)
        finally:
            with server._sessions_lock:
                server._active_requests.pop(me, None)
                server._completed_requests += 1

    def _execute_request_inner(self, req, query, graph, session, sp) -> dict:
        from janusgraph_tpu_torch.core import deadline as _deadline
        from janusgraph_tpu_torch.exceptions import DeadlineExceededError

        try:
            if session is not None:
                result = self.jg_server.execute_session(
                    query, graph, session
                )
            else:
                result = self.jg_server.execute(query, graph)
            # wall-clock deadline on EVALUATION, not just on reads: an
            # evaluation that ran past the budget returns a structured
            # timeout (nobody is waiting for the late answer) instead of
            # a success on a connection the client already abandoned
            _deadline.check("query evaluation")
            data = json.loads(graphson_dumps(result))
            sp.annotate(code=200)
            return {"result": {"data": data}, "status": {"code": 200}}
        except DeadlineExceededError as e:
            # structured timeout, not a hung connection: the deadline
            # machinery (traversal checks + backend_op + the remote
            # protocols) aborted the evaluation mid-flight
            sp.annotate(code=504, error=type(e).__name__)
            return _timeout_payload(e)
        except QueryTooLongError as e:
            # client error, like the 413 for max-request-bytes — a retry
            # of the identical oversized query can never succeed
            sp.annotate(code=413)
            return {
                "result": {"data": None},
                "status": {"code": 413, "message": str(e)},
            }
        except (QueryRejected, QueryError, KeyError, PermissionError,
                AttributeError) as e:
            # the request was WRONG (sandbox rejection, unknown graph,
            # read-only endpoint): a client error, not an incident — no
            # black-box dump, or every fuzzed bad query would write a file
            sp.annotate(code=500, error=type(e).__name__)
            return {
                "result": {"data": None},
                "status": {"code": 500, "message": f"{type(e).__name__}: {e}"},
            }
        except Exception as e:  # noqa: BLE001 - surface to client
            from janusgraph_tpu_torch.observability import (
                flight_recorder,
                get_logger,
            )

            sp.annotate(code=500, error=type(e).__name__)
            get_logger("server").error(
                "request-failed",
                error=type(e).__name__, message=str(e)[:500],
                graph=graph or "", query_len=len(query),
            )
            # unhandled evaluation error: black-box the timeline that led
            # here (one of the three dump triggers)
            flight_recorder.record(
                "server_error", error=type(e).__name__,
                message=str(e)[:200], graph=graph or "",
            )
            flight_recorder.dump(reason="server-error")
            # full forensics alongside the flight dump: flame windows,
            # stacks, timeseries tail, active requests (rate-limited and
            # a no-op unless metrics.bundle-dir is set)
            from janusgraph_tpu_torch.observability import bundle_writer

            bundle_writer.capture(reason="server-error")
            return {
                "result": {"data": None},
                "status": {"code": 500, "message": f"{type(e).__name__}: {e}"},
            }

    # ----------------------------------------------------------------- HTTP
    def do_GET(self):
        if self.path == "/health":
            self._send_json(200, {"status": "ok"})
            return
        if self.path == "/healthz":
            # ok/degraded from breaker states + fault/recovery counters:
            # "am I serving, and is anything currently failing over"
            # (unauthenticated like /health — liveness probes carry no
            # credentials, and nothing here includes data content)
            payload = healthz_snapshot()
            # fleet identity + drain state ride along so the router's
            # probe sees admission load, burn rate, AND lifecycle in one
            # round trip; draining is deliberate, so it does not flip the
            # ok/degraded verdict
            server = self.jg_server
            if server.replica_name:
                payload["replica"] = server.replica_name
            payload["draining"] = server.draining
            payload["open_sessions"] = server.open_sessions
            if server.gossip is not None:
                payload["fleet_peers"] = dict(server.gossip.peer_state)
            if server.cdc_state is not None:
                # replication lane: role + durable cursor + honest
                # staleness; a follower past the priced staleness bound
                # IS degraded — the router must stop preferring it
                cdc = server.cdc_state.healthz_block()
                payload["cdc"] = cdc
                if cdc.get("degraded"):
                    payload["status"] = "degraded"
            code = 200 if payload["status"] == "ok" else 503
            self._send_json(code, payload)
            return
        if self.path == "/metrics":
            # Prometheus text exposition of the process registry. Like
            # /health, unauthenticated: scrapers don't carry credentials
            # and nothing here includes query or data content.
            from janusgraph_tpu_torch.observability import (
                prometheus_text,
                registry,
            )

            body = prometheus_text(registry).encode("utf-8")
            self.send_response(200)
            self.send_header(
                "Content-Type", "text/plain; version=0.0.4; charset=utf-8"
            )
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
            return
        if self.path == "/timeseries" or self.path.startswith("/timeseries?"):
            # the metrics history ring: per-window counter/timer deltas
            # with window percentiles (observability/timeseries.py).
            # ?name= prefix-filters series, ?window=N bounds to the last
            # N windows. Unauthenticated like /metrics — same content
            # class, just with a time axis. Bypasses admission (above).
            from urllib.parse import parse_qs, urlsplit

            from janusgraph_tpu_torch.observability import history

            qs = parse_qs(urlsplit(self.path).query)
            name = (qs.get("name") or [""])[0]
            try:
                window = int((qs.get("window") or ["0"])[0])
            except ValueError:
                self._send_json(400, {"status": {
                    "code": 400, "message": "window must be an integer",
                }})
                return
            if (qs.get("raw") or ["0"])[0] in ("1", "true"):
                # the federation scrape shape: full windows WITH bucket
                # delta vectors + this replica's clocks, so the fleet
                # frontend can merge exact percentiles and estimate our
                # wall-clock offset (observability/federation.py)
                self._send_json(200, history.scrape(last=window))
                return
            self._send_json(200, history.query(name=name, window=window))
            return
        if self.path.startswith("/profile/timeline"):
            # one OLAP run rendered to Chrome-trace (catapult) JSON —
            # loads unmodified in chrome://tracing / ui.perfetto.dev.
            # ?run= indexes the retained run records (negative = from
            # the end; default -1 = the last run).
            from urllib.parse import parse_qs, urlsplit

            from janusgraph_tpu_torch.observability import registry, render_run

            qs = parse_qs(urlsplit(self.path).query)
            try:
                run = int((qs.get("run") or ["-1"])[0])
            except ValueError:
                self._send_json(400, {"status": {
                    "code": 400, "message": "run must be an integer",
                }})
                return
            doc = render_run(registry, run=run)
            if doc is None:
                self._send_json(404, {"status": {
                    "code": 404,
                    "message": f"no retained OLAP run at index {run}",
                }})
                return
            self._send_json(200, doc)
            return
        if self.path == "/flight" or self.path.startswith("/flight?"):
            # black-box flight recorder: the bounded event ring, counts,
            # and last-dump pointer; ?dump=1 writes a dump file first and
            # returns its path (unauthenticated like /metrics: events are
            # operational, never query/data content)
            from janusgraph_tpu_torch.observability import flight_recorder

            if "dump=1" in self.path:
                flight_recorder.dump(reason="http-request")
            self._send_json(
                200,
                json.dumps(
                    flight_recorder.snapshot(), default=str
                ).encode("utf-8"),
            )
            return
        if self.path == "/profile" or self.path.startswith("/profile?"):
            # the query-digest table: top-K traversal shapes by total
            # cost with p50/p95 wall (unauthenticated like /metrics:
            # shapes are literal-stripped, never data content). Digests
            # the spillover planner promoted onto the OLAP executor are
            # marked so a dashboard can tell optimized shapes apart.
            from janusgraph_tpu_torch.observability.profiler import digest_table
            from janusgraph_tpu_torch.olap.spillover import promoted_digests

            promoted = promoted_digests()
            digests = digest_table.top(32)
            for d in digests:
                d["promoted"] = d["digest"] in promoted
            self._send_json(200, {"digests": digests})
            return
        if self.path.startswith("/profile/flame"):
            # collapsed-stack rendering of one retained trace's span
            # trees (with ledger annotations folded into frame names) —
            # pipe into any flamegraph renderer
            from urllib.parse import parse_qs, urlsplit

            from janusgraph_tpu_torch.observability import tracer
            from janusgraph_tpu_torch.observability.profiler import flame_text

            qs = parse_qs(urlsplit(self.path).query)
            trace_id = (qs.get("trace") or [""])[0]
            if not trace_id:
                self._send_json(400, {"status": {
                    "code": 400, "message": "missing ?trace=<id>",
                }})
                return
            text = flame_text(tracer, trace_id)
            if not text:
                self._send_json(404, {"status": {
                    "code": 404,
                    "message": f"trace {trace_id!r} not retained",
                }})
                return
            body = (text + "\n").encode("utf-8")
            self.send_response(200)
            self.send_header("Content-Type", "text/plain; charset=utf-8")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
            return
        if self.path.startswith("/debug/profile/diff"):
            # differential flamegraph between two sealed flame windows:
            # ?a=&b= are window seqs (negative = index from the newest,
            # -1 = last), ?top=N bounds the frame list. Output is the
            # flamediff structure (observability/continuous.py) — per
            # frame self-sample delta, a-count, b-count — the "what got
            # slower between these two minutes" question answered
            # without shipping raw stacks.
            from urllib.parse import parse_qs, urlsplit

            from janusgraph_tpu_torch.observability import sampling_profiler
            from janusgraph_tpu_torch.observability.continuous import flamediff

            qs = parse_qs(urlsplit(self.path).query)
            try:
                a = int((qs.get("a") or ["-2"])[0])
                b = int((qs.get("b") or ["-1"])[0])
                top = int((qs.get("top") or ["50"])[0])
            except ValueError:
                self._send_json(400, {"status": {
                    "code": 400, "message": "a, b, top must be integers",
                }})
                return
            retained = sampling_profiler.windows()
            by_seq = {w.get("seq"): w for w in retained}

            def _pick(key):
                if key in by_seq:
                    return by_seq[key]
                if key < 0 and -key <= len(retained):
                    return retained[key]
                return None

            wa, wb = _pick(a), _pick(b)
            if wa is None or wb is None:
                self._send_json(404, {"status": {
                    "code": 404,
                    "message": "flame window not retained "
                               f"(a={a} b={b}; retained "
                               f"{sorted(k for k in by_seq if k)})",
                }})
                return
            self._send_json(200, {
                "a": {"seq": wa.get("seq"), "ts": wa.get("ts"),
                      "samples": wa.get("samples")},
                "b": {"seq": wb.get("seq"), "ts": wb.get("ts"),
                      "samples": wb.get("samples")},
                "frames": flamediff(wa, wb, top=top),
            })
            return
        if self.path.startswith("/debug/profile"):
            # the continuous profiler's collapsed-stack flamegraph (the
            # whole process, merged over retained windows; ?window=N
            # bounds to the last N). Unauthenticated like /metrics —
            # frames are code locations, never data content. Like every
            # observability endpoint, bypasses admission.
            from urllib.parse import parse_qs, urlsplit

            from janusgraph_tpu_torch.observability import sampling_profiler

            qs = parse_qs(urlsplit(self.path).query)
            try:
                window = int((qs.get("window") or ["0"])[0])
            except ValueError:
                self._send_json(400, {"status": {
                    "code": 400, "message": "window must be an integer",
                }})
                return
            body = sampling_profiler.flame_text(last=window).encode(
                "utf-8"
            )
            self.send_response(200)
            self.send_header("Content-Type", "text/plain; charset=utf-8")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
            return
        if self.path == "/debug/stacks":
            # all-thread stack dump, the py-spy-dump equivalent over
            # HTTP: what is every thread doing RIGHT NOW
            from janusgraph_tpu_torch.observability import bundle_writer

            self._send_json(200, {"stacks": bundle_writer._all_stacks()})
            return
        if self.path == "/debug/bundle" or self.path.startswith(
            "/debug/bundle?"
        ):
            # the newest forensics bundle (?capture=1 forces a fresh one
            # first); a torn bundle on disk — a writer killed mid-write
            # before the atomic rename — is skipped, not fatal
            from janusgraph_tpu_torch.observability import bundle_writer

            if "capture=1" in self.path:
                bundle_writer.capture(reason="manual", force=True)
            got = bundle_writer.latest()
            if got is None:
                self._send_json(404, {"status": {
                    "code": 404,
                    "message": "no forensics bundle on disk "
                               "(set metrics.bundle-dir, or "
                               "?capture=1 to force one)",
                }})
                return
            self._send_json(200, got)
            return
        if self.path == "/telemetry" or self.path.startswith("/telemetry?"):
            # JSON snapshot: metrics + recent span trees + slow-op log +
            # structured run records (e.g. OLAP per-superstep telemetry)
            from janusgraph_tpu_torch.observability import (
                json_snapshot,
                registry,
                tracer,
            )

            body = json.dumps(
                json_snapshot(registry, tracer), default=str
            ).encode("utf-8")
            self._send_json(200, body)
            return
        if self.path == "/watch/info":
            # the streaming-transport capability handshake: advertises
            # the telemetry bus's streams and their CURRENT cursors (the
            # same producer-keyed vocabulary the federation scrape uses)
            # so a push-mode peer can negotiate before upgrading, and a
            # reconnecting subscriber can see what it missed. A peer that
            # 404s here is poll-only — the federation keeps the exact
            # scrape path for it. Unauthenticated like /metrics.
            from janusgraph_tpu_torch.observability import telemetry_bus
            from janusgraph_tpu_torch.observability.identity import replica_name
            from janusgraph_tpu_torch.observability.stream import STREAMS

            self._send_json(200, {
                "watch": True,
                "streams": list(STREAMS),
                "cursors": telemetry_bus.cursors(),
                "replica": self.jg_server.replica_name or replica_name(),
                "now": time.time(),
                "subscribers": telemetry_bus.subscriber_count(),
            })
            return
        if self.path == "/graphs":
            if not self._auth():
                return
            self._send_json(
                200, {"graphs": self.jg_server.manager.graph_names()}
            )
            return
        if self.path.startswith("/watch") and (
            self.headers.get("Upgrade", "").lower() == "websocket"
        ):
            self._watch_stream()
            return
        if self.path.startswith("/gremlin") and (
            self.headers.get("Upgrade", "").lower() == "websocket"
        ):
            self._websocket()
            return
        self._send_json(404, {"status": {"code": 404}})

    def do_POST(self):
        length = int(self.headers.get("Content-Length", 0))
        if length > self.jg_server.max_request_bytes:
            # keep-alive would try to parse the unread body as the next
            # request line — close instead of draining attacker-sized data
            self.close_connection = True
            self._send_json(413, {"status": {
                "code": 413,
                "message": f"request exceeds server.max-request-bytes "
                           f"({self.jg_server.max_request_bytes})",
            }})
            return
        raw = self.rfile.read(length)
        if self.path == "/session" or self.path == "/token":
            try:
                req = json.loads(raw)
                token = self.jg_server.authenticator.issue_token(
                    req["username"], req["password"]
                )
                self._send_json(200, {"token": token})
            except (AuthenticationError, KeyError, AttributeError) as e:
                self._send_json(401, {"status": {"code": 401, "message": str(e)}})
            return
        if self.path == "/gossip":
            # fleet state gossip (server/fleet.StateGossip): merge the
            # peer's digest (price-book records + brownout rung) and
            # answer with ours — the PULL half of push-pull anti-entropy.
            # Operational-plane content only (literal-stripped shapes,
            # bounded by the price book's top-K eviction), so it rides
            # unauthenticated like /metrics; 404 when no agent is wired.
            gossip = getattr(self.jg_server, "gossip", None)
            if gossip is None:
                self._send_json(404, {"status": {"code": 404}})
                return
            try:
                body = json.loads(raw)
            except json.JSONDecodeError:
                self._send_json(400, {"status": {
                    "code": 400, "message": "bad json",
                }})
                return
            gossip.merge(body)
            self._send_json(200, gossip.local_digest())
            return
        if self.path == "/gremlin" or self.path == "/":
            if not self._auth():
                return
            try:
                req = json.loads(raw)
            except json.JSONDecodeError:
                self._send_json(400, {"status": {"code": 400, "message": "bad json"}})
                return
            payload = self._run_request(
                req, trace_header=self.headers.get("X-Trace-Context"),
                deadline_header=self.headers.get("X-Deadline-Ms"),
            )
            status = payload.get("status", {})
            if status.get("status") == "shed" or (
                status.get("status") == "draining"
            ):
                # a REAL 503 (unlike embedded evaluation errors, which
                # stay HTTP 200 for driver compat): load balancers and
                # generic HTTP clients understand it, and EVERY shed
                # response carries Retry-After (decorrelated jitter)
                self._send_json(
                    503, payload,
                    extra_headers={
                        "Retry-After": str(status.get("retry_after_s", 1)),
                    },
                )
                return
            if status.get("status") == "timeout":
                self._send_json(504, payload)
                return
            self._send_json(200, payload)
            return
        self._send_json(404, {"status": {"code": 404}})

    # ------------------------------------------------------------ WebSocket
    def _watch_stream(self) -> None:
        """The ``/watch`` live-telemetry WebSocket: the telemetry bus's
        wire transport (observability/stream.py).

        Protocol: the client's FIRST text frame is the subscribe request
        ``{"streams": [...], "names": [...], "cursors": {...},
        "heartbeat_s": N, "name": "..."}`` (all optional; ``categories``
        is accepted as an alias for ``names``).  The server answers with
        a ``hello`` frame carrying the replica identity and the bus's
        CURRENT cursors, then streams ``{"type": "event", "stream",
        "seq", "data"}`` envelopes; an idle gap longer than
        ``heartbeat_s`` produces ``{"type": "heartbeat", "ts",
        "dropped"}`` so the peer can distinguish quiet from dead and
        watch its drop counter.  Cursors in the subscribe request resume
        past-tail replay exactly like a federation scrape cursor.
        Unauthenticated like /metrics — events are operational, never
        query/data content — and bypasses admission like every
        observability endpoint."""
        from janusgraph_tpu_torch.observability import telemetry_bus
        from janusgraph_tpu_torch.observability.identity import replica_name

        key = self.headers.get("Sec-WebSocket-Key", "")
        accept = base64.b64encode(
            hashlib.sha1((key + _WS_MAGIC).encode()).digest()
        ).decode()
        self.send_response(101, "Switching Protocols")
        self.send_header("Upgrade", "websocket")
        self.send_header("Connection", "Upgrade")
        self.send_header("Sec-WebSocket-Accept", accept)
        self.end_headers()
        # the socket is a WS stream from here on — never hand it back
        # to the HTTP request parser (covers every exit path below)
        self.close_connection = True
        sock = self.connection
        raw = _ws_recv(sock)
        if raw is None:
            return
        try:
            req = json.loads(raw)
            if not isinstance(req, dict):
                raise ValueError("subscribe frame must be an object")
        except ValueError as e:
            _ws_send(sock, json.dumps({
                "type": "error", "message": f"bad subscribe frame: {e}",
            }))
            return
        heartbeat_s = req.get("heartbeat_s", 5.0)
        try:
            heartbeat_s = min(30.0, max(0.2, float(heartbeat_s)))
        except (TypeError, ValueError):
            heartbeat_s = 5.0
        label = str(
            req.get("name") or "watch-%s" % (self.client_address[0],)
        )
        try:
            sub = telemetry_bus.subscribe(
                streams=req.get("streams") or None,
                names=tuple(
                    req.get("names") or req.get("categories") or ()
                ),
                cursors=req.get("cursors") or None,
                name=label,
            )
        except (TypeError, ValueError) as e:
            _ws_send(sock, json.dumps({
                "type": "error", "message": str(e),
            }))
            return
        server = self.jg_server
        try:
            _ws_send(sock, json.dumps({
                "type": "hello",
                "replica": server.replica_name or replica_name(),
                "streams": sorted(sub.streams),
                "cursors": telemetry_bus.cursors(),
                "heartbeat_s": heartbeat_s,
            }, default=str))
            while True:
                envelope = sub.pop(timeout=heartbeat_s)
                if envelope is None:
                    if sub.closed:
                        break
                    _ws_send(sock, json.dumps({
                        "type": "heartbeat",
                        "ts": time.time(),
                        "dropped": sub.dropped,
                    }))
                else:
                    _ws_send(sock, json.dumps({
                        "type": "event", **envelope,
                    }, default=str))
                # a readable socket mid-stream is the client talking —
                # a close frame (or EOF) ends the session; pings are
                # answered inside _ws_recv
                readable, _, _ = select.select([sock], [], [], 0)
                if readable and _ws_recv(sock) is None:
                    break
        except OSError:
            pass  # client went away mid-send; unsubscribe below
        finally:
            telemetry_bus.unsubscribe(sub)

    def _websocket(self) -> None:
        if not self._auth():
            return
        key = self.headers.get("Sec-WebSocket-Key", "")
        accept = base64.b64encode(
            hashlib.sha1((key + _WS_MAGIC).encode()).digest()
        ).decode()
        self.send_response(101, "Switching Protocols")
        self.send_header("Upgrade", "websocket")
        self.send_header("Connection", "Upgrade")
        self.send_header("Sec-WebSocket-Accept", accept)
        self.end_headers()
        sock = self.connection
        # session mode (the reference's in-session requests): any message
        # carrying a truthy "session" field switches this CONNECTION to a
        # shared-transaction session; the tx spans messages until the
        # query commits/rolls back, and a close without commit rolls back
        session = None
        # WS multiplexing (driver.ws-multiplex): a request carrying an
        # "id" field may run CONCURRENTLY with its siblings — the id is
        # echoed in the response so the driver demuxes out-of-order
        # completions. Requests WITHOUT ids (old drivers) and in-session
        # requests (one shared transaction) stay strictly serial, so old
        # clients see byte-identical ordered behavior.
        ws_pool = None
        send_lock = threading.Lock()

        def _send_locked(payload: dict) -> None:
            with send_lock:
                _ws_send(sock, json.dumps(payload))

        def _serve_tagged(req: dict) -> None:
            rid = req.get("id")
            try:
                payload = self._run_request(
                    req, session=None, trace_header=req.get("trace"),
                )
            except Exception as e:  # noqa: BLE001 - protocol boundary
                payload = {"status": {"code": 500, "message": str(e)}}
            payload["id"] = rid
            try:
                _send_locked(payload)
            except (ConnectionError, OSError):
                pass  # connection died mid-reply; the read loop notices
        try:
            while True:
                msg = _ws_recv(sock, self.jg_server.max_request_bytes)
                if msg is None:
                    break
                try:
                    req = json.loads(msg)
                except json.JSONDecodeError:
                    _send_locked(
                        {"status": {"code": 400, "message": "bad json"}}
                    )
                    continue
                if req.get("session") and session is None:
                    try:
                        session = self.jg_server.open_session()
                    except PermissionError as e:
                        # draining replica: refuse the NEW session with a
                        # structured response the driver/router can act
                        # on; the connection itself stays usable
                        payload = {"status": {
                            "code": 503, "status": "draining",
                            "message": str(e),
                        }}
                        if req.get("id") is not None:
                            payload["id"] = req.get("id")
                        _send_locked(payload)
                        continue
                if req.get("id") is not None and session is None:
                    from concurrent.futures import ThreadPoolExecutor

                    if ws_pool is None:
                        ws_pool = ThreadPoolExecutor(
                            max_workers=getattr(
                                self.jg_server, "ws_workers", 4
                            ),
                            thread_name_prefix="ws-mux",
                        )
                    ws_pool.submit(_serve_tagged, req)
                    continue
                payload = self._run_request(
                    req, session=session, trace_header=req.get("trace"),
                )
                if req.get("id") is not None:
                    # in-session requests run serially but still echo
                    # the id so a multiplexing driver can match them
                    payload["id"] = req.get("id")
                _send_locked(payload)
        except (ConnectionError, OSError):
            pass
        finally:
            if ws_pool is not None:
                ws_pool.shutdown(wait=False)
            if session is not None:
                self.jg_server.close_session(session)
        self.close_connection = True


# ------------------------------------------------------- RFC6455 frame codec

def _ws_recv(sock, max_bytes: int = 1 << 20) -> Optional[str]:
    """Read one text message (handles close/ping; no fragmentation).
    Frames above max_bytes (server.max-request-bytes) close the socket —
    reading an attacker-sized frame into memory is the thing to avoid."""
    while True:
        hdr = _read_exact(sock, 2)
        if hdr is None:
            return None
        b1, b2 = hdr
        opcode = b1 & 0x0F
        masked = b2 & 0x80
        length = b2 & 0x7F
        if length == 126:
            ext = _read_exact(sock, 2)
            if ext is None:
                return None
            (length,) = struct.unpack(">H", ext)
        elif length == 127:
            ext = _read_exact(sock, 8)
            if ext is None:
                return None
            (length,) = struct.unpack(">Q", ext)
        if length > max_bytes:
            return None  # oversized frame: drop the connection
        mask = _read_exact(sock, 4) if masked else b"\x00" * 4
        if mask is None:
            return None
        payload = _read_exact(sock, length) if length else b""
        if payload is None:
            return None
        if masked:
            payload = bytes(
                c ^ mask[i % 4] for i, c in enumerate(payload)
            )
        if opcode == 0x8:  # close
            return None
        if opcode == 0x9:  # ping -> pong
            _ws_send_raw(sock, 0xA, payload)
            continue
        if opcode in (0x1, 0x2):
            return payload.decode("utf-8")


def _ws_send(sock, text: str) -> None:
    _ws_send_raw(sock, 0x1, text.encode("utf-8"))


def _ws_send_raw(sock, opcode: int, payload: bytes) -> None:
    n = len(payload)
    hdr = bytearray([0x80 | opcode])
    if n < 126:
        hdr.append(n)
    elif n < (1 << 16):
        hdr.append(126)
        hdr += struct.pack(">H", n)
    else:
        hdr.append(127)
        hdr += struct.pack(">Q", n)
    sock.sendall(bytes(hdr) + payload)


def _read_exact(sock, n: int) -> Optional[bytes]:
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            return None
        buf += chunk
    return buf
