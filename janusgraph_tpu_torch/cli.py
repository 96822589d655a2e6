"""Command-line entry points — the port's copy of ``janusgraph_tpu/cli.py``
but its ``bench``:

  python -m janusgraph_tpu_torch server [--config graph.json] [--port 8182]
                                        [--graph-name NAME] [--load-gods]
                                        [--auth-credentials creds.json]
                                        [--replica-name NAME]
  python -m janusgraph_tpu_torch fleet [--config graph.json] [--port 8182]
                                       [--replicas N] [--graph-name NAME]
  python -m janusgraph_tpu_torch console [--config graph.json |
                                          --remote host:port] [--load-gods]
  python -m janusgraph_tpu_torch storage-server [--host H] [--port P]
                                                [--directory DIR |
                                                 --sharded-nodes N]
  python -m janusgraph_tpu_torch chaos [--seed S] [--txs N]
                                       [--error-rate R] [--compact]
  python -m janusgraph_tpu_torch telemetry|trace|flight|top|flame|bundle|
                                 timeseries|timeline [--url host:port] ...
  python -m janusgraph_tpu_torch incident|fleet-bundles --url host:port ...
  python -m janusgraph_tpu_torch watch --url host:port [--count N] ...
  python -m janusgraph_tpu_torch config-docs [--out FILE]
  python -m janusgraph_tpu_torch benchdiff OLD NEW [--threshold PCT]
                                           [--fail-on-regress] [--compact]
  python -m janusgraph_tpu_torch export|import --config graph.json ...

``server`` opens the graph its config file describes (an in-memory one
without ``--config``), registers it in the process's
``JanusGraphManager`` and serves it over HTTP and WebSocket
(``server/server.py``) with the ``server.*`` and ``metrics.*`` options of
that config: admission, deadlines, the metric history, SLOs, the
profiler and the watchdog. Its first line, ``JanusGraph-TPU server
listening on HOST:PORT``, is the reference's, and scripts read the address
from it (``--port 0`` binds a free port). A computer step in a query
(``g.V().pageRank()``) runs on the device the graph's
``computer.executor`` names: the card by default, which raises on a
machine without one; ``"cpu"`` runs the plain path.

``fleet`` runs N such replicas over one shared store behind the fleet
router and its HTTP frontend (``server/fleet.py``): health probes, state
gossip, drain, warm-up of every replica but the first from
``server.fleet.warmup-dir``, and with ``server.fleet.federation-enabled``
the federation's merged views (``/fleet/timeseries``, ``/fleet/metrics``,
``/fleet/incident``, ``/fleet/bundles``). Its last start-up line, ``fleet
frontend listening on HOST:PORT (N replicas)``, is the reference's.

``console`` is an interactive Python console holding ``g`` over a local
graph, or ``submit`` of a ``JanusGraphClient`` with ``--remote``.

``storage-server`` serves a storage backend over TCP
(``storage/remote.py``): the persistent local store in ``--directory``,
an N-node sharded composite (``storage/sharded_store.py``) with
``--sharded-nodes``, or by default an in-memory store. Its first line,
``storage server (KIND) listening on HOST:PORT``, is the contract scripts
read the address from (``--port 0`` binds a free port). Graph instances
open it with ``storage.backend`` "remote", ``storage.hostname`` and
``storage.port``; a client of either package talks to it. The server
never touches the card and never imports torch.

``chaos`` is the operator's seeded soak of the self-healing paths: an
OLTP workload on an in-memory graph under injected read and write faults,
a lock-lease expiry and a torn batch (``storage/faults.py``), then a
reopen whose torn-commit recovery heals the batch; it prints a JSON
report with the reference's keys and exits 1 if a vertex is missing.

The operator tools read this process's telemetry, or a running server's
(or fleet frontend's) with ``--url``: ``telemetry`` (Prometheus text or
JSON), ``trace`` (one stitched trace), ``flight`` (the flight recorder),
``top`` (the query digests), ``flame`` (one trace, or the sampling
profiler's windows with ``--live``), ``bundle`` (forensics bundles),
``timeseries`` (the metric history), ``timeline`` (one OLAP run as a
Chrome trace), ``incident`` (a fleet's merged failover timeline),
``watch`` (the live telemetry bus), ``fleet-bundles`` (bundles shipped to
a fleet frontend). ``config-docs`` renders the option registry;
``export`` and ``import`` move a graph through GraphSON or GraphML.

``benchdiff`` compares two bench artifacts cell by cell
(``observability/benchdiff.py``) and prints the report as JSON; it exits
2 for a missing file, 3 when no cell is in both, and 1 for a regression
under ``--fail-on-regress`` (``bin/torch_benchdiff.sh`` wraps it).

``bench`` runs the benchmark. The reference's runs its own ``bench.py``;
the port has no benchmark yet, so the parser knows the name and says so.
"""

from __future__ import annotations

import argparse
import code
import json
import os
import sys
from typing import Optional

_ROADMAP_TOOLS = (
    "ROADMAP.md Queue A, the port's own benchmark (bench runs it, and the "
    "port has none yet)"
)

#: the reference's subcommands the port refuses, each naming the item
_NOT_PORTED = ("bench",)


def _load_config(path: Optional[str]) -> dict:
    if not path:
        return {"storage.backend": "inmemory", "ids.authority-wait-ms": 0.0}
    with open(path) as f:
        return json.load(f)


def _slo_specs_from_config(cfg):
    """The stock SLO spec set sized from the metrics.slo-* keys."""
    from janusgraph_tpu_torch.observability.slo import default_specs

    return default_specs(
        availability_objective=cfg.get("metrics.slo-availability-objective"),
        latency_objective=cfg.get("metrics.slo-latency-objective"),
        latency_threshold_ms=cfg.get("metrics.slo-latency-threshold-ms"),
        freshness_max_staleness=cfg.get("metrics.slo-freshness-max-staleness"),
        fast_windows=cfg.get("metrics.slo-fast-windows"),
        slow_windows=cfg.get("metrics.slo-slow-windows"),
        page_burn=cfg.get("metrics.slo-page-burn"),
        ticket_burn=cfg.get("metrics.slo-ticket-burn"),
    )


def cmd_server(args) -> int:
    """Serve one graph over HTTP and WebSocket until interrupted."""
    from janusgraph_tpu_torch.core.graph import open_graph
    from janusgraph_tpu_torch.observability import set_replica
    from janusgraph_tpu_torch.server import JanusGraphManager, JanusGraphServer

    cfg = _load_config(args.config)
    graph = open_graph(cfg)
    replica = args.replica_name or graph.config.get(
        "server.fleet.replica-name"
    )
    if replica:
        # tag this process's flight events / logs / metrics with the
        # fleet identity (observability/identity.py)
        set_replica(replica)
    if args.load_gods:
        from janusgraph_tpu_torch.core import gods

        gods.load(graph)
    manager = JanusGraphManager.get_instance()
    manager.put_graph(args.graph_name, graph)

    authenticator = None
    if args.auth_credentials:
        from janusgraph_tpu_torch.core.graph import open_graph as _og
        from janusgraph_tpu_torch.server import (
            CredentialsAuthenticator,
            HMACAuthenticator,
        )

        creds_cfg = _load_config(args.auth_credentials)
        # server.auth.credentials-db names the credentials graph
        creds_cfg.setdefault(
            "graph.graphname",
            graph.config.get("server.auth.credentials-db"),
        )
        creds_graph = _og(creds_cfg)
        secret = graph.config.get("server.auth.secret")
        authenticator = HMACAuthenticator(
            CredentialsAuthenticator(creds_graph),
            secret=secret.encode() if secret else None,
            token_ttl_seconds=(
                graph.config.get("server.auth.token-ttl-ms") / 1000.0
            ),
        )

    admission = None
    if graph.config.get("server.admission.enabled"):
        from janusgraph_tpu_torch.server.admission import AdmissionController

        admission = AdmissionController.from_config(graph.config)
    server = JanusGraphServer(
        manager=manager,
        default_graph=args.graph_name,
        authenticator=authenticator,
        host=args.host,
        port=args.port,
        max_request_bytes=graph.config.get("server.max-request-bytes"),
        max_query_length=graph.config.get("server.max-query-length"),
        request_timeout_s=graph.config.get("server.request-timeout-s"),
        auto_commit=graph.config.get("server.auto-commit"),
        admission=admission,
        admission_enabled=graph.config.get("server.admission.enabled"),
        default_deadline_ms=graph.config.get("server.deadline.default-ms"),
        max_deadline_ms=graph.config.get("server.deadline.max-ms"),
        history_enabled=graph.config.get("metrics.history-enabled"),
        slo_enabled=graph.config.get("metrics.slo-enabled"),
        slo_specs=_slo_specs_from_config(graph.config),
        replica_name=replica,
        profiler_enabled=graph.config.get("metrics.profile-enabled"),
        watchdog_enabled=graph.config.get("server.watchdog-enabled"),
        bundle_dir=graph.config.get("metrics.bundle-dir"),
    ).start()
    print(f"JanusGraph-TPU server listening on {args.host}:{server.port}", flush=True)
    try:
        import threading

        threading.Event().wait()
    except KeyboardInterrupt:
        pass
    finally:
        server.stop()
        graph.close()
    return 0


def cmd_fleet(args) -> int:
    """Run a serving FLEET: N JanusGraphServer replicas over ONE shared
    storage backend, fronted by the consistent-hash/least-loaded router
    (server/fleet.py) with health probes, state gossip, and replica
    warm-up from the shard-checkpoint snapshot pack. The in-process shape
    of the reference deployment model — for production the same router
    library fronts replicas on separate hosts speaking to a shared
    storage-server endpoint (storage.backend=remote)."""
    from janusgraph_tpu_torch.core.graph import open_graph
    from janusgraph_tpu_torch.observability import set_replica
    from janusgraph_tpu_torch.server import (
        FleetFrontend,
        FleetRouter,
        JanusGraphManager,
        JanusGraphServer,
        StateGossip,
    )
    from janusgraph_tpu_torch.server.fleet import warm_replica

    cfg = _load_config(args.config)
    set_replica("fleet-frontend")
    # one shared backing for every replica: inmemory shares the manager
    # object in-process; remote/local replicas each open their own client
    # to the SAME endpoint/directory (the config already names it)
    shared = None
    if cfg.get("storage.backend", "inmemory") == "inmemory":
        from janusgraph_tpu_torch.storage.inmemory import InMemoryStoreManager

        shared = InMemoryStoreManager()
    graphs, servers, gossips = [], [], []
    first = open_graph(dict(cfg), store_manager=shared)
    n = args.replicas or first.config.get("server.fleet.replicas")
    probe_interval = first.config.get("server.fleet.probe-interval-s")
    probe_timeout = first.config.get("server.fleet.probe-timeout-s")
    router = FleetRouter(
        vnodes=first.config.get("server.fleet.vnodes"),
        candidates=first.config.get("server.fleet.candidates"),
        probe_timeout_s=probe_timeout,
        trend_windows=first.config.get("server.fleet.trend-windows"),
    )
    warmup_dir = first.config.get("server.fleet.warmup-dir")
    try:
        for i in range(n):
            graph = first if i == 0 else open_graph(
                dict(cfg), store_manager=shared
            )
            if i > 0:
                graphs.append(graph)
            name = f"r{i}"
            if i > 0 and warmup_dir:
                warm_replica(graph, warmup_dir, replica=name)
            manager = JanusGraphManager()
            manager.put_graph(args.graph_name, graph)
            server = JanusGraphServer(
                manager=manager,
                default_graph=args.graph_name,
                host=args.host,
                port=0,
                replica_name=name,
                # process-global planes (history sampler, SLO engine)
                # belong to ONE owner in an in-process fleet
                history_enabled=(i == 0) and graph.config.get(
                    "metrics.history-enabled"
                ),
                slo_enabled=(i == 0) and graph.config.get(
                    "metrics.slo-enabled"
                ),
                # like history/SLO: the sampler, watchdog, and bundle
                # plane are process-global — replica 0 owns them
                profiler_enabled=(i == 0) and graph.config.get(
                    "metrics.profile-enabled"
                ),
                watchdog_enabled=(i == 0) and graph.config.get(
                    "server.watchdog-enabled"
                ),
                bundle_dir=(
                    graph.config.get("metrics.bundle-dir") if i == 0
                    else ""
                ),
            ).start()
            servers.append(server)
            gossip = StateGossip(
                name, server.admission,
                fanout=graph.config.get("server.fleet.gossip-fanout"),
                timeout_s=probe_timeout,
            )
            server.gossip = gossip
            gossips.append(gossip)
            router.add_replica(name, args.host, server.port)
        urls = [f"http://{args.host}:{s.port}" for s in servers]
        for i, gossip in enumerate(gossips):
            gossip.set_peers([u for j, u in enumerate(urls) if j != i])
            gossip.start(
                interval_s=first.config.get(
                    "server.fleet.gossip-interval-s"
                )
            )
        router.probe()
        router.start_probes(interval_s=probe_interval)
        federation = None
        if first.config.get("server.fleet.federation-enabled"):
            from janusgraph_tpu_torch.observability.federation import (
                FleetFederation,
            )

            federation = FleetFederation(
                router,
                interval_s=first.config.get(
                    "server.fleet.federation-interval-s"
                ),
                timeout_s=first.config.get(
                    "server.fleet.federation-timeout-s"
                ),
                retention=first.config.get("metrics.fleet-retention"),
                outlier_metric=first.config.get(
                    "metrics.fleet-outlier-metric"
                ),
                outlier_factor=first.config.get(
                    "metrics.fleet-outlier-factor"
                ),
                outlier_min_count=first.config.get(
                    "metrics.fleet-outlier-min-count"
                ),
                push_enabled=first.config.get("server.fleet.push-enabled"),
                ship_bundles=first.config.get(
                    "server.fleet.push-ship-bundles"
                ),
                bundle_retention=first.config.get(
                    "server.fleet.push-bundle-retention"
                ),
                bundle_min_interval_s=first.config.get(
                    "server.fleet.push-bundle-min-interval-s"
                ),
            )
            federation.start()
        frontend = FleetFrontend(
            router, host=args.host, port=args.port,
            federation=federation,
        ).start()
        for server in servers:
            print(f"  replica {server.replica_name}: "
                  f"{args.host}:{server.port}", flush=True)
        print(f"fleet frontend listening on {args.host}:{frontend.port} "
              f"({n} replicas)", flush=True)
        try:
            import threading

            threading.Event().wait()
        except KeyboardInterrupt:
            pass
        finally:
            frontend.stop()
            if federation is not None:
                federation.stop()
    finally:
        router.stop()
        for gossip in gossips:
            gossip.stop()
        for server in servers:
            server.stop()
        for graph in graphs:
            graph.close()
        first.close()
    return 0


def cmd_console(args) -> int:
    """An interactive console over a local graph (``g``) or a running
    server (``submit``)."""
    banner = "JanusGraph-TPU console — `g` is the traversal source, `P` the predicates"
    ns = {}
    if args.remote:
        from janusgraph_tpu_torch.driver import JanusGraphClient

        host, _, port = args.remote.partition(":")
        client = JanusGraphClient(host=host, port=int(port or 8182))
        ns["client"] = client
        ns["submit"] = client.submit
        banner = (
            "JanusGraph-TPU remote console — submit('g.V()...') runs on "
            f"{args.remote}"
        )
    else:
        from janusgraph_tpu_torch.core.codecs import Direction
        from janusgraph_tpu_torch.core.graph import open_graph
        from janusgraph_tpu_torch.core.traversal import P, Pick, T
        from janusgraph_tpu_torch.core.traversal import __ as _anon

        graph = open_graph(_load_config(args.config))
        if args.load_gods:
            from janusgraph_tpu_torch.core import gods

            gods.load(graph)
        ns.update({
            "graph": graph, "g": graph.traversal(), "P": P, "__": _anon,
            "T": T, "Direction": Direction, "Pick": Pick,
        })
    code.interact(banner=banner, local=ns)
    return 0


def cmd_storage_server(args) -> int:
    """Serve a storage backend over TCP (the remote KCVS endpoint other
    instances open with storage.backend=remote) until interrupted."""
    from janusgraph_tpu_torch.storage.remote import RemoteStoreServer

    if args.directory:
        from janusgraph_tpu_torch.storage.localstore import open_local_kcvs

        manager = open_local_kcvs(args.directory)
        kind = f"local({args.directory})"
    elif args.sharded_nodes is not None:
        if args.sharded_nodes < 1:
            print("--sharded-nodes must be >= 1", file=sys.stderr)
            return 2
        from janusgraph_tpu_torch.storage.sharded_store import ShardedStoreManager

        manager = ShardedStoreManager(num_nodes=args.sharded_nodes)
        kind = f"sharded({args.sharded_nodes})"
    else:
        from janusgraph_tpu_torch.storage.inmemory import InMemoryStoreManager

        manager = InMemoryStoreManager()
        kind = "inmemory"
    server = RemoteStoreServer(manager, host=args.host, port=args.port).start()
    host, port = server.address
    print(f"storage server ({kind}) listening on {host}:{port}", flush=True)
    print(
        "connect with open_graph({'storage.backend': 'remote', "
        f"'storage.hostname': '{host}', 'storage.port': {port}}})",
        flush=True,
    )
    try:
        import time as _t

        while True:
            _t.sleep(3600)
    except KeyboardInterrupt:
        server.stop()
    return 0


def cmd_telemetry(args) -> int:
    """Dump telemetry: Prometheus text (default) or the JSON snapshot.
    With --url, scrape a RUNNING server's /metrics (or /telemetry with
    --json); without, render this process's registry — useful from
    scripts/consoles that imported the package and did work."""
    if args.url:
        import urllib.request

        base = args.url.rstrip("/")
        if not base.startswith("http"):
            base = "http://" + base
        path = "/telemetry" if args.json else "/metrics"
        with urllib.request.urlopen(base + path, timeout=10) as resp:
            sys.stdout.write(resp.read().decode("utf-8"))
        return 0
    from janusgraph_tpu_torch.observability import (
        json_snapshot,
        prometheus_text,
        registry,
        tracer,
    )

    if args.json:
        print(json.dumps(json_snapshot(registry, tracer), indent=2,
                         default=str))
    else:
        sys.stdout.write(prometheus_text(registry))
    return 0


def cmd_trace(args) -> int:
    """Print every retained span tree of one trace id (the stitched
    cross-process view): local process registry by default, or a running
    server's /telemetry snapshot with --url."""
    try:
        trace_id = f"{int(args.trace_id, 16):016x}"
    except ValueError:
        print(f"not a hex trace id: {args.trace_id!r}", file=sys.stderr)
        return 2
    if args.url:
        import urllib.request

        base = args.url.rstrip("/")
        if not base.startswith("http"):
            base = "http://" + base
        with urllib.request.urlopen(base + "/telemetry", timeout=10) as resp:
            payload = json.loads(resp.read().decode("utf-8"))
        trees = [
            s for s in payload.get("spans", [])
            if s.get("trace_id") == trace_id
        ]
    else:
        from janusgraph_tpu_torch.observability import tracer

        trees = [r.to_dict() for r in tracer.find_trace(trace_id)]
    print(json.dumps({"trace_id": trace_id, "spans": trees}, indent=2,
                     default=str))
    return 0 if trees else 1


def cmd_flight(args) -> int:
    """Dump the black-box flight recorder: the bounded ring of salient
    events (injected faults, breaker transitions, retry exhaustions, torn
    recoveries, checkpoints, OLAP resumes, slow spans). --dump also
    writes a JSON dump file; --url reads a running server's /flight."""
    if args.url:
        import urllib.request

        base = args.url.rstrip("/")
        if not base.startswith("http"):
            base = "http://" + base
        path = "/flight?dump=1" if args.dump else "/flight"
        with urllib.request.urlopen(base + path, timeout=10) as resp:
            sys.stdout.write(resp.read().decode("utf-8"))
            sys.stdout.write("\n")
        return 0
    from janusgraph_tpu_torch.observability import flight_recorder

    if args.dump:
        path = flight_recorder.dump(reason="cli")
        print(f"dumped -> {path}", file=sys.stderr)
    print(json.dumps(flight_recorder.snapshot(), indent=2, default=str))
    return 0


def cmd_top(args) -> int:
    """Print the query-digest table: the top-K traversal shapes by total
    cost (count, total/p50/p95 wall, cells). Local process table by
    default, or a running server's GET /profile with --url."""
    if args.url:
        import urllib.request

        base = args.url.rstrip("/")
        if not base.startswith("http"):
            base = "http://" + base
        with urllib.request.urlopen(base + "/profile", timeout=10) as resp:
            payload = json.loads(resp.read().decode("utf-8"))
        digests = payload.get("digests", [])
    else:
        from janusgraph_tpu_torch.observability.profiler import digest_table
        from janusgraph_tpu_torch.olap.spillover import promoted_digests

        promoted = promoted_digests()
        digests = digest_table.top(args.k)
        for d in digests:
            d["promoted"] = d["digest"] in promoted
    if args.json:
        print(json.dumps({"digests": digests[: args.k]}, indent=2))
        return 0
    print(f"{'digest':10} {'count':>7} {'total_ms':>10} {'p50_ms':>8} "
          f"{'p95_ms':>8} {'cells':>9}  shape")
    for d in digests[: args.k]:
        # spillover-promoted shapes (running on the OLAP executor) are
        # marked like GET /profile marks them
        mark = "*" if d.get("promoted") else " "
        print(f"{d['digest']:9}{mark} {d['count']:>7} "
              f"{d['total_ms']:>10.2f} "
              f"{d['p50_ms']:>8.2f} {d['p95_ms']:>8.2f} "
              f"{d['total_cells']:>9}  {d['shape']}")
    return 0


def cmd_flame(args) -> int:
    """Render one stitched trace's span trees to collapsed-stack lines
    (pipe into any flamegraph renderer). Local tracer by default, or a
    running server's GET /profile/flame with --url. --live renders the
    continuous sampling profiler's merged flame windows instead — what
    every thread was actually doing, no instrumentation required."""
    if args.live:
        if args.url:
            import urllib.error
            import urllib.request

            base = args.url.rstrip("/")
            if not base.startswith("http"):
                base = "http://" + base
            try:
                with urllib.request.urlopen(
                    base + f"/debug/profile?window={args.window}",
                    timeout=10,
                ) as resp:
                    sys.stdout.write(resp.read().decode("utf-8"))
                return 0
            except urllib.error.HTTPError as e:
                print(f"server: {e}", file=sys.stderr)
                return 1
        from janusgraph_tpu_torch.observability import sampling_profiler

        text = sampling_profiler.flame_text(last=args.window)
        if not text:
            print("no samples collected (is the profiler running?)",
                  file=sys.stderr)
            return 1
        print(text)
        return 0
    if not args.trace_id:
        print("trace_id required (or --live for the sampling profiler)",
              file=sys.stderr)
        return 2
    try:
        trace_id = f"{int(args.trace_id, 16):016x}"
    except ValueError:
        print(f"not a hex trace id: {args.trace_id!r}", file=sys.stderr)
        return 2
    if args.url:
        import urllib.error
        import urllib.request

        base = args.url.rstrip("/")
        if not base.startswith("http"):
            base = "http://" + base
        try:
            with urllib.request.urlopen(
                base + f"/profile/flame?trace={trace_id}", timeout=10
            ) as resp:
                sys.stdout.write(resp.read().decode("utf-8"))
            return 0
        except urllib.error.HTTPError as e:
            print(f"server: {e}", file=sys.stderr)
            return 1
    from janusgraph_tpu_torch.observability import tracer
    from janusgraph_tpu_torch.observability.profiler import flame_text

    text = flame_text(tracer, trace_id)
    if not text:
        print(f"trace {trace_id} not retained", file=sys.stderr)
        return 1
    print(text)
    return 0


def cmd_bundle(args) -> int:
    """Fetch the newest anomaly forensics bundle — flame windows, the
    flight ring, the timeseries tail, all-thread stacks, in-flight
    requests — from a running server's GET /debug/bundle with --url, or
    this process's bundle directory. --capture forces a fresh capture
    first (rate limit bypassed)."""
    if args.url:
        import urllib.error
        import urllib.request

        base = args.url.rstrip("/")
        if not base.startswith("http"):
            base = "http://" + base
        path = "/debug/bundle?capture=1" if args.capture else "/debug/bundle"
        try:
            with urllib.request.urlopen(base + path, timeout=30) as resp:
                sys.stdout.write(resp.read().decode("utf-8"))
                sys.stdout.write("\n")
            return 0
        except urllib.error.HTTPError as e:
            print(f"server: {e}", file=sys.stderr)
            return 1
    from janusgraph_tpu_torch.observability import bundle_writer

    if args.capture:
        path = bundle_writer.capture(reason="cli", force=True)
        if path is None:
            print("capture failed (is metrics.bundle-dir set?)",
                  file=sys.stderr)
            return 1
        print(f"captured -> {path}", file=sys.stderr)
    got = bundle_writer.latest()
    if got is None:
        print("no bundle on disk (set metrics.bundle-dir, or --capture)",
              file=sys.stderr)
        return 1
    print(json.dumps(got, indent=2, default=str))
    return 0


def cmd_timeseries(args) -> int:
    """Query the metrics history ring: per-window counter/timer deltas
    with window percentiles. Local process ring by default, a running
    server's GET /timeseries with --url; --export writes the retained
    windows as JSONL for offline analysis."""
    if args.url:
        import urllib.parse
        import urllib.request

        base = args.url.rstrip("/")
        if not base.startswith("http"):
            base = "http://" + base
        qs = urllib.parse.urlencode(
            {"name": args.name, "window": args.window}
        )
        with urllib.request.urlopen(
            base + "/timeseries?" + qs, timeout=10
        ) as resp:
            payload = json.loads(resp.read().decode("utf-8"))
    else:
        from janusgraph_tpu_torch.observability import history

        if args.export:
            n = history.export_jsonl(args.export, last=args.window)
            print(f"exported {n} windows -> {args.export}", file=sys.stderr)
        payload = history.query(name=args.name, window=args.window)
    print(json.dumps(payload, indent=2, default=str))
    return 0


def cmd_incident(args) -> int:
    """Pull a fleet frontend's merged incident report (GET
    /fleet/incident): every replica's flight ring, offset-corrected onto
    one clock and causally ordered, with the failover narrative
    (kill -> mark_dead -> re-pin -> warm-up) and a Chrome-trace document
    (one lane per replica). --trace-out writes the trace JSON for
    chrome://tracing / ui.perfetto.dev; --json prints the full payload."""
    import urllib.request

    base = args.url.rstrip("/")
    if not base.startswith("http"):
        base = "http://" + base
    url = base + f"/fleet/incident?window={args.window}"
    with urllib.request.urlopen(url, timeout=10) as resp:
        payload = json.loads(resp.read().decode("utf-8"))
    if args.trace_out:
        with open(args.trace_out, "w") as f:
            json.dump(payload.get("trace", {}), f, indent=2, default=str)
        print(f"trace -> {args.trace_out}", file=sys.stderr)
    if args.json:
        print(json.dumps(payload, indent=2, default=str))
        return 0
    events = payload.get("events", [])
    print(f"incident window: last {payload.get('window_s')}s  "
          f"replicas: {', '.join(payload.get('replicas', [])) or '-'}  "
          f"events: {len(events)}"
          + ("  PARTIAL (missing: "
             + ", ".join(payload.get("missing", [])) + ")"
             if payload.get("partial") else ""))
    for p in payload.get("phases", []):
        print(f"  {p['phase']:>10}  t={p['ts_corrected']:.6f}  "
              f"lane={p['lane'] or '-'}  {p.get('detail') or ''}")
    for e in events[-args.tail:] if args.tail else events:
        detail = e.get("action") or e.get("kind") or ""
        print(f"  {e['ts_corrected']:.6f}  [{e['lane'] or '-':>8}]  "
              f"{e.get('category')}{':' + str(detail) if detail else ''}")
    return 0


def cmd_watch(args) -> int:
    """Live-tail a server's telemetry bus over the /watch WebSocket
    (observability/stream.py): flight events, sealed metrics windows,
    SLO transitions, flame-window seals, and bundle announcements as
    they happen — no polling. --cursor resumes a stream past an
    already-seen seq (the federation's cursor vocabulary), --names
    prefix-filters, and heartbeats keep quiet streams distinguishable
    from dead servers."""
    from janusgraph_tpu_torch.driver.client import WatchSession

    subscribe = {"name": "cli-watch"}
    if args.streams:
        subscribe["streams"] = [
            s.strip() for s in args.streams.split(",") if s.strip()
        ]
    if args.names:
        subscribe["names"] = [
            s.strip() for s in args.names.split(",") if s.strip()
        ]
    if args.cursor:
        cursors = {}
        for pair in args.cursor:
            stream, _, seq = pair.partition("=")
            try:
                cursors[stream] = int(seq)
            except ValueError:
                print(f"bad --cursor {pair!r} (want stream=seq)",
                      file=sys.stderr)
                return 2
        subscribe["cursors"] = cursors
    if args.heartbeat:
        subscribe["heartbeat_s"] = args.heartbeat
    try:
        session = WatchSession(
            args.url, subscribe=subscribe, connect_timeout_s=5.0
        )
    except (OSError, ConnectionError) as e:
        print(f"connect failed: {e}", file=sys.stderr)
        return 1
    seen = 0
    try:
        while True:
            try:
                frame = session.recv(timeout=2.0)
            except ConnectionError as e:
                print(f"stream closed: {e}", file=sys.stderr)
                return 1
            if frame is None:
                continue
            if args.json:
                print(json.dumps(frame, default=str))
                sys.stdout.flush()
            else:
                kind = frame.get("type")
                if kind == "hello":
                    print(f"# watching {frame.get('replica') or '-'}  "
                          f"streams={','.join(frame.get('streams', []))}  "
                          f"cursors={frame.get('cursors')}",
                          file=sys.stderr)
                elif kind == "heartbeat":
                    if args.heartbeats:
                        print(f"# heartbeat dropped={frame.get('dropped')}",
                              file=sys.stderr)
                elif kind == "event":
                    data = frame.get("data") or {}
                    detail = (
                        data.get("category")
                        or f"window counters={len(data.get('counters') or {})}"
                        f" series={len(data.get('series') or {})}"
                    )
                    extra = data.get("action") or data.get("kind") or ""
                    print(f"[{frame.get('stream'):>7} "
                          f"#{frame.get('seq')}] {detail}"
                          + (f":{extra}" if extra else ""))
                    sys.stdout.flush()
                else:
                    print(json.dumps(frame, default=str), file=sys.stderr)
            if frame.get("type") == "event":
                seen += 1
                if args.count and seen >= args.count:
                    return 0
    except KeyboardInterrupt:
        return 0
    finally:
        session.close()


def cmd_fleet_bundles(args) -> int:
    """List or fetch forensics bundles a fleet frontend shipped
    off-host (GET /fleet/bundles): bundles announced on each replica's
    telemetry bus are retained at the frontend, so a dead replica's
    evidence is still retrievable here."""
    import urllib.request

    base = args.url.rstrip("/")
    if not base.startswith("http"):
        base = "http://" + base
    url = base + "/fleet/bundles"
    if args.replica:
        url += f"?replica={args.replica}&i={args.index}"
    with urllib.request.urlopen(url, timeout=10) as resp:
        payload = json.loads(resp.read().decode("utf-8"))
    if args.replica or args.json:
        print(json.dumps(payload, indent=2, default=str))
        return 0
    rows = payload.get("bundles", [])
    push = payload.get("push", {})
    print(f"shipped bundles: {len(rows)}  "
          f"(fetched={payload.get('fetched')} "
          f"rate-limited-skips={payload.get('rate_skipped')}  "
          f"push channels={len(push.get('channels') or {})})")
    for b in rows:
        print(f"  {b.get('replica'):>10}  "
              f"reason={b.get('reason') or '-'}  "
              f"path={b.get('path') or '-'}  "
              f"fetched_at={b.get('fetched_at')}")
    return 0


def cmd_timeline(args) -> int:
    """Render one retained OLAP run to Chrome-trace (catapult) JSON —
    load the output in chrome://tracing or ui.perfetto.dev to see
    exchange/compute/checkpoint overlap per superstep per shard. Local
    run records by default, a server's GET /profile/timeline with
    --url."""
    if args.url:
        import urllib.error
        import urllib.request

        base = args.url.rstrip("/")
        if not base.startswith("http"):
            base = "http://" + base
        try:
            with urllib.request.urlopen(
                base + f"/profile/timeline?run={args.run}", timeout=10
            ) as resp:
                doc = json.loads(resp.read().decode("utf-8"))
        except urllib.error.HTTPError as e:
            print(f"server: {e}", file=sys.stderr)
            return 1
    else:
        from janusgraph_tpu_torch.observability import registry, render_run

        doc = render_run(registry, run=args.run)
        if doc is None:
            print(f"no retained OLAP run at index {args.run}",
                  file=sys.stderr)
            return 1
    text = json.dumps(doc, indent=None if args.out else 2)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text)
        print(f"wrote {args.out}", file=sys.stderr)
    else:
        print(text)
    return 0


def cmd_benchdiff(args) -> int:
    """Compare two bench artifacts cell-by-cell (stage, scale, platform,
    host-fallback): per-metric deltas with improve/regress/noise
    verdicts. With --fail-on-regress, exit non-zero when any cell
    regressed — the CI gate (bin/torch_benchdiff.sh wraps this)."""
    from janusgraph_tpu_torch.observability.benchdiff import diff_artifacts

    for p in (args.old, args.new):
        if not os.path.isfile(p):
            print(f"no such artifact: {p}", file=sys.stderr)
            return 2
    report = diff_artifacts(
        args.old, args.new, threshold=args.threshold / 100.0
    )
    print(json.dumps(report, indent=None if args.compact else 2))
    if report["cells_compared"] == 0:
        print("benchdiff: no comparable cells (stage/scale/platform "
              "mismatch?)", file=sys.stderr)
        return 3
    if args.fail_on_regress and report["regressed"]:
        regressed = [
            c["cell"] for c in report["comparisons"]
            if c["verdict"] == "regress"
        ]
        print(f"benchdiff: REGRESSION in cells {regressed}",
              file=sys.stderr)
        return 1
    return 0


def cmd_chaos(args) -> int:
    """Seeded chaos soak on an in-memory graph: an OLTP workload through
    injected faults including a torn batch, then a reopen that runs
    torn-commit recovery; prints a JSON report."""
    import tempfile
    import time as _t

    from janusgraph_tpu_torch.core.graph import JanusGraphTPU
    from janusgraph_tpu_torch.exceptions import InjectedCrashError, TemporaryBackendError
    from janusgraph_tpu_torch.observability import registry
    from janusgraph_tpu_torch.storage.inmemory import InMemoryStoreManager

    base = {
        "ids.authority-wait-ms": 0.0,
        "locks.wait-ms": 0.0,
        "tx.log-tx": True,
        "tx.max-commit-time-ms": 0.0,
        "storage.scan-parallelism": 1,
        "storage.backoff-base-ms": 1.0,
        "storage.backoff-max-ms": 4.0,
        "computer.executor": "cpu",
        "computer.checkpoint-every": 2,
        "computer.checkpoint-path": tempfile.mktemp(suffix=".npz"),
    }
    torn_at = max(8, args.txs // 2)
    chaos = {
        **base,
        "storage.faults.enabled": True,
        "storage.faults.seed": args.seed,
        "storage.faults.read-error-rate": args.error_rate,
        "storage.faults.write-error-rate": args.error_rate,
        "storage.faults.torn-mutation-at": torn_at,
        "storage.faults.lock-expiry-at": max(2, args.txs // 3),
        "storage.faults.preempt-superstep": 3,
    }
    mgr = InMemoryStoreManager()
    t0 = _t.monotonic()
    graph = JanusGraphTPU(chaos, store_manager=mgr)
    plan = graph.fault_plan
    mgmt = graph.management()
    mgmt.make_property_key("uid", int)
    mgmt.build_composite_index("byUid", ["uid"], unique=True)

    def write(i):
        retries = 12
        for attempt in range(retries):
            tx = graph.new_transaction()
            try:
                tx.add_vertex(uid=i)
                tx.commit()
                return
            except TemporaryBackendError:
                if tx.is_open:
                    tx.rollback()
                if attempt == retries - 1:
                    raise

    crashed_at = None
    for i in range(args.txs):
        try:
            write(i)
        except InjectedCrashError:
            crashed_at = i
            break
    # the crash: the graph is abandoned unclosed, reopened, and heals
    t_rec = _t.monotonic()
    graph2 = JanusGraphTPU(base, store_manager=mgr)
    recovery_ms = (_t.monotonic() - t_rec) * 1000.0
    if crashed_at is not None:
        for i in range(crashed_at + 1, args.txs):
            write_tx = graph2.new_transaction()
            write_tx.add_vertex(uid=i)
            write_tx.commit()
    tx = graph2.new_transaction(read_only=True)
    present = sum(1 for i in range(args.txs) if graph2.index_lookup(tx, "byUid", (i,)))
    tx.rollback()
    snap = registry.snapshot()
    injected: dict = {}
    for e in plan.journal:
        injected[e["kind"]] = injected.get(e["kind"], 0) + 1
    report = {
        "seed": args.seed,
        "txs": args.txs,
        "crashed_at": crashed_at,
        "vertices_present": present,
        "torn_recovery": graph2.last_torn_recovery,
        "injected": injected,
        "ops_observed": plan.counters(),
        "journal": plan.journal[:64],
        "retries": snap.get("storage.backend_op.retries", {}).get("count", 0),
        "recovery_open_ms": round(recovery_ms, 2),
        "wall_s": round(_t.monotonic() - t0, 3),
    }
    print(json.dumps(report, indent=None if args.compact else 2))
    graph2.close()
    return 0 if present == args.txs else 1


def cmd_config_docs(args) -> int:
    from janusgraph_tpu_torch.core.config import describe_options

    text = (
        "# Configuration reference\n\n"
        "Generated from the registered option tree "
        "(`janusgraph_tpu_torch/core/config.py`; reference model: the reference's "
        "auto-generated janusgraph-cfg.md).\n\n" + describe_options() + "\n"
    )
    if args.out:
        with open(args.out, "w") as f:
            f.write(text)
        print(f"wrote {args.out}")
    else:
        # identical bytes on both paths: `print` would append a second
        # newline and make regenerated docs churn a trailing blank line
        sys.stdout.write(text)
    return 0


def cmd_export(args) -> int:
    from janusgraph_tpu_torch.core.graph import open_graph
    from janusgraph_tpu_torch.core.io import export_graphml, export_graphson

    fn = export_graphml if args.format == "graphml" else export_graphson
    graph = open_graph(_load_config(args.config))
    try:
        counts = fn(graph, args.out)
        print(f"exported {counts['vertices']} vertices, "
              f"{counts['edges']} edges -> {args.out}")
    finally:
        graph.close()
    return 0


def cmd_import(args) -> int:
    from janusgraph_tpu_torch.core.graph import open_graph
    from janusgraph_tpu_torch.core.io import import_graphml, import_graphson

    if args.batch < 1:
        print("--batch must be >= 1", file=sys.stderr)
        return 2
    fn = import_graphml if args.format == "graphml" else import_graphson
    graph = open_graph(_load_config(args.config))
    try:
        counts = fn(graph, args.infile, batch_size=args.batch)
        print(f"imported {counts['vertices']} vertices, "
              f"{counts['edges']} edges from {args.infile}")
    finally:
        graph.close()
    return 0


def _not_ported(name: str):
    def refuse(_args) -> int:
        print(f"'{name}' is not ported yet: {_ROADMAP_TOOLS}", file=sys.stderr)
        return 2

    return refuse


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="janusgraph_tpu_torch")
    sub = parser.add_subparsers(dest="command", required=True)

    ps = sub.add_parser("server", help="start the query server")
    ps.add_argument("--config", help="graph config JSON file")
    ps.add_argument("--graph-name", default="graph")
    ps.add_argument("--host", default="127.0.0.1")
    ps.add_argument("--port", type=int, default=8182)
    ps.add_argument("--auth-credentials", help="credentials-graph config JSON")
    ps.add_argument("--load-gods", action="store_true",
                    help="preload the Graph of the Gods example")
    ps.add_argument("--replica-name", default="",
                    help="fleet identity tag (overrides "
                         "server.fleet.replica-name)")
    ps.set_defaults(fn=cmd_server)

    pfleet = sub.add_parser(
        "fleet",
        help="run N server replicas over one shared backend behind the "
             "fleet router (probes, gossip, drain, warm-up)",
    )
    pfleet.add_argument("--config", help="graph config JSON file")
    pfleet.add_argument("--graph-name", default="graph")
    pfleet.add_argument("--host", default="127.0.0.1")
    pfleet.add_argument("--port", type=int, default=8182,
                        help="frontend port (replicas pick free ports)")
    pfleet.add_argument("--replicas", type=int, default=0,
                        help="replica count (0 = server.fleet.replicas)")
    pfleet.set_defaults(fn=cmd_fleet)

    pc = sub.add_parser("console", help="interactive console")
    pc.add_argument("--config", help="graph config JSON file")
    pc.add_argument("--remote", help="host:port of a running server")
    pc.add_argument("--load-gods", action="store_true")
    pc.set_defaults(fn=cmd_console)

    pss = sub.add_parser(
        "storage-server", help="serve a storage backend over TCP"
    )
    pss.add_argument("--host", default="127.0.0.1")
    pss.add_argument("--port", type=int, default=0)
    backing = pss.add_mutually_exclusive_group()
    backing.add_argument("--directory", help="persistent local store directory")
    backing.add_argument(
        "--sharded-nodes", type=int,
        help="serve an N-node sharded composite (N >= 1)",
    )
    pss.set_defaults(fn=cmd_storage_server)

    pt = sub.add_parser(
        "telemetry",
        help="dump telemetry (Prometheus text, or JSON with --json)",
    )
    pt.add_argument(
        "--url", help="scrape a running server (host:port or http URL) "
        "instead of this process's registry",
    )
    pt.add_argument("--json", action="store_true",
                    help="JSON snapshot (metrics + spans + slow ops)")
    pt.set_defaults(fn=cmd_telemetry)

    ptr = sub.add_parser(
        "trace",
        help="print the span trees of one trace id (stitched view)",
    )
    ptr.add_argument("trace_id", help="16-hex-char trace id")
    ptr.add_argument(
        "--url", help="read a running server's /telemetry instead of "
        "this process's tracer",
    )
    ptr.set_defaults(fn=cmd_trace)

    pf = sub.add_parser(
        "flight",
        help="dump the black-box flight recorder (salient-event ring)",
    )
    pf.add_argument(
        "--url", help="read a running server's /flight instead of this "
        "process's recorder",
    )
    pf.add_argument("--dump", action="store_true",
                    help="also write a JSON dump file")
    pf.set_defaults(fn=cmd_flight)

    ptp = sub.add_parser(
        "top",
        help="print the query-digest table (top shapes by total cost)",
    )
    ptp.add_argument(
        "--url", help="read a running server's /profile instead of this "
        "process's table",
    )
    ptp.add_argument("-k", type=int, default=10, help="rows to print")
    ptp.add_argument("--json", action="store_true")
    ptp.set_defaults(fn=cmd_top)

    pfl = sub.add_parser(
        "flame",
        help="render one trace to collapsed-stack flamegraph lines",
    )
    pfl.add_argument("trace_id", nargs="?", default="",
                     help="16-hex-char trace id (omit with --live)")
    pfl.add_argument(
        "--url", help="read a running server's /profile/flame (or "
        "/debug/profile with --live) instead of this process",
    )
    pfl.add_argument(
        "--live", action="store_true",
        help="render the continuous sampling profiler's flame windows "
        "instead of one trace",
    )
    pfl.add_argument("--window", type=int, default=0,
                     help="with --live: last N flame windows (0 = all)")
    pfl.set_defaults(fn=cmd_flame)

    pbu = sub.add_parser(
        "bundle",
        help="fetch the newest anomaly forensics bundle",
    )
    pbu.add_argument(
        "--url", help="read a running server's /debug/bundle instead of "
        "this process's bundle directory",
    )
    pbu.add_argument("--capture", action="store_true",
                     help="force a fresh capture first")
    pbu.set_defaults(fn=cmd_bundle)

    pts = sub.add_parser(
        "timeseries",
        help="query the metrics history (per-window deltas/percentiles)",
    )
    pts.add_argument(
        "--url", help="read a running server's /timeseries instead of "
        "this process's history ring",
    )
    pts.add_argument("--name", default="",
                     help="metric-name prefix filter")
    pts.add_argument("--window", type=int, default=0,
                     help="last N windows only (0 = all retained)")
    pts.add_argument("--export",
                     help="also write retained windows to this JSONL file")
    pts.set_defaults(fn=cmd_timeseries)

    ptl = sub.add_parser(
        "timeline",
        help="render one OLAP run to Chrome-trace (catapult) JSON",
    )
    ptl.add_argument(
        "--url", help="read a running server's /profile/timeline instead "
        "of this process's run records",
    )
    ptl.add_argument("--run", type=int, default=-1,
                     help="run record index (negative = from the end)")
    ptl.add_argument("--out", help="write the trace JSON to this file")
    ptl.set_defaults(fn=cmd_timeline)

    pin = sub.add_parser(
        "incident",
        help="merged cross-replica failover forensics from a fleet "
             "frontend (/fleet/incident)",
    )
    pin.add_argument(
        "--url", required=True,
        help="fleet frontend base URL (host:port)",
    )
    pin.add_argument(
        "--window", type=float, default=60.0,
        help="lookback seconds (0 = whole flight rings)",
    )
    pin.add_argument(
        "--trace-out", help="write the Chrome-trace JSON to this file",
    )
    pin.add_argument("--json", action="store_true",
                     help="print the full report payload")
    pin.add_argument(
        "--tail", type=int, default=0,
        help="print only the last N merged events (0 = all)",
    )
    pin.set_defaults(fn=cmd_incident)

    pw = sub.add_parser(
        "watch",
        help="live-tail a server's telemetry bus (/watch WebSocket)",
    )
    pw.add_argument(
        "--url", required=True, help="server base URL (host:port)",
    )
    pw.add_argument(
        "--streams",
        help="comma-separated streams (flight,window,slo,flame,bundle; "
             "default all)",
    )
    pw.add_argument(
        "--names",
        help="comma-separated name/category prefixes to filter on",
    )
    pw.add_argument(
        "--cursor", action="append", default=[],
        metavar="STREAM=SEQ",
        help="resume a stream past an already-seen seq (repeatable)",
    )
    pw.add_argument(
        "--heartbeat", type=float, default=0.0,
        help="requested heartbeat cadence in seconds (0 = server default)",
    )
    pw.add_argument("--count", type=int, default=0,
                    help="exit after N events (0 = run until interrupted)")
    pw.add_argument("--json", action="store_true",
                    help="print raw protocol frames as JSON lines")
    pw.add_argument("--heartbeats", action="store_true",
                    help="also print heartbeat frames (compact mode)")
    pw.set_defaults(fn=cmd_watch)

    pfb = sub.add_parser(
        "fleet-bundles",
        help="forensics bundles shipped off-host to a fleet frontend "
             "(/fleet/bundles)",
    )
    pfb.add_argument(
        "--url", required=True,
        help="fleet frontend base URL (host:port)",
    )
    pfb.add_argument("--replica",
                     help="fetch one replica's full bundle body")
    pfb.add_argument(
        "--index", type=int, default=-1,
        help="which of the replica's retained bundles (-1 = newest)",
    )
    pfb.add_argument("--json", action="store_true",
                     help="print the raw listing payload")
    pfb.set_defaults(fn=cmd_fleet_bundles)

    pbd = sub.add_parser(
        "benchdiff",
        help="compare two bench artifacts (improve/regress/noise verdicts)",
    )
    pbd.add_argument("old", help="prior artifact (JSON or JSONL)")
    pbd.add_argument("new", help="new artifact (JSON or JSONL)")
    pbd.add_argument(
        "--threshold", type=float, default=10.0,
        help="relative noise threshold in percent (default 10)",
    )
    pbd.add_argument(
        "--fail-on-regress", action="store_true",
        help="exit 1 when any cell regressed (the CI gate)",
    )
    pbd.add_argument("--compact", action="store_true",
                     help="one-line JSON report")
    pbd.set_defaults(fn=cmd_benchdiff)

    pch = sub.add_parser(
        "chaos",
        help="seeded chaos soak: inject faults, crash, self-heal, report",
    )
    pch.add_argument("--seed", type=int, default=42)
    pch.add_argument("--txs", type=int, default=120)
    pch.add_argument("--error-rate", type=float, default=0.01,
                     help="per-op probability of injected temporary faults")
    pch.add_argument("--compact", action="store_true",
                     help="one-line JSON report")
    pch.set_defaults(fn=cmd_chaos)

    pd = sub.add_parser("config-docs", help="render the config reference")
    pd.add_argument("--out", help="write to this file instead of stdout")
    pd.set_defaults(fn=cmd_config_docs)

    pe = sub.add_parser(
        "export", help="export a graph (GraphSON or GraphML)"
    )
    # required: a no-config export would truncate the output with a fresh
    # (empty) in-memory graph's contents
    pe.add_argument("--config", required=True, help="graph config JSON file")
    pe.add_argument(
        "--format", choices=("graphson", "graphml"), default="graphson",
        help="interchange format (graphml: primitive values only)",
    )
    pe.add_argument("out", help="output path")
    pe.set_defaults(fn=cmd_export)

    pi = sub.add_parser(
        "import", help="import GraphSON or GraphML into a graph"
    )
    # required: importing into an unnamed in-memory graph that closes right
    # after would silently discard everything
    pi.add_argument("--config", required=True, help="graph config JSON file")
    pi.add_argument(
        "--batch", type=int, default=1000,
        help="elements per import transaction (>= 1)",
    )
    pi.add_argument(
        "--format", choices=("graphson", "graphml"), default="graphson",
        help="interchange format",
    )
    pi.add_argument("infile", help="input path")
    pi.set_defaults(fn=cmd_import)

    for name in _NOT_PORTED:
        sub.add_parser(name, help=f"not ported yet: {_ROADMAP_TOOLS}").set_defaults(
            fn=_not_ported(name)
        )

    # a refused subcommand takes whatever arguments the reference's takes
    args, extra = parser.parse_known_args(argv)
    if extra and args.command not in _NOT_PORTED:
        parser.error(f"unrecognized arguments: {' '.join(extra)}")
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
