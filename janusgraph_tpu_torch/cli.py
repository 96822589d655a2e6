"""Command-line entry points — the port's copy of the ``server``,
``console``, ``storage-server`` and ``chaos`` subcommands of
``janusgraph_tpu/cli.py``:

  python -m janusgraph_tpu_torch server [--config graph.json] [--port 8182]
                                        [--graph-name NAME] [--load-gods]
                                        [--auth-credentials creds.json]
  python -m janusgraph_tpu_torch console [--config graph.json |
                                          --remote host:port] [--load-gods]
  python -m janusgraph_tpu_torch storage-server [--host H] [--port P]
                                                [--directory DIR |
                                                 --sharded-nodes N]
  python -m janusgraph_tpu_torch chaos [--seed S] [--txs N]
                                       [--error-rate R] [--compact]

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

Every other subcommand of the reference (the fleet, the telemetry and
bench tools, import and export) waits for ROADMAP Queue A #5.6b: the
parser knows their names and says so.
"""

from __future__ import annotations

import argparse
import code
import json
import sys
from typing import Optional

_ROADMAP_TOOLS = "ROADMAP.md Queue A #5.6b (the fleet, federation and the tools)"

#: the reference's other subcommands, each refused naming the item
_NOT_PORTED = (
    "fleet", "bench", "telemetry", "trace", "flight", "top", "flame",
    "bundle", "timeseries", "timeline", "incident", "watch",
    "fleet-bundles", "benchdiff", "config-docs", "export", "import",
)


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

    graph = open_graph(_load_config(args.config))
    if args.replica_name:
        # tag this process's flight events, logs and metrics
        # (observability/identity.py)
        set_replica(args.replica_name)
    if args.load_gods:
        from janusgraph_tpu_torch.core import gods

        gods.load(graph)
    manager = JanusGraphManager.get_instance()
    manager.put_graph(args.graph_name, graph)

    authenticator = None
    if args.auth_credentials:
        from janusgraph_tpu_torch.server import CredentialsAuthenticator, HMACAuthenticator

        creds_cfg = _load_config(args.auth_credentials)
        # server.auth.credentials-db names the credentials graph
        creds_cfg.setdefault("graph.graphname", graph.config.get("server.auth.credentials-db"))
        creds_graph = open_graph(creds_cfg)
        secret = graph.config.get("server.auth.secret")
        authenticator = HMACAuthenticator(
            CredentialsAuthenticator(creds_graph),
            secret=secret.encode() if secret else None,
            token_ttl_seconds=graph.config.get("server.auth.token-ttl-ms") / 1000.0,
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
        replica_name=args.replica_name,
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
    ps.add_argument("--replica-name", default="", help="telemetry identity tag")
    ps.set_defaults(fn=cmd_server)

    pc = sub.add_parser("console", help="interactive console")
    pc.add_argument("--config", help="graph config JSON file")
    pc.add_argument("--remote", help="host:port of a running server")
    pc.add_argument("--load-gods", action="store_true")
    pc.set_defaults(fn=cmd_console)

    pss = sub.add_parser("storage-server", help="serve a storage backend over TCP")
    pss.add_argument("--host", default="127.0.0.1")
    pss.add_argument("--port", type=int, default=0)
    backing = pss.add_mutually_exclusive_group()
    backing.add_argument("--directory", help="persistent local store directory")
    backing.add_argument(
        "--sharded-nodes", type=int, help="serve an N-node sharded composite (N >= 1)",
    )
    pss.set_defaults(fn=cmd_storage_server)

    pch = sub.add_parser(
        "chaos", help="seeded chaos soak: inject faults, crash, self-heal, report"
    )
    pch.add_argument("--seed", type=int, default=42)
    pch.add_argument("--txs", type=int, default=120)
    pch.add_argument(
        "--error-rate", type=float, default=0.01,
        help="per-op probability of injected temporary faults",
    )
    pch.add_argument("--compact", action="store_true", help="one-line JSON report")
    pch.set_defaults(fn=cmd_chaos)

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
