"""Command-line entry points — the port's copy of the ``storage-server``
and ``chaos`` subcommands of ``janusgraph_tpu/cli.py``:

  python -m janusgraph_tpu_torch storage-server [--host H] [--port P]
                                                [--directory DIR |
                                                 --sharded-nodes N]
  python -m janusgraph_tpu_torch chaos [--seed S] [--txs N]
                                       [--error-rate R] [--compact]

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

Every other subcommand of the reference (the query server, the console,
the telemetry and bench tools, import and export) waits for ROADMAP Queue
A #5.6: the parser knows their names and says so.
"""

from __future__ import annotations

import argparse
import json
import sys

_ROADMAP_SERVER = "ROADMAP.md Queue A #5.6 (the server, the driver and the tools)"

#: the reference's other subcommands, each refused naming the item
_NOT_PORTED = (
    "server", "fleet", "console", "bench", "telemetry", "trace", "flight",
    "top", "flame", "bundle", "timeseries", "timeline", "incident", "watch",
    "fleet-bundles", "benchdiff", "config-docs", "export", "import",
)


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
        print(f"'{name}' is not ported yet: {_ROADMAP_SERVER}", file=sys.stderr)
        return 2

    return refuse


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="janusgraph_tpu_torch")
    sub = parser.add_subparsers(dest="command", required=True)

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
        sub.add_parser(name, help=f"not ported yet: {_ROADMAP_SERVER}").set_defaults(
            fn=_not_ported(name)
        )

    # a refused subcommand takes whatever arguments the reference's takes
    args, extra = parser.parse_known_args(argv)
    if extra and args.command not in _NOT_PORTED:
        parser.error(f"unrecognized arguments: {' '.join(extra)}")
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
