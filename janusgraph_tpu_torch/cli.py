"""Command-line entry points — the port's copy of the ``storage-server``
subcommand of ``janusgraph_tpu/cli.py``:

  python -m janusgraph_tpu_torch storage-server [--host H] [--port P]
                                                [--directory DIR]

serves a storage backend over TCP (``storage/remote.py``): the persistent
local store in ``--directory``, or by default an in-memory store. Its first
line, ``storage server (KIND) listening on HOST:PORT``, is the contract
scripts read the address from (``--port 0`` binds a free port). Graph
instances open it with ``storage.backend`` "remote", ``storage.hostname``
and ``storage.port``; a client of either package talks to it. The server
never touches the card and never imports torch.

``--sharded-nodes`` (the sharded composite store) waits for ROADMAP Queue A
#5.5b. Every other subcommand of the reference (the query server, the
console, the telemetry and bench tools, import and export) waits for #5.6:
the parser knows their names and says so.
"""

from __future__ import annotations

import argparse
import sys

_ROADMAP_SHARDED = "ROADMAP.md Queue A #5.5b (faults, the sharded store and the remote index)"
_ROADMAP_SERVER = "ROADMAP.md Queue A #5.6 (the server, the driver and the tools)"

#: the reference's other subcommands, each refused naming the item
_NOT_PORTED = (
    "server", "fleet", "console", "bench", "telemetry", "trace", "flight",
    "top", "flame", "bundle", "timeseries", "timeline", "incident", "watch",
    "fleet-bundles", "benchdiff", "chaos", "config-docs", "export", "import",
)


def cmd_storage_server(args) -> int:
    """Serve a storage backend over TCP (the remote KCVS endpoint other
    instances open with storage.backend=remote) until interrupted."""
    from janusgraph_tpu_torch.storage.remote import RemoteStoreServer

    if args.sharded_nodes is not None:
        print(f"--sharded-nodes is not ported yet: {_ROADMAP_SHARDED}", file=sys.stderr)
        return 2
    if args.directory:
        from janusgraph_tpu_torch.storage.localstore import open_local_kcvs

        manager = open_local_kcvs(args.directory)
        kind = f"local({args.directory})"
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
        "--sharded-nodes", type=int,
        help=f"serve an N-node sharded composite (not ported yet: {_ROADMAP_SHARDED})",
    )
    pss.set_defaults(fn=cmd_storage_server)

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
