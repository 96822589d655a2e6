"""Host-side read costs of the PyTorch port on the stored graph, on the card.

Builds the stored graph of ``chip_smoke.py``'s ``stored`` phase (the first
2,000,000 out-edges of the scale-20 R-MAT graph, label "link", bulk-loaded
into an in-memory store) and times, on this tree's ``janusgraph_tpu_torch``:

  - the warm ``graph.compute().program(PageRank(20, tol=0)).submit()``,
    ``--repeat`` times after a cold and a first warm submit (median, min,
    max of the walls);
  - the ``page_rank()`` top-10 traversal of the ``oltp`` phase, once: its
    wall, the OLAP run's wall and the host walk (the difference);
  - where the tree has them, one call of ``Backend.guard`` around an empty
    operation, and one slice-cache read that misses and one that hits
    (``storage/cache.py`` over a store that answers at once), each
    averaged over many calls.

``--db-cache on|off`` sets ``cache.db-cache`` on both graphs; without it
the tree's default holds (a tree without the option has no cache). Run
from the root of the tree to measure, on a machine with a CUDA card:

    python3 bin/torch_host_reads.py --db-cache off

It prints the card's name and power limit, then one JSON object.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np


def per_call_us(fn, calls: int) -> float:
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    return (time.perf_counter() - t0) / calls * 1e6


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scale", type=int, default=20)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--repeat", type=int, default=30)
    ap.add_argument("--db-cache", choices=("on", "off"), default=None)
    ap.add_argument("--label", default="")
    args = ap.parse_args()

    sys.path.insert(0, os.getcwd())
    import torch

    if not torch.cuda.is_available():
        print("torch_host_reads: no CUDA device", file=sys.stderr)
        return 2
    from janusgraph_tpu_torch.core.bulk import bulk_add_edges, bulk_add_vertices
    from janusgraph_tpu_torch.core.graph import open_graph
    from janusgraph_tpu_torch.observability import registry
    from janusgraph_tpu_torch.olap import rmat_csr
    from janusgraph_tpu_torch.olap.programs import PageRankProgram

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    extra = {} if args.db_cache is None else {"cache.db-cache": args.db_cache == "on"}
    out = {"label": args.label, "db_cache": args.db_cache, "device": smi}

    csr = rmat_csr(args.scale, 16, seed=args.seed)
    n = csr.num_vertices
    cap = min(2_000_000, csr.num_edges)
    src = np.repeat(np.arange(n), np.diff(csr.out_indptr))[:cap]
    dst = np.asarray(csr.out_dst[:cap], dtype=np.int64)
    g = open_graph({"storage.backend": "inmemory", **extra})
    t0 = time.perf_counter()
    vids = bulk_add_vertices(g, n)
    bulk_add_edges(g, "link", vids[src], vids[dst])
    out["bulk_s"] = time.perf_counter() - t0

    def submit():
        t0 = time.perf_counter()
        res = g.compute().program(PageRankProgram(max_iterations=20, tol=0.0)).submit()
        torch.cuda.synchronize()
        return res, time.perf_counter() - t0

    _, out["cold_submit_s"] = submit()
    first, _ = submit()
    walls = [submit()[1] for _ in range(args.repeat)]
    out["warm_submit_s"] = {"median": float(np.median(walls)), "min": min(walls),
                            "max": max(walls), "n": len(walls)}
    rank = first.states["rank"]
    if not np.isfinite(rank).all() or abs(float(rank.astype(np.float64).sum()) - 1.0) > 1e-3:
        raise RuntimeError("the warm submit's ranks are not a distribution")

    g2 = open_graph({"computer.spillover": True, "query.max-traversers": 1 << 22, **extra},
                    store_manager=g.backend.manager)
    t0 = time.perf_counter()
    top = g2.traversal().V().page_rank().order().by("pagerank", reverse=True).limit(10).id_()
    top = top.to_list()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    run_wall = registry.last_run("olap")["wall_s"]
    if len(top) != 10:
        raise RuntimeError(f"page_rank() top 10 returned {top}")
    out["top10"] = {"wall_s": wall, "run_wall_s": run_wall, "host_walk_s": wall - run_wall,
                    "vertices": n}

    backend = g2.backend
    if hasattr(backend, "guard"):
        noop = lambda: None  # noqa: E731
        out["guard_us"] = per_call_us(lambda: backend.guard(noop), 1_000_000)
        out["bare_call_us"] = per_call_us(noop, 1_000_000)
    try:
        from janusgraph_tpu_torch.storage.cache import ExpirationCacheStore
        from janusgraph_tpu_torch.storage.kcvs import KeySliceQuery, SliceQuery
    except ImportError:
        pass
    else:
        class Answer:
            name = "answer"

            def get_slice(self, query, txh):
                return [(b"c", b"v")]

        cache = ExpirationCacheStore(Answer(), max_entries=65536)
        sq = SliceQuery(b"\x00", b"\xff")
        queries = iter([KeySliceQuery(i.to_bytes(8, "big"), sq) for i in range(400_000)])
        # 400,000 rows through 65,536 entries: every read misses and,
        # past the first 65,536, evicts
        out["cache_miss_us"] = per_call_us(lambda: cache.get_slice(next(queries), None), 400_000)
        hit = KeySliceQuery((399_999).to_bytes(8, "big"), sq)
        out["cache_hit_us"] = per_call_us(lambda: cache.get_slice(hit, None), 400_000)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
