"""The port stands alone: it imports neither jax nor the JAX package.

Checks run the port with both blocked in a fresh interpreter (the remote
store's server in a second one); another scans every port module and
chip_smoke.py for such imports. The module name
``janusgraph_tpu_torch`` starts with ``janusgraph_tpu``, so the scan matches
the exact module name or its dotted prefix, never the bare prefix."""

import ast
import glob
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "janusgraph_tpu")

BLOCKED_RUN = r"""
import sys
sys.modules["jax"] = None
sys.modules["janusgraph_tpu"] = None
import numpy as np
import janusgraph_tpu_torch
from janusgraph_tpu_torch.olap import GPUExecutor, csr_from_edges, run_on
from janusgraph_tpu_torch.olap.programs import (
    PageRankProgram, ShortestPathProgram, TraversalCountProgram,
)
rng = np.random.default_rng(0)
src = rng.integers(0, 50, 300).astype(np.int32)
dst = rng.integers(0, 50, 300).astype(np.int32)
csr = csr_from_edges(50, src, dst)
out = run_on(csr, PageRankProgram(max_iterations=10), device="cpu")
ex = GPUExecutor(csr, device="cpu")
dist = ex.run(ShortestPathProgram(seed_index=0, max_iterations=4))["distance"]
assert ex.last_run_info["path"] == "frontier" and dist[0] == 0.0
paths = run_on(csr, TraversalCountProgram(hops=3), device="cpu")["count"].sum()
hyb = GPUExecutor(csr, strategy="hybrid", device="cpu", hub_cutoff=4, tail_chunk=4)
fused = hyb.run(PageRankProgram(max_iterations=10))["rank"]
assert hyb.last_run_info["path"] == "fused" and hyb.last_run_info["strategy_resolved"] == "hybrid"
assert np.array_equal(fused, GPUExecutor(csr, strategy="ell", device="cpu").run(
    PageRankProgram(max_iterations=10), fused=False)["rank"])
auto = GPUExecutor(csr, strategy="auto", device="cpu")
auto.run(PageRankProgram(max_iterations=3))
assert auto.last_run_info["autotune"]["device_kind"] == "cpu"
from janusgraph_tpu_torch.olap.delta import DeltaOverlay, OverlayView, materialize
from janusgraph_tpu_torch.olap.programs import ConnectedComponentsProgram, GCNForwardProgram
z = np.zeros(5, dtype=np.int64)
ov = DeltaOverlay.from_batches([{"add": (np.arange(5), np.arange(5) + 60, z),
                                 "del": (src[:3].astype(np.int64), dst[:3].astype(np.int64), z[:3]),
                                 "v_add": {60 + i: 0 for i in range(5)}, "v_del": []}])
view = OverlayView(csr, ov)
cc = GPUExecutor(csr, strategy="ell", device="cpu", delta=view).run(ConnectedComponentsProgram())
mat = run_on(materialize(csr, ov), ConnectedComponentsProgram(), device="cpu", frontier="off")
assert np.array_equal(cc["component"], mat["component"]) and len(mat["component"]) == 55
h = run_on(csr, GCNForwardProgram(feature_dim=8, hidden_dim=8, out_dim=8), strategy="ell",
           device="cpu")["h"]
assert h.shape == (50, 8) and np.isfinite(h).all()
from janusgraph_tpu_torch.olap import (
    ClusterCountMapReduce, FulgoraAnalogueComputer, ldbc_snb_csr, twitter_csr,
)
from janusgraph_tpu_torch.olap.programs import (
    DegreeCountProgram, OLAPTraversalProgram, TraversalStep, enumerate_paths,
)
tcsr = csr_from_edges(50, src, dst, edge_types=(src % 3).astype(np.int32))
tp = OLAPTraversalProgram([TraversalStep("out", (0,)), TraversalStep("both")], record_reach=True)
st = run_on(tcsr, tp, device="cpu")
assert int(st["count"].sum()) == len(list(enumerate_paths(tcsr, tp, st))) > 0
assert np.array_equal(run_on(csr, DegreeCountProgram(), device="cpu")["in_degree"], csr.in_degree)
assert ClusterCountMapReduce("component").execute(cc, csr)["count"] >= 1
assert ldbc_snb_csr(6).num_vertices == 64 and twitter_csr(64, 4).num_edges == 256
assert abs(FulgoraAnalogueComputer(csr, 2).pagerank(2)[0].sum() - 1.0) < 1e-6
loaded = sorted(m for m, mod in sys.modules.items() if mod is not None and (
    m == "jax" or m.startswith("jax.")
    or m == "janusgraph_tpu" or m.startswith("janusgraph_tpu.")))
print("OK", round(float(out["rank"].sum()), 4), paths > 0, loaded)
"""


STORED_RUN = r"""
import sys
sys.modules["jax"] = None
sys.modules["janusgraph_tpu"] = None
import numpy as np
from janusgraph_tpu_torch import _build, native
from janusgraph_tpu_torch.core.bulk import bulk_add_edges, bulk_add_vertices
from janusgraph_tpu_torch.core.graph import open_graph
from janusgraph_tpu_torch.olap.csr import load_csr, load_csr_snapshot
from janusgraph_tpu_torch.olap.generators import rmat_edges
from janusgraph_tpu_torch.olap.programs import PageRankProgram
from janusgraph_tpu_torch.storage.inmemory import InMemoryStoreManager
n, src, dst = rmat_edges(8, seed=2)
g = open_graph({"storage.backend": "inmemory"})
vids = bulk_add_vertices(g, n)
bulk_add_edges(g, "link", vids[src], vids[dst])
csr, epoch = load_csr_snapshot(g)
assert csr.num_vertices == n and csr.num_edges == len(src) and epoch > 0
res = g.compute(executor="cpu").program(PageRankProgram(max_iterations=10)).submit()
assert res.run_info["snapshot"]["path"] == "cold"
res.write_back(["rank"])
back = load_csr(g, property_keys=("rank",))
assert np.array_equal(back.properties["rank"], res.states["rank"].astype(np.float64))
again = open_graph(store_manager=InMemoryStoreManager.from_rows(g.backend.manager.dump_rows()))
assert np.array_equal(load_csr(again, property_keys=("rank",)).properties["rank"],
                      back.properties["rank"])
assert native.available() == ("error" not in _build.host_build_info)
from janusgraph_tpu_torch.core.codecs import Direction
tx = g.new_transaction()
a, b = tx.get_vertex(int(vids[0])), tx.get_vertex(int(vids[1]))
tx.add_edge(a, "link", b, since=3)
tx.add_edge(tx.add_vertex(name="new"), "link", a)
tx.remove_edge(tx.get_edges(tx.get_vertex(int(vids[src[0]])), Direction.OUT, ("link",))[0])
tx.commit()
warm = g.compute(executor="cpu").program(PageRankProgram(max_iterations=10)).submit()
assert warm.run_info["snapshot"] == {"path": "fused", "overlay": 4}, warm.run_info["snapshot"]
assert len(warm.states["rank"]) == n + 1 and abs(warm.states["rank"].sum() - 1.0) < 1e-5
loaded = sorted(m for m, mod in sys.modules.items() if mod is not None and (
    m == "jax" or m.startswith("jax.")
    or m == "janusgraph_tpu" or m.startswith("janusgraph_tpu.")))
print("OK", round(float(res.states["rank"].sum()), 4), loaded)
"""


TRAVERSAL_RUN = r"""
import sys
sys.modules["jax"] = None
sys.modules["janusgraph_tpu"] = None
from janusgraph_tpu_torch.core.graph import open_graph
from janusgraph_tpu_torch.core.predicates import Geoshape
from janusgraph_tpu_torch.core.traversal import P
from janusgraph_tpu_torch.observability import registry
g = open_graph({"computer.executor": "cpu", "computer.spillover-min-cost-ms": 0.0,
                "computer.spillover-min-seen": 1})
t = g.traversal()
vs = [t.add_v("person", name=f"p{i}", loc=Geoshape.point(i, i)) for i in range(8)]
for i, v in enumerate(vs):
    t.add_e(v, "knows", vs[(i + 1) % 8])
    t.add_e(v, "knows", vs[(i + 3) % 8])
t.commit()
assert g.traversal().V().out().count() == 16
assert g.traversal().V().has("loc", P.geo_within(Geoshape.box(-1, -1, 2.5, 2.5))).count() == 3
walk = g.traversal().V().out("knows").out("knows").count()  # teaches the shape
spilled = g.traversal().V().out("knows").out("knows").count()
assert walk == spilled == 32
assert registry.snapshot()["olap.spillover.spilled"]["count"] == 1
ranks = g.traversal().V().page_rank().values("pagerank").to_list()
assert abs(sum(ranks) - 1.0) < 1e-5
g.close()
loaded = sorted(m for m, mod in sys.modules.items() if mod is not None and (
    m == "jax" or m.startswith("jax.")
    or m == "janusgraph_tpu" or m.startswith("janusgraph_tpu.")))
print("OK", spilled, loaded)
"""


LOCAL_RUN = r"""
import sys
sys.modules["jax"] = None
sys.modules["janusgraph_tpu"] = None
import numpy as np
from janusgraph_tpu_torch.core.bulk import bulk_add_edges, bulk_add_vertices
from janusgraph_tpu_torch.core.graph import drop_graph, open_graph
from janusgraph_tpu_torch.olap.csr import load_csr
from janusgraph_tpu_torch.olap.programs import PageRankProgram
cfg = {"storage.backend": "local", "storage.directory": sys.argv[1],
       "computer.executor": "cpu", "storage.distributed-load-timeout-s": 120.0}
g = open_graph(cfg)
rng = np.random.default_rng(1)
vids = bulk_add_vertices(g, 40)
bulk_add_edges(g, "link", vids[rng.integers(0, 40, 160)], vids[rng.integers(0, 40, 160)])
one = load_csr(g)
g.close()
g = open_graph(dict(cfg, **{"storage.distributed-load-workers": 2}))
res = g.compute().program(PageRankProgram(max_iterations=5)).submit()
assert res.run_info["snapshot"] == {"path": "distributed", "workers": 2}
assert np.array_equal(res.csr.in_src, one.in_src) and res.csr.num_edges == 160
drop_graph(g)
loaded = sorted(m for m, mod in sys.modules.items() if mod is not None and (
    m == "jax" or m.startswith("jax.")
    or m == "janusgraph_tpu" or m.startswith("janusgraph_tpu.")))
print("OK", res.csr.num_vertices, loaded)
"""


LOGS_RUN = r"""
import sys, time
sys.modules["jax"] = None
sys.modules["janusgraph_tpu"] = None
import numpy as np
from janusgraph_tpu_torch.core.graph import open_graph
from janusgraph_tpu_torch.core.txlog import LogTxStatus, TornCommitRecovery, decode_tx_entry
from janusgraph_tpu_torch.olap import delta as D
from janusgraph_tpu_torch.olap.csr import load_csr, load_csr_snapshot
from janusgraph_tpu_torch.storage.inmemory import InMemoryStoreManager
mgr = InMemoryStoreManager()
cfg = {"computer.executor": "cpu", "storage.cdc.dir": sys.argv[1]}
g = open_graph(dict(cfg), store_manager=mgr)
g.management().set_config("tx.log-tx", True)
tx = g.new_transaction()
vs = [tx.add_vertex(name=f"v{i}") for i in range(20)]
for i in range(19):
    tx.add_edge(vs[i], "link", vs[i + 1])
tx.commit()
csr0, epoch0 = load_csr_snapshot(g)
seen = []
g.open_log_processor("feed").add_processor(seen.append).build()
time.sleep(0.05)
tx = g.new_transaction(log_identifier="feed")
for i in range(10):
    tx.add_edge(tx.get_vertex(vs[i].id), "link", tx.get_vertex(vs[19 - i].id))
tx.commit()
deadline = time.monotonic() + 5
while not seen and time.monotonic() < deadline:
    time.sleep(0.01)
assert len(seen) == 1 and len(seen[0].added) == 10
records, _ = g.cdc_log.replay_from(g.cdc_log.cursor_for_epoch(epoch0))
folded = D.materialize(csr0, D.DeltaOverlay.from_batches([b for _e, b in records]), idm=g.idm)
fresh = load_csr(g)
assert np.array_equal(folded.out_dst, fresh.out_dst) and fresh.num_edges == 29
flush = mgr.mutate_many
def torn(mutations, txh):
    mgr.mutate_many = flush
    rows = [(s, k, m) for s, r in mutations.items() for k, m in r.items()]
    keep = {}
    for s, k, m in rows[: len(rows) // 2]:
        keep.setdefault(s, {})[k] = m
    flush(keep, txh)
    raise RuntimeError("crash")
mgr.mutate_many = torn
tx = g.new_transaction()
for i in range(5):
    tx.add_edge(tx.get_vertex(vs[i].id), "link", tx.add_vertex(name=f"t{i}"))
try:
    tx.commit()
except RuntimeError:
    pass
g.log_manager.close()
h = open_graph({"computer.executor": "cpu", "tx.max-commit-time-ms": 0.0}, store_manager=mgr)
assert len(h.last_torn_recovery["replayed"]) == 1
assert TornCommitRecovery(h).run() == {"replayed": [], "rolled_back": []}
assert load_csr(h).num_edges == 34
statuses = [decode_tx_entry(m.content).status for m in h.log_manager.open_log("txlog").read_range(0)]
assert statuses.count(LogTxStatus.PRIMARY_SUCCESS) == 3
h.close()
loaded = sorted(m for m, mod in sys.modules.items() if mod is not None and (
    m == "jax" or m.startswith("jax.")
    or m == "janusgraph_tpu" or m.startswith("janusgraph_tpu.")))
print("OK", len(records), loaded)
"""


IO_RUN = r"""
import io, pickle, struct, sys
sys.modules["jax"] = None
sys.modules["janusgraph_tpu"] = None
import numpy as np
import janusgraph_tpu_torch
from janusgraph_tpu_torch.core.attributes import Instant, Serializer, SerializerError
from janusgraph_tpu_torch.core.codecs import Direction
from janusgraph_tpu_torch.core.graph import open_graph
g, h = open_graph({"computer.executor": "cpu"}), open_graph({"computer.executor": "cpu"})
tx = g.new_transaction()
a = tx.add_vertex("person", name="a", seen=Instant(5, 7), w=np.arange(3, dtype=np.float32))
tx.add_edge(a, "knows", tx.add_vertex("person", name="b"), since=3)
tx.commit()
path = sys.argv[1]
assert janusgraph_tpu_torch.export_graphson(g, path) == {"vertices": 2, "edges": 1}
assert janusgraph_tpu_torch.import_graphson(h, path) == {"vertices": 2, "edges": 1}
assert h.traversal().V().has("name", "a").values("seen").to_list() == [Instant(5, 7)]
g.close(); h.close()
ser = Serializer()
cell = struct.pack(">H", 43) + b"janusgraph_tpu.core.attributes:Instant"
assert ser.write_object(Instant) == cell and ser.read_object(cell)[0] is Instant
frame = ser.write_object({Instant(1, 2), Direction.OUT})
assert b"janusgraph_tpu.core.attributes" in frame and b"janusgraph_tpu_torch" not in frame
assert ser.read_object(frame)[0] == {Instant(1, 2), Direction.OUT}
mod, name = b"janusgraph_tpu.olap.csr", b"CSRGraph"
# a protocol-4 pickle of the reference's class (SHORT_BINUNICODE twice,
# STACK_GLOBAL, STOP), written by hand: pickling it would import it
global_pickle = (b"\x80\x04\x8c" + bytes([len(mod)]) + mod + b"\x8c" + bytes([len(name)])
                 + name + b"\x93.")
assert pickle.loads(b"\x80\x04\x8c\x08builtins\x8c\x03int\x93.") is int
refused = 0
for bad in (struct.pack(">H", 43) + mod + b":" + name, struct.pack(">H", 42) + global_pickle):
    try:
        ser.read_object(bad)
    except SerializerError:
        refused += 1
loaded = sorted(m for m, mod in sys.modules.items() if mod is not None and (
    m == "jax" or m.startswith("jax.")
    or m == "janusgraph_tpu" or m.startswith("janusgraph_tpu.")))
print("OK", refused, loaded)
"""


REMOTE_RUN = r"""
import re, subprocess, sys
BLOCK = 'import sys; sys.modules["jax"] = None; sys.modules["janusgraph_tpu"] = None; '
sys.modules["jax"] = None
sys.modules["janusgraph_tpu"] = None
server = subprocess.Popen(
    [sys.executable, "-c", BLOCK + "from janusgraph_tpu_torch.cli import main; "
     "sys.exit(main(['storage-server', '--port', '0']))"],
    stdout=subprocess.PIPE, text=True)
try:
    m = re.search(r"listening on ([\d.]+):(\d+)", server.stdout.readline())
    from janusgraph_tpu_torch.core.graph import open_graph
    from janusgraph_tpu_torch.olap.programs import PageRankProgram
    g = open_graph({"storage.backend": "remote", "storage.hostname": m.group(1),
                    "storage.port": int(m.group(2)), "computer.executor": "cpu"})
    tx = g.new_transaction()
    vs = [tx.add_vertex("node") for _ in range(6)]
    for i in range(6):
        tx.add_edge(vs[i], "link", vs[(i + 1) % 6])
    tx.commit()
    res = g.compute().program(PageRankProgram(max_iterations=5)).submit()
    assert res.run_info["snapshot"]["path"] == "cold" and res.states["rank"].shape == (6,)
    g.close()
    alive = server.poll() is None
finally:
    server.terminate()
    server.wait(timeout=10)
loaded = sorted(m for m, mod in sys.modules.items() if mod is not None and (
    m == "jax" or m.startswith("jax.")
    or m == "janusgraph_tpu" or m.startswith("janusgraph_tpu.")))
print("OK", round(float(res.states["rank"].sum()), 4), alive, loaded)
"""


FAULT_RUN = r"""
import re, subprocess, sys
BLOCK = 'import sys; sys.modules["jax"] = None; sys.modules["janusgraph_tpu"] = None; '
sys.modules["jax"] = None
sys.modules["janusgraph_tpu"] = None
index = subprocess.Popen(
    [sys.executable, "-c", BLOCK + "import time; from janusgraph_tpu_torch.indexing import "
     "InMemoryIndexProvider, RemoteIndexServer; s = RemoteIndexServer(InMemoryIndexProvider())"
     ".start(); print('index on %s:%d' % s.address, flush=True); time.sleep(600)"],
    stdout=subprocess.PIPE, text=True)
try:
    m = re.search(r"index on ([\d.]+):(\d+)", index.stdout.readline())
    from janusgraph_tpu_torch.core.graph import open_graph
    from janusgraph_tpu_torch.core.traversal import P
    from janusgraph_tpu_torch.olap.programs import PageRankProgram
    g = open_graph({"storage.backend": "sharded", "computer.executor": "cpu",
                    "storage.faults.enabled": True, "storage.faults.seed": 3,
                    "storage.faults.read-error-rate": 0.05,
                    "storage.faults.preempt-superstep": 2,
                    "computer.checkpoint-every": 2,
                    "computer.checkpoint-path": sys.argv[1],
                    "storage.backoff-base-ms": 1.0, "storage.backoff-max-ms": 2.0,
                    "index.search.backend": "remote", "index.search.hostname": m.group(1),
                    "index.search.port": int(m.group(2))})
    mgmt = g.management()
    mgmt.make_property_key("w", int)
    mgmt.build_mixed_index("byW", ["w"], backing="search")
    tx = g.new_transaction()
    vs = [tx.add_vertex("node", w=i) for i in range(6)]
    for i in range(6):
        tx.add_edge(vs[i], "link", vs[(i + 1) % 6])
        tx.add_edge(vs[i], "link", vs[(i * i) % 6])
    tx.commit()
    hits = len(g.traversal().V().has("w", P.gt(2)).to_list())
    res = g.compute().program(PageRankProgram(max_iterations=6)).submit()
    assert res.run_info["resumes"] == 1 and res.states["rank"].shape == (6,)
    kinds = sorted({e["kind"] for e in g.fault_plan.journal})
    g.close()
finally:
    index.terminate()
    index.wait(timeout=10)
loaded = sorted(m for m, mod in sys.modules.items() if mod is not None and (
    m == "jax" or m.startswith("jax.")
    or m == "janusgraph_tpu" or m.startswith("janusgraph_tpu.")))
print("OK", hits, "superstep" in kinds, loaded)
"""


SERVER_RUN = r"""
import sys
sys.modules["jax"] = None
sys.modules["janusgraph_tpu"] = None
import janusgraph_tpu_torch.server
from janusgraph_tpu_torch.core import gods
from janusgraph_tpu_torch.core.graph import open_graph
from janusgraph_tpu_torch.driver.client import JanusGraphClient
from janusgraph_tpu_torch.driver import binary_dumps, binary_loads
from janusgraph_tpu_torch.server import JanusGraphManager, JanusGraphServer
g = open_graph({"computer.executor": "cpu"})
gods.load(g)
m = JanusGraphManager()
m.put_graph("graph", g)
s = JanusGraphServer(manager=m).start()
try:
    c = JanusGraphClient(port=s.port, http_timeout_s=60)
    top = c.submit("g.V().pageRank().order().by('pagerank', reverse=True).limit(3).values('name')")
    ws = c.ws(session=True)
    ws.sock.settimeout(60)
    ws.submit("g.addV('person').property('name','x').iterate()")
    ws.submit("g.commit()")
    ws.close()
    n = c.submit("g.V().has('name','x').count()")
    assert binary_loads(binary_dumps({"k": [1, 2.5]})) == {"k": [1, 2.5]}
finally:
    s.stop()
    g.close()
loaded = sorted(m for m, mod in sys.modules.items() if mod is not None and (
    m == "jax" or m.startswith("jax.")
    or m == "janusgraph_tpu" or m.startswith("janusgraph_tpu.")))
print("OK", top[0], n, loaded)
"""


FLEET_RUN = r"""
import json, os, re, subprocess, sys
BLOCK = 'import sys; sys.modules["jax"] = None; sys.modules["janusgraph_tpu"] = None; '
sys.modules["jax"] = None
sys.modules["janusgraph_tpu"] = None
d = sys.argv[1]
cfg = os.path.join(d, "fleet.json")
with open(cfg, "w") as f:
    json.dump({"computer.executor": "cpu", "server.fleet.federation-interval-s": 0.5}, f)
fleet = subprocess.Popen(
    [sys.executable, "-c", BLOCK + "from janusgraph_tpu_torch.cli import main; "
     f"sys.exit(main(['fleet', '--port', '0', '--replicas', '2', '--config', {cfg!r}]))"],
    stdout=subprocess.PIPE, text=True)
try:
    lines = [fleet.stdout.readline() for _ in range(3)]
    m = re.search(r"fleet frontend listening on ([\d.]+):(\d+) \((\d+) replicas\)", lines[-1])
    from janusgraph_tpu_torch.driver.client import JanusGraphClient
    c = JanusGraphClient(port=int(m.group(2)), http_timeout_s=60)
    c.submit("g.addV('person').property('name','a').iterate()")
    ranks = c.submit("g.V().pageRank().values('pagerank')")
    alive = fleet.poll() is None
finally:
    fleet.terminate()
    fleet.wait(timeout=20)
# in process: export and warm-up, a follower over the CDC log, a federation tick
from janusgraph_tpu_torch.core.graph import open_graph
from janusgraph_tpu_torch.observability.federation import FleetFederation
from janusgraph_tpu_torch.olap.csr import load_csr, load_csr_snapshot
from janusgraph_tpu_torch.olap.programs import PageRankProgram
from janusgraph_tpu_torch.olap.sharded_checkpoint import save_csr_checkpoint
from janusgraph_tpu_torch.server import FleetRouter, export_snapshot, warm_replica
from janusgraph_tpu_torch.server.fleet import CDCFollower
from janusgraph_tpu_torch.storage.inmemory import InMemoryStoreManager
mgr = InMemoryStoreManager()
g = open_graph({"computer.executor": "cpu", "storage.cdc.dir": os.path.join(d, "cdc")},
               store_manager=mgr)
tx = g.new_transaction()
vs = [tx.add_vertex("node") for _ in range(8)]
for i in range(8):
    tx.add_edge(vs[i], "link", vs[(i + 3) % 8])
tx.commit()
export_snapshot(g, os.path.join(d, "pack"), num_shards=3)
h = open_graph({"computer.executor": "cpu"}, store_manager=mgr)
assert warm_replica(h, os.path.join(d, "pack"))
res = h.compute().program(PageRankProgram(max_iterations=5)).submit()
assert res.run_info["snapshot"]["path"] == "warm"
csr0, epoch0 = load_csr_snapshot(g)
save_csr_checkpoint(os.path.join(d, "ckpt"), csr0, epoch0, num_shards=2)
f = CDCFollower(g.cdc_log, os.path.join(d, "ckpt"), idm=g.idm, name="f")
assert f.bootstrap()
tx = g.new_transaction()
tx.add_edge(tx.get_vertex(vs[0].id), "link", tx.get_vertex(vs[5].id))
tx.commit()
applied = f.pull()["applied"]
assert (f.csr.out_dst == load_csr(g).out_dst).all()
f.unregister_watchdog()
fed = FleetFederation(FleetRouter(fetch=lambda u, t: {}), fetch=lambda u, t: {})
window = fed.tick()
h.close()
g.close()
loaded = sorted(m for m, mod in sys.modules.items() if mod is not None and (
    m == "jax" or m.startswith("jax.")
    or m == "janusgraph_tpu" or m.startswith("janusgraph_tpu.")))
print("OK", m and m.group(3), ranks, alive, applied, window["partial"], loaded)
"""


def _forbidden(name):
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


SHARDED_RUN = r"""
import sys, tempfile
sys.modules["jax"] = None
sys.modules["janusgraph_tpu"] = None
import numpy as np
import torch
from janusgraph_tpu_torch.core.bulk import bulk_add_edges, bulk_add_vertices
from janusgraph_tpu_torch.core.graph import open_graph
from janusgraph_tpu_torch.olap import GPUExecutor, csr_from_edges
from janusgraph_tpu_torch.olap.programs import (
    ConnectedComponentsProgram, PageRankProgram, ShortestPathProgram,
)
from janusgraph_tpu_torch.parallel import Mesh, ShardedExecutor, halo
from janusgraph_tpu_torch.parallel.multihost import init_multihost
from janusgraph_tpu_torch.storage.faults import FaultPlan
rng = np.random.default_rng(0)
src = rng.integers(0, 60, 300).astype(np.int32)
dst = rng.integers(0, 60, 300).astype(np.int32)
csr = csr_from_edges(60, src, dst)
mesh = Mesh([torch.device("cpu")] * 8)
single = GPUExecutor(csr, device="cpu").run(PageRankProgram(max_iterations=10))["rank"]
for exchange, agg in (("a2a", "ell"), ("blocked", "segment"), ("ring", "segment"), ("auto", "ell")):
    ex = ShardedExecutor(csr, mesh=mesh, exchange=exchange, agg=agg)
    rank = ex.run(PageRankProgram(max_iterations=10))["rank"]
    assert np.allclose(rank, single, rtol=1e-5, atol=1e-7), exchange
dist = ShardedExecutor(csr, mesh=mesh).run(ShortestPathProgram(seed_index=0))["distance"]
assert dist[0] == 0.0
plan = FaultPlan(seed=1, shard_preempt_superstep=3)
d = tempfile.mkdtemp()
resumed = ShardedExecutor(csr, mesh=mesh).run(
    PageRankProgram(max_iterations=8, tol=0.0), fused=False, checkpoint_every=2,
    shard_checkpoint_dir=d, fault_hook=plan.sharded_hook)["rank"]
clean = ShardedExecutor(csr, mesh=mesh).run(PageRankProgram(max_iterations=8, tol=0.0),
                                            fused=False)["rank"]
assert np.array_equal(resumed, clean)
assert init_multihost() == 0
g = open_graph({"computer.executor": "cpu"})
vids = bulk_add_vertices(g, 60)
bulk_add_edges(g, "e", vids[src], vids[dst])
res = g.compute(executor="sharded", mesh=mesh).program(ConnectedComponentsProgram()).submit()
assert res.run_info["routing"]["executor"] == "sharded"
g.close()
loaded = sorted(m for m, mod in sys.modules.items() if mod is not None and (
    m == "jax" or m.startswith("jax.")
    or m == "janusgraph_tpu" or m.startswith("janusgraph_tpu.")))
print("OK", round(float(clean.sum()), 4), loaded)
"""


def test_sharded_run_with_jax_blocked():
    """The sharded executor on a mesh of 8 CPU slots (four exchanges, the
    frontier, a shard preemption resumed bitwise, a graph.compute(executor=
    "sharded") submit), with both blocked."""
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run(
        [sys.executable, "-c", SHARDED_RUN], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "OK 1.0 []", proc.stdout


def test_forbidden_matches_exact_names_only():
    assert _forbidden("jax") and _forbidden("jax.numpy")
    assert _forbidden("janusgraph_tpu") and _forbidden("janusgraph_tpu.olap.csr")
    assert not _forbidden("janusgraph_tpu_torch") and not _forbidden("janusgraph_tpu_torch.olap")
    assert not _forbidden("jaxtyping")


def test_port_runs_with_jax_blocked():
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run(
        [sys.executable, "-c", BLOCKED_RUN], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "OK 1.0 True []", proc.stdout


def test_stored_path_runs_with_jax_blocked():
    """open_graph -> bulk load -> submit(executor="cpu") -> a transaction
    -> a warm, fused submit -> write_back -> reload, and a reopen from the
    store's rows, with both blocked."""
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run(
        [sys.executable, "-c", STORED_RUN], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "OK 1.0 []", proc.stdout


def test_traversal_and_spillover_run_with_jax_blocked():
    """graph.traversal(): a scan, a geo predicate, a walked and then a
    spilled 2-hop count, and the page_rank() step, with both blocked."""
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run(
        [sys.executable, "-c", TRAVERSAL_RUN], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "OK 32 []", proc.stdout


def test_loader_workers_run_with_stub_jax_first_on_the_path(tmp_path):
    """A local graph loaded through 2 loader processes whose PYTHONPATH
    starts with a ``jax`` and a ``janusgraph_tpu`` that raise on import:
    the workers, which run in their own temporary directory, import
    neither, so the load succeeds."""
    stub = tmp_path / "stub"
    for name in FORBIDDEN:
        (stub / name).mkdir(parents=True)
        (stub / name / "__init__.py").write_text(
            f"raise RuntimeError('{name} must not be imported by the port')\n"
        )
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(stub), ROOT] + (
        [env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    proc = subprocess.run(
        [sys.executable, "-c", LOCAL_RUN, str(tmp_path / "graph")], cwd=str(tmp_path),
        env=env, capture_output=True, text=True, timeout=180,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "OK 40 []", proc.stdout


def test_logs_run_with_jax_blocked(tmp_path):
    """A WAL-on commit with a user log and its processor, the CDC log's
    replay folded into the snapshot, a torn commit and its recovery at the
    next open, with both blocked."""
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run(
        [sys.executable, "-c", LOGS_RUN, str(tmp_path / "cdc")], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "OK 1 []", proc.stdout


def test_graph_io_and_reference_class_paths_run_with_jax_blocked(tmp_path):
    """A GraphSON round trip through the package-level functions, and a
    class cell and a pickle that name the reference's package: the ones
    with a counterpart read as the port's classes, the others are refused,
    and neither imports the reference, with both blocked."""
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run(
        [sys.executable, "-c", IO_RUN, str(tmp_path / "graph.json")], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "OK 2 []", proc.stdout


def test_remote_store_runs_with_jax_blocked():
    """A port storage server in its own process and a port client: a graph
    over the wire, a commit and a CPU submit(), with both blocked in both
    processes."""
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run(
        [sys.executable, "-c", REMOTE_RUN], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "OK 1.0 True []", proc.stdout


def test_faults_sharded_store_and_remote_index_run_with_jax_blocked(tmp_path):
    """A faulted graph over the sharded store with its mixed index on a
    port index server in another process: writes, an index query and a
    CPU submit preempted and resumed, with both blocked in both
    processes."""
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run(
        [sys.executable, "-c", FAULT_RUN, str(tmp_path / "ck.npz")], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "OK 3 True []", proc.stdout


def test_query_server_and_driver_run_with_jax_blocked():
    """The query server over the Gods on the CPU: a pageRank() request
    through the driver, a WebSocket session's commit read back, and a
    GraphBinary round trip, with both blocked."""
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run(
        [sys.executable, "-c", SERVER_RUN], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "OK tartarus 1 []", proc.stdout


def test_fleet_follower_and_federation_run_with_jax_blocked(tmp_path):
    """The ``fleet`` subcommand in its own process (two replicas behind
    the frontend, a write and a pageRank() request through it), then in
    process an export and a warm replica's submit, a CDC follower's
    bootstrap and pull, and a federation tick, with both blocked in both
    processes."""
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run(
        [sys.executable, "-c", FLEET_RUN, str(tmp_path)], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "OK 2 [1.0] True 1 False []", proc.stdout


def _port_files():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    # the scripts that drive the port on the card
    files += sorted(glob.glob(os.path.join(ROOT, "bin", "torch_*.py")))
    for dirpath, dirs, names in os.walk(os.path.join(ROOT, "janusgraph_tpu_torch")):
        dirs[:] = [d for d in dirs if d != "_build"]  # build output, not source
        files +=[os.path.join(dirpath, n) for n in names if n.endswith(".py")]
    return files


def _imported_names(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.lineno, node.module
        elif (
            isinstance(node, ast.Call)
            and getattr(node.func, "id", getattr(node.func, "attr", None))
            in ("__import__", "import_module")
            and node.args
            and isinstance(node.args[0], ast.Constant)
            and isinstance(node.args[0].value, str)
        ):
            yield node.lineno, node.args[0].value


#: modules of the stored-graph path that the scan must cover, and the
#: loader of the native host library (native.py builds csrc/graphcsr.cpp
#: through _build.py)
STORED_PATH_MODULES = (
    "native.py", "_build.py", "core/ids.py", "core/attributes.py", "core/codecs.py",
    "core/schema.py", "core/config.py", "core/management.py", "core/graph.py",
    "core/bulk.py", "storage/kcvs.py", "storage/inmemory.py", "storage/idauthority.py",
    "storage/backend.py", "olap/csr.py", "olap/computer.py", "core/tx.py",
    "core/elements.py", "olap/delta.py", "storage/kvstore.py", "storage/localstore.py",
    "storage/cache.py", "storage/locking.py", "storage/ttl.py", "storage/backend_op.py",
    "util/timestamps.py", "olap/input_format.py", "olap/distributed_load.py",
    "storage/log.py", "core/txlog.py", "storage/cdc.py",
)
#: modules of the traversal path (graph.traversal(), its computer steps and
#: the spillover planner)
TRAVERSAL_PATH_MODULES = (
    "exceptions.py", "core/deadline.py", "core/predicates.py", "core/profile.py",
    "core/traversal.py", "observability/profiler.py", "olap/spillover.py",
)
#: modules of graph I/O (GraphSON, GraphML, g.io())
IO_PATH_MODULES = ("core/io.py", "driver/__init__.py", "driver/graphson.py",
                   "driver/relation_identifier.py")
#: modules of the remote store (the server, the client, its pipelined
#: framing and breaker, placement, the command line)
REMOTE_PATH_MODULES = ("storage/remote.py", "storage/pipeline.py", "storage/circuit.py",
                       "core/placement.py", "cli.py", "__main__.py")
#: modules of the fault injector, the sharded store and the remote index
FAULT_PATH_MODULES = ("storage/faults.py", "storage/sharded_store.py", "indexing/remote.py",
                      "indexing/__init__.py")
#: modules of the query server, its driver and the observability plane
#: they read
SERVER_PATH_MODULES = (
    "server/__init__.py", "server/server.py", "server/admission.py", "server/auth.py",
    "server/manager.py", "server/gremlin_compat.py", "driver/client.py",
    "driver/graphbinary.py", "observability/timeseries.py", "observability/slo.py",
    "observability/continuous.py", "observability/stream.py",
)
#: modules of the serving fleet, its follower, the shard checkpoint and the
#: federation
FLEET_PATH_MODULES = ("server/fleet.py", "olap/sharded_checkpoint.py",
                      "observability/federation.py")
#: modules of the sharded executor and its transport between processes
MULTIHOST_PATH_MODULES = ("parallel/multihost.py", "parallel/compat.py", "parallel/sharded.py",
                          "parallel/sharded_frontier.py", "parallel/halo.py")


def test_no_port_file_imports_jax_or_reference():
    files = _port_files()
    assert len(files) > 10 and os.path.exists(files[0])
    pkg = os.path.join(ROOT, "janusgraph_tpu_torch")
    for rel in (STORED_PATH_MODULES + TRAVERSAL_PATH_MODULES + IO_PATH_MODULES
                + REMOTE_PATH_MODULES + FAULT_PATH_MODULES + SERVER_PATH_MODULES
                + FLEET_PATH_MODULES + MULTIHOST_PATH_MODULES):
        assert os.path.join(pkg, rel) in files, rel
    assert os.path.join(ROOT, "bin", "torch_multiprocess_olap.py") in files
    assert os.path.exists(os.path.join(pkg, "csrc", "graphcsr.cpp"))
    bad = []
    for path in files:
        with open(path) as f:
            tree = ast.parse(f.read(), filename=path)
        bad += [
            f"{os.path.relpath(path, ROOT)}:{line} imports {name}"
            for line, name in _imported_names(tree)
            if _forbidden(name)
        ]
    assert not bad, bad


#: the port's static analyzer: stdlib only
ANALYSIS_MODULES = (
    "__init__.py", "__main__.py", "baseline.py", "callgraph.py", "checkpoint_rules.py",
    "cli.py", "concurrency_rules.py", "core.py", "imports_check.py", "lock_rules.py",
    "metric_rules.py", "reporting.py", "robustness_rules.py", "shape_rules.py",
    "thread_rules.py", "trace_rules.py", "tracing.py",
)


def test_the_analyzer_imports_no_torch_jax_numpy_or_reference():
    """janusgraph_tpu_torch/analysis/ (17 modules) imports nothing but the
    standard library and itself."""
    pkg = os.path.join(ROOT, "janusgraph_tpu_torch", "analysis")
    found = sorted(n for n in os.listdir(pkg) if n.endswith(".py"))
    assert found == sorted(ANALYSIS_MODULES)
    bad = []
    for rel in found:
        path = os.path.join(pkg, rel)
        with open(path) as f:
            tree = ast.parse(f.read(), filename=path)
        bad += [
            f"{rel}:{line} imports {name}"
            for line, name in _imported_names(tree)
            if name.split(".")[0] in ("torch", "jax", "numpy", "janusgraph_tpu")
        ]
    assert not bad, bad


def test_the_analyzer_runs_with_jax_blocked():
    """`python -m janusgraph_tpu_torch.analysis` with jax and the JAX
    package blocked: it lints a file, and loads neither them nor torch."""
    code = (
        "import sys, runpy\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['janusgraph_tpu'] = None\n"
        "sys.argv = ['graphlint', '--check-imports', sys.argv[1]]\n"
        "try:\n"
        "    runpy.run_module('janusgraph_tpu_torch.analysis', run_name='__main__')\n"
        "except SystemExit as e:\n"
        "    print('RC', e.code, sorted(m for m in ('torch', 'jax', 'janusgraph_tpu')\n"
        "                             if sys.modules.get(m) is not None))\n"
    )
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    target = os.path.join(ROOT, "janusgraph_tpu_torch", "analysis")
    proc = subprocess.run(
        [sys.executable, "-c", code, target], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    assert "graphlint: 0 error(s)" in proc.stdout, proc.stdout
    assert proc.stdout.strip().endswith("RC 0 []"), proc.stdout


def test_benchdiff_runs_with_jax_blocked(tmp_path):
    """`python -m janusgraph_tpu_torch benchdiff` with jax and the JAX
    package blocked: a 20% superstep regression exits 1 under
    --fail-on-regress, and neither is loaded."""
    import json

    stage = {"stage": "pagerank", "platform": "gpu", "scale": 20,
             "pagerank_superstep_ms": 1.0, "flame": {"a;b": 1}}
    old, new = tmp_path / "old.jsonl", tmp_path / "new.json"
    old.write_text(json.dumps(stage) + "\n")
    new.write_text(json.dumps({"rc": 0, "tail": "x " + json.dumps(
        dict(stage, pagerank_superstep_ms=1.2, flame={"a;b": 3}))}))
    code = (
        "import sys, runpy\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['janusgraph_tpu'] = None\n"
        "sys.argv = ['janusgraph_tpu_torch', 'benchdiff'] + sys.argv[1:]\n"
        "try:\n"
        "    runpy.run_module('janusgraph_tpu_torch', run_name='__main__')\n"
        "except SystemExit as e:\n"
        "    print('RC', e.code, sorted(m for m, mod in sys.modules.items() if mod is not None\n"
        "                             and (m == 'jax' or m.startswith('jax.')\n"
        "                                  or m == 'janusgraph_tpu'\n"
        "                                  or m.startswith('janusgraph_tpu.'))))\n"
    )
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run(
        [sys.executable, "-c", code, str(old), str(new), "--fail-on-regress", "--compact"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    report, rc = proc.stdout.strip().splitlines()
    assert rc == "RC 1 []", proc.stdout
    report = json.loads(report)
    assert report["regressed"] and report["comparisons"][0]["frame_deltas"]
    assert "REGRESSION in cells" in proc.stderr
