"""The port's operator tools held to the JAX package's ``cli.py``.

Each ported subcommand runs through ``janusgraph_tpu_torch.cli.main`` and
the reference's through ``janusgraph_tpu.cli.main`` on the same inputs
(the same telemetry recorded into each package's own registry, tracer,
flight recorder and digest table; or the same running port server or
fleet frontend, read by both tools over HTTP): the outputs and exit codes
are equal once timestamps, durations and ports are masked.

- ``config-docs``: the same option names, types, mutabilities and
  defaults as the reference's for every option the port registers (the
  two defaults the port changes on purpose excepted), on stdout and with
  ``--out``;
- ``telemetry``, ``trace``, ``flight``, ``top``, ``flame``, ``bundle``,
  ``timeseries``, ``timeline`` locally and with ``--url``;
- ``incident``, ``fleet-bundles`` against a port fleet frontend with
  federation, and ``watch`` against a port server;
- ``export`` and ``import`` over a local store directory both packages
  read;
- ``fleet`` in its own process: its start-up lines, a request through
  its frontend, and ``incident`` and ``top`` against it;
- ``benchdiff``'s exit code and message for a missing artifact
  (``tests/test_torch_benchdiff.py`` holds the rest); ``bench`` refuses,
  naming the port's own benchmark (a ROADMAP item).
"""

import json
import os
import re
import subprocess
import sys
import time
import urllib.request

import pytest

import janusgraph_tpu.observability as ref_obs
import janusgraph_tpu_torch.observability as port_obs
from janusgraph_tpu import cli as ref_cli
from janusgraph_tpu.core import config as ref_config
from janusgraph_tpu_torch import cli
from janusgraph_tpu_torch.core import config

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: defaults the port changes on purpose (ROADMAP "Deliberate differences")
DEFAULT_DIFFERENCES = {"computer.strategy", "computer.frontier-cc-min-edges"}


@pytest.fixture(autouse=True)
def _reset():
    for obs in (ref_obs, port_obs):
        obs.flight_recorder.reset()
        obs.registry.reset()
        obs.tracer.reset()
        obs.digest_table.reset()
    yield


def _run(main, argv, capsys):
    code = main(argv)
    out, err = capsys.readouterr()
    return code, out, err


def _both(argv, capsys):
    return _run(ref_cli.main, argv, capsys), _run(cli.main, argv, capsys)


def _rows(text):
    rows = {}
    for line in text.splitlines():
        if line.startswith("| ") and not line.startswith("| option"):
            cells = [c.strip() for c in line.strip("|").split(" | ")]
            rows[cells[0]] = cells[1:4]
    return rows


def test_config_docs_list_the_references_names_and_defaults(capsys, tmp_path):
    (rc, rout, _), (pc, pout, _) = _both(["config-docs"], capsys)
    assert rc == pc == 0
    ref_rows, port_rows = _rows(rout), _rows(pout)
    assert sorted(port_rows) == sorted(config.REGISTRY)
    assert set(port_rows) <= set(ref_rows)
    for name, (typ, mut, default) in port_rows.items():
        assert [typ, mut] == ref_rows[name][:2], name
        if name not in DEFAULT_DIFFERENCES:
            assert default == ref_rows[name][2], name
    fleet_rows = [n for n in port_rows if n.startswith(("server.fleet.", "metrics.fleet-"))]
    assert len(fleet_rows) == 24
    assert all(n in port_rows for n in ref_config.REGISTRY if n.startswith("storage.faults.replica-"))
    code, out, _ = _run(cli.main, ["config-docs", "--out", str(tmp_path / "cfg.md")], capsys)
    assert code == 0 and out.strip() == f"wrote {tmp_path / 'cfg.md'}"
    assert (tmp_path / "cfg.md").read_text() == pout


@pytest.mark.parametrize("argv", [["bench"], ["bench", "--scale", "4"],
                                  ["benchdiff", "a.json", "b.json", "--fail-on-regress"]])
def test_bench_tools_refuse_naming_their_item(argv, capsys):
    """``bench`` refuses with exit code 2, naming the port's benchmark;
    ``benchdiff`` is ported and exits as the reference's does (2: the
    artifacts do not exist), with the same message."""
    code, out, err = _run(cli.main, argv, capsys)
    assert code == 2 and out == ""
    assert cli._NOT_PORTED == ("bench",)
    if argv[0] == "bench":
        assert "'bench' is not ported yet" in err and "the port's own benchmark" in err
        assert "#5" not in err
    else:
        assert (code, out, err) == _run(ref_cli.main, argv, capsys)
        assert err == "no such artifact: a.json\n"


def test_the_tools_parse_the_references_flags(capsys):
    for argv in (["fleet", "--bogus"], ["incident"], ["watch"], ["trace"]):
        with pytest.raises(SystemExit) as pe:
            cli.main(argv)
        with pytest.raises(SystemExit) as re_:
            ref_cli.main(argv)
        assert pe.value.code == re_.value.code == 2
    capsys.readouterr()


def _masked_snapshot(text):
    payload = json.loads(text)
    for e in payload.get("events", []):
        for k in ("ts", "mono", "seq"):
            e.pop(k, None)
    return payload


def test_flight_dumps_the_same_events(capsys):
    for obs in (ref_obs, port_obs):
        obs.flight_recorder.record("fleet", action="drain", replica="r1", handed_off=3)
        obs.flight_recorder.record("fault", kind="replica_kill", replica=2)
    (rc, rout, _), (pc, pout, _) = _both(["flight"], capsys)
    assert rc == pc == 0
    ref, port = _masked_snapshot(rout), _masked_snapshot(pout)
    assert port["events"] == ref["events"] and len(port["events"]) == 2


def _trace(obs, trace_id):
    ctx = obs.TraceContext(trace_id=trace_id, span_id=0x77)
    with obs.tracer.child_span(ctx, "fleet.route", key="k"):
        with obs.tracer.span("fleet.attempt", replica="r0", attempt=0):
            pass


def _strip(d):
    if isinstance(d, dict):
        return {k: _strip(v) for k, v in d.items() if k not in ("duration_ms", "span_id",
                                                                  "parent_span_id")}
    if isinstance(d, list):
        return [_strip(x) for x in d]
    return d


def test_trace_prints_the_same_span_trees(capsys):
    for obs in (ref_obs, port_obs):
        _trace(obs, 0xABC)
    (rc, rout, _), (pc, pout, _) = _both(["trace", "abc"], capsys)
    assert rc == pc == 0
    assert _strip(json.loads(pout)) == _strip(json.loads(rout))
    assert json.loads(pout)["spans"][0]["children"][0]["attrs"] == {"replica": "r0", "attempt": 0}
    assert [c[0] for c in _both(["trace", "123"], capsys)] == [1, 1]
    assert [c[0] for c in _both(["trace", "xyz"], capsys)] == [2, 2]


def test_flame_renders_the_same_stacks(capsys):
    for obs in (ref_obs, port_obs):
        _trace(obs, 0xDEF)
    (rc, rout, _), (pc, pout, _) = _both(["flame", "def"], capsys)
    assert rc == pc == 0
    stacks = lambda t: [line.rsplit(" ", 1)[0] for line in t.splitlines()]  # noqa: E731
    assert stacks(pout) == stacks(rout) == ["fleet.route", "fleet.route;fleet.attempt"]
    for argv, want in ((["flame"], 2), (["flame", "zz"], 2), (["flame", "1234"], 1)):
        assert [c[0] for c in _both(argv, capsys)] == [want, want]


def test_top_prints_the_same_digest_table(capsys):
    for obs in (ref_obs, port_obs):
        for i in range(5):
            obs.digest_table.observe("d1", "g.V().out(?)", 2.0 + i, cells=10)
        obs.digest_table.observe("d2", "g.V().count()", 40.0, cells=3)
    (rc, rout, _), (pc, pout, _) = _both(["top"], capsys)
    assert rc == pc == 0 and pout == rout
    assert pout.splitlines()[1].split()[0] == "d2"
    (rc, rout, _), (pc, pout, _) = _both(["top", "--json", "-k", "1"], capsys)
    assert json.loads(pout) == json.loads(rout) and len(json.loads(pout)["digests"]) == 1


def test_telemetry_renders_the_same_registry(capsys):
    for obs in (ref_obs, port_obs):
        obs.registry.counter("fleet.router.routed").inc(3)
        obs.registry.set_gauge("admission.limit", 8.0)
    (rc, rout, _), (pc, pout, _) = _both(["telemetry"], capsys)
    assert rc == pc == 0 and pout == rout
    assert "fleet_router_routed" in pout
    (rc, rout, _), (pc, pout, _) = _both(["telemetry", "--json"], capsys)
    assert json.loads(pout)["metrics"] == json.loads(rout)["metrics"]


def test_timeseries_and_timeline_locally(capsys, tmp_path):
    (rc, rout, _), (pc, pout, _) = _both(["timeseries", "--name", "nothing."], capsys)
    assert rc == pc == 0 and sorted(json.loads(pout)) == sorted(json.loads(rout))
    code, out, err = _run(cli.main, ["timeseries", "--export", str(tmp_path / "w.jsonl")], capsys)
    assert code == 0 and "exported" in err
    assert [c[0] for c in _both(["timeline", "--run", "-1"], capsys)] == [1, 1]
    import numpy as np

    from janusgraph_tpu_torch.olap import csr_from_edges, run_on
    from janusgraph_tpu_torch.olap.programs import PageRankProgram

    rng = np.random.default_rng(0)
    run_on(csr_from_edges(16, rng.integers(0, 16, 40), rng.integers(0, 16, 40)),
           PageRankProgram(max_iterations=3), device="cpu")
    code, out, _ = _run(cli.main, ["timeline", "--out", str(tmp_path / "t.json")], capsys)
    assert code == 0
    doc = json.loads((tmp_path / "t.json").read_text())
    port_obs.timeline.validate_chrome_trace(doc)


def test_bundle_without_a_directory_fails_as_the_reference(capsys):
    (rc, _, rerr), (pc, _, perr) = _both(["bundle"], capsys)
    assert rc == pc == 1 and perr == rerr


@pytest.fixture
def port_server():
    from janusgraph_tpu_torch.core.graph import open_graph
    from janusgraph_tpu_torch.server import JanusGraphManager, JanusGraphServer

    g = open_graph({"computer.executor": "cpu"})
    m = JanusGraphManager()
    m.put_graph("graph", g)
    s = JanusGraphServer(manager=m, history_enabled=False, slo_enabled=False,
                         replica_name="r0").start()
    yield s
    s.stop()
    g.close()


def test_the_tools_read_a_running_server(port_server, capsys):
    url = f"127.0.0.1:{port_server.port}"
    from janusgraph_tpu_torch.driver import JanusGraphClient

    JanusGraphClient(port=port_server.port, http_timeout_s=30).submit("g.V().count()")
    for argv in (["telemetry", "--url", url], ["telemetry", "--json", "--url", url],
                 ["flight", "--url", url], ["top", "--json", "--url", url],
                 ["timeseries", "--url", url]):
        (rc, rout, _), (pc, pout, _) = _both(argv, capsys)
        assert rc == pc == 0, argv
        if "--json" in argv or argv[0] in ("top", "timeseries"):
            assert sorted(json.loads(pout)) == sorted(json.loads(rout)), argv
    (rc, rout, _), (pc, pout, _) = _both(["top", "--url", url], capsys)
    assert pout.splitlines()[0] == rout.splitlines()[0]
    assert [c[0] for c in _both(["flame", "--live", "--url", url], capsys)] == [0, 0]
    assert [c[0] for c in _both(["timeline", "--url", url], capsys)] == [1, 1]


def test_watch_tails_a_running_server(port_server, capsys):
    url = f"127.0.0.1:{port_server.port}"
    port_obs.flight_recorder.record("fleet", action="drain", replica="r0")
    outs = []
    for main in (ref_cli.main, cli.main):
        # a resume cursor of 0 replays the retained flight ring
        code, out, err = _run(main, ["watch", "--url", url, "--count", "1", "--json",
                                     "--streams", "flight", "--cursor", "flight=0"], capsys)
        frames = [json.loads(line) for line in out.splitlines()]
        outs.append((code, [f["type"] for f in frames], [
            (f["data"]["category"], f["data"].get("action")) for f in frames if f["type"] == "event"]))
    assert outs[0] == outs[1] == (0, ["hello", "event"], [("fleet", "drain")])
    code, _out, err = _run(cli.main, ["watch", "--url", "127.0.0.1:9", "--count", "1"], capsys)
    assert code == 1 and "connect failed" in err


@pytest.fixture
def port_fleet():
    from janusgraph_tpu_torch.core.graph import open_graph
    from janusgraph_tpu_torch.observability.federation import FleetFederation
    from janusgraph_tpu_torch.server import (FleetFrontend, FleetRouter, JanusGraphManager,
                                             JanusGraphServer)
    from janusgraph_tpu_torch.storage.inmemory import InMemoryStoreManager

    mgr = InMemoryStoreManager()
    graphs, servers = [], []
    router = FleetRouter()
    for i in range(2):
        g = open_graph({"computer.executor": "cpu"}, store_manager=mgr)
        m = JanusGraphManager()
        m.put_graph("graph", g)
        s = JanusGraphServer(manager=m, history_enabled=(i == 0), slo_enabled=False,
                             replica_name=f"r{i}").start()
        graphs.append(g)
        servers.append(s)
        router.add_replica(f"r{i}", "127.0.0.1", s.port)
    router.probe()
    fed = FleetFederation(router, interval_s=3600.0)
    frontend = FleetFrontend(router, federation=fed).start()
    yield frontend, fed, router
    frontend.stop()
    router.stop()
    for s in servers:
        s.stop()
    for g in graphs:
        g.close()


def test_incident_and_fleet_bundles_read_a_frontend(port_fleet, capsys):
    frontend, fed, router = port_fleet
    router.mark_dead("r1", reason="test")
    fed.tick()
    url = f"127.0.0.1:{frontend.port}"
    (rc, rout, _), (pc, pout, _) = _both(["incident", "--url", url, "--window", "0", "--json"], capsys)
    assert rc == pc == 0
    ref, port = json.loads(rout), json.loads(pout)
    assert sorted(port) == sorted(ref) and port["missing"] == ref["missing"] == ["r1"]
    assert [p["phase"] for p in port["phases"]] == [p["phase"] for p in ref["phases"]]
    assert "mark_dead" in [p["phase"] for p in port["phases"]]
    (rc, rout, _), (pc, pout, _) = _both(["incident", "--url", url, "--window", "0", "--tail", "2"],
                                         capsys)
    assert rc == pc == 0
    mask = lambda t: re.sub(r"t=[\d.]+|\s[\d.]{8,}\s", "", t)  # noqa: E731
    assert mask(pout) == mask(rout) and "PARTIAL (missing: r1)" in pout
    (rc, rout, _), (pc, pout, _) = _both(["fleet-bundles", "--url", url], capsys)
    assert rc == pc == 0 and pout == rout and pout.startswith("shipped bundles: 0")


def test_export_and_import_through_both_tools(tmp_path, capsys):
    from janusgraph_tpu_torch.core.graph import open_graph

    d = str(tmp_path / "db")
    src = {"storage.backend": "local", "storage.directory": d, "computer.executor": "cpu"}
    g = open_graph(src)
    tx = g.new_transaction()
    vs = [tx.add_vertex("person", name=f"p{i}", age=20 + i) for i in range(5)]
    for i in range(5):
        tx.add_edge(vs[i], "knows", vs[(i + 1) % 5])
    tx.commit()
    g.close()
    (tmp_path / "src.json").write_text(json.dumps(src))
    outs = {}
    for name, main in (("ref", ref_cli.main), ("port", cli.main)):
        code, out, _ = _run(main, ["export", "--config", str(tmp_path / "src.json"),
                                   str(tmp_path / f"{name}.json")], capsys)
        outs[name] = (code, out.replace(str(tmp_path / f"{name}.json"), "OUT"))
    assert outs["port"] == outs["ref"] == (0, "exported 5 vertices, 5 edges -> OUT\n")
    assert (tmp_path / "port.json").read_text() == (tmp_path / "ref.json").read_text()
    for name, main in (("ref", ref_cli.main), ("port", cli.main)):
        dst = {"storage.backend": "local", "storage.directory": str(tmp_path / f"in_{name}")}
        (tmp_path / f"dst_{name}.json").write_text(json.dumps(dst))
        code, out, _ = _run(main, ["import", "--config", str(tmp_path / f"dst_{name}.json"),
                                   "--batch", "2", str(tmp_path / "port.json")], capsys)
        outs[name] = (code, out.replace(str(tmp_path / "port.json"), "IN"))
    assert outs["port"] == outs["ref"] == (0, "imported 5 vertices, 5 edges from IN\n")
    assert [c[0] for c in _both(["import", "--config", str(tmp_path / "dst_port.json"),
                                 "--batch", "0", "x"], capsys)] == [2, 2]


def test_the_fleet_subcommand_serves_through_its_frontend(tmp_path, capsys):
    cfg = tmp_path / "fleet.json"
    cfg.write_text(json.dumps({"computer.executor": "cpu", "server.fleet.replicas": 2,
                               "server.fleet.probe-interval-s": 0.2}))
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.Popen([sys.executable, "-m", "janusgraph_tpu_torch", "fleet", "--port", "0",
                             "--config", str(cfg)], cwd=ROOT, env=env,
                            stdout=subprocess.PIPE, text=True)
    try:
        lines = [proc.stdout.readline() for _ in range(3)]
        assert re.match(r"  replica r0: 127\.0\.0\.1:\d+$", lines[0])
        assert re.match(r"  replica r1: 127\.0\.0\.1:\d+$", lines[1])
        m = re.match(r"fleet frontend listening on 127\.0\.0\.1:(\d+) \(2 replicas\)$", lines[2])
        assert m, lines
        port = int(m.group(1))
        from janusgraph_tpu_torch.driver import JanusGraphClient

        c = JanusGraphClient(port=port, http_timeout_s=60)
        c.submit("g.addV('person').property('name','a').iterate()")
        assert c.submit("g.V().count()") == 1
        health = json.loads(urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz",
                                                   timeout=30).read())
        assert health["status"] == "ok" and sorted(health["replicas"]) == ["r0", "r1"]
        deadline = time.monotonic() + 30
        while True:
            code, out, _ = _run(cli.main, ["incident", "--url", f"127.0.0.1:{port}", "--json"], capsys)
            if code == 0 and json.loads(out)["replicas"] == ["r0", "r1"]:
                break
            assert time.monotonic() < deadline
            time.sleep(0.2)
        # the digests live on the replicas: top reads one of them
        r0 = lines[0].rsplit(" ", 1)[1].strip()
        code, out, _ = _run(cli.main, ["top", "--url", r0], capsys)
        assert code == 0 and out.splitlines()[0].split()[:2] == ["digest", "count"]
    finally:
        proc.terminate()
        proc.wait(timeout=20)
