"""The port's shard-checkpoint format held to the JAX package's.

``olap/sharded_checkpoint.py`` is the reference's module, whole: the
state checkpoints (per-shard slices + a digest-verified manifest) and the
CSR snapshot packs the fleet's warm-up and the CDC follower read. The
format is the reference's byte for byte: a checkpoint either package
writes, at 1, 3 or 4 shards, loads array-equal in the other, and the two
packages write the same manifest bytes for the same inputs (the manifest
names every slice by its content digest, so equal manifests mean equal
slice contents). A torn slice falls back to its ``.prev`` twin, a torn
manifest to ``manifest.json.prev``, with the reference's counters and
flight events; a checkpoint written at 4 shards restores at any shard
count. Exact equality throughout: these are files, ids and arrays.
"""

import json
import os

import numpy as np
import pytest

from janusgraph_tpu.observability import flight_recorder as ref_flight
from janusgraph_tpu.observability import registry as ref_registry
from janusgraph_tpu.olap import csr as ref_csr
from janusgraph_tpu.olap import sharded_checkpoint as ref_sc
from janusgraph_tpu_torch.observability import flight_recorder, registry
from janusgraph_tpu_torch.olap import csr as port_csr
from janusgraph_tpu_torch.olap import sharded_checkpoint as sc

PKGS = {
    "ref": dict(sc=ref_sc, csr=ref_csr, flight=ref_flight, registry=ref_registry),
    "port": dict(sc=sc, csr=port_csr, flight=flight_recorder, registry=registry),
}
OTHER = {"ref": "port", "port": "ref"}
CSR_FIELDS = ("vertex_ids", "out_indptr", "out_dst", "in_indptr", "in_src", "out_degree",
              "labels", "out_edge_type", "in_edge_type")


@pytest.fixture(autouse=True)
def _reset():
    for p in PKGS.values():
        p["flight"].reset()
        p["registry"].reset()
    yield


def _graph(pkg, seed=0, n=37, m=150, typed=True, labelled=True):
    rng = np.random.default_rng(seed)
    src, dst = rng.integers(0, n, m), rng.integers(0, n, m)
    types = rng.integers(0, 5, m) if typed else None
    g = PKGS[pkg]["csr"].csr_from_edges(n, src, dst, edge_types=types)
    g.vertex_ids = (rng.permutation(n).astype(np.int64) << 8) + 1
    if labelled:
        g.labels = rng.integers(0, 7, n).astype(np.int32)
    return g


def _state(seed=0, n=37):
    rng = np.random.default_rng(seed)
    return {"rank": rng.random(n), "hops": rng.integers(0, 9, (n, 3)).astype(np.int32),
            "flag": rng.random(n) < 0.5}


def _assert_csr_equal(a, b):
    for f in CSR_FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        assert (x is None) == (y is None), f
        if x is not None:
            assert x.dtype == y.dtype and np.array_equal(x, y), f


def _manifest(d):
    with open(os.path.join(d, "manifest.json"), "rb") as f:
        return f.read()


@pytest.mark.parametrize("shards", [1, 3, 4])
@pytest.mark.parametrize("writer", ["ref", "port"])
def test_csr_checkpoint_loads_in_the_other_package(tmp_path, writer, shards):
    g = _graph(writer, seed=shards)
    PKGS[writer]["sc"].save_csr_checkpoint(str(tmp_path / "w"), g, 41, num_shards=shards)
    out = PKGS[OTHER[writer]]["sc"].load_csr_checkpoint(str(tmp_path / "w"))
    assert out is not None and out[1] == 41
    _assert_csr_equal(out[0], g)
    # the same pack written by the other package: the same manifest bytes
    PKGS[OTHER[writer]]["sc"].save_csr_checkpoint(str(tmp_path / "o"), g, 41, num_shards=shards)
    assert _manifest(tmp_path / "w") == _manifest(tmp_path / "o")
    assert sorted(os.listdir(tmp_path / "w")) == sorted(os.listdir(tmp_path / "o"))


@pytest.mark.parametrize("shards", [1, 3, 4])
@pytest.mark.parametrize("writer", ["ref", "port"])
def test_state_checkpoint_loads_in_the_other_package(tmp_path, writer, shards):
    state, memory = _state(seed=shards), {"delta": 0.125, "iters": 7}
    PKGS[writer]["sc"].save_sharded_checkpoint(str(tmp_path / "w"), state, memory, 5, shards)
    got = PKGS[OTHER[writer]]["sc"].load_sharded_checkpoint(str(tmp_path / "w"))
    assert got is not None
    st, mem, steps = got
    assert steps == 5 and mem == {"delta": 0.125, "iters": 7.0}
    assert sorted(st) == sorted(state)
    for k in state:
        assert st[k].dtype == state[k].dtype and np.array_equal(st[k], state[k]), k
    PKGS[OTHER[writer]]["sc"].save_sharded_checkpoint(str(tmp_path / "o"), state, memory, 5, shards)
    assert _manifest(tmp_path / "w") == _manifest(tmp_path / "o")


@pytest.mark.parametrize("n,s", [(0, 1), (1, 4), (5, 3), (37, 4), (64, 8), (100, 7), (7, 7)])
def test_shard_ranges_equal_the_reference(n, s):
    assert sc.shard_ranges(n, s) == ref_sc.shard_ranges(n, s)


def _torn_slice(pkg, d, kind):
    """Save twice, then tear shard 1 after its demotion: the loader takes
    the ``.prev`` twin, which carries the newest manifest's bytes when the
    second save wrote the same content."""
    m = PKGS[pkg]["sc"]
    if kind == "csr":
        g = _graph(pkg, seed=3)
        m.save_csr_checkpoint(d, g, 9, num_shards=3)
        m.save_csr_checkpoint(d, g, 9, num_shards=3)
    else:
        m.save_sharded_checkpoint(d, _state(3), {"x": 1.0}, 4, 3)
        m.save_sharded_checkpoint(d, _state(3), {"x": 1.0}, 4, 3)
    with open(os.path.join(d, "shard-1.npz"), "wb") as f:
        f.write(b"PK\x03\x04torn")
    out = m.load_csr_checkpoint(d) if kind == "csr" else m.load_sharded_checkpoint(d)
    snap = PKGS[pkg]["registry"].snapshot()
    events = [{k: v for k, v in e.items() if k not in ("ts", "mono", "seq")}
              for e in PKGS[pkg]["flight"].events("checkpoint")]
    return out, snap.get("olap.checkpoint.shard_fallback", {}).get("count", 0), events


@pytest.mark.parametrize("kind", ["csr", "state"])
def test_a_torn_slice_falls_back_to_its_prev_twin(tmp_path, kind):
    got = {p: _torn_slice(p, str(tmp_path / p), kind) for p in PKGS}
    out, fallbacks, events = got["port"]
    assert out is not None
    if kind == "csr":
        _assert_csr_equal(out[0], _graph("port", seed=3))
    else:
        assert np.array_equal(out[0]["rank"], _state(3)["rank"]) and out[2] == 4
        assert fallbacks == 1
    assert (fallbacks, events) == got["ref"][1:]


def _torn_manifest(pkg, d, kind):
    m = PKGS[pkg]["sc"]
    if kind == "csr":
        m.save_csr_checkpoint(d, _graph(pkg, seed=1), 3, num_shards=2)
        m.save_csr_checkpoint(d, _graph(pkg, seed=2), 8, num_shards=2)
    else:
        m.save_sharded_checkpoint(d, _state(1), {"x": 1.0}, 3, 2)
        m.save_sharded_checkpoint(d, _state(2), {"x": 2.0}, 8, 2)
    with open(os.path.join(d, "manifest.json"), "w") as f:
        f.write('{"torn":')
    out = m.load_csr_checkpoint(d) if kind == "csr" else m.load_sharded_checkpoint(d)
    count = PKGS[pkg]["registry"].snapshot().get("olap.checkpoint.manifest_fallback", {})
    actions = [e.get("action") for e in PKGS[pkg]["flight"].events("checkpoint")]
    return out, count.get("count", 0), actions


@pytest.mark.parametrize("kind", ["csr", "state"])
def test_a_torn_manifest_falls_back_to_manifest_prev(tmp_path, kind):
    got = {p: _torn_manifest(p, str(tmp_path / p), kind) for p in PKGS}
    out, count, actions = got["port"]
    assert out is not None and count == 1 and actions[-1] == "manifest_fallback"
    if kind == "csr":
        # the previous pack (epoch 3) comes back whole from the demoted twins
        assert out[1] == 3
        _assert_csr_equal(out[0], _graph("port", seed=1))
    else:
        assert out[2] == 3 and np.array_equal(out[0]["rank"], _state(1)["rank"])
    assert (count, actions) == got["ref"][1:]


def test_a_torn_slice_without_a_good_twin_is_no_checkpoint(tmp_path):
    for p in PKGS:
        d = str(tmp_path / p)
        PKGS[p]["sc"].save_csr_checkpoint(d, _graph(p), 2, num_shards=2)
        with open(os.path.join(d, "shard-0.npz"), "wb") as f:
            f.write(b"garbage")
        assert PKGS[p]["sc"].load_csr_checkpoint(d) is None
        assert PKGS[p]["sc"].load_csr_checkpoint(str(tmp_path / "missing")) is None
        assert PKGS[p]["sc"].load_sharded_checkpoint(str(tmp_path / "missing")) is None


@pytest.mark.parametrize("kind", ["csr", "state"])
def test_a_checkpoint_written_at_4_shards_restores_at_any_count(tmp_path, kind):
    g, state = _graph("port", seed=9, n=41), _state(9, n=41)
    first = str(tmp_path / "s4")
    if kind == "csr":
        sc.save_csr_checkpoint(first, g, 6, num_shards=4)
    else:
        sc.save_sharded_checkpoint(first, state, {"m": 2.0}, 6, 4)
    for count in (1, 2, 3, 5, 8):
        d = str(tmp_path / f"s{count}")
        if kind == "csr":
            back, epoch = sc.load_csr_checkpoint(first)
            sc.save_csr_checkpoint(d, back, epoch, num_shards=count)
            again, epoch2 = ref_sc.load_csr_checkpoint(d)
            assert epoch2 == 6
            _assert_csr_equal(again, g)
        else:
            st, mem, steps = sc.load_sharded_checkpoint(first)
            sc.save_sharded_checkpoint(d, st, mem, steps, count)
            st2, mem2, steps2 = ref_sc.load_sharded_checkpoint(d)
            assert (mem2, steps2) == ({"m": 2.0}, 6)
            for k in state:
                assert np.array_equal(st2[k], state[k])


def test_saves_record_the_references_flight_events(tmp_path):
    seen = {}
    for p in PKGS:
        PKGS[p]["sc"].save_csr_checkpoint(str(tmp_path / p / "c"), _graph(p), 1, num_shards=3)
        PKGS[p]["sc"].save_sharded_checkpoint(str(tmp_path / p / "s"), _state(), {}, 2, 2)
        seen[p] = [{k: v for k, v in e.items() if k not in ("ts", "mono", "seq")}
                   for e in PKGS[p]["flight"].events("checkpoint")]
    assert seen["port"] == seen["ref"]
    assert [e["action"] for e in seen["port"]] == ["csr_save", "shard_save"]


def test_a_manifest_edited_after_the_fact_does_not_verify(tmp_path):
    d = str(tmp_path)
    sc.save_csr_checkpoint(d, _graph("port"), 4, num_shards=2)
    body = json.loads(_manifest(d))
    body["epoch"] = 5  # the digest no longer matches
    with open(os.path.join(d, "manifest.json"), "w") as f:
        json.dump(body, f)
    assert sc.load_csr_checkpoint(d) is None
    assert ref_sc.load_csr_checkpoint(d) is None
