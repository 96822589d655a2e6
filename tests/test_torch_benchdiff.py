"""The port's bench regression sentinel (``observability/benchdiff.py``)
and its ``benchdiff`` subcommand, held to the JAX package's.

The first cases are the port's twins of the reference's own benchdiff
tests. The rest run both packages on the same synthetic artifacts, written
to ``tmp_path`` in each of the four shapes the loader accepts (one stage
dict, a supervisor wrapper with stage lines in its ``tail``, a ``.jsonl``
of stage lines, a list of stage dicts): ``diff_artifacts``, ``compare``
and ``best_prior`` must give equal reports, and both CLIs equal exit codes
and stdout. No case reads an artifact of the repository.
"""

import json

import pytest

from janusgraph_tpu.cli import main as ref_cli_main
from janusgraph_tpu.observability import benchdiff as ref_bd
from janusgraph_tpu_torch import cli
from janusgraph_tpu_torch.observability import benchdiff as bd


def _stage(ms, **kw):
    s = {"stage": "pagerank", "platform": "cpu", "scale": 16,
         "pagerank_superstep_ms": ms}
    s.update(kw)
    return s


# ------------------------------------------------ twins of the reference's
def test_benchdiff_verdict_matrix():
    old = _stage(100.0)
    assert bd.compare(old, _stage(120.0))["verdict"] == "regress"
    assert bd.compare(old, _stage(80.0))["verdict"] == "improve"
    assert bd.compare(old, _stage(105.0))["verdict"] == "noise"
    # higher-is-better metrics flip the direction
    o = {"stage": "saturate", "platform": "cpu", "peak_goodput_per_s": 100.0}
    n = dict(o, peak_goodput_per_s=70.0)
    assert bd.compare(o, n)["verdict"] == "regress"


def test_benchdiff_cell_matching_is_strict():
    stages = [_stage(50.0, scale=20), _stage(70.0, platform="tpu"),
              _stage(90.0), _stage(60.0)]
    best = bd.best_prior(stages, bd.cell_key(_stage(0.0)))
    # only the two (pagerank, 16, cpu) rows compete; the best (60) wins
    assert best["pagerank_superstep_ms"] == 60.0
    assert bd.best_prior(stages, bd.cell_key(_stage(0.0, scale=99))) is None


def test_benchdiff_artifact_shapes(tmp_path):
    p1 = tmp_path / "one.json"
    p1.write_text(json.dumps(_stage(50.0)))
    assert len(bd.load_stages(str(p1))) == 1
    p2 = tmp_path / "many.jsonl"
    p2.write_text(json.dumps(_stage(50.0)) + "\nnot json\n"
                  + json.dumps(_stage(60.0, stage="bfs")) + "\n")
    assert len(bd.load_stages(str(p2))) == 2
    p3 = tmp_path / "wrap.json"
    p3.write_text(json.dumps({"rc": 0, "tail": "noise " + json.dumps(_stage(55.0))
                              + " trailing", "parsed": None}))
    st = bd.load_stages(str(p3))
    assert len(st) == 1 and st[0]["pagerank_superstep_ms"] == 55.0


def test_benchdiff_cli_flags_synthetic_regression(tmp_path, capsys):
    """A synthetic 20% superstep_ms regression exits non-zero under
    --fail-on-regress."""
    old, new = tmp_path / "old.json", tmp_path / "new.json"
    old.write_text(json.dumps(_stage(75.0)))
    new.write_text(json.dumps(_stage(90.0)))  # +20%
    assert cli.main(["benchdiff", str(old), str(new), "--fail-on-regress"]) == 1
    report = json.loads(capsys.readouterr().out)
    assert report["regressed"] is True
    m = report["comparisons"][0]["metrics"][0]
    assert m["verdict"] == "regress" and m["delta_pct"] == 20.0
    # without the gate flag the report prints but exits 0
    assert cli.main(["benchdiff", str(old), str(new)]) == 0
    better = tmp_path / "better.json"
    better.write_text(json.dumps(_stage(50.0)))
    assert cli.main(["benchdiff", str(old), str(better), "--fail-on-regress"]) == 0
    capsys.readouterr()


def test_bench_baseline_index_attaches_regression(tmp_path):
    art_dir = tmp_path / "arts"
    art_dir.mkdir()
    (art_dir / "r1.json").write_text(json.dumps(_stage(75.0)))
    idx = bd.BaselineIndex([str(art_dir)])
    fresh = _stage(90.0)
    idx.attach_regression(fresh)
    assert fresh["regression"]["verdict"] == "regress"
    novel = _stage(10.0, stage="bfs", bfs_4hop_wall_s=1.0)
    del novel["pagerank_superstep_ms"]
    idx.attach_regression(novel)
    assert novel["regression"]["verdict"] == "no_baseline"


def test_benchdiff_attaches_frame_deltas_on_regress():
    old = {"stage": "saturate", "peak_goodput_per_s": 400.0,
           "goodput_2x_over_peak": 0.95, "flame": {"a;b": 100, "a;c": 50}}
    new = dict(old, peak_goodput_per_s=200.0, flame={"a;b": 300, "a;c": 50})
    got = bd.compare(old, new)
    assert got["verdict"] == "regress"
    deltas = got["frame_deltas"]
    assert 0 < len(deltas) <= 3
    assert deltas[0]["frame"] == "a"  # |delta| tie with b -> name order
    assert "frame_deltas" not in bd.compare(old, dict(old))


# ----------------------------------------------------- against the reference
def test_the_tables_are_the_references():
    assert bd.HEADLINES == ref_bd.HEADLINES
    assert (bd.LOWER, bd.HIGHER, bd.NOISE_THRESHOLD, bd.CELL_FIELDS) == (
        ref_bd.LOWER, ref_bd.HIGHER, ref_bd.NOISE_THRESHOLD, ref_bd.CELL_FIELDS)
    assert bd._SUFFIX_DIRS == ref_bd._SUFFIX_DIRS


def _old_stages():
    return [
        _stage(100.0, pagerank_wall_s=2.0, edges_per_sec=1e6, cpu_count=8),
        _stage(90.0, pagerank_wall_s=2.5, cpu_count=8),
        {"stage": "saturate", "platform": "gpu", "scale": 20,
         "peak_goodput_per_s": 400.0, "goodput_2x_over_peak": 0.9,
         "flame": {"a;b": 100, "a;c": 50}},
        {"stage": "bfs", "platform": "gpu", "scale": 20, "bfs_4hop_wall_s": 0.03},
        {"stage": "custom", "platform": "gpu", "x_ms": 5.0, "y_per_s": 10.0,
         "z_speedup": 2.0, "flag": True},
        {"stage": "smoke", "platform": "gpu"},
        {"stage": "oltp", "platform": "cpu", "scale": 16, "oltp_write_per_s": 0,
         "oltp_3hop_ms": 0.0},
    ]


def _new_stages():
    return [
        _stage(108.0, pagerank_wall_s=1.0, edges_per_sec=9e5, cpu_count=8),
        {"stage": "saturate", "platform": "gpu", "scale": 20,
         "peak_goodput_per_s": 200.0, "goodput_2x_over_peak": 0.95,
         "flame": {"a;b": 300, "a;c": 50}},
        {"stage": "bfs", "platform": "gpu", "scale": 20, "bfs_4hop_wall_s": 0.02},
        {"stage": "custom", "platform": "gpu", "x_ms": 6.0, "y_per_s": 9.5,
         "z_speedup": 2.0, "flag": False},
        {"stage": "smoke", "platform": "gpu"},
        {"stage": "oltp", "platform": "cpu", "scale": 16, "oltp_write_per_s": 5,
         "oltp_3hop_ms": 1.0},
        _stage(50.0, scale=99),
    ]


def _write(tmp_path, name, stages, shape):
    """One artifact file of the given shape holding ``stages``."""
    if shape == "stage":
        # one stage dict per file: the first stage only
        path, text = tmp_path / f"{name}.json", json.dumps(stages[0])
    elif shape == "wrapper":
        tail = "\n".join(["log line"] + [json.dumps(s) for s in stages] + ["done"])
        path, text = tmp_path / f"{name}.json", json.dumps(
            {"rc": 0, "tail": tail, "parsed": None})
    elif shape == "jsonl":
        path = tmp_path / f"{name}.jsonl"
        text = "\n".join([json.dumps(s) for s in stages] + ["not json", ""])
    else:
        path, text = tmp_path / f"{name}.json", json.dumps(stages)
    path.write_text(text)
    return str(path)


SHAPES = ("stage", "wrapper", "jsonl", "list")


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("threshold", [0.10, 0.05, 0.30])
def test_diff_artifacts_equals_the_references(tmp_path, shape, threshold):
    old = _write(tmp_path, "old", _old_stages(), shape)
    new = _write(tmp_path, "new", _new_stages(), shape)
    assert bd.load_stages(old) == ref_bd.load_stages(old)
    got = bd.diff_artifacts(old, new, threshold=threshold)
    assert got == ref_bd.diff_artifacts(old, new, threshold=threshold)
    assert got["cells_compared"] >= 1


@pytest.mark.parametrize("shape", SHAPES)
def test_compare_and_best_prior_equal_the_references(tmp_path, shape):
    old_stages = bd.load_stages(_write(tmp_path, "old", _old_stages(), shape))
    for s in bd.load_stages(_write(tmp_path, "new", _new_stages(), shape)):
        cell = bd.cell_key(s)
        assert cell == ref_bd.cell_key(s)
        assert bd.headline_metrics(s) == ref_bd.headline_metrics(s)
        prior = bd.best_prior(old_stages, cell)
        assert prior == ref_bd.best_prior(old_stages, cell)
        assert bd.nearest_cell_mismatch(old_stages, cell) == \
            ref_bd.nearest_cell_mismatch(old_stages, cell)
        if prior is not None:
            assert bd.compare(prior, s) == ref_bd.compare(prior, s)


def test_attach_regression_equals_the_references(tmp_path):
    (tmp_path / "a.jsonl").write_text("\n".join(json.dumps(s) for s in _old_stages()))
    (tmp_path / "skip.txt").write_text("ignored")
    ours, ref = bd.BaselineIndex([str(tmp_path)]), ref_bd.BaselineIndex([str(tmp_path)])
    for s in _new_stages() + [{"stage": "pagerank", "platform": "tpu",
                               "pagerank_superstep_ms": 1.0}]:
        a, b = dict(s), dict(s)
        ours.attach_regression(a)
        ref.attach_regression(b)
        assert a == b


CLI_CASES = [
    ([], "wrapper"),
    (["--fail-on-regress"], "wrapper"),
    (["--compact"], "jsonl"),
    (["--threshold", "50", "--fail-on-regress"], "list"),
    (["--fail-on-regress", "--compact"], "stage"),
]


@pytest.mark.parametrize("flags,shape", CLI_CASES)
def test_the_cli_equals_the_references(tmp_path, capsys, flags, shape):
    old = _write(tmp_path, "old", _old_stages(), shape)
    new = _write(tmp_path, "new", _new_stages(), shape)
    argv = ["benchdiff", old, new] + flags
    code = cli.main(argv)
    out, err = capsys.readouterr()
    ref_code = ref_cli_main(argv)
    ref_out, ref_err = capsys.readouterr()
    assert (code, out, err) == (ref_code, ref_out, ref_err)


def test_the_cli_exit_codes_equal_the_references(tmp_path, capsys):
    """2 for a missing file, 3 when no cell is in both."""
    a = tmp_path / "a.json"
    a.write_text(json.dumps(_stage(1.0)))
    b = tmp_path / "b.json"
    b.write_text(json.dumps(_stage(1.0, scale=3)))
    for argv, want in ((["benchdiff", str(a), str(tmp_path / "none.json")], 2),
                       (["benchdiff", str(a), str(b)], 3),
                       (["benchdiff", str(a), str(a), "--fail-on-regress"], 0)):
        code = cli.main(argv)
        out, err = capsys.readouterr()
        assert (code, out, err) == (ref_cli_main(argv), *capsys.readouterr())
        assert code == want
