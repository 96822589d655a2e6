"""The port's checkpoints and auto-resume held against the JAX package's.

The ``.npz`` format is the reference's, so a checkpoint written by either
package loads in the other and a run resumed from it finishes with the
reference's bits. A ``SuperstepPreempted`` at superstep k resumes from the
last checkpoint, on the host loop and on the fused path, with the bits of
the uninterrupted run (as ``tests/test_chaos.py`` holds the reference).
PageRank runs at damping 0.5 on a graph where every vertex has an out-edge,
where the two packages give the same bits (see tests/test_torch_fused.py)."""

import os

import numpy as np
import pytest

import janusgraph_tpu.olap as ref
from janusgraph_tpu.olap import autotune as ref_at
from janusgraph_tpu.olap import checkpoint as ref_ck
from janusgraph_tpu.olap.programs import (
    ConnectedComponentsProgram as RefCC,
    PageRankProgram as RefPR,
)
from janusgraph_tpu.olap.tpu_executor import TPUExecutor
from janusgraph_tpu_torch.exceptions import SuperstepPreempted
from janusgraph_tpu_torch.olap import GPUExecutor, csr_from_edges, run_on
from janusgraph_tpu_torch.olap.checkpoint import load_checkpoint, save_checkpoint
from janusgraph_tpu_torch.olap.programs import (
    ConnectedComponentsProgram,
    PageRankProgram,
    ShortestPathProgram,
)


def _graph(n=300, m=3000, seed=4):
    rng = np.random.default_rng(seed)
    src = np.concatenate([rng.integers(0, n, m), np.arange(n)]).astype(np.int32)
    dst = np.concatenate([(rng.zipf(1.4, m) % n), (np.arange(n) + 1) % n]).astype(np.int32)
    return ref.csr_from_edges(n, src, dst), csr_from_edges(n, src, dst)


RCSR, CSR = _graph()


class Preempt:
    """Raises SuperstepPreempted once the run reaches ``at`` (``times``
    times in all), like the reference's FaultPlan.olap_hook."""

    def __init__(self, at, times=1):
        self.at, self.left, self.seen = at, times, []

    def __call__(self, step):
        self.seen.append(step)
        if self.left and step >= self.at:
            self.left -= 1
            raise SuperstepPreempted(f"injected at superstep {step}")


def _bits(a):
    return np.asarray(a).view(np.int32)


# ------------------------------------------------------------ the format
def test_roundtrip_and_prev_fallback(tmp_path):
    path = str(tmp_path / "ck.npz")
    s1 = {"rank": np.arange(8, dtype=np.float32)}
    s2 = {"rank": np.arange(8, dtype=np.float32) * 2}
    save_checkpoint(path, s1, {"delta": np.asarray(0.5)}, 2)
    save_checkpoint(path, s2, {"delta": np.asarray(0.25)}, 4)
    assert os.path.exists(path + ".prev")
    state, mem, steps = load_checkpoint(path)
    assert steps == 4 and np.array_equal(state["rank"], s2["rank"])
    with open(path, "r+b") as f:  # torn: the older checkpoint answers
        f.truncate(16)
    state, mem, steps = load_checkpoint(path)
    assert steps == 2 and np.array_equal(state["rank"], s1["rank"])
    assert float(mem["delta"]) == 0.5


def test_corruption_detected_by_digest(tmp_path):
    path = str(tmp_path / "ck.npz")
    save_checkpoint(path, {"x": np.ones(4)}, {}, 1)
    save_checkpoint(path, {"x": np.ones(4) * 3}, {}, 3)
    data = bytearray(open(path, "rb").read())
    mid = len(data) // 2
    data[mid:mid + 4] = bytes(b ^ 0xFF for b in data[mid:mid + 4])
    with open(path, "wb") as f:
        f.write(bytes(data))
    loaded = load_checkpoint(path)
    assert loaded is None or (loaded[2] == 1 and np.array_equal(loaded[0]["x"], np.ones(4)))
    assert load_checkpoint(str(tmp_path / "missing.npz")) is None


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_files_read_across_packages(tmp_path, writer):
    path = str(tmp_path / "ck.npz")
    state = {"rank": np.linspace(0, 1, 7, dtype=np.float32), "chosen": np.arange(7, dtype=np.int32)}
    mem = {"delta": np.float32(0.125), "dangling": np.float32(0.5)}
    save, load = (save_checkpoint, ref_ck.load_checkpoint) if writer == "port" else (
        ref_ck.save_checkpoint, load_checkpoint)
    save(path, state, mem, 9)
    got_state, got_mem, steps = load(path)
    assert steps == 9 and set(got_state) == set(state) and set(got_mem) == set(mem)
    for k in state:
        assert got_state[k].dtype == state[k].dtype
        np.testing.assert_array_equal(got_state[k], state[k])
    with np.load(path) as z:
        assert set(z.files) == {"state__rank", "state__chosen", "mem__delta", "mem__dangling",
                                "meta__steps", "meta__digest"}


# ------------------------------------------------------- preempt, resume
RUNS = {
    "pagerank": (lambda: PageRankProgram(damping=0.5, max_iterations=12, tol=0.0), "rank"),
    "cc": (lambda: ConnectedComponentsProgram(), "component"),
}


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "host_loop"])
@pytest.mark.parametrize("at", [1, 2])
@pytest.mark.parametrize("name", sorted(RUNS))
def test_preemption_resumes_bitwise(tmp_path, name, at, fused):
    make, key = RUNS[name]
    want = GPUExecutor(CSR, strategy="ell", device="cpu").run(make(), fused=fused)[key]
    hook = Preempt(at)
    ex = GPUExecutor(CSR, strategy="ell", device="cpu")
    got = ex.run(make(), fused=fused, checkpoint_path=str(tmp_path / "ck.npz"),
                 checkpoint_every=2, fault_hook=hook)[key]
    info = ex.last_run_info
    assert info["resumes"] == 1 and len(info["resume_steps"]) == 1
    assert info["path"] == ("fused" if fused else "host-loop")
    np.testing.assert_array_equal(_bits(got), _bits(want))
    # the replay started from the last checkpoint (every 2 supersteps)
    fired = next(i for i, step in enumerate(hook.seen) if step >= at)
    assert hook.seen[fired + 1] == hook.seen[fired] // 2 * 2
    rec = info["resume_steps"][0]
    assert rec["preempted_at"] == hook.seen[fired]
    assert rec["from_step"] == hook.seen[fired] // 2 * 2
    assert info["run_wall_s"] >= info["wall_s"] > 0


def test_run_on_forwards_checkpoint_arguments(tmp_path):
    want = run_on(CSR, PageRankProgram(damping=0.5, max_iterations=10), device="cpu")
    got = run_on(CSR, PageRankProgram(damping=0.5, max_iterations=10), device="cpu",
                 checkpoint_path=str(tmp_path / "pr.npz"), checkpoint_every=3,
                 fault_hook=Preempt(4))
    np.testing.assert_array_equal(_bits(got["rank"]), _bits(want["rank"]))


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "host_loop"])
def test_resume_from_a_reference_checkpoint(tmp_path, fused):
    """The JAX package checkpoints the first 6 supersteps; the port resumes
    from its file and ends where the reference's uninterrupted run ends."""
    path = str(tmp_path / "ref.npz")
    TPUExecutor(RCSR, strategy="ell").run(
        RefPR(damping=0.5, max_iterations=6, tol=0.0), checkpoint_path=path, checkpoint_every=6)
    want = TPUExecutor(RCSR, strategy="ell").run(RefPR(damping=0.5, max_iterations=14, tol=0.0))
    ex = GPUExecutor(CSR, strategy="ell", device="cpu")
    got = ex.run(PageRankProgram(damping=0.5, max_iterations=14, tol=0.0), fused=fused,
                 checkpoint_path=path, checkpoint_every=4, resume=True)
    assert ex.last_run_info["supersteps"] == 14
    np.testing.assert_array_equal(_bits(got["rank"]), _bits(np.asarray(want["rank"])))


def test_reference_resumes_from_a_port_checkpoint(tmp_path):
    path = str(tmp_path / "port.npz")
    GPUExecutor(CSR, strategy="ell", device="cpu").run(
        ConnectedComponentsProgram(max_iterations=2), checkpoint_path=path, checkpoint_every=2)
    want = GPUExecutor(CSR, strategy="ell", device="cpu").run(ConnectedComponentsProgram())
    got = TPUExecutor(RCSR, strategy="ell").run(
        RefCC(), checkpoint_path=path, checkpoint_every=2, resume=True)
    np.testing.assert_array_equal(_bits(np.asarray(got["component"])), _bits(want["component"]))


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "host_loop"])
def test_exhausted_resume_attempts_reraise(tmp_path, fused):
    ex = GPUExecutor(CSR, strategy="ell", device="cpu")
    with pytest.raises(SuperstepPreempted):
        ex.run(PageRankProgram(max_iterations=10), fused=fused, fault_hook=Preempt(2, times=10),
               checkpoint_path=str(tmp_path / "ck.npz"), checkpoint_every=2, resume_attempts=2)
    # without checkpointing the preemption propagates at once
    hook = Preempt(0)
    with pytest.raises(SuperstepPreempted):
        ex.run(PageRankProgram(max_iterations=10), fused=fused, fault_hook=hook)
    assert hook.left == 0


def test_frontier_always_refuses_checkpointing(tmp_path):
    ex = GPUExecutor(CSR, device="cpu", frontier="always")
    with pytest.raises(ValueError, match="cannot be combined with checkpointing"):
        ex.run(ShortestPathProgram(seed_index=0), checkpoint_path=str(tmp_path / "c.npz"),
               checkpoint_every=2)
    # under "auto" a checkpointed BFS runs dense (fused) and checkpoints
    auto = GPUExecutor(CSR, device="cpu")
    auto.run(ShortestPathProgram(seed_index=0), checkpoint_path=str(tmp_path / "c.npz"),
             checkpoint_every=2)
    assert auto.last_run_info["path"] == "fused" and os.path.exists(tmp_path / "c.npz")


def test_measured_record_persists_beside_the_checkpoint(tmp_path):
    path = str(tmp_path / "pr.npz")
    ex = GPUExecutor(CSR, strategy="ell", device="cpu")
    ex.run(PageRankProgram(max_iterations=4, tol=0.0), checkpoint_path=path, checkpoint_every=2)
    rec = ref_at.load_measured(path + ".autotune.json")
    assert rec["strategy"] == "ell" and rec["pad_ratio"] == ex.last_run_info["pad_ratio"]
    assert rec["superstep_ms"] > 0 and rec["roofline_by_tier"] is None
    # the next executor's decision is calibrated by it
    nxt = GPUExecutor(CSR, strategy="auto", device="cpu")
    nxt.run(PageRankProgram(max_iterations=2, tol=0.0), checkpoint_path=str(tmp_path / "pr.npz"),
            checkpoint_every=2)
    assert nxt.last_run_info["autotune"]["source"] == "measured+model"
    off = GPUExecutor(CSR, strategy="ell", device="cpu", autotune_persist=False)
    off.run(PageRankProgram(max_iterations=2), checkpoint_path=str(tmp_path / "x.npz"),
            checkpoint_every=2)
    assert not os.path.exists(tmp_path / "x.npz.autotune.json")
