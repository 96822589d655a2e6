"""The CUDA sorted segment sum's work split, held to the JAX package.

``csrc/segsum.cu`` runs only on the card, so these tests hold what
surrounds it on the CPU: the plan's segment offsets and merge-path
partition (Merrill and Garland, SC '16), and a numpy replay of the kernel's
decomposition (per-CTA walk, per-thread runs, block carries, the fix-up in
CTA order) against ``np.bincount`` in fp64 and the Pallas kernel in
interpret mode at the reference's tolerance (rtol=atol=1e-4,
tests/test_kernels.py). chip_smoke.py holds the kernel itself to its plain
version on the card."""

import functools
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from janusgraph_tpu.olap import kernels as ref
from janusgraph_tpu_torch.native import segment_ids
from janusgraph_tpu_torch.olap import csr_from_edges, rmat_edges
from janusgraph_tpu_torch.olap import kernels as port

TOL = dict(rtol=1e-4, atol=1e-4)
SOURCE = os.path.join(os.path.dirname(port.__file__), os.pardir, "csrc", "segsum.cu")


def _graph500_s8_in_csr():
    n, src, dst = rmat_edges(8, 16, seed=5)
    csr = csr_from_edges(n, src, dst)
    return segment_ids(csr.in_indptr, csr.num_edges).astype(np.int64), n


def _cases():
    rng = np.random.default_rng(12)
    return {
        "no_edges": (np.zeros(0, dtype=np.int64), 70),
        "one_segment_owns_all": (np.full(3000, 2, dtype=np.int64), 5),
        "empty_run_1e5": (np.concatenate([
            np.sort(rng.integers(0, 5, 40)), np.sort(rng.integers(100_005, 100_010, 40)),
        ]), 100_010),
        "unaligned_edge_count": (np.sort(rng.integers(0, 600, 4099)), 600),
        "hub_over_many_ctas": (np.concatenate([
            np.sort(rng.integers(0, 7, 300)), np.full(20_000, 7),
            np.sort(rng.integers(8, 500, 2000)),
        ]), 500),
        "graph500_s8_in_csr": _graph500_s8_in_csr(),
        # a typed channel whose label set matches no edge, over many CTAs
        "no_edges_many_ctas": (np.zeros(0, dtype=np.int64), 9000),
        # the sparse survivors of a label filter: most segments empty
        "label_filter_survivors": (np.sort(rng.choice(9000, 700)), 9000),
    }


CASES = _cases()
ITEMS_PER_CTA = [37, 512, port.SEGSUM_ITEMS_PER_CTA]


def _data(case):
    seg, _n = CASES[case]
    return np.random.default_rng(7).uniform(-1, 1, len(seg)).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _pallas(case):
    seg, n = CASES[case]
    return np.asarray(ref.pallas_sorted_segment_sum(
        jnp.asarray(_data(case)), ref.make_segsum_plan(seg, n), interpret=True
    ))


def _merge_positions(seg_ptr, num_edges):
    """Merge item of each segment end and each edge: end s comes after the
    s ends and the seg_ptr[s + 1] edges before it; edge e after the e edges
    and the ends at or before it."""
    ends = seg_ptr[1:].astype(np.int64)
    end_pos = np.arange(len(ends)) + ends
    edge_pos = np.arange(num_edges) + np.searchsorted(ends, np.arange(num_edges), side="right")
    return end_pos, edge_pos


def replay_kernel(plan, data, threads=port.SEGSUM_THREADS,
                  per_thread=port.SEGSUM_ITEMS_PER_THREAD):
    """csrc/segsum.cu's decomposition in numpy, summing in fp64.

    CTA k walks merge items [d_k, d_k+1); thread t its run of per_thread
    of them, starting where a search over the
    CTA's segment ends puts it. A segment closed by the thread that opened it
    is final; a thread's first close adds the segmented-scan carry of the
    threads before it; the CTA's open run goes to carry[k]. Segment s0 of a
    CTA after the first began before it: the CTA's part goes to head[k], and
    the fix-up writes that segment as its run of carries plus head[k], in
    CTA order. Returns (sums, how often each segment was written)."""
    n, ipc = plan.num_segments, plan.items_per_cta
    assert ipc <= threads * per_thread
    vals_all = np.asarray(data, dtype=np.float64)
    out = np.full(n, np.nan)
    writes = np.zeros(n, dtype=np.int64)
    carry = np.zeros(plan.num_ctas)
    head = np.full(plan.num_ctas, np.nan)
    for k in range(plan.num_ctas):
        s0, s1 = int(plan.seg_start[k]), int(plan.seg_start[k + 1])
        e0, e1 = int(plan.edge_start[k]), int(plan.edge_start[k + 1])
        ns, ne = s1 - s0, e1 - e0
        total = ns + ne
        assert 1 <= total <= ipc
        ends = plan.seg_ptr[s0 + 1 : s1 + 1].astype(np.int64)
        los = np.minimum(np.arange(threads) * per_thread, total)
        starts = np.searchsorted(np.arange(ns) + ends - e0, los, side="left")
        ends, vals = ends.tolist(), vals_all[e0:e1].tolist()
        res = [None] * ns
        keys, runs, firsts = [], [], []
        for t in range(threads):
            lo = int(los[t])
            if lo == total:  # idle threads hold an empty run of segment s1
                break
            i = i0 = int(starts[t])
            j = lo - i
            run, first = 0.0, None
            for _ in range(lo, min(lo + per_thread, total)):
                if i < ns and ends[i] - e0 <= j:  # segment s0 + i ends before edge e0 + j
                    if first is None:
                        first = run
                    else:
                        assert res[i] is None
                        res[i] = run
                    run = 0.0
                    i += 1
                else:
                    run += vals[j]
                    j += 1
            keys.append(s0 + i)
            runs.append(run)
            firsts.append((i0, first))
        inclusive = []
        for t, (key, run) in enumerate(zip(keys, runs)):
            inclusive.append(run + (inclusive[t - 1] if t and keys[t - 1] == key else 0.0))
        for t, (i0, first) in enumerate(firsts):
            if first is not None:
                assert res[i0] is None
                res[i0] = (inclusive[t - 1] if t else 0.0) + first
        assert None not in res and keys[-1] == s1
        if k > 0 and ns > 0:
            head[k], res = res[0], res[1:]
            s0 += 1
        out[s0:s1] = res
        writes[s0:s1] += 1
        carry[k] = inclusive[-1]
    keys = plan.seg_start[1:]
    run = 0.0
    for k in range(plan.num_ctas):
        run += carry[k]
        if k + 1 < plan.num_ctas and keys[k + 1] != keys[k]:
            out[keys[k]] = run + head[k + 1]
            writes[keys[k]] += 1
            run = 0.0
    return out, writes


@pytest.mark.parametrize("items_per_cta", ITEMS_PER_CTA)
@pytest.mark.parametrize("case", sorted(CASES))
def test_partition_covers_every_merge_item_once(case, items_per_cta):
    seg, n = CASES[case]
    m = len(seg)
    plan = port.make_segsum_plan(seg, n, items_per_cta=items_per_cta)
    # the offsets equal those of the segments the reference plan lays out
    rp = ref.make_segsum_plan(seg, n)
    valid = rp.pad_mask == 1
    ref_seg = (np.repeat(rp.out_tile.astype(np.int64), rp.block) * rp.tile + rp.seg_local)[valid]
    ref_seg = ref_seg[np.argsort(rp.gather_idx[valid], kind="stable")]
    assert plan.seg_ptr.dtype == np.int32
    np.testing.assert_array_equal(plan.seg_ptr, np.searchsorted(ref_seg, np.arange(n + 1)))

    ss = plan.seg_start.astype(np.int64)
    es = plan.edge_start.astype(np.int64)
    assert plan.seg_start.dtype == plan.edge_start.dtype == np.int32
    assert plan.num_ctas == -(-(n + m) // items_per_cta) == len(ss) - 1
    assert ss[0] == es[0] == 0 and ss[-1] == n and es[-1] == m
    assert (np.diff(ss) >= 0).all() and (np.diff(es) >= 0).all()
    sizes = np.diff(ss) + np.diff(es)
    assert (sizes >= 1).all() and (sizes <= items_per_cta).all()

    # CTA k owns ends [ss[k], ss[k+1]) and edges [es[k], es[k+1]); their merge
    # items are exactly [d_k, d_k+1), so every item is owned once, in order
    end_pos, edge_pos = _merge_positions(plan.seg_ptr, m)
    assert np.array_equal(np.sort(np.concatenate([end_pos, edge_pos])), np.arange(n + m))
    cta_of_end = np.repeat(np.arange(plan.num_ctas), np.diff(ss))
    cta_of_edge = np.repeat(np.arange(plan.num_ctas), np.diff(es))
    np.testing.assert_array_equal(cta_of_end, end_pos // items_per_cta)
    np.testing.assert_array_equal(cta_of_edge, edge_pos // items_per_cta)

    # the largest CTA span of one segment's items, counted item by item
    if n:
        owner = np.empty(n + m, dtype=np.int64)
        owner[end_pos] = np.arange(n)
        owner[edge_pos] = seg
        spans = [len(np.unique(np.arange(n + m)[owner == s] // items_per_cta)) for s in
                 np.unique(np.concatenate([[0], seg, [n - 1]]))]
        assert plan.max_segment_cta_span() == max(spans)


@pytest.mark.parametrize("items_per_cta", ITEMS_PER_CTA)
@pytest.mark.parametrize("case", sorted(CASES))
def test_kernel_replay_matches_bincount_and_pallas(case, items_per_cta):
    seg, n = CASES[case]
    data = _data(case)
    plan = port.make_segsum_plan(seg, n, items_per_cta=items_per_cta)
    got, writes = replay_kernel(plan, data)
    np.testing.assert_array_equal(writes, np.ones(n, dtype=np.int64))
    want = np.bincount(seg, weights=data.astype(np.float64), minlength=n)
    np.testing.assert_allclose(got, want, **TOL)
    if len(seg):  # the reference's gather of an empty data array fails
        np.testing.assert_allclose(got, _pallas(case), **TOL)
    # the plain version (what a CPU tensor runs) agrees too, whatever the split
    plain = port.sorted_segment_sum(torch.from_numpy(data), plan).numpy()
    np.testing.assert_allclose(plain, want, **TOL)


def test_kernel_replay_with_few_threads_per_cta():
    """Many items per thread: the within-thread closes and the block carries
    both reach hub, empty and ordinary segments."""
    seg, n = CASES["hub_over_many_ctas"]
    data = _data("hub_over_many_ctas")
    plan = port.make_segsum_plan(seg, n, items_per_cta=301)
    got, writes = replay_kernel(plan, data, threads=4, per_thread=77)
    assert (writes == 1).all() and plan.max_segment_cta_span() > 60
    np.testing.assert_allclose(got, np.bincount(seg, weights=data.astype(np.float64), minlength=n), **TOL)


def test_nonfinite_value_stays_in_its_segment():
    """A deliberate difference from the reference, pinned on both sides.

    With data[0] = inf the port's sum is inf in edge 0's segment only; every
    other segment is finite and equals bincount. The reference multiplies
    every plan slot by pad_mask, padded ones included
    (janusgraph_tpu/olap/kernels.py:785): a padded slot gathers data[0],
    inf * 0 is NaN, and the one-hot matmul spreads it over every segment of
    each tile with padding. The port keeps the sum itself: NaN in segments
    that own no non-finite value is an artefact of the TPU's padding, not
    of the segment sum."""
    rng = np.random.default_rng(9)
    n = 2500
    seg = np.sort(rng.integers(0, n, 9000))
    data = rng.uniform(0.1, 1.0, len(seg)).astype(np.float32)
    data[0] = np.inf
    others = np.arange(n) != seg[0]
    want = np.bincount(seg[1:], weights=data[1:].astype(np.float64), minlength=n)

    plan = port.make_segsum_plan(seg, n, items_per_cta=512)
    plain = port.sorted_segment_sum(torch.from_numpy(data), plan).numpy()
    replay, _ = replay_kernel(plan, data)
    for got in (plain, replay):
        assert got[seg[0]] == np.inf
        assert np.isfinite(got[others]).all()
        np.testing.assert_allclose(got[others], want[others], **TOL)

    rp = ref.make_segsum_plan(seg, n)
    pallas = np.asarray(ref.pallas_sorted_segment_sum(jnp.asarray(data), rp, interpret=True))
    counts = np.bincount(seg // rp.tile, minlength=rp.padded_segments // rp.tile)
    padded = counts % rp.block != 0
    assert padded.any()
    for t in np.nonzero(padded)[0]:
        assert np.isnan(pallas[t * rp.tile : (t + 1) * rp.tile]).all()


def _source_code():
    """segsum.cu without its comments."""
    with open(SOURCE) as f:
        text = f.read()
    return re.sub(r"//[^\n]*", "", text)


def test_kernel_source_agrees_with_plan():
    code = _source_code()
    assert int(re.search(r"kThreads = (\d+);", code).group(1)) == port.SEGSUM_THREADS
    per_thread = int(re.search(r"kItemsPerThread = (\d+);", code).group(1))
    assert per_thread == port.SEGSUM_ITEMS_PER_THREAD
    assert "kMaxItemsPerCta = kThreads * kItemsPerThread;" in code
    # no float atomics, and none of the reference plan's per-slot arrays
    for word in ("atomic", "red.", "gather_idx", "pad_mask", "seg_local"):
        assert word not in code, word


def test_plan_bytes_and_limits():
    seg, n = CASES["graph500_s8_in_csr"]
    plan = port.make_segsum_plan(seg, n)
    m = len(seg)
    assert plan.function_bytes() == 4 * (m + 2 * n + 1)
    assert plan.function_bytes() - 4 <= plan.kernel_read_bytes() <= 1.05 * plan.function_bytes()
    arrs = plan.device_arrays("cpu")
    assert set(arrs) == {"seg_ptr", "seg_start", "edge_start"}
    with pytest.raises(ValueError, match="2\\*\\*31"):
        port.make_segsum_plan(np.broadcast_to(np.int64(0), (2**31,)), 1)
    with pytest.raises(ValueError, match="items_per_cta"):
        port.make_segsum_plan(seg, n, items_per_cta=0)
