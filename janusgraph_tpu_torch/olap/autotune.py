"""Autotuner: pick the aggregation layout and the frontier tier ladders
from a graph's degree statistics and the device's peaks — the port of
``janusgraph_tpu/olap/autotune.py`` (``GraphStats``, ``AutotuneDecision``,
``decide``, ``decide_tiers``, ``pick_tier``, ``save_measured``,
``load_measured``, ``DeltaDecision``, ``decide_delta``).

``decide()`` is a pure function of (GraphStats, device_kind, overrides,
measured): the same inputs give the same decision. For the CPU and every
TPU kind it returns the reference's decision field for field. The port adds
a "gpu" device class (kinds that match a GPU row of the peak table, the
H100), priced with constants measured on the card by ``chip_smoke.py``.

Not ported yet (ROADMAP.md): ``decide_sharded`` (multi-GPU).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

import numpy as np

from janusgraph_tpu_torch.observability import profiler
from janusgraph_tpu_torch.olap.features.kernels import (  # noqa: F401 (re-exported)
    FEATURE_TIERS,
    pick_feature_tier,
)


def _next_pow2(v: int) -> int:
    return 1 << max(0, int(v) - 1).bit_length() if v > 1 else 1


#: pow2 hub-cutoff candidates the model searches
CUTOFF_CANDIDATES = tuple(1 << k for k in range(3, 11))  # 8 .. 1024

@dataclass(frozen=True)
class GraphStats:
    """Degree-distribution summary the tuner decides from, computed in one
    numpy pass so ``decide()`` itself is plain arithmetic."""

    num_vertices: int
    num_edges: int          # per packed orientation (2x |E| when undirected)
    weighted: bool
    max_degree: int
    mean_degree: float
    #: log2-bucket in-degree histogram: hist[k] = #vertices with
    #: 2^(k-1) < deg <= 2^k (hist[0] = deg 0 plus deg 1)
    degree_hist: Tuple[int, ...]
    #: pure-ELL slot count (pow2 bucket rounding, supernode row-split)
    ell_slots: int
    #: candidate hub cutoff -> (cutoff, hybrid gathered slots, hub count,
    #: torso bucket count, tail chunk rows): the HybridPack footprint
    hybrid_by_cutoff: Tuple[Tuple[int, int, int, int, int], ...]

    @classmethod
    def from_degrees(
        cls, deg: np.ndarray, num_edges: int, weighted: bool,
        max_capacity: int = 1 << 14, tail_chunk: int = 256,
    ) -> "GraphStats":
        deg = np.asarray(deg, dtype=np.int64)
        n = len(deg)
        maxd = int(deg.max()) if n else 0
        caps = np.maximum(
            1, 1 << np.ceil(np.log2(np.maximum(deg, 1))).astype(np.int64)
        )
        capped = np.minimum(caps, max_capacity)
        ell_slots = int(capped.sum())
        over = deg > max_capacity
        if over.any():
            ell_slots += int((deg[over] - max_capacity).sum())
        hist_bins = np.zeros(36, dtype=np.int64)
        if n:
            k = np.ceil(np.log2(np.maximum(deg, 1))).astype(np.int64)
            np.add.at(hist_bins, np.minimum(k, 35), 1)
        hyb = []
        for cutoff in CUTOFF_CANDIDATES:
            torso = (deg >= 1) & (deg <= cutoff)
            hub = deg > cutoff
            t = min(tail_chunk, _next_pow2(cutoff + 1), max_capacity)
            chunk_rows = int((-(-deg[hub] // t)).sum())
            slots = int(deg[torso].sum()) + chunk_rows * t
            torso_buckets = int(len(np.unique(deg[torso]))) if torso.any() else 0
            hyb.append((cutoff, slots, int(hub.sum()), torso_buckets, chunk_rows))
        return cls(
            num_vertices=n,
            num_edges=int(num_edges),
            weighted=bool(weighted),
            max_degree=maxd,
            mean_degree=float(num_edges) / n if n else 0.0,
            degree_hist=tuple(int(x) for x in np.trim_zeros(hist_bins, "b")),
            ell_slots=ell_slots,
            hybrid_by_cutoff=tuple(hyb),
        )

    @classmethod
    def from_csr(cls, csr, undirected: bool = False, **kw) -> "GraphStats":
        deg = np.diff(csr.in_indptr).astype(np.int64)
        edges = csr.num_edges
        if undirected:
            deg = deg + np.diff(csr.out_indptr).astype(np.int64)
            edges *= 2
        return cls.from_degrees(
            deg, edges, weighted=csr.in_edge_weight is not None, **kw
        )


@dataclass(frozen=True)
class AutotuneDecision:
    """One tuning decision. ``as_dict()`` is the record stored in
    ``last_run_info["autotune"]``, the same shape as the reference's."""

    strategy: str                     # ell | hybrid | segment (or forced)
    hub_cutoff: Optional[int]         # hybrid only
    tail_chunk: Optional[int]         # hybrid only
    pad_ratio_est: float              # chosen layout's modeled pad ratio
    f_schedule: Tuple[int, ...]       # frontier F_cap ladder (pow2, asc)
    e_schedule: Tuple[int, ...]       # frontier E_cap ladder (pow2, asc)
    device_kind: str
    source: str                       # model | config | measured+model
    modeled_ms: Dict[str, float] = field(default_factory=dict)
    feature_dim: int = 0
    feature_tier: Optional[int] = None

    def as_dict(self) -> dict:
        return {
            "strategy": self.strategy,
            "hub_cutoff": self.hub_cutoff,
            "tail_chunk": self.tail_chunk,
            "pad_ratio_est": round(self.pad_ratio_est, 4),
            "f_schedule": list(self.f_schedule),
            "e_schedule": list(self.e_schedule),
            "device_kind": self.device_kind,
            "source": self.source,
            "feature_dim": self.feature_dim,
            "feature_tier": self.feature_tier,
            "modeled_ms": {
                k: round(v, 4) for k, v in sorted(self.modeled_ms.items())
            },
        }


def device_class(device_kind: Optional[str]) -> str:
    """"tpu", "gpu" (a kind that matches a GPU row of the peak table) or
    "cpu" (everything else, as in the reference)."""
    kind = (device_kind or "").lower()
    if "tpu" in kind:
        return "tpu"
    if any(sub in kind for sub in profiler.GPU_ROWS):
        return "gpu"
    return "cpu"


#: bytes gathered per slot: idx i32; weighted packs add weight+valid f32
def _bytes_per_slot(weighted: bool) -> int:
    return 12 if weighted else 4


# The "gpu" constants below are fitted by chip_smoke.py's `autotune` phase
# to PageRank-shaped SUM aggregates at graph500 scale 20, each captured in
# a CUDA graph and replayed as the fused loop runs it: directed ELL 0.4541
# ms, hybrid at cutoffs 16, 64 and 1024 0.6838, 1.4915 and 7.9500 ms;
# undirected ELL 0.6684 ms, hybrid at cutoffs 8 and 64 0.7310 and 1.7026
# ms; the directed segment aggregate 0.5378 ms (on an NVIDIA H100 80GB
# HBM3 at its 700.00 W limit). A non-negative least-squares fit of slots,
# buckets and tail chunk rows: a replayed aggregate costs mostly its
# launches, some 21 us a bucket. The cpu/tpu values are the reference's.

#: fixed cost per bucket of a packed layout. cpu/tpu: the reference's
#: 2e-7 (XLA fuses the per-bucket gathers); gpu: the fit
_BUCKET_OVERHEAD_S = {"cpu": 2e-7, "tpu": 2e-7, "gpu": 2.082e-5}

#: cost per hybrid tail chunk row (partial-table scatter + fold slot)
_TAIL_CHUNK_COST_S = {"cpu": 7.5e-8, "tpu": 3e-8, "gpu": 8.687e-11}

#: per-gathered-slot cost of the packed aggregation (the gather wall)
_GATHER_COST_S = {"cpu": 3.3e-9, "tpu": 7e-9, "gpu": 4.780e-12}

#: segment-reduce derating against the packed gather; gpu: what makes the
#: model give the measured segment aggregate
_SEGMENT_PENALTY = {"tpu": 8.0, "cpu": 2.5, "gpu": 6.447}


def tail_buckets(degree_hist: Tuple[int, ...], cutoff: int, max_log2: int = 14) -> int:
    """Buckets of a hybrid pack's tail: one per pow2 capacity among the
    degrees above ``cutoff`` (a power of two), those past the largest
    capacity in one."""
    k0 = int(cutoff).bit_length() - 1
    return len({min(k, max_log2) for k, c in enumerate(degree_hist) if c and k > k0})


def _modeled_seconds(
    slots: int, n: int, weighted: bool, buckets: int, peaks: dict,
    penalty: float = 1.0, eff_bw: Optional[float] = None,
    chunk_rows: int = 0, kind: str = "cpu", cols: int = 1,
) -> float:
    """Roofline time model for one superstep of a packed aggregation:
    max(bytes at peak-or-measured bandwidth, slots through the gather wall),
    plus the flops, a cost per bucket and the tail's cost per chunk row.
    ``cols`` is the message width."""
    cols = max(1, int(cols))
    bw = eff_bw or peaks["peak_bytes_per_s"]
    byts = slots * _bytes_per_slot(weighted) + 4.0 * slots * cols + (
        8.0 * n * cols
    )
    t = max(
        penalty * byts / max(bw, 1.0),
        penalty * slots * _GATHER_COST_S[kind],
    )
    t += slots * cols / max(peaks["peak_flops"], 1.0)
    t += buckets * _BUCKET_OVERHEAD_S[kind]
    t += chunk_rows * cols * _TAIL_CHUNK_COST_S[kind]
    return t


def decide(
    stats: GraphStats,
    device_kind: str,
    overrides: Optional[dict] = None,
    measured: Optional[dict] = None,
    feature_dim: int = 0,
) -> AutotuneDecision:
    """Pick (strategy, hub cutoff, tail chunk, tier schedules) for one
    graph and device; a pure function of its arguments.

    overrides: strategy (forces it, source "config"), hub_cutoff,
    tail_chunk (default 256), min_gain (hybrid must beat ELL's modeled time
    by this fraction, default 0.05), budget_bytes (packed-layout budget,
    default 6 GiB), max_pad (default 3.0), f_min/e_min, max_tiers,
    tier_growth (frontier ladders). measured: a prior run's ``pad_ratio`` +
    ``superstep_ms`` calibrate the effective bandwidth (source
    "measured+model"); its ``roofline_by_tier`` prunes dead frontier tiers.
    feature_dim: the padded lane tier scales the modeled message traffic."""
    ov = dict(overrides or {})
    peaks = profiler.device_peaks(device_kind)
    kind = device_class(device_kind)
    # the reference prices ell and segment at the cpu constants on every
    # kind (only hybrid passes its kind); kept for tpu so decisions stay
    # equal to the reference's, while the gpu class prices all three alike
    flat_kind = "gpu" if kind == "gpu" else "cpu"
    budget = int(ov.get("budget_bytes") or (6 << 30))
    max_pad = float(ov.get("max_pad") or 3.0)
    min_gain = float(ov.get("min_gain") if ov.get("min_gain") is not None
                     else 0.05)
    tail_chunk = int(ov.get("tail_chunk") or 256)
    feature_dim = int(feature_dim or 0)
    feature_tier = None
    cols = 1
    if feature_dim:
        feature_tier = pick_feature_tier(feature_dim)
        cols = feature_tier

    n, m = stats.num_vertices, stats.num_edges
    bps = _bytes_per_slot(stats.weighted)

    eff_bw = None
    source = "model"
    if measured and measured.get("superstep_ms") and measured.get("pad_ratio"):
        meas_slots = float(measured["pad_ratio"]) * m
        meas_bytes = meas_slots * bps + 4.0 * meas_slots * cols + (
            8.0 * n * cols
        )
        eff_bw = meas_bytes / (float(measured["superstep_ms"]) / 1e3)
        source = "measured+model"

    modeled: Dict[str, float] = {}
    modeled["segment"] = _modeled_seconds(
        m, n, stats.weighted, 1, peaks,
        penalty=_SEGMENT_PENALTY[kind], eff_bw=eff_bw, cols=cols,
        kind=flat_kind,
    )
    ell_buckets = max(1, len(stats.degree_hist))
    ell_pad = stats.ell_slots / max(1, m)
    modeled["ell"] = _modeled_seconds(
        stats.ell_slots, n, stats.weighted, ell_buckets, peaks,
        eff_bw=eff_bw, cols=cols, kind=flat_kind,
    )

    forced_cutoff = int(ov.get("hub_cutoff") or 0) or None
    best = None  # (modeled_s, cutoff, slots)
    for cutoff, slots, hubs, torso_buckets, chunk_rows in stats.hybrid_by_cutoff:
        if forced_cutoff is not None and cutoff != forced_cutoff:
            continue
        # the reference prices the whole tail as one bucket; on the card
        # each of its buckets is launches of its own
        tail = tail_buckets(stats.degree_hist, cutoff) if kind == "gpu" else (1 if hubs else 0)
        t = _modeled_seconds(
            slots, n, stats.weighted, torso_buckets + tail, peaks, eff_bw=eff_bw,
            chunk_rows=chunk_rows, kind=kind, cols=cols,
        )
        if best is None or t < best[0]:
            best = (t, cutoff, slots)
    if best is not None:
        modeled["hybrid"] = best[0]
        hyb_cutoff, hyb_slots = best[1], best[2]
        hyb_pad = hyb_slots / max(1, m)
    else:
        hyb_cutoff, hyb_slots, hyb_pad = None, stats.ell_slots, ell_pad

    forced = ov.get("strategy")
    if forced and forced not in ("auto",):
        strategy, source = forced, "config"
    else:
        strategy = "ell"
        if "hybrid" in modeled and modeled["hybrid"] < modeled["ell"] * (
            1.0 - min_gain
        ):
            strategy = "hybrid"
        chosen_slots = hyb_slots if strategy == "hybrid" else stats.ell_slots
        chosen_pad = hyb_pad if strategy == "hybrid" else ell_pad
        if chosen_slots * bps > budget or chosen_pad > max_pad:
            strategy = "segment"

    # "segsum" is the port's name for the reference's "pallas": no padding
    pad_est = {
        "ell": ell_pad, "hybrid": hyb_pad, "segment": 1.0, "pallas": 1.0,
        "segsum": 1.0,
    }.get(strategy, ell_pad)

    f_sched, e_sched = decide_tiers(stats, ov, measured)
    return AutotuneDecision(
        strategy=strategy,
        hub_cutoff=hyb_cutoff if strategy == "hybrid" else None,
        tail_chunk=(
            min(tail_chunk, _next_pow2((hyb_cutoff or 0) + 1))
            if strategy == "hybrid" and hyb_cutoff
            else (tail_chunk if strategy == "hybrid" else None)
        ),
        pad_ratio_est=float(pad_est),
        f_schedule=f_sched,
        e_schedule=e_sched,
        device_kind=device_kind or "cpu",
        source=source,
        feature_dim=feature_dim,
        feature_tier=feature_tier,
        modeled_ms={k: v * 1e3 for k, v in modeled.items()},
    )


@dataclass(frozen=True)
class DeltaDecision:
    """At what overlay depth folding the overlay back into the base pack
    (``olap/delta.materialize``) beats carrying the fused lanes through
    every superstep."""

    compact_threshold: int
    device_kind: str
    source: str                      # model | config
    cells: Dict[str, float] = field(default_factory=dict)

    def as_dict(self) -> dict:
        return {
            "compact_threshold": self.compact_threshold,
            "device_kind": self.device_kind,
            "source": self.source,
            "cells": {k: round(v, 9) for k, v in sorted(self.cells.items())},
        }


# The "gpu" delta constants are measured by chip_smoke.py's `delta` phase
# at graph500 scale 20 with the reference bench's burst (0.5 % of the edges
# added, 256 tombstones, 84,142 overlay records): the PageRank lane merge
# replayed from a CUDA graph, 0.04162 ms a superstep, per record; and
# `materialize`'s 7.058 s of host time on the card's host, per edge (an
# NVIDIA H100 80GB HBM3 at its 700.00 W limit). cpu/tpu are the reference's.
# The materialize figure is numpy time on whatever host the card has, not
# device time. With these two, d_star = 5.3 * E (8 runs of 20 supersteps),
# so every graph above about 12k edges gets the 65,536 cap: on the gpu
# class the threshold is the cap until a caller feeds the decision its own
# run counts.

#: per-record per-superstep cost of the fused delta lanes
_DELTA_LANE_COST_S = {"cpu": 8e-9, "tpu": 5.5e-8, "gpu": 4.946e-10}

#: per-edge cost of the zero-scan materialize (numpy multiset merge + CSR
#: rebuild); the reference's one figure for cpu and tpu
_DELTA_MATERIALIZE_COST_S = {"cpu": 2.5e-8, "tpu": 2.5e-8, "gpu": 4.207e-7}
_REPACK_SCAN_COST_S = 3.5e-7


def decide_delta(
    num_edges: int,
    num_vertices: int,
    device_kind: str = "cpu",
    overrides: Optional[dict] = None,
    expected_runs: int = 8,
) -> DeltaDecision:
    """The overlay depth at which compaction amortizes, a pure function of
    (graph size, device kind, overrides): an overlay of depth d costs about
    d lane cells per superstep per run, folding it one O(E) materialize.
    The threshold solves ``expected_runs * supersteps * d * lane_cost >=
    materialize_cost``, clamped to a pow2 in [1024, 65536].
    ``overrides={"compact_threshold": n}`` wins. For the CPU and TPU kinds
    the decision is the reference's."""
    ov = overrides or {}
    if ov.get("compact_threshold"):
        return DeltaDecision(
            compact_threshold=int(ov["compact_threshold"]),
            device_kind=device_kind, source="config",
        )
    kind = device_class(device_kind)
    supersteps = 20.0  # a PageRank-shaped run's typical iteration count
    lane = _DELTA_LANE_COST_S[kind]
    mat_s = num_edges * _DELTA_MATERIALIZE_COST_S[kind]
    repack_s = num_edges * _REPACK_SCAN_COST_S
    d_star = mat_s / max(expected_runs * supersteps * lane, 1e-12)
    threshold = _next_pow2(int(max(1024, min(d_star, 1 << 16))))
    threshold = min(threshold, 1 << 16)
    return DeltaDecision(
        compact_threshold=threshold,
        device_kind=device_kind,
        source="model",
        cells={
            "materialize_s": mat_s,
            "repack_s": repack_s,
            "lane_cost_per_record_per_step_s": lane,
            "d_star": d_star,
        },
    )


def decide_tiers(
    stats: GraphStats,
    overrides: Optional[dict] = None,
    measured: Optional[dict] = None,
) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
    """(F_cap ladder, E_cap ladder) for the frontier engine: pow2 tiers
    from the floors up to (n, m), with the growth factor chosen per graph so
    the ladder stays within the tier budget. The E floor covers one
    mean-degree expansion of the smallest F tier. With ``measured``, tiers
    whose measured roofline utilization rounds to zero are dropped from the
    middle of the ladder."""
    ov = dict(overrides or {})
    n = max(1, stats.num_vertices)
    m = max(1, stats.num_edges)
    f_min = int(ov.get("f_min") or (1 << 10))
    e_min = int(ov.get("e_min") or (1 << 13))
    max_tiers = int(ov.get("max_tiers") or 8)
    max_growth = int(ov.get("tier_growth") or 16)

    e_floor = max(e_min, _next_pow2(int(f_min * max(stats.mean_degree, 1.0))))
    e_floor = min(e_floor, _next_pow2(m))

    def ladder(lo: int, hi: int) -> Tuple[int, ...]:
        lo = _next_pow2(lo)
        top = hi  # the top tier is the dense fallback, not rounded up
        if lo >= top:
            return (top,)
        growth = 2
        while growth < max_growth:
            count, c = 1, lo
            while c < top:
                c *= growth
                count += 1
            if count <= max_tiers:
                break
            growth *= 2
        tiers, c = [lo], lo
        while c < top:
            c = min(c * growth, top)
            tiers.append(c)
        return tuple(tiers)

    f_sched = ladder(f_min, n)
    e_sched = ladder(e_floor, m)

    if measured:
        by_tier = measured.get("roofline_by_tier") or {}
        dead = {
            int(k) for k, v in by_tier.items()
            if k.isdigit() and (v.get("roofline_utilization") or 0.0) < 1e-4
        }
        if dead:
            kept = tuple(
                t for i, t in enumerate(e_sched)
                if i == 0 or i == len(e_sched) - 1 or t not in dead
            )
            if len(kept) >= 2:
                e_sched = kept
    return f_sched, e_sched


def pick_tier(need: int, schedule: Tuple[int, ...], hi: int) -> int:
    """Smallest scheduled tier >= need (clamped to hi); the top tier is the
    dense fallback, so nothing is ever dropped."""
    for t in schedule:
        if t >= need:
            return min(t, hi)
    return hi


# --------------------------------------------------------------------------
# Measured-record persistence: the reference's v2 file format (records
# keyed by shard count; a v1 file is read as the shard_count=1 record), so
# either package reads the other's file
# --------------------------------------------------------------------------

_MEASURED_VERSION = 2

_RECORD_FIELDS = (
    "strategy", "pad_ratio", "superstep_ms", "roofline_by_tier",
    # per-shard-layout fields (the reference's sharded executor)
    "exchange", "agg", "halo_cap",
)


def _read_measured_records(path: str) -> Optional[dict]:
    """{shard_count(str): record} from a v1 or v2 file; None when missing
    or unreadable."""
    import json
    import os

    if not path or not os.path.exists(path):
        return None
    try:
        with open(path) as f:
            payload = json.load(f)
    except (OSError, ValueError):
        return None
    if not isinstance(payload, dict):
        return None
    if payload.get("version") == 1:
        return {"1": {k: payload.get(k) for k in _RECORD_FIELDS}}
    if payload.get("version") == _MEASURED_VERSION:
        records = payload.get("records")
        return records if isinstance(records, dict) else None
    return None


def save_measured(path: str, record: dict, shard_count: int = 1) -> None:
    """Atomically persist one measured record under its shard-count key
    (tmp + rename), keeping every other layout's record. An I/O error is
    swallowed: persistence must never fail a run."""
    import json
    import os
    import tempfile

    records = _read_measured_records(path) or {}
    records[str(int(shard_count))] = {k: record.get(k) for k in _RECORD_FIELDS}
    payload = {"version": _MEASURED_VERSION, "records": records}
    try:
        d = os.path.dirname(os.path.abspath(path)) or "."
        os.makedirs(d, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=d, suffix=".json.tmp")
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(payload, f)
            os.replace(tmp, path)
        except BaseException:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise
    except OSError:
        return


def load_measured(path: str, shard_count: int = 1) -> Optional[dict]:
    """The persisted record for one shard count; None when missing,
    unreadable, of an unknown version or without the calibration fields."""
    records = _read_measured_records(path)
    if records is None:
        return None
    rec = records.get(str(int(shard_count)))
    if not isinstance(rec, dict):
        return None
    if not rec.get("superstep_ms") or not rec.get("pad_ratio"):
        return None
    return rec
