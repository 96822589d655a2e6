"""OLTP->OLAP spillover: compile hot multi-hop traversals to frontier
supersteps over a cached CSR snapshot — the port of
``janusgraph_tpu/olap/spillover.py``.

The OLTP engine walks ``g.V().out().out()...`` row by row through the
property layer while the OLAP engine already executes the same adjacency
math as vectorized frontier expansion over a CSR snapshot. This module is
the planner that routes recurring expensive shapes onto the OLAP executor:

- **Recognition** (:func:`recognize`): a compilable chain is a
  ``V()``/``V(ids)`` start (optionally label-filtered), a sequence of
  ``out/in/both[E]`` hops with edge-label filters (plus mid-chain
  ``has_label`` vertex filters), terminated by ``count``/``dedup``/``id``
  -style reducers. Anything else is an unsupported step and falls back.

- **Promotion policy**: the digest table (``observability/profiler.py``)
  measures per-shape mean cost; a shape is promoted once its measured mean
  wall exceeds ``computer.spillover-min-cost-ms`` over at least
  ``computer.spillover-min-seen`` executions. Promotion is sticky for the
  planner's lifetime (a spilled shape's now-cheap walls must not demote it
  back into the slow path — that would flap).

- **Execution**: the chain compiles to an ``OLAPTraversalProgram`` (one
  typed EdgeChannel per hop, traverser-count state; under the executor's
  default "segsum" strategy each hop is one run of the segment-sum kernel
  on its channel's plan) and runs over a CACHED CSR snapshot on the device
  ``computer.executor`` names (the card for "tpu", the CPU for "cpu"). The
  snapshot is packed once, refreshed from the change capture's records
  (``overlay_since`` + ``materialize``, zero store reads) or, without a
  capture, by ``refresh_csr`` while committed writes stay within
  ``computer.spillover-max-staleness``, and dropped for a repack beyond it
  (counter ``olap.spillover.stale``).

- **Tx-overlay reconciliation** (read-your-writes): the transaction's
  uncommitted adds/deletes are merged into the snapshot BEFORE the run by
  patching the edge multiset (delete tombstoned instances, append added
  edges, extend the vertex set with uncommitted vertices), so spilled
  results are set-equal to the step-by-step walk even mid-transaction.
  Overlays beyond ``computer.spillover-max-overlay`` fall back.

- **Fallback**: an unsupported step, overlay overflow, staleness breach,
  a rung-2 brownout (``check_olap_admission``), count overflow past
  float32 exactness, or an error while recognizing,
  compiling, patching or reducing returns ``None`` to the caller — the
  row-by-row walk continues unchanged — with a ``spillover_fallback``
  flight event and a per-reason counter. Unlike the reference, an error
  of the DEVICE RUN itself (a kernel that failed to build or launch, a
  CUDA error) is not hidden behind the row walk's correct answer: it
  reaches the caller (ROADMAP.md "Deliberate differences").

Hooked from ``GraphTraversal._execute`` (and the ``count()`` terminal) via
:func:`try_spill`; built per graph at open when ``computer.spillover`` is
set (``core/graph.py``). Under a query server whose brownout ladder stands
at rung 2 or above (``server/admission.py`` ``check_olap_admission``) a
promoted shape falls back with reason "brownout" before any snapshot or
launch; every promoted digest joins the process-wide set
(``promoted_digests``) that the server's ``/profile`` and ``/healthz``
read.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from janusgraph_tpu_torch.core import deadline as _deadline
from janusgraph_tpu_torch.core.codecs import Direction
from janusgraph_tpu_torch.core.elements import Edge, LifeCycle, Vertex
from janusgraph_tpu_torch.core.predicates import Contain
from janusgraph_tpu_torch.core.traversal import Traverser
from janusgraph_tpu_torch.exceptions import DeadlineExceededError, QueryError
from janusgraph_tpu_torch.observability import flight_recorder, registry, tracer
from janusgraph_tpu_torch.observability.profiler import (
    digest_table,
    shape_digest,
    traversal_shape,
)
from janusgraph_tpu_torch.olap import delta as _delta_mod
from janusgraph_tpu_torch.olap.computer import executor_device, run_on, visible_cards
from janusgraph_tpu_torch.olap.csr import csr_from_edges, load_csr_snapshot, refresh_csr
from janusgraph_tpu_torch.olap.gpu_executor import GPUExecutor
from janusgraph_tpu_torch.olap.programs.olap_traversal import (
    OLAPTraversalProgram,
    steps_from_spec,
)

#: process-wide promoted-digest set: GET /profile marks table rows whose
#: digest any live planner has promoted, and /healthz lists them
_PROMOTED_LOCK = threading.Lock()
_PROMOTED_GLOBAL: set = set()


def promoted_digests() -> set:
    with _PROMOTED_LOCK:
        return set(_PROMOTED_GLOBAL)


class _SpillRefused(Exception):
    """Internal control flow: this attempt falls back (reason carried)."""
    def __init__(self, reason: str):
        super().__init__(reason)
        self.reason = reason


@dataclass
class SpilloverPlan:
    """One recognized compilable chain."""
    digest: str
    shape: str
    #: [(direction, edge-label names or None, [vertex-label tuples])]
    hops: List[Tuple[str, Optional[Tuple[str, ...]], List[Tuple[str, ...]]]]
    #: explicit V(ids) seeds (None = all vertices)
    seed_ids: Optional[List[int]] = None
    #: folded has_label() conditions on the seed set (AND of tuples)
    seed_labels: List[Tuple[str, ...]] = field(default_factory=list)
    distinct: bool = False
    as_ids: bool = False
    count_step: bool = False
    terminal_count: bool = False


# --------------------------------------------------------------- recognition
def traversal_digest(traversal) -> Tuple[str, str]:
    """(shape, digest) for a traversal BEFORE execution — same
    normalization as GraphTraversal._observe_digest, with the start
    access predicted (ids point-lookup vs full scan; the only accesses a
    compilable chain can resolve to, since property-filtered starts are
    unsupported and fall back before this matters)."""
    plan = {"access": "ids" if traversal._start.ids else "full-scan"}
    shape = traversal_shape(
        [getattr(s, "_label", "step") for s in traversal._steps], plan
    )
    return shape, shape_digest(shape)


def recognize(traversal, terminal=None):
    """(SpilloverPlan, None) for a compilable chain, (None, reason)
    otherwise. Pure inspection — no store reads, no device work."""
    if getattr(traversal.source, "_sack_init", None) is not None:
        return None, "sack"
    start = traversal._start
    seed_ids = None
    if start.ids:
        seed_ids = [
            i.id if isinstance(i, Vertex) else i for i in start.ids
        ]
    seed_labels: List[Tuple[str, ...]] = []
    for key, p in traversal._pre_has:
        if key is not None:
            return None, f"seed-filter:{key}"
        if p.eq_value is not None:
            seed_labels.append((p.eq_value,))
        elif p.predicate is Contain.IN and all(
            isinstance(x, str) for x in (p.condition or ())
        ):
            seed_labels.append(tuple(p.condition))
        else:
            return None, "seed-label-predicate"
    cfg = getattr(traversal.source.graph, "config", None)
    if seed_ids is None and cfg is not None and cfg.get("query.force-index"):
        # the row path REFUSES an unindexed full scan under
        # query.force-index — spilling around the refusal would silently
        # change semantics
        return None, "force-index"
    dir_name = {
        Direction.OUT: "out", Direction.IN: "in", Direction.BOTH: "both",
    }
    hops: List[Tuple] = []
    tail: List[str] = []
    edge_tail = False
    for st in traversal._steps:
        em = getattr(st, "_expand_meta", None)
        sm = getattr(st, "_spill_meta", None)
        if em is not None:
            if tail or edge_tail:
                return None, "expansion-after-reducer"
            if em["sort_range"] is not None:
                return None, "sort-range"
            hops.append((
                dir_name[em["direction"]],
                tuple(em["labels"]) or None,
                [],
            ))
            if not em["to_vertex"]:
                # an edge expansion yields one traverser per edge — the
                # same count as the vertex expansion, so a TRAILING
                # outE/inE/bothE is compilable for counting terminals
                # only (edge objects/ids are not in the count state)
                edge_tail = True
        elif sm is not None:
            kind = sm[0]
            if kind == "hasLabel":
                if tail or edge_tail or not hops:
                    return None, "hasLabel-position"
                hops[-1][2].append(tuple(sm[1]))
            elif kind == "count":
                tail.append("count")
            elif kind in ("dedup", "id"):
                if edge_tail:
                    return None, f"edge-{kind}"
                tail.append(kind)
            else:
                return None, kind
        else:
            return None, getattr(st, "_label", "step")
    if edge_tail and not (
        tail == ["count"] or (not tail and terminal == "count")
    ):
        return None, "edge-expansion-without-count"
    distinct = as_ids = count_step = False
    for k in tail:
        if count_step:
            return None, "step-after-count"
        if k == "dedup":
            distinct = True
        elif k == "id":
            as_ids = True
        else:
            count_step = True
    shape, digest = traversal_digest(traversal)
    return SpilloverPlan(
        digest=digest, shape=shape, hops=hops, seed_ids=seed_ids,
        seed_labels=seed_labels, distinct=distinct, as_ids=as_ids,
        count_step=count_step, terminal_count=(terminal == "count"),
    ), None


# ------------------------------------------------------------- overlay view
def tx_overlay(tx) -> dict:
    """The transaction's uncommitted graph-structure delta, in graph-id
    space: added/deleted edge triples (src vid, dst vid, edge type id),
    uncommitted vertices ({vid: label id}), and removed vids. Property
    mutations are irrelevant to compilable chains (no property filters
    are supported) and are not collected."""
    with tx._lock:
        added_rel = [r for rels in tx._added.values() for r in rels]
        deleted_rel = list(tx._deleted)
        removed = set(tx._removed_vertices)
        new_vertices = {
            vid: tx._new_vertex_labels.get(vid, 0)
            for vid, v in tx._vertex_cache.items()
            if v.is_new and not v.is_removed
        }
    added: List[Tuple[int, int, int]] = []
    seen: set = set()
    for r in added_rel:
        # new edges register under BOTH endpoint vids — dedupe by object
        if isinstance(r, Edge) and not r.is_removed and id(r) not in seen:
            seen.add(id(r))
            added.append((r.out_vertex.id, r.in_vertex.id, r.type_id))
    deleted: List[Tuple[int, int, int]] = []
    seen_ids: set = set()
    for r in deleted_rel:
        if isinstance(r, Edge) and r.id not in seen_ids:
            seen_ids.add(r.id)
            deleted.append((r.out_vertex.id, r.in_vertex.id, r.type_id))
    return {
        "added": added,
        "deleted": deleted,
        "new_vertices": new_vertices,
        "removed": removed,
        "size": len(added) + len(deleted) + len(new_vertices) + len(removed),
    }


def patched_csr(csr, overlay):
    """The snapshot with the tx overlay reconciled in: deleted edge
    INSTANCES removed from the multiset (one per tombstone — parallel
    edges with identical (src, dst, type) are count-equivalent), added
    edges appended, uncommitted vertices extending the vertex set. The
    committed snapshot is returned untouched for an empty overlay."""

    if not overlay["size"]:
        return csr
    vids = csr.vertex_ids
    if overlay["new_vertices"]:
        extra = np.setdiff1d(
            np.fromiter(
                overlay["new_vertices"].keys(), dtype=np.int64,
                count=len(overlay["new_vertices"]),
            ),
            vids,
        )
        vids2 = np.unique(np.concatenate([vids, extra]))
    else:
        vids2 = vids
    # labels aligned to the extended vertex set (seed has_label filters
    # must see uncommitted vertices' labels)
    labels2 = None
    if csr.labels is not None or overlay["new_vertices"]:
        labels2 = np.zeros(len(vids2), dtype=np.int64)
        if csr.labels is not None:
            pos = np.searchsorted(vids2, vids)
            labels2[pos] = csr.labels
        for vid, lid in overlay["new_vertices"].items():
            i = int(np.searchsorted(vids2, vid))
            if i < len(vids2) and vids2[i] == vid:
                labels2[i] = lid

    src_vid = np.repeat(vids, np.diff(csr.out_indptr)).astype(np.int64)
    dst_vid = vids[csr.out_dst].astype(np.int64)
    et = (
        csr.out_edge_type.astype(np.int64)
        if csr.out_edge_type is not None
        else np.zeros(len(src_vid), dtype=np.int64)
    )
    if overlay["deleted"]:
        # multiset subtraction: tokenize (src, dst, type) triples, then
        # drop the first `deleted count` instances of each token
        m = len(src_vid)
        trip = np.stack([src_vid, dst_vid, et], axis=1)
        dtrip = np.asarray(overlay["deleted"], dtype=np.int64).reshape(-1, 3)
        _, inv = np.unique(
            np.concatenate([trip, dtrip]), axis=0, return_inverse=True
        )
        etok, dtok = inv[:m], inv[m:]
        del_counts = np.bincount(dtok, minlength=int(inv.max()) + 1)
        order = np.argsort(etok, kind="stable")
        st = etok[order]
        first = np.searchsorted(st, st, side="left")
        rank = np.arange(m) - first
        keep = np.ones(m, dtype=bool)
        keep[order[rank < del_counts[st]]] = False
        src_vid, dst_vid, et = src_vid[keep], dst_vid[keep], et[keep]
    if overlay["added"]:
        a = np.asarray(overlay["added"], dtype=np.int64).reshape(-1, 3)
        src_vid = np.concatenate([src_vid, a[:, 0]])
        dst_vid = np.concatenate([dst_vid, a[:, 1]])
        et = np.concatenate([et, a[:, 2]])
    n = len(vids2)
    si = np.searchsorted(vids2, src_vid)
    di = np.searchsorted(vids2, dst_vid)
    valid = (
        (si < n) & (di < n)
        & (vids2[np.minimum(si, n - 1)] == src_vid)
        & (vids2[np.minimum(di, n - 1)] == dst_vid)
    )
    patched = csr_from_edges(
        n,
        si[valid].astype(np.int32),
        di[valid].astype(np.int32),
        edge_types=et[valid].astype(np.int32),
    )
    patched.vertex_ids = vids2
    patched.labels = labels2
    return patched


# ----------------------------------------------------------------- planner
class SpilloverPlanner:
    """Per-graph spillover state: cached snapshot + epoch, promotion set,
    and the cached executor (its device packs and channel plans survive
    across spilled queries of the same snapshot)."""

    def __init__(self, graph):
        self.graph = graph
        cfg = graph.config
        self.enabled = bool(cfg.get("computer.spillover"))
        self.min_cost_ms = float(cfg.get("computer.spillover-min-cost-ms"))
        self.min_seen = int(cfg.get("computer.spillover-min-seen"))
        self.min_hops = int(cfg.get("computer.spillover-min-hops"))
        self.max_overlay = int(cfg.get("computer.spillover-max-overlay"))
        self.max_staleness = int(cfg.get("computer.spillover-max-staleness"))
        self._lock = threading.RLock()
        self._csr = None
        self._epoch = -1
        self._ex = None
        self._promoted: Dict[str, dict] = {}

    def close(self) -> None:
        """Drop the snapshot and the cached executor (and its device
        memory); the next spill repacks."""
        with self._lock:
            self._csr = None
            self._epoch = -1
            self._ex = None

    # ------------------------------------------------------------ promotion
    def _check_promotion(self, digest: str, shape: str) -> bool:
        """Sticky promotion against the digest table's measured means.
        Call under the lock."""
        if digest in self._promoted:
            return True
        mean = digest_table.mean_cost_ms(digest)
        if mean is None or mean < self.min_cost_ms:
            return False
        with digest_table._lock:
            entry = digest_table._entries.get(digest)
            seen = entry["count"] if entry else 0
        if seen < self.min_seen:
            return False
        self._promoted[digest] = {
            "shape": shape, "mean_ms_at_promotion": round(mean, 3),
            "seen_at_promotion": seen, "spilled": 0, "fallbacks": 0,
        }
        with _PROMOTED_LOCK:
            _PROMOTED_GLOBAL.add(digest)
        registry.counter("olap.spillover.promotions").inc()
        registry.set_gauge(f"olap.spillover.promoted.{digest}", 1.0)
        registry.set_gauge(
            "olap.spillover.promoted_digests", float(len(self._promoted))
        )
        flight_recorder.record(
            "spillover", action="promoted", digest=digest,
            mean_ms=round(mean, 3), seen=seen,
        )
        return True

    def promotion_snapshot(self) -> dict:
        with self._lock:
            return {d: dict(s) for d, s in self._promoted.items()}

    # ------------------------------------------------------------- snapshot
    def _snapshot(self):
        """The current committed-graph CSR: packed on first use, refreshed
        O(delta) from the change capture's records (zero store reads;
        olap/delta.py) while the pending overlay stays within the
        staleness bound, dropped for repack beyond it. Without a capture
        the whole-row re-derivation of the touched rows (refresh_csr)
        refreshes instead. Call under the lock."""
        backend = self.graph.backend
        if self._csr is None:
            self._csr, self._epoch = load_csr_snapshot(self.graph)
            self._ex = None
            registry.counter("olap.spillover.packs").inc()
            registry.set_gauge("olap.spillover.staleness", 0.0)
            return self._csr
        now = backend.mutation_epoch()
        if now == self._epoch:
            registry.set_gauge("olap.spillover.staleness", 0.0)
            return self._csr
        # the freshness signal (gauge olap.spillover.staleness): the
        # DELTA-OVERLAY LAG — pending captured records when the capture
        # can serve, else distinct touched rows. Both dedupe repeated
        # touches of one row per (tx, row), so a workload hammering the
        # same rows does not inflate staleness one epoch per commit and
        # force spurious full repacks near the bound.
        cap = getattr(self.graph, "change_capture", None)
        lag = cap.depth_since(self._epoch) if cap is not None else None
        if lag is None:
            rows = backend.touched_count_since(self._epoch)
            lag = rows if rows is not None else (now - self._epoch)
        registry.set_gauge("olap.spillover.staleness", float(lag))
        if lag > self.max_staleness:
            # beyond the bound a full repack beats an incremental
            # refresh; THIS query falls back, the next attempt repacks
            registry.counter("olap.spillover.stale").inc()
            self._csr = None
            self._ex = None
            raise _SpillRefused("stale")
        if lag == 0:
            # property-only writes bumped the epoch but changed no
            # structure; the capture append shares the epoch lock, so a
            # zero depth at `now` proves nothing is pending
            self._epoch = now
            registry.set_gauge("olap.spillover.staleness", 0.0)
            return self._csr
        refreshed = None
        if cap is not None:
            got = _delta_mod.overlay_since(self.graph, self._epoch)
            if got is not None:
                ov, upto = got
                registry.set_gauge(
                    "olap.delta.overlay_depth", float(ov.size)
                )
                try:
                    refreshed = (
                        _delta_mod.materialize(
                            self._csr, ov, idm=self.graph.idm,
                        )
                        if ov.size else self._csr,
                        upto if ov.size else now,
                    )
                    registry.counter(
                        "olap.spillover.delta_refreshes"
                    ).inc()
                except ValueError:
                    refreshed = None  # filtered/weighted snapshot
        if refreshed is None:
            refreshed = refresh_csr(self.graph, self._csr, self._epoch)
        self._csr, self._epoch = refreshed
        self._ex = None
        registry.counter("olap.spillover.refreshes").inc()
        registry.set_gauge("olap.spillover.staleness", 0.0)
        return self._csr

    # ------------------------------------------------------------ execution
    def maybe_execute(self, traversal, terminal=None):
        """The planner hook body: None = run the row path. For
        ``terminal="count"`` returns the int count; otherwise the final
        traverser list."""
        steps = traversal._steps
        n_hops = sum(
            1 for s in steps if getattr(s, "_expand_meta", None) is not None
        )
        if n_hops < self.min_hops:
            return None
        plan, reason = recognize(traversal, terminal)
        if plan is None:
            # not compilable: only a PROMOTED shape's refusal is an event
            shape, digest = traversal_digest(traversal)
            with self._lock:
                hot = digest in self._promoted
            if hot:
                return self._fallback(digest, f"unsupported:{reason}")
            return None
        with self._lock:
            if not self._check_promotion(plan.digest, plan.shape):
                return None
        from janusgraph_tpu_torch.exceptions import ServerOverloadedError
        from janusgraph_tpu_torch.server.admission import check_olap_admission

        try:
            check_olap_admission()
        except ServerOverloadedError:
            return self._fallback(plan.digest, "brownout")
        with self._lock:
            t0 = time.perf_counter()
            prep, reason = self._guarded(
                lambda: self._prepare(traversal, plan)
            )
            if reason is not None:
                return self._fallback(plan.digest, reason)
            base, packed_epoch, overlay, csr, program = prep
            # the device run is outside the guard: a kernel that failed to
            # build or launch, or a CUDA error, reaches the caller instead
            # of hiding behind the row walk's correct answer
            with tracer.span(
                "olap.spillover", digest=plan.digest, hops=len(plan.hops),
            ):
                states = self._run_program(
                    csr, program, patched=csr is not base
                )
            done, reason = self._guarded(
                lambda: self._finish(
                    traversal, plan, terminal, t0, packed_epoch, overlay,
                    csr, states,
                )
            )
            if reason is not None:
                return self._fallback(plan.digest, reason)
            return done

    @staticmethod
    def _guarded(fn):
        """(fn(), None), or (None, reason) when ``fn`` refuses or fails:
        a planner defect degrades to the row walk, never fails the query
        (the flight event and counter keep it visible). Semantic refusals
        (traverser budget, expired deadline) are the QUERY's errors — the
        row path would raise the same way — and propagate."""
        try:
            return fn(), None
        except _SpillRefused as e:
            return None, e.reason
        except (QueryError, DeadlineExceededError):
            raise
        except Exception as e:  # noqa: BLE001 - the fallback is the contract
            return None, f"error:{type(e).__name__}: {e}"[:200]

    def _prepare(self, traversal, plan: SpilloverPlan):
        """(base snapshot, its epoch, tx overlay, patched CSR, program).
        Call under the lock."""
        _deadline.check("spillover compile")
        base = self._snapshot()
        packed_epoch = self._epoch
        overlay = tx_overlay(traversal.tx)
        if overlay["size"] > self.max_overlay:
            raise _SpillRefused("overlay-overflow")
        csr = patched_csr(base, overlay)
        program = self._compile(plan, csr, overlay)
        _deadline.check("spillover run")
        return base, packed_epoch, overlay, csr, program

    def _finish(self, traversal, plan: SpilloverPlan, terminal, t0,
                packed_epoch, overlay, csr, states):
        """Reduce the run's counts into the chain's output and record the
        spilled execution. Call under the lock."""
        counts = np.asarray(states["count"], dtype=np.float64)
        if counts.size and counts.max() >= float(1 << 24):
            # per-vertex traverser counts ride float32 on device — exact
            # only below 2^24; past it the row walk is the honest answer
            raise _SpillRefused("count-overflow")
        result, total = self._reduce(traversal, plan, csr, counts, terminal)
        wall_ms = (time.perf_counter() - t0) * 1000.0
        # the spilled execution still feeds the digest table (the shape's
        # new, cheap reality) and the ambient span, like the row path
        digest_table.observe(plan.digest, plan.shape, wall_ms)
        cur = tracer.current()
        if cur is not None:
            cur.annotate(digest=plan.digest, spillover=True)
        stats = self._promoted.get(plan.digest)
        if stats is not None:
            stats["spilled"] += 1
        registry.counter("olap.spillover.spilled").inc()
        registry.counter(f"olap.spillover.spilled.{plan.digest}").inc()
        block = {
            "digest": plan.digest,
            "shape": plan.shape,
            "hops": len(plan.hops),
            "reducer": self._reducer_name(plan, terminal),
            "overlay": {
                "added": len(overlay["added"]),
                "deleted": len(overlay["deleted"]),
                "new_vertices": len(overlay["new_vertices"]),
                "removed": len(overlay["removed"]),
            },
            "snapshot_epoch": packed_epoch,
            "wall_ms": round(wall_ms, 3),
            "result_total": total,
            "fallback": None,
        }
        olap_run = registry.last_run("olap") or {}
        run_info = {
            "spillover": block,
            "executor": olap_run.get("path"),
            "supersteps": olap_run.get("supersteps"),
        }
        registry.record_run("olap.spillover", run_info)
        flight_recorder.record(
            "spillover", action="spilled", digest=plan.digest,
            hops=len(plan.hops), overlay=overlay["size"],
            wall_ms=round(wall_ms, 3), total=total,
        )
        return result

    def _reducer_name(self, plan: SpilloverPlan, terminal) -> str:
        parts = []
        if plan.distinct:
            parts.append("dedup")
        if plan.as_ids:
            parts.append("id")
        if plan.count_step or terminal == "count":
            parts.append("count")
        return ">".join(parts) if parts else "vertices"

    def _compile(self, plan: SpilloverPlan, csr, overlay):
        spec = [(d, list(labels) if labels else None) for d, labels, _ in plan.hops]
        try:
            steps = steps_from_spec(self.graph, spec)
        except ValueError:
            # an edge label the schema has never seen matches nothing on
            # the row path — keep that semantics there
            raise _SpillRefused("unknown-edge-label")
        n = csr.num_vertices
        seed_mask = None
        if plan.seed_ids is not None:
            seed_mask = np.zeros(n, dtype=np.float32)
            for vid in plan.seed_ids:
                i = int(np.searchsorted(csr.vertex_ids, vid))
                if i < n and csr.vertex_ids[i] == vid and (
                    vid not in overlay["removed"]
                ):
                    # V(1, 1) seeds two traversers: the mask carries
                    # MULTIPLICITY, not membership
                    seed_mask[i] += 1.0
        if plan.seed_labels:
            lm = self._label_mask(csr, plan.seed_labels)
            seed_mask = lm if seed_mask is None else seed_mask * lm
        if overlay["removed"]:
            rm = np.asarray(sorted(overlay["removed"]), dtype=np.int64)
            pos = np.searchsorted(csr.vertex_ids, rm)
            ok = (pos < n) & (csr.vertex_ids[np.minimum(pos, n - 1)] == rm)
            if seed_mask is None:
                seed_mask = np.ones(n, dtype=np.float32)
            seed_mask[pos[ok]] = 0.0
        step_masks = None
        if any(vlabels for _, _, vlabels in plan.hops):
            cols = [
                self._label_mask(csr, vlabels)
                if vlabels
                else np.ones(n, dtype=np.float32)
                for _, _, vlabels in plan.hops
            ]
            step_masks = np.stack(cols, axis=1)
        return OLAPTraversalProgram(
            steps, seed_mask=seed_mask, step_masks=step_masks
        )

    def _label_mask(self, csr, label_groups):
        """AND over has_label() groups: each group is an OR of vertex
        label NAMES (unknown names match nothing, like the row filter)."""
        n = csr.num_vertices
        if csr.labels is None:
            raise _SpillRefused("no-label-column")
        mask = np.ones(n, dtype=np.float32)
        for group in label_groups:
            ids = []
            for name in group:
                el = self.graph.schema_cache.get_by_name(name)
                if el is not None:
                    ids.append(el.id)
            m = (
                np.isin(csr.labels, np.asarray(ids, dtype=np.int64))
                if ids
                else np.zeros(n, dtype=bool)
            )
            mask *= m.astype(np.float32)
        return mask

    def _run_program(self, csr, program, patched: bool):
        """Run on the device ``computer.executor`` names, as
        ``graph.compute()`` maps it (``executor_device``). The executor
        is CACHED per snapshot so its device packs and channel plans
        survive across spilled queries; a patched-snapshot run uses a
        throwaway executor (the patch is per transaction). As in the
        reference, "sharded" (named, or routed from "tpu" under
        ``computer.sharded-auto`` when more than one card is visible) runs
        the sharded executor over the default mesh."""
        cfg = self.graph.config
        executor = cfg.get("computer.executor")
        if (
            executor == "tpu" and cfg.get("computer.sharded-auto") and visible_cards() > 1
            and getattr(program, "sharded_compatible", True)
        ):
            executor = "sharded"
        if executor == "sharded":
            return run_on(
                csr, program, executor="sharded", exchange=cfg.get("computer.exchange"),
                agg=cfg.get("computer.agg"),
                frontier_tier_growth=cfg.get("computer.frontier-tier-growth"),
            )
        device = executor_device(executor)
        if patched:
            return GPUExecutor(csr, device=device).run(program)
        if self._ex is None or self._ex.csr is not csr or self._ex.device != device:
            self._ex = GPUExecutor(csr, device=device)
        return self._ex.run(program)

    def _reduce(self, traversal, plan: SpilloverPlan, csr, counts, terminal):
        """Fold the per-vertex traverser counts into the chain's output:
        (result, total). ``result`` is an int for the count() terminal,
        else the final traverser list."""
        if plan.distinct:
            mult = (counts > 0).astype(np.int64)
        else:
            mult = np.rint(counts).astype(np.int64)
        total = int(mult.sum())
        if plan.count_step:
            # count as a STEP yields one int traverser; the count()
            # TERMINAL over it is its len (= 1), like the row path
            if terminal == "count":
                return 1, total
            return [Traverser(total)], total
        if terminal == "count":
            return total, total
        cap = getattr(self.graph, "_max_traversers", 0)
        if cap and total > cap:
            # the row walk would have refused this frontier size — the
            # spilled path must not bypass the budget on MATERIALIZED
            # output (count terminals never materialize)
            raise QueryError(
                f"traverser count {total} exceeds query.max-traversers "
                f"({cap}) in spilled traversal"
            )
        idxs = np.nonzero(mult)[0]
        out: List[Traverser] = []
        if plan.as_ids:
            for i in idxs:
                vid = int(csr.vertex_ids[i])
                out.extend(Traverser(vid) for _ in range(int(mult[i])))
            return out, total
        tx = traversal.tx
        for i in idxs:
            v = _vertex_handle(tx, int(csr.vertex_ids[i]))
            if v is None:
                continue
            out.extend(Traverser(v) for _ in range(int(mult[i])))
        return out, total

    # ------------------------------------------------------------- fallback
    def _fallback(self, digest: str, reason: str):
        registry.counter("olap.spillover.fallback").inc()
        head = reason.split(":", 1)[0]
        # head is the fixed refusal-reason vocabulary (unsupported,
        # overlay-overflow, stale, count-overflow, error, ...)
        registry.counter(f"olap.spillover.fallback.{head}").inc()
        with self._lock:
            stats = self._promoted.get(digest)
            if stats is not None:
                stats["fallbacks"] += 1
        flight_recorder.record(
            "spillover_fallback", digest=digest, reason=reason,
        )
        registry.record_run("olap.spillover", {
            "spillover": {"digest": digest, "fallback": reason},
        })
        return None


def _vertex_handle(tx, vid: int):
    """A Vertex handle for a vid the snapshot (or tx overlay) proved
    alive — tx.get_vertex minus the per-vid existence read, sharing the
    tx vertex cache so spilled results alias the row path's handles."""
    with tx._lock:
        v = tx._vertex_cache.get(vid)
        if v is not None:
            return None if v.is_removed else v
        if vid in tx._removed_vertices:
            return None
        v = Vertex(vid, tx, LifeCycle.LOADED)
        tx._vertex_cache[vid] = v
    return v


# ------------------------------------------------------------------ the hook
def try_spill(traversal, terminal=None):
    """GraphTraversal's planner hook: spilled result, or None to run the
    row-by-row path. Raises no planner-internal error (the fallback is the
    contract) but does raise an error of the device run; QueryError from
    budget enforcement propagates like the row path's own."""
    source = getattr(traversal, "source", None)
    graph = getattr(source, "graph", None) if source is not None else None
    planner = getattr(graph, "spillover_planner", None)
    if planner is None or not planner.enabled:
        return None
    start = traversal._start
    if start is None or type(start).__name__ != "_start_vertices":
        return None
    return planner.maybe_execute(traversal, terminal)
