"""OLAP traversal execution, the TraversalVertexProgram analogue — the port
of ``janusgraph_tpu/olap/programs/olap_traversal.py``.

A restricted Gremlin traversal, a chain of expansion steps each with its
own direction, edge labels and has()-filters, runs as one BSP program:
superstep k aggregates over step k's typed ``EdgeChannel``, and the state is
the per-vertex traverser count, what count() and group-count terminals
need. Under ``strategy="segsum"`` each count step is one launch of the
segment-sum kernel on the channel's plan. ``record_reach`` keeps the
per-step reach masks the host walks back over for path() and select();
``sack`` carries a weight sum or product per traverser through per-column
edge transforms (``[n, 2]``/``[n, 3]`` SUM messages, aggregated through the
channel's ELL pack).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from janusgraph_tpu_torch.olap.csr import channel_edges
from janusgraph_tpu_torch.olap.vertex_program import (
    Combiner,
    EdgeChannel,
    EdgeTransform,
    VertexProgram,
)
from janusgraph_tpu_torch.core.predicates import _CmpPredicate


@dataclass(frozen=True)
class PropertyFilter:
    """A mid-chain has()-filter: keep traversers only on vertices whose
    property satisfies the predicate. Evaluated on the host over the CSR's
    property arrays into an (n,) {0,1} mask that moves to the device once
    (``evaluate_filter_mask``)."""

    key: str
    predicate: object  # a predicate singleton (Cmp, or any evaluate()-er)
    value: object


@dataclass(frozen=True)
class TraversalStep:
    """One expansion: direction out/in/both, optional edge-label ids,
    optional post-expansion property filters (the ``.out().has(...)``
    shape) and an as()-label for select(). Frozen and value-comparable, so
    program cache keys and the executors' channel caches hit across
    instances built from the same spec."""

    direction: str = "out"
    labels: Optional[Tuple[int, ...]] = None
    filters: Tuple[PropertyFilter, ...] = ()
    as_label: Optional[str] = None

    def __post_init__(self):
        if self.direction not in ("out", "in", "both"):
            raise ValueError(f"unknown step direction {self.direction!r}")
        if self.labels is not None:
            object.__setattr__(self, "labels", tuple(self.labels))
        object.__setattr__(self, "filters", tuple(self.filters))


def _parse_filters(filters) -> Tuple[PropertyFilter, ...]:
    out = []
    for f in filters or ():
        if isinstance(f, PropertyFilter):
            out.append(f)
        else:
            key, pred, value = f
            out.append(PropertyFilter(key, pred, value))
    return tuple(out)


def steps_from_spec(graph, spec: Sequence) -> Tuple[TraversalStep, ...]:
    """Build steps from spec items, resolving label NAMES to schema ids
    through ``graph.schema_cache.get_by_name`` (None/empty labels = all).
    Item shapes:
      'out'                                  — expand, all labels
      ('out', ['knows'])                     — expand along labels
      ('out', ['knows'], [(key, pred, v)])   — expand, then has()-filter
      ('out', ['knows'], [...], 'b')         — ... and as('b')-tag the step
    """
    out = []
    for item in spec:
        filters = ()
        as_label = None
        if isinstance(item, str):
            direction, labels = item, None
        elif len(item) == 2:
            direction, labels = item
        elif len(item) == 3:
            direction, labels, filters = item
        else:
            direction, labels, filters, as_label = item
        ids = None
        if labels:
            ids = []
            for name in labels:
                el = graph.schema_cache.get_by_name(name)
                if el is None:
                    # a typo'd label matching nothing would give a
                    # plausible wrong count
                    raise ValueError(f"unknown edge label {name!r}")
                ids.append(el.id)
            ids = tuple(ids)
        out.append(TraversalStep(direction, ids, _parse_filters(filters), as_label))
    return tuple(out)


def evaluate_filter_mask(csr, filters: Sequence[PropertyFilter]) -> np.ndarray:
    """AND-combined (n,) float32 {0,1} mask over the CSR's host property
    arrays. ``Cmp`` predicates on numeric columns vectorize through numpy;
    any other predicate (any object with ``evaluate(value, condition)``)
    is evaluated value by value."""
    n = csr.num_vertices
    mask = np.ones(n, dtype=np.float32)
    for f in filters:
        col = csr.properties.get(f.key)
        if col is None:
            raise ValueError(
                f"property {f.key!r} not loaded in this CSR snapshot — "
                f"pass property_keys={f.key!r} to load_csr"
            )
        m = None
        if isinstance(f.predicate, _CmpPredicate) and np.issubdtype(np.asarray(col).dtype, np.number):
            try:
                with np.errstate(invalid="ignore"):
                    m = f.predicate._fn(np.asarray(col), f.value)
            except TypeError:
                m = None  # a mistyped condition: evaluate() decides
        if m is None:
            m = np.fromiter((f.predicate.evaluate(v, f.value) for v in col), dtype=bool, count=n)
        mask *= m.astype(np.float32)
    return mask


def _column(mat: torch.Tensor, superstep) -> torch.Tensor:
    """Column ``superstep`` of ``mat``, clamped to its range: a view for a
    host step, a clamped ``index_select`` for a device step counter."""
    last = mat.shape[1] - 1
    if isinstance(superstep, torch.Tensor):
        col = torch.clamp(superstep.reshape(1).to(torch.int64), 0, last)
        return torch.index_select(mat, 1, col)[:, 0]
    return mat[:, min(max(int(superstep), 0), last)]


class OLAPTraversalProgram(VertexProgram):
    """Traverser-count BSP over a step chain.

    ``state["count"][v]`` = number of traversers at v after the steps so far
    (exact in float32 up to 2^24 per vertex). Starts from all vertices
    (``g.V()``) or a seed set.

    Terminals on the result:
      total = result["count"].sum()            — g.V().out()...count()
      per-vertex counts                         — group-count by destination
    """

    compute_keys = ("count",)
    combiner = Combiner.SUM
    setup_only_params = ("seed_indices",)

    def __init__(
        self,
        steps: Sequence[TraversalStep],
        seed_indices=None,
        seed_mask=None,
        step_masks=None,
        record_reach: bool = False,
        sack: Optional[str] = None,
        sack_init: Optional[float] = None,
    ):
        """``seed_mask``: (n,) {0,1} array filtering the start set (the
        ``g.V().has(...)`` head). ``step_masks``: (n, S) array, column k the
        post-expansion filter mask of step k (ones where unfiltered); both
        are built by ``build_olap_traversal`` from the steps' filters and
        ride in the state.

        ``record_reach`` records, per superstep, the {0,1} mask of vertices
        holding a traverser: the per-level reach ``enumerate_paths`` walks
        back over. ``sack`` (TinkerPop's ``withSack().sack(op).by(w)``):
        ``state["sack"][v]`` = total sack mass of the traversers at v.
          "sum"  — each hop adds the edge weight per traverser,
                   S'[v] = Σ_{u→v} (S[u] + w·c[u]); message columns
                   [count, sack, count] with transforms (NONE, NONE,
                   MUL_WEIGHT), the third aggregating to Σ w·c
          "mult" — each hop multiplies by the edge weight,
                   S'[v] = Σ S[u]·w; columns [count, sack], (NONE, MUL_WEIGHT)
        """
        self.steps = tuple(steps)
        if not self.steps:
            raise ValueError("at least one traversal step required")
        if step_masks is None and any(st.filters for st in self.steps):
            # running a filter-bearing chain without masks would return
            # unfiltered counts
            raise ValueError(
                "steps carry property filters but no step_masks were "
                "built — construct via build_olap_traversal(graph, csr, "
                "spec) so masks are evaluated against the CSR snapshot"
            )
        self.seed_indices = (
            tuple(int(i) for i in seed_indices) if seed_indices is not None else None
        )
        self._seed_mask = seed_mask
        self._step_masks = step_masks
        self.has_step_masks = step_masks is not None
        self.record_reach = record_reach
        if sack not in (None, "sum", "mult"):
            raise ValueError(f"unknown sack op {sack!r} (sum|mult)")
        self.sack = sack
        self.sack_init = sack_init if sack_init is not None else (0.0 if sack == "sum" else 1.0)
        if sack == "sum":
            self.edge_transform_cols = (
                EdgeTransform.NONE, EdgeTransform.NONE, EdgeTransform.MUL_WEIGHT,
            )
        elif sack == "mult":
            self.edge_transform_cols = (EdgeTransform.NONE, EdgeTransform.MUL_WEIGHT)
        self.max_iterations = len(self.steps)
        # one named channel per step; labels=None channels still carry the
        # step's direction
        self.edge_channels = {
            f"s{i}": EdgeChannel(st.direction, st.labels) for i, st in enumerate(self.steps)
        }

    def channel_for(self, superstep: int) -> str:
        return f"s{min(superstep, len(self.steps) - 1)}"

    def setup(self, graph):
        n = graph.local_num_vertices
        dev = graph.active.device
        if self.seed_indices is None:
            count = torch.ones(n, device=dev) * graph.active
        else:
            idx = torch.arange(n, device=dev) + graph.global_offset
            seeds = torch.as_tensor(self.seed_indices, dtype=torch.int64, device=dev)
            count = torch.isin(idx, seeds).to(torch.float32)
        if self._seed_mask is not None:
            count = count * self._slice_local(self._seed_mask, graph, dev)
        state = {"count": count}
        if self.sack is not None:
            state["sack"] = count * self.sack_init
        if self.has_step_masks:
            state["step_masks"] = self._slice_local(self._step_masks, graph, dev)
        if self.record_reach:
            # column k = the mask after step k (column 0: the seed set)
            ncols = len(self.steps) + 1
            reach = torch.zeros((n, ncols), dtype=count.dtype, device=dev)
            onehot = (torch.arange(ncols, device=dev) == 0).to(count.dtype)
            state["reach"] = reach + (count > 0).to(count.dtype)[:, None] * onehot
        return state, {}

    @staticmethod
    def _slice_local(arr, graph, dev) -> torch.Tensor:
        """A mask's rows [global_offset, + local_num_vertices) as float32 on
        the device, zero-padded where the view pads past the vertex count
        (padding slots never hold traversers: ``active`` zeroes them)."""
        off = graph.global_offset
        n = graph.local_num_vertices
        a = torch.as_tensor(np.asarray(arr, dtype=np.float32), device=dev)
        s = a[off:off + n]
        short = n - s.shape[0]
        if short > 0:
            s = torch.cat([s, s.new_zeros((short,) + tuple(s.shape[1:]))])
        return s

    def message(self, state, superstep, graph):
        if self.sack == "sum":
            # [count, sack, count]: the third column rides MUL_WEIGHT and
            # aggregates to the cross-term Σ w·c
            return torch.stack([state["count"], state["sack"], state["count"]], dim=1)
        if self.sack == "mult":
            return torch.stack([state["count"], state["sack"]], dim=1)
        return state["count"]

    def apply(self, state, aggregated, superstep, memory_in, graph):
        # traversers MOVE: the new count is what arrived; the step's
        # has()-filter mask then zeroes the vertices it rejects
        if self.sack == "sum":
            new = {"count": aggregated[:, 0], "sack": aggregated[:, 1] + aggregated[:, 2]}
        elif self.sack == "mult":
            new = {"count": aggregated[:, 0], "sack": aggregated[:, 1]}
        else:
            new = {"count": aggregated}
        if self.has_step_masks:
            masks = state["step_masks"]
            col = _column(masks, superstep)
            new["count"] = new["count"] * col
            if self.sack is not None:
                # rejected traversers take their sack mass with them
                new["sack"] = new["sack"] * col
            new["step_masks"] = masks
        if self.record_reach:
            # one-hot column write: column superstep + 1 becomes this
            # step's arrival mask
            reach = state["reach"]
            ncols = reach.shape[1]
            if isinstance(superstep, torch.Tensor):
                col1 = torch.clamp(superstep, 0, ncols - 2) + 1
            else:
                col1 = min(max(int(superstep), 0), ncols - 2) + 1
            onehot = (torch.arange(ncols, device=reach.device) == col1).to(reach.dtype)
            arrived = (new["count"] > 0).to(reach.dtype)
            new["reach"] = reach * (1.0 - onehot)[None, :] + arrived[:, None] * onehot[None, :]
        return new, {}

    def terminate(self, memory):
        return False  # a fixed-length chain: max_iterations bounds the run


def build_olap_traversal(
    graph,
    csr,
    spec: Sequence,
    seeds=None,
    seed_filters=None,
    record_reach: bool = False,
    sack: Optional[str] = None,
    sack_init: Optional[float] = None,
) -> OLAPTraversalProgram:
    """Compile a filtered traversal spec against a CSR snapshot:
    ``g.V().has(seed_filters...).out(...).has(...)...`` as one BSP program.
    ``seeds`` are graph vertex ids; filter predicates evaluate on the host
    over ``csr.properties`` into masks (``PropertyFilter``)."""
    steps = steps_from_spec(graph, spec)
    seed_mask = None
    if seed_filters:
        seed_mask = evaluate_filter_mask(csr, _parse_filters(seed_filters))
    step_masks = None
    if any(st.filters for st in steps):
        cols = [
            evaluate_filter_mask(csr, st.filters) if st.filters
            else np.ones(csr.num_vertices, dtype=np.float32)
            for st in steps
        ]
        step_masks = np.stack(cols, axis=1)  # (n, S)
    seed_indices = None
    if seeds is not None:
        seed_indices = [csr.index_of(v) for v in seeds]
    if sack is not None and csr.in_edge_weight is None and csr.out_edge_weight is None:
        # fail fast like TinkerPop's .by('weight') on a missing key
        raise ValueError(
            f"sack={sack!r} folds edge weights but the CSR snapshot "
            "carries none — load with compute().weight(<property key>)"
        )
    return OLAPTraversalProgram(
        steps, seed_indices=seed_indices, seed_mask=seed_mask, step_masks=step_masks,
        record_reach=record_reach, sack=sack, sack_init=sack_init,
    )


def build_path_index(csr, program):
    """The per-step reverse adjacency ``enumerate_paths`` walks: one
    O(E log E) sort per step. Build once per (csr, program) and reuse."""
    n = csr.num_vertices
    rev = []
    for k in range(len(program.steps)):
        src, dst, _w = channel_edges(csr, program.edge_channels[f"s{k}"])
        order = np.argsort(dst, kind="stable")
        indptr = np.zeros(n + 1, dtype=np.int64)
        np.cumsum(np.bincount(dst, minlength=n), out=indptr[1:])
        rev.append((indptr, src[order]))
    return rev


def enumerate_paths(csr, program, states, limit=None, path_index=None):
    """The host half of OLAP path(): lazily enumerate the traverser paths
    of a ``record_reach`` run as tuples of graph vertex ids, seed first.

    The device ran the expansion and recorded per-step reach masks; the
    host walks them backward over each step's edge view. A backward
    neighbour u of v at level k-1 with reach[u, k-1] set lies on a real
    seed-to-v path, so the walk emits exactly the OLTP traverser paths
    (parallel edges give one path per edge). ``path_index`` may be a
    prebuilt ``build_path_index`` or a zero-argument callable returning
    one. Bound the generator with ``limit``: the device's count sum prices
    the enumeration first."""
    reach = np.asarray(states["reach"]) > 0          # (n, S+1)
    S = len(program.steps)
    if callable(path_index):
        path_index = path_index()
    rev = path_index if path_index is not None else build_path_index(csr, program)
    vids = csr.vertex_ids

    def back(v, k):
        if k == 0:
            yield (v,)
            return
        indptr, srcs = rev[k - 1]
        cand = srcs[indptr[v]: indptr[v + 1]]
        # the reached neighbours, in edge order: one vectorized test
        # instead of one per edge
        for u in cand[reach[cand, k - 1]]:
            for prefix in back(int(u), k - 1):
                yield prefix + (v,)

    emitted = 0
    if limit is not None and limit <= 0:
        return
    for v in np.nonzero(reach[:, S])[0]:
        for p in back(int(v), S):
            yield tuple(int(vids[i]) for i in p)
            emitted += 1
            if limit is not None and emitted >= limit:
                return


def select_paths(csr, program, states, names, source_as=None, limit=None, path_index=None):
    """select() over enumerated paths: project the as()-labeled positions
    of each path into a dict. ``source_as`` names position 0 (the head)."""
    positions = {}
    if source_as is not None:
        positions[source_as] = 0
    for i, st in enumerate(program.steps):
        if st.as_label is not None:
            if st.as_label in positions:
                # this projection is single-valued: refuse rather than drop
                # the earlier binding
                raise ValueError(
                    f"duplicate as()-label {st.as_label!r} — give each "
                    "selected step a distinct label"
                )
            positions[st.as_label] = i + 1
    missing = [nm for nm in names if nm not in positions]
    if missing:
        raise ValueError(
            f"select() names {missing} match no as()-labeled step "
            f"(labeled: {sorted(positions)})"
        )
    for p in enumerate_paths(csr, program, states, limit=limit, path_index=path_index):
        yield {nm: p[positions[nm]] for nm in names}


def group_count_by_label(graph, csr, counts) -> Dict[str, float]:
    """Group-count terminal: traverser totals per vertex label (the
    ``groupCount().by(label)`` shape), names resolved through
    ``graph.schema_cache.get_by_id``. A host bincount over the CSR's label
    column."""
    if csr.labels is None:
        raise ValueError("CSR snapshot has no vertex-label column — reload with load_csr")
    counts = np.asarray(counts, dtype=np.float64)
    labels = np.asarray(csr.labels)
    out: Dict[str, float] = {}
    for lbl in np.unique(labels):
        total = float(counts[labels == lbl].sum())
        if total == 0.0:
            continue
        el = graph.schema_cache.get_by_id(int(lbl))
        out[el.name if el is not None else str(int(lbl))] = total
    return out
