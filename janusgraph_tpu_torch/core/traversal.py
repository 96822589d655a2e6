"""Gremlin-style fluent traversal DSL — the port of
``janusgraph_tpu/core/traversal.py``.

Capability parity with the reference's OLTP query path: the same step
vocabulary and the same two optimizations the reference registers as
traversal strategies (reference: graphdb/tinkerpop/optimize/strategy/
JanusGraphStepStrategy.java, which folds leading has() chains into the
start step; JanusGraphLocalQueryOptimizerStrategy.java, which batches
vertex expansion through multiQuery prefetch):

- `g.V().has('name', 'x')` folds its has-chain, matches it against the
  registered composite indexes, and starts from an index lookup instead of a
  full scan when every index key is covered by equality conditions (a
  ``within`` folds as a union of at most 64 point lookups); failing that,
  the conditions a mixed index supports are pushed down to its provider.
  ``profile()`` names the plan ("composite-index", "composite-index-union",
  "mixed-index" or "full-scan"); ``query.force-index`` refuses the scan.
- `out()/in_()/both()/outE()/...` prefetch the needed slices for ALL current
  traversers with one batched multi-query before expanding.

Execution model is batch-at-a-time (each step maps a list of traversers to
the next list), which matches both the multi-query optimization and the
batch thinking of the OLAP path. The computer steps (``page_rank``,
``connected_component``, ``peer_pressure``) run their program through
``graph.compute().program(p).submit()`` and ``shortest_path`` through
``run_on`` over ``load_csr``, on the device ``computer.executor`` names
(the CUDA card for "tpu", the CPU for "cpu"). A hot multi-hop chain can
spill to the OLAP engine (``olap/spillover.py``). ``io(path)`` reads or
writes the graph as GraphSON or GraphML through ``graph.io()``
(``core/io.py``).
"""

from __future__ import annotations

import enum
import itertools
from collections import Counter
from typing import Callable, Dict, List, Optional, Tuple

from janusgraph_tpu_torch.core.codecs import Direction
from janusgraph_tpu_torch.core.elements import Edge, Vertex, VertexProperty
from janusgraph_tpu_torch.core.predicates import Cmp, Contain, Geo, Text
from janusgraph_tpu_torch.exceptions import QueryError


class Pick(enum.Enum):
    """TinkerPop branch() option tokens: Pick.none = the default branch
    (runs when no concrete option matched), Pick.any = always runs."""

    none = "none"
    any = "any"


class T(enum.Enum):
    """TinkerPop structure tokens: the map keys that address an element's
    id/label DISTINCTLY from same-named property keys — merge_v/merge_e
    match maps and the Gremlin-text dialect use them (surface reached
    through the reference's TinkerPop dependency: gremlin-core
    structure.T, used by every mergeV example in its docs)."""

    id = "id"
    label = "label"


def _split_merge_map(match: dict):
    """(id, label, {prop: value}) from a merge match map keyed by T tokens
    and property names. Direction keys (merge_e endpoints) are stripped by
    the caller first."""
    vid = match.get(T.id)
    label = match.get(T.label)
    props = {
        k: v for k, v in match.items()
        if not isinstance(k, (T, Direction))
    }
    for k in props:
        if not isinstance(k, str):
            raise QueryError(f"merge map key {k!r} is not a property name")
    return vid, label, props


class P:
    """Predicate (reference vocabulary: core/attribute/Cmp.java, Text.java,
    Geo.java). Carries the structured (predicate, condition) pair so index
    selection can push it down to composite rows or a mixed IndexProvider."""

    def __init__(
        self,
        test: Callable[[object], bool],
        label: str,
        eq_value=None,
        predicate=None,
        condition=None,
    ):
        self.test = test
        self.label = label
        #: set when the predicate is a plain equality — index-foldable
        self.eq_value = eq_value
        #: structured predicate for mixed-index pushdown (None = opaque)
        self.predicate = predicate
        self.condition = condition

    def __repr__(self):
        return f"P.{self.label}"

    @staticmethod
    def _of(pred, v, label) -> "P":
        return P(
            lambda x: pred.evaluate(x, v), label, predicate=pred, condition=v
        )

    @staticmethod
    def eq(v) -> "P":
        return P(
            lambda x: x == v,
            f"eq({v!r})",
            eq_value=v,
            predicate=Cmp.EQUAL,
            condition=v,
        )

    @staticmethod
    def neq(v) -> "P":
        return P(
            lambda x: x != v, f"neq({v!r})", predicate=Cmp.NOT_EQUAL, condition=v
        )

    @staticmethod
    def gt(v) -> "P":
        return P(
            lambda x: x is not None and x > v,
            f"gt({v!r})",
            predicate=Cmp.GREATER_THAN,
            condition=v,
        )

    @staticmethod
    def gte(v) -> "P":
        return P(
            lambda x: x is not None and x >= v,
            f"gte({v!r})",
            predicate=Cmp.GREATER_THAN_EQUAL,
            condition=v,
        )

    @staticmethod
    def lt(v) -> "P":
        return P(
            lambda x: x is not None and x < v,
            f"lt({v!r})",
            predicate=Cmp.LESS_THAN,
            condition=v,
        )

    @staticmethod
    def lte(v) -> "P":
        return P(
            lambda x: x is not None and x <= v,
            f"lte({v!r})",
            predicate=Cmp.LESS_THAN_EQUAL,
            condition=v,
        )

    @staticmethod
    def within(*vs) -> "P":
        vals = tuple(dict.fromkeys(vs))  # deduped, order kept
        s = set(vals)
        return P(
            lambda x: x in s, f"within{tuple(vs)!r}",
            predicate=Contain.IN, condition=vals,
        )

    @staticmethod
    def without(*vs) -> "P":
        s = set(vs)
        vals = tuple(dict.fromkeys(vs))
        return P(
            lambda x: x not in s, f"without{tuple(vs)!r}",
            predicate=Contain.NOT_IN, condition=vals,
        )

    @staticmethod
    def between(lo, hi) -> "P":
        return P(lambda x: x is not None and lo <= x < hi, f"between({lo!r},{hi!r})")

    # ---- full-text predicates (reference: attribute/Text.java) ----
    @staticmethod
    def text_contains(v) -> "P":
        return P._of(Text.CONTAINS, v, f"textContains({v!r})")

    @staticmethod
    def text_contains_prefix(v) -> "P":
        return P._of(Text.CONTAINS_PREFIX, v, f"textContainsPrefix({v!r})")

    @staticmethod
    def text_contains_regex(v) -> "P":
        return P._of(Text.CONTAINS_REGEX, v, f"textContainsRegex({v!r})")

    @staticmethod
    def text_contains_fuzzy(v) -> "P":
        return P._of(Text.CONTAINS_FUZZY, v, f"textContainsFuzzy({v!r})")

    @staticmethod
    def text_contains_phrase(v) -> "P":
        return P._of(Text.CONTAINS_PHRASE, v, f"textContainsPhrase({v!r})")

    @staticmethod
    def text_prefix(v) -> "P":
        return P._of(Text.PREFIX, v, f"textPrefix({v!r})")

    @staticmethod
    def text_regex(v) -> "P":
        return P._of(Text.REGEX, v, f"textRegex({v!r})")

    @staticmethod
    def text_fuzzy(v) -> "P":
        return P._of(Text.FUZZY, v, f"textFuzzy({v!r})")

    # ---- geo predicates (reference: attribute/Geo.java) ----
    @staticmethod
    def geo_intersect(shape) -> "P":
        return P._of(Geo.INTERSECT, shape, f"geoIntersect({shape!r})")

    @staticmethod
    def geo_within(shape) -> "P":
        return P._of(Geo.WITHIN, shape, f"geoWithin({shape!r})")

    @staticmethod
    def geo_disjoint(shape) -> "P":
        return P._of(Geo.DISJOINT, shape, f"geoDisjoint({shape!r})")

    @staticmethod
    def geo_contains(shape) -> "P":
        return P._of(Geo.CONTAINS, shape, f"geoContains({shape!r})")


class Traverser:
    """One unit of traversal state: the current object, the vertex it was
    reached from (needed by otherV), the full path history (for path() /
    simple_path()), and the as_()-tag bindings (for select() / where())
    (reference: TinkerPop traversers carry the same path/labels state; the
    reference reuses them via graphdb/tinkerpop/ glue)."""

    __slots__ = ("obj", "prev", "path", "tags", "sack", "loops")

    def __init__(self, obj, prev=None, path=None, tags=None, sack=None):
        self.obj = obj
        self.prev = prev
        self.path = (obj,) if path is None else path
        self.tags = tags
        #: per-traverser scratch value (TinkerPop sack(); set by
        #: with_sack(), transformed by sack(fn), read by sack())
        self.sack = sack
        #: repeat() loop depth (TinkerPop loops(); stamped by the repeat
        #: loop on every round's survivors, read by the loops() step)
        self.loops = 0

    def child(self, obj, prev=None) -> "Traverser":
        """A traverser one step further along: path extended, tags kept."""
        c = Traverser(
            obj, prev=prev, path=self.path + (obj,), tags=self.tags,
            sack=self.sack,
        )
        c.loops = self.loops  # repeat() depth survives map steps
        return c

    def tagged(self, name: str) -> "Traverser":
        tags = dict(self.tags) if self.tags else {}
        tags[name] = self.obj
        return Traverser(
            self.obj, prev=self.prev, path=self.path, tags=tags,
            sack=self.sack,
        )


class AnonymousTraversal:
    """TinkerPop's `__` analogue: records a step chain and replays it when
    called with a traversal — usable anywhere a lambda body is accepted
    (`t.repeat(__.out('father'), times=2)`), and the ONLY body form the
    Gremlin-text dialect can express (it has no lambdas). Chains
    are immutable; each step returns a new recorder, so shared prefixes are
    safe to reuse."""

    __slots__ = ("_chain",)

    def __init__(self, chain: tuple = ()):
        object.__setattr__(self, "_chain", chain)

    def __getattr__(self, name):
        if name.startswith("_"):
            raise AttributeError(name)
        chain = self._chain

        def add(*args, **kwargs):
            return AnonymousTraversal(chain + ((name, args, kwargs),))

        return add

    def __call__(self, t):
        for name, args, kwargs in self._chain:
            t = getattr(t, name)(*args, **kwargs)
        return t

    def __repr__(self):
        return "__" + "".join(f".{n}(...)" for n, _a, _k in self._chain)


#: the anonymous start: __.out('knows').has('name', ...)
__ = AnonymousTraversal()


class GraphTraversalSource:
    def __init__(self, graph, tx=None):
        self.graph = graph
        self.tx = tx or graph.new_transaction()
        self._sack_init = None

    def with_sack(self, initial) -> "GraphTraversalSource":
        """Seed every traverser with a sack value (TinkerPop withSack();
        a callable is invoked per traverser so mutable sacks don't alias)."""
        src = GraphTraversalSource(self.graph, self.tx)
        src._sack_init = initial if callable(initial) else (lambda: initial)
        return src

    def V(self, *ids) -> "GraphTraversal":
        return GraphTraversal(self, _start_vertices(self, ids))

    def E(self, *ids) -> "GraphTraversal":
        return GraphTraversal(self, _start_edges(self, ids))

    def add_v(self, label: Optional[str] = None, **props) -> Vertex:
        return self.tx.add_vertex(label, **props)

    def add_v_(self, label: Optional[str] = None) -> "GraphTraversal":
        """TinkerPop AddVertexStartStep: ``g.add_v_('person')
        .property('name', 'marko')`` — a TRAVERSAL seeded with a new
        vertex, so property()/add_e_() chains compose (the Gremlin-text
        endpoint maps ``g.addV(...)`` here; the plain add_v returns the
        raw Vertex for direct-API callers). LAZY like the reference: the
        vertex is created per EXECUTION, inside the start step."""
        return GraphTraversal(self, _start_new_vertex(self, label))

    def add_e(self, out_v: Vertex, label: str, in_v: Vertex, **props) -> Edge:
        return self.tx.add_edge(out_v, label, in_v, **props)

    def merge_v(self, match: dict) -> "GraphTraversal":
        """TinkerPop MergeVertexStep (start): ``g.merge_v({T.label: 'person',
        'name': 'marko'}).on_create({'age': 29})`` — emit every vertex
        matching the map (label + property equalities, index-folded like
        V().has()), or create one from the map if none match. on_create()
        extends the creation map; on_match() sets properties on matched
        vertices. The declarative spelling of the
        ``fold().coalesce(unfold(), add_v_())`` upsert idiom.

        Concurrency: like the reference, merge does NOT serialize racing
        upserts by itself — two overlapping transactions can both miss
        and both create. Guard the merge key with a UNIQUE composite
        index (and its consistent-key lock under LOCK consistency): the
        second commit then fails with SchemaViolationError and a retry
        matches."""
        start = _start_merge_vertex(self, dict(match))
        t = GraphTraversal(self, start)
        t._last_merge = start.spec
        return t

    def merge_e(self, match: dict) -> "GraphTraversal":
        """TinkerPop MergeEdgeStep (start): match keys Direction.OUT /
        Direction.IN (Vertex or vertex id), T.label, plus property
        equalities; emits matching edges or creates one. on_create()/
        on_match() as in merge_v."""
        start = _start_merge_edge(self, dict(match))
        t = GraphTraversal(self, start)
        t._last_merge = start.spec
        return t

    def inject(self, *values) -> "GraphTraversal":
        """TinkerPop InjectStep (start): a traversal over the given raw
        values — ``g.inject(1, 2).map_(...)`` shapes."""
        return GraphTraversal(self, _start_inject(self, values))

    def io(self, path: str) -> "_IoStep":
        """TinkerPop IoStep spelling: ``g.io('graph.json').read()`` /
        ``.write()`` — format inferred from the extension (.xml/.graphml
        -> graphml, else graphson), overridable with ``.with_('graphml')``.
        Delegates to graph.io() (core/io.py); read/write execute
        immediately, like iterate()d Io traversals."""
        return _IoStep(self.graph, path)

    def commit(self) -> None:
        self.tx.commit()
        self.tx = self.graph.new_transaction()

    def rollback(self) -> None:
        self.tx.rollback()
        self.tx = self.graph.new_transaction()


class _IoStep:
    """g.io(path).read()/.write() — the TinkerPop IoStep spelling over
    the graph.io() facade."""

    def __init__(self, graph, path: str):
        self._graph = graph
        self._path = path
        lower = path.lower()
        self._format = (
            "graphml" if lower.endswith((".xml", ".graphml")) else "graphson"
        )

    def with_(self, format: str) -> "_IoStep":
        self._format = format
        return self

    def read(self) -> dict:
        return self._graph.io(self._format).read(self._path)

    def write(self) -> dict:
        return self._graph.io(self._format).write(self._path)


# ---------------------------------------------------------------- start steps
class _start_new_vertex:
    """AddVertexStartStep: creates the vertex at run() — a traversal that
    never executes (or fails while being built) must not leave a phantom
    vertex in the transaction, and each execution creates a fresh one."""

    def __init__(self, source: GraphTraversalSource, label):
        self.source = source
        self.label = label
        self.plan = {"access": "addV"}

    def run(self, has_conditions) -> List[Traverser]:
        tx = self.source.tx
        v = tx.add_vertex(self.label)
        return _apply_has([Traverser(v)], has_conditions, tx)


def _merge_find_vertices(source, match) -> List[Vertex]:
    """Vertices matching a merge_v map: T.id short-circuits to a point
    lookup; otherwise label + property equalities run through the normal
    V().has() start so composite-index folding applies."""
    vid, label, props = _split_merge_map(match)
    tx = source.tx
    if vid is not None:
        v = tx.get_vertex(vid.id if isinstance(vid, Vertex) else vid)
        if v is None:
            return []
        if label is not None and v.label != label:
            return []
        for k, want in props.items():
            if want not in [p.value for p in tx.get_properties(v, k)]:
                return []
        return [v]
    # a key the schema has never seen cannot match anything — that is the
    # CREATE path of the upsert, not a query error (so the
    # query.ignore-unknown-index-key strictness does not apply here)
    if any(not _is_property_key(source.graph, k) for k in props):
        return []
    t = GraphTraversal(source, _start_vertices(source, ()))
    if label is not None:
        t = t.has_label(label)
    for k, v in props.items():
        t = t.has(k, v)
    return t.to_list()


def _merge_vertex(source, match, spec) -> List[Vertex]:
    """Find-or-create for merge_v: returns the matched vertices (after
    applying on_match properties) or the one created vertex (from the
    match map merged with the on_create map)."""
    tx = source.tx
    # validate the on_create modulator EAGERLY — before the match runs —
    # so a bad query fails the same way regardless of data state
    vid, label, props = _split_merge_map(match)
    cid, clabel, cprops = _split_merge_map(spec["on_create"])
    if cid is not None:
        raise QueryError("on_create() cannot set T.id")
    if clabel is not None and label is not None and clabel != label:
        raise QueryError("on_create() T.label conflicts with the merge map")
    overlap = set(props) & set(cprops)
    if overlap:
        # TinkerPop rejects onCreate overriding merge-map keys: the created
        # element would not match its own merge map, duplicating on re-run
        raise QueryError(
            f"on_create() cannot override merge-map keys {sorted(overlap)}"
        )
    found = _merge_find_vertices(source, match)
    if found:
        for v in found:
            for k, val in spec["on_match"].items():
                tx.add_property(v, k, val)
        return found
    # a T.id-keyed merge that misses must create WITH that id (TinkerPop
    # contract — anything else duplicates on every re-run); custom ids
    # need graph.set-vertex-id=true, and tx.add_vertex raises if not
    v = tx.add_vertex(
        label or clabel,
        vertex_id=vid.id if isinstance(vid, Vertex) else vid,
        **{**props, **cprops},
    )
    return [v]


def _merge_resolve_endpoint(tx, target, side: str) -> Vertex:
    if isinstance(target, Vertex):
        return target
    v = tx.get_vertex(target)
    if v is None:
        raise QueryError(f"merge_e {side} endpoint {target!r} not found")
    return v


def _merge_edge(source, match, spec, default_v: Optional[Vertex] = None):
    """Find-or-create for merge_e. Endpoints default to `default_v` (the
    incoming vertex in mid-traversal position) when the map omits them;
    on_create may supply endpoints/label the match map lacks."""
    tx = source.tx
    # on_create fills in whatever the match map lacks (endpoints, label);
    # a CONFLICTING on_create label is an error, not a silent override
    eid, label, props = _split_merge_map(match)
    # on_create validation runs BEFORE any lookup so a bad query fails
    # the same way regardless of data state
    cid, clabel, cprops = _split_merge_map(spec["on_create"])
    if cid is not None:
        raise QueryError("on_create() cannot set T.id")
    if clabel is not None and label is not None and clabel != label:
        raise QueryError("on_create() T.label conflicts with the merge map")
    overlap = set(props) & set(cprops)
    if overlap:
        raise QueryError(
            f"on_create() cannot override merge-map keys {sorted(overlap)}"
        )
    if eid is not None:
        # T.id-keyed edge merge: RelationIdentifier point lookup; a miss
        # cannot create (edge ids are not user-assignable), so it is an
        # error rather than a silent duplicate
        try:
            e = tx.get_edge(eid)
        except Exception:
            raise QueryError(
                f"merge_e: T.id must be a RelationIdentifier or its "
                f"string form (got {eid!r})"
            )
        if e is None:
            raise QueryError(
                f"merge_e: no edge with id {eid!r}, and edge ids cannot "
                "be chosen at creation"
            )
        if label is not None and e.label != label:
            return []
        # endpoint constraints in the map must agree with the edge
        for dkey, attr in ((Direction.OUT, "out_vertex"),
                           (Direction.IN, "in_vertex")):
            want = match.get(dkey)
            if want is not None:
                wid = want.id if isinstance(want, Vertex) else want
                if getattr(e, attr).id != wid:
                    return []
        vals = e.property_values()
        if not all(vals.get(k) == want for k, want in props.items()):
            return []
        for k, val in spec["on_match"].items():
            e = e.set_property(k, val)
        return [e]
    merged = {**spec["on_create"], **match}
    out_t = merged.get(Direction.OUT, default_v)
    in_t = merged.get(Direction.IN, default_v)
    if out_t is None or in_t is None:
        raise QueryError(
            "merge_e needs Direction.OUT and Direction.IN endpoints "
            "(from the merge map, on_create(), or an incoming vertex)"
        )
    if label is None and clabel is None:
        raise QueryError("merge_e needs a T.label entry")
    out_v = _merge_resolve_endpoint(tx, out_t, "OUT")
    in_v = _merge_resolve_endpoint(tx, in_t, "IN")
    found = []
    # match on the MATCH map only: no T.label there means any label
    # between the endpoints matches (on_create's label is creation-only)
    for e in tx.get_edges(out_v, Direction.OUT,
                          (label,) if label is not None else ()):
        if e.in_vertex.id != in_v.id:
            continue
        vals = e.property_values()
        if all(vals.get(k) == want for k, want in props.items()):
            found.append(e)
    if found:
        out = []
        for e in found:
            for k, val in spec["on_match"].items():
                e = e.set_property(k, val)
            out.append(e)
        return out
    e = tx.add_edge(
        out_v, label or clabel, in_v, **{**props, **cprops}
    )
    return [e]


class _start_merge_vertex:
    """MergeVertexStep in start position: find-or-create runs at run() so
    an unexecuted traversal leaves no phantom writes (same laziness as
    _start_new_vertex), and on_create()/on_match() modulators registered
    after construction are honored via the shared spec."""

    def __init__(self, source: GraphTraversalSource, match: dict):
        self.source = source
        self.match = match
        self.spec = {"on_create": {}, "on_match": {}}
        self.plan = {"access": "mergeV"}

    def run(self, has_conditions) -> List[Traverser]:
        vs = _merge_vertex(self.source, self.match, self.spec)
        return _apply_has(
            [Traverser(v) for v in vs], has_conditions, self.source.tx
        )


class _start_merge_edge:
    def __init__(self, source: GraphTraversalSource, match: dict):
        self.source = source
        self.match = match
        self.spec = {"on_create": {}, "on_match": {}}
        self.plan = {"access": "mergeE"}

    def run(self, has_conditions) -> List[Traverser]:
        es = _merge_edge(self.source, self.match, self.spec)
        return _apply_has(
            [Traverser(e) for e in es], has_conditions, self.source.tx
        )


class _start_inject:
    def __init__(self, source: GraphTraversalSource, values):
        self.source = source
        self.values = tuple(values)
        self.plan = {"access": "inject"}

    def run(self, has_conditions) -> List[Traverser]:
        return _apply_has(
            [Traverser(v) for v in self.values], has_conditions,
            self.source.tx,
        )


class _start_vertices:
    def __init__(self, source: GraphTraversalSource, ids):
        self.source = source
        self.ids = ids
        #: filled at run(): how the start step resolved (for .profile())
        self.plan: dict = {}

    def run(self, has_conditions) -> List[Traverser]:
        tx = self.source.tx
        if self.ids:
            # id point-lookups keep plain filter semantics: the reference's
            # query.ignore-unknown-index-key governs only graph-centric
            # (index-planned) queries — JanusGraphStep with ids bypasses
            # GraphCentricQueryBuilder
            self.plan = {"access": "ids"}
            out = []
            for i in self.ids:
                v = tx.get_vertex(i.id if isinstance(i, Vertex) else i)
                if v is not None:
                    out.append(Traverser(v))
            return _apply_has(out, has_conditions, tx)
        # query.ignore-unknown-index-key (reference default false): a
        # graph-centric query over a key the schema has never seen is
        # almost always a typo — raise unless the option opts into
        # treating the condition as unsatisfiable (reference:
        # GraphCentricQueryBuilder unknown-key handling)
        graph = self.source.graph
        unknown = [
            k for k, _p in has_conditions
            if k is not None and not _is_property_key(graph, k)
        ]
        if unknown:
            if not graph.config.get("query.ignore-unknown-index-key"):
                raise QueryError(
                    f"unknown property key(s) {sorted(set(unknown))} in "
                    "graph query; set query.ignore-unknown-index-key=true "
                    "to treat as no-match"
                )
            self.plan = {"access": "unknown-key", "keys": unknown}
            return []
        # index folding: find a composite index fully covered by eq (one
        # value) or within (a finite value set) conditions — within folds
        # as a UNION of point lookups, the reference's Contain.IN handling
        # (GraphCentricQueryBuilder constraints2Indexes), capped so a huge
        # IN-list degrades to the scan instead of exploding combinations
        cands: Dict[str, list] = {}
        for key, p in has_conditions:
            if key is None:
                continue
            if p.eq_value is not None:
                # an eq ALWAYS narrows: it overrides a within() on the
                # same key (their conjunction is at most that one value)
                cands[key] = [p.eq_value]
            elif p.predicate is Contain.IN and key not in cands:
                cands[key] = list(p.condition)
        # label equality (if any) gates label-constrained indexes
        label_eq = None
        for key, p in has_conditions:
            if key is None and p.eq_value is not None:
                label_eq = p.eq_value
        covered = _covered_indexes(self.source.graph, cands, label_eq)
        over_cap_best = None  # (n_combos, idx, names) fallback
        chosen = None
        for idx in covered:
            names = [
                self.source.graph.schema_cache.get_by_id(k).name
                for k in idx.key_ids
            ]
            # cap decided ARITHMETICALLY (materializing a huge cartesian
            # just to reject it would be the blowup the cap prevents);
            # over-cap: try the next (narrower) covered index
            n_combos = 1
            for n in names:
                n_combos *= len(cands[n])
            if n_combos > 64:
                if over_cap_best is None or n_combos < over_cap_best[0]:
                    over_cap_best = (n_combos, idx, names)
                continue
            chosen = (n_combos, idx, names)
            break
        if chosen is None and over_cap_best is not None and (
            self.source.graph.config.get("query.force-index")
        ):
            # under query.force-index an over-cap union still beats the
            # REFUSED scan: run the fewest-combo covered index uncapped
            # (the product stays lazy; cost is the user's own IN-list)
            chosen = over_cap_best
        if chosen is not None:
            n_combos, idx, names = chosen
            combos = itertools.product(*[cands[n] for n in names])
            self.plan = {
                "access": (
                    "composite-index" if n_combos == 1
                    else "composite-index-union"
                ),
                "index": idx.name,
            }
            if n_combos > 1:
                self.plan["point_lookups"] = n_combos
            seen = set()
            vids = []
            for combo in combos:
                for vid in self.source.graph.index_lookup(
                    tx, idx.name, list(combo)
                ):
                    if vid not in seen:
                        seen.add(vid)
                        vids.append(vid)
            return _index_hits_with_tx_overlay(tx, vids, has_conditions)
        # mixed-index folding: push supported predicate conditions down to an
        # IndexProvider (reference: GraphCentricQueryBuilder index selection
        # falling back from composite to mixed indexes)
        hit = _select_mixed_index(self.source.graph, has_conditions, label_eq)
        if hit is not None:
            midx, covered = hit
            self.plan = {
                "access": "mixed-index",
                "index": midx.name,
                "conditions_pushed": len(covered),
            }
            vids = self.source.graph.mixed_index_query(tx, midx, covered)
            return _index_hits_with_tx_overlay(tx, vids, has_conditions)
        # full scan (the reference warns here; query.force-index refuses)
        if graph.config.get("query.force-index"):
            raise QueryError(
                "query.force-index is set and this traversal has no "
                "index-covered start conditions — add an index or drop "
                "the option (reference: query.force-index)"
            )
        self.plan = {"access": "full-scan"}
        return _apply_has([Traverser(v) for v in tx.vertices()], has_conditions, tx)


class _start_edges:
    def __init__(self, source: GraphTraversalSource, ids=()):
        self.source = source
        self.ids = ids

    def run(self, has_conditions) -> List[Traverser]:
        tx = self.source.tx
        if self.ids:
            # E(rid, ...) point lookups by RelationIdentifier / its
            # string form / an Edge (reference: graph.edges(ids) ->
            # StandardJanusGraphTx.getEdge per id)
            out = []
            for i in self.ids:
                try:
                    e = tx.get_edge(
                        i.identifier if isinstance(i, Edge) else i
                    )
                except Exception:
                    raise QueryError(
                        f"E(): not an edge id (RelationIdentifier or its "
                        f"string form): {i!r}"
                    )
                if e is not None:
                    out.append(Traverser(e))
            return _apply_has(out, has_conditions, tx)
        out, seen = [], set()
        for v in tx.vertices():
            for e in tx.get_edges(v, Direction.OUT, ()):
                if e.id not in seen:
                    seen.add(e.id)
                    out.append(Traverser(e))
        return _apply_has(out, has_conditions, tx)


def _index_hits_with_tx_overlay(tx, vids, has_conditions) -> List[Traverser]:
    """Committed index hits can't see this tx's writes: add tx-created
    vertices AND loaded vertices whose properties changed in-tx; _apply_has
    then re-checks every condition on current values."""
    out = [Traverser(v) for vid in vids if (v := tx.get_vertex(vid))]
    dirty = {
        vid
        for vid, rels in tx._added.items()
        if any(isinstance(r, VertexProperty) for r in rels)
    }
    dirty.update(
        r.vertex.id for r in tx._deleted if isinstance(r, VertexProperty)
    )
    out.extend(
        Traverser(v)
        for v in tx._vertex_cache.values()
        if not v.is_removed and (v.is_new or v.id in dirty)
    )
    return _apply_has(_dedup(out), has_conditions, tx)


def _select_mixed_index(graph, has_conditions, label_eq=None):
    """Pick the mixed index covering the most pushable conditions; returns
    (index, [(key, predicate, condition), ...]) or None."""
    best = None
    for idx in graph.indexes.values():
        if not idx.mixed or idx.status != "ENABLED":
            continue
        if idx.label_constraint is not None and idx.label_constraint != label_eq:
            continue
        provider = graph.index_providers.get(idx.backing)
        if provider is None:
            continue
        fields = graph.mixed_index_fields(idx)
        covered = []
        for key, p in has_conditions:
            if key is None or p.predicate is None or key not in fields:
                continue
            _kid, info = fields[key]
            if provider.supports(info, p.predicate):
                covered.append((key, p.predicate, p.condition))
        if covered and (best is None or len(covered) > len(best[1])):
            best = (idx, covered)
    return best


def _covered_indexes(graph, eqs: dict, label_eq=None) -> list:
    """Every ENABLED composite index whose keys the conditions cover,
    WIDEST first (the caller may skip a wide index whose within-cartesian
    exceeds the point-lookup cap in favor of a narrower covered one)."""
    out = []
    for idx in graph.indexes.values():
        if idx.mixed or idx.status != "ENABLED":
            continue  # exact-row lookups on ENABLED composite indexes only
        # a label-constrained index only covers vertices of that label: it is
        # usable only when the query pins the label to exactly that value
        if idx.label_constraint is not None and idx.label_constraint != label_eq:
            continue
        names = []
        for k in idx.key_ids:
            el = graph.schema_cache.get_by_id(k)
            if el is None:
                break
            names.append(el.name)
        if len(names) != len(idx.key_ids):
            continue
        if all(n in eqs for n in names):
            out.append(idx)
    out.sort(key=lambda i: len(i.key_ids), reverse=True)
    return out


def _element_value(t: Traverser, key: str, tx):
    obj = t.obj
    if isinstance(obj, Vertex):
        return obj.value(key)
    if isinstance(obj, Edge):
        return obj.value(key)
    if isinstance(obj, VertexProperty):
        return obj.value if obj.key == key else None
    return None


def _is_property_key(graph, name: str) -> bool:
    """True when `name` is a PROPERTY KEY in the schema — a vertex/edge
    label with the same name must not satisfy a has(key, ...) lookup
    (the reference's unknown-key check is PropertyKey-specific)."""
    from janusgraph_tpu_torch.core.schema import PropertyKey

    el = graph.schema_cache.get_by_name(name)
    return isinstance(el, PropertyKey)


def _apply_has(ts: List[Traverser], conditions, tx) -> List[Traverser]:
    out = ts
    for key, p in conditions:
        if key is None:  # label condition
            out = [t for t in out if p.test(_label_of(t.obj))]
        else:
            out = [t for t in out if p.test(_element_value(t, key, tx))]
    return out


def _label_of(obj):
    if isinstance(obj, (Vertex, Edge)):
        return obj.label
    if isinstance(obj, VertexProperty):
        return obj.key
    return None


def _dedup(ts: List[Traverser]) -> List[Traverser]:
    seen, out = set(), []
    for t in ts:
        k = t.obj if not isinstance(t.obj, (Vertex, Edge)) else t.obj.id
        try:
            if k in seen:
                continue
            seen.add(k)
        except TypeError:
            pass  # unhashable values are kept
        out.append(t)
    return out


# ------------------------------------------------------------------ traversal
class GraphTraversal:
    def __init__(self, source: GraphTraversalSource, start):
        self.source = source
        self.tx = source.tx
        self._start = start  # None for anonymous (sub-traversal) bodies
        self._pre_has: List = []  # foldable leading has-conditions
        self._steps: List[Callable[[List[Traverser]], List[Traverser]]] = []
        self._folding = True  # still collecting leading has() steps
        self._last_by: Optional[List] = None  # open by() modulator window
        self._side_effects: Dict[str, List] = {}  # aggregate()/cap() buckets
        #: transient OLAP-bridge results {vid: {key: value}} — per
        #: TRAVERSAL (sub-traversal bodies share the root's dict via
        #: _sub_steps); never written to the tx, schema, or source
        self._olap_overlay: Dict = {}

    # -- filters ------------------------------------------------------------
    def has(self, key: str, value=None) -> "GraphTraversal":
        if value is None:
            p = P(lambda x: x is not None, f"exists({key})")
        elif isinstance(value, P):
            p = value
        else:
            p = P.eq(value)
        if self._folding:
            self._pre_has.append((key, p))
        else:
            self._add(
                lambda ts: [t for t in ts if p.test(self._elem_val(t, key))],
                name=f"has({key})",
            )
        return self

    def has_label(self, *labels: str) -> "GraphTraversal":
        # single label folds as an equality so label-constrained indexes apply
        p = P.eq(labels[0]) if len(labels) == 1 else P.within(*labels)
        if self._folding:
            self._pre_has.append((None, p))
        else:
            step = lambda ts: [t for t in ts if p.test(_label_of(t.obj))]
            self._add(step, name="hasLabel")
            # spillover planner metadata (olap/spillover.py): a mid-chain
            # label filter compiles to a device-side step mask
            step._spill_meta = ("hasLabel", tuple(labels))
        return self

    def has_id(self, *ids) -> "GraphTraversal":
        from janusgraph_tpu_torch.core.codecs import RelationIdentifier

        idset = set()
        rid_set = set()  # edge ids are RelationIdentifiers (see id_())
        for i in ids:
            if isinstance(i, Vertex):
                idset.add(i.id)
            elif isinstance(i, Edge):
                rid_set.add(i.identifier)
            elif isinstance(i, RelationIdentifier):
                rid_set.add(i)
            else:
                idset.add(i)
        # AdjacentVertex rewrite (reference: optimize/strategy/
        # AdjacentVertexHasIdOptimizerStrategy): `.out(lbl).has_id(v)`
        # collapses the expansion + filter into per-traverser adjacency
        # POINT LOOKUPS — a bounded column slice per (label, target) instead
        # of materializing the whole neighborhood
        prev = self._steps[-1] if self._steps else None
        meta = getattr(prev, "_expand_meta", None)
        if meta is not None and meta["to_vertex"] and meta["sort_range"] is None:
            tx = self.tx
            direction, labels = meta["direction"], meta["labels"]

            def adjacency(ts):
                out = []
                for t in ts:
                    v = t.obj
                    if not isinstance(v, Vertex):
                        continue
                    for e in tx.adjacency_edges(v, direction, labels, idset):
                        out.append(t.child(e.other(v), prev=v))
                return out

            adjacency._label = f"adjacentVertexHasId{tuple(sorted(idset))!r}"
            self._steps[-1] = adjacency
            return self
        # START-position fold (reference: JanusGraphStep hasId folding):
        # V().has_id(1, 2) becomes the V(1, 2) point-lookup start instead
        # of a full scan + filter — vertex ids only (rids mean edges)
        if (
            self._folding
            and idset
            and not rid_set
            and isinstance(self._start, _start_vertices)
            and not self._start.ids
            and not self._steps
        ):
            self._start.ids = tuple(idset)
            return self
        # symmetric fold for edges: E().has_id(rid, ...) -> E(rid, ...)
        if (
            self._folding
            and rid_set
            and not idset
            and isinstance(self._start, _start_edges)
            and not self._start.ids
            and not self._steps
        ):
            self._start.ids = tuple(rid_set)
            return self

        def _id_hit(obj):
            if isinstance(obj, Edge) and obj.identifier in rid_set:
                return True
            return getattr(obj, "id", None) in idset

        self._add(lambda ts: [t for t in ts if _id_hit(t.obj)])
        return self

    def filter_(self, fn: Callable[[object], bool]) -> "GraphTraversal":
        self._add(lambda ts: [t for t in ts if fn(t.obj)])
        return self

    def identity(self) -> "GraphTraversal":
        """TinkerPop identity(): pass traversers through unchanged."""
        self._add(lambda ts: ts, name="identity")
        return self

    def none(self) -> "GraphTraversal":
        """TinkerPop none(): discard every traverser (the iterate()
        companion for mutation-only chains)."""
        self._add(lambda ts: [], name="none")
        return self

    def map_(self, fn) -> "GraphTraversal":
        """TinkerPop map(): one output per input. Accepts a python
        callable on the raw object OR a traversal body — ``map(values(
        'name'))`` over the text endpoint — whose FIRST result is the
        output (traversers with no result are dropped, the TinkerPop
        map-traversal contract)."""
        if isinstance(fn, GraphTraversal):
            raise QueryError(
                "use an anonymous traversal (__) as the body, not an "
                "executable traversal"
            )
        if isinstance(fn, AnonymousTraversal):
            steps = self._sub_steps(fn)

            def step(ts):
                out = []
                for t in ts:
                    hits = self._apply_steps(steps, [t])
                    if hits:
                        out.append(
                            t.child(hits[0].obj, prev=hits[0].prev)
                        )
                return out

        else:
            def step(ts):
                return [t.child(fn(t.obj)) for t in ts]

        self._add(step, name="map")
        return self

    def flat_map(self, fn) -> "GraphTraversal":
        """TinkerPop flatMap(): each input yields zero or more outputs.
        Accepts a traversal body (``flatMap(out('knows'))`` — every
        result becomes a traverser) or a python callable returning an
        iterable."""
        if isinstance(fn, GraphTraversal):
            raise QueryError(
                "use an anonymous traversal (__) as the body, not an "
                "executable traversal"
            )
        if isinstance(fn, AnonymousTraversal):
            steps = self._sub_steps(fn)

            def step(ts):
                out = []
                for t in ts:
                    out.extend(
                        t.child(r.obj, prev=r.prev)
                        for r in self._apply_steps(steps, [t])
                    )
                return out

        else:
            def step(ts):
                out = []
                for t in ts:
                    for x in fn(t.obj):
                        out.append(t.child(x))
                return out

        self._add(step, name="flatMap")
        return self

    def _add(self, step, name: Optional[str] = None) -> None:
        self._folding = False
        self._last_by = None  # a new step closes the previous by() window
        self._last_repeat = None  # ... and the repeat modulator window
        self._last_branch = None  # ... and the branch option window
        self._last_merge = None  # ... and the merge on_create/on_match window
        # label for .profile(): the public step method that registered it
        import sys

        step._label = name or sys._getframe(1).f_code.co_name
        self._steps.append(step)

    # -- vertex expansion (batched via prefetch) -----------------------------
    def out(self, *labels: str) -> "GraphTraversal":
        return self._expand(Direction.OUT, labels, to_vertex=True)

    def in_(self, *labels: str) -> "GraphTraversal":
        return self._expand(Direction.IN, labels, to_vertex=True)

    def both(self, *labels: str) -> "GraphTraversal":
        return self._expand(Direction.BOTH, labels, to_vertex=True)

    def out_e(self, *labels: str, sort_range=None) -> "GraphTraversal":
        return self._expand(
            Direction.OUT, labels, to_vertex=False, sort_range=sort_range
        )

    def in_e(self, *labels: str, sort_range=None) -> "GraphTraversal":
        return self._expand(
            Direction.IN, labels, to_vertex=False, sort_range=sort_range
        )

    def both_e(self, *labels: str) -> "GraphTraversal":
        return self._expand(Direction.BOTH, labels, to_vertex=False)

    def _expand(
        self, direction, labels, to_vertex, sort_range=None
    ) -> "GraphTraversal":
        tx = self.tx

        def step(ts: List[Traverser]) -> List[Traverser]:
            vs = [t.obj for t in ts if isinstance(t.obj, Vertex)]
            # query.batch, resolved once at graph open (hot path)
            if sort_range is None and tx.graph._query_batch:
                tx.prefetch(vs, direction, labels)  # the multiQuery batch
            out: List[Traverser] = []
            for t in ts:
                v = t.obj
                if not isinstance(v, Vertex):
                    continue
                for e in tx.get_edges(v, direction, labels, sort_range=sort_range):
                    if to_vertex:
                        out.append(t.child(e.other(v), prev=v))
                    else:
                        out.append(t.child(e, prev=v))
            return out

        kind = {Direction.OUT: "out", Direction.IN: "in", Direction.BOTH: "both"}[
            direction
        ]
        suffix = ("" if to_vertex else "E") + (
            f"({','.join(labels)})" if labels else "()"
        )
        self._add(step, name=kind + suffix)
        # metadata for peephole rewrites (AdjacentVertex* strategies)
        step._expand_meta = {
            "direction": direction,
            "labels": labels,
            "to_vertex": to_vertex,
            "sort_range": sort_range,
        }
        return self

    def out_v(self) -> "GraphTraversal":
        self._add(
            lambda ts: [
                t.child(t.obj.out_vertex) for t in ts if isinstance(t.obj, Edge)
            ]
        )
        return self

    def in_v(self) -> "GraphTraversal":
        self._add(
            lambda ts: [
                t.child(t.obj.in_vertex) for t in ts if isinstance(t.obj, Edge)
            ]
        )
        return self

    def other_v(self) -> "GraphTraversal":
        def step(ts):
            out = []
            for t in ts:
                if isinstance(t.obj, Edge) and t.prev is not None:
                    out.append(t.child(t.obj.other(t.prev), prev=t.prev))
            return out

        self._add(step)
        return self

    def both_v(self) -> "GraphTraversal":
        def step(ts):
            out = []
            for t in ts:
                if isinstance(t.obj, Edge):
                    out.append(t.child(t.obj.out_vertex))
                    out.append(t.child(t.obj.in_vertex))
            return out

        self._add(step)
        return self

    # -- projections ---------------------------------------------------------
    def values(self, *keys: str) -> "GraphTraversal":
        tx = self.tx

        def step(ts):
            out = []
            for t in ts:
                if isinstance(t.obj, Vertex):
                    shadowed = set()
                    for k, val in self._overlay_items(t.obj, keys):
                        out.append(t.child(val, prev=t.prev))
                        shadowed.add(k)
                    props = tx.get_properties(t.obj, *keys)
                    out.extend(
                        t.child(p.value, prev=t.prev)
                        for p in props if p.key not in shadowed
                    )
                elif isinstance(t.obj, Edge):
                    pv = t.obj.property_values()
                    for k, v in pv.items():
                        if not keys or k in keys:
                            out.append(t.child(v, prev=t.prev))
            return out

        self._add(step)
        return self

    def properties(self, *keys: str) -> "GraphTraversal":
        tx = self.tx
        self._add(
            lambda ts: [
                t.child(p, prev=t.prev)
                for t in ts
                if isinstance(t.obj, Vertex)
                for p in tx.get_properties(t.obj, *keys)
            ]
        )
        return self

    def element(self) -> "GraphTraversal":
        """TinkerPop element(): property traverser -> its owning element."""

        def step(ts):
            out = []
            for t in ts:
                if not isinstance(t.obj, VertexProperty):
                    raise QueryError(
                        "element() requires property traversers "
                        f"(got {type(t.obj).__name__})"
                    )
                out.append(t.child(t.obj.vertex, prev=t.prev))
            return out

        self._add(step, name="element")
        return self

    def key(self) -> "GraphTraversal":
        """TinkerPop key(): property traverser -> its key string."""

        def step(ts):
            out = []
            for t in ts:
                if not isinstance(t.obj, VertexProperty):
                    raise QueryError(
                        "key() requires property traversers "
                        f"(got {type(t.obj).__name__})"
                    )
                out.append(t.child(t.obj.key, prev=t.prev))
            return out

        self._add(step, name="key")
        return self

    def value(self) -> "GraphTraversal":
        """TinkerPop value(): property traverser -> its value."""

        def step(ts):
            out = []
            for t in ts:
                if not isinstance(t.obj, VertexProperty):
                    raise QueryError(
                        "value() requires property traversers "
                        f"(got {type(t.obj).__name__})"
                    )
                out.append(t.child(t.obj.value, prev=t.prev))
            return out

        self._add(step, name="value")
        return self

    def has_key(self, *keys: str) -> "GraphTraversal":
        """TinkerPop hasKey(): keep property traversers with these keys."""
        ks = set(keys)
        self._add(
            lambda ts: [
                t for t in ts
                if isinstance(t.obj, VertexProperty) and t.obj.key in ks
            ],
            name=f"hasKey{tuple(sorted(ks))!r}",
        )
        return self

    def has_value(self, *values) -> "GraphTraversal":
        """TinkerPop hasValue(): keep property traversers whose value
        matches one of the arguments (or a P predicate)."""
        preds = [v if isinstance(v, P) else P.eq(v) for v in values]
        self._add(
            lambda ts: [
                t for t in ts
                if isinstance(t.obj, VertexProperty)
                and any(p.test(t.obj.value) for p in preds)
            ],
            name="hasValue",
        )
        return self

    def label(self) -> "GraphTraversal":
        """Map each element to its label string (TinkerPop LabelStep).
        `label_` is the same step under its historical spelling."""
        self._add(
            lambda ts: [t.child(_label_of(t.obj), prev=t.prev) for t in ts],
            name="label",
        )
        return self

    label_ = label

    def element_map(self, *keys: str) -> "GraphTraversal":
        """One flat dict per element: id + label + single-valued properties
        (TinkerPop ElementMapStep; multi-valued keys keep the LAST value,
        matching TinkerPop's elementMap flattening)."""
        tx = self.tx

        def step(ts):
            out = []
            for t in ts:
                obj = t.obj
                if isinstance(obj, Vertex):
                    m = {"id": obj.id, "label": obj.label}
                    for p in tx.get_properties(obj, *keys):
                        m[p.key] = p.value
                elif isinstance(obj, Edge):
                    # TinkerPop elementMap() on edges keys the endpoint
                    # summaries by Direction.OUT/Direction.IN enum members
                    # (ElementMapStep), not strings
                    m = {
                        "id": obj.identifier,
                        "label": obj.label,
                        Direction.OUT: {
                            "id": obj.out_vertex.id,
                            "label": obj.out_vertex.label,
                        },
                        Direction.IN: {
                            "id": obj.in_vertex.id,
                            "label": obj.in_vertex.label,
                        },
                    }
                    for k, v in obj.property_values().items():
                        if not keys or k in keys:
                            m[k] = v
                else:
                    raise QueryError(
                        f"element_map() requires vertex or edge traversers "
                        f"(got {type(obj).__name__})"
                    )
                out.append(t.child(m, prev=t.prev))
            return out

        self._add(step, name="elementMap")
        return self

    def add_v_(self, label: Optional[str] = None) -> "GraphTraversal":
        """Mid-traversal AddVertexStep: one NEW vertex per incoming
        traverser, whatever its object (the canonical upsert
        ``fold().coalesce(__.unfold(), __.add_v_('person'))`` spawns from
        the empty-fold list traverser)."""
        tx = self.tx

        def step(ts):
            return [t.child(tx.add_vertex(label)) for t in ts]

        self._add(step, name=f"addV({label})")
        return self

    def add_e_(self, label: str, **props) -> "GraphTraversal":
        """Mid-traversal edge creation (TinkerPop AddEdgeStep):
        ``g.V().has(...).add_e_('knows').to_(other)`` wires one edge per
        incoming vertex traverser; the traverser becomes the new Edge.
        Endpoints: OUT defaults to the incoming vertex, overridable with
        ``from_``; IN comes from ``to_``. Targets may be a Vertex, a tag
        name bound with as_(), or an anonymous traversal evaluated from
        the incoming vertex that must yield exactly ONE vertex. (Named
        add_e_ — the traversal SOURCE's add_e creates an edge directly.)"""
        tx = self.tx
        spec = {"to": None, "from": None}
        self._last_add_e = spec

        def step(ts):
            # sub-traversal endpoints compile ONCE per execution, not per
            # traverser; every resolved endpoint must be a Vertex (an
            # edge-tagged as_() label would otherwise wire a corrupt edge
            # that only explodes at commit)
            compiled = {
                side: (
                    self._sub_steps(tgt)
                    if tgt is not None
                    and not isinstance(tgt, (Vertex, str))
                    else None
                )
                for side, tgt in spec.items()
            }

            def resolve(side, t):
                target = spec[side]
                if target is None:
                    return None
                if isinstance(target, str):  # as_() tag
                    tags = t.tags or {}
                    if target not in tags:
                        raise QueryError(
                            f"add_e_ endpoint tag {target!r} is not bound"
                        )
                    target = tags[target]
                if isinstance(target, Vertex):
                    return target
                if compiled[side] is None:
                    raise QueryError(
                        f"add_e_ endpoint must be a vertex "
                        f"(got {type(target).__name__})"
                    )
                hits = [
                    r.obj for r in self._apply_steps(compiled[side], [t])
                ]
                if len(hits) != 1 or not isinstance(hits[0], Vertex):
                    raise QueryError(
                        f"add_e_ endpoint must resolve to exactly one "
                        f"vertex (got "
                        f"{[type(h).__name__ for h in hits] or 'nothing'})"
                    )
                return hits[0]

            out = []
            for t in ts:
                v = t.obj
                if not isinstance(v, Vertex):
                    raise QueryError(
                        "add_e_() requires vertex traversers "
                        f"(got {type(v).__name__})"
                    )
                src = resolve("from", t) or v
                dst = resolve("to", t)
                if dst is None:
                    raise QueryError(
                        "add_e_() needs a to_(target) endpoint"
                    )
                e = tx.add_edge(src, label, dst, **props)
                # prev = the edge's anchoring vertex: other_v() etc. must
                # see the incident vertex, not the pre-step history
                out.append(t.child(e, prev=v))
            return out

        self._add(step, name=f"addE({label})")
        return self

    def to_(self, target) -> "GraphTraversal":
        """Bind the IN endpoint of the preceding add_e_() step."""
        spec = getattr(self, "_last_add_e", None)
        if spec is None:
            raise QueryError("to_() must follow add_e_()")
        spec["to"] = target
        return self

    def from_(self, target) -> "GraphTraversal":
        """Bind the OUT endpoint of the preceding add_e_() step."""
        spec = getattr(self, "_last_add_e", None)
        if spec is None:
            raise QueryError("from_() must follow add_e_()")
        spec["from"] = target
        return self

    def merge_v(self, match: Optional[dict] = None) -> "GraphTraversal":
        """Mid-traversal MergeVertexStep: find-or-create per incoming
        traverser. With no map, the incoming traverser's object IS the
        merge map (the ``inject({...}).merge_v()`` bulk-upsert shape);
        each match (or the one created vertex) continues the traversal."""
        source = self.source
        spec = {"on_create": {}, "on_match": {}}

        def step(ts):
            out = []
            for t in ts:
                m = match if match is not None else t.obj
                if not isinstance(m, dict):
                    raise QueryError(
                        "merge_v() without a map needs dict traversers "
                        f"(got {type(m).__name__})"
                    )
                for v in _merge_vertex(source, m, spec):
                    out.append(t.child(v))
            return out

        self._add(step, name="mergeV")
        self._last_merge = spec  # reopen after _add closed the windows
        return self

    def merge_e(self, match: Optional[dict] = None) -> "GraphTraversal":
        """Mid-traversal MergeEdgeStep: endpoints the map omits default to
        the incoming vertex (TinkerPop's incident-vertex default)."""
        source = self.source
        spec = {"on_create": {}, "on_match": {}}

        def step(ts):
            out = []
            for t in ts:
                m = match if match is not None else t.obj
                if not isinstance(m, dict):
                    raise QueryError(
                        "merge_e() without a map needs dict traversers "
                        f"(got {type(m).__name__})"
                    )
                default_v = t.obj if isinstance(t.obj, Vertex) else None
                for e in _merge_edge(source, m, spec, default_v):
                    out.append(t.child(e, prev=default_v))
            return out

        self._add(step, name="mergeE")
        self._last_merge = spec  # reopen after _add closed the windows
        return self

    def on_create(self, props: dict) -> "GraphTraversal":
        """Creation-side modulator for the preceding merge_v()/merge_e():
        extends the creation map (properties, and for merge_e endpoints/
        label the match map lacks)."""
        spec = getattr(self, "_last_merge", None)
        if spec is None:
            raise QueryError("on_create() must follow merge_v()/merge_e()")
        spec["on_create"].update(props)
        return self

    def on_match(self, props: dict) -> "GraphTraversal":
        """Match-side modulator for the preceding merge_v()/merge_e():
        properties set on every matched element."""
        spec = getattr(self, "_last_merge", None)
        if spec is None:
            raise QueryError("on_match() must follow merge_v()/merge_e()")
        for k in props:
            if not isinstance(k, str):
                raise QueryError(f"on_match() key {k!r} is not a property")
        spec["on_match"].update(props)
        return self

    def inject(self, *values) -> "GraphTraversal":
        """Mid-traversal InjectStep: append the given raw values to the
        traverser stream (TinkerPop semantics — existing traversers pass
        through, injected values start fresh paths)."""

        def step(ts):
            return list(ts) + [Traverser(v) for v in values]

        self._add(step, name="inject")
        return self

    def constant(self, value) -> "GraphTraversal":
        """ConstantStep: map every traverser to the given value."""
        self._add(
            lambda ts: [t.child(value) for t in ts], name="constant"
        )
        return self

    def branch(self, selector) -> "GraphTraversal":
        """TinkerPop branch(selector).option(value, body)...: the
        selector (a traversal body or python callable) computes a pick
        value per traverser; every option registered for that value runs
        (plus Pick.any options always, and Pick.none options when no
        concrete option matched). Results of all fired branches
        concatenate."""
        selector_steps = (
            self._sub_steps(selector)
            if isinstance(selector, AnonymousTraversal)
            else None
        )
        spec = {"options": []}

        def step(ts):
            compiled = [
                (pick, self._sub_steps(body))
                for pick, body in spec["options"]
            ]
            if not compiled:
                raise QueryError("branch() needs at least one option()")
            out = []
            for t in ts:
                if selector_steps is not None:
                    hits = self._apply_steps(selector_steps, [t])
                    v = hits[0].obj if hits else None
                else:
                    v = selector(t.obj)
                matched = False
                fired = []
                for pick, body_steps in compiled:
                    if pick is Pick.any or (
                        not isinstance(pick, Pick) and pick == v
                    ):
                        if not isinstance(pick, Pick):
                            matched = True
                        fired.append(body_steps)
                if not matched:
                    fired.extend(
                        bs for pick, bs in compiled if pick is Pick.none
                    )
                for body_steps in fired:
                    out.extend(self._apply_steps(body_steps, [t]))
            return out

        self._add(step, name="branch")
        self._last_branch = spec  # reopen after _add closed windows
        return self

    def option(self, pick, body) -> "GraphTraversal":
        """Register one branch() option (see branch())."""
        spec = getattr(self, "_last_branch", None)
        if spec is None:
            raise QueryError("option() must follow branch()")
        spec["options"].append((pick, body))
        return self

    def fail(self, message: str = "fail() step reached") -> "GraphTraversal":
        """TinkerPop fail(): abort the traversal with an error when any
        traverser reaches this step."""

        def step(ts):
            if ts:
                raise QueryError(message)
            return ts

        self._add(step, name="fail")
        return self

    def property_map(self, *keys: str) -> "GraphTraversal":
        """TinkerPop propertyMap(): like value_map but vertex map values
        are the VertexProperty objects themselves (meta-properties
        reachable); edge properties are inline values (no standalone
        Property object exists for them here). Reads STORED properties
        only — the transient OLAP overlay holds raw values, not property
        objects, so it is not surfaced."""
        tx = self.tx

        def step(ts):
            out = []
            for t in ts:
                if isinstance(t.obj, Vertex):
                    m: dict = {}
                    for p in tx.get_properties(t.obj, *keys):
                        m.setdefault(p.key, []).append(p)
                    out.append(t.child(m, prev=t.prev))
                elif isinstance(t.obj, Edge):
                    pv = t.obj.property_values()
                    out.append(t.child(
                        {k: v for k, v in pv.items()
                         if not keys or k in keys},
                        prev=t.prev,
                    ))
            return out

        self._add(step, name="propertyMap")
        return self

    def loops(self) -> "GraphTraversal":
        """TinkerPop loops(): the traverser's current repeat() depth —
        ``repeat(out()).until(loops().is_(3))`` bounds a loop by depth."""
        self._add(
            lambda ts: [t.child(t.loops) for t in ts], name="loops"
        )
        return self

    def barrier(self, max_size: Optional[int] = None) -> "GraphTraversal":
        """TinkerPop barrier([maxBarrierSize]): an explicit
        synchronization point. The execution model here is already
        batch-at-a-time (every step maps the WHOLE traverser list), so
        this is a documented no-op — including the size argument, which
        tunes TinkerPop's lazy-stream batching that does not exist
        here."""
        self._add(lambda ts: ts, name="barrier")
        return self

    def property(self, key: str, value=None, **props) -> "GraphTraversal":
        """Set properties on each element traverser (TinkerPop
        PropertyStep: ``g.V().has(...).property('age', 31)``). Vertex
        properties respect the key's cardinality (SINGLE replaces, LIST
        appends, SET dedups — the same semantics as tx.add_property);
        edge properties replace. Traversers pass through unchanged;
        mutations join the surrounding transaction — commit as usual."""
        tx = self.tx
        kv = dict(props)
        if key is not None:
            kv[key] = value
        if not kv:
            raise QueryError("property() needs a key/value")

        def step(ts):
            for t in ts:
                obj = t.obj
                if isinstance(obj, Vertex):
                    for k, v in kv.items():
                        tx.add_property(obj, k, v)
                elif isinstance(obj, Edge):
                    # loaded edges rewrite as delete + re-add: chain the
                    # LIVE replacement back into the traverser — including
                    # path history and as_() tags, which path()/select()
                    # read downstream — or they see a dead handle
                    stale = obj
                    for k, v in kv.items():
                        obj = obj.set_property(k, v)
                    t.obj = obj
                    if obj is not stale:
                        t.path = tuple(
                            obj if p is stale else p for p in t.path
                        )
                        if t.tags:
                            t.tags = {
                                nm: (obj if tv is stale else tv)
                                for nm, tv in t.tags.items()
                            }
                else:
                    raise QueryError(
                        "property() requires vertex or edge traversers "
                        f"(got {type(obj).__name__})"
                    )
            return ts

        self._add(step, name=f"property({sorted(kv)})")
        return self

    def drop(self) -> "GraphTraversal":
        """Remove every element on the frontier — vertices (with their
        incident edges), edges, or vertex properties (TinkerPop DropStep).
        Mutations join the surrounding transaction; commit as usual."""
        tx = self.tx

        def step(ts):
            for t in ts:
                obj = t.obj
                if isinstance(obj, Vertex):
                    tx.remove_vertex(obj)
                elif isinstance(obj, Edge):
                    tx.remove_edge(obj)
                elif isinstance(obj, VertexProperty):
                    tx.remove_property(obj)
                else:
                    raise QueryError(
                        f"drop() cannot remove {type(obj).__name__}"
                    )
            return []

        self._add(step, name="drop")
        return self

    def value_map(self, *keys: str) -> "GraphTraversal":
        tx = self.tx

        def step(ts):
            out = []
            for t in ts:
                if isinstance(t.obj, Vertex):
                    m = {}
                    shadowed = set()
                    for k, val in self._overlay_items(t.obj, keys):
                        m[k] = [val]  # shadows the stored property
                        shadowed.add(k)
                    for p in tx.get_properties(t.obj, *keys):
                        if p.key not in shadowed:
                            m.setdefault(p.key, []).append(p.value)
                    out.append(t.child(m, prev=t.prev))
                elif isinstance(t.obj, Edge):
                    out.append(t.child(t.obj.property_values(), prev=t.prev))
            return out

        self._add(step)
        return self

    def id_(self) -> "GraphTraversal":
        """Element id step (TinkerPop id()): vertex ids are longs; an
        EDGE's id is its RelationIdentifier (the reference's edge-id
        contract — round-trips through E(id)/mergeE({T.id: ...}))."""
        self._add(lambda ts: [
            t.child(
                t.obj.identifier if isinstance(t.obj, Edge) else t.obj.id,
                prev=t.prev,
            )
            for t in ts
        ])
        self._steps[-1]._spill_meta = ("id",)
        return self


    # -- collection/order/slicing -------------------------------------------
    def dedup(self) -> "GraphTraversal":
        self._add(_dedup)
        self._steps[-1]._spill_meta = ("dedup",)
        return self

    def limit(self, n: int) -> "GraphTraversal":
        self._add(lambda ts: ts[:n])
        return self

    def range_(self, lo: int, hi: int) -> "GraphTraversal":
        self._add(lambda ts: ts[lo:hi])
        return self

    def tail(self, n: int = 1) -> "GraphTraversal":
        self._add(lambda ts: ts[-n:] if n else [])
        return self

    def skip(self, n: int) -> "GraphTraversal":
        self._add(lambda ts: ts[n:])
        return self

    def sample(self, n: int, seed: Optional[int] = None) -> "GraphTraversal":
        """Uniform sample without replacement (TinkerPop sample();
        deterministic when `seed` is given — compiler-friendly habit kept
        even host-side)."""
        import random

        def step(ts):
            if len(ts) <= n:
                return list(ts)
            rng = random.Random(seed)
            return rng.sample(ts, n)

        self._add(step, name=f"sample({n})")
        return self

    def coin(self, probability: float, seed: Optional[int] = None) -> "GraphTraversal":
        """Keep each traverser with the given probability (TinkerPop coin())."""
        import random

        def step(ts):
            rng = random.Random(seed)
            return [t for t in ts if rng.random() < probability]

        self._add(step, name=f"coin({probability})")
        return self

    # -- side-effect steps (TinkerPop aggregate/store/cap) --------------------
    def aggregate(self, name: str) -> "GraphTraversal":
        """Eagerly collect the CURRENT objects into side-effect `name`
        (TinkerPop aggregate(): a barrier — the whole frontier is gathered
        before traversal continues; read back with cap())."""

        def step(ts):
            bucket = self._side_effects.setdefault(name, [])
            bucket.extend(t.obj for t in ts)
            return ts

        self._add(step, name=f"aggregate({name})")
        return self

    def store(self, name: str) -> "GraphTraversal":
        """Lazily collect objects into side-effect `name` (TinkerPop
        store() semantics — same collection mechanics here, kept as a
        distinct step for API parity)."""
        return self.aggregate(name)

    def cap(self, name: str) -> "GraphTraversal":
        """Replace the frontier with the collected side-effect — the list
        for aggregate()/store(), or the materialized induced graph for
        subgraph() buckets."""

        def step(ts):
            vals = list(self._side_effects.get(name, []))
            if name in getattr(self, "_subgraph_names", ()):
                return [Traverser(self._materialize_subgraph(vals))]
            return [Traverser(vals)]

        self._add(step, name=f"cap({name})")
        return self

    def order(self, key: Optional[str] = None, reverse: bool = False) -> "GraphTraversal":
        by_list: List[Tuple] = []

        def _sort_missing_last(ts, value_of, rev):
            # traversers MISSING the key sort LAST in either direction
            # (a naive (is-None, val) tuple under reverse=True would put
            # them FIRST — observed with uncommitted vertices absent from
            # a pageRank() snapshot); values computed ONCE per traverser
            keyed = [(value_of(t), t) for t in ts]
            have = [(v, t) for v, t in keyed if v is not None]
            missing = [t for v, t in keyed if v is None]
            have.sort(key=lambda p: p[0], reverse=rev)
            return [t for _v, t in have] + missing

        def step(ts):
            if by_list:  # .order().by('name') / .by(body, reverse=True)
                spec = by_list[0]
                return _sort_missing_last(
                    ts, lambda t: self._by_value(spec, t.obj), spec[2]
                )
            if key is None:
                return sorted(ts, key=lambda t: t.obj, reverse=reverse)
            return _sort_missing_last(
                ts, lambda t: self._elem_val(t, key), reverse
            )

        self._add(step)
        self._last_by = by_list
        return self

    # -- sub-traversal machinery ---------------------------------------------
    # Bodies are Python callables receiving an anonymous traversal (the
    # TinkerPop `__` analogue): t.union(lambda t: t.out('knows'), ...).
    def _sub_steps(self, body) -> List[Callable]:
        sub = GraphTraversal(self.source, None)
        sub._folding = False  # has() inside a body is a plain filter
        sub._olap_overlay = self._olap_overlay  # share the ROOT's overlay
        r = body(sub)
        return (r if isinstance(r, GraphTraversal) else sub)._steps

    @staticmethod
    def _apply_steps(steps: List[Callable], ts: List[Traverser]) -> List[Traverser]:
        for st in steps:
            ts = st(ts)
        return ts

    # -- by() modulator -------------------------------------------------------
    def _resolve_by_spec(self, spec):
        """A by() argument: None (identity), a property key, or a body."""
        if spec is None:
            return ("id", None)
        if isinstance(spec, str):
            return ("key", spec)
        if callable(spec):
            return ("sub", self._sub_steps(spec))
        raise QueryError(f"unsupported by() modulator: {spec!r}")

    def _overlay_get(self, obj, key):
        """(hit, value) from the OLAP overlay (see _olap_annotate):
        transient computer results consulted before (and SHADOWING) real
        properties. Scoped to THIS traversal — sub-traversal bodies
        (by(traversal)/where(traversal)) share the root's dict through
        _sub_steps; other traversals, even from the same source, never
        see it."""
        ov = self._olap_overlay
        if ov and isinstance(obj, Vertex):
            per = ov.get(obj.id)
            if per is not None and key in per:
                return True, per[key]
        return False, None

    def _overlay_items(self, obj, keys=()):
        """[(key, value)] overlay entries for this vertex — restricted to
        `keys` when given, ALL annotated keys otherwise (so no-arg
        values()/value_map() surface them too)."""
        ov = self._olap_overlay
        if not ov or not isinstance(obj, Vertex):
            return []
        if keys:
            out = []
            for k in keys:
                hit, val = self._overlay_get(obj, k)
                if hit:
                    out.append((k, val))
            return out
        per = ov.get(obj.id)
        return list(per.items()) if per else []

    def _elem_val(self, t, key):
        hit, val = self._overlay_get(t.obj, key)
        if hit:
            return val
        return _element_value(t, key, self.tx)

    def _by_value(self, resolved, obj):
        kind, arg = resolved[0], resolved[1]
        if kind == "id":
            return obj
        if kind == "key":
            return self._elem_val(Traverser(obj), arg)
        hits = self._apply_steps(arg, [Traverser(obj)])
        return hits[0].obj if hits else None

    def by(self, spec=None, reverse: bool = False) -> "GraphTraversal":
        """Modulate the previous step (order/select/path/project/group) —
        TinkerPop's by(): a property key, a sub-traversal body, or nothing
        (identity). Multiple by() calls round-robin (project/select/group)."""
        if getattr(self, "_last_by", None) is None:
            raise QueryError("by() must follow a modulatable step")
        self._last_by.append(self._resolve_by_spec(spec) + (reverse,))
        return self

    # -- path / tags ----------------------------------------------------------
    def as_(self, name: str) -> "GraphTraversal":
        """Tag the current object (reference: TinkerPop step labels consumed
        by select()/where())."""
        self._add(lambda ts: [t.tagged(name) for t in ts], name=f"as({name})")
        return self

    def select(self, *names: str) -> "GraphTraversal":
        by_list: List[Tuple] = []

        def step(ts):
            out = []
            for t in ts:
                tags = t.tags or {}
                if any(n not in tags for n in names):
                    continue
                if len(names) == 1:
                    spec = by_list[0] if by_list else ("id", None, False)
                    out.append(t.child(self._by_value(spec, tags[names[0]]),
                                       prev=t.prev))
                else:
                    d = {}
                    for i, nm in enumerate(names):
                        spec = (
                            by_list[i % len(by_list)]
                            if by_list
                            else ("id", None, False)
                        )
                        d[nm] = self._by_value(spec, tags[nm])
                    out.append(t.child(d, prev=t.prev))
            return out

        self._add(step, name=f"select{names!r}")
        self._last_by = by_list
        return self

    def path(self) -> "GraphTraversal":
        by_list: List[Tuple] = []

        def step(ts):
            out = []
            for t in ts:
                if by_list:
                    objs = tuple(
                        self._by_value(by_list[i % len(by_list)], o)
                        for i, o in enumerate(t.path)
                    )
                else:
                    objs = t.path
                out.append(t.child(objs, prev=t.prev))
            return out

        self._add(step, name="path")
        self._last_by = by_list
        return self

    def simple_path(self) -> "GraphTraversal":
        """Keep traversers whose path never revisits an element."""

        def step(ts):
            out = []
            for t in ts:
                seen = set()
                ok = True
                for o in t.path:
                    k = o.id if isinstance(o, (Vertex, Edge)) else o
                    try:
                        if k in seen:
                            ok = False
                            break
                        seen.add(k)
                    except TypeError:
                        pass
                if ok:
                    out.append(t)
            return out

        self._add(step, name="simplePath")
        return self

    def cyclic_path(self) -> "GraphTraversal":
        """Keep traversers whose path REVISITS an element — the complement
        of simple_path() (TinkerPop CyclicPathStep)."""

        def step(ts):
            out = []
            for t in ts:
                seen = set()
                cyclic = False
                for o in t.path:
                    k = o.id if isinstance(o, (Vertex, Edge)) else o
                    try:
                        if k in seen:
                            cyclic = True
                            break
                        seen.add(k)
                    except TypeError:
                        pass
                if cyclic:
                    out.append(t)
            return out

        self._add(step, name="cyclicPath")
        return self

    def has_not(self, key: str) -> "GraphTraversal":
        """Keep elements WITHOUT the property (TinkerPop hasNot())."""
        self._add(
            lambda ts: [
                t for t in ts if self._elem_val(t, key) is None
            ],
            name=f"hasNot({key})",
        )
        return self

    def local(self, body) -> "GraphTraversal":
        """Apply `body` to each traverser in ISOLATION (TinkerPop local()):
        barrier semantics inside the body — order/limit/fold/count — scope
        to one traverser's sub-frontier instead of the whole frontier."""
        sub = self._sub_steps(body)

        def step(ts):
            out = []
            for t in ts:
                out.extend(self._apply_steps(sub, [t]))
            return out

        self._add(step, name="local")
        return self

    def tree(self) -> "GraphTraversal":
        """Collapse the frontier into ONE nested-dict tree of all paths
        (TinkerPop TreeStep / TreeSideEffectStep's terminal form): each
        level maps a path element to the subtree of its continuations.
        Optional by() modulates per-depth keys (property key or body)."""
        by_list: List[Tuple] = []

        def step(ts):
            root: dict = {}
            for t in ts:
                node = root
                for depth, o in enumerate(t.path):
                    key = (
                        self._by_value(by_list[depth % len(by_list)], o)
                        if by_list
                        else o
                    )
                    try:
                        node = node.setdefault(key, {})
                    except TypeError:  # unhashable key: fall back to repr
                        node = node.setdefault(repr(key), {})
            return [Traverser(root)]

        self._add(step, name="tree")
        self._last_by = by_list
        return self

    def sack(self, fn=None) -> "GraphTraversal":
        """TinkerPop sack(): with no argument, map each traverser to its
        sack value; with a binary fn, fold the current object into the sack
        (`new_sack = fn(sack, value)`), where by() modulates which value is
        folded (property key or body; default: the object itself)."""
        if fn is None:
            def step(ts):
                return [t.child(t.sack, prev=t.prev) for t in ts]

            self._add(step, name="sack")
            return self

        by_list: List[Tuple] = []

        def step(ts):
            out = []
            for t in ts:
                val = (
                    self._by_value(by_list[0], t.obj) if by_list else t.obj
                )
                # fresh traverser, NOT in-place mutation: branch steps
                # (union/coalesce/choose/local) hand the SAME traverser to
                # every branch — TinkerPop split semantics require one
                # branch's sack updates to stay invisible to the others.
                # (A fn that mutates a shared mutable sack in place still
                # aliases — same caveat as TinkerPop's split contract.)
                out.append(
                    Traverser(
                        t.obj, prev=t.prev, path=t.path, tags=t.tags,
                        sack=fn(t.sack, val),
                    )
                )
            return out

        self._add(step, name="sack(fn)")
        self._last_by = by_list
        return self

    def subgraph(self, name: str) -> "GraphTraversal":
        """Collect traversed EDGES into side-effect `name`; cap(name)
        materializes the induced subgraph as a standalone in-memory graph
        (TinkerPop SubgraphStep returns a Graph). Non-edge traversers are
        rejected loudly — an edge-less subgraph() is a query bug."""

        def step(ts):
            bucket = self._side_effects.setdefault(name, [])
            for t in ts:
                if not isinstance(t.obj, Edge):
                    raise QueryError(
                        "subgraph() requires edge traversers "
                        f"(got {type(t.obj).__name__}); use outE/inE/bothE"
                    )
                bucket.append(t.obj)
            return ts

        self._subgraph_names = getattr(self, "_subgraph_names", set())
        self._subgraph_names.add(name)
        self._add(step, name=f"subgraph({name})")
        return self

    def _materialize_subgraph(self, edges):
        """Build the induced graph: new in-memory graph, auto schema, all
        endpoint vertices + the collected edges with their properties."""
        from janusgraph_tpu_torch.core.graph import open_graph

        from janusgraph_tpu_torch.core.codecs import Cardinality

        sg = open_graph({"ids.authority-wait-ms": 0.0})
        tx = sg.new_transaction()
        vmap = {}

        def grouped_props(v):
            grouped: Dict[str, list] = {}
            for p in v.properties():
                grouped.setdefault(p.key, []).append(p.value)
            return grouped

        # pre-scan EVERY endpoint's keys BEFORE copying: a key that is
        # multi-valued on any vertex must be declared LIST before the
        # auto-schema path fixes it as SINGLE from a one-valued vertex
        # (order-dependent silent value loss otherwise)
        endpoints = {}
        for e in edges:
            for v in (e.out_vertex, e.in_vertex):
                endpoints.setdefault(v.id, v)
        multi_sample = {}
        for v in endpoints.values():
            for k, vs in grouped_props(v).items():
                if len(vs) > 1 and k not in multi_sample:
                    multi_sample[k] = vs[0]
        for k, sample in multi_sample.items():
            sg.management().make_property_key(
                k, type(sample), Cardinality.LIST
            )

        def copy_vertex(v):
            if v.id not in vmap:
                grouped = grouped_props(v)
                single = {
                    k: vs[0] for k, vs in grouped.items()
                    if k not in multi_sample
                }
                nv = tx.add_vertex(v.label, **single)
                for k in grouped:
                    if k not in multi_sample:
                        continue
                    for val in grouped[k]:
                        nv.property(k, val)
                vmap[v.id] = nv
            return vmap[v.id]

        seen_edges = set()
        for e in edges:
            if e.id in seen_edges:
                continue
            seen_edges.add(e.id)
            ov = copy_vertex(e.out_vertex)
            iv = copy_vertex(e.in_vertex)
            tx.add_edge(ov, e.label, iv, **e.property_values())
        tx.commit()
        return sg

    # -- branching ------------------------------------------------------------
    def union(self, *bodies) -> "GraphTraversal":
        branches = [self._sub_steps(b) for b in bodies]

        def step(ts):
            out = []
            for t in ts:
                for br in branches:
                    out.extend(self._apply_steps(br, [t]))
            return out

        self._add(step, name=f"union[{len(branches)}]")
        return self

    def coalesce(self, *bodies) -> "GraphTraversal":
        branches = [self._sub_steps(b) for b in bodies]

        def step(ts):
            out = []
            for t in ts:
                for br in branches:
                    hits = self._apply_steps(br, [t])
                    if hits:
                        out.extend(hits)
                        break
            return out

        self._add(step, name=f"coalesce[{len(branches)}]")
        return self

    def optional_(self, body) -> "GraphTraversal":
        return self.coalesce(body, lambda t: t)

    def choose(self, predicate, true_body, false_body=None) -> "GraphTraversal":
        """Binary branch. `predicate` is a P (tested on the current object)
        or a body (non-empty result = true)."""
        t_steps = self._sub_steps(true_body)
        f_steps = self._sub_steps(false_body) if false_body is not None else None
        p_steps = (
            self._sub_steps(predicate) if callable(predicate) and not isinstance(predicate, P)
            else None
        )

        def step(ts):
            out = []
            for t in ts:
                if p_steps is not None:
                    cond = bool(self._apply_steps(p_steps, [t]))
                else:
                    cond = predicate.test(t.obj)
                if cond:
                    out.extend(self._apply_steps(t_steps, [t]))
                elif f_steps is not None:
                    out.extend(self._apply_steps(f_steps, [t]))
                else:
                    out.append(t)
            return out

        self._add(step, name="choose")
        return self

    # -- filters over sub-traversals / tags -----------------------------------
    def where(self, arg) -> "GraphTraversal":
        """where(body): keep traversers whose sub-traversal is non-empty.
        where(P): the P's condition names an as_() tag — compare the current
        object against the tagged one (TinkerPop: strings inside where() are
        step labels, e.g. .as_('x')...where(P.neq('x')))."""
        if isinstance(arg, P):
            p = arg

            def step(ts):
                out = []
                for t in ts:
                    tags = t.tags or {}
                    if isinstance(p.condition, tuple):
                        # within('a','b'): every name is a TAG whose
                        # bound object joins the membership set
                        if any(n not in tags for n in p.condition):
                            continue
                        refs = [tags[n] for n in p.condition]
                        keep = p.predicate.evaluate(t.obj, refs)
                    elif p.condition in tags:
                        ref = tags[p.condition]
                        if p.predicate is not None:
                            keep = p.predicate.evaluate(t.obj, ref)
                        else:
                            keep = p.test(t.obj)
                    else:
                        continue
                    if keep:
                        out.append(t)
                return out

            self._add(step, name=f"where({p.label})")
            return self
        steps = self._sub_steps(arg)
        self._add(
            lambda ts: [t for t in ts if self._apply_steps(steps, [t])],
            name="where(traversal)",
        )
        return self

    def not_(self, body) -> "GraphTraversal":
        steps = self._sub_steps(body)
        self._add(
            lambda ts: [t for t in ts if not self._apply_steps(steps, [t])],
            name="not",
        )
        return self

    def match(self, *patterns) -> "GraphTraversal":
        """match(__.as_('a').out('father').as_('b'), ...) — declarative
        constraint-join pattern matching (TinkerPop MatchStep subset:
        connected patterns, solved in bound-tag-first order). Each pattern
        must start at an as_() tag; a trailing as_() binds (or checks) the
        end tag; a pattern without a trailing as_() is an existence filter
        on its start binding. Solutions are emitted as tag bindings on the
        outgoing traversers, read back with select(). The reference gets
        MatchStep from TinkerPop and optimizes around it
        (JanusGraphLocalQueryOptimizerStrategy.java); here the step itself
        is part of the DSL."""
        if not patterns:
            raise ValueError("match() needs at least one pattern")
        compiled = []
        for pat in patterns:
            chain = getattr(pat, "_chain", None)
            if not chain or chain[0][0] != "as_":
                raise ValueError(
                    "match() patterns must start with __.as_(tag)"
                )
            start = chain[0][1][0]
            mid = list(chain[1:])
            end = None
            if mid and mid[-1][0] == "as_":
                end = mid[-1][1][0]
                mid = mid[:-1]
            compiled.append(
                (start, end, self._sub_steps(AnonymousTraversal(tuple(mid))))
            )

        def _key(o):
            return ("el", o.id) if isinstance(o, (Vertex, Edge)) else ("v", o)

        def step(ts):
            out = []
            for t in ts:
                base = dict(t.tags) if t.tags else {}
                # seed the current object as the first pattern's start ONLY
                # when no pattern start is already tag-bound — a pre-tagged
                # traverser supplies its own anchor (TinkerPop computed-start)
                if not any(s in base for s, _e, _st in compiled):
                    base[compiled[0][0]] = t.obj
                frontier = [base]
                pending = list(compiled)
                while pending and frontier:
                    pick = next(
                        (
                            i
                            for i, (s, _e, _m) in enumerate(pending)
                            if all(s in b for b in frontier)
                        ),
                        None,
                    )
                    if pick is None:
                        raise ValueError(
                            "match() patterns are disconnected: no "
                            "remaining pattern starts at a bound tag "
                            f"(pending: {[s for s, _e, _m in pending]})"
                        )
                    start, end, steps = pending.pop(pick)
                    nxt = []
                    for b in frontier:
                        seed = Traverser(b[start], tags=b)
                        for r in self._apply_steps(steps, [seed]):
                            rb = dict(r.tags) if r.tags else dict(b)
                            if end is None:
                                nxt.append(rb)
                                break  # existence filter: one hit suffices
                            if end in rb and _key(rb[end]) != _key(r.obj):
                                continue  # contradicts an earlier binding
                            rb = dict(rb)
                            rb[end] = r.obj
                            nxt.append(rb)
                    frontier = nxt
                for b in frontier:
                    out.append(
                        Traverser(
                            t.obj, prev=t.prev, path=t.path, tags=b,
                            sack=t.sack,
                        )
                    )
            return out

        self._add(step, name=f"match[{len(patterns)}]")
        return self

    def is_(self, arg) -> "GraphTraversal":
        # AdjacentVertexIs rewrite: `.out(lbl).is_(v)` -> adjacency lookup
        if isinstance(arg, Vertex):
            return self.has_id(arg.id)
        p = arg if isinstance(arg, P) else P.eq(arg)
        self._add(lambda ts: [t for t in ts if p.test(t.obj)], name=f"is({p.label})")
        return self

    def math(self, expression: str) -> "GraphTraversal":
        """TinkerPop MathStep: evaluate an arithmetic expression per
        traverser — ``math('_ + 100')`` (``_`` = incoming value),
        ``math('a / b')`` over as_() tag bindings, with by() extracting a
        number from element-valued variables (``math('_ * 2').by('age')``).
        Functions: abs ceil floor sqrt exp log log10 sin cos tan signum.
        The expression is AST-validated (numbers, variables, arithmetic
        operators, whitelisted calls only)."""
        import ast
        import math as _pymath

        funcs = {
            "abs": abs, "ceil": _pymath.ceil, "floor": _pymath.floor,
            "sqrt": _pymath.sqrt, "exp": _pymath.exp, "log": _pymath.log,
            "log10": _pymath.log10, "sin": _pymath.sin, "cos": _pymath.cos,
            "tan": _pymath.tan,
            "signum": lambda x: (x > 0) - (x < 0),
        }
        try:
            tree = ast.parse(expression, mode="eval")
        except SyntaxError as e:
            raise QueryError(f"math(): bad expression {expression!r}: {e}")
        _ALLOWED_OPS = (
            ast.Add, ast.Sub, ast.Mult, ast.Div, ast.Mod, ast.Pow,
            ast.USub, ast.UAdd,
        )
        call_positions = set()  # Name nodes that ARE a call's function
        name_nodes: List[ast.Name] = []
        for node in ast.walk(tree):
            if isinstance(node, (ast.Expression, ast.Load)):
                continue
            if isinstance(node, (ast.BinOp, ast.UnaryOp)):
                continue
            if isinstance(node, _ALLOWED_OPS):
                continue
            if isinstance(node, ast.Constant):
                if isinstance(node.value, bool) or not isinstance(
                    node.value, (int, float)
                ):
                    raise QueryError(
                        f"math(): non-numeric constant {node.value!r}"
                    )
                continue
            if isinstance(node, ast.Call):
                if (
                    not isinstance(node.func, ast.Name)
                    or node.func.id not in funcs
                    or node.keywords
                ):
                    raise QueryError(
                        "math(): only the built-in functions "
                        f"{sorted(funcs)} may be called"
                    )
                call_positions.add(id(node.func))
                continue
            if isinstance(node, ast.Name):
                name_nodes.append(node)
                continue
            raise QueryError(
                f"math(): {type(node).__name__} is not allowed in "
                f"{expression!r}"
            )
        # variables in SOURCE left-to-right order — by() modulators bind
        # round-robin in the order variables appear in the expression, and
        # ast.walk is breadth-first, which reorders nested operands
        variables: List[str] = []
        for node in sorted(
            name_nodes, key=lambda n: (n.lineno, n.col_offset)
        ):
            if id(node) in call_positions:
                continue
            if node.id in funcs:
                raise QueryError(
                    f"math(): {node.id!r} is a function — call it, "
                    "don't use it as a value"
                )
            if node.id not in variables:
                variables.append(node.id)
        code = compile(tree, "<math>", "eval")
        # funcs ride the (immutable) globals, built once; per-traverser
        # locals carry only the variable bindings
        gbl = {"__builtins__": {}, **funcs}
        by_list: List[Tuple] = []

        def step(ts):
            out = []
            for t in ts:
                env = {}
                for i, nm in enumerate(variables):
                    if nm == "_":
                        val = t.obj
                    else:
                        tags = t.tags or {}
                        if nm not in tags:
                            raise QueryError(
                                f"math(): variable {nm!r} is not a bound "
                                "as_() tag"
                            )
                        val = tags[nm]
                    if isinstance(val, (Vertex, Edge)) or by_list:
                        spec = (
                            by_list[i % len(by_list)]
                            if by_list else ("id", None, False)
                        )
                        val = self._by_value(spec, val)
                    if not isinstance(val, (int, float)) or isinstance(
                        val, bool
                    ):
                        raise QueryError(
                            f"math(): variable {nm!r} is "
                            f"{type(val).__name__}, not a number "
                            "(use by('key') to extract one)"
                        )
                    env[nm] = val
                try:
                    res = eval(code, gbl, env)
                except QueryError:
                    raise
                except Exception as e:
                    # divergence note: Java doubles yield Infinity/NaN on
                    # division by zero; here every evaluation error is a
                    # uniform QueryError (the step's whole contract)
                    raise QueryError(
                        f"math({expression!r}): {type(e).__name__}: {e}"
                    )
                out.append(t.child(res))
            return out

        self._add(step, name=f"math({expression})")
        self._last_by = by_list
        return self

    # -- OLAP-bridge steps ----------------------------------------------------
    def _olap_annotate(self, program, state_key, key, to_value, name):
        """Shared body of the traversal-embedded OLAP steps (TinkerPop
        pageRank()/connectedComponent(), which the reference routes
        through FulgoraGraphComputer as a TraversalVertexProgram stage):
        a BARRIER that runs `program` on the graph's configured OLAP
        executor over the COMMITTED graph, then exposes the result via a
        TRAVERSAL-LOCAL overlay — downstream values(key)/order().by(key)/
        has(key)/value_map/group_count of THIS traversal read it like a
        property, nothing is ever written to the transaction or schema
        (the reference's computer results are likewise never persisted),
        read-only transactions work, and other traversals never see it.
        Uncommitted vertices are not in the compute scope and stay
        unannotated. Persist explicitly with
        graph.compute().program(...).submit().write_back()."""
        source = self.source

        def step(ts):
            if not ts:  # nothing downstream can read the annotation
                return ts
            res = source.graph.compute().program(program).submit()
            if to_value is None:
                by_vid = res.by_vertex(state_key)
            else:
                by_vid = {
                    int(v): to_value(res, x)
                    for v, x in zip(
                        res.csr.vertex_ids, res.states[state_key]
                    )
                }
            ov = self._olap_overlay
            for vid, val in by_vid.items():
                ov.setdefault(vid, {})[key] = val
            return ts

        self._add(step, name=name)
        return self

    def page_rank(
        self, key: str = "pagerank", iterations: int = 20,
        alpha: float = 0.85,
    ) -> "GraphTraversal":
        """TinkerPop pageRank() step: ``g.V().page_rank().order().by(
        'pagerank', reverse=True).limit(3)`` — runs PageRank on the OLAP
        engine (the card or the CPU per computer.executor) and exposes the
        rank as the `key` property of the frontier's vertices.
        ``page_rank(0.85)`` (TinkerPop's alpha overload) is honored as
        the damping factor."""
        from janusgraph_tpu_torch.olap.programs import PageRankProgram

        if isinstance(key, (int, float)) and not isinstance(key, bool):
            alpha, key = float(key), "pagerank"
        return self._olap_annotate(
            PageRankProgram(damping=alpha, max_iterations=iterations),
            "rank", key, None, f"pageRank({key})",
        )

    def connected_component(
        self, key: str = "component", iterations: int = 200
    ) -> "GraphTraversal":
        """TinkerPop connectedComponent() step: the component id is the
        smallest member VERTEX ID (stable across runs, like the
        reference's smallest-element-id convention)."""
        from janusgraph_tpu_torch.olap.programs import ConnectedComponentsProgram

        return self._olap_annotate(
            ConnectedComponentsProgram(max_iterations=iterations),
            "component", key,
            lambda res, x: int(res.csr.vertex_ids[int(x)]),
            f"connectedComponent({key})",
        )

    def shortest_path(
        self, target=None, max_hops: int = 10,
        weight_key: Optional[str] = None,
    ) -> "GraphTraversal":
        """TinkerPop shortestPath() step (the reference special-cases the
        backing program at FulgoraGraphComputer.java:249-253): for each
        incoming VERTEX, run the frontier-compacted BFS with predecessor
        tracking on the OLAP engine and emit one PATH (list of vertices,
        source first) per reached target. `target` filters the targets
        (an anonymous traversal, evaluated per candidate target vertex);
        the source itself is never a target. `weight_key` switches to
        weighted (Dijkstra-equivalent) paths over that edge property: the
        device program relaxes distances to fixpoint and the predecessor
        array derives host-side from the relaxation equation
        (weighted_predecessors). Paths reflect the COMMITTED graph (the
        OLAP snapshot), like the other computer steps."""
        from janusgraph_tpu_torch.olap.computer import executor_device, run_on
        from janusgraph_tpu_torch.olap.csr import load_csr
        from janusgraph_tpu_torch.olap.programs import ShortestPathProgram
        from janusgraph_tpu_torch.olap.programs.shortest_path import (
            INF,
            reconstruct_path,
            weighted_predecessors,
        )

        source = self.source
        target_steps = (
            self._sub_steps(target) if target is not None else None
        )

        def step(ts):
            import numpy as np

            sources = [t for t in ts if isinstance(t.obj, Vertex)]
            if not sources:
                return []
            if weight_key is not None and not _is_property_key(
                source.graph, weight_key
            ):
                raise QueryError(
                    f"shortest_path: weight_key {weight_key!r} is not a "
                    "property key in the schema"
                )
            csr = load_csr(source.graph, weight_key=weight_key)
            index_of = {
                int(v): i for i, v in enumerate(csr.vertex_ids)
            }
            # the reference passes computer.executor to run_on: "sharded"
            # runs the sharded executor over the default mesh; the port's
            # run_on takes the strategy third, so "tpu" and "cpu" become
            # the device they name
            executor = source.graph.config.get("computer.executor")
            run_kw = (
                {"executor": "sharded"} if executor == "sharded"
                else {"device": executor_device(executor)}
            )
            tx = self.tx
            # per-vertex caches shared across ALL (source, target) pairs:
            # the target verdict and the vid->Vertex fetch are per-vertex
            # facts, not per-pair
            vertex_cache: dict = {}
            verdict_cache: dict = {}

            def _vertex_at(i):
                if i not in vertex_cache:
                    vertex_cache[i] = tx.get_vertex(int(csr.vertex_ids[i]))
                return vertex_cache[i]

            def _is_target(i):
                if target_steps is None:
                    return True
                if i not in verdict_cache:
                    tv = _vertex_at(i)
                    verdict_cache[i] = tv is not None and bool(
                        self._apply_steps(target_steps, [Traverser(tv)])
                    )
                return verdict_cache[i]

            out = []
            for t in sources:
                seed = index_of.get(t.obj.id)
                if seed is None:  # uncommitted vertex: not in the snapshot
                    continue
                # weighted mode MUST reach the relaxation fixpoint (the
                # predecessor derivation requires it) — the program stops
                # early at fixpoint anyway, so the cap is just a
                # Bellman-Ford worst-case bound; max_hops caps only the
                # unweighted hop count
                res = run_on(
                    csr,
                    ShortestPathProgram(
                        seed_index=seed,
                        max_iterations=(
                            max_hops if weight_key is None
                            else csr.num_vertices + 1
                        ),
                        weighted=weight_key is not None,
                        track_paths=weight_key is None,
                    ),
                    **run_kw,
                )
                res = dict(res)
                if weight_key is not None:
                    res["predecessor"] = weighted_predecessors(
                        csr, res, seed
                    )
                dist = np.asarray(res["distance"])
                for ti in range(len(dist)):
                    if ti == seed or dist[ti] >= INF:
                        continue
                    if _vertex_at(ti) is None or not _is_target(ti):
                        continue
                    chain = reconstruct_path(res, ti)
                    if chain is None:
                        continue
                    path_vs = [_vertex_at(i) for i in chain]
                    if any(v is None for v in path_vs):
                        continue
                    out.append(t.child(path_vs, prev=t.prev))
            return out

        self._add(step, name="shortestPath")
        return self

    def peer_pressure(
        self, key: str = "cluster", rounds: int = 30
    ) -> "GraphTraversal":
        """TinkerPop peerPressure() step: label-propagation clustering on
        the OLAP engine; the cluster id lands in the overlay like the
        other computer steps."""
        from janusgraph_tpu_torch.olap.programs import PeerPressureProgram

        return self._olap_annotate(
            PeerPressureProgram(rounds=rounds), "cluster", key,
            # cluster id = a member VERTEX ID (TinkerPop's convention,
            # same as connected_component), not the internal CSR index
            lambda res, x: int(res.csr.vertex_ids[int(x)]),
            f"peerPressure({key})",
        )

    # -- projections over sub-traversals --------------------------------------
    def project(self, *names: str) -> "GraphTraversal":
        """project('a','b').by(...).by(...) — one dict per traverser."""
        by_list: List[Tuple] = []

        def step(ts):
            out = []
            for t in ts:
                d = {}
                for i, nm in enumerate(names):
                    spec = (
                        by_list[i % len(by_list)] if by_list else ("id", None, False)
                    )
                    d[nm] = self._by_value(spec, t.obj)
                out.append(t.child(d, prev=t.prev))
            return out

        self._add(step, name=f"project{names!r}")
        self._last_by = by_list
        return self

    def group(self) -> "GraphTraversal":
        """group().by(key_spec).by(value_spec) — ONE dict traverser:
        {key: [values]} (TinkerPop group semantics with list fold)."""
        by_list: List[Tuple] = []

        def step(ts):
            key_spec = by_list[0] if by_list else ("id", None, False)
            val_spec = by_list[1] if len(by_list) > 1 else ("id", None, False)
            m: dict = {}
            for t in ts:
                k = self._by_value(key_spec, t.obj)
                if isinstance(k, (Vertex, Edge)):
                    k = k.id
                m.setdefault(k, []).append(self._by_value(val_spec, t.obj))
            return [Traverser(m)]

        self._add(step, name="group")
        self._last_by = by_list
        return self

    def fold(self) -> "GraphTraversal":
        self._add(lambda ts: [Traverser([t.obj for t in ts])], name="fold")
        return self

    def count_(self) -> "GraphTraversal":
        """count as a STEP (for use inside bodies / by() modulators, like
        TinkerPop's mid-traversal count()); the terminal form is count()."""
        self._add(lambda ts: [Traverser(len(ts))], name="count")
        self._steps[-1]._spill_meta = ("count",)
        return self

    def unfold(self) -> "GraphTraversal":
        def step(ts):
            out = []
            for t in ts:
                if isinstance(t.obj, dict):
                    out.extend(t.child(kv) for kv in t.obj.items())
                elif isinstance(t.obj, (list, tuple, set)):
                    out.extend(t.child(o) for o in t.obj)
                else:
                    out.append(t)
            return out

        self._add(step, name="unfold")
        return self

    # -- repeat ---------------------------------------------------------------
    def repeat(
        self,
        body: Callable[["GraphTraversal"], "GraphTraversal"],
        times: Optional[int] = None,
        until=None,
        emit: bool = False,
        max_loops: Optional[int] = None,
    ) -> "GraphTraversal":
        """t.repeat(lambda t: t.out('knows'), times=3)
        t.repeat(body, until=lambda t: t.has('name','x'))  # do-while
        t.repeat(body, times=5, emit=True)  # emit intermediate traversers

        TinkerPop repeat().until()/emit() semantics: the body runs, then the
        until filter splits satisfied traversers out of the loop; emit copies
        every surviving traverser into the output each round. `max_loops`
        bounds until-only loops (cycles would otherwise never drain).

        The REAL Gremlin spelling chains the loop controls as modulators —
        ``repeat(out('knows')).times(2)``, ``repeat(...).until(...)``,
        ``repeat(...).emit()`` — so a bare repeat(body) defers: the
        following times()/until()/emit() calls complete it, and execution
        without any control raises. (Pre-positioned ``until().repeat()``
        do-while ordering is not supported — use the kwargs.)"""
        body_steps = self._sub_steps(body)
        if max_loops is None:
            # query.max-repeat-loops bounds until-only loops graph-wide
            cfg = getattr(self.tx.graph, "config", None)
            max_loops = cfg.get("query.max-repeat-loops") if cfg else 64
        spec = {
            "times": times,
            "until_steps": (
                self._sub_steps(until) if until is not None else None
            ),
            "emit": emit,
            "emit_steps": None,
        }

        def step(ts):
            times_ = spec["times"]
            until_steps = spec["until_steps"]
            emit_ = spec["emit"]
            if times_ is None and until_steps is None and not emit_:
                raise QueryError(
                    "repeat() needs times()/until()/emit() — chained "
                    "modulators or the times=/until=/emit= kwargs"
                )
            results: List[Traverser] = []
            frontier = ts
            loops = 0
            bound = times_ if times_ is not None else max_loops
            cap = getattr(self.tx.graph, "_max_traversers", 0)
            while frontier and loops < bound:
                frontier = self._apply_steps(body_steps, frontier)
                loops += 1
                for t in frontier:  # TinkerPop loops() visibility
                    t.loops = loops
                if cap and len(frontier) + len(results) > cap:
                    raise QueryError(
                        f"traverser count {len(frontier) + len(results)} "
                        f"exceeds query.max-traversers ({cap}) in "
                        f"repeat() loop {loops}"
                    )
                if until_steps is not None:
                    cont = []
                    for t in frontier:
                        if self._apply_steps(until_steps, [t]):
                            results.append(t)
                        else:
                            cont.append(t)
                    frontier = cont
                if emit_:
                    es = spec["emit_steps"]
                    emitted = (
                        frontier if es is None else
                        [t for t in frontier
                         if self._apply_steps(es, [t])]
                    )
                    for t in emitted:
                        c = Traverser(
                            t.obj, prev=t.prev, path=t.path,
                            tags=t.tags, sack=t.sack,
                        )
                        c.loops = t.loops
                        results.append(c)
            if until_steps is None and not emit_:
                return frontier
            if until_steps is not None and not emit_:
                # loop bound exhausted: remaining traversers exit as output
                results.extend(frontier)
            return results

        self._add(step, name="repeat")
        # open the modulator window AFTER _add (which closes the previous
        # one): chained times()/until()/emit() write into this spec
        self._last_repeat = spec
        return self

    def times(self, n: int) -> "GraphTraversal":
        """Loop-count modulator for the preceding repeat() (the Gremlin
        ``repeat(...).times(n)`` spelling)."""
        spec = getattr(self, "_last_repeat", None)
        if spec is None:
            raise QueryError("times() must follow repeat()")
        spec["times"] = n
        return self

    def until(self, cond) -> "GraphTraversal":
        """Exit-condition modulator for the preceding repeat()
        (post-positioned only — do-while ``until().repeat()`` ordering is
        not supported; use repeat(body, until=...))."""
        spec = getattr(self, "_last_repeat", None)
        if spec is None:
            raise QueryError(
                "until() must follow repeat() (pre-positioned until() is "
                "not supported — use repeat(body, until=...))"
            )
        spec["until_steps"] = self._sub_steps(cond)
        return self

    def emit(self, arg=True) -> "GraphTraversal":
        """Emit modulator for the preceding repeat(): copy surviving
        traversers into the output each round. ``emit(predicate)`` (an
        anonymous traversal / callable) emits only the traversers the
        filter passes — the Gremlin emit(has(...)) form."""
        spec = getattr(self, "_last_repeat", None)
        if spec is None:
            raise QueryError("emit() must follow repeat()")
        if isinstance(arg, bool):
            spec["emit"] = arg
        else:
            spec["emit"] = True
            spec["emit_steps"] = self._sub_steps(arg)
        return self

    # -- aggregation ---------------------------------------------------------
    def count(self) -> int:
        # OLTP->OLAP spillover (olap/spillover.py): a promoted multi-hop
        # count never materializes its traverser multiset — the planner
        # reduces the device-side count vector directly
        total = self._try_spillover(terminal="count")
        if total is not None:
            return total
        # one planner decision per query: the row walk below must not
        # re-attempt (a stale-snapshot refusal would repack mid-query)
        self._spill_skip_once = True
        return len(self._execute())

    def sum_(self):
        return sum(t.obj for t in self._execute())

    def max_(self):
        vals = [t.obj for t in self._execute()]
        return max(vals) if vals else None

    def min_(self):
        vals = [t.obj for t in self._execute()]
        return min(vals) if vals else None

    def mean_(self):
        vals = [t.obj for t in self._execute()]
        return sum(vals) / len(vals) if vals else None

    def group_count(self, key: Optional[str] = None) -> dict:
        ts = self._execute()
        if key is None:
            return dict(Counter(t.obj for t in ts))
        return dict(Counter(self._elem_val(t, key) for t in ts))

    # -- terminals -----------------------------------------------------------
    def _try_spillover(self, terminal=None):
        """OLTP->OLAP spillover planner hook (olap/spillover.py): a
        promoted hot multi-hop shape executes as frontier-expansion
        supersteps over the cached CSR snapshot (tx overlay reconciled
        for read-your-writes); None = run row by row. The planner feeds
        the digest table itself, so the caller skips _observe_digest on
        a spilled run."""
        if self._start is None:
            return None
        from janusgraph_tpu_torch.olap.spillover import try_spill

        return try_spill(self, terminal=terminal)

    def _execute(self, observe=None) -> List[Traverser]:
        """One execution path for plain runs and .profile(): `observe` wraps
        every stage invocation (label, fn, input) -> output."""
        if self._start is None:
            raise QueryError(
                "anonymous (sub-traversal) bodies cannot be executed directly"
            )
        # fresh side-effect buckets per execution: re-running a traversal
        # must not accumulate aggregate()/store() contents across runs
        self._side_effects.clear()
        if observe is None:
            # .profile() wants the real per-step walk — spillover only
            # intercepts plain executions (and count() consumes its own
            # attempt before delegating here)
            if getattr(self, "_spill_skip_once", False):
                self._spill_skip_once = False
            else:
                spilled = self._try_spillover()
                if spilled is not None:
                    return spilled
        run = observe if observe is not None else (lambda _label, fn, ts: fn(ts))
        import time as _time

        from janusgraph_tpu_torch.observability.profiler import current_ledger

        _led = current_ledger()
        _cells0 = _led.op_cells() if _led is not None else 0
        t0 = _time.perf_counter()
        ts = run("start", lambda _: self._start.run(self._pre_has), None)
        init = getattr(self.source, "_sack_init", None)
        if init is not None:
            for t in ts:
                t.sack = init()
        # query.max-traversers: frontier-size budget — an exploding chain
        # (e.g. an unbounded repeat().emit() on a cyclic label doubles the
        # frontier every loop) fails loudly instead of consuming the
        # process (the reference's Gremlin Server bounds runaway scripts
        # with evaluationTimeout; a Python thread cannot be interrupted,
        # so the budget is on SIZE, which is what actually explodes)
        cap = getattr(self.tx.graph, "_max_traversers", 0)
        from janusgraph_tpu_torch.core import deadline as _deadline

        for step in self._steps:
            # wall-clock deadline on EVALUATION (core/deadline.py): a
            # Python thread cannot be interrupted, so the budget is
            # checked at every step boundary — a deep traversal whose
            # caller gave up aborts between steps instead of walking on
            _deadline.check("traversal step")
            ts = run(getattr(step, "_label", "step"), step, ts)
            if cap and len(ts) > cap:
                raise QueryError(
                    f"traverser count {len(ts)} exceeds "
                    f"query.max-traversers ({cap}) after "
                    f"{getattr(step, '_label', 'step')!r}"
                )
        # metrics.slow-query-threshold-ms: observability for outlier
        # traversals; resolved once at graph open (hot path)
        elapsed_ms = (_time.perf_counter() - t0) * 1000.0
        thr = getattr(self.tx.graph, "_slow_query_threshold_ms", 0.0)
        if thr > 0 and elapsed_ms > thr:
            from janusgraph_tpu_torch.util.metrics import metrics as _mm

            _mm.counter("query.slow").inc()
        self._observe_digest(
            elapsed_ms,
            (_led.op_cells() - _cells0) if _led is not None else 0,
        )
        return ts

    def _observe_digest(self, elapsed_ms: float, cells: int) -> None:
        """Normalize this traversal to its shape digest (step vocabulary
        + resolved index choice, literals stripped), feed the bounded
        top-K digest table, and annotate the ambient span so slow-op and
        flight `slow_span` events group recurring offenders by shape."""
        from janusgraph_tpu_torch.observability import tracer
        from janusgraph_tpu_torch.observability.profiler import (
            digest_table,
            shape_digest,
            traversal_shape,
        )

        shape = traversal_shape(
            [getattr(s, "_label", "step") for s in self._steps],
            getattr(self._start, "plan", None),
        )
        digest = shape_digest(shape)
        digest_table.observe(digest, shape, elapsed_ms, cells=cells)
        sp = tracer.current()
        if sp is not None:
            sp.annotate(digest=digest)

    def profile(self):
        """Execute with per-step timing and plan annotations (reference:
        Gremlin .profile() → QueryProfiler via TP3ProfileWrapper.java;
        annotations mirror SimpleQueryProfiler's condition/index notes).
        The whole execution runs under a fresh ResourceLedger, so the
        returned metrics carry a ``resources`` block (cells, bytes, index
        hits — the same cost vocabulary OLAP run records use)."""
        from janusgraph_tpu_torch.core.profile import QueryProfiler, TraversalMetrics
        from janusgraph_tpu_torch.observability import tracer
        from janusgraph_tpu_torch.observability.profiler import ledger_scope

        root = QueryProfiler("traversal")

        def observe(label, fn, ts):
            p = root.add_nested(label)
            # each stage runs inside a span too, so storage/index spans
            # (store.getSlice, index.lookup, ...) nest under the step —
            # their counts feed back into the profiler annotations
            with p, tracer.span(f"oltp.step.{label}") as stage:
                out = fn(ts)
            p.annotate("traversers", len(out))
            if stage.children:
                p.annotate("store_ops", len(stage.children))
                p.annotate(
                    "store_ms",
                    round(sum(c.duration_ms for c in stage.children), 3),
                )
            if label == "start":
                if self._pre_has:
                    p.annotate(
                        "conditions",
                        [f"{k or 'label'}:{pr.label}" for k, pr in self._pre_has],
                    )
                for k, v in getattr(self._start, "plan", {}).items():
                    p.annotate(k, v)
            return out

        with ledger_scope() as led:
            with root, tracer.span("oltp.traversal"):
                ts = self._execute(observe)
        resources = led.to_dict()
        if resources:
            root.annotate("resources", resources)
        return TraversalMetrics(root, [t.obj for t in ts], resources)

    def to_list(self) -> List[object]:
        return [t.obj for t in self._execute()]

    def to_set(self) -> set:
        return set(self.to_list())

    def to_bulk_set(self):
        """TinkerPop toBulkSet(): results with multiplicity — a Counter
        keyed by result object."""
        return Counter(self.to_list())

    def next(self):
        res = self._execute()
        if not res:
            raise QueryError("traversal returned no results")
        return res[0].obj

    def try_next(self):
        res = self._execute()
        return res[0].obj if res else None

    def iterate(self) -> None:
        self._execute()

    def __iter__(self):
        return iter(self.to_list())
