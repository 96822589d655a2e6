"""Gremlin-text compatibility for the query endpoint — the port's copy of
``janusgraph_tpu/server/gremlin_compat.py``.

The server's DSL is Python-syntax Gremlin; REAL Gremlin text differs only
lexically: camelCase step names (`outE`, `elementMap`) and steps named by
Python reserved words (`.in(...)`, `.as('a')`, `.not(...)`, `.from(...)`).
This module rewrites a Gremlin string to the DSL at the TOKEN level —
string literals are untouched, python-named queries pass through
unchanged (every mapping source is camelCase or a reserved word, which
the DSL never uses) — so one endpoint serves both dialects
(reference: the gremlin-groovy scripts JanusGraph server evaluates).
"""

from __future__ import annotations

import io
import token as token_mod
import tokenize

#: camelCase / reserved-word Gremlin step -> DSL method. Sources are
#: exactly the names the DSL does NOT define, so translation is idempotent
#: and cannot touch a python-named query.
STEP_MAP = {
    # reserved words
    "in": "in_",
    "as": "as_",
    "not": "not_",
    "is": "is_",
    "from": "from_",
    "and": "and_",
    "or": "or_",
    "with": "with_",
    # camelCase steps
    "outE": "out_e",
    "inE": "in_e",
    "bothE": "both_e",
    "outV": "out_v",
    "inV": "in_v",
    "bothV": "both_v",
    "otherV": "other_v",
    "addE": "add_e_",
    "addV": "add_v_",
    "hasNot": "has_not",
    "hasLabel": "has_label",
    "hasId": "has_id",
    "elementMap": "element_map",
    "valueMap": "value_map",
    "groupCount": "group_count",
    "simplePath": "simple_path",
    "cyclicPath": "cyclic_path",
    "sideEffect": "side_effect",
    "tryNext": "try_next",
    "toList": "to_list",
    "toSet": "to_set",
    "toBulkSet": "to_bulk_set",
    "withSack": "with_sack",
    "mergeV": "merge_v",
    "mergeE": "merge_e",
    "onCreate": "on_create",
    "onMatch": "on_match",
    "pageRank": "page_rank",
    "connectedComponent": "connected_component",
    "shortestPath": "shortest_path",
    "peerPressure": "peer_pressure",
    "hasKey": "has_key",
    "hasValue": "has_value",
    "flatMap": "flat_map",
    "map": "map_",
    "propertyMap": "property_map",
}

#: step names that collide with structure-token attributes (T.id): only
#: rewritten in CALL position — `.id()` is the step, `T.id` is the token
CALL_ONLY_STEP_MAP = {"id": "id_"}

#: bare Gremlin predicates -> P methods (Gremlin exposes them unqualified)
PREDICATE_MAP = {
    "eq": "eq", "neq": "neq", "gt": "gt", "gte": "gte", "lt": "lt",
    "lte": "lte", "within": "within", "without": "without",
    "between": "between",
    "textContains": "text_contains",
    "textContainsPrefix": "text_contains_prefix",
    "textContainsRegex": "text_contains_regex",
    "textContainsFuzzy": "text_contains_fuzzy",
    "textContainsPhrase": "text_contains_phrase",
    "textPrefix": "text_prefix", "textRegex": "text_regex",
    "textFuzzy": "text_fuzzy",
    "geoWithin": "geo_within", "geoIntersect": "geo_intersect",
    "geoDisjoint": "geo_disjoint", "geoContains": "geo_contains",
}


def translate(text: str) -> str:
    """Rewrite Gremlin-dialect step names to the DSL. Token-level: string
    literals and python-named queries are untouched."""
    out = []
    try:
        tokens = list(
            tokenize.generate_tokens(io.StringIO(text).readline)
        )
    except (tokenize.TokenError, IndentationError):
        return text  # let the AST sandbox produce the real error
    for i, tok in enumerate(tokens):
        ttype, string, start, end, line = tok
        if ttype == token_mod.NAME and string in STEP_MAP:
            # dotted steps AND bare anonymous steps (Gremlin-Groovy's
            # static imports: where(not(...)), where(out(...))): reserved
            # words can't appear as operators in the sandbox DSL (Compare/
            # BoolOp nodes aren't whitelisted), so the rewrite is safe
            # everywhere; bare predicates resolve via compat_namespace
            string = STEP_MAP[string]
        elif ttype == token_mod.NAME and string in CALL_ONLY_STEP_MAP:
            # names that are ALSO structure-token attributes (T.id): only
            # the call position `.id()` is the step — `T.id` stays intact
            nxt = next(
                (t for t in tokens[i + 1:]
                 if t[0] not in (token_mod.NL, token_mod.NEWLINE,
                                 tokenize.COMMENT)),
                None,
            )
            if nxt is not None and nxt[1] == "(":
                string = CALL_ONLY_STEP_MAP[string]
        out.append((ttype, string))
    try:
        return tokenize.untokenize(out)
    except ValueError:
        return text


def compat_namespace() -> dict:
    """Extra names the Gremlin dialect expects unqualified: the predicate
    vocabulary under its Gremlin spellings, and ANONYMOUS STEPS as the
    Gremlin-Groovy static imports (`where(out('x'))` without `__.`) —
    each bare step name binds to the `__` recorder's method."""
    from janusgraph_tpu_torch.core.codecs import Direction
    from janusgraph_tpu_torch.core.traversal import (
        AnonymousTraversal,
        GraphTraversal,
        P,
        Pick,
        T,
    )

    anon = AnonymousTraversal()
    ns = {"P": P, "__": anon, "T": T, "Direction": Direction,
          "Pick": Pick}
    for gname, pname in PREDICATE_MAP.items():
        ns[gname] = getattr(P, pname)
    # every public GraphTraversal step, under BOTH spellings (the recorder
    # resolves lazily, so binding is just attribute access on __)
    for m in dir(GraphTraversal):
        if not m.startswith("_"):
            ns.setdefault(m, getattr(anon, m))
    for gname, dname in STEP_MAP.items():
        if hasattr(GraphTraversal, dname):
            ns.setdefault(gname, getattr(anon, dname))
    return ns
