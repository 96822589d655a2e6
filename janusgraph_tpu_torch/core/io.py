"""Graph import/export: line-delimited GraphSON (the TinkerPop io() step /
GraphSONWriter analogue the reference inherits — graph.io(graphson()).
writeGraph(...) — re-shaped as plain functions over the public API).

Format: one JSON object per line, {"kind": "vertex"|"edge", ...} with
property values framed by the driver's typed GraphSON codec, so every
registered datatype (Geoshape included) round-trips. Vertex ids are
preserved as "original_id" and remapped on import (ids are assigned by
the target graph's authority — imports into a live cluster must not
collide with its id blocks).

The port's copy of ``janusgraph_tpu/core/io.py`` (all of it): the same
files for the same graph, so either package imports the other's export.
As in the reference, values of eight datatypes (Float, Int, Short, Byte,
Long64, UUID, Decimal, Bytes) come back as another type
(``driver/graphson.py``), so their import raises ``SchemaViolationError``
unless the target graph declares those keys first with the type they
come back as.
"""

from __future__ import annotations

import json
from typing import Dict, Optional, TextIO, Union


def export_graphson(graph, path_or_file: Union[str, TextIO]) -> Dict[str, int]:
    """Write every vertex (with properties + label) and edge to
    line-delimited GraphSON. Returns {"vertices": n, "edges": m}."""
    from janusgraph_tpu_torch.core.codecs import Direction
    from janusgraph_tpu_torch.driver.graphson import _encode

    close = False
    if isinstance(path_or_file, str):
        f = open(path_or_file, "w")
        close = True
    else:
        f = path_or_file
    nv = ne = 0
    # schema records first: the importing graph must know cardinalities
    # and datatypes BEFORE values arrive (a LIST key re-created as SINGLE
    # by auto-schema would silently drop all but the last entry)
    from janusgraph_tpu_torch.core.schema import _DATA_TYPE_NAMES

    mgmt = graph.management()
    for pk in mgmt.property_keys():
        f.write(json.dumps({
            "kind": "propertykey", "name": pk.name,
            "dataType": _DATA_TYPE_NAMES[pk.data_type],
            "cardinality": int(pk.cardinality),
        }) + "\n")
    for vl in mgmt.vertex_labels():
        f.write(json.dumps({
            "kind": "vertexlabel", "name": vl.name,
            "partitioned": vl.partitioned, "static": vl.static,
        }) + "\n")
    for el in mgmt.edge_labels():
        f.write(json.dumps({
            "kind": "edgelabel", "name": el.name,
            "multiplicity": int(el.multiplicity),
        }) + "\n")
    tx = graph.new_transaction()
    try:
        # ONE pass: each vertex record followed by its OUT edges (import
        # resolves forward references, so record order is free and the
        # second full-graph scan would be pure wasted I/O)
        for v in tx.vertices():
            props = []
            for p in v.properties():
                rec = {"key": p.key, "value": _encode(p.value)}
                metas = p.property_values()
                if metas:
                    # META-properties ride a nested typed map (TinkerPop
                    # GraphSON writes vp properties the same way)
                    rec["properties"] = {
                        mk: _encode(mv) for mk, mv in metas.items()
                    }
                props.append(rec)
            f.write(json.dumps({
                "kind": "vertex", "original_id": v.id, "label": v.label,
                "properties": props,
            }) + "\n")
            nv += 1
            for e in tx.get_edges(v, Direction.OUT, ()):
                f.write(json.dumps({
                    "kind": "edge",
                    "label": e.label,
                    "out": e.out_vertex.id,
                    "in": e.in_vertex.id,
                    "properties": {
                        k: _encode(val)
                        for k, val in e.property_values().items()
                    },
                }) + "\n")
                ne += 1
    finally:
        tx.rollback()
        if close:
            f.close()
    return {"vertices": nv, "edges": ne}


def import_graphson(
    graph,
    path_or_file: Union[str, TextIO],
    batch_size: int = 1000,
) -> Dict[str, int]:
    """Load a line-delimited GraphSON export into `graph` (ids remapped;
    commits every `batch_size` elements). Edges whose endpoints are
    already imported process as encountered; FORWARD references defer in
    memory until the end — exports from export_graphson (vertex followed
    by its out-edges) defer only edges pointing at later vertices.
    Returns {"vertices": n, "edges": m}.

    NOT atomic: each batch commits durably as it completes, so a failure
    mid-file (malformed record, constraint violation, edge referencing an
    unknown vertex) leaves earlier batches in the graph. The raised
    exception carries ``committed = {"vertices": n, "edges": m}`` — the
    counts that are already durable — so callers can detect a partial
    import and clean up (or re-export/re-import into a fresh graph)."""
    from janusgraph_tpu_torch.driver.graphson import _decode

    close = False
    if isinstance(path_or_file, str):
        f = open(path_or_file)
        close = True
    else:
        f = path_or_file
    id_map: Dict[int, int] = {}
    nv = ne = 0
    nv_committed = ne_committed = 0
    tx = graph.new_transaction(read_only=False)
    pending = 0

    def maybe_commit():
        nonlocal tx, pending, nv_committed, ne_committed
        pending += 1
        if pending >= batch_size:
            tx.commit()
            nv_committed, ne_committed = nv, ne
            tx = graph.new_transaction(read_only=False)
            pending = 0

    def add_edge_record(obj):
        nonlocal ne
        out_id = id_map.get(obj["out"])
        in_id = id_map.get(obj["in"])
        if out_id is None or in_id is None:
            raise ValueError(
                f"edge references unknown vertex {obj['out']}→{obj['in']}"
            )
        v_out = tx.get_vertex(out_id)
        v_in = tx.get_vertex(in_id)
        if v_out is None or v_in is None:
            raise ValueError(
                f"edge endpoint not visible in the import tx "
                f"({obj['out']}→{obj['in']})"
            )
        e = tx.add_edge(v_out, obj["label"], v_in)
        for k, val in obj.get("properties", {}).items():
            e.set_property(k, _decode(val))
        ne += 1
        maybe_commit()

    try:
        deferred_edges = []
        for line in f:
            line = line.strip()
            if not line:
                continue
            obj = json.loads(line)
            kind = obj["kind"]
            if kind in ("propertykey", "vertexlabel", "edgelabel"):
                _ensure_schema(graph, obj)
                continue
            if obj["kind"] == "vertex":
                label = obj.get("label") or None
                v = tx.add_vertex(label if label != "vertex" else None)
                # per-entry add_property, NOT kwargs: multi-valued
                # (LIST/SET) keys keep every entry, and a property that
                # happens to be named "label" cannot collide with the
                # label argument
                for p in obj.get("properties", ()):
                    tx.add_property(
                        v, p["key"], _decode(p["value"]),
                        **{
                            mk: _decode(mv)
                            for mk, mv in p.get("properties", {}).items()
                        },
                    )
                id_map[obj["original_id"]] = v.id
                nv += 1
                maybe_commit()
            elif obj["kind"] == "edge":
                if obj["out"] in id_map and obj["in"] in id_map:
                    add_edge_record(obj)  # streamable: endpoints known
                else:
                    deferred_edges.append(obj)  # forward reference
            else:
                raise ValueError(f"unknown record kind {obj['kind']!r}")
        for obj in deferred_edges:
            add_edge_record(obj)
        tx.commit()
        nv_committed, ne_committed = nv, ne
    except BaseException as exc:
        # see docstring: earlier batches are already durable — surface how
        # much so the caller can clean up the partial import
        exc.committed = {"vertices": nv_committed, "edges": ne_committed}
        raise
    finally:
        try:
            tx.rollback()  # no-op after a successful commit; on error it
            # releases the dangling backend transaction
        except Exception:  # noqa: BLE001 — teardown must not mask errors
            pass
        if close:
            f.close()
    return {"vertices": nv, "edges": ne}


def _ensure_schema(graph, obj) -> None:
    """Create an exported schema element in the target when absent
    (existing definitions win — imports into populated graphs must not
    clobber their schema)."""
    from janusgraph_tpu_torch.core.codecs import Cardinality, Multiplicity
    from janusgraph_tpu_torch.core.schema import _DATA_TYPES

    if graph.schema_cache.get_by_name(obj["name"]) is not None:
        return
    mgmt = graph.management()
    if obj["kind"] == "propertykey":
        mgmt.make_property_key(
            obj["name"], _DATA_TYPES[obj["dataType"]],
            Cardinality(obj["cardinality"]),
        )
    elif obj["kind"] == "vertexlabel":
        mgmt.make_vertex_label(
            obj["name"], partitioned=obj.get("partitioned", False),
            static=obj.get("static", False),
        )
    else:
        mgmt.make_edge_label(
            obj["name"], Multiplicity(obj.get("multiplicity", 0)),
        )


# ---------------------------------------------------------------- GraphML
# (reference: graph.io(IoCore.graphml()) — the TinkerPop interchange XML;
# JanusGraph.java io() support, demo data ships as grateful-dead.xml.)
# TinkerPop conventions honored: vertex label under <data key="labelV">,
# edge label under <data key="labelE">, typed <key> declarations.

_GRAPHML_PARSERS = {
    "string": str, "int": int, "long": int,
    "float": float, "double": float,
    # xs:boolean lexical space: true/false/1/0 (case tolerated)
    "boolean": lambda s: s.strip().lower() in ("true", "1"),
}


def export_graphml(graph, path_or_file: Union[str, TextIO]) -> Dict[str, int]:
    """Write the graph as TinkerPop-convention GraphML. PRIMITIVE property
    values only (string/long/double/boolean — the format's own limitation,
    same as TinkerPop's GraphMLWriter); richer datatypes need the
    GraphSON exporter. Returns {"vertices": n, "edges": m}."""
    from xml.sax.saxutils import escape, quoteattr

    from janusgraph_tpu_torch.core.codecs import Direction

    def _type_of(key: str, value) -> str:
        # bool FIRST: it subclasses int
        if isinstance(value, bool):
            return "boolean"
        if isinstance(value, str):
            return "string"
        if isinstance(value, int):
            return "long"
        if isinstance(value, float):
            return "double"
        raise ValueError(
            f"GraphML supports primitive values only; property {key!r} "
            f"holds {type(value).__name__} — use export_graphson for "
            "typed values"
        )

    def _fmt(value) -> str:
        if isinstance(value, bool):
            return "true" if value else "false"
        return escape(str(value))

    tx = graph.new_transaction()
    nv = ne = 0
    close = False
    f = None
    try:
        # pass 1 BEFORE opening the output: collect typed keys (GraphML
        # declares them up front) and validate — a type/name rejection
        # must not have truncated an existing file at the destination
        vkeys: Dict[str, str] = {}
        ekeys: Dict[str, str] = {}
        for v in tx.vertices():
            for p in v.properties():
                if p.key in ("labelV", "labelE") or p.key.startswith("E-"):
                    raise ValueError(
                        f"vertex property key {p.key!r} collides with "
                        "GraphML's reserved labelV/labelE/E- id namespace "
                        "— rename it or use export_graphson"
                    )
                vkeys.setdefault(p.key, _type_of(p.key, p.value))
            for e in tx.get_edges(v, Direction.OUT, ()):
                for k, val in e.property_values().items():
                    if k in ("labelV", "labelE"):
                        raise ValueError(
                            f"edge property key {k!r} collides with "
                            "GraphML's reserved label keys — rename it "
                            "or use export_graphson"
                        )
                    ekeys.setdefault(k, _type_of(k, val))
        if isinstance(path_or_file, str):
            # explicit utf-8: XML must not follow the locale encoding
            f = open(path_or_file, "w", encoding="utf-8")
            close = True
        else:
            f = path_or_file
        f.write('<?xml version="1.0" ?>')
        f.write(
            '<graphml xmlns="http://graphml.graphdrawing.org/xmlns">'
        )
        f.write(
            '<key id="labelV" for="node" attr.name="labelV" '
            'attr.type="string"/>'
        )
        for k, t in sorted(vkeys.items()):
            f.write(
                f'<key id={quoteattr(k)} for="node" '
                f'attr.name={quoteattr(k)} attr.type="{t}"/>'
            )
        f.write(
            '<key id="labelE" for="edge" attr.name="labelE" '
            'attr.type="string"/>'
        )
        for k, t in sorted(ekeys.items()):
            # id carries the E- disambiguation prefix; attr.name stays the
            # bare key so the importer files edge props under it
            f.write(
                f'<key id={quoteattr("E-" + k)} for="edge" '
                f'attr.name={quoteattr(k)} attr.type="{t}"/>'
            )
        f.write('<graph id="G" edgedefault="directed">')
        for v in tx.vertices():
            f.write(f'<node id="{v.id}">')
            f.write(f'<data key="labelV">{escape(v.label)}</data>')
            for p in v.properties():
                f.write(
                    f'<data key={quoteattr(p.key)}>{_fmt(p.value)}</data>'
                )
            f.write("</node>")
            nv += 1
        for v in tx.vertices():
            for e in tx.get_edges(v, Direction.OUT, ()):
                f.write(
                    f'<edge source="{e.out_vertex.id}" '
                    f'target="{e.in_vertex.id}">'
                )
                f.write(f'<data key="labelE">{escape(e.label)}</data>')
                for k, val in e.property_values().items():
                    f.write(
                        f'<data key={quoteattr("E-" + k)}>{_fmt(val)}'
                        "</data>"
                    )
                f.write("</edge>")
                ne += 1
        f.write("</graph></graphml>")
    finally:
        tx.rollback()
        if close and f is not None:
            f.close()
    return {"vertices": nv, "edges": ne}


def import_graphml(
    graph, path_or_file: Union[str, TextIO], batch_size: int = 1000,
) -> Dict[str, int]:
    """Load TinkerPop-convention GraphML (labelV/labelE keys, typed <key>
    declarations — the shape GraphMLWriter emits and the reference's
    grateful-dead.xml demo uses). Ids are remapped; commits every
    `batch_size` elements with the same partial-commit contract as
    import_graphson (the raised exception carries ``committed``)."""
    import xml.etree.ElementTree as ET

    close = False
    if isinstance(path_or_file, str):
        f = open(path_or_file, "rb")
        close = True
    else:
        f = path_or_file

    def _local(tag: str) -> str:
        return tag.rsplit("}", 1)[-1]

    key_types: Dict[str, tuple] = {}  # key id -> (attr.name, parser)
    id_map: Dict[str, int] = {}
    deferred_edges: list = []
    nv = ne = 0
    nv_committed = ne_committed = 0
    pending = 0
    tx = graph.new_transaction(read_only=False)

    def _add_edge(rec):
        nonlocal ne
        src_id, dst_id, label, props = rec
        src = id_map.get(src_id)
        dst = id_map.get(dst_id)
        if src is None or dst is None:
            raise ValueError(
                f"edge references unknown node {src_id}->{dst_id}"
            )
        e = tx.add_edge(tx.get_vertex(src), label, tx.get_vertex(dst))
        for k, val in props.items():
            e.set_property(k, val)
        ne += 1

    try:
        container = None  # the <graph> element records accumulate under
        since_clear = 0
        for event, el in ET.iterparse(f, events=("start", "end")):
            if event == "start":
                if _local(el.tag) == "graph":
                    container = el
                continue
            tag = _local(el.tag)
            if tag == "key":
                parser = _GRAPHML_PARSERS.get(
                    el.get("attr.type", "string"), str
                )
                key_types[el.get("id")] = (
                    el.get("attr.name", el.get("id")), parser,
                )
            elif tag == "node":
                label = None
                entries = []  # (name, value) — LIST/SET keys repeat
                for d in el:
                    if _local(d.tag) != "data":
                        continue
                    name, parser = key_types.get(
                        d.get("key"), (d.get("key"), str)
                    )
                    text = d.text or ""
                    if name == "labelV":
                        label = text or None
                    else:
                        # empty string IS a value (grateful-dead.xml has
                        # empty songType cells)
                        entries.append((name, parser(text)))
                v = tx.add_vertex(label if label != "vertex" else None)
                dup = {
                    nm for nm in {n for n, _ in entries}
                    if sum(1 for n, _ in entries if n == nm) > 1
                }
                for nm in dup:
                    # GraphML carries no schema records: a repeated key
                    # imported through an auto-created SINGLE key would
                    # silently keep only the last value
                    pk = graph.schema_cache.get_by_name(nm)
                    if pk is None or int(
                        getattr(pk, "cardinality", 0)
                    ) == 0:
                        raise ValueError(
                            f"node {el.get('id')} repeats key {nm!r} but "
                            "the key is (or would be auto-created) "
                            "SINGLE-cardinality — pre-create it as "
                            "LIST/SET or use GraphSON, which carries "
                            "schema records"
                        )
                for k, val in entries:
                    tx.add_property(v, k, val)
                id_map[el.get("id")] = v.id
                nv += 1
                pending += 1
                el.clear()
            elif tag == "edge":
                label = "edge"
                props = {}
                for d in el:
                    if _local(d.tag) != "data":
                        continue
                    name, parser = key_types.get(
                        d.get("key"), (d.get("key"), str)
                    )
                    text = d.text or ""
                    if name == "labelE":
                        label = text or "edge"
                    elif name in props:
                        # edges carry single-valued properties: a repeat
                        # is data loss, fail like the node path does
                        raise ValueError(
                            f"edge {el.get('source')}->"
                            f"{el.get('target')} repeats key {name!r}"
                        )
                    else:
                        props[name] = parser(text)
                rec = (el.get("source"), el.get("target"), label, props)
                if rec[0] in id_map and rec[1] in id_map:
                    _add_edge(rec)
                    pending += 1
                else:
                    # spec permits edges before their nodes: defer like
                    # import_graphson's forward references
                    deferred_edges.append(rec)
                el.clear()
            since_clear += 1
            if since_clear >= batch_size and container is not None:
                # el.clear() empties elements, but they stay CHILDREN of
                # <graph> (the parser's stack keeps appending there) —
                # clear the container or import memory grows O(n); safe
                # on an end event: only ancestors are open
                container.clear()
                since_clear = 0
            if pending >= batch_size:
                tx.commit()
                nv_committed, ne_committed = nv, ne
                tx = graph.new_transaction(read_only=False)
                pending = 0
        for rec in deferred_edges:
            _add_edge(rec)
            pending += 1
            if pending >= batch_size:
                tx.commit()
                nv_committed, ne_committed = nv, ne
                tx = graph.new_transaction(read_only=False)
                pending = 0
        tx.commit()
        nv_committed, ne_committed = nv, ne
    except BaseException as exc:
        exc.committed = {"vertices": nv_committed, "edges": ne_committed}
        raise
    finally:
        try:
            tx.rollback()
        except Exception:  # noqa: BLE001 — teardown must not mask errors
            pass
        if close:
            f.close()
    return {"vertices": nv, "edges": ne}
