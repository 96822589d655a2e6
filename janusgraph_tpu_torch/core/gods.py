"""Graph of the Gods — the canonical demo/parity dataset.

Same graph as the reference's factory
(reference: janusgraph-core .../example/GraphOfTheGodsFactory.java:41):
12 vertices (titan/god/demigod/human/monster/location), 17 edges
(father/mother/brother/battled/lives/pet), schema with a unique name index,
an age index, and `battled` sorted by time. Used by the OLTP tests and as
BASELINE config #1 for OLAP PageRank.

The port's copy of ``janusgraph_tpu/core/gods.py``: the same schema,
vertices and edges in the same order, so both packages write the same rows.
"""

from __future__ import annotations

from janusgraph_tpu_torch.core.predicates import Geoshape
from janusgraph_tpu_torch.core.codecs import Multiplicity


def load(graph) -> None:
    mgmt = graph.management()
    mgmt.make_property_key("name", str)
    mgmt.make_property_key("age", int)
    mgmt.make_property_key("time", int)
    mgmt.make_property_key("reason", str)
    mgmt.make_property_key("place", Geoshape)

    for label in ("titan", "god", "demigod", "human", "monster", "location"):
        mgmt.make_vertex_label(label)

    mgmt.make_edge_label("father", Multiplicity.MANY2ONE)
    mgmt.make_edge_label("mother", Multiplicity.MANY2ONE)
    mgmt.make_edge_label("brother")
    mgmt.make_edge_label("battled", sort_key=("time",))
    mgmt.make_edge_label("lives")
    mgmt.make_edge_label("pet")

    mgmt.build_composite_index("name", ["name"], unique=True)
    mgmt.build_composite_index("age", ["age"])

    tx = graph.new_transaction(read_only=False)
    saturn = tx.add_vertex("titan", name="saturn", age=10000)
    sky = tx.add_vertex("location", name="sky")
    sea = tx.add_vertex("location", name="sea")
    jupiter = tx.add_vertex("god", name="jupiter", age=5000)
    neptune = tx.add_vertex("god", name="neptune", age=4500)
    hercules = tx.add_vertex("demigod", name="hercules", age=30)
    alcmene = tx.add_vertex("human", name="alcmene", age=45)
    pluto = tx.add_vertex("god", name="pluto", age=4000)
    nemean = tx.add_vertex("monster", name="nemean")
    hydra = tx.add_vertex("monster", name="hydra")
    cerberus = tx.add_vertex("monster", name="cerberus")
    tartarus = tx.add_vertex("location", name="tartarus")

    tx.add_edge(jupiter, "father", saturn)
    tx.add_edge(jupiter, "lives", sky, reason="loves fresh breezes")
    tx.add_edge(jupiter, "brother", neptune)
    tx.add_edge(jupiter, "brother", pluto)

    tx.add_edge(neptune, "lives", sea, reason="loves waves")
    tx.add_edge(neptune, "brother", jupiter)
    tx.add_edge(neptune, "brother", pluto)

    tx.add_edge(hercules, "father", jupiter)
    tx.add_edge(hercules, "mother", alcmene)
    tx.add_edge(
        hercules, "battled", nemean, time=1, place=Geoshape.point(38.1, 23.7)
    )
    tx.add_edge(
        hercules, "battled", hydra, time=2, place=Geoshape.point(37.7, 23.9)
    )
    tx.add_edge(
        hercules, "battled", cerberus, time=12, place=Geoshape.point(39.0, 22.0)
    )

    tx.add_edge(pluto, "brother", jupiter)
    tx.add_edge(pluto, "brother", neptune)
    tx.add_edge(pluto, "lives", tartarus, reason="no fear of death")
    tx.add_edge(pluto, "pet", cerberus)

    tx.add_edge(cerberus, "lives", tartarus)

    tx.commit()
