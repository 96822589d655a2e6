"""Client-side serialization: the port's copy of the part of
``janusgraph_tpu/driver/`` that graph I/O runs — the edge identity
(``RelationIdentifier``) and the typed GraphSON codec. The remote client
and GraphBinary wait for ROADMAP.md Queue A #5.6.
"""

from janusgraph_tpu_torch.driver.relation_identifier import RelationIdentifier  # noqa: F401
from janusgraph_tpu_torch.driver.graphson import graphson_dumps, graphson_loads  # noqa: F401
