"""Client-side driver: the port's copy of ``janusgraph_tpu/driver/`` — the
edge identity (``RelationIdentifier``), the typed GraphSON and GraphBinary
codecs, and the remote client of the query server (``client.py``).
"""

from janusgraph_tpu_torch.driver.relation_identifier import RelationIdentifier  # noqa: F401
from janusgraph_tpu_torch.driver.graphson import graphson_dumps, graphson_loads  # noqa: F401
from janusgraph_tpu_torch.driver.graphbinary import binary_dumps, binary_loads  # noqa: F401
from janusgraph_tpu_torch.driver.client import JanusGraphClient  # noqa: F401
