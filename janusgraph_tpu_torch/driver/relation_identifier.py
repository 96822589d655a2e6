"""Edge identity quadruple — re-export of the canonical implementation.

(reference: janusgraph-driver .../graphdb/relations/RelationIdentifier.java:131
— edge id = [relation-id, out-vertex-id, type-id, in-vertex-id]). The
canonical class lives in core/codecs.py (storage-independent); the driver
re-exports it so client code can import it without touching core. The
port's copy of ``janusgraph_tpu/driver/relation_identifier.py``.
"""

from janusgraph_tpu_torch.core.codecs import RelationIdentifier

__all__ = ["RelationIdentifier"]
