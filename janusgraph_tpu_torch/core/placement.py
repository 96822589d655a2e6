"""ID placement strategies: which storage partition a new vertex lands in —
the port's copy of ``janusgraph_tpu/core/placement.py``.

Capability parity with the reference's placement SPI (reference:
graphdb/database/idassigner/placement/IDPlacementStrategy.java:96 —
strategy interface; SimpleBulkPlacementStrategy.java:130 — random/round
robin spread; PropertyPlacementStrategy.java:110 — partition derived from
hashing a configured property's value so related vertices co-locate).

Partition choice matters twice: OLTP scans touch fewer partitions for
co-located data, and the OLAP mesh shards along partition key ranges — the
smaller the cross-partition edge cut, the smaller the boundary buckets the
all-to-all exchange ships every superstep. ``stable_hash`` is the
reference's, so a property strategy puts a value in the same partition in
both packages.
"""

from __future__ import annotations

import zlib
from typing import Optional

from janusgraph_tpu_torch.exceptions import ConfigurationError


class IDPlacementStrategy:
    """Strategy SPI: return a partition for a new vertex, or None to let the
    assigner fall back to its default spread."""

    def partition_for(
        self, label, props: Optional[dict], num_partitions: int
    ) -> Optional[int]:
        raise NotImplementedError


class SimpleBulkPlacementStrategy(IDPlacementStrategy):
    """Round-robin spread over all partitions (the default; reference:
    SimpleBulkPlacementStrategy.java:130)."""

    def __init__(self):
        self._rr = 0

    def partition_for(self, label, props, num_partitions):
        p = self._rr % num_partitions
        self._rr += 1
        return p


def stable_hash(value) -> int:
    """Process-independent value hash (python's hash() is salted for str)."""
    if isinstance(value, bytes):
        raw = value
    elif isinstance(value, str):
        raw = value.encode()
    else:
        raw = repr(value).encode()
    return zlib.crc32(raw) & 0xFFFFFFFF


class PropertyPlacementStrategy(IDPlacementStrategy):
    """Partition = hash(props[key]) % num_partitions: vertices sharing the
    key's value co-locate in one partition (reference:
    PropertyPlacementStrategy.java:110 — same contract, including falling
    back to the default spread when the vertex lacks the key)."""

    def __init__(self, key: str):
        if not key:
            raise ConfigurationError(
                "PropertyPlacementStrategy requires ids.placement-key"
            )
        self.key = key
        self._fallback = SimpleBulkPlacementStrategy()

    def partition_for(self, label, props, num_partitions):
        if props and self.key in props:
            return stable_hash(props[self.key]) % num_partitions
        return self._fallback.partition_for(label, props, num_partitions)


def make_placement_strategy(name: str, key: str = "") -> IDPlacementStrategy:
    if name == "simple":
        return SimpleBulkPlacementStrategy()
    if name == "property":
        return PropertyPlacementStrategy(key)
    raise ConfigurationError(f"unknown ids.placement strategy {name!r}")
