"""Cluster timestamp providers — the port's copy of
``janusgraph_tpu/util/timestamps.py``.

Capability parity with the reference's TimestampProviders
(reference: diskstorage/util/time/TimestampProviders.java — the
`graph.timestamps` config value choosing the resolution every instance
stamps storage-visible times with; serialized into global config, which is
why it is a registered attribute-serializer enum,
StandardSerializer.java:78-132).

All providers return integer NANOSECONDS truncated to their resolution, so
consumers compare/sort timestamps without unit bookkeeping; the resolution
choice governs how coarsely concurrent writers collide (a MILLI cluster
cannot order two same-millisecond log appends by time alone — the log's
(sender, seq) column tail breaks such ties, like the reference's rid).
"""

from __future__ import annotations

import time
from enum import Enum


class TimestampProviders(Enum):
    NANO = 1
    MICRO = 1_000
    MILLI = 1_000_000

    @property
    def resolution_ns(self) -> int:
        return self.value

    def time_ns(self) -> int:
        """Current time, truncated to this provider's resolution."""
        return (time.time_ns() // self.value) * self.value

    @classmethod
    def of(cls, name: str) -> "TimestampProviders":
        try:
            return cls[name.upper()]
        except KeyError:
            raise ValueError(
                f"unknown timestamp provider {name!r} "
                f"(one of {[m.name.lower() for m in cls]})"
            )
