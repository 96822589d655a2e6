"""The query server and its fleet: the port's copy of
``janusgraph_tpu/server/``.

- ``server.py``: :class:`JanusGraphServer`, the HTTP and WebSocket
  endpoint that evaluates the traversal DSL (and, through
  ``gremlin_compat.py``, the Gremlin dialect) against the graphs a
  ``JanusGraphManager`` (``manager.py``) serves, in an AST-whitelisted
  sandbox, with the observability routes (``/healthz``, ``/metrics``,
  ``/timeseries``, ``/profile``, ``/flight``, ``/debug/*``, ``/watch``).
- ``auth.py``: password hashing, HMAC tokens and the authenticators.
- ``admission.py``: the cost-aware front door (AIMD limit, shedding,
  the brownout ladder) and ``check_olap_admission``, which the graph
  computer and the spillover consult before an OLAP run.
- ``fleet.py``: N replicas over one shared store behind
  :class:`FleetRouter` (consistent hash, least-loaded tie-break,
  retry-elsewhere, sticky sessions, drain) and :class:`FleetFrontend`;
  :class:`StateGossip` between replicas; :func:`export_snapshot` and
  :func:`warm_replica` (a joining replica's snapshot from the shard
  checkpoint, no store scan); ``CDCFollower``, a read replica over the
  durable CDC log.

The server and the fleet never touch the card themselves: a computer
step a replica evaluates (``pageRank()``, ``connectedComponent()``), and
a warmed replica's or a follower's submit, go to the device the graph's
``computer.executor`` names, the card by default.
"""

from janusgraph_tpu_torch.server.manager import (  # noqa: F401
    ConfiguredGraphFactory,
    JanusGraphManager,
)
from janusgraph_tpu_torch.server.auth import (  # noqa: F401
    CredentialsAuthenticator,
    HMACAuthenticator,
    SaslAndHMACAuthenticator,
)
from janusgraph_tpu_torch.server.server import JanusGraphServer  # noqa: F401
from janusgraph_tpu_torch.server.admission import (  # noqa: F401
    AdmissionController,
)
from janusgraph_tpu_torch.server.fleet import (  # noqa: F401
    FleetFrontend,
    FleetRouter,
    StateGossip,
    export_snapshot,
    warm_replica,
)
