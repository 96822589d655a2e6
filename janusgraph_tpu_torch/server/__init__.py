"""The query server: the port's copy of ``janusgraph_tpu/server/`` but its
fleet (ROADMAP Queue A #5.6b).

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

The server itself never touches the card: a computer step it evaluates
(``pageRank()``, ``connectedComponent()``) submits to the device the
graph's ``computer.executor`` names, the card by default.
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
