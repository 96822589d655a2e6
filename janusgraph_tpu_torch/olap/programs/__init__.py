from janusgraph_tpu_torch.olap.programs.pagerank import PageRankProgram  # noqa: F401
from janusgraph_tpu_torch.olap.programs.connected_components import (  # noqa: F401
    ConnectedComponentsProgram,
)
