from janusgraph_tpu_torch.olap.programs.pagerank import PageRankProgram  # noqa: F401
from janusgraph_tpu_torch.olap.programs.connected_components import (  # noqa: F401
    ConnectedComponentsProgram,
)
from janusgraph_tpu_torch.olap.programs.peer_pressure import PeerPressureProgram  # noqa: F401
from janusgraph_tpu_torch.olap.programs.shortest_path import (  # noqa: F401
    ShortestPathProgram,
    reconstruct_path,
    weighted_predecessors,
)
from janusgraph_tpu_torch.olap.programs.traversal_count import (  # noqa: F401
    TraversalCountProgram,
)
from janusgraph_tpu_torch.olap.programs.gcn import GCNForwardProgram  # noqa: F401
from janusgraph_tpu_torch.olap.programs.embedding import EmbeddingUpdateProgram  # noqa: F401
from janusgraph_tpu_torch.olap.programs.degree import DegreeCountProgram  # noqa: F401
from janusgraph_tpu_torch.olap.programs.olap_traversal import (  # noqa: F401
    OLAPTraversalProgram,
    PropertyFilter,
    TraversalStep,
    build_olap_traversal,
    build_path_index,
    enumerate_paths,
    evaluate_filter_mask,
    group_count_by_label,
    select_paths,
    steps_from_spec,
)
