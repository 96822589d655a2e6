from janusgraph_tpu_torch.olap.computer import (  # noqa: F401
    ComputerResult,
    GraphComputer,
    run_on,
    write_back,
)
from janusgraph_tpu_torch.olap.csr import (  # noqa: F401
    CSRGraph,
    channel_edges,
    csr_from_arrays,
    csr_from_edges,
    load_csr,
    load_csr_snapshot,
)
from janusgraph_tpu_torch.olap.frontier import FrontierEngine  # noqa: F401
from janusgraph_tpu_torch.olap.generators import (  # noqa: F401
    LDBC_SF_SIZES,
    ldbc_sf_csr,
    ldbc_snb_csr,
    ldbc_snb_edges,
    rmat_csr,
    rmat_edges,
    twitter_csr,
    twitter_edges,
)
from janusgraph_tpu_torch.olap.fulgora_baseline import (  # noqa: F401
    FulgoraAnalogueComputer,
    measure_fulgora_baseline,
)
from janusgraph_tpu_torch.olap.gpu_executor import GPUExecutor  # noqa: F401
from janusgraph_tpu_torch.olap.mapreduce import (  # noqa: F401
    ClusterCountMapReduce,
    MapReduce,
    StatsMapReduce,
    TopKMapReduce,
    run_map_reduce,
)
from janusgraph_tpu_torch.olap.vertex_program import (  # noqa: F401
    Combiner,
    EdgeChannel,
    EdgeTransform,
    Memory,
    VertexProgram,
)
from janusgraph_tpu_torch.olap.programs.degree import DegreeCountProgram  # noqa: F401
from janusgraph_tpu_torch.olap.programs.olap_traversal import (  # noqa: F401
    OLAPTraversalProgram,
    TraversalStep,
    build_olap_traversal,
)
