from janusgraph_tpu_torch.olap.computer import run_on  # noqa: F401
from janusgraph_tpu_torch.olap.csr import (  # noqa: F401
    CSRGraph,
    csr_from_arrays,
    csr_from_edges,
)
from janusgraph_tpu_torch.olap.frontier import FrontierEngine  # noqa: F401
from janusgraph_tpu_torch.olap.generators import rmat_csr, rmat_edges  # noqa: F401
from janusgraph_tpu_torch.olap.gpu_executor import GPUExecutor  # noqa: F401
from janusgraph_tpu_torch.olap.vertex_program import (  # noqa: F401
    Combiner,
    EdgeTransform,
    Memory,
    VertexProgram,
)
