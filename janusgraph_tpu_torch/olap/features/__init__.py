from janusgraph_tpu_torch.olap.features.dense_program import (  # noqa: F401
    DenseVertexProgram,
    MessageMode,
)
from janusgraph_tpu_torch.olap.features.kernels import (  # noqa: F401
    FEATURE_TIERS,
    dense_transform,
    ell_row_dsts,
    hybrid_row_dsts,
    matmul_flops,
    pad_features,
    pick_feature_tier,
    sddmm_ell_aggregate,
    sddmm_flops,
    sddmm_hybrid_aggregate,
    sddmm_segment_aggregate,
    tree_dot,
    tree_matmul,
)
