"""nn.Module model families of the port, the JAX weight bridge and the
reference ``.pt`` import."""
from av1tpu_torch.models.fgvc import (  # noqa: F401
    CosineClassifier,
    FGVCModel,
    center_loss,
    init_centers,
    l2_normalize,
)
from av1tpu_torch.models.jax_import import (  # noqa: F401
    from_jax_variables,
    load_jax_variables,
    to_jax_variables,
)
from av1tpu_torch.models.layers import (  # noqa: F401
    AdapterModule,
    BasicBlock,
    ConvBNAct,
    DepthwiseSeparableConv,
    DualAttention,
    MLPHead,
    SEBlock,
    SpatialAttention,
    SpatialConv,
    global_avg_pool,
    same_padding,
)
from av1tpu_torch.models.torch_import import (  # noqa: F401
    import_any,
    import_fgvc_model,
    import_v5_hierarchical,
    import_v6_stage_model,
    load_torch_checkpoint,
)
from av1tpu_torch.models.v5 import (  # noqa: F401
    HierarchicalBackbone,
    HierarchicalModel,
    HierarchicalOutputs,
    QPEmbedding,
)
from av1tpu_torch.models.v6 import (  # noqa: F401
    FEATURE_DIM,
    ImprovedBackbone,
    Stage1Model,
    Stage2FlatModel,
    Stage2Model,
    Stage2ModelWithAdapters,
    Stage3ABModel,
    Stage3RectModel,
    UNIFIED_LOGIT_DIM,
    UNIFIED_LOGIT_SLICES,
    UnifiedV6Model,
    split_unified_logits,
)
