"""nn.Module model families of the port and the JAX weight bridge."""
from av1tpu_torch.models.fgvc import CosineClassifier, FGVCModel, l2_normalize  # noqa: F401
from av1tpu_torch.models.jax_import import (  # noqa: F401
    from_jax_variables,
    load_jax_variables,
    to_jax_variables,
)
from av1tpu_torch.models.layers import (  # noqa: F401
    BasicBlock,
    MLPHead,
    SEBlock,
    SpatialAttention,
    SpatialConv,
    same_padding,
)
from av1tpu_torch.models.v6 import (  # noqa: F401
    ImprovedBackbone,
    Stage1Model,
    Stage2Model,
    Stage3ABModel,
    Stage3RectModel,
    UNIFIED_LOGIT_DIM,
    UNIFIED_LOGIT_SLICES,
    UnifiedV6Model,
    split_unified_logits,
)
