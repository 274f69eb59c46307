"""BN folding for the folded pipelines and post-training int8 serving
(counterpart of ``av1tpu.quant``)."""
from av1tpu_torch.quant.ptq import (
    QuantStageModel,
    QuantUnifiedModel,
    attach_fused_front,
    calibrate,
    fold_backbone,
    fold_head,
    make_drift_checker,
    make_unified_pipeline_int8,
    make_v6_pipeline_int8,
    quantize_stage,
    quantize_unified,
)

__all__ = [
    "QuantStageModel",
    "QuantUnifiedModel",
    "attach_fused_front",
    "calibrate",
    "fold_backbone",
    "fold_head",
    "make_drift_checker",
    "make_unified_pipeline_int8",
    "make_v6_pipeline_int8",
    "quantize_stage",
    "quantize_unified",
]
