"""The port's per-stage v6 predictor for one level: the four stage models,
BN-folded (or int8 with ``"int8": true``), with the configuration's kernels."""
from __future__ import annotations

from typing import Callable

import numpy as np

from av1tpu_torch.eval.folded import make_v6_pipeline_folded
from av1tpu_torch.eval.hierarchy import PipelineModels
from av1tpu_torch.models.v6 import Stage1Model, Stage2Model, Stage3ABModel, Stage3RectModel
from av1tpu_torch.quant.ptq import make_v6_pipeline_int8
from portbench.system import DTYPES, module

CLASSES = {"stage1": Stage1Model, "stage2": Stage2Model, "rect": Stage3RectModel,
           "ab": Stage3ABModel}


def build(config: dict, models: dict, device, calib: np.ndarray = None) -> Callable:
    """``predict`` for one level's ``{kind: state dict}``; ``int8`` quantizes
    on ``calib``, uint16 ``(n, px, px)`` blocks."""
    dtype = DTYPES[config["float_dtype"]]
    threshold, scale = config["stage1_threshold"], config["norm_scale"]
    stages = PipelineModels(*(module(cls, models[kind]) for kind, cls in CLASSES.items()))
    if config.get("int8"):
        return make_v6_pipeline_int8(stages, np.asarray(calib)[..., None], threshold, scale,
                                     float_dtype=dtype,
                                     use_fused_front=bool(config["use_fused_front"]),
                                     device=device)
    return make_v6_pipeline_folded(stages, threshold, scale, float_dtype=dtype,
                                   use_fused_front=config["use_fused_front"], device=device,
                                   use_pallas_groups=config["use_pallas_groups"])
