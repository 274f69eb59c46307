"""The port's unified v6 predictor for one level: the one model, BN-folded
(or int8 with ``"int8": true``), with the configuration's front kernel."""
from __future__ import annotations

from typing import Callable

import numpy as np

from av1tpu_torch.eval.unified import make_unified_pipeline_folded
from av1tpu_torch.models.v6 import UnifiedV6Model
from av1tpu_torch.quant.ptq import make_unified_pipeline_int8
from portbench.system import DTYPES, module

CLASSES = {"unified": UnifiedV6Model}


def build(config: dict, models: dict, device, calib: np.ndarray = None) -> Callable:
    """``predict`` for one level's ``{"unified": state dict}``; ``int8``
    quantizes on ``calib``, uint16 ``(n, px, px)`` blocks."""
    dtype = DTYPES[config["float_dtype"]]
    threshold, scale = config["stage1_threshold"], config["norm_scale"]
    model = module(UnifiedV6Model, models["unified"])
    if config.get("int8"):
        return make_unified_pipeline_int8(model, np.asarray(calib)[..., None], threshold, scale,
                                          float_dtype=dtype,
                                          use_fused_front=bool(config["use_fused_front"]),
                                          device=device)
    return make_unified_pipeline_folded(model, threshold, scale, float_dtype=dtype,
                                        use_fused_front=config["use_fused_front"], device=device)
