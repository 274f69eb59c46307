"""The system under test: the only module of the benchmark that imports the
PyTorch and CUDA port (``av1tpu_torch``).

It loads the benchmark's seeded state dicts into the port's stage models,
builds each level's serving pipeline as the configuration states it, and
hands the traffic loops the port's entry points. What the loops time is what a
caller of the port's library runs.
"""
from __future__ import annotations

from typing import Callable, Dict

import numpy as np
import torch

from av1tpu_torch.eval.folded import make_v6_pipeline_folded
from av1tpu_torch.eval.hierarchy import PipelineModels, run_pipeline_batched
from av1tpu_torch.eval.tree_infer import predict_frame_trees, predict_partition_trees
from av1tpu_torch.eval.unified import make_unified_pipeline_folded
from av1tpu_torch.ingest.tiler import tile_frame
from av1tpu_torch.kernels import _build
from av1tpu_torch.models.v6 import (
    Stage1Model,
    Stage2Model,
    Stage3ABModel,
    Stage3RectModel,
    UnifiedV6Model,
)
from av1tpu_torch.quant.ptq import make_unified_pipeline_int8, make_v6_pipeline_int8

MODEL_CLASSES = {"stage1": Stage1Model, "stage2": Stage2Model, "rect": Stage3RectModel,
                 "ab": Stage3ABModel, "unified": UnifiedV6Model}
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}

__all__ = ["build_predictors", "load_kernels", "launch_counts", "predict_frame_trees",
           "predict_partition_trees", "run_pipeline_batched", "tile_frame"]


def _module(kind: str, sd: Dict[str, torch.Tensor]) -> torch.nn.Module:
    """The port's model of ``kind`` holding a copy of ``sd`` (its checkpoint
    keys; the BatchNorms' batch counters, which serving never reads, are
    zero)."""
    with torch.device("meta"):
        model = MODEL_CLASSES[kind]()
    full = {key: value.clone() for key, value in sd.items()}  # the reference keeps sd
    for key in model.state_dict():
        if key.endswith("num_batches_tracked"):
            full[key] = torch.zeros((), dtype=torch.long, device=next(iter(sd.values())).device)
    model.load_state_dict(full, strict=True, assign=True)
    return model.eval()


def build_predictors(config: dict, level_models: Dict[int, dict], device,
                     calib: Dict[int, np.ndarray] = None) -> Dict[int, Callable]:
    """``{block px: predict}``: each level's serving pipeline as ``config``
    states it (family, dtype, fused kernels; ``int8`` quantizes on
    ``calib[px]``, uint16 ``(n, px, px)`` blocks)."""
    dtype = DTYPES[config["float_dtype"]]
    threshold, scale = config["stage1_threshold"], config["norm_scale"]
    out = {}
    for size, models in level_models.items():
        modules = {kind: _module(kind, sd) for kind, sd in models.items()}
        if config.get("int8"):
            blocks = np.asarray(calib[size])[..., None]
            if "unified" in modules:
                out[size] = make_unified_pipeline_int8(
                    modules["unified"], blocks, threshold, scale, float_dtype=dtype,
                    use_fused_front=bool(config["use_fused_front"]), device=device)
            else:
                out[size] = make_v6_pipeline_int8(
                    PipelineModels(*(modules[k] for k in ("stage1", "stage2", "rect", "ab"))),
                    blocks, threshold, scale, float_dtype=dtype,
                    use_fused_front=bool(config["use_fused_front"]), device=device)
        elif "unified" in modules:
            out[size] = make_unified_pipeline_folded(
                modules["unified"], threshold, scale, float_dtype=dtype,
                use_fused_front=config["use_fused_front"], device=device)
        else:
            out[size] = make_v6_pipeline_folded(
                PipelineModels(*(modules[k] for k in ("stage1", "stage2", "rect", "ab"))),
                threshold, scale, float_dtype=dtype, use_fused_front=config["use_fused_front"],
                device=device, use_pallas_groups=config["use_pallas_groups"])
    return out


def load_kernels() -> None:
    """Build the port's kernel library with nvcc unless the checkout holds
    it already, and load it."""
    _build.load_kernels()


def launch_counts() -> Dict[str, int]:
    """The port's own count of its kernels' launches so far."""
    return dict(_build.launch_counts)
