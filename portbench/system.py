"""The system under test: with the model families' ``port.py`` files, the
only module of the benchmark that imports the PyTorch and CUDA port
(``av1tpu_torch``).

It hands each level's seeded state dicts to the configuration's model family
(``families/<family>/port.py``, found by ``spec.load_family``), which builds
that level's serving pipeline as the configuration states it, and it hands
the traffic loops the port's entry points. What the loops time is what a
caller of the port's library runs. A new model family brings its own
``port.py`` and edits nothing here.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from av1tpu_torch.eval.hierarchy import run_pipeline_batched
from av1tpu_torch.eval.tree_infer import predict_frame_trees, predict_partition_trees
from av1tpu_torch.ingest.tiler import tile_frame
from av1tpu_torch.kernels import _build

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}

__all__ = ["DTYPES", "build_predictors", "load_kernels", "launch_counts", "module",
           "predict_frame_trees", "predict_partition_trees", "recorded_spans",
           "run_pipeline_batched", "tile_frame"]


def module(cls: type, sd: Dict[str, torch.Tensor]) -> torch.nn.Module:
    """The port's model ``cls()`` in eval mode, holding a copy of ``sd`` (its
    checkpoint keys; the BatchNorms' batch counters, which serving never
    reads, are zero)."""
    with torch.device("meta"):
        model = cls()
    full = {key: value.clone() for key, value in sd.items()}  # the reference keeps sd
    for key in model.state_dict():
        if key.endswith("num_batches_tracked"):
            full[key] = torch.zeros((), dtype=torch.long, device=next(iter(sd.values())).device)
    model.load_state_dict(full, strict=True, assign=True)
    return model.eval()


def build_predictors(family, config: dict, level_models: Dict[int, dict], device,
                     calib: Dict[int, np.ndarray] = None) -> Dict[int, Callable]:
    """``{block px: predict}``: each level's serving pipeline, built by
    ``family.port.build`` (a ``spec.Family``) as ``config`` states it
    (dtype, fused kernels; ``int8`` quantizes on ``calib[px]``, uint16
    ``(n, px, px)`` blocks)."""
    return {size: family.port.build(config, models, device,
                                    None if calib is None else calib[size])
            for size, models in level_models.items()}


def load_kernels() -> None:
    """Build the port's kernel library with nvcc unless the checkout holds
    it already, and load it."""
    _build.load_kernels()


def launch_counts() -> Dict[str, int]:
    """The port's own count of its kernels' launches so far."""
    return dict(_build.launch_counts)


def recorded_spans() -> Optional[List[dict]]:
    """The spans the port's recorder kept of the last profiler session
    (``utils.profiling.spans``), or None: none recorded, or a port without
    the recorder."""
    try:
        from av1tpu_torch.utils.profiling import spans
    except ImportError:  # a port without the recorder
        return None
    return spans() or None
