"""Shared CLI plumbing: dataset splits, checkpoint and model loading (npz
or a reference ``.pt``), one model's outputs over a split, and the int8
calibration subsample.

Dataset bundles are ``av1tpu_torch.data.bundles``, the port's own copy of
the JAX package's format (same npz keys and ``metadata.json``)."""
from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Callable, Dict, Tuple

import numpy as np
import torch
from torch import nn

from av1tpu_torch.data.bundles import Bundle
from av1tpu_torch.data.records import NORM_10BIT
from av1tpu_torch.eval.hierarchy import on_device, run_pipeline_batched
from av1tpu_torch.models.jax_import import load_jax_variables
from av1tpu_torch.models.torch_import import import_any, load_torch_checkpoint
from av1tpu_torch.train.checkpoint import load_variables_npz


def load_split(dataset_dir: Path, block_size: int) -> Tuple[Bundle, Bundle, Dict]:
    """``<dir>/block_<S>/{train,val}.npz`` and its metadata."""
    root = Path(dataset_dir) / f"block_{block_size}"
    train = Bundle.load(root / "train.npz")
    val = Bundle.load(root / "val.npz")
    meta_path = root / "metadata.json"
    meta = json.loads(meta_path.read_text()) if meta_path.exists() else {}
    return train, val, meta


def load_model_variables(path: Path) -> Dict[str, Any]:
    """Load a JAX variable tree from a flat npz checkpoint, or import a
    reference torch ``.pt``/``.pth``: its state dict goes to the importer
    its key shape names (v5 hierarchical, FGVC or a v6 stage model,
    ``models.torch_import.import_any``) and comes back as the JAX package's
    float32 numpy tree."""
    path = Path(path)
    if path.suffix == ".npz":
        return load_variables_npz(path)
    if path.suffix in (".pt", ".pth"):
        return _as_float32(import_any(load_torch_checkpoint(path)))
    raise ValueError(f"unsupported checkpoint format: {path}")


def _as_float32(tree):
    if isinstance(tree, dict):
        return {k: _as_float32(v) for k, v in tree.items()}
    return np.asarray(tree, dtype=np.float32)


def load_model(path: Path, model_cls) -> nn.Module:
    """``model_cls()`` holding the checkpoint at ``path`` (npz or ``.pt``), in
    eval mode (an FGVC checkpoint's class ``centers`` are training state and
    dropped)."""
    variables = load_model_variables(path)
    variables.pop("centers", None)
    return load_jax_variables(model_cls(), variables).eval()


def model_outputs(model: nn.Module, head: Callable, samples: np.ndarray,
                  batch_size: int, device, dtype) -> np.ndarray:
    """``head(model, x)`` over uint16 NHWC ``samples`` divided by 1023, in
    batches on ``device`` with the model cast to ``dtype``, as numpy."""
    model = on_device(model, device, dtype)

    @torch.inference_mode()
    def predict(images):
        x = (images.to(torch.float32) / NORM_10BIT).to(dtype)
        return {"out": head(model, x)}

    return run_pipeline_batched(predict, samples, batch_size, device)["out"]


def train_calibration_blocks(train_samples: np.ndarray, n: int) -> np.ndarray:
    """The int8 calibration blocks of the JAX CLIs: ``min(n, len)`` rows of
    the train split drawn without replacement by ``default_rng(0)``, in row
    order."""
    idx = np.random.default_rng(0).choice(
        len(train_samples), size=min(n, len(train_samples)), replace=False)
    return train_samples[np.sort(idx)]


__all__ = ["load_model", "load_model_variables", "load_split",
           "model_outputs", "train_calibration_blocks"]
