"""Shared CLI plumbing: dataset splits, checkpoint and model loading, one
model's outputs over a split, the int8 calibration subsample, and the flags
of the JAX CLIs that are not ported yet.

Dataset bundles are ``av1tpu_torch.data.bundles``, the port's own copy of
the JAX package's format (same npz keys and ``metadata.json``)."""
from __future__ import annotations

import argparse
import json
from pathlib import Path
from typing import Any, Callable, Dict, Mapping, Tuple

import numpy as np
import torch
from torch import nn

from av1tpu_torch.data.bundles import Bundle
from av1tpu_torch.data.records import NORM_10BIT
from av1tpu_torch.eval.hierarchy import on_device, run_pipeline_batched
from av1tpu_torch.models.jax_import import load_jax_variables
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
    """Load a JAX variable tree from a flat npz checkpoint."""
    path = Path(path)
    if path.suffix == ".npz":
        return load_variables_npz(path)
    if path.suffix in (".pt", ".pth"):
        raise ValueError(
            f"{path}: reference .pt checkpoints wait for the F1 padding switch "
            "(ROADMAP M4); convert them to npz with the JAX package"
        )
    raise ValueError(f"unsupported checkpoint format: {path}")


def load_model(path: Path, model_cls) -> nn.Module:
    """``model_cls()`` holding the npz checkpoint at ``path``, in eval mode
    (an FGVC checkpoint's class ``centers`` are training state and dropped)."""
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


def add_not_ported_flags(parser: argparse.ArgumentParser,
                         flags: Mapping[str, str]) -> None:
    """Register each flag of ``flags`` (flag -> ROADMAP item that ports it)
    so that using it exits with an error naming that item."""

    class NotPorted(argparse.Action):
        def __init__(self, option_strings, dest, **kwargs):
            super().__init__(option_strings, dest, nargs="*", **kwargs)

        def __call__(self, parser, namespace, values, option_string=None):
            parser.error(f"{option_string} is not ported yet "
                         f"(ROADMAP {flags[option_string]})")

    for flag in flags:
        parser.add_argument(flag, action=NotPorted, help=argparse.SUPPRESS)


__all__ = ["add_not_ported_flags", "load_model", "load_model_variables", "load_split",
           "model_outputs", "train_calibration_blocks"]
