"""Shared CLI plumbing: dataset splits and checkpoint loading.

Dataset bundles are ``av1tpu_torch.data.bundles``, the port's own copy of
the JAX package's format (same npz keys and ``metadata.json``)."""
from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Dict, Tuple

from av1tpu_torch.data.bundles import Bundle
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


__all__ = ["load_model_variables", "load_split"]
