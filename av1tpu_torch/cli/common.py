"""Shared CLI plumbing: dataset splits, checkpoint loading, and the flags
of the JAX CLIs that are not ported yet.

Dataset bundles are ``av1tpu_torch.data.bundles``, the port's own copy of
the JAX package's format (same npz keys and ``metadata.json``)."""
from __future__ import annotations

import argparse
import json
from pathlib import Path
from typing import Any, Dict, Mapping, Tuple

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


__all__ = ["add_not_ported_flags", "load_model_variables", "load_split"]
