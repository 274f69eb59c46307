"""Flat npz variable files, the format of ``av1tpu.train.checkpoint``.

Keys are slash-joined paths of the JAX ``{"params", "batch_stats"}`` tree
(``params/backbone/conv1/kernel``); loading rebuilds the nested dicts of
numpy arrays without a model template. ``models.jax_import`` converts
between that tree and a torch state dict.
"""
from __future__ import annotations

from pathlib import Path
from typing import Any, Dict

import numpy as np


def save_variables_npz(path: Path, variables: Dict[str, Any],
                       compress: bool = True) -> Path:
    """Write a nested dict of arrays as one npz of flat keys, compressed as
    the JAX package writes it unless ``compress`` is false (random weights do
    not compress; both forms load the same way)."""
    flat = {}

    def walk(prefix, node):
        if isinstance(node, dict) or hasattr(node, "items"):
            for key, value in node.items():
                walk(prefix + (str(key),), value)
        else:
            flat["/".join(prefix)] = np.asarray(node)

    walk((), variables)
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    (np.savez_compressed if compress else np.savez)(path, **flat)
    return path


def load_variables_npz(path: Path) -> Dict[str, Any]:
    """Read a file written by :func:`save_variables_npz` into nested dicts."""
    with np.load(Path(path)) as z:
        tree: Dict[str, Any] = {}
        for key in z.files:
            node = tree
            parts = key.split("/")
            for part in parts[:-1]:
                node = node.setdefault(part, {})
            node[parts[-1]] = z[key]
    return tree


__all__ = ["load_variables_npz", "save_variables_npz"]
