"""Training checkpoints with a save -> restore -> bitwise check, and the
flat npz variable files of ``av1tpu.train.checkpoint``.

``save_checkpoint`` writes a whole ``TrainState`` (the model's state dict,
the optimizer's state, the step) to ``<dir>/state.pt`` with ``torch.save``,
plus ``meta.json``; with ``verify`` it loads what it wrote and raises unless
every tensor is bitwise equal (the reference documents an unresolved F1 drop
after reload, quirk Q4; the JAX package makes this check on orbax files, the
port on its own format, since orbax is not on the card's machine).

The npz files: keys are slash-joined paths of the JAX ``{"params",
"batch_stats"}`` tree (``params/backbone/conv1/kernel``); loading rebuilds
the nested dicts of numpy arrays without a model template.
``models.jax_import`` converts between that tree and a torch state dict, so
both packages serve either's ``*_best_variables.npz``.
"""
from __future__ import annotations

import copy
import json
import shutil
from pathlib import Path
from typing import TYPE_CHECKING, Any, Dict, Optional, Tuple

import numpy as np
import torch

if TYPE_CHECKING:
    from av1tpu_torch.train.trainer import TrainState

STATE_FILE = "state.pt"


def _to_host(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_host(v) for v in tree)
    return tree


def _bitwise_equal(a, b) -> bool:
    if isinstance(a, torch.Tensor):
        if not (isinstance(b, torch.Tensor) and a.dtype == b.dtype and a.shape == b.shape):
            return False
        return torch.equal(a.reshape(-1).view(torch.uint8), b.reshape(-1).view(torch.uint8))
    if isinstance(a, dict):
        return (isinstance(b, dict) and a.keys() == b.keys()
                and all(_bitwise_equal(a[k], b[k]) for k in a))
    if isinstance(a, (list, tuple)):
        return (type(a) is type(b) and len(a) == len(b)
                and all(_bitwise_equal(x, y) for x, y in zip(a, b)))
    return a == b


def _state_payload(state: "TrainState") -> Dict[str, Any]:
    """The host copy of a ``TrainState`` that a checkpoint holds."""
    return _to_host({"model": state.model.state_dict(),
                     "optimizer": state.optimizer.state_dict(), "step": int(state.step)})


def states_equal(a: "TrainState", b: "TrainState") -> bool:
    """Whether two train states are bitwise equal: every tensor of the model,
    the optimizer's state and the step."""
    return _bitwise_equal(_state_payload(a), _state_payload(b))


def save_checkpoint(directory: Path, state: "TrainState",
                    meta: Optional[Dict[str, Any]] = None, verify: bool = True) -> Path:
    """Write one checkpoint directory (replacing it); with ``verify``, load it
    back and raise unless it equals the state bitwise."""
    directory = Path(directory).absolute()
    if directory.exists():
        shutil.rmtree(directory)
    directory.mkdir(parents=True)
    payload = _state_payload(state)
    torch.save(payload, directory / STATE_FILE)
    if meta is not None:
        (directory / "meta.json").write_text(json.dumps(meta, indent=2, default=str))
    if verify:
        restored = torch.load(directory / STATE_FILE, map_location="cpu", weights_only=True)
        if not _bitwise_equal(payload, restored):
            raise RuntimeError(
                f"checkpoint round-trip mismatch at {directory}: saved and restored "
                "states differ (quirk-Q4 guard)")
    return directory


def restore_checkpoint(directory: Path, template: "TrainState"
                       ) -> Tuple["TrainState", Dict[str, Any]]:
    """Load a checkpoint into ``template``'s model and optimizer (in place,
    on their devices); returns it with the checkpoint's meta."""
    directory = Path(directory).absolute()
    payload = torch.load(directory / STATE_FILE, map_location="cpu", weights_only=True)
    template.model.load_state_dict(payload["model"])
    template.optimizer.load_state_dict(payload["optimizer"])
    template.step = int(payload["step"])
    meta_path = directory / "meta.json"
    meta = json.loads(meta_path.read_text()) if meta_path.exists() else {}
    return template, meta


def tree_shapes(tree):
    """The nested dict of a variable tree's leaf shapes."""
    if isinstance(tree, dict):
        return {k: tree_shapes(v) for k, v in tree.items()}
    return np.shape(tree)


def transplant_backbone(target_params: Dict, source_params: Dict,
                        prefix: str = "backbone") -> Dict:
    """Copy a backbone subtree of a JAX variable tree into another's (the
    reference's prefix-filtered ``load_state_dict(strict=False)``
    transplants, 013:53-64, 004:327-349): shapes must match; heads stay."""
    target = copy.deepcopy(dict(target_params))
    if prefix not in source_params:
        raise KeyError(f"source has no '{prefix}' subtree")
    src = source_params[prefix]
    dst = target.get(prefix)
    if dst is not None and tree_shapes(src) != tree_shapes(dst):
        raise ValueError("backbone structure mismatch; cannot transplant")
    target[prefix] = copy.deepcopy(src)
    return target


def transplant_flat_backbone(target_params: Dict, source_params: Dict,
                             prefix: str = "backbone") -> Dict:
    """Copy the ``prefix`` subtree of a JAX variable tree onto a tree that
    names the same modules ``<prefix>_<x>`` at its top level (the adapter
    model's trunk: ``backbone_conv1``, ``backbone_layer1_0``, ...): each
    ``source[prefix][x]`` replaces ``target[f"{prefix}_{x}"]``, whose shapes
    must match; the other subtrees stay."""
    target = copy.deepcopy(dict(target_params))
    if prefix not in source_params:
        raise KeyError(f"source has no '{prefix}' subtree")
    for name, src in source_params[prefix].items():
        key = f"{prefix}_{name}"
        if key not in target:
            raise KeyError(f"target has no '{key}' subtree for source '{prefix}/{name}'")
        if tree_shapes(src) != tree_shapes(target[key]):
            raise ValueError(f"'{prefix}/{name}' and '{key}' differ in shape")
        target[key] = copy.deepcopy(src)
    return target


def merge_v5_pipeline_variables(stage2_vars: Dict[str, Any],
                                specialist_vars: Dict[str, Dict[str, Any]]) -> Dict[str, Any]:
    """The merged v5 multi-head eval checkpoint (013_run_pipeline_eval.py:
    66-94): the stage-2 tree supplies the backbone and the stage-1/2 heads,
    each specialist head subtree comes from its own stage-3 tree."""
    out: Dict[str, Any] = {}
    for col in ("params", "batch_stats"):
        if col not in stage2_vars and not any(col in v for v in specialist_vars.values()):
            continue
        merged = copy.deepcopy(dict(stage2_vars.get(col, {})))
        for head, vars_ in specialist_vars.items():
            key = f"specialist_{head}"
            src = vars_.get(col, {})
            if key in src:
                merged[key] = src[key]
        out[col] = merged
    return out


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


__all__ = ["load_variables_npz", "merge_v5_pipeline_variables", "restore_checkpoint",
           "save_checkpoint", "save_variables_npz", "states_equal", "transplant_backbone",
           "transplant_flat_backbone", "tree_shapes"]
