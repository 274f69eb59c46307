"""Reference PyTorch checkpoint -> JAX-shaped variable tree (numpy).

The port's own copy of ``av1tpu.models.torch_import``: a reference ``.pt``
(``{model_state_dict | model_state, ...}``, torchvision-style key names)
becomes the ``{"params", "batch_stats"}`` tree of numpy arrays that the JAX
package imports it to, and ``models.jax_import.from_jax_variables`` takes it
from there, so a ``.pt`` reaches a port model by the JAX package's path. The
JAX copy's ``as_jax_variables`` is left out: it imports jax.

Tensor-layout conventions handled here:
  * Conv2d weight OIHW -> flax HWIO (transpose 2,3,1,0)
  * Depthwise conv (groups=C): torch (C,1,kH,kW) -> flax (kH,kW,1,C)
  * Linear weight (out,in) -> flax kernel (in,out) (transpose)
  * BatchNorm weight/bias -> params scale/bias; running_mean/var ->
    batch_stats mean/var

Name maps cover the three reference model families:
  * v6 ``Stage{1,2}Model`` / ``Stage3{Rect,AB}Model`` / ``Stage2FlatModel``
    (pesquisa_v6/v6_pipeline/models.py naming)
  * v6 ``FGVCModel`` (scripts/006 naming)
  * v5 ``HierarchicalModel`` (pesquisa_v5/v5_pipeline/models_hier.py naming)

A served ``.pt`` runs under the port's XLA ``"SAME"`` padding, as the JAX
package serves it (ROADMAP F1).
"""
from __future__ import annotations

import re
from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch


def _to_numpy(t) -> np.ndarray:
    if isinstance(t, np.ndarray):
        return t
    return t.detach().cpu().numpy()  # torch tensor


def _conv_kernel(w: np.ndarray, depthwise: bool = False) -> np.ndarray:
    w = _to_numpy(w)
    if depthwise:
        # torch depthwise (C,1,kH,kW) -> flax (kH,kW,1,C)
        return w.transpose(2, 3, 1, 0)
    return w.transpose(2, 3, 1, 0)  # OIHW -> HWIO


def _linear_kernel(w: np.ndarray) -> np.ndarray:
    return _to_numpy(w).T


def _set(tree: Dict, path: Tuple[str, ...], value: np.ndarray) -> None:
    node = tree
    for key in path[:-1]:
        node = node.setdefault(key, {})
    node[path[-1]] = value


def _put_bn(params, stats, flax_prefix: Tuple[str, ...], torch_prefix: str, sd) -> None:
    _set(params, flax_prefix + ("scale",), _to_numpy(sd[torch_prefix + ".weight"]))
    _set(params, flax_prefix + ("bias",), _to_numpy(sd[torch_prefix + ".bias"]))
    _set(stats, flax_prefix + ("mean",), _to_numpy(sd[torch_prefix + ".running_mean"]))
    _set(stats, flax_prefix + ("var",), _to_numpy(sd[torch_prefix + ".running_var"]))


def _put_conv(params, flax_prefix, torch_key, sd, depthwise=False) -> None:
    _set(params, flax_prefix + ("kernel",), _conv_kernel(sd[torch_key], depthwise))


def _put_linear(params, flax_prefix, torch_prefix, sd, bias=True) -> None:
    _set(params, flax_prefix + ("kernel",), _linear_kernel(sd[torch_prefix + ".weight"]))
    if bias and torch_prefix + ".bias" in sd:
        _set(params, flax_prefix + ("bias",), _to_numpy(sd[torch_prefix + ".bias"]))


def _sequential_linear_indices(sd: Mapping[str, Any], prefix: str):
    """Indices i of ``{prefix}.{i}.weight`` 2-D (Linear) entries, sorted."""
    idx = []
    pat = re.compile(re.escape(prefix) + r"\.(\d+)\.weight$")
    for key in sd:
        m = pat.match(key)
        if m and _to_numpy(sd[key]).ndim == 2:
            idx.append(int(m.group(1)))
    return sorted(idx)


def _import_mlp_head(params, stats, flax_prefix, torch_prefix, sd) -> None:
    """torch nn.Sequential of Linear/ReLU/Dropout -> MLPHead Dense_0..n."""
    for di, ti in enumerate(_sequential_linear_indices(sd, torch_prefix)):
        _put_linear(params, flax_prefix + (f"Dense_{di}",), f"{torch_prefix}.{ti}", sd)


def _import_improved_backbone(params, stats, prefix: Tuple[str, ...], tp: str, sd) -> None:
    """Reference ``ImprovedBackbone`` (models.py:64-126) -> flax
    ``ImprovedBackbone`` (same graph, names layer{g}_{b}/se{g}/spatial_attn)."""
    _put_conv(params, prefix + ("conv1",), f"{tp}conv1.weight", sd)
    _put_bn(params, stats, prefix + ("bn1",), f"{tp}bn1", sd)
    for g in range(1, 5):
        for b in range(2):
            fb = prefix + (f"layer{g}_{b}",)
            tb = f"{tp}layer{g}.{b}"
            _put_conv(params, fb + ("conv1",), f"{tb}.conv1.weight", sd)
            _put_bn(params, stats, fb + ("bn1",), f"{tb}.bn1", sd)
            _put_conv(params, fb + ("conv2",), f"{tb}.conv2.weight", sd)
            _put_bn(params, stats, fb + ("bn2",), f"{tb}.bn2", sd)
            if f"{tb}.downsample.0.weight" in sd:
                _put_conv(params, fb + ("downsample_conv",), f"{tb}.downsample.0.weight", sd)
                _put_bn(params, stats, fb + ("downsample_bn",), f"{tb}.downsample.1", sd)
        # SE excitation Sequential: 0=Linear, 2=Linear (models.py:32-37)
        se = prefix + (f"se{g}",)
        _put_linear(params, se + ("Dense_0",), f"{tp}se{g}.excitation.0", sd, bias=False)
        _put_linear(params, se + ("Dense_1",), f"{tp}se{g}.excitation.2", sd, bias=False)
    _put_conv(params, prefix + ("spatial_attn", "Conv_0"), f"{tp}spatial_attn.conv.weight", sd)


def import_v6_stage_model(state_dict: Mapping[str, Any]) -> Dict[str, Dict]:
    """Import any v6 per-stage model (Stage1/2/3Rect/3AB/Flat).

    Returns ``{"params": ..., "batch_stats": ...}`` matching the flax
    module trees in :mod:`av1tpu.models.v6`.
    """
    sd = dict(state_dict)
    params: Dict = {}
    stats: Dict = {}
    _import_improved_backbone(params, stats, ("backbone",), "backbone.", sd)
    _import_mlp_head(params, stats, ("head",), "head.head", sd)
    if "head.temperature" in sd:
        params["temperature"] = _to_numpy(sd["head.temperature"])
    return {"params": params, "batch_stats": stats}


def import_fgvc_model(state_dict: Mapping[str, Any]) -> Dict[str, Dict]:
    """Import the FGVC stage-3 AB model (scripts/006 naming:
    backbone.* / feat_proj.{0,4}=Linear,{1,5}=BatchNorm1d / classifier.weight)."""
    sd = dict(state_dict)
    params: Dict = {}
    stats: Dict = {}
    _import_improved_backbone(params, stats, ("backbone",), "backbone.", sd)
    # feat_proj Sequential: Linear,BN,ReLU,Dropout,Linear,BN,ReLU,Dropout
    lin_idx = _sequential_linear_indices(sd, "feat_proj")
    bn_idx = sorted(
        int(m.group(1))
        for m in (
            re.match(r"feat_proj\.(\d+)\.running_mean$", k) for k in sd
        )
        if m
    )
    for li, (ti, bi) in enumerate(zip(lin_idx, bn_idx)):
        _put_linear(params, (f"proj_dense{li}",), f"feat_proj.{ti}", sd)
        _put_bn(params, stats, (f"proj_bn{li}",), f"feat_proj.{bi}", sd)
    _set(params, ("classifier", "weight"), _to_numpy(sd["classifier.weight"]))
    return {"params": params, "batch_stats": stats}


def import_v5_hierarchical(state_dict: Mapping[str, Any]) -> Dict[str, Dict]:
    """Import the v5 ``HierarchicalModel`` (models_hier.py naming)."""
    sd = dict(state_dict)
    params: Dict = {}
    stats: Dict = {}

    bb = ("backbone",)
    _put_conv(params, bb + ("stem", "Conv_0"), "backbone.stem.conv.weight", sd)
    _put_bn(params, stats, bb + ("stem", "BatchNorm_0"), "backbone.stem.bn", sd)
    for i in range(3):
        blk = bb + (f"block{i + 1}",)
        tb = f"backbone.blocks.{i}"
        _put_conv(params, blk + ("Conv_0",), f"{tb}.depthwise.weight", sd, depthwise=True)
        _put_bn(params, stats, blk + ("BatchNorm_0",), f"{tb}.bn1", sd)
        _put_conv(params, blk + ("Conv_1",), f"{tb}.pointwise.weight", sd)
        _put_bn(params, stats, blk + ("BatchNorm_1",), f"{tb}.bn2", sd)

    head_map = {
        "stage1_head": "stage1_head.fc",
        "stage2_head": "stage2_head.fc",
    }
    for flax_name, torch_prefix in head_map.items():
        _import_mlp_head(params, stats, (flax_name,), torch_prefix, sd)
    heads = sorted(
        {m.group(1) for m in (re.match(r"specialist_heads\.([^.]+)\.", k) for k in sd) if m}
    )
    for head in heads:
        _import_mlp_head(
            params, stats, (f"specialist_{head}",), f"specialist_heads.{head}.fc", sd
        )
    if "qp_embed.proj.0.weight" in sd:
        _put_linear(params, ("qp_embed", "Dense_0"), "qp_embed.proj.0", sd)
    return {"params": params, "batch_stats": stats}


def import_any(state_dict: Mapping[str, Any]) -> Dict[str, Dict]:
    """Auto-dispatch a reference state dict to the right importer by its
    key shape: ``specialist_heads.*`` -> v5 hierarchical
    (models_hier.py:158-206), ``feat_proj.*``/``classifier.weight`` ->
    FGVC (scripts/006), else a v6 per-stage model."""
    keys = set(state_dict)
    if any(k.startswith("specialist_heads.") for k in keys):
        return import_v5_hierarchical(state_dict)
    if "classifier.weight" in keys or any(k.startswith("feat_proj.") for k in keys):
        return import_fgvc_model(state_dict)
    return import_v6_stage_model(state_dict)


def load_torch_checkpoint(path) -> Dict[str, Any]:
    """Load a reference checkpoint file and return its raw state dict
    (handles both ``model_state_dict`` and ``model_state`` payload keys)."""
    payload = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(payload, dict):
        for key in ("model_state_dict", "model_state"):
            if key in payload:
                return payload[key]
    return payload


__all__ = [
    "import_any",
    "import_fgvc_model",
    "import_v5_hierarchical",
    "import_v6_stage_model",
    "load_torch_checkpoint",
]
