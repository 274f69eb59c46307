"""Weight bridge between the JAX package's variable trees and torch state
dicts.

``from_jax_variables`` takes ``{"params", "batch_stats"}`` of a v6 stage
model or an FGVC model (numpy leaves, as ``train.checkpoint`` loads them)
and returns the port's state dict; ``to_jax_variables`` inverts it, so
tests and ``chip_smoke.py`` can write npz checkpoints without jax.

Layouts: conv kernels HWIO <-> OIHW, Dense kernels (in, out) <-> Linear
weights (out, in), BatchNorm ``scale/bias/mean/var`` <->
``weight/bias/running_mean/running_var``. Names: ``layer2_0`` <->
``layer2.0``, ``downsample_conv|bn`` <-> ``downsample.0|1``,
``se*/Dense_0|1`` <-> ``se*.excitation.0|2``, ``spatial_attn/Conv_0`` <->
``spatial_attn.conv``, ``head/Dense_i`` <-> ``head.head.<3i>`` (and the
unified model's ``head_stage1|head_stage2|head_rect|head_ab`` likewise),
``proj_dense<l>|proj_bn<l>`` <-> ``feat_proj.<4l>|<4l+1>``, the stage-1
``temperature`` <-> ``head.temperature``, the unified model's top-level
``temperature`` <-> ``temperature`` (the tree that has no ``head`` module).
The adapter model's flat names keep their prefix (``backbone_layer1_0`` <->
``backbone_layer1.0``, ``backbone_bn1``), with ``adapter_layer<g>/Dense_0|1``
<-> ``adapter_layer<g>.down|up``. The v5 tree: ``backbone/stem/Conv_0|
BatchNorm_0`` <-> ``backbone.stem.conv|bn``, ``backbone/block<i>/Conv_0|
BatchNorm_0|Conv_1|BatchNorm_1`` <-> ``backbone.blocks.<i-1>.depthwise|bn1|
pointwise|bn2`` (the depthwise kernel ``(3, 3, 1, C)`` <-> ``(C, 1, 3, 3)``,
the same transpose as any conv), ``stage1_head|stage2_head/Dense_i`` <->
``stage1_head|stage2_head.fc.<3i>``, ``specialist_<H>/Dense_i`` <->
``specialist_heads.<H>.fc.<3i>``, ``qp_embed/Dense_0`` <-> ``qp_embed.proj.0``.

``quant_model_from_arrays`` builds the port's int8 model from an int8
state held as numpy arrays (scales, int8 weights, corrected biases, the
hybrid plan, the calibration absmax), so a test can carry the JAX package's
quantized state across without the port importing it.
"""
from __future__ import annotations

import re
from typing import Any, Dict, Iterator, Mapping, Tuple

import numpy as np
import torch
from torch import nn

# (JAX module path pattern, torch replacement), applied to the slash-joined
# JAX module path; the inverse table below undoes each rule.
_TO_TORCH = (
    (r"layer(\d)_(\d)", r"layer\1.\2"),
    (r"downsample_conv", "downsample.0"),
    (r"downsample_bn", "downsample.1"),
    (r"(se\d)/Dense_0", r"\1/excitation.0"),
    (r"(se\d)/Dense_1", r"\1/excitation.2"),
    (r"spatial_attn/Conv_0", "spatial_attn/conv"),
    (r"^(head\w*)/Dense_(\d+)", lambda m: f"{m[1]}/head.{3 * int(m[2])}"),
    (r"^proj_dense(\d+)", lambda m: f"feat_proj.{4 * int(m[1])}"),
    (r"^proj_bn(\d+)", lambda m: f"feat_proj.{4 * int(m[1]) + 1}"),
    (r"^(adapter_layer\d)/Dense_0", r"\1/down"),
    (r"^(adapter_layer\d)/Dense_1", r"\1/up"),
    (r"^backbone/stem/Conv_0", "backbone/stem/conv"),
    (r"^backbone/stem/BatchNorm_0", "backbone/stem/bn"),
    (r"^backbone/block(\d+)/(Conv_0|BatchNorm_0|Conv_1|BatchNorm_1)$",
     lambda m: f"backbone/blocks.{int(m[1]) - 1}/{_V5_BLOCK[m[2]]}"),
    (r"^(stage\d_head)/Dense_(\d+)", lambda m: f"{m[1]}/fc.{3 * int(m[2])}"),
    (r"^specialist_([^/]+)/Dense_(\d+)",
     lambda m: f"specialist_heads.{m[1]}/fc.{3 * int(m[2])}"),
    (r"^qp_embed/Dense_0", "qp_embed/proj.0"),
)
_TO_JAX = (
    (r"layer(\d)\.(\d)", r"layer\1_\2"),
    (r"downsample\.0", "downsample_conv"),
    (r"downsample\.1", "downsample_bn"),
    (r"(se\d)\.excitation\.0", r"\1.Dense_0"),
    (r"(se\d)\.excitation\.2", r"\1.Dense_1"),
    (r"spatial_attn\.conv", "spatial_attn.Conv_0"),
    (r"^(head\w*)\.head\.(\d+)", lambda m: f"{m[1]}.Dense_{int(m[2]) // 3}"),
    (r"^feat_proj\.(\d+)", lambda m: (
        f"proj_dense{int(m[1]) // 4}" if int(m[1]) % 4 == 0
        else f"proj_bn{int(m[1]) // 4}"
    )),
    (r"^(adapter_layer\d)\.down", r"\1.Dense_0"),
    (r"^(adapter_layer\d)\.up", r"\1.Dense_1"),
    (r"^backbone\.stem\.conv$", "backbone.stem.Conv_0"),
    (r"^backbone\.stem\.bn$", "backbone.stem.BatchNorm_0"),
    (r"^backbone\.blocks\.(\d+)\.(depthwise|bn1|pointwise|bn2)$",
     lambda m: f"backbone.block{int(m[1]) + 1}.{_V5_BLOCK_INV[m[2]]}"),
    (r"^(stage\d_head)\.fc\.(\d+)", lambda m: f"{m[1]}.Dense_{int(m[2]) // 3}"),
    (r"^specialist_heads\.([^.]+)\.fc\.(\d+)",
     lambda m: f"specialist_{m[1]}.Dense_{int(m[2]) // 3}"),
    (r"^qp_embed\.proj\.0", "qp_embed.Dense_0"),
)
# A v5 block's flax submodules <-> the reference's names
_V5_BLOCK = {"Conv_0": "depthwise", "BatchNorm_0": "bn1", "Conv_1": "pointwise",
             "BatchNorm_1": "bn2"}
_V5_BLOCK_INV = {v: k for k, v in _V5_BLOCK.items()}
# The last JAX module name of every BatchNorm: ``bn1``, ``backbone_bn1``,
# ``downsample_bn``, ``proj_bn0``, the v5 ``BatchNorm_<i>``
_BN_MODULE = re.compile(r"^(\w*bn\d+|downsample_bn|BatchNorm_\d+)$")
_BN_LEAVES = {  # JAX (collection, leaf) -> torch leaf
    ("params", "scale"): "weight",
    ("params", "bias"): "bias",
    ("batch_stats", "mean"): "running_mean",
    ("batch_stats", "var"): "running_var",
}
_BN_LEAVES_INV = {v: k for k, v in _BN_LEAVES.items()}
_TEMPERATURE = "head.temperature"  # Stage1Model keeps it under its head
_UNIFIED_TEMPERATURE = "temperature"  # UnifiedV6Model has four heads and no ``head``


def _rewrite(path: str, rules) -> str:
    for pattern, repl in rules:
        path = re.sub(pattern, repl, path)
    return path


def _leaves(tree: Mapping, prefix: Tuple[str, ...] = ()) -> Iterator:
    for key, value in tree.items():
        if isinstance(value, Mapping):
            yield from _leaves(value, prefix + (str(key),))
        else:
            yield prefix + (str(key),), value


def _kernel_to_torch(k: np.ndarray) -> np.ndarray:
    if k.ndim == 4:
        return k.transpose(3, 2, 0, 1)  # HWIO -> OIHW
    return k.T  # Dense (in, out) -> Linear (out, in)


def _kernel_to_jax(w: np.ndarray) -> np.ndarray:
    if w.ndim == 4:
        return w.transpose(2, 3, 1, 0)  # OIHW -> HWIO
    return w.T


def from_jax_variables(variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX ``{"params", "batch_stats"}`` tree -> torch state dict."""
    sd: Dict[str, torch.Tensor] = {}
    temperature = (_TEMPERATURE if "head" in variables.get("params", {})
                   else _UNIFIED_TEMPERATURE)
    for col in ("params", "batch_stats"):
        for path, value in _leaves(variables.get(col, {})):
            value = np.asarray(value)
            if col == "params" and path == ("temperature",):
                sd[temperature] = torch.from_numpy(np.array(value))
                continue
            module, leaf = path[:-1], path[-1]
            tmod = _rewrite("/".join(module), _TO_TORCH).replace("/", ".")
            if _BN_MODULE.match(module[-1]):
                tleaf = _BN_LEAVES[(col, leaf)]
                sd[f"{tmod}.num_batches_tracked"] = torch.tensor(0)
            elif leaf == "kernel":
                tleaf, value = "weight", _kernel_to_torch(value)
            else:
                tleaf = leaf
            sd[f"{tmod}.{tleaf}"] = torch.from_numpy(np.array(value, order="C"))
    return sd


def to_jax_variables(state_dict: Mapping[str, torch.Tensor]) -> Dict[str, Dict]:
    """Torch state dict -> JAX ``{"params", "batch_stats"}`` tree of numpy
    arrays (the inverse of :func:`from_jax_variables`)."""
    out: Dict[str, Dict] = {"params": {}, "batch_stats": {}}
    for key, tensor in state_dict.items():
        if key.endswith("num_batches_tracked"):
            continue
        value = tensor.detach().cpu().numpy()
        if key in (_TEMPERATURE, _UNIFIED_TEMPERATURE):
            out["params"]["temperature"] = value.copy()
            continue
        tmod, tleaf = key.rsplit(".", 1)
        module = _rewrite(tmod, _TO_JAX).split(".")
        if _BN_MODULE.match(module[-1]):
            col, leaf = _BN_LEAVES_INV[tleaf]
        elif tleaf == "weight" and module[-1] != "classifier":
            col, leaf, value = "params", "kernel", _kernel_to_jax(value)
        else:
            col, leaf = "params", tleaf
        node = out[col]
        for part in module:
            node = node.setdefault(part, {})
        node[leaf] = np.ascontiguousarray(value)
    return out


def load_jax_variables(model: nn.Module, variables: Mapping[str, Any]) -> nn.Module:
    """Load a JAX variable tree into ``model`` (strict: every key maps)."""
    model.load_state_dict(from_jax_variables(variables))
    return model


def _tensors(tree, device):
    if isinstance(tree, Mapping):
        return {k: _tensors(v, device) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree, order="C")).to(device)


def quant_model_from_arrays(model: nn.Module, scales: Mapping, qw: Mapping,
                            qbias: Any, plan: Mapping, calib_amax: Mapping,
                            float_dtype=torch.float32, device=None):
    """The port's int8 model of ``model`` (a v6 stage model or a
    ``UnifiedV6Model`` holding the weights that were quantized) carrying
    another quantizer's state, given as plain numpy arrays in the JAX
    package's layouts: ``scales`` (site -> ``(inv, s_x)``), ``qw`` (weight key
    -> ``(int8 (K, O), s_w)``), ``qbias`` (weight key -> bias, or None),
    ``plan`` (``hw``, ``blocks``, and ``smm_w`` / ``smm_b`` per weight key) and
    ``calib_amax`` (site -> absmax). The folded float weights come from
    ``model``. Returns a ``quant.ptq.QuantStageModel`` or
    ``QuantUnifiedModel`` on ``device``, by default the device that ``model``'s
    parameters are on."""
    from av1tpu_torch.quant import ptq

    device = torch.device(device if device is not None
                          else next(model.parameters()).device)
    folded = ptq.cast_tree(ptq.jax_layout_backbone(ptq.fold_backbone(model.backbone)),
                           device, torch.float32)
    state = dict(
        scales={site: (_tensors(inv, device), float(s_x))
                for site, (inv, s_x) in scales.items()},
        qw={wkey: (_tensors(w, device), _tensors(s, device))
            for wkey, (w, s) in qw.items()},
        float_dtype=float_dtype,
        qbias=None if qbias is None else _tensors(qbias, device),
        plan={"hw": int(plan["hw"]),
              "blocks": {n: dict(b) for n, b in plan["blocks"].items()},
              "smm_w": _tensors(plan["smm_w"], device),
              "smm_b": _tensors(plan["smm_b"], device)},
        calib_amax={site: np.asarray(v, np.float64) for site, v in calib_amax.items()},
    )
    if hasattr(model, "head"):
        head = ptq.cast_tree(ptq.jax_layout_head(ptq.fold_head(model.head)), device,
                             torch.float32)
        return ptq.QuantStageModel(folded, head, **state)
    heads = {name: ptq.cast_tree(ptq.jax_layout_head(ptq.fold_head(getattr(model, name))),
                                 device, torch.float32)
             for name in ptq._UNIFIED_HEADS}
    return ptq.QuantUnifiedModel(folded, heads, **state)


__all__ = ["from_jax_variables", "load_jax_variables", "quant_model_from_arrays",
           "to_jax_variables"]
