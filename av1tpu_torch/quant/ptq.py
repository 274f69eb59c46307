"""BN folding and the folded float forward of a v6 stage model.

Counterpart of the float serving parts of ``av1tpu.quant.ptq``: ``_fold``,
``fold_backbone``, ``fold_head``, ``is_plain_stage``, ``_conv_f`` and the
float paths of ``_backbone_apply`` / ``_head_apply``. int8 serving and
calibration are not ported yet (ROADMAP M9).

Folded trees hold torch layouts: conv ``weight`` OIHW, dense ``weight``
``(out, in)``, plus ``bias``. Folding runs in fp32; the serving dtype is
applied afterwards (``cast_tree``), as the JAX path casts folded fp32
kernels per call.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

import torch
import torch.nn.functional as F
from torch import nn

from av1tpu_torch.models.layers import BN_EPS, MLPHead, pad_same
from av1tpu_torch.models.v6 import ImprovedBackbone

_GROUPS = ("layer1", "layer2", "layer3", "layer4")


def _fold(conv_weight: torch.Tensor, bn: nn.BatchNorm2d):
    """Fold an inference-mode BatchNorm into the conv before it:
    ``conv(x)*k + (bias - mean*k)`` with ``k = scale/sqrt(var+eps)``."""
    k = bn.weight.detach().float() / torch.sqrt(
        bn.running_var.detach().float() + BN_EPS
    )
    w = conv_weight.detach().float() * k[:, None, None, None]
    return {"weight": w, "bias": bn.bias.detach().float() - bn.running_mean.float() * k}


def is_plain_stage(model: nn.Module) -> bool:
    """True for the ImprovedBackbone + MLPHead layout that
    ``fold_backbone`` / ``fold_head`` understand (the FGVC model's
    projection + cosine head is not one)."""
    return isinstance(getattr(model, "backbone", None), ImprovedBackbone) and (
        isinstance(getattr(model, "head", None), MLPHead)
    )


def fold_backbone(backbone: ImprovedBackbone) -> Dict[str, Any]:
    """BN-fold an ImprovedBackbone into conv weight+bias entries plus the
    SE and spatial-attention weights, all fp32."""
    folded: Dict[str, Any] = {"stem": _fold(backbone.conv1.weight, backbone.bn1)}
    for gi, gname in enumerate(_GROUPS, start=1):
        for bi, blk in enumerate(getattr(backbone, gname)):
            folded[f"{gname}_{bi}"] = {
                "conv1": _fold(blk.conv1.weight, blk.bn1),
                "conv2": _fold(blk.conv2.weight, blk.bn2),
                "downsample": None if blk.downsample is None
                else _fold(blk.downsample[0].weight, blk.downsample[1]),
            }
        exc = getattr(backbone, f"se{gi}").excitation
        folded[f"se{gi}"] = {
            "d0": exc[0].weight.detach().float(),
            "d1": exc[2].weight.detach().float(),
        }
    folded["spatial_attn"] = backbone.spatial_attn.conv.weight.detach().float()
    return folded


def fold_head(head: MLPHead) -> List[Dict[str, torch.Tensor]]:
    """An MLPHead's Linear layers as an ordered weight+bias list."""
    return [
        {"weight": m.weight.detach().float(), "bias": m.bias.detach().float()}
        for m in head.head if isinstance(m, nn.Linear)
    ]


def cast_tree(tree, device, dtype):
    """Copy every tensor of a folded tree to ``device`` / ``dtype``."""
    if isinstance(tree, dict):
        return {k: cast_tree(v, device, dtype) for k, v in tree.items()}
    if isinstance(tree, list):
        return [cast_tree(v, device, dtype) for v in tree]
    if tree is None:
        return None
    return tree.to(device=device, dtype=dtype)


def _conv_f(x: torch.Tensor, weight: torch.Tensor, stride: int) -> torch.Tensor:
    """3x3 XLA-"SAME" conv of an NCHW tensor, as a center-tap matmul at a
    1x1 extent with stride 1 (as the JAX path does)."""
    weight = weight.to(x.dtype)
    if x.shape[2] == 1 and x.shape[3] == 1 and stride == 1 and weight.shape[2] == 3:
        return (x[:, :, 0, 0] @ weight[:, :, 1, 1].T)[:, :, None, None]
    return F.conv2d(pad_same(x, weight.shape[2], stride), weight, stride=stride)


def _bias(t: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    return t + bias.to(t.dtype)[None, :, None, None]


def _backbone_apply(
    folded: Dict[str, Any],
    x: torch.Tensor,
    float_dtype=torch.float32,
    front_fn: Optional[Callable] = None,
    front_g1_fn: Optional[Callable] = None,
    group12_fn: Optional[Callable] = None,
) -> torch.Tensor:
    """ImprovedBackbone forward over folded weights: NHWC ``(B, H, W, 1)``
    in, ``(B, 512)`` embedding out.

    ``front_fn`` replaces stem conv + bias + relu + maxpool (kernel K1,
    ``kernels.fused_front.make_fused_front``); ``front_g1_fn`` replaces
    that and layer group 1 with SE1 (kernel K2), so the forward resumes at
    group 2. Both take the NHWC input and return NHWC ``(B, H/4, W/4, 64)``.
    ``group12_fn`` replaces layer groups 1 and 2 with SE1 and SE2 (kernel
    K5, ``kernels.resnet_group.fused_group12``): NHWC ``(B, h, w, 64)`` in,
    ``(B, h/2, w/2, 128)`` out, after ``front_fn`` or the plain stem. As in
    the JAX package, ``front_g1_fn`` takes precedence: with it, group 1 is
    done and ``group12_fn`` is not called.
    """
    x = x.to(float_dtype)
    groups = list(enumerate(_GROUPS, start=1))
    if front_g1_fn is not None:
        x = front_g1_fn(x).permute(0, 3, 1, 2)
        groups = groups[1:]
        group12_fn = None
    elif front_fn is not None:
        x = front_fn(x).permute(0, 3, 1, 2)
    else:
        stem = folded["stem"]
        x = F.conv2d(x.permute(0, 3, 1, 2), stem["weight"].to(float_dtype),
                     stride=2, padding=3)
        x = torch.relu(_bias(x, stem["bias"]))
        x = F.max_pool2d(x, 3, stride=2, padding=1)
    if group12_fn is not None:
        x = group12_fn(x.permute(0, 2, 3, 1).contiguous()).permute(0, 3, 1, 2)
        groups = groups[2:]

    for gi, gname in groups:
        for bi in range(2):
            blk = folded[f"{gname}_{bi}"]
            stride = 2 if (gi > 1 and bi == 0) else 1
            y = torch.relu(_bias(_conv_f(x, blk["conv1"]["weight"], stride),
                                 blk["conv1"]["bias"]))
            y = _bias(_conv_f(y, blk["conv2"]["weight"], 1), blk["conv2"]["bias"])
            res = x
            if blk["downsample"] is not None:
                ds = blk["downsample"]
                res = _bias(F.conv2d(x, ds["weight"].to(x.dtype), stride=stride),
                            ds["bias"])
            x = torch.relu(y + res)
        se = folded[f"se{gi}"]
        g = x.mean(dim=(2, 3))
        g = torch.relu(g @ se["d0"].to(g.dtype).T)
        g = torch.sigmoid(g @ se["d1"].to(g.dtype).T)
        x = x * g[:, :, None, None]

    sa = folded["spatial_attn"].to(float_dtype)  # (1, 2, 7, 7)
    a = torch.cat([x.mean(dim=1, keepdim=True), x.amax(dim=1, keepdim=True)], 1)
    if x.shape[2] == 1 and x.shape[3] == 1:
        attn = (a[:, :, 0, 0] @ sa[0, :, 3, 3])[:, None, None, None]
    else:
        attn = F.conv2d(a, sa, padding=3)
    x = x * torch.sigmoid(attn)
    return x.mean(dim=(2, 3))


def _head_apply(head: List[Dict[str, torch.Tensor]], x: torch.Tensor,
                float_dtype=torch.float32) -> torch.Tensor:
    """MLPHead forward over ``fold_head`` layers (dropout is identity)."""
    x = x.to(float_dtype)
    for i, layer in enumerate(head):
        x = x @ layer["weight"].to(x.dtype).T + layer["bias"].to(x.dtype)
        if i < len(head) - 1:
            x = torch.relu(x)
    return x


__all__ = [
    "cast_tree",
    "fold_backbone",
    "fold_head",
    "is_plain_stage",
]
