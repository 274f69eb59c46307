"""The parts of the v6 models in plain PyTorch, from a state dict and the
configuration's sizes; each model family (``families/<family>/reference.py``)
builds its models from them.

This is the benchmark's own statement of what the system computes: a
ResNet-18 trunk (7x7/2 stem with BatchNorm, ReLU and a 3x3/2 max-pool; four
groups of two basic blocks, widths 64-512, a 1x1 projection shortcut where the
stride or width changes), a squeeze-and-excitation gate after each group, a
7x7 spatial-attention gate over the channel mean and max, a global mean, and
an MLP head per decision. BatchNorm runs in eval mode, unfolded. The 3x3
convolutions pad as XLA's "SAME" does (at stride 2 and an even extent the
extra row and column go low/high as (0, 1)): the system's stated semantics,
where the published PyTorch code pads (1, 1). Nothing here imports the
program.

State dict names follow the published checkpoints' torchvision-style keys
(``backbone.layer2.0.downsample.0.weight``, ``head.head.3.bias``), which is the
checkpoint format the system loads; a family names its heads' prefixes.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F


def _bn_shapes(prefix: str, c: int) -> List[Tuple[str, tuple]]:
    return [(f"{prefix}.{k}", (c,)) for k in ("weight", "bias", "running_mean", "running_var")]


def backbone_shapes(arch: dict, prefix: str = "backbone") -> List[Tuple[str, tuple]]:
    """``(name, shape)`` of every float tensor of the trunk, in module order."""
    stem = arch["stem"]
    c = stem["channels"]
    out = [(f"{prefix}.conv1.weight", (c, 1, stem["kernel"], stem["kernel"]))]
    out += _bn_shapes(f"{prefix}.bn1", c)
    in_ch = c
    for g, width in enumerate(arch["widths"], start=1):
        for b in range(arch["blocks_per_group"]):
            p = f"{prefix}.layer{g}.{b}"
            stride = 2 if (g > 1 and b == 0) else 1
            out += [(f"{p}.conv1.weight", (width, in_ch, 3, 3))] + _bn_shapes(f"{p}.bn1", width)
            out += [(f"{p}.conv2.weight", (width, width, 3, 3))] + _bn_shapes(f"{p}.bn2", width)
            if in_ch != width or stride != 1:
                out += [(f"{p}.downsample.0.weight", (width, in_ch, 1, 1))]
                out += _bn_shapes(f"{p}.downsample.1", width)
            in_ch = width
        hidden = width // arch["se_reduction"]
        out += [(f"{prefix}.se{g}.excitation.0.weight", (hidden, width)),
                (f"{prefix}.se{g}.excitation.2.weight", (width, hidden))]
    k = arch["attention_kernel"]
    out.append((f"{prefix}.spatial_attn.conv.weight", (1, 2, k, k)))
    return out


def head_shapes(widths: List[int], in_dim: int, prefix: str) -> List[Tuple[str, tuple]]:
    """An MLP head's Linear layers; hidden layers are Linear, ReLU, Dropout."""
    out = []
    for i, width in enumerate(widths):
        out += [(f"{prefix}.head.{3 * i}.weight", (width, in_dim)),
                (f"{prefix}.head.{3 * i}.bias", (width,))]
        in_dim = width
    return out


def same_padding(size: int, kernel: int, stride: int) -> Tuple[int, int]:
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def conv_same(x: torch.Tensor, w: torch.Tensor, stride: int) -> torch.Tensor:
    """A square "SAME" convolution of an NCHW tensor, no bias. At a 1x1 extent
    and stride 1 only the centre tap meets the input: a matrix product."""
    k = w.shape[-1]
    if x.shape[-1] == 1 and x.shape[-2] == 1 and stride == 1:
        return (x[:, :, 0, 0] @ w[:, :, k // 2, k // 2].T)[:, :, None, None]
    top, bottom = same_padding(x.shape[-2], k, stride)
    left, right = same_padding(x.shape[-1], k, stride)
    return F.conv2d(F.pad(x, (left, right, top, bottom)), w, stride=stride)


def batch_norm(sd: Dict[str, torch.Tensor], prefix: str, x: torch.Tensor, eps: float,
               calibrate: bool) -> torch.Tensor:
    """Eval-mode BatchNorm from the running statistics. With ``calibrate``
    the running statistics are first set to this batch's (biased) ones."""
    if calibrate:
        dims = (0, 2, 3)
        sd[f"{prefix}.running_mean"].copy_(x.mean(dim=dims))
        sd[f"{prefix}.running_var"].copy_(x.var(dim=dims, unbiased=False))
    scale = sd[f"{prefix}.weight"] / torch.sqrt(sd[f"{prefix}.running_var"] + eps)
    shift = sd[f"{prefix}.bias"] - sd[f"{prefix}.running_mean"] * scale
    return x * scale[None, :, None, None] + shift[None, :, None, None]


def backbone(sd: Dict[str, torch.Tensor], arch: dict, x: torch.Tensor,
             calibrate: bool = False, prefix: str = "backbone") -> torch.Tensor:
    """NHWC ``(N, H, W, 1)`` in [0, 1] -> the ``(N, 512)`` embedding."""
    eps, stem, pool = arch["bn_eps"], arch["stem"], arch["pool"]
    x = x.permute(0, 3, 1, 2)
    x = F.conv2d(x, sd[f"{prefix}.conv1.weight"], stride=stem["stride"], padding=stem["padding"])
    x = torch.relu(batch_norm(sd, f"{prefix}.bn1", x, eps, calibrate))
    x = F.max_pool2d(x, pool["kernel"], stride=pool["stride"], padding=pool["padding"])
    for g in range(1, len(arch["widths"]) + 1):
        for b in range(arch["blocks_per_group"]):
            p = f"{prefix}.layer{g}.{b}"
            stride = 2 if (g > 1 and b == 0) else 1
            y = conv_same(x, sd[f"{p}.conv1.weight"], stride)
            y = torch.relu(batch_norm(sd, f"{p}.bn1", y, eps, calibrate))
            y = batch_norm(sd, f"{p}.bn2", conv_same(y, sd[f"{p}.conv2.weight"], 1), eps,
                           calibrate)
            res = x
            if f"{p}.downsample.0.weight" in sd:
                res = F.conv2d(x, sd[f"{p}.downsample.0.weight"], stride=stride)
                res = batch_norm(sd, f"{p}.downsample.1", res, eps, calibrate)
            x = torch.relu(y + res)
        gate = torch.relu(x.mean(dim=(2, 3)) @ sd[f"{prefix}.se{g}.excitation.0.weight"].T)
        gate = torch.sigmoid(gate @ sd[f"{prefix}.se{g}.excitation.2.weight"].T)
        x = x * gate[:, :, None, None]
    maps = torch.cat([x.mean(dim=1, keepdim=True), x.amax(dim=1, keepdim=True)], dim=1)
    x = x * torch.sigmoid(conv_same(maps, sd[f"{prefix}.spatial_attn.conv.weight"], 1))
    return x.mean(dim=(2, 3))


def head(sd: Dict[str, torch.Tensor], prefix: str, feats: torch.Tensor) -> torch.Tensor:
    """An MLP head: Linear and ReLU per hidden width, then the logits Linear
    (dropout is the identity in eval mode)."""
    layers = sorted({int(k.split(".")[-2]) for k in sd if k.startswith(f"{prefix}.head.")})
    x = feats
    for i, index in enumerate(layers):
        x = x @ sd[f"{prefix}.head.{index}.weight"].T + sd[f"{prefix}.head.{index}.bias"]
        if i < len(layers) - 1:
            x = torch.relu(x)
    return x


def last_bias(sd: Dict[str, torch.Tensor], prefix: str) -> torch.Tensor:
    """The bias of an MLP head's logits layer (a view: adding to it shifts
    the logits)."""
    index = max(int(k.split(".")[-2]) for k in sd if k.startswith(f"{prefix}.head."))
    return sd[f"{prefix}.head.{index}.bias"]


def threshold_logit(threshold: float) -> float:
    """The stage-1 logit at which the gate's probability equals ``threshold``."""
    return math.log(threshold / (1.0 - threshold))


__all__ = ["backbone", "backbone_shapes", "batch_norm", "conv_same", "head", "head_shapes",
           "last_bias", "same_padding", "threshold_logit"]
