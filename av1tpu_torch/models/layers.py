"""v6 building blocks as ``nn.Module``s (NCHW inside, eval-mode inference).

Counterpart of ``av1tpu.models.layers``. Submodule names follow the
reference's torchvision-style state-dict keys (``conv1``, ``bn1``,
``downsample.0``, ``excitation.0``, ``spatial_attn.conv``, ``head.head.0``)
so that ``models.jax_import`` maps the JAX tree onto them mechanically.

Padding follows XLA ``"SAME"``, not PyTorch's symmetric ``padding=1``: a
stride-2 3x3 conv at an even extent pads (0, 1), at extent 1 it pads (1, 1)
(ROADMAP fault F1). ``same_padding`` is the one formula every conv of the
port uses.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

BN_EPS = 1e-5  # flax BatchNorm's default epsilon


def same_padding(size: int, kernel: int, stride: int) -> Tuple[int, int]:
    """XLA ``"SAME"`` padding (low, high) of one spatial axis."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def pad_same(x: torch.Tensor, kernel: int, stride: int) -> torch.Tensor:
    """Zero-pad an NCHW tensor so that a VALID conv equals XLA ``"SAME"``."""
    top, bottom = same_padding(x.shape[-2], kernel, stride)
    left, right = same_padding(x.shape[-1], kernel, stride)
    if top == bottom == left == right == 0:
        return x
    return F.pad(x, (left, right, top, bottom))


class SpatialConv(nn.Conv2d):
    """kxk conv with XLA ``"SAME"`` padding worked out from the input extent.

    At a 1x1 extent the padded window holds only zeros besides the center
    pixel, so the result equals the JAX center-tap collapse exactly.
    """

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int = 3,
                 stride: int = 1, bias: bool = False):
        super().__init__(in_ch, out_ch, kernel_size, stride=stride, padding=0,
                         bias=bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = pad_same(x, self.kernel_size[0], self.stride[0])
        return F.conv2d(x, self.weight, self.bias, self.stride)


class SEBlock(nn.Module):
    """Squeeze-and-excitation: spatial mean -> Linear -> relu -> Linear ->
    sigmoid -> channel scale (no biases)."""

    def __init__(self, channels: int, reduction: int = 16):
        super().__init__()
        self.excitation = nn.Sequential(
            nn.Linear(channels, channels // reduction, bias=False),
            nn.ReLU(),
            nn.Linear(channels // reduction, channels, bias=False),
            nn.Sigmoid(),
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.excitation(x.mean(dim=(2, 3)))[:, :, None, None]


class SpatialAttention(nn.Module):
    """CBAM spatial gate: 7x7 conv over the channel mean and max maps."""

    def __init__(self, kernel_size: int = 7):
        super().__init__()
        self.conv = SpatialConv(2, 1, kernel_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        maps = torch.cat(
            [x.mean(dim=1, keepdim=True), x.amax(dim=1, keepdim=True)], dim=1
        )
        return x * torch.sigmoid(self.conv(maps))


class BasicBlock(nn.Module):
    """ResNet basic block; a 1x1 projection shortcut on stride or width
    change."""

    def __init__(self, in_ch: int, out_ch: int, stride: int = 1):
        super().__init__()
        self.conv1 = SpatialConv(in_ch, out_ch, 3, stride)
        self.bn1 = nn.BatchNorm2d(out_ch, eps=BN_EPS)
        self.conv2 = SpatialConv(out_ch, out_ch, 3)
        self.bn2 = nn.BatchNorm2d(out_ch, eps=BN_EPS)
        self.downsample = None
        if in_ch != out_ch or stride != 1:
            # a 1x1 window needs no padding at any extent under "SAME"
            self.downsample = nn.Sequential(
                nn.Conv2d(in_ch, out_ch, 1, stride=stride, bias=False),
                nn.BatchNorm2d(out_ch, eps=BN_EPS),
            )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        res = x if self.downsample is None else self.downsample(x)
        return F.relu(y + res)


class MLPHead(nn.Module):
    """Linear -> relu -> dropout per hidden width, then a logits Linear.

    The layers sit in ``self.head`` so that a stage model's keys read
    ``head.head.<i>``, as in the reference checkpoints."""

    def __init__(self, in_dim: int, hidden: Sequence[int], num_outputs: int,
                 dropout: Sequence[float]):
        super().__init__()
        if len(hidden) != len(dropout):
            raise ValueError("one dropout rate per hidden layer")
        layers = []
        for width, rate in zip(hidden, dropout):
            layers += [nn.Linear(in_dim, width), nn.ReLU(), nn.Dropout(rate)]
            in_dim = width
        layers.append(nn.Linear(in_dim, num_outputs))
        self.head = nn.Sequential(*layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.head(x)


__all__ = [
    "BN_EPS",
    "BasicBlock",
    "MLPHead",
    "SEBlock",
    "SpatialAttention",
    "SpatialConv",
    "pad_same",
    "same_padding",
]
