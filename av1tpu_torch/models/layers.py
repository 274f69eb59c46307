"""v5 and v6 building blocks as ``nn.Module``s (NCHW inside, eval-mode
inference).

Counterpart of ``av1tpu.models.layers``. Submodule names follow the
reference's torchvision-style state-dict keys (``conv1``, ``bn1``,
``downsample.0``, ``excitation.0``, ``spatial_attn.conv``, ``head.head.0``;
the v5 ``conv``/``bn``, ``depthwise``/``pointwise``) so that
``models.jax_import`` maps the JAX tree onto them mechanically.

``BatchNorm2d`` and ``BatchNorm1d`` are torch's in eval mode (the serving
path and the bridge see no difference) and flax's in train mode: the running
variance moves by the **biased** batch variance, ``momentum=0.1`` being flax's 0.9.
``init_like_flax`` draws a model's parameters from flax's initializers.

Padding follows XLA ``"SAME"``, not PyTorch's symmetric ``padding=1``: a
stride-2 3x3 conv at an even extent pads (0, 1), at extent 1 it pads (1, 1)
(ROADMAP fault F1). ``same_padding`` is the one formula every conv of the
port uses.
"""
from __future__ import annotations

import math
from typing import Callable, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from av1tpu_torch.parallel.mesh import all_reduce_sum, current_data_group

BN_EPS = 1e-5  # flax BatchNorm's default epsilon
# flax's lecun_normal: a normal truncated at 2 std, rescaled to unit variance
_TRUNC_STD = 0.87962566103423978


def _flax_train_norm(bn: nn.modules.batchnorm._BatchNorm, x: torch.Tensor,
                     dims: Tuple[int, ...]) -> torch.Tensor:
    """flax ``nn.BatchNorm``'s train mode over ``dims`` (every axis but the
    channel axis 1): statistics in at least float32, the fast variance
    ``E[x^2] - E[x]^2`` clipped at 0, the running statistics moved by the
    batch mean and this biased variance, the result in ``x``'s dtype.

    Inside ``parallel.mesh.data_parallel`` the statistics are the global
    batch's, as under the JAX package's GSPMD: sum x, sum x^2 and the row
    count are all-reduced over the data group, differentiably, so that the
    running statistics move identically on every rank."""
    xf = x.to(torch.promote_types(x.dtype, torch.float32))
    group = current_data_group()
    if group is None:
        mean = xf.mean(dim=dims)
        mean_sq = (xf * xf).mean(dim=dims)
    else:
        c = xf.shape[1]
        count = torch.full((1,), xf.numel() // c, dtype=xf.dtype, device=xf.device)
        sums = all_reduce_sum(torch.cat([xf.sum(dim=dims), (xf * xf).sum(dim=dims), count]),
                              group)
        mean, mean_sq = sums[:c] / sums[-1], sums[c:2 * c] / sums[-1]
    var = torch.clamp(mean_sq - mean * mean, min=0.0)
    with torch.no_grad():
        m = bn.momentum
        bn.running_mean.mul_(1 - m).add_(mean * m)
        bn.running_var.mul_(1 - m).add_(var * m)
        bn.num_batches_tracked.add_(1)
    shape = (1, -1) + (1,) * (x.dim() - 2)
    mul = torch.rsqrt(var + bn.eps) * bn.weight
    y = (xf - mean.view(shape)) * mul.view(shape) + bn.bias.view(shape)
    return y.to(x.dtype)


class BatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` whose train mode is flax's ``nn.BatchNorm``.

    In train mode the batch is normalized as flax does it: statistics in
    at least float32 whatever the input dtype, the variance the fast ``E[x^2] -
    E[x]^2`` clipped at 0, ``(x - mean) * (rsqrt(var + eps) * scale) + bias``,
    the result in the input's dtype; and the running statistics move as
    ``r = (1 - momentum) * r + momentum * s`` by the batch mean and this
    **biased** variance (torch would move them by the unbiased one, n/(n-1)
    larger: at 16 px the layer-3/4 maps are 1x1 and n is the batch).
    ``momentum=None`` (a cumulative average) and eval mode are torch's,
    unchanged."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.momentum is None:
            return super().forward(x)
        return _flax_train_norm(self, x, (0, 2, 3))


class BatchNorm1d(nn.BatchNorm1d):
    """``nn.BatchNorm1d`` over ``(N, C)`` whose train mode is flax's
    ``nn.BatchNorm``, as :class:`BatchNorm2d` (the FGVC projection's
    ``proj_bn<l>``; flax ``momentum=0.9`` is torch ``momentum=0.1``). Eval mode
    is torch's."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.momentum is None:
            return super().forward(x)
        return _flax_train_norm(self, x, (0,))


class Dropout(nn.Dropout):
    """``nn.Dropout`` whose train-mode mask is drawn for the global batch.

    The mask is ``bernoulli(1 - p) / (1 - p)`` over the rows of every data
    rank (inside ``parallel.mesh.data_parallel``; this rank's rows alone
    outside it) from the default generator, and this rank keeps its own
    rows: ranks seeded alike draw the mask one process draws for the same
    global batch. On the CPU this is ``F.dropout``'s own draw."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.p == 0.0:
            return x
        group = current_data_group()
        ranks = 1 if group is None else torch.distributed.get_world_size(group)
        rank = 0 if group is None else torch.distributed.get_rank(group)
        rows = x.shape[0]
        noise = torch.empty((rows * ranks,) + x.shape[1:], dtype=x.dtype, device=x.device)
        noise.bernoulli_(1.0 - self.p).div_(1.0 - self.p)
        return x * noise[rank * rows:(rank + 1) * rows]


def init_like_flax(model: nn.Module, gen: torch.Generator) -> nn.Module:
    """Draw ``model``'s parameters in place as flax initializes the JAX
    package's modules, from ``gen`` (module order): conv and Linear weights
    ``lecun_normal`` (truncated normal over the fan-in), biases 0, BatchNorm
    scale 1, bias 0 and running stats 0 / 1, the adapters' Linear weights
    ``normal(1e-3)``, a module with ``reset_like_flax(gen)`` (the FGVC cosine
    classifier) by that method. A temperature keeps its 1.5."""
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, (nn.Conv2d, nn.Linear)):
                std = math.sqrt(1.0 / mod.weight[0].numel()) / _TRUNC_STD
                nn.init.trunc_normal_(mod.weight, 0.0, std, -2 * std, 2 * std,
                                      generator=gen)
                if mod.bias is not None:
                    mod.bias.zero_()
            elif isinstance(mod, nn.modules.batchnorm._BatchNorm):
                mod.reset_parameters()
        for mod in model.modules():
            if isinstance(mod, AdapterModule):
                for lin in (mod.down, mod.up):
                    nn.init.normal_(lin.weight, 0.0, 1e-3, generator=gen)
            elif hasattr(mod, "reset_like_flax"):  # the FGVC cosine classifier
                mod.reset_like_flax(gen)
    return model


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
    ``groups=in_ch`` is the depthwise conv: a torch ``(C, 1, k, k)`` weight,
    flax's ``(k, k, 1, C)`` kernel.
    """

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int = 3,
                 stride: int = 1, bias: bool = False, groups: int = 1):
        super().__init__(in_ch, out_ch, kernel_size, stride=stride, padding=0,
                         bias=bias, groups=groups)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = pad_same(x, self.kernel_size[0], self.stride[0])
        return F.conv2d(x, self.weight, self.bias, self.stride, groups=self.groups)


class ConvBNAct(nn.Module):
    """kxk SAME conv -> BatchNorm -> activation (the v5 ``ConvStem``)."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int = 3,
                 stride: int = 1, act: Callable = F.silu, bias: bool = False):
        super().__init__()
        self.conv = SpatialConv(in_ch, out_ch, kernel_size, stride, bias)
        self.bn = BatchNorm2d(out_ch, eps=BN_EPS)
        self.act = act

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.act(self.bn(self.conv(x)))


class DepthwiseSeparableConv(nn.Module):
    """Depthwise 3x3 SAME conv + BN + SiLU, then pointwise 1x1 + BN + SiLU.

    The depthwise conv pads as XLA ``"SAME"`` does: (0, 1) at stride 2 and an
    even extent, where ``padding=1`` would pad (1, 1) (ROADMAP F1)."""

    def __init__(self, in_ch: int, out_ch: int, stride: int = 1):
        super().__init__()
        self.depthwise = SpatialConv(in_ch, in_ch, 3, stride, groups=in_ch)
        self.bn1 = BatchNorm2d(in_ch, eps=BN_EPS)
        self.pointwise = nn.Conv2d(in_ch, out_ch, 1, bias=False)
        self.bn2 = BatchNorm2d(out_ch, eps=BN_EPS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.silu(self.bn1(self.depthwise(x)))
        return F.silu(self.bn2(self.pointwise(x)))


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


class DualAttention(nn.Module):
    """Full CBAM: channel attention (the mean and the max squeeze through one
    shared ``mlp``, no biases) then a 7x7 spatial gate, as the FGVC
    ``DualAttentionModule``."""

    def __init__(self, channels: int, reduction: int = 16):
        super().__init__()
        self.mlp = nn.Sequential(
            nn.Linear(channels, channels // reduction, bias=False),
            nn.ReLU(),
            nn.Linear(channels // reduction, channels, bias=False),
        )
        self.conv = SpatialConv(2, 1, 7)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        gate = torch.sigmoid(self.mlp(x.mean(dim=(2, 3))) + self.mlp(x.amax(dim=(2, 3))))
        x = x * gate[:, :, None, None]
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
        self.bn1 = BatchNorm2d(out_ch, eps=BN_EPS)
        self.conv2 = SpatialConv(out_ch, out_ch, 3)
        self.bn2 = BatchNorm2d(out_ch, eps=BN_EPS)
        self.downsample = None
        if in_ch != out_ch or stride != 1:
            # a 1x1 window needs no padding at any extent under "SAME"
            self.downsample = nn.Sequential(
                nn.Conv2d(in_ch, out_ch, 1, stride=stride, bias=False),
                BatchNorm2d(out_ch, eps=BN_EPS),
            )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        res = x if self.downsample is None else self.downsample(x)
        return F.relu(y + res)


class MLPHead(nn.Module):
    """Linear -> ``act`` -> dropout per hidden width, then a logits Linear
    (``act`` is an ``nn.Module`` class: ReLU for v6, SiLU for the v5 heads).

    The layers sit in ``self.head`` so that a stage model's keys read
    ``head.head.<i>``, as in the reference checkpoints."""

    def __init__(self, in_dim: int, hidden: Sequence[int], num_outputs: int,
                 dropout: Sequence[float], act: type = nn.ReLU):
        super().__init__()
        if len(hidden) != len(dropout):
            raise ValueError("one dropout rate per hidden layer")
        layers = []
        for width, rate in zip(hidden, dropout):
            layers += [nn.Linear(in_dim, width), act(), Dropout(rate)]
            in_dim = width
        layers.append(nn.Linear(in_dim, num_outputs))
        self.head = nn.Sequential(*layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.head(x)


class AdapterModule(nn.Module):
    """Residual bottleneck adapter over channel statistics: spatial mean ->
    ``down`` -> relu -> dropout -> ``up``, broadcast-added to the map."""

    def __init__(self, channels: int, bottleneck_dim: int = 64, dropout: float = 0.1):
        super().__init__()
        self.down = nn.Linear(channels, bottleneck_dim)
        self.drop = Dropout(dropout)
        self.up = nn.Linear(bottleneck_dim, channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.up(self.drop(F.relu(self.down(global_avg_pool(x)))))
        return x + y[:, :, None, None]


def global_avg_pool(x: torch.Tensor) -> torch.Tensor:
    """NCHW -> NC spatial mean."""
    return x.mean(dim=(2, 3))


__all__ = [
    "AdapterModule",
    "BN_EPS",
    "BasicBlock",
    "BatchNorm1d",
    "BatchNorm2d",
    "ConvBNAct",
    "DepthwiseSeparableConv",
    "Dropout",
    "DualAttention",
    "MLPHead",
    "SEBlock",
    "SpatialAttention",
    "SpatialConv",
    "global_avg_pool",
    "init_like_flax",
    "pad_same",
    "same_padding",
]
