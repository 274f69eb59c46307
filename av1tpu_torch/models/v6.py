"""v6 stage models: ResNet-18 + SE + spatial attention, then an MLP head.

Counterpart of ``av1tpu.models.v6`` (ImprovedBackbone, the four stage
models, the 7-way flatten model, the adapter model and the single-trunk
UnifiedV6Model). Inputs are NHWC ``(B, H, W, 1)`` like the JAX models; the
backbone works in NCHW inside and returns the ``(B, 512)`` embedding.
"""
from __future__ import annotations

import torch
from torch import nn

from av1tpu_torch.models.layers import (
    BN_EPS,
    AdapterModule,
    BatchNorm2d,
    BasicBlock,
    MLPHead,
    SEBlock,
    SpatialAttention,
    global_avg_pool,
)

FEATURE_DIM = 512
WIDTHS = (64, 128, 256, 512)


def _resnet_modules(module: nn.Module, prefix: str = "") -> None:
    """Add the ResNet-18 + SE + spatial-attention trunk's submodules to
    ``module``, each name prefixed with ``prefix``: ``conv1``, ``bn1``,
    ``layer<g>`` (two BasicBlocks), ``se<g>``, ``spatial_attn``."""
    module.add_module(f"{prefix}conv1", nn.Conv2d(1, 64, 7, stride=2, padding=3,
                                                  bias=False))
    module.add_module(f"{prefix}bn1", BatchNorm2d(64, eps=BN_EPS))
    in_ch = 64
    for gi, width in enumerate(WIDTHS, start=1):
        stride = 1 if gi == 1 else 2
        module.add_module(f"{prefix}layer{gi}", nn.Sequential(
            BasicBlock(in_ch, width, stride), BasicBlock(width, width)
        ))
        module.add_module(f"{prefix}se{gi}", SEBlock(width))
        in_ch = width
    module.add_module(f"{prefix}spatial_attn", SpatialAttention())


class ImprovedBackbone(nn.Module):
    """7x7/2 stem + maxpool, layer groups [2,2,2,2] with SE after each
    group, spatial attention after layer4, global average pool."""

    def __init__(self):
        super().__init__()
        _resnet_modules(self)
        self.maxpool = nn.MaxPool2d(3, stride=2, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2)  # NHWC -> NCHW
        x = self.maxpool(torch.relu(self.bn1(self.conv1(x))))
        for gi in range(1, 5):
            x = getattr(self, f"se{gi}")(getattr(self, f"layer{gi}")(x))
        return self.spatial_attn(x).mean(dim=(2, 3))


class _StageModel(nn.Module):
    hidden: tuple = ()
    dropout: tuple = ()
    num_outputs: int = 0

    def __init__(self):
        super().__init__()
        self.backbone = ImprovedBackbone()
        self.head = MLPHead(FEATURE_DIM, self.hidden, self.num_outputs,
                            self.dropout)

    def forward(self, x: torch.Tensor, from_features: bool = False):
        feats = x if from_features else self.backbone(x)
        return self.head(feats)


class Stage1Model(_StageModel):
    """Binary NONE-vs-PARTITION gate with a temperature parameter. Returns
    ``(B,)`` logits, divided by the temperature when ``apply_temp``."""

    hidden, dropout, num_outputs = (256,), (0.3,), 1

    def __init__(self):
        super().__init__()
        # stored under the head, as the reference's Stage1BinaryHead does
        self.head.temperature = nn.Parameter(torch.full((1,), 1.5))

    def forward(self, x, apply_temp: bool = False, from_features: bool = False):
        logits = super().forward(x, from_features).squeeze(-1)
        return logits / self.head.temperature if apply_temp else logits


class Stage2Model(_StageModel):
    """3-way SPLIT / RECT / AB classifier."""

    hidden, dropout, num_outputs = (256, 128), (0.4, 0.4), 3


class Stage3RectModel(_StageModel):
    """Binary HORZ-vs-VERT specialist."""

    hidden, dropout, num_outputs = (128, 64), (0.2, 0.2), 2


class Stage3ABModel(_StageModel):
    """4-way AB specialist."""

    hidden, dropout, num_outputs = (256, 128), (0.5, 0.5), 4


class UnifiedV6Model(nn.Module):
    """One shared ``ImprovedBackbone`` and all four v6 stage heads.

    The head shapes are the per-stage models' (stage1 256->1 with the
    temperature parameter, stage2 256/128->3, rect 128/64->2, AB
    256/128->4). Returns one ``(N, 10)`` tensor of concatenated logits
    ``[s1(1) | s2(3) | rect(2) | ab(4)]``; slice it with
    :func:`split_unified_logits`."""

    def __init__(self):
        super().__init__()
        self.backbone = ImprovedBackbone()
        self.head_stage1 = MLPHead(FEATURE_DIM, (256,), 1, (0.3,))
        self.head_stage2 = MLPHead(FEATURE_DIM, (256, 128), 3, (0.4, 0.4))
        self.head_rect = MLPHead(FEATURE_DIM, (128, 64), 2, (0.2, 0.2))
        self.head_ab = MLPHead(FEATURE_DIM, (256, 128), 4, (0.5, 0.5))
        self.temperature = nn.Parameter(torch.full((1,), 1.5))

    def forward(self, x, apply_temp: bool = False, from_features: bool = False):
        feats = x if from_features else self.backbone(x)
        s1 = self.head_stage1(feats)
        if apply_temp:
            s1 = s1 / self.temperature.to(s1.dtype)
        return torch.cat([s1, self.head_stage2(feats), self.head_rect(feats),
                          self.head_ab(feats)], dim=-1)


class Stage2FlatModel(_StageModel):
    """The flatten architecture: one 7-way classifier in place of the
    stage-2/3 cascade."""

    hidden, dropout, num_outputs = (256, 128), (0.4, 0.4), 7


class Stage2ModelWithAdapters(nn.Module):
    """Stage 2 with a residual adapter after each layer group (after the
    spatial attention in group 4). Names are flat, as in the JAX model:
    ``backbone_conv1``, ``backbone_layer<g>``, ``backbone_se<g>``,
    ``backbone_spatial_attn``, ``adapter_layer<g>``, ``head``. Trained with
    every ``backbone_*`` partition frozen (``stage2_recipe(use_adapters=True)``)."""

    def __init__(self, bottleneck_dim: int = 64, adapter_dropout: float = 0.1):
        super().__init__()
        _resnet_modules(self, "backbone_")
        self.maxpool = nn.MaxPool2d(3, stride=2, padding=1)
        for gi, width in enumerate(WIDTHS, start=1):
            self.add_module(f"adapter_layer{gi}",
                            AdapterModule(width, bottleneck_dim, adapter_dropout))
        self.head = MLPHead(FEATURE_DIM, (256, 128), 3, (0.4, 0.4))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2)  # NHWC -> NCHW
        x = self.maxpool(torch.relu(self.backbone_bn1(self.backbone_conv1(x))))
        for gi in range(1, 5):
            x = getattr(self, f"backbone_se{gi}")(getattr(self, f"backbone_layer{gi}")(x))
            if gi == 4:
                x = self.backbone_spatial_attn(x)
            x = getattr(self, f"adapter_layer{gi}")(x)
        return self.head(global_avg_pool(x))


# Column layout of the UnifiedV6Model output:
# [s1 | s2 s2 s2 | rect rect | ab ab ab ab].
UNIFIED_LOGIT_SLICES = {
    "stage1": (0, 1),
    "stage2": (1, 4),
    "rect": (4, 6),
    "ab": (6, 10),
}
UNIFIED_LOGIT_DIM = 10


def split_unified_logits(logits):
    """(..., 10) unified logits -> (s1(...,), s2(...,3), rect(...,2),
    ab(...,4))."""
    return (
        logits[..., 0],
        logits[..., 1:4],
        logits[..., 4:6],
        logits[..., 6:10],
    )


__all__ = [
    "FEATURE_DIM",
    "ImprovedBackbone",
    "Stage1Model",
    "Stage2FlatModel",
    "Stage2Model",
    "Stage2ModelWithAdapters",
    "Stage3ABModel",
    "Stage3RectModel",
    "UNIFIED_LOGIT_DIM",
    "UNIFIED_LOGIT_SLICES",
    "UnifiedV6Model",
    "split_unified_logits",
]
