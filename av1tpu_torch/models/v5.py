"""v5 model family: a depthwise-separable backbone shared by every head.

Counterpart of ``av1tpu.models.v5``: one forward gives the stage-1 binary
logit, the 5-way stage-2 logits and the three specialists' logits. Inputs
are NHWC ``(N, H, W, 1)`` as in the JAX model; the backbone works in NCHW
inside. Submodules carry the reference's v5 state-dict names
(``backbone.stem.conv|bn``, ``backbone.blocks.<i>.depthwise|bn1|pointwise|bn2``,
``stage1_head.fc.<i>``, ``specialist_heads.<H>.fc.<i>``, ``qp_embed.proj.0``),
so a model's ``state_dict()`` is a reference-shaped checkpoint.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Mapping, Optional

import torch
from torch import nn

from av1tpu_torch.models.layers import (
    ConvBNAct,
    DepthwiseSeparableConv,
    MLPHead,
    global_avg_pool,
)

# Specialist head name -> class count (reference STAGE3_GROUPS sizes).
DEFAULT_SPECIALISTS: Dict[str, int] = {"RECT": 2, "AB": 4, "1TO4": 2}
STAGE2_CLASSES_V5 = 5
QP_EMBED_DIM = 16


@dataclass
class HierarchicalOutputs:
    """Every head's logits from one backbone forward."""

    stage1: torch.Tensor                  # (N,)
    stage2: torch.Tensor                  # (N, 5)
    specialists: Dict[str, torch.Tensor]  # head -> (N, classes)


class HierarchicalBackbone(nn.Module):
    """3x3 stem + three depthwise-separable blocks, widths
    ``base * (1, 2, 4, 4)``, stem stride 1, block strides 2/2/1, then the
    spatial mean."""

    def __init__(self, base_channels: int = 32):
        super().__init__()
        widths = (base_channels, base_channels * 2, base_channels * 4,
                  base_channels * 4)
        self.stem = ConvBNAct(1, widths[0])
        self.blocks = nn.ModuleList(
            DepthwiseSeparableConv(widths[i - 1], widths[i],
                                   stride=2 if i < len(widths) - 1 else 1)
            for i in range(1, len(widths))
        )
        self.feature_dim = widths[-1]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.stem(x.permute(0, 3, 1, 2))  # NHWC -> NCHW
        for block in self.blocks:
            x = block(x)
        return global_avg_pool(x)


class QPEmbedding(nn.Module):
    """Linear(1 -> 16) + SiLU of a scalar QP; a 1-D ``qp`` gets a trailing
    axis."""

    def __init__(self, embed_dim: int = QP_EMBED_DIM):
        super().__init__()
        self.proj = nn.Sequential(nn.Linear(1, embed_dim), nn.SiLU())

    def forward(self, qp: torch.Tensor) -> torch.Tensor:
        if qp.dim() == 1:
            qp = qp[:, None]
        return self.proj(qp)


class _Head(nn.Module):
    """One SiLU hidden layer and the logits, in ``fc`` as the reference names
    them (``fc.0`` and ``fc.3``)."""

    def __init__(self, in_dim: int, hidden: int, num_outputs: int, dropout: float):
        super().__init__()
        self.fc = MLPHead(in_dim, (hidden,), num_outputs, (dropout,), act=nn.SiLU).head

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc(x)


class HierarchicalModel(nn.Module):
    """The shared backbone and all heads. The hidden width of every head is
    ``feature_dim // 2``, taken before the QP embedding is concatenated (64
    wide for a 144-wide input with ``use_qp``); dropout 0.2 / 0.3 / 0.3.
    With ``use_qp`` and no ``qp``, zeros stand in for the embedding."""

    def __init__(self, stage2_classes: int = STAGE2_CLASSES_V5,
                 specialist_classes: Optional[Mapping[str, int]] = None,
                 use_qp: bool = False, base_channels: int = 32):
        super().__init__()
        self.backbone = HierarchicalBackbone(base_channels)
        self.use_qp = use_qp
        feature_dim = self.backbone.feature_dim
        in_dim = feature_dim + (QP_EMBED_DIM if use_qp else 0)
        hidden = feature_dim // 2
        if use_qp:
            self.qp_embed = QPEmbedding()
        self.stage1_head = _Head(in_dim, hidden, 1, 0.2)
        self.stage2_head = _Head(in_dim, hidden, stage2_classes, 0.3)
        self.specialist_heads = nn.ModuleDict({
            head: _Head(in_dim, hidden, classes, 0.3)
            for head, classes in dict(specialist_classes or DEFAULT_SPECIALISTS).items()
        })

    def forward(self, image: torch.Tensor,
                qp: Optional[torch.Tensor] = None) -> HierarchicalOutputs:
        features = self.backbone(image)
        if self.use_qp:
            embed = (features.new_zeros(features.shape[0], QP_EMBED_DIM) if qp is None
                     else self.qp_embed(qp))
            features = torch.cat([features, embed], dim=-1)
        return HierarchicalOutputs(
            stage1=self.stage1_head(features).squeeze(-1),
            stage2=self.stage2_head(features),
            specialists={head: m(features) for head, m in self.specialist_heads.items()},
        )


__all__ = [
    "DEFAULT_SPECIALISTS",
    "STAGE2_CLASSES_V5",
    "HierarchicalBackbone",
    "HierarchicalModel",
    "HierarchicalOutputs",
    "QPEmbedding",
]
