"""FGVC stage-3 AB model: backbone -> BN-MLP projection -> L2 normalize ->
scaled cosine classifier; and the center loss it trains with.

Counterpart of ``av1tpu.models.fgvc``. The projection is one
``nn.Sequential`` named ``feat_proj`` (Linear at 0 and 4, BatchNorm1d at 1
and 5), as the reference checkpoints name it. Its BatchNorms are
``layers.BatchNorm1d``: flax's train mode (the running variance moves by the
biased batch variance), torch's eval mode.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
from torch import nn

from av1tpu_torch.models.layers import BN_EPS, BatchNorm1d, Dropout
from av1tpu_torch.models.v6 import FEATURE_DIM, ImprovedBackbone
from av1tpu_torch.parallel.mesh import current_data_group, global_sum


def l2_normalize(x: torch.Tensor, dim: int = -1, eps: float = 1e-12):
    """``x / sqrt(sum(x*x) + eps)``, the JAX formula (not F.normalize)."""
    return x / torch.sqrt(torch.sum(x * x, dim=dim, keepdim=True) + eps)


class CosineClassifier(nn.Module):
    """``scale * features @ l2_normalize(weight).T``."""

    def __init__(self, num_classes: int, feat_dim: int, scale: float = 20.0):
        super().__init__()
        self.weight = nn.Parameter(torch.randn(num_classes, feat_dim))
        self.scale = scale

    def reset_like_flax(self, gen: torch.Generator) -> None:
        """flax's ``normal(stddev=1.0)`` initializer, drawn from ``gen``."""
        nn.init.normal_(self.weight, 0.0, 1.0, generator=gen)

    def forward(self, features: torch.Tensor) -> torch.Tensor:
        weight = l2_normalize(self.weight.to(features.dtype), dim=-1)
        return self.scale * features @ weight.T


class FGVCModel(nn.Module):
    """Backbone -> 2x (Linear, BatchNorm1d, relu, dropout) -> L2 normalize
    -> cosine logits."""

    def __init__(self, num_classes: int = 4, feat_dim: int = 512):
        super().__init__()
        self.backbone = ImprovedBackbone()
        self.feat_proj = nn.Sequential(
            nn.Linear(FEATURE_DIM, feat_dim),
            BatchNorm1d(feat_dim, eps=BN_EPS), nn.ReLU(), Dropout(0.3),
            nn.Linear(feat_dim, feat_dim),
            BatchNorm1d(feat_dim, eps=BN_EPS), nn.ReLU(), Dropout(0.3),
        )
        self.classifier = CosineClassifier(num_classes, feat_dim)

    def forward(self, x: torch.Tensor, return_features: bool = False,
                from_features: bool = False):
        feats = x if from_features else self.backbone(x)
        feats = l2_normalize(self.feat_proj(feats), dim=-1)
        logits = self.classifier(feats)
        return (logits, feats) if return_features else logits


def init_centers(gen: torch.Generator, num_classes: int = 4, feat_dim: int = 512,
                 device=None) -> torch.Tensor:
    """The center loss's learnable class centers, ``N(0, 1)`` of shape
    ``(num_classes, feat_dim)`` drawn from ``gen`` (``006:185-214``); the
    trainer holds them beside the model and optimizes them jointly."""
    return torch.randn((num_classes, feat_dim), generator=gen,
                       device=gen.device if device is None else device)


def center_loss(features: torch.Tensor, labels: torch.Tensor,
                centers: torch.Tensor) -> torch.Tensor:
    """Summed squared distance of each sample to its class center over the
    batch size (Wen et al., 2016; ``006:199-214``); over the global batch
    inside ``parallel.mesh.data_parallel``."""
    group = current_data_group()
    rows = features.shape[0] * (1 if group is None else dist.get_world_size(group))
    return global_sum((features - centers[labels.long()]) ** 2) / rows


__all__ = ["CosineClassifier", "FGVCModel", "center_loss", "init_centers", "l2_normalize"]
