"""The per-stage v6 family in plain PyTorch: per block size four models, one
for each decision, each a ResNet-18 trunk (``reference/v6.backbone``) and an
MLP head under ``head``. Nothing here imports the program.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from portbench.counts import v6 as counts
from portbench.reference.v6 import backbone, backbone_shapes, head, head_shapes, last_bias

DECISIONS = ("stage1", "stage2", "rect", "ab")

Models = Dict[str, Dict[str, torch.Tensor]]


def kinds(config: dict) -> List[str]:
    """The models held at one level: one a decision."""
    return list(DECISIONS)


def shapes(arch: dict, kind: str) -> List[Tuple[str, tuple]]:
    """Every float tensor of one stage model, in draw order."""
    out = backbone_shapes(arch) + head_shapes(arch["heads"][kind], arch["widths"][-1], "head")
    if kind == "stage1":
        out.append(("head.temperature", (1,)))
    return out


def level_logits(arch: dict, models: Models, x: torch.Tensor,
                 calibrate: bool = False) -> Dict[str, torch.Tensor]:
    """The four decisions' logits on NHWC blocks in [0, 1]: ``stage1`` ``(N,)``,
    ``stage2`` ``(N, 3)``, ``rect`` ``(N, 2)``, ``ab`` ``(N, 4)``. With
    ``calibrate`` each trunk's BatchNorm statistics are first set to ``x``'s."""
    out = {d: head(models[d], "head", backbone(models[d], arch, x, calibrate))
           for d in DECISIONS}
    out["stage1"] = out["stage1"][:, 0]
    return out


def first_class_shift(models: Models, decision: str, amount: float) -> None:
    """Add ``amount`` to the decision's first logit: its head's last bias."""
    last_bias(models[decision], "head")[0] += amount


def trunks(config: dict) -> int:
    """Trunks a row runs through the port's fused kernels: all four."""
    return len(DECISIONS)


def per_block(config: dict, px: int) -> int:
    """Operations of one ``px`` block through one level: four trunks and
    four heads."""
    arch = config["arch"]
    trunk = sum(counts.backbone(arch, px).values())
    heads = sum(counts.head(arch["heads"][d], arch["widths"][-1]) for d in DECISIONS)
    return len(DECISIONS) * trunk + heads
