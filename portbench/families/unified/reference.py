"""The unified v6 family in plain PyTorch: per block size one model, a
shared ResNet-18 trunk (``reference/v6.backbone``) and one MLP head a
decision under ``head_<decision>``. Nothing here imports the program.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from portbench.counts import v6 as counts
from portbench.reference.v6 import backbone, backbone_shapes, head, head_shapes, last_bias

DECISIONS = ("stage1", "stage2", "rect", "ab")
HEAD = {"stage1": "head_stage1", "stage2": "head_stage2", "rect": "head_rect",
        "ab": "head_ab"}

Models = Dict[str, Dict[str, torch.Tensor]]


def kinds(config: dict) -> List[str]:
    """The models held at one level: the one unified model."""
    return ["unified"]


def shapes(arch: dict, kind: str) -> List[Tuple[str, tuple]]:
    """Every float tensor of the unified model, in draw order."""
    out = backbone_shapes(arch)
    for d in DECISIONS:
        out += head_shapes(arch["heads"][d], arch["widths"][-1], HEAD[d])
    out.append(("temperature", (1,)))
    return out


def level_logits(arch: dict, models: Models, x: torch.Tensor,
                 calibrate: bool = False) -> Dict[str, torch.Tensor]:
    """The four decisions' logits on NHWC blocks in [0, 1] (shapes as the
    per-stage family's). With ``calibrate`` the trunk's BatchNorm statistics
    are first set to ``x``'s."""
    sd = models["unified"]
    feats = backbone(sd, arch, x, calibrate)
    out = {d: head(sd, HEAD[d], feats) for d in DECISIONS}
    out["stage1"] = out["stage1"][:, 0]
    return out


def first_class_shift(models: Models, decision: str, amount: float) -> None:
    """Add ``amount`` to the decision's first logit: its head's last bias."""
    last_bias(models["unified"], HEAD[decision])[0] += amount


def trunks(config: dict) -> int:
    """Trunks a row runs through the port's fused kernels: the shared one."""
    return 1


def per_block(config: dict, px: int) -> int:
    """Operations of one ``px`` block through one level: one trunk and four
    heads."""
    arch = config["arch"]
    trunk = sum(counts.backbone(arch, px).values())
    return trunk + sum(counts.head(arch["heads"][d], arch["widths"][-1]) for d in DECISIONS)
