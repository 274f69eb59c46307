"""Seeded weights for every model a cell serves, made on the device.

The recipe (``recipe`` in the configuration file; the system's trained
checkpoints are not public, and random weights serve speed and agreement
alike):

1. every conv and Linear weight from one normal draw for all models, scaled by
   1/sqrt(fan-in); Linear biases 0, BatchNorm scale 1 and shift 0;
2. each model's BatchNorm running statistics set to a calibration batch's own
   (a forward that normalises each layer by its batch statistics), then
   perturbed: the mean by ``bn_mean_shift`` standard deviations of a normal
   draw, the variance by a uniform factor in ``bn_var_scale``;
3. each decision's first logit shifted (the family's ``first_class_shift``:
   for an MLP head its last bias) so that, on probe blocks, the stage-1 gate
   opens on ``gate_share`` of them and class 0 (SPLIT for stage 2, HORZ,
   HORZ_A) wins on the configured shares. Random heads otherwise take one
   decision on every block, and the cascade's trees would not vary.

The models, their tensors and their forward are the model family's
(``spec.Family``: ``kinds``, ``shapes``, ``level_logits``); a BatchNorm is a
tensor group with a ``running_var``. Everything runs in fp32 with TF32 off,
through the reference forward.
"""
from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from portbench.reference.cascade import DECISIONS, exact_fp32
from portbench.reference.v6 import threshold_logit

Models = Dict[str, Dict[str, torch.Tensor]]


def _bn_prefixes(sd: Dict[str, torch.Tensor]) -> List[str]:
    return [k[: -len(".running_var")] for k in sd if k.endswith(".running_var")]


def _drawn(shapes: List[Tuple[str, tuple]]) -> List[bool]:
    """Which tensors the normal draw fills: the weights of all but the
    BatchNorms."""
    stats = {n[: -len(".running_var")] for n, _ in shapes if n.endswith(".running_var")}
    return [n.endswith(".weight") and n[: -len(".weight")] not in stats for n, _ in shapes]


def _draw(family, config: dict, levels: Sequence[int], gen: torch.Generator,
          device) -> Dict[int, Models]:
    """Step 1: every model's tensors, the weights from one normal draw."""
    arch = config["arch"]
    layout = [(size, kind, family.reference.shapes(arch, kind)) for size in levels
              for kind in family.reference.kinds(config)]
    weights = [s for _, _, shapes in layout for (_, s), w in zip(shapes, _drawn(shapes)) if w]
    total = sum(math.prod(s) for s in weights)
    noise = torch.randn(total, generator=gen, device=device, dtype=torch.float32)
    out: Dict[int, Models] = {size: {} for size in levels}
    offset = 0
    for size, kind, shapes in layout:
        sd = {}
        for (name, shape), drawn in zip(shapes, _drawn(shapes)):
            count = math.prod(shape)
            if drawn:
                fan_in = count // shape[0]
                sd[name] = noise[offset:offset + count].view(shape) / math.sqrt(fan_in)
                offset += count
            elif name.endswith("temperature"):
                sd[name] = torch.full(shape, 1.5, device=device)
            elif name.endswith((".weight", ".running_var")):
                sd[name] = torch.ones(shape, device=device)
            else:
                sd[name] = torch.zeros(shape, device=device)
        out[size][kind] = sd
    return out


def _share_shift(logits: np.ndarray, share: float, threshold: float) -> float:
    """The shift of a head's first logit that gives ``share`` of the probe
    rows the first decision."""
    logits = np.asarray(logits, np.float64)
    if logits.ndim == 1:
        return threshold_logit(threshold) - float(np.quantile(logits, 1 - share))
    return float(np.quantile(logits[:, 1:].max(axis=1) - logits[:, 0], share))


@torch.no_grad()
def make_level_models(family, config: dict, calib: Dict[int, np.ndarray],
                      gen: torch.Generator, device) -> Dict[int, Models]:
    """``{block px: {kind: state dict}}`` of ``family`` (a ``spec.Family``)
    for the levels in ``calib``, whose uint16 blocks ``(2 * n, px, px)`` give
    the calibration batch (first half) and the probe batch (second half)."""
    recipe, arch = config["recipe"], config["arch"]
    levels = sorted(calib, reverse=True)
    models = _draw(family, config, levels, gen, device)
    threshold = config["stage1_threshold"]
    with exact_fp32():
        for size in levels:
            blocks = torch.from_numpy(np.asarray(calib[size], np.float32)).to(device)
            x = (blocks / config["norm_scale"])[..., None]
            half = x.shape[0] // 2
            family.reference.level_logits(arch, models[size], x[:half], calibrate=True)
            for sd in models[size].values():
                prefixes = _bn_prefixes(sd)
                widths = [sd[f"{p}.running_var"].numel() for p in prefixes]
                shift = torch.randn(sum(widths), generator=gen, device=device).split(widths)
                scale = torch.rand(sum(widths), generator=gen, device=device).split(widths)
                lo, hi = recipe["bn_var_scale"]
                for p, n01, u01 in zip(prefixes, shift, scale):
                    std = sd[f"{p}.running_var"].sqrt()
                    sd[f"{p}.running_mean"] += recipe["bn_mean_shift"] * std * n01
                    sd[f"{p}.running_var"] *= lo + (hi - lo) * u01
            probe = family.reference.level_logits(arch, models[size], x[half:])
            shares = dict(zip(DECISIONS, (recipe["gate_share"], recipe["split_share"][str(size)],
                                          recipe["rect_share"], recipe["ab_share"])))
            for d in DECISIONS:
                family.reference.first_class_shift(
                    models[size], d, _share_shift(probe[d].cpu().numpy(), shares[d], threshold))
    return models


__all__ = ["Models", "make_level_models"]
