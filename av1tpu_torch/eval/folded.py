"""BN-folded v6 serving pipeline, with the fused kernels as options.

Counterpart of ``av1tpu.eval.folded``. Each plain stage model's conv+BN
pairs fold into conv+bias (``quant.ptq.fold_backbone``) in fp32, then cast
to the serving dtype. ``use_fused_front=True`` runs the stem + maxpool as
kernel K1, ``"g1"`` runs stem + maxpool + layer group 1 + SE1 as kernel K2;
both are built lazily per input extent and extents above 16 px use the
plain front, as the JAX pipeline does. ``use_pallas_groups=True`` runs layer
groups 1 and 2 with SE1 and SE2 as kernel K5 at every block size (its
weights packed, and its conv stream built, once per stage); with ``"g1"`` at 8 and 16 px, K2 has done
group 1 and K5 does not run, as in the JAX package. An FGVC AB stage runs
unfolded through its own forward.
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch
from torch import nn

from av1tpu_torch.data.records import NORM_10BIT
from av1tpu_torch.eval.hierarchy import PipelineModels, assemble_v6_predict, on_device
from av1tpu_torch.kernels.fused_front import (
    make_fused_front,
    make_fused_front_g1,
    supports_extent,
)
from av1tpu_torch.kernels.resnet_group import (
    fused_group12,
    group12_conv_stream,
    pack_group12_weights,
)
from av1tpu_torch.quant.ptq import (
    _backbone_apply,
    _head_apply,
    cast_tree,
    fold_backbone,
    fold_head,
    is_plain_stage,
)


def check_fused_front_option(use_fused_front) -> None:
    if use_fused_front not in (False, True, "g1"):
        raise ValueError(f"use_fused_front must be False, True or 'g1', "
                         f"got {use_fused_front!r}")


def front_selector(folded32, use_fused_front, float_dtype) -> Callable:
    """``fronts_for(hw) -> (front_fn, front_g1_fn)`` for ``_backbone_apply``:
    K1 (``True``) or K2 (``"g1"``) over the fp32 folded tree, built at the
    first call for each extent; ``(None, None)``, the plain front, when the
    option is off or the kernels do not support the extent."""
    fronts: Dict[int, Tuple] = {}

    def fronts_for(hw: int):
        if not use_fused_front or not supports_extent(hw):
            return None, None
        if hw not in fronts:
            if use_fused_front == "g1":
                fronts[hw] = (None, make_fused_front_g1(folded32, hw, float_dtype))
            else:
                stem = folded32["stem"]
                fronts[hw] = (make_fused_front(stem["weight"], stem["bias"], hw,
                                               float_dtype), None)
        return fronts[hw]

    return fronts_for


def _folded_stage_fn(model: nn.Module, float_dtype, use_fused_front,
                     use_pallas_groups, device) -> Callable:
    """``x -> logits`` for one plain stage: folded backbone + dense head."""
    folded32 = cast_tree(fold_backbone(model.backbone), device, torch.float32)
    folded = cast_tree(folded32, device, float_dtype)
    head = cast_tree(fold_head(model.head), device, float_dtype)
    group12_fn = None
    if use_pallas_groups:
        weights = pack_group12_weights(folded32, float_dtype)
        conv_stream = group12_conv_stream(weights)  # built once, not per call

        def group12_fn(x):
            return fused_group12(x, weights, conv_stream)

    fronts_for = front_selector(folded32, use_fused_front, float_dtype)

    def forward(x):
        front_fn, front_g1_fn = fronts_for(int(x.shape[1]))
        feats = _backbone_apply(folded, x, float_dtype=float_dtype,
                                front_fn=front_fn, front_g1_fn=front_g1_fn,
                                group12_fn=group12_fn)
        return _head_apply(head, feats, float_dtype=float_dtype)

    return forward


def make_v6_pipeline_folded(
    models: PipelineModels,
    stage1_threshold: float = 0.45,
    norm_scale: float = NORM_10BIT,
    float_dtype=torch.bfloat16,
    use_fused_front=False,
    device="cuda",
    use_pallas_groups: bool = False,
    mesh=None,
) -> Callable:
    """The v6 pipeline over BN-folded weights on ``device``:
    ``predict(images_u16) -> dict``, the output contract of
    ``make_v6_pipeline``. ``use_fused_front`` is False, True (K1) or
    ``"g1"`` (K2). ``use_pallas_groups`` (the JAX package's name) selects
    kernel K5 for layer groups 1 and 2 with their SE gates."""
    check_fused_front_option(use_fused_front)
    if mesh is not None:
        raise NotImplementedError("multi-device inference waits for ROADMAP M11")
    device = torch.device(device)
    fns = [
        _folded_stage_fn(m, float_dtype, use_fused_front, use_pallas_groups, device)
        for m in (models.stage1, models.stage2, models.stage3_rect)
    ]
    if is_plain_stage(models.stage3_ab):
        fns.append(_folded_stage_fn(models.stage3_ab, float_dtype,
                                    use_fused_front, use_pallas_groups, device))
    else:  # FGVC head layout: its own unfolded forward
        fns.append(on_device(models.stage3_ab, device, float_dtype))
    return assemble_v6_predict(*fns, stage1_threshold, norm_scale,
                               float_dtype=float_dtype)


__all__ = ["check_fused_front_option", "front_selector", "make_v6_pipeline_folded"]
