"""Unified single-backbone serving pipeline: one trunk instead of four.

Counterpart of ``av1tpu.eval.unified``. The per-stage v6 pipeline
(``eval.hierarchy.make_v6_pipeline``) runs all four stage models on the whole
batch, so each block pays four ResNet-18 forwards;
:class:`av1tpu_torch.models.UnifiedV6Model` shares ONE backbone across the
four stage heads. The output contract is that of ``make_v6_pipeline``
(``final``/``stage1_prob``/``stage1_pred``/``stage2_pred``/
``stage3_rect_pred``/``stage3_ab_pred``, routed by ``v6_route``), so a unified
predictor drops into ``run_pipeline_batched`` and the tree cascade
(``eval.tree_infer``) unchanged.

Two serving formulations, as in the per-stage family:

* :func:`make_unified_pipeline`: the ``nn.Module``'s own forward, with the
  optional 4-view TTA (and swap-aligned AB pooling).
* :func:`make_unified_pipeline_folded`: BN-folded conv+bias weights through
  the shared ``quant.ptq`` fold helpers, one folded backbone forward and four
  dense head stacks, with the fused front kernels (K1, K2) as options.
"""
from __future__ import annotations

from typing import Callable, Dict

import torch
from torch import nn

from av1tpu_torch.data.records import NORM_10BIT
from av1tpu_torch.eval.folded import check_fused_front_option, front_selector
from av1tpu_torch.eval.graphs import graphed
from av1tpu_torch.eval.hierarchy import on_device, tta_mean_logits, v6_route
from av1tpu_torch.models.v6 import split_unified_logits
from av1tpu_torch.quant.ptq import (
    _backbone_apply,
    _head_apply,
    cast_tree,
    fold_backbone,
    fold_head,
)

_HEADS = ("stage1", "stage2", "rect", "ab")


def _route_from_unified(logits: torch.Tensor,
                        stage1_threshold: float) -> Dict[str, torch.Tensor]:
    """(N, 10) unified logits -> the v6 pipeline output dict."""
    s1_logits, s2_logits, rect_logits, ab_logits = split_unified_logits(logits)
    s1_prob = torch.sigmoid(s1_logits.float())
    s1_pred = (s1_prob >= stage1_threshold).to(torch.int32)
    s2_pred = torch.argmax(s2_logits, dim=-1).to(torch.int32)
    rect_pred = torch.argmax(rect_logits, dim=-1).to(torch.int32)
    ab_pred = torch.argmax(ab_logits, dim=-1).to(torch.int32)
    return {
        "final": v6_route(s1_pred, s2_pred, rect_pred, ab_pred),
        "stage1_prob": s1_prob,
        "stage1_pred": s1_pred,
        "stage2_pred": s2_pred,
        "stage3_rect_pred": rect_pred,
        "stage3_ab_pred": ab_pred,
    }


def _unified_predict(forward: Callable, stage1_threshold: float,
                     norm_scale: float, float_dtype) -> Callable:
    """uint16 NHWC images -> the routed outputs of ``forward``'s logits."""

    @torch.inference_mode()
    def predict(images: torch.Tensor) -> Dict[str, torch.Tensor]:
        # divide, not multiply by 1/1023: the two differ by 1 ulp in fp32
        x = (images.to(torch.float32) / norm_scale).to(float_dtype)
        return _route_from_unified(forward(x), stage1_threshold)

    return predict


def make_unified_pipeline(
    model: nn.Module,
    stage1_threshold: float = 0.45,
    norm_scale: float = NORM_10BIT,
    input_dtype=torch.float32,
    tta: bool = False,
    tta_align_ab: bool = True,
    device="cuda",
    mesh=None,
) -> Callable:
    """The unified pipeline over a ``UnifiedV6Model``'s own forward:
    ``predict(images_u16) -> dict`` with the ``make_v6_pipeline`` output
    contract, from ONE backbone forward, on ``device`` (the card unless the
    caller passes ``"cpu"``; ``"cuda"`` without a card raises).

    ``tta`` averages the packed logits over the 4 TTA views
    (original/hflip/vflip/rot180); ``tta_align_ab`` (default ON) re-expresses
    each flipped view's AB logit slice (columns 6:10) in the original
    frame's class order before averaging
    (``train.augment.align_tta_ab_logits``). Stage-1/2 targets do not depend
    on the view and RECT is invariant under these four views (hflip/vflip/
    rot180 preserve HORZ vs VERT), so only AB needs the remap. ``mesh``:
    the model stays replicated on this rank's ``device``."""
    model = on_device(model, device, input_dtype)

    def forward(x):
        if not tta:
            return model(x)
        return tta_mean_logits(model, x, tta_align_ab)

    return _unified_predict(forward, stage1_threshold, norm_scale, input_dtype)


def make_unified_pipeline_folded(
    model: nn.Module,
    stage1_threshold: float = 0.45,
    norm_scale: float = NORM_10BIT,
    float_dtype=torch.bfloat16,
    use_fused_front=False,
    device="cuda",
    mesh=None,
) -> Callable:
    """BN-folded unified pipeline on ``device``.

    Folds the shared backbone's conv+BN pairs into conv+bias once
    (``quant.ptq.fold_backbone``: a ``UnifiedV6Model`` has the ``backbone``
    of the per-stage models) and takes the four heads' dense stacks; serving
    is one folded backbone forward and four matmul stacks. Same routing and
    output contract as :func:`make_unified_pipeline`. ``use_fused_front=True``
    runs stem + maxpool as kernel K1 at 8 and 16 px blocks; ``"g1"`` runs
    the whole stem + maxpool + layer group 1 + SE1 chain as kernel K2. Both
    are built lazily per input extent, and extents above 16 px take the plain
    front. ``mesh``: the folded model stays replicated on this rank's
    ``device``, where its kernels run. On a CUDA ``device`` each input
    shape's calls are captured and replayed as a CUDA graph from its second
    call on (``eval.graphs``)."""
    check_fused_front_option(use_fused_front)
    device = torch.device(device)
    folded32 = cast_tree(fold_backbone(model.backbone), device, torch.float32)
    folded = cast_tree(folded32, device, float_dtype)
    heads = {
        name: cast_tree(fold_head(getattr(model, f"head_{name}")), device, float_dtype)
        for name in _HEADS
    }
    fronts_for = front_selector(folded32, use_fused_front, float_dtype)

    def forward(x):
        front_fn, front_g1_fn = fronts_for(int(x.shape[1]))
        feats = _backbone_apply(folded, x, float_dtype=float_dtype,
                                front_fn=front_fn, front_g1_fn=front_g1_fn)
        return torch.cat(
            [_head_apply(heads[n], feats, float_dtype=float_dtype).float()
             for n in _HEADS], dim=-1)

    return graphed(_unified_predict(forward, stage1_threshold, norm_scale, float_dtype),
                   device)


__all__ = ["make_unified_pipeline", "make_unified_pipeline_folded"]
