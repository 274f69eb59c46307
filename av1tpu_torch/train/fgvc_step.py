"""The FGVC composite train step: CutMix cross-entropy plus the center loss.

Counterpart of ``av1tpu.train.fgvc_step``. The reference's production
stage-3 AB model trains with ``CE(cutmix) + 0.001 * CenterLoss`` over the
FGVC stack (006_train_stage3_ab_fgvc.py:437-444, 739-857). One step is

    uint16 batch -> float / 1023 -> label-aware AB augmentation -> CutMix ->
    forward in train mode (logits and normalized features) ->
    lam * CE(labels) + (1 - lam) * CE(labels[perm]) + 0.001 * the same mix of
    center losses -> backward -> one AdamW step over the model and the centers

The class centers are an ``nn.Parameter`` beside the model, in the same
optimizer partition: one ``clip_by_global_norm`` over the model's gradients
and the centers' together, and the decoupled weight decay on both (optax's
``adamw`` has no mask). As in ``train.trainer``, the draws (the augmentation's
and CutMix's) come from an explicit generator, and :func:`fgvc_loss` applies
given draws, so that a test can apply the JAX package's own.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Mapping, Optional

import torch
from torch import nn

from av1tpu_torch.data.records import NORM_10BIT
from av1tpu_torch.models.fgvc import center_loss, init_centers
from av1tpu_torch.models.layers import init_like_flax
from av1tpu_torch.parallel.mesh import (
    DATA_AXIS,
    axis_group,
    data_parallel,
    gather_group,
    own_rows,
    sync_gradients,
)
from av1tpu_torch.train.augment import STAGE3_AB, apply_pipeline, draw_pipeline
from av1tpu_torch.train.losses import (
    cutmix_apply,
    cutmix_draw,
    mixed_loss,
    partner_rows,
    weighted_ce_label_smoothing,
)
from av1tpu_torch.train.schedules import AdamWSpec, TrainOptimizer
from av1tpu_torch.train.trainer import TrainState, _autocast, at_least_fp32, confusion_matrix


@dataclass
class FGVCState(TrainState):
    """A ``TrainState`` whose optimizer also steps the class ``centers``."""

    centers: Optional[nn.Parameter] = None


def create_fgvc_state(model: nn.Module, spec: AdamWSpec, seed: int, num_classes: int = 4,
                      feat_dim: int = 512, device="cuda") -> FGVCState:
    """``model`` drawn after flax's initializers and the centers ``N(0, 1)``,
    both from ``seed``, on ``device``; one optimizer partition over the
    model's parameters and the centers."""
    gen = torch.Generator().manual_seed(seed)
    model = init_like_flax(model, gen).to(device)
    centers = nn.Parameter(init_centers(gen, num_classes, feat_dim).to(device))
    optimizer = TrainOptimizer([("all", [*model.parameters(), centers], spec)])
    return FGVCState(model, optimizer, 0, centers)


def fgvc_draws(gen: torch.Generator, images: torch.Tensor,
               cutmix_alpha: float = 1.0) -> Dict[str, object]:
    """One step's draws: the AB pipeline's per-sample draws and CutMix's."""
    n, h, w = images.shape[0], images.shape[1], images.shape[2]
    return {"augment": draw_pipeline(STAGE3_AB, gen, images),
            "cutmix": cutmix_draw(gen, n, h, w, cutmix_alpha)}


def fgvc_loss(model: nn.Module, centers: torch.Tensor, images: torch.Tensor,
              labels: torch.Tensor, draws: Mapping[str, object], center_weight: float,
              num_classes: int, compute_dtype: torch.dtype = torch.float32):
    """The composite loss of normalized ``images`` on given ``draws``:
    ``(total, ce, center, confusion)``. The model runs in its current mode.
    Inside ``parallel.mesh.data_parallel`` ``images`` and ``labels`` are the
    global batch, the draws are applied to it, and this rank's rows of the
    result go through the model (``confusion`` is then this rank's)."""
    images, labels = apply_pipeline(STAGE3_AB, images, labels, draws["augment"])
    images, perm, lam = cutmix_apply(images, draws["cutmix"])
    images, labels = own_rows(images), own_rows(labels)
    with _autocast(images.device, compute_dtype):
        logits, feats = model(images, return_features=True)
    logits, feats = at_least_fp32(logits), at_least_fp32(feats)
    ce = mixed_loss(lambda lo, ta: weighted_ce_label_smoothing(lo, ta), logits, labels,
                    perm, lam)
    c_loss = (lam * center_loss(feats, labels, centers)
              + (1.0 - lam) * center_loss(feats, partner_rows(labels, perm), centers))
    with torch.no_grad():
        conf = confusion_matrix(labels, torch.argmax(logits, dim=-1), num_classes)
    return ce + center_weight * c_loss, ce, c_loss, conf


def make_fgvc_train_step(model: nn.Module, optimizer: TrainOptimizer, centers: nn.Parameter,
                         center_weight: float = 0.001, cutmix_alpha: float = 1.0,
                         norm_scale: float = NORM_10BIT, label_key: str = "stage3_AB",
                         num_classes: int = 4, compute_dtype: torch.dtype = torch.float32,
                         mesh=None):
    """``step(state, batch, gen) -> {"loss", "ce", "center", "confusion"}``
    (device tensors), updating the model and the centers in place; the
    ``train.trainer`` epoch loops run it. With ``mesh`` ``batch`` is this
    rank's rows: the global batch is gathered, drawn for and mixed as in
    ``trainer.make_train_step``, and the gradients averaged over the data
    group."""
    group = axis_group(mesh, DATA_AXIS)

    def train_step(state: TrainState, batch, gen: torch.Generator):
        images = gather_group(batch["samples"], group).to(torch.float32) / norm_scale
        labels = gather_group(batch[label_key], group).long()
        model.train()
        with data_parallel(mesh):
            total, ce, c_loss, conf = fgvc_loss(model, centers, images, labels,
                                                fgvc_draws(gen, images, cutmix_alpha),
                                                center_weight, num_classes, compute_dtype)
            optimizer.zero_grad()
            total.backward(inputs=optimizer.params)
        sync_gradients(optimizer.params, mesh)
        optimizer.step()
        state.step += 1
        return {"loss": total.detach(), "ce": ce.detach(), "center": c_loss.detach(),
                "confusion": conf}

    return train_step


def make_fgvc_eval_step(model: nn.Module, norm_scale: float = NORM_10BIT,
                        label_key: str = "stage3_AB", num_classes: int = 4,
                        compute_dtype: torch.dtype = torch.float32):
    """``eval_step(state, batch) -> {"loss", "confusion", "logits"}``: eval
    mode, the unweighted CE without smoothing."""

    @torch.no_grad()
    def eval_step(state: TrainState, batch):
        images = batch["samples"].to(torch.float32) / norm_scale
        labels = batch[label_key].long()
        model.eval()
        with _autocast(images.device, compute_dtype):
            logits = model(images)
        logits = logits.float()
        return {"loss": weighted_ce_label_smoothing(logits, labels),
                "confusion": confusion_matrix(labels, torch.argmax(logits, dim=-1),
                                              num_classes),
                "logits": logits}

    return eval_step


__all__ = ["FGVCState", "create_fgvc_state", "fgvc_draws", "fgvc_loss",
           "make_fgvc_eval_step", "make_fgvc_train_step"]
