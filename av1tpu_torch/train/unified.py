"""Unified multi-task training: one shared backbone, all four v6 heads.

Counterpart of ``av1tpu.train.unified``. ``models.UnifiedV6Model`` shares one
trunk between the four stage heads; this module trains it:

* masked multi-task losses over one packed label array ``[s1 | s2 | rect |
  ab]``: binary focal on stage 1 (every row), class-balanced focal on stage 2
  and AB, focal on RECT, each masked to the rows where the hierarchy defines
  the label (-1 elsewhere, the per-stage datasets' filters);
* optional logit distillation from the four trained per-stage models, run
  dense over the split once (:func:`compute_teacher_logits`), so that every
  head gets soft targets on every row (Hinton et al., 2015);
* the validation metric is the composed final 8-class decision (``v6_route``
  over the four heads), the quantity the serving pipeline reports.

Label packing (float32 columns; -1 = undefined):

    col 0: stage1 (0/1)        col 2: rect (0/1)
    col 1: stage2 (0..2)       col 3: ab (0..3)
    cols 4..13 (distillation only): teacher logits [s1|s2(3)|rect(2)|ab(4)]

The augmentations are draws and applies, as in ``train.augment``: the AB
column is remapped through the v6 swap tables, RECT swapped on a rotation,
-1 stays -1; with distillation only photometric transforms run, so that the
teacher columns describe the image the student sees.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np
import torch

from av1tpu_torch.codec.partitions import (
    AB_HFLIP_SWAP_V6,
    AB_ROT270_SWAP_V6,
    AB_ROT90_SWAP_V6,
    AB_VFLIP_SWAP_V6,
)
from av1tpu_torch.data.bundles import Bundle, class_counts
from av1tpu_torch.data.records import NORM_10BIT
from av1tpu_torch.eval.hierarchy import (
    PipelineModels,
    on_device,
    run_pipeline_batched,
    v6_route,
)
from av1tpu_torch.models import UNIFIED_LOGIT_DIM, UnifiedV6Model, split_unified_logits
from av1tpu_torch.train.augment import (
    Transform,
    _gate,
    _remap,
    _where,
    apply_pipeline,
    cutout,
    draw_pipeline,
    gaussian_noise,
)
from av1tpu_torch.train.losses import (
    binary_focal_loss,
    class_balanced_focal_loss,
    masked_mean,
    multiclass_focal_loss,
)
from av1tpu_torch.train.schedules import adamw, cosine_schedule
from av1tpu_torch.train.stages import Phase, StageRecipe
from av1tpu_torch.train.trainer import at_least_fp32

UNIFIED_LABEL_KEY = "unified"
_HARD_COLS = 4


# ---------------------------------------------------------------------------
# Label packing
# ---------------------------------------------------------------------------

def pack_unified_labels(bundle: Bundle, teacher_logits: Optional[np.ndarray] = None
                        ) -> np.ndarray:
    """The v6 label views (and optional dense teacher logits) as one
    ``(N, 4[+10])`` float32 array (layout in the module docstring)."""
    cols = np.stack([bundle.labels["stage1"], bundle.labels["stage2"],
                     bundle.labels["stage3_RECT"], bundle.labels["stage3_AB"]],
                    axis=1).astype(np.float32)
    if teacher_logits is not None:
        teacher_logits = np.asarray(teacher_logits, dtype=np.float32)
        if teacher_logits.shape != (len(bundle), UNIFIED_LOGIT_DIM):
            raise ValueError(f"teacher logits shape {teacher_logits.shape} != "
                             f"({len(bundle)}, {UNIFIED_LOGIT_DIM})")
        cols = np.concatenate([cols, teacher_logits], axis=1)
    return cols


def with_unified_labels(bundle: Bundle, teacher_logits: Optional[np.ndarray] = None
                        ) -> Bundle:
    """The bundle with the packed ``unified`` label view added."""
    labels = dict(bundle.labels)
    labels[UNIFIED_LABEL_KEY] = pack_unified_labels(bundle, teacher_logits)
    return Bundle(samples=bundle.samples, qps=bundle.qps, labels=labels)


# ---------------------------------------------------------------------------
# Composed-final predictions and metric labels (the 8-class serving space)
# ---------------------------------------------------------------------------

def unified_metric_labels(packed: torch.Tensor) -> torch.Tensor:
    """Packed labels -> composed v6 final 8-class ids (-1 where the truth is
    outside the v6 space or the row is padding)."""
    s1, s2, rect, ab = (packed[..., i].to(torch.int32) for i in range(4))
    minus = torch.full_like(s1, -1)
    final = torch.where(
        s1 == 0, torch.zeros_like(s1),
        torch.where(s2 == 0, torch.ones_like(s1),
                    torch.where(s2 == 1, torch.where(rect >= 0, rect + 2, minus),
                                torch.where((s2 == 2) & (ab >= 0), ab + 4, minus))))
    return torch.where(s1 < 0, minus, final)


def make_unified_predictions(stage1_threshold: float = 0.5) -> Callable:
    """The prediction rule: the composed final id through ``v6_route`` over
    the four heads' outputs."""

    def predictions(outputs: torch.Tensor) -> torch.Tensor:
        s1, s2, rect, ab = split_unified_logits(outputs)
        s1_pred = (torch.sigmoid(s1.float()) >= stage1_threshold).to(torch.int32)
        return v6_route(s1_pred, torch.argmax(s2, dim=-1).to(torch.int32),
                        torch.argmax(rect, dim=-1).to(torch.int32),
                        torch.argmax(ab, dim=-1).to(torch.int32))

    return predictions


# ---------------------------------------------------------------------------
# Multi-task loss and distillation
# ---------------------------------------------------------------------------

def make_unified_loss(s2_counts: Sequence[int], ab_counts: Sequence[int],
                      alpha: float = 0.25, gamma: float = 2.5, beta: float = 0.9999,
                      head_weights: Sequence[float] = (1.0, 1.0, 1.0, 1.0),
                      distill_weight: float = 0.0, kd_temperature: float = 2.0) -> Callable:
    """``loss(outputs (N, 10), packed (N, 4[+10])) -> scalar``.

    The hard term: stage-1 binary focal, stage-2 and AB class-balanced focal
    over the train split's counts, RECT multiclass focal, each masked by its
    -1 labels, weighted by ``head_weights``. ``distill_weight`` in (0, 1]
    blends in the KD term against the packed teacher columns: a softened KL
    per multiclass head and a softened BCE for stage 1, scaled by T^2 and
    averaged over every row with ``packed[:, 0] >= 0``; total ``(1 - w) *
    hard + w * kd``."""
    w1, w2, w3, w4 = (float(w) for w in head_weights)
    s2_counts = [max(int(c), 1) for c in s2_counts]
    ab_counts = [max(int(c), 1) for c in ab_counts]

    def hard_loss(outputs, packed):
        s1, s2, rect, ab = split_unified_logits(outputs)
        s1_l, s2_l, rect_l, ab_l = (packed[..., i].to(torch.int32) for i in range(4))
        total = w1 * binary_focal_loss(s1, s1_l, alpha, gamma)
        total = total + w2 * class_balanced_focal_loss(s2, s2_l, s2_counts, beta, 2.0)
        total = total + w3 * multiclass_focal_loss(rect, rect_l, 2.0)
        return total + w4 * class_balanced_focal_loss(ab, ab_l, ab_counts, beta, 2.0)

    if distill_weight <= 0.0:
        return hard_loss

    T = float(kd_temperature)

    def kd_loss(outputs, packed):
        s1, s2, rect, ab = split_unified_logits(outputs)
        t1, t2, trect, tab = split_unified_logits(packed[..., _HARD_COLS:])
        valid = packed[..., 0] >= 0  # padding rows carry no teacher signal

        def kl(student, teacher):
            teacher = at_least_fp32(teacher) / T
            p = torch.softmax(teacher, dim=-1)
            logq = torch.log_softmax(at_least_fp32(student) / T, dim=-1)
            logp = torch.log_softmax(teacher, dim=-1)
            return masked_mean(torch.sum(p * (logp - logq), dim=-1), valid)

        def binary_kd(student, teacher):
            pt = torch.sigmoid(at_least_fp32(teacher) / T)
            zs = at_least_fp32(student) / T
            # BCE-with-logits against the soft target
            return masked_mean(torch.logaddexp(torch.zeros_like(zs), zs) - pt * zs, valid)

        return (T * T) * (w1 * binary_kd(s1, t1) + w2 * kl(s2, t2) + w3 * kl(rect, trect)
                          + w4 * kl(ab, tab))

    w = float(distill_weight)

    def loss(outputs, packed):
        return (1.0 - w) * hard_loss(outputs, packed) + w * kd_loss(outputs, packed)

    return loss


# ---------------------------------------------------------------------------
# Label-aware augmentation over the packed columns
# ---------------------------------------------------------------------------

def _swap_ab(table: np.ndarray, packed: torch.Tensor, apply: torch.Tensor) -> torch.Tensor:
    """The AB column remapped through ``table`` where ``apply`` and the label
    is defined; -1 stays -1."""
    ab = packed[:, 3].to(torch.int32)
    swapped = _remap(table, torch.clamp(ab, min=0))
    return torch.where(apply & (ab >= 0), swapped, ab)


def _with_columns(packed: torch.Tensor, rect=None, ab=None) -> torch.Tensor:
    out = packed.clone()
    if rect is not None:
        out[:, 2] = rect.to(packed.dtype)
    if ab is not None:
        out[:, 3] = ab.to(packed.dtype)
    return out


def _packed_hflip(p: float = 0.5) -> Transform:
    def apply(x, y, d):
        return (_where(d["apply"], torch.flip(x, dims=(2,)), x),
                _with_columns(y, ab=_swap_ab(AB_HFLIP_SWAP_V6, y, d["apply"])))

    return Transform("hflip_ab", lambda gen, x: {"apply": _gate(gen, x.shape[0], p)}, apply)


def _packed_vflip(p: float = 0.5) -> Transform:
    def apply(x, y, d):
        return (_where(d["apply"], torch.flip(x, dims=(1,)), x),
                _with_columns(y, ab=_swap_ab(AB_VFLIP_SWAP_V6, y, d["apply"])))

    return Transform("vflip_ab", lambda gen, x: {"apply": _gate(gen, x.shape[0], p)}, apply)


def _packed_rot90(p: float = 0.5) -> Transform:
    """A 90 or 270 degree rotation (one coin each): AB through the rotation's
    swap table, RECT HORZ <-> VERT."""
    def draw(gen, x):
        return {"apply": _gate(gen, x.shape[0], p), "use_270": _gate(gen, x.shape[0], 0.5)}

    def apply(x, y, d):
        rotated = _where(d["use_270"], torch.rot90(x, 3, dims=(1, 2)),
                         torch.rot90(x, 1, dims=(1, 2)))
        ab = torch.where(d["use_270"], _swap_ab(AB_ROT270_SWAP_V6, y, d["apply"]),
                         _swap_ab(AB_ROT90_SWAP_V6, y, d["apply"]))
        rect = y[:, 2].to(torch.int32)
        rect = torch.where(d["apply"] & (rect >= 0), 1 - rect, rect)
        return _where(d["apply"], rotated, x), _with_columns(y, rect=rect, ab=ab)

    return Transform("rot90_ab", draw, apply)


UNIFIED_LABELED = (_packed_hflip(), _packed_vflip(), _packed_rot90(),
                   gaussian_noise(0.01, 0.3), cutout(4, 0.3))
UNIFIED_NOISE_ONLY = (gaussian_noise(0.01, 0.3), cutout(4, 0.3))


def unified_augment_labeled(gen: torch.Generator, images: torch.Tensor,
                            packed: torch.Tensor):
    """Geometric and photometric augmentation with every label column kept
    consistent (the teacher columns are not permuted: distil with
    :func:`unified_augment_noise_only`)."""
    return apply_pipeline(UNIFIED_LABELED, images, packed,
                          draw_pipeline(UNIFIED_LABELED, gen, images))


def unified_augment_noise_only(gen: torch.Generator, images: torch.Tensor,
                               packed: torch.Tensor):
    """Distillation-safe augmentation: photometric only, labels untouched."""
    return apply_pipeline(UNIFIED_NOISE_ONLY, images, packed,
                          draw_pipeline(UNIFIED_NOISE_ONLY, gen, images))


# ---------------------------------------------------------------------------
# Recipe and teacher logits
# ---------------------------------------------------------------------------

def unified_recipe(s2_counts: Sequence[int], ab_counts: Sequence[int], epochs: int = 30,
                   lr: float = 1e-3, batch_size: int = 256, weight_decay: float = 1e-2,
                   alpha: float = 0.25, gamma: float = 2.5, beta: float = 0.9999,
                   stage1_threshold: float = 0.5,
                   head_weights: Sequence[float] = (1.0, 1.0, 1.0, 1.0),
                   distill_weight: float = 0.0, kd_temperature: float = 2.0,
                   steps_per_epoch: Optional[int] = None, dtype=torch.float32) -> StageRecipe:
    """AdamW + cosine (the stage-1 schedule), the best checkpoint by the
    composed-final macro-F1 over the 8-class serving space. With
    ``distill_weight > 0`` the bundles carry teacher columns
    (``with_unified_labels(bundle, teacher_logits)``)."""
    augment = (unified_augment_noise_only if distill_weight > 0.0
               else unified_augment_labeled)
    return StageRecipe(
        name="unified", model=UnifiedV6Model, label_key=UNIFIED_LABEL_KEY, num_classes=8,
        loss_fn=make_unified_loss(s2_counts, ab_counts, alpha, gamma, beta,
                                  head_weights=head_weights, distill_weight=distill_weight,
                                  kd_temperature=kd_temperature),
        augment_labeled=augment,
        phases=[Phase(epochs, lambda m, spe: adamw(cosine_schedule(lr, epochs * spe),
                                                   weight_decay), "cosine")],
        batch_size=batch_size, best_metric="macro_f1", steps_per_epoch=steps_per_epoch,
        predictions_fn=make_unified_predictions(stage1_threshold),
        metric_labels_fn=unified_metric_labels, dtype=dtype,
    )


def unified_counts(train_bundle: Bundle) -> dict:
    """Per-head class counts of a v6 train bundle (the loss weights)."""
    return {"s2": class_counts(train_bundle.labels["stage2"], 3),
            "ab": class_counts(train_bundle.labels["stage3_AB"], 4)}


def compute_teacher_logits(models: PipelineModels, samples: np.ndarray,
                           batch_size: int = 4096, norm_scale: Optional[float] = None,
                           float_dtype=torch.float32, device="cuda") -> np.ndarray:
    """The four per-stage models run dense (plain eval-mode forwards, no
    folding, as in the JAX package) over ``samples`` on ``device`` in
    ``float_dtype``: the packed ``(N, 10)`` teacher logits."""
    scale = NORM_10BIT if norm_scale is None else norm_scale
    stages = [on_device(m, device, float_dtype) for m in (
        models.stage1, models.stage2, models.stage3_rect, models.stage3_ab)]

    @torch.inference_mode()
    def logits_fn(images):
        x = (images.to(torch.float32) / scale).to(float_dtype)
        s1, s2, rect, ab = (m(x).float() for m in stages)
        return {"teacher": torch.cat([s1[:, None], s2, rect, ab], dim=-1)}

    return run_pipeline_batched(logits_fn, np.asarray(samples), batch_size, device)["teacher"]


__all__ = [
    "UNIFIED_LABELED",
    "UNIFIED_LABEL_KEY",
    "UNIFIED_NOISE_ONLY",
    "compute_teacher_logits",
    "make_unified_loss",
    "make_unified_predictions",
    "pack_unified_labels",
    "unified_augment_labeled",
    "unified_augment_noise_only",
    "unified_counts",
    "unified_metric_labels",
    "unified_recipe",
    "with_unified_labels",
]
