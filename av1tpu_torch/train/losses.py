"""Loss functions: focal, class-balanced focal, label smoothing, the v5
focal-BCE, hard-negative mining and the Mixup/CutMix pairs.

Counterpart of ``av1tpu.train.losses``: plain functions on tensors, the same
formulas written op for op after the JAX package's (and through it after
``pesquisa_v6/v6_pipeline/losses.py`` and the v5 stage losses). Every loss
takes logits and integer labels; rows with a negative label (eval padding)
contribute nothing, and ``mean`` divides by the valid rows. Inside
``parallel.mesh.data_parallel`` every reduction over the batch is over the
global batch: a rank's loss is the one-process loss of the global batch.

Mixup and CutMix are split into a draw (one lambda, a permutation, CutMix's
box and gate) and an apply given those draws, so that a test can hold the
apply against the JAX package on the JAX package's own draws.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from av1tpu_torch.data.sampling import effective_number_weights
from av1tpu_torch.parallel.mesh import current_data_group, global_rows, global_sum, own_rows


def _sigmoid_bce(logits, targets):
    """``optax.sigmoid_binary_cross_entropy``."""
    return -targets * F.logsigmoid(logits) - (1.0 - targets) * F.logsigmoid(-logits)


def _softmax_ce_int(logits, targets):
    """``optax.softmax_cross_entropy_with_integer_labels``: the max is taken
    out (without a gradient) before the log-sum-exp."""
    logits = logits - logits.max(dim=-1, keepdim=True).values.detach()
    label_logits = torch.gather(logits, -1, targets[:, None])[:, 0]
    return torch.log(torch.exp(logits).sum(dim=-1)) - label_logits


def _reduce_valid(loss, targets, reduction: str):
    """Reduce ignoring negative targets (eval padding rows); the mean over
    the valid rows of the global batch inside ``parallel.mesh.data_parallel``
    (numerator and count summed over the data group), the sum this rank's."""
    valid = (targets >= 0).to(loss.dtype)
    loss = loss * valid
    if reduction == "mean":
        return global_sum(loss) / torch.clamp(global_sum(valid.detach()), min=1.0)
    if reduction == "sum":
        return loss.sum()
    return loss


def binary_focal_loss(logits, targets, alpha: float = 0.25, gamma: float = 2.0,
                      reduction: str = "mean"):
    """Binary focal loss (Lin et al., 2017): ``alpha_t * (1-p_t)^gamma * BCE``
    (v6 ``FocalLoss`` binary branch, losses.py:29-38)."""
    raw_targets = targets
    targets = torch.clamp(targets, min=0).to(logits.dtype)
    bce = _sigmoid_bce(logits, targets)
    probs = torch.sigmoid(logits)
    pt = probs * targets + (1.0 - probs) * (1.0 - targets)
    alpha_t = alpha * targets + (1.0 - alpha) * (1.0 - targets)
    loss = alpha_t * (1.0 - pt) ** gamma * bce
    return _reduce_valid(loss, raw_targets, reduction)


def multiclass_focal_loss(logits, targets, gamma: float = 2.0, reduction: str = "mean"):
    """Multiclass focal ``(1-p_t)^gamma * CE`` (losses.py:41-46; no alpha)."""
    t = torch.clamp(targets, min=0).long()
    ce = _softmax_ce_int(logits, t)
    pt = torch.gather(torch.softmax(logits, dim=-1), -1, t[:, None])[:, 0]
    return _reduce_valid((1.0 - pt) ** gamma * ce, targets, reduction)


def class_balanced_focal_loss(logits, targets, samples_per_class, beta: float = 0.9999,
                              gamma: float = 2.0, reduction: str = "mean"):
    """Class-Balanced focal loss (Cui et al., 2019; losses.py:56-93): the
    effective-number weight of each sample's class scales its CE, focal
    modulation on top."""
    weights = torch.as_tensor(
        effective_number_weights(np.asarray(samples_per_class), beta),
        dtype=logits.dtype, device=logits.device)
    t = torch.clamp(targets, min=0).long()
    ce = _softmax_ce_int(logits, t) * weights[t]
    pt = torch.gather(torch.softmax(logits, dim=-1), -1, t[:, None])[:, 0]
    return _reduce_valid((1.0 - pt) ** gamma * ce, targets, reduction)


def weighted_ce_label_smoothing(logits, targets, class_weights=None, smoothing: float = 0.0,
                                reduction: str = "mean"):
    """Weighted CE with label smoothing: ``smoothing/(C-1)`` off-class,
    ``1-smoothing`` on-class (v5 ``_stage2_loss``, v6 ``LabelSmoothingLoss``)."""
    num_classes = logits.shape[-1]
    t = torch.clamp(targets, min=0).long()
    log_probs = torch.log_softmax(logits, dim=-1)
    off = smoothing / (num_classes - 1) if num_classes > 1 else 0.0
    true_dist = torch.full_like(log_probs, off)
    true_dist[torch.arange(t.shape[0], device=t.device), t] = 1.0 - smoothing
    loss = -(true_dist * log_probs).sum(dim=-1)
    if class_weights is not None:
        loss = loss * torch.as_tensor(np.asarray(class_weights), dtype=loss.dtype,
                                      device=loss.device)[t]
    return _reduce_valid(loss, targets, reduction)


def stage1_focal_bce_v5(logits, targets, pos_weight: float = 1.0, gamma: float = 0.0,
                        reduction: str = "mean"):
    """v5 stage-1 loss: BCE-with-logits with ``pos_weight`` and an optional
    focal factor (train_stage.py:74-88)."""
    raw_targets = targets
    targets = torch.clamp(targets, min=0).to(logits.dtype)
    bce = -(pos_weight * targets * F.logsigmoid(logits)
            + (1.0 - targets) * F.logsigmoid(-logits))
    if gamma > 0:
        probs = torch.sigmoid(logits)
        pt = probs * targets + (1.0 - probs) * (1.0 - targets)
        bce = (1.0 - pt) ** gamma * bce
    return _reduce_valid(bce, raw_targets, reduction)


def hard_negative_mining_loss(logits, targets, neg_pos_ratio: float = 3.0,
                              base: str = "focal", alpha: float = 0.25, gamma: float = 2.0):
    """All positives plus the ``num_pos * ratio`` hardest negatives
    (v6 ``HardNegativeMiningLoss``, losses.py:125-172). Negatives are ranked
    by a **stable** sort of the negated losses, as ``jnp.argsort`` ranks them,
    so that tied losses at the cut keep the lower index. Inside
    ``parallel.mesh.data_parallel`` the negatives are chosen over the global
    batch (its losses and positives gathered, without a gradient) and the
    kept losses summed over it."""
    targets_f = targets.to(logits.dtype)
    if base == "focal":
        per = binary_focal_loss(logits, targets, alpha, gamma, reduction="none")
    else:
        per = _sigmoid_bce(logits, targets_f)
    pos_mask = targets_f > 0.5
    neg_loss = torch.where(pos_mask, torch.full_like(per, -math.inf), per)
    all_pos, all_neg_loss = global_rows(pos_mask), global_rows(neg_loss.detach())
    num_pos = all_pos.sum()
    num_neg_keep = torch.minimum((num_pos * neg_pos_ratio).to(torch.int32),
                                 (~all_pos).sum().to(torch.int32))
    order = torch.argsort(-all_neg_loss, stable=True)
    ranks = torch.empty_like(order).scatter_(
        0, order, torch.arange(order.shape[0], device=order.device))
    keep = own_rows(all_pos | (ranks < num_neg_keep))
    total = global_sum(torch.where(keep, per, torch.zeros_like(per)))
    return total / torch.clamp(global_sum(keep), min=1)


def masked_mean(per_sample_loss, valid_mask):
    """Mean over valid samples only (of the global batch inside
    ``parallel.mesh.data_parallel``)."""
    valid = valid_mask.to(per_sample_loss.dtype)
    return (global_sum(per_sample_loss * valid)
            / torch.clamp(global_sum(valid.detach()), min=1.0))


# ---------------------------------------------------------------------------
# Mixing augment + loss pairs (a whole device batch)
# ---------------------------------------------------------------------------

def _host_rng(gen: torch.Generator) -> np.random.Generator:
    """A numpy generator seeded from ``gen``: torch has no Beta draw that
    takes a generator, so the batch's scalar draws are made on the host."""
    seed = torch.randint(0, 2**62, (1,), generator=gen, device=gen.device)
    return np.random.default_rng(int(seed.item()))


def mixup_draw(gen: torch.Generator, n: int, alpha: float = 0.4) -> Tuple[torch.Tensor, float]:
    """Mixup's draws: a permutation of the batch (on ``gen``'s device) and
    ``lam ~ Beta(alpha, alpha)`` (1 when ``alpha`` is 0)."""
    lam = float(_host_rng(gen).beta(alpha, alpha)) if alpha > 0 else 1.0
    return torch.randperm(n, generator=gen, device=gen.device), lam


def mixup_apply(images, perm, lam):
    """``lam * x + (1-lam) * x[perm]`` (v6 ``MixupLoss.mixup_data``)."""
    return lam * images + (1.0 - lam) * images[perm]


def mixup_batch(gen: torch.Generator, images, alpha: float = 0.4):
    """Mixup (Zhang et al., 2018): ``(mixed_images, perm, lam)``; combine
    per-label losses with :func:`mixed_loss`."""
    perm, lam = mixup_draw(gen, images.shape[0], alpha)
    return mixup_apply(images, perm, lam), perm, lam


def cutmix_draw(gen: torch.Generator, n: int, h: int, w: int, alpha: float = 1.0,
                apply_prob: float = 0.5) -> Dict[str, object]:
    """CutMix's draws: the gate, ``lam0 ~ Beta(alpha, alpha)``, the box centre
    and a permutation of the batch."""
    rng = _host_rng(gen)
    return {"apply": bool(rng.uniform() < apply_prob), "lam0": float(rng.beta(alpha, alpha)),
            "cx": int(rng.integers(0, w)), "cy": int(rng.integers(0, h)),
            "perm": torch.randperm(n, generator=gen, device=gen.device)}


def cutmix_apply(images, draws: Dict[str, object]):
    """The box of ``draws`` (clipped to the block) pasted from the permuted
    batch, lambda adjusted to the box's real area; without the gate the
    batch, the identity permutation and 1 (``CutMixCrossEntropyLoss``,
    006:300-345)."""
    n, h, w = images.shape[0], images.shape[1], images.shape[2]
    if not draws["apply"]:
        return images, torch.arange(n, device=images.device), 1.0
    cut_rat = math.sqrt(1.0 - draws["lam0"])
    cut_w, cut_h = int(w * cut_rat), int(h * cut_rat)
    cx, cy = draws["cx"], draws["cy"]
    x1, x2 = min(max(cx - cut_w // 2, 0), w), min(max(cx + cut_w // 2, 0), w)
    y1, y2 = min(max(cy - cut_h // 2, 0), h), min(max(cy + cut_h // 2, 0), h)
    box = torch.zeros((h, w), dtype=images.dtype, device=images.device)
    box[y1:y2, x1:x2] = 1.0
    box = box[None, :, :, None]
    perm = draws["perm"]
    mixed = images * (1.0 - box) + images[perm] * box
    return mixed, perm, 1.0 - ((x2 - x1) * (y2 - y1)) / (w * h)


def cutmix_batch(gen: torch.Generator, images, alpha: float = 1.0, apply_prob: float = 0.5):
    """CutMix box mixing (Yun et al., 2019): ``(images, perm, lam)``."""
    draws = cutmix_draw(gen, images.shape[0], images.shape[1], images.shape[2], alpha,
                        apply_prob)
    return cutmix_apply(images, draws)


def mixed_loss(loss_fn, logits, targets, perm, lam):
    """``lam * loss(y) + (1-lam) * loss(y[perm])`` (losses.py:120-122).
    Inside ``parallel.mesh.data_parallel`` ``perm`` permutes the global
    batch: each row's partner label comes from the gathered labels."""
    return (lam * loss_fn(logits, targets)
            + (1.0 - lam) * loss_fn(logits, partner_rows(targets, perm)))


def partner_rows(t, perm):
    """``t[perm]`` for this rank's rows, ``perm`` a permutation of the global
    batch (``t[perm]`` outside ``parallel.mesh.data_parallel``)."""
    if current_data_group() is None:
        return t[perm]
    return own_rows(global_rows(t)[perm])


# ---------------------------------------------------------------------------
# Stage -> loss factory (parity: get_loss_function, losses.py:204-250)
# ---------------------------------------------------------------------------

def get_loss_function(stage: str, cfg: Optional[Dict] = None):
    """``loss(logits, targets) -> scalar`` for a training stage: stage1
    focal(alpha=.25, gamma=2.5) or hard mining, stage2 CB-focal(beta=.9999,
    gamma=2), stage3_rect focal(gamma=2), stage3_ab CB-focal."""
    cfg = dict(cfg or {})
    if stage == "stage1":
        if cfg.get("hard_mining"):
            ratio = cfg.get("neg_pos_ratio", 3.0)
            return lambda lo, ta: hard_negative_mining_loss(lo, ta, ratio, base="focal")
        alpha, gamma = cfg.get("alpha", 0.25), cfg.get("gamma", 2.5)
        return lambda lo, ta: binary_focal_loss(lo, ta, alpha, gamma)
    if stage == "stage2":
        spc = cfg.get("samples_per_class", [1000, 1000, 1000])
        beta, gamma = cfg.get("beta", 0.9999), cfg.get("gamma", 2.0)
        return lambda lo, ta: class_balanced_focal_loss(lo, ta, spc, beta, gamma)
    if stage == "stage3_rect":
        gamma = cfg.get("gamma", 2.0)
        return lambda lo, ta: multiclass_focal_loss(lo, ta, gamma)
    if stage == "stage3_ab":
        spc = cfg.get("samples_per_class", [250, 250, 250, 250])
        beta, gamma = cfg.get("beta", 0.9999), cfg.get("gamma", 2.0)
        return lambda lo, ta: class_balanced_focal_loss(lo, ta, spc, beta, gamma)
    raise ValueError(f"Unknown stage: {stage}")


__all__ = [
    "binary_focal_loss",
    "class_balanced_focal_loss",
    "cutmix_apply",
    "cutmix_batch",
    "cutmix_draw",
    "get_loss_function",
    "hard_negative_mining_loss",
    "masked_mean",
    "mixed_loss",
    "mixup_apply",
    "mixup_batch",
    "mixup_draw",
    "multiclass_focal_loss",
    "partner_rows",
    "stage1_focal_bce_v5",
    "weighted_ce_label_smoothing",
]
