"""Model ensembles: voting, uncertainty, weighting, stacking, diversity.

Counterpart of ``av1tpu.eval.ensemble``. Members' logits arrive stacked as
``(M, N, C)`` arrays and combine with array ops. Probabilities are float32
softmaxes, as the JAX package computes them; the stacking meta-model is fit
by full-batch gradient descent in torch, on the card unless the caller asks
for the CPU.
"""
from __future__ import annotations

import copy
import json
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from av1tpu_torch.eval.hierarchy import run_pipeline_batched, tta_mean_logits
from av1tpu_torch.models.jax_import import load_jax_variables
from av1tpu_torch.train.checkpoint import load_variables_npz, save_variables_npz


def _softmax(member_logits) -> np.ndarray:
    """float32 softmax over the last axis."""
    logits = torch.from_numpy(np.asarray(member_logits, dtype=np.float32))
    return torch.softmax(logits, dim=-1).numpy()


def soft_vote(member_logits: np.ndarray) -> np.ndarray:
    """Mean softmax probability -> argmax (parity: ensemble.py:51-56)."""
    return _softmax(member_logits).mean(axis=0, dtype=np.float32).argmax(axis=-1)


def hard_vote(member_logits: np.ndarray) -> np.ndarray:
    """Per-member argmax -> majority vote; ties resolve to the smallest
    class id, matching torch.mode semantics (parity: ensemble.py:58-79)."""
    preds = np.argmax(member_logits, axis=-1)  # (M, N)
    num_classes = member_logits.shape[-1]
    counts = np.apply_along_axis(
        lambda col: np.bincount(col, minlength=num_classes), 0, preds
    )  # (num_classes, N)
    return counts.argmax(axis=0)


def predict_with_uncertainty(member_logits: np.ndarray) -> Dict[str, np.ndarray]:
    """Mean/std of member probabilities + agreement fraction
    (parity: ensemble.py:83-117)."""
    probs = _softmax(member_logits)
    mean_probs = probs.mean(axis=0)
    std_probs = probs.std(axis=0)
    preds = mean_probs.argmax(axis=-1)
    member_preds = probs.argmax(axis=-1)  # (M, N)
    agreement = (member_preds == preds[None, :]).mean(axis=0)
    return {
        "predictions": preds,
        "mean_probs": mean_probs,
        "std_probs": std_probs,
        "agreement": agreement,
    }


def weighted_vote(member_logits: np.ndarray, weights: Sequence[float]) -> np.ndarray:
    """Weighted soft voting (parity: WeightedEnsemble, ensemble.py:156-183)."""
    w = np.asarray(weights, dtype=np.float64)
    w = w / w.sum()
    return np.einsum("m,mnc->nc", w, _softmax(member_logits)).argmax(axis=-1)


def _stacking_features(member_logits: np.ndarray) -> np.ndarray:
    """(N, M*C + 1): each sample's member probabilities, then a 1 for the bias."""
    probs = _softmax(member_logits)
    m, n, c = probs.shape
    feats = probs.transpose(1, 0, 2).reshape(n, m * c)
    return np.concatenate([feats, np.ones((n, 1))], axis=1)


def _stacking_objective(w: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
                        l2: float) -> torch.Tensor:
    """Mean softmax cross-entropy of the meta-model ``x @ w`` plus ``l2 * sum(w²)``."""
    return F.cross_entropy(x @ w, y) + l2 * torch.sum(w * w)


def fit_stacking(
    member_logits: np.ndarray,
    labels: np.ndarray,
    l2: float = 1e-3,
    steps: int = 500,
    lr: float = 0.1,
    seed: int = 0,
    device="cuda",
) -> np.ndarray:
    """Fit the stacking meta-model: multinomial logistic regression over the
    concatenation of member probabilities (parity: StackingEnsemble,
    ensemble.py:186-226 — a Linear meta-model over concat probs), on
    ``device`` (the card unless the caller passes ``"cpu"``).

    Returns the meta weight matrix ``(M*C + 1, C)`` (bias folded in) as host
    numpy, initialised from N(0, 0.01²) drawn on the host by a
    ``torch.Generator`` seeded with ``seed``, so that every device starts
    from the same weights."""
    m, _, c = np.shape(member_logits)
    x = torch.as_tensor(_stacking_features(member_logits), dtype=torch.float32,
                        device=device)
    y = torch.as_tensor(np.asarray(labels), dtype=torch.int64, device=device)
    gen = torch.Generator().manual_seed(seed)
    w = (torch.randn((m * c + 1, c), generator=gen, dtype=torch.float32) * 0.01).to(device)
    with torch.enable_grad():
        for _ in range(steps):
            w.requires_grad_(True)
            (grad,) = torch.autograd.grad(_stacking_objective(w, x, y, l2), w)
            w = (w - lr * grad).detach()
    return w.cpu().numpy()


def stacking_predict(member_logits: np.ndarray, meta_w: np.ndarray) -> np.ndarray:
    return (_stacking_features(member_logits) @ meta_w).argmax(axis=-1)


def ensemble_diversity(member_logits: np.ndarray) -> Dict[str, object]:
    """Pairwise disagreement rates (parity: evaluate_ensemble_diversity,
    ensemble.py:252-293)."""
    preds = np.argmax(member_logits, axis=-1)
    m = preds.shape[0]
    pair_disagreement = {}
    vals = []
    for i in range(m):
        for j in range(i + 1, m):
            d = float((preds[i] != preds[j]).mean())
            pair_disagreement[f"{i}-{j}"] = d
            vals.append(d)
    return {
        "pairwise_disagreement": pair_disagreement,
        "mean_disagreement": float(np.mean(vals)) if vals else 0.0,
    }


def _batched_logits(forward, images, batch_size: int, device) -> np.ndarray:
    """``forward``'s float32 logits over ``images`` (float NHWC, host numpy
    or a tensor) through :func:`run_pipeline_batched` on ``device``."""

    @torch.inference_mode()
    def predict(x):
        return {"out": forward(x).float()}

    return run_pipeline_batched(predict, images, batch_size, device)["out"]


def _member(model: torch.nn.Module, variables, device) -> torch.nn.Module:
    """A copy of ``model`` holding ``variables`` (a JAX variable tree), on
    ``device`` in eval mode."""
    return load_jax_variables(copy.deepcopy(model), variables).to(device).eval()


def stacked_member_logits(
    model, member_variables: List, images, batch_size: int = 4096, device="cuda",
) -> np.ndarray:
    """``(M, N, C)`` logits of every ensemble member: ``model``'s class with
    each member's variable tree (as :func:`load_ensemble` returns them), one
    member after another, on ``device`` (the card unless the caller passes
    ``"cpu"``)."""
    return np.stack([
        _batched_logits(_member(model, v, device), images, batch_size, device)
        for v in member_variables
    ])


def save_ensemble(directory, member_variables: List, meta: Optional[Dict] = None):
    """Persist ensemble members + metadata (parity: ABEnsemble.save_ensemble,
    ensemble.py:119-137). One flat-variables npz per member + ensemble.json."""
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    paths = []
    for i, variables in enumerate(member_variables, start=1):
        paths.append(
            save_variables_npz(directory / f"member_{i}_variables.npz", variables)
        )
    payload = {"num_members": len(member_variables), **(meta or {})}
    (directory / "ensemble.json").write_text(json.dumps(payload, indent=2))
    return paths


def load_ensemble(directory):
    """Load all members saved by :func:`save_ensemble`; returns
    ``(member_variables, meta)``."""
    directory = Path(directory)
    meta = json.loads((directory / "ensemble.json").read_text())
    members = [
        load_variables_npz(directory / f"member_{i}_variables.npz")
        for i in range(1, meta["num_members"] + 1)
    ]
    return members, meta


def tta_logits(model, variables, images, batch_size: int = 4096,
               device="cuda") -> np.ndarray:
    """Test-time-augmentation logits: the mean over the 4 views of
    ``train.augment.tta_views`` (original/hflip/vflip/rot180) of ``model``'s
    class holding ``variables``, on ``device`` (the card unless the caller
    passes ``"cpu"``)."""
    member = _member(model, variables, device)
    return _batched_logits(lambda x: tta_mean_logits(member, x), images,
                           batch_size, device)


__all__ = [
    "ensemble_diversity",
    "fit_stacking",
    "hard_vote",
    "load_ensemble",
    "predict_with_uncertainty",
    "save_ensemble",
    "soft_vote",
    "stacked_member_logits",
    "stacking_predict",
    "tta_logits",
    "weighted_vote",
]
