"""Evaluation metrics, threshold sweeps and temperature calibration (numpy
only).

Copied from ``av1tpu.eval.metrics``: the JAX package's ``eval/__init__``
imports jax, so the module cannot be imported from there.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


def confusion(y_true: np.ndarray, y_pred: np.ndarray, num_classes: int) -> np.ndarray:
    y_true = np.asarray(y_true, dtype=np.int64)
    y_pred = np.asarray(y_pred, dtype=np.int64)
    valid = y_true >= 0
    idx = y_true[valid] * num_classes + y_pred[valid]
    return np.bincount(idx, minlength=num_classes * num_classes).reshape(
        num_classes, num_classes
    )


def _prf(conf: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    tp = np.diag(conf).astype(np.float64)
    predicted = conf.sum(axis=0).astype(np.float64)
    support = conf.sum(axis=1).astype(np.float64)
    precision = np.divide(tp, predicted, out=np.zeros_like(tp), where=predicted > 0)
    recall = np.divide(tp, support, out=np.zeros_like(tp), where=support > 0)
    denom = precision + recall
    f1 = np.divide(
        2 * precision * recall, denom, out=np.zeros_like(tp), where=denom > 0
    )
    return precision, recall, f1


def compute_metrics(
    y_true: np.ndarray,
    y_pred: np.ndarray,
    labels: Optional[Sequence[str]] = None,
    num_classes: Optional[int] = None,
) -> Dict[str, object]:
    """Accuracy / macro / weighted F1 / per-class table + confusion.

    Same quantities as the reference ``compute_metrics`` (metrics.py:17-73,
    built on sklearn) with identical averaging semantics.

    Pass ``labels`` (class names) or ``num_classes`` to pin the confusion
    matrix's size the way the reference's fixed label lists do; without
    either, the class count is inferred from the data, and a sample
    missing the top class yields a smaller matrix.
    """
    y_true = np.asarray(y_true)
    y_pred = np.asarray(y_pred)
    inferred = int(max(y_true.max(initial=0), y_pred.max(initial=0))) + 1
    num_classes = max(inferred, num_classes or 0)
    if labels is not None:
        num_classes = max(num_classes, len(labels))
    conf = confusion(y_true, y_pred, num_classes)
    precision, recall, f1 = _prf(conf)
    support = conf.sum(axis=1)
    total = conf.sum()
    weighted_f1 = float((f1 * support).sum() / total) if total else 0.0
    # Macro averages run over the classes observed in y_true or y_pred,
    # matching the reference's sklearn default (metrics.py:39-41 passes no
    # `labels`, so sklearn infers the set from the data). A structurally
    # absent class (e.g. SPLIT at block 8, which never occurs) must not
    # drag macro-F1 down with a spurious 0 — that artifact produced the
    # anomalous 0.607 stage-2 figure at 8px in the round-3 tree ladder.
    observed = (support > 0) | (conf.sum(axis=0) > 0)
    if not observed.any():
        observed = np.ones(num_classes, dtype=bool)

    names = list(labels) if labels else [str(i) for i in range(num_classes)]
    per_class = {
        names[i]: {
            "precision": float(precision[i]),
            "recall": float(recall[i]),
            "f1": float(f1[i]),
            "support": int(support[i]),
        }
        for i in range(num_classes)
    }
    return {
        "accuracy": float(np.diag(conf).sum() / total) if total else 0.0,
        "macro_f1": float(f1[observed].mean()),
        "weighted_f1": weighted_f1,
        "macro_precision": float(precision[observed].mean()),
        "macro_recall": float(recall[observed].mean()),
        "per_class": per_class,
        "confusion_matrix": conf.tolist(),
        "class_names": names,
    }


def compute_binary_metrics(
    y_true: np.ndarray, probs: np.ndarray, threshold: float = 0.5
) -> Dict[str, float]:
    """Binary accuracy/P/R/F1 at a threshold plus AUC
    (parity: metrics.py:76-110)."""
    y_true = np.asarray(y_true).astype(np.int64)
    probs = np.asarray(probs, dtype=np.float64)
    preds = (probs >= threshold).astype(np.int64)
    tp = int(((preds == 1) & (y_true == 1)).sum())
    fp = int(((preds == 1) & (y_true == 0)).sum())
    fn = int(((preds == 0) & (y_true == 1)).sum())
    tn = int(((preds == 0) & (y_true == 0)).sum())
    precision = tp / (tp + fp) if tp + fp else 0.0
    recall = tp / (tp + fn) if tp + fn else 0.0
    f1 = 2 * precision * recall / (precision + recall) if precision + recall else 0.0
    return {
        "accuracy": (tp + tn) / max(len(y_true), 1),
        "precision": precision,
        "recall": recall,
        "f1": f1,
        "auc": roc_auc(y_true, probs),
        "tp": tp,
        "fp": fp,
        "fn": fn,
        "tn": tn,
        "threshold": threshold,
        # fraction of samples passing the stage-1 gate at this threshold —
        # the quantity capacity-gated serving sizes its static K from
        "gate_rate": (tp + fp) / max(len(y_true), 1),
    }


def roc_auc(y_true: np.ndarray, probs: np.ndarray) -> float:
    """Rank-based AUC (equivalent to sklearn roc_auc_score with ties)."""
    y_true = np.asarray(y_true)
    probs = np.asarray(probs, dtype=np.float64)
    pos = probs[y_true == 1]
    neg = probs[y_true == 0]
    if len(pos) == 0 or len(neg) == 0:
        return 0.0
    order = np.argsort(np.concatenate([pos, neg]), kind="mergesort")
    ranks = np.empty(len(order), dtype=np.float64)
    sorted_vals = np.concatenate([pos, neg])[order]
    ranks[order] = np.arange(1, len(order) + 1)
    # average ranks for ties
    _, inv, counts = np.unique(sorted_vals, return_inverse=True, return_counts=True)
    cum = np.cumsum(counts)
    avg_rank = (cum - (counts - 1) / 2.0)[inv]
    full_ranks = np.empty(len(order))
    full_ranks[order] = avg_rank
    r_pos = full_ranks[: len(pos)].sum()
    return float(
        (r_pos - len(pos) * (len(pos) + 1) / 2.0) / (len(pos) * len(neg))
    )


def find_optimal_threshold(
    y_true: np.ndarray,
    probs: np.ndarray,
    metric: str = "f1",
    thresholds: Optional[np.ndarray] = None,
) -> Tuple[float, Dict[str, float]]:
    """Fine 81-point sweep in [0.1, 0.9] (parity: metrics.py:113-163)."""
    if thresholds is None:
        thresholds = np.linspace(0.1, 0.9, 81)
    best_th, best_val, best_metrics = 0.5, -1.0, {}
    for th in thresholds:
        m = compute_binary_metrics(y_true, probs, float(th))
        if m[metric] > best_val:
            best_th, best_val, best_metrics = float(th), m[metric], m
    return best_th, best_metrics


def threshold_sweep(
    y_true: np.ndarray,
    probs: np.ndarray,
    start: float = 0.40,
    stop: float = 0.70,
    step: float = 0.05,
) -> List[Dict[str, float]]:
    """Coarse stage-1 calibration grid (parity:
    007_optimize_thresholds.py:154-166 — [0.4, 0.7] step 0.05)."""
    thresholds = np.arange(start, stop + step / 2, step)
    return [compute_binary_metrics(y_true, probs, float(t)) for t in thresholds]


def best_by(sweep: List[Dict[str, float]], keys=("f1", "precision", "recall", "accuracy")):
    """Best operating point per metric (parity: 007:169-244 summary)."""
    return {k: max(sweep, key=lambda m: m[k]) for k in keys}


def classification_report_text(
    metrics: Dict[str, object], digits: int = 4
) -> str:
    """Plain-text per-class table like sklearn's classification_report."""
    lines = [f"{'':<14}{'precision':>10}{'recall':>10}{'f1':>10}{'support':>10}"]
    for name, row in metrics["per_class"].items():
        lines.append(
            f"{name:<14}{row['precision']:>10.{digits}f}{row['recall']:>10.{digits}f}"
            f"{row['f1']:>10.{digits}f}{row['support']:>10d}"
        )
    lines.append("")
    lines.append(f"accuracy: {metrics['accuracy']:.{digits}f}")
    lines.append(f"macro f1: {metrics['macro_f1']:.{digits}f}")
    lines.append(f"weighted f1: {metrics['weighted_f1']:.{digits}f}")
    return "\n".join(lines)


def expected_calibration_error(
    labels: np.ndarray, probs: np.ndarray, bins: int = 15
) -> float:
    """Binary ECE: |accuracy - confidence| averaged over equal-width
    probability bins, weighted by bin mass (Guo et al. 2017)."""
    labels = np.asarray(labels).astype(np.float64)
    probs = np.asarray(probs, dtype=np.float64)
    edges = np.linspace(0.0, 1.0, bins + 1)
    which = np.clip(np.digitize(probs, edges[1:-1]), 0, bins - 1)
    ece = 0.0
    n = len(probs)
    for b in range(bins):
        mask = which == b
        if not mask.any():
            continue
        ece += mask.sum() / n * abs(labels[mask].mean() - probs[mask].mean())
    return float(ece)


def fit_temperature(
    logits: np.ndarray, labels: np.ndarray,
    grid=(0.05, 10.0, 200),
) -> float:
    """Fit a scalar temperature minimizing binary NLL on held-out logits.

    Coarse log-spaced grid then golden-section refinement: the NLL is
    smooth in log T. Returns T (divide logits by it)."""
    logits = np.asarray(logits, dtype=np.float64)
    labels = np.asarray(labels).astype(np.float64)

    def nll(temp: float) -> float:
        z = logits / temp
        # stable log-sigmoid formulation
        return float(np.mean(np.logaddexp(0.0, -z) + (1.0 - labels) * z))

    lo, hi, num = grid
    ts = np.geomspace(lo, hi, int(num))
    losses = [nll(t) for t in ts]
    i = int(np.argmin(losses))
    a = ts[max(i - 1, 0)]
    b = ts[min(i + 1, len(ts) - 1)]
    phi = (np.sqrt(5.0) - 1.0) / 2.0
    for _ in range(40):
        c = b - phi * (b - a)
        d = a + phi * (b - a)
        if nll(c) < nll(d):
            b = d
        else:
            a = c
    return float((a + b) / 2.0)


__all__ = [
    "best_by",
    "classification_report_text",
    "compute_binary_metrics",
    "compute_metrics",
    "confusion",
    "expected_calibration_error",
    "find_optimal_threshold",
    "fit_temperature",
    "roc_auc",
    "threshold_sweep",
]
