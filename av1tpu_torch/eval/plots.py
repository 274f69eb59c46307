"""Plotting: confusion heatmaps, PR curves, training curves.

Matplotlib equivalents of the reference's observability surface
(``pesquisa_v6/v6_pipeline/metrics.py:166-289`` — ``plot_confusion_matrix``,
``plot_precision_recall_curve``, ``MetricsTracker``'s 2x2 training-curve
figure). All functions render to files (headless Agg backend); none are on
the training hot path.

The port's own copy of ``av1tpu.eval.plots``, the same figures byte for byte.
matplotlib is imported inside each function, so that the CLIs that draw
these import where matplotlib is not installed (they skip the PNG there).
"""
from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Sequence

import numpy as np


def pyplot():
    """matplotlib's pyplot on the headless Agg backend; raises ImportError
    where matplotlib is not installed."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def plot_confusion_matrix(
    conf: np.ndarray,
    class_names: Sequence[str],
    path: Path,
    normalize: bool = True,
    title: str = "Confusion matrix",
) -> Path:
    plt = pyplot()
    conf = np.asarray(conf, dtype=np.float64)
    if normalize:
        conf = conf / np.maximum(conf.sum(axis=1, keepdims=True), 1)
    fig, ax = plt.subplots(figsize=(1.2 * len(class_names) + 2,) * 2)
    im = ax.imshow(conf, cmap="Blues", vmin=0)
    ax.set_xticks(range(len(class_names)), class_names, rotation=45, ha="right")
    ax.set_yticks(range(len(class_names)), class_names)
    ax.set_xlabel("Predicted")
    ax.set_ylabel("True")
    ax.set_title(title)
    for i in range(conf.shape[0]):
        for j in range(conf.shape[1]):
            ax.text(
                j, i, f"{conf[i, j]:.2f}" if normalize else f"{int(conf[i, j])}",
                ha="center", va="center",
                color="white" if conf[i, j] > conf.max() / 2 else "black",
                fontsize=8,
            )
    fig.colorbar(im, ax=ax, shrink=0.8)
    fig.tight_layout()
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    fig.savefig(path, dpi=120)
    plt.close(fig)
    return path


def plot_precision_recall_curve(
    y_true: np.ndarray, probs: np.ndarray, path: Path,
    title: str = "Precision-Recall",
) -> Path:
    plt = pyplot()
    y_true = np.asarray(y_true)
    probs = np.asarray(probs)
    order = np.argsort(-probs)
    y_sorted = y_true[order]
    tp = np.cumsum(y_sorted == 1)
    fp = np.cumsum(y_sorted == 0)
    total_pos = max(int((y_true == 1).sum()), 1)
    precision = tp / np.maximum(tp + fp, 1)
    recall = tp / total_pos

    fig, ax = plt.subplots(figsize=(6, 5))
    ax.plot(recall, precision)
    ax.set_xlabel("Recall")
    ax.set_ylabel("Precision")
    ax.set_title(title)
    ax.set_xlim(0, 1)
    ax.set_ylim(0, 1.05)
    ax.grid(alpha=0.3)
    fig.tight_layout()
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    fig.savefig(path, dpi=120)
    plt.close(fig)
    return path


def plot_training_curves(history: List[Dict], path: Path) -> Path:
    """2x2 loss/accuracy/F1/throughput curves from a train_stage history
    (parity with MetricsTracker.plot, metrics.py:256-289)."""
    plt = pyplot()
    epochs = [h["epoch"] for h in history]
    panels = [
        ("loss", [h["train_loss"] for h in history],
         [h["val_loss"] for h in history]),
        ("accuracy", [h["train_metrics"]["accuracy"] for h in history],
         [h["val_metrics"]["accuracy"] for h in history]),
        ("macro F1", [h["train_metrics"]["macro_f1"] for h in history],
         [h["val_metrics"]["macro_f1"] for h in history]),
        ("throughput (samples/s)", [h.get("throughput", 0) for h in history],
         None),
    ]
    fig, axes = plt.subplots(2, 2, figsize=(11, 8))
    for ax, (name, train_vals, val_vals) in zip(axes.flat, panels):
        ax.plot(epochs, train_vals, label="train")
        if val_vals is not None:
            ax.plot(epochs, val_vals, label="val")
        ax.set_title(name)
        ax.set_xlabel("epoch")
        ax.grid(alpha=0.3)
        ax.legend()
    fig.tight_layout()
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    fig.savefig(path, dpi=120)
    plt.close(fig)
    return path


def plot_block_grid(
    samples: np.ndarray,
    labels: np.ndarray,
    class_names: Dict[int, str],
    path: Path,
    per_class: int = 8,
    norm_max: float = 1023.0,
) -> Path:
    """Visual inspection grid: ``per_class`` example blocks per class
    (the capability of the reference's 006_visualize_blocks notebook)."""
    plt = pyplot()
    labels = np.asarray(labels)
    classes = [c for c in sorted(class_names) if (labels == c).any()]
    fig, axes = plt.subplots(
        len(classes), per_class,
        figsize=(1.2 * per_class, 1.4 * len(classes)),
        squeeze=False,
    )
    for row, cls in enumerate(classes):
        idx = np.flatnonzero(labels == cls)[:per_class]
        for col in range(per_class):
            ax = axes[row][col]
            ax.axis("off")
            if col < len(idx):
                img = np.asarray(samples[idx[col]])[..., 0]
                ax.imshow(img, cmap="gray", vmin=0, vmax=norm_max)
            if col == 0:
                ax.set_title(class_names[cls], fontsize=8, loc="left")
    fig.tight_layout()
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    fig.savefig(path, dpi=120)
    plt.close(fig)
    return path


__all__ = [
    "plot_block_grid",
    "plot_confusion_matrix",
    "plot_precision_recall_curve",
    "plot_training_curves",
]
