"""Accuracy metrics for composed partition trees.

The port's own copy of ``av1tpu.eval.tree_metrics`` (numpy only): scores
predicted ``(N, 85)`` trees (``eval.tree_infer``) against ground truth from
any oracle.

Scoring rules:
  * a ground-truth-REACHED node scores correct iff the predicted tree
    reaches it with the same mode — a node the prediction never reaches
    (an ancestor failed to predict SPLIT) is wrong, so cascade routing
    errors are charged to every node they orphan;
  * per-level accuracy conditions on ground-truth reach at that level;
  * ``exact_tree_match`` requires all 85 slots equal (structure AND modes);
  * ``structure_accuracy`` ignores modes: reached-set equality per tree.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np

from av1tpu_torch.codec.tree import LEVEL_OFFSETS, LEVEL_SIZES, NODES_PER_LEVEL


def tree_accuracy(pred_trees: np.ndarray, true_trees: np.ndarray) -> Dict:
    pred = np.asarray(pred_trees)
    true = np.asarray(true_trees)
    if pred.shape != true.shape:
        raise ValueError(f"shape mismatch: {pred.shape} vs {true.shape}")

    per_level: List[Dict] = []
    for size, nodes, off in zip(LEVEL_SIZES, NODES_PER_LEVEL, LEVEL_OFFSETS):
        t = true[:, off:off + nodes]
        p = pred[:, off:off + nodes]
        reached = t >= 0
        n_reached = int(reached.sum())
        correct = int(((p == t) & reached).sum())
        per_level.append({
            "block_size": size,
            "nodes_reached": n_reached,
            "node_accuracy": correct / n_reached if n_reached else 1.0,
        })

    reached_t = true >= 0
    reached_p = pred >= 0
    n_all = int(reached_t.sum())
    return {
        "per_level": per_level,
        "node_accuracy": (
            int(((pred == true) & reached_t).sum()) / n_all if n_all else 1.0
        ),
        "exact_tree_match": float((pred == true).all(axis=1).mean()),
        "structure_accuracy": float(
            (reached_p == reached_t).all(axis=1).mean()
        ),
        "trees": int(true.shape[0]),
    }


__all__ = ["tree_accuracy"]
