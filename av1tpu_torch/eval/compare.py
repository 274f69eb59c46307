"""Side-by-side operating-point comparison for the v6 pipeline (numpy only;
the port's copy of ``av1tpu.eval.compare``).

The pipeline runs once: stage-2 and stage-3 predictions do not depend on the
stage-1 threshold, so any number of operating points recompose on the host
from the cached stage outputs, and the report compares accuracy, macro-F1
and per-class precision/recall/F1 between points, with deltas.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

from av1tpu_torch.eval.metrics import compute_metrics


def compose_final(outputs: Dict[str, np.ndarray], threshold: float) -> np.ndarray:
    """Recompose the 8-class final decision at a new stage-1 threshold from
    cached pipeline outputs (equal to running the pipeline at that threshold:
    routing does not depend on the gate)."""
    prob = np.asarray(outputs["stage1_prob"])
    s2 = np.asarray(outputs["stage2_pred"])
    rect = np.asarray(outputs["stage3_rect_pred"])
    ab = np.asarray(outputs["stage3_ab_pred"])
    routed = np.where(s2 == 0, 1, np.where(s2 == 1, rect + 2, ab + 4))
    return np.where(prob < threshold, 0, routed).astype(np.int64)


def compare_operating_points(
    outputs: Dict[str, np.ndarray],
    labels: np.ndarray,
    thresholds: Sequence[float],
    class_names: Sequence[str],
) -> Dict:
    """Metrics per threshold + per-class deltas vs the first threshold."""
    points: List[Dict] = []
    for th in thresholds:
        final = compose_final(outputs, th)
        m = compute_metrics(labels, final, labels=list(class_names))
        points.append({
            "threshold": float(th),
            "accuracy": m["accuracy"],
            "macro_f1": m["macro_f1"],
            "per_class": m["per_class"],
            "confusion_matrix": m["confusion_matrix"],
        })
    base = points[0]
    for p in points[1:]:
        p["delta_vs_first"] = {
            "accuracy": p["accuracy"] - base["accuracy"],
            "macro_f1": p["macro_f1"] - base["macro_f1"],
            "per_class_f1": {
                name: p["per_class"][name]["f1"] - base["per_class"][name]["f1"]
                for name in class_names
            },
        }
    return {"points": points, "class_names": list(class_names)}


def render_markdown(report: Dict) -> str:
    names = report["class_names"]
    points = report["points"]
    ths = [p["threshold"] for p in points]
    lines = [
        "# Operating-point comparison", "",
        "| metric | " + " | ".join(f"th={t:.2f}" for t in ths) + " |",
        "|---|" + "---|" * len(ths),
        "| accuracy | " + " | ".join(f"{p['accuracy']:.4f}" for p in points) + " |",
        "| macro F1 | " + " | ".join(f"{p['macro_f1']:.4f}" for p in points) + " |",
        "",
        "## Per-class F1 (precision / recall)", "",
        "| class | " + " | ".join(f"th={t:.2f}" for t in ths) + " |",
        "|---|" + "---|" * len(ths),
    ]
    for name in names:
        cells = []
        for p in points:
            c = p["per_class"][name]
            cells.append(f"{c['f1']:.3f} ({c['precision']:.3f} / {c['recall']:.3f})")
        lines.append(f"| {name} | " + " | ".join(cells) + " |")
    return "\n".join(lines) + "\n"


__all__ = ["compare_operating_points", "compose_final", "render_markdown"]
