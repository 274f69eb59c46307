"""Evaluation artifact writers: JSON metrics, CSV predictions, NPZ arrays,
text report. Copied from ``av1tpu.eval.report`` (whose package imports
jax), so both CLIs write the same files."""
from __future__ import annotations

import csv
import json
from pathlib import Path
from typing import Dict, Mapping, Optional, Sequence

import numpy as np

from av1tpu_torch.eval.metrics import classification_report_text


def write_metrics_json(path: Path, payload: Mapping) -> Path:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(payload, indent=2, default=_jsonable))
    return path


def write_predictions_npz(
    path: Path, predictions: np.ndarray, labels: np.ndarray,
    class_names: Sequence[str], **extra,
) -> Path:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez(
        path, predictions=predictions, labels=labels,
        class_names=np.asarray(class_names), **extra,
    )
    return path


def write_predictions_csv(
    path: Path, rows: Sequence[Mapping[str, object]]
) -> Optional[Path]:
    if not rows:
        return None
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with path.open("w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=list(rows[0].keys()))
        writer.writeheader()
        writer.writerows(rows)
    return path


def write_text_report(
    path: Path, title: str, metrics: Dict, extra_lines: Sequence[str] = ()
) -> Path:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    lines = [title, "=" * 70, ""]
    lines.extend(extra_lines)
    lines.append("")
    lines.append(classification_report_text(metrics))
    path.write_text("\n".join(lines) + "\n")
    return path


def _jsonable(obj):
    if isinstance(obj, (np.integer,)):
        return int(obj)
    if isinstance(obj, (np.floating,)):
        return float(obj)
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    return str(obj)


__all__ = [
    "write_metrics_json",
    "write_predictions_csv",
    "write_predictions_npz",
    "write_text_report",
]
