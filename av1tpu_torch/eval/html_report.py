"""The calibration-sweep reader of ``av1tpu.eval.html_report``.

``run_pipeline_eval --capacity auto`` and ``certify_serving`` size the gate
from the sweep that ``optimize_thresholds`` writes. The HTML report itself
is not ported yet (ROADMAP M12).
"""
from __future__ import annotations

import csv
import json
from pathlib import Path


def load_sweep(sweep_dir: Path):
    """Load optimize_thresholds artifacts (csv + summary json): the CSV's
    rows with numeric values as floats, and the summary (None if absent)."""
    sweep_dir = Path(sweep_dir)
    csv_path = (sweep_dir if sweep_dir.suffix == ".csv"
                else sweep_dir / "threshold_sweep.csv")

    def coerce(v):
        # a hand-edited sweep may hold non-numeric columns: pass them through
        try:
            return float(v)
        except (TypeError, ValueError):
            return v

    with csv_path.open() as f:
        rows = [{k: coerce(v) for k, v in row.items()} for row in csv.DictReader(f)]
    summary = None
    summary_path = csv_path.parent / "threshold_summary.json"
    if summary_path.exists():
        summary = json.loads(summary_path.read_text())
    return rows, summary


__all__ = ["load_sweep"]
