"""Self-contained HTML analysis report — the reference notebooks as a tool.

The reference's result analysis lives in throwaway notebooks
(``notebooks/pipeline_analysis.ipynb``, ``analise_block16_results.ipynb``,
``pipeline_analysis_threshold.ipynb``) that re-load artifacts by hand.
This module renders the same analysis — headline metrics, per-class
drill-down, confusion heatmap, cascade error decomposition, stage-1
threshold sweep, training curves — into ONE self-contained ``report.html``
(images embedded base64, no external assets) from the artifacts the CLIs
already write:

* ``run_pipeline_eval`` output dirs (``pipeline_metrics_<split>.json`` +
  ``pipeline_confusion_<split>.png``) — several runs side by side;
* ``optimize_thresholds``'s ``threshold_sweep.csv`` + summary JSON;
* trainer ``*_history.json`` files.

Chart conventions: single-hue sequential for magnitude (the confusion
heatmap), the Okabe-Ito colorblind-safe palette in fixed order for the
few multi-series line charts, one y-axis per figure, recessive grids.

The port's own copy of ``av1tpu.eval.html_report``: the same HTML for the
same artifacts. matplotlib is imported inside the plotting functions, so
``load_sweep`` (which ``run_pipeline_eval --capacity auto`` and
``certify_serving`` read) imports where matplotlib is not installed.
"""
from __future__ import annotations

import base64
import csv
import html
import io
import json
from pathlib import Path
from typing import Dict, List, Mapping, Optional, Sequence

from av1tpu_torch.eval.plots import pyplot

# Okabe-Ito, fixed assignment order (colorblind-safe categorical set)
_SERIES = ("#0072B2", "#E69F00", "#009E73", "#CC79A7")
_INK = "#1a1a1a"
_GRID = dict(color="#dddddd", linewidth=0.6)


def _fig_b64(fig) -> str:
    buf = io.BytesIO()
    fig.savefig(buf, format="png", dpi=110, bbox_inches="tight")
    pyplot().close(fig)
    return base64.b64encode(buf.getvalue()).decode("ascii")


def _file_b64(path: Path) -> Optional[str]:
    path = Path(path)
    if not path.exists():
        return None
    return base64.b64encode(path.read_bytes()).decode("ascii")


def _img(b64: Optional[str], alt: str) -> str:
    if b64 is None:
        return f"<p class='muted'>({html.escape(alt)}: not available)</p>"
    return (
        f"<img alt='{html.escape(alt)}' "
        f"src='data:image/png;base64,{b64}' style='max-width:720px'>"
    )


def _style_axes(ax):
    ax.grid(True, axis="y", **_GRID)
    ax.set_axisbelow(True)
    for side in ("top", "right"):
        ax.spines[side].set_visible(False)
    for side in ("left", "bottom"):
        ax.spines[side].set_color("#999999")
    ax.tick_params(colors="#555555", labelcolor=_INK)


def plot_threshold_sweep(rows: Sequence[Mapping]) -> str:
    """F1 / precision / recall vs stage-1 threshold (+ calibrated F1 when
    present); the best-F1 operating point gets a direct label."""
    plt = pyplot()
    if not rows:
        raise ValueError(
            "threshold sweep has no data rows — re-run optimize_thresholds "
            "or point --sweep at its output directory"
        )
    thr = [float(r["threshold"]) for r in rows]
    fig, ax = plt.subplots(figsize=(6.4, 3.6))
    series = [("f1", "F1"), ("precision", "precision"), ("recall", "recall")]
    if rows and "f1_calibrated" in rows[0]:
        series.append(("f1_calibrated", "F1 (calibrated)"))
    for (key, label), color in zip(series, _SERIES):
        vals = [float(r[key]) for r in rows]
        ax.plot(thr, vals, color=color, linewidth=2, label=label)
    best_i = max(range(len(rows)), key=lambda i: float(rows[i]["f1"]))
    ax.scatter([thr[best_i]], [float(rows[best_i]["f1"])],
               s=36, color=_SERIES[0], zorder=5)
    ax.annotate(
        f"best F1 {float(rows[best_i]['f1']):.3f} @ {thr[best_i]:.2f}",
        (thr[best_i], float(rows[best_i]["f1"])),
        textcoords="offset points", xytext=(8, 8), color=_INK, fontsize=9,
    )
    ax.set_xlabel("stage-1 threshold")
    ax.set_ylabel("metric")
    ax.legend(frameon=False, fontsize=9)
    _style_axes(ax)
    return _fig_b64(fig)


def plot_cascade(cascade: Mapping) -> str:
    """Error-attribution bar: where the pipeline's errors come from."""
    plt = pyplot()
    frac = cascade["error_attribution_fractions"]
    order = [
        "correct", "stage1_false_negative", "stage1_false_positive",
        "stage2_misroute", "stage3_refinement", "other",
    ]
    keys = [k for k in order if k in frac]
    vals = [100.0 * float(frac[k]) for k in keys]
    fig, ax = plt.subplots(figsize=(6.4, 0.5 * len(keys) + 1.2))
    ypos = range(len(keys))[::-1]
    ax.barh(list(ypos), vals, color="#0072B2", height=0.62)
    ax.set_yticks(list(ypos), [k.replace("_", " ") for k in keys])
    for y, v in zip(ypos, vals):
        ax.text(v + 0.6, y, f"{v:.1f}%", va="center",
                color=_INK, fontsize=9)
    ax.set_xlabel("% of samples")
    ax.set_xlim(0, max(vals) * 1.18 + 1)
    ax.grid(True, axis="x", **_GRID)
    ax.set_axisbelow(True)
    for side in ("top", "right", "left"):
        ax.spines[side].set_visible(False)
    return _fig_b64(fig)


def plot_tree_accuracy(tree_acc: Mapping) -> str:
    """Per-level node accuracy of a composed partition-tree run
    (``eval.tree_metrics.tree_accuracy`` JSON)."""
    plt = pyplot()
    levels = list(tree_acc.get("per_level", []))
    if not levels:
        raise ValueError("tree accuracy payload has no per_level entries")
    labels = [f"{lv['block_size']}px" for lv in levels]
    vals = [100.0 * float(lv["node_accuracy"]) for lv in levels]
    overall = 100.0 * float(tree_acc["node_accuracy"])
    fig, ax = plt.subplots(figsize=(6.0, 3.0))
    ax.bar(range(len(vals)), vals, color="#0072B2", width=0.62)
    ax.axhline(overall, color=_INK, linewidth=1, linestyle="--")
    ax.text(len(vals) - 0.45, overall + 1.0, f"overall {overall:.1f}%",
            fontsize=9, color=_INK, ha="right")
    ax.set_xticks(range(len(vals)), labels)
    # Headroom above the tallest bar so value labels (placed at v + 1) and
    # the overall annotation never clip against the axis limit when node
    # accuracies approach 100%.
    ylim = min(104.0, max(max(vals), overall) * 1.18 + 2)
    for x, v in enumerate(vals):
        if v + 3.0 > ylim:  # label would clip: draw it inside the bar
            ax.text(x, v - 1.0, f"{v:.1f}%", ha="center", va="top",
                    color="white", fontsize=9)
        else:
            ax.text(x, v + 1.0, f"{v:.1f}%", ha="center", color=_INK,
                    fontsize=9)
    ax.set_ylabel("node accuracy (%)")
    ax.set_ylim(0, ylim)
    ax.grid(True, axis="y", **_GRID)
    ax.set_axisbelow(True)
    for side in ("top", "right"):
        ax.spines[side].set_visible(False)
    return _fig_b64(fig)


def plot_history(history: Sequence[Mapping], metric: str) -> str:
    """Train/val loss and the tracked val metric per epoch (two panels,
    one y-axis each — never a dual axis). Tolerates histories without a
    val_loss series (the FGVC trainer records train loss only)."""
    plt = pyplot()
    epochs = [int(r["epoch"]) for r in history]
    fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(8.8, 3.2))
    ax1.plot(epochs, [float(r["train_loss"]) for r in history],
             color=_SERIES[0], linewidth=2, label="train")
    if history and "val_loss" in history[0]:
        ax1.plot(epochs, [float(r["val_loss"]) for r in history],
                 color=_SERIES[1], linewidth=2, label="val")
    ax1.set_xlabel("epoch")
    ax1.set_ylabel("loss")
    ax1.legend(frameon=False, fontsize=9)
    _style_axes(ax1)
    vals = [float(r["val_metrics"].get(metric, float("nan")))
            for r in history]
    ax2.plot(epochs, vals, color=_SERIES[2], linewidth=2)
    ax2.set_xlabel("epoch")
    ax2.set_ylabel(f"val {metric}")
    _style_axes(ax2)
    fig.tight_layout()
    return _fig_b64(fig)


def _metrics_table(runs: List[Dict]) -> str:
    cols = ["run", "split", "accuracy", "macro_f1", "weighted_f1",
            "stage1_f1", "samples", "throughput (sb/s)"]
    body = []
    for r in runs:
        p = r["payload"]
        m = p["metrics"]
        body.append(
            "<tr>"
            f"<td>{html.escape(r['name'])}</td>"
            f"<td>{html.escape(str(p.get('split', '')))}</td>"
            f"<td>{m['accuracy']:.4f}</td>"
            f"<td>{m['macro_f1']:.4f}</td>"
            f"<td>{m.get('weighted_f1', float('nan')):.4f}</td>"
            f"<td>{p.get('stage1', {}).get('f1', float('nan')):.4f}</td>"
            f"<td>{p.get('samples', '')}</td>"
            f"<td>{p.get('throughput_superblocks_per_sec', 0):,.0f}</td>"
            "</tr>"
        )
    head = "".join(f"<th>{c}</th>" for c in cols)
    return f"<table><tr>{head}</tr>{''.join(body)}</table>"


def _per_class_table(metrics: Mapping) -> str:
    rows = []
    for name, d in metrics["per_class"].items():
        rows.append(
            "<tr>"
            f"<td>{html.escape(name)}</td>"
            f"<td>{d['precision']:.4f}</td><td>{d['recall']:.4f}</td>"
            f"<td>{d['f1']:.4f}</td><td>{d['support']}</td></tr>"
        )
    return (
        "<table><tr><th>class</th><th>precision</th><th>recall</th>"
        "<th>F1</th><th>support</th></tr>" + "".join(rows) + "</table>"
    )


_CSS = """
body { font-family: system-ui, sans-serif; color: #1a1a1a; margin: 2em auto;
       max-width: 880px; line-height: 1.45; }
h1 { font-size: 1.5em; } h2 { font-size: 1.2em; margin-top: 1.6em; }
table { border-collapse: collapse; margin: 0.8em 0; font-size: 0.92em;
        font-variant-numeric: tabular-nums; }
th, td { border: 1px solid #ddd; padding: 4px 10px; text-align: right; }
th { background: #f5f5f5; } td:first-child, th:first-child { text-align: left; }
.muted { color: #777; }
"""


def build_report(
    eval_runs: Sequence[Dict],
    sweep_rows: Optional[Sequence[Mapping]] = None,
    sweep_summary: Optional[Mapping] = None,
    histories: Optional[Dict[str, Sequence[Mapping]]] = None,
    history_metric: str = "macro_f1",
    title: str = "av1tpu pipeline analysis",
    tree_runs: Optional[Dict[str, Mapping]] = None,
) -> str:
    """Assemble the HTML. ``eval_runs``: list of dicts with keys ``name``,
    ``payload`` (pipeline_metrics JSON) and optional ``confusion_png``.
    ``tree_runs``: name -> ``tree_metrics.tree_accuracy`` payloads for
    composed partition-tree sections."""
    parts = [
        "<!doctype html><html><head><meta charset='utf-8'>",
        f"<title>{html.escape(title)}</title><style>{_CSS}</style></head>",
        f"<body><h1>{html.escape(title)}</h1>",
    ]
    if eval_runs:
        parts.append("<h2>Pipeline runs</h2>")
        parts.append(_metrics_table(list(eval_runs)))
        for r in eval_runs:
            parts.append(f"<h2>{html.escape(r['name'])}: per-class</h2>")
            parts.append(_per_class_table(r["payload"]["metrics"]))
            png = r.get("confusion_png")
            if png is not None:
                parts.append(_img(_file_b64(png),
                                  f"{r['name']} confusion matrix"))
            cascade = r["payload"].get("cascade")
            if cascade:
                parts.append(
                    f"<h2>{html.escape(r['name'])}: cascade error "
                    "attribution</h2>"
                )
                parts.append(_img(plot_cascade(cascade),
                                  "cascade error attribution"))
                cond = cascade.get("conditional", {})
                if cond:
                    rows = "".join(
                        f"<tr><td>{html.escape(k.replace('_', ' '))}</td>"
                        f"<td>{float(v):.4f}</td></tr>"
                        for k, v in cond.items()
                    )
                    parts.append(
                        "<table><tr><th>conditional metric</th><th>value"
                        f"</th></tr>{rows}</table>"
                    )
    if sweep_rows:
        parts.append("<h2>Stage-1 threshold sweep</h2>")
        parts.append(_img(plot_threshold_sweep(list(sweep_rows)),
                          "threshold sweep"))
        if sweep_summary and "calibration" in sweep_summary:
            cal = sweep_summary["calibration"]
            parts.append(
                "<p>Temperature calibration (Guo 2017): "
                f"T={cal['temperature']:.3f}, "
                f"ECE {cal['ece_raw']:.4f} &rarr; "
                f"{cal['ece_calibrated']:.4f}</p>"
            )
    for name, tree_acc in (tree_runs or {}).items():
        parts.append(f"<h2>Partition trees: {html.escape(name)}</h2>")
        parts.append(_img(plot_tree_accuracy(tree_acc),
                          f"{name} per-level node accuracy"))
        summary_rows = [
            ("trees scored", f"{int(tree_acc.get('trees', 0)):,}"),
            ("overall node accuracy",
             f"{float(tree_acc['node_accuracy']):.4f}"),
            ("exact-tree match (85 slots)",
             f"{float(tree_acc['exact_tree_match']):.4f}"),
            ("structure accuracy",
             f"{float(tree_acc['structure_accuracy']):.4f}"),
        ]
        rows = "".join(
            f"<tr><td>{html.escape(k)}</td><td>{v}</td></tr>"
            for k, v in summary_rows
        )
        parts.append(
            f"<table><tr><th>metric</th><th>value</th></tr>{rows}</table>"
        )
    for name, history in (histories or {}).items():
        parts.append(f"<h2>Training: {html.escape(name)}</h2>")
        parts.append(_img(plot_history(history, history_metric),
                          f"{name} training curves"))
    parts.append("</body></html>")
    return "".join(parts)


def load_eval_run(eval_dir: Path, split: str, name: Optional[str] = None
                  ) -> Dict:
    """Load one run_pipeline_eval output directory into a report entry."""
    eval_dir = Path(eval_dir)
    payload = json.loads(
        (eval_dir / f"pipeline_metrics_{split}.json").read_text()
    )
    png = eval_dir / f"pipeline_confusion_{split}.png"
    return {
        "name": name or eval_dir.name,
        "payload": payload,
        "confusion_png": png if png.exists() else None,
    }


def load_sweep(sweep_dir: Path):
    """Load optimize_thresholds artifacts (csv + summary json)."""
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
        rows = [
            {k: coerce(v) for k, v in row.items()}
            for row in csv.DictReader(f)
        ]
    summary = None
    summary_path = csv_path.parent / "threshold_summary.json"
    if summary_path.exists():
        summary = json.loads(summary_path.read_text())
    return rows, summary


__all__ = [
    "build_report",
    "load_eval_run",
    "load_sweep",
    "plot_cascade",
    "plot_history",
    "plot_threshold_sweep",
]
