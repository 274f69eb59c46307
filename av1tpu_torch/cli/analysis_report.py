"""CLI: one self-contained HTML report over evaluation + training artifacts.

The tool-ification of the reference's analysis notebooks
(``notebooks/pipeline_analysis.ipynb``, ``analise_block16_results.ipynb``,
``pipeline_analysis_threshold.ipynb``):

    python -m av1tpu_torch.cli.analysis_report \
        --eval-dir runs/pipeline --eval-dir frozen=runs/pipeline_frozen \
        --threshold-sweep runs/calib \
        --history stage1=runs/stage1/stage1_history.json \
        --output runs/report.html

``--eval-dir`` and ``--history`` accept ``name=path`` to label entries
(default: the directory/file stem). Everything is optional except at
least one input; the output embeds all images (shareable single file).
The port's own copy of ``av1tpu.cli.analysis_report``.
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

from av1tpu_torch.eval.html_report import build_report, load_eval_run, load_sweep


def _split_labeled(value: str, default_from):
    if "=" in value:
        name, _, path = value.partition("=")
        return name, Path(path)
    path = Path(value)
    return default_from(path), path


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--eval-dir", action="append", default=[],
                        help="run_pipeline_eval output dir (name=path ok); "
                        "repeatable for side-by-side comparison")
    parser.add_argument("--split", choices=("train", "val"), default="val")
    parser.add_argument("--threshold-sweep", type=Path, default=None,
                        help="optimize_thresholds output dir (or the csv)")
    parser.add_argument("--history", action="append", default=[],
                        help="trainer *_history.json (name=path ok); "
                        "repeatable")
    parser.add_argument("--history-metric", default="macro_f1",
                        help="val metric to plot from histories")
    parser.add_argument("--tree-accuracy", action="append", default=[],
                        help="tree_accuracy JSON (eval.tree_metrics; "
                        "name=path ok); repeatable — adds a composed "
                        "partition-tree section per entry")
    parser.add_argument("--title", default="av1tpu pipeline analysis")
    parser.add_argument("--output", type=Path, required=True)
    args = parser.parse_args(argv)

    if not (args.eval_dir or args.threshold_sweep or args.history
            or args.tree_accuracy):
        raise SystemExit(
            "nothing to report: pass --eval-dir / --threshold-sweep / "
            "--history / --tree-accuracy"
        )

    runs = []
    for entry in args.eval_dir:
        name, path = _split_labeled(entry, lambda p: p.name)
        runs.append(load_eval_run(path, args.split, name))

    sweep_rows = sweep_summary = None
    if args.threshold_sweep is not None:
        sweep_rows, sweep_summary = load_sweep(args.threshold_sweep)

    histories = {}
    for entry in args.history:
        name, path = _split_labeled(entry, lambda p: p.stem)
        histories[name] = json.loads(Path(path).read_text())

    tree_runs = {}
    for entry in args.tree_accuracy:
        name, path = _split_labeled(entry, lambda p: p.stem)
        payload = json.loads(Path(path).read_text())
        # accept both a bare tree_accuracy payload and a tree_demo
        # RESULTS.json that nests it
        tree_runs[name] = payload.get("tree_accuracy", payload)

    html_text = build_report(
        runs, sweep_rows, sweep_summary, histories,
        history_metric=args.history_metric, title=args.title,
        tree_runs=tree_runs,
    )
    args.output.parent.mkdir(parents=True, exist_ok=True)
    args.output.write_text(html_text)
    print(f"report: {args.output} ({len(html_text) / 1024:.0f} KiB)")


if __name__ == "__main__":
    main()
