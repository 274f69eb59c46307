"""CLI: stage-1 threshold calibration on one device (PyTorch port).

    python -m av1tpu_torch.cli.optimize_thresholds \
        --dataset-dir data/v6_dataset --block-size 16 \
        --stage1-checkpoint runs/stage1/stage1_best_variables.npz \
        --output-dir runs/calibration

Runs the stage-1 model (or a unified model's stage-1 column) over the
validation split on the card, sweeps the [0.4, 0.7] grid (step 0.05) of the
sigmoid probabilities, and writes what ``av1tpu.cli.optimize_thresholds``
writes: ``threshold_sweep.csv`` (one row of binary metrics per threshold,
with the gate's pass rate that ``run_pipeline_eval --capacity auto`` reads),
``threshold_summary.json`` (the best row per metric and a ``calibration``
block: the temperature fitted by validation NLL and the ECE before and
after it), and the checkpoint with that temperature written into
``params/temperature``.
"""
from __future__ import annotations

import argparse
import csv
import json
from pathlib import Path

import numpy as np
import torch

from av1tpu_torch.cli.common import load_model_variables, load_split, model_outputs
from av1tpu_torch.eval.metrics import (
    best_by,
    expected_calibration_error,
    fit_temperature,
    threshold_sweep,
)
from av1tpu_torch.models import Stage1Model, UnifiedV6Model, load_jax_variables
from av1tpu_torch.train.checkpoint import save_variables_npz


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--dataset-dir", type=Path, required=True)
    parser.add_argument("--block-size", type=int, default=16)
    parser.add_argument("--stage1-checkpoint", type=Path)
    parser.add_argument("--unified-checkpoint", type=Path,
                        help="calibrate a UnifiedV6Model checkpoint's stage-1 "
                        "head instead; writes unified_calibrated_variables.npz")
    parser.add_argument("--output-dir", type=Path, required=True)
    parser.add_argument("--batch-size", type=int, default=4096)
    parser.add_argument("--grid", type=float, nargs=3, default=(0.40, 0.70, 0.05),
                        metavar=("START", "STOP", "STEP"))
    parser.add_argument("--bf16", action="store_true")
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                        help="cuda needs a GPU; nothing falls back to the CPU")
    args = parser.parse_args(argv)
    if (args.stage1_checkpoint is None) == (args.unified_checkpoint is None):
        parser.error("exactly one of --stage1-checkpoint / --unified-checkpoint")
    if args.device == "cuda" and not torch.cuda.is_available():
        parser.error("--device cuda: no CUDA device is available")

    _, val_b, _ = load_split(args.dataset_dir, args.block_size)
    dtype = torch.bfloat16 if args.bf16 else torch.float32
    if args.unified_checkpoint is not None:
        variables = load_model_variables(args.unified_checkpoint)
        model = load_jax_variables(UnifiedV6Model(), variables)
        ckpt_name = "unified_calibrated_variables.npz"

        def stage1_logits(m, x):  # the stage-1 column of the packed logits
            return m(x)[:, 0].float()
    else:
        variables = load_model_variables(args.stage1_checkpoint)
        model = load_jax_variables(Stage1Model(), variables)
        ckpt_name = "stage1_calibrated_variables.npz"

        def stage1_logits(m, x):
            return m(x).float()

    logits = model_outputs(model, stage1_logits, val_b.samples, args.batch_size,
                           args.device, dtype)
    labels = val_b.labels["stage1"]
    probs = 1.0 / (1.0 + np.exp(-logits))

    # temperature calibration (Guo 2017): fit T by val NLL, compare ECE
    temperature = fit_temperature(logits, labels)
    probs_cal = 1.0 / (1.0 + np.exp(-logits / temperature))
    ece_raw = expected_calibration_error(labels, probs)
    ece_cal = expected_calibration_error(labels, probs_cal)

    sweep = threshold_sweep(labels, probs, *args.grid)
    sweep_cal = threshold_sweep(labels, probs_cal, *args.grid)
    for row, row_cal in zip(sweep, sweep_cal):
        row["f1_calibrated"] = row_cal["f1"]
        row["accuracy_calibrated"] = row_cal["accuracy"]
    summary = best_by(sweep)
    summary["calibration"] = {
        "temperature": temperature,
        "ece_raw": ece_raw,
        "ece_calibrated": ece_cal,
        "best_f1_calibrated": max(r["f1_calibrated"] for r in sweep),
    }

    out = Path(args.output_dir)
    out.mkdir(parents=True, exist_ok=True)
    with (out / "threshold_sweep.csv").open("w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=list(sweep[0].keys()))
        writer.writeheader()
        writer.writerows(sweep)
    (out / "threshold_summary.json").write_text(json.dumps(summary, indent=2))

    # the checkpoint with the fitted temperature in the model's temperature
    # parameter (read by a forward with apply_temp=True)
    calibrated = dict(variables)
    calibrated["params"] = dict(calibrated["params"])
    calibrated["params"]["temperature"] = np.asarray([temperature], np.float32)
    save_variables_npz(out / ckpt_name, calibrated)

    print(json.dumps(summary["f1"], indent=2))
    print(f"best-by-f1 threshold: {summary['f1']['threshold']:.2f}")
    print(f"temperature: {temperature:.3f} (ECE {ece_raw:.4f} -> {ece_cal:.4f})")


if __name__ == "__main__":
    main()
