"""CLI: stage-2 confusion analysis on one device (PyTorch port).

    python -m av1tpu_torch.cli.analyze_confusion \
        --dataset-dir data/v6_dataset --block-size 16 \
        --stage2-checkpoint runs/stage2/stage2_best_variables.npz \
        --output-dir runs/analysis

Runs the stage-2 model over the validation samples that have a stage-2
label and writes ``stage2_confusion.json`` as ``av1tpu.cli.analyze_confusion``
does: the confusion matrix, its row-normalised form, the metrics, and the
misclassification profile that confusion-based noise injection reads.
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np
import torch

from av1tpu_torch.cli.common import load_model, load_split, model_outputs
from av1tpu_torch.codec.partitions import STAGE2_NAMES_V6
from av1tpu_torch.data.bundles import filter_stage2_v6
from av1tpu_torch.eval.metrics import compute_metrics, confusion
from av1tpu_torch.models import Stage2Model


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--dataset-dir", type=Path, required=True)
    parser.add_argument("--block-size", type=int, default=16)
    parser.add_argument("--stage2-checkpoint", type=Path, required=True)
    parser.add_argument("--output-dir", type=Path, required=True)
    parser.add_argument("--batch-size", type=int, default=4096)
    parser.add_argument("--bf16", action="store_true")
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                        help="cuda needs a GPU; nothing falls back to the CPU")
    args = parser.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        parser.error("--device cuda: no CUDA device is available")

    _, val_b, _ = load_split(args.dataset_dir, args.block_size)
    val_b = filter_stage2_v6(val_b)
    model = load_model(args.stage2_checkpoint, Stage2Model)
    dtype = torch.bfloat16 if args.bf16 else torch.float32
    preds = model_outputs(model, lambda m, x: torch.argmax(m(x), dim=-1),
                          val_b.samples, args.batch_size, args.device, dtype)
    preds = preds.astype(np.int64)

    labels = val_b.labels["stage2"]
    conf = confusion(labels, preds, 3)
    row_norm = conf / np.maximum(conf.sum(axis=1, keepdims=True), 1)
    metrics = compute_metrics(labels, preds, labels=list(STAGE2_NAMES_V6))

    out = Path(args.output_dir)
    out.mkdir(parents=True, exist_ok=True)
    payload = {
        "confusion_matrix": conf.tolist(),
        "confusion_row_normalized": row_norm.tolist(),
        "class_names": list(STAGE2_NAMES_V6),
        "metrics": metrics,
        # the probability table confusion-based noise injection reads
        "misclassification_profile": {
            STAGE2_NAMES_V6[i]: {
                STAGE2_NAMES_V6[j]: float(row_norm[i, j]) for j in range(3) if j != i
            }
            for i in range(3)
        },
    }
    (out / "stage2_confusion.json").write_text(json.dumps(payload, indent=2))
    print(json.dumps(payload["misclassification_profile"], indent=2))
    print(f"macro F1: {metrics['macro_f1']:.4f}")


if __name__ == "__main__":
    main()
