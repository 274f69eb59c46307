"""CLI: accuracy certification of the serving paths (PyTorch port).

Evaluates the same v6 checkpoints through every serving formulation the port
has (the plain nn.Module graph, BN-folded, capacity-gated over the folded
stages and, with ``--unified-checkpoint``, the unified family plain and
folded) on one dataset split, and writes the accuracy / agreement table of
``av1tpu.cli.certify_serving`` (``serving_certification.json`` and ``.md``).
The plain graph's row keeps the JAX package's name, ``flax``, so that both
packages write the same keys.

    python -m av1tpu_torch.cli.certify_serving --skip-int8 \
        --dataset-dir runs/scale_demo/v6_dataset --block-size 16 \
        --stage1-checkpoint .../stage1_best_variables.npz \
        --stage2-checkpoint .../stage2_best_variables.npz \
        --stage3-rect-checkpoint .../stage3_rect_best_variables.npz \
        --stage3-ab-checkpoint .../stage3_ab_fgvc_best_variables.npz \
        --calibration-dir runs/scale_demo/calibration \
        --output-dir runs/certify_serving --bf16

The int8 rows wait for ROADMAP M9: without ``--skip-int8`` the CLI exits.
Each timed pass follows one warm-up batch, which pays cuDNN's first calls.
"""
from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np
import torch

from av1tpu_torch.cli.common import add_not_ported_flags, load_model, load_split
from av1tpu_torch.codec.partitions import raw_to_v6_final
from av1tpu_torch.eval import (
    PipelineModels,
    auto_capacity,
    compute_metrics,
    make_unified_pipeline,
    make_unified_pipeline_folded,
    make_v6_pipeline,
    make_v6_pipeline_folded,
    make_v6_pipeline_gated,
    run_pipeline_batched,
)
from av1tpu_torch.eval.html_report import load_sweep
from av1tpu_torch.models import (
    FGVCModel,
    Stage1Model,
    Stage2Model,
    Stage3ABModel,
    Stage3RectModel,
    UnifiedV6Model,
)


def _evaluate(name, predict, samples, labels, batch_size, device, reference_final):
    # one warm-up batch, so that the timed pass excludes first-call costs
    run_pipeline_batched(predict, samples[:batch_size], batch_size, device)
    start = time.perf_counter()
    out = run_pipeline_batched(predict, samples, batch_size, device)
    seconds = time.perf_counter() - start
    final = np.asarray(out["final"])
    metrics = compute_metrics(labels, final)
    agreement = (
        float((final == reference_final).mean())
        if reference_final is not None else 1.0
    )
    row = {
        "variant": name,
        "accuracy": metrics["accuracy"],
        "macro_f1": metrics["macro_f1"],
        "agreement_vs_flax": agreement,
        "throughput_superblocks_per_sec": len(labels) / seconds,
    }
    print(json.dumps(row), flush=True)
    return row, final


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--dataset-dir", type=Path, required=True)
    parser.add_argument("--block-size", type=int, default=16)
    parser.add_argument("--split", choices=("train", "val"), default="val")
    parser.add_argument("--output-dir", type=Path, required=True)
    parser.add_argument("--batch-size", type=int, default=4096)
    parser.add_argument("--stage1-threshold", type=float, default=0.45)
    parser.add_argument("--bf16", action="store_true")
    parser.add_argument("--stage1-checkpoint", type=Path, required=True)
    parser.add_argument("--stage2-checkpoint", type=Path, required=True)
    parser.add_argument("--stage3-rect-checkpoint", type=Path, required=True)
    parser.add_argument("--stage3-ab-checkpoint", type=Path, required=True)
    parser.add_argument("--ab-fgvc", action="store_true", default=True)
    parser.add_argument("--no-ab-fgvc", dest="ab_fgvc", action="store_false")
    parser.add_argument("--calibration-dir", type=Path, default=None,
                        help="optimize_thresholds output; sizes the gated "
                        "row's capacity from the calibrated gate rate (else 0.5)")
    parser.add_argument("--capacity-margin", type=float, default=0.1)
    parser.add_argument("--skip-int8", action="store_true",
                        help="required until the int8 rows are ported (ROADMAP M9)")
    parser.add_argument("--single-device", action="store_true",
                        help="accepted for compatibility: one device is the "
                        "only mode until ROADMAP M11")
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                        help="cuda needs a GPU; nothing falls back to the CPU")
    parser.add_argument("--unified-checkpoint", type=Path, default=None,
                        help="UnifiedV6Model variables npz: adds the unified "
                        "family's rows (its plain graph, then its BN-folded "
                        "graph certified against it)")
    parser.add_argument("--unified-threshold", type=float, default=None,
                        help="stage-1 gate for the unified rows (default: "
                        "--stage1-threshold)")
    add_not_ported_flags(parser, {"--calib-samples": "M9"})
    args = parser.parse_args(argv)
    if not args.skip_int8:
        parser.error("the int8 rows are not ported yet (ROADMAP M9); pass --skip-int8")
    if args.device == "cuda" and not torch.cuda.is_available():
        parser.error("--device cuda: no CUDA device is available")
    device = torch.device(args.device)
    dtype = torch.bfloat16 if args.bf16 else torch.float32
    train_b, val_b, _ = load_split(args.dataset_dir, args.block_size)
    bundle = val_b if args.split == "val" else train_b

    models = PipelineModels(
        load_model(args.stage1_checkpoint, Stage1Model),
        load_model(args.stage2_checkpoint, Stage2Model),
        load_model(args.stage3_rect_checkpoint, Stage3RectModel),
        load_model(args.stage3_ab_checkpoint, FGVCModel if args.ab_fgvc else Stage3ABModel),
    )
    labels = raw_to_v6_final(bundle.labels["stage0"])
    samples = bundle.samples

    def evaluate(name, predict, reference_final):
        return _evaluate(name, predict, samples, labels, args.batch_size, device,
                         reference_final)

    threshold = args.stage1_threshold
    rows = []
    # the plain nn.Module graph: the semantics reference
    row, flax_final = evaluate("flax", make_v6_pipeline(
        models, stage1_threshold=threshold, input_dtype=dtype, device=device), None)
    rows.append(row)
    row, _ = evaluate("folded", make_v6_pipeline_folded(
        models, stage1_threshold=threshold, float_dtype=dtype, device=device),
        flax_final)
    rows.append(row)

    capacity = 0.5
    if args.calibration_dir is not None:
        sweep_rows, _ = load_sweep(args.calibration_dir)
        capacity = auto_capacity(sweep_rows, threshold, args.capacity_margin)
    row, _ = evaluate(f"gated(folded, capacity={capacity:.3f})", make_v6_pipeline_gated(
        models, capacity=capacity, stage1_threshold=threshold, input_dtype=dtype,
        folded=True, device=device), flax_final)
    rows.append(row)

    if args.unified_checkpoint is not None:
        unified = load_model(args.unified_checkpoint, UnifiedV6Model)
        uni_thr = (args.unified_threshold if args.unified_threshold is not None
                   else threshold)
        # agreement with the per-stage plain graph measures how far the two
        # families differ; the folded row below is the certification (same
        # weights, transformed graph)
        row, uni_final = evaluate("unified", make_unified_pipeline(
            unified, stage1_threshold=uni_thr, input_dtype=dtype, device=device),
            flax_final)
        row["agreement_reference"] = "cascade flax (family divergence)"
        rows.append(row)
        row, _ = evaluate("unified(folded)", make_unified_pipeline_folded(
            unified, stage1_threshold=uni_thr, float_dtype=dtype, device=device),
            uni_final)
        row["agreement_reference"] = "unified flax"
        rows.append(row)

    out = Path(args.output_dir)
    out.mkdir(parents=True, exist_ok=True)
    payload = {
        "split": args.split,
        "samples": int(len(labels)),
        "threshold": threshold,
        "block_size": args.block_size,
        "capacity": capacity,
        "rows": rows,
    }
    if args.unified_checkpoint is not None:
        payload["unified_threshold"] = uni_thr
    (out / "serving_certification.json").write_text(json.dumps(payload, indent=2))
    lines = [
        "| serving path | accuracy | macro F1 | agreement vs flax | superblocks/s |",
        "|---|---|---|---|---|",
    ]
    for r in rows:
        lines.append(
            f"| {r['variant']} | {r['accuracy']:.4f} | {r['macro_f1']:.4f} "
            f"| {r['agreement_vs_flax']:.4%} "
            f"| {r['throughput_superblocks_per_sec']:,.0f} |"
        )
    (out / "serving_certification.md").write_text("\n".join(lines) + "\n")
    print("\n".join(lines))


if __name__ == "__main__":
    main()
