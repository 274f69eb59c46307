"""CLI: accuracy certification of the serving paths (PyTorch port).

Evaluates the same v6 checkpoints through every serving formulation (the
plain nn.Module graph, BN-folded, int8, capacity-gated over the folded
stages and, with ``--unified-checkpoint``, the unified family plain, folded
and int8) on one dataset split, and writes the accuracy / agreement table of
``av1tpu.cli.certify_serving`` (``serving_certification.json`` and ``.md``).
The plain graph's row keeps the JAX package's name, ``flax``, so that both
packages write the same keys. The int8 rows calibrate on a seeded subsample
of ``--calib-samples`` train blocks, as the JAX CLI does; ``--skip-int8``
leaves them out.

    python -m av1tpu_torch.cli.certify_serving \
        --dataset-dir runs/scale_demo/v6_dataset --block-size 16 \
        --stage1-checkpoint .../stage1_best_variables.npz \
        --stage2-checkpoint .../stage2_best_variables.npz \
        --stage3-rect-checkpoint .../stage3_rect_best_variables.npz \
        --stage3-ab-checkpoint .../stage3_ab_fgvc_best_variables.npz \
        --calibration-dir runs/scale_demo/calibration \
        --output-dir runs/certify_serving --bf16

Each timed pass follows one warm-up batch, which pays cuDNN's first calls.
"""
from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np
import torch

from av1tpu_torch.cli.common import (
    add_single_device_arg,
    cli_log,
    load_model,
    load_split,
    serving_mesh,
    train_calibration_blocks,
)
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
from av1tpu_torch.parallel.mesh import is_writer
from av1tpu_torch.quant import make_unified_pipeline_int8, make_v6_pipeline_int8


def _evaluate(name, predict, samples, labels, batch_size, device, reference_final,
              mesh=None):
    # one warm-up batch, so that the timed pass excludes first-call costs
    run_pipeline_batched(predict, samples[:batch_size], batch_size, device, mesh=mesh)
    start = time.perf_counter()
    out = run_pipeline_batched(predict, samples, batch_size, device, mesh=mesh)
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
    cli_log(json.dumps(row))
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
    parser.add_argument("--skip-int8", action="store_true")
    parser.add_argument("--calib-samples", type=int, default=512)
    add_single_device_arg(parser)
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                        help="cuda needs a GPU; nothing falls back to the CPU")
    parser.add_argument("--unified-checkpoint", type=Path, default=None,
                        help="UnifiedV6Model variables npz: adds the unified "
                        "family's rows (its plain graph, then its BN-folded "
                        "graph certified against it)")
    parser.add_argument("--unified-threshold", type=float, default=None,
                        help="stage-1 gate for the unified rows (default: "
                        "--stage1-threshold)")
    args = parser.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        parser.error("--device cuda: no CUDA device is available")
    device = torch.device(args.device)
    mesh = serving_mesh(args)
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
                         reference_final, mesh)

    threshold = args.stage1_threshold
    rows = []
    # the plain nn.Module graph: the semantics reference
    row, flax_final = evaluate("flax", make_v6_pipeline(
        models, stage1_threshold=threshold, input_dtype=dtype, device=device, mesh=mesh), None)
    rows.append(row)
    row, _ = evaluate("folded", make_v6_pipeline_folded(
        models, stage1_threshold=threshold, float_dtype=dtype, device=device, mesh=mesh),
        flax_final)
    rows.append(row)
    calib = None if args.skip_int8 else train_calibration_blocks(train_b.samples,
                                                                 args.calib_samples)
    if calib is not None:
        row, _ = evaluate("int8", make_v6_pipeline_int8(
            models, calib, stage1_threshold=threshold, float_dtype=dtype, device=device, mesh=mesh),
            flax_final)
        rows.append(row)

    capacity = 0.5
    if args.calibration_dir is not None:
        sweep_rows, _ = load_sweep(args.calibration_dir)
        capacity = auto_capacity(sweep_rows, threshold, args.capacity_margin)
    row, _ = evaluate(f"gated(folded, capacity={capacity:.3f})", make_v6_pipeline_gated(
        models, capacity=capacity, stage1_threshold=threshold, input_dtype=dtype,
        folded=True, device=device, mesh=mesh), flax_final)
    rows.append(row)

    if args.unified_checkpoint is not None:
        unified = load_model(args.unified_checkpoint, UnifiedV6Model)
        uni_thr = (args.unified_threshold if args.unified_threshold is not None
                   else threshold)
        # agreement with the per-stage plain graph measures how far the two
        # families differ; the folded row below is the certification (same
        # weights, transformed graph)
        row, uni_final = evaluate("unified", make_unified_pipeline(
            unified, stage1_threshold=uni_thr, input_dtype=dtype, device=device, mesh=mesh),
            flax_final)
        row["agreement_reference"] = "cascade flax (family divergence)"
        rows.append(row)
        row, _ = evaluate("unified(folded)", make_unified_pipeline_folded(
            unified, stage1_threshold=uni_thr, float_dtype=dtype, device=device, mesh=mesh),
            uni_final)
        row["agreement_reference"] = "unified flax"
        rows.append(row)
        if calib is not None:
            row, _ = evaluate("unified(int8)", make_unified_pipeline_int8(
                unified, calib, stage1_threshold=uni_thr, float_dtype=dtype,
                device=device, mesh=mesh), uni_final)
            row["agreement_reference"] = "unified flax"
            rows.append(row)

    if not is_writer():
        return
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
