"""CLI: end-to-end v6 pipeline evaluation on one device (PyTorch port).

    python -m av1tpu_torch.cli.run_pipeline_eval --variant v6 --folded \
        --fused-front on --bf16 \
        --dataset-dir data/v6_dataset --block-size 16 \
        --stage1-checkpoint runs/stage1/stage1_best_variables.npz \
        --stage2-checkpoint runs/stage2/stage2_best_variables.npz \
        --stage3-rect-checkpoint runs/rect/stage3_rect_best_variables.npz \
        --stage3-ab-checkpoint runs/ab/stage3_ab_fgvc_best_variables.npz \
        --output-dir runs/pipeline_eval

Writes the files of ``av1tpu.cli.run_pipeline_eval`` (metrics JSON,
predictions npz, optional CSV, text report) except the confusion PNG.
``--variant unified --unified-checkpoint ...`` serves the single-trunk
family; ``--tta``, ``--stage3-ab-ensemble-dir`` and ``--capacity`` (a float
or ``auto`` with ``--calibration-dir``) select the plain graph's options and
the capacity-gated pipeline as in the JAX CLI. ``--fused-front`` passes
``use_fused_front`` (off/on/g1) to the folded pipeline, per-stage or unified;
the gated pipeline has no fused front. Flags and variants not ported yet exit
with the ROADMAP item that will bring them.
"""
from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np
import torch

from av1tpu_torch.codec.partitions import V6_EVAL_CLASS_NAMES, raw_to_v6_final
from av1tpu_torch.cli.common import add_not_ported_flags, load_model, load_split
from av1tpu_torch.eval import (
    PipelineModels,
    auto_capacity,
    compute_binary_metrics,
    compute_metrics,
    decompose_v6,
    load_ensemble,
    make_unified_pipeline,
    make_unified_pipeline_folded,
    make_v6_pipeline,
    make_v6_pipeline_folded,
    make_v6_pipeline_gated,
    run_pipeline_batched,
    write_metrics_json,
    write_predictions_csv,
    write_predictions_npz,
    write_text_report,
)
from av1tpu_torch.eval.html_report import load_sweep
from av1tpu_torch.models import (
    FGVCModel,
    Stage1Model,
    Stage2Model,
    Stage3ABModel,
    Stage3RectModel,
    UnifiedV6Model,
    load_jax_variables,
)

# flag -> ROADMAP item that ports it
NOT_PORTED = {
    "--flatten-checkpoint": "M8", "--v5-checkpoint": "M8",
    "--available-specialists": "M8",
    "--int8": "M9", "--calib-samples": "M9",
}
VARIANTS_NOT_PORTED = {"v5": "M8", "flatten": "M8"}
FUSED_FRONT = {"off": False, "on": True, "g1": "g1"}
CAPACITY_ERROR = "--capacity must be a float in (0, 1] or 'auto'"


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--variant", default="v6",
                        choices=("v6", "unified", *VARIANTS_NOT_PORTED))
    parser.add_argument("--dataset-dir", type=Path, required=True)
    parser.add_argument("--block-size", type=int, default=16)
    parser.add_argument("--split", choices=("train", "val"), default="val")
    parser.add_argument("--output-dir", type=Path, required=True)
    parser.add_argument("--batch-size", type=int, default=4096)
    parser.add_argument("--stage1-threshold", type=float, default=0.45)
    parser.add_argument("--bf16", action="store_true")
    parser.add_argument("--csv", action="store_true",
                        help="also write per-sample CSV records")
    parser.add_argument("--stage1-checkpoint", type=Path)
    parser.add_argument("--stage2-checkpoint", type=Path)
    parser.add_argument("--stage3-rect-checkpoint", type=Path)
    parser.add_argument("--stage3-ab-checkpoint", type=Path)
    parser.add_argument("--ab-fgvc", action="store_true", default=True)
    parser.add_argument("--no-ab-fgvc", dest="ab_fgvc", action="store_false")
    parser.add_argument("--stage3-ab-ensemble-dir", type=Path, default=None,
                        help="directory from eval.ensemble.save_ensemble: "
                        "soft-vote the AB stage over its members (then "
                        "--stage3-ab-checkpoint is not needed)")
    parser.add_argument("--tta", action="store_true",
                        help="average each stage over 4 TTA views")
    parser.add_argument("--tta-align-ab", action=argparse.BooleanOptionalAction,
                        default=None,
                        help="with --tta: remap each flipped view's AB logits "
                        "through the training swap tables before averaging; "
                        "on by default with --tta, --no-tta-align-ab takes "
                        "the plain mean")
    parser.add_argument("--capacity", type=str, default=None,
                        help="v6 only: capacity-gated inference, stages 2 and 3 "
                        "on this fraction of each batch (top-K by gate "
                        "probability); equal to dense while it covers the "
                        "gate's pass rate. 'auto' sizes it from the "
                        "calibrated gate rate (--calibration-dir) plus "
                        "--capacity-margin. Not with --tta, ensembles or a "
                        "fused front")
    parser.add_argument("--calibration-dir", type=Path, default=None,
                        help="optimize_thresholds output dir supplying the "
                        "measured gate rate for --capacity auto")
    parser.add_argument("--capacity-margin", type=float, default=0.1,
                        help="headroom over the calibrated gate rate for "
                        "--capacity auto (default 0.1)")
    parser.add_argument("--unified-checkpoint", type=Path,
                        help="UnifiedV6Model variables npz: --variant unified "
                        "serves the whole hierarchy from one backbone "
                        "(--folded and --tta supported)")
    parser.add_argument("--folded", action="store_true",
                        help="BN-folded serving path (eval.folded, eval.unified)")
    parser.add_argument("--reference-compat-labels", action="store_true",
                        help="reproduce the reference's misaligned raw-vs-"
                        "reordered label comparison (quirk Q7)")
    parser.add_argument("--single-device", action="store_true",
                        help="accepted for compatibility: one device is the "
                        "only mode until ROADMAP M11")
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                        help="cuda needs a GPU; nothing falls back to the CPU")
    parser.add_argument("--fused-front", choices=tuple(FUSED_FRONT),
                        default="off",
                        help="with --folded: stem+maxpool as kernel K1 (on) "
                        "or stem+maxpool+layer group 1+SE1 as kernel K2 (g1), "
                        "per-stage or unified")
    add_not_ported_flags(parser, NOT_PORTED)
    return parser


def build_v6(args, dtype, device):
    ab_ensemble = None
    if args.stage3_ab_ensemble_dir is not None:
        ab_ensemble, _ = load_ensemble(args.stage3_ab_ensemble_dir)
        stage3_ab = load_jax_variables(Stage3ABModel(), ab_ensemble[0]).eval()
        print(f"AB ensemble: {len(ab_ensemble)} members (soft vote)")
    else:
        stage3_ab = load_model(args.stage3_ab_checkpoint,
                               FGVCModel if args.ab_fgvc else Stage3ABModel)
    models = PipelineModels(
        load_model(args.stage1_checkpoint, Stage1Model),
        load_model(args.stage2_checkpoint, Stage2Model),
        load_model(args.stage3_rect_checkpoint, Stage3RectModel),
        stage3_ab,
    )
    if args.tta_align_ab and not args.tta:
        raise SystemExit("--tta-align-ab requires --tta")
    if args.folded and (args.tta or ab_ensemble is not None):
        raise SystemExit("--int8/--folded are incompatible with --tta/ensembles")
    if args.capacity is not None:
        if args.tta or ab_ensemble is not None:
            raise SystemExit("--capacity is incompatible with --tta/ensembles")
        return make_v6_pipeline_gated(
            models, capacity=args.capacity, stage1_threshold=args.stage1_threshold,
            input_dtype=dtype, folded=args.folded, device=device,
        )
    if args.folded:
        return make_v6_pipeline_folded(
            models, stage1_threshold=args.stage1_threshold, float_dtype=dtype,
            use_fused_front=FUSED_FRONT[args.fused_front], device=device,
        )
    return make_v6_pipeline(
        models, stage1_threshold=args.stage1_threshold, input_dtype=dtype,
        device=device, tta=args.tta,
        tta_align_ab=args.tta and args.tta_align_ab is not False,
        ab_ensemble_vars=ab_ensemble,
    )


def build_unified(args, dtype, device):
    model = load_model(args.unified_checkpoint, UnifiedV6Model)
    if args.tta_align_ab and not args.tta:
        raise SystemExit("--tta-align-ab requires --tta")
    if args.folded:
        if args.tta:
            raise SystemExit("--folded is incompatible with --tta")
        return make_unified_pipeline_folded(
            model, stage1_threshold=args.stage1_threshold, float_dtype=dtype,
            use_fused_front=FUSED_FRONT[args.fused_front], device=device,
        )
    return make_unified_pipeline(
        model, stage1_threshold=args.stage1_threshold, input_dtype=dtype,
        tta=args.tta, tta_align_ab=args.tta_align_ab is not False, device=device,
    )


def resolve_capacity(parser, args) -> None:
    """``args.capacity`` as a float in (0, 1], from a number or from the
    calibration sweep (``auto``); None stays None."""
    if args.capacity is None:
        return
    if args.capacity == "auto":
        if args.calibration_dir is None:
            parser.error("--capacity auto requires --calibration-dir")
        rows, _ = load_sweep(args.calibration_dir)
        args.capacity = auto_capacity(rows, args.stage1_threshold, args.capacity_margin)
        print(f"auto capacity: {args.capacity:.3f} "
              f"(gate rate @ th {args.stage1_threshold} + "
              f"{args.capacity_margin:.0%} margin)")
        return
    try:
        args.capacity = float(args.capacity)
    except ValueError:
        parser.error(CAPACITY_ERROR)
    if not 0.0 < args.capacity <= 1.0:
        parser.error(CAPACITY_ERROR)


def main(argv=None) -> None:
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.variant in VARIANTS_NOT_PORTED:
        parser.error(f"--variant {args.variant} is not ported yet "
                     f"(ROADMAP {VARIANTS_NOT_PORTED[args.variant]})")
    if args.variant == "unified" and args.capacity is not None:
        parser.error("--capacity is only supported with --variant v6")
    if args.fused_front != "off" and not args.folded:
        parser.error("--fused-front needs --folded")
    if args.capacity is not None and args.fused_front != "off":
        parser.error("--capacity: the gated pipeline has no fused front; "
                     "use --fused-front off")
    resolve_capacity(parser, args)
    if args.variant == "v6":
        required = ["stage1_checkpoint", "stage2_checkpoint", "stage3_rect_checkpoint"]
        if args.stage3_ab_ensemble_dir is None:
            required.append("stage3_ab_checkpoint")
        for req in required:
            if getattr(args, req) is None:
                parser.error(f"--{req.replace('_', '-')} required for v6")
    elif args.unified_checkpoint is None:
        parser.error("--unified-checkpoint required for unified")
    if args.device == "cuda" and not torch.cuda.is_available():
        parser.error("--device cuda: no CUDA device is available")
    device = torch.device(args.device)
    dtype = torch.bfloat16 if args.bf16 else torch.float32

    train_b, val_b, _ = load_split(args.dataset_dir, args.block_size)
    bundle = val_b if args.split == "val" else train_b
    build = build_v6 if args.variant == "v6" else build_unified
    predict = build(args, dtype, device)
    class_names = list(V6_EVAL_CLASS_NAMES)

    start = time.perf_counter()
    out = run_pipeline_batched(predict, bundle.samples, args.batch_size, device)
    seconds = time.perf_counter() - start
    throughput = len(bundle) / seconds

    raw_labels = bundle.labels["stage0"]
    if args.reference_compat_labels:
        labels = np.clip(raw_labels, 0, len(class_names) - 1)
    else:
        labels = raw_to_v6_final(raw_labels)  # -1 for 1TO4: excluded
    final = out["final"]
    metrics = compute_metrics(labels, final, labels=class_names)
    stage1_metrics = compute_binary_metrics(
        bundle.labels["stage1"], out["stage1_prob"], args.stage1_threshold
    )
    payload = {
        "variant": args.variant,
        "split": args.split,
        "threshold": args.stage1_threshold,
        "samples": len(bundle),
        "int8": False,
        "folded": bool(args.folded),
        "capacity": args.capacity,
        "throughput_superblocks_per_sec": throughput,
        "metrics": metrics,
        "stage1": stage1_metrics,
        "cascade": decompose_v6(out, raw_labels),
    }
    out_dir = Path(args.output_dir)
    write_metrics_json(out_dir / f"pipeline_metrics_{args.split}.json", payload)
    write_predictions_npz(
        out_dir / f"pipeline_predictions_{args.split}.npz",
        final, labels, class_names, stage1_prob=out["stage1_prob"],
    )
    if args.csv:
        rows = [
            {
                "index": i,
                "true": class_names[int(labels[i])] if labels[i] >= 0 else "EXCLUDED",
                "pred": class_names[int(final[i])],
                "stage1_prob": float(out["stage1_prob"][i]),
            }
            for i in range(len(final))
        ]
        write_predictions_csv(out_dir / f"pipeline_predictions_{args.split}.csv", rows)
    summary = {
        "accuracy": metrics["accuracy"],
        "macro_f1": metrics["macro_f1"],
        "stage1_f1": stage1_metrics["f1"],
        "throughput_superblocks_per_sec": round(throughput, 1),
    }
    serving = (f"device: {args.device}, folded: {args.folded}, "
               f"fused front: {args.fused_front}")
    if "overflow" in out:  # gate-passing samples beyond K, sent to SPLIT
        summary["overflow"] = int(out["overflow"].sum())
        serving += f", capacity: {args.capacity}, overflow: {summary['overflow']}"
    write_text_report(
        out_dir / f"pipeline_report_{args.split}.txt",
        f"av1tpu_torch {args.variant} pipeline evaluation",
        metrics,
        extra_lines=[
            f"split: {args.split}",
            f"stage-1 threshold: {args.stage1_threshold}",
            f"samples: {len(bundle)}",
            serving,
            f"throughput: {throughput:,.0f} superblocks/sec",
        ],
    )
    print(json.dumps(summary, indent=2))


if __name__ == "__main__":
    main()
