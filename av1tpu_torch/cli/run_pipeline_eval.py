"""CLI: end-to-end hierarchical pipeline evaluation on one device (PyTorch
port): v6, unified, v5 and flatten.

    python -m av1tpu_torch.cli.run_pipeline_eval --variant v6 --folded \
        --fused-front on --bf16 \
        --dataset-dir data/v6_dataset --block-size 16 \
        --stage1-checkpoint runs/stage1/stage1_best_variables.npz \
        --stage2-checkpoint runs/stage2/stage2_best_variables.npz \
        --stage3-rect-checkpoint runs/rect/stage3_rect_best_variables.npz \
        --stage3-ab-checkpoint runs/ab/stage3_ab_fgvc_best_variables.npz \
        --output-dir runs/pipeline_eval

Writes the files of ``av1tpu.cli.run_pipeline_eval`` (metrics JSON,
predictions npz, optional CSV, confusion PNG, text report); where matplotlib
is not installed it prints that the PNG was not written and goes on.
``--variant unified --unified-checkpoint ...`` serves the single-trunk
family; ``--tta``, ``--stage3-ab-ensemble-dir`` and ``--capacity`` (a float
or ``auto`` with ``--calibration-dir``) select the plain graph's options and
the capacity-gated pipeline as in the JAX CLI. ``--int8`` serves the
post-training-quantized pipeline (``quant.ptq``), calibrated on a seeded
subsample of ``--calib-samples`` train blocks, the JAX CLI's rows in its
order. ``--fused-front`` passes ``use_fused_front`` (off/on/g1) to the folded
pipeline, per-stage or unified, and (off/on) to the int8 one; the gated
pipeline has no fused front.

``--variant v5 --v5-checkpoint ...`` serves the v5 multi-head model in fp32
(``--bf16`` too, as the JAX CLI builds it without a dtype), with
``--available-specialists`` (a missing specialist falls back to its group's
first member) and the bundle's QPs / 255 for a QP-conditioned checkpoint;
``--variant flatten --stage1-checkpoint ... --flatten-checkpoint ...`` serves
the stage-1 gate and the 7-way classifier. Both report raw partition ids.
Every checkpoint flag takes an npz or a reference ``.pt``.
"""
from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np
import torch

from av1tpu_torch.codec.partitions import (
    PARTITION_ID_TO_NAME,
    V6_EVAL_CLASS_NAMES,
    raw_to_v6_final,
)
from av1tpu_torch.cli.common import (
    load_model,
    load_model_variables,
    load_split,
    save_plot,
    train_calibration_blocks,
)
from av1tpu_torch.eval import (
    PipelineModels,
    auto_capacity,
    compute_binary_metrics,
    compute_metrics,
    decompose_v6,
    load_ensemble,
    make_flatten_pipeline,
    make_unified_pipeline,
    make_unified_pipeline_folded,
    make_v5_pipeline,
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
from av1tpu_torch.eval.plots import plot_confusion_matrix
from av1tpu_torch.models import (
    FGVCModel,
    HierarchicalModel,
    Stage1Model,
    Stage2FlatModel,
    Stage2Model,
    Stage3ABModel,
    Stage3RectModel,
    UnifiedV6Model,
    load_jax_variables,
)
from av1tpu_torch.quant import make_unified_pipeline_int8, make_v6_pipeline_int8

FUSED_FRONT = {"off": False, "on": True, "g1": "g1"}
CAPACITY_ERROR = "--capacity must be a float in (0, 1] or 'auto'"


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--variant", default="v6",
                        choices=("v5", "v6", "flatten", "unified"))
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
                        "per-stage or unified; with --int8: on (K1) only")
    parser.add_argument("--int8", action="store_true",
                        help="serve the post-training-quantized int8 pipeline "
                        "(quant.ptq): BN-folded weights, per-channel int8, "
                        "activations calibrated on --calib-samples train "
                        "blocks. An FGVC AB model stays float inside it")
    parser.add_argument("--calib-samples", type=int, default=512,
                        help="calibration batch size for --int8")
    parser.add_argument("--flatten-checkpoint", type=Path,
                        help="Stage2FlatModel checkpoint for --variant flatten")
    parser.add_argument("--v5-checkpoint", type=Path,
                        help="v5 HierarchicalModel checkpoint for --variant v5")
    parser.add_argument("--available-specialists", nargs="*",
                        default=["RECT", "AB", "1TO4"])
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
    if args.int8 or args.folded:
        if args.tta or ab_ensemble is not None:
            raise SystemExit("--int8/--folded are incompatible with --tta/ensembles")
        if args.int8 and args.folded:
            raise SystemExit("--int8 and --folded are distinct serving paths; pick one")
        if args.int8 and args.capacity is not None:
            raise SystemExit("--int8 is incompatible with --capacity")
    if args.int8:
        return make_v6_pipeline_int8(
            models, args.calib_images, stage1_threshold=args.stage1_threshold,
            float_dtype=dtype, use_fused_front=FUSED_FRONT[args.fused_front],
            device=device,
        )
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
    if args.int8:
        if args.tta or args.folded:
            raise SystemExit("--int8 is a distinct serving path (no --tta/--folded)")
        return make_unified_pipeline_int8(
            model, args.calib_images, stage1_threshold=args.stage1_threshold,
            float_dtype=dtype, use_fused_front=FUSED_FRONT[args.fused_front],
            device=device,
        )
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


def build_v5(args, qps, device):
    """The v5 pipeline and the QPs it takes: the bundle's ``qps`` / 255 for a
    QP-conditioned checkpoint (a ``qp_embed`` tree), else None."""
    variables = load_model_variables(args.v5_checkpoint)
    use_qp = "qp_embed" in variables.get("params", {})
    if use_qp:
        print("QP-conditioned v5 checkpoint: feeding per-sample QPs")
    model = load_jax_variables(HierarchicalModel(use_qp=use_qp), variables).eval()
    predict = make_v5_pipeline(
        model, stage1_threshold=args.stage1_threshold,
        available_specialists=tuple(args.available_specialists), device=device,
    )
    return predict, (qps.astype(np.float32) / 255.0 if use_qp else None)


def build_flatten(args, dtype, device):
    return make_flatten_pipeline(
        load_model(args.stage1_checkpoint, Stage1Model),
        load_model(args.flatten_checkpoint, Stage2FlatModel),
        stage1_threshold=args.stage1_threshold, input_dtype=dtype, device=device,
    )


REQUIRED = {  # variant -> the checkpoint flags it needs (v6's depend on its AB flags)
    "unified": ["unified_checkpoint"],
    "v5": ["v5_checkpoint"],
    "flatten": ["stage1_checkpoint", "flatten_checkpoint"],
}


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
    if args.variant not in ("v6", "unified"):
        for flag in ("int8", "folded"):
            if getattr(args, flag):
                parser.error(f"--{flag} is only supported with --variant v6/unified")
        if args.capacity is not None:
            parser.error("--capacity is only supported with --variant v6")
    if args.variant == "unified" and args.capacity is not None:
        parser.error("--capacity is only supported with --variant v6")
    if args.fused_front != "off" and not (args.folded or args.int8):
        parser.error("--fused-front needs --folded or --int8")
    if args.int8 and args.fused_front == "g1":
        parser.error("--fused-front g1: the int8 graph has no group-1 hook; "
                     "use --fused-front on")
    if args.capacity is not None and args.fused_front != "off":
        parser.error("--capacity: the gated pipeline has no fused front; "
                     "use --fused-front off")
    resolve_capacity(parser, args)
    if args.variant == "v6":
        required = ["stage1_checkpoint", "stage2_checkpoint", "stage3_rect_checkpoint"]
        if args.stage3_ab_ensemble_dir is None:
            required.append("stage3_ab_checkpoint")
    else:
        required = REQUIRED[args.variant]
    for req in required:
        if getattr(args, req) is None:
            parser.error(f"--{req.replace('_', '-')} required for {args.variant}")
    if args.device == "cuda" and not torch.cuda.is_available():
        parser.error("--device cuda: no CUDA device is available")
    device = torch.device(args.device)
    dtype = torch.bfloat16 if args.bf16 else torch.float32

    train_b, val_b, _ = load_split(args.dataset_dir, args.block_size)
    bundle = val_b if args.split == "val" else train_b
    # int8 calibration: a seeded random subsample of the TRAIN split, never
    # the evaluated one (bundles are frame-sequential, so the first rows
    # would calibrate on one frame's content)
    args.calib_images = (train_calibration_blocks(train_b.samples, args.calib_samples)
                         if args.int8 else None)
    qps = None  # per-sample QPs for a QP-conditioned v5 checkpoint
    if args.variant == "v5":
        predict, qps = build_v5(args, bundle.qps, device)
        class_names = [PARTITION_ID_TO_NAME[i] for i in range(10)]
    elif args.variant == "flatten":
        # raw partition ids: the flatten classes map onto them
        predict = build_flatten(args, dtype, device)
        class_names = [PARTITION_ID_TO_NAME[i].replace("PARTITION_", "")
                       for i in range(8)]
    else:
        build = build_v6 if args.variant == "v6" else build_unified
        predict = build(args, dtype, device)
        class_names = list(V6_EVAL_CLASS_NAMES)

    start = time.perf_counter()
    out = run_pipeline_batched(predict, bundle.samples, args.batch_size, device, qps=qps)
    seconds = time.perf_counter() - start
    throughput = len(bundle) / seconds

    raw_labels = bundle.labels["stage0"]
    v6_family = args.variant in ("v6", "unified")
    if v6_family and not args.reference_compat_labels:
        labels = raw_to_v6_final(raw_labels)  # -1 for 1TO4: excluded
    else:
        # raw-id spaces (v5, flatten), or the reference's misaligned v6
        # comparison (quirk Q7) with --reference-compat-labels
        labels = np.clip(raw_labels, 0, len(class_names) - 1)
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
        "int8": bool(args.int8),
        "folded": bool(args.folded),
        "capacity": args.capacity,
        "throughput_superblocks_per_sec": throughput,
        "metrics": metrics,
        "stage1": stage1_metrics,
    }
    if v6_family:
        payload["cascade"] = decompose_v6(out, raw_labels)
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
    save_plot(lambda path: plot_confusion_matrix(
        np.asarray(metrics["confusion_matrix"]), class_names, path,
        title=f"{args.variant} pipeline ({args.split})"),
        out_dir / f"pipeline_confusion_{args.split}.png")
    summary = {
        "accuracy": metrics["accuracy"],
        "macro_f1": metrics["macro_f1"],
        "stage1_f1": stage1_metrics["f1"],
        "throughput_superblocks_per_sec": round(throughput, 1),
    }
    serving = (f"device: {args.device}, folded: {args.folded}, int8: {args.int8}, "
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
