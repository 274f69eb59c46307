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
``--fused-front`` passes ``use_fused_front`` (off/on/g1) to the folded
pipeline. Flags and variants not ported yet exit with the ROADMAP item
that will bring them.
"""
from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np
import torch

from av1tpu_torch.codec.partitions import V6_EVAL_CLASS_NAMES, raw_to_v6_final
from av1tpu_torch.cli.common import (
    add_not_ported_flags,
    load_model_variables,
    load_split,
)
from av1tpu_torch.eval import (
    PipelineModels,
    compute_binary_metrics,
    compute_metrics,
    decompose_v6,
    make_v6_pipeline,
    make_v6_pipeline_folded,
    run_pipeline_batched,
    write_metrics_json,
    write_predictions_csv,
    write_predictions_npz,
    write_text_report,
)
from av1tpu_torch.models import (
    FGVCModel,
    Stage1Model,
    Stage2Model,
    Stage3ABModel,
    Stage3RectModel,
    load_jax_variables,
)

# flag -> ROADMAP item that ports it
NOT_PORTED = {
    "--tta": "M2", "--tta-align-ab": "M2", "--no-tta-align-ab": "M2",
    "--stage3-ab-ensemble-dir": "M2",
    "--unified-checkpoint": "M3",
    "--capacity": "M7", "--calibration-dir": "M7", "--capacity-margin": "M7",
    "--flatten-checkpoint": "M8", "--v5-checkpoint": "M8",
    "--available-specialists": "M8",
    "--int8": "M9", "--calib-samples": "M9",
}
VARIANTS_NOT_PORTED = {"unified": "M3", "v5": "M8", "flatten": "M8"}
FUSED_FRONT = {"off": False, "on": True, "g1": "g1"}


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--variant", default="v6",
                        choices=("v6", *VARIANTS_NOT_PORTED))
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
    parser.add_argument("--folded", action="store_true",
                        help="BN-folded serving path (eval.folded)")
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
                        "or stem+maxpool+layer group 1+SE1 as kernel K2 (g1)")
    add_not_ported_flags(parser, NOT_PORTED)
    return parser


def build_v6(args, dtype, device):
    def load(path, model_cls):
        variables = load_model_variables(path)
        variables.pop("centers", None)
        return load_jax_variables(model_cls(), variables).eval()

    models = PipelineModels(
        load(args.stage1_checkpoint, Stage1Model),
        load(args.stage2_checkpoint, Stage2Model),
        load(args.stage3_rect_checkpoint, Stage3RectModel),
        load(args.stage3_ab_checkpoint,
             FGVCModel if args.ab_fgvc else Stage3ABModel),
    )
    if args.folded:
        return make_v6_pipeline_folded(
            models, stage1_threshold=args.stage1_threshold, float_dtype=dtype,
            use_fused_front=FUSED_FRONT[args.fused_front], device=device,
        )
    return make_v6_pipeline(models, stage1_threshold=args.stage1_threshold,
                            input_dtype=dtype, device=device)


def main(argv=None) -> None:
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.variant != "v6":
        parser.error(f"--variant {args.variant} is not ported yet "
                     f"(ROADMAP {VARIANTS_NOT_PORTED[args.variant]})")
    for req in ("stage1_checkpoint", "stage2_checkpoint",
                "stage3_rect_checkpoint", "stage3_ab_checkpoint"):
        if getattr(args, req) is None:
            parser.error(f"--{req.replace('_', '-')} required for v6")
    if args.fused_front != "off" and not args.folded:
        parser.error("--fused-front needs --folded")
    if args.device == "cuda" and not torch.cuda.is_available():
        parser.error("--device cuda: no CUDA device is available")
    device = torch.device(args.device)
    dtype = torch.bfloat16 if args.bf16 else torch.float32

    train_b, val_b, _ = load_split(args.dataset_dir, args.block_size)
    bundle = val_b if args.split == "val" else train_b
    predict = build_v6(args, dtype, device)
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
        "capacity": None,
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
    write_text_report(
        out_dir / f"pipeline_report_{args.split}.txt",
        f"av1tpu_torch {args.variant} pipeline evaluation",
        metrics,
        extra_lines=[
            f"split: {args.split}",
            f"stage-1 threshold: {args.stage1_threshold}",
            f"samples: {len(bundle)}",
            f"device: {args.device}, folded: {args.folded}, "
            f"fused front: {args.fused_front}",
            f"throughput: {throughput:,.0f} superblocks/sec",
        ],
    )
    print(json.dumps({
        "accuracy": metrics["accuracy"],
        "macro_f1": metrics["macro_f1"],
        "stage1_f1": stage1_metrics["f1"],
        "throughput_superblocks_per_sec": round(throughput, 1),
    }, indent=2))


if __name__ == "__main__":
    main()
