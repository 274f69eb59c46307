"""Dataset-scale training ladder demonstration — the realized results run.

The reference's results database (docs_v6/*.md) was measured on a private
dataset that is not shipped; this runs the ENTIRE v6 ladder at the
documented dataset scale (train 152,600 partition blocks + NONE, val 90,793
— see ``data/synth.py``) with the real recipes and epoch counts, through the
same CLIs a user would run, on ``--device``:

    dataset prep -> stage1 (30 ep) -> threshold + temperature calibration
    -> stage2 ULMFiT (5+25 ep) -> stage3 RECT (5+25) -> stage3 AB FGVC
    (5+25) -> flatten 7-way (15+25) -> pipeline eval (v6 + flatten)
    -> serving certification -> confusion analysis

Emits ``<out>/RESULTS.json`` + ``RESULTS.md`` with per-stage metrics and
wall-clock.

    python -m av1tpu_torch.examples.scale_demo --out runs/scale_demo \
        [--scale 0.05] [--device cuda]
"""
import argparse
import json
import time
from pathlib import Path

import numpy as np

from av1tpu_torch.cli import (
    analyze_confusion,
    certify_serving,
    optimize_thresholds,
    prepare_stage3,
    run_pipeline_eval,
    train_stage1,
    train_stage2,
    train_stage2_flat,
    train_stage3,
)
from av1tpu_torch.data import build_flatten_bundle, build_v6_bundle
from av1tpu_torch.data.bundles import save_split
from av1tpu_torch.data.synth import reference_shaped_corpus
from av1tpu_torch.examples._common import Steps, add_device_arg, parse_example_args


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--out", type=Path, default=Path("runs/scale_demo"))
    parser.add_argument("--scale", type=float, default=1.0,
                        help="corpus scale factor (1.0 = documented sizes)")
    parser.add_argument("--batch-size", type=int, default=256)
    parser.add_argument("--bf16", action=argparse.BooleanOptionalAction,
                        default=True,
                        help="bf16 compute (default; --no-bf16 for float32)")
    parser.add_argument("--stage1-epochs", type=int, default=30)
    parser.add_argument("--stage2-epochs", type=int, default=30)
    parser.add_argument("--stage3-epochs", type=int, default=30)
    parser.add_argument("--flat-epochs", type=int, default=40)
    parser.add_argument("--seed", type=int, default=42)
    add_device_arg(parser)
    args = parse_example_args(parser, argv)

    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    results = {"scale": args.scale, "stages": {}}
    bf16 = ["--bf16"] if args.bf16 else []
    dev = ["--device", args.device]
    step = Steps(args.device, record=results["stages"])

    def record_best(name, history_path):
        hist = json.loads(Path(history_path).read_text())
        best = max(h["val_metrics"]["macro_f1"] for h in hist)
        best_acc = max(h["val_metrics"]["accuracy"] for h in hist)
        thr = np.mean([h.get("throughput", 0.0) for h in hist])
        results["stages"][name].update({
            "epochs": len(hist),
            "best_val_macro_f1": round(best, 4),
            "best_val_accuracy": round(best_acc, 4),
            "train_samples_per_sec": round(float(thr), 1),
        })

    # --- corpus + datasets -------------------------------------------------
    t0 = time.perf_counter()
    train_set, val_set = reference_shaped_corpus(args.seed, scale=args.scale)
    ds = out / "v6_dataset"
    flat_ds = out / "flatten_dataset"
    save_split(ds, 16, build_v6_bundle(train_set), build_v6_bundle(val_set), "v6")
    save_split(flat_ds, 16, build_flatten_bundle(train_set),
               build_flatten_bundle(val_set), "flatten")
    results["corpus"] = {
        "train": len(train_set.labels), "val": len(val_set.labels),
        "build_seconds": round(time.perf_counter() - t0, 1),
    }
    print(f"corpus: {results['corpus']}", flush=True)

    stage3_dir = out / "stage3_datasets"
    step("prepare_stage3", prepare_stage3.main, [
        "--dataset-dir", str(ds), "--out", str(stage3_dir),
        "--block-size", "16", "--ensemble-members", "3",
    ])

    # --- stage 1 ------------------------------------------------------------
    s1_dir = out / "stage1"
    step("stage1", train_stage1.main, [
        "--dataset-dir", str(ds), "--block-size", "16",
        "--output-dir", str(s1_dir),
        "--epochs", str(args.stage1_epochs),
        "--batch-size", str(args.batch_size), *bf16, *dev,
    ])
    s1_ckpt = s1_dir / "stage1_best_variables.npz"
    record_best("stage1", s1_dir / "stage1_history.json")

    # --- threshold + temperature calibration --------------------------------
    calib_dir = out / "calibration"
    step("calibration", optimize_thresholds.main, [
        "--dataset-dir", str(ds), "--block-size", "16",
        "--stage1-checkpoint", str(s1_ckpt),
        "--output-dir", str(calib_dir), *bf16, *dev,
    ])
    calib = json.loads((calib_dir / "threshold_summary.json").read_text())
    results["stages"]["calibration"].update({
        "best_threshold": calib["f1"]["threshold"],
        "stage1_f1_at_best": round(calib["f1"]["f1"], 4),
        "temperature": round(calib["calibration"]["temperature"], 3),
        "ece_raw": round(calib["calibration"]["ece_raw"], 4),
        "ece_calibrated": round(calib["calibration"]["ece_calibrated"], 4),
    })
    best_threshold = calib["f1"]["threshold"]

    # --- stage 2 (ULMFiT, stage-1 backbone) ----------------------------------
    s2_dir = out / "stage2"
    step("stage2", train_stage2.main, [
        "--dataset-dir", str(ds), "--block-size", "16",
        "--output-dir", str(s2_dir),
        "--epochs", str(args.stage2_epochs), "--freeze-epochs", "5",
        "--batch-size", str(args.batch_size),
        "--stage1-checkpoint", str(s1_ckpt), *bf16, *dev,
    ])
    s2_ckpt = s2_dir / "stage2_best_variables.npz"
    record_best("stage2", s2_dir / "stage2_history.json")

    # --- stage 3 RECT ---------------------------------------------------------
    rect_dir = out / "stage3_rect"
    step("stage3_rect", train_stage3.main, [
        "--head", "RECT",
        "--dataset-dir", str(stage3_dir), "--block-size", "16",
        "--output-dir", str(rect_dir),
        "--epochs", str(args.stage3_epochs),
        "--batch-size", str(args.batch_size),
        "--stage2-checkpoint", str(s2_ckpt), *bf16, *dev,
    ])
    rect_ckpt = rect_dir / "stage3_rect_best_variables.npz"
    record_best("stage3_rect", rect_dir / "stage3_rect_history.json")

    # --- stage 3 AB (FGVC) ------------------------------------------------------
    ab_dir = out / "stage3_ab"
    step("stage3_ab_fgvc", train_stage3.main, [
        "--head", "AB", "--fgvc",
        "--dataset-dir", str(stage3_dir), "--block-size", "16",
        "--output-dir", str(ab_dir),
        "--epochs", str(args.stage3_epochs),
        "--batch-size", "128",
        "--stage2-checkpoint", str(s2_ckpt), *bf16, *dev,
    ])
    ab_ckpt = ab_dir / "stage3_ab_fgvc_best_variables.npz"
    record_best("stage3_ab_fgvc", ab_dir / "stage3_ab_fgvc_history.json")

    # --- flatten 7-way ----------------------------------------------------------
    flat_dir = out / "stage2_flat"
    step("stage2_flat", train_stage2_flat.main, [
        "--dataset-dir", str(flat_ds), "--block-size", "16",
        "--output-dir", str(flat_dir),
        "--epochs", str(args.flat_epochs), "--freeze-epochs", "15",
        "--batch-size", str(args.batch_size), *bf16, *dev,
    ])
    flat_ckpt = flat_dir / "stage2_flat_best_variables.npz"
    record_best("stage2_flat", flat_dir / "stage2_flat_history.json")

    # --- pipeline eval (v6) -------------------------------------------------------
    pipe_dir = out / "pipeline_v6"
    step("pipeline_v6", run_pipeline_eval.main, [
        "--variant", "v6",
        "--dataset-dir", str(ds), "--block-size", "16",
        "--output-dir", str(pipe_dir),
        "--stage1-threshold", str(best_threshold),
        "--stage1-checkpoint", str(s1_ckpt),
        "--stage2-checkpoint", str(s2_ckpt),
        "--stage3-rect-checkpoint", str(rect_ckpt),
        "--stage3-ab-checkpoint", str(ab_ckpt), *bf16, *dev,
    ])
    pipe = json.loads((pipe_dir / "pipeline_metrics_val.json").read_text())
    results["stages"]["pipeline_v6"].update({
        "accuracy": round(pipe["metrics"]["accuracy"], 4),
        "macro_f1": round(pipe["metrics"]["macro_f1"], 4),
        "stage1_f1": round(pipe["stage1"]["f1"], 4),
        "throughput_superblocks_per_sec": round(
            pipe["throughput_superblocks_per_sec"], 1),
        "cascade": pipe.get("cascade"),
    })

    # --- flatten pipeline eval --------------------------------------------------
    pipe_flat_dir = out / "pipeline_flatten"
    step("pipeline_flatten", run_pipeline_eval.main, [
        "--variant", "flatten",
        "--dataset-dir", str(ds), "--block-size", "16",
        "--output-dir", str(pipe_flat_dir),
        "--stage1-threshold", str(best_threshold),
        "--stage1-checkpoint", str(s1_ckpt),
        "--flatten-checkpoint", str(flat_ckpt), *bf16, *dev,
    ])
    pf = json.loads((pipe_flat_dir / "pipeline_metrics_val.json").read_text())
    results["stages"]["pipeline_flatten"].update({
        "accuracy": round(pf["metrics"]["accuracy"], 4),
        "macro_f1": round(pf["metrics"]["macro_f1"], 4),
    })

    # --- serving-path certification (dense/folded/int8/gated-auto) ---------------
    cert_dir = out / "certify_serving"
    step("certify_serving", certify_serving.main, [
        "--dataset-dir", str(ds), "--block-size", "16",
        "--output-dir", str(cert_dir),
        "--stage1-threshold", str(best_threshold),
        "--stage1-checkpoint", str(s1_ckpt),
        "--stage2-checkpoint", str(s2_ckpt),
        "--stage3-rect-checkpoint", str(rect_ckpt),
        "--stage3-ab-checkpoint", str(ab_ckpt),
        "--calibration-dir", str(calib_dir), *bf16, *dev,
    ])
    cert = json.loads((cert_dir / "serving_certification.json").read_text())
    results["stages"]["certify_serving"].update({
        r["variant"]: {
            "accuracy": round(r["accuracy"], 4),
            "macro_f1": round(r["macro_f1"], 4),
            "agreement_vs_flax": round(r["agreement_vs_flax"], 6),
        }
        for r in cert["rows"]
    })

    # --- confusion analysis -------------------------------------------------------
    step("analyze_confusion", analyze_confusion.main, [
        "--dataset-dir", str(ds), "--block-size", "16",
        "--stage2-checkpoint", str(s2_ckpt),
        "--output-dir", str(out / "confusion"), *bf16, *dev,
    ])

    (out / "RESULTS.json").write_text(json.dumps(results, indent=2))

    lines = [
        "# Scale demonstration results", "",
        f"Corpus: train {results['corpus']['train']:,} / "
        f"val {results['corpus']['val']:,} (scale {args.scale})", "",
        "| stage | epochs | best val macro-F1 | best val acc | "
        "train samples/s | wall (s) |",
        "|---|---|---|---|---|---|",
    ]
    for name, r in results["stages"].items():
        lines.append(
            f"| {name} | {r.get('epochs', '-')} | "
            f"{r.get('best_val_macro_f1', r.get('macro_f1', '-'))} | "
            f"{r.get('best_val_accuracy', r.get('accuracy', '-'))} | "
            f"{r.get('train_samples_per_sec', '-')} | "
            f"{r.get('wall_seconds', '-')} |"
        )
    (out / "RESULTS.md").write_text("\n".join(lines) + "\n")
    print(json.dumps(results, indent=2))


if __name__ == "__main__":
    main()
