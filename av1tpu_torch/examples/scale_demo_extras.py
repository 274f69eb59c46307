"""Scale-demo extras: the remaining experiment families at dataset scale.

Runs after ``av1tpu_torch.examples.scale_demo`` against its artifacts:

  * AB 3-member ensemble (reference 006-ensemble) + soft-vote pipeline row
  * TTA pipeline row and capacity-gated (0.5) serving row
  * operating-point comparison (0.40/0.45/0.50/0.55) via compare_thresholds
  * the v5 family ladder (shared-backbone model: stage1 -> stage2 ->
    RECT/AB specialists -> fused v5 pipeline eval) on the same corpus

Writes everything to ``<demo>/EXTRAS.json``.

    python -m av1tpu_torch.examples.scale_demo_extras --demo runs/scale_demo \
        [--device cuda]
"""
import argparse
import json
from pathlib import Path

from av1tpu_torch.cli import (
    compare_thresholds,
    prepare_stage3,
    run_pipeline_eval,
    train_stage1,
    train_stage2,
    train_stage3,
)
from av1tpu_torch.data import build_v5_bundle
from av1tpu_torch.data.bundles import save_split
from av1tpu_torch.data.synth import reference_shaped_corpus
from av1tpu_torch.examples._common import Steps, add_device_arg, parse_example_args
from av1tpu_torch.train.checkpoint import load_variables_npz, save_variables_npz


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--demo", type=Path, default=Path("runs/scale_demo"))
    parser.add_argument("--scale", type=float, default=1.0)
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--batch-size", type=int, default=256)
    parser.add_argument("--ensemble-epochs", type=int, default=30)
    parser.add_argument("--v5-epochs", type=int, default=20)
    add_device_arg(parser)
    args = parse_example_args(parser, argv)

    demo = Path(args.demo)
    ds = demo / "v6_dataset"
    stage3_dir = demo / "stage3_datasets"
    s1_ckpt = demo / "stage1" / "stage1_best_variables.npz"
    s2_ckpt = demo / "stage2" / "stage2_best_variables.npz"
    rect_ckpt = demo / "stage3_rect" / "stage3_rect_best_variables.npz"
    ab_ckpt = demo / "stage3_ab" / "stage3_ab_fgvc_best_variables.npz"
    calib = json.loads(
        (demo / "calibration" / "threshold_summary.json").read_text()
    )
    threshold = str(calib["f1"]["threshold"])
    dev = ["--device", args.device]

    results = {}
    step = Steps(args.device, record=results)

    def pipeline_row(name, extra):
        out_dir = demo / name
        step(name, run_pipeline_eval.main, [
            "--variant", "v6",
            "--dataset-dir", str(ds), "--block-size", "16",
            "--output-dir", str(out_dir),
            "--stage1-threshold", threshold,
            "--stage1-checkpoint", str(s1_ckpt),
            "--stage2-checkpoint", str(s2_ckpt),
            "--stage3-rect-checkpoint", str(rect_ckpt),
            "--bf16", *extra, *dev,
        ])
        m = json.loads((out_dir / "pipeline_metrics_val.json").read_text())
        results[name].update({
            "accuracy": round(m["metrics"]["accuracy"], 4),
            "macro_f1": round(m["metrics"]["macro_f1"], 4),
            "throughput_superblocks_per_sec": round(
                m["throughput_superblocks_per_sec"], 1),
        })

    # --- AB ensemble (006-ensemble) + soft-vote pipeline ---------------------
    ens_out = demo / "stage3_ab_ensemble"
    step("ab_ensemble_train", train_stage3.main, [
        "--head", "AB", "--ensemble", "3",
        "--dataset-dir", str(stage3_dir), "--block-size", "16",
        "--output-dir", str(ens_out),
        "--epochs", str(args.ensemble_epochs),
        "--batch-size", "128", "--bf16", *dev,
    ])
    for member in (1, 2, 3):
        hist = json.loads(
            (ens_out / f"stage3_ab_member{member}_history.json").read_text())
        results["ab_ensemble_train"][f"member{member}_best_f1"] = round(
            max(h["val_metrics"]["macro_f1"] for h in hist), 4)
    pipeline_row("pipeline_v6_ab_ensemble",
                 ["--stage3-ab-ensemble-dir", str(ens_out / "ensemble")])

    # --- TTA + gated rows ------------------------------------------------------
    pipeline_row("pipeline_v6_tta",
                 ["--stage3-ab-checkpoint", str(ab_ckpt), "--tta"])
    pipeline_row("pipeline_v6_gated_05",
                 ["--stage3-ab-checkpoint", str(ab_ckpt), "--capacity", "0.5"])

    # --- operating points -------------------------------------------------------
    step("compare_thresholds", compare_thresholds.main, [
        "--dataset-dir", str(ds), "--block-size", "16",
        "--output-dir", str(demo / "operating_points"),
        "--thresholds", "0.40", "0.45", "0.50", "0.55",
        "--stage1-checkpoint", str(s1_ckpt),
        "--stage2-checkpoint", str(s2_ckpt),
        "--stage3-rect-checkpoint", str(rect_ckpt),
        "--stage3-ab-checkpoint", str(ab_ckpt), "--bf16", *dev,
    ])

    # --- v5 family ladder --------------------------------------------------------
    train_set, val_set = reference_shaped_corpus(args.seed, scale=args.scale)
    v5_ds = demo / "v5_dataset"
    save_split(v5_ds, 16, build_v5_bundle(train_set),
               build_v5_bundle(val_set), "v5")
    v5_s3 = demo / "v5_stage3_datasets"
    step("v5_prepare_stage3", prepare_stage3.main, [
        "--dataset-dir", str(v5_ds), "--out", str(v5_s3),
        "--block-size", "16", "--heads", "RECT", "AB",
    ])

    def record_best(name, history_path):
        hist = json.loads(Path(history_path).read_text())
        results[name]["epochs"] = len(hist)
        results[name]["best_val_macro_f1"] = round(
            max(h["val_metrics"]["macro_f1"] for h in hist), 4)

    v5_runs = demo / "v5_runs"
    step("v5_stage1", train_stage1.main, [
        "--dataset-dir", str(v5_ds), "--block-size", "16", "--variant", "v5",
        "--output-dir", str(v5_runs / "stage1"),
        "--epochs", str(args.v5_epochs),
        "--batch-size", str(args.batch_size), "--bf16", *dev,
    ])
    record_best("v5_stage1", v5_runs / "stage1" / "v5_stage1_history.json")
    v5_s1 = v5_runs / "stage1" / "v5_stage1_best_variables.npz"

    step("v5_stage2", train_stage2.main, [
        "--dataset-dir", str(v5_ds), "--block-size", "16", "--variant", "v5",
        "--output-dir", str(v5_runs / "stage2"),
        "--epochs", str(args.v5_epochs),
        "--batch-size", str(args.batch_size),
        "--stage1-checkpoint", str(v5_s1), "--bf16", *dev,
    ])
    record_best("v5_stage2", v5_runs / "stage2" / "v5_stage2_history.json")
    v5_s2 = v5_runs / "stage2" / "v5_stage2_best_variables.npz"

    for head in ("RECT", "AB"):
        step(f"v5_stage3_{head}", train_stage3.main, [
            "--head", head, "--variant", "v5",
            "--dataset-dir", str(v5_s3), "--block-size", "16",
            "--output-dir", str(v5_runs / f"stage3_{head}"),
            "--epochs", str(args.v5_epochs),
            "--batch-size", str(args.batch_size),
            "--stage2-checkpoint", str(v5_s2), "--bf16", *dev,
        ])
        record_best(
            f"v5_stage3_{head}",
            v5_runs / f"stage3_{head}" / f"v5_stage3_{head}_history.json",
        )

    # merge heads into one multi-head checkpoint for the fused v5 pipeline
    merged = load_variables_npz(v5_s2)
    for head in ("RECT", "AB"):
        hv = load_variables_npz(
            v5_runs / f"stage3_{head}" / f"v5_stage3_{head}_best_variables.npz"
        )
        merged["params"][f"specialist_{head}"] = hv["params"][
            f"specialist_{head}"
        ]
    v5_merged = v5_runs / "v5_merged_variables.npz"
    save_variables_npz(v5_merged, merged)

    step("v5_pipeline", run_pipeline_eval.main, [
        "--variant", "v5",
        "--dataset-dir", str(v5_ds), "--block-size", "16",
        "--output-dir", str(demo / "pipeline_v5"),
        "--v5-checkpoint", str(v5_merged),
        "--available-specialists", "RECT", "AB", "--bf16", *dev,
    ])
    m = json.loads(
        (demo / "pipeline_v5" / "pipeline_metrics_val.json").read_text())
    results["v5_pipeline"].update({
        "accuracy": round(m["metrics"]["accuracy"], 4),
        "macro_f1": round(m["metrics"]["macro_f1"], 4),
    })

    (demo / "EXTRAS.json").write_text(json.dumps(results, indent=2))
    print(json.dumps(results, indent=2))


if __name__ == "__main__":
    main()
