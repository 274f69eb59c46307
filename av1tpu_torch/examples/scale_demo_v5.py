"""v5 ladder at dataset scale — the measured v5-family results run.

The reference's v5 results database (``pesquisa_v5/docs/analise_resultados_
block16.md``) was measured on a private block-16 dataset (~65.6k val
blocks) that is not shipped; this runs the ENTIRE v5 ladder at that
documented scale on the synthetic reference-shaped corpus, through the same
CLIs a user would run, on ``--device``:

    v5 dataset prep -> stage1 binary (009, 15 ep) -> stage2 5-way macro
    (010, 20 ep, full stage-1 state seed) -> stage3 specialists
    RECT/AB (012, 15 ep each, stage-2 seed) -> checkpoint merge
    (013:66-94 semantics) -> fused v5 pipeline eval (013)

Emits ``<out>/RESULTS.json`` + ``RESULTS.md`` with per-stage metrics,
pipeline accuracy, and wall-clock. The reference's corresponding block-16
numbers (stage1 F1 65.19%, stage2 macro-F1 33.41%, pipeline 39.56%) are
recorded alongside for context — measured on different (real) data, so
directional only.

    python -m av1tpu_torch.examples.scale_demo_v5 --out runs/scale_demo_v5 \
        [--scale 0.05] [--device cuda]
"""
import argparse
import json
import time
from pathlib import Path

import numpy as np

from av1tpu_torch.cli import (
    prepare_stage3,
    run_pipeline_eval,
    train_stage1,
    train_stage2,
    train_stage3,
)
from av1tpu_torch.cli.common import load_model_variables
from av1tpu_torch.data import build_v5_bundle
from av1tpu_torch.data.bundles import save_split
from av1tpu_torch.data.synth import reference_shaped_corpus
from av1tpu_torch.examples._common import Steps, add_device_arg, parse_example_args
from av1tpu_torch.train.checkpoint import merge_v5_pipeline_variables, save_variables_npz

# v5 block-16 documented val size is ~65,603 blocks vs the corpus
# generator's v6-documented 90,793 — scale the same generator down.
V5_DOC_SCALE = 65603 / 90793


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--out", type=Path, default=Path("runs/scale_demo_v5"))
    parser.add_argument("--scale", type=float, default=1.0,
                        help="corpus scale factor (1.0 = documented v5 size)")
    parser.add_argument("--batch-size", type=int, default=256)
    parser.add_argument("--bf16", action=argparse.BooleanOptionalAction,
                        default=True)
    parser.add_argument("--stage1-epochs", type=int, default=15)
    parser.add_argument("--stage2-epochs", type=int, default=20)
    parser.add_argument("--stage3-epochs", type=int, default=15)
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
        results["stages"][name].update({
            "epochs": len(hist),
            "best_val_macro_f1": round(
                max(h["val_metrics"]["macro_f1"] for h in hist), 4
            ),
            "best_val_accuracy": round(
                max(h["val_metrics"]["accuracy"] for h in hist), 4
            ),
            "train_samples_per_sec": round(float(np.mean(
                [h.get("throughput", 0.0) for h in hist]
            )), 1),
        })

    # --- corpus + v5 dataset -------------------------------------------------
    t0 = time.perf_counter()
    train_set, val_set = reference_shaped_corpus(
        args.seed, scale=args.scale * V5_DOC_SCALE
    )
    ds = out / "v5_dataset"
    save_split(ds, 16, build_v5_bundle(train_set), build_v5_bundle(val_set), "v5")
    results["corpus"] = {
        "train": len(train_set.labels), "val": len(val_set.labels),
        "build_seconds": round(time.perf_counter() - t0, 1),
    }
    print(f"corpus: {results['corpus']}", flush=True)

    # 1TO4 is structurally absent from the documented block-16 data (the
    # reference's confusion matrix has an all-zero 1TO4 row: "0 predicoes e
    # 0 amostras reais"), so only RECT/AB specialists train; the pipeline
    # eval exercises the specialist-fallback semantics for 1TO4
    # (013:233-237) exactly as the reference run did.
    heads = ("RECT", "AB")
    stage3_dir = out / "stage3_datasets"
    step("prepare_stage3", prepare_stage3.main, [
        "--dataset-dir", str(ds), "--out", str(stage3_dir),
        "--block-size", "16", "--heads", *heads,
        "--ensemble-members", "0",
    ])

    # --- stage 1 (009) -------------------------------------------------------
    s1_dir = out / "stage1"
    step("stage1", train_stage1.main, [
        "--dataset-dir", str(ds), "--block-size", "16", "--variant", "v5",
        "--output-dir", str(s1_dir), "--epochs", str(args.stage1_epochs),
        "--batch-size", str(args.batch_size), *bf16, *dev,
    ])
    s1_ckpt = s1_dir / "v5_stage1_best_variables.npz"
    record_best("stage1", s1_dir / "v5_stage1_history.json")

    # --- stage 2 (010, full stage-1 state seed) ------------------------------
    s2_dir = out / "stage2"
    step("stage2", train_stage2.main, [
        "--dataset-dir", str(ds), "--block-size", "16", "--variant", "v5",
        "--output-dir", str(s2_dir), "--epochs", str(args.stage2_epochs),
        "--batch-size", str(args.batch_size),
        "--stage1-checkpoint", str(s1_ckpt), *bf16, *dev,
    ])
    s2_ckpt = s2_dir / "v5_stage2_best_variables.npz"
    record_best("stage2", s2_dir / "v5_stage2_history.json")

    # --- stage 3 specialists (012, stage-2 seed) -----------------------------
    s3_dir = out / "stage3"
    for head in heads:
        step(f"stage3_{head}", train_stage3.main, [
            "--head", head, "--variant", "v5",
            "--dataset-dir", str(stage3_dir), "--block-size", "16",
            "--batch-size", str(args.batch_size), *bf16,
            "--output-dir", str(s3_dir),
            "--epochs", str(args.stage3_epochs),
            "--stage2-checkpoint", str(s2_ckpt), *dev,
        ])
        record_best(
            f"stage3_{head}", s3_dir / f"v5_stage3_{head}_history.json"
        )

    # --- merge (013:66-94) + fused pipeline eval (013) -----------------------
    merged = merge_v5_pipeline_variables(
        load_model_variables(s2_ckpt),
        {
            head: load_model_variables(
                s3_dir / f"v5_stage3_{head}_best_variables.npz"
            )
            for head in heads
        },
    )
    merged_path = out / "v5_pipeline_variables.npz"
    save_variables_npz(merged_path, merged)

    pipe_dir = out / "pipeline"
    step("pipeline_eval", run_pipeline_eval.main, [
        "--variant", "v5", "--dataset-dir", str(ds), "--block-size", "16",
        "--output-dir", str(pipe_dir), "--v5-checkpoint", str(merged_path),
        "--batch-size", "4096", "--available-specialists", *heads,
        *dev,
    ])
    pipe = json.loads((pipe_dir / "pipeline_metrics_val.json").read_text())
    results["pipeline"] = {
        "accuracy": round(pipe["metrics"]["accuracy"], 4),
        "macro_f1": round(pipe["metrics"]["macro_f1"], 4),
        "throughput_blocks_per_sec": round(
            pipe["throughput_superblocks_per_sec"], 1
        ),
    }
    results["reference_block16"] = {
        "note": "measured on the reference's private real dataset — "
                "directional context only",
        "stage1_f1": 0.6519, "stage2_macro_f1": 0.3341,
        "pipeline_accuracy": 0.3956,
    }

    (out / "RESULTS.json").write_text(json.dumps(results, indent=2))
    lines = [
        "# v5 ladder at dataset scale", "",
        f"corpus: train={results['corpus']['train']} "
        f"val={results['corpus']['val']} (scale={args.scale})", "",
        "| stage | best val macro-F1 | best val acc | wall (s) |",
        "|---|---|---|---|",
    ]
    for name, st in results["stages"].items():
        if "best_val_macro_f1" in st:
            lines.append(
                f"| {name} | {st['best_val_macro_f1']} | "
                f"{st['best_val_accuracy']} | {st['wall_seconds']} |"
            )
    lines += [
        "",
        f"pipeline (merged, fused eval): accuracy="
        f"{results['pipeline']['accuracy']} "
        f"macro_f1={results['pipeline']['macro_f1']} "
        f"({results['pipeline']['throughput_blocks_per_sec']} blocks/s)",
        "",
        "reference block-16 context (real data): stage1 F1 0.6519, "
        "stage2 macro-F1 0.3341, pipeline accuracy 0.3956",
    ]
    (out / "RESULTS.md").write_text("\n".join(lines) + "\n")
    print(json.dumps(results, indent=2))


if __name__ == "__main__":
    main()
