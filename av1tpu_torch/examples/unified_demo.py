"""Unified single-backbone family at dataset scale — the measured trade.

Trains the v6 per-stage ladder (stage1 -> stage2 ULMFiT -> RECT -> AB FGVC,
the scale_demo recipes) and then the unified single-backbone model twice —
plain multi-task and distilled from the trained ladder — on the same
reference-shaped corpus, and measures what the family actually buys:

* accuracy: composed final 8-class acc / macro-F1 on val, per-stage
  cascade vs unified (plain and distilled), each at its best stage-1
  operating point (one dense forward, thresholds swept on the host — the
  reference's 007 optimizer semantics);
* serving throughput: BN-folded per-stage vs BN-folded unified on
  ``--device`` at trained weights, in superblocks per second: the uint16
  batch is uploaded before the clock starts, five calls (kernel builds,
  cuDNN's first picks) are warm-up, and the card is synchronised before each
  clock read. ``--fused-front`` serves both through kernel K1 or K2.

Emits ``<out>/RESULTS.{json,md}``. Reuse a prior scale_demo/unified_demo
directory with --ladder to skip retraining the per-stage checkpoints.

    python -m av1tpu_torch.examples.unified_demo --out runs/unified_demo \
        [--scale 1.0] [--fused-front g1] [--device cuda]
"""
import argparse
import json
import time
from pathlib import Path

import numpy as np
import torch

from av1tpu_torch.cli import (
    prepare_stage3,
    train_stage1,
    train_stage2,
    train_stage3,
    train_unified,
)
from av1tpu_torch.cli.common import load_model, load_split
from av1tpu_torch.codec.partitions import raw_to_v6_final
from av1tpu_torch.data import build_v6_bundle
from av1tpu_torch.data.bundles import save_split
from av1tpu_torch.data.synth import reference_shaped_corpus
from av1tpu_torch.eval import (
    PipelineModels,
    compute_metrics,
    make_unified_pipeline,
    make_unified_pipeline_folded,
    make_v6_pipeline,
    make_v6_pipeline_folded,
    run_pipeline_batched,
)
from av1tpu_torch.eval.hierarchy import v6_route
from av1tpu_torch.examples._common import (
    FUSED_FRONT,
    Steps,
    add_device_arg,
    add_fused_front_arg,
    parse_example_args,
    synchronize,
)
from av1tpu_torch.models import (
    FGVCModel,
    Stage1Model,
    Stage2Model,
    Stage3RectModel,
    UnifiedV6Model,
)

THRESHOLD_GRID = [round(float(t), 2) for t in np.arange(0.20, 0.81, 0.05)]


def sweep_final_metrics(out, raw_labels, grid=THRESHOLD_GRID):
    """One dense pipeline pass -> composed final metrics at every stage-1
    threshold (host-side re-threshold of stage1_prob; every other head's
    argmax is threshold-independent). Returns (best_row, all_rows)."""
    labels = raw_to_v6_final(np.asarray(raw_labels))
    rows = []
    for thr in grid:
        s1_pred = (out["stage1_prob"] >= thr).astype(np.int32)
        final = v6_route(*(torch.as_tensor(np.asarray(a)) for a in (
            s1_pred, out["stage2_pred"], out["stage3_rect_pred"],
            out["stage3_ab_pred"]))).numpy()
        m = compute_metrics(labels, final)
        rows.append({
            "threshold": thr,
            "accuracy": round(m["accuracy"], 4),
            "macro_f1": round(m["macro_f1"], 4),
        })
    best = max(rows, key=lambda r: r["macro_f1"])
    return best, rows


def time_folded(predict, batch, device, iters=30):
    """Superblocks per second of ``predict`` on one uint16 batch already on
    ``device``; the first five calls are warm-up."""
    images = torch.from_numpy(
        np.random.default_rng(0).integers(0, 1024, size=(batch, 16, 16, 1))
        .astype(np.uint16)
    ).to(device)
    for _ in range(5):
        predict(images)
    synchronize(device)
    start = time.perf_counter()
    for _ in range(iters):
        predict(images)
    synchronize(device)
    return batch * iters / (time.perf_counter() - start)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--out", type=Path, default=Path("runs/unified_demo"))
    parser.add_argument("--ladder", type=Path, default=None,
                        help="existing scale_demo/unified_demo out dir: "
                        "reuse its v6_dataset + per-stage checkpoints")
    parser.add_argument("--scale", type=float, default=1.0)
    parser.add_argument("--batch-size", type=int, default=256)
    parser.add_argument("--epochs", type=int, default=30)
    parser.add_argument("--distill-weight", type=float, default=0.5)
    parser.add_argument("--bf16", action=argparse.BooleanOptionalAction,
                        default=True)
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--throughput-batch", type=int, default=8192)
    parser.add_argument("--skip-throughput", action="store_true")
    add_fused_front_arg(parser)
    add_device_arg(parser)
    args = parse_example_args(parser, argv)
    device = torch.device(args.device)

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
            "train_samples_per_sec": round(
                float(np.mean([h.get("throughput", 0.0) for h in hist])), 1
            ),
        })

    # --- corpus + per-stage ladder (or reuse) -------------------------------
    if args.ladder is not None:
        ladder = Path(args.ladder)
        ds = ladder / "v6_dataset"
        s1_ckpt = ladder / "stage1" / "stage1_best_variables.npz"
        s2_ckpt = ladder / "stage2" / "stage2_best_variables.npz"
        rect_ckpt = (
            ladder / "stage3_rect" / "stage3_rect_best_variables.npz"
        )
        ab_ckpt = (
            ladder / "stage3_ab" / "stage3_ab_fgvc_best_variables.npz"
        )
        results["ladder"] = str(ladder)
    else:
        t0 = time.perf_counter()
        train_set, val_set = reference_shaped_corpus(args.seed, scale=args.scale)
        ds = out / "v6_dataset"
        save_split(
            ds, 16, build_v6_bundle(train_set), build_v6_bundle(val_set), "v6"
        )
        results["corpus"] = {
            "train": len(train_set.labels), "val": len(val_set.labels),
            "build_seconds": round(time.perf_counter() - t0, 1),
        }
        print(f"corpus: {results['corpus']}", flush=True)

        stage3_dir = out / "stage3_datasets"
        step("prepare_stage3", prepare_stage3.main, [
            "--dataset-dir", str(ds), "--out", str(stage3_dir),
            "--block-size", "16",
        ])
        s1_dir = out / "stage1"
        step("stage1", train_stage1.main, [
            "--dataset-dir", str(ds), "--block-size", "16",
            "--output-dir", str(s1_dir), "--epochs", str(args.epochs),
            "--batch-size", str(args.batch_size), *bf16, *dev,
        ])
        s1_ckpt = s1_dir / "stage1_best_variables.npz"
        record_best("stage1", s1_dir / "stage1_history.json")

        s2_dir = out / "stage2"
        step("stage2", train_stage2.main, [
            "--dataset-dir", str(ds), "--block-size", "16",
            "--output-dir", str(s2_dir), "--epochs", str(args.epochs),
            "--freeze-epochs", "5", "--batch-size", str(args.batch_size),
            "--stage1-checkpoint", str(s1_ckpt), *bf16, *dev,
        ])
        s2_ckpt = s2_dir / "stage2_best_variables.npz"
        record_best("stage2", s2_dir / "stage2_history.json")

        rect_dir = out / "stage3_rect"
        step("stage3_rect", train_stage3.main, [
            "--head", "RECT",
            "--dataset-dir", str(stage3_dir), "--block-size", "16",
            "--output-dir", str(rect_dir), "--epochs", str(args.epochs),
            "--batch-size", str(args.batch_size),
            "--stage2-checkpoint", str(s2_ckpt), *bf16, *dev,
        ])
        rect_ckpt = rect_dir / "stage3_rect_best_variables.npz"
        record_best("stage3_rect", rect_dir / "stage3_rect_history.json")

        ab_dir = out / "stage3_ab"
        step("stage3_ab_fgvc", train_stage3.main, [
            "--head", "AB", "--fgvc",
            "--dataset-dir", str(stage3_dir), "--block-size", "16",
            "--output-dir", str(ab_dir), "--epochs", str(args.epochs),
            "--batch-size", "128",
            "--stage2-checkpoint", str(s2_ckpt), *bf16, *dev,
        ])
        ab_ckpt = ab_dir / "stage3_ab_fgvc_best_variables.npz"
        record_best("stage3_ab_fgvc", ab_dir / "stage3_ab_fgvc_history.json")

    # --- unified: plain multi-task ------------------------------------------
    uni_dir = out / "unified"
    step("unified", train_unified.main, [
        "--dataset-dir", str(ds), "--block-size", "16",
        "--output-dir", str(uni_dir), "--epochs", str(args.epochs),
        "--batch-size", str(args.batch_size), *bf16, *dev,
    ])
    uni_ckpt = uni_dir / "unified_best_variables.npz"
    record_best("unified", uni_dir / "unified_history.json")

    # --- unified: distilled from the trained ladder --------------------------
    kd_dir = out / "unified_kd"
    step("unified_kd", train_unified.main, [
        "--dataset-dir", str(ds), "--block-size", "16",
        "--output-dir", str(kd_dir), "--epochs", str(args.epochs),
        "--batch-size", str(args.batch_size),
        "--distill-weight", str(args.distill_weight),
        "--stage1-checkpoint", str(s1_ckpt),
        "--stage2-checkpoint", str(s2_ckpt),
        "--stage3-rect-checkpoint", str(rect_ckpt),
        "--stage3-ab-checkpoint", str(ab_ckpt), *bf16, *dev,
    ])
    kd_ckpt = kd_dir / "unified_best_variables.npz"
    record_best("unified_kd", kd_dir / "unified_history.json")

    # --- composed-final accuracy, each family at its best threshold ----------
    _, val_b, _ = load_split(ds, 16)
    dtype = torch.bfloat16 if args.bf16 else torch.float32
    raw = val_b.labels["stage0"]

    models = PipelineModels(
        load_model(s1_ckpt, Stage1Model), load_model(s2_ckpt, Stage2Model),
        load_model(rect_ckpt, Stage3RectModel), load_model(ab_ckpt, FGVCModel),
    )
    print("\n=== val sweeps (dense pass per family, thresholds on host) ===",
          flush=True)
    cascade_out = run_pipeline_batched(
        make_v6_pipeline(models, stage1_threshold=0.5, input_dtype=dtype,
                         device=device),
        val_b.samples, device=device,
    )
    best_cascade, rows_cascade = sweep_final_metrics(cascade_out, raw)
    results["val"] = {"cascade": {**best_cascade, "sweep": rows_cascade}}
    print(f"cascade best: {best_cascade}", flush=True)

    unified_models = {name: load_model(ckpt, UnifiedV6Model)
                      for name, ckpt in (("unified", uni_ckpt), ("unified_kd", kd_ckpt))}
    for name, model in unified_models.items():
        uni_out = run_pipeline_batched(
            make_unified_pipeline(model, stage1_threshold=0.5, input_dtype=dtype,
                                  device=device),
            val_b.samples, device=device,
        )
        best_uni, rows_uni = sweep_final_metrics(uni_out, raw)
        results["val"][name] = {**best_uni, "sweep": rows_uni}
        print(f"{name} best: {best_uni}", flush=True)

    # --- serving throughput, trained weights, BN-folded ---------------------
    if not args.skip_throughput:
        print("\n=== folded serving throughput (trained weights) ===",
              flush=True)
        front = FUSED_FRONT[args.fused_front]
        thr_cascade = time_folded(
            make_v6_pipeline_folded(
                models, stage1_threshold=0.45, float_dtype=dtype,
                use_fused_front=front, device=device,
            ),
            args.throughput_batch, device,
        )
        best_u = None
        unified_folded = make_unified_pipeline_folded(
            unified_models["unified_kd"], stage1_threshold=0.45,
            float_dtype=dtype, use_fused_front=front, device=device,
        )
        for batch in (args.throughput_batch, 4 * args.throughput_batch):
            t = time_folded(unified_folded, batch, device)
            if best_u is None or t > best_u[0]:
                best_u = (t, batch)
        results["throughput"] = {
            "folded_cascade_sb_per_sec": round(thr_cascade, 1),
            "folded_unified_sb_per_sec": round(best_u[0], 1),
            "unified_batch": best_u[1],
            "speedup": round(best_u[0] / thr_cascade, 2),
            "fused_front": args.fused_front,
            "device": (torch.cuda.get_device_name(device)
                       if device.type == "cuda" else "cpu"),
        }
        print(f"throughput: {results['throughput']}", flush=True)

    (out / "RESULTS.json").write_text(json.dumps(results, indent=2))

    lines = [
        "# Unified single-backbone family at dataset scale", "",
        f"corpus scale {args.scale}, {args.epochs} epochs/stage, bf16={args.bf16}",
        "",
        "| family | best thr | val acc | val macro-F1 |",
        "|---|---|---|---|",
    ]
    for name in ("cascade", "unified", "unified_kd"):
        r = results["val"][name]
        lines.append(
            f"| {name} | {r['threshold']} | {r['accuracy']} | {r['macro_f1']} |"
        )
    if "throughput" in results:
        t = results["throughput"]
        lines += [
            "",
            f"Folded serving on {t['device']} (--fused-front {t['fused_front']}): "
            f"cascade {t['folded_cascade_sb_per_sec']:,} sb/s "
            f"vs unified {t['folded_unified_sb_per_sec']:,} sb/s "
            f"(**{t['speedup']}x**, batch {t['unified_batch']}).",
        ]
    (out / "RESULTS.md").write_text("\n".join(lines) + "\n")
    print(f"\nwrote {out/'RESULTS.json'} and RESULTS.md", flush=True)


if __name__ == "__main__":
    main()
