"""North-star measurement: per-size ladders + composed partition-tree accuracy.

Trains the four per-block-size v6 ladders (64/32/16/8: stage1 + stage2 +
stage3 RECT + stage3 AB FGVC) on a tree-structured synthetic corpus whose
ground-truth trees are known by construction (``data/synth_tree.py`` —
per-size training blocks extracted from the SAME superblocks, like the real
encoder-dump data path), then:

  1. packs held-out superblocks into real YUV 4:2:0 10-bit frames,
  2. runs the public ``cli.predict_trees`` over them (ingest -> tiling ->
     4-level cascade -> 85-slot trees),
  3. scores the predicted trees against ground truth
     (``eval.tree_metrics``: per-level node accuracy, exact-tree match).

``RESULTS.json`` has the JAX package's layout, so either package's
``tta_eval`` reads a directory that either package's ``tree_demo`` wrote.
``--fused-front on|g1`` serves the folded variants through kernel K1 or K2;
their trees go to ``trees_<variant>_<front>`` and their scores under that
name, so a ``--resume`` run with another front adds its trees beside the
first's.

    python -m av1tpu_torch.examples.tree_demo --out runs/tree_demo \
        [--train-superblocks 12000 --val-superblocks 2400] [--device cuda]
"""
import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

from av1tpu_torch.cli import (
    optimize_thresholds,
    predict_trees,
    prepare_stage3,
    train_stage1,
    train_stage2,
    train_stage3,
    train_unified,
)
from av1tpu_torch.data import build_v6_bundle
from av1tpu_torch.data.bundles import save_split
from av1tpu_torch.data.synth_tree import tree_corpus
from av1tpu_torch.eval.tree_metrics import tree_accuracy
from av1tpu_torch.examples._common import (
    FRAME_H,
    FRAME_W,
    SB_PER_FRAME,
    Steps,
    add_device_arg,
    add_fused_front_arg,
    pack_yuv,
    parse_example_args,
)

# the config keys a --resume run must share with the run it resumes
GUARDED = ("train_superblocks", "val_superblocks", "batch_size",
           "stage1_epochs", "stage2_epochs", "stage3_epochs",
           "freeze_epochs", "calibrate", "bf16", "seed",
           "unified_kd", "unified_epochs", "distill_weight")
HISTORIES = (
    ("stage1", "stage1_history.json"),
    ("stage2", "stage2_history.json"),
    ("stage3_rect", "stage3_rect_history.json"),
    ("stage3_ab", "stage3_ab_fgvc_history.json"),
)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--out", type=Path, default=Path("runs/tree_demo"))
    parser.add_argument("--train-superblocks", type=int, default=12000)
    parser.add_argument("--val-superblocks", type=int, default=2400,
                        help="must be a multiple of 240 (superblocks/frame)")
    parser.add_argument("--batch-size", type=int, default=256)
    parser.add_argument("--stage1-epochs", type=int, default=15)
    parser.add_argument("--stage2-epochs", type=int, default=15)
    parser.add_argument("--stage3-epochs", type=int, default=15)
    parser.add_argument("--freeze-epochs", type=int, default=3)
    parser.add_argument("--stage1-threshold", type=float, default=0.45)
    parser.add_argument("--calibrate", action="store_true",
                        help="run optimize_thresholds per size and predict "
                        "with each level's calibrated gate")
    parser.add_argument("--folded", action="store_true",
                        help="predict through the BN-folded serving graphs")
    parser.add_argument("--bf16", action=argparse.BooleanOptionalAction,
                        default=True,
                        help="bf16 compute (default; --no-bf16 for float32)")
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--unified-kd", action="store_true",
                        help="additionally train a unified single-backbone "
                        "family per size, distilled from that size's "
                        "trained ladder (cli.train_unified), and score the "
                        "'unified'/'unified_tta' tree variants with it")
    parser.add_argument("--unified-epochs", type=int, default=20)
    parser.add_argument("--distill-weight", type=float, default=0.5)
    parser.add_argument("--variants", nargs="+", default=["ladder"],
                        choices=["ladder", "ladder_tta", "unified",
                                 "unified_tta"],
                        help="tree-prediction variants to score; the first "
                        "one is reported as the primary tree_accuracy")
    parser.add_argument("--sizes", type=int, nargs="+",
                        default=[64, 32, 16, 8])
    parser.add_argument("--resume", action="store_true",
                        help="skip steps whose completion artifacts already "
                        "exist under --out (each stage writes its "
                        "*_history.json only on completion, so an "
                        "interrupted stage reruns from scratch); requires "
                        "the prior run's config to match")
    add_fused_front_arg(parser)
    add_device_arg(parser)
    return parser


def variant_flags(variant: str, folded: bool, fused_front: str) -> list:
    """``predict_trees``' serving flags of one tree variant."""
    fold = ["--folded"] if folded else []
    flags = {
        "ladder": fold,
        "ladder_tta": ["--tta"],
        "unified": ["--unified"] + fold,
        "unified_tta": ["--unified", "--tta"],
    }[variant]
    if fused_front != "off" and "--folded" in flags:
        flags += ["--fused-front", fused_front]
    return flags


def variant_name(variant: str, flags: list) -> str:
    """The variant's key in RESULTS.json (its front appended when fused)."""
    if "--fused-front" in flags:
        return f"{variant}_{flags[flags.index('--fused-front') + 1]}"
    return variant


def main(argv=None):
    parser = build_parser()
    args = parse_example_args(parser, argv)
    assert args.val_superblocks % SB_PER_FRAME == 0
    if args.fused_front != "off" and not args.folded:
        parser.error("--fused-front needs --folded")

    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    prev = {}
    if args.resume and (out / "RESULTS.json").exists():
        prev = json.loads((out / "RESULTS.json").read_text())
        mismatch = {
            k: (prev.get("config", {}).get(k), getattr(args, k))
            for k in GUARDED
            if prev.get("config", {}).get(k) != getattr(args, k)
        }
        if mismatch:
            sys.exit(f"--resume: config mismatch vs {out / 'RESULTS.json'} "
                     f"(prev, new): {mismatch}")
    config = {k: str(v) if isinstance(v, Path) else v for k, v in vars(args).items()}
    results = {"config": config | {"out": str(out), "sizes": args.sizes},
               "sizes": {}}
    if prev:
        results["resumed"] = True
    bf16 = ["--bf16"] if args.bf16 else []
    dev = ["--device", args.device]
    step = Steps(args.device, resume=args.resume)

    def write_results():
        (out / "RESULTS.json").write_text(json.dumps(results, indent=2))

    # --- corpora -------------------------------------------------------------
    t0 = time.perf_counter()
    _, train_trees, train_sets = tree_corpus(
        args.train_superblocks, seed=args.seed
    )
    val_sbs, val_trees, val_sets = tree_corpus(
        args.val_superblocks, seed=args.seed + 1
    )
    np.save(out / "val_trees_truth.npy", val_trees)
    results["corpus"] = {
        "train_superblocks": args.train_superblocks,
        "val_superblocks": args.val_superblocks,
        "per_size_train_blocks": {
            str(s): len(bs.labels) for s, bs in train_sets.items()
        },
        "build_seconds": round(time.perf_counter() - t0, 1),
    }
    print(f"corpus: {results['corpus']}", flush=True)

    yuv_path = out / f"val_{FRAME_W}x{FRAME_H}_30.yuv"
    frames = pack_yuv(val_sbs, yuv_path)

    # --- per-size ladders ----------------------------------------------------
    for size in args.sizes:
        sdir = out / f"size_{size}"
        ds = sdir / "dataset"
        models = sdir / "models"
        if not (args.resume
                and (ds / f"block_{size}" / "metadata.json").exists()):
            save_split(
                ds, size, build_v6_bundle(train_sets[size]),
                build_v6_bundle(val_sets[size]), "v6",
            )
        # carry forward measured walls for steps --resume skips below
        szres = {
            k: v
            for k, v in prev.get("sizes", {}).get(str(size), {}).items()
            if k.endswith("_wall")
        }

        def timed_step(key, name, fn, argv, done):
            wall = step(name, fn, argv, done=done)
            if wall is not None:
                szres[key] = round(wall, 1)

        stage3_dir = sdir / "stage3_datasets"
        step(f"prepare_stage3[{size}]", prepare_stage3.main, [
            "--dataset-dir", str(ds), "--out", str(stage3_dir),
            "--block-size", str(size), "--ensemble-members", "0",
        ], done=[stage3_dir / h / f"block_{size}" / "metadata.json"
                 for h in ("RECT", "AB")])
        common = ["--dataset-dir", str(ds), "--block-size", str(size),
                  "--batch-size", str(args.batch_size), *bf16]
        timed_step("stage1_wall", f"stage1[{size}]", train_stage1.main, [
            *common, "--output-dir", str(models),
            "--epochs", str(args.stage1_epochs), *dev,
        ], models / "stage1_history.json")
        s1_ckpt = models / "stage1_best_variables.npz"
        if args.calibrate:
            step(f"calibrate[{size}]", optimize_thresholds.main, [
                "--dataset-dir", str(ds), "--block-size", str(size),
                "--stage1-checkpoint", str(s1_ckpt),
                "--output-dir", str(sdir / "calibration"),
                "--grid", "0.30", "0.70", "0.05", *bf16, *dev,
            ], done=sdir / "calibration" / "threshold_summary.json")
            summary = json.loads(
                (sdir / "calibration" / "threshold_summary.json").read_text()
            )
            szres["calibrated_threshold"] = summary["f1"]["threshold"]
        timed_step("stage2_wall", f"stage2[{size}]", train_stage2.main, [
            *common, "--output-dir", str(models),
            "--epochs", str(args.stage2_epochs),
            "--freeze-epochs", str(args.freeze_epochs),
            "--stage1-checkpoint", str(s1_ckpt), *dev,
        ], models / "stage2_history.json")
        s2_ckpt = models / "stage2_best_variables.npz"
        timed_step("stage3_rect_wall", f"stage3_rect[{size}]", train_stage3.main, [
            "--head", "RECT",
            "--dataset-dir", str(stage3_dir), "--block-size", str(size),
            "--batch-size", str(args.batch_size), *bf16,
            "--output-dir", str(models),
            "--epochs", str(args.stage3_epochs),
            "--stage2-checkpoint", str(s2_ckpt), *dev,
        ], models / "stage3_rect_history.json")
        timed_step("stage3_ab_wall", f"stage3_ab[{size}]", train_stage3.main, [
            "--head", "AB", "--fgvc",
            "--dataset-dir", str(stage3_dir), "--block-size", str(size),
            "--batch-size", "128", *bf16,
            "--output-dir", str(models),
            "--epochs", str(args.stage3_epochs),
            "--stage2-checkpoint", str(s2_ckpt), *dev,
        ], models / "stage3_ab_fgvc_history.json")
        if args.unified_kd:
            timed_step("unified_wall", f"unified_kd[{size}]", train_unified.main, [
                *common, "--output-dir", str(models),
                "--epochs", str(args.unified_epochs),
                "--distill-weight", str(args.distill_weight),
                "--stage1-checkpoint", str(s1_ckpt),
                "--stage2-checkpoint", str(s2_ckpt),
                "--stage3-rect-checkpoint",
                str(models / "stage3_rect_best_variables.npz"),
                "--stage3-ab-checkpoint",
                str(models / "stage3_ab_fgvc_best_variables.npz"), *dev,
            ], models / "unified_history.json")
            if args.calibrate:
                step(f"calibrate_unified[{size}]", optimize_thresholds.main, [
                    "--dataset-dir", str(ds), "--block-size", str(size),
                    "--unified-checkpoint",
                    str(models / "unified_best_variables.npz"),
                    "--output-dir", str(sdir / "calibration_unified"),
                    "--grid", "0.30", "0.70", "0.05", *bf16, *dev,
                ], done=sdir / "calibration_unified" / "threshold_summary.json")
                uni_summary = json.loads(
                    (sdir / "calibration_unified" / "threshold_summary.json")
                    .read_text()
                )
                szres["unified_calibrated_threshold"] = (
                    uni_summary["f1"]["threshold"]
                )
            uh = json.loads((models / "unified_history.json").read_text())
            szres["unified_best_macro_f1"] = round(
                max(e["val_metrics"]["macro_f1"] for e in uh), 4
            )
        for stage, hist in HISTORIES:
            h = json.loads((models / hist).read_text())
            szres[f"{stage}_best_macro_f1"] = round(
                max(e["val_metrics"]["macro_f1"] for e in h), 4
            )
        results["sizes"][str(size)] = szres
        write_results()

    # --- composed tree prediction via the public CLI -------------------------
    if set(args.sizes) != {64, 32, 16, 8}:
        # predict_trees needs all four per-size model dirs; a subset run
        # still produced its ladders + per-stage F1s above
        print(f"sizes {args.sizes} != [64, 32, 16, 8]: skipping composed "
              "tree prediction (train-only run)", flush=True)
        write_results()
        return

    def thresholds_for(variant):
        """predict_trees takes per-size thresholds positionally in
        64/32/16/8 order, independent of --sizes ordering."""
        if not args.calibrate:
            return [str(args.stage1_threshold)]
        key = (
            "unified_calibrated_threshold"
            if variant.startswith("unified") else "calibrated_threshold"
        )
        return [
            str(results["sizes"][str(s)].get(
                key, results["sizes"][str(s)]["calibrated_threshold"]
            ))
            for s in (64, 32, 16, 8)
        ]

    variants = list(dict.fromkeys(args.variants))
    results.setdefault("tree_accuracy_variants", {}).update(
        prev.get("tree_accuracy_variants", {})
    )
    primary = None
    for variant in variants:
        if variant.startswith("unified") and not args.unified_kd:
            sys.exit(f"variant {variant} requires --unified-kd")
        flags = variant_flags(variant, args.folded, args.fused_front)
        name = variant_name(variant, flags)
        tree_out = out / ("trees" if name == "ladder" else f"trees_{name}")
        wall = step(f"predict_trees[{name}]", predict_trees.main, [
            "--yuv", str(yuv_path),
            "--frames", *[str(i) for i in range(frames)],
            # one cascade dispatch per 10 frames: the per-level chain of
            # launches is paid once for ten frames
            "--frames-per-batch", "10",
            *[a for s in args.sizes
              for a in (f"--models-{s}", str(out / f"size_{s}" / "models"))],
            "--output-dir", str(tree_out),
            "--stage1-threshold", *thresholds_for(variant),
            *flags,
            *bf16, *dev,
        ], done=tree_out / "tree_stats.json")

        pred_trees = np.concatenate([
            np.load(tree_out / f"trees_frame{i}.npz")["trees"]
            for i in range(frames)
        ])
        acc = tree_accuracy(pred_trees, val_trees)
        if wall is None:  # --resume skipped the predict step
            wall = (
                results["tree_accuracy_variants"]
                .get(name, {})
                .get("predict_wall_seconds", 0.0)
            )
        acc["predict_wall_seconds"] = round(wall, 1)
        results["tree_accuracy_variants"][name] = acc
        if primary is None:
            primary = acc
            results["tree_accuracy"] = acc
        write_results()
        print(f"[{name}] node={acc['node_accuracy']:.4f} "
              f"exact={acc['exact_tree_match']:.4f}", flush=True)

    acc = results["tree_accuracy"]  # primary (first) variant
    lines = [
        "# Tree composition results", "",
        f"Corpus: {args.train_superblocks:,} train / "
        f"{args.val_superblocks:,} val superblocks", "",
        "| block size | train blocks | s1 F1 | s2 F1 | rect F1 | ab F1 | "
        "node acc |",
        "|---|---|---|---|---|---|---|",
    ]
    for lv in acc["per_level"]:
        s = str(lv["block_size"])
        r = results["sizes"].get(s, {})
        lines.append(
            f"| {s} | "
            f"{results['corpus']['per_size_train_blocks'].get(s, '-')} | "
            f"{r.get('stage1_best_macro_f1', '-')} | "
            f"{r.get('stage2_best_macro_f1', '-')} | "
            f"{r.get('stage3_rect_best_macro_f1', '-')} | "
            f"{r.get('stage3_ab_best_macro_f1', '-')} | "
            f"{lv['node_accuracy']:.4f} |"
        )
    lines += [
        "",
        f"Overall node accuracy: {acc['node_accuracy']:.4f}",
        f"Exact-tree match: {acc['exact_tree_match']:.4f}",
        f"Structure accuracy: {acc['structure_accuracy']:.4f}",
    ]
    if len(results["tree_accuracy_variants"]) > 1:
        lines += [
            "", "| variant | node acc | exact tree | structure |",
            "|---|---|---|---|",
        ]
        for v, a in results["tree_accuracy_variants"].items():
            lines.append(
                f"| {v} | {a['node_accuracy']:.4f} | "
                f"{a['exact_tree_match']:.4f} | "
                f"{a['structure_accuracy']:.4f} |"
            )
    (out / "RESULTS.md").write_text("\n".join(lines) + "\n")
    print("\n".join(lines))


if __name__ == "__main__":
    main()
