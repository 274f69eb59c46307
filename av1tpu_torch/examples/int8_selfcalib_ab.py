"""A/B certification of ``predict_trees --int8`` self-serve calibration.

The int8 hybrid lowering (quant/ptq.py) normally calibrates on a held-out
dataset sample; the ``--int8`` CLI path instead calibrates each level on
the input video's OWN blocks (no calibration set ships with the model).
This harness certifies that shortcut on trained checkpoints: it runs the
SAME structured clip through the public CLI in paired serving modes on
identical weights and scores inter-path tree agreement plus warm
per-frame wall clock:

    folded (bf16 reference formulation)  vs  --int8 (self-calibrated)
    --unified folded                     vs  --unified --int8

Tree agreement here is the deployment-level metric — do the quantized
graphs emit the same 85-slot partition trees the bf16 graphs would —
complementing the logit-level certification in ``cli.certify_serving``
(which uses a proper calibration split). ``--fused-front on`` serves every
mode's 16 and 8 px levels through kernel K1 (the int8 graph has no group-1
hook, so no ``g1``). Warm superblocks per second come from the CLI's own
per-frame seconds, the first frame (level builds, the int8 calibration)
left out.

    python -m av1tpu_torch.examples.int8_selfcalib_ab \
        --models runs/unified_demo --out runs/int8_ab [--device cuda]
"""
import argparse
import json
from pathlib import Path

import numpy as np

from av1tpu_torch.cli import predict_trees
from av1tpu_torch.data.synth_tree import tree_corpus
from av1tpu_torch.examples._common import (
    FRAME_H,
    FRAME_W,
    SB_PER_FRAME,
    add_device_arg,
    add_fused_front_arg,
    assemble_models_dir,
    pack_yuv,
    parse_example_args,
    timed,
)


def run_mode(yuv: Path, models: Path, out: Path, frames, extra,
             device="cuda", fused_front: str = "off"):
    argv = [
        "--yuv", str(yuv), "--frames", *[str(f) for f in frames],
        "--models-64", str(models), "--models-32", str(models),
        "--models-16", str(models), "--models-8", str(models),
        "--output-dir", str(out), "--batch-size", "4096",
        "--no-ab-fgvc", "--bf16", "--single-device", *extra,
        "--device", str(device),
        *(["--fused-front", fused_front] if fused_front != "off" else []),
    ]
    _, wall = timed(lambda: predict_trees.main(argv), device)
    stats = json.loads((out / "tree_stats.json").read_text())
    trees = np.stack(
        [np.load(out / f"trees_frame{f}.npz")["trees"] for f in frames]
    )
    # warm per-frame seconds: skip the first frame (carries the level
    # builds and, for --int8, the self-calibration quantization)
    warm = [stats[str(f)]["seconds"] for f in frames[1:]]
    return {
        "trees": trees,
        "wall_s": round(wall, 2),
        "warm_frame_s": round(float(np.median(warm)), 4) if warm else None,
        "warm_sb_per_s": (
            round(SB_PER_FRAME / float(np.median(warm)), 1) if warm else None
        ),
    }


def agreement(a: np.ndarray, b: np.ndarray) -> dict:
    """Node-level + exact-tree agreement over 85-slot trees (slot value
    -1 = node absent; structural disagreement counts as disagreement)."""
    assert a.shape == b.shape
    node = float((a == b).mean())
    flat_a = a.reshape(-1, a.shape[-1])
    flat_b = b.reshape(-1, b.shape[-1])
    exact = float((flat_a == flat_b).all(axis=1).mean())
    return {"node_agreement": round(node, 4), "exact_tree": round(exact, 4)}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--models", type=Path, required=True,
                    help="training-run dir (per-stage subdirs) or a flat "
                    "dir already holding *_best_variables.npz")
    ap.add_argument("--out", type=Path, default=Path("runs/int8_ab"))
    ap.add_argument("--frames", type=int, default=6)
    ap.add_argument("--seed", type=int, default=7)
    add_fused_front_arg(ap, choices=("off", "on"))
    add_device_arg(ap)
    args = parse_example_args(ap, argv)

    args.out.mkdir(parents=True, exist_ok=True)
    n_sbs = args.frames * SB_PER_FRAME
    sbs, _, _ = tree_corpus(n_sbs, seed=args.seed)
    yuv = args.out / f"clip_{FRAME_W}x{FRAME_H}_ab.yuv"
    pack_yuv(sbs, yuv)

    models = args.out / "models"
    assemble_models_dir(args.models, models)
    frames = list(range(args.frames))

    modes = {
        "folded": ["--folded"],
        "int8": ["--int8"],
    }
    if (models / "unified_best_variables.npz").exists():
        modes["unified_folded"] = ["--unified", "--folded"]
        modes["unified_int8"] = ["--unified", "--int8"]
    runs = {}
    for name, extra in modes.items():
        print(f"== mode {name}", flush=True)
        runs[name] = run_mode(
            yuv, models, args.out / f"trees_{name}", frames, extra,
            device=args.device, fused_front=args.fused_front,
        )

    report = {
        "clip": {"frames": args.frames, "superblocks": n_sbs,
                 "resolution": f"{FRAME_W}x{FRAME_H}", "seed": args.seed},
        "device": args.device,
        "fused_front": args.fused_front,
        "modes": {
            k: {kk: vv for kk, vv in v.items() if kk != "trees"}
            for k, v in runs.items()
        },
        "agreement": {},
    }
    pairs = [("folded", "int8")]
    if "unified_int8" in runs:
        pairs.append(("unified_folded", "unified_int8"))
    for ref, quant in pairs:
        report["agreement"][f"{quant}_vs_{ref}"] = agreement(
            runs[ref]["trees"], runs[quant]["trees"]
        )
        report["agreement"][f"{quant}_vs_{ref}"]["speedup_warm"] = (
            round(
                runs[quant]["warm_sb_per_s"] / runs[ref]["warm_sb_per_s"], 2
            )
            if runs[quant]["warm_sb_per_s"] and runs[ref]["warm_sb_per_s"]
            else None
        )
    (args.out / "int8_selfcalib_ab.json").write_text(
        json.dumps(report, indent=2)
    )
    print(json.dumps(report, indent=2))


if __name__ == "__main__":
    main()
