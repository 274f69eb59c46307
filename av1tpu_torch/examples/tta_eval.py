"""Measure test-time augmentation at tree-serving level: none vs naive
TTA vs swap-aligned TTA.

The reference's TTA (pesquisa_v6/v6_pipeline/augmentation.py:251-276)
averages each stage's logits over original/hflip/vflip/rot180 WITHOUT
remapping the AB head's classes, even though its own training swap tables
say a flip relabels HORZ_A<->HORZ_B / VERT_A<->VERT_B — so the flipped
views' AB evidence lands on the swapped class and partially cancels.
``--tta-align-ab`` (train/augment.TTA_AB_ALIGN_V6) gathers each view's
AB logits through that view's permutation first, pooling the evidence
instead.

This replays a tree-demo directory (``av1tpu_torch.examples.tree_demo
--out <dir>``, or the JAX package's ``examples/tree_demo.py``, must have
completed: per-size models, packed val clip, and ground-truth trees on disk)
through ``cli.predict_trees`` under the three configurations, writing each
configuration's trees to ``<dir>/trees_<config>``, and scores composed-tree
accuracy against truth into ``--output``:

    python -m av1tpu_torch.examples.tta_eval --xl-dir runs/tree_demo_xl \
        --output runs/tta_eval.json [--device cuda]

All three runs use the plain graph (TTA composes per-view forwards; the
BN-folded graph serves the no-TTA production path) so the comparison
isolates the TTA effect.
"""
import argparse
import json
from pathlib import Path

import numpy as np

from av1tpu_torch.cli import predict_trees
from av1tpu_torch.eval.tree_metrics import tree_accuracy
from av1tpu_torch.examples._common import (
    SB_PER_FRAME,
    add_device_arg,
    parse_example_args,
    timed,
)

FLAGS = {
    "none": [],
    # naive = the reference's TTA mean (alignment defaults ON, so opt out
    # explicitly)
    "tta": ["--tta", "--no-tta-align-ab"],
    "tta_aligned": ["--tta", "--tta-align-ab"],
}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--xl-dir", type=Path, default=Path("runs/tree_demo_xl"))
    ap.add_argument("--output", type=Path, default=None,
                    help="results JSON (default <xl-dir>/tta_eval.json)")
    ap.add_argument("--frames-per-batch", type=int, default=10)
    ap.add_argument("--bf16", action="store_true", default=True)
    ap.add_argument("--no-bf16", dest="bf16", action="store_false")
    ap.add_argument("--configs", nargs="+",
                    default=["none", "tta", "tta_aligned"],
                    choices=["none", "tta", "tta_aligned"])
    add_device_arg(ap)
    args = parse_example_args(ap, argv)
    output = args.output or args.xl_dir / "tta_eval.json"

    xl = args.xl_dir
    results = json.loads((xl / "RESULTS.json").read_text())
    thresholds = [
        str(results["sizes"][str(s)]["calibrated_threshold"])
        for s in (64, 32, 16, 8)
    ]
    clips = sorted(xl.glob("val_*x*_30.yuv"))
    assert clips, f"no packed val clip in {xl}"
    yuv = clips[0]
    truth = np.load(xl / "val_trees_truth.npy")
    n_frames = results["corpus"]["val_superblocks"] // SB_PER_FRAME

    out = {"clip": yuv.name, "frames": n_frames,
           "thresholds_64_32_16_8": [float(t) for t in thresholds],
           "frames_per_batch": args.frames_per_batch,
           "graph": "plain" + (" bf16" if args.bf16 else " f32"),
           "device": args.device,
           "configs": {}}
    for config in args.configs:
        tree_dir = xl / f"trees_{config}"
        _, wall = timed(lambda: predict_trees.main([
            "--yuv", str(yuv),
            "--frames", *[str(i) for i in range(n_frames)],
            "--frames-per-batch", str(args.frames_per_batch),
            *[a for s in (64, 32, 16, 8)
              for a in (f"--models-{s}", str(xl / f"size_{s}" / "models"))],
            "--output-dir", str(tree_dir),
            "--stage1-threshold", *thresholds,
            *(["--bf16"] if args.bf16 else []),
            *FLAGS[config],
            "--device", args.device,
        ]), args.device)
        pred = np.concatenate([
            np.load(tree_dir / f"trees_frame{i}.npz")["trees"]
            for i in range(n_frames)
        ])
        acc = tree_accuracy(pred, truth)
        acc["predict_wall_seconds"] = round(wall, 1)
        out["configs"][config] = acc
        print(f"[{config}] node_acc={acc['node_accuracy']:.4f} "
              f"exact_tree={acc['exact_tree_match']:.4f} wall={wall:.0f}s",
              flush=True)
        output.parent.mkdir(parents=True, exist_ok=True)
        output.write_text(json.dumps(out, indent=2))
    print(json.dumps({k: {"node": v["node_accuracy"],
                          "exact": v["exact_tree_match"]}
                      for k, v in out["configs"].items()}, indent=2))


if __name__ == "__main__":
    main()
