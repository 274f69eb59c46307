"""CLI: block visualization — the reference's 006_visualize_blocks notebook
as a command:

    python -m av1tpu_torch.cli.visualize_blocks \
        --dataset-dir data/v6_dataset --block-size 16 --out viz.png

Renders a per-class grid of example luma blocks plus the class
distribution, for manual data inspection. The port's own copy of
``av1tpu.cli.visualize_blocks``.
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

from av1tpu_torch.cli.common import load_split
from av1tpu_torch.codec.partitions import PARTITION_ID_TO_NAME, class_distribution
from av1tpu_torch.eval.plots import plot_block_grid


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--dataset-dir", type=Path, required=True)
    parser.add_argument("--block-size", type=int, default=16)
    parser.add_argument("--split", choices=("train", "val"), default="val")
    parser.add_argument("--out", type=Path, required=True)
    parser.add_argument("--per-class", type=int, default=8)
    args = parser.parse_args(argv)

    train_b, val_b, _ = load_split(args.dataset_dir, args.block_size)
    bundle = val_b if args.split == "val" else train_b
    path = plot_block_grid(
        bundle.samples,
        bundle.labels["stage0"],
        PARTITION_ID_TO_NAME,
        args.out,
        per_class=args.per_class,
    )
    dist = class_distribution(bundle.labels["stage0"])
    print(json.dumps({"written": str(path), "class_distribution": dist}, indent=2))


if __name__ == "__main__":
    main()
