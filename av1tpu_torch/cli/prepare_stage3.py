"""CLI: the stage-3 specialist datasets — filtered, AB oversampled, and the
AB ensemble's shuffled copies. The port of ``av1tpu.cli.prepare_stage3``,
with the same flags and files (``<out>/<head>/block_<S>/train.npz``,
``train_v<i>.npz`` for AB, ``val.npz``, ``metadata.json``), which
``train_stage3`` reads:

    python -m av1tpu_torch.cli.prepare_stage3 \
        --dataset-dir data/v6_dataset --out data/v6_stage3 --block-size 16 \
        --ab-oversample 1:5,2:5 --ensemble-members 3

Host numpy only: no device is used.
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

from av1tpu_torch.data.bundles import (
    Bundle,
    class_counts,
    ensemble_shuffles,
    filter_stage3,
    oversample_ab,
)


def parse_factor_map(text: str):
    """``"1:5,2:5"`` -> ``{1: 5, 2: 5}``."""
    if not text:
        return {}
    return {int(k): int(v) for k, v in (pair.split(":") for pair in text.split(","))}


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--dataset-dir", type=Path, required=True)
    parser.add_argument("--out", type=Path, required=True)
    parser.add_argument("--block-size", type=int, default=16)
    parser.add_argument("--heads", nargs="+", default=["RECT", "AB"])
    parser.add_argument("--ab-oversample", type=str, default="1:5,2:5",
                        help="classid:factor pairs (reference default HORZ_B:5, VERT_A:5)")
    parser.add_argument("--ensemble-members", type=int, default=3)
    parser.add_argument("--seed", type=int, default=42)
    args = parser.parse_args(argv)

    root = Path(args.dataset_dir) / f"block_{args.block_size}"
    train, val = Bundle.load(root / "train.npz"), Bundle.load(root / "val.npz")
    summary = {}
    for head in args.heads:
        head_dir = Path(args.out) / head / f"block_{args.block_size}"
        head_dir.mkdir(parents=True, exist_ok=True)
        train_h, val_h = filter_stage3(train, head), filter_stage3(val, head)
        if head == "AB":
            factors = parse_factor_map(args.ab_oversample)
            train_over = oversample_ab(train_h, factors) if factors else train_h
            train_over.save(head_dir / "train.npz")
            for i, member in enumerate(
                    ensemble_shuffles(train_over, args.ensemble_members, args.seed), start=1):
                member.save(head_dir / f"train_v{i}.npz")
        else:
            train_h.save(head_dir / "train.npz")
        val_h.save(head_dir / "val.npz")
        summary[head] = {
            "train": len(train_h),
            "val": len(val_h),
            "train_counts": class_counts(train_h.labels[f"stage3_{head}"],
                                         4 if head == "AB" else 2),
        }
        (head_dir / "metadata.json").write_text(json.dumps(summary[head], indent=2))
    print(json.dumps(summary, indent=2))


if __name__ == "__main__":
    main()
