"""CLI: dataset materialization — raw block files -> train/val bundles.

Replaces v5 008_prepare_hierarchical_dataset, v6 scripts/001 and the
flatten 001b:

    python -m av1tpu_torch.cli.prepare_dataset \
        --raw data/extracted --out data/v6_dataset --variant v6 \
        --block-size 16 [--partitioned-only]

The port's own copy of ``av1tpu.cli.prepare_dataset``: host numpy, no
device, every flag of the JAX CLI.
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

from av1tpu_torch.data.bundles import (
    build_flatten_bundle,
    build_v5_bundle,
    build_v6_bundle,
    filter_partitioned_only,
    save_split,
)
from av1tpu_torch.data.records import (
    load_npz_sequences,
    load_reference_layout,
    train_test_split,
)

BUILDERS = {
    "v5": build_v5_bundle,
    "v6": build_v6_bundle,
    "flatten": build_flatten_bundle,
}


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--raw", type=Path, required=True,
                        help="extracted data dir (reference layout or npz)")
    parser.add_argument("--out", type=Path, required=True)
    parser.add_argument("--variant", choices=tuple(BUILDERS), default="v6")
    parser.add_argument("--block-size", type=int, nargs="+", default=[16],
                        choices=(8, 16, 32, 64),
                        help="one or more block sizes (a block_<S> dir each)")
    parser.add_argument("--format", choices=("reference", "npz"),
                        default="reference")
    parser.add_argument("--test-ratio", type=float, default=0.2)
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--partitioned-only", action="store_true",
                        help="drop PARTITION_NONE samples (v5 008 flag)")
    args = parser.parse_args(argv)

    for block_size in args.block_size:
        if args.format == "reference":
            record = load_reference_layout(args.raw, str(block_size))
        else:
            record = load_npz_sequences(args.raw, block_size)

        train_rec, val_rec = train_test_split(record, args.test_ratio, args.seed)
        build = BUILDERS[args.variant]
        train_b, val_b = build(train_rec), build(val_rec)
        if args.partitioned_only:
            train_b = filter_partitioned_only(train_b)
            val_b = filter_partitioned_only(val_b)

        root = save_split(args.out, block_size, train_b, val_b, args.variant)
        meta = json.loads((root / "metadata.json").read_text())
        print(json.dumps(meta, indent=2))


if __name__ == "__main__":
    main()
