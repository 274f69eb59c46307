"""CLI: the flatten architecture's 7-way trainer (reference 004b). The port of
``av1tpu.cli.train_stage2_flat``, with the same flags and output files:

    python -m av1tpu_torch.cli.train_stage2_flat \
        --dataset-dir data/flatten_dataset --output-dir runs/flat

``--dataset-dir`` holds a split with the ``flatten`` label view
(``data.bundles.build_flatten_bundle``). Trains on the card (``--device cpu``
on the CPU).
"""
from __future__ import annotations

import argparse
from dataclasses import replace

import torch

from av1tpu_torch.cli.common import (
    add_common_train_args,
    check_train_args,
    cli_log,
    export_best,
    load_split,
    make_cli_mesh,
    write_history,
)
from av1tpu_torch.data.bundles import class_counts
from av1tpu_torch.train.stages import flatten_recipe, train_stage


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__)
    add_common_train_args(parser)
    parser.add_argument("--freeze-epochs", type=int, default=15)
    parser.add_argument("--gamma", type=float, default=2.5)
    args = parser.parse_args(argv)
    check_train_args(parser, args)
    mesh = make_cli_mesh(args.num_model_shards)

    train_b, val_b, _ = load_split(args.dataset_dir, args.block_size)
    recipe = flatten_recipe(
        samples_per_class=class_counts(train_b.labels["flatten"], 7),
        freeze_epochs=args.freeze_epochs,
        unfreeze_epochs=max(1, (args.epochs or 40) - args.freeze_epochs),
        max_lr=args.lr or 1e-3, batch_size=args.batch_size, gamma=args.gamma,
        steps_per_epoch=max(len(train_b) // args.batch_size, 1),
        dtype=torch.bfloat16 if args.bf16 else torch.float32)
    recipe = replace(recipe, input_shape=(args.block_size, args.block_size, 1))
    result = train_stage(recipe, train_b, val_b, seed=args.seed,
                         checkpoint_dir=args.output_dir, resume_from=args.resume,
                         checkpoint_every=args.checkpoint_every, device=args.device, mesh=mesh,
                         log=cli_log)
    export_best(result, recipe.name, args.output_dir)
    write_history(result, args.output_dir, recipe.name)
    cli_log(f"best val {recipe.best_metric}: {result.best_value:.4f}")


if __name__ == "__main__":
    main()
