"""CLI: stage-1 (NONE vs PARTITION) trainer, v6 or (``--variant v5``) the
v5 shared model's stage-1 path. The port of ``av1tpu.cli.train_stage1``,
with the same flags and output files:

    python -m av1tpu_torch.cli.train_stage1 \
        --dataset-dir data/v6_dataset --block-size 16 \
        --output-dir runs/stage1 --epochs 30 [--bf16] [--use-hard-mining]

Trains on the card (``--device cpu`` on the CPU).
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
from av1tpu_torch.train.stages import stage1_recipe, train_stage, v5_stage1_recipe


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__)
    add_common_train_args(parser)
    parser.add_argument("--variant", choices=("v5", "v6"), default="v6")
    parser.add_argument("--alpha", type=float, default=0.25)
    parser.add_argument("--gamma", type=float, default=2.5)
    parser.add_argument("--pos-weight", type=float, default=1.0,
                        help="v5 only: BCE positive-class weight")
    parser.add_argument("--use-hard-mining", action="store_true",
                        help="v6 only: hard-negative-mining loss instead of focal "
                        "(works, unlike the reference's --use-hard-mining, quirk Q2)")
    parser.add_argument("--hard-mining-ratio", type=float, default=3.0)
    parser.add_argument("--use-qp", action="store_true",
                        help="v5 only: condition on the per-block QP via QPEmbedding "
                        "(the reference kept it dormant, quirk Q6)")
    args = parser.parse_args(argv)
    check_train_args(parser, args)
    mesh = make_cli_mesh(args.num_model_shards)

    train_b, val_b, _ = load_split(args.dataset_dir, args.block_size)
    steps_per_epoch = max(len(train_b) // args.batch_size, 1)
    if args.variant == "v6":
        recipe = stage1_recipe(
            epochs=args.epochs or 30, lr=args.lr or 1e-3, batch_size=args.batch_size,
            alpha=args.alpha, gamma=args.gamma, steps_per_epoch=steps_per_epoch,
            dtype=torch.bfloat16 if args.bf16 else torch.float32,
            use_hard_mining=args.use_hard_mining, hard_mining_ratio=args.hard_mining_ratio)
    else:
        # the JAX CLI builds the v5 model without its dtype: fp32 under --bf16
        recipe = v5_stage1_recipe(
            epochs=args.epochs or 20, lr=args.lr or 1e-3, batch_size=args.batch_size,
            pos_weight=args.pos_weight, gamma=args.gamma, steps_per_epoch=steps_per_epoch,
            use_qp=args.use_qp)
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
