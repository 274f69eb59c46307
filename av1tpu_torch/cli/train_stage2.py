"""CLI: stage-2 trainer — ULMFiT / scratch / adapters / pipeline-aware, or
(``--variant v5``) the v5 shared model's 5-way head. The port of
``av1tpu.cli.train_stage2``, with the same flags and output files:

    python -m av1tpu_torch.cli.train_stage2 \
        --dataset-dir data/v6_dataset --output-dir runs/stage2 \
        --stage1-checkpoint runs/stage1/stage1_best_variables.npz \
        [--scratch | --use-adapters | --pipeline-aware]

Trains on the card (``--device cpu`` on the CPU).
"""
from __future__ import annotations

import argparse
from dataclasses import replace
from pathlib import Path

import numpy as np
import torch

from av1tpu_torch.cli.common import (
    add_common_train_args,
    check_train_args,
    export_best,
    load_model_variables,
    load_split,
    write_history,
)
from av1tpu_torch.data.bundles import class_counts, filter_stage2_v6
from av1tpu_torch.models import Stage1Model, load_jax_variables
from av1tpu_torch.models.layers import init_like_flax
from av1tpu_torch.train.checkpoint import transplant_backbone, tree_shapes
from av1tpu_torch.train.stages import (
    filter_through_stage1,
    stage2_recipe,
    train_stage,
    v5_stage2_recipe,
    variables_of,
)


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__)
    add_common_train_args(parser)
    parser.add_argument("--variant", choices=("v5", "v6"), default="v6")
    parser.add_argument("--stage1-checkpoint", type=Path, default=None,
                        help="variables npz (or reference .pt) whose backbone "
                        "seeds this model")
    parser.add_argument("--freeze-epochs", type=int, default=5)
    parser.add_argument("--head-lr", type=float, default=5e-4)
    parser.add_argument("--backbone-lr", type=float, default=1e-6)
    parser.add_argument("--scratch", action="store_true")
    parser.add_argument("--use-adapters", action="store_true")
    parser.add_argument("--pipeline-aware", action="store_true",
                        help="filter train set through the stage-1 model at "
                        "threshold 0.45 (H2.1 experiment, reference 004c)")
    parser.add_argument("--stage1-threshold", type=float, default=0.45)
    args = parser.parse_args(argv)
    check_train_args(parser, args)

    train_b, val_b, _ = load_split(args.dataset_dir, args.block_size)
    train_b = filter_stage2_v6(train_b)
    val_b = filter_stage2_v6(val_b)
    dtype = torch.bfloat16 if args.bf16 else torch.float32

    stage1_vars = None
    if args.stage1_checkpoint is not None:
        stage1_vars = load_model_variables(args.stage1_checkpoint)
    if args.pipeline_aware:
        if stage1_vars is None:
            parser.error("--pipeline-aware requires --stage1-checkpoint")
        before = len(train_b)
        train_b = filter_through_stage1(
            train_b, load_jax_variables(Stage1Model(), stage1_vars),
            threshold=args.stage1_threshold, device=args.device, dtype=dtype)
        print(f"pipeline-aware filter: {before} -> {len(train_b)} samples")

    counts = class_counts(train_b.labels["stage2"], 3)
    steps_per_epoch = max(len(train_b) // args.batch_size, 1)
    if args.variant == "v6":
        recipe = stage2_recipe(
            samples_per_class=counts, freeze_epochs=args.freeze_epochs,
            unfreeze_epochs=max(1, (args.epochs or 30) - args.freeze_epochs),
            head_lr=args.head_lr, backbone_lr=args.backbone_lr, batch_size=args.batch_size,
            steps_per_epoch=steps_per_epoch, scratch=args.scratch,
            use_adapters=args.use_adapters, dtype=dtype)
    else:
        weights = 1.0 / np.maximum(np.asarray(counts, np.float64), 1)
        weights = weights / weights.sum() * len(weights)
        recipe = v5_stage2_recipe(class_weights=weights, epochs=args.epochs or 20,
                                  lr=args.lr or 1e-3, batch_size=args.batch_size,
                                  steps_per_epoch=steps_per_epoch)
    recipe = replace(recipe, input_shape=(args.block_size, args.block_size, 1))

    init_params = init_stats = None
    if stage1_vars is not None:
        fresh = variables_of(init_like_flax(recipe.model(),
                                            torch.Generator().manual_seed(args.seed)))
        if args.variant == "v5":
            # v5 010:111-115 loads the FULL stage-1 state (strict=False): the
            # backbone and the trained stage1_head carry into the shared model
            init_params, init_stats = fresh["params"], fresh["batch_stats"]
            for col, src in ((init_params, stage1_vars.get("params", {})),
                             (init_stats, stage1_vars.get("batch_stats", {}))):
                for k in list(col):
                    if k in src and tree_shapes(src[k]) == tree_shapes(col[k]):
                        col[k] = src[k]
            print("seeded full v5 state from stage-1 checkpoint (010:111-115)")
        elif "backbone" not in fresh["params"]:
            # the adapter model's trunk is backbone_*: the JAX CLI transplants
            # the stage-1 backbone under a key that model never reads
            print("backbone transplant skipped: the model has no 'backbone' subtree")
        else:
            # seed the backbone from stage 1 (reference 004:327-349)
            try:
                init_params = transplant_backbone(fresh["params"], stage1_vars["params"],
                                                  prefix="backbone")
                init_stats = transplant_backbone(fresh["batch_stats"],
                                                 stage1_vars.get("batch_stats", {}),
                                                 prefix="backbone")
                print("seeded backbone from stage-1 checkpoint")
            except (KeyError, ValueError) as exc:
                print(f"backbone transplant skipped: {exc}")

    result = train_stage(recipe, train_b, val_b, seed=args.seed, init_params=init_params,
                         init_batch_stats=init_stats, checkpoint_dir=args.output_dir,
                         resume_from=args.resume, checkpoint_every=args.checkpoint_every,
                         device=args.device)
    export_best(result, recipe.name, args.output_dir)
    write_history(result, args.output_dir, recipe.name)
    print(f"best val {recipe.best_metric}: {result.best_value:.4f}")


if __name__ == "__main__":
    main()
