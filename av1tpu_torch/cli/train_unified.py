"""CLI: the unified single-backbone multi-task trainer, with optional
distillation. The port of ``av1tpu.cli.train_unified``, with the same flags
and output files. It trains ``models.UnifiedV6Model`` (one shared backbone,
all four v6 stage heads) against the packed multi-task labels and keeps the
best composed final 8-class macro-F1; ``--distill-weight`` adds the four
trained per-stage models' dense logits as soft targets on every row:

    python -m av1tpu_torch.cli.train_unified \
        --dataset-dir data/v6_dataset --block-size 16 \
        --output-dir runs/unified --epochs 30

    python -m av1tpu_torch.cli.train_unified ... --distill-weight 0.5 \
        --stage1-checkpoint runs/stage1/stage1_best_variables.npz \
        --stage2-checkpoint runs/stage2/stage2_best_variables.npz \
        --stage3-rect-checkpoint runs/rect/stage3_rect_best_variables.npz \
        --stage3-ab-checkpoint runs/ab/stage3_ab_fgvc_best_variables.npz

Trains on the card (``--device cpu`` on the CPU).
"""
from __future__ import annotations

import argparse
from dataclasses import replace
from pathlib import Path

import torch

from av1tpu_torch.cli.common import (
    add_common_train_args,
    check_train_args,
    cli_log,
    export_best,
    load_model,
    load_split,
    make_cli_mesh,
    write_history,
)
from av1tpu_torch.data.bundles import class_counts
from av1tpu_torch.eval.hierarchy import PipelineModels
from av1tpu_torch.models import (
    FGVCModel,
    Stage1Model,
    Stage2Model,
    Stage3ABModel,
    Stage3RectModel,
)
from av1tpu_torch.train.stages import train_stage
from av1tpu_torch.train.unified import (
    compute_teacher_logits,
    unified_recipe,
    with_unified_labels,
)

_TEACHER_ARGS = ("stage1_checkpoint", "stage2_checkpoint", "stage3_rect_checkpoint",
                 "stage3_ab_checkpoint")


def _load_teachers(args) -> PipelineModels:
    """The four per-stage teachers (an FGVC checkpoint's ``centers`` are
    dropped, as the JAX CLI pops them)."""
    return PipelineModels(
        load_model(args.stage1_checkpoint, Stage1Model),
        load_model(args.stage2_checkpoint, Stage2Model),
        load_model(args.stage3_rect_checkpoint, Stage3RectModel),
        load_model(args.stage3_ab_checkpoint, FGVCModel if args.ab_fgvc else Stage3ABModel))


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__)
    add_common_train_args(parser)
    parser.add_argument("--alpha", type=float, default=0.25)
    parser.add_argument("--gamma", type=float, default=2.5)
    parser.add_argument("--beta", type=float, default=0.9999,
                        help="class-balanced effective-number beta for the stage-2/AB heads")
    parser.add_argument("--head-weights", type=float, nargs=4, default=(1.0, 1.0, 1.0, 1.0),
                        metavar=("W_S1", "W_S2", "W_RECT", "W_AB"),
                        help="loss weights per head [stage1 stage2 rect ab]")
    parser.add_argument("--stage1-threshold", type=float, default=0.5,
                        help="gate threshold used by the composed-final validation metric")
    parser.add_argument("--weight-decay", type=float, default=1e-2)
    parser.add_argument("--distill-weight", type=float, default=0.0,
                        help="in (0,1]: blend logit distillation from the four per-stage "
                        "teacher checkpoints into the loss")
    parser.add_argument("--kd-temperature", type=float, default=2.0)
    parser.add_argument("--teacher-batch-size", type=int, default=4096,
                        help="dense teacher-forward batch for distillation target "
                        "precomputation")
    parser.add_argument("--stage1-checkpoint", type=Path)
    parser.add_argument("--stage2-checkpoint", type=Path)
    parser.add_argument("--stage3-rect-checkpoint", type=Path)
    parser.add_argument("--stage3-ab-checkpoint", type=Path)
    parser.add_argument("--ab-fgvc", action="store_true", default=True,
                        help="teacher AB checkpoint is the FGVC model")
    parser.add_argument("--no-ab-fgvc", dest="ab_fgvc", action="store_false")
    args = parser.parse_args(argv)
    check_train_args(parser, args)
    mesh = make_cli_mesh(args.num_model_shards)

    train_b, val_b, _ = load_split(args.dataset_dir, args.block_size)
    dtype = torch.bfloat16 if args.bf16 else torch.float32
    teacher_train = teacher_val = None
    if args.distill_weight > 0.0:
        missing = [a for a in _TEACHER_ARGS if getattr(args, a) is None]
        if missing:
            parser.error("--distill-weight requires the four teacher checkpoints: "
                         + ", ".join("--" + m.replace("_", "-") for m in missing))
        teachers = _load_teachers(args)
        cli_log(f"computing dense teacher logits ({len(train_b)} train + {len(val_b)} val "
              "rows) ...")
        teacher_train, teacher_val = (
            compute_teacher_logits(teachers, b.samples, batch_size=args.teacher_batch_size,
                                   float_dtype=dtype, device=args.device)
            for b in (train_b, val_b))

    train_b = with_unified_labels(train_b, teacher_train)
    val_b = with_unified_labels(val_b, teacher_val)
    recipe = unified_recipe(
        s2_counts=class_counts(train_b.labels["stage2"], 3),
        ab_counts=class_counts(train_b.labels["stage3_AB"], 4),
        epochs=args.epochs or 30, lr=args.lr or 1e-3, batch_size=args.batch_size,
        weight_decay=args.weight_decay, alpha=args.alpha, gamma=args.gamma, beta=args.beta,
        stage1_threshold=args.stage1_threshold, head_weights=tuple(args.head_weights),
        distill_weight=args.distill_weight, kd_temperature=args.kd_temperature,
        steps_per_epoch=max(len(train_b) // args.batch_size, 1), dtype=dtype)
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
