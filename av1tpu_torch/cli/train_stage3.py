"""CLI: stage-3 specialist trainers — RECT, AB-FGVC, the AB ensemble and the
v5 specialists. The port of ``av1tpu.cli.train_stage3``, with the same flags
and output files:

    python -m av1tpu_torch.cli.train_stage3 --head RECT \
        --dataset-dir data/v6_stage3 --output-dir runs/stage3_rect \
        [--noise-ratio 0.25 --noise-dataset-dir data/v6_dataset]
    python -m av1tpu_torch.cli.train_stage3 --head AB --fgvc ...
    python -m av1tpu_torch.cli.train_stage3 --head AB --ensemble 3 ...
    python -m av1tpu_torch.cli.train_stage3 --variant v5 --head AB ...

``--dataset-dir`` is ``prepare_stage3``'s output
(``<head>/block_<S>/{train,train_v<i>,val}.npz``). Trains on the card
(``--device cpu`` on the CPU).
"""
from __future__ import annotations

import argparse
import json
from dataclasses import replace
from pathlib import Path

import numpy as np
import torch

from av1tpu_torch.cli.common import (
    add_common_train_args,
    check_train_args,
    cli_log,
    export_best,
    load_model_variables,
    load_split,
    make_cli_mesh,
    write_history,
)
from av1tpu_torch.data.bundles import Bundle, class_counts, filter_stage3
from av1tpu_torch.data.noise import build_noisy_bundle
from av1tpu_torch.eval.ensemble import save_ensemble
from av1tpu_torch.models import FGVCModel, load_jax_variables
from av1tpu_torch.models.layers import init_like_flax
from av1tpu_torch.parallel.mesh import is_writer, place_params
from av1tpu_torch.train.checkpoint import save_variables_npz, tree_shapes
from av1tpu_torch.train.fgvc_step import (
    create_fgvc_state,
    make_fgvc_eval_step,
    make_fgvc_train_step,
)
from av1tpu_torch.train.schedules import TrainOptimizer, adamw, cosine_schedule
from av1tpu_torch.train.stages import (
    epoch_seeds,
    squared_inverse_freq_weights,
    stage3_ab_ensemble_recipe,
    stage3_ab_fgvc_recipe,
    stage3_rect_recipe,
    train_stage,
    v5_stage3_recipe,
    variables_of,
)
from av1tpu_torch.train.trainer import (
    resident_eligible,
    resident_eval_arrays,
    run_eval,
    run_eval_resident,
    run_train_epoch,
    run_train_epoch_resident,
    to_device,
)


def load_head_split(dataset_dir: Path, head: str, block_size: int, member: int = 0):
    """``<dir>/<head>/block_<S>/train.npz`` (``train_v<member>.npz`` for an
    ensemble member) and ``val.npz``."""
    root = Path(dataset_dir) / head / f"block_{block_size}"
    train_name = f"train_v{member}.npz" if member else "train.npz"
    return Bundle.load(root / train_name), Bundle.load(root / "val.npz")


def _load_stage2_vars(args):
    """The stage-2 variables that seed the backbone (every reference stage-3
    trainer loads them, 005:448-457, 006:697-702, ensemble 265-271, v5
    012:171-180); a missing file trains from scratch, as the reference's
    ``Path(...).exists()`` guard does."""
    if args.stage2_checkpoint is None:
        return None
    if not Path(args.stage2_checkpoint).exists():
        cli_log(f"stage2 checkpoint {args.stage2_checkpoint} not found; training from scratch")
        return None
    return load_model_variables(args.stage2_checkpoint)


def _graft_stage2(fresh_vars, stage2_vars, v5: bool):
    """Copy stage-2 subtrees into a fresh init's params and batch_stats: v6
    models share only ``backbone`` (005:451-457); the v5 model takes all but
    the stage-2 head and the specialist heads (012:171-176). A subtree whose
    shapes differ keeps the fresh init (``strict=False``)."""
    def allowed(k: str) -> bool:
        if v5:
            return k != "stage2_head" and not k.startswith("specialist_")
        return k == "backbone"

    out = []
    for col in ("params", "batch_stats"):
        dst = dict(fresh_vars.get(col, {}))
        src = stage2_vars.get(col, {})
        for k in list(dst):
            if allowed(k) and k in src and tree_shapes(src[k]) == tree_shapes(dst[k]):
                dst[k] = src[k]
        out.append(dst)
    return out[0], out[1]


def _stage2_init(model_factory, stage2_vars, seed: int, v5: bool = False):
    """A fresh init of ``model_factory()`` from ``seed`` with the stage-2
    weights grafted in: ``(init_params, init_batch_stats)`` for
    ``train_stage``, or ``(None, None)`` when there is nothing to graft."""
    if stage2_vars is None:
        return None, None
    fresh = variables_of(init_like_flax(model_factory(), torch.Generator().manual_seed(seed)))
    params, stats = _graft_stage2(fresh, stage2_vars, v5=v5)
    cli_log("stage-2 weights grafted into stage-3 init")
    return params, stats


def train_fgvc(args, train_b: Bundle, val_b: Bundle, stage2_vars=None, mesh=None) -> None:
    """The production AB path: the FGVC model with CutMix CE and the center
    loss (``train.fgvc_step``), balanced epochs, device-resident when the
    data fits; the best epoch's variables and centers go to
    ``stage3_ab_fgvc_best_variables.npz``."""
    device = torch.device(args.device)
    dtype = torch.bfloat16 if args.bf16 else torch.float32
    steps_per_epoch = max(len(train_b) // args.batch_size, 1)
    epochs = args.epochs or 30
    spec = adamw(cosine_schedule(args.lr or 1e-3, epochs * steps_per_epoch), grad_clip=1.0)
    state = create_fgvc_state(FGVCModel(), spec, args.seed, device=device)
    model = state.model
    if stage2_vars is not None:  # 006:697-702: FGVC starts from the stage-2 backbone
        params, stats = _graft_stage2(variables_of(model), stage2_vars, v5=False)
        load_jax_variables(model, {"params": params, "batch_stats": stats})
        cli_log("stage-2 backbone grafted into FGVC init (006:697-702)")
    arrays = {"samples": train_b.samples, "stage3_AB": train_b.labels["stage3_AB"]}
    val_arrays = {"samples": val_b.samples, "stage3_AB": val_b.labels["stage3_AB"]}
    if mesh is not None:  # the optimizer is rebuilt over the sharded parameters
        place_params(model, mesh)
        state.optimizer = TrainOptimizer([("all", [*model.parameters(), state.centers], spec)])
    train_step = make_fgvc_train_step(model, state.optimizer, state.centers,
                                      compute_dtype=dtype, mesh=mesh)
    eval_step = make_fgvc_eval_step(model, compute_dtype=dtype)
    resident = resident_eligible(arrays)
    if resident:
        device_arrays = to_device(arrays, device)
        device_val, n_val = resident_eval_arrays(val_arrays, device)

    best, history = -np.inf, []
    for epoch in range(epochs):
        aug_seed, dropout_seed = epoch_seeds(args.seed + 1, epoch)
        gen = torch.Generator(device=device).manual_seed(aug_seed)
        with torch.random.fork_rng(devices=[device] if device.type == "cuda" else []):
            torch.manual_seed(dropout_seed)
            if resident:
                state, tr = run_train_epoch_resident(
                    train_step, state, device_arrays, args.batch_size, gen,
                    epoch_seed=args.seed + epoch, num_classes=4,
                    balance_labels=arrays["stage3_AB"])
            else:
                state, tr = run_train_epoch(
                    train_step, state, arrays, args.batch_size, gen,
                    epoch_seed=args.seed + epoch, num_classes=4,
                    balance_labels=arrays["stage3_AB"], device=device, mesh=mesh)
        if resident:
            ev = run_eval_resident(eval_step, state, device_val, n_val, args.batch_size, 4)
        else:
            ev = run_eval(eval_step, state, val_arrays, args.batch_size, 4, device, mesh)
        value = ev.metrics["macro_f1"]
        history.append({"epoch": epoch, "train_loss": tr.loss, "val_loss": ev.loss,
                        "val_metrics": ev.metrics, "throughput": tr.throughput,
                        "train_seconds": tr.seconds})
        cli_log(f"[stage3_ab_fgvc] epoch {epoch}: loss={tr.loss:.4f} val_macro_f1={value:.4f}")
        if value > best:
            best = value
            save_variables_npz(
                args.output_dir / "stage3_ab_fgvc_best_variables.npz",
                {**variables_of(model),
                 "centers": {"centers": state.centers.detach().cpu().numpy()}},
                compress=False)
    if is_writer():
        args.output_dir.mkdir(parents=True, exist_ok=True)
        (args.output_dir / "stage3_ab_fgvc_history.json").write_text(
            json.dumps(history, indent=2))
    cli_log(f"best val macro_f1: {best:.4f}")


def _noisy_train(parser, args, train_b: Bundle, label_key: str, num_classes: int) -> Bundle:
    """``--noise-ratio``: the train split mixed with relabeled samples of the
    other partition families of ``--noise-dataset-dir`` (005:38-122)."""
    if args.noise_dataset_dir is None:
        parser.error("--noise-ratio requires --noise-dataset-dir")
    label_dist = None
    if args.noise_label_dist:
        label_dist = np.array([float(v) for v in args.noise_label_dist.split(",")])
        if len(label_dist) != num_classes:
            parser.error(f"--noise-label-dist needs {num_classes} probabilities")
    full_train, _, _ = load_split(args.noise_dataset_dir, args.block_size)
    sources = []
    for fam in {"RECT": ("AB", "SPLIT"), "AB": ("RECT", "SPLIT")}[args.head]:
        if fam == "SPLIT":
            src = full_train.take(np.flatnonzero(full_train.labels["stage2"] == 0))
        else:
            src = filter_stage3(full_train, fam)
        if len(src):
            sources.append(src)
    train_b = build_noisy_bundle(train_b, sources, label_key=label_key,
                                 num_label_classes=num_classes, noise_ratio=args.noise_ratio,
                                 seed=args.seed, label_distribution=label_dist)
    cli_log(f"noise injection: ratio={args.noise_ratio}, total={len(train_b)} samples")
    return train_b


def _train_ensemble(args, stage2_vars, mesh=None) -> None:
    """``--ensemble N``: N plain AB members, member i on ``train_v<i>`` from
    seed ``seed + 100 i``, each with its fresh head and the shared stage-2
    backbone (ensemble reference 265-271); the best states go to
    ``ensemble/`` (``eval.ensemble.save_ensemble``)."""
    members = []
    total_epochs = args.epochs or 30
    freeze = min(5, max(1, total_epochs // 2))
    for member in range(1, args.ensemble + 1):
        m_train, m_val = load_head_split(args.dataset_dir, "AB", args.block_size, member=member)
        recipe = stage3_ab_ensemble_recipe(
            seed_offset=member, batch_size=args.batch_size,
            steps_per_epoch=max(len(m_train) // args.batch_size, 1), freeze_epochs=freeze,
            unfreeze_epochs=max(1, total_epochs - freeze))
        recipe = replace(recipe, input_shape=(args.block_size, args.block_size, 1))
        seed = args.seed + 100 * member
        m_params, m_stats = _stage2_init(recipe.model, stage2_vars, seed)
        result = train_stage(recipe, m_train, m_val, seed=seed, init_params=m_params,
                             init_batch_stats=m_stats, checkpoint_dir=args.output_dir,
                             checkpoint_every=args.checkpoint_every, device=args.device,
                             mesh=mesh,                         log=cli_log)
        export_best(result, recipe.name, args.output_dir)
        write_history(result, args.output_dir, recipe.name)
        if result.best_state is not None:
            members.append(variables_of(result.best_state.model))
    if is_writer():
        save_ensemble(args.output_dir / "ensemble", members,
                      meta={"members": len(members), "epochs": total_epochs})


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__)
    add_common_train_args(parser)
    parser.add_argument("--head", choices=("RECT", "AB", "1TO4"), required=True)
    parser.add_argument("--variant", choices=("v5", "v6"), default="v6")
    parser.add_argument("--fgvc", action="store_true",
                        help="AB only: FGVC stack with CutMix + center loss")
    parser.add_argument("--ensemble", type=int, default=0,
                        help="AB only: train N plain members on train_vN sets")
    parser.add_argument("--noise-ratio", type=float, default=0.0,
                        help="adversarial noise-injection fraction")
    parser.add_argument("--noise-dataset-dir", type=Path, default=None,
                        help="v6 dataset dir supplying noise source samples")
    parser.add_argument("--noise-label-dist", type=str, default=None,
                        help="comma-separated class probabilities for confusion-based "
                        "noise labels (H3.2); default uniform like the reference")
    parser.add_argument("--stage2-checkpoint", type=Path, default=None)
    args = parser.parse_args(argv)
    check_train_args(parser, args)
    mesh = make_cli_mesh(args.num_model_shards)

    train_b, val_b = load_head_split(args.dataset_dir, args.head, args.block_size)
    if len(train_b) == 0 or len(val_b) == 0:
        parser.error(
            f"head {args.head} has an empty {'train' if len(train_b) == 0 else 'val'} "
            f"split at block {args.block_size} — the corpus has no samples for this head "
            "(rerun dataset prep at a larger scale)")
    label_key = f"stage3_{args.head}"
    num_classes = 4 if args.head == "AB" else 2
    if args.noise_ratio > 0:
        train_b = _noisy_train(parser, args, train_b, label_key, num_classes)

    dtype = torch.bfloat16 if args.bf16 else torch.float32
    steps_per_epoch = max(len(train_b) // args.batch_size, 1)
    stage2_vars = _load_stage2_vars(args)

    if args.head == "AB" and args.fgvc:
        train_fgvc(args, train_b, val_b, stage2_vars, mesh)
        return
    if args.head == "AB" and args.ensemble:
        _train_ensemble(args, stage2_vars, mesh)
        return

    if args.variant == "v5":
        # the JAX CLI builds the v5 model without its dtype: fp32 under --bf16
        weights = squared_inverse_freq_weights(train_b.labels[label_key], num_classes)
        recipe = v5_stage3_recipe(args.head, weights, epochs=args.epochs or 20,
                                  lr=args.lr or 5e-4, batch_size=args.batch_size,
                                  steps_per_epoch=steps_per_epoch)
    elif args.head == "RECT":
        weights = np.asarray(class_counts(train_b.labels[label_key], 2), np.float64)
        weights = weights.sum() / np.maximum(weights, 1)
        recipe = stage3_rect_recipe(
            class_weights=weights / weights.sum() * 2,
            unfreeze_epochs=max(1, (args.epochs or 30) - 5), head_lr=args.lr or 1e-3,
            batch_size=args.batch_size, steps_per_epoch=steps_per_epoch, dtype=dtype)
    else:
        recipe = stage3_ab_fgvc_recipe(
            unfreeze_epochs=max(1, (args.epochs or 30) - 5), head_lr=args.lr or 1e-3,
            batch_size=args.batch_size, steps_per_epoch=steps_per_epoch, dtype=dtype)
    recipe = replace(recipe, input_shape=(args.block_size, args.block_size, 1))
    init_params, init_stats = _stage2_init(recipe.model, stage2_vars, args.seed,
                                           v5=args.variant == "v5")
    result = train_stage(recipe, train_b, val_b, seed=args.seed, init_params=init_params,
                         init_batch_stats=init_stats, checkpoint_dir=args.output_dir,
                         resume_from=args.resume, checkpoint_every=args.checkpoint_every,
                         device=args.device, mesh=mesh,
                         log=cli_log)
    export_best(result, recipe.name, args.output_dir)
    write_history(result, args.output_dir, recipe.name)
    cli_log(f"best val {recipe.best_metric}: {result.best_value:.4f}")


if __name__ == "__main__":
    main()
