"""End-to-end framework demo: synthesize -> train the cascade -> plain eval.

Generates a synthetic dataset where every partition class has a distinct
visual structure (flat / quadrant / band / asymmetric-band patterns), trains
all four v6 stages briefly through ``train.stages.train_stage``, and
evaluates the plain hierarchical pipeline with a stage-1 threshold sweep —
the complete train -> calibrate -> eval loop on ``--device``.

    python -m av1tpu_torch.examples.demo_e2e [--epochs 3] [--out runs/demo] \
        [--device cuda]

Writes stage and pipeline metrics to ``<out>/demo_results.json``.
"""
import argparse
import json
import time
from dataclasses import replace
from pathlib import Path

import numpy as np
import torch

from av1tpu_torch.codec.partitions import V6_EVAL_CLASS_NAMES, raw_to_v6_final
from av1tpu_torch.data import BlockSet, build_v6_bundle, train_test_split
from av1tpu_torch.data.bundles import filter_stage2_v6, filter_stage3
from av1tpu_torch.eval import (
    PipelineModels,
    best_by,
    compute_metrics,
    decompose_v6,
    make_v6_pipeline,
    run_pipeline_batched,
    threshold_sweep,
)
from av1tpu_torch.examples._common import add_device_arg, parse_example_args
from av1tpu_torch.models import Stage3ABModel
from av1tpu_torch.models.layers import init_like_flax
from av1tpu_torch.train.augment import stage3_ab_augment
from av1tpu_torch.train.checkpoint import transplant_backbone
from av1tpu_torch.train.losses import multiclass_focal_loss
from av1tpu_torch.train.schedules import adamw, cosine_schedule
from av1tpu_torch.train.stages import (
    Phase,
    StageRecipe,
    stage1_recipe,
    stage2_recipe,
    stage3_rect_recipe,
    train_stage,
    variables_of,
)


def synth_block(cls: int, rng, size=16):
    """Distinct 10-bit pattern per raw partition class.

    The AB patterns are chosen to COMMUTE with the v6 label-aware
    augmentation tables (hflip swaps HORZ_A<->HORZ_B; vflip swaps
    VERT_A<->VERT_B; rot90 k=1 maps HA->VA, HB->VB, VA->HB, VB->HA):
    HA=left-bright, HB=right-bright, VA=bottom-bright, VB=top-bright
    satisfy all three identities, so augmentation reinforces rather than
    contradicts the labels. RECT uses smooth gradients (invariant-class
    under the label-agnostic RECT flips), SPLIT a quadrant checker.
    """
    lo, hi = 300.0, 700.0
    h = size // 2
    img = np.full((size, size), lo)
    ramp = np.linspace(lo, hi, size)
    if cls == 0:      # NONE: flat
        pass
    elif cls == 3:    # SPLIT: checker quadrants
        img[:h, :h] = hi
        img[h:, h:] = hi
    elif cls == 1:    # HORZ: smooth vertical gradient
        img = np.tile(ramp[:, None], (1, size))
    elif cls == 2:    # VERT: smooth horizontal gradient
        img = np.tile(ramp[None, :], (size, 1))
    elif cls == 4:    # HORZ_A: left half bright
        img[:, :h] = hi
    elif cls == 5:    # HORZ_B: right half bright
        img[:, h:] = hi
    elif cls == 6:    # VERT_A: bottom half bright
        img[h:, :] = hi
    elif cls == 7:    # VERT_B: top half bright
        img[:h, :] = hi
    img = img + rng.normal(0, 40, (size, size))
    return np.clip(img, 0, 1023).astype(np.uint16)


def make_dataset(n_per_class=800, seed=0):
    rng = np.random.default_rng(seed)
    classes = [0, 1, 2, 3, 4, 5, 6, 7]
    labels = np.repeat(classes, n_per_class).astype(np.int32)
    rng.shuffle(labels)
    samples = np.stack([synth_block(int(c), rng) for c in labels])[..., None]
    return BlockSet(samples=samples, labels=labels,
                    qps=np.full(len(labels), 80, np.int32))


def small_phases(recipe, epochs):
    phases = [Phase(epochs=max(1, epochs // len(recipe.phases)),
                    make_optimizer=p.make_optimizer, name=p.name)
              for p in recipe.phases]
    return replace(recipe, phases=phases)


def best_variables(result):
    return variables_of(result.best_state.model)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--epochs", type=int, default=3)
    parser.add_argument("--batch-size", type=int, default=256)
    parser.add_argument("--out", type=Path, default=Path("runs/demo"))
    parser.add_argument("--bf16", action=argparse.BooleanOptionalAction,
                        default=True,
                        help="bf16 compute (default; --no-bf16 for float32)")
    parser.add_argument("--seed", type=int, default=0,
                        help="every stage's draws; the stage-3 heads start "
                        "from a model drawn from seed + 9 on --device")
    add_device_arg(parser)
    args = parse_example_args(parser, argv)
    device = torch.device(args.device)

    dtype = torch.bfloat16 if args.bf16 else torch.float32
    backend = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(f"device: {backend}, dtype: {dtype}")
    record = make_dataset()
    train_rec, val_rec = train_test_split(record, 0.25, seed=42)
    train_b, val_b = build_v6_bundle(train_rec), build_v6_bundle(val_rec)
    spe = max(len(train_b) // args.batch_size, 1)
    results = {}
    t_start = time.time()

    def log(msg):
        print(f"[{time.time() - t_start:7.1f}s] {msg}")

    def train(recipe, train_set, val_set, **init):
        return train_stage(recipe, train_set, val_set, seed=args.seed, log=log,
                           device=device, **init)

    # stage 1
    r1 = train(
        small_phases(stage1_recipe(lr=2e-3, batch_size=args.batch_size,
                                   steps_per_epoch=spe, dtype=dtype),
                     args.epochs),
        train_b, val_b,
    )
    results["stage1_val_f1"] = r1.best_value

    # stage 2
    t2, v2 = filter_stage2_v6(train_b), filter_stage2_v6(val_b)
    counts = np.bincount(t2.labels["stage2"], minlength=3)
    r2 = train(
        small_phases(stage2_recipe(samples_per_class=counts, scratch=True,
                                   head_lr=2e-3, batch_size=args.batch_size,
                                   steps_per_epoch=spe, dtype=dtype),
                     args.epochs),
        t2, v2,
    )
    results["stage2_val_f1"] = r2.best_value
    s2_vars = best_variables(r2)

    # stage 3 RECT — seed the backbone from stage 2 (reference 005:451-457)
    def seeded_init(recipe):
        model = recipe.model().to(device)
        fresh = variables_of(init_like_flax(
            model, torch.Generator(device=device).manual_seed(args.seed + 9)))
        return {
            "init_params": transplant_backbone(fresh["params"], s2_vars["params"]),
            "init_batch_stats": transplant_backbone(fresh["batch_stats"],
                                                    s2_vars["batch_stats"]),
        }

    tr_r, va_r = filter_stage3(train_b, "RECT"), filter_stage3(val_b, "RECT")
    rect_recipe = small_phases(
        stage3_rect_recipe(class_weights=[1.0, 1.0], head_lr=2e-3,
                           batch_size=args.batch_size, steps_per_epoch=spe,
                           dtype=dtype),
        args.epochs,
    )
    r3 = train(rect_recipe, tr_r, va_r, **seeded_init(rect_recipe))
    results["stage3_rect_val_f1"] = r3.best_value

    # stage 3 AB (plain model, focal, label-aware augmentation)
    tr_a, va_a = filter_stage3(train_b, "AB"), filter_stage3(val_b, "AB")
    ab_recipe = StageRecipe(
        name="demo_ab",
        model=Stage3ABModel,
        label_key="stage3_AB",
        num_classes=4,
        loss_fn=lambda lo, ta: multiclass_focal_loss(lo, ta, 2.0),
        augment_labeled=stage3_ab_augment,
        balance=True,
        phases=[Phase(args.epochs,
                      lambda m: adamw(cosine_schedule(2e-3, args.epochs * spe)),
                      "main")],
        batch_size=args.batch_size,
        dtype=dtype,
    )
    r4 = train(ab_recipe, tr_a, va_a, **seeded_init(ab_recipe))
    results["stage3_ab_val_f1"] = r4.best_value

    # plain pipeline eval + threshold calibration
    models = PipelineModels(*(r.best_state.model for r in (r1, r2, r3, r4)))
    predict = make_v6_pipeline(models, stage1_threshold=0.45, input_dtype=dtype,
                               device=device)
    out = run_pipeline_batched(predict, val_b.samples, batch_size=1024, device=device)
    sweep = best_by(threshold_sweep(val_b.labels["stage1"], out["stage1_prob"]))
    metrics = compute_metrics(
        raw_to_v6_final(val_b.labels["stage0"]), out["final"],
        labels=list(V6_EVAL_CLASS_NAMES),
    )
    results["pipeline_accuracy"] = metrics["accuracy"]
    results["pipeline_macro_f1"] = metrics["macro_f1"]
    results["per_class_f1"] = {
        k: v["f1"] for k, v in metrics["per_class"].items()
    }
    results["cascade"] = decompose_v6(out, val_b.labels["stage0"])
    results["best_threshold_f1"] = sweep["f1"]["threshold"]
    results["total_seconds"] = time.time() - t_start
    results["backend"] = backend

    args.out.mkdir(parents=True, exist_ok=True)
    (args.out / "demo_results.json").write_text(json.dumps(results, indent=2))
    print(json.dumps(results, indent=2))
    assert results["pipeline_accuracy"] > 0.5, "pipeline failed to learn"
    print("OK: end-to-end cascade learned the synthetic structure")


if __name__ == "__main__":
    main()
