"""Per-stage training recipes and ``train_stage``, the loop that runs them.

Counterpart of ``av1tpu.train.stages``: the v6 stage-1, stage-2, stage-3
RECT, AB-FGVC and AB-ensemble recipes, the flatten recipe and the v5 stage-1,
stage-2 and stage-3 specialist recipes (the FGVC composite loss with CutMix
and the center loss is ``train.fgvc_step``). ``train_stage`` runs a recipe's phases, each with a
fresh optimizer, over balanced or shuffled epochs; tracks the best value of
the recipe's metric; checkpoints ``<name>_best`` (verified), the rolling
``<name>_last`` resume anchor and ``<name>_final``, each with a
``variables.npz`` in the JAX package's key layout; stops early; and resumes.

Resume is full-fidelity: the whole ``TrainState`` (parameters, BatchNorm
statistics, optimizer moments, step count) comes back from ``<name>_last``,
each epoch's generators are seeded from ``(seed, epoch)`` alone, and each
epoch's data order from ``seed + epoch`` (the JAX package's numpy orders,
bitwise), so a run interrupted at epoch k and resumed is identical to the
run that was not interrupted. A directory holding only ``variables.npz`` (a
JAX run's, or a legacy one) resumes with its parameters and statistics and a
fresh optimizer.

A recipe's ``model`` is a zero-argument factory (a class); ``train_stage``
draws its parameters after flax's initializers from ``seed`` unless
``init_params`` are given.
"""
from __future__ import annotations

import copy
import inspect
import json
from dataclasses import dataclass, field, replace
from pathlib import Path
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from av1tpu_torch.data.bundles import Bundle
from av1tpu_torch.models import (
    FGVCModel,
    HierarchicalModel,
    Stage1Model,
    Stage2FlatModel,
    Stage2Model,
    Stage2ModelWithAdapters,
    Stage3ABModel,
    Stage3RectModel,
    load_jax_variables,
    to_jax_variables,
)
from av1tpu_torch.models.layers import init_like_flax
from av1tpu_torch.parallel.mesh import place_params
from av1tpu_torch.train.augment import (
    stage1_augment,
    stage2_augment,
    stage3_ab_augment,
    stage3_rect_augment,
    v5_stage3_ab_augment,
)
from av1tpu_torch.train.checkpoint import (
    STATE_FILE,
    load_variables_npz,
    restore_checkpoint,
    save_checkpoint,
    save_variables_npz,
)
from av1tpu_torch.train.losses import (
    binary_focal_loss,
    class_balanced_focal_loss,
    hard_negative_mining_loss,
    mixup_batch,
    multiclass_focal_loss,
    stage1_focal_bce_v5,
    weighted_ce_label_smoothing,
)
from av1tpu_torch.train.schedules import (
    FREEZE,
    TrainOptimizer,
    adamw,
    as_optimizer,
    cosine_schedule,
    partitioned_optimizer,
    ulmfit_phase1,
    ulmfit_phase2,
)
from av1tpu_torch.train.trainer import (
    StepConfig,
    TrainState,
    make_eval_step,
    make_train_step,
    resident_eligible,
    resident_eval_arrays,
    run_eval,
    run_eval_resident,
    run_train_epoch,
    run_train_epoch_resident,
    to_device,
)


@dataclass
class Phase:
    """One optimizer phase: epochs and an optimizer factory, called as
    ``(model, steps_per_epoch)`` when it takes two arguments, else
    ``(model)``; it returns an ``AdamWSpec`` (every parameter one partition)
    or a ``TrainOptimizer``."""

    epochs: int
    make_optimizer: Callable
    name: str = "phase"


def _phase_optimizer(phase: Phase, model: nn.Module, steps_per_epoch: int) -> TrainOptimizer:
    fn = phase.make_optimizer
    try:
        arity = len(inspect.signature(fn).parameters)
    except (TypeError, ValueError):
        arity = 1
    spec = fn(model, steps_per_epoch) if arity >= 2 else fn(model)
    return as_optimizer(model, spec)


@dataclass
class StageRecipe:
    """Everything needed to train one stage (``av1tpu.train.StageRecipe``;
    ``model`` is a factory, ``dtype`` the compute dtype of ``--bf16``)."""

    name: str
    model: Callable[[], nn.Module]
    label_key: str
    num_classes: int
    loss_fn: Callable
    phases: List[Phase]
    binary: bool = False
    augment: Optional[Callable] = None
    augment_labeled: Optional[Callable] = None
    balance: bool = False
    best_metric: str = "macro_f1"
    early_stop_patience: Optional[int] = None
    batch_size: int = 256
    input_shape: Tuple[int, int, int] = (16, 16, 1)
    apply_kwargs: Mapping[str, Any] = field(default_factory=dict)
    logits_fn: Optional[Callable] = None
    steps_per_epoch: Optional[int] = None
    use_qp: bool = False
    batch_mix: Optional[Callable] = None
    predictions_fn: Optional[Callable] = None
    metric_labels_fn: Optional[Callable] = None
    dtype: torch.dtype = torch.float32


@dataclass
class TrainResult:
    state: TrainState
    best_state: Optional[TrainState]
    best_value: float
    history: List[Dict]

    def save_history(self, path: Path) -> None:
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(self.history, indent=2))


def _bundle_arrays(bundle: Bundle, label_key: str, use_qp: bool = False) -> Dict[str, np.ndarray]:
    arrays = {"samples": bundle.samples, label_key: bundle.labels[label_key]}
    if use_qp:
        arrays["qp"] = bundle.qps
    return arrays


def epoch_seeds(seed: int, epoch: int) -> Tuple[int, int]:
    """The seeds of one epoch's augmentation generator and dropout stream,
    from ``(seed, epoch)`` alone (whether or not earlier epochs ran in this
    process)."""
    a, b = np.random.SeedSequence([seed, epoch]).generate_state(2, np.uint64)
    return int(a >> np.uint64(1)), int(b >> np.uint64(1))


def variables_of(model: nn.Module) -> Dict[str, Dict]:
    """The JAX package's ``{"params", "batch_stats"}`` tree of ``model``."""
    return to_jax_variables(model.state_dict())


def _init_model(recipe: StageRecipe, seed: int, init_params, init_batch_stats) -> nn.Module:
    model = init_like_flax(recipe.model(), torch.Generator().manual_seed(seed))
    if init_params is None and init_batch_stats is None:
        return model
    variables = variables_of(model)
    if init_params is not None:
        variables["params"] = init_params
    if init_batch_stats is not None:
        variables["batch_stats"] = init_batch_stats
    return load_jax_variables(model, variables)


def _save_resume_variables(ckpt_dir: Path, state: TrainState) -> None:
    save_variables_npz(Path(ckpt_dir) / "variables.npz", variables_of(state.model),
                       compress=False)


def _snapshot(state: TrainState) -> TrainState:
    """A copy of the state on its device (model, optimizer and step)."""
    return copy.deepcopy(state)


def train_stage(
    recipe: StageRecipe,
    train_bundle: Bundle,
    val_bundle: Bundle,
    seed: int = 42,
    init_params=None,
    init_batch_stats=None,
    checkpoint_dir: Optional[Path] = None,
    resume_from: Optional[Path] = None,
    stop_after_epoch: Optional[int] = None,
    checkpoint_every: int = 10,
    log: Callable[[str], None] = print,
    device="cuda",
    mesh=None,
) -> TrainResult:
    """Run all phases of a recipe on ``device``; returns the final and best
    states. ``init_params`` / ``init_batch_stats`` are JAX-layout trees
    (a transplanted backbone). ``checkpoint_every`` spaces the rolling
    ``_last`` anchor (plus the last epoch of every phase): epochs replay
    deterministically, so a sparse anchor costs recovery time, never
    correctness.

    ``mesh`` (``parallel.mesh``; every rank calls with the same arguments,
    ``device`` its own card): ``recipe.batch_size`` is the global batch,
    which the data axis splits; the model axis shards the wide layers
    (``place_params``). Every rank holds the same state after each step and
    the same global metrics; rank 0 writes the checkpoints."""
    device = torch.device(device)
    model = _init_model(recipe, seed, init_params, init_batch_stats).to(device)
    if mesh is not None:
        model = place_params(model, mesh)
    steps_per_epoch = recipe.steps_per_epoch or max(1, len(train_bundle) // recipe.batch_size)

    start_epoch, resume_best, resume_no_improve = 0, None, 0
    resume_state, resume_phase_idx = None, -1
    if resume_from is not None:
        resume_from = Path(resume_from)
        meta_path = resume_from / "meta.json"
        meta = json.loads(meta_path.read_text()) if meta_path.exists() else {}
        start_epoch = meta.get("epoch", -1) + 1
        if "best_value" in meta:
            resume_best = meta["best_value"]
        elif meta.get("metric") == recipe.best_metric:
            resume_best = meta.get("value")
        resume_no_improve = int(meta.get("no_improve", 0))
        saved_phase = meta.get("phase_index")
        if saved_phase is not None and (resume_from / STATE_FILE).exists():
            template = TrainState(model, _phase_optimizer(recipe.phases[saved_phase], model,
                                                          steps_per_epoch))
            resume_state, _ = restore_checkpoint(resume_from, template)
            resume_phase_idx = int(saved_phase)
        else:  # variables only (a JAX run's orbax directory too): a fresh optimizer
            restored = load_variables_npz(resume_from / "variables.npz")
            load_jax_variables(model, {"params": restored["params"],
                                       "batch_stats": restored.get("batch_stats", {})})
        log(f"[{recipe.name}] resuming from {resume_from} at epoch {start_epoch}")

    arrays = _bundle_arrays(train_bundle, recipe.label_key, recipe.use_qp)
    val_arrays = _bundle_arrays(val_bundle, recipe.label_key, recipe.use_qp)
    balance_labels = arrays[recipe.label_key] if recipe.balance else None
    resident = resident_eligible(arrays)
    if resident:
        device_arrays = to_device(arrays, device)
        device_val, n_val = resident_eval_arrays(val_arrays, device)
        log(f"[{recipe.name}] device-resident data "
            f"({sum(a.nbytes for a in arrays.values()) / 2**20:.0f} MiB, {device})")

    cfg = StepConfig(
        loss_fn=recipe.loss_fn, label_key=recipe.label_key, augment=recipe.augment,
        augment_labeled=recipe.augment_labeled, binary=recipe.binary,
        num_classes=recipe.num_classes, apply_kwargs=dict(recipe.apply_kwargs),
        logits_fn=recipe.logits_fn, use_qp=recipe.use_qp, batch_mix=recipe.batch_mix,
        predictions_fn=recipe.predictions_fn, metric_labels_fn=recipe.metric_labels_fn,
        compute_dtype=recipe.dtype,
    )
    eval_step = make_eval_step(model, cfg)

    history: List[Dict] = []
    best_value = resume_best if resume_best is not None else -np.inf
    best_state, best_epoch, best_dirty = None, -1, False
    state: Optional[TrainState] = None
    epoch_global = 0
    no_improve = resume_no_improve

    for phase_idx, phase in enumerate(recipe.phases):
        phase_start = epoch_global
        phase_end = phase_start + phase.epochs
        if start_epoch >= phase_end:  # finished before the resume point
            epoch_global = phase_end
            continue
        if resume_state is not None and phase_idx == resume_phase_idx \
                and start_epoch > phase_start:
            state = resume_state  # mid-phase: the checkpointed optimizer continues
        else:
            step = (resume_state.step if resume_state is not None
                    else state.step if state is not None else 0)
            state = TrainState(model, _phase_optimizer(phase, model, steps_per_epoch), step)
        resume_state = None
        train_step = make_train_step(model, state.optimizer, cfg, mesh)
        log(f"[{recipe.name}] phase '{phase.name}': {phase.epochs} epochs")

        for _ in range(phase.epochs):
            if epoch_global < start_epoch:
                epoch_global += 1
                continue
            aug_seed, dropout_seed = epoch_seeds(seed, epoch_global)
            gen = torch.Generator(device=device).manual_seed(aug_seed)
            with torch.random.fork_rng(devices=[device] if device.type == "cuda" else []):
                torch.manual_seed(dropout_seed)
                if resident:
                    state, tr = run_train_epoch_resident(
                        train_step, state, device_arrays, recipe.batch_size, gen,
                        epoch_seed=seed + epoch_global, num_classes=recipe.num_classes,
                        balance_labels=balance_labels)
                else:
                    state, tr = run_train_epoch(
                        train_step, state, arrays, recipe.batch_size, gen,
                        epoch_seed=seed + epoch_global, num_classes=recipe.num_classes,
                        balance_labels=balance_labels, device=device, mesh=mesh)
            if resident:
                ev = run_eval_resident(eval_step, state, device_val, n_val,
                                       recipe.batch_size, recipe.num_classes)
            else:
                ev = run_eval(eval_step, state, val_arrays, recipe.batch_size,
                              recipe.num_classes, device, mesh)
            value = ev.metrics[recipe.best_metric]
            history.append({
                "epoch": epoch_global, "phase": phase.name, "train_loss": tr.loss,
                "train_metrics": tr.metrics, "val_loss": ev.loss, "val_metrics": ev.metrics,
                "train_seconds": tr.seconds, "throughput": tr.throughput,
            })
            log(f"[{recipe.name}] epoch {epoch_global}: train_loss={tr.loss:.4f} "
                f"val_{recipe.best_metric}={value:.4f} ({tr.throughput:.0f} samples/s)")
            if value > best_value:
                best_value, best_epoch, best_dirty = value, epoch_global, True
                best_state = _snapshot(state)
                no_improve = 0
            else:
                no_improve += 1
            anchor_due = ((epoch_global + 1) % max(1, checkpoint_every) == 0
                          or epoch_global + 1 == phase_end
                          or epoch_global == stop_after_epoch)
            if checkpoint_dir is not None and anchor_due and best_dirty:
                ckpt_dir = save_checkpoint(
                    Path(checkpoint_dir) / f"{recipe.name}_best", best_state,
                    meta={"epoch": best_epoch, "metric": recipe.best_metric,
                          "value": float(best_value)},
                    verify=True)
                _save_resume_variables(ckpt_dir, best_state)
                best_dirty = False
            if checkpoint_dir is not None and anchor_due:
                # the rolling resume anchor; verified saves are the _best and
                # _final ones (re-verifying every anchor doubles its cost)
                last_dir = save_checkpoint(
                    Path(checkpoint_dir) / f"{recipe.name}_last", state,
                    meta={"epoch": epoch_global, "phase_index": phase_idx,
                          "metric": recipe.best_metric, "best_value": float(best_value),
                          "no_improve": int(no_improve)},
                    verify=False)
                _save_resume_variables(last_dir, state)
            epoch_global += 1
            if stop_after_epoch is not None and epoch_global > stop_after_epoch:
                log(f"[{recipe.name}] stopping after epoch {stop_after_epoch}")
                break
            if (recipe.early_stop_patience is not None
                    and no_improve >= recipe.early_stop_patience):
                log(f"[{recipe.name}] early stop (patience {recipe.early_stop_patience})")
                break
        else:
            continue
        break

    if checkpoint_dir is not None and best_dirty and best_state is not None:
        ckpt_dir = save_checkpoint(
            Path(checkpoint_dir) / f"{recipe.name}_best", best_state,
            meta={"epoch": best_epoch, "metric": recipe.best_metric,
                  "value": float(best_value)},
            verify=True)
        _save_resume_variables(ckpt_dir, best_state)
    if checkpoint_dir is not None and state is not None:
        final_dir = save_checkpoint(Path(checkpoint_dir) / f"{recipe.name}_final", state,
                                    meta={"epoch": epoch_global - 1}, verify=True)
        _save_resume_variables(final_dir, state)
    return TrainResult(state=state, best_state=best_state, best_value=float(best_value),
                       history=history)


# ---------------------------------------------------------------------------
# v6 recipes
# ---------------------------------------------------------------------------

def stage1_recipe(epochs: int = 30, lr: float = 1e-3, batch_size: int = 256,
                  alpha: float = 0.25, gamma: float = 2.5, weight_decay: float = 1e-2,
                  steps_per_epoch: Optional[int] = None, dtype=torch.float32,
                  use_hard_mining: bool = False, hard_mining_ratio: float = 3.0
                  ) -> StageRecipe:
    """v6 stage 1: focal loss (or hard-negative mining at
    ``hard_mining_ratio`` negatives per positive, which the reference's own
    flag could not run, quirk Q2), balanced sampler, AdamW + cosine, best F1
    (parity: 003_train_stage1_improved.py:211-302)."""
    if use_hard_mining:
        loss = lambda lo, ta: hard_negative_mining_loss(lo, ta, neg_pos_ratio=hard_mining_ratio)
    else:
        loss = lambda lo, ta: binary_focal_loss(lo, ta, alpha, gamma)
    return StageRecipe(
        name="stage1", model=Stage1Model, label_key="stage1", num_classes=2, binary=True,
        loss_fn=loss, augment=stage1_augment, balance=True,
        phases=[Phase(epochs, lambda m, spe: adamw(
            cosine_schedule(lr, epochs * spe), weight_decay), "cosine")],
        batch_size=batch_size, best_metric="macro_f1", steps_per_epoch=steps_per_epoch,
        dtype=dtype,
    )


def stage2_recipe(samples_per_class: Sequence[int], freeze_epochs: int = 5,
                  unfreeze_epochs: int = 25, head_lr: float = 5e-4,
                  backbone_lr: float = 1e-6, batch_size: int = 256, beta: float = 0.9999,
                  gamma: float = 2.0, steps_per_epoch: Optional[int] = None,
                  scratch: bool = False, use_adapters: bool = False, dtype=torch.float32
                  ) -> StageRecipe:
    """v6 stage 2: CB-focal + the ULMFiT freeze / unfreeze (parity:
    004:353-431). ``scratch`` trains one phase without freezing;
    ``use_adapters`` trains the adapter model with its backbone frozen for
    every epoch (Exp 11A)."""
    loss = lambda lo, ta: class_balanced_focal_loss(lo, ta, list(samples_per_class), beta,
                                                    gamma)
    all_epochs = freeze_epochs + unfreeze_epochs
    if use_adapters:
        model = Stage2ModelWithAdapters
        phases = [Phase(all_epochs, lambda m, spe: ulmfit_phase1(
            m, head_lr, all_epochs * spe, backbone_prefix="backbone_"), "adapters")]
    else:
        model = Stage2Model
        if scratch:
            phases = [Phase(all_epochs, lambda m, spe: adamw(
                cosine_schedule(head_lr, all_epochs * spe)), "scratch")]
        else:
            phases = [
                Phase(freeze_epochs, lambda m, spe: ulmfit_phase1(
                    m, head_lr, freeze_epochs * spe), "frozen"),
                Phase(unfreeze_epochs, lambda m, spe: ulmfit_phase2(
                    m, head_lr, backbone_lr, unfreeze_epochs * spe), "unfrozen"),
            ]
    return StageRecipe(
        name="stage2", model=model, label_key="stage2", num_classes=3, loss_fn=loss,
        augment=stage2_augment, balance=True, phases=phases, batch_size=batch_size,
        best_metric="macro_f1", steps_per_epoch=steps_per_epoch, dtype=dtype,
    )


def stage3_rect_recipe(class_weights: Sequence[float], freeze_epochs: int = 5,
                       unfreeze_epochs: int = 25, head_lr: float = 1e-3,
                       batch_size: int = 256, label_smoothing: float = 0.1,
                       steps_per_epoch: Optional[int] = None, early_stop_patience: int = 5,
                       dtype=torch.float32) -> StageRecipe:
    """v6 stage-3 RECT: weighted CE with label smoothing 0.1, the backbone
    frozen and then unfrozen at ``head_lr * 0.01``, clip 1.0, patience 5
    (parity: 005_train_stage3_rect.py:484-575)."""
    cw = np.asarray(class_weights, dtype=np.float32)
    loss = lambda lo, ta: weighted_ce_label_smoothing(lo, ta, cw, label_smoothing)
    return StageRecipe(
        name="stage3_rect", model=Stage3RectModel, label_key="stage3_RECT", num_classes=2,
        loss_fn=loss, augment=stage3_rect_augment,
        phases=[
            Phase(freeze_epochs, lambda m, spe: ulmfit_phase1(
                m, head_lr, freeze_epochs * spe, grad_clip=1.0), "frozen"),
            Phase(unfreeze_epochs, lambda m, spe: ulmfit_phase2(
                m, head_lr, head_lr * 0.01, unfreeze_epochs * spe, grad_clip=1.0), "unfrozen"),
        ],
        batch_size=batch_size, best_metric="macro_f1", early_stop_patience=early_stop_patience,
        steps_per_epoch=steps_per_epoch, dtype=dtype,
    )


def stage3_ab_fgvc_recipe(freeze_epochs: int = 5, unfreeze_epochs: int = 25,
                          head_lr: float = 1e-3, backbone_lr: float = 1e-6,
                          batch_size: int = 128, steps_per_epoch: Optional[int] = None,
                          dtype=torch.float32) -> StageRecipe:
    """v6 stage-3 AB on the FGVC model: focal loss, the label-aware AB
    augmentation, balanced epochs, 5 frozen and 25 unfrozen epochs at
    backbone lr 1e-6 (parity: 006_train_stage3_ab_fgvc.py:739-857). The
    CutMix + center-loss composite is ``train.fgvc_step`` (``train_stage3
    --fgvc``); this recipe is the schedule and augmentation."""
    return StageRecipe(
        name="stage3_ab", model=FGVCModel, label_key="stage3_AB", num_classes=4,
        loss_fn=lambda lo, ta: multiclass_focal_loss(lo, ta, 2.0),
        augment_labeled=stage3_ab_augment, balance=True,
        phases=[
            Phase(freeze_epochs, lambda m, spe: ulmfit_phase1(
                m, head_lr, freeze_epochs * spe), "frozen"),
            Phase(unfreeze_epochs, lambda m, spe: ulmfit_phase2(
                m, head_lr, backbone_lr, unfreeze_epochs * spe), "unfrozen"),
        ],
        batch_size=batch_size, best_metric="macro_f1", steps_per_epoch=steps_per_epoch,
        dtype=dtype,
    )


def stage3_ab_ensemble_recipe(seed_offset: int = 0, mixup_alpha: float = 0.4,
                              **kw) -> StageRecipe:
    """One AB-ensemble member: the plain ``Stage3ABModel`` with Mixup
    (alpha 0.4) over the FGVC recipe's focal loss and schedule (parity:
    006_train_stage3_ab_ensemble_reference.py:52-80); ``mixup_alpha=0``
    turns the mixing off."""
    batch_mix = ((lambda gen, images: mixup_batch(gen, images, mixup_alpha))
                 if mixup_alpha > 0 else None)
    return replace(stage3_ab_fgvc_recipe(**kw), name=f"stage3_ab_member{seed_offset}",
                   model=Stage3ABModel, batch_mix=batch_mix)


def flatten_recipe(samples_per_class: Sequence[int], freeze_epochs: int = 15,
                   unfreeze_epochs: int = 25, max_lr: float = 1e-3, batch_size: int = 256,
                   beta: float = 0.9999, gamma: float = 2.5,
                   steps_per_epoch: Optional[int] = None, early_stop_patience: int = 8,
                   dtype=torch.float32) -> StageRecipe:
    """Flatten 7-way: CB-focal (beta 0.9999, gamma 2.5), 15 frozen then 25
    unfrozen epochs at ``max_lr * 0.01``, patience 8 (parity: 004b:461-590)."""
    loss = lambda lo, ta: class_balanced_focal_loss(lo, ta, list(samples_per_class), beta,
                                                    gamma)
    return StageRecipe(
        name="stage2_flat", model=Stage2FlatModel, label_key="flatten", num_classes=7,
        loss_fn=loss, augment=stage2_augment, balance=True,
        phases=[
            Phase(freeze_epochs, lambda m, spe: ulmfit_phase1(
                m, max_lr, freeze_epochs * spe), "frozen"),
            Phase(unfreeze_epochs, lambda m, spe: ulmfit_phase2(
                m, max_lr, max_lr * 0.01, unfreeze_epochs * spe), "unfrozen"),
        ],
        batch_size=batch_size, best_metric="macro_f1", early_stop_patience=early_stop_patience,
        steps_per_epoch=steps_per_epoch, dtype=dtype,
    )


# ---------------------------------------------------------------------------
# v5 recipes (shared-backbone HierarchicalModel)
# ---------------------------------------------------------------------------

def v5_stage1_recipe(epochs: int = 20, lr: float = 1e-3, batch_size: int = 256,
                     pos_weight: float = 1.0, gamma: float = 0.0,
                     steps_per_epoch: Optional[int] = None, use_qp: bool = False
                     ) -> StageRecipe:
    """v5 stage 1 (parity: 009_train_stage1.py): BCE + pos_weight + focal
    factor, 1:1 weighted sampling, the shared model's stage-1 path;
    ``use_qp`` conditions on the per-block QP (quirk Q6)."""
    loss = lambda out, ta: stage1_focal_bce_v5(out.stage1, ta, pos_weight, gamma)
    return StageRecipe(
        name="v5_stage1", model=lambda: HierarchicalModel(use_qp=use_qp),
        label_key="stage1", num_classes=2, binary=True, loss_fn=loss, balance=True,
        phases=[Phase(epochs, lambda m, spe: adamw(cosine_schedule(lr, epochs * spe)),
                      "main")],
        batch_size=batch_size, best_metric="macro_f1", logits_fn=lambda out: out.stage1,
        steps_per_epoch=steps_per_epoch, use_qp=use_qp,
    )


def v5_stage2_recipe(class_weights: Sequence[float], epochs: int = 20, lr: float = 1e-3,
                     batch_size: int = 256, label_smoothing: float = 0.05,
                     freeze_backbone: bool = False, steps_per_epoch: Optional[int] = None,
                     use_qp: bool = False) -> StageRecipe:
    """v5 stage 2 (parity: 010_train_stage2.py): weighted CE + smoothing over
    the shared model's 5-way head; optional backbone freeze."""
    cw = np.asarray(class_weights, dtype=np.float32)
    loss = lambda out, ta: weighted_ce_label_smoothing(out.stage2, ta, cw, label_smoothing)
    if freeze_backbone:
        phases = [Phase(epochs, lambda m, spe: ulmfit_phase1(m, lr, epochs * spe), "frozen")]
    else:
        phases = [Phase(epochs, lambda m, spe: adamw(cosine_schedule(lr, epochs * spe)),
                        "main")]
    return StageRecipe(
        name="v5_stage2", model=lambda: HierarchicalModel(use_qp=use_qp),
        label_key="stage2", num_classes=5, loss_fn=loss, phases=phases,
        batch_size=batch_size, best_metric="macro_f1", logits_fn=lambda out: out.stage2,
        steps_per_epoch=steps_per_epoch, use_qp=use_qp,
    )


V5_SPECIALISTS = {"RECT": 2, "AB": 4, "1TO4": 2}  # head -> classes


def v5_stage3_recipe(head: str, class_weights: Sequence[float], epochs: int = 20,
                     lr: float = 5e-4, batch_size: int = 256,
                     steps_per_epoch: Optional[int] = None, use_qp: bool = False
                     ) -> StageRecipe:
    """v5 stage-3 specialist (parity: 012_train_stage3.py): every
    partition but the target specialist head frozen (no update, no decay, no
    AdamW state), squared-inverse-frequency class weights, and for AB the v5
    label-aware flips (``augment.v5_ab_flip_rot90``)."""
    cw = np.asarray(class_weights, dtype=np.float32)
    loss = lambda out, ta: weighted_ce_label_smoothing(out.specialists[head], ta, cw, 0.0)
    frozen = {"backbone": "frozen", "stage1_head": "frozen", "stage2_head": "frozen",
              **{f"specialist_{h}": "frozen" for h in V5_SPECIALISTS if h != head}}
    make_opt = lambda m, spe: partitioned_optimizer(
        m, {"frozen": FREEZE, "head": adamw(cosine_schedule(lr, epochs * spe))}, frozen)
    return StageRecipe(
        name=f"v5_stage3_{head}", model=lambda: HierarchicalModel(use_qp=use_qp),
        label_key=f"stage3_{head}", num_classes=V5_SPECIALISTS[head], loss_fn=loss,
        augment_labeled=v5_stage3_ab_augment if head == "AB" else None,
        phases=[Phase(epochs, make_opt, "specialist")], batch_size=batch_size,
        best_metric="macro_f1", logits_fn=lambda out: out.specialists[head],
        steps_per_epoch=steps_per_epoch, use_qp=use_qp,
    )


# ---------------------------------------------------------------------------
# Pipeline-aware filtering (004c) and the v5 stage-3 class weights
# ---------------------------------------------------------------------------

def filter_through_stage1(bundle: Bundle, stage1_model: nn.Module, threshold: float = 0.45,
                          batch_size: int = 4096, norm_scale: float = 1023.0,
                          device="cuda", dtype=torch.float32) -> Bundle:
    """Keep only the samples the stage-1 model (eval mode, on ``device`` in
    ``dtype``) predicts PARTITION at ``threshold`` (H2.1, parity:
    004c:142-180)."""
    model = copy.deepcopy(stage1_model).to(device).eval()
    keep = np.zeros(len(bundle), dtype=bool)
    with torch.no_grad(), torch.autocast(device_type=torch.device(device).type, dtype=dtype,
                                         enabled=dtype != torch.float32):
        for start in range(0, len(bundle), batch_size):
            chunk = torch.from_numpy(bundle.samples[start: start + batch_size]).to(device)
            x = chunk.to(torch.float32) / norm_scale
            keep[start: start + len(chunk)] = (
                torch.sigmoid(model(x).float()) >= threshold).cpu().numpy()
    return bundle.take(np.flatnonzero(keep))


def squared_inverse_freq_weights(labels: np.ndarray, num_classes: int) -> np.ndarray:
    """v5 stage-3 class weighting (parity: 012_train_stage3.py:76-81)."""
    counts = np.bincount(labels[labels >= 0], minlength=num_classes).astype(np.float64)
    weights = (1.0 / np.maximum(counts, 1)) ** 2
    return (weights / weights.sum() * num_classes).astype(np.float32)


__all__ = [
    "Phase",
    "StageRecipe",
    "TrainResult",
    "epoch_seeds",
    "V5_SPECIALISTS",
    "filter_through_stage1",
    "flatten_recipe",
    "squared_inverse_freq_weights",
    "stage1_recipe",
    "stage2_recipe",
    "stage3_ab_ensemble_recipe",
    "stage3_ab_fgvc_recipe",
    "stage3_rect_recipe",
    "train_stage",
    "v5_stage1_recipe",
    "v5_stage2_recipe",
    "v5_stage3_recipe",
    "variables_of",
]
