"""Learning-rate schedules and the fine-tuning (ULMFiT) optimizer partitions.

Counterpart of ``av1tpu.train.schedules``:

  * the schedules are optax's formulas as plain functions of the step count
    ``k`` (counted from 0 in each phase): cosine decay, warmup-cosine and
    optax's cosine one-cycle (div 25 and 1e4). The one-cycle schedule moves
    the learning rate only; torch's ``OneCycleLR`` would also cycle Adam's
    beta1, which optax does not;
  * ``adamw`` describes one partition's AdamW (beta 0.9/0.999, eps 1e-8,
    decoupled decay scaled by the scheduled lr, an optional clip by the
    partition's global norm); ``TrainOptimizer`` runs such partitions as the
    parameter groups of one ``torch.optim.AdamW``;
  * ``partitioned_optimizer`` labels parameters by the prefix of their
    top-level module name (``label_params_by_prefix``) as
    ``optax.multi_transform`` does; ``FREEZE`` in place of a partition's
    AdamW is ``optax.set_to_zero``: its parameters take no update, no decay
    and hold no optimizer state. BatchNorm statistics are buffers, not
    parameters, so a frozen backbone's statistics still move in train mode,
    as the JAX package's ``batch_stats`` do.

Clipping is per partition, inside it, as ``ulmfit_phase1/2`` wrap
``clip_by_global_norm`` in each ``multi_transform`` partition: the head's norm
is taken over head parameters only. The clip is optax's (scale by
``max_norm / norm`` when ``norm >= max_norm``), not ``clip_grad_norm_``'s.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Dict, List, Mapping, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist
from torch import nn

from av1tpu_torch.parallel.mesh import column_parallel_of

Schedule = Callable[[int], float]


def cosine_schedule(base_lr: float, total_steps: int, warmup_steps: int = 0) -> Schedule:
    """Cosine decay to 0 with an optional linear warmup from 0
    (``optax.cosine_decay_schedule`` / ``warmup_cosine_decay_schedule``)."""
    decay = max(total_steps, 1) if warmup_steps <= 0 else total_steps - warmup_steps
    if decay <= 0:
        raise ValueError(f"the cosine schedule needs decay steps > 0, got {decay}")

    def cosine(k: float) -> float:
        k = min(k, decay)
        return base_lr * (0.5 * (1 + math.cos(math.pi * k / decay)))

    if warmup_steps <= 0:
        return cosine

    def warmup_cosine(k: int) -> float:
        if k < warmup_steps:
            return base_lr * (min(max(k, 0), warmup_steps) / warmup_steps)
        return cosine(k - warmup_steps)

    return warmup_cosine


def onecycle_schedule(max_lr: float, total_steps: int, pct_start: float = 0.3,
                      div_factor: float = 25.0, final_div_factor: float = 1e4) -> Schedule:
    """``optax.cosine_onecycle_schedule``: cosine from ``max_lr / div`` up to
    ``max_lr`` over ``pct_start`` of the steps, then down to
    ``max_lr / (div * final_div)``, held after the last step."""
    total = max(total_steps, 1)
    bounds = [0, int(pct_start * total), int(total)]
    values = [max_lr / div_factor, max_lr, max_lr / (div_factor * final_div_factor)]

    def schedule(k: int) -> float:
        for i in range(2):
            if bounds[i] <= k < bounds[i + 1]:
                pct = (k - bounds[i]) / (bounds[i + 1] - bounds[i])
                start, end = values[i], values[i + 1]
                return end + (start - end) / 2.0 * (math.cos(math.pi * pct) + 1)
        return values[-1] if k >= bounds[-1] else 0.0

    return schedule


@dataclass(frozen=True)
class AdamWSpec:
    """One partition's ``optax.adamw(lr, weight_decay)``, after an optional
    ``clip_by_global_norm(grad_clip)``. ``lr`` is a constant or a schedule of
    the step count."""

    lr: Union[float, Schedule]
    weight_decay: float = 1e-2
    grad_clip: Optional[float] = None

    def lr_at(self, k: int) -> float:
        return float(self.lr(k)) if callable(self.lr) else float(self.lr)


FREEZE = "freeze"  # a partition's transform that is ``optax.set_to_zero()``


def adamw(lr: Union[float, Schedule], weight_decay: float = 1e-2,
          grad_clip: Optional[float] = None) -> AdamWSpec:
    """AdamW as optax builds it (beta 0.9/0.999, eps 1e-8), decay scaled by
    the scheduled lr, optionally after a clip by the global norm."""
    return AdamWSpec(lr, weight_decay, grad_clip)


def _clip_by_global_norm(params: Sequence[torch.Tensor], max_norm: float) -> None:
    """``optax.clip_by_global_norm`` of the params' gradients in place, with
    no host sync: every grad becomes ``g / norm * max_norm`` when ``norm >=
    max_norm``. A parameter that holds its rows of a model-sharded layer
    (``parallel.mesh.ColumnParallel``) adds the squares of the whole layer's
    gradient, summed over its model group."""
    grads = [p.grad for p in params]
    sharded = [p for p in params if column_parallel_of(p) is not None]
    if not sharded:
        sq = sum(torch.sum(g * g) for g in grads)
    else:
        part = sum(torch.sum(p.grad * p.grad) for p in sharded)
        dist.all_reduce(part, group=column_parallel_of(sharded[0]).group)  # one model group
        sq = sum(torch.sum(p.grad * p.grad) for p in params
                 if column_parallel_of(p) is None) + part
    norm = torch.sqrt(sq)
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, g / norm * max_norm))


class TrainOptimizer:
    """Partitions of a model's parameters, each an ``AdamWSpec``, stepped as
    the parameter groups of one ``torch.optim.AdamW``; frozen partitions are
    left out of it. ``count`` is the number of steps taken, the ``k`` of every
    schedule."""

    def __init__(self, groups: Sequence[Tuple[str, List[nn.Parameter], AdamWSpec]]):
        self.labels = [label for label, params, _ in groups if params]
        self.specs = [spec for _, params, spec in groups if params]
        self.params = [p for _, params, _ in groups for p in params]
        self.count = 0
        self.adamw = torch.optim.AdamW(
            [{"params": params, "lr": spec.lr_at(0), "weight_decay": spec.weight_decay}
             for _, params, spec in groups if params],
            betas=(0.9, 0.999), eps=1e-8) if self.params else None

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    def step(self) -> None:
        """One update from the parameters' ``.grad``. A parameter of a
        trainable partition that the loss does not reach has a zero gradient,
        as in the JAX package: its moments decay and weight decay applies."""
        if self.adamw is None:
            self.count += 1
            return
        with torch.no_grad():
            for group, spec in zip(self.adamw.param_groups, self.specs):
                for p in group["params"]:
                    if p.grad is None:
                        p.grad = torch.zeros_like(p)
                if spec.grad_clip is not None:
                    _clip_by_global_norm(group["params"], spec.grad_clip)
                group["lr"] = spec.lr_at(self.count)
        self.adamw.step()
        self.count += 1

    def state_dict(self) -> Dict:
        return {"count": self.count,
                "adamw": None if self.adamw is None else self.adamw.state_dict()}

    def load_state_dict(self, state: Mapping) -> None:
        self.count = int(state["count"])
        if self.adamw is not None:
            self.adamw.load_state_dict(state["adamw"])


def label_params_by_prefix(model: nn.Module, prefix_labels: Mapping[str, str],
                           default: str = "head") -> Dict[str, str]:
    """Parameter name -> label: the label of the first prefix its top-level
    module name starts with, else ``default``. The top-level name
    (``backbone`` of ``backbone.layer1.0.conv1.weight``, :func:`jax_top_level`)
    is the key of the JAX package's params dict that holds the same
    parameter."""
    def label_of(name: str) -> str:
        for prefix, label in prefix_labels.items():
            if name.startswith(prefix):
                return label
        return default

    return {name: label_of(jax_top_level(name)) for name, _ in model.named_parameters()}


def jax_top_level(name: str) -> str:
    """The JAX package's top-level params key of a port parameter name:
    the first component, except the v5 model's ``specialist_heads.<H>.*``,
    which flax keeps as ``specialist_<H>``."""
    parts = name.split(".")
    if parts[0] == "specialist_heads":
        return f"specialist_{parts[1]}"
    return parts[0]


def partitioned_optimizer(model: nn.Module,
                          transforms: Mapping[str, Union[AdamWSpec, str]],
                          prefix_labels: Mapping[str, str],
                          default: str = "head") -> TrainOptimizer:
    """``optax.multi_transform`` over prefix-labelled parameters; a
    ``FREEZE`` transform freezes its partition."""
    labels = label_params_by_prefix(model, prefix_labels, default)
    named = dict(model.named_parameters())
    groups = []
    for label, spec in transforms.items():
        if spec == FREEZE:
            continue
        groups.append((label, [named[n] for n, lab in labels.items() if lab == label], spec))
    unknown = set(labels.values()) - set(transforms)
    if unknown:
        raise ValueError(f"no transform for the labels {sorted(unknown)}")
    return TrainOptimizer(groups)


def as_optimizer(model: nn.Module, spec: Union[AdamWSpec, TrainOptimizer]) -> TrainOptimizer:
    """A phase's optimizer: an ``AdamWSpec`` takes every parameter of the
    model as one partition."""
    if isinstance(spec, TrainOptimizer):
        return spec
    return TrainOptimizer([("all", list(model.parameters()), spec)])


def ulmfit_phase1(model: nn.Module, head_lr: float, total_steps: int,
                  weight_decay: float = 1e-2, grad_clip: Optional[float] = 1.0,
                  backbone_prefix: str = "backbone") -> TrainOptimizer:
    """Frozen-backbone phase: the backbone frozen, the head on cosine
    (parity: 004's freeze epochs with only the head's param group)."""
    return partitioned_optimizer(
        model,
        {"frozen": FREEZE,
         "head": adamw(cosine_schedule(head_lr, total_steps), weight_decay, grad_clip)},
        {backbone_prefix: "frozen"},
    )


def ulmfit_phase2(model: nn.Module, head_lr: float, backbone_lr: float, total_steps: int,
                  weight_decay: float = 1e-2, grad_clip: Optional[float] = 1.0,
                  backbone_prefix: str = "backbone") -> TrainOptimizer:
    """Unfrozen phase with discriminative LRs and a fresh cosine restart
    (parity: 004:407-431)."""
    return partitioned_optimizer(
        model,
        {"backbone": adamw(cosine_schedule(backbone_lr, total_steps), weight_decay, grad_clip),
         "head": adamw(cosine_schedule(head_lr, total_steps), weight_decay, grad_clip)},
        {backbone_prefix: "backbone"},
    )


__all__ = [
    "AdamWSpec",
    "FREEZE",
    "TrainOptimizer",
    "adamw",
    "as_optimizer",
    "cosine_schedule",
    "jax_top_level",
    "label_params_by_prefix",
    "onecycle_schedule",
    "partitioned_optimizer",
    "ulmfit_phase1",
    "ulmfit_phase2",
]
