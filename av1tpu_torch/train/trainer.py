"""The stage trainer: train and eval steps, the epoch loops, metrics.

Counterpart of ``av1tpu.train.trainer``. One train step is

    uint16 batch -> float / 1023 -> augmentation (device generator) ->
    optional batch mixing -> forward in train mode (optional QP input,
    bf16 autocast) -> loss -> backward -> the partitioned AdamW step

with the confusion matrix accumulated on the device (one-hot products), so
the host reads the epoch's loss and confusion once, at its end.

Two epoch loops give the same result: the streaming one gathers each batch
on the host and copies it to the device; the **device-resident** one (taken
under the same ``RESIDENT_MAX_BYTES`` policy as the JAX package) copies the
dataset to the device once and gathers each step's batch there from the
epoch's ``(steps, batch)`` index matrix. It is one loop of eager steps, not a
captured graph.

Over a mesh (``parallel.mesh``) the streaming loop runs in every process,
each data rank on its contiguous shard of the epoch order with its share of
the global batch; the steps gather what the global batch decides (the draws,
the BatchNorm statistics, the loss) and average the gradients, and the
metrics come out global on every rank.

``--bf16`` in the port: the forward runs under ``torch.autocast`` in
bfloat16 (convolutions and matmuls in bf16 over fp32 parameters), BatchNorm
statistics are taken in fp32, and the loss is computed in fp32 on the logits
cast up. The JAX package instead gives every flax module ``dtype=bfloat16``
and computes the loss on bf16 logits; the two agree loosely, not bitwise.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Iterator, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from av1tpu_torch.data.records import NORM_10BIT
from av1tpu_torch.data.sampling import (
    balanced_epoch_indices,
    host_shard,
    shuffled_epoch_indices,
)
from av1tpu_torch.parallel.mesh import (
    DATA_AXIS,
    axis_group,
    axis_index,
    axis_size,
    data_parallel,
    gather_group,
    local_batch_slice,
    local_rows,
    sync_gradients,
    world_size,
)
from av1tpu_torch.train.losses import mixed_loss
from av1tpu_torch.train.schedules import TrainOptimizer


@dataclass
class TrainState:
    """What one train step changes: the model (parameters and BatchNorm
    statistics), its optimizer, and the number of steps taken."""

    model: nn.Module
    optimizer: TrainOptimizer
    step: int = 0


@dataclass
class StepConfig:
    """What the train and eval steps compute (``av1tpu.train.StepConfig``)."""

    loss_fn: Callable  # (outputs, labels) -> scalar
    label_key: str
    augment: Optional[Callable] = None          # (gen, images) -> images
    augment_labeled: Optional[Callable] = None  # (gen, images, labels) -> (images, labels)
    norm_scale: float = NORM_10BIT
    binary: bool = False
    num_classes: int = 2
    apply_kwargs: Mapping[str, Any] = field(default_factory=dict)
    # Feed batch["qp"] / 255 as the model's second positional arg (v5)
    use_qp: bool = False
    # Structured outputs (the v5 HierarchicalOutputs) -> the logits predicted from
    logits_fn: Optional[Callable] = None
    # (gen, images) -> (mixed images, perm, lam): Mixup/CutMix, train only
    batch_mix: Optional[Callable] = None
    predictions_fn: Optional[Callable] = None
    metric_labels_fn: Optional[Callable] = None
    # bfloat16: the forward under autocast (see the module docstring)
    compute_dtype: torch.dtype = torch.float32

    def predictions(self, outputs):
        if self.predictions_fn is not None:
            return self.predictions_fn(outputs)
        logits = self.logits_fn(outputs) if self.logits_fn else outputs
        if self.binary:
            return (torch.sigmoid(logits) >= 0.5).long()
        return torch.argmax(logits, dim=-1)

    def metric_labels(self, labels):
        return self.metric_labels_fn(labels) if self.metric_labels_fn is not None else labels


def confusion_matrix(labels: torch.Tensor, preds: torch.Tensor, num_classes: int):
    """Confusion as a one-hot product; labels < 0 contribute nothing."""
    valid = (labels >= 0).float()
    lab_oh = torch.nn.functional.one_hot(torch.clamp(labels, min=0).long(), num_classes)
    pred_oh = torch.nn.functional.one_hot(preds.long(), num_classes).float()
    return (lab_oh.float() * valid[:, None]).T @ pred_oh


def _autocast(device: torch.device, dtype: torch.dtype):
    if dtype == torch.float32:
        return contextlib.nullcontext()
    return torch.autocast(device_type=device.type, dtype=dtype)


def at_least_fp32(t: torch.Tensor) -> torch.Tensor:
    """``t`` in float32, or float64 if it is (a float64 reference step)."""
    return t.to(torch.promote_types(t.dtype, torch.float32))


def _as_float(outputs):
    """Model outputs cast to fp32 (a tensor, or a dataclass or dict of them)."""
    if isinstance(outputs, torch.Tensor):
        return outputs.float()
    if dataclasses.is_dataclass(outputs):
        return type(outputs)(**{f.name: _as_float(getattr(outputs, f.name))
                                for f in dataclasses.fields(outputs)})
    if isinstance(outputs, dict):
        return {k: _as_float(v) for k, v in outputs.items()}
    return outputs


def _inputs(cfg: StepConfig, batch: Mapping[str, torch.Tensor]):
    images = batch["samples"].to(torch.float32) / cfg.norm_scale
    if cfg.use_qp:
        return images, (batch["qp"].to(torch.float32) / 255.0,)
    return images, ()


def _labels(cfg: StepConfig, batch: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """The step's labels: integer ids as int64; a float array (the unified
    trainer's packed label and teacher columns) as it is."""
    labels = batch[cfg.label_key]
    return labels if labels.is_floating_point() else labels.long()


def make_train_step(model: nn.Module, optimizer: TrainOptimizer, cfg: StepConfig,
                    mesh=None):
    """``step(state, batch, gen) -> {"loss", "confusion"}`` (device tensors):
    one update of ``state`` in place. ``batch`` holds device tensors (uint16
    samples, integer labels); ``gen`` is the epoch's device generator, which
    every augmentation and batch-mix draw comes from.

    With ``mesh`` (``parallel.mesh``) ``batch`` is this rank's rows of the
    global batch. The global batch is gathered over the data group, its
    augmentation and batch-mix draws are made from ``gen`` (seeded alike on
    every rank) and applied to it, and this rank trains on its own rows of
    the result, inside ``data_parallel``: the BatchNorm statistics and the
    loss are the global batch's. The gradients are averaged over the data
    group before the optimizer step, so that every rank takes the step one
    process takes on the global batch. ``confusion`` is this rank's."""
    group = axis_group(mesh, DATA_AXIS)

    def train_step(state: TrainState, batch, gen: torch.Generator):
        batch = {k: gather_group(v, group) for k, v in batch.items()}
        images, extra = _inputs(cfg, batch)
        labels = _labels(cfg, batch)
        if cfg.augment_labeled is not None:
            images, labels = cfg.augment_labeled(gen, images, labels)
        elif cfg.augment is not None:
            images = cfg.augment(gen, images)
        perm = lam = None
        if cfg.batch_mix is not None:
            images, perm, lam = cfg.batch_mix(gen, images)
        images, labels = local_rows(images, group), local_rows(labels, group)
        extra = tuple(local_rows(e, group) for e in extra)
        model.train()
        with data_parallel(mesh):
            with _autocast(images.device, cfg.compute_dtype):
                outputs = model(images, *extra, **cfg.apply_kwargs)
            outputs = _as_float(outputs)
            if perm is not None:
                loss = mixed_loss(cfg.loss_fn, outputs, labels, perm, lam)
            else:
                loss = cfg.loss_fn(outputs, labels)
            optimizer.zero_grad()
            if optimizer.params:
                loss.backward(inputs=optimizer.params)
        sync_gradients(optimizer.params, mesh)
        optimizer.step()
        state.step += 1
        with torch.no_grad():
            conf = confusion_matrix(cfg.metric_labels(labels), cfg.predictions(outputs),
                                    cfg.num_classes)
        return {"loss": loss.detach(), "confusion": conf}

    return train_step


def make_eval_step(model: nn.Module, cfg: StepConfig):
    """``eval_step(state, batch) -> {"loss", "confusion", "logits"}``."""

    @torch.no_grad()
    def eval_step(state: TrainState, batch):
        images, extra = _inputs(cfg, batch)
        labels = _labels(cfg, batch)
        model.eval()
        with _autocast(images.device, cfg.compute_dtype):
            outputs = model(images, *extra, **cfg.apply_kwargs)
        outputs = _as_float(outputs)
        loss = cfg.loss_fn(outputs, labels)
        conf = confusion_matrix(cfg.metric_labels(labels), cfg.predictions(outputs),
                                cfg.num_classes)
        logits = cfg.logits_fn(outputs) if cfg.logits_fn else outputs
        return {"loss": loss, "confusion": conf, "logits": logits}

    return eval_step


def confusion_to_metrics(conf: np.ndarray) -> Dict[str, float]:
    """accuracy / macro-F1 / per-class F1 from a confusion matrix (the
    reference ``_macro_f1``, 013:108-116); the macro average runs over the
    classes observed in targets or predictions (sklearn's label inference)."""
    conf = np.asarray(conf, dtype=np.float64)
    tp = np.diag(conf)
    support = conf.sum(axis=1)
    predicted = conf.sum(axis=0)
    precision = np.divide(tp, predicted, out=np.zeros_like(tp), where=predicted > 0)
    recall = np.divide(tp, support, out=np.zeros_like(tp), where=support > 0)
    denom = precision + recall
    f1 = np.divide(2 * precision * recall, denom, out=np.zeros_like(tp), where=denom > 0)
    total = conf.sum()
    observed = (support > 0) | (predicted > 0)
    if not observed.any():
        observed = np.ones_like(support, dtype=bool)
    return {
        "accuracy": float(tp.sum() / total) if total else 0.0,
        "macro_f1": float(f1[observed].mean()),
        "per_class_f1": f1.tolist(),
        "per_class_precision": precision.tolist(),
        "per_class_recall": recall.tolist(),
        "support": support.tolist(),
    }


def iterate_batches(arrays: Mapping[str, np.ndarray], indices: np.ndarray,
                    batch_size: int, drop_remainder: bool = True) -> Iterator[Dict]:
    """Fixed-shape host batches gathered by ``indices``; training drops the
    final partial batch (sampling is with replacement anyway)."""
    total = len(indices)
    usable = (total // batch_size) * batch_size if drop_remainder else total
    for start in range(0, usable, batch_size):
        idx = indices[start: start + batch_size]
        yield {k: v[idx] for k, v in arrays.items()}


def pad_to_multiple(arrays: Mapping[str, np.ndarray], batch_size: int):
    """Pad a dataset dict to a batch multiple; returns (padded, valid_count).
    Padding rows repeat row 0 with every label array set to -1."""
    n = len(next(iter(arrays.values())))
    padded_n = ((n + batch_size - 1) // batch_size) * batch_size
    if padded_n == n:
        return dict(arrays), n
    out = {}
    for k, v in arrays.items():
        pad = np.repeat(v[:1], padded_n - n, axis=0)
        if k not in ("samples", "qp"):
            pad = np.full_like(pad, -1)
        out[k] = np.concatenate([v, pad], axis=0)
    return out, n


@dataclass
class EpochResult:
    loss: float
    metrics: Dict[str, float]
    seconds: float
    samples: int

    @property
    def throughput(self) -> float:
        return self.samples / self.seconds if self.seconds else 0.0


# The device-resident epoch engages at or below this dataset size (host
# bytes); above it, or with AV1TPU_STREAM_DATA=1, each batch streams from
# the host. The JAX package's policy and variables.
RESIDENT_MAX_BYTES = int(os.environ.get("AV1TPU_RESIDENT_MAX_BYTES", 4 * 1024**3))


def resident_eligible(arrays: Mapping[str, np.ndarray]) -> bool:
    """Whether ``train_stage`` keeps the dataset on the device: never in a
    world of more than one process (each rank streams its shard of every
    global batch, the JAX package's multi-process contract)."""
    if os.environ.get("AV1TPU_STREAM_DATA", "") in ("1", "true") or world_size() > 1:
        return False
    return sum(a.nbytes for a in arrays.values()) <= RESIDENT_MAX_BYTES


def to_device(arrays: Mapping[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """Host arrays as device tensors (uint16 samples stay uint16)."""
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device) for k, v in arrays.items()}


def take_rows(t: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``t[idx]`` along axis 0; uint16 through its int16 view (not every torch
    build indexes uint16)."""
    if t.dtype == torch.uint16:
        return t.view(torch.int16)[idx].view(torch.uint16)
    return t[idx]


def resident_eval_arrays(arrays: Mapping[str, np.ndarray], device):
    """A val set on the device with one poison row (zero sample, labels -1)
    at index n, the pad target of the final partial batch. Returns
    ``(device_arrays, n_valid)``."""
    n = len(next(iter(arrays.values())))
    out = {}
    for k, v in arrays.items():
        row = np.zeros_like(v[:1]) if k in ("samples", "qp") else np.full_like(v[:1], -1)
        out[k] = torch.from_numpy(np.concatenate([v, row], axis=0)).to(device)
    return out, n


def _epoch_indices(n: int, batch_size: int, epoch_seed: int,
                  balance_labels: Optional[np.ndarray], mesh=None) -> Tuple[np.ndarray, int]:
    """The epoch's sample order (balanced or shuffled, from ``epoch_seed``)
    and the local batch. Under a mesh with several data ranks each takes its
    contiguous ``host_shard`` of the global order and ``batch_size / data``
    rows a step (the JAX package's multi-process contract). The order wraps
    around to one local batch when it is shorter."""
    if balance_labels is not None:
        indices = balanced_epoch_indices(balance_labels, epoch_seed)
    else:
        indices = shuffled_epoch_indices(n, epoch_seed)
    local_batch = batch_size
    num_data = axis_size(mesh, DATA_AXIS)
    if num_data > 1:
        local_batch = local_batch_slice(batch_size, mesh)
        indices = host_shard(indices, axis_index(mesh, DATA_AXIS), num_data)
    if len(indices) < local_batch:
        indices = np.resize(indices, local_batch)
    return indices, local_batch


def _global_totals(totals, mesh):
    """The epoch's loss sum (its mean over the data ranks) and confusion
    (their sum): the global metrics, the same on every rank."""
    group = axis_group(mesh, DATA_AXIS)
    loss_sum, conf_sum = totals
    if group is None or loss_sum is None:
        return totals
    loss_sum, conf_sum = loss_sum.clone(), conf_sum.clone()
    dist.all_reduce(loss_sum, group=group)
    dist.all_reduce(conf_sum, group=group)
    return loss_sum / dist.get_world_size(group), conf_sum


def _epoch_result(loss_sum, conf_sum, steps: int, num_classes: int, start: float,
                  samples: int) -> EpochResult:
    conf = (conf_sum.cpu().numpy() if conf_sum is not None
            else np.zeros((num_classes, num_classes)))
    loss = float(loss_sum) if loss_sum is not None else 0.0
    return EpochResult(loss=loss / max(steps, 1), metrics=confusion_to_metrics(conf),
                       seconds=time.perf_counter() - start, samples=samples)


def _accumulate(totals, metrics):
    loss_sum, conf_sum = totals
    if loss_sum is None:
        return metrics["loss"], metrics["confusion"]
    return loss_sum + metrics["loss"], conf_sum + metrics["confusion"]


def run_train_epoch(train_step, state: TrainState, arrays: Mapping[str, np.ndarray],
                    batch_size: int, gen: torch.Generator, epoch_seed: int,
                    num_classes: int, balance_labels: Optional[np.ndarray] = None,
                    device=None, mesh=None) -> Tuple[TrainState, EpochResult]:
    """One streaming epoch: each batch gathered on the host and copied to
    ``device`` (``gen``'s device by default). ``batch_size`` is the global
    batch: with ``mesh`` each data rank feeds its rows of its shard of the
    epoch order to ``train_step`` (made with the same mesh), and the
    metrics come out global on every rank."""
    device = torch.device(device if device is not None else gen.device)
    n = len(next(iter(arrays.values())))
    indices, local_batch = _epoch_indices(n, batch_size, epoch_seed, balance_labels, mesh)
    totals, steps = (None, None), 0
    start = time.perf_counter()
    for batch in iterate_batches(arrays, indices, local_batch):
        metrics = train_step(state, to_device(batch, device), gen)
        totals = _accumulate(totals, metrics)
        steps += 1
    return state, _epoch_result(*_global_totals(totals, mesh), steps, num_classes, start,
                                steps * batch_size)


def run_train_epoch_resident(train_step, state: TrainState,
                             device_arrays: Mapping[str, torch.Tensor], batch_size: int,
                             gen: torch.Generator, epoch_seed: int, num_classes: int,
                             balance_labels: Optional[np.ndarray] = None
                             ) -> Tuple[TrainState, EpochResult]:
    """One epoch over a dataset already on the device: the epoch's index
    matrix goes up once and each step gathers its batch there. Batches,
    draws and results equal :func:`run_train_epoch`'s."""
    n = len(next(iter(device_arrays.values())))
    indices, _ = _epoch_indices(n, batch_size, epoch_seed, balance_labels)
    steps = len(indices) // batch_size
    device = next(iter(device_arrays.values())).device
    idx_mat = torch.from_numpy(np.ascontiguousarray(
        indices[: steps * batch_size].reshape(steps, batch_size), dtype=np.int64)).to(device)
    totals = (None, None)
    start = time.perf_counter()
    for s in range(steps):
        batch = {k: take_rows(v, idx_mat[s]) for k, v in device_arrays.items()}
        totals = _accumulate(totals, train_step(state, batch, gen))
    return state, _epoch_result(*totals, steps, num_classes, start, steps * batch_size)


def run_eval(eval_step, state: TrainState, arrays: Mapping[str, np.ndarray],
             batch_size: int, num_classes: int, device, mesh=None) -> EpochResult:
    """The val pass, streamed; the last batch padded with label -1 rows.
    With ``mesh`` each data rank evaluates its slice of every global batch
    inside ``data_parallel`` and the metrics come out global on every rank."""
    padded, valid = pad_to_multiple(dict(arrays), batch_size)
    n = len(next(iter(padded.values())))
    idx, local_batch = np.arange(n), batch_size
    num_data = axis_size(mesh, DATA_AXIS)
    if num_data > 1:
        local_batch = local_batch_slice(batch_size, mesh)
        idx = idx.reshape(-1, num_data, local_batch)[:, axis_index(mesh, DATA_AXIS)]
        idx = idx.reshape(-1)
    totals, steps = (None, None), 0
    start = time.perf_counter()
    with data_parallel(mesh):
        for batch in iterate_batches(padded, idx, local_batch, drop_remainder=False):
            totals = _accumulate(totals, eval_step(state, to_device(batch, device)))
            steps += 1
    return _epoch_result(*_global_totals(totals, mesh), steps, num_classes, start, valid)


def run_eval_resident(eval_step, state: TrainState, device_arrays: Mapping[str, torch.Tensor],
                      n_valid: int, batch_size: int, num_classes: int) -> EpochResult:
    """The val pass over :func:`resident_eval_arrays`; the final partial
    batch indexes the poison row, so the confusion equals :func:`run_eval`'s."""
    steps = max(1, -(-n_valid // batch_size))
    idx = np.full(steps * batch_size, n_valid, dtype=np.int64)
    idx[:n_valid] = np.arange(n_valid)
    device = next(iter(device_arrays.values())).device
    idx_mat = torch.from_numpy(idx.reshape(steps, batch_size)).to(device)
    totals = (None, None)
    start = time.perf_counter()
    for s in range(steps):
        batch = {k: take_rows(v, idx_mat[s]) for k, v in device_arrays.items()}
        totals = _accumulate(totals, eval_step(state, batch))
    return _epoch_result(*totals, steps, num_classes, start, n_valid)


__all__ = [
    "EpochResult",
    "RESIDENT_MAX_BYTES",
    "StepConfig",
    "TrainState",
    "at_least_fp32",
    "confusion_matrix",
    "confusion_to_metrics",
    "iterate_batches",
    "make_eval_step",
    "make_train_step",
    "pad_to_multiple",
    "resident_eligible",
    "resident_eval_arrays",
    "run_eval",
    "run_eval_resident",
    "run_train_epoch",
    "run_train_epoch_resident",
    "take_rows",
    "to_device",
]
