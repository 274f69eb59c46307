"""Dense hierarchical v6 inference and batched streaming on one device.

Counterpart of ``av1tpu.eval.hierarchy``: all four stage models run on the
whole batch and ``v6_route`` resolves the hierarchy with masks, so the
output of a sample never depends on the rest of its batch.

    final = where(s1 == 0, NONE, where(s2 == SPLIT, SPLIT,
            where(s2 == RECT, rect + 2, ab + 4)))
"""
from __future__ import annotations

import copy
from dataclasses import dataclass
from typing import Callable, Dict, List, Mapping, Optional, Sequence

import numpy as np
import torch
from torch import nn

from av1tpu_torch.data.records import NORM_10BIT
from av1tpu_torch.models.jax_import import load_jax_variables
from av1tpu_torch.train.augment import align_tta_ab_logits, tta_views


@dataclass
class PipelineModels:
    """The four v6 stage models (``nn.Module``s holding their weights)."""

    stage1: nn.Module
    stage2: nn.Module
    stage3_rect: nn.Module
    stage3_ab: nn.Module


def v6_route(s1_pred, s2_pred, rect_pred, ab_pred):
    """Masked v6 hierarchy resolution -> final 8-class ids (NONE=0,
    SPLIT=1, RECT+2, AB+4)."""
    return torch.where(
        s1_pred == 0,
        0,
        torch.where(
            s2_pred == 0, 1, torch.where(s2_pred == 1, rect_pred + 2, ab_pred + 4)
        ),
    ).to(torch.int32)


def assemble_v6_predict(f1, f2, f3r, f3a, stage1_threshold: float,
                        norm_scale: float, float_dtype=None) -> Callable:
    """The v6 predict body from four per-stage logit functions: uint16
    NHWC images in, a dict of per-sample outputs out."""

    @torch.inference_mode()
    def predict(images: torch.Tensor) -> Dict[str, torch.Tensor]:
        # divide, not multiply by 1/1023: the two differ by 1 ulp in fp32
        x = images.to(torch.float32) / norm_scale
        if float_dtype is not None:
            x = x.to(float_dtype)
        s1_prob = torch.sigmoid(f1(x).squeeze(-1).float())
        s1_pred = (s1_prob >= stage1_threshold).to(torch.int32)
        s2_pred = torch.argmax(f2(x), dim=-1).to(torch.int32)
        rect_pred = torch.argmax(f3r(x), dim=-1).to(torch.int32)
        ab_pred = torch.argmax(f3a(x), dim=-1).to(torch.int32)
        return {
            "final": v6_route(s1_pred, s2_pred, rect_pred, ab_pred),
            "stage1_prob": s1_prob,
            "stage1_pred": s1_pred,
            "stage2_pred": s2_pred,
            "stage3_rect_pred": rect_pred,
            "stage3_ab_pred": ab_pred,
        }

    return predict


def on_device(model: nn.Module, device, dtype) -> nn.Module:
    """An eval-mode copy of ``model`` on ``device`` in ``dtype`` (the
    caller's module is left where it is)."""
    return copy.deepcopy(model).to(device=device, dtype=dtype).eval()


def _mean_over_axis0(t: torch.Tensor) -> torch.Tensor:
    """Mean over axis 0, summed in fp32 and rounded once to ``t``'s dtype (what
    ``jnp.mean`` does for bf16)."""
    return t.float().mean(dim=0).to(t.dtype)


def tta_mean_logits(forward: Callable, x: torch.Tensor, align_ab: bool = False):
    """Mean of ``forward``'s logits over the four TTA views of ``x`` (NHWC),
    computed as one forward of the views stacked on the batch axis: in eval
    mode every layer works per sample. ``align_ab`` first re-expresses each
    view's AB logits (the last four columns) in the original frame's class
    order."""
    views = tta_views(x)
    logits = forward(views.flatten(0, 1)).unflatten(0, views.shape[:2])
    if align_ab:
        ab = align_tta_ab_logits(logits[..., -4:])
        logits = torch.cat([logits[..., :-4], ab], dim=-1)
    return _mean_over_axis0(logits)


def make_v6_pipeline(
    models: PipelineModels,
    stage1_threshold: float = 0.45,
    norm_scale: float = NORM_10BIT,
    input_dtype=torch.float32,
    device="cuda",
    tta: bool = False,
    tta_align_ab: bool = False,
    ab_ensemble_vars: Optional[Sequence[Mapping]] = None,
    stacked: bool = False,
    mesh=None,
) -> Callable:
    """The plain v6 pipeline over the stage models' own forwards:
    ``predict(images_u16) -> dict`` on ``device``: the card unless the
    caller passes ``"cpu"``; ``"cuda"`` without a card raises.

    ``tta`` averages each stage's logits over the four test-time-augmentation
    views (original/hflip/vflip/rot180). ``tta_align_ab`` (read only with
    ``tta``) gathers each flipped view's AB logits through its training
    swap-table permutation before the mean, so that HORZ_A/HORZ_B and
    VERT_A/VERT_B evidence pools instead of cancelling. ``ab_ensemble_vars``
    replaces the single AB model with soft voting (the mean of the members'
    softmax) over checkpoint variable trees of ``models.stage3_ab``'s class,
    in the layout ``cli.common.load_model_variables`` returns."""
    if stacked:
        raise NotImplementedError(
            "stacked backbones are not ported (ROADMAP Queue 1, 'Drop, don't port')"
        )
    if mesh is not None:
        raise NotImplementedError("multi-device inference waits for ROADMAP M11")
    s1, s2, s3r, s3a = (on_device(m, device, input_dtype) for m in (
        models.stage1, models.stage2, models.stage3_rect, models.stage3_ab
    ))

    def stage_fn(model, align_ab=False):
        if not tta:
            return model
        return lambda x: tta_mean_logits(model, x, align_ab)

    if ab_ensemble_vars:
        members = [
            stage_fn(on_device(load_jax_variables(copy.deepcopy(models.stage3_ab), v),
                               device, input_dtype), tta_align_ab)
            for v in ab_ensemble_vars
        ]

        def ab_fn(x):  # mean member probabilities; the caller takes their argmax
            return _mean_over_axis0(
                torch.stack([torch.softmax(m(x), dim=-1) for m in members]))
    else:
        ab_fn = stage_fn(s3a, tta_align_ab)
    s1_fn = stage_fn(s1)
    return assemble_v6_predict(
        lambda x: s1_fn(x)[:, None], stage_fn(s2), stage_fn(s3r), ab_fn,
        stage1_threshold, norm_scale, float_dtype=input_dtype,
    )


class _Staging:
    """A ring of two pinned host buffers for non-blocking uploads: a buffer
    is refilled only after the copy that last read it has finished."""

    def __init__(self, shape, dtype):
        self.bufs = [torch.empty(shape, dtype=dtype, pin_memory=True) for _ in range(2)]
        self.done = [None, None]
        self.turn = 0

    def upload(self, chunk: np.ndarray, device) -> torch.Tensor:
        i, self.turn = self.turn, 1 - self.turn
        if self.done[i] is not None:
            self.done[i].synchronize()
        host = self.bufs[i][: len(chunk)]
        host.copy_(torch.from_numpy(chunk))
        out = host.to(device, non_blocking=True)
        self.done[i] = torch.cuda.Event()
        self.done[i].record()
        return out


def _pad_rows(chunk: torch.Tensor, rows: int) -> torch.Tensor:
    """``chunk`` padded to ``rows`` rows with copies of its first row, on its
    device (through the int16 view of uint16 codes: not every torch build
    concatenates uint16)."""
    pad = rows - chunk.shape[0]
    if pad <= 0:
        return chunk
    view = chunk.view(torch.int16) if chunk.dtype == torch.uint16 else chunk
    padded = torch.cat([view, view[:1].expand(pad, *view.shape[1:])])
    return padded.view(chunk.dtype)


def run_pipeline_batched(
    predict_fn: Callable,
    samples,
    batch_size: int = 4096,
    device="cuda",
    as_numpy: bool = True,
) -> Dict[str, np.ndarray]:
    """Stream a dataset through ``predict_fn`` in batches of ``batch_size``
    on one device (the card unless the caller passes ``"cpu"``; ``"cuda"``
    without a card raises). ``samples`` is host numpy or a tensor; a tensor
    already on ``device`` is sliced there and never visits the host.

    A per-sample predictor runs the last batch at its own size. A predictor
    that declares ``accepts_valid`` (the capacity-gated pipeline, whose K
    depends on the batch) gets every batch at ``batch_size`` rows, the tail
    padded on the device with copies of its first row, and the count of real
    rows as its second argument; as in the JAX package. Per-sample outputs
    are trimmed to the dataset; a 0-d output (``overflow``) comes back as one
    entry per batch. Outputs stay on the device until the end and come back
    to the host once, as numpy; ``as_numpy=False`` returns the device
    tensors instead and does not synchronise, so that a caller can overlap
    host work with the device's."""
    device = torch.device(device)
    n = int(samples.shape[0])
    accepts_valid = getattr(predict_fn, "accepts_valid", False)
    staging = None
    if isinstance(samples, np.ndarray) and device.type == "cuda":
        staging = _Staging((min(batch_size, n),) + samples.shape[1:],
                           torch.from_numpy(samples[:0]).dtype)
    outputs: Dict[str, List[torch.Tensor]] = {}
    for start in range(0, n, batch_size):
        chunk = samples[start:start + batch_size]
        if staging is not None:
            chunk = staging.upload(np.ascontiguousarray(chunk), device)
        elif isinstance(chunk, np.ndarray):
            chunk = torch.from_numpy(np.ascontiguousarray(chunk)).to(device)
        else:
            chunk = chunk.to(device)
        if accepts_valid:
            valid = int(chunk.shape[0])
            result = predict_fn(_pad_rows(chunk, batch_size), valid)
        else:
            result = predict_fn(chunk)
        for key, value in result.items():
            outputs.setdefault(key, []).append(value)
    gathered = {k: torch.cat([torch.atleast_1d(t) for t in v])[:n]
                for k, v in outputs.items()}
    if not as_numpy:
        return gathered
    return {k: v.cpu().numpy() for k, v in gathered.items()}


__all__ = [
    "PipelineModels",
    "assemble_v6_predict",
    "make_v6_pipeline",
    "on_device",
    "run_pipeline_batched",
    "tta_mean_logits",
    "v6_route",
]
