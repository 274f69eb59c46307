"""Dense hierarchical inference (v6, v5, flatten) and batched streaming on
one device or over a mesh's data axis.

Counterpart of ``av1tpu.eval.hierarchy``: all four stage models run on the
whole batch and ``v6_route`` resolves the hierarchy with masks, so the
output of a sample never depends on the rest of its batch.

    final = where(s1 == 0, NONE, where(s2 == SPLIT, SPLIT,
            where(s2 == RECT, rect + 2, ab + 4)))

``make_v6_pipeline(stacked=True)`` runs the four stage backbones as one
``torch.func.vmap`` forward over their stacked weights (the convolutions
become grouped ones) and each head on its stage's slice of the embeddings.
``make_v5_pipeline`` routes the v5 multi-head model's outputs to raw
partition ids with the same masks; ``make_flatten_pipeline`` gates a 7-way
classifier with stage 1 and maps its classes to raw ids. All are plain
module forwards, as in the JAX package, which calls no Pallas kernel there.

``run_pipeline_batched`` streams a dataset in batches. With ``prefetch``
(default 2) a producer thread slices the host array (reading a memmap's
pages), fills pinned buffers and issues each host-to-device copy on a side
CUDA stream, ``prefetch`` batches ahead of the predictor, so that batch
k + 1's staging and copy overlap batch k's compute.
"""
from __future__ import annotations

import contextlib
import copy
import functools
import queue
import threading
from dataclasses import dataclass
from typing import Callable, Dict, Iterator, List, Mapping, Optional, Sequence

import numpy as np
import torch
from torch import nn

from av1tpu_torch.codec.partitions import flatten_to_raw
from av1tpu_torch.data.records import NORM_10BIT
from av1tpu_torch.models.jax_import import load_jax_variables
from av1tpu_torch.parallel.mesh import (
    DATA_AXIS,
    axis_group,
    axis_size,
    gather_group,
    shard_batch,
)
from av1tpu_torch.quant.ptq import _sigmoid  # XLA's sigmoid, rounded op by op
from av1tpu_torch.train.augment import align_tta_ab_logits, tta_views
from av1tpu_torch.utils import profiling


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
                        norm_scale: float, float_dtype=None,
                        features: Optional[Callable] = None) -> Callable:
    """The v6 predict body from four per-stage logit functions: uint16
    NHWC images in, a dict of per-sample outputs out. ``features`` (the
    stacked backbones) maps the normalized batch to the four stages' inputs,
    ``(4, N, ...)``; without it every function reads the batch itself."""

    @torch.inference_mode()
    def predict(images: torch.Tensor) -> Dict[str, torch.Tensor]:
        # divide, not multiply by 1/1023: the two differ by 1 ulp in fp32
        x = images.to(torch.float32) / norm_scale
        if float_dtype is not None:
            x = x.to(float_dtype)
        inputs = (x,) * 4 if features is None else features(x)
        s1_prob = torch.sigmoid(f1(inputs[0]).squeeze(-1).float())
        s1_pred = (s1_prob >= stage1_threshold).to(torch.int32)
        s2_pred = torch.argmax(f2(inputs[1]), dim=-1).to(torch.int32)
        rect_pred = torch.argmax(f3r(inputs[2]), dim=-1).to(torch.int32)
        ab_pred = torch.argmax(f3a(inputs[3]), dim=-1).to(torch.int32)
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


def _stackable(backbones: Sequence[Optional[nn.Module]]) -> bool:
    """All four backbones present, of one class, with the same parameter and
    buffer names and shapes (the JAX package's ``_stackable`` over the
    ``backbone`` subtrees)."""
    if any(b is None for b in backbones):
        return False

    def layout(b):
        return type(b), [(k, tuple(v.shape)) for k, v in b.state_dict().items()]

    return all(layout(b) == layout(backbones[0]) for b in backbones[1:])


class _VmapBatchNorm2d(nn.BatchNorm2d):
    """Eval-mode BatchNorm through ``torch.native_batch_norm``, which vmap
    batches on every device. ``F.batch_norm`` on the card first asks whether
    cuDNN may take the input, a question about its memory layout that a
    vmapped tensor cannot answer."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.native_batch_norm(x, self.weight, self.bias, self.running_mean,
                                       self.running_var, False, 0.0, self.eps)[0]


def _stacked_features(backbones: Sequence[nn.Module]) -> Callable:
    """``x -> (4, N, 512)``: one ``torch.func.vmap`` forward of the four
    backbones over their weights stacked on a leading axis (the convolutions
    run as grouped ones), ``x`` shared."""
    params, buffers = torch.func.stack_module_state(list(backbones))
    params = {k: v.detach() for k, v in params.items()}
    base = copy.deepcopy(backbones[0]).to("meta")
    for module in list(base.modules()):
        for name, child in module.named_children():
            if isinstance(child, nn.BatchNorm2d):
                setattr(module, name, _VmapBatchNorm2d(child.num_features, eps=child.eps,
                                                       device="meta"))

    def forward(p, b, x):
        return torch.func.functional_call(base, (p, b), (x,))

    batched = torch.func.vmap(forward, in_dims=(0, 0, None))
    return lambda x: batched(params, buffers, x)


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
    in the layout ``cli.common.load_model_variables`` returns. With
    ``mesh`` (``parallel.mesh``) the models stay replicated on this rank's
    ``device``; ``run_pipeline_batched(mesh=...)`` gives each rank its rows.

    ``stacked`` runs the four backbones as one vmapped forward over their
    stacked weights and each stage's head on its slice of the embeddings
    (``from_features``): the same function, in other kernels. As in the JAX
    package it applies only without ``tta`` and ensemble, and when the four
    ``backbone`` submodules match in class, names and shapes; otherwise the
    pipeline is the unstacked one."""
    s1, s2, s3r, s3a = (on_device(m, device, input_dtype) for m in (
        models.stage1, models.stage2, models.stage3_rect, models.stage3_ab
    ))
    backbones = [getattr(m, "backbone", None) for m in (s1, s2, s3r, s3a)]
    if stacked and not tta and not ab_ensemble_vars and _stackable(backbones):
        return assemble_v6_predict(
            lambda f: s1(f, from_features=True)[:, None],
            *(functools.partial(m, from_features=True) for m in (s2, s3r, s3a)),
            stage1_threshold, norm_scale, float_dtype=input_dtype,
            features=_stacked_features(backbones))

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


def make_v5_pipeline(
    model: nn.Module,
    stage1_threshold: float = 0.5,
    available_specialists: Sequence[str] = ("RECT", "AB", "1TO4"),
    norm_scale: float = NORM_10BIT,
    device="cuda",
    mesh=None,
) -> Callable:
    """The v5 pipeline over one ``HierarchicalModel`` (fp32):
    ``predict(images_u16, qp=None) -> dict`` on ``device``.

    Raw partition ids: stage 2 says NONE (0), SPLIT (3), RECT, AB or 1TO4;
    the RECT head gives 1 + its argmax, AB 4 + its argmax, 1TO4 8 + its
    argmax. A specialist missing from ``available_specialists`` falls back to
    its group's first member (1, 4, 8). ``qp`` (per sample, normalized as in
    training) reaches a QP-conditioned model and is ignored by any other.
    ``mesh``: the model stays replicated on this rank's ``device``."""
    model = on_device(model, device, torch.float32)
    has = {head: head in available_specialists for head in ("RECT", "AB", "1TO4")}

    @torch.inference_mode()
    def predict(images: torch.Tensor, qp=None) -> Dict[str, torch.Tensor]:
        out = model(images.to(torch.float32) / norm_scale, qp)
        s1_prob = _sigmoid(out.stage1)
        s1_pred = (s1_prob >= stage1_threshold).to(torch.int32)
        s2_pred = torch.argmax(out.stage2, dim=-1).to(torch.int32)
        args = {head: torch.argmax(out.specialists[head], dim=-1).to(torch.int32)
                for head in ("RECT", "AB", "1TO4")}

        def routed(head, first):
            return args[head] + first if has[head] else torch.full_like(args[head], first)

        final = torch.where(
            (s1_pred == 0) | (s2_pred == 0), 0,
            torch.where(s2_pred == 1, 3,
                        torch.where(s2_pred == 2, routed("RECT", 1),
                                    torch.where(s2_pred == 3, routed("AB", 4),
                                                routed("1TO4", 8)))))
        return {
            "final": final.to(torch.int32),
            "stage1_prob": s1_prob,
            "stage1_pred": s1_pred,
            "stage2_pred": s2_pred,
            **{f"stage3_{head}_pred": arg for head, arg in args.items()},
        }

    return predict


def make_flatten_pipeline(
    stage1_model: nn.Module,
    flat_model: nn.Module,
    stage1_threshold: float = 0.45,
    norm_scale: float = NORM_10BIT,
    input_dtype=torch.float32,
    device="cuda",
    mesh=None,
) -> Callable:
    """Stage-1 gate + the 7-way ``Stage2FlatModel``, its classes mapped to
    raw partition ids (``codec.partitions.flatten_to_raw``, a table on the
    device): ``predict(images_u16) -> dict`` on ``device``. Stage 1 runs
    without its temperature. In ``input_dtype`` (the models cast to it, as
    ``make_v6_pipeline`` does) the gate's sigmoid and threshold work in that
    dtype, as the JAX graph's do; ``stage1_prob`` comes back as fp32.
    ``mesh``: the models stay replicated on this rank's ``device``."""
    s1 = on_device(stage1_model, device, input_dtype)
    flat = on_device(flat_model, device, input_dtype)
    remap = torch.as_tensor(flatten_to_raw(np.arange(7)), dtype=torch.int32,
                            device=device)

    @torch.inference_mode()
    def predict(images: torch.Tensor) -> Dict[str, torch.Tensor]:
        x = (images.to(torch.float32) / norm_scale).to(input_dtype)
        s1_prob = _sigmoid(s1(x))
        s1_pred = (s1_prob >= stage1_threshold).to(torch.int32)
        flat_pred = torch.argmax(flat(x), dim=-1).to(torch.int32)
        return {
            "final": torch.where(s1_pred == 0, 0, remap[flat_pred]).to(torch.int32),
            "stage1_prob": s1_prob.float(),
            "stage1_pred": s1_pred,
            "flatten_pred": flat_pred,
        }

    return predict


class _Staging:
    """A ring of ``count`` pinned host buffers for non-blocking uploads, each
    copy issued on ``stream`` (the current stream when None): a buffer is
    refilled only after the copy that last read it has finished."""

    def __init__(self, shape, dtype, count: int, stream=None):
        self.bufs = [torch.empty(shape, dtype=dtype, pin_memory=True) for _ in range(count)]
        self.views = [buf.numpy() for buf in self.bufs]
        self.done = [None] * count
        self.turn = 0
        self.stream = stream

    def upload(self, chunk: np.ndarray, qchunk, device) -> tuple:
        """``chunk`` (host rows; a memmap's pages are read here) through the
        next buffer to ``device``, and ``qchunk`` (or None) beside it:
        ``(rows, qps, event)``, the event recorded after both copies on the
        staging stream."""
        i, self.turn = self.turn, (self.turn + 1) % len(self.bufs)
        if self.done[i] is not None:
            with profiling.span("batching.ring_wait"):
                self.done[i].synchronize()
        rows = len(chunk)
        np.copyto(self.views[i][:rows], chunk)
        with torch.cuda.stream(self.stream):
            out = self.bufs[i][:rows].to(device, non_blocking=True)
            if qchunk is not None:
                qchunk = torch.as_tensor(qchunk).to(device)
            self.done[i] = torch.cuda.Event()
            self.done[i].record()
        return out, qchunk, self.done[i]


def _chunks(samples, qps, batch_size: int, device: torch.device,
            prefetch: int) -> Iterator[tuple]:
    """``(rows, qps rows or None, count of rows)`` of each batch of
    ``samples``, on ``device``. A tensor is sliced on the caller's thread (one
    on ``device`` never visits the host). Host numpy is staged on the caller's
    thread with ``prefetch=0`` or a single batch; otherwise a producer thread
    stages it ``prefetch`` batches ahead, through ``prefetch + 1`` pinned
    buffers with each copy on a side stream that the caller's stream waits on
    before it reads the rows. An exception in the producer is raised here;
    closing the generator stops the producer."""
    starts = range(0, int(samples.shape[0]), batch_size)

    def qps_at(start):
        return None if qps is None else qps[start:start + batch_size]

    if not isinstance(samples, np.ndarray):
        for start in starts:
            chunk = samples[start:start + batch_size].to(device)
            q = qps_at(start)
            yield chunk, None if q is None else torch.as_tensor(q).to(device), len(chunk)
        return
    threaded = prefetch > 0 and len(starts) > 1
    staging = None
    if device.type == "cuda":
        staging = _Staging((min(batch_size, len(samples)),) + samples.shape[1:],
                           torch.from_numpy(np.empty(0, samples.dtype)).dtype,
                           prefetch + 1 if threaded else 2,
                           torch.cuda.Stream(device) if threaded else None)

    def stage(start):
        chunk = samples[start:start + batch_size]
        with profiling.span("batching.stage", rows=len(chunk), bytes=chunk.nbytes):
            if staging is not None:
                return staging.upload(chunk, qps_at(start), device)
            q = qps_at(start)
            return (torch.from_numpy(np.array(chunk)),
                    None if q is None else torch.as_tensor(np.array(q)), None)

    if not threaded:
        for start in starts:
            chunk, q, _ = stage(start)
            yield chunk, q, len(chunk)
        return

    staged: queue.Queue = queue.Queue(maxsize=prefetch)
    stop = threading.Event()

    def put(item) -> bool:
        # a timed put, so that the producer ends once the caller has gone
        while not stop.is_set():
            try:
                staged.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    caller = profiling.current()  # the producer's spans are children of the caller's

    def produce():
        try:
            with profiling.within(caller):
                for start in starts:
                    if not put(stage(start)):
                        return
        except BaseException as exc:  # raised again in the caller
            put(exc)

    threading.Thread(target=produce, name="run_pipeline_batched-producer",
                     daemon=True).start()
    try:
        for _ in starts:
            with profiling.span("batching.wait"):
                item = staged.get()
            if isinstance(item, BaseException):
                raise item
            chunk, q, copied = item
            if copied is not None:
                current = torch.cuda.current_stream(device)
                current.wait_event(copied)
                for t in (chunk, q):
                    if t is not None:  # allocated on the side stream, read on this one
                        t.record_stream(current)
            yield chunk, q, len(chunk)
    finally:
        stop.set()


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


def _gathered(outputs: Dict[str, List[torch.Tensor]], n: int, as_numpy: bool):
    gathered = {k: torch.cat([torch.atleast_1d(t) for t in v])[:n]
                for k, v in outputs.items()}
    if not as_numpy:
        return gathered
    return {k: v.cpu().numpy() for k, v in gathered.items()}


def run_pipeline_batched(
    predict_fn: Callable,
    samples,
    batch_size: int = 4096,
    device="cuda",
    as_numpy: bool = True,
    qps=None,
    mesh=None,
    prefetch: int = 2,
) -> Dict[str, np.ndarray]:
    """Stream a dataset through ``predict_fn`` in batches of ``batch_size``
    on one device (the card unless the caller passes ``"cpu"``; ``"cuda"``
    without a card raises). ``samples`` is host numpy (a ``np.memmap`` too)
    or a tensor; a tensor already on ``device`` is sliced there and never
    visits the host.

    ``prefetch`` (host numpy only) stages the next ``prefetch`` batches on a
    producer thread while the device computes: the thread slices the array
    (reading a memmap's pages), fills pinned buffers and issues each
    host-to-device copy on a side stream, which the compute stream waits on
    by event; on the CPU it slices and copies alone. An exception in the
    producer is raised here, and the producer stops when the caller does.
    ``prefetch=0`` stages each batch on the caller's thread (its copy
    non-blocking on the compute stream). Outputs are the same, bit for bit,
    for every ``prefetch``.

    A per-sample predictor runs the last batch at its own size. A predictor
    that declares ``accepts_valid`` (the capacity-gated pipeline, whose K
    depends on the batch) gets every batch at ``batch_size`` rows, the tail
    padded on the device with copies of its first row, and the count of real
    rows as its second argument; as in the JAX package. Per-sample outputs
    are trimmed to the dataset; a 0-d output (``overflow``) comes back as one
    entry per batch. Outputs stay on the device until the end and come back
    to the host once, as numpy; ``as_numpy=False`` returns the device
    tensors instead and does not synchronise, so that a caller can overlap
    host work with the device's.

    ``qps`` (per sample, for a QP-conditioned v5 predictor, normalized as in
    training: qp / 255) is sliced and uploaded beside ``samples`` and passed
    as the predictor's second argument; ``accepts_valid`` takes precedence.

    With ``mesh`` (``parallel.mesh``; every rank calls with the same
    ``samples``) ``batch_size`` rounds up to a multiple of the data axis,
    every batch is padded on the device to ``batch_size`` rows (copies of its
    first row), each rank runs its contiguous slice of every batch, and the
    outputs are all-gathered over the data group, so that every rank returns
    the whole result, as the JAX package replicates it. ``valid`` is then
    the batch's count of real rows; a 0-d output is the same on every rank.
    A mesh with one data rank streams as no mesh does.

    The call is the span ``batching``; inside it ``batching.predict`` around
    each predictor call, ``batching.stage`` around each batch's staging (on
    the producer thread, parented to ``batching``), ``batching.wait`` where
    the caller waits for the producer (``utils.profiling``)."""
    device = torch.device(device)
    n = int(samples.shape[0])
    accepts_valid = getattr(predict_fn, "accepts_valid", False)
    with profiling.span("batching", rows=n):
        if axis_size(mesh, DATA_AXIS) > 1:
            return _run_sharded(predict_fn, samples, batch_size, device, as_numpy, qps, mesh,
                                accepts_valid, prefetch)
        outputs: Dict[str, List[torch.Tensor]] = {}
        with contextlib.closing(_chunks(samples, qps, batch_size, device, prefetch)) as chunks:
            for chunk, qchunk, valid in chunks:
                with profiling.span("batching.predict", rows=valid):
                    if accepts_valid:
                        result = predict_fn(_pad_rows(chunk, batch_size), valid)
                    elif qchunk is not None:
                        result = predict_fn(chunk, qchunk)
                    else:
                        result = predict_fn(chunk)
                for key, value in result.items():
                    outputs.setdefault(key, []).append(value)
        return _gathered(outputs, n, as_numpy)


def _run_sharded(predict_fn, samples, batch_size, device, as_numpy, qps, mesh,
                 accepts_valid, prefetch) -> Dict[str, np.ndarray]:
    """``run_pipeline_batched`` over the data axis of ``mesh``."""
    n = int(samples.shape[0])
    num_data = axis_size(mesh, DATA_AXIS)
    batch_size = -(-batch_size // num_data) * num_data
    group = axis_group(mesh, DATA_AXIS)
    outputs: Dict[str, List[torch.Tensor]] = {}
    with contextlib.closing(_chunks(samples, qps, batch_size, device, prefetch)) as chunks:
        for chunk, qchunk, valid in chunks:
            chunk = shard_batch(_pad_rows(chunk, batch_size), mesh)
            with profiling.span("batching.predict", rows=valid):
                if accepts_valid:
                    result = predict_fn(chunk, valid)
                elif qchunk is not None:
                    result = predict_fn(chunk, shard_batch(_pad_rows(qchunk, batch_size), mesh))
                else:
                    result = predict_fn(chunk)
            for key, value in result.items():
                if value.dim() > 0:
                    value = gather_group(value, group)
                outputs.setdefault(key, []).append(value)
    return _gathered(outputs, n, as_numpy)


__all__ = [
    "PipelineModels",
    "assemble_v6_predict",
    "make_flatten_pipeline",
    "make_v5_pipeline",
    "make_v6_pipeline",
    "on_device",
    "run_pipeline_batched",
    "tta_mean_logits",
    "v6_route",
]
