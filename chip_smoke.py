#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``av1tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout. Phases, one JSON line each:
  1. device: ``nvidia-smi`` name and power limit, the torch device name;
  2. build: nvcc builds the kernels from ``av1tpu_torch/csrc``, one process
     per source, all started together; the registers and spill bytes ptxas
     reports for each fused kernel;
  3. kernel checks, each kernel against its plain PyTorch version on the
     card, fp32 (TF32 off) and bf16, with the share of output elements that
     differ at all: K1 and K2 at 8 and 16 px on batches of 1, 255 and 4099
     and on a 4099-block view that starts one value into its buffer (off the
     16-byte grid of the bf16 kernels' loads); K5 at extents 2-16 (8-64 px
     blocks), batch 4099; K3a on three padded 1080p frames at bs 16
     and 64 and K3b on 4099 blocks (bit-exact); K4 forward for each
     activation at (4099, 512) x (512, 256), at a head's second layer
     (256, 8), at an unaligned (500, 250) that takes the general kernel and
     at K = 4096, with the fp32 error against a float64 product beside the
     library's (cuBLAS fp32), and K4 backward against float64 autograd;
  4. reference: the folded fp32 pipeline on the card (fronts off/on/g1, and
     K5 with fronts off/on) against the plain nn.Module pipeline on the CPU;
  5. three main paths, each driven with the launch counts set to 0 just
     before it and read just after, on a synthetic 65,536-block 16 px
     dataset and four seeded stage models (plus an FGVC AB model) at the
     published v6 widths:
       a. the port's ``run_pipeline_eval --variant v6 --folded --bf16
          --batch-size 4096`` with ``--fused-front off``, ``on``, ``g1`` and
          ``on --ab-fgvc`` (K1, K2);
       b. ``make_v6_pipeline_folded(..., use_pallas_groups=True)`` with
          fronts off and on, through ``run_pipeline_batched`` at batch 4096,
          bf16 (K5, K1);
       c. the ``av1tpu_torch.kernels`` API: K3a and K3b ingest of eight
          1080p frames, then three training steps of a two-layer head built
          from K4 on the stage-1 embeddings of 4096 blocks;
     each run prints blocks/s (or its own rate), its launches, and its
     agreement with path a's ``off`` run;
  6. predict: the CUDA-event time of one 4,096-block bf16 predict on a
     batch already on the card, for fronts off / on / g1 and K5 with fronts
     off / on, in ABCDE EDCBA turns, and from a ``torch.profiler`` trace the
     kernels launched per predict, the device's busy time and idle share;
  7. timing: each kernel, its plain version and, for K4, one library call
     (``torch.addmm`` + ``relu_``) in turns at the main paths' shapes, K1 and
     K2 also at 8 px, K4 in fp32 and bf16, K5 at all four extents. ``ms`` is
     device time: the calls are captured in a CUDA graph and the graph is
     replayed, so Python's
     per-call overhead (larger than K4's run time) stays out; ``eager_ms``
     is the same call launched from Python. ``bound_ms`` is the least time
     the card could take: the larger of the bytes (each input read once,
     each output written once) over 3.35 TB/s and the operations over the
     peak for the input type (989 TFLOP/s bf16 on the tensor cores,
     67 TFLOP/s fp32).
Then the card's ``nvidia-smi`` line, a ``{"kernels": [...]}`` line, and as the
last line ``{"ok": true, "device": {...}}``. Any failed phase raises and the
script exits non-zero; without a CUDA device it fails before printing.
"""
from __future__ import annotations

import copy
import itertools
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

from av1tpu_torch.cli import run_pipeline_eval  # noqa: E402
from av1tpu_torch.data.bundles import Bundle, save_split  # noqa: E402
from av1tpu_torch.eval import (  # noqa: E402
    PipelineModels,
    make_v6_pipeline,
    make_v6_pipeline_folded,
    run_pipeline_batched,
)
from av1tpu_torch.kernels import _build  # noqa: E402
from av1tpu_torch.kernels import fused_front as ff  # noqa: E402
from av1tpu_torch.kernels import preprocess as pp  # noqa: E402
from av1tpu_torch.kernels import resnet_group as rg  # noqa: E402
from av1tpu_torch.kernels.fused_dense import (  # noqa: E402
    ACTS,
    fused_dense,
    fused_dense_reference,
    takes_fast_path,
)
from av1tpu_torch.models import (  # noqa: E402
    FGVCModel,
    Stage1Model,
    Stage2Model,
    Stage3ABModel,
    Stage3RectModel,
    to_jax_variables,
)
from av1tpu_torch.quant.ptq import fold_backbone  # noqa: E402
from av1tpu_torch.train.checkpoint import save_variables_npz  # noqa: E402

SEED = 0
N_VAL = 65536
HW = 16
BATCH = 4096
RAGGED = 4099
THRESHOLD = 0.45
FRAMES = (8, 1080, 1920)  # eight 1080p luma frames
HEAD = (512, 256, 8)      # a v6 head's widths: embedding, hidden, classes
FP32_TOL = {"fused_front": 1e-5, "fused_front_g1": 5e-5}  # absolute
FP32_REL_TOL = {"fused_group12": 2e-5, "fused_dense": 1e-5}  # of max(1, max|plain|)
BF16_REL_TOL = 1e-2  # of max(1, max|plain|): ~1 bf16 ulp of the largest output
GRAD_RTOL = 1e-3  # K4 backward against float64 autograd (tests/test_kernels.py)
# dW is a torch fp32 product over 4099 rows in either path: at entries near 0
# that sum alone is up to 2.4e-4 from float64 (`atol_needed` below prints it)
GRAD_ATOL = {"x": 1e-4, "w": 5e-4, "b": 1e-4}
# Published peaks of an H100 SXM (NVIDIA's data sheet, dense rates)
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
FORBIDDEN_MODULES = ("jax", "flax", "av1tpu")  # the port imports none of them
WORK = ROOT / "build" / "chip_smoke"
KERNELS = {  # name: (source, the TPU kernel it replaces)
    "fused_front": ("av1tpu_torch/csrc/fused_front.cu",
                    "av1tpu/kernels/fused_front.py:105"),
    "fused_front_g1": ("av1tpu_torch/csrc/fused_front.cu",
                       "av1tpu/kernels/fused_front.py:212"),
    "tile_normalize_frames": ("av1tpu_torch/csrc/preprocess.cu",
                              "av1tpu/kernels/preprocess.py:53"),
    "normalize_blocks": ("av1tpu_torch/csrc/preprocess.cu",
                         "av1tpu/kernels/preprocess.py:102"),
    "fused_dense": ("av1tpu_torch/csrc/fused_dense.cu",
                    "av1tpu/kernels/fused_dense.py:59"),
    "fused_group12": ("av1tpu_torch/csrc/resnet_group.cu",
                      "av1tpu/kernels/resnet_group.py:162"),
}


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def seeded_model(cls, gen: torch.Generator, calib: torch.Tensor) -> nn.Module:
    """A model drawn from ``gen``: lecun-normal weights, BN running stats
    set to a calibration batch's statistics and then perturbed, so that
    the logits depend on the input."""
    model = cls()
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, (nn.Conv2d, nn.Linear)):
                fan_in = mod.weight[0].numel()
                mod.weight.copy_(torch.randn(mod.weight.shape, generator=gen)
                                 / math.sqrt(fan_in))
                if mod.bias is not None:
                    mod.bias.zero_()
            elif isinstance(mod, nn.modules.batchnorm._BatchNorm):
                mod.weight.fill_(1.0)
                mod.bias.zero_()
                mod.reset_running_stats()
                mod.momentum = None  # running stats = the batch's own
        if hasattr(model, "classifier"):
            model.classifier.weight.copy_(
                torch.randn(model.classifier.weight.shape, generator=gen))
        model.train()
        model(calib)
        model.eval()
        for mod in model.modules():
            if isinstance(mod, nn.modules.batchnorm._BatchNorm):
                std = mod.running_var.sqrt()
                mod.running_mean += 0.2 * std * torch.randn(std.shape, generator=gen)
                mod.running_var *= 0.5 + torch.rand(std.shape, generator=gen)
    return model


def codes(rng: np.random.Generator, shape) -> np.ndarray:
    """Uniform 10-bit codes as uint16."""
    return rng.integers(0, 1024, size=shape, dtype=np.uint16)


def host_tile(frames: np.ndarray, bs: int) -> np.ndarray:
    """(F, H, W) -> (F*R*C, bs, bs, 1), frame-major then row-major."""
    f, h, w = frames.shape
    x = frames.reshape(f, h // bs, bs, w // bs, bs).transpose(0, 1, 3, 2, 4)
    return np.ascontiguousarray(x.reshape(-1, bs, bs, 1))


def time_ms(fn, iters: int = 50) -> float:
    """Per-call time of ``fn`` launched from Python (CUDA events)."""
    for _ in range(5):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters: int = 20, replays: int = 5) -> float:
    """Per-call device time of ``fn``: ``iters`` calls captured in a CUDA
    graph, the graph replayed ``replays`` times between two events."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm up off the default stream
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (iters * replays)


def tensor_bytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(n_bytes: int, flops: float, dtype) -> tuple:
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    operations over the peak rate for ``dtype``."""
    by_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    by_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def front_flops(hw: int, with_g1: bool) -> float:
    """Per sample: the 7x7/2 stem conv, and layer group 1 at extent hw/4."""
    stem = 2.0 * (hw // 2) ** 2 * 49 * 64
    return stem + (group12_flops(hw // 4, groups=(1,)) if with_g1 else 0.0)


def group12_flops(e: int, groups=(1, 2)) -> float:
    """Per sample: the convs of layer groups 1 and 2 at input extent ``e``
    (each product once; SE, biases and pooling are not counted)."""
    g1 = 2.0 * 4 * e * e * 576 * 64
    g2 = 2.0 * (e // 2) ** 2 * (576 * 128 + 3 * 1152 * 128 + 64 * 128)
    return (g1 if 1 in groups else 0.0) + (g2 if 2 in groups else 0.0)


# ---------------------------------------------------------------------------
# Phase 3: every kernel against its plain version
# ---------------------------------------------------------------------------


def compare(name, got, want, tol, **fields) -> float:
    """Max |got - want|, emitted; raises above ``tol``."""
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"{name}: {got.shape}/{got.dtype} "
                             f"vs {want.shape}/{want.dtype}")
    diff = (got.float() - want.float()).abs()
    err = diff.max().item()
    scale = want.float().abs().max().item()
    emit("kernel_check", kernel=name, max_abs_err=err, tol=tol,
         max_abs_out=scale, share_differing=(diff > 0).float().mean().item(), **fields)
    if not (err <= tol and math.isfinite(scale)):
        raise AssertionError(f"{name} {fields}: err {err} > {tol}")
    return err


def rel_tol(name, dtype, want) -> float:
    rel = FP32_REL_TOL[name] if dtype == torch.float32 else BF16_REL_TOL
    return rel * max(1.0, want.float().abs().max().item())


def front_args(name, folded, dtype, dev):
    if name == "fused_front":
        w, b = ff.stem_weights(folded["stem"]["weight"], folded["stem"]["bias"], dtype)
        return ff.fused_front, ff.fused_front_reference, (w.to(dev), b.to(dev))
    args = tuple(a.to(dev) for a in ff.g1_weights(folded, dtype))
    return ff.fused_front_g1, ff.fused_front_g1_reference, args


def stem_output(folded, gen, n, hw, dev) -> torch.Tensor:
    """K5's input: the fp32 stem + pool of ``n`` random ``hw`` px blocks."""
    img = (torch.randint(0, 1024, (n, hw, hw, 1), generator=gen).float()
           / 1023.0).to(dev)
    stem = ff.stem_weights(folded["stem"]["weight"], folded["stem"]["bias"],
                           torch.float32)
    return ff.fused_front_reference(img, *(t.to(dev) for t in stem))


def check_kernels(folded, gen, dev) -> dict:
    """Each kernel against its plain version on the card; returns the max
    error per kernel at its main path's shape and dtype."""
    errors = {}
    bf16, f32 = torch.bfloat16, torch.float32
    for hw in (8, 16):  # K1, K2
        size = hw * hw
        u16 = torch.randint(0, 1024, (RAGGED, hw, hw, 1), generator=gen).view(-1)
        u16 = torch.cat([u16, u16[:1]])  # one value more, for the view that starts at 1
        for dtype in (f32, bf16):
            flat = (u16.float() / 1023.0).to(dev, dtype)
            views = [(batch, "aligned", flat[:batch * size]) for batch in (1, 255, RAGGED)]
            views.append((RAGGED, "offset_by_one", flat[1:]))
            for (batch, layout, view), name in itertools.product(
                    views, ("fused_front", "fused_front_g1")):
                x = view.view(batch, hw, hw, 1)
                kern, plain, args = front_args(name, folded, dtype, dev)
                got = kern(x, *args)
                torch.cuda.synchronize()
                want = plain(x, *args)
                tol = (FP32_TOL[name] if dtype == f32
                       else BF16_REL_TOL * max(1.0, want.float().abs().max().item()))
                err = compare(name, got, want, tol, hw=hw, batch=batch, layout=layout,
                              dtype=str(dtype))
                if (hw, dtype, batch, layout) == (HW, bf16, RAGGED, "aligned"):
                    errors[name] = err

    for e in rg.EXTENTS:  # K5 on the stem's output of 4e px blocks
        x32 = stem_output(folded, gen, RAGGED, 4 * e, dev)
        for dtype in (f32, bf16):
            x = x32.to(dtype)
            w = tuple(t.to(dev) for t in rg.pack_group12_weights(folded, dtype))
            stream = rg.group12_conv_stream(w) if dtype == bf16 else None
            got = rg.fused_group12(x, w, stream)
            torch.cuda.synchronize()
            want = rg.fused_group12_reference(x, w)
            err = compare("fused_group12", got, want, rel_tol("fused_group12", dtype, want),
                          extent=e, batch=RAGGED, dtype=str(dtype))
            if e == HW // 4 and dtype == bf16:
                errors["fused_group12"] = err

    rng = np.random.default_rng(SEED)
    frames = torch.from_numpy(pp.pad_frames(codes(rng, (3,) + FRAMES[1:]), 64)).to(dev)
    blocks = torch.from_numpy(codes(rng, (RAGGED, HW, HW, 1))).to(dev)
    for dtype in (f32, bf16):  # K3a, K3b: bit-exact
        for bs in (16, 64):
            got = pp.tile_normalize_frames(frames, bs, dtype)
            torch.cuda.synchronize()
            err = compare("tile_normalize_frames", got,
                          pp.tile_normalize_reference(frames, bs, dtype), 0.0,
                          block_size=bs, frames=list(frames.shape), dtype=str(dtype))
            if bs == HW and dtype == bf16:
                errors["tile_normalize_frames"] = err
        for layout, b in (("aligned", blocks), ("offset_by_one", blocks.view(-1)[1:])):
            got = pp.normalize_blocks(b, dtype)
            torch.cuda.synchronize()
            err = compare("normalize_blocks", got, pp.normalize_blocks_reference(b, dtype),
                          0.0, shape=list(b.shape), layout=layout, dtype=str(dtype))
            if layout == "aligned" and dtype == bf16:
                errors["normalize_blocks"] = err

    # K4 forward, ragged M: a head's two layers (tensor-core kernel; the
    # second is 8 columns of a 64-wide tile), a (K, N) off the 16-byte rows
    # (general kernel), and a long K
    d_in, d_hid, d_out = HEAD
    for k, n, acts in ((d_in, d_hid, ("linear", "relu", "silu", "sigmoid")),
                       (d_hid, d_out, ("linear",)),
                       (500, 250, ("linear", "relu", "silu", "sigmoid")),
                       (4096, d_hid, ("linear",))):
        shape = (RAGGED, k, n)
        cpu = (torch.randn(RAGGED, k, generator=gen),
               torch.randn(k, n, generator=gen) / math.sqrt(k),
               torch.randn(n, generator=gen))
        if shape == (RAGGED, d_in, d_hid):
            data = cpu  # the backward check below reuses it
        for dtype in (f32, bf16):
            x, w = cpu[0].to(dev, dtype), cpu[1].to(dev, dtype)
            b = cpu[2].to(dev)
            fast = takes_fast_path(x, w)
            if fast != (k % 8 == 0 and n % 8 == 0):
                raise AssertionError(f"fused_dense {shape}: fast path {fast}")
            for act in acts:
                got = fused_dense(x, w, b, act)
                torch.cuda.synchronize()
                want = fused_dense_reference(x, w, b, act)
                err = compare("fused_dense", got, want,
                              rel_tol("fused_dense", dtype, want), shape=list(shape),
                              act=act, dtype=str(dtype), tensor_cores=fast)
                if act == "relu" and dtype == f32 and k == d_in:
                    errors["fused_dense"] = err
                if act == "linear" and dtype == f32:
                    # both against a float64 product; `want` is cuBLAS fp32
                    exact = x.double() @ w.double() + b.double()
                    ours = (got.double() - exact).abs().max().item()
                    library = (want.double() - exact).abs().max().item()
                    emit("kernel_check", kernel="fused_dense_vs_float64",
                         shape=list(shape), tensor_cores=fast, max_abs_err=ours,
                         library_max_abs_err=library,
                         max_abs_out=exact.abs().max().item())
                    if fast and k == d_in and ours > library:
                        raise AssertionError(
                            f"fused_dense fp32 {shape}: {ours} from float64, "
                            f"the library {library}")
    # K4 backward: the custom VJP, and autograd through the plain version
    # beside it, against float64 autograd, on two draws of the head's first
    # layer. `atol_needed` is the least atol with which each would pass at
    # GRAD_RTOL, and `between_atol_needed` what holding one to the other needs.
    second = torch.Generator().manual_seed(SEED + 4)
    draws = (data, (torch.randn(RAGGED, d_in, generator=second),
                    torch.randn(d_in, d_hid, generator=second) * 0.05,
                    torch.randn(d_hid, generator=second)))
    for (draw, cpu), act in itertools.product(enumerate(draws), ACTS):
        grads = []
        for fn, dtype in ((fused_dense, f32), (fused_dense_reference, f32),
                          (lambda x, w, b, a: ACTS[a](x @ w + b), torch.float64)):
            params = [t.to(dev, dtype).requires_grad_() for t in cpu]
            (fn(*params, act) ** 2).sum().backward()
            grads.append([p.grad.double() for p in params])
        for arg, got, plain_grad, exact in zip("xwb", *grads):
            def needed(grad, ref=exact):
                return ((grad - ref).abs() - GRAD_RTOL * ref.abs()).max().item()
            emit("kernel_check", kernel="fused_dense_backward", draw=draw, act=act,
                 grad=arg, max_abs_err=(got - exact).abs().max().item(),
                 plain_max_abs_err=(plain_grad - exact).abs().max().item(),
                 atol_needed=needed(got), plain_atol_needed=needed(plain_grad),
                 between_atol_needed=needed(got, plain_grad),
                 max_abs_out=exact.abs().max().item(), rtol=GRAD_RTOL, atol=GRAD_ATOL[arg])
            torch.testing.assert_close(got, exact, rtol=GRAD_RTOL, atol=GRAD_ATOL[arg])
    return errors


# ---------------------------------------------------------------------------
# Phase 4: the folded fp32 pipeline against the plain nn.Module pipeline
# ---------------------------------------------------------------------------


def check_reference(models: PipelineModels, samples: np.ndarray, dev) -> None:
    """Folded fp32 pipeline on the card with each front, with and without
    K5, vs the plain nn.Module pipeline on the CPU: stage-1 probabilities
    within 1e-4 and every label equal where the decision margin exceeds
    1e-3."""
    images = torch.from_numpy(samples)
    want = make_v6_pipeline(models, stage1_threshold=THRESHOLD, device="cpu")(images)
    with torch.inference_mode():
        x = images.float() / 1023.0
        s1 = torch.sigmoid(models.stage1(x))
        margins = {"stage1_pred": (s1 - THRESHOLD).abs()}
        for key, m in (("stage2_pred", models.stage2),
                       ("stage3_rect_pred", models.stage3_rect),
                       ("stage3_ab_pred", models.stage3_ab)):
            top = m(x).topk(2, dim=-1).values
            margins[key] = top[:, 0] - top[:, 1]
    margins["final"] = torch.stack(list(margins.values())).amin(0)
    for mode, groups in ((False, False), (True, False), ("g1", False),
                         (False, True), (True, True)):
        got = make_v6_pipeline_folded(models, THRESHOLD, float_dtype=torch.float32,
                                      use_fused_front=mode, use_pallas_groups=groups,
                                      device=dev)(images.to(dev))
        got = {k: v.cpu() for k, v in got.items()}
        prob_err = (got["stage1_prob"] - want["stage1_prob"]).abs().max().item()
        mismatches = {}
        for key, margin in margins.items():
            sure = margin > 1e-3
            mismatches[key] = int((got[key] != want[key])[sure].sum())
        emit("reference", fused_front=mode, pallas_groups=groups, samples=len(samples),
             stage1_prob_max_abs_err=prob_err,
             guarded_share=float((margins["final"] > 1e-3).float().mean()),
             mismatches_above_margin=mismatches)
        if prob_err > 1e-4 or any(mismatches.values()):
            raise AssertionError(f"folded fp32 ({mode}, groups={groups}) "
                                 "disagrees with the reference")


# ---------------------------------------------------------------------------
# Phase 5: the main paths
# ---------------------------------------------------------------------------


def make_dataset() -> Path:
    rng = np.random.default_rng(SEED)

    def bundle(n):
        stage0 = rng.integers(0, 8, size=n).astype(np.int32)
        return Bundle(
            samples=codes(rng, (n, HW, HW, 1)),
            qps=np.full(n, 90, np.int32),
            labels={"stage0": stage0, "stage1": (stage0 != 0).astype(np.int32)},
        )

    root = WORK / "dataset"
    save_split(root, HW, bundle(64), bundle(N_VAL), "v6")
    return root


def run_cli(dataset: Path, ckpts: dict, mode: str, fgvc: bool, dev) -> dict:
    out = WORK / "runs" / (f"{mode}_fgvc" if fgvc else mode)
    argv = [
        "--variant", "v6", "--dataset-dir", str(dataset), "--block-size", str(HW),
        "--output-dir", str(out), "--batch-size", str(BATCH),
        "--stage1-threshold", str(THRESHOLD), "--folded", "--bf16",
        "--fused-front", mode, "--device", dev.type,
        "--stage1-checkpoint", str(ckpts["stage1"]),
        "--stage2-checkpoint", str(ckpts["stage2"]),
        "--stage3-rect-checkpoint", str(ckpts["rect"]),
        "--stage3-ab-checkpoint", str(ckpts["fgvc" if fgvc else "ab"]),
        "--ab-fgvc" if fgvc else "--no-ab-fgvc",
    ]
    run_pipeline_eval.main(argv)
    metrics = json.loads((out / "pipeline_metrics_val.json").read_text())
    preds = np.load(out / "pipeline_predictions_val.npz")
    return {"samples": metrics["samples"],
            "blocks_per_s": metrics["throughput_superblocks_per_sec"],
            "final": preds["predictions"], "stage1_prob": preds["stage1_prob"]}


def drive(path: str, plan, run_one) -> tuple:
    """One main path: counts set to 0, each ``(name, arg)`` of ``plan``
    run through ``run_one``, counts read. Returns (runs, launches)."""
    _build.reset_launch_counts()
    runs, before = [], dict(_build.launch_counts)
    for name, arg in plan:
        run = run_one(arg)
        run["name"] = name
        run["launches"] = {k: v - before[k] for k, v in _build.launch_counts.items()
                           if v - before[k]}
        before = dict(_build.launch_counts)
        runs.append(run)
    launches = dict(_build.launch_counts)
    emit("main_path", path=path, launches=launches)
    return runs, launches


def report_runs(path, runs, base, expect) -> None:
    """Emit each serving run; check its outputs and that ``expect(run)``'s
    kernels launched."""
    for run in runs:
        finite = bool(np.isfinite(run["stage1_prob"]).all())
        emit("end_to_end", path=path, run=run["name"], samples=run["samples"],
             blocks_per_s=run["blocks_per_s"], launches=run["launches"],
             final_agrees_with_off=float((run["final"] == base["final"]).mean()),
             stage1_prob_max_abs_diff_vs_off=float(
                 np.abs(run["stage1_prob"] - base["stage1_prob"]).max()),
             finite=finite)
        if run["samples"] != N_VAL or len(run["final"]) != N_VAL or not finite:
            raise AssertionError(f"{run['name']}: bad outputs")
        if not np.isin(run["final"], np.arange(8)).all():
            raise AssertionError(f"{run['name']}: labels outside 0..7")
        for kernel in expect(run):
            if run["launches"].get(kernel, 0) == 0:
                raise AssertionError(f"{run['name']}: {kernel} never launched")


def serve_with_groups(models: PipelineModels, samples: np.ndarray, dev):
    """``run_one`` of path b: K5 with the given front, bf16, batch 4096."""
    predicts = {}

    def run_one(mode):
        if mode not in predicts:
            predicts[mode] = make_v6_pipeline_folded(
                models, THRESHOLD, float_dtype=torch.bfloat16, use_fused_front=mode,
                use_pallas_groups=True, device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = run_pipeline_batched(predicts[mode], samples, batch_size=BATCH, device=dev)
        seconds = time.perf_counter() - t0
        return {"samples": len(out["final"]), "blocks_per_s": len(samples) / seconds,
                "final": out["final"], "stage1_prob": out["stage1_prob"], "mode": mode}

    return run_one


def kernel_api_path(models, val: Bundle, dev) -> dict:
    """Path c through ``av1tpu_torch.kernels``: K3a/K3b ingest of eight
    1080p frames, then three training steps of a K4 head."""
    rng = np.random.default_rng(SEED + 1)
    frames = pp.pad_frames(codes(rng, FRAMES), HW)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    frames_dev = torch.from_numpy(frames).to(dev)
    tiled = pp.tile_normalize_frames(frames_dev, HW, torch.bfloat16)
    torch.cuda.synchronize()
    ingest_s = time.perf_counter() - t0
    again = pp.normalize_blocks(torch.from_numpy(host_tile(frames, HW)).to(dev),
                                torch.bfloat16)
    f, h, w = frames.shape
    if tiled.shape != (f * (h // HW) * (w // HW), HW, HW, 1) or not torch.equal(tiled, again):
        raise AssertionError("K3a blocks differ from K3b on host-tiled blocks")
    emit("kernel_api", step="ingest", frames=list(frames.shape), blocks=tiled.shape[0],
         blocks_per_s=tiled.shape[0] / ingest_s, k3a_equals_k3b_on_host_tiles=True)

    x = pp.normalize_blocks(torch.from_numpy(val.samples[:BATCH]).to(dev))
    labels = torch.from_numpy(val.labels["stage0"][:BATCH]).long().to(dev)
    backbone = copy.deepcopy(models.stage1.backbone).to(dev).eval()
    with torch.no_grad():
        emb = backbone(x)
        emb = (emb - emb.mean(0)) / (emb.std(0) + 1e-6)  # standardised features
    gen = torch.Generator().manual_seed(SEED)
    params = []
    for d_in, d_out in zip(HEAD[:-1], HEAD[1:]):
        params += [(torch.randn(d_in, d_out, generator=gen) / math.sqrt(d_in)).to(dev),
                   torch.zeros(d_out, device=dev)]
    for p in params:
        p.requires_grad_()
    losses = []
    for _ in range(3):
        h = fused_dense(emb, params[0], params[1], "relu")
        loss = F.cross_entropy(fused_dense(h, params[2], params[3], "linear"), labels)
        loss.backward()
        with torch.no_grad():
            for p in params:
                p -= 0.1 * p.grad
                p.grad = None
        losses.append(loss.item())
    emit("kernel_api", step="head_training", batch=BATCH, widths=list(HEAD),
         losses=losses)
    if not all(map(math.isfinite, losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"K4 head training did not reduce its loss: {losses}")
    return {"tiled": tiled}


# ---------------------------------------------------------------------------
# Phase 6: one predict per mode
# ---------------------------------------------------------------------------

PREDICT_MODES = {  # name: (use_fused_front, use_pallas_groups)
    "off": (False, False), "on": (True, False), "g1": ("g1", False),
    "groups_off": (False, True), "groups_on": (True, True),
}


def trace_predict(predict, batch, repeats: int = 3) -> dict:
    """Kernels per predict, device busy ms per predict (the union of the
    kernels' intervals) and the host's launch calls per predict from a
    ``torch.profiler`` trace of ``repeats`` predicts. The device fields are
    None if the trace shows no device activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(repeats):
            predict(batch)
        torch.cuda.synchronize()
    events = prof.events()
    spans = sorted((e.time_range.start, e.time_range.end) for e in events
                   if e.device_type == DeviceType.CUDA)
    launch_calls = sum(e.device_type == DeviceType.CPU and "LaunchKernel" in e.name
                       for e in events) / repeats
    if not spans:
        return {"kernels_per_predict": None, "device_busy_ms": None,
                "host_launch_calls_per_predict": launch_calls}
    busy, (lo, hi) = 0.0, spans[0]
    for start, end in spans[1:]:
        if start > hi:
            busy, lo, hi = busy + hi - lo, start, end
        else:
            hi = max(hi, end)
    busy += hi - lo
    return {"kernels_per_predict": len(spans) / repeats,
            "device_busy_ms": busy / 1e3 / repeats,
            "host_launch_calls_per_predict": launch_calls}


def predict_phase(models: PipelineModels, samples: np.ndarray, dev, smi: str) -> None:
    """CUDA-event ms of one 4,096-block bf16 predict on a batch on the card:
    six samples per mode in ABCDE EDCBA turns (each the mean of 10 predicts;
    ``predict_ms`` is their median), with the port's kernels launched per
    predict and the trace's kernel count, busy time and idle share."""
    batch = torch.from_numpy(samples[:BATCH]).to(dev)
    predicts = {
        name: make_v6_pipeline_folded(models, THRESHOLD, float_dtype=torch.bfloat16,
                                      use_fused_front=front, use_pallas_groups=groups,
                                      device=dev)
        for name, (front, groups) in PREDICT_MODES.items()
    }
    for _ in range(2):  # warm-up: cuDNN plans, the allocator, the clocks
        for predict in predicts.values():
            for _ in range(10):
                predict(batch)
    names = list(predicts)
    samples_ms = {name: [] for name in names}
    for name in (names + names[::-1]) * 3:
        samples_ms[name].append(time_ms(lambda: predicts[name](batch), iters=10))
    for name in names:
        before = dict(_build.launch_counts)
        predicts[name](batch)
        launched = {k: v - before[k] for k, v in _build.launch_counts.items()
                    if v - before[k]}
        trace = trace_predict(predicts[name], batch)
        ms = float(np.median(samples_ms[name]))
        busy = trace["device_busy_ms"]
        emit("predict", mode=name, batch=BATCH, hw=HW, dtype="bfloat16", predict_ms=ms,
             samples_ms=samples_ms[name], port_kernels_per_predict=launched,
             idle_share=None if busy is None else max(0.0, 1.0 - busy / ms),
             nvidia_smi=smi, **trace)


# ---------------------------------------------------------------------------
# Phase 7: timing
# ---------------------------------------------------------------------------


class TimingCase(NamedTuple):
    kernel: str                   # a name of KERNELS
    run: Callable                 # the kernel's wrapper
    plain: Callable               # its plain PyTorch version
    library: Optional[Callable]   # one PyTorch call for the same function, if any
    n_bytes: int                  # inputs read once + outputs written once
    flops: float                  # the function's operations on these inputs
    dtype: torch.dtype            # the inputs' type, which picks the peak rate
    shape: dict
    main: bool                    # the case of the main path: the `kernels` line


def timing_cases(folded, gen, dev) -> list:
    """Every kernel at its main path's shape, K1 and K2 also at 8 px, K4 also
    in bf16 and K5 at the other extents."""
    bf16, f32 = torch.bfloat16, torch.float32
    cases = []
    inputs = {hw: (torch.randint(0, 1024, (BATCH, hw, hw, 1), generator=gen).float()
                   / 1023.0).to(dev, bf16) for hw in (HW, 8)}
    for (hw, x), name in itertools.product(inputs.items(),
                                           ("fused_front", "fused_front_g1")):
        kern, plain, args = front_args(name, folded, bf16, dev)
        cases.append(TimingCase(
            name, lambda k=kern, x=x, a=args: k(x, *a),
            lambda p=plain, x=x, a=args: p(x, *a), None,
            tensor_bytes(x, *args, kern(x, *args)),
            BATCH * front_flops(hw, with_g1=name == "fused_front_g1"), bf16,
            {"batch": BATCH, "hw": hw, "dtype": "bfloat16"}, hw == HW))
    wg = tuple(t.to(dev) for t in rg.pack_group12_weights(folded, bf16))
    stream = rg.group12_conv_stream(wg)
    for e in (HW // 4,) + tuple(e for e in rg.EXTENTS if e != HW // 4):
        xg = stem_output(folded, gen, BATCH, 4 * e, dev).to(bf16)
        cases.append(TimingCase(
            "fused_group12", lambda xg=xg: rg.fused_group12(xg, wg, stream),
            lambda xg=xg: rg.fused_group12_reference(xg, wg), None,
            tensor_bytes(xg, *wg, rg.fused_group12(xg, wg, stream)),
            BATCH * group12_flops(e), bf16,
            {"batch": BATCH, "extent": e, "dtype": "bfloat16"}, e == HW // 4))
    rng = np.random.default_rng(SEED + 2)
    frames = torch.from_numpy(pp.pad_frames(codes(rng, FRAMES), HW)).to(dev)
    cases.append(TimingCase(
        "tile_normalize_frames", lambda: pp.tile_normalize_frames(frames, HW, bf16),
        lambda: pp.tile_normalize_reference(frames, HW, bf16), None,
        tensor_bytes(frames, pp.tile_normalize_frames(frames, HW, bf16)),
        float(frames.numel()), f32,  # one fp32 divide per value
        {"frames": list(frames.shape), "block_size": HW, "dtype": "bfloat16"}, True))
    blocks = torch.from_numpy(codes(rng, (N_VAL, HW, HW, 1))).to(dev)
    cases.append(TimingCase(
        "normalize_blocks", lambda: pp.normalize_blocks(blocks, bf16),
        lambda: pp.normalize_blocks_reference(blocks, bf16), None,
        tensor_bytes(blocks, pp.normalize_blocks(blocks, bf16)), float(blocks.numel()), f32,
        {"shape": list(blocks.shape), "dtype": "bfloat16"}, True))
    d_in, d_hid, _ = HEAD
    cpu = (torch.randn(BATCH, d_in, generator=gen),
           torch.randn(d_in, d_hid, generator=gen) / math.sqrt(d_in),
           torch.randn(d_hid, generator=gen))
    for dtype in (f32, bf16):  # fp32 is path c's dtype
        xd, wd, bd = cpu[0].to(dev, dtype), cpu[1].to(dev, dtype), cpu[2].to(dev)
        bias = bd.to(dtype)  # addmm wants one dtype
        cases.append(TimingCase(
            "fused_dense", lambda xd=xd, wd=wd: fused_dense(xd, wd, bd, "relu"),
            lambda xd=xd, wd=wd: fused_dense_reference(xd, wd, bd, "relu"),
            lambda xd=xd, wd=wd, bias=bias: torch.addmm(bias, xd, wd).relu_(),
            tensor_bytes(xd, wd, bd, fused_dense(xd, wd, bd, "relu")),
            2.0 * BATCH * d_in * d_hid, dtype,
            {"shape": [BATCH, d_in, d_hid], "act": "relu",
             "dtype": str(dtype).replace("torch.", "")}, dtype == f32))
    return cases


def time_case(case: TimingCase, smi: str) -> dict:
    """The case's calls in turns (plain, library, kernel, kernel, library,
    plain), device time through a CUDA graph; the wrapper also from Python."""
    order = [case.plain, case.library, case.run, case.run, case.library, case.plain]
    slow = case.shape.get("extent", 0) >= 8
    t = [None if fn is None else device_ms(fn, iters=4 if slow else 20,
                                           replays=2 if slow else 5) for fn in order]
    bound_ms, bound_by = bound(case.n_bytes, case.flops, case.dtype)
    result = {
        "ms": (t[2] + t[3]) / 2, "plain_ms": (t[0] + t[5]) / 2,
        "library_ms": None if case.library is None else (t[1] + t[4]) / 2,
        "bound_ms": bound_ms, "bound_by": bound_by,
    }
    emit("timing", kernel=case.kernel, **result, share_of_bound=bound_ms / result["ms"],
         eager_ms=time_ms(case.run, iters=10 if slow else 50), samples_ms=t[2:4],
         plain_samples_ms=[t[0], t[5]],
         library_samples_ms=None if case.library is None else [t[1], t[4]],
         bytes=case.n_bytes, flops=case.flops, nvidia_smi=smi, **case.shape)
    return result


def ptxas_report(lib: Path) -> dict:
    """Registers and spill bytes (stores, loads) of every fused kernel, from
    the ``-Xptxas -v`` lines in nvcc's logs beside the library."""
    entry = re.compile(
        r"Compiling entry function '\S*?(?<=\d)(fused_[a-z0-9_]+?_kernel)I(\S*?)Ev\S*'.*?"
        r"(\d+) bytes spill stores, (\d+) bytes spill loads.*?Used (\d+) registers", re.S)
    report = {}
    for log in sorted(lib.parent.glob("*.nvcc.log")):
        for kernel, targs, stores, loads, regs in entry.findall(log.read_text()):
            args = [a or b or c for a, b, c in
                    re.findall(r"Li(\d+)E|(f)|13__nv_(bfloat16)", targs)]
            report[f"{kernel}<{', '.join(args)}>"] = {
                "registers": int(regs), "spill_bytes": [int(stores), int(loads)]}
    return report


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke test needs one",
              file=sys.stderr)
        return 1
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smi = nvidia_smi_line()
    kind = torch.cuda.get_device_name(0)
    emit("device", nvidia_smi=smi, kind=kind, count=torch.cuda.device_count(),
         torch=torch.__version__, cuda=torch.version.cuda)
    loaded = sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN_MODULES)
    if loaded:
        raise AssertionError(f"the port must import nothing of {FORBIDDEN_MODULES}; "
                             f"loaded: {loaded[:5]}")

    t0 = time.perf_counter()
    lib = _build.build_kernels()
    _build.load_kernels()
    emit("build", seconds=time.perf_counter() - t0, library=str(lib.relative_to(ROOT)),
         sources=[str(s.relative_to(ROOT)) for s in _build.SOURCES],
         ptxas=ptxas_report(lib))

    torch.manual_seed(SEED)  # dropout during BN calibration
    gen = torch.Generator().manual_seed(SEED)
    calib = torch.randint(0, 1024, (512, HW, HW, 1), generator=gen).float() / 1023.0
    models = {name: seeded_model(cls, gen, calib) for name, cls in (
        ("stage1", Stage1Model), ("stage2", Stage2Model),
        ("rect", Stage3RectModel), ("ab", Stage3ABModel), ("fgvc", FGVCModel),
    )}
    folded = fold_backbone(models["stage1"].backbone)
    errors = check_kernels(folded, gen, dev)

    dataset = make_dataset()
    val = Bundle.load(dataset / f"block_{HW}" / "val.npz")
    plain = PipelineModels(models["stage1"], models["stage2"], models["rect"],
                           models["ab"])
    check_reference(plain, val.samples[:2048], dev)

    ckpts = {}
    for name, model in models.items():
        ckpts[name] = save_variables_npz(WORK / "ckpt" / f"{name}_variables.npz",
                                         to_jax_variables(model.state_dict()))

    # path a: the serving CLI. A warm-up run pays cuDNN's and the
    # allocator's first calls; then each front once.
    cli_runs, cli_launches = drive("a_cli", [
        ("off_warmup", ("off", False)), ("off", ("off", False)), ("on", ("on", False)),
        ("g1", ("g1", False)), ("on_fgvc", ("on", True)),
    ], lambda arg: dict(run_cli(dataset, ckpts, *arg, dev), mode=arg[0]))
    base = cli_runs[1]
    front_kernel = {"on": ["fused_front"], "g1": ["fused_front_g1"]}
    report_runs("a_cli", cli_runs, base, lambda r: front_kernel.get(r["mode"], []))

    # path b: K5 serving, fronts off and on, after a warm-up, in turns
    k5_runs, k5_launches = drive("b_groups", [
        ("groups_off_warmup", False), ("groups_off", False), ("groups_on", True),
        ("groups_on_2", True), ("groups_off_2", False),
    ], serve_with_groups(plain, val.samples, dev))
    report_runs("b_groups", k5_runs, base, lambda r: ["fused_group12"] + (
        ["fused_front"] if r["mode"] else []))

    # path c: the kernels API
    _, api_launches = drive("c_kernel_api", [("ingest_and_head", None)],
                            lambda _: kernel_api_path(plain, val, dev))

    launches = {k: cli_launches[k] + k5_launches[k] + api_launches[k]
                for k in _build.KERNELS}
    for name in KERNELS:
        if launches[name] == 0:
            raise AssertionError(f"{name} was never launched by a main path")

    predict_phase(plain, val.samples, dev, smi)

    kernels = []
    for case in timing_cases(folded, gen, dev):
        result = time_case(case, smi)
        if case.main:
            source, replaces = KERNELS[case.kernel]
            kernels.append({"name": case.kernel, "route": "cuda", "source": source,
                            "replaces": replaces, "launches": launches[case.kernel],
                            "max_abs_err": errors[case.kernel], **result})
    if sorted(k["name"] for k in kernels) != sorted(KERNELS):
        raise AssertionError("the kernels line must list every kernel once")

    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
