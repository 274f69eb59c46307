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
  5. the main paths, each driven with the launch counts set to 0 just
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
       d. the frame -> partition-tree cascade on a synthetic yuv420p10le clip
          of eight 1920x1080 frames (510 superblocks each), every level of
          64/32/16/8 px with its own seeded models: the port's
          ``predict_trees --folded --bf16 --frames-per-batch 4`` with
          ``--fused-front off`` (after a warm-up), ``on`` and ``g1``, the same
          with ``--unified``, one run with ``--level-capacity 1 0.75 0.38
          0.15`` (a group without overflow must agree with the dense run on
          99.9% of its slots), and ``predict_partition_trees`` with K5
          predictors, fronts off and on (K1 and K2 at 16 and 8 px, K5 at
          every extent);
       then path a's second part (``a_serving``), on path a's dataset, bf16,
       batch 4096: ``optimize_thresholds`` on the stage-1 checkpoint (the
       calibration directory of what follows); ``--folded --capacity auto
       --capacity-margin 0.1`` and ``--folded --capacity 0.5`` (the gated
       pipeline: its overflow summed over batches; exactly the passers
       outside each batch's K rows are SPLIT, and every other row's label
       equals the ``off`` run's on 99.9%); ``--variant unified
       --folded --fused-front off|on|g1`` with path d's 16 px unified model
       (K1, K2); ``--tta`` and ``--stage3-ab-ensemble-dir`` (three seeded AB
       members saved with ``save_ensemble``) on the plain graph; then
       ``certify_serving --skip-int8`` in fp32 (its folded and
       unified(folded) rows agree with their plain graphs on 99%),
       ``compare_thresholds`` and ``analyze_confusion``, each of which must
       write its files; after it (phase ``stacking``, outside the path) the
       three members' logits on 4,096 of its blocks and the stacking
       meta-model fit on them on the card, whose objective must equal the
       CPU fit's within 1e-4 and fall below the starting weights';
     each run prints blocks/s (or frames/s and superblocks/s), its launches,
     and its agreement with its path's ``off`` run;
  6. predict: the CUDA-event time of one 4,096-block bf16 predict on a
     batch already on the card, for fronts off / on / g1, K5 with fronts
     off / on and the gated pipeline at path a's ``auto`` capacity and at
     0.5, in ABC...CBA turns, and from a ``torch.profiler`` trace the
     kernels launched per predict, the device's busy time and idle share;
     then the same per level of the cascade for one group of four frames
     (``cascade_level``: per-stage off / g1 / K5+K1 and unified g1);
  7. timing: each kernel, its plain version and, for K4, one library call
     (``torch.addmm`` + ``relu_``) in turns at the main paths' shapes, K1 and
     K2 also at 8 px, K4 in fp32 and bf16, K5 at all four extents and at the
     cascade's 64 and 32 px rows (extent 16 x 510 and 2,040, extent 8 x
     2,040). ``ms`` is
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

import contextlib
import copy
import io
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

from av1tpu_torch.cli import (  # noqa: E402
    analyze_confusion,
    certify_serving,
    compare_thresholds,
    optimize_thresholds,
    predict_trees,
    run_pipeline_eval,
)
from av1tpu_torch.codec.partitions import map_to_stage2_v6  # noqa: E402
from av1tpu_torch.codec.tree import LEVEL_SIZES, NODES_PER_LEVEL  # noqa: E402
from av1tpu_torch.data.bundles import Bundle, save_split  # noqa: E402
from av1tpu_torch.eval import (  # noqa: E402
    PipelineModels,
    make_unified_pipeline,
    make_unified_pipeline_folded,
    make_v6_pipeline,
    make_v6_pipeline_folded,
    make_v6_pipeline_gated,
    predict_partition_trees,
    quad_tile_on_device,
    fit_stacking,
    load_ensemble,
    run_pipeline_batched,
    save_ensemble,
    stacked_member_logits,
    v6_route,
)
from av1tpu_torch.eval.ensemble import _stacking_features, _stacking_objective  # noqa: E402
from av1tpu_torch.ingest import (  # noqa: E402
    Yuv420p10Geometry,
    read_y_frames_batch,
    tile_frames,
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
    UnifiedV6Model,
    split_unified_logits,
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
# Path d: the tree cascade on a clip of eight 1080p frames, four frames a group
CLIP = (8, 1080, 1920)
FRAME_SBS = 17 * 30       # 64 px superblocks of one padded 1080p frame
FRAMES_PER_BATCH = 4
LEVEL_CAPACITY = (1.0, 0.75, 0.38, 0.15)
# The share of blocks on which each level's gate opens and its stage 2 says
# SPLIT, chosen so that about 54% / 24% / 8% of the 32 / 16 / 8 px nodes are
# alive and LEVEL_CAPACITY covers them.
GATE_SHARE = 0.9
SPLIT_SHARE = {64: 0.6, 32: 0.5, 16: 0.37, 8: 0.3}
RECT_SHARE, AB_SHARE = 0.5, 0.3  # HORZ among the RECT pair, HORZ_A among the AB four
STAGE_CKPT = {"stage1": "stage1", "stage2": "stage2", "rect": "stage3_rect",
              "ab": "stage3_ab"}
STAGE_CLASSES = {"stage1": Stage1Model, "stage2": Stage2Model,
                 "rect": Stage3RectModel, "ab": Stage3ABModel}
# Rows of one kernel call when one and four frames go through the cascade at
# batch 4096: whole levels, full chunks and the tails they leave. By K5's
# extent (block px / 4); K1 and K2 see the 16 and 8 px rows.
CASCADE_ROWS = {16: (510, 2040), 8: (2040, 4096, 4064), 4: (4096, 4064, 3968),
                2: (4096, 3968, 3584)}
WORK = ROOT / "build" / "chip_smoke"
FRONT_KERNELS = {"on": ["fused_front"], "g1": ["fused_front_g1"]}  # by --fused-front
CAPACITY_MARGIN = 0.1     # --capacity auto's headroom over the calibrated gate rate
ENSEMBLE_MEMBERS = 3      # seeded AB members of --stage3-ab-ensemble-dir
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


def seeded_model(cls, gen: torch.Generator, calib: torch.Tensor,
                 device="cpu") -> nn.Module:
    """A model on the CPU drawn from ``gen``: lecun-normal weights, BN running
    stats set to a calibration batch's statistics (the forward that takes
    them runs on ``device``) and then perturbed, so that the logits depend on
    the input."""
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
        model.to(device).train()
        model(calib.to(device))
        model.cpu().eval()
        for mod in model.modules():
            if isinstance(mod, nn.modules.batchnorm._BatchNorm):
                std = mod.running_var.sqrt()
                mod.running_mean += 0.2 * std * torch.randn(std.shape, generator=gen)
                mod.running_var *= 0.5 + torch.rand(std.shape, generator=gen)
    return model


def codes(rng: np.random.Generator, shape) -> np.ndarray:
    """Uniform 10-bit codes as uint16."""
    return rng.integers(0, 1024, size=shape, dtype=np.uint16)


def structured_luma(rng: np.random.Generator, shape) -> np.ndarray:
    """uint16 luma planes ``(..., H, W)`` (multiples of 16) with structure at
    every scale of the 64->32->16->8 hierarchy: a random level per 16 px cell
    plus noise whose amplitude is drawn per 8 px cell, so that blocks of every
    size differ from their neighbours in brightness and in texture."""
    *lead, h, w = shape
    level = np.kron(rng.uniform(100, 900, (*lead, h // 16, w // 16)), np.ones((16, 16)))
    amp = np.kron(rng.uniform(0, 250, (*lead, h // 8, w // 8)), np.ones((8, 8)))
    noisy = level + amp * rng.standard_normal(level.shape, dtype=np.float32)
    return np.clip(noisy, 0, 1023).astype(np.uint16)


def set_first_class_share(head: nn.Module, logits: np.ndarray, share: float) -> np.ndarray:
    """Shift the bias of an ``MLPHead``'s last Linear in place so that, on the
    probe blocks that gave ``logits``, the share ``share`` takes the first
    decision: the stage-1 gate opens (``(N,)`` logits, against ``THRESHOLD``)
    or class 0, SPLIT for stage 2, wins the argmax (``(N, C)``). Returns the
    shifted logits. A random head takes one decision on every input; a cascade
    needs its SPLIT decisions to vary with the block."""
    logits = np.asarray(logits, np.float64)
    shift = np.zeros(head.head[-1].bias.shape[0])
    if logits.ndim == 1:
        shift[0] = math.log(THRESHOLD / (1 - THRESHOLD)) - np.quantile(logits, 1 - share)
    else:
        shift[0] = np.quantile(logits[:, 1:].max(axis=1) - logits[:, 0], share)
    with torch.no_grad():
        head.head[-1].bias += torch.as_tensor(shift, dtype=torch.float32)
    return logits + (shift[0] if logits.ndim == 1 else shift)


def host_tile(frames: np.ndarray, bs: int) -> np.ndarray:
    """(F, H, W) -> (F*R*C, bs, bs, 1), frame-major then row-major."""
    f, h, w = frames.shape
    x = frames.reshape(f, h // bs, bs, w // bs, bs).transpose(0, 1, 3, 2, 4)
    return np.ascontiguousarray(x.reshape(-1, bs, bs, 1))


def time_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    """Per-call time of ``fn`` launched from Python (CUDA events)."""
    for _ in range(warmup):
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
            labels={"stage0": stage0, "stage1": (stage0 != 0).astype(np.int32),
                    "stage2": map_to_stage2_v6(stage0)[0].astype(np.int32)},
        )

    root = WORK / "dataset"
    save_split(root, HW, bundle(64), bundle(N_VAL), "v6")
    return root


def v6_checkpoints(ckpts: dict, ab: str = "ab") -> list:
    """The per-stage checkpoint arguments of the CLIs; ``ab`` is ``"ab"``,
    ``"fgvc"`` or ``"ensemble"`` (a ``save_ensemble`` directory)."""
    args = ["--stage1-checkpoint", str(ckpts["stage1"]),
            "--stage2-checkpoint", str(ckpts["stage2"]),
            "--stage3-rect-checkpoint", str(ckpts["rect"])]
    if ab == "ensemble":
        return args + ["--stage3-ab-ensemble-dir", str(ckpts["ensemble"])]
    return args + ["--stage3-ab-checkpoint", str(ckpts[ab]),
                   "--ab-fgvc" if ab == "fgvc" else "--no-ab-fgvc"]


def quietly(main: Callable, argv: list) -> str:
    """Run a CLI's ``main``; return what it printed (its summary lines are
    read, not shown)."""
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        main(argv)
    return printed.getvalue()


def run_cli(dataset: Path, name: str, args: list, dev) -> dict:
    """The port's ``run_pipeline_eval`` on path a's dataset, bf16, batch 4096,
    with ``args`` (variant, serving options, checkpoints)."""
    out = WORK / "runs" / name
    argv = ["--dataset-dir", str(dataset), "--block-size", str(HW),
            "--output-dir", str(out), "--batch-size", str(BATCH),
            "--stage1-threshold", str(THRESHOLD), "--bf16", "--device", dev.type, *args]
    printed = quietly(run_pipeline_eval.main, argv)
    summary = json.loads(printed[printed.rindex("{\n"):])  # the CLI's last print
    metrics = json.loads((out / "pipeline_metrics_val.json").read_text())
    preds = np.load(out / "pipeline_predictions_val.npz")
    return {"samples": metrics["samples"],
            "blocks_per_s": metrics["throughput_superblocks_per_sec"],
            "capacity": metrics["capacity"], "overflow": summary.get("overflow"),
            "final": preds["predictions"], "stage1_prob": preds["stage1_prob"]}


def drive(path: str, plan, run_one) -> tuple:
    """One main path: counts set to 0, each ``(name, arg)`` of ``plan``
    run through ``run_one``, counts read (and the path's wall seconds
    emitted). Returns (runs, launches)."""
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    runs, before = [], dict(_build.launch_counts)
    for name, arg in plan:
        run = run_one(arg)
        run["name"] = name
        run["launches"] = {k: v - before[k] for k, v in _build.launch_counts.items()
                           if v - before[k]}
        before = dict(_build.launch_counts)
        runs.append(run)
    launches = dict(_build.launch_counts)
    emit("main_path", path=path, launches=launches, seconds=time.perf_counter() - t0)
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


def serving_plan(dataset: Path, ckpts: dict, unified_ckpt: Path, dev) -> list:
    """The second part of path a, in order: the calibration sweep, the gated
    pipeline at ``auto`` and 0.5, the unified family with each front, the
    plain graph with TTA and with the AB ensemble, then the tools."""
    calibration = WORK / "calibration"
    data = ["--dataset-dir", str(dataset), "--block-size", str(HW),
            "--batch-size", str(BATCH), "--bf16", "--device", dev.type]
    unified = ["--variant", "unified", "--unified-checkpoint", str(unified_ckpt), "--folded"]
    return [
        ("optimize_thresholds", ("tool", optimize_thresholds.main, data + [
            "--stage1-checkpoint", str(ckpts["stage1"]), "--output-dir", str(calibration)],
            ["threshold_sweep.csv", "threshold_summary.json",
             "stage1_calibrated_variables.npz"])),
        ("gated_auto", ("cli", ["--folded", "--capacity", "auto", "--capacity-margin",
                                str(CAPACITY_MARGIN), "--calibration-dir", str(calibration),
                                *v6_checkpoints(ckpts)])),
        ("gated_0.5", ("cli", ["--folded", "--capacity", "0.5", *v6_checkpoints(ckpts)])),
        *((f"unified_{mode}", ("cli", [*unified, "--fused-front", mode]))
          for mode in ("off", "on", "g1")),
        ("tta", ("cli", ["--tta", *v6_checkpoints(ckpts)])),
        ("ensemble", ("cli", v6_checkpoints(ckpts, "ensemble"))),
        # fp32: a certification of the folded graphs against the plain ones.
        # In bf16 the seeded random heads put ~5% of the labels within one
        # rounding of their decision boundary (94.5% agreement on 300 blocks on a CPU).
        ("certify_serving", ("tool", certify_serving.main, [a for a in data if a != "--bf16"] + [
            "--output-dir", str(WORK / "certify"), "--stage1-threshold", str(THRESHOLD),
            "--skip-int8", "--calibration-dir", str(calibration),
            "--unified-checkpoint", str(unified_ckpt), *v6_checkpoints(ckpts)],
            ["serving_certification.json", "serving_certification.md"])),
        ("compare_thresholds", ("tool", compare_thresholds.main, data + [
            "--output-dir", str(WORK / "operating_points"),
            "--thresholds", "0.45", "0.5", "0.55", *v6_checkpoints(ckpts)],
            ["operating_points.json", "operating_points.md"])),
        ("analyze_confusion", ("tool", analyze_confusion.main, data + [
            "--output-dir", str(WORK / "confusion"),
            "--stage2-checkpoint", str(ckpts["stage2"])], ["stage2_confusion.json"])),
    ]


def serve_one(dataset: Path, dev) -> Callable:
    """``run_one`` of path a: a ``run_pipeline_eval`` run, or a tool CLI whose
    files must appear (its output directory is the argument after
    ``--output-dir``)."""

    def run_one(arg):
        name, (kind, *rest) = arg
        if kind == "cli":
            return {**run_cli(dataset, name, rest[0], dev), "kind": kind}
        main, argv, files = rest
        out = Path(argv[argv.index("--output-dir") + 1])
        t0 = time.perf_counter()
        quietly(main, argv)
        missing = [f for f in files if not (out / f).exists()]
        if missing:
            raise AssertionError(f"{name} did not write {missing}")
        return {"kind": kind, "seconds": time.perf_counter() - t0, "out": out}

    return run_one


def gated_overflow_rows(run: dict) -> np.ndarray:
    """The rows the gated pipeline sent to the SPLIT fallback, from its own
    stage-1 probabilities: per batch, the passers outside the K rows that a
    stable descending sort puts first (``eval.gated``)."""
    prob = run["stage1_prob"]
    rows = np.zeros(len(prob), bool)
    k = max(1, int(-(-run["capacity"] * BATCH // 1)))
    for start in range(0, len(prob), BATCH):
        p = prob[start:start + BATCH]
        chosen = np.zeros(len(p), bool)
        chosen[np.argsort(-p, kind="stable")[:k]] = True
        rows[start:start + BATCH] = (p >= THRESHOLD) & ~chosen
    return rows


def check_serving_runs(runs: list, base: dict) -> None:
    """Path a's second part: serving runs against ``base`` (the per-stage
    ``off`` run) or the unified ``off`` run, the gated runs' fallback, and the
    certification's folded rows."""
    by_name = {run["name"]: run for run in runs}
    cli = [run for run in runs if run["kind"] == "cli"]
    report_runs("a_serving", [r for r in cli if not r["name"].startswith("unified")], base,
                lambda r: [])
    report_runs("a_serving_unified", [r for r in cli if r["name"].startswith("unified")],
                by_name["unified_off"], lambda r: FRONT_KERNELS.get(r["name"][8:], []))
    for name in ("gated_auto", "gated_0.5"):
        run = by_name[name]
        rows = gated_overflow_rows(run)
        kept = ~rows
        agree_kept = float((run["final"][kept] == base["final"][kept]).mean())
        emit("gated_cli", run=name, capacity=run["capacity"], overflow=run["overflow"],
             gate_rate=float((run["stage1_prob"] >= THRESHOLD).mean()),
             final_agrees_with_off=float((run["final"] == base["final"]).mean()),
             rows_outside_overflow_agree_with_off=agree_kept,
             blocks_per_s=run["blocks_per_s"])
        if run["overflow"] != int(rows.sum()):
            raise AssertionError(f"{name}: overflow {run['overflow']}, but {rows.sum()} "
                                 "passers lie outside the K rows")
        if agree_kept < 0.999:
            raise AssertionError(f"{name}: only {agree_kept:.5f} of the labels outside the "
                                 "overflow rows equal the dense run's")
        if (run["final"][rows] != 1).any():
            raise AssertionError(f"{name}: an overflow row is not SPLIT")
    for run in runs:
        if run["kind"] == "tool":
            emit("tool", run=run["name"], seconds=run["seconds"], launches=run["launches"],
                 files=sorted(f.name for f in run["out"].iterdir()))
    cert = json.loads((by_name["certify_serving"]["out"]
                       / "serving_certification.json").read_text())
    emit("certify_serving", capacity=cert["capacity"], rows=cert["rows"])
    rows = {row["variant"]: row for row in cert["rows"]}
    for name in ("folded", "unified(folded)"):
        if rows[name]["agreement_vs_flax"] < 0.99:
            raise AssertionError(f"certify_serving: the {name} row agrees with its "
                                 f"plain graph on {rows[name]['agreement_vs_flax']:.4f}")
    sweep = json.loads((WORK / "calibration" / "threshold_summary.json").read_text())
    emit("calibration", temperature=sweep["calibration"]["temperature"],
         ece_raw=sweep["calibration"]["ece_raw"],
         ece_calibrated=sweep["calibration"]["ece_calibrated"],
         best_f1_threshold=sweep["f1"]["threshold"])


def stacking_phase(ensemble_dir: Path, samples: np.ndarray, dev) -> None:
    """The AB ensemble's members on ``BATCH`` blocks, then the stacking
    meta-model fit on the card against the same fit on the CPU (both start
    from the same host-drawn weights), on labels that follow member 0."""
    members, _ = load_ensemble(ensemble_dir)
    images = samples[:BATCH].astype(np.float32) / 1023.0
    logits = stacked_member_logits(Stage3ABModel(), members, images, batch_size=BATCH,
                                   device=dev)
    labels = logits[0].argmax(-1)
    x = torch.as_tensor(_stacking_features(logits), dtype=torch.float32)
    y = torch.as_tensor(labels, dtype=torch.int64)
    objective = lambda w: float(_stacking_objective(torch.as_tensor(w), x, y, 1e-3))
    t0 = time.perf_counter()
    w_card = fit_stacking(logits, labels, steps=300, device=dev)
    seconds = time.perf_counter() - t0
    w_cpu = fit_stacking(logits, labels, steps=300, device="cpu")
    start = objective(torch.randn(w_cpu.shape, generator=torch.Generator().manual_seed(0)) * 0.01)
    fitted = {"card": objective(w_card), "cpu": objective(w_cpu)}
    emit("stacking", logits_shape=list(logits.shape), classes=int(len(np.unique(labels))),
         start_objective=start, fitted_objective=fitted, card_seconds=seconds)
    if not (np.isfinite(logits).all() and np.isfinite(w_card).all()):
        raise AssertionError("stacking: non-finite member logits or weights")
    if abs(fitted["card"] - fitted["cpu"]) > 1e-4 or fitted["card"] >= start:
        raise AssertionError(f"stacking: the card's fit reached {fitted['card']}, the "
                             f"CPU's {fitted['cpu']}, from {start}")


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
# Path d: the frame -> partition-tree cascade
# ---------------------------------------------------------------------------


def cascade_models(dev) -> dict:
    """``{size: {"stage1" | "stage2" | "rect" | "ab" | "unified": model}}``:
    each level of the cascade has its own seeded models, calibrated on
    structured blocks of its own size (a random ResNet calibrated at one block
    size saturates or dies at another; those forwards run on ``dev``), with the
    heads shifted to ``GATE_SHARE``, ``SPLIT_SHARE``, ``RECT_SHARE`` and
    ``AB_SHARE`` on probe blocks."""
    sbs = structured_luma(np.random.default_rng(SEED + 3), (512, 64, 64))
    out = {}
    for size in LEVEL_SIZES:
        blocks = torch.from_numpy(host_tile(sbs, size)[:512].astype(np.float32) / 1023.0)
        calib, probe = blocks[:256], blocks[256:]
        gen = torch.Generator().manual_seed(SEED + size)
        out[size] = {}
        for name, cls in (*STAGE_CLASSES.items(), ("unified", UnifiedV6Model)):
            model = seeded_model(cls, gen, calib, dev)
            with torch.no_grad():
                logits = model.to(dev)(probe.to(dev)).cpu().numpy()
            model.cpu()
            shares = {"stage1": GATE_SHARE, "stage2": SPLIT_SHARE[size],
                      "rect": RECT_SHARE, "ab": AB_SHARE}
            if name == "unified":
                parts = dict(zip(shares, split_unified_logits(logits)))
                for head, share in shares.items():
                    set_first_class_share(getattr(model, f"head_{head}"), parts[head], share)
            else:
                set_first_class_share(model.head, logits, shares[name])
            out[size][name] = model
    return out


def write_clip() -> Path:
    """Eight structured 1080p frames as a yuv420p10le file (about 50 MB)."""
    f, h, w = CLIP
    luma = structured_luma(np.random.default_rng(SEED + 4), (f, -(-h // 16) * 16, w))[:, :h]
    path = WORK / f"clip_{w}x{h}_30.yuv"
    path.parent.mkdir(parents=True, exist_ok=True)
    chroma = np.full(2 * (h // 2) * (w // 2), 512, "<u2").tobytes()
    with open(path, "wb") as out:
        for plane in luma:
            out.write(plane.astype("<u2").tobytes())
            out.write(chroma)
    return path


def write_cascade_checkpoints(models: dict) -> dict:
    """One directory per block size under the names the CLI looks for."""
    dirs = {}
    for size, by_name in models.items():
        dirs[size] = WORK / "tree_ckpt" / f"models_{size}"
        for name, model in by_name.items():
            stem = "unified" if name == "unified" else STAGE_CKPT[name]
            save_variables_npz(dirs[size] / f"{stem}_best_variables.npz",
                               to_jax_variables(model.state_dict()), compress=False)
    return dirs


def level_pipeline_models(models: dict, size: int) -> PipelineModels:
    return PipelineModels(*(models[size][name] for name in STAGE_CLASSES))


def run_tree_cli(clip: Path, dirs: dict, name: str, extra: list, dev) -> dict:
    """The port's ``predict_trees`` CLI over the whole clip, folded bf16, four
    frames a group. ``seconds`` is the CLI's own: each group from the upload of
    its superblocks to its trees on the host."""
    out = WORK / "trees" / name
    argv = ["--yuv", str(clip), "--frames", *map(str, range(CLIP[0])),
            "--output-dir", str(out), "--batch-size", str(BATCH),
            "--stage1-threshold", str(THRESHOLD), "--folded", "--bf16", "--no-ab-fgvc",
            "--frames-per-batch", str(FRAMES_PER_BATCH), "--device", dev.type, *extra]
    for size in LEVEL_SIZES:
        argv += [f"--models-{size}", str(dirs[size])]
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):  # its stats are read from the file
        predict_trees.main(argv)
    wall = time.perf_counter() - t0
    stats = json.loads((out / "tree_stats.json").read_text())
    files = [np.load(out / f"trees_frame{i}.npz") for i in range(CLIP[0])]
    overflow = [{k: v for k, v in stats[str(first)].items() if "overflow" in k}
                for first in range(0, CLIP[0], FRAMES_PER_BATCH)]
    return {"trees": np.concatenate([f["trees"] for f in files]), "frames": CLIP[0],
            "seconds": sum(st["seconds"] for st in stats.values()),
            "cli_wall_seconds": wall, "overflow": overflow,
            "mean_nodes": float(np.mean([st["mean_nodes"] for st in stats.values()]))}


def run_tree_library(models: dict, sbs: np.ndarray, front, dev) -> dict:
    """Path d4: ``predict_partition_trees`` over four frames' superblocks with
    K5 predictors (``use_pallas_groups=True``, no CLI flag in either package),
    built once per level; timed on the second call."""
    predictors = {
        size: make_v6_pipeline_folded(
            level_pipeline_models(models, size), THRESHOLD, float_dtype=torch.bfloat16,
            use_fused_front=front, use_pallas_groups=True, device=dev)
        for size in LEVEL_SIZES
    }
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        result = predict_partition_trees(sbs, predictors, BATCH, device=dev)
        seconds = time.perf_counter() - t0
    trees = result["trees"]
    return {"trees": trees, "frames": len(sbs) // FRAME_SBS, "seconds": seconds,
            "cli_wall_seconds": None, "overflow": [],
            "mean_nodes": float((trees >= 0).sum(axis=1).mean())}


def report_tree_runs(runs: list, expect: dict) -> None:
    """Emit each run of path d; check its trees and that the kernels
    ``expect[name]`` launched. ``tree_slots_equal_to_off`` compares with the
    dense ``--fused-front off`` run of the same model family (per-stage or
    unified) on the same frames."""
    by_name = {run["name"]: run for run in runs}
    for run in runs:
        trees = run["trees"]
        n = run["frames"] * FRAME_SBS
        base = by_name["unified_off" if run["name"].startswith("unified") else "off"]
        equal = float((trees == base["trees"][:n]).mean()) if trees.shape[0] == n else None
        emit("end_to_end", path="d_trees", run=run["name"], frames=run["frames"],
             superblocks=n, seconds=run["seconds"],
             frames_per_s=run["frames"] / run["seconds"],
             superblocks_per_s=n / run["seconds"], cli_wall_seconds=run["cli_wall_seconds"],
             launches=run["launches"], tree_slots_equal_to_off=equal,
             mean_nodes_per_tree=run["mean_nodes"], overflow=run["overflow"])
        if trees.shape != (n, 85) or trees.min() < -1 or trees.max() > 7:
            raise AssertionError(f"{run['name']}: bad trees {trees.shape}")
        if (trees[:, 0] < 0).any() or not 2.0 < run["mean_nodes"] < 60.0:
            raise AssertionError(f"{run['name']}: the trees do not vary "
                                 f"(mean nodes {run['mean_nodes']})")
        for kernel in expect.get(run["name"], []):
            if run["launches"].get(kernel, 0) == 0:
                raise AssertionError(f"{run['name']}: {kernel} never launched")


def check_gated_run(gated: dict, dense: dict) -> None:
    """Path d3. The gate is exact when K covers the live set, but its chunks
    hold other rows than the dense run's, and cuDNN may sum a row's bf16
    convolution in another order in another batch: a group without overflow
    must agree with the dense run on at least 99.9% of its slots."""
    rows = FRAMES_PER_BATCH * FRAME_SBS
    for g, overflow in enumerate(gated["overflow"]):
        part = slice(g * rows, (g + 1) * rows)
        share = float((gated["trees"][part] == dense["trees"][part]).mean())
        covered = all(v == 0 for v in overflow.values())
        emit("gated_cascade", group=g, level_capacity=list(LEVEL_CAPACITY), overflow=overflow,
             k_covers_the_live_set=covered, tree_slots_equal_to_dense=share)
        if len(overflow) != 3:
            raise AssertionError(f"gated run, group {g}: overflow counts {overflow}")
        if covered and share < 0.999:
            raise AssertionError(f"gated run, group {g}: no overflow, yet only "
                                 f"{share:.5f} of the slots equal the dense run's")


def check_tree_reference(models: dict, sbs: np.ndarray, dev) -> None:
    """The folded fp32 cascade on the card (fronts off/on/g1, and K5 with K1)
    against the plain nn.Module cascade on the CPU: every tree slot equal
    wherever each decision on the node's ancestry has a margin above 1e-3.
    Then, per level, the unified folded fp32 pipeline on the card against
    ``UnifiedV6Model``'s own forward on the CPU: stage-1 probability within
    1e-4, labels equal above the margin."""
    margins = {size: [] for size in LEVEL_SIZES}

    def plain_predictor(size):
        m = level_pipeline_models(models, size)

        @torch.inference_mode()
        def predict(images):
            x = images.to(torch.float32) / 1023.0
            s1 = torch.sigmoid(m.stage1(x))
            logits = [m.stage2(x), m.stage3_rect(x), m.stage3_ab(x)]
            tops = [lg.topk(2, dim=-1).values for lg in logits]
            margins[size].append(torch.stack(
                [(s1 - THRESHOLD).abs()] + [t[:, 0] - t[:, 1] for t in tops]).amin(0))
            preds = [lg.argmax(-1).to(torch.int32) for lg in logits]
            return {"final": v6_route((s1 >= THRESHOLD).to(torch.int32), *preds)}

        return predict

    want = predict_partition_trees(
        sbs, {size: plain_predictor(size) for size in LEVEL_SIZES}, BATCH, device="cpu")
    # a node's slot depends on its own decision and on every ancestor's
    sure, above = [], None
    for size, nodes in zip(LEVEL_SIZES, NODES_PER_LEVEL):
        own = torch.cat(margins[size]).reshape(len(sbs), nodes) > 1e-3
        above = own if above is None else own & above.repeat_interleave(4, dim=1)
        sure.append(above)
    sure = torch.cat(sure, dim=1).numpy()
    for mode, groups in ((False, False), (True, False), ("g1", False), (True, True)):
        got = predict_partition_trees(sbs, {
            size: make_v6_pipeline_folded(
                level_pipeline_models(models, size), THRESHOLD, float_dtype=torch.float32,
                use_fused_front=mode, use_pallas_groups=groups, device=dev)
            for size in LEVEL_SIZES}, BATCH, device=dev)
        mismatches = int((got["trees"] != want["trees"])[sure].sum())
        emit("reference", path="d_trees", fused_front=mode, pallas_groups=groups,
             superblocks=len(sbs), guarded_share=float(sure.mean()),
             slots_equal=float((got["trees"] == want["trees"]).mean()),
             mismatches_above_margin=mismatches,
             mean_nodes_per_tree=float((want["trees"] >= 0).sum(axis=1).mean()))
        if mismatches or sure.mean() < 0.5:
            raise AssertionError(f"folded fp32 cascade ({mode}, groups={groups}) "
                                 "disagrees with the plain cascade")

    blocks = {size: host_tile(sbs, size)[:256] for size in LEVEL_SIZES}
    for size, mode in itertools.product(LEVEL_SIZES, (False, True, "g1")):
        model, images = models[size]["unified"], torch.from_numpy(blocks[size])
        want = make_unified_pipeline(model, THRESHOLD, device="cpu")(images)
        with torch.inference_mode():
            s1, s2, rect, ab = split_unified_logits(model(images.float() / 1023.0))
        tops = [lg.topk(2, dim=-1).values for lg in (s2, rect, ab)]
        sure = torch.stack([(torch.sigmoid(s1) - THRESHOLD).abs()]
                           + [t[:, 0] - t[:, 1] for t in tops]).amin(0) > 1e-3
        got = make_unified_pipeline_folded(
            model, THRESHOLD, float_dtype=torch.float32, use_fused_front=mode,
            device=dev)(images.to(dev))
        prob_err = (got["stage1_prob"].cpu() - want["stage1_prob"]).abs().max().item()
        mismatches = int((got["final"].cpu() != want["final"])[sure].sum())
        emit("reference", path="d_unified", block_size=size, fused_front=mode,
             samples=len(images), stage1_prob_max_abs_err=prob_err,
             guarded_share=float(sure.float().mean()), mismatches_above_margin=mismatches)
        if prob_err > 1e-4 or mismatches:
            raise AssertionError(f"unified folded fp32 ({size} px, {mode}) disagrees "
                                 "with the model's own forward")


def check_kernels_at_cascade_shapes(folded, gen, dev) -> None:
    """K1, K2 and K5 in bf16, the cascade's dtype, against their plain versions
    at the row counts of ``CASCADE_ROWS``."""
    bf16 = torch.bfloat16
    wg = tuple(t.to(dev) for t in rg.pack_group12_weights(folded, bf16))
    stream = rg.group12_conv_stream(wg)
    for e, rows in ((e, r) for e, rs in CASCADE_ROWS.items() for r in rs):
        hw = 4 * e
        if ff.supports_extent(hw):
            x = (torch.randint(0, 1024, (rows, hw, hw, 1), generator=gen).float()
                 / 1023.0).to(dev, bf16)
            for name in ("fused_front", "fused_front_g1"):
                kern, plain, args = front_args(name, folded, bf16, dev)
                got = kern(x, *args)
                torch.cuda.synchronize()
                want = plain(x, *args)
                compare(name, got, want, rel_tol(name, bf16, want), hw=hw, batch=rows,
                        shape="cascade", dtype=str(bf16))
        x = stem_output(folded, gen, rows, hw, dev).to(bf16)
        got = rg.fused_group12(x, wg, stream)
        torch.cuda.synchronize()
        want = rg.fused_group12_reference(x, wg)
        compare("fused_group12", got, want, rel_tol("fused_group12", bf16, want),
                extent=e, batch=rows, shape="cascade", dtype=str(bf16))


# ---------------------------------------------------------------------------
# Phase 6: one predict per mode
# ---------------------------------------------------------------------------

PREDICT_MODES = {  # name: (use_fused_front, use_pallas_groups)
    "off": (False, False), "on": (True, False), "g1": ("g1", False),
    "groups_off": (False, True), "groups_on": (True, True),
}


def trace_calls(fn: Callable, repeats: int = 3) -> dict:
    """Per call of ``fn``, from a ``torch.profiler`` trace of ``repeats`` calls:
    the kernels on the device, the device's busy ms (the union of the kernels'
    intervals) and the host's launch calls. The device fields are None if the
    trace shows no device activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(repeats):
            fn()
        torch.cuda.synchronize()
    events = prof.events()
    spans = sorted((e.time_range.start, e.time_range.end) for e in events
                   if e.device_type == DeviceType.CUDA)
    launch_calls = sum(e.device_type == DeviceType.CPU and "LaunchKernel" in e.name
                       for e in events) / repeats
    if not spans:
        return {"kernels": None, "device_busy_ms": None, "host_launch_calls": launch_calls}
    busy, (lo, hi) = 0.0, spans[0]
    for start, end in spans[1:]:
        if start > hi:
            busy, lo, hi = busy + hi - lo, start, end
        else:
            hi = max(hi, end)
    busy += hi - lo
    return {"kernels": len(spans) / repeats, "device_busy_ms": busy / 1e3 / repeats,
            "host_launch_calls": launch_calls}


def launched_by(fn: Callable) -> dict:
    """The port's kernels that one call of ``fn`` launches."""
    before = dict(_build.launch_counts)
    fn()
    return {k: v - before[k] for k, v in _build.launch_counts.items() if v - before[k]}


def predict_phase(models: PipelineModels, samples: np.ndarray, dev, smi: str,
                  capacities: dict) -> None:
    """CUDA-event ms of one 4,096-block bf16 predict on a batch on the card:
    six samples per mode in ABC...CBA turns (each the mean of 10 predicts;
    ``predict_ms`` is their median), with the port's kernels launched per
    predict and the trace's kernel count, busy time and idle share. The
    modes are ``PREDICT_MODES`` and the folded gated pipeline at each of
    ``capacities`` (name: capacity)."""
    batch = torch.from_numpy(samples[:BATCH]).to(dev)
    predicts = {
        name: make_v6_pipeline_folded(models, THRESHOLD, float_dtype=torch.bfloat16,
                                      use_fused_front=front, use_pallas_groups=groups,
                                      device=dev)
        for name, (front, groups) in PREDICT_MODES.items()
    }
    for name, capacity in capacities.items():
        predicts[name] = make_v6_pipeline_gated(
            models, capacity, THRESHOLD, input_dtype=torch.bfloat16, folded=True, device=dev)
    for _ in range(2):  # warm-up: cuDNN plans, the allocator, the clocks
        for predict in predicts.values():
            for _ in range(10):
                predict(batch)
    names = list(predicts)
    samples_ms = {name: [] for name in names}
    for name in (names + names[::-1]) * 3:
        samples_ms[name].append(time_ms(lambda: predicts[name](batch), iters=10))
    for name in names:
        launched = launched_by(lambda: predicts[name](batch))
        trace = trace_calls(lambda: predicts[name](batch))
        ms = float(np.median(samples_ms[name]))
        busy = trace["device_busy_ms"]
        emit("predict", mode=name, batch=BATCH, hw=HW, dtype="bfloat16", predict_ms=ms,
             samples_ms=samples_ms[name], port_kernels_per_predict=launched,
             idle_share=None if busy is None else max(0.0, 1.0 - busy / ms),
             nvidia_smi=smi, kernels_per_predict=trace["kernels"],
             device_busy_ms=busy,
             host_launch_calls_per_predict=trace["host_launch_calls"])


LEVEL_MODES = {  # name: (family, use_fused_front, use_pallas_groups)
    "off": ("stages", False, False), "g1": ("stages", "g1", False),
    "groups_on": ("stages", True, True), "unified_g1": ("unified", "g1", False),
}


def cascade_levels_phase(models: dict, sbs: np.ndarray, dev, smi: str) -> None:
    """The cascade level by level for one group of four frames (2,040
    superblocks on the card), bf16, dense: per mode and block size the CUDA-event
    ms of the level's ``run_pipeline_batched`` (median of three), the port's
    kernels it launches, and from a ``torch.profiler`` trace of one run its
    kernel count, the device's busy ms and the idle share."""
    sbs_dev = torch.from_numpy(sbs).to(dev).view(torch.int16)
    for mode, (family, front, groups) in LEVEL_MODES.items():
        for size in LEVEL_SIZES:
            if family == "unified":
                predict = make_unified_pipeline_folded(
                    models[size]["unified"], THRESHOLD, float_dtype=torch.bfloat16,
                    use_fused_front=front, device=dev)
            else:
                predict = make_v6_pipeline_folded(
                    level_pipeline_models(models, size), THRESHOLD,
                    float_dtype=torch.bfloat16, use_fused_front=front,
                    use_pallas_groups=groups, device=dev)
            blocks = quad_tile_on_device(sbs_dev, size).view(torch.uint16)
            rows = blocks.shape[0]
            level_batch = min(BATCH, -(-rows // 256) * 256)  # as the cascade sets it

            def run_level():
                return run_pipeline_batched(predict, blocks, level_batch, dev,
                                            as_numpy=False)

            run_level()  # warm-up: cuDNN plans at this level's shapes
            samples = [time_ms(run_level, iters=1, warmup=0) for _ in range(3)]
            launched = launched_by(run_level)
            trace = trace_calls(run_level, repeats=1)
            ms = float(np.median(samples))
            busy = trace["device_busy_ms"]
            emit("cascade_level", mode=mode, block_size=size, rows=rows,
                 chunks=-(-rows // level_batch), dtype="bfloat16", level_ms=ms,
                 samples_ms=samples, port_kernels=launched,
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
    for e, rows in ((16, 510), (16, 2040), (8, 2040)):  # levels 64 and 32 px of path d
        xg = stem_output(folded, gen, rows, 4 * e, dev).to(bf16)
        cases.append(TimingCase(
            "fused_group12", lambda xg=xg: rg.fused_group12(xg, wg, stream),
            lambda xg=xg: rg.fused_group12_reference(xg, wg), None,
            tensor_bytes(xg, *wg, rg.fused_group12(xg, wg, stream)),
            rows * group12_flops(e), bf16,
            {"batch": rows, "extent": e, "dtype": "bfloat16"}, False))
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
    check_kernels_at_cascade_shapes(folded, gen, dev)

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
    def front(mode, ab="ab"):
        return ["--folded", "--fused-front", mode, *v6_checkpoints(ckpts, ab)]

    cli_runs, cli_launches = drive("a_cli", [
        (name, (name, args)) for name, args in (
            ("off_warmup", front("off")), ("off", front("off")), ("on", front("on")),
            ("g1", front("g1")), ("on_fgvc", front("on", "fgvc")))
    ], lambda arg: run_cli(dataset, *arg, dev))
    base = cli_runs[1]
    report_runs("a_cli", cli_runs, base,
                lambda r: FRONT_KERNELS.get(r["name"].split("_")[0], []))

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

    # path d: the tree cascade on eight 1080p frames, each level with its own
    # seeded models; first its fp32 reference check on 256 superblocks
    t0 = time.perf_counter()
    tree_models = cascade_models(dev)
    clip, tree_dirs = write_clip(), write_cascade_checkpoints(tree_models)
    clip_sbs = tile_frames(read_y_frames_batch(
        clip, Yuv420p10Geometry(CLIP[2], CLIP[1]), range(FRAMES_PER_BATCH)), 64)[0]
    emit("tree_setup", seconds=time.perf_counter() - t0, clip=str(clip.relative_to(ROOT)),
         clip_bytes=clip.stat().st_size, superblocks_per_frame=FRAME_SBS,
         models="4 stage models + 1 unified model per block size, each calibrated "
                "at its own size")
    check_tree_reference(tree_models, clip_sbs[:256], dev)

    def run_tree(arg):
        kind, name, extra = arg
        if kind == "cli":
            return run_tree_cli(clip, tree_dirs, name, extra, dev)
        return run_tree_library(tree_models, clip_sbs, extra, dev)

    fronts = [("off", ["--fused-front", "off"]), ("on", ["--fused-front", "on"]),
              ("g1", ["--fused-front", "g1"])]
    tree_runs, tree_launches = drive("d_trees", [
        ("off_warmup", ("cli", "off_warmup", fronts[0][1])),
        *((name, ("cli", name, extra)) for name, extra in fronts),
        *((f"unified_{name}", ("cli", f"unified_{name}", ["--unified", *extra]))
          for name, extra in fronts),
        ("gated", ("cli", "gated", ["--fused-front", "off", "--level-capacity",
                                    *map(str, LEVEL_CAPACITY)])),
        ("groups_off", ("library", "groups_off", False)),
        ("groups_on", ("library", "groups_on", True)),
    ], run_tree)
    by_name = {run["name"]: run for run in tree_runs}
    report_tree_runs(tree_runs, {
        "on": ["fused_front"], "g1": ["fused_front_g1"],
        "unified_on": ["fused_front"], "unified_g1": ["fused_front_g1"],
        "groups_off": ["fused_group12"], "groups_on": ["fused_group12", "fused_front"],
    })
    check_gated_run(by_name["gated"], by_name["off"])
    for name in ("fused_front", "fused_front_g1", "fused_group12"):
        if tree_launches[name] == 0:
            raise AssertionError(f"{name} was never launched by the tree cascade")

    # path a, second part: the rest of v6 serving on path a's dataset, with
    # three seeded AB members as an ensemble and path d's 16 px unified model
    ckpts["ensemble"] = WORK / "ensemble"
    members = torch.Generator().manual_seed(SEED + 5)
    save_ensemble(ckpts["ensemble"], [
        to_jax_variables(seeded_model(Stage3ABModel, members, calib).state_dict())
        for _ in range(ENSEMBLE_MEMBERS)])
    plan = serving_plan(dataset, ckpts, tree_dirs[HW] / "unified_best_variables.npz", dev)
    serving_runs, serving_launches = drive(
        "a_serving", [(name, (name, spec)) for name, spec in plan], serve_one(dataset, dev))
    check_serving_runs(serving_runs, base)
    stacking_phase(ckpts["ensemble"], val.samples, dev)

    launches = {k: cli_launches[k] + k5_launches[k] + api_launches[k] + tree_launches[k]
                + serving_launches[k] for k in _build.KERNELS}
    for name in KERNELS:
        if launches[name] == 0:
            raise AssertionError(f"{name} was never launched by a main path")

    predict_phase(plain, val.samples, dev, smi, {
        name: next(r["capacity"] for r in serving_runs if r["name"] == name)
        for name in ("gated_auto", "gated_0.5")})
    cascade_levels_phase(tree_models, clip_sbs, dev, smi)

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
