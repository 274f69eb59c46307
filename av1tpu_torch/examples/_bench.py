"""What the sweep examples time with: the port's own copies of the three
``bench.py`` helpers they import (``_build_models``, ``_time_predict``,
``bench_tree_cascade``, under the same names), and an operation count in
place of XLA's ``cost_analysis()``.

:func:`flops_per_block` counts the operations one block needs in the folded
v6 pipeline, its four stages dense, from the layer shapes of the stage
models: every convolution with only the taps that fall inside its input (XLA
counts convolutions so), the SE and spatial-attention products and the MLP
heads, each multiply-add as two. The elementwise work (biases, ReLUs,
sigmoids, pooling, the bf16 converts) is left out; XLA counts it at one per
element, which puts this count under XLA's of the JAX folded pipeline in
bf16, by 1.2% at 64 px and 2.6% at 8 px. A counter that reads the arguments of
the convolutions (``torch.utils.flop_counter``) cannot count so: the port
pads explicitly before each convolution, and at the 1x1 and 2x2 extents of
layers 3 and 4 eight of a 3x3 window's nine taps are padding.
:func:`backbone_flops` gives the same count part by part (the stem, each
layer group, each SE), from which the operation bounds of the kernels that
compute those parts come.

MFU is ``flops_per_block x blocks/s / PEAK_FLOPS`` on the card, and ``None``
on the CPU.
"""
from __future__ import annotations

import functools
import subprocess
import time
from typing import Callable, Dict, Mapping, Optional

import numpy as np
import torch
from torch import nn

from av1tpu_torch.codec.tree import LEVEL_SIZES, NODES_PER_LEVEL
from av1tpu_torch.eval import PipelineModels, make_v6_pipeline_folded, predict_partition_trees
from av1tpu_torch.examples._common import synchronize
from av1tpu_torch.models import Stage1Model, Stage2Model, Stage3ABModel, Stage3RectModel
from av1tpu_torch.models.jax_import import load_jax_variables
from av1tpu_torch.models.layers import SpatialConv, same_padding
from av1tpu_torch.utils.initialization import init_on_cpu

PEAK_FLOPS = 989e12  # H100 SXM, dense bf16 on the tensor cores
WARMUP_ITERS = 5
TIMED_ITERS = 50  # bench.py's default count of timed calls
STAGE_CLASSES = (Stage1Model, Stage2Model, Stage3RectModel, Stage3ABModel)


def _build_models(device="cuda") -> PipelineModels:
    """The four v6 stage models at the published widths, drawn with flax's
    initializers by ``init_on_cpu`` from seeds 1-4 on a ``(2, 16, 16, 1)``
    sample, as ``bench.py`` draws them, then placed on ``device``. The
    weights stay fp32, as ``bench.py``'s flax parameters do; a pipeline's
    ``float_dtype`` casts them after folding. The draws come from a torch
    ``Generator``: the same initializers as the JAX package's, not its
    bits."""
    sample = torch.zeros((2, 16, 16, 1))

    def build(cls, seed):
        model = load_jax_variables(cls(), init_on_cpu(cls(), seed, sample))
        return model.to(device).eval()

    return PipelineModels(*(build(cls, seed) for seed, cls in enumerate(STAGE_CLASSES, 1)))


def seeded_blocks(batch: int, block_px: int) -> np.ndarray:
    """``_time_predict``'s uint16 input, ``bench.py``'s draw."""
    return np.random.default_rng(0).integers(
        0, 1024, size=(batch, block_px, block_px, 1)).astype(np.uint16)


def seeded_superblocks(n_superblocks: int) -> np.ndarray:
    """``bench_tree_cascade``'s ``(n, 64, 64)`` uint16 superblocks, ``bench.py``'s
    draw."""
    return np.random.default_rng(3).integers(
        0, 1024, size=(n_superblocks, 64, 64)).astype(np.uint16)


def _valid_taps(extent: int, kernel: int, stride: int, pad: tuple) -> tuple:
    """``(output extent, kernel taps summed over the outputs that fall inside
    the input)`` along one axis."""
    lo, hi = pad
    out = (extent + lo + hi - kernel) // stride + 1
    taps = sum(1 for o in range(out) for t in range(kernel)
               if 0 <= o * stride - lo + t < extent)
    return out, taps


def _conv_flops(conv: nn.Conv2d, extent: int) -> tuple:
    """``(operations per block, output extent)`` of a square conv at ``extent``:
    XLA "SAME" padding for a ``SpatialConv``, its own padding otherwise."""
    k, s = conv.kernel_size[0], conv.stride[0]
    pad = (same_padding(extent, k, s) if isinstance(conv, SpatialConv)
           else (conv.padding[0], conv.padding[0]))
    out, taps = _valid_taps(extent, k, s, pad)
    return 2 * conv.in_channels // conv.groups * conv.out_channels * taps * taps, out


def _dense_flops(layers) -> int:
    return sum(2 * m.in_features * m.out_features for m in layers if isinstance(m, nn.Linear))


@functools.lru_cache(maxsize=None)
def _v6_stages() -> tuple:
    with torch.device("meta"):  # shapes only
        return tuple(cls() for cls in STAGE_CLASSES)


def backbone_flops(px: int, backbone: Optional[nn.Module] = None) -> Dict[str, int]:
    """Operations of one ``px`` block in each part of a v6 ``ImprovedBackbone``
    (default: stage 1's at the published widths), valid taps only: ``stem``
    (the 7x7/2 conv), ``layer1``-``layer4`` (their convs, downsample
    included), ``se1``-``se4`` (the SE products) and ``attn``."""
    b = _v6_stages()[0].backbone if backbone is None else backbone
    parts = {}
    parts["stem"], e = _conv_flops(b.conv1, px)
    pool = b.maxpool
    e = (e + 2 * pool.padding - pool.kernel_size) // pool.stride + 1
    for g in range(1, 5):
        total = 0
        for block in getattr(b, f"layer{g}"):
            conv1, e_out = _conv_flops(block.conv1, e)
            conv2, _ = _conv_flops(block.conv2, e_out)
            total += conv1 + conv2
            if block.downsample is not None:
                total += _conv_flops(block.downsample[0], e)[0]
            e = e_out
        parts[f"layer{g}"] = total
        parts[f"se{g}"] = _dense_flops(getattr(b, f"se{g}").excitation)
    parts["attn"] = _conv_flops(b.spatial_attn.conv, e)[0]
    return parts


def _stage_flops(model: nn.Module, px: int) -> int:
    """One plain v6 stage (``ImprovedBackbone`` + ``MLPHead``) on one block."""
    return sum(backbone_flops(px, model.backbone).values()) + _dense_flops(model.head.head)


def flops_per_block(px: int) -> int:
    """Operations of one ``px`` block through the folded v6 pipeline, four
    stages dense (see the module docstring), read from the layers of the v6
    stage models at the published widths."""
    return sum(_stage_flops(m, px) for m in _v6_stages())


def _mfu(flops_per_s: float, device: torch.device) -> Optional[float]:
    return flops_per_s / PEAK_FLOPS if device.type == "cuda" else None


def _time_predict(predict: Callable, batch: int, block_px: int, iters: int = TIMED_ITERS,
                  device="cuda") -> tuple:
    """``(blocks/s, flops_per_block, mfu)`` of ``predict`` on ``batch`` seeded
    ``block_px`` blocks on ``device``: ``WARMUP_ITERS`` calls, then ``iters``
    timed ones under a host clock that waits for the card at both ends."""
    device = torch.device(device)
    images = torch.from_numpy(seeded_blocks(batch, block_px)).to(device)
    for _ in range(WARMUP_ITERS):
        predict(images)
    synchronize(device)
    start = time.perf_counter()
    for _ in range(iters):
        predict(images)
    synchronize(device)
    throughput = batch * iters / (time.perf_counter() - start)
    flops = flops_per_block(block_px)
    return throughput, flops, _mfu(flops * throughput, device)


def bench_tree_cascade(models: PipelineModels, dtype, n_superblocks: int = 512,
                       iters: int = 20, predict: Optional[Callable] = None,
                       predict_by_size: Optional[Mapping[int, Callable]] = None,
                       device="cuda") -> Dict[str, object]:
    """Trees/s of the 64->32->16->8 cascade (``predict_partition_trees``)
    over ``n_superblocks`` seeded superblocks resident on ``device``, with
    ``predict`` at every level (default: the folded pipeline in ``dtype``)
    or ``predict_by_size[size]`` at each. Its batch of 64 x n rows makes
    each level ONE predict on all of its rows (n, 4n, 16n, 64n). ``mfu``
    sums the four levels' ``flops_per_block x nodes`` per tree (card
    only)."""
    device = torch.device(device)
    if predict is None and predict_by_size is None:
        predict = make_v6_pipeline_folded(models, stage1_threshold=0.45,
                                          float_dtype=dtype, device=device)
    level_predictors = (predict_by_size if predict_by_size is not None
                        else dict.fromkeys(LEVEL_SIZES, predict))

    def cascade(sbs):
        return predict_partition_trees(sbs, level_predictors, batch_size=64 * n_superblocks,
                                       as_numpy=False, device=device)["trees"]

    sbs = torch.from_numpy(seeded_superblocks(n_superblocks)).to(device)
    for _ in range(WARMUP_ITERS):
        cascade(sbs)
    synchronize(device)
    start = time.perf_counter()
    for _ in range(iters):
        cascade(sbs)
    synchronize(device)
    trees_per_sec = n_superblocks * iters / (time.perf_counter() - start)
    flops = sum(flops_per_block(size) * nodes
                for size, nodes in zip(LEVEL_SIZES, NODES_PER_LEVEL))
    mfu = _mfu(flops * trees_per_sec, device)
    return {
        "trees_per_sec": round(trees_per_sec, 1),
        "mfu": round(mfu, 4) if mfu else None,
        "superblocks_per_dispatch": n_superblocks,
    }


def describe_device(device) -> str:
    """One line naming where a sweep runs: the card's name and, from
    ``nvidia-smi``, its name and power limit."""
    device = torch.device(device)
    if device.type != "cuda":
        return f"device: {device.type}"
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60,
        ).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError) as exc:
        smi = f"nvidia-smi not read: {type(exc).__name__}"
    return f"device: {torch.cuda.get_device_name(device)} ({smi})"


def mfu_cell(mfu: Optional[float]) -> str:
    """A table's MFU cell: a percentage on the card, else "not measured"."""
    return "not measured" if mfu is None else f"{mfu * 100:.1f}%"


__all__ = ["PEAK_FLOPS", "TIMED_ITERS", "WARMUP_ITERS", "_build_models", "_time_predict",
           "backbone_flops", "bench_tree_cascade", "describe_device", "flops_per_block",
           "mfu_cell", "seeded_blocks", "seeded_superblocks"]
