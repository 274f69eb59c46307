"""Fused backbone front: kernels K1 and K2 (``csrc/fused_front.cu``).

K1 ``fused_front`` replaces ``av1tpu.kernels.fused_front.make_fused_front``:
stem 7x7/2 conv (pad 3) + fp32 bias + relu + 3x3/2 max-pool (pad 1).
K2 ``fused_front_g1`` replaces ``make_fused_front_g1``: K1, then both
layer-1 blocks and SE1. Both map NHWC ``(B, hw, hw, 1)`` to
``(B, hw/4, hw/4, 64)`` for hw in {8, 16}, in fp32 or bf16.

On an H100 K2 is bound by operations (four 64x64 3x3 convs per pooled
position, ~2000 FLOP per byte of device memory) and K1 by bytes (its output).
In bf16, the serving dtype, both CUDA kernels run on ``wgmma``: the stem as an
implicit GEMM whose K axis is the 7x7 window laid out as 8 rows of 8 taps
(:func:`stem_gemm_weight`, :func:`stem_gemm_index`) on 64-row tiles
(:func:`stem_tile_rows`), its input read by one TMA box a group of samples
(:func:`x_box`), and K2's four convs through the conv routine it shares with
K5 (``csrc/conv_wgmma.cuh``), reading ``conv_w`` by TMA through a map encoded
once per weight tensor, with K5's rows (position-major) and tap table
(``resnet_group.group12_tile_taps``). In fp32, the parity mode, both run
direct convolutions on the CUDA cores.

Numerics follow the TPU kernels: every sum and every bias add is fp32. K2
keeps fp32 between its stages and rounds to the weight dtype wherever the TPU
kernel casts a matmul operand: each conv input, and in SE1 the block output
before the spatial mean, the mean, the hidden vector, the gate, and the two SE
matrices. In fp32 each of those casts is the identity.

Each wrapper runs its plain PyTorch twin (``*_reference``) only for a
tensor on the CPU; for a CUDA tensor it launches the kernel or raises. A
launch adds one to ``launch_counts[name]`` (a view of ``_build.launch_counts``).

Weight layouts the kernels take: stem ``(49, 64)`` tap-major, in the
activation dtype; layer-1 convs ``(4, 9, 64, 64)`` as [conv][tap][ci][co]
in the activation dtype; biases ``(64,)`` / ``(4, 64)`` fp32; SE1 ``d0``
``(4, 64)`` and ``d1`` ``(64, 4)`` fp32 (Linear layouts) holding values of
the activation dtype (:func:`g1_weights` rounds them once).
"""
from __future__ import annotations

import ctypes
from typing import Callable, Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from av1tpu_torch.kernels import _build
from av1tpu_torch.kernels import resnet_group as rg

C = 64
SE_HIDDEN = C // 16
_DTYPES = (torch.float32, torch.bfloat16)

launch_counts = _build.CountsView(("fused_front", "fused_front_g1"))


def reset_launch_counts() -> None:
    _build.reset_launch_counts(launch_counts)


def supports_extent(hw: int) -> bool:
    """The kernels are built for 8 and 16 px blocks."""
    return hw in (8, 16)


# ---------------------------------------------------------------------------
# Plain PyTorch versions (same numerics: fp32 sums, fp32 bias)
# ---------------------------------------------------------------------------


def _stem_pool_f32(x, stem_w, stem_b):
    w = stem_w.float().T.reshape(C, 1, 7, 7)
    y = F.conv2d(x.float().permute(0, 3, 1, 2), w, stride=2, padding=3)
    y = torch.relu(y + stem_b.float()[None, :, None, None])
    return F.max_pool2d(y, 3, stride=2, padding=1)  # NCHW fp32


def fused_front_reference(x, stem_w, stem_b):
    """Plain K1: ``(B, hw, hw, 1)`` -> ``(B, hw/4, hw/4, 64)`` in x's dtype."""
    y = _stem_pool_f32(x, stem_w, stem_b)
    return y.permute(0, 2, 3, 1).to(x.dtype).contiguous()


def fused_front_g1_reference(x, stem_w, stem_b, conv_w, conv_b, se_d0, se_d1):
    """Plain K2: K1, layer1_0, layer1_1, SE1. fp32 between stages and in every
    sum; each matmul operand rounded to the weight dtype, as the TPU kernel
    casts it."""
    z = _stem_pool_f32(x, stem_w, stem_b)

    def rnd(a):
        return a.to(conv_w.dtype).float()

    def conv(a, i):
        w = conv_w[i].float().reshape(3, 3, C, C).permute(3, 2, 0, 1)
        return F.conv2d(rnd(a), w, padding=1) + conv_b[i].float()[None, :, None, None]

    for first in (0, 2):
        h = torch.relu(conv(z, first))
        z = torch.relu(conv(h, first + 1) + z)
    mean = rnd(z).mean(dim=(2, 3))
    s = torch.relu(rnd(mean) @ rnd(se_d0).T)
    s = torch.sigmoid(rnd(s) @ rnd(se_d1).T)
    z = z * rnd(s)[:, :, None, None]
    return z.permute(0, 2, 3, 1).to(x.dtype).contiguous()


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------


def _check(name, t, shape, dtype, device):
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def _check_input(x):
    if x.dim() != 4 or x.shape[3] != 1 or x.shape[1] != x.shape[2]:
        raise ValueError(f"x: expected (B, hw, hw, 1), got {tuple(x.shape)}")
    if not supports_extent(int(x.shape[1])):
        raise ValueError(f"x: extent {x.shape[1]} not in (8, 16)")
    if x.dtype not in _DTYPES:
        raise ValueError(f"x: dtype {x.dtype} not in {_DTYPES}")
    if x.shape[0] == 0:
        raise ValueError("x: empty batch")
    if not x.is_contiguous():
        raise ValueError("x: must be contiguous")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"x: unsupported device {x.device}")


_MAPS: Dict[Tuple[torch.device, int], ctypes.Array] = {}  # conv_w maps by address


def _conv_w_map(conv_w) -> ctypes.Array:
    """K2's TMA map of ``conv_w``, encoded at its first use: a map holds the
    address and the geometry, never the values."""
    key = (conv_w.device, conv_w.data_ptr())
    found = _MAPS.get(key)
    if found is None:
        found = ctypes.create_string_buffer(128)
        _build.check_launch("fused_front_g1_encode_map",
                            _build.load_kernels().av1_fused_front_g1_encode_map(
                                conv_w.data_ptr(), found))
        _MAPS[key] = found
    return found


def _out_like(x):
    hw = int(x.shape[1])
    return torch.empty((x.shape[0], hw // 4, hw // 4, C), dtype=x.dtype,
                       device=x.device)


def fused_front(x, stem_w, stem_b):
    """K1 on ``x`` ``(B, hw, hw, 1)``; see the module docstring for layouts."""
    _check_input(x)
    _check("stem_w", stem_w, (49, C), x.dtype, x.device)
    _check("stem_b", stem_b, (C,), torch.float32, x.device)
    if x.device.type == "cpu":
        return fused_front_reference(x, stem_w, stem_b)
    out = _out_like(x)
    _build.launch(
        "fused_front", x.data_ptr(), stem_w.data_ptr(), stem_b.data_ptr(),
        out.data_ptr(), int(x.shape[0]), int(x.shape[1]),
        int(x.dtype == torch.bfloat16), _build.stream_of(x),
    )
    return out


def fused_front_g1(x, stem_w, stem_b, conv_w, conv_b, se_d0, se_d1):
    """K2 on ``x`` ``(B, hw, hw, 1)``; see the module docstring for layouts."""
    _check_input(x)
    _check("stem_w", stem_w, (49, C), x.dtype, x.device)
    _check("stem_b", stem_b, (C,), torch.float32, x.device)
    _check("conv_w", conv_w, (4, 9, C, C), x.dtype, x.device)
    _check("conv_b", conv_b, (4, C), torch.float32, x.device)
    _check("se_d0", se_d0, (SE_HIDDEN, C), torch.float32, x.device)
    _check("se_d1", se_d1, (C, SE_HIDDEN), torch.float32, x.device)
    if x.device.type == "cpu":
        return fused_front_g1_reference(x, stem_w, stem_b, conv_w, conv_b,
                                        se_d0, se_d1)
    out = _out_like(x)
    maps = taps = None  # the bf16 kernel's: conv_w's map, layer 1's tap table
    if x.dtype == torch.bfloat16:
        maps, taps = _conv_w_map(conv_w), rg._tile_taps(int(x.shape[1]) // 4)
    _build.launch(
        "fused_front_g1", x.data_ptr(), stem_w.data_ptr(), stem_b.data_ptr(),
        conv_w.data_ptr(), conv_b.data_ptr(), se_d0.data_ptr(),
        se_d1.data_ptr(), maps, taps, out.data_ptr(), int(x.shape[0]),
        int(x.shape[1]), int(x.dtype == torch.bfloat16), _build.stream_of(x),
    )
    return out


# ---------------------------------------------------------------------------
# Builders (the JAX package's make_* signatures)
# ---------------------------------------------------------------------------


def stem_weights(stem_kernel, stem_bias, float_dtype):
    """Folded OIHW ``(64, 1, 7, 7)`` stem + bias -> the kernels' layouts."""
    w = stem_kernel.detach().float().reshape(C, 49).T.contiguous().to(float_dtype)
    return w, stem_bias.detach().float().contiguous()


def g1_weights(folded, float_dtype):
    """A ``fold_backbone`` tree -> K2's stem, conv and SE1 arguments."""
    blocks = (folded["layer1_0"], folded["layer1_1"])
    if any(b["downsample"] is not None for b in blocks):
        raise ValueError("layer-1 blocks must be identity-residual")
    convs = [b[k] for b in blocks for k in ("conv1", "conv2")]
    conv_w = torch.stack([
        c["weight"].detach().float().permute(2, 3, 1, 0).reshape(9, C, C)
        for c in convs
    ]).to(float_dtype).contiguous()
    conv_b = torch.stack([c["bias"].detach().float() for c in convs]).contiguous()
    se = folded["se1"]
    return (
        *stem_weights(folded["stem"]["weight"], folded["stem"]["bias"], float_dtype),
        conv_w, conv_b,
        # fp32 arrays of float_dtype values: the TPU kernel holds them in float_dtype
        se["d0"].detach().to(float_dtype).float().contiguous(),
        se["d1"].detach().to(float_dtype).float().contiguous(),
    )


def stem_gemm_weight(stem_w):
    """The ``(49, 64)`` stem kernel as the 64 x 64 B operand that the bf16
    kernels build in shared memory: the 7x7 window as 8 rows of 8 taps, row
    ``8 * dy + dx + 1`` holding tap ``(dy, dx)``; the 15 rows with
    ``dx + 1 == 0`` or ``dy == 7`` are zero."""
    w = stem_w.new_zeros(8, 8, C)
    w[:7, 1:] = stem_w.reshape(7, 7, C)
    return w.reshape(64, C)


def stem_gemm_index(hw: int):
    """``(hw/2 * hw/2, 64)`` int64: for conv position ``(cy, cx)`` (row) and
    GEMM column ``k``, the element ``(2 * cy + k // 8, 2 * cx + k % 8)`` of a
    sample's tile that the bf16 kernels read. The tile is ``hw + 6`` rows of
    ``hw + 8`` values: the pixels from row 3, column 4, inside zeros."""
    co = hw // 2
    pos, k = torch.arange(co * co)[:, None], torch.arange(64)[None, :]
    return (2 * (pos // co) + k // 8) * (hw + 8) + 2 * (pos % co) + k % 8


def stem_tile_rows(hw: int) -> np.ndarray:
    """``(64, 3)``: for row ``16 * w + 8 * h + g`` of a 64-row stem tile of the
    bf16 kernels (warp ``w``, lane group ``g = lane // 4``, fragment half
    ``h``), the (sample of the tile, conv row, conv column) it computes: conv
    row ``Y = RW * w + g // XP`` of the tile's samples (``hw // 2`` rows each)
    at column ``2 * (g % XP) + h``, where ``XP = hw // 4`` lane groups cover a
    conv row and a warp ``RW = 8 // XP`` rows. A lane thus holds two
    neighbouring columns of one row, which the in-register max-pool uses; a
    tile holds one sample at 16 px, four at 8 px."""
    co = hw // 2
    xp = co // 2
    rw = 8 // xp
    r = np.arange(64)
    w, h, g = r // 16, r % 16 // 8, r % 8
    y_all = w * rw + g // xp
    return np.stack([y_all // co, y_all % co, 2 * (g % xp) + h], axis=1)


def x_box(hw: int, samples: int) -> Tuple[Tuple[int, int, int], Tuple[int, int, int], int]:
    """The TMA box through which the bf16 kernels read ``samples`` samples of
    x, viewed as ``(B, hw, hw)``: its shape ``(samples, hw + 6, hw + 8)``, its
    origin relative to the group's first sample, ``(0, 0, 0)`` (TMA takes no
    negative coordinates), and the lead, ``3 * (hw + 8) + 4`` elements. The
    box's zero fill outside x puts zeros right of and below each sample's
    pixels and zero samples past the batch; read from the lead's zeros in
    front of the box on, each sample's block is its tile as
    :func:`stem_gemm_index` reads it (the 4 columns left of a row are the
    previous row's last 4 zeros, the 3 rows above the first the previous
    sample's last zero rows, or the lead)."""
    return (samples, hw + 6, hw + 8), (0, 0, 0), 3 * (hw + 8) + 4


def g1_samples_per_block(hw: int) -> int:
    """Samples of a bf16 K2 block: K5's layer-1 block at extent ``hw // 4``
    (256 rows, 128 at 8 px, position-major: ``resnet_group.group12_row_order``)."""
    return rg.samples_per_block(hw // 4)


def k1_samples_per_group(hw: int) -> int:
    """Samples a bf16 K1 worker takes at a time: two stem tiles at 16 px, one
    (of four samples) at 8 px; one TMA box in, one TMA store out."""
    return 2 if hw == 16 else 4


def _for_extent(fn, hw, float_dtype, args) -> Callable:
    if not supports_extent(hw):
        raise ValueError(f"fused front supports 8/16px extents, got {hw}")

    def front(x):
        if tuple(x.shape[1:]) != (hw, hw, 1):
            raise ValueError(f"front built for {hw}px, got {tuple(x.shape)}")
        return fn(x.to(float_dtype).contiguous(), *args)

    return front


def make_fused_front(stem_kernel, stem_bias, hw: int,
                     float_dtype=torch.bfloat16) -> Callable:
    """``front(x)``: K1 for ``hw`` px with weights on the stem's device."""
    return _for_extent(fused_front, hw, float_dtype,
                       stem_weights(stem_kernel, stem_bias, float_dtype))


def make_fused_front_g1(folded, hw: int, float_dtype=torch.bfloat16) -> Callable:
    """``front_g1(x)``: K2 for ``hw`` px over a ``fold_backbone`` tree."""
    return _for_extent(fused_front_g1, hw, float_dtype,
                       g1_weights(folded, float_dtype))


__all__ = [
    "fused_front",
    "fused_front_g1",
    "fused_front_g1_reference",
    "fused_front_reference",
    "g1_samples_per_block",
    "g1_weights",
    "k1_samples_per_group",
    "launch_counts",
    "make_fused_front",
    "make_fused_front_g1",
    "reset_launch_counts",
    "stem_gemm_index",
    "stem_gemm_weight",
    "stem_tile_rows",
    "stem_weights",
    "supports_extent",
    "x_box",
]
