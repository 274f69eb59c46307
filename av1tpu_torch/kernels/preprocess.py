"""Ingest preprocessing: kernels K3a and K3b (``csrc/preprocess.cu``).

Counterpart of ``av1tpu.kernels.preprocess``:

* :func:`tile_normalize_frames` (K3a): ``(F, H, W)`` uint16 luma frames ->
  ``(F*R*C, bs, bs, 1)`` blocks, frame-major then row-major (the order of
  ``av1tpu.ingest.tiler.tile_frames``), times 1/1023;
* :func:`normalize_blocks` (K3b): uint16 blocks of any shape -> the same
  shape in float, times 1/1023.

Both multiply by ``INV_1023`` in fp32 and round to ``out_dtype`` (fp32 or
bf16), as the TPU kernels do; the serving pipelines divide by 1023 instead,
and keep doing so. Inputs are ``torch.uint16`` tensors. A CPU tensor runs
the plain twin; a CUDA tensor launches the kernel or raises, and a launch
adds one to ``_build.launch_counts[name]``. The TPU kernels' ``tile``
(VMEM chunk) and ``interpret`` (Pallas interpreter) have no counterpart
here.

:func:`pad_frames` is the numpy helper of the JAX module, written again
because importing ``av1tpu.kernels`` imports jax.
"""
from __future__ import annotations

import numpy as np
import torch

from av1tpu_torch.kernels import _build

INV_1023 = 1.0 / 1023.0
_DTYPES = (torch.float32, torch.bfloat16)


def pad_frames(frames: np.ndarray, block_size: int) -> np.ndarray:
    """Zero-pad (F, H, W) frames to block multiples (reference semantics)."""
    _, h, w = frames.shape
    ph, pw = -h % block_size, -w % block_size
    if not ph and not pw:
        return frames
    return np.pad(frames, ((0, 0), (0, ph), (0, pw)))


def _to_f32(t):
    """uint16 -> fp32 through int16/int32, the conversions every build of
    torch has for CPU and CUDA tensors."""
    return (t.view(torch.int16).to(torch.int32) & 0xFFFF).to(torch.float32)


def tile_normalize_reference(frames, block_size: int, out_dtype=torch.float32):
    """Plain K3a: ``(F, H, W)`` uint16 -> ``(F*R*C, bs, bs, 1)`` out_dtype."""
    f, h, w = frames.shape
    rows, cols = h // block_size, w // block_size
    x = _to_f32(frames) * INV_1023
    x = x.reshape(f, rows, block_size, cols, block_size).permute(0, 1, 3, 2, 4)
    return x.reshape(f * rows * cols, block_size, block_size, 1).to(out_dtype)


def normalize_blocks_reference(blocks, out_dtype=torch.float32):
    """Plain K3b: uint16 -> out_dtype, times 1/1023."""
    return (_to_f32(blocks) * INV_1023).to(out_dtype)


def _check(name, t, out_dtype):
    if t.dtype != torch.uint16:
        raise ValueError(f"{name}: dtype {t.dtype}, expected torch.uint16")
    if out_dtype not in _DTYPES:
        raise ValueError(f"out_dtype {out_dtype} not in {_DTYPES}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {t.device}")


def tile_normalize_frames(frames, block_size: int = 16, out_dtype=torch.float32):
    """Fused tile + normalize: ``(F, H, W)`` uint16 -> ``(F*R*C, bs, bs, 1)``.

    H and W must be multiples of ``block_size`` (use :func:`pad_frames`
    first, the reference's zero padding)."""
    _check("frames", frames, out_dtype)
    if frames.dim() != 3:
        raise ValueError(f"frames: expected (F, H, W), got {tuple(frames.shape)}")
    f, h, w = map(int, frames.shape)
    if h % block_size or w % block_size:
        raise ValueError(
            f"frame {h}x{w} not a multiple of block_size={block_size}; "
            "pad_frames() first"
        )
    if frames.device.type == "cpu":
        return tile_normalize_reference(frames, block_size, out_dtype)
    n = f * (h // block_size) * (w // block_size)
    out = torch.empty((n, block_size, block_size, 1), dtype=out_dtype,
                      device=frames.device)
    if n:
        _build.launch("tile_normalize_frames", frames.data_ptr(), out.data_ptr(),
                      f, h, w, block_size, int(out_dtype == torch.bfloat16),
                      _build.stream_of(frames))
    return out


def normalize_blocks(blocks, out_dtype=torch.float32):
    """Fused dequant + normalize of pre-tiled uint16 blocks, e.g.
    ``(N, bs, bs, 1)``; the output has the input's shape."""
    _check("blocks", blocks, out_dtype)
    if blocks.device.type == "cpu":
        return normalize_blocks_reference(blocks, out_dtype)
    out = torch.empty(blocks.shape, dtype=out_dtype, device=blocks.device)
    if blocks.numel():
        _build.launch("normalize_blocks", blocks.data_ptr(), out.data_ptr(),
                      blocks.numel(), int(out_dtype == torch.bfloat16),
                      _build.stream_of(blocks))
    return out


__all__ = [
    "INV_1023",
    "normalize_blocks",
    "normalize_blocks_reference",
    "pad_frames",
    "tile_normalize_frames",
    "tile_normalize_reference",
]
