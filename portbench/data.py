"""Seeded inputs: luma planes and blocks with structure at every scale of
the 64 -> 32 -> 16 -> 8 hierarchy, drawn on the device in a few large calls.

A plane is a random level per 16 px cell, plus noise whose amplitude is drawn
per 8 px cell, clipped to 10 bits: blocks of every size differ from their
neighbours in brightness and in texture, so the cascade's decisions vary with
the block. The same seed gives the same inputs.
"""
from __future__ import annotations

import numpy as np
import torch

LEVEL_RANGE = (100.0, 900.0)
AMPLITUDE_RANGE = (0.0, 250.0)
CODE_MAX = 1023


def structured_luma(gen: torch.Generator, count: int, height: int, width: int,
                    device) -> np.ndarray:
    """``(count, height, width)`` uint16 planes; ``height`` and ``width`` are
    multiples of 16."""
    def uniform(lo, hi, shape):
        return lo + (hi - lo) * torch.rand(shape, generator=gen, device=device)

    level = uniform(*LEVEL_RANGE, (count, height // 16, width // 16))
    amp = uniform(*AMPLITUDE_RANGE, (count, height // 8, width // 8))
    noise = torch.randn((count, height, width), generator=gen, device=device)
    level = level.repeat_interleave(16, 1).repeat_interleave(16, 2)
    amp = amp.repeat_interleave(8, 1).repeat_interleave(8, 2)
    codes = (level + amp * noise).clamp_(0, CODE_MAX).to(torch.int16)  # truncates, as astype
    return codes.cpu().numpy().view(np.uint16)


def frame(gen: torch.Generator, width: int, height: int, device) -> np.ndarray:
    """One ``height`` x ``width`` plane (drawn at the next multiple of 16 rows
    and columns, and cropped)."""
    rows = -(-height // 16) * 16
    cols = -(-width // 16) * 16
    return np.ascontiguousarray(structured_luma(gen, 1, rows, cols, device)[0, :height, :width])


def block_dataset(gen: torch.Generator, count: int, px: int, device,
                  chunk: int = 1 << 17) -> np.ndarray:
    """``(count, px, px, 1)`` uint16 blocks, each a ``px`` x ``px`` plane of
    its own, drawn ``chunk`` at a time into one host array."""
    out = np.empty((count, px, px, 1), dtype=np.uint16)
    for start in range(0, count, chunk):
        n = min(chunk, count - start)
        out[start:start + n, ..., 0] = structured_luma(gen, n, px, px, device)
    return out


__all__ = ["block_dataset", "frame", "structured_luma"]
