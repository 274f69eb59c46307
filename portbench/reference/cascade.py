"""The partition cascade in plain PyTorch and numpy: frame tiling, the
64 -> 32 -> 16 -> 8 quad tiling, the v6 routing, the raw-mode remap and the
85-slot tree assembly, with the decision margins that the output check reads.

Contracts, as the system states them:

* a ``(H, W)`` luma plane is zero-padded at the bottom and right to multiples
  of 64 and cut into 64 px superblocks in row-major order;
* a node's children at the next level are its quadrants, quadrant-major: child
  k of node j is node ``4 j + k`` (top-left, top-right, bottom-left,
  bottom-right);
* a block's input is its uint16 codes divided by the configuration's
  ``norm_scale``;
* the decisions (:data:`DECISIONS`): the stage-1 gate's one logit, stage 2's
  three (SPLIT, RECT, AB), the RECT head's two and the AB head's four; a model
  family (``spec.load_family``) gives them for one level's models;
* routing: ``final = NONE`` where the stage-1 probability is under the
  threshold, else SPLIT, ``2 + rect`` or ``4 + ab`` by stage 2's argmax
  (SPLIT, RECT, AB);
* the final class maps to a raw AV1 partition id through
  :data:`FINAL_TO_RAW` (NONE, SPLIT, HORZ, VERT, HORZ_A, HORZ_B, VERT_A, VERT_B);
* a tree row holds 1 + 4 + 16 + 64 slots in level order: a node's raw mode
  where every ancestor's mode is SPLIT (raw 3), else -1.
"""
from __future__ import annotations

import contextlib
from typing import Dict, List, Sequence

import numpy as np
import torch

from portbench.reference.v6 import threshold_logit

DECISIONS = ("stage1", "stage2", "rect", "ab")
LEVELS = (64, 32, 16, 8)
NODES = (1, 4, 16, 64)
FINAL_TO_RAW = np.array([0, 3, 1, 2, 4, 5, 6, 7], dtype=np.int64)
RAW_SPLIT = 3
RAW_TO_FINAL = np.full(16, -1, dtype=np.int64)
RAW_TO_FINAL[FINAL_TO_RAW] = np.arange(len(FINAL_TO_RAW))


def tile_superblocks(plane: np.ndarray) -> np.ndarray:
    """``(H, W)`` -> ``(rows * cols, 64, 64)`` row-major, zero-padded."""
    h, w = plane.shape
    rows, cols = -(-h // 64), -(-w // 64)
    padded = np.zeros((rows * 64, cols * 64), dtype=plane.dtype)
    padded[:h, :w] = plane
    return np.ascontiguousarray(
        padded.reshape(rows, 64, cols, 64).transpose(0, 2, 1, 3).reshape(-1, 64, 64))


def quad_tile(sbs: np.ndarray, size: int) -> np.ndarray:
    """``(N, 64, 64)`` -> ``(N * nodes, size, size)`` in quadrant-major order."""
    n = sbs.shape[0]
    cur = sbs[:, None]
    extent = 64
    while extent > size:
        half = extent // 2
        quads = [cur[:, :, :half, :half], cur[:, :, :half, half:],
                 cur[:, :, half:, :half], cur[:, :, half:, half:]]
        cur = np.stack(quads, axis=2).reshape(n, -1, half, half)
        extent = half
    return cur.reshape(-1, size, size)


def route(logits: Dict[str, torch.Tensor], threshold: float) -> torch.Tensor:
    """The final 8-class decision of each row."""
    s1 = logits["stage1"] >= threshold_logit(threshold)
    s2 = logits["stage2"].argmax(dim=-1)
    rect = logits["rect"].argmax(dim=-1)
    ab = logits["ab"].argmax(dim=-1)
    final = torch.where(s2 == 0, 1, torch.where(s2 == 1, 2 + rect, 4 + ab))
    return torch.where(s1, final, 0)


def assemble(level_modes: Sequence[np.ndarray]) -> np.ndarray:
    """Per-level raw modes ``(N, nodes)`` -> ``(N, 85)`` trees."""
    n = level_modes[0].shape[0]
    reached = np.ones((n, 1), dtype=bool)
    parts = []
    for li, nodes in enumerate(NODES):
        modes = np.asarray(level_modes[li]).reshape(n, nodes)
        parts.append(np.where(reached, modes, -1))
        if li + 1 < len(NODES):
            reached = np.repeat(reached & (modes == RAW_SPLIT), 4, axis=1)
    return np.concatenate(parts, axis=1)


@contextlib.contextmanager
def exact_fp32():
    """TF32 off for cuDNN and matmuls while the reference runs; the caller's
    settings come back afterwards."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved[:2]
        torch.set_float32_matmul_precision(saved[2])


@torch.inference_mode()
def block_logits(family, arch: dict, models: Dict[str, Dict[str, torch.Tensor]],
                 blocks: np.ndarray, norm_scale: float, device,
                 rows: int) -> Dict[str, torch.Tensor]:
    """fp32 logits of uint16 blocks ``(N, s, s)`` or ``(N, s, s, 1)`` through
    ``family``'s reference (a ``spec.Family``), on ``device`` in chunks of
    ``rows``, returned on the CPU."""
    out: Dict[str, List[torch.Tensor]] = {d: [] for d in DECISIONS}
    n = blocks.shape[0]
    with exact_fp32():
        for start in range(0, n, rows):
            chunk = torch.from_numpy(np.ascontiguousarray(
                blocks[start:start + rows].reshape(-1, blocks.shape[1], blocks.shape[2], 1)
                .astype(np.float32)))
            x = chunk.to(device) / norm_scale
            for h, t in family.reference.level_logits(arch, models, x).items():
                out[h].append(t.float().cpu())
    return {h: torch.cat(v) for h, v in out.items()}


def frame_reference(family, arch: dict,
                    level_models: Dict[int, Dict[str, Dict[str, torch.Tensor]]],
                    planes: Sequence[np.ndarray], threshold: float, norm_scale: float,
                    device, rows: Dict[int, int]) -> dict:
    """The reference cascade over whole frames: per level the logits of every
    node of every frame (frame-major, then superblock, then node), the raw
    modes ``(frames, superblocks, nodes)`` and the trees ``(frames,
    superblocks, 85)``."""
    sbs = np.stack([tile_superblocks(np.asarray(p)) for p in planes])  # (F, N, 64, 64)
    f, n = sbs.shape[:2]
    flat = sbs.reshape(f * n, 64, 64)
    logits, modes = {}, []
    for size, nodes in zip(LEVELS, NODES):
        lg = block_logits(family, arch, level_models[size], quad_tile(flat, size), norm_scale,
                          device, rows[size])
        logits[size] = lg
        final = route(lg, threshold).numpy()
        modes.append(FINAL_TO_RAW[final].reshape(f * n, nodes))
    trees = assemble(modes).reshape(f, n, -1)
    return {"logits": logits, "modes": [m.reshape(f, n, -1) for m in modes], "trees": trees}


def margins(logits: Dict[str, torch.Tensor], threshold: float) -> Dict[str, np.ndarray]:
    """Each decision's margin: the stage-1 logit's distance from the
    threshold's, and each argmax head's best logit less its second."""
    out = {"stage1": (logits["stage1"] - threshold_logit(threshold)).abs().numpy()}
    for h in DECISIONS[1:]:
        top = logits[h].topk(2, dim=-1).values
        out[h] = (top[:, 0] - top[:, 1]).numpy()
    return out


def regrets(logits: Dict[str, torch.Tensor], threshold: float,
            choices: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """For each head and row, how far the reference's logit of the chosen
    class lies below its best (0 where they agree; NaN where ``choices``
    leaves the head undecided, as -1). Stage 1's choice is 0 or 1."""
    out = {}
    s1 = logits["stage1"].numpy().astype(np.float64) - threshold_logit(threshold)
    c1 = choices["stage1"]
    out["stage1"] = np.where(c1 < 0, np.nan, np.where((s1 >= 0) == (c1 == 1), 0.0, np.abs(s1)))
    for h in DECISIONS[1:]:
        lg = logits[h].numpy().astype(np.float64)
        c = choices[h]
        picked = np.take_along_axis(lg, np.clip(c, 0, None)[:, None], axis=1)[:, 0]
        out[h] = np.where(c < 0, np.nan, lg.max(axis=1) - picked)
    return out


def choices_from_final(final: np.ndarray) -> Dict[str, np.ndarray]:
    """The decisions that an 8-class final label implies, -1 where it implies
    none (a NONE says nothing of stages 2 and 3)."""
    final = np.asarray(final, dtype=np.int64)
    s2 = np.select([final == 1, (final == 2) | (final == 3), final >= 4], [0, 1, 2], -1)
    return {
        "stage1": (final > 0).astype(np.int64),
        "stage2": s2,
        "rect": np.where((final == 2) | (final == 3), final - 2, -1),
        "ab": np.where(final >= 4, final - 4, -1),
    }


__all__ = ["DECISIONS", "FINAL_TO_RAW", "LEVELS", "NODES", "RAW_TO_FINAL", "assemble",
           "block_logits", "choices_from_final", "exact_fp32", "frame_reference", "margins",
           "quad_tile", "regrets", "route", "tile_superblocks"]
