"""AV1 partition-tree assembly from per-level block decisions.

The port's own copy of ``av1tpu.codec.tree`` (same names, same values): the
per-block-size models' decisions compose into one partition tree per
superblock, as a vectorized computation on numpy arrays or torch tensors.

Tree model (intra, square blocks 64 -> 32 -> 16 -> 8):
  * each 64x64 superblock is the root; a node whose predicted mode is
    PARTITION_SPLIT recurses into its 4 quadrant children at the next size
  * any other mode terminates the node (HORZ/VERT/AB/H4/V4 partitions
    produce non-square leaves that do not recurse in this hierarchy)
  * 8x8 nodes never recurse (8 is the smallest size in the data)

Serialization: a fixed-shape quadtree table per superblock with
1 + 4 + 16 + 64 = 85 node slots in level order; slot value = predicted
partition mode for reached nodes, -1 for unreached ones. Fixed shape keeps
the whole assembly a masked ``where`` cascade — no data-dependent control
flow, so on a device it never waits for the host.
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from av1tpu_torch.codec.partitions import PARTITION_SPLIT

LEVEL_SIZES: Tuple[int, ...] = (64, 32, 16, 8)
NODES_PER_LEVEL: Tuple[int, ...] = (1, 4, 16, 64)
TREE_SLOTS = sum(NODES_PER_LEVEL)  # 85
LEVEL_OFFSETS: Tuple[int, ...] = (0, 1, 5, 21)


def assemble_trees(level_modes: Sequence) -> "np.ndarray":
    """Compose per-level mode predictions into (N, 85) partition trees.

    ``level_modes`` is a sequence of arrays, one per level in
    :data:`LEVEL_SIZES` order, shaped ``(N, nodes)`` with nodes =
    1, 4, 16, 64 — the predicted partition mode of every *potential* node
    (children are indexed quadrant-major: child k of node j at level L is
    node ``4*j + k`` at level L+1).

    Works on numpy arrays or torch tensors (pure ``where``/repeat ops; tensors
    stay on their device). A node's slot holds its mode if every ancestor
    chose SPLIT, else -1.
    """
    first = level_modes[0]
    if isinstance(first, torch.Tensor):
        return _assemble_trees_torch(level_modes)
    xp = np

    n = first.shape[0]
    out_parts = []
    reached = xp.ones((n, 1), dtype=bool)
    for li, nodes in enumerate(NODES_PER_LEVEL):
        modes = xp.asarray(level_modes[li]).reshape(n, nodes)
        slot = xp.where(reached, modes, -1)
        out_parts.append(slot)
        if li + 1 < len(NODES_PER_LEVEL):
            # a child is reached iff its parent is reached AND split
            parent_split = reached & (modes == PARTITION_SPLIT)
            reached = xp.repeat(parent_split, 4, axis=1)
    return xp.concatenate(out_parts, axis=1)


def _assemble_trees_torch(level_modes: Sequence[torch.Tensor]) -> torch.Tensor:
    n = level_modes[0].shape[0]
    out_parts = []
    reached = torch.ones((n, 1), dtype=torch.bool, device=level_modes[0].device)
    for li, nodes in enumerate(NODES_PER_LEVEL):
        modes = level_modes[li].reshape(n, nodes)
        out_parts.append(torch.where(reached, modes, -1))
        if li + 1 < len(NODES_PER_LEVEL):
            parent_split = reached & (modes == PARTITION_SPLIT)
            reached = parent_split.repeat_interleave(4, dim=1)
    return torch.cat(out_parts, dim=1)


def tree_depth_stats(trees: np.ndarray) -> Dict[str, float]:
    """Distribution statistics over assembled trees."""
    trees = np.asarray(trees)
    reached = trees >= 0
    leaves = reached & (trees != PARTITION_SPLIT)
    return {
        "mean_nodes": float(reached.sum(axis=1).mean()),
        "mean_leaves": float(leaves.sum(axis=1).mean()),
        "full_split_fraction": float(
            (reached.sum(axis=1) == TREE_SLOTS).mean()
        ),
        "no_split_fraction": float((reached.sum(axis=1) == 1).mean()),
    }


def tree_to_nested(tree_row: np.ndarray):
    """One (85,) tree row -> nested python structure for inspection:
    ``(mode, [child, child, child, child])`` for split nodes, ``mode``
    for leaves."""
    tree_row = np.asarray(tree_row)

    def node(level: int, index: int):
        mode = int(tree_row[LEVEL_OFFSETS[level] + index])
        if mode == PARTITION_SPLIT and level + 1 < len(NODES_PER_LEVEL):
            children = [node(level + 1, 4 * index + k) for k in range(4)]
            return (mode, children)
        return mode

    return node(0, 0)


def flatten_superblock(y64: np.ndarray) -> Dict[int, np.ndarray]:
    """Tile one (64, 64) superblock (or an (N, 64, 64) batch) into the
    per-level block inputs the per-size models consume.

    Returns {size: (N * nodes, size, size)} in the quadrant-major node
    order :func:`assemble_trees` expects.
    """
    arr = np.asarray(y64)
    if arr.ndim == 2:
        arr = arr[None]
    n = arr.shape[0]
    out: Dict[int, np.ndarray] = {64: arr.reshape(n, 64, 64)}
    for size, nodes in zip(LEVEL_SIZES[1:], NODES_PER_LEVEL[1:]):
        # recursive quadrant-major ordering: child k of node j is 4*j+k
        out[size] = _quad_tile(arr, size).reshape(n * nodes, size, size)
    return out


def _quad_tile(arr: np.ndarray, size: int) -> np.ndarray:
    """(N, 64, 64) -> (N, nodes, size, size) in recursive quadrant order."""
    n = arr.shape[0]
    current = arr[:, None]  # (N, 1, 64, 64)
    cur_size = 64
    while cur_size > size:
        half = cur_size // 2
        nodes = current.shape[1]
        quads = np.stack(
            [
                current[:, :, :half, :half],
                current[:, :, :half, half:],
                current[:, :, half:, :half],
                current[:, :, half:, half:],
            ],
            axis=2,
        )  # (N, nodes, 4, half, half)
        current = quads.reshape(n, nodes * 4, half, half)
        cur_size = half
    return current


__all__ = [
    "LEVEL_OFFSETS",
    "LEVEL_SIZES",
    "NODES_PER_LEVEL",
    "TREE_SLOTS",
    "assemble_trees",
    "flatten_superblock",
    "tree_depth_stats",
    "tree_to_nested",
]
