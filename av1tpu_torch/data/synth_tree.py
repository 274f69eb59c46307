"""Tree-structured synthetic corpus: superblocks with KNOWN partition trees.

The port's own copy of ``av1tpu.data.synth_tree``, numpy only: with the
same seed it draws the same trees, superblocks and per-size block sets.

The north-star output of the rebuild is the full AV1 partition tree per
64x64 superblock (``codec/tree.py``, ``eval/tree_infer.py``). The
reference never composes its per-block-size models into trees — each size
is evaluated in isolation (``pesquisa_v5/013_run_pipeline_eval.py``) — so
composition accuracy is a claim only this framework can (and must)
measure. Its dataset is not shipped, so the measurement runs on a
synthetic corpus whose ground-truth trees are known by construction.

Construction mirrors how the real data path produces per-size datasets
from one video (SURVEY §3.4–3.5): a ground-truth tree is sampled per
superblock, its LEAF nodes are rendered from the class-conditional
templates (:mod:`av1tpu_torch.data.synth`), and each level's training blocks are
extracted from the SAME superblocks — a 64px block whose ground truth is
SPLIT really contains four differently-patterned quadrants, exactly the
signal the size-64 model must learn to call SPLIT on. Per-size labels
exist only for REACHED nodes (the encoder dump likewise only emits blocks
the encoder realized).
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional, Sequence, Tuple

import numpy as np

from av1tpu_torch.codec.partitions import PARTITION_SPLIT
from av1tpu_torch.codec.tree import (
    LEVEL_OFFSETS,
    LEVEL_SIZES,
    NODES_PER_LEVEL,
    TREE_SLOTS,
    _quad_tile,
)
from av1tpu_torch.data.records import BlockSet
from av1tpu_torch.data.synth import synth_blocks

# Per-level probability that a reached node SPLITs (8px never splits —
# smallest size in the data, codec/tree.py). Values chosen to yield the
# deep-but-not-degenerate trees real intra frames produce: mean ~30 nodes
# of 85, a few percent full-split, a few percent no-split.
DEFAULT_SPLIT_PROBS: Dict[int, float] = {64: 0.55, 32: 0.45, 16: 0.35, 8: 0.0}

# Leaf-mode mix over the non-SPLIT raw ids {NONE, HORZ, VERT, AB*4},
# echoing the documented block-16 imbalance (synth.TRAIN_PARTITION_MIX:
# RECT-heavy, HORZ_B/VERT_A minorities, NONE majority).
DEFAULT_LEAF_PROBS: Dict[int, float] = {
    0: 0.42, 1: 0.16, 2: 0.14, 4: 0.10, 5: 0.02, 6: 0.02, 7: 0.14,
}


def sample_trees(
    n: int,
    rng: np.random.Generator,
    split_probs: Optional[Mapping[int, float]] = None,
    leaf_probs: Optional[Mapping[int, float]] = None,
) -> np.ndarray:
    """Sample ``(n, 85)`` ground-truth trees (slot = raw mode, -1 unreached).

    Vectorized level order: every node at level L draws SPLIT with the
    level's probability (conditioned on being reached) else a leaf mode
    from ``leaf_probs``.
    """
    split_probs = dict(split_probs or DEFAULT_SPLIT_PROBS)
    leaf_probs = dict(leaf_probs or DEFAULT_LEAF_PROBS)
    leaf_ids = np.asarray(sorted(leaf_probs), dtype=np.int8)
    leaf_p = np.asarray([leaf_probs[i] for i in sorted(leaf_probs)])
    leaf_p = leaf_p / leaf_p.sum()

    trees = np.full((n, TREE_SLOTS), -1, dtype=np.int8)
    reached = np.ones((n, 1), dtype=bool)
    for level, (size, nodes, off) in enumerate(
        zip(LEVEL_SIZES, NODES_PER_LEVEL, LEVEL_OFFSETS)
    ):
        do_split = rng.uniform(size=(n, nodes)) < split_probs.get(size, 0.0)
        leaf_modes = leaf_ids[
            rng.choice(len(leaf_ids), size=(n, nodes), p=leaf_p)
        ]
        modes = np.where(do_split, PARTITION_SPLIT, leaf_modes).astype(np.int8)
        trees[:, off:off + nodes] = np.where(reached, modes, -1)
        if level + 1 < len(LEVEL_SIZES):
            reached = np.repeat(reached & do_split, 4, axis=1)
    return trees


def _node_origin(level: int, index: int) -> Tuple[int, int]:
    """Pixel origin of node ``index`` at ``level`` inside the 64x64
    superblock, under the quadrant-major child order of
    ``codec.tree._quad_tile`` (child k: 0=TL, 1=TR, 2=BL, 3=BR)."""
    row = col = 0
    size = 64
    digits = []
    for _ in range(level):
        digits.append(index % 4)
        index //= 4
    for k in reversed(digits):
        size //= 2
        row += (k // 2) * size
        col += (k % 2) * size
    return row, col


def render_superblocks(
    trees: np.ndarray,
    rng: np.random.Generator,
    noise: float = 40.0,
    contrast: Optional[Tuple[float, float]] = (0.15, 1.0),
    mix_prob: float = 0.2,
) -> np.ndarray:
    """Render ``(n, 64, 64, 1)`` uint16 superblocks from ground-truth trees.

    Each LEAF node's region gets its class-conditional pattern via
    :func:`av1tpu_torch.data.synth.synth_blocks` (same graded difficulty: contrast
    scaling + template mixing + noise). SPLIT nodes carry no pattern of
    their own — their content IS the composition of their children, which
    is what makes SPLIT learnable at every level.
    """
    n = trees.shape[0]
    canvas = np.zeros((n, 64, 64), dtype=np.uint16)
    for level, (size, nodes, off) in enumerate(
        zip(LEVEL_SIZES, NODES_PER_LEVEL, LEVEL_OFFSETS)
    ):
        slots = trees[:, off:off + nodes]
        is_leaf = (slots >= 0) & (slots != PARTITION_SPLIT)
        for j in range(nodes):
            mask = is_leaf[:, j]
            m = int(mask.sum())
            if not m:
                continue
            blocks = synth_blocks(
                slots[mask, j].astype(np.int64), rng, size=size,
                noise=noise, contrast=contrast, mix_prob=mix_prob,
            )[..., 0]
            r, c = _node_origin(level, j)
            canvas[mask, r:r + size, c:c + size] = blocks
    return canvas[..., None]


def per_size_blocksets(
    superblocks: np.ndarray,
    trees: np.ndarray,
    rng: np.random.Generator,
    qp_range: Tuple[int, int] = (60, 140),
) -> Dict[int, BlockSet]:
    """Extract each level's labeled training blocks from the superblocks.

    For every size S: all REACHED nodes' contents (quadrant-major order,
    matching ``eval.tree_infer``'s on-device tiling) with their raw-mode
    labels. Mirrors the real data path where the encoder dump labels only
    realized blocks (SURVEY §3.4).
    """
    sbs = np.asarray(superblocks)
    if sbs.ndim == 4:
        sbs = sbs[..., 0]
    n = sbs.shape[0]
    out: Dict[int, BlockSet] = {}
    for size, nodes, off in zip(LEVEL_SIZES, NODES_PER_LEVEL, LEVEL_OFFSETS):
        blocks = _quad_tile(sbs, size).reshape(n * nodes, size, size)
        slots = trees[:, off:off + nodes].reshape(-1)
        mask = slots >= 0
        labels = slots[mask].astype(np.int32)
        out[size] = BlockSet(
            samples=blocks[mask][..., None].astype(np.uint16),
            labels=labels,
            qps=rng.integers(*qp_range, int(mask.sum())).astype(np.int32),
        )
    return out


def tree_corpus(
    n_superblocks: int,
    seed: int = 42,
    split_probs: Optional[Mapping[int, float]] = None,
    leaf_probs: Optional[Mapping[int, float]] = None,
    noise: float = 40.0,
) -> Tuple[np.ndarray, np.ndarray, Dict[int, BlockSet]]:
    """One corpus: ``(superblocks, trees, per_size_blocksets)``.

    Build separate train/val corpora with different seeds so validation
    blocks come from held-out superblocks at every level.
    """
    rng = np.random.default_rng(seed)
    trees = sample_trees(n_superblocks, rng, split_probs, leaf_probs)
    sbs = render_superblocks(trees, rng, noise=noise)
    sets = per_size_blocksets(sbs, trees, rng)
    return sbs, trees, sets


__all__ = [
    "DEFAULT_LEAF_PROBS",
    "DEFAULT_SPLIT_PROBS",
    "per_size_blocksets",
    "render_superblocks",
    "sample_trees",
    "tree_corpus",
]
