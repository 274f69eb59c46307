"""Superblock tiling and label-position joining.

The port's own copy of ``av1tpu.ingest.tiler``, numpy only: tiling is a
pad + reshape + transpose, and the sequential label join of the reference
extractor is a vectorized scan with bit-identical kept/discarded decisions.

Tiling contract (identical to the reference):
  * grid is ceil(H/bs) x ceil(W/bs), zero-padded bottom/right
  * blocks emitted row-major (left->right, top->bottom)
  * dtype uint16, lossless

Tiling is the span ``ingest.tile`` (``utils.profiling``).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Tuple

import numpy as np

from av1tpu_torch.utils.profiling import span


@dataclass(frozen=True)
class TileGrid:
    """Geometry of a block tiling of one frame."""

    block_size: int
    frame_height: int
    frame_width: int

    @property
    def num_rows(self) -> int:
        return math.ceil(self.frame_height / self.block_size)

    @property
    def num_cols(self) -> int:
        return math.ceil(self.frame_width / self.block_size)

    @property
    def num_blocks(self) -> int:
        return self.num_rows * self.num_cols

    @property
    def padded_height(self) -> int:
        return self.num_rows * self.block_size

    @property
    def padded_width(self) -> int:
        return self.num_cols * self.block_size

    def block_cols(self) -> np.ndarray:
        """Column index of each block in row-major emission order."""
        return np.tile(np.arange(self.num_cols, dtype=np.int64), self.num_rows)

    def block_rows(self) -> np.ndarray:
        return np.repeat(np.arange(self.num_rows, dtype=np.int64), self.num_cols)


def tile_frame(y_plane: np.ndarray, block_size: int) -> Tuple[np.ndarray, TileGrid]:
    """Tile one ``(H, W)`` luma plane into ``(N, bs, bs)`` row-major blocks.

    Vectorized equivalent of the reference ``extract_blocks_with_validation``:
    zero-pad to ceil multiples, then a reshape/transpose emits the row-major
    block order with no data movement beyond the pad copy.
    """
    h, w = y_plane.shape
    grid = TileGrid(block_size=block_size, frame_height=h, frame_width=w)
    with span("ingest.tile", rows=grid.num_blocks):
        ph, pw = grid.padded_height, grid.padded_width
        if (ph, pw) != (h, w):
            padded = np.zeros((ph, pw), dtype=y_plane.dtype)
            padded[:h, :w] = y_plane
        else:
            padded = y_plane
        blocks = (
            padded.reshape(grid.num_rows, block_size, grid.num_cols, block_size)
            .transpose(0, 2, 1, 3)
            .reshape(grid.num_blocks, block_size, block_size)
        )
    return blocks, grid


def tile_frames(y_planes: np.ndarray, block_size: int) -> Tuple[np.ndarray, TileGrid]:
    """Tile a batch ``(F, H, W)`` into ``(F*N, bs, bs)``, frame-major order."""
    f, h, w = y_planes.shape
    grid = TileGrid(block_size=block_size, frame_height=h, frame_width=w)
    with span("ingest.tile", rows=f * grid.num_blocks):
        ph, pw = grid.padded_height, grid.padded_width
        if (ph, pw) != (h, w):
            padded = np.zeros((f, ph, pw), dtype=y_planes.dtype)
            padded[:, :h, :w] = y_planes
        else:
            padded = y_planes
        blocks = (
            padded.reshape(f, grid.num_rows, block_size, grid.num_cols, block_size)
            .transpose(0, 1, 3, 2, 4)
            .reshape(f * grid.num_blocks, block_size, block_size)
        )
    return blocks, grid


def label_cols_from_units(label_units: np.ndarray, block_size: int) -> np.ndarray:
    """Convert encoder-dump 4-pixel-unit column positions to grid columns.

    The dump stores row/col in 4-pixel units; the reference converts with
    ``(value / block_size) * 4`` then truncates (005:477-479). Reproduced
    exactly, including the float-then-truncate semantics.
    """
    return ((np.asarray(label_units, dtype=np.float64) / block_size) * 4).astype(np.int64)


def join_blocks_with_labels(
    block_cols: np.ndarray, label_cols: np.ndarray
) -> Tuple[np.ndarray, np.ndarray]:
    """Sequential label-position join, vectorized.

    The reference walks blocks in emission order with a label cursor: a block
    is kept iff its grid column equals the current label's expected column,
    which advances the cursor; otherwise the block is discarded
    (005:495-516). The cursor state makes a naive elementwise compare wrong,
    so we vectorize per label-run: for each label we find the first
    subsequent block whose column matches.

    Returns ``(kept_block_indices, matched_label_indices)`` — both ascending,
    equal length, bit-identical to the reference loop.
    """
    block_cols = np.asarray(block_cols)
    label_cols = np.asarray(label_cols)
    num_blocks = block_cols.shape[0]
    num_labels = label_cols.shape[0]
    if num_labels > num_blocks:
        raise ValueError(
            f"labels ({num_labels}) exceed blocks ({num_blocks})"
        )

    # For each column value, precompute the sorted positions where it occurs
    # so each label advances with a binary search instead of a linear scan.
    kept = np.empty(num_labels, dtype=np.int64)
    positions_by_col = {}
    for col in np.unique(label_cols):
        positions_by_col[int(col)] = np.flatnonzero(block_cols == col)

    cursor = 0  # first block index not yet consumed
    for li in range(num_labels):
        pos = positions_by_col.get(int(label_cols[li]))
        if pos is None:
            # No block ever has this column: reference loop would scan to the
            # end and terminate the join.
            kept = kept[:li]
            break
        j = np.searchsorted(pos, cursor)
        if j == len(pos):
            kept = kept[:li]
            break
        kept[li] = pos[j]
        cursor = pos[j] + 1

    label_idx = np.arange(kept.shape[0], dtype=np.int64)
    return kept, label_idx


def extract_labeled_blocks(
    y_plane: np.ndarray,
    block_size: int,
    label_units: np.ndarray,
) -> Tuple[np.ndarray, np.ndarray, TileGrid]:
    """Tile one frame and keep only the blocks matched by the label join.

    Returns ``(blocks, matched_label_indices, grid)`` where ``blocks`` is
    ``(K, bs, bs)`` uint16 — byte-identical to the reference script output.
    """
    blocks, grid = tile_frame(y_plane, block_size)
    cols = grid.block_cols()
    lab_cols = label_cols_from_units(label_units, block_size)
    kept_idx, label_idx = join_blocks_with_labels(cols, lab_cols)
    return blocks[kept_idx], label_idx, grid


__all__ = [
    "TileGrid",
    "extract_labeled_blocks",
    "join_blocks_with_labels",
    "label_cols_from_units",
    "tile_frame",
    "tile_frames",
]
