"""Full partition-tree inference: frame -> per-superblock AV1 quadtrees.

Counterpart of ``av1tpu.eval.tree_infer``. A whole frame's 64x64 superblocks
are tiled, every potential block at every level of the 64->32->16->8
hierarchy runs through that level's v6 pipeline in dense batches, and the
per-level decisions assemble into fixed-shape (N, 85)-slot partition trees
(see :mod:`av1tpu_torch.codec.tree`).

By default all four levels evaluate dense: a child's pipeline result is
discarded by the tree mask when its parent did not SPLIT. On top of the
dense cascade, ``level_capacities`` offers static-capacity gating (a fixed-K
selection over node aliveness): exact whenever K covers the live node set.
Shapes stay fixed by K, so nothing in the level loop waits for the host.
"""
from __future__ import annotations

from typing import Callable, Dict, Mapping, Optional

import numpy as np
import torch

from av1tpu_torch.codec.partitions import PARTITION_SPLIT, V6_FINAL_TO_RAW
from av1tpu_torch.codec.tree import LEVEL_SIZES, NODES_PER_LEVEL, assemble_trees
from av1tpu_torch.eval.hierarchy import run_pipeline_batched
from av1tpu_torch.ingest.tiler import tile_frame
from av1tpu_torch.utils.profiling import span


def quad_tile_on_device(sbs: torch.Tensor, size: int) -> torch.Tensor:
    """(N, 64, 64) superblocks -> (N·nodes, size, size, 1) sub-blocks in
    quadrant-major order, on ``sbs``'s device: the tensor twin of
    ``codec.tree._quad_tile`` and the single source of the cascade's child
    ordering."""
    current = sbs[:, None]
    cur = 64
    while cur > size:
        half = cur // 2
        nn = current.shape[1]
        quads = torch.stack(
            [
                current[:, :, :half, :half],
                current[:, :, :half, half:],
                current[:, :, half:, :half],
                current[:, :, half:, half:],
            ],
            dim=2,
        )
        current = quads.reshape(sbs.shape[0], nn * 4, half, half)
        cur = half
    return current.reshape(-1, size, size)[..., None]


def predict_partition_trees(
    superblocks,
    level_predictors: Mapping[int, Callable],
    batch_size: int = 4096,
    mesh=None,
    as_numpy: bool = True,
    level_capacities: Optional[Mapping[int, float]] = None,
    device="cuda",
) -> Dict[str, np.ndarray]:
    """Run the 4-level cascade over (N, 64, 64) uint16 superblocks (numpy or
    a tensor) on ``device``: the card unless the caller passes ``"cpu"``;
    ``"cuda"`` without a card raises.

    ``level_predictors`` maps block size (64/32/16/8) to a v6 pipeline
    ``predict`` (``make_v6_pipeline``, ``make_v6_pipeline_folded`` or a
    unified pipeline, made for the same device) trained for that size.
    Returns the assembled ``(N, 85)`` trees plus the per-level raw-mode
    arrays ``modes_<size>``. The superblocks are uploaded once; every
    level's sub-blocks derive from them on the device.
    ``as_numpy=False`` keeps every output on the device without
    synchronising, so a caller can overlap the next chunk's disk IO and host
    tiling with this chunk's device compute (convert once at the end).

    ``level_capacities`` maps block size -> fraction of that level's
    potential nodes to evaluate (default 1.0 = dense). A node is ALIVE iff
    every ancestor predicted SPLIT; the tree assembly masks every other
    node's mode anyway, so evaluating only a static K nodes selected by
    aliveness is EXACT whenever K covers the live set. Alive nodes beyond K
    (overflow, reported per level as ``overflow_<size>``) fall back to NONE,
    truncating that subtree. Among equally alive (or equally dead) nodes the
    selection takes the lowest indices first, as ``jax.lax.top_k`` does, so
    both packages evaluate the same nodes. Level 64 is always dense (every
    root is alive).

    ``mesh`` (``parallel.mesh``; every rank passes the same superblocks and
    predictors built with the same mesh) shards every level's batches over
    the data axis. Each level's outputs come back whole on every rank, so
    the node selection of the next level is the same everywhere.

    The call is the span ``cascade``, with ``cascade.upload`` and one
    ``cascade.level`` a level inside it (``utils.profiling``)."""
    with span("cascade", rows=int(superblocks.shape[0])):
        return _cascade(superblocks, level_predictors, batch_size, mesh, as_numpy,
                        level_capacities, torch.device(device))


def _cascade(superblocks, level_predictors, batch_size, mesh, as_numpy, level_capacities,
             device) -> Dict[str, np.ndarray]:
    """``predict_partition_trees``'s body."""
    missing = [s for s in LEVEL_SIZES if s not in level_predictors]
    if missing:
        raise ValueError(f"missing level predictors for sizes: {missing}")
    caps = {int(k): float(v) for k, v in (level_capacities or {}).items()}
    bad = {s: c for s, c in caps.items() if not 0.0 < c <= 1.0}
    if bad:
        raise ValueError(f"level capacities must be in (0, 1]: {bad}")
    n = int(superblocks.shape[0])
    # Upload the 64x64 superblocks ONCE. Tiling and gathering only move
    # values, so they work on the int16 view of the uint16 codes, a dtype
    # every torch build indexes and stacks on either device.
    with span("cascade.upload", bytes=n * 64 * 64 * 2):
        if isinstance(superblocks, np.ndarray):
            superblocks = torch.from_numpy(np.ascontiguousarray(superblocks))
        if superblocks.dim() == 4:
            superblocks = superblocks[..., 0]
        device_sbs = superblocks.to(device, non_blocking=True).view(torch.int16)

    remap = torch.from_numpy(V6_FINAL_TO_RAW).to(device)
    level_modes = []
    per_level: Dict[str, torch.Tensor] = {}
    alive = None  # (n, nodes) bool at the current level; None = all alive
    for size, nodes in zip(LEVEL_SIZES, NODES_PER_LEVEL):
        total = n * nodes
        cap = caps.get(size, 1.0)
        gated = alive is not None and cap < 1.0
        k = min(max(int(np.ceil(cap * total)), 1), total) if gated else total
        with span("cascade.level", device=device, px=size, rows=k):
            blocks = quad_tile_on_device(device_sbs, size)  # stays on device
            if gated:
                score = alive.reshape(-1).to(torch.float32)
                # a stable descending sort: ties keep their index order
                idx = torch.sort(score, descending=True, stable=True).indices[:k]
                level_batch = min(batch_size, -(-k // 256) * 256)
                out = run_pipeline_batched(
                    level_predictors[size],
                    blocks.index_select(0, idx).view(torch.uint16),
                    batch_size=level_batch, device=device, as_numpy=False, mesh=mesh,
                )
                final = torch.zeros((total,), dtype=out["final"].dtype, device=device)
                final[idx] = out["final"]
                # The overflow count stays a device scalar under as_numpy=False:
                # int() here would wait for the device once per gated level and
                # end the overlap of IO and compute documented above.
                overflow = torch.clamp(score.sum().to(torch.int32) - k, min=0)
                per_level[f"overflow_{size}"] = overflow
            else:
                # Cap the batch at the level's real block count (rounded up to
                # 256), so that chunk boundaries match the JAX package's.
                level_batch = min(batch_size, -(-total // 256) * 256)
                out = run_pipeline_batched(
                    level_predictors[size], blocks.view(torch.uint16),
                    batch_size=level_batch, device=device, as_numpy=False, mesh=mesh,
                )
                final = out["final"]
            raw_modes = remap[final.long()].reshape(n, nodes)
            level_modes.append(raw_modes)
            per_level[f"modes_{size}"] = raw_modes
            if size != LEVEL_SIZES[-1]:
                node_split = raw_modes == PARTITION_SPLIT
                parent_alive = node_split if alive is None else (alive & node_split)
                alive = parent_alive.repeat_interleave(4, dim=1)

    result = {"trees": assemble_trees(level_modes), **per_level}
    if not as_numpy:
        return result
    return {
        key: int(value) if key.startswith("overflow_") else value.cpu().numpy()
        for key, value in result.items()
    }


def predict_frame_trees(
    y_plane: np.ndarray,
    level_predictors: Mapping[int, Callable],
    batch_size: int = 4096,
    mesh=None,
    level_capacities: Optional[Mapping[int, float]] = None,
    as_numpy: bool = True,
    device="cuda",
) -> Dict[str, np.ndarray]:
    """Whole-frame entry: tile a (H, W) luma plane into superblocks on the
    host and emit one partition tree per superblock (row-major order), plus
    ``grid_shape``.

    ``as_numpy=False`` returns device tensors without synchronising, so a
    frame-pipelined caller can start the next frame's disk read and host
    tiling while this frame is still computing."""
    sbs, grid = tile_frame(np.asarray(y_plane), 64)
    result = predict_partition_trees(
        sbs, level_predictors, batch_size, mesh=mesh,
        level_capacities=level_capacities, as_numpy=as_numpy, device=device,
    )
    result["grid_shape"] = np.asarray([grid.num_rows, grid.num_cols])
    return result


__all__ = [
    "predict_frame_trees",
    "predict_partition_trees",
    "quad_tile_on_device",
]
