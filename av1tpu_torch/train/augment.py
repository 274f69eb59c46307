"""Test-time augmentation views and their AB label alignment.

Counterpart of the TTA part of ``av1tpu.train.augment`` (``tta_views``,
``TTA_AB_ALIGN_V6``, ``align_tta_ab_logits``). The training augmentations
are not ported yet.
"""
from __future__ import annotations

import numpy as np
import torch

from av1tpu_torch.codec.partitions import AB_HFLIP_SWAP_V6, AB_VFLIP_SWAP_V6


def tta_views(images: torch.Tensor) -> torch.Tensor:
    """Test-time augmentation views: original, hflip, vflip, rot180.
    Batched NHWC: (N,H,W,C) -> (4,N,H,W,C); aggregate predictions with a
    mean over axis 0."""
    return torch.stack(
        [
            images,
            torch.flip(images, dims=(2,)),
            torch.flip(images, dims=(1,)),
            torch.rot90(images, k=2, dims=(1, 2)),
        ]
    )


# Per-view AB label permutation induced by each tta_views transform, in
# tta_views order (identity, hflip, vflip, rot180 = hflip∘vflip), from the
# training swap tables (codec/partitions.py AB_*_SWAP_V6). All four views
# are involutions, so each row is its own inverse. A plain mean of the
# views' AB logits mixes e.g. HORZ_A evidence into HORZ_B for the flipped
# views; gathering each view's logits through its row re-expresses them in
# the original frame's classes before averaging. See align_tta_ab_logits.
TTA_AB_ALIGN_V6 = np.stack([
    np.arange(4, dtype=np.int32),
    AB_HFLIP_SWAP_V6,
    AB_VFLIP_SWAP_V6,
    AB_HFLIP_SWAP_V6[AB_VFLIP_SWAP_V6],  # rot180 = hflip ∘ vflip
])


def align_tta_ab_logits(view_logits: torch.Tensor) -> torch.Tensor:
    """Re-express per-view AB logits (4, N, 4) in the ORIGINAL frame's
    class order: aligned[v, :, c] = view_logits[v, :, P_v[c]], where P_v is
    the swap-table label map of view v (label(T_v(x)) = P_v[label(x)]).
    Averaging the aligned views pools each class's evidence instead of
    mixing swapped pairs."""
    perms = torch.from_numpy(TTA_AB_ALIGN_V6).to(view_logits.device, torch.int64)
    index = perms[:, None, :].expand(-1, view_logits.shape[1], -1)
    return torch.gather(view_logits, 2, index)


__all__ = ["TTA_AB_ALIGN_V6", "align_tta_ab_logits", "tta_views"]
