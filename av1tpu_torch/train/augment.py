"""Training augmentations, batched on the device, and the test-time views.

Counterpart of ``av1tpu.train.augment``. The JAX package vmaps single-image
transforms over per-sample PRNG keys inside its jitted step; here every
transform works on a whole NHWC batch and is split in two:

  * ``draw(gen, images)`` makes its per-sample decisions (the gate of
    probability ``p``, rot90's ``k``, box origins, the grid permutation, the
    noise) from an explicit ``torch.Generator`` on the batch's device;
  * ``apply(images, labels, draws)`` is deterministic given those draws.

A pipeline (``stage1_augment`` ...) is a tuple of transforms applied in the
JAX package's order; ``draw_pipeline`` / ``apply_pipeline`` expose the two
halves so that tests can fix the draws. Random streams cannot match across
frameworks: the JAX package's threefry draws and these are held alike by
distribution, and the applies bitwise on equal draws.

Probabilities and strengths are the reference's per-stage pipelines
(augmentation.py:166-248). Every transform returns a new tensor (the
reference's in-place ``Cutout`` corrupted its dataset, quirk Q3). The AB
transforms remap labels through the swap tables of ``codec.partitions``.
"""
from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from av1tpu_torch.codec.partitions import (
    AB_HFLIP_SWAP_V5,
    AB_HFLIP_SWAP_V6,
    AB_ROT270_SWAP_V6,
    AB_ROT90_SWAP_V5,
    AB_ROT90_SWAP_V6,
    AB_VFLIP_SWAP_V6,
)

Draws = Dict[str, torch.Tensor]


class Transform(NamedTuple):
    """One augmentation: ``draw(gen, images) -> draws`` and
    ``apply(images, labels, draws) -> (images, labels)``."""

    name: str
    draw: Callable[[torch.Generator, torch.Tensor], Draws]
    apply: Callable[[torch.Tensor, Optional[torch.Tensor], Draws],
                    Tuple[torch.Tensor, Optional[torch.Tensor]]]


def _gate(gen: torch.Generator, n: int, p: float) -> torch.Tensor:
    """Per-sample ``uniform < p`` on ``gen``'s device."""
    return torch.rand(n, generator=gen, device=gen.device) < p


def _where(mask: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.where(mask.view(-1, *([1] * (a.dim() - 1))), a, b)


def _rot90_each(images: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Sample i rotated by ``k[i]`` quarter turns (``jnp.rot90`` over H, W)."""
    out = images
    for turns in (1, 2, 3):
        out = _where(k == turns, torch.rot90(images, turns, dims=(1, 2)), out)
    return out


def _box_mask(h: int, w: int, y0: torch.Tensor, x0: torch.Tensor, size: int,
              dtype) -> torch.Tensor:
    """(n, h, w, 1): 1 inside each sample's ``size`` x ``size`` box."""
    rows = torch.arange(h, device=y0.device).view(1, h, 1)
    cols = torch.arange(w, device=x0.device).view(1, 1, w)
    y0, x0 = y0.view(-1, 1, 1), x0.view(-1, 1, 1)
    inside = (rows >= y0) & (rows < y0 + size) & (cols >= x0) & (cols < x0 + size)
    return inside.to(dtype)[..., None]


def _origins(gen: torch.Generator, n: int, h: int, w: int, size: int):
    """Box origins ``x0 ~ U{0..max(1, w-size+1)-1}``, ``y0`` likewise."""
    x0 = torch.randint(0, max(1, w - size + 1), (n,), generator=gen, device=gen.device)
    y0 = torch.randint(0, max(1, h - size + 1), (n,), generator=gen, device=gen.device)
    return x0, y0


# ---------------------------------------------------------------------------
# Label-agnostic transforms
# ---------------------------------------------------------------------------

def random_hflip(p: float = 0.5) -> Transform:
    return Transform(
        "hflip", lambda gen, x: {"apply": _gate(gen, x.shape[0], p)},
        lambda x, y, d: (_where(d["apply"], torch.flip(x, dims=(2,)), x), y))


def random_vflip(p: float = 0.5) -> Transform:
    return Transform(
        "vflip", lambda gen, x: {"apply": _gate(gen, x.shape[0], p)},
        lambda x, y, d: (_where(d["apply"], torch.flip(x, dims=(1,)), x), y))


def random_rot90(p: float = 0.5) -> Transform:
    """Rotate by k*90 deg, k uniform in {0,1,2,3}, with prob p
    (Stage1Augmentation rot lambda, augmentation.py:174)."""
    def draw(gen, x):
        return {"apply": _gate(gen, x.shape[0], p),
                "k": torch.randint(0, 4, (x.shape[0],), generator=gen, device=gen.device)}

    return Transform("rot90", draw,
                     lambda x, y, d: (_where(d["apply"], _rot90_each(x, d["k"]), x), y))


def gaussian_noise(sigma: float = 0.01, p: float = 0.5) -> Transform:
    """Additive N(0, sigma) noise with prob p (augmentation.py:78-88). The
    draw holds the standard normal; the apply scales it by ``sigma``."""
    def draw(gen, x):
        return {"apply": _gate(gen, x.shape[0], p),
                "z": torch.randn(x.shape, generator=gen, device=gen.device, dtype=x.dtype)}

    return Transform("noise", draw,
                     lambda x, y, d: (_where(d["apply"], x + d["z"] * sigma, x), y))


def cutout(size: int = 4, p: float = 0.3) -> Transform:
    """Zero one random ``size`` x ``size`` square (augmentation.py:91-103)."""
    def draw(gen, x):
        x0, y0 = _origins(gen, x.shape[0], x.shape[1], x.shape[2], size)
        return {"apply": _gate(gen, x.shape[0], p), "x0": x0, "y0": y0}

    def apply(x, y, d):
        mask = _box_mask(x.shape[1], x.shape[2], d["y0"], d["x0"], size, x.dtype)
        return _where(d["apply"], x * (1 - mask), x), y

    return Transform("cutout", draw, apply)


def coarse_dropout(num_holes: int = 3, hole_size: int = 4, p: float = 0.3) -> Transform:
    """Zero ``num_holes`` random squares (augmentation.py:138-152). Draws
    ``x0``, ``y0`` of shape (num_holes, n)."""
    def draw(gen, x):
        holes = [_origins(gen, x.shape[0], x.shape[1], x.shape[2], hole_size)
                 for _ in range(num_holes)]
        return {"apply": _gate(gen, x.shape[0], p),
                "x0": torch.stack([h[0] for h in holes]),
                "y0": torch.stack([h[1] for h in holes])}

    def apply(x, y, d):
        keep = torch.ones((x.shape[0], x.shape[1], x.shape[2], 1), dtype=x.dtype,
                          device=x.device)
        for i in range(num_holes):
            keep = keep * (1 - _box_mask(x.shape[1], x.shape[2], d["y0"][i], d["x0"][i],
                                         hole_size, x.dtype))
        return _where(d["apply"], x * keep, x), y

    return Transform("coarse_dropout", draw, apply)


def grid_shuffle(grid_size: int = 4, p: float = 0.2) -> Transform:
    """Shuffle each image's ``grid_size``^2 cells (augmentation.py:106-135).
    The draw holds one permutation of the cells per sample, (n, g*g)."""
    g = grid_size

    def draw(gen, x):
        keys = torch.rand((x.shape[0], g * g), generator=gen, device=gen.device)
        return {"apply": _gate(gen, x.shape[0], p), "perm": torch.argsort(keys, dim=1)}

    def apply(x, y, d):
        n, h, w, c = x.shape
        gh, gw = h // g, w // g
        cells = (x[:, : gh * g, : gw * g].reshape(n, g, gh, g, gw, c)
                 .permute(0, 1, 3, 2, 4, 5).reshape(n, g * g, gh, gw, c))
        perm = d["perm"].view(n, g * g, 1, 1, 1).expand(-1, -1, gh, gw, c)
        shuffled = (torch.gather(cells, 1, perm).reshape(n, g, g, gh, gw, c)
                    .permute(0, 1, 3, 2, 4, 5).reshape(n, gh * g, gw * g, c))
        return _where(d["apply"], shuffled, x), y

    return Transform("grid_shuffle", draw, apply)


# ---------------------------------------------------------------------------
# Label-aware AB transforms (v6 swap semantics)
# ---------------------------------------------------------------------------

def _remap(table: np.ndarray, labels: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(table, device=labels.device).to(labels.dtype)[labels.long()]


def hflip_with_label_swap(p: float = 0.5) -> Transform:
    """HORZ_A <-> HORZ_B on a horizontal flip (augmentation.py:13-26)."""
    def apply(x, y, d):
        return (_where(d["apply"], torch.flip(x, dims=(2,)), x),
                torch.where(d["apply"], _remap(AB_HFLIP_SWAP_V6, y), y))

    return Transform("hflip_ab", lambda gen, x: {"apply": _gate(gen, x.shape[0], p)}, apply)


def vflip_with_label_swap(p: float = 0.5) -> Transform:
    """VERT_A <-> VERT_B on a vertical flip (augmentation.py:29-42)."""
    def apply(x, y, d):
        return (_where(d["apply"], torch.flip(x, dims=(1,)), x),
                torch.where(d["apply"], _remap(AB_VFLIP_SWAP_V6, y), y))

    return Transform("vflip_ab", lambda gen, x: {"apply": _gate(gen, x.shape[0], p)}, apply)


def rot90_with_label_rotate(p: float = 0.5) -> Transform:
    """A 90 or 270 degree rotation (one coin each) with the HORZ <-> VERT
    label remap (augmentation.py:45-75)."""
    def draw(gen, x):
        return {"apply": _gate(gen, x.shape[0], p), "use_270": _gate(gen, x.shape[0], 0.5)}

    def apply(x, y, d):
        rotated = _where(d["use_270"], torch.rot90(x, 3, dims=(1, 2)),
                         torch.rot90(x, 1, dims=(1, 2)))
        new = torch.where(d["use_270"], _remap(AB_ROT270_SWAP_V6, y),
                          _remap(AB_ROT90_SWAP_V6, y))
        return _where(d["apply"], rotated, x), torch.where(d["apply"], new, y)

    return Transform("rot90_ab", draw, apply)


def v5_ab_flip_rot90(p: float = 0.5) -> Transform:
    """The v5 stage-3 AB flips (012:215-255): a horizontal flip with the v5
    swap ``{0:1, 1:0, 2:3, 3:2}``, then a 90-degree rotation with ``{0:2,
    2:0, 1:3, 3:1}``, one coin each (``v5_stage3_recipe``'s augment)."""
    def draw(gen, x):
        return {"flip": _gate(gen, x.shape[0], p), "rot": _gate(gen, x.shape[0], p)}

    def apply(x, y, d):
        x = _where(d["flip"], torch.flip(x, dims=(2,)), x)
        y = torch.where(d["flip"], _remap(AB_HFLIP_SWAP_V5, y), y)
        x = _where(d["rot"], torch.rot90(x, 1, dims=(1, 2)), x)
        return x, torch.where(d["rot"], _remap(AB_ROT90_SWAP_V5, y), y)

    return Transform("v5_ab", draw, apply)


# ---------------------------------------------------------------------------
# Per-stage pipelines (augmentation.py:166-248), in the JAX package's order
# ---------------------------------------------------------------------------

STAGE1 = (random_hflip(), random_vflip(), random_rot90(), gaussian_noise(0.01, 0.3))
STAGE2 = (random_hflip(), random_vflip(), random_rot90(), gaussian_noise(0.01, 0.3),
          cutout(4, 0.3), grid_shuffle(4, 0.2))
STAGE3_RECT = (random_hflip(), random_vflip(), gaussian_noise(0.01, 0.3), cutout(4, 0.2))
STAGE3_AB = (hflip_with_label_swap(), vflip_with_label_swap(), rot90_with_label_rotate(),
             gaussian_noise(0.01, 0.3), coarse_dropout(3, 4, 0.3), cutout(4, 0.3))
V5_STAGE3_AB = (v5_ab_flip_rot90(),)


def draw_pipeline(pipeline: Sequence[Transform], gen: torch.Generator,
                  images: torch.Tensor) -> list:
    """Every transform's draws for a batch, in pipeline order."""
    return [t.draw(gen, images) for t in pipeline]


def apply_pipeline(pipeline: Sequence[Transform], images: torch.Tensor,
                   labels: Optional[torch.Tensor], draws: Sequence[Draws]):
    """The pipeline's transforms applied in order given ``draws``."""
    for t, d in zip(pipeline, draws):
        images, labels = t.apply(images, labels, d)
    return images, labels


def stage1_augment(gen: torch.Generator, images: torch.Tensor) -> torch.Tensor:
    return apply_pipeline(STAGE1, images, None, draw_pipeline(STAGE1, gen, images))[0]


def stage2_augment(gen: torch.Generator, images: torch.Tensor) -> torch.Tensor:
    return apply_pipeline(STAGE2, images, None, draw_pipeline(STAGE2, gen, images))[0]


def stage3_rect_augment(gen: torch.Generator, images: torch.Tensor) -> torch.Tensor:
    return apply_pipeline(STAGE3_RECT, images, None,
                          draw_pipeline(STAGE3_RECT, gen, images))[0]


def stage3_ab_augment(gen: torch.Generator, images: torch.Tensor, labels: torch.Tensor):
    return apply_pipeline(STAGE3_AB, images, labels, draw_pipeline(STAGE3_AB, gen, images))


def v5_stage3_ab_augment(gen: torch.Generator, images: torch.Tensor, labels: torch.Tensor):
    return apply_pipeline(V5_STAGE3_AB, images, labels,
                          draw_pipeline(V5_STAGE3_AB, gen, images))


STAGE_AUGMENTS = {
    "stage1": stage1_augment,
    "stage2": stage2_augment,
    "stage3_rect": stage3_rect_augment,
}


def get_augmentation(stage: str):
    """The reference ``get_augmentation`` (augmentation.py:279-299);
    stage3_ab is label-aware and takes ``(gen, images, labels)``."""
    if stage in STAGE_AUGMENTS:
        return STAGE_AUGMENTS[stage]
    if stage == "stage3_ab":
        return stage3_ab_augment
    raise ValueError(f"Unknown stage: {stage}")


# ---------------------------------------------------------------------------
# Test-time augmentation
# ---------------------------------------------------------------------------

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


__all__ = [
    "STAGE1",
    "STAGE2",
    "STAGE3_AB",
    "STAGE3_RECT",
    "TTA_AB_ALIGN_V6",
    "Transform",
    "V5_STAGE3_AB",
    "align_tta_ab_logits",
    "apply_pipeline",
    "coarse_dropout",
    "cutout",
    "draw_pipeline",
    "gaussian_noise",
    "get_augmentation",
    "grid_shuffle",
    "hflip_with_label_swap",
    "random_hflip",
    "random_rot90",
    "random_vflip",
    "rot90_with_label_rotate",
    "stage1_augment",
    "stage2_augment",
    "stage3_ab_augment",
    "stage3_rect_augment",
    "tta_views",
    "v5_ab_flip_rot90",
    "v5_stage3_ab_augment",
    "vflip_with_label_swap",
]
