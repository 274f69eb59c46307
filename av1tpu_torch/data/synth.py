"""Reference-shaped synthetic corpora for scale demonstrations.

The port's own copy of ``av1tpu.data.synth``: the same seed gives the same
blocks, labels and QPs byte for byte.

The reference's measured experiment record was produced on a private
block-16 dataset whose class mix is documented but whose data is not
shipped (``pesquisa_v6/docs_v6/00_README.md:105-107``: train 152,600
partition-only blocks — SPLIT 23,942 / RECT 71,378 / AB 57,280 — val
90,793 full / 38,256 partition-only; no checkpoints exist anywhere in the
repo). Exact replication is therefore impossible; this module generates a
corpus with the SAME size and imbalance profile from class-conditional
10-bit luma patterns, so the full training ladder can be demonstrated at
dataset scale with real epoch counts and its measured numbers recorded
(docs/EXPERIMENTS.md).

Patterns commute with the v6 label-aware augmentation tables (hflip swaps
HORZ_A<->HORZ_B, vflip swaps VERT_A<->VERT_B, rot90 maps HORZ<->VERT
families), so augmentation reinforces labels — see
``examples/demo_e2e.synth_block`` for the commutation argument.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

from av1tpu_torch.data.records import BlockSet

# documented block-16 class mix (00_README.md:105-107 + metadata.json):
# train partition-only counts; AB splits chosen so HORZ_B/VERT_A are the
# ~5x minorities the reference oversamples (002:56-62)
TRAIN_PARTITION_MIX: Dict[int, int] = {
    3: 23_942,            # SPLIT
    1: 38_000, 2: 33_378,  # HORZ / VERT  (RECT total 71,378)
    4: 22_000, 5: 4_500,   # HORZ_A / HORZ_B
    6: 4_780, 7: 26_000,   # VERT_A / VERT_B  (AB total 57,280)
}
VAL_TOTAL = 90_793
VAL_PARTITION_TOTAL = 38_256


def class_templates(size: int = 16, lo: float = 300.0, hi: float = 700.0):
    """(8, size, size) float templates, one per raw partition class."""
    h = size // 2
    ramp = np.linspace(lo, hi, size)
    t = np.full((8, size, size), lo)
    t[3, :h, :h] = hi
    t[3, h:, h:] = hi                     # SPLIT: quadrant checker
    t[1] = np.tile(ramp[:, None], (1, size))  # HORZ: vertical gradient
    t[2] = np.tile(ramp[None, :], (size, 1))  # VERT: horizontal gradient
    t[4, :, :h] = hi                      # HORZ_A: left bright
    t[5, :, h:] = hi                      # HORZ_B: right bright
    t[6, h:, :] = hi                      # VERT_A: bottom bright
    t[7, :h, :] = hi                      # VERT_B: top bright
    return t


def synth_blocks(
    labels: np.ndarray, rng: np.random.Generator,
    size: int = 16, noise: float = 40.0,
    contrast: Optional[Tuple[float, float]] = (0.05, 1.0),
    mix_prob: float = 0.35,
) -> np.ndarray:
    """Vectorized (N, size, size, 1) uint16 blocks for raw class labels.

    Difficulty is graded so the learned metrics land away from 0/100%
    (matching the character of real encoder data, where many partition
    decisions are genuinely ambiguous):
      * per-block **contrast scaling** ~ U(contrast): low-contrast blocks
        approach flat (NONE-like) regardless of label — the stage-1
        ambiguity real video has;
      * with probability ``mix_prob`` the pattern is a 50/50 **mixture**
        with a uniformly random other class's template — irreducible
        inter-class confusion that exercises the cascade error analysis.
    Set ``contrast=None, mix_prob=0`` for the cleanly separable variant.
    """
    labels = np.asarray(labels)
    n = len(labels)
    templates = class_templates(size)
    mid = templates.mean()
    centered = templates - templates.mean(axis=(1, 2), keepdims=True)
    patterns = centered[labels]
    if mix_prob > 0:
        other = rng.integers(0, len(templates), n)
        lam = np.where(rng.uniform(size=n) < mix_prob, 0.5, 1.0)[:, None, None]
        patterns = lam * patterns + (1.0 - lam) * centered[other]
    if contrast is not None:
        patterns = patterns * rng.uniform(*contrast, n)[:, None, None]
    imgs = mid + patterns + rng.normal(0.0, noise, (n, size, size))
    return np.clip(imgs, 0, 1023).astype(np.uint16)[..., None]


def _labels_from_mix(mix: Dict[int, int], rng) -> np.ndarray:
    labels = np.concatenate(
        [np.full(count, cls, np.int32) for cls, count in sorted(mix.items())]
    )
    rng.shuffle(labels)
    return labels


def reference_shaped_corpus(
    seed: int = 42, size: int = 16, noise: float = 40.0,
    scale: float = 1.0,
) -> Tuple[BlockSet, BlockSet]:
    """(train, val) BlockSets matching the documented sizes and imbalance.

    Train: the documented 152,600 partition blocks plus NONE blocks at the
    val split's NONE fraction (52,537/90,793 -> 209,577 NONE, 362,177
    total). Val: 90,793 blocks with 38,256 partition in the train mix's
    proportions. ``scale`` shrinks everything proportionally for quicker
    runs (e.g. 0.1 for a smoke pass).
    """
    rng = np.random.default_rng(seed)

    train_mix = {c: max(1, int(round(n * scale)))
                 for c, n in TRAIN_PARTITION_MIX.items()}
    train_partition = sum(train_mix.values())
    none_fraction = (VAL_TOTAL - VAL_PARTITION_TOTAL) / VAL_PARTITION_TOTAL
    train_mix[0] = int(round(train_partition * none_fraction))

    val_partition_total = max(1, int(round(VAL_PARTITION_TOTAL * scale)))
    partition_total = sum(
        v for c, v in train_mix.items() if c != 0
    )
    val_mix = {
        c: max(1, int(round(v / partition_total * val_partition_total)))
        for c, v in train_mix.items() if c != 0
    }
    val_mix[0] = int(round(val_partition_total * none_fraction))

    def build(mix, gen_seed):
        gen = np.random.default_rng(gen_seed)
        labels = _labels_from_mix(mix, gen)
        samples = synth_blocks(labels, gen, size=size, noise=noise)
        qps = gen.integers(60, 140, len(labels)).astype(np.int32)
        return BlockSet(samples=samples, labels=labels, qps=qps)

    return build(train_mix, seed), build(val_mix, seed + 1)


__all__ = [
    "TRAIN_PARTITION_MIX",
    "class_templates",
    "reference_shaped_corpus",
    "synth_blocks",
]
