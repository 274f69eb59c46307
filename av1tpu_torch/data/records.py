"""Block records, their seeded split and the normalization policy.

The port's own copy of the container part of ``av1tpu.data.records``:
:class:`BlockSet` (NHWC uint16 samples, raw partition labels, QPs),
``train_test_split`` (the reference's seeded permutation) and
``normalize_images``. Samples stay uint16 end to end and are normalized
exactly once, on the device, at the model's input, by ``NORM_10BIT``. The
text-layout, native-npz and ``.pt`` loaders are not ported yet (ROADMAP M13).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np

NORM_10BIT = 1023.0
# Reference-compat: v6 stage-1/2 effectively divide by 1023 twice (quirk Q1).
NORM_10BIT_DOUBLE = 1023.0 * 1023.0


@dataclass
class BlockSet:
    """All samples for one block size: NHWC uint16 + labels + QPs."""

    samples: np.ndarray  # (N, bs, bs, 1) uint16
    labels: np.ndarray   # (N,) int32 raw partition ids 0..9
    qps: np.ndarray      # (N,) int32

    def __post_init__(self):
        n = self.samples.shape[0]
        if self.labels.shape[0] != n or self.qps.shape[0] != n:
            raise ValueError("samples/labels/qps length mismatch")

    @property
    def block_size(self) -> int:
        return int(self.samples.shape[1])

    def __len__(self) -> int:
        return int(self.samples.shape[0])

    def take(self, indices: np.ndarray) -> "BlockSet":
        return BlockSet(samples=self.samples[indices], labels=self.labels[indices],
                        qps=self.qps[indices])

    def concat(self, other: "BlockSet") -> "BlockSet":
        return BlockSet(
            samples=np.concatenate([self.samples, other.samples], axis=0),
            labels=np.concatenate([self.labels, other.labels], axis=0),
            qps=np.concatenate([self.qps, other.qps], axis=0),
        )


def train_test_split(
    record: BlockSet, test_ratio: float = 0.2, seed: int = 42
) -> Tuple[BlockSet, BlockSet]:
    """Seeded permutation split, the reference's (``data_hub.py:194-213``:
    ``np.random.default_rng(seed).permutation``)."""
    if not 0 < test_ratio < 1:
        raise ValueError("test_ratio must be between 0 and 1")
    indices = np.random.default_rng(seed).permutation(len(record))
    split_point = int(len(record) * (1 - test_ratio))
    return record.take(indices[:split_point]), record.take(indices[split_point:])


def normalize_images(samples: np.ndarray, norm_scale: float = NORM_10BIT) -> np.ndarray:
    """uint16 NHWC -> float32 NHWC in [0, 1] (or compat double-normalized)."""
    return samples.astype(np.float32) / norm_scale


__all__ = ["BlockSet", "NORM_10BIT", "NORM_10BIT_DOUBLE", "normalize_images",
           "train_test_split"]
