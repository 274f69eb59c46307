"""Class-imbalance sampling strategies (host numpy).

The port's own copy of ``av1tpu.data.sampling``: deterministic epoch index
arrays in place of the reference's ``WeightedRandomSampler``
(``pesquisa_v6/v6_pipeline/data_hub.py:365-449``). A seeded generator draws
(with replacement) per-epoch sample indices whose class frequencies match the
target weights; the arrays are bitwise those of the JAX package for the same
seed, so both packages train on the same epoch orders.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np


def effective_number_weights(
    counts: np.ndarray, beta: float = 0.9999
) -> np.ndarray:
    """Class-Balanced weights via effective number of samples (Cui 2019).

    Same formula as the reference ``get_class_weights`` / CB-focal buffer
    (``data_hub.py:365-383``, ``losses.py:61-72``): weights are
    ``(1-beta)/(1-beta^n)``, normalized to sum to ``num_classes``. Empty
    classes are clamped to count 1 — their weight multiplies no sample's
    loss, but an inf would poison the normalization of every other class
    (e.g. block-8 stage-2 never sees SPLIT: 8 is the minimum size).
    """
    counts = np.asarray(counts, dtype=np.float64)
    effective_num = 1.0 - np.power(beta, np.maximum(counts, 1.0))
    weights = (1.0 - beta) / effective_num
    return (weights / weights.sum() * len(weights)).astype(np.float32)


def inverse_frequency_weights(counts: np.ndarray) -> np.ndarray:
    """Per-class 1/n weights normalized to sum to num_classes (reference
    ``create_balanced_sampler`` default path, data_hub.py:395-405)."""
    counts = np.asarray(counts, dtype=np.float64)
    weights = 1.0 / counts
    return (weights / weights.sum() * len(weights)).astype(np.float32)


def sample_weights_from_labels(
    labels: np.ndarray,
    class_weights: Optional[np.ndarray] = None,
    oversample_factor: Optional[Dict[int, float]] = None,
    beta: Optional[float] = None,
) -> np.ndarray:
    """Per-sample weights from per-class weights.

    Priority: explicit ``class_weights`` > ``oversample_factor`` dict >
    effective-number (if ``beta``) > inverse frequency.
    """
    labels = np.asarray(labels)
    unique, counts = np.unique(labels, return_counts=True)
    if class_weights is None:
        if oversample_factor is not None:
            class_weights = np.array(
                [oversample_factor.get(int(c), 1.0) for c in unique], dtype=np.float64
            )
            class_weights = (
                class_weights / class_weights.sum() * len(unique)
            ).astype(np.float32)
        elif beta is not None:
            class_weights = effective_number_weights(counts, beta)
        else:
            class_weights = inverse_frequency_weights(counts)
    sample_weights = np.zeros(len(labels), dtype=np.float32)
    for cls, w in zip(unique, class_weights):
        sample_weights[labels == cls] = w
    return sample_weights


def balanced_epoch_indices(
    labels: np.ndarray,
    epoch_seed: int,
    num_samples: Optional[int] = None,
    class_weights: Optional[np.ndarray] = None,
    oversample_factor: Optional[Dict[int, float]] = None,
) -> np.ndarray:
    """Weighted with-replacement index draw for one epoch.

    Functional equivalent of torch ``WeightedRandomSampler(weights, N,
    replacement=True)`` but deterministic in ``epoch_seed`` so every
    data-parallel host derives the identical global order and takes its own
    contiguous shard.
    """
    weights = sample_weights_from_labels(
        labels, class_weights=class_weights, oversample_factor=oversample_factor
    ).astype(np.float64)
    probs = weights / weights.sum()
    n = len(labels) if num_samples is None else num_samples
    rng = np.random.default_rng(epoch_seed)
    return rng.choice(len(labels), size=n, replace=True, p=probs)


def oversample_indices(
    labels: np.ndarray, oversample_factors: Dict[int, int]
) -> np.ndarray:
    """Static index-repetition oversampling (reference
    ``create_ab_oversampled_dataset``, data_hub.py:419-449): each sample of
    class ``c`` is repeated ``oversample_factors.get(c, 1)`` times, in
    original order."""
    labels = np.asarray(labels)
    reps = np.ones(len(labels), dtype=np.int64)
    for cls, factor in oversample_factors.items():
        reps[labels == cls] = factor
    return np.repeat(np.arange(len(labels), dtype=np.int64), reps)


def shuffled_epoch_indices(n: int, epoch_seed: int) -> np.ndarray:
    """Plain seeded permutation for unweighted epochs."""
    return np.random.default_rng(epoch_seed).permutation(n)


def host_shard(
    indices: np.ndarray, process_index: int, process_count: int
) -> np.ndarray:
    """This host's contiguous shard of a global epoch index order.

    Multi-host data loading contract: every process derives the identical
    global order from the shared ``epoch_seed`` (all sampling here is
    deterministic in it), then takes its contiguous slice — together the
    hosts realize exactly the torch ``WeightedRandomSampler`` class balance
    the reference used, with no inter-host communication. Trailing
    indices that don't divide evenly are dropped so per-host batch counts
    match (a collective requirement).
    """
    if not 0 <= process_index < process_count:
        raise ValueError(f"process_index {process_index} out of range")
    per_host = len(indices) // process_count
    start = process_index * per_host
    return indices[start : start + per_host]


__all__ = [
    "balanced_epoch_indices",
    "effective_number_weights",
    "host_shard",
    "inverse_frequency_weights",
    "oversample_indices",
    "sample_weights_from_labels",
    "shuffled_epoch_indices",
]
