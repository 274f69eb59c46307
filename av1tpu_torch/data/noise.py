"""Adversarial noise-injection datasets for stage-3 robustness training.

Counterpart of ``av1tpu.data.noise``: a stage-3 specialist trains on a mix of
clean samples and samples of *other* partition families carrying random
specialist labels, which simulates upstream stage-2 misclassification
(``005_train_stage3_rect.py:38-122``, ``006_train_stage3_ab_fgvc.py:46-128``).
The mixed set is materialized once as a bundle. The draws are numpy's
``RandomState(seed)``, so the bundle equals the JAX package's bitwise.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from av1tpu_torch.data.bundles import Bundle


def build_noisy_bundle(
    clean: Bundle,
    noise_sources: Sequence[Bundle],
    label_key: str,
    num_label_classes: int,
    noise_ratio: float = 0.25,
    seed: int = 42,
    label_distribution: Optional[np.ndarray] = None,
) -> Bundle:
    """Mix ``1 - noise_ratio`` clean samples with relabeled noise samples.

    The total equals ``len(clean)``; the clean subset is a sorted draw
    without replacement; the noise is split evenly across the sources, and
    each noise sample gets a label in ``[0, num_label_classes)``, uniform
    (the reference) or drawn from ``label_distribution`` (confusion-based
    noise, hypothesis H3.2)."""
    if not 0.0 <= noise_ratio < 1.0:
        raise ValueError("noise_ratio must be in [0, 1)")
    total = len(clean)
    n_clean = int(total * (1.0 - noise_ratio))
    n_noise = total - n_clean

    rng = np.random.RandomState(seed)  # the reference's generator
    clean_indices = np.sort(rng.choice(total, n_clean, replace=False))
    parts = [clean.take(clean_indices)]

    if n_noise and noise_sources:
        per_source = n_noise // len(noise_sources)
        for src in noise_sources:
            if per_source == 0:
                continue
            idx = rng.choice(len(src), min(per_source, len(src)), replace=False)
            sub = src.take(idx)
            if label_distribution is not None:
                probs = np.asarray(label_distribution, dtype=np.float64)
                random_labels = rng.choice(num_label_classes, size=len(sub),
                                           p=probs / probs.sum()).astype(np.int32)
            else:
                random_labels = rng.randint(0, num_label_classes,
                                            size=len(sub)).astype(np.int32)
            labels = {k: v.copy() for k, v in sub.labels.items()}
            labels[label_key] = random_labels
            parts.append(Bundle(samples=sub.samples, qps=sub.qps, labels=labels))

    keys = parts[0].labels.keys()
    return Bundle(samples=np.concatenate([p.samples for p in parts], axis=0),
                  qps=np.concatenate([p.qps for p in parts], axis=0),
                  labels={k: np.concatenate([p.labels[k] for p in parts], axis=0)
                          for k in keys})


__all__ = ["build_noisy_bundle"]
