"""Dataset split bundles: the train/val artifacts the trainers and the
pipeline eval read.

The port's own copy of ``av1tpu.data.bundles``, with the same npz keys
(``samples``, ``qps``, ``label__<view>``) and the same ``metadata.json``, so a
dataset written by either package loads in the other. Bundles are compressed
``.npz`` with uint16 NHWC samples (normalized once, on the device; see
:mod:`av1tpu_torch.data.records`) and every hierarchical label view
precomputed through the codec tables: the v5, v6 and flatten builders, the
stage filters, AB oversampling and the ensemble shuffles, byte for byte the
JAX package's.
"""
from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List

import numpy as np

from av1tpu_torch.codec.partitions import (
    FLATTEN_ID_TO_NAME,
    STAGE2_NAMES_V5,
    STAGE2_NAMES_V6,
    map_to_flatten,
    map_to_stage1,
    map_to_stage2_v5,
    map_to_stage2_v6,
    map_to_stage3_v5,
    map_to_stage3_v6,
)
from av1tpu_torch.data.records import BlockSet
from av1tpu_torch.data.sampling import oversample_indices, shuffled_epoch_indices


@dataclass
class Bundle:
    """A materialized dataset split: samples + all label views."""

    samples: np.ndarray            # (N, bs, bs, 1) uint16
    qps: np.ndarray                # (N,) int32
    labels: Dict[str, np.ndarray]  # label view name -> (N,) int32

    def __len__(self) -> int:
        return int(self.samples.shape[0])

    def take(self, indices: np.ndarray) -> "Bundle":
        return Bundle(
            samples=self.samples[indices],
            qps=self.qps[indices],
            labels={k: v[indices] for k, v in self.labels.items()},
        )

    def save(self, path: Path) -> None:
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        np.savez_compressed(
            path,
            samples=self.samples,
            qps=self.qps,
            **{f"label__{k}": v for k, v in self.labels.items()},
        )

    @staticmethod
    def load(path: Path) -> "Bundle":
        with np.load(path) as z:
            labels = {
                k[len("label__"):]: z[k] for k in z.files if k.startswith("label__")
            }
            return Bundle(samples=z["samples"], qps=z["qps"], labels=labels)


def build_v5_bundle(record: BlockSet) -> Bundle:
    """v5 label views: stage0 raw, stage1 binary, stage2 5-way, 3 specialist
    heads (``008_prepare_hierarchical_dataset.py:76-107`` key contract)."""
    stage3 = map_to_stage3_v5(record.labels)
    return Bundle(
        samples=record.samples,
        qps=record.qps,
        labels={
            "stage0": record.labels.astype(np.int32),
            "stage1": map_to_stage1(record.labels).astype(np.int32),
            "stage2": map_to_stage2_v5(record.labels).astype(np.int32),
            "stage3_RECT": stage3["RECT"].astype(np.int32),
            "stage3_AB": stage3["AB"].astype(np.int32),
            "stage3_1TO4": stage3["1TO4"].astype(np.int32),
        },
    )


def build_v6_bundle(record: BlockSet) -> Bundle:
    """v6 label views: 3-way stage2 with -1 for NONE/1TO4
    (``001_prepare_v6_dataset.py:85-104`` key contract)."""
    stage2, _ = map_to_stage2_v6(record.labels)
    stage3 = map_to_stage3_v6(record.labels)
    return Bundle(
        samples=record.samples,
        qps=record.qps,
        labels={
            "stage0": record.labels.astype(np.int32),
            "stage1": map_to_stage1(record.labels).astype(np.int32),
            "stage2": stage2.astype(np.int32),
            "stage3_RECT": stage3["RECT"].astype(np.int32),
            "stage3_AB": stage3["AB"].astype(np.int32),
        },
    )


def build_flatten_bundle(record: BlockSet) -> Bundle:
    """7-way flatten bundle: NONE dropped, ids remapped
    (``001b_prepare_flatten_dataset.py:117-166``). Raises on labels outside
    the expected remap domain, like the reference's hard ValueError."""
    flat = map_to_flatten(record.labels)
    keep = flat >= 0
    dropped_not_none = np.sum(~keep & (record.labels != 0))
    if dropped_not_none and np.any(record.labels[~keep] > 9):
        raise ValueError("unexpected raw labels outside 0..9")
    sub = record.take(np.flatnonzero(keep))
    return Bundle(
        samples=sub.samples,
        qps=sub.qps,
        labels={
            "stage0": sub.labels.astype(np.int32),
            "flatten": map_to_flatten(sub.labels).astype(np.int32),
        },
    )


def filter_partitioned_only(bundle: Bundle) -> Bundle:
    """Drop PARTITION_NONE samples (v5 ``--partitioned-only``, 008:140-153)."""
    return bundle.take(np.flatnonzero(bundle.labels["stage0"] != 0))


def filter_stage3(bundle: Bundle, head: str) -> Bundle:
    """Keep only samples belonging to one specialist head (label >= 0)."""
    key = f"stage3_{head}"
    if key not in bundle.labels:
        raise ValueError(f"unknown stage3 head: {head}")
    return bundle.take(np.flatnonzero(bundle.labels[key] >= 0))


def oversample_ab(bundle: Bundle, factors: Dict[int, int]) -> Bundle:
    """Index-repetition oversampling of AB classes (reference default
    factors {HORZ_B:5, VERT_A:5}, ``002_prepare_v6_stage3_datasets.py:56-62``)."""
    return bundle.take(oversample_indices(bundle.labels["stage3_AB"], factors))


def ensemble_shuffles(
    bundle: Bundle, num_members: int = 3, seed: int = 42
) -> List[Bundle]:
    """Per-member shuffled copies for AB ensembles, seeds ``seed + 100*i``
    (reference ``002:159-180``)."""
    return [
        bundle.take(shuffled_epoch_indices(len(bundle), seed + 100 * i))
        for i in range(num_members)
    ]


def class_counts(labels: np.ndarray, num_classes: int) -> List[int]:
    valid = labels[labels >= 0]
    return np.bincount(valid, minlength=num_classes).tolist()


def bundle_metadata(
    train: Bundle, val: Bundle, variant: str, block_size: int
) -> Dict[str, object]:
    """Class-count metadata for loss weighting and audits."""
    meta: Dict[str, object] = {
        "variant": variant,
        "block_size": block_size,
        "train_samples": len(train),
        "val_samples": len(val),
        "label_views": sorted(train.labels.keys()),
    }
    for split_name, split in (("train", train), ("val", val)):
        stats: Dict[str, object] = {}
        stats["stage0_counts"] = class_counts(split.labels["stage0"], 10)
        if "stage1" in split.labels:
            stats["stage1_counts"] = class_counts(split.labels["stage1"], 2)
        if "stage2" in split.labels:
            n = len(STAGE2_NAMES_V6) if variant.startswith("v6") else len(STAGE2_NAMES_V5)
            stats["stage2_counts"] = class_counts(split.labels["stage2"], n)
        if "stage3_RECT" in split.labels:
            stats["stage3_RECT_counts"] = class_counts(split.labels["stage3_RECT"], 2)
        if "stage3_AB" in split.labels:
            stats["stage3_AB_counts"] = class_counts(split.labels["stage3_AB"], 4)
        if "flatten" in split.labels:
            stats["flatten_counts"] = class_counts(
                split.labels["flatten"], len(FLATTEN_ID_TO_NAME)
            )
        meta[split_name] = stats
    return meta


def filter_stage2_v6(bundle: Bundle) -> Bundle:
    """Keep only samples with a valid 3-way stage-2 label (SPLIT/RECT/AB)."""
    return bundle.take(np.flatnonzero(bundle.labels["stage2"] >= 0))


def save_split(
    out_dir: Path,
    block_size: int,
    train: Bundle,
    val: Bundle,
    variant: str,
) -> Path:
    """Write ``<out>/block_<S>/{train,val}.npz + metadata.json`` (the
    reference directory contract with npz instead of torch .pt)."""
    root = Path(out_dir) / f"block_{block_size}"
    root.mkdir(parents=True, exist_ok=True)
    train.save(root / "train.npz")
    val.save(root / "val.npz")
    meta = bundle_metadata(train, val, variant, block_size)
    (root / "metadata.json").write_text(json.dumps(meta, indent=2, sort_keys=True))
    return root


__all__ = [
    "Bundle",
    "build_flatten_bundle",
    "build_v5_bundle",
    "build_v6_bundle",
    "bundle_metadata",
    "class_counts",
    "ensemble_shuffles",
    "filter_partitioned_only",
    "filter_stage2_v6",
    "filter_stage3",
    "oversample_ab",
    "save_split",
]
