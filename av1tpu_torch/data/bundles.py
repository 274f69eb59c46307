"""Dataset split bundles: the train/val artifacts the pipeline eval reads.

The port's own copy of the container part of ``av1tpu.data.bundles``, with
the same npz keys (``samples``, ``qps``, ``label__<view>``) and the same
``metadata.json``, so a dataset written by either package loads in the other.
Bundles are compressed ``.npz`` with uint16 NHWC samples (normalized once, on
the device; see :mod:`av1tpu_torch.data.records`) and every hierarchical
label view precomputed, and the stage-2 filter ``analyze_confusion`` uses. The
functions that make those views from block records are not ported yet
(ROADMAP M13).
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
)


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
    "bundle_metadata",
    "class_counts",
    "filter_stage2_v6",
    "save_split",
]
