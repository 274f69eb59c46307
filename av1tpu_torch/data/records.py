"""Block records: loading, splitting, and normalization policy.

The port's own copy of ``av1tpu.data.records``: :class:`BlockSet` (NHWC
uint16 samples, raw partition labels, QPs), its three loaders, the
reference's seeded split and ``normalize_images``. A BlockSet loads from

* the reference three-directory text layout (``intra_raw_blocks/``,
  ``labels/``, ``qps/``; the loader semantics of
  ``pesquisa_v5/v5_pipeline/data_hub.py:67-191``),
* the per-sequence ``.npz`` columnar files of
  :func:`av1tpu_torch.ingest.etl.write_npz`, or
* reference ``train.pt``/``val.pt`` torch bundles (as numpy arrays).

Samples stay uint16 end to end and are normalized exactly once, on the
device, at the model's input, by ``NORM_10BIT`` (quirk Q1 in SURVEY.md:
the reference divides v6 stage-1/2 inputs twice; ``NORM_10BIT_DOUBLE``
reproduces that on request).
"""
from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from av1tpu_torch.codec.partitions import BLOCK_SIZES

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


def index_sequences(base_path: Path) -> Dict[str, Dict[str, Dict[str, Optional[str]]]]:
    """Enumerate sample/label/QP file triplets per sequence and block size.

    File-name contract identical to the reference data hub
    (``data_hub.py:67-108``): sequences are discovered from
    ``intra_raw_blocks/*_sample_*.txt`` and label/QP files are resolved as
    ``<seq>_labels_<S>_intra.txt`` / ``<seq>_qps_<S>_intra.txt``.
    """
    base_path = Path(base_path).expanduser().resolve()
    dirs = {
        "samples": base_path / "intra_raw_blocks",
        "labels": base_path / "labels",
        "qps": base_path / "qps",
    }
    for name, folder in dirs.items():
        if not folder.is_dir():
            raise FileNotFoundError(f"Required directory missing: {folder} ({name})")

    sample_files = sorted(p for p in dirs["samples"].iterdir() if p.suffix == ".txt")
    sequence_names = {
        p.name.replace(".txt", "").split("_sample_")[0]
        for p in sample_files
        if "_sample_" in p.name
    }

    inventory: Dict[str, Dict[str, Dict[str, Optional[str]]]] = {}
    for seq in sorted(sequence_names):
        inventory[seq] = {}
        for block in BLOCK_SIZES:
            entry = {
                "sample": (dirs["samples"], f"{seq}_sample_{block}.txt"),
                "label": (dirs["labels"], f"{seq}_labels_{block}_intra.txt"),
                "qps": (dirs["qps"], f"{seq}_qps_{block}_intra.txt"),
            }
            inventory[seq][block] = {
                key: fname if (folder / fname).exists() else None
                for key, (folder, fname) in entry.items()
            }
    return inventory


def load_reference_layout(base_path: Path, block_size: str) -> BlockSet:
    """Load every complete sample/label/QP triplet for one block size.

    Bit-identical to the reference ``load_block_records``
    (``data_hub.py:144-191``): raw uint16 sample bytes, space-separated
    uint8 label/QP text, sequences concatenated in sorted order.
    """
    if block_size not in BLOCK_SIZES:
        raise ValueError(f"block_size must be one of {BLOCK_SIZES}, got {block_size}")
    base_path = Path(base_path)
    inventory = index_sequences(base_path)
    bs = int(block_size)

    samples, labels, qps = [], [], []
    for seq, blocks in inventory.items():
        entry = blocks.get(block_size)
        if not entry:
            continue
        if not (entry["sample"] and entry["label"] and entry["qps"]):
            continue
        raw = np.frombuffer(
            (base_path / "intra_raw_blocks" / entry["sample"]).read_bytes(),
            dtype="<u2",
        )
        samples.append(raw.reshape(-1, bs, bs, 1))
        labels.append(
            np.fromfile(base_path / "labels" / entry["label"], dtype=np.uint8, sep=" ")
        )
        qps.append(
            np.fromfile(base_path / "qps" / entry["qps"], dtype=np.uint8, sep=" ")
        )
    if not samples:
        raise RuntimeError(f"No samples found for block size {block_size}")
    return BlockSet(
        samples=np.concatenate(samples, axis=0),
        labels=np.concatenate(labels, axis=0).astype(np.int32),
        qps=np.concatenate(qps, axis=0).astype(np.int32),
    )


def load_npz_sequences(npz_dir: Path, block_size: int) -> BlockSet:
    """Load the native columnar format (``<seq>_block<S>.npz`` files)."""
    npz_dir = Path(npz_dir)
    paths = sorted(npz_dir.glob(f"*_block{block_size}.npz"))
    if not paths:
        raise RuntimeError(f"No *_block{block_size}.npz under {npz_dir}")
    samples, labels, qps = [], [], []
    for path in paths:
        with np.load(path) as z:
            samples.append(z["blocks"][..., None])
            labels.append(z["modes"].astype(np.int32))
            qps.append(z["qps"].astype(np.int32))
    return BlockSet(
        samples=np.concatenate(samples, axis=0),
        labels=np.concatenate(labels, axis=0),
        qps=np.concatenate(qps, axis=0),
    )


def load_torch_bundle(path: Path) -> Tuple[Dict[str, np.ndarray], Dict[str, object]]:
    """Compat: load a reference ``train.pt``/``val.pt`` bundle as numpy.

    Returns ``(arrays, meta)``. Sample tensors are converted NCHW->NHWC.
    The reference v6 bundles store *already-normalized* float samples
    (quirk Q1); callers should pass the appropriate ``norm_scale`` downstream.
    """
    payload = torch.load(path, map_location="cpu", weights_only=False)
    arrays: Dict[str, np.ndarray] = {}
    meta: Dict[str, object] = {}
    for key, value in payload.items():
        if isinstance(value, torch.Tensor):
            arr = value.numpy()
            if key in ("image", "samples") and arr.ndim == 4:
                arr = arr.transpose(0, 2, 3, 1)
            arrays[key] = arr
        else:
            meta[key] = value
    return arrays, meta


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


__all__ = ["BlockSet", "NORM_10BIT", "NORM_10BIT_DOUBLE", "index_sequences",
           "load_npz_sequences", "load_reference_layout", "load_torch_bundle",
           "normalize_images", "train_test_split"]
