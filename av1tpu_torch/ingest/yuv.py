"""YUV 4:2:0 10-bit video ingestion.

The port's own copy of ``av1tpu.ingest.yuv``: lossless Y-plane (luma) frame
reading from raw ``.yuv`` files with strict size/geometry validation, numpy
only:

* plane geometry is computed once (`Yuv420p10Geometry`)
* frames are read by seeking to ``frame_index * frame_bytes`` and viewing the
  bytes as little-endian uint16 — no per-pixel work
* optional 10-bit range validation is a single vectorized comparison

Tiling lives in :mod:`av1tpu_torch.ingest.tiler`; this module is just fast
IO + geometry.
"""
from __future__ import annotations

import os
import re
from dataclasses import dataclass
from pathlib import Path
from typing import Iterator, Optional, Tuple

import numpy as np

BYTES_PER_SAMPLE = 2  # 10-bit stored in 16-bit little-endian words
MAX_10BIT = 1023


@dataclass(frozen=True)
class Yuv420p10Geometry:
    """Byte-layout arithmetic for a YUV 4:2:0 10-bit (yuv420p10le) file."""

    width: int
    height: int

    @property
    def y_samples(self) -> int:
        return self.width * self.height

    @property
    def y_bytes(self) -> int:
        return self.y_samples * BYTES_PER_SAMPLE

    @property
    def chroma_bytes(self) -> int:
        # U and V each are (W/2)x(H/2); ceil to handle odd dimensions the same
        # way libaom allocates them.
        cw = (self.width + 1) // 2
        ch = (self.height + 1) // 2
        return cw * ch * BYTES_PER_SAMPLE

    @property
    def frame_bytes(self) -> int:
        return self.y_bytes + 2 * self.chroma_bytes

    def num_frames(self, file_size: int) -> int:
        return file_size // self.frame_bytes

    def validate_file(self, path: Path) -> Tuple[int, int]:
        """Return (num_frames, remainder_bytes); raise if the file is empty
        or smaller than a single frame."""
        size = os.path.getsize(path)
        if size < self.frame_bytes:
            raise ValueError(
                f"{path}: file size {size} smaller than one frame "
                f"({self.frame_bytes} bytes for {self.width}x{self.height})"
            )
        return size // self.frame_bytes, size % self.frame_bytes


_RESOLUTION_RE = re.compile(r"(\d{2,5})x(\d{2,5})")


def infer_resolution(name: str) -> Optional[Tuple[int, int]]:
    """Infer ``(width, height)`` from a filename like ``Foo_1920x1080_60.yuv``."""
    m = _RESOLUTION_RE.search(name)
    if m is None:
        return None
    return int(m.group(1)), int(m.group(2))


def read_y_frame(
    path: Path,
    frame_index: int,
    geometry: Yuv420p10Geometry,
    validate_range: bool = True,
) -> np.ndarray:
    """Read one luma plane losslessly as a ``(height, width)`` uint16 array.

    Seek to the frame offset, read ``W*H*2`` bytes, reinterpret as ``<u2``.
    With ``validate_range`` a vectorized check enforces the 10-bit
    [0, 1023] range.
    """
    offset = frame_index * geometry.frame_bytes
    with open(path, "rb", buffering=0) as f:
        f.seek(offset)
        raw = f.read(geometry.y_bytes)
    if len(raw) != geometry.y_bytes:
        raise EOFError(
            f"{path}: short read at frame {frame_index}: "
            f"got {len(raw)} bytes, wanted {geometry.y_bytes}"
        )
    plane = np.frombuffer(raw, dtype="<u2").reshape(geometry.height, geometry.width)
    if validate_range and plane.max(initial=0) > MAX_10BIT:
        bad = int(plane.max())
        raise ValueError(
            f"{path}: frame {frame_index} exceeds 10-bit range (max={bad})"
        )
    return plane


def iter_y_frames(
    path: Path,
    geometry: Yuv420p10Geometry,
    start: int = 0,
    stop: Optional[int] = None,
    validate_range: bool = True,
) -> Iterator[np.ndarray]:
    """Iterate luma planes ``start..stop`` (stop exclusive; None = all)."""
    total, _ = geometry.validate_file(Path(path))
    stop = total if stop is None else min(stop, total)
    for idx in range(start, stop):
        yield read_y_frame(path, idx, geometry, validate_range=validate_range)


def read_y_frames_batch(
    path: Path,
    geometry: Yuv420p10Geometry,
    frame_indices,
    validate_range: bool = False,
) -> np.ndarray:
    """Read several luma planes into one ``(F, H, W)`` uint16 array.

    Batched ingestion hands ``kernels.preprocess.tile_normalize_frames``
    whole groups of frames at once.
    """
    frames = np.empty(
        (len(frame_indices), geometry.height, geometry.width), dtype=np.uint16
    )
    with open(path, "rb", buffering=0) as f:
        for i, idx in enumerate(frame_indices):
            f.seek(idx * geometry.frame_bytes)
            raw = f.read(geometry.y_bytes)
            if len(raw) != geometry.y_bytes:
                raise EOFError(f"{path}: short read at frame {idx}")
            frames[i] = np.frombuffer(raw, dtype="<u2").reshape(
                geometry.height, geometry.width
            )
    if validate_range and frames.max(initial=0) > MAX_10BIT:
        raise ValueError(f"{path}: batch exceeds 10-bit range")
    return frames


__all__ = [
    "BYTES_PER_SAMPLE",
    "MAX_10BIT",
    "Yuv420p10Geometry",
    "infer_resolution",
    "iter_y_frames",
    "read_y_frame",
    "read_y_frames_batch",
]
