"""ctypes bindings for the native (C++) YUV ingestion library.

The port's own copy of ``av1tpu.ingest.native``. It loads the same
``native/libav1tpu_io.so`` (built with ``make -C native``; ``native/``
belongs to neither package), or the file ``AV1TPU_NATIVE_LIB`` names:
multithreaded pread-based frame loading and block tiling straight into
caller-owned numpy buffers. Falls back transparently to the pure-numpy
:mod:`av1tpu_torch.ingest.yuv` / :mod:`av1tpu_torch.ingest.tiler` paths when
the library is not built, so the native layer is an accelerator, never a
dependency: a host reader, not a device kernel.
"""
from __future__ import annotations

import ctypes
import math
import os
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

from av1tpu_torch.ingest.tiler import tile_frames as _tile_frames_np
from av1tpu_torch.ingest.yuv import Yuv420p10Geometry, read_y_frames_batch

_LIB_CANDIDATES = (
    Path(__file__).resolve().parents[2] / "native" / "libav1tpu_io.so",
    Path(__file__).resolve().parent / "libav1tpu_io.so",
)

_lib: Optional[ctypes.CDLL] = None


def _load() -> Optional[ctypes.CDLL]:
    """Load the native library, memoizing only SUCCESS: a miss re-probes,
    so building the .so later in a process (e.g. a test fixture running
    ``make`` after another module already fell back to numpy) is picked
    up. The retry cost is two ``Path.exists`` calls."""
    global _lib
    if _lib is not None:
        return _lib
    override = os.environ.get("AV1TPU_NATIVE_LIB")
    candidates = ((Path(override),) if override else ()) + _LIB_CANDIDATES
    for path in candidates:
        if path.exists():
            lib = ctypes.CDLL(str(path))
            lib.av1tpu_read_y_frames.restype = ctypes.c_int
            lib.av1tpu_read_y_frames.argtypes = [
                ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64,
                ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
                ctypes.POINTER(ctypes.c_uint16), ctypes.c_int, ctypes.c_int,
            ]
            lib.av1tpu_tile_frames.restype = ctypes.c_int
            lib.av1tpu_tile_frames.argtypes = [
                ctypes.POINTER(ctypes.c_uint16), ctypes.c_int64,
                ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                ctypes.POINTER(ctypes.c_uint16), ctypes.c_int,
            ]
            lib.av1tpu_probe_yuv.restype = ctypes.c_int
            lib.av1tpu_probe_yuv.argtypes = [
                ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64,
                ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
            ]
            _lib = lib
            break
    return _lib


def native_available() -> bool:
    return _load() is not None


def read_y_frames(
    path: Path,
    geometry: Yuv420p10Geometry,
    frame_indices: Sequence[int],
    validate_range: bool = False,
    num_threads: int = 0,
) -> np.ndarray:
    """Batched luma read — native multithreaded pread when built, numpy
    fallback otherwise. Returns (F, H, W) uint16."""
    lib = _load()
    if lib is None:
        return read_y_frames_batch(
            path, geometry, list(frame_indices), validate_range=validate_range
        )
    idx = np.asarray(frame_indices, dtype=np.int64)
    out = np.empty(
        (len(idx), geometry.height, geometry.width), dtype=np.uint16
    )
    rc = lib.av1tpu_read_y_frames(
        str(path).encode(),
        geometry.width,
        geometry.height,
        idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        len(idx),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
        1 if validate_range else 0,
        num_threads,
    )
    if rc != 0:
        raise IOError(f"native read failed (code {rc}) for {path}")
    return out


def tile_frames(
    frames: np.ndarray, block_size: int, num_threads: int = 0
) -> np.ndarray:
    """Row-major zero-padded tiling — native threaded memcpy when built.
    Returns (F*rows*cols, bs, bs) uint16, bit-identical to the numpy tiler."""
    lib = _load()
    if lib is None:
        blocks, _ = _tile_frames_np(frames, block_size)
        return blocks
    f, h, w = frames.shape
    rows = math.ceil(h / block_size)
    cols = math.ceil(w / block_size)
    frames = np.ascontiguousarray(frames, dtype=np.uint16)
    out = np.empty((f * rows * cols, block_size, block_size), dtype=np.uint16)
    rc = lib.av1tpu_tile_frames(
        frames.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
        f, h, w, block_size,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
        num_threads,
    )
    if rc != 0:
        raise RuntimeError(f"native tiling failed (code {rc})")
    return out


def probe_yuv(path: Path, geometry: Yuv420p10Geometry):
    """(num_frames, remainder_bytes) via the native prober or numpy math."""
    lib = _load()
    if lib is None:
        return geometry.validate_file(Path(path))
    frames = ctypes.c_int64()
    remainder = ctypes.c_int64()
    rc = lib.av1tpu_probe_yuv(
        str(path).encode(), geometry.width, geometry.height,
        ctypes.byref(frames), ctypes.byref(remainder),
    )
    if rc != 0:
        raise IOError(f"native probe failed (code {rc}) for {path}")
    return frames.value, remainder.value


__all__ = ["native_available", "probe_yuv", "read_y_frames", "tile_frames"]
