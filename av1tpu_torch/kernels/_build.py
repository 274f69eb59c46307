"""Build the port's CUDA kernels with nvcc, load them with ctypes, and count
their launches.

``csrc/*.cu`` compile at first use, one nvcc process per source, all started
together, and link into one shared library with a plain C interface under
``build/av1tpu_torch_kernels/<hash>/`` at the root of the checkout. The hash
covers the sources, the headers and the flags, so an edit rebuilds and an
unchanged tree reuses the library. Nothing here runs at import time.

Every wrapper launches through :func:`launch`, which adds one to
``launch_counts[name]``: the one place where launches are counted.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from collections.abc import Mapping
from pathlib import Path
from typing import Dict, Iterable

import torch

_PKG = Path(__file__).resolve().parents[1]
SOURCES = tuple(sorted((_PKG / "csrc").glob("*.cu")))
HEADERS = tuple(sorted((_PKG / "csrc").glob("*.cuh")))
BUILD_ROOT = _PKG.parent / "build" / "av1tpu_torch_kernels"
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
LIB_NAME = "libav1tpu_torch_kernels.so"
KERNELS = ("fused_front", "fused_front_g1", "fused_group12",
           "tile_normalize_frames", "normalize_blocks", "fused_dense")

launch_counts: Dict[str, int] = {name: 0 for name in KERNELS}


def reset_launch_counts(names: Iterable[str] = KERNELS) -> None:
    for name in names:
        launch_counts[name] = 0


class CountsView(Mapping):
    """A live read-only view of ``launch_counts`` for some kernels."""

    def __init__(self, names):
        self._names = tuple(names)

    def __getitem__(self, name):
        if name not in self._names:
            raise KeyError(name)
        return launch_counts[name]

    def __iter__(self):
        return iter(self._names)

    def __len__(self):
        return len(self._names)

    def __repr__(self):
        return repr(dict(self))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and Path(home, "bin", "nvcc").exists():
            return str(Path(home, "bin", "nvcc"))
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def _run_all(cmds, logs):
    """Run the commands in parallel; raise with the output of the first
    that fails. Each command's output goes to its log file."""
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for cmd in cmds]
    failed = None
    for proc, log in zip(procs, logs):
        out, _ = proc.communicate()
        log.write_text(out)
        if proc.returncode != 0 and failed is None:
            failed = f"{' '.join(proc.args)} exited {proc.returncode}:\n{out}"
    if failed:
        raise RuntimeError(f"nvcc failed: {failed}")


def build_kernels() -> Path:
    """Compile the sources unless a library for their hash exists; return
    its path. A failed build raises with nvcc's output."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in SOURCES + HEADERS:
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    out_dir = BUILD_ROOT / digest.hexdigest()[:16]
    lib = out_dir / LIB_NAME
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc, tag = _nvcc(), os.getpid()
    objs = [out_dir / f"{src.stem}.{tag}.o" for src in SOURCES]
    _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
              for src, obj in zip(SOURCES, objs)],
             [out_dir / f"{src.stem}.nvcc.log" for src in SOURCES])
    tmp = out_dir / f"{LIB_NAME}.{tag}.tmp"
    _run_all([[nvcc, *ARCH, "-shared", "-o", str(tmp), *map(str, objs)]],
             [out_dir / "link.log"])
    for obj in objs:
        obj.unlink()
    os.replace(tmp, lib)  # atomic: a concurrent loader sees all or nothing
    return lib


@functools.cache
def load_kernels() -> ctypes.CDLL:
    """The kernel library, built if needed, with its C signatures set."""
    lib = ctypes.CDLL(str(build_kernels()))
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    signatures = {
        "av1_fused_front": [ptr] * 4 + [i32] * 3 + [ptr],
        "av1_fused_front_g1": [ptr] * 10 + [i32] * 3 + [ptr],
        "av1_fused_front_g1_encode_map": [ptr, ptr],
        "av1_fused_group12": [ptr] * 5 + [i32] * 3 + [ptr],
        "av1_group12_encode_maps": [ptr, ptr, i32, i32, ptr],
        "av1_tile_normalize_frames": [ptr] * 2 + [i32] * 5 + [ptr],
        "av1_normalize_blocks": [ptr, ptr, i64, i32, ptr],
        "av1_fused_dense": [ptr] * 4 + [i32] * 6 + [ptr],
    }
    for name, argtypes in signatures.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = i32
    lib.av1_cuda_error_string.argtypes = [i32]
    lib.av1_cuda_error_string.restype = ctypes.c_char_p
    return lib


def check_launch(name: str, code: int) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if code != 0:
        msg = load_kernels().av1_cuda_error_string(code).decode()
        raise RuntimeError(f"{name}: CUDA error {code} ({msg})")


def launch(name: str, *args) -> None:
    """Call the C entry point ``av1_<name>``, raise on a CUDA error, and
    count the launch."""
    check_launch(name, getattr(load_kernels(), f"av1_{name}")(*args))
    launch_counts[name] += 1


def stream_of(t) -> int:
    """The raw handle of the current CUDA stream on ``t``'s device."""
    return torch.cuda.current_stream(t.device).cuda_stream


__all__ = [
    "BUILD_ROOT",
    "CountsView",
    "HEADERS",
    "KERNELS",
    "SOURCES",
    "build_kernels",
    "check_launch",
    "launch",
    "launch_counts",
    "load_kernels",
    "reset_launch_counts",
    "stream_of",
]
