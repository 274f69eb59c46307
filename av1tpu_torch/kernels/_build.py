"""Build the port's CUDA kernels with nvcc and load them with ctypes.

``csrc/*.cu`` compile at first use into one shared library with a plain C
interface, under ``build/av1tpu_torch_kernels/<hash>/`` at the root of the
checkout; the hash covers the sources and the flags, so an edit rebuilds
and an unchanged tree reuses the library. Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
SOURCES = tuple(sorted((_PKG / "csrc").glob("*.cu")))
BUILD_ROOT = _PKG.parent / "build" / "av1tpu_torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
LIB_NAME = "libav1tpu_torch_kernels.so"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and Path(home, "bin", "nvcc").exists():
            return str(Path(home, "bin", "nvcc"))
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def build_kernels() -> Path:
    """Compile the sources unless a library for their hash exists; return
    its path. A failed build raises with nvcc's output."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in SOURCES:
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    out_dir = BUILD_ROOT / digest.hexdigest()[:16]
    lib = out_dir / LIB_NAME
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f"{LIB_NAME}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, SOURCES)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    (out_dir / "nvcc.log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed with exit code {proc.returncode}:\n{proc.stderr}"
        )
    os.replace(tmp, lib)  # atomic: a concurrent loader sees all or nothing
    return lib


@functools.cache
def load_kernels() -> ctypes.CDLL:
    """The kernel library, built if needed, with its C signatures set."""
    lib = ctypes.CDLL(str(build_kernels()))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.av1_fused_front.argtypes = [ptr] * 4 + [i32] * 3 + [ptr]
    lib.av1_fused_front.restype = i32
    lib.av1_fused_front_g1.argtypes = [ptr] * 8 + [i32] * 3 + [ptr]
    lib.av1_fused_front_g1.restype = i32
    lib.av1_cuda_error_string.argtypes = [i32]
    lib.av1_cuda_error_string.restype = ctypes.c_char_p
    return lib


def check_launch(name: str, code: int) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if code != 0:
        msg = load_kernels().av1_cuda_error_string(code).decode()
        raise RuntimeError(f"{name}: CUDA error {code} ({msg})")


__all__ = ["BUILD_ROOT", "SOURCES", "build_kernels", "check_launch", "load_kernels"]
