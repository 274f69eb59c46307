"""Helpers the port's examples share: the packed validation clip, the step
runner, the flat model directory of ``predict_trees``, the ``--device`` and
``--fused-front`` flags, and a wall clock that waits for the card."""
from __future__ import annotations

import argparse
import time
from pathlib import Path
from typing import Callable, Dict, Iterable, Optional, Sequence, Union

import numpy as np
import torch

FRAME_COLS, FRAME_ROWS = 20, 12          # 1280 x 768: 240 superblocks/frame
FRAME_W, FRAME_H = FRAME_COLS * 64, FRAME_ROWS * 64
SB_PER_FRAME = FRAME_COLS * FRAME_ROWS

# --fused-front's values -> the folded pipelines' use_fused_front
FUSED_FRONT = {"off": False, "on": True, "g1": "g1"}


def pack_yuv(superblocks: np.ndarray, path: Path) -> int:
    """Write superblocks into a yuv420p10le clip, row-major 64px grid per
    frame (matching ingest.tiler.tile_frame order). Returns frame count.
    Count must be a multiple of SB_PER_FRAME (caller sizes the val set)."""
    sbs = np.asarray(superblocks)
    if sbs.ndim == 4:
        sbs = sbs[..., 0]
    n = sbs.shape[0]
    assert n % SB_PER_FRAME == 0, (n, SB_PER_FRAME)
    frames = n // SB_PER_FRAME
    uv = np.zeros((FRAME_H // 2, FRAME_W // 2), dtype="<u2")
    with Path(path).open("wb") as f:
        for fi in range(frames):
            grid = sbs[fi * SB_PER_FRAME:(fi + 1) * SB_PER_FRAME]
            plane = (
                grid.reshape(FRAME_ROWS, FRAME_COLS, 64, 64)
                .transpose(0, 2, 1, 3)
                .reshape(FRAME_H, FRAME_W)
            )
            f.write(plane.astype("<u2").tobytes())
            f.write(uv.tobytes())
            f.write(uv.tobytes())
    return frames


def assemble_models_dir(src: Path, dest: Path) -> None:
    """predict_trees wants all four stage npz files in ONE directory;
    the demo/training layout keeps them under per-stage subdirs."""
    src, dest = Path(src), Path(dest)
    dest.mkdir(parents=True, exist_ok=True)
    names = [
        ("stage1", "stage1_best_variables.npz"),
        ("stage2", "stage2_best_variables.npz"),
        ("stage3_rect", "stage3_rect_best_variables.npz"),
        ("stage3_ab", "stage3_ab_best_variables.npz"),
        ("stage3_ab", "stage3_ab_fgvc_best_variables.npz"),
        ("unified_kd", "unified_best_variables.npz"),
        ("unified", "unified_best_variables.npz"),
    ]
    for sub, fname in names:
        for cand in (src / sub / fname, src / fname):
            if cand.exists() and not (dest / fname).exists():
                (dest / fname).symlink_to(cand.resolve())
                break


def add_device_arg(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                        help="where every CLI and library call runs; cuda needs "
                        "a GPU and nothing falls back to the CPU")


def add_fused_front_arg(parser: argparse.ArgumentParser,
                        choices: Sequence[str] = tuple(FUSED_FRONT)) -> None:
    parser.add_argument("--fused-front", choices=tuple(choices), default="off",
                        help="folded serving: stem + maxpool as kernel K1 (on) "
                        "or stem + maxpool + layer group 1 + SE1 as kernel K2 "
                        "(g1) at the 16 and 8 px blocks")


def parse_example_args(parser: argparse.ArgumentParser, argv=None) -> argparse.Namespace:
    """``parser.parse_args(argv)``, refusing ``--device cuda`` without a card."""
    args = parser.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        parser.error("--device cuda: no CUDA device is available")
    return args


def synchronize(device) -> None:
    """Wait for the card's queued work; nothing on the CPU."""
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def timed(fn: Callable[[], object], device) -> tuple:
    """``(fn(), seconds)``, the card synchronised before each clock read."""
    synchronize(device)
    start = time.perf_counter()
    out = fn()
    synchronize(device)
    return out, time.perf_counter() - start


class Steps:
    """Runs one CLI step at a time and prints its wall clock. With
    ``resume``, a step whose completion sentinels (``done``: a path or
    paths, each written at the step's end) all exist is skipped.
    ``record``, when given, gets ``record[name]["wall_seconds"]``."""

    def __init__(self, device, resume: bool = False,
                 record: Optional[Dict[str, dict]] = None):
        self.device = device
        self.resume = resume
        self.record = record

    def __call__(self, name: str, fn: Callable, argv: list,
                 done: Union[None, str, Path, Iterable] = None) -> Optional[float]:
        sentinels = ([] if done is None
                     else [done] if isinstance(done, (str, Path))
                     else list(done))
        if self.resume and sentinels and all(Path(p).exists() for p in sentinels):
            print(f"\n=== {name}: complete "
                  f"({', '.join(Path(p).name for p in sentinels)} exist), "
                  "skipped ===", flush=True)
            return None
        print(f"\n=== {name} ===", flush=True)
        _, seconds = timed(lambda: fn(argv), self.device)
        if self.record is not None:
            self.record.setdefault(name, {})["wall_seconds"] = round(seconds, 1)
        print(f"=== {name} done in {seconds:.1f}s ===", flush=True)
        return seconds

