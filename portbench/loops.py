"""The two traffic loops, ``cascade`` and ``blocks``: set-up from the seed,
warm-up, the measured window, and in a traced run an untraced and a profiled
phase. Each reads its mix's parameters from ``traffic/<mix>.json``.

``cascade`` drives the port's whole-frame entries. Its ``loop`` is

* ``overlap``: ``frames_per_dispatch`` frames are tiled on the host and sent
  as one ``predict_partition_trees(..., as_numpy=False)`` call; the next
  group is tiled while the device computes, then this group's trees and modes
  come back to the host as numpy (the tree CLI's overlap without its disk IO);
* ``frame``: one ``predict_frame_trees(..., as_numpy=False)`` call a frame,
  its outputs pulled to the host before the next frame is handed over (a live
  encoder waits for each frame's trees).

``blocks`` drives ``run_pipeline_batched`` over a host dataset of
``dataset_blocks`` blocks of ``block_px``, whole passes, labels back as numpy.

Both are closed loops with one client. The window starts at the first timed
dispatch and closes when the last dispatch started before ``seconds`` has
completed; every frame or block of those dispatches counts.
"""
from __future__ import annotations

import gc
import time
from typing import Callable, Dict, List

import numpy as np
import torch

from portbench import trace
from portbench.reference.cascade import LEVELS, NODES, quad_tile, tile_superblocks

SB = 64


def now() -> float:
    return time.perf_counter()


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _settle() -> None:
    """Collect set-up's garbage and exempt what survives from later
    collections, so that the window's collections scan only its own objects."""
    gc.collect()
    gc.freeze()


def _window(step: Callable[[int], dict], seconds: float, first: int = 0) -> List[dict]:
    """Dispatches from ``first`` on, started while under ``seconds`` have
    passed since the window opened (at least one)."""
    _settle()
    records, t0, k = [], now(), first
    while not records or now() - t0 < seconds:
        records.append(step(k))
        k += 1
    for r in records:
        r["t_open"] = t0
    return records


def level_rows(traffic: dict, superblocks: int) -> Dict[int, int]:
    """Rows each level's predictor serves for ``superblocks`` superblocks:
    every node, or under ``level_capacities`` the K the gate selects."""
    caps = {int(k): float(v) for k, v in (traffic.get("level_capacities") or {}).items()}
    out = {}
    for size, nodes in zip(LEVELS, NODES):
        total = superblocks * nodes
        cap = caps.get(size, 1.0)
        out[size] = total if size == LEVELS[0] or cap >= 1.0 else min(
            max(int(np.ceil(cap * total)), 1), total)
    return out


def _traced(step, device, k0: int, untraced: int, profiled: int, spans) -> tuple:
    """An untraced phase (host clock) and a profiled one (device trace)."""
    _settle()
    host = [step(k0 + i) for i in range(untraced)]
    sync(device)
    spans.on = True
    with trace.profiler(device) as prof:
        with spans(trace.WINDOW):
            traced = [step(k0 + untraced + i) for i in range(profiled)]
            sync(device)
    spans.on = False
    return host, traced, trace.summarize(trace.events(prof, spans))


def _in_span(spans, name: str, fn: Callable) -> Callable:
    """``fn`` inside the host range ``name``."""
    def predict(images):
        with spans(name):
            return fn(images)
    return predict


def _calibration_blocks(gen, source: np.ndarray, size: int, count: int, device) -> np.ndarray:
    """``count`` blocks of ``size`` px drawn from ``source`` rows, by the
    seed's generator."""
    pick = torch.randperm(source.shape[0], generator=gen, device=device)[:count].cpu().numpy()
    return source[np.sort(pick)]


class Cascade:
    """Frames through the tree cascade."""

    def __init__(self, traffic: dict, gen: torch.Generator, device: torch.device):
        from portbench.data import frame
        self.traffic, self.device = traffic, device
        width, height = traffic["resolution"]
        self.pool = np.stack([frame(gen, width, height, device)
                              for _ in range(traffic["pool_frames"])])
        self.superblocks = (-(-height // SB)) * (-(-width // SB))
        self.grid = (-(-height // SB), -(-width // SB))
        sbs = np.concatenate([tile_superblocks(p) for p in self.pool[:traffic["calib_frames"]]])
        self.calib = {size: _calibration_blocks(gen, quad_tile(sbs, size), size,
                                                2 * traffic["calib_blocks"], device)
                      for size in LEVELS}
        self.levels = list(LEVELS)

    def run(self, system, predictors: Dict[int, Callable], seconds: float, traced: bool) -> dict:
        t = self.traffic
        live = t["loop"] == "frame"
        fpd = 1 if live else t["frames_per_dispatch"]
        spans = trace.Spans()
        preds = {size: _in_span(spans, f"level_{size}", fn) for size, fn in predictors.items()}
        state = {}

        def frames_of(k):
            return [(k * fpd + i) % len(self.pool) for i in range(fpd)]

        def tile(k):
            return np.concatenate([system.tile_frame(self.pool[i], SB)[0] for i in frames_of(k)])

        def to_host(result):
            return {key: (v.cpu().numpy() if torch.is_tensor(v) else np.asarray(v))
                    for key, v in result.items()}

        def step(k):
            if not live and state.get("k") != k:
                state["sbs"], state["k"] = tile(k), k
            t0 = now()
            if live:
                with spans("cascade_call"):
                    result = system.predict_frame_trees(
                        self.pool[frames_of(k)[0]], preds, batch_size=t["batch_size"],
                        level_capacities=t.get("level_capacities"), as_numpy=False,
                        device=self.device)
                t_call = now() - t0
            else:
                with spans("cascade_call"):
                    result = system.predict_partition_trees(
                        state["sbs"], preds, batch_size=t["batch_size"],
                        level_capacities=t.get("level_capacities"), as_numpy=False,
                        device=self.device)
                t_call = now() - t0
                with spans("tile"):
                    state["sbs"], state["k"] = tile(k + 1), k + 1
            with spans("to_host"):
                out = to_host(result)
            return {"k": k, "frames": fpd, "pool": frames_of(k), "out": out, "t0": t0,
                    "t_call": t_call, "t_end": now()}

        for k in range(t["warm_dispatches"]):
            step(k)
        sync(self.device)
        first = t["warm_dispatches"]
        if traced:
            host, prof, summary = _traced(step, self.device, first, t["host_dispatches"],
                                          t["trace_dispatches"], spans)
            records = host + prof
            rows = level_rows(t, self.superblocks * fpd)
            host_s = host[-1]["t_end"] - host[0]["t0"]
            out = {"records": records, "host": {
                "cascade_call_s": [r["t_call"] for r in host], "seconds": host_s,
                "level_rows": {s: r * len(host) for s, r in rows.items()}}}
            if summary is not None:
                summary.update(frames=fpd * len(prof), dispatches=len(prof),
                               level_rows={s: r * len(prof) for s, r in rows.items()})
            out["trace"] = summary
            return out
        return {"records": _window(step, seconds, first)}

    def occurrences(self, records):
        """``(pool index, one frame's outputs)`` for every frame of the records."""
        for r in records:
            out = r["out"]
            for j, index in enumerate(r["pool"]):
                rows = slice(j * self.superblocks, (j + 1) * self.superblocks)
                frame = {key: v[rows] for key, v in out.items()
                         if key == "trees" or key.startswith("modes_")}
                if "grid_shape" in out:
                    frame["grid_shape"] = out["grid_shape"]
                yield index, frame


class Blocks:
    """A dataset of blocks through the batching layer."""

    def __init__(self, traffic: dict, gen: torch.Generator, device: torch.device):
        from portbench.data import block_dataset
        self.traffic, self.device = traffic, device
        px = traffic["block_px"]
        self.dataset = block_dataset(gen, traffic["dataset_blocks"], px, device)
        self.calib = {px: _calibration_blocks(gen, self.dataset[..., 0], px,
                                              2 * traffic["calib_blocks"], device)}
        self.levels = [px]

    def run(self, system, predictors: Dict[int, Callable], seconds: float, traced: bool) -> dict:
        t = self.traffic
        px, n = t["block_px"], t["dataset_blocks"]
        spans = trace.Spans()
        predict = _in_span(spans, "batch", predictors[px])

        def step(k):
            t0 = now()
            with spans("pass"):
                out = system.run_pipeline_batched(predict, self.dataset, batch_size=t["batch_size"],
                                                  device=self.device, as_numpy=True,
                                                  prefetch=t["prefetch"])
            return {"k": k, "blocks": n, "out": out, "t0": t0, "t_end": now()}

        for k in range(t["warm_dispatches"]):
            step(k)
        sync(self.device)
        first = t["warm_dispatches"]
        if traced:
            host, prof, summary = _traced(step, self.device, first, t["host_dispatches"],
                                          t["trace_dispatches"], spans)
            batches = -(-n // t["batch_size"])
            out = {"records": host + prof, "host": {
                "seconds": host[-1]["t_end"] - host[0]["t0"],
                "level_rows": {px: n * len(host)}}}
            if summary is not None:
                summary.update(batches=batches * len(prof), dispatches=len(prof),
                               level_rows={px: n * len(prof)})
            out["trace"] = summary
            return out
        return {"records": _window(step, seconds, first)}


LOOPS = {"cascade": Cascade, "blocks": Blocks}

__all__ = ["Blocks", "Cascade", "LOOPS", "level_rows"]
