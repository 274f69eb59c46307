"""Tracing and throughput observability.

The port's own copy of ``av1tpu.utils.profiling``. The reference has no
profiling at all (SURVEY.md §5: tqdm bars and hand-recorded epoch times).
Here ``trace`` captures a ``torch.profiler`` trace of any region (the host's
ops, and the card's kernels where there is a card) and writes it as a Chrome
trace (open it in ui.perfetto.dev); ``annotate`` names a region inside it
(an NVTX range too on the card); ``ThroughputMeter`` times steps and counts
items per second; ``device_memory_stats`` reads the CUDA caching allocator's
statistics per card.
"""
from __future__ import annotations

import contextlib
import json
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional

import torch
from torch.profiler import ProfilerActivity, profile, record_function


@contextlib.contextmanager
def trace(log_dir: Path, name: str = "av1tpu_torch"):
    """Capture a ``torch.profiler`` trace of the enclosed region, CPU and,
    where a card is present, CUDA; on exit it is written to
    ``log_dir/<name>.pt.trace.json``. Yields the profiler, whose
    ``key_averages()`` and ``events()`` the caller may read after the
    region."""
    log_dir = Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        with record_function(name):
            yield prof
    prof.export_chrome_trace(str(log_dir / f"{name}.pt.trace.json"))


@contextlib.contextmanager
def annotate(name: str):
    """Named region inside an active trace (and an NVTX range on the card)."""
    with contextlib.ExitStack() as stack:
        stack.enter_context(record_function(name))
        if torch.cuda.is_available():
            stack.enter_context(torch.cuda.nvtx.range(name))
        yield


@dataclass
class ThroughputMeter:
    """Step-time / items-per-second accumulator with percentile summary."""

    unit: str = "superblocks"
    _times: List[float] = field(default_factory=list)
    _items: List[int] = field(default_factory=list)
    _start: Optional[float] = None

    def start(self) -> None:
        self._start = time.perf_counter()

    def stop(self, items: int) -> float:
        if self._start is None:
            raise RuntimeError("call start() first")
        dt = time.perf_counter() - self._start
        self._times.append(dt)
        self._items.append(items)
        self._start = None
        return dt

    @contextlib.contextmanager
    def step(self, items: int):
        self.start()
        try:
            yield
        finally:
            self.stop(items)

    def summary(self, skip_warmup: int = 1) -> Dict[str, float]:
        times = self._times[skip_warmup:] or self._times
        items = self._items[skip_warmup:] or self._items
        if not times:
            return {}
        total_time = sum(times)
        total_items = sum(items)
        sorted_times = sorted(times)

        def pct(p):
            idx = min(int(len(sorted_times) * p), len(sorted_times) - 1)
            return sorted_times[idx]

        return {
            "steps": len(times),
            f"{self.unit}_per_sec": total_items / total_time,
            "mean_step_sec": total_time / len(times),
            "p50_step_sec": pct(0.50),
            "p90_step_sec": pct(0.90),
            "p99_step_sec": pct(0.99),
        }

    def save(self, path: Path, skip_warmup: int = 1) -> None:
        Path(path).parent.mkdir(parents=True, exist_ok=True)
        Path(path).write_text(json.dumps(self.summary(skip_warmup), indent=2))


def device_memory_stats() -> Dict[str, Dict[str, int]]:
    """Per-card statistics of the CUDA caching allocator
    (``torch.cuda.memory_stats``), keyed ``cuda:<i>``; empty without a card."""
    if not torch.cuda.is_available():
        return {}
    return {f"cuda:{i}": dict(torch.cuda.memory_stats(i))
            for i in range(torch.cuda.device_count())}


__all__ = ["ThroughputMeter", "annotate", "device_memory_stats", "trace"]
