"""The traced phase: a ``torch.profiler`` window of the device's operations
over some dispatches, reduced in memory to what the per-layer readers take.

The profiler records the device alone (CUDA activity: kernels, copies and
fills through CUPTI), so that the host runs as fast as when untraced; the
benchmark's own ranges around its calls into the program are taken on the
host's wall clock (``time.time_ns``), the clock the profiler's events carry:
``traced_window``, ``tile``, ``cascade_call``, ``to_host``, ``level_<px>``
around each level's predictor, ``pass`` and ``batch`` for block scoring.

Events are plain tuples ``(name, start_ns, end_ns)``: ``kernels`` (device
kernels), ``device`` (every device operation, for the busy time and the idle
gaps) and ``ranges``. ``summarize`` works on those lists alone, so it is
tested without a card.
"""
from __future__ import annotations

import contextlib
import time
from typing import Dict, Iterable, List, Optional, Tuple

import torch

Event = Tuple[str, int, int]
WINDOW = "traced_window"
TOP = 10


def profiler(device: torch.device):
    """A profiler of the device's operations (of the host's on the CPU)."""
    activity = torch.profiler.ProfilerActivity
    return torch.profiler.profile(
        activities=[activity.CUDA if device.type == "cuda" else activity.CPU],
        record_shapes=False, profile_memory=False, with_stack=False)


class Spans:
    """The benchmark's host ranges, recorded while ``on``."""

    def __init__(self):
        self.on = False
        self.ranges: List[Event] = []

    def __call__(self, name: str):
        return self._record(name) if self.on else contextlib.nullcontext()

    @contextlib.contextmanager
    def _record(self, name: str):
        start = time.time_ns()
        try:
            yield
        finally:
            self.ranges.append((name, start, time.time_ns()))


def events(prof, spans: Spans) -> Dict[str, List[Event]]:
    """The profiler's device events as ``kernels`` and ``device``, and the
    host ranges of ``spans``."""
    out: Dict[str, List[Event]] = {"kernels": [], "device": [], "ranges": list(spans.ranges)}
    for e in prof.profiler.kineto_results.events():
        if "CUDA" not in str(e.device_type()):
            continue
        name = e.name()
        kind = e.activity_type() if hasattr(e, "activity_type") else ""
        if "annotation" in kind:
            continue
        start = int(e.start_ns())
        end = start + int(e.duration_ns())
        out["device"].append((name, start, end))
        if kind == "kernel" or (not kind and not name.startswith(("Memcpy", "Memset"))):
            out["kernels"].append((name, start, end))
    return out


def _union(intervals: Iterable[Tuple[int, int]]) -> List[Tuple[int, int]]:
    merged: List[List[int]] = []
    for start, end in sorted(intervals):
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append([start, end])
    return [(a, b) for a, b in merged]


def short_name(name: str) -> str:
    """A kernel's name without ``void``, anonymous namespaces and its argument
    list, at most 160 characters."""
    name = name.replace("(anonymous namespace)::", "")
    name = name[5:] if name.startswith("void ") else name
    return name.split("(")[0].strip()[:160]


def _innermost(ranges: List[Event], t: int) -> str:
    best = None
    for name, start, end in ranges:
        if start <= t <= end and name != WINDOW and (best is None or start >= best[1]):
            best = (name, start)
    return best[0] if best else "outside the benchmark's ranges"


def summarize(ev: Dict[str, List[Event]]) -> Optional[dict]:
    """Busy and window seconds, device operations by total time and idle time
    by the host range it fell in, over the ``traced_window`` range; None
    without that range."""
    windows = [r for r in ev["ranges"] if r[0] == WINDOW]
    if not windows:
        return None
    _, w0, w1 = windows[0]
    inside = [(max(s, w0), min(e, w1)) for _, s, e in ev["device"] if e > w0 and s < w1]
    busy = _union(inside)
    by_op: Dict[str, int] = {}
    for name, s, e in ev["device"]:
        if e > w0 and s < w1:
            key = short_name(name)
            by_op[key] = by_op.get(key, 0) + min(e, w1) - max(s, w0)
    gaps, cursor = [], w0
    for s, e in busy + [(w1, w1)]:
        if s > cursor:
            gaps.append((cursor, s))
        cursor = max(cursor, e)
    ranges = [r for r in ev["ranges"] if r[2] > w0 and r[1] < w1]
    idle: Dict[str, int] = {}
    for s, e in gaps:
        key = _innermost(ranges, (s + e) // 2)
        idle[key] = idle.get(key, 0) + e - s
    top = sorted(by_op.items(), key=lambda kv: -kv[1])[:TOP]
    return {
        # where the first device operation starts after the window opens and
        # the last ends before it closes: a check that the two clocks agree
        "edges_s": [(busy[0][0] - w0) / 1e9, (w1 - busy[-1][1]) / 1e9] if busy else None,
        "window_s": (w1 - w0) / 1e9,
        "busy_s": sum(e - s for s, e in busy) / 1e9,
        "kernels": [k for k in ev["kernels"] if k[2] > w0 and k[1] < w1],
        "device_ops": [[name, ns / 1e9] for name, ns in top],
        "idle_gaps": [[name, ns / 1e9] for name, ns in sorted(idle.items(),
                                                              key=lambda kv: -kv[1])[:TOP]],
    }


__all__ = ["Spans", "events", "profiler", "short_name", "summarize"]
