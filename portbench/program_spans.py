"""The program's own spans in the traced phase, and the reductions the
span readers under ``metrics/`` make of them.

The spans come from the port's recorder through ``system.recorded_spans``
(``av1tpu_torch.utils.profiling.spans()``): those the port recorded at its
layer boundaries while the traced phase's profiler ran (the recorder keeps
one profiler session). They are taken once a run and kept in the summary. A
port without the recorder gives none, and every reader returns None.

A span is a dict: ``name``, ``id``, ``parent``, ``call``, ``thread``,
``start_ns`` and ``end_ns`` on ``time.time_ns`` (the clock of the device
trace's events), ``attrs`` and ``device_ms``. Readers normalise a frame
(``summary["trace"]["frames"]``) or a batch (``["batches"]``), whichever the
cell's loop counts.

The spans are read on the card alone. Off it the traced phase's profiler
records every host operation and slows the host (it doubled a host-bound
dispatch on the card), so host spans would mostly time the profiler.
"""
from __future__ import annotations

import bisect
from typing import Dict, Iterable, List, Optional, Tuple

KEY = "program_spans"


def load(summary: dict) -> Optional[List[dict]]:
    """The port's spans of the traced phase, or None (off the card, without
    a trace, without the recorder, or with no span recorded)."""
    if not summary.get("on_card") or not summary.get("trace"):
        return None
    if KEY not in summary:
        from portbench.system import recorded_spans
        summary[KEY] = recorded_spans()
    return summary[KEY]


def units(summary: dict) -> Optional[int]:
    """The traced phase's frames, else its batches."""
    trace = summary["trace"]
    return trace.get("frames") or trace.get("batches")


def named(spans: List[dict], name: str) -> List[dict]:
    return [s for s in spans if s["name"] == name]


def _ms(ns: int) -> float:
    return ns / 1e6


def total_ms(spans: List[dict], name: str) -> Optional[float]:
    """The summed host ms of the spans ``name``; None without one."""
    found = named(spans, name)
    return _ms(sum(s["end_ns"] - s["start_ns"] for s in found)) if found else None


def self_ms(spans: List[dict], name: str, less: Iterable[str]) -> Optional[float]:
    """The summed host ms of the spans ``name`` less their direct children
    named in ``less``; None without one."""
    found = named(spans, name)
    if not found:
        return None
    ids, less = {s["id"] for s in found}, set(less)
    children = sum(s["end_ns"] - s["start_ns"] for s in spans
                   if s["parent"] in ids and s["name"] in less)
    return _ms(sum(s["end_ns"] - s["start_ns"] for s in found) - children)


def device_ms(spans: List[dict], name: str, **attrs) -> Optional[float]:
    """The summed device ms between the markers of the spans ``name`` whose
    attributes hold ``attrs``; None without one, or if any lacks its time."""
    found = [s for s in named(spans, name)
             if all(s["attrs"].get(k) == v for k, v in attrs.items())]
    if not found or any(s["device_ms"] is None for s in found):
        return None
    return sum(s["device_ms"] for s in found)


def _union(intervals: Iterable[Tuple[int, int]]) -> List[Tuple[int, int]]:
    merged: List[List[int]] = []
    for start, end in sorted(intervals):
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append([start, end])
    return [(a, b) for a, b in merged]


def _covered(busy: List[Tuple[int, int]], ends: List[int], start: int, end: int) -> int:
    """Ns of ``[start, end)`` inside ``busy`` (disjoint, sorted; ``ends`` its ends)."""
    covered, i = 0, bisect.bisect_right(ends, start)
    while i < len(busy) and busy[i][0] < end:
        covered += min(busy[i][1], end) - max(busy[i][0], start)
        i += 1
    return covered


def own_intervals(span: dict, children: Iterable[dict]) -> List[Tuple[int, int]]:
    """The parts of ``span``'s interval in which it is the innermost span on
    its thread: its interval less those of its ``children`` on that thread."""
    inner = _union((c["start_ns"], c["end_ns"]) for c in children
                   if c["thread"] == span["thread"])
    out, cursor = [], span["start_ns"]
    for start, end in inner + [(span["end_ns"], span["end_ns"])]:
        if start > cursor:
            out.append((cursor, min(start, span["end_ns"])))
        cursor = max(cursor, end)
    return out


def idle_ms(spans: List[dict], kernels: List[tuple], name: str) -> Optional[float]:
    """Device idle ms while the innermost program span on the calling thread
    is one named ``name``: within its own intervals, the time no kernel of
    the trace (``(name, start_ns, end_ns)``) ran. Copies and fills are not
    kernels and count as idle; they are small beside the kernels (host to
    device 0.018 s of a 0.41 s traced window in ``v6_unified.offline_1080p``).
    None without such a span or without kernels."""
    found = named(spans, name)
    if not found or not kernels:
        return None
    children: Dict[int, List[dict]] = {}
    for s in spans:
        children.setdefault(s["parent"], []).append(s)
    busy = _union((start, end) for _, start, end in kernels)
    ends = [e for _, e in busy]
    idle = 0
    for span in found:
        for start, end in own_intervals(span, children.get(span["id"], ())):
            idle += end - start - _covered(busy, ends, start, end)
    return _ms(idle)


def per_unit(summary: dict, reduce) -> Optional[float]:
    """``reduce(spans, trace)`` (ms, or None) over the traced phase's frames
    or batches."""
    spans = load(summary)
    if spans is None or not units(summary):
        return None
    value = reduce(spans, summary["trace"])
    return None if value is None else value / units(summary)


__all__ = ["device_ms", "idle_ms", "load", "own_intervals", "per_unit", "self_ms",
           "total_ms", "units"]
