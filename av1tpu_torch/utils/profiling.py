"""Tracing: a ``torch.profiler`` capture, the port's own spans, and the card's
memory statistics.

``trace`` captures a ``torch.profiler`` trace of any region (the host's ops,
and the card's kernels where there is a card) and writes it as a Chrome trace
(open it in ui.perfetto.dev). ``device_memory_stats`` reads the CUDA caching
allocator's statistics per card.

``span`` marks the port's layer boundaries. It records only while a
``torch.profiler`` is recording (``trace``'s, or any other), so the spans
cover the device trace's window and nothing else; otherwise it returns one
shared no-op context. Read them with ``spans()`` after the profiler has
stopped (and, for device times, after the caller has synchronised). The
buffer is cleared when a span first runs in a new profiler session after a
span ran, or the spans were read, with no profiler recording: it holds one
session's spans. The spans the port records (attributes in brackets):

* ``ingest.tile`` (``rows``): ``ingest/tiler.tile_frame`` and ``tile_frames``;
* ``cascade`` (``rows``): ``eval/tree_infer.predict_partition_trees``, the
  whole call; inside it ``cascade.upload`` (``bytes``: the superblocks made
  contiguous and copied to the device) and ``cascade.level`` (``px``,
  ``rows``; device markers) for each level of its loop;
* ``batching`` (``rows``): ``eval/hierarchy.run_pipeline_batched``; inside it
  ``batching.predict`` (``rows``) around each call of the predictor,
  ``batching.wait`` where the caller waits on the producer's queue, and
  ``batching.stage`` (``rows``, ``bytes``: a batch sliced, staged and its
  copy issued, on the producer thread or the caller's) with
  ``batching.ring_wait`` where staging waits for a pinned buffer's last copy;
* ``pipeline.capture`` and ``pipeline.replay`` (``rows``): a folded
  pipeline's predict captured as a CUDA graph, and each replay of it
  (``eval/graphs``), inside ``batching.predict``.

Times are ``time.time_ns()``, the clock of the profiler's device events.
"""
from __future__ import annotations

import contextlib
import itertools
import threading
import time
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import torch
from torch.autograd import profiler as _autograd_profiler
from torch.profiler import ProfilerActivity, profile, record_function

CAP = 1_000_000  # spans a session keeps; past it they are counted as dropped


@contextlib.contextmanager
def trace(log_dir: Path, name: str = "av1tpu_torch"):
    """Capture a ``torch.profiler`` trace of the enclosed region, CPU and,
    where a card is present, CUDA; on exit it is written to
    ``log_dir/<name>.pt.trace.json``. Yields the profiler, whose
    ``key_averages()`` and ``events()`` the caller may read after the
    region; ``spans()`` then gives the port's spans inside it."""
    log_dir = Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        with record_function(name):
            yield prof
    prof.export_chrome_trace(str(log_dir / f"{name}.pt.trace.json"))


class _Off:
    """The context ``span`` returns while no profiler records."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Recorder:
    """The process's span buffer and each thread's stack of open spans
    (``(span id, call id)`` pairs)."""

    def __init__(self):
        self.records: List[tuple] = []
        self.dropped = 0
        self.seen_off = True  # a span ran, or spans() read, with no profiler recording
        self.ids = itertools.count(1)
        self.lock = threading.Lock()
        self.local = threading.local()

    def stack(self) -> List[Tuple[int, int]]:
        try:
            return self.local.stack
        except AttributeError:
            self.local.stack = []
            return self.local.stack

    def new_session(self) -> None:
        with self.lock:
            if self.seen_off:
                self.seen_off = False
                self.records = []
                self.dropped = 0

    def keep(self, record: tuple) -> None:
        with self.lock:
            if len(self.records) < CAP:
                self.records.append(record)
            else:
                self.dropped += 1


_RECORDER = _Recorder()


class _Span:
    __slots__ = ("name", "attrs", "device", "id", "parent", "call", "start_ns", "events")

    def __init__(self, name: str, device, attrs: dict):
        self.name, self.attrs = name, attrs
        self.device = device if device is not None and device.type == "cuda" else None

    def __enter__(self):
        stack = _RECORDER.stack()
        self.id = next(_RECORDER.ids)
        self.parent, self.call = stack[-1] if stack else (None, self.id)
        stack.append((self.id, self.call))
        self.events = None
        self.start_ns = time.time_ns()
        if self.device is not None:
            self.events = (torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True))
            self.events[0].record(torch.cuda.current_stream(self.device))
        return self

    def __exit__(self, *exc):
        if self.events is not None:
            self.events[1].record(torch.cuda.current_stream(self.device))
        end_ns = time.time_ns()
        _RECORDER.stack().pop()
        _RECORDER.keep((self.id, self.parent, self.call, threading.get_ident(), self.name,
                        self.start_ns, end_ns, self.attrs, self.events))
        return False


def span(name: str, device: Optional[torch.device] = None, *, px: Optional[int] = None,
         rows: Optional[int] = None, bytes: Optional[int] = None):
    """A context that records the enclosed region as the span ``name`` while
    a ``torch.profiler`` records: its id, its parent (the innermost open span
    on this thread), its call id (the id of the outermost span of the call
    into the port), the thread, start and end on ``time.time_ns``, and the
    attributes given (``px``, ``rows``, ``bytes`` where work is counted).
    With a CUDA ``device`` it also records a timing event on that device's
    current stream at each end. Otherwise it returns one shared no-op
    context, and allocates nothing."""
    if not _autograd_profiler._is_profiler_enabled:
        _RECORDER.seen_off = True
        return _OFF
    if _RECORDER.seen_off:
        _RECORDER.new_session()
    attrs = {key: value for key, value in (("px", px), ("rows", rows), ("bytes", bytes))
             if value is not None}
    return _Span(name, device, attrs)


class _Within:
    __slots__ = ("context",)

    def __init__(self, context: Tuple[int, int]):
        self.context = context

    def __enter__(self):
        _RECORDER.stack().append(self.context)

    def __exit__(self, *exc):
        _RECORDER.stack().pop()
        return False


def current() -> Optional[Tuple[int, int]]:
    """The calling thread's innermost open span as ``(span id, call id)``,
    or None (also while no profiler records)."""
    if not _autograd_profiler._is_profiler_enabled:
        return None
    stack = _RECORDER.stack()
    return stack[-1] if stack else None


def within(context: Optional[Tuple[int, int]]):
    """A context in which the calling thread's spans take the span of
    ``context`` (``current()`` on the thread that started this one) as their
    parent and share its call id; no-op for None."""
    return _OFF if context is None else _Within(context)


def _device_ms(events) -> Optional[float]:
    if events is None or not events[1].query():
        return None
    return events[0].elapsed_time(events[1])


def spans() -> List[dict]:
    """The spans of the last profiler session, in the order they ended:
    ``id``, ``parent``, ``call``, ``thread``, ``name``, ``start_ns``,
    ``end_ns``, ``attrs`` and ``device_ms`` (the device stream's ms between
    the span's two markers; None without markers or before they completed)."""
    if not _autograd_profiler._is_profiler_enabled:
        _RECORDER.seen_off = True
    with _RECORDER.lock:
        records = list(_RECORDER.records)
    return [{"id": i, "parent": parent, "call": call, "thread": thread, "name": name,
             "start_ns": start, "end_ns": end, "attrs": dict(attrs),
             "device_ms": _device_ms(events)}
            for i, parent, call, thread, name, start, end, attrs, events in records]


def dropped() -> int:
    """Spans of the last session not kept, past ``CAP``."""
    return _RECORDER.dropped


def device_memory_stats() -> Dict[str, Dict[str, int]]:
    """Per-card statistics of the CUDA caching allocator
    (``torch.cuda.memory_stats``), keyed ``cuda:<i>``; empty without a card."""
    if not torch.cuda.is_available():
        return {}
    return {f"cuda:{i}": dict(torch.cuda.memory_stats(i))
            for i in range(torch.cuda.device_count())}


__all__ = ["CAP", "current", "device_memory_stats", "dropped", "span", "spans", "trace",
           "within"]
