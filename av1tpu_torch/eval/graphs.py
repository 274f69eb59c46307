"""CUDA graphs around a predict body: one replay a call in place of its
hundreds of launches from Python.

``graphed(predict, device)`` wraps the predict body of a folded pipeline
(``eval/folded.make_v6_pipeline_folded``, ``eval/unified
.make_unified_pipeline_folded``) on a CUDA ``device``; on any other device it
returns ``predict`` itself. The wrapper decides from what it sees, the input's
``(shape, dtype, device)``:

* the first call with a key runs the body eagerly: that call settles cuDNN's
  algorithm choice, the fused fronts' lazy plans and K5's TMA maps;
* the second captures the whole body (normalisation, every forward, the
  routing) into a ``torch.cuda.CUDAGraph`` over a static input, then replays;
* every later call copies its input into the static input, replays on the
  caller's current stream and returns copies of the static outputs (a caller
  may keep one call's outputs while the next replay overwrites them).

The same kernels run in the same order on the same shapes, so the outputs are
bitwise those of the eager body. A capture that raises (a body that waits for
the device, say) leaves its key eager for good and is counted in
``counts["failed"]``; later captures take a fresh pool (``_abandon``). While the caller's stream is itself being captured the
body runs eagerly, inside the caller's graph. ``_build.launch_counts`` stays a
count of kernel runs: what a capture enqueued is taken back out of it, and
added once at each replay.

Every graph of a device allocates from one memory pool
(``torch.cuda.graph_pool_handle``), so that the graphs' memory stays near one
eager call's and does not grow as their sum. That is safe here: a graph's
intermediates are written and read within its own replay, every replay goes
to the caller's one stream (so two replays never overlap on the device), and
each graph keeps its static input and outputs referenced for its whole life,
so no capture is ever handed a block that a live tensor of another graph
holds. Once every graph of a pool is gone, the next capture takes a new
pool. Captures run with ``capture_error_mode="thread_local"``: the batching
layer's producer thread keeps issuing copies and waiting on events on its own
stream while the caller's thread captures, which the default (global) mode
would forbid.

Spans (``utils.profiling``): ``pipeline.capture`` (``rows``) around each
capture and ``pipeline.replay`` (``rows``) around each replay, input and
output copies included; inside ``batching.predict`` when the batching layer
calls the predictor.
"""
from __future__ import annotations

import contextlib
import warnings
import weakref
from typing import Callable, Dict, Tuple

import torch

from av1tpu_torch.kernels import _build
from av1tpu_torch.utils import profiling

counts: Dict[str, int] = {"captured": 0, "failed": 0}

_EAGER, _SEEN = "eager", "seen"  # a key's state before it holds a graph
_POOLS: Dict[torch.device, Tuple[tuple, weakref.WeakSet]] = {}  # pool id, graphs in it
_STREAMS: Dict[torch.device, torch.cuda.Stream] = {}


def _capturable(images: torch.Tensor) -> bool:
    """Whether a call on ``images`` may capture or replay: on a card, and not
    while the caller's stream is being captured already."""
    return images.is_cuda and not torch.cuda.is_current_stream_capturing()


def _capture(body: Callable, static_in: torch.Tensor):
    """``(graph, outputs)``: ``body(static_in)`` captured on the device's
    capture stream into its shared pool. Nothing runs on the device.

    torch frees a pool with the last graph in it and refuses later captures
    into its id, so a device whose graphs are all gone (their pipelines
    dropped) takes a fresh pool."""
    device = static_in.device
    if device not in _STREAMS:
        _STREAMS[device] = torch.cuda.Stream(device)
    if device not in _POOLS or not _POOLS[device][1]:
        _POOLS[device] = torch.cuda.graph_pool_handle(), weakref.WeakSet()
    pool, held_by = _POOLS[device]
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.device(device), torch.cuda.stream(_STREAMS[device]):
        try:
            graph.capture_begin(pool=pool, capture_error_mode="thread_local")
            out = body(static_in)
            graph.capture_end()
        except BaseException:
            _abandon(graph, device, pool)
            raise
    held_by.add(graph)
    return graph, out


def _abandon(graph, device: torch.device, pool: tuple) -> None:
    """Undo what a failed capture leaves behind, as far as torch lets a
    caller: a failed ``capture_end`` leaves the allocator routing into the
    pool, the pool refusing later captures, and the device's default
    generator in capture mode, so that its next draw raises. End the capture
    and the routing, give later captures a fresh pool, and hand the
    generator a copy of its state taken out of capture mode. Each step is a
    no-op where there is nothing to undo."""
    with contextlib.suppress(Exception):
        graph.capture_end()
    with contextlib.suppress(Exception):
        torch._C._cuda_endAllocateToPool(device.index, pool)
    _POOLS.pop(device, None)
    with contextlib.suppress(Exception):
        generator = torch.cuda.default_generators[device.index]
        generator.graphsafe_set_state(generator.clone_state())


class _Graph:
    """One key's graph, its static input and outputs, and the port kernels
    it holds (``_build.launch_counts`` names and counts)."""

    def __init__(self, graph, static_in, static_out, held: Dict[str, int]):
        self.graph, self.static_in, self.static_out = graph, static_in, static_out
        self.held = held

    def replay(self, images: torch.Tensor) -> Dict[str, torch.Tensor]:
        with profiling.span("pipeline.replay", rows=int(images.shape[0])):
            static = self.static_in
            if images.dtype == torch.uint16:  # not every torch build copies uint16
                static, images = static.view(torch.int16), images.view(torch.int16)
            static.copy_(images)
            self.graph.replay()
            for name, n in self.held.items():
                _build.launch_counts[name] += n
            return {key: value.clone() for key, value in self.static_out.items()}


class _Graphed:
    """``predict`` with a graph per input key (see the module docstring);
    ``body`` is the eager predict."""

    def __init__(self, body: Callable):
        self.body = body
        self.keys: Dict[tuple, object] = {}

    def __call__(self, images: torch.Tensor) -> Dict[str, torch.Tensor]:
        if not _capturable(images):
            return self.body(images)
        key = (tuple(images.shape), images.dtype, images.device)
        state = self.keys.get(key)
        if state is None:
            self.keys[key] = _SEEN
        elif state is _SEEN:
            state = self.keys[key] = self._capture(images)
        if not isinstance(state, _Graph):
            return self.body(images)
        with torch.inference_mode():
            return state.replay(images)

    def _capture(self, images: torch.Tensor):
        """A ``_Graph`` for ``images``' key, or ``_EAGER`` if capture raised."""
        before = dict(_build.launch_counts)
        try:
            with profiling.span("pipeline.capture", rows=int(images.shape[0])), \
                    torch.inference_mode():
                static_in = torch.empty(images.shape, dtype=images.dtype, device=images.device)
                graph, static_out = _capture(self.body, static_in)
        except Exception as exc:  # noqa: BLE001 - any capture fault: stay eager
            counts["failed"] += 1
            warnings.warn(f"predict stays eager for {tuple(images.shape)} "
                          f"{images.dtype}: capture failed ({exc})", RuntimeWarning)
            return _EAGER
        finally:  # a capture runs nothing: take its launches back out
            held = {name: n - before.get(name, 0)
                    for name, n in _build.launch_counts.items() if n != before.get(name, 0)}
            _build.launch_counts.update(before)
        counts["captured"] += 1
        return _Graph(graph, static_in, static_out, held)


def graphed(predict: Callable, device) -> Callable:
    """``predict`` with its calls captured and replayed as CUDA graphs on a
    CUDA ``device``; ``predict`` itself on any other."""
    return _Graphed(predict) if torch.device(device).type == "cuda" else predict


__all__ = ["counts", "graphed"]
