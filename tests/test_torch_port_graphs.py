"""The graph policy of ``eval.graphs`` on the CPU, with the capture stubbed
through the module's ``_capture`` seam: which call runs eager, captures or
replays, what a failed capture leaves, the launch counts, the copies handed
back and the spans. The card's graphs against the eager body, bitwise:
``tests/test_torch_port_graphs_cuda.py``. Port only: the JAX package has no
counterpart."""
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from av1tpu_torch.eval import graphs
from av1tpu_torch.eval.hierarchy import run_pipeline_batched
from av1tpu_torch.eval.unified import make_unified_pipeline_folded
from av1tpu_torch.kernels import _build
from av1tpu_torch.models import UnifiedV6Model
from av1tpu_torch.utils import profiling

HELD = 3  # K5 launches the stub body makes a call


def _plain(images):
    x = images.view(torch.int16).to(torch.int32)
    return {"final": x.sum(dim=(1, 2, 3)) % 8, "stage1_prob": x.float().mean(dim=(1, 2, 3))}


class _Body:
    """A predict body that counts its eager runs and launches ``HELD``
    kernels a call through ``_build.launch_counts``, as the kernel wrappers do."""

    def __init__(self):
        self.runs = 0

    def __call__(self, images):
        self.runs += 1
        _build.launch_counts["fused_group12"] += HELD
        return _plain(images)


class _FakeGraph:
    """Writes the body's outputs into the captured ones in place, as a
    replayed graph does, without running the body."""

    def __init__(self, static_in, out):
        self.static_in, self.out = static_in, out

    def replay(self):
        for key, value in _plain(self.static_in).items():
            self.out[key].copy_(value)


@pytest.fixture
def seam(monkeypatch):
    """Captures on CPU tensors through a stub; the shapes captured in order."""
    captured = []

    def capture(body, static_in):
        captured.append(tuple(static_in.shape))
        out = body(static_in)  # a capture enqueues the body's launches
        return _FakeGraph(static_in, out), out

    monkeypatch.setattr(graphs, "_capturable", lambda images: True)
    monkeypatch.setattr(graphs, "_capture", capture)
    monkeypatch.setattr(graphs, "counts", {"captured": 0, "failed": 0})
    monkeypatch.setattr(_build, "launch_counts", dict(_build.launch_counts))
    return captured


def _codes(rows, seed, px=8):
    return torch.from_numpy(np.random.default_rng(seed).integers(
        0, 1024, (rows, px, px, 1), dtype=np.uint16))


def _equal(got, want):
    assert got.keys() == want.keys()
    for key in want:
        assert torch.equal(got[key], want[key]), key


def test_first_call_runs_eager_then_one_capture_and_replays(seam):
    body = _Body()
    predict = graphs.graphed(body, "cuda")
    for i, want_runs in enumerate([1, 2, 2, 2]):
        images = _codes(64, seed=i)
        _equal(predict(images), _plain(images))
        assert body.runs == want_runs  # the capture is the second run; replays run nothing
    assert seam == [(64, 8, 8, 1)]
    assert graphs.counts == {"captured": 1, "failed": 0}


def test_a_new_shape_runs_eager_first_and_gets_its_own_graph(seam):
    body = _Body()
    predict = graphs.graphed(body, "cuda")
    for seed in range(3):
        predict(_codes(64, seed))
    for seed in range(3):
        images = _codes(48, seed + 10)
        _equal(predict(images), _plain(images))
    assert body.runs == 2 + 2
    assert seam == [(64, 8, 8, 1), (48, 8, 8, 1)]
    images = _codes(64, 20)  # the first shape's graph still replays
    _equal(predict(images), _plain(images))
    assert body.runs == 4 and graphs.counts == {"captured": 2, "failed": 0}


def test_off_the_card_nothing_captures(monkeypatch):
    def refuse(body, static_in):
        raise AssertionError("captured off the card")

    monkeypatch.setattr(graphs, "_capture", refuse)
    body = _Body()
    assert graphs.graphed(body, "cpu") is body
    assert graphs.graphed(body, torch.device("cpu")) is body
    predict = graphs.graphed(body, "cuda")  # built for a card, called on the CPU
    for seed in range(4):
        images = _codes(32, seed)
        _equal(predict(images), _plain(images))
    assert body.runs == 4
    model = UnifiedV6Model()
    assert not isinstance(make_unified_pipeline_folded(model, device="cpu"), graphs._Graphed)


def test_a_capture_that_raises_leaves_its_key_eager(seam, monkeypatch):
    tried = []

    def failing(body, static_in):
        tried.append(tuple(static_in.shape))
        body(static_in)  # launches enqueued before the fault
        raise RuntimeError("operation not permitted when stream is capturing")

    monkeypatch.setattr(graphs, "_capture", failing)
    body = _Body()
    predict = graphs.graphed(body, "cuda")
    predict(_codes(64, 0))
    before = _build.launch_counts["fused_group12"]
    with pytest.warns(RuntimeWarning, match="stays eager"):
        images = _codes(64, 1)
        _equal(predict(images), _plain(images))
    assert _build.launch_counts["fused_group12"] == before + HELD  # the eager run's alone
    for seed in range(2, 5):
        images = _codes(64, seed)
        _equal(predict(images), _plain(images))
    assert tried == [(64, 8, 8, 1)]
    assert body.runs == 1 + 2 + 3
    assert graphs.counts == {"captured": 0, "failed": 1}


def test_launch_counts_grow_by_the_captured_kernels_at_each_replay(seam):
    predict = graphs.graphed(_Body(), "cuda")
    grown = []
    for seed in range(5):
        before = _build.launch_counts["fused_group12"]
        predict(_codes(64, seed))
        grown.append(_build.launch_counts["fused_group12"] - before)
    assert grown == [HELD] * 5  # eager, capture + replay, three replays: one run each


def test_a_replays_outputs_survive_the_next_replay(seam):
    predict = graphs.graphed(_Body(), "cuda")
    predict(_codes(64, 0))
    first, second = _codes(64, 1), _codes(64, 2)
    kept = predict(first)
    again = predict(second)
    _equal(kept, _plain(first))
    _equal(again, _plain(second))
    assert not torch.equal(kept["stage1_prob"], again["stage1_prob"])


@pytest.mark.parametrize("prefetch", [0, 2])
def test_capture_and_replay_spans_nest_under_batching_predict(seam, prefetch):
    blocks = _codes(1000, seed=5).numpy()  # three batches of 256, then 232
    predict = graphs.graphed(_Body(), "cuda")
    profiling.spans()  # close whatever session ran before
    with profile(activities=[ProfilerActivity.CPU]):
        out = run_pipeline_batched(predict, blocks, batch_size=256, device="cpu",
                                   prefetch=prefetch)
    want = _plain(torch.from_numpy(blocks))
    assert np.array_equal(out["final"], want["final"].numpy())
    spans = profiling.spans()
    predicts = [s for s in spans if s["name"] == "batching.predict"]
    captures = [s for s in spans if s["name"] == "pipeline.capture"]
    replays = [s for s in spans if s["name"] == "pipeline.replay"]
    assert len(predicts) == 4
    assert [c["parent"] for c in captures] == [predicts[1]["id"]]
    assert [r["parent"] for r in replays] == [predicts[1]["id"], predicts[2]["id"]]
    assert [s["attrs"] for s in captures + replays] == [{"rows": 256}] * 3
    assert all(predicts[1]["start_ns"] <= c["start_ns"] <= c["end_ns"] <= predicts[1]["end_ns"]
               for c in captures)
