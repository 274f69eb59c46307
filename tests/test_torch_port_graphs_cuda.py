"""The folded pipelines' CUDA graphs (``eval.graphs``) on a card against
their eager bodies, bitwise: at every chunk shape the benchmark's cascades and
block scoring run, with fresh batches through one graph, outputs kept across
replays, graphs of one pool replayed in any order, the batching layer's
producer thread running while a graph is captured, a capture that fails, the
port's launch counts and the profiler's view of a replay.

These tests need a card: they carry the ``cuda`` marker and skip without
one. This file imports no jax:

    python -m pytest --noconftest -m cuda tests/test_torch_port_graphs_cuda.py
"""
import gc

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from av1tpu_torch.eval import (
    PipelineModels,
    make_unified_pipeline_folded,
    make_v6_pipeline_folded,
    run_pipeline_batched,
)
from av1tpu_torch.eval import graphs
from av1tpu_torch.kernels import _build
from av1tpu_torch.models import (
    Stage1Model,
    Stage2Model,
    Stage3ABModel,
    Stage3RectModel,
    UnifiedV6Model,
)

# (block px, rows) of every predict the benchmark's cells make: the offline
# 1080p cascade, the live 1440p cascade, 16 px block scoring at 8,192
SHAPES = {
    "offline": [(64, 4080), (32, 16320), (16, 32768), (16, 32512), (8, 32768), (8, 31744)],
    "live": [(64, 920), (32, 3680), (16, 14720), (8, 26112)],
    "blocks": [(16, 8192)],
}
CASES = [(px, rows) for shapes in SHAPES.values() for px, rows in shapes]
FAMILIES = ("stages", "unified")  # folded bf16: K1 + K5; K2


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _calibrated(cls, seed, px, card):
    """A model on the card whose BN running statistics are a random batch's
    own at ``px``: activations stay near unit scale at the size it serves."""
    torch.manual_seed(seed)
    model = cls().to(card)
    for m in model.modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            m.reset_running_stats()
            m.momentum = None  # cumulative average: one batch's statistics
    with torch.no_grad():
        model.train()
        model(torch.randint(0, 1024, (256, px, px, 1), device=card).float() / 1023.0)
    return model.eval()


def _pipeline(family, px, card):
    """The benchmark's configuration of ``family`` for ``px`` blocks."""
    if family == "unified":
        return make_unified_pipeline_folded(_calibrated(UnifiedV6Model, px, px, card),
                                            float_dtype=torch.bfloat16,
                                            use_fused_front="g1", device=card)
    models = PipelineModels(*(_calibrated(cls, px + seed, px, card) for seed, cls in enumerate(
        (Stage1Model, Stage2Model, Stage3RectModel, Stage3ABModel))))
    return make_v6_pipeline_folded(models, float_dtype=torch.bfloat16, use_fused_front=True,
                                   use_pallas_groups=True, device=card)


@pytest.fixture(scope="module")
def pipelines(card):
    """One graphed pipeline a family and block size, shared by the tests, so
    that each later shape is captured after earlier captures in the pool."""
    return {(family, px): _pipeline(family, px, card)
            for family in FAMILIES for px in (64, 32, 16, 8)}


def _codes(rows, px, seed, card):
    gen = torch.Generator(card).manual_seed(seed)
    return torch.randint(0, 1024, (rows, px, px, 1), generator=gen, device=card,
                         dtype=torch.int32).to(torch.int16).view(torch.uint16)


def _equal(got, want, what):
    assert got.keys() == want.keys()
    for key in want:
        assert torch.equal(got[key], want[key]), (what, key)


def _port_launches():
    return {k: v for k, v in _build.launch_counts.items() if v}


@pytest.mark.cuda
@pytest.mark.parametrize("px, rows", CASES)
@pytest.mark.parametrize("family", FAMILIES)
def test_graphed_predict_is_the_eager_predict_bitwise(card, pipelines, family, px, rows):
    """Eager, capture and replay, then a replay of a new batch: each call's
    outputs bitwise the eager body's on the same batch; the outputs one call
    returned unchanged by the next replay; every call counts the eager
    call's port kernels."""
    predict = pipelines[family, px]
    assert isinstance(predict, graphs._Graphed)
    captured, failed = graphs.counts["captured"], graphs.counts["failed"]
    kept, launched = [], []
    for seed in range(4):
        images = _codes(rows, px, 1000 * px + seed, card)
        before = _port_launches()
        got = predict(images)
        launched.append({k: v - before.get(k, 0) for k, v in _port_launches().items()
                         if v != before.get(k, 0)})
        kept.append((images, got))
    for seed, (images, got) in enumerate(kept):
        _equal(got, predict.body(images), (family, px, rows, seed))
    assert not torch.equal(kept[2][1]["stage1_prob"], kept[3][1]["stage1_prob"])
    assert launched[1] == launched[2] == launched[3] == launched[0]
    assert graphs.counts["captured"] == captured + 1 and graphs.counts["failed"] == failed


@pytest.mark.cuda
@pytest.mark.parametrize("family", FAMILIES)
def test_graphs_of_one_pool_replay_in_any_order(card, family):
    """Two shapes captured one after the other into the shared pool, then
    replayed in turns, each against the eager body."""
    predict = _pipeline(family, 16, card)
    for rows in (4096, 2048):
        for seed in range(2):
            predict(_codes(rows, 16, seed, card))
    for seed, rows in enumerate((4096, 2048, 2048, 4096, 2048, 4096)):
        images = _codes(rows, 16, 50 + seed, card)
        _equal(predict(images), predict.body(images), (family, rows, seed))
    assert len([s for s in predict.keys.values() if isinstance(s, graphs._Graph)]) == 2


@pytest.mark.cuda
@pytest.mark.parametrize("family", FAMILIES)
def test_batched_with_a_producer_is_the_eager_run_bitwise(card, family):
    """``run_pipeline_batched(prefetch=2)`` over host numpy, graphed against
    the eager body: the second batch is captured while the producer thread
    stages the next ones and waits on its copies."""
    predict = _pipeline(family, 16, card)
    blocks = _codes(6 * 8192 + 1000, 16, 7, card).cpu().numpy()
    captured, failed = graphs.counts["captured"], graphs.counts["failed"]
    got = run_pipeline_batched(predict, blocks, 8192, card, prefetch=2)
    assert graphs.counts["captured"] == captured + 1 and graphs.counts["failed"] == failed
    want = run_pipeline_batched(predict.body, blocks, 8192, card, prefetch=2)
    again = run_pipeline_batched(predict, blocks, 8192, card, prefetch=2)
    for key, value in want.items():
        np.testing.assert_array_equal(got[key], value, err_msg=(family, key))
        np.testing.assert_array_equal(again[key], value, err_msg=(family, key))


@pytest.mark.cuda
def test_captures_go_on_after_every_graph_of_the_pool_is_gone(card, monkeypatch):
    """torch frees a pool with its last graph: pipelines built, used and
    dropped one after another each capture, into a pool of their own."""
    monkeypatch.setattr(graphs, "_POOLS", {})  # this test's pool: no other graph holds it
    images = _codes(512, 8, 11, card)
    captured, failed, pools = graphs.counts["captured"], graphs.counts["failed"], set()
    for turn in range(3):
        predict = _pipeline("unified", 8, card)
        for _ in range(3):
            _equal(predict(images), predict.body(images), turn)
        pools.add(graphs._POOLS[images.device][0])
        del predict
        gc.collect()
    assert graphs.counts["captured"] == captured + 3 and graphs.counts["failed"] == failed
    assert len(pools) == 3


@pytest.mark.cuda
def test_a_capture_that_fails_stays_eager(card, pipelines):
    """A body that waits for the device cannot be captured: its key stays
    eager, the failure is counted, and the card serves on."""
    def waits(images):
        x = images.view(torch.int16).to(torch.float32)
        total = float(x.sum())  # a host read: not allowed while capturing
        return {"final": (x.mean(dim=(1, 2, 3)) + total).to(torch.int32)}

    predict = graphs.graphed(waits, card)
    failed = graphs.counts["failed"]
    images = _codes(256, 8, 3, card)
    predict(images)
    with pytest.warns(RuntimeWarning, match="stays eager"):
        _equal(predict(images), waits(images), "failed capture")
    for _ in range(2):
        _equal(predict(images), waits(images), "eager after")
    assert graphs.counts["failed"] == failed + 1
    assert list(predict.keys.values()) == [graphs._EAGER]
    stages, captured = pipelines["stages", 8], graphs.counts["captured"]
    images = _codes(512, 8, 4, card)
    for _ in range(3):  # a fresh pool takes the next capture
        _equal(stages(images), stages.body(images), "after a failed capture")
    assert graphs.counts["captured"] == captured + 1 and graphs.counts["failed"] == failed + 1
    assert torch.randint(0, 5, (4,), device=card).shape == (4,)  # the default generator draws


@pytest.mark.cuda
def test_the_profiler_sees_the_kernels_of_a_replay(card, pipelines):
    """The kernels inside a replay reach a CUDA profiler's trace under their
    own names, as many of each port kernel as an eager call runs."""
    predict = pipelines["stages", 16]
    images = _codes(2048, 16, 9, card)
    for _ in range(2):
        predict(images)
    assert isinstance(predict.keys[tuple(images.shape), images.dtype, images.device],
                      graphs._Graph)
    found = {}
    for name, fn in (("replay", predict), ("eager", predict.body)):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn(images)
            torch.cuda.synchronize()
        names = [e.name() for e in prof.profiler.kineto_results.events()
                 if "CUDA" in str(e.device_type())]
        found[name] = {k: sum(k in n for n in names)
                       for k in ("fused_front_wgmma", "fused_group12_wgmma")}
    assert found["replay"] == found["eager"] and all(found["eager"].values()), found
