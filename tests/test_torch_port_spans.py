"""The port's spans (``utils.profiling.span``): off outside a profiler,
recorded inside one with parents, call ids and threads on the device trace's
clock, a buffer per profiler session with a cap, and the spans the cascade,
the batching layer and the tiler record. Port only: nothing here is compared
with the JAX package, which has no spans."""
import threading
import time

import numpy as np
import pytest
import torch
from torch.autograd import profiler as autograd_profiler
from torch.profiler import ProfilerActivity, profile

from av1tpu_torch.codec.tree import LEVEL_SIZES, NODES_PER_LEVEL
from av1tpu_torch.eval.hierarchy import run_pipeline_batched
from av1tpu_torch.eval.tree_infer import predict_frame_trees, predict_partition_trees
from av1tpu_torch.ingest.tiler import tile_frame, tile_frames
from av1tpu_torch.utils import profiling

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _last_session_read():
    """Each test's session starts empty: reading the spans with no profiler
    recording closes the buffer of whatever session ran before."""
    profiling.spans()


def recording():
    return profile(activities=[ProfilerActivity.CPU])


def _stub(images):
    """Final v6 ids from a block's pixel sum: SPLIT (1) on two thirds."""
    total = images.to(torch.int32).sum(dim=(1, 2, 3))
    return {"final": torch.where(total % 3 != 0, 1, total % 8).to(torch.int32)}


def _superblocks(n=5, seed=0):
    return np.random.default_rng(seed).integers(0, 1024, (n, 64, 64), dtype=np.uint16)


def _blocks(n=1000, seed=1):
    return np.random.default_rng(seed).integers(0, 1024, (n, 8, 8, 1), dtype=np.uint16)


def by_name(spans, name):
    return [s for s in spans if s["name"] == name]


def test_the_profiler_sets_the_flag_the_recorder_reads():
    assert autograd_profiler._is_profiler_enabled is False
    with recording():
        assert autograd_profiler._is_profiler_enabled is True
    assert autograd_profiler._is_profiler_enabled is False


def test_off_a_span_records_nothing_and_is_the_shared_no_op():
    with recording():
        with profiling.span("kept"):
            pass
    before = profiling.spans()
    first, second = profiling.span("a", rows=1), profiling.span("b", device=CPU)
    assert first is second
    with first as inside:
        assert inside is None
        assert profiling.current() is None
    assert profiling.within(None) is first
    assert [s["name"] for s in profiling.spans()] == [s["name"] for s in before] == ["kept"]


def test_spans_record_parents_call_ids_threads_and_attributes():
    with recording():
        with profiling.span("outer", rows=3):
            with profiling.span("inner", px=8, bytes=64):
                pass
            with profiling.span("marked", device=CPU):  # no markers off a CUDA device
                pass
        with profiling.span("second"):
            pass
    spans = {s["name"]: s for s in profiling.spans()}
    outer, inner, marked, second = (spans[k] for k in ("outer", "inner", "marked", "second"))
    assert outer["parent"] is None and outer["call"] == outer["id"]
    assert inner["parent"] == outer["id"] and inner["call"] == outer["id"]
    assert marked["parent"] == outer["id"] and marked["device_ms"] is None
    assert second["parent"] is None and second["call"] == second["id"] != outer["id"]
    assert inner["attrs"] == {"px": 8, "bytes": 64} and outer["attrs"] == {"rows": 3}
    assert {s["thread"] for s in spans.values()} == {threading.get_ident()}
    assert outer["start_ns"] <= inner["start_ns"] <= inner["end_ns"] <= marked["start_ns"]
    assert marked["end_ns"] <= outer["end_ns"] <= second["start_ns"]


def test_a_profiled_op_lies_inside_its_span():
    """The spans' clock is the profiler's: an op inside a span starts and
    ends inside it."""
    with recording() as prof:
        time.sleep(0.002)
        with profiling.span("around"):
            torch.ones(64, 64) @ torch.ones(64, 64)
        time.sleep(0.002)
    around = by_name(profiling.spans(), "around")[0]
    ops = [e for e in prof.profiler.kineto_results.events() if e.name() == "aten::mm"]
    assert len(ops) == 1
    start = ops[0].start_ns()
    assert around["start_ns"] <= start <= start + ops[0].duration_ns() <= around["end_ns"]


def test_a_new_profiler_session_starts_an_empty_buffer():
    with recording():
        with profiling.span("first session"):
            pass
    with profiling.span("off"):
        pass
    assert [s["name"] for s in profiling.spans()] == ["first session"]
    with recording():
        with profiling.span("second session"):
            pass
    assert [s["name"] for s in profiling.spans()] == ["second session"]
    with recording():  # read after the last session: this one starts empty too
        with profiling.span("third session"):
            pass
    assert [s["name"] for s in profiling.spans()] == ["third session"]


def test_past_the_cap_spans_are_dropped_and_counted(monkeypatch):
    monkeypatch.setattr(profiling, "CAP", 3)
    with recording():
        for i in range(5):
            with profiling.span(f"s{i}"):
                pass
    assert [s["name"] for s in profiling.spans()] == ["s0", "s1", "s2"]
    assert profiling.dropped() == 2
    with recording():
        with profiling.span("next"):
            pass
    assert profiling.dropped() == 0 and len(profiling.spans()) == 1


def test_the_cascade_records_its_call_upload_and_levels():
    sbs = _superblocks()
    with recording():
        predict_partition_trees(sbs, {s: _stub for s in LEVEL_SIZES}, batch_size=256,
                                device="cpu")
    spans = profiling.spans()
    (cascade,), (upload,) = by_name(spans, "cascade"), by_name(spans, "cascade.upload")
    levels = by_name(spans, "cascade.level")
    assert cascade["parent"] is None and cascade["attrs"] == {"rows": len(sbs)}
    assert upload["parent"] == cascade["id"] and upload["attrs"] == {"bytes": sbs.nbytes}
    assert [lv["attrs"] for lv in levels] == [
        {"px": size, "rows": len(sbs) * nodes} for size, nodes in zip(LEVEL_SIZES,
                                                                       NODES_PER_LEVEL)]
    assert all(lv["parent"] == cascade["id"] and lv["device_ms"] is None for lv in levels)
    assert {s["call"] for s in spans} == {cascade["id"]}
    batching = by_name(spans, "batching")
    assert [b["parent"] for b in batching] == [lv["id"] for lv in levels]
    predicts = by_name(spans, "batching.predict")
    assert {p["parent"] for p in predicts} == {b["id"] for b in batching}
    assert sum(p["attrs"]["rows"] for p in predicts) == len(sbs) * sum(NODES_PER_LEVEL)


def test_the_gated_cascade_level_counts_the_rows_it_serves():
    sbs = _superblocks()
    caps = {32: 0.5, 16: 0.25, 8: 0.1}
    with recording():
        predict_partition_trees(sbs, {s: _stub for s in LEVEL_SIZES}, batch_size=256,
                                level_capacities=caps, device="cpu")
    rows = [lv["attrs"]["rows"] for lv in by_name(profiling.spans(), "cascade.level")]
    want = [len(sbs)] + [int(np.ceil(caps[s] * len(sbs) * n))
                         for s, n in zip(LEVEL_SIZES[1:], NODES_PER_LEVEL[1:])]
    assert rows == want


def test_the_frame_entry_and_the_tiler_record_tiling():
    plane = np.random.default_rng(2).integers(0, 1024, (130, 200), dtype=np.uint16)
    with recording():
        predict_frame_trees(plane, {s: _stub for s in LEVEL_SIZES}, batch_size=256,
                            device="cpu")
        tile_frame(plane, 16)
        tile_frames(np.stack([plane] * 3), 64)
    spans = profiling.spans()
    tiles = by_name(spans, "ingest.tile")
    assert [t["attrs"]["rows"] for t in tiles] == [3 * 4, 9 * 13, 3 * 3 * 4]
    (cascade,) = by_name(spans, "cascade")
    assert tiles[0]["end_ns"] <= cascade["start_ns"] and cascade["attrs"] == {"rows": 12}


@pytest.mark.parametrize("prefetch", [0, 2])
def test_batching_records_stage_wait_and_predict_per_batch(prefetch):
    blocks = _blocks()
    batches = -(-len(blocks) // 256)
    with recording():
        with profiling.span("caller"):
            run_pipeline_batched(_stub, blocks, batch_size=256, device="cpu",
                                 prefetch=prefetch)
    spans = profiling.spans()
    (caller,), (batching,) = by_name(spans, "caller"), by_name(spans, "batching")
    stages, waits = by_name(spans, "batching.stage"), by_name(spans, "batching.wait")
    predicts = by_name(spans, "batching.predict")
    assert batching["parent"] == caller["id"] and batching["attrs"] == {"rows": len(blocks)}
    assert len(stages) == len(predicts) == batches
    assert [s["attrs"]["rows"] for s in stages] == [256] * (batches - 1) + [1000 % 256]
    assert sum(s["attrs"]["bytes"] for s in stages) == blocks.nbytes
    assert {s["call"] for s in spans} == {caller["id"]}
    assert all(s["parent"] == batching["id"] for s in stages + waits + predicts)
    assert all(p["thread"] == caller["thread"] for p in predicts + waits)
    if prefetch:  # staged on the producer thread, which the caller waits on
        assert len(waits) == batches
        assert {s["thread"] for s in stages} != {caller["thread"]}
        assert len({s["thread"] for s in stages}) == 1
    else:
        assert waits == [] and {s["thread"] for s in stages} == {caller["thread"]}


@pytest.mark.parametrize("path", ["cascade", "gated", "frame", "batched"])
def test_outputs_are_the_same_with_the_recorder_on_and_off(path):
    preds = {s: _stub for s in LEVEL_SIZES}

    def run():
        if path == "batched":
            return run_pipeline_batched(_stub, _blocks(), batch_size=256, device="cpu")
        if path == "frame":
            plane = np.random.default_rng(3).integers(0, 1024, (130, 200), dtype=np.uint16)
            return predict_frame_trees(plane, preds, batch_size=256, device="cpu")
        caps = {32: 0.5, 16: 0.25, 8: 0.1} if path == "gated" else None
        return predict_partition_trees(_superblocks(), preds, batch_size=256,
                                       level_capacities=caps, device="cpu")

    off = run()
    with recording():
        on = run()
    assert profiling.spans()
    assert off.keys() == on.keys()
    for key in off:
        assert np.array_equal(np.asarray(off[key]), np.asarray(on[key])), key
