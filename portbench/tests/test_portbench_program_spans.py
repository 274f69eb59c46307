"""The reductions of the port's spans (``program_spans``) on synthetic spans
and kernels, and whole traced CPU runs whose spans the new readers read."""
import pytest
import torch

from portbench import program_spans, run, spec
from portbench.tests.test_portbench_run import SEED, tiny

MS = 1_000_000
BENCH = spec.load_benchmark()
NEW = {"tile_ms", "upload_ms", "cascade_self_ms", "level64_device_ms", "level32_device_ms",
       "level16_device_ms", "level8_device_ms", "predict_host_ms", "predict_host_ms.blocks",
       "predict_idle_ms", "predict_idle_ms.blocks", "stage_ms", "batch_wait_ms"}
DEVICE_ONLY = {"level64_device_ms", "level32_device_ms", "level16_device_ms",
               "level8_device_ms", "predict_idle_ms", "predict_idle_ms.blocks"}


def span(id, name, start, end, parent=None, thread=1, device_ms=None, **attrs):
    return {"id": id, "name": name, "parent": parent, "call": 1, "thread": thread,
            "start_ns": start * MS, "end_ns": end * MS, "attrs": attrs,
            "device_ms": device_ms}


# One call: a cascade with its upload and two levels, each level's predicts,
# a span nested in the second predict on the same thread, and a producer's
# stage on another thread under the level.
SPANS = [
    span(1, "cascade", 0, 100),
    span(2, "cascade.upload", 2, 8, parent=1),
    span(3, "cascade.level", 10, 45, parent=1, device_ms=30.0, px=64),
    span(4, "cascade.level", 48, 95, parent=1, device_ms=12.5, px=8),
    span(5, "batching.predict", 10, 40, parent=3),
    span(6, "batching.predict", 50, 90, parent=4),
    span(7, "inner", 60, 70, parent=6),
    span(8, "batching.stage", 50, 95, parent=4, thread=2),
    span(9, "batching.ring_wait", 52, 55, parent=8, thread=2),
]
KERNELS = [("k", 20 * MS, 30 * MS), ("k", 35 * MS, 55 * MS), ("k", 65 * MS, 68 * MS),
           ("k", 25 * MS, 28 * MS)]


def summary(trace, spans=SPANS):
    return {"on_card": True, "trace": trace, program_spans.KEY: spans}


def test_self_time_takes_out_the_named_children_alone():
    assert program_spans.self_ms(SPANS, "cascade", ("cascade.upload", "cascade.level")) == (
        pytest.approx(100 - 6 - 35 - 47))
    assert program_spans.self_ms(SPANS, "batching.stage", ("batching.ring_wait",)) == (
        pytest.approx(45 - 3))
    assert program_spans.total_ms(SPANS, "batching.predict") == pytest.approx(30 + 40)
    assert program_spans.self_ms(SPANS, "absent", ()) is None
    assert program_spans.total_ms(SPANS, "absent") is None


def test_idle_is_counted_where_the_span_is_innermost_on_its_thread():
    # predict 5 [10, 40]: kernels cover 20-30 and 35-40, so 15 idle; predict
    # 6 [50, 90] less its child 60-70: kernels cover 50-55 of 30 ms, so 25
    # idle (the kernel at 65-68 runs inside the child); the producer's stage
    # on thread 2 takes nothing out of the predicts.
    assert program_spans.idle_ms(SPANS, KERNELS, "batching.predict") == pytest.approx(40)
    assert program_spans.own_intervals(SPANS[5], [SPANS[6], SPANS[7]]) == [
        (50 * MS, 60 * MS), (70 * MS, 90 * MS)]
    assert program_spans.idle_ms(SPANS, [], "batching.predict") is None
    assert program_spans.idle_ms(SPANS, KERNELS, "absent") is None


def test_device_time_by_level_and_its_absence():
    assert program_spans.device_ms(SPANS, "cascade.level", px=64) == 30.0
    assert program_spans.device_ms(SPANS, "cascade.level") == 42.5
    assert program_spans.device_ms(SPANS, "cascade.level", px=16) is None
    unresolved = SPANS[:3] + [dict(SPANS[3], device_ms=None)]
    assert program_spans.device_ms(unresolved, "cascade.level") is None


def test_readers_normalise_per_frame_and_per_batch():
    per_frame = summary({"frames": 2, "kernels": KERNELS})
    per_batch = summary({"batches": 4, "kernels": KERNELS})
    reads = {name: spec.load_reader(name) for name in NEW}
    assert reads["cascade_self_ms"](per_frame) == pytest.approx(12 / 2)
    assert reads["upload_ms"](per_frame) == pytest.approx(6 / 2)
    assert reads["level8_device_ms"](per_frame) == pytest.approx(12.5 / 2)
    assert reads["predict_host_ms"](per_frame) == pytest.approx(70 / 2)
    assert reads["predict_host_ms.blocks"](per_batch) == pytest.approx(70 / 4)
    assert reads["predict_idle_ms"](per_frame) == pytest.approx(40 / 2)
    assert reads["predict_idle_ms.blocks"](per_batch) == pytest.approx(40 / 4)
    assert reads["stage_ms"](per_batch) == pytest.approx(42 / 4)
    assert reads["tile_ms"](per_frame) is None and reads["batch_wait_ms"](per_batch) is None
    assert reads["upload_ms"](dict(per_frame, on_card=False)) is None
    assert reads["upload_ms"](summary({"frames": 2, "kernels": []}, spans=None)) is None


def test_the_spans_are_taken_once_a_run_and_a_port_without_them_reads_none(monkeypatch):
    from av1tpu_torch.utils import profiling
    calls = []
    monkeypatch.setattr(profiling, "spans", lambda: calls.append(1) or list(SPANS))
    s = {"on_card": True, "trace": {"frames": 2, "kernels": KERNELS}}
    assert spec.load_reader("upload_ms")(s) == pytest.approx(3)
    assert spec.load_reader("predict_idle_ms")(s) == pytest.approx(20)
    assert calls == [1]
    monkeypatch.delattr(profiling, "spans")
    s = {"on_card": True, "trace": {"frames": 2, "kernels": KERNELS}}
    assert spec.load_reader("upload_ms")(s) is None


@pytest.fixture
def summaries(monkeypatch):
    """Every summary a run hands its readers."""
    seen, load_reader = [], spec.load_reader

    def recording(name, *args, **kwargs):
        read = load_reader(name, *args, **kwargs)
        return lambda s: (seen.append(s), read(s))[1]

    monkeypatch.setattr(spec, "load_reader", recording)
    return seen


@pytest.fixture(autouse=True)
def _threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(4)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("cell", ["v6_stages.live_1440p", "v6_stages.blocks_16px"])
def test_a_traced_cpu_run_gives_the_readers_the_ports_spans(cell, summaries):
    """Off the card the line leaves the span metrics out; the same run's
    summary, read as if on the card, gives every host-side one and None for
    those of the device."""
    result = run.run_cell(cell, SEED, 0.2, True, torch.device("cpu"), traffic=tiny(cell))
    assert result["correct"] is True and not set(result["metrics"]) & NEW
    names = {m["name"] for m in spec.cell_metrics(BENCH, cell)[1]} & NEW
    assert names == (NEW - {"predict_host_ms.blocks", "predict_idle_ms.blocks", "stage_ms",
                            "batch_wait_ms"} if "blocks" not in cell else
                     {"predict_host_ms.blocks", "predict_idle_ms.blocks", "stage_ms",
                      "batch_wait_ms"})
    s = dict(summaries[0], on_card=True)
    assert s["trace"]["kernels"] == []  # the CPU profiler records no device kernel
    for name in names:
        value = spec.load_reader(name)(s)
        if name in DEVICE_ONLY:
            assert value is None, name
        else:
            assert value is not None and value > 0, name
