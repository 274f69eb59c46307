"""``graph_replay_share`` on synthetic spans: the share of predictor calls
that replayed a graph, and None for a program that records no graph span."""
import pytest

from portbench import program_spans, spec

MS = 1_000_000
BENCH = spec.load_benchmark()
CASCADES = ["v6_stages.offline_1080p", "v6_unified.offline_1080p", "v6_stages.live_1440p"]


def span(id, name, start, end, parent=None):
    return {"id": id, "name": name, "parent": parent, "call": 1, "thread": 1,
            "start_ns": start * MS, "end_ns": end * MS, "attrs": {"rows": 256},
            "device_ms": None}


# Four predictor calls: eager; captured, then replayed; replayed; replayed.
# A replay outside any predictor call counts for nothing.
SPANS = [
    span(1, "batching", 0, 100),
    span(2, "batching.predict", 0, 20, parent=1),
    span(3, "batching.predict", 20, 50, parent=1),
    span(4, "pipeline.capture", 21, 40, parent=3),
    span(5, "pipeline.replay", 40, 49, parent=3),
    span(6, "batching.predict", 50, 60, parent=1),
    span(7, "pipeline.replay", 51, 59, parent=6),
    span(8, "batching.predict", 60, 70, parent=1),
    span(9, "pipeline.replay", 61, 69, parent=8),
    span(10, "pipeline.replay", 80, 90),
]


def summary(spans, on_card=True):
    return {"on_card": on_card, "trace": {"frames": 2, "kernels": []},
            program_spans.KEY: spans}


@pytest.mark.parametrize("name", ["graph_replay_share", "graph_replay_share.blocks"])
def test_the_share_of_predicts_that_replayed(name):
    read = spec.load_reader(name)
    assert read(summary(SPANS)) == pytest.approx(75.0)
    replays_only = [s for s in SPANS if s["name"] != "pipeline.capture"]
    assert read(summary(replays_only)) == pytest.approx(75.0)
    eager = [s for s in SPANS if s["id"] in (1, 2, 3, 6)] + [span(11, "pipeline.capture", 3, 9,
                                                                   parent=2)]
    assert read(summary(eager)) == 0.0


@pytest.mark.parametrize("name", ["graph_replay_share", "graph_replay_share.blocks"])
def test_a_program_without_graph_spans_reads_none(name):
    read = spec.load_reader(name)
    without = [s for s in SPANS if not s["name"].startswith("pipeline.")]
    assert read(summary(without)) is None
    assert read(summary(SPANS, on_card=False)) is None
    assert read(summary(None)) is None
    assert read(summary([span(1, "pipeline.replay", 0, 1)])) is None  # no predictor call


def test_the_entries_name_the_pipeline_layer_and_their_cells():
    entries = {m["name"]: m for m in BENCH["per_layer"]}
    share, blocks = entries["graph_replay_share"], entries["graph_replay_share.blocks"]
    for m in (share, blocks):
        assert (m["unit"], m["better"], m["source"], m["layer"]) == (
            "%", "higher", "program_span", "pipeline")
    assert share["moves"] == "frames_per_s" and share["workloads"] == CASCADES
    assert blocks["moves"] == "blocks_per_s" and blocks["workloads"] == ["v6_stages.blocks_16px"]
    assert list(entries)[-2:] == ["graph_replay_share", "graph_replay_share.blocks"]
