"""BENCHMARK.json against the contract's shape, and every name it holds
resolving to the files the harness reads."""
import json
import re

import pytest

from portbench import spec

BENCH = spec.load_benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]
TEXT = re.compile(r"^[^\n\t]{1,200}$")


def test_top_level_keys_and_paths():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"] and (spec.ROOT / "portbench").is_dir()
    assert 1 <= len(BENCH["command"]) <= 32 and all(TEXT.match(w) for w in BENCH["command"])
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) <= 64 * 1024


def test_names_units_and_entry_keys():
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    names += [c["name"] for c in BENCH["configs"]] + CELLS
    assert len(names) == len(set(names))
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert all(spec.NAME.match(k) for k in c["reduced"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and TEXT.match(w["why"])
        assert spec.NAME.match(w["config"]) and spec.NAME.match(w["traffic"])
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert TEXT.match(m["layer"])
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert spec.NAME.match(m["name"]) and spec.UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves_to_its_files(cell):
    entry = spec.workload(BENCH, cell)
    config = spec.load_config(entry["config"])
    traffic = spec.load_traffic(entry["traffic"])
    assert config["name"] == entry["config"] and traffic["name"] == entry["traffic"]
    assert cell == f"{entry['config']}.{entry['traffic']}"
    assert spec.load_limits(cell)
    e2e, per_layer = spec.cell_metrics(BENCH, cell)
    names = {m["name"] for m in e2e}
    assert "setup_s" in names and len(names) >= 2 and per_layer
    for m in per_layer:
        assert m["moves"] in names, f"{m['name']} moves a metric {cell} does not report"
        assert callable(spec.load_reader(m["name"]))


def test_a_metric_with_a_part_reads_with_its_stems_reader():
    assert not (spec.PKG / "metrics" / "mfu.blocks.py").exists()
    summary = {"on_card": True, "config": spec.load_config("v6_stages"), "peaks": spec.peaks(),
               "family": spec.load_family("stages"),
               "host": {"seconds": 2.0, "level_rows": {16: 8192}}}
    value = spec.load_reader("mfu.blocks")(summary)
    assert value is not None and value > 0 and value == spec.load_reader("mfu")(summary)
    with pytest.raises(FileNotFoundError):
        spec.load_reader("no_such_metric.blocks")


def test_config_entries_match_their_files():
    for c in BENCH["configs"]:
        config = json.loads((spec.ROOT / c["file"]).read_text())
        assert c["file"].startswith("portbench/configs/")
        assert config["source"] == c["source"] and config["reduced"] == c["reduced"]
        assert any(w["config"] == c["name"] for w in BENCH["workloads"])


def test_every_end_to_end_metric_is_reported_somewhere():
    reported = {m["name"] for cell in CELLS for m in spec.cell_metrics(BENCH, cell)[0]}
    assert reported == {m["name"] for m in BENCH["end_to_end"]}
    assert {m["name"] for m in BENCH["end_to_end"]} == {
        "setup_s", "frames_per_s", "frame_ms_p95", "blocks_per_s"}


@pytest.mark.parametrize("name", [c["name"] for c in BENCH["configs"]])
def test_every_configuration_names_a_family_of_two_files_and_the_contract(name):
    from portbench.reference.cascade import DECISIONS
    config = spec.load_config(name)
    folder = spec.PKG / "families" / config["family"]
    assert (folder / "reference.py").is_file() and (folder / "port.py").is_file()
    family = spec.load_family(config["family"])
    assert family.name == config["family"] and family.reference.DECISIONS == DECISIONS
    for fn in ("kinds", "shapes", "level_logits", "first_class_shift", "trunks", "per_block"):
        assert callable(getattr(family.reference, fn)), fn
    assert callable(family.port.build)
    kinds = family.reference.kinds(config)
    assert kinds and set(kinds) <= set(family.port.CLASSES)


def test_a_family_that_decides_otherwise_or_lacks_a_file_is_refused(tmp_path):
    (tmp_path / "flat").mkdir()
    (tmp_path / "flat" / "reference.py").write_text('DECISIONS = ("stage1", "flat7")\n')
    (tmp_path / "flat" / "port.py").write_text("def build(*args):\n    pass\n")
    with pytest.raises(ValueError, match="decides"):
        spec.load_family("flat", directory=tmp_path)
    (tmp_path / "half").mkdir()
    (tmp_path / "half" / "reference.py").write_text(
        'DECISIONS = ("stage1", "stage2", "rect", "ab")\n')
    with pytest.raises(FileNotFoundError, match="port.py"):
        spec.load_family("half", directory=tmp_path)
