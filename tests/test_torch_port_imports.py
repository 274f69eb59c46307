"""The port stands alone: it imports nothing of jax, flax, the JAX package
``av1tpu`` or its ``bench.py``, keeps its own copies of the codec tables and
the dataset bundles (equal to the JAX package's, and readable by it), and
runs on the card unless the caller asks for the CPU.
"""
import inspect
import json
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from av1tpu.codec import partitions as jax_partitions
from av1tpu.data import bundles as jax_bundles
from av1tpu_torch.codec import partitions as port_partitions
from av1tpu_torch.data import bundles as port_bundles
from av1tpu.data.records import BlockSet as JaxBlockSet
from av1tpu_torch.data.records import NORM_10BIT
from av1tpu_torch.eval import (
    fit_stacking,
    make_flatten_pipeline,
    make_unified_pipeline,
    make_unified_pipeline_folded,
    make_v5_pipeline,
    make_v6_pipeline,
    make_v6_pipeline_folded,
    make_v6_pipeline_gated,
    predict_frame_trees,
    predict_partition_trees,
    run_pipeline_batched,
    stacked_member_logits,
    tta_logits,
)
from av1tpu_torch.quant import make_unified_pipeline_int8, make_v6_pipeline_int8

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = ("_common", "demo_e2e", "tree_demo", "tta_eval", "unified_demo",
            "int8_selfcalib_ab", "scale_demo", "scale_demo_extras", "scale_demo_v5",
            "bench_ingest_to_trees")

PROBE = """
import importlib, json, pkgutil, sys
sys.path.insert(0, {root!r})
import av1tpu_torch
names = ["av1tpu_torch"] + [m.name for m in pkgutil.walk_packages(
    av1tpu_torch.__path__, "av1tpu_torch.")]
for name in names + ["chip_smoke"]:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "av1tpu", "bench"))
print(json.dumps({{"imported": names + ["chip_smoke"], "bad": bad}}))
"""


def test_fresh_interpreter_imports_the_port_without_jax_or_av1tpu():
    """Every module under ``av1tpu_torch`` (the examples too) and
    ``chip_smoke`` (not run)."""
    out = subprocess.run([sys.executable, "-c", PROBE.format(root=str(ROOT))],
                         capture_output=True, text=True, cwd=ROOT, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    report = json.loads(out.stdout.strip().splitlines()[-1])
    assert len(report["imported"]) >= 67
    for module in ("codec.tree", "ingest.yuv", "ingest.tiler", "train.augment",
                   "ingest.partition_dump", "ingest.xlsx", "ingest.etl", "ingest.native",
                   "data.synth_tree", "eval.plots", "utils.profiling", "cli.prepare_data",
                   "cli.prepare_dataset", "cli.analysis_report", "cli.visualize_blocks",
                   "eval.unified", "eval.tree_infer", "eval.tree_metrics",
                   "cli.predict_trees", "eval.gated", "eval.ensemble", "eval.compare",
                   "eval.html_report", "cli.optimize_thresholds", "cli.compare_thresholds",
                   "cli.analyze_confusion", "cli.certify_serving", "quant.ptq",
                   "models.jax_import", "data.sampling", "data.synth", "data.records",
                   "train.losses", "train.schedules", "train.trainer", "train.checkpoint",
                   "train.stages", "cli.train_stage1", "cli.train_stage2", "data.noise",
                   "train.fgvc_step", "train.unified", "cli.prepare_stage3",
                   "cli.train_stage3", "cli.train_stage2_flat", "cli.train_unified",
                   "parallel", "parallel.mesh", *(f"examples.{name}" for name in EXAMPLES)):
        assert f"av1tpu_torch.{module}" in report["imported"]
    assert report["bad"] == []


NO_MATPLOTLIB = """
import importlib, json, pkgutil, sys
sys.modules["matplotlib"] = None  # as on a machine without matplotlib
sys.path.insert(0, {root!r})
import av1tpu_torch
names = ["av1tpu_torch"] + [m.name for m in pkgutil.walk_packages(
    av1tpu_torch.__path__, "av1tpu_torch.")] + ["chip_smoke"]
failed = {{}}
for name in names:
    try:
        importlib.import_module(name)
    except ImportError as exc:
        failed[name] = str(exc)
print(json.dumps({{"imported": names, "failed": failed}}))
"""


@pytest.fixture(scope="module")
def without_matplotlib():
    """Every module of the port, and ``chip_smoke``, imported in a fresh
    interpreter where ``import matplotlib`` fails."""
    out = subprocess.run([sys.executable, "-c", NO_MATPLOTLIB.format(root=str(ROOT))],
                         capture_output=True, text=True, cwd=ROOT, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("module", [
    "cli.run_pipeline_eval", "cli.prepare_data", "cli.prepare_dataset", "cli.train_stage1",
    "cli.train_stage2", "cli.train_stage3", "cli.train_stage2_flat", "cli.train_unified",
    "cli.prepare_stage3", "eval.plots", "eval.html_report", "cli.common"])
def test_the_clis_import_without_matplotlib(without_matplotlib, module):
    assert f"av1tpu_torch.{module}" in without_matplotlib["imported"]
    assert without_matplotlib["failed"] == {}


def test_new_modules_import_nothing_of_jax_or_av1tpu():
    """The modules of the data layer, the ETL, the plots, the reports and the
    profiling, each alone in a fresh interpreter."""
    modules = ["ingest.partition_dump", "ingest.xlsx", "ingest.etl", "ingest.native",
               "data.synth_tree", "data.records", "eval.plots", "eval.html_report",
               "utils.profiling", "cli.prepare_data", "cli.prepare_dataset",
               "cli.analysis_report", "cli.visualize_blocks",
               *(f"examples.{name}" for name in EXAMPLES)]
    code = (f"import importlib, json, sys\nsys.path.insert(0, {str(ROOT)!r})\n"
            "bad = {}\n"
            f"for name in {modules!r}:\n"
            "    before = set(sys.modules)\n"
            "    importlib.import_module('av1tpu_torch.' + name)\n"
            "    bad[name] = sorted(m for m in set(sys.modules) - before if m.split('.')[0]\n"
            "                       in ('jax', 'jaxlib', 'flax', 'optax', 'av1tpu', 'bench'))\n"
            "print(json.dumps(bad))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=ROOT, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == {m: [] for m in modules}


def test_no_source_line_imports_jax_or_av1tpu():
    pattern = re.compile(r"^\s*(from|import)\s+(av1tpu\b|jax|flax|optax|bench\b)")
    files = sorted((ROOT / "av1tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) >= 43
    hits = [f"{f.relative_to(ROOT)}:{i}" for f in files
            for i, line in enumerate(f.read_text().splitlines(), 1) if pattern.match(line)]
    assert hits == []


MAPS = ["map_to_stage1", "map_to_stage2_v5", "map_to_stage2_v6", "map_to_stage3_v5",
        "map_to_stage3_v6", "map_to_flatten", "raw_to_v6_final"]


def _same(got, want):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for key in want:
            _same(got[key], want[key])
    elif isinstance(want, tuple):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _same(g, w)
    else:
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", MAPS)
def test_partition_maps_equal_the_jax_package(name):
    """On every raw label value, and on a seeded array of them."""
    every = np.arange(port_partitions.NUM_PARTITION_MODES)
    seeded = np.random.default_rng(11).integers(0, 10, size=(257,))
    for ids in (every, seeded):
        _same(getattr(port_partitions, name)(ids), getattr(jax_partitions, name)(ids))


def test_flatten_to_raw_equals_the_jax_package():
    ids = np.random.default_rng(12).integers(0, 7, size=(100,))
    _same(port_partitions.flatten_to_raw(ids), jax_partitions.flatten_to_raw(ids))


def test_partition_maps_take_torch_tensors():
    import torch

    ids = np.random.default_rng(13).integers(0, 10, size=(64,))
    got = port_partitions.raw_to_v6_final(torch.from_numpy(ids))
    assert isinstance(got, torch.Tensor)
    np.testing.assert_array_equal(got.numpy(), port_partitions.raw_to_v6_final(ids))


def test_partition_tables_and_names_equal_the_jax_package():
    assert port_partitions.__all__ == jax_partitions.__all__
    for name in port_partitions.__all__:
        got, want = getattr(port_partitions, name), getattr(jax_partitions, name)
        if callable(want):
            continue
        if isinstance(want, np.ndarray):
            _same(got, want)
        elif isinstance(want, dict) and want and isinstance(
                next(iter(want.values())), np.ndarray):
            _same(got, want)
        else:
            assert got == want, name


def _record(seed, n=48, bs=16):
    rng = np.random.default_rng(seed)
    return dict(samples=rng.integers(0, 1024, size=(n, bs, bs, 1), dtype=np.uint16),
                labels=rng.integers(0, 10, size=n).astype(np.int32),
                qps=rng.integers(20, 200, size=n).astype(np.int32))


def _v6_bundle(seed, n=48):
    """A port Bundle with the label views of the JAX package's ``build_v6_bundle``."""
    built = jax_bundles.build_v6_bundle(JaxBlockSet(**_record(seed, n)))
    return port_bundles.Bundle(samples=built.samples, qps=built.qps,
                               labels=dict(built.labels))


def test_v6_bundle_equals_the_jax_package():
    """The v6 label views made with the port's maps equal ``build_v6_bundle``'s."""
    rec = _record(21)
    want = jax_bundles.build_v6_bundle(JaxBlockSet(**rec))
    stage2, _ = port_partitions.map_to_stage2_v6(rec["labels"])
    stage3 = port_partitions.map_to_stage3_v6(rec["labels"])
    views = {"stage0": rec["labels"], "stage1": port_partitions.map_to_stage1(rec["labels"]),
             "stage2": stage2, "stage3_RECT": stage3["RECT"], "stage3_AB": stage3["AB"]}
    got = port_bundles.Bundle(samples=rec["samples"], qps=rec["qps"],
                              labels={k: v.astype(np.int32) for k, v in views.items()})
    assert sorted(got.labels) == sorted(want.labels)
    for key in want.labels:
        _same(got.labels[key], want.labels[key])
    _same(got.samples, want.samples)
    _same(got.qps, want.qps)
    assert NORM_10BIT == 1023.0


@pytest.mark.parametrize("writer, reader", [("port", "jax"), ("jax", "port")])
def test_split_saved_by_one_package_loads_in_the_other(tmp_path, writer, reader):
    mods = {"port": port_bundles, "jax": jax_bundles}
    train, val = _v6_bundle(31), _v6_bundle(32, n=24)
    w, r = mods[writer], mods[reader]
    as_w = lambda b: w.Bundle(samples=b.samples, qps=b.qps, labels=dict(b.labels))
    root = w.save_split(tmp_path, 16, as_w(train), as_w(val), "v6")
    for name, want in (("train", train), ("val", val)):
        got = r.Bundle.load(root / f"{name}.npz")
        assert len(got) == len(want)
        _same(got.samples, want.samples)
        _same(got.qps, want.qps)
        assert sorted(got.labels) == sorted(want.labels)
        for key in want.labels:
            _same(got.labels[key], want.labels[key])
        _same(got.take(np.arange(5)).samples, want.samples[:5])
    meta = json.loads((root / "metadata.json").read_text())
    as_r = lambda b: r.Bundle(samples=b.samples, qps=b.qps, labels=dict(b.labels))
    assert meta == json.loads(json.dumps(
        r.bundle_metadata(as_r(train), as_r(val), "v6", 16), sort_keys=True))


@pytest.mark.parametrize("fn", [make_v6_pipeline, run_pipeline_batched,
                                make_v6_pipeline_folded, make_unified_pipeline,
                                make_unified_pipeline_folded, predict_partition_trees,
                                predict_frame_trees, make_v6_pipeline_gated,
                                tta_logits, stacked_member_logits, fit_stacking,
                                make_v6_pipeline_int8, make_unified_pipeline_int8,
                                make_v5_pipeline, make_flatten_pipeline],
                         ids=lambda f: f.__name__)
def test_entry_points_default_to_the_card(fn):
    assert inspect.signature(fn).parameters["device"].default == "cuda"


def test_training_entry_points_default_to_the_card():
    from av1tpu_torch.cli import (
        train_stage1,
        train_stage2,
        train_stage2_flat,
        train_stage3,
        train_unified,
    )
    from av1tpu_torch.cli.common import add_common_train_args
    from av1tpu_torch.train.fgvc_step import create_fgvc_state
    from av1tpu_torch.train.stages import filter_through_stage1, train_stage
    from av1tpu_torch.train.unified import compute_teacher_logits
    import argparse

    for fn in (train_stage, filter_through_stage1, create_fgvc_state, compute_teacher_logits):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    for cli in (train_stage3, train_stage2_flat, train_unified):
        assert "add_common_train_args(parser)" in inspect.getsource(cli.main)
        assert "check_train_args(parser, args)" in inspect.getsource(cli.main)
    parser = argparse.ArgumentParser()
    add_common_train_args(parser)
    assert parser.parse_args(["--dataset-dir", "d", "--output-dir", "o"]).device == "cuda"
    assert train_stage1.main and train_stage2.main
    import torch

    if not torch.cuda.is_available():  # nothing carries on on the CPU
        from av1tpu_torch.train.stages import stage1_recipe

        bundle = _v6_bundle(41, n=16)
        with pytest.raises((RuntimeError, AssertionError)):
            train_stage(stage1_recipe(epochs=1, batch_size=8), bundle, bundle, log=print)


@pytest.mark.parametrize("name", EXAMPLES[1:])
def test_examples_default_to_the_card(name):
    """Each example's ``--device`` is ``cuda`` unless the caller asks for
    the CPU, and asking for the card without one is refused."""
    import argparse
    import importlib

    import torch

    module = importlib.import_module(f"av1tpu_torch.examples.{name}")
    required = ["--models", "m"] if name == "int8_selfcalib_ab" else []
    original = argparse.ArgumentParser.parse_args
    seen = []

    def parse(self, args=None, namespace=None):
        seen.append(original(self, args, namespace))
        raise SystemExit(0)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(argparse.ArgumentParser, "parse_args", parse)
        with pytest.raises(SystemExit):
            module.main(required)
    assert seen[0].device == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit) as refused:
            module.main(required)
        assert refused.value.code == 2


def test_asking_for_the_card_without_one_raises():
    """Nothing carries on on the CPU."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    predict = lambda x: {"final": x}
    with pytest.raises((RuntimeError, AssertionError)):
        run_pipeline_batched(predict, np.zeros((4, 16, 16, 1), np.uint16), batch_size=2)
