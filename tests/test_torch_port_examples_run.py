"""The port's examples run alone on the CPU (``--device cpu``): tree_demo
then tta_eval. The others: ``test_torch_port_examples_train.py``
(int8_selfcalib_ab, scale_demo_v5, bench_ingest_to_trees),
``..._demos.py`` (unified_demo, demo_e2e), ``..._scale.py`` (scale_demo)
and ``..._extras.py`` (scale_demo_extras).

* tree_demo and tta_eval pack 1280x768 frames (240 superblocks), and the
  cascade over one such frame takes about 80 s on one CPU thread: their
  frame geometry is patched to 192x128 (six superblocks), and tree_demo's
  four trainers are stubbed to link one level's seeded stage checkpoints
  (tests/torch_port_fixtures.py) and write their history files;
  ``prepare_stage3``, ``optimize_thresholds``, ``predict_trees`` (folded,
  ``--fused-front g1``, then ``on`` through ``--resume``; plain with TTA) and
  ``tree_accuracy`` run for real.

Every test removes what it wrote, and each trainer's TrainState checkpoints
as soon as its CLI returns (:func:`remove_outputs`): the full-width
checkpoints fill a disk otherwise.
"""
import importlib
import json
import shutil
from pathlib import Path

import numpy as np
import pytest

from av1tpu_torch.examples import _common
from av1tpu_torch.examples import int8_selfcalib_ab
from av1tpu_torch.examples import tree_demo
from av1tpu_torch.examples import tta_eval
from av1tpu_torch.train.checkpoint import save_variables_npz
from tests.torch_port_fixtures import cascade_stage_models, cascade_unified_models, jax_variables

CPU = ["--device", "cpu"]
LEVEL = 32  # the level whose seeded models serve every level (their trees vary)
FILES = {"stage1": "stage1", "stage2": "stage2", "rect": "stage3_rect", "ab": "stage3_ab"}


TRAINERS = ("train_stage1", "train_stage2", "train_stage3", "train_stage2_flat",
            "train_unified")


@pytest.fixture(autouse=True)
def remove_outputs(tmp_path, monkeypatch):
    """Nothing stays behind a test, and no trainer's TrainState checkpoints
    outlive its CLI: each trainer runs whole, then the directories holding
    its ``state.pt`` (``<name>_best|last|final``, 174 MB each at full
    width), which no example reads, are removed. Several example files run
    at once under xdist and would otherwise hold GBs (F8)."""
    for name in TRAINERS:
        module = importlib.import_module(f"av1tpu_torch.cli.{name}")

        def main(argv=None, _main=module.main):
            _main(argv)
            for state in Path(argv[argv.index("--output-dir") + 1]).rglob("state.pt"):
                shutil.rmtree(state.parent)

        monkeypatch.setattr(module, "main", main)
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)


@pytest.fixture
def small_frames(monkeypatch):
    """192x128 frames: 3 x 2 superblocks."""
    geometry = {"FRAME_COLS": 3, "FRAME_ROWS": 2, "FRAME_W": 192, "FRAME_H": 128,
                "SB_PER_FRAME": 6}
    for module in (_common, tree_demo, tta_eval, int8_selfcalib_ab):
        for name, value in geometry.items():
            if hasattr(module, name):
                monkeypatch.setattr(module, name, value)


@pytest.fixture(scope="module")
def level_models(tmp_path_factory):
    """One directory of a level's four stage checkpoints and its unified one."""
    root = tmp_path_factory.mktemp("examples_models")
    for name, model in cascade_stage_models(seed=610, sizes=(LEVEL,))[LEVEL].items():
        save_variables_npz(root / f"{FILES[name]}_best_variables.npz",
                           jax_variables(model), compress=False)
    save_variables_npz(root / "unified_best_variables.npz",
                       jax_variables(cascade_unified_models(seed=620, sizes=(LEVEL,))[LEVEL]),
                       compress=False)
    yield root
    shutil.rmtree(root)


def stub_trainers(monkeypatch, models: Path, calls: list) -> None:
    """tree_demo's trainers: each links its checkpoint from ``models`` into
    its output directory and writes a one-epoch history."""
    from av1tpu_torch.cli import train_stage1, train_stage2, train_stage3

    def trainer(stem_of):
        def main(argv):
            out = Path(argv[argv.index("--output-dir") + 1])
            stem = stem_of(argv)
            calls.append(stem)
            out.mkdir(parents=True, exist_ok=True)
            checkpoint = "stage3_ab" if stem.startswith("stage3_ab") else stem
            (out / f"{checkpoint}_best_variables.npz").symlink_to(
                models / f"{checkpoint}_best_variables.npz")
            (out / f"{stem}_history.json").write_text(json.dumps(
                [{"val_metrics": {"macro_f1": 0.5, "accuracy": 0.5}, "throughput": 1.0}]))
        return main

    monkeypatch.setattr(train_stage1, "main", trainer(lambda argv: "stage1"))
    monkeypatch.setattr(train_stage2, "main", trainer(lambda argv: "stage2"))
    monkeypatch.setattr(train_stage3, "main", trainer(
        lambda argv: "stage3_rect" if "RECT" in argv else "stage3_ab_fgvc"))


def test_tree_demo_then_tta_eval(tmp_path, monkeypatch, small_frames, level_models):
    calls = []
    stub_trainers(monkeypatch, level_models, calls)
    out = tmp_path / "tree"
    argv = ["--out", str(out), "--train-superblocks", "24", "--val-superblocks", "6",
            "--calibrate", "--folded", "--no-bf16", *CPU]
    tree_demo.main(argv + ["--fused-front", "g1"])
    tree_demo.main(argv + ["--resume", "--fused-front", "on"])
    assert sorted(set(calls)) == ["stage1", "stage2", "stage3_ab_fgvc", "stage3_rect"]
    assert len(calls) == 16  # four sizes, once: the --resume run trained nothing

    results = json.loads((out / "RESULTS.json").read_text())
    assert sorted(results["tree_accuracy_variants"]) == ["ladder_g1", "ladder_on"]
    for size in ("64", "32", "16", "8"):
        assert 0.3 <= results["sizes"][size]["calibrated_threshold"] <= 0.7
    for name in ("g1", "on"):
        trees = np.load(out / f"trees_ladder_{name}" / "trees_frame0.npz")["trees"]
        assert trees.shape == (6, 85) and (trees[:, 0] >= 0).all()
        acc = results["tree_accuracy_variants"][f"ladder_{name}"]
        assert 0.0 <= acc["node_accuracy"] <= 1.0 and acc["trees"] == 6
    assert (out / "RESULTS.md").exists()

    tta_eval.main(["--xl-dir", str(out), "--configs", "none", "tta_aligned",
                   "--no-bf16", *CPU])
    report = json.loads((out / "tta_eval.json").read_text())
    assert list(report["configs"]) == ["none", "tta_aligned"]
    assert report["frames"] == 1 and report["clip"] == "val_192x128_30.yuv"
    for config in ("none", "tta_aligned"):
        assert (out / f"trees_{config}" / "trees_frame0.npz").exists()
