"""Port parity at the CLI boundary: ``av1tpu_torch.cli.predict_trees --device
cpu`` against ``av1tpu.cli.predict_trees --single-device`` on one synthetic
yuv420p10le clip and the same npz checkpoints, fp32.

Every key of every ``trees_frame<N>.npz`` has the JAX CLI's dtype, shape and
values, and ``tree_stats.json`` is the same but for ``seconds``. Equality is
exact: the outputs are integers, and a seed that put a logit margin inside
float noise would be replaced, not tolerated.
"""
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import av1tpu.quant
from av1tpu.cli import predict_trees as jax_cli
from av1tpu_torch import models as tm
from av1tpu_torch.cli import predict_trees as port_cli
from av1tpu_torch.eval import predict_partition_trees
from av1tpu_torch.ingest.tiler import tile_frame
from av1tpu_torch.ingest.yuv import Yuv420p10Geometry, read_y_frame
from av1tpu_torch.quant import make_unified_pipeline_int8
from av1tpu_torch.train.checkpoint import save_variables_npz
from tests.torch_port_fixtures import (
    LEVEL_SIZES,
    blocks_of_every_size,
    cascade_stage_models,
    cascade_unified_models,
    jax_variables,
    seeded_torch_model,
    superblocks_u16,
)

REPO = Path(__file__).resolve().parents[1]
W, H, FRAMES = 192, 128, 3  # 3 x 2 superblocks a frame
CKPT = {"stage1": "stage1", "stage2": "stage2", "rect": "stage3_rect", "ab": "stage3_ab"}


def _save_npz(path, model, **collections):
    """Not compressed: 21 ResNet-18s of random floats would take a minute."""
    save_variables_npz(path, {**jax_variables(model), **collections}, compress=False)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The clip, and one checkpoint directory per block size holding the four
    stage checkpoints and the unified one; the 16 px directory also holds an
    FGVC AB checkpoint (with a ``centers`` collection, which both CLIs drop)."""
    root = tmp_path_factory.mktemp("torch_port_predict_trees")
    sbs = superblocks_u16(500, FRAMES * 6).reshape(FRAMES, 2, 3, 64, 64)
    luma = sbs.transpose(0, 1, 3, 2, 4).reshape(FRAMES, H, W)
    yuv = root / f"clip_{W}x{H}_30.yuv"
    with open(yuv, "wb") as f:
        for plane in luma:
            f.write(plane.astype("<u2").tobytes())
            f.write(np.full(2 * (H // 2) * (W // 2), 512, "<u2").tobytes())
    dirs = {}
    stages, unified = cascade_stage_models(seed=510), cascade_unified_models(seed=520)
    for size in LEVEL_SIZES:
        dirs[size] = root / f"models_{size}"
        for name, model in stages[size].items():
            _save_npz(dirs[size] / f"{CKPT[name]}_best_variables.npz", model)
        _save_npz(dirs[size] / "unified_best_variables.npz", unified[size])
    calib = blocks_of_every_size(superblocks_u16(530, 8))[16]
    _save_npz(dirs[16] / "stage3_ab_fgvc_best_variables.npz",
              seeded_torch_model(tm.FGVCModel, 531, calib),
              centers={"centers": np.zeros((4, 128), np.float32)})
    yield yuv, dirs
    for path in dirs.values():  # ~0.9 GB of checkpoints
        shutil.rmtree(path)


def _argv(yuv, dirs, out, extra):
    models = [x for size in LEVEL_SIZES for x in (f"--models-{size}", str(dirs[size]))]
    return ["--yuv", str(yuv), *models, "--output-dir", str(out),
            "--batch-size", "64", *extra]


CASES = {
    # FGVC AB at 16 px (unfolded inside the folded pipeline), the plain AB
    # checkpoint elsewhere (the lookup falls back); a group of two frames and
    # one of one. The plain per-stage graph takes the JAX CLI minutes to
    # compile: test_per_stage_folded_cli_agrees_with_the_plain_cli ties it to
    # this run, and the plain unified graph runs below.
    "per_stage_folded": (["--folded", "--frames", "0", "1", "2",
                          "--frames-per-batch", "2"], [0, 1, 2]),
    "unified_folded_serial_overflow": (
        ["--unified", "--folded", "--serial-io", "--frames", "2",
         "--stage1-threshold", "0.45", "0.4", "0.5", "0.45",
         "--level-capacity", "1", "0.4", "0.1", "0.02"], [2]),
    "unified_tta_gated": (
        ["--unified", "--tta", "--frames", "0", "1", "--frames-per-batch", "2",
         "--level-capacity", "0.9", "0.9", "0.8", "0.7"], [0, 1]),
}


@pytest.mark.parametrize("case", list(CASES))
def test_cli_matches_jax_cli(setup, tmp_path, capsys, case):
    yuv, dirs = setup
    extra, frames = CASES[case]
    jax_cli.main(_argv(yuv, dirs, tmp_path / "jax", extra) + ["--single-device"])
    capsys.readouterr()
    port_cli.main(_argv(yuv, dirs, tmp_path / "port", extra) + ["--device", "cpu"])
    printed = capsys.readouterr()

    reached = []
    for frame in frames:
        want = np.load(tmp_path / "jax" / f"trees_frame{frame}.npz")
        got = np.load(tmp_path / "port" / f"trees_frame{frame}.npz")
        assert sorted(got.files) == sorted(want.files)
        for key in want.files:
            assert got[key].dtype == want[key].dtype, key
            assert got[key].shape == want[key].shape, key
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
        assert want["trees"].shape == (6, 85)
        reached.append((want["trees"] >= 0).sum(axis=1))
    reached = np.concatenate(reached)
    if case == "unified_folded_serial_overflow":  # truncated where a level overflows
        assert reached.min() < 5 < reached.max()
    else:
        assert reached.min() < 21 < reached.max()  # shallow trees and 8 px leaves

    want_stats = json.loads((tmp_path / "jax" / "tree_stats.json").read_text())
    got_stats = json.loads((tmp_path / "port" / "tree_stats.json").read_text())
    assert json.loads(printed.out) == got_stats
    for stats in (want_stats, got_stats):
        for frame_stats in stats.values():
            assert frame_stats.pop("seconds") > 0
    assert got_stats == want_stats
    if case == "unified_tta_gated":
        assert "C64=0.9 has no effect" in printed.err
        assert set(got_stats["0"]) >= {"group_overflow_32", "group_overflow_8",
                                       "frames_in_batch"}
    if case == "unified_folded_serial_overflow":
        assert sum(got_stats["2"][f"overflow_{s}"] for s in (32, 16, 8)) > 0


def test_cli_runs_without_jax_and_with_the_fused_fronts(setup, tmp_path):
    """A fresh interpreter: ``--unified --folded --fused-front g1`` end to end
    (K2's plain version on the CPU at 16 and 8 px), with no jax loaded; its
    trees equal the ``--fused-front off`` run's wherever fp32 allows."""
    yuv, dirs = setup
    base = ["--unified", "--folded", "--frames", "0", "--device", "cpu"]
    argv = _argv(yuv, dirs, tmp_path / "g1", base + ["--fused-front", "g1"])
    code = (
        "import sys\n"
        "from av1tpu_torch.cli.predict_trees import main\n"
        f"main({argv!r})\n"
        "loaded = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'flax', 'av1tpu'))\n"
        "assert not loaded, loaded\n"
    )
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    port_cli.main(_argv(yuv, dirs, tmp_path / "off", base))
    got = np.load(tmp_path / "g1" / "trees_frame0.npz")["trees"]
    want = np.load(tmp_path / "off" / "trees_frame0.npz")["trees"]
    assert (got == want).mean() >= 0.99


def test_per_stage_folded_cli_agrees_with_the_plain_cli(setup, tmp_path):
    """The port's CLI alone, per-stage: ``--folded`` against the plain graph
    on one frame, fp32 (BN folding moves logits by float noise only)."""
    yuv, dirs = setup
    base = ["--frames", "1", "--no-ab-fgvc", "--device", "cpu"]
    port_cli.main(_argv(yuv, dirs, tmp_path / "plain", base))
    port_cli.main(_argv(yuv, dirs, tmp_path / "folded", base + ["--folded"]))
    got = np.load(tmp_path / "folded" / "trees_frame1.npz")
    want = np.load(tmp_path / "plain" / "trees_frame1.npz")
    assert sorted(got.files) == sorted(want.files)
    assert (got["trees"] == want["trees"]).mean() >= 0.99
    assert (want["trees"] >= 0).sum(axis=1).max() > 21


def test_flag_wiring(monkeypatch):
    """--tta implies swap-aligned AB averaging, --no-tta-align-ab restores the
    naive mean; --fused-front reaches ``build_level_predictor`` as
    ``use_fused_front``; the
    thresholds fan out per level."""
    seen = []

    def fake_build(model_dir, threshold, dtype, ab_fgvc, **kwargs):
        seen.append((threshold, dtype, kwargs))
        if len(seen) % 4 == 0:
            raise RuntimeError("stop-test")

    monkeypatch.setattr(port_cli, "build_level_predictor", fake_build)
    base = ["--yuv", "clip_128x64_30.yuv", "--output-dir", "out", "--device", "cpu",
            "--models-64", "m", "--models-32", "m", "--models-16", "m", "--models-8", "m"]
    for extra, want in (
        (["--tta"], dict(tta=True, tta_align_ab=True)),
        (["--tta", "--no-tta-align-ab"], dict(tta=True, tta_align_ab=False)),
        ([], dict(tta=False, tta_align_ab=False, use_fused_front=False, folded=False)),
        (["--folded", "--fused-front", "g1", "--bf16", "--unified", "--single-device"],
         dict(folded=True, use_fused_front="g1", unified=True)),
        (["--folded", "--fused-front", "on"], dict(use_fused_front=True)),
    ):
        with pytest.raises(RuntimeError, match="stop-test"):
            port_cli.main(base + extra)
        threshold, dtype, kwargs = seen[-1]
        assert threshold == 0.45
        assert dtype == (torch.bfloat16 if "--bf16" in extra else torch.float32)
        assert {k: kwargs[k] for k in want} == want, extra
        assert kwargs["device"] == torch.device("cpu")
    with pytest.raises(RuntimeError, match="stop-test"):
        port_cli.main(base + ["--stage1-threshold", "0.5", "0.4", "0.3", "0.2"])
    assert [s[0] for s in seen[-4:]] == [0.5, 0.4, 0.3, 0.2]


@pytest.mark.parametrize("extra, message", [
    (["--tta", "--folded"], "--tta is incompatible with --folded"),
    (["--tta-align-ab"], "--tta-align-ab requires --tta"),
    (["--fused-front", "on"], "--fused-front needs --folded"),
    (["--stage1-threshold", "0.4", "0.5"], "takes 1 or 4 values"),
    (["--yuv", "clip.yuv"], "cannot infer resolution"),
    (["--int8", "--folded"], "--int8 is a distinct serving path"),
    (["--int8", "--fused-front", "g1"], "no group-1 hook"),
])
def test_argument_errors(tmp_path, capsys, extra, message):
    base = ["--yuv", "clip_128x64_30.yuv", "--output-dir", str(tmp_path), "--device", "cpu",
            "--models-64", "m", "--models-32", "m", "--models-16", "m", "--models-8", "m"]
    with pytest.raises(SystemExit) as exit_info:
        port_cli.main(base + extra)
    assert exit_info.value.code == 2
    assert message in capsys.readouterr().err


def test_cuda_is_the_default_and_needs_a_card(tmp_path, capsys):
    assert port_cli.build_parser().parse_args(
        ["--yuv", "c_64x64.yuv", "--output-dir", "o", "--models-64", "m",
         "--models-32", "m", "--models-16", "m", "--models-8", "m"]).device == "cuda"
    if torch.cuda.is_available():
        return
    with pytest.raises(SystemExit):
        port_cli.main(["--yuv", "clip_128x64_30.yuv", "--output-dir", str(tmp_path),
                       "--models-64", "m", "--models-32", "m", "--models-16", "m",
                       "--models-8", "m"])
    assert "no CUDA device" in capsys.readouterr().err


def test_helpers_equal_the_jax_cli():
    for values in ([0.4], [0.5, 0.4, 0.45, 0.6]):
        assert port_cli.normalize_thresholds(values) == jax_cli.normalize_thresholds(values)
    for bad in ([], [0.4, 0.5], [0.1, 0.2, 0.3, 0.4, 0.5]):
        with pytest.raises(ValueError):
            port_cli.normalize_thresholds(bad)
    trees = np.arange(6)[:, None] * np.ones((6, 85), np.int32)
    result = {"trees": trees, "overflow_16": np.asarray(4), "overflow_8": np.asarray(1)}
    for n_frames, frame_sbs, j in ((2, 3, 0), (2, 3, 1), (1, 6, 0)):
        got = port_cli.split_group_result(result, n_frames, frame_sbs, j)
        want = jax_cli.split_group_result(result, n_frames, frame_sbs, j)
        assert sorted(got) == sorted(want)
        for key in want:
            np.testing.assert_array_equal(got[key], want[key])
    assert "group_overflow_16" in port_cli.split_group_result(result, 2, 3, 0)


class _Stop(Exception):
    """Raised once every level's calibration set is captured."""


def _captured_calibration(monkeypatch, module, names, main, argv) -> dict:
    """``{size: uint16 blocks}`` that ``main`` hands each level's int8
    pipeline builder (looked up as ``module.<name>``), stopped before any
    quantization."""
    sets = {}

    def capture(model, calib, **kwargs):
        sets[64 >> len(sets)] = np.array(calib)
        if len(sets) == len(LEVEL_SIZES):
            raise _Stop
        return None

    for name in names:
        monkeypatch.setattr(module, name, capture)
    with pytest.raises(_Stop):
        main(argv)
    return sets


INT8_CALIB = {  # case -> (--frames, --int8-calib-blocks)
    "three_frames_40_blocks": (["0", "1", "2"], "40"),
    "one_frame_all_blocks": (["2"], "1000"),
}


@pytest.mark.parametrize("case", list(INT8_CALIB))
def test_int8_calibration_blocks_equal_the_jax_cli(setup, tmp_path, monkeypatch, case):
    """The self-serve calibration: the same frames, the same ``default_rng(0)``
    draws per level, the same blocks, byte for byte (no quantization runs)."""
    yuv, dirs = setup
    frames, n = INT8_CALIB[case]
    extra = ["--int8", "--int8-calib-blocks", n, "--frames", *frames]
    names = ("make_v6_pipeline_int8", "make_unified_pipeline_int8")
    want = _captured_calibration(monkeypatch, av1tpu.quant, names, jax_cli.main,
                                 _argv(yuv, dirs, tmp_path / "jax", extra) + ["--single-device"])
    got = _captured_calibration(monkeypatch, port_cli, names, port_cli.main,
                                _argv(yuv, dirs, tmp_path / "port", extra + ["--device", "cpu"]))
    assert sorted(got) == sorted(want) == sorted(LEVEL_SIZES)
    blocks_per_sb = {size: (64 // size) ** 2 for size in LEVEL_SIZES}
    for size in LEVEL_SIZES:
        assert got[size].dtype == want[size].dtype == np.uint16
        assert got[size].shape == want[size].shape
        assert got[size].shape[0] == min(int(n), 6 * len(frames) * blocks_per_sb[size])
        assert got[size].tobytes() == want[size].tobytes(), size


def test_int8_unified_cli_equals_the_library(setup, tmp_path, monkeypatch):
    """``--int8 --unified`` end to end on the CPU: its trees equal
    ``predict_partition_trees`` over ``make_unified_pipeline_int8``
    predictors built from the JAX CLI's calibration sets, and vary."""
    yuv, dirs = setup
    extra = ["--int8", "--unified", "--int8-calib-blocks", "64", "--frames", "0", "1"]
    with monkeypatch.context() as patch:
        sets = _captured_calibration(patch, av1tpu.quant, ("make_unified_pipeline_int8",),
                                     jax_cli.main, _argv(yuv, dirs, tmp_path / "jax", extra)
                                     + ["--single-device"])
    port_cli.main(_argv(yuv, dirs, tmp_path / "port", extra + ["--device", "cpu"]))
    predictors = {}
    for size in LEVEL_SIZES:
        variables = port_cli.load_model_variables(dirs[size] / port_cli.UNIFIED_CKPT_NAME)
        model = tm.load_jax_variables(tm.UnifiedV6Model(), variables).eval()
        predictors[size] = make_unified_pipeline_int8(model, sets[size], device="cpu")
    geom = Yuv420p10Geometry(width=W, height=H)
    sbs = np.concatenate([tile_frame(read_y_frame(yuv, f, geom), 64)[0] for f in (0, 1)])
    want = predict_partition_trees(sbs, predictors, 64, device="cpu")["trees"]
    got = np.concatenate([np.load(tmp_path / "port" / f"trees_frame{f}.npz")["trees"]
                          for f in (0, 1)])
    np.testing.assert_array_equal(got, np.asarray(want))
    reached = (got >= 0).sum(axis=1)
    assert reached.min() < reached.max()
