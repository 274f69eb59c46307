"""Port parity at the CLI boundary: ``av1tpu_torch.cli.run_pipeline_eval
--device cpu`` against ``av1tpu.cli.run_pipeline_eval --single-device`` on
the same npz checkpoints and a 1,024-block dataset, fp32.

Predictions agree under the margin guard (labels identical where every
decision behind them has a margin above 1e-3), stage-1 probabilities to
1e-4, and the metrics JSON is identical except for the throughput, so the
confusion PNG is the JAX CLI's byte for byte. The same weights served from
reference-shaped ``.pt`` files write the npz run's files.
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

from av1tpu.cli import run_pipeline_eval as jax_cli
from av1tpu_torch.cli import run_pipeline_eval as port_cli
from av1tpu_torch import models as tm
from av1tpu_torch.cli.common import load_model, load_model_variables
from tests.torch_port_fixtures import cli_argv as _argv
from tests.torch_port_fixtures import cli_workspace

REPO = Path(__file__).resolve().parents[1]
PORT_CLASSES = {"stage1": tm.Stage1Model, "stage2": tm.Stage2Model,
                "rect": tm.Stage3RectModel, "ab": tm.Stage3ABModel, "fgvc": tm.FGVCModel}


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    ws = cli_workspace(tmp_path_factory.mktemp("torch_port_cli"))
    yield ws["root"], ws["dataset"], ws["ckpts"], ws["margins"]
    shutil.rmtree(ws["root"])  # full-width checkpoints, ~220 MB


@pytest.fixture
def tmp_path(tmp_path):
    """pytest's ``tmp_path``, removed after the test: the tests here write
    full-width checkpoints, and pytest keeps its last three runs."""
    yield tmp_path
    shutil.rmtree(tmp_path, ignore_errors=True)


@pytest.mark.parametrize("mode, fgvc, extra", [
    ("plain_fgvc", True, []),
    ("folded", False, ["--csv"]),
    ("folded_fgvc_compat", True, ["--folded", "--reference-compat-labels"]),
])
def test_cli_matches_jax_cli(setup, tmp_path, mode, fgvc, extra):
    _, dataset, ckpts, margins = setup
    if mode == "folded":
        extra = ["--folded", *extra]
    jax_cli.main(_argv(dataset, ckpts, tmp_path / "jax", fgvc, extra)
                 + ["--single-device"])
    port_cli.main(_argv(dataset, ckpts, tmp_path / "port", fgvc, extra)
                  + ["--device", "cpu"])

    want = np.load(tmp_path / "jax" / "pipeline_predictions_val.npz")
    got = np.load(tmp_path / "port" / "pipeline_predictions_val.npz")
    assert set(got.files) == set(want.files)
    np.testing.assert_array_equal(got["labels"], want["labels"])
    np.testing.assert_array_equal(got["class_names"], want["class_names"])
    np.testing.assert_allclose(got["stage1_prob"], want["stage1_prob"],
                               atol=1e-4, rtol=0)
    used = ["stage1", "stage2", "rect", "fgvc" if fgvc else "ab"]
    sure = np.min(np.stack([margins[k] for k in used]), axis=0) > 1e-3
    assert sure.mean() > 0.9
    np.testing.assert_array_equal(got["predictions"][sure],
                                  want["predictions"][sure])

    jm_ = json.loads((tmp_path / "jax" / "pipeline_metrics_val.json").read_text())
    pm = json.loads((tmp_path / "port" / "pipeline_metrics_val.json").read_text())
    assert jm_.pop("throughput_superblocks_per_sec") > 0
    assert pm.pop("throughput_superblocks_per_sec") > 0
    assert pm == jm_
    if "--csv" in extra:
        assert (tmp_path / "port" / "pipeline_predictions_val.csv").exists()
    assert (tmp_path / "port" / "pipeline_report_val.txt").exists()
    # equal metrics: the confusion PNG is the JAX CLI's, byte for byte
    png = "pipeline_confusion_val.png"
    assert (tmp_path / "port" / png).read_bytes() == (tmp_path / "jax" / png).read_bytes()


def test_cli_imports_no_jax(setup, tmp_path):
    """The port's CLI runs end to end in a process that never loads jax."""
    _, dataset, ckpts, _ = setup
    argv = _argv(dataset, ckpts, tmp_path / "out", False,
                 ["--folded", "--fused-front", "g1", "--device", "cpu"])
    code = (
        "import sys\n"
        "import av1tpu_torch\n"
        "from av1tpu_torch.cli.run_pipeline_eval import main\n"
        f"main({argv!r})\n"
        "loaded = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'flax'))\n"
        "assert not loaded, loaded\n"
    )
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert (tmp_path / "out" / "pipeline_metrics_val.json").exists()


def test_fused_front_needs_folded_and_cuda_needs_a_card(setup, tmp_path, capsys):
    _, dataset, ckpts, _ = setup
    with pytest.raises(SystemExit):
        port_cli.main(_argv(dataset, ckpts, tmp_path, False,
                            ["--fused-front", "on", "--device", "cpu"]))
    assert "--fused-front needs --folded" in capsys.readouterr().err
    if torch.cuda.is_available():
        return
    with pytest.raises(SystemExit):
        port_cli.main(_argv(dataset, ckpts, tmp_path, False, ["--device", "cuda"]))
    assert "no CUDA device" in capsys.readouterr().err


@pytest.mark.parametrize("fgvc", [False, True], ids=["ab", "fgvc"])
def test_reference_pt_checkpoints_serve_as_their_npz(setup, tmp_path, fgvc):
    """The four stage models saved as reference-shaped ``.pt`` files (each
    model's state dict under ``model_state_dict``) write the files that the
    npz checkpoints of the same weights write: the same predictions and
    probabilities, bit for bit, and the same metrics and report."""
    _, dataset, ckpts, _ = setup
    pts = {}
    for name, cls in PORT_CLASSES.items():
        pts[name] = tmp_path / f"{name}.pt"
        torch.save({"model_state_dict": load_model(ckpts[name], cls).state_dict()},
                   pts[name])
    for name, files in (("npz", ckpts), ("pt", pts)):
        port_cli.main(_argv(dataset, files, tmp_path / name, fgvc,
                            ["--folded", "--device", "cpu"]))
    got = np.load(tmp_path / "pt" / "pipeline_predictions_val.npz")
    want = np.load(tmp_path / "npz" / "pipeline_predictions_val.npz")
    assert set(got.files) == set(want.files)
    for key in want.files:
        np.testing.assert_array_equal(got[key], want[key])
    metrics = [json.loads((tmp_path / d / "pipeline_metrics_val.json").read_text())
               for d in ("pt", "npz")]
    for m in metrics:
        assert m.pop("throughput_superblocks_per_sec") > 0
    assert metrics[0] == metrics[1]
    reports = [[line for line in (tmp_path / d / "pipeline_report_val.txt").read_text()
                .splitlines() if not line.startswith("throughput")] for d in ("pt", "npz")]
    assert reports[0] == reports[1]


def test_checkpoint_formats(tmp_path):
    with pytest.raises(ValueError, match="unsupported checkpoint format"):
        load_model_variables(tmp_path / "stage1.ckpt")
