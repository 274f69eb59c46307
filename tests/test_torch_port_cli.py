"""Port parity at the CLI boundary: ``av1tpu_torch.cli.run_pipeline_eval
--device cpu`` against ``av1tpu.cli.run_pipeline_eval --single-device`` on
the same npz checkpoints and a 1,024-block dataset, fp32.

Predictions agree under the margin guard (labels identical where every
decision behind them has a margin above 1e-3), stage-1 probabilities to
1e-4, and the metrics JSON is identical except for the throughput.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from av1tpu.cli import run_pipeline_eval as jax_cli
from av1tpu_torch.cli import run_pipeline_eval as port_cli
from av1tpu_torch.cli.common import load_model_variables
from tests.torch_port_fixtures import cli_argv as _argv
from tests.torch_port_fixtures import cli_workspace

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    ws = cli_workspace(tmp_path_factory.mktemp("torch_port_cli"))
    return ws["root"], ws["dataset"], ws["ckpts"], ws["margins"]


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


@pytest.mark.parametrize("flag, item", [
    (["--int8"], "M9"), (["--variant", "v5"], "M8"), (["--variant", "flatten"], "M8"),
])
def test_unported_flags_name_their_roadmap_item(setup, tmp_path, capsys, flag, item):
    _, dataset, ckpts, _ = setup
    with pytest.raises(SystemExit):
        port_cli.main(_argv(dataset, ckpts, tmp_path, False, flag + ["--device", "cpu"]))
    assert f"ROADMAP {item}" in capsys.readouterr().err


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


def test_reference_pt_checkpoints_wait_for_m4(tmp_path):
    with pytest.raises(ValueError, match="ROADMAP M4"):
        load_model_variables(tmp_path / "stage1.pt")
