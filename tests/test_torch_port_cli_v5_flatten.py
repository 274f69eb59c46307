"""Port parity of ``run_pipeline_eval --variant v5`` and ``--variant flatten``:
``av1tpu_torch.cli.run_pipeline_eval --device cpu`` against
``av1tpu.cli.run_pipeline_eval --single-device`` on the same checkpoints (npz
and reference-shaped ``.pt``) and a 512-block 16 px dataset whose QPs vary
per block, fp32.

As in ``test_torch_port_cli.py``: the metrics JSON is equal but for the
throughput, predicted labels are equal where every decision behind them has a
margin above 1e-3, stage-1 probabilities agree to 1e-4, and the npz keys,
the CSV and the text report's metric table are the JAX CLI's.
"""
import csv
import functools
import json
import types

import numpy as np
import pytest
import torch

from av1tpu.cli import run_pipeline_eval as jax_cli
from av1tpu.data.bundles import Bundle, save_split
from av1tpu_torch import models as tm
from av1tpu_torch.cli import run_pipeline_eval as port_cli
from av1tpu_torch.cli.common import load_model_variables
from av1tpu_torch.train.checkpoint import save_variables_npz
from chip_smoke import set_first_class_share
from tests.torch_port_fixtures import (
    STAGE1_THRESHOLD,
    assert_input_sensitive,
    cli_bundle,
    images_u16,
    jax_variables,
    seeded_torch_model,
    top2_margin,
)

N_VAL, BATCH = 512, 384  # a full chunk and a 128-row tail
HEADS = ("RECT", "AB", "1TO4")
MODELS = {  # name -> (port class, seed)
    "v5": (tm.HierarchicalModel, 120),
    "v5_qp": (functools.partial(tm.HierarchicalModel, use_qp=True), 121),
    "stage1": (tm.Stage1Model, 122),
    "flat": (tm.Stage2FlatModel, 123),
}


def _bundle(seed: int, n: int) -> Bundle:
    """:func:`cli_bundle`'s split with QPs drawn per block (0..255)."""
    b = cli_bundle(seed, n)
    qps = np.random.default_rng(seed + 1).integers(0, 256, size=n).astype(np.int32)
    return Bundle(samples=b.samples, qps=qps, labels=b.labels)


def _outputs(model, x, qps):
    """``{head name: logits}`` of a port model on ``x``."""
    with torch.no_grad():
        if isinstance(model, tm.HierarchicalModel):
            out = model(x, torch.from_numpy(qps) if model.use_qp else None)
            return {"stage1_head": out.stage1.numpy(), "stage2_head": out.stage2.numpy(),
                    **{f"specialist_heads.{h}": out.specialists[h].numpy() for h in HEADS}}
        return {"head": model(x).numpy()}


def _head(model, name):
    """The object whose ``head[-1]`` is the logits Linear of head ``name``."""
    if name == "head":
        return model.head
    return types.SimpleNamespace(head=model.get_submodule(name).fc)


@pytest.fixture(scope="module")
def ws(tmp_path_factory):
    """The dataset, each model of :data:`MODELS` drawn and calibrated in torch
    with every head's first decision shifted to 60% of the val blocks (F2
    guard passed), saved as npz (the JAX tree) and as a reference-shaped
    ``.pt``, and the decision margins of each CLI variant."""
    root = tmp_path_factory.mktemp("torch_port_cli_v5_flatten")
    dataset = root / "dataset"
    save_split(dataset, 16, _bundle(130, 64), _bundle(131, N_VAL), "v6")
    val = Bundle.load(dataset / "block_16" / "val.npz")
    x = torch.from_numpy(val.samples.astype(np.float32) / 1023.0)
    qps = val.qps.astype(np.float32) / 255.0
    calib = images_u16(132, 128, 16)
    files, margins = {}, {}
    for name, (cls, seed) in MODELS.items():
        model = seeded_torch_model(cls, seed, calib)
        for head, logits in _outputs(model, x, qps).items():
            set_first_class_share(_head(model, head), logits, 0.6)
        heads = _outputs(model, x, qps)
        for logits in heads.values():
            assert_input_sensitive(logits, 1e-4)
        margins[name] = {
            head: (np.abs(1 / (1 + np.exp(-lg.astype(np.float64))) - STAGE1_THRESHOLD)
                   if lg.ndim == 1 else top2_margin(lg))
            for head, lg in heads.items()}
        files[f"{name}.npz"] = save_variables_npz(root / f"{name}_variables.npz",
                                                  jax_variables(model), compress=False)
        files[f"{name}.pt"] = root / f"{name}.pt"
        torch.save({"model_state_dict": model.state_dict()}, files[f"{name}.pt"])
    return {"root": root, "dataset": dataset, "val": val, "files": files, "margins": margins}


RUNS = {  # mode -> run_pipeline_eval arguments, checkpoints by file name
    "v5": ["--variant", "v5", "--v5-checkpoint", "v5.npz", "--csv"],
    "v5_pt": ["--variant", "v5", "--v5-checkpoint", "v5.pt"],
    "v5_qp": ["--variant", "v5", "--v5-checkpoint", "v5_qp.npz"],
    "v5_rect_only": ["--variant", "v5", "--v5-checkpoint", "v5.npz",
                     "--available-specialists", "RECT"],
    "flatten": ["--variant", "flatten", "--stage1-checkpoint", "stage1.npz",
                "--flatten-checkpoint", "flat.npz", "--csv"],
}


def _argv(ws, args, out):
    return ["--dataset-dir", str(ws["dataset"]), "--block-size", "16",
            "--output-dir", str(out), "--batch-size", str(BATCH),
            "--stage1-threshold", str(STAGE1_THRESHOLD),
            *(str(ws["files"][a]) if a in ws["files"] else a for a in args)]


def _margin(ws, mode):
    """Per block, the least margin of the decisions behind its label."""
    if mode.startswith("flatten"):
        return np.minimum(ws["margins"]["stage1"]["head"], ws["margins"]["flat"]["head"])
    name = "v5_qp" if mode == "v5_qp" else "v5"
    return np.min(np.stack(list(ws["margins"][name].values())), axis=0)


def _report_table(path):
    """The text report's lines after its header block (the metric table)."""
    lines = path.read_text().splitlines()
    return lines[lines.index("", 3):]


def assert_same_files(got_dir, want_dir, sure, val):
    want = np.load(want_dir / "pipeline_predictions_val.npz")
    got = np.load(got_dir / "pipeline_predictions_val.npz")
    assert set(got.files) == set(want.files)
    for key in ("labels", "class_names"):
        np.testing.assert_array_equal(got[key], want[key])
    np.testing.assert_allclose(got["stage1_prob"], want["stage1_prob"], atol=1e-4, rtol=0)
    np.testing.assert_array_equal(got["predictions"][sure], want["predictions"][sure])

    wm = json.loads((want_dir / "pipeline_metrics_val.json").read_text())
    gm = json.loads((got_dir / "pipeline_metrics_val.json").read_text())
    assert wm.pop("throughput_superblocks_per_sec") > 0
    assert gm.pop("throughput_superblocks_per_sec") > 0
    # the AUC ranks every (positive, negative) pair: a pair whose
    # probabilities are within the 1e-4 parity tolerance may swap
    auc, want_auc = gm["stage1"].pop("auc"), wm["stage1"].pop("auc")
    gate = val.labels["stage1"] == 1
    close = np.abs(want["stage1_prob"][gate][:, None]
                   - want["stage1_prob"][~gate][None, :]) < 2e-4
    assert abs(auc - want_auc) <= close.sum() / close.size
    assert gm == wm
    assert _report_table(got_dir / "pipeline_report_val.txt") == \
        _report_table(want_dir / "pipeline_report_val.txt")
    csv_path = "pipeline_predictions_val.csv"
    assert (got_dir / csv_path).exists() == (want_dir / csv_path).exists()
    if (want_dir / csv_path).exists():
        rows = [list(csv.DictReader((d / csv_path).open())) for d in (got_dir, want_dir)]
        assert [r["true"] for r in rows[0]] == [r["true"] for r in rows[1]]
        assert [r["pred"] for r, s in zip(rows[0], sure) if s] == \
            [r["pred"] for r, s in zip(rows[1], sure) if s]


@pytest.mark.parametrize("mode", list(RUNS))
def test_cli_matches_jax_cli(ws, tmp_path, mode):
    jax_dir, port_dir = tmp_path / "jax", tmp_path / "port"
    jax_cli.main(_argv(ws, RUNS[mode], jax_dir) + ["--single-device"])
    port_cli.main(_argv(ws, RUNS[mode], port_dir) + ["--device", "cpu"])
    sure = _margin(ws, mode) > 1e-3
    assert sure.mean() > 0.9
    assert_same_files(port_dir, jax_dir, sure, ws["val"])
    preds = np.load(port_dir / "pipeline_predictions_val.npz")["predictions"]
    assert len(np.unique(preds)) > 3


@pytest.mark.parametrize("mode, same_as", [
    ("v5_bf16", ["--variant", "v5", "--v5-checkpoint", "v5.npz"]),
    ("flatten_pt", RUNS["flatten"][:-1]),
])
def test_port_cli_variants_equal_their_twins(ws, tmp_path, mode, same_as):
    """``--variant v5 --bf16`` serves fp32, as the JAX CLI does (it builds the
    v5 model without a dtype); flatten from ``.pt`` files writes what it
    writes from the npz files of the same weights."""
    args = (same_as + ["--bf16"] if mode == "v5_bf16"
            else [a.replace(".npz", ".pt") for a in same_as])
    for name, argv in (("twin", same_as), (mode, args)):
        port_cli.main(_argv(ws, argv, tmp_path / name) + ["--device", "cpu"])
    got = np.load(tmp_path / mode / "pipeline_predictions_val.npz")
    want = np.load(tmp_path / "twin" / "pipeline_predictions_val.npz")
    for key in want.files:
        np.testing.assert_array_equal(got[key], want[key])
    gm, wm = (json.loads((tmp_path / d / "pipeline_metrics_val.json").read_text())
              for d in (mode, "twin"))
    gm.pop("throughput_superblocks_per_sec"), wm.pop("throughput_superblocks_per_sec")
    assert gm == wm


def test_qp_model_reads_the_bundle_qps(ws, tmp_path):
    """A QP-conditioned checkpoint is fed the bundle's QPs / 255: with the QPs
    zeroed the same checkpoint gives other stage-1 probabilities."""
    port_cli.main(_argv(ws, RUNS["v5_qp"], tmp_path / "qp") + ["--device", "cpu"])
    prob = np.load(tmp_path / "qp" / "pipeline_predictions_val.npz")["stage1_prob"]
    model = tm.load_jax_variables(tm.HierarchicalModel(use_qp=True),
                                  load_model_variables(ws["files"]["v5_qp.npz"]))
    x = torch.from_numpy(ws["val"].samples.astype(np.float32) / 1023.0)
    with torch.no_grad():
        fed = torch.sigmoid(model.eval()(x, torch.from_numpy(
            ws["val"].qps.astype(np.float32) / 255.0)).stage1).numpy()
        zeroed = torch.sigmoid(model(x, torch.zeros(len(x))).stage1).numpy()
    np.testing.assert_allclose(prob, fed, atol=1e-5, rtol=0)
    assert np.abs(prob - zeroed).max() > 1e-3
