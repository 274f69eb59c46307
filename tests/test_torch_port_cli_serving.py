"""Port parity of the rest of the v6 serving CLIs: ``run_pipeline_eval``'s
gated, TTA, ensemble and unified runs, ``optimize_thresholds``,
``compare_thresholds``, ``analyze_confusion`` and ``certify_serving``, each
``--device cpu`` against the JAX package's CLI (``--single-device``) on the
same npz checkpoints and a 512-block 16 px dataset, fp32.

As in ``test_torch_port_cli.py``: the metrics JSON is equal but for the
throughput, predicted labels are equal where every decision behind them has a
margin above 1e-3 (margins of the mode's own logits: TTA means, the ensemble's
mean probabilities, the unified heads), and stage-1 probabilities agree to
1e-4. Refusals exit with the JAX CLI's words.

The ``--int8`` runs calibrate in each package on the same seeded train rows,
so the two int8 graphs differ by int8 noise (``test_torch_port_int8.py``):
their labels agree on >= 90% of the rows and wherever every decision's margin
(of the port's int8 logits) exceeds 0.25, stage-1 probabilities within 0.2,
and the metrics JSON has the same keys and counts within the rows that differ.
"""
import csv
import json

import numpy as np
import pytest
import torch

from av1tpu.cli import analyze_confusion as jax_confusion
from av1tpu.cli import certify_serving as jax_certify
from av1tpu.cli import compare_thresholds as jax_compare
from av1tpu.cli import optimize_thresholds as jax_optimize
from av1tpu.cli import run_pipeline_eval as jax_cli
from av1tpu.train.checkpoint import load_variables_npz
from av1tpu_torch import models as tm
from av1tpu_torch.cli import analyze_confusion as port_confusion
from av1tpu_torch.cli import certify_serving as port_certify
from av1tpu_torch.cli import compare_thresholds as port_compare
from av1tpu_torch.cli import optimize_thresholds as port_optimize
from av1tpu_torch.cli import run_pipeline_eval as port_cli
from av1tpu_torch.eval.ensemble import save_ensemble
from av1tpu_torch.cli.common import train_calibration_blocks
from av1tpu_torch.eval.hierarchy import tta_mean_logits
from av1tpu_torch.quant import quantize_stage, quantize_unified
from av1tpu_torch.train.checkpoint import save_variables_npz
from chip_smoke import set_first_class_share
from tests.torch_port_fixtures import (
    FIRST_CLASS_SHARE,
    STAGE1_THRESHOLD,
    assert_input_sensitive,
    cli_argv,
    cli_workspace,
    images_u16,
    jax_variables,
    seeded_torch_model,
    top2_margin,
)

N_VAL, BATCH = 512, 384  # a full chunk and a 128-row tail
INT8_CALIB = 48  # --calib-samples of the v6 int8 run: 48 of the 64 train rows
INT8_MARGIN, INT8_PROB_ATOL, INT8_LABEL_SHARE = 0.25, 0.2, 0.9


@pytest.fixture(scope="module")
def ws(tmp_path_factory):
    """The shared CLI workspace (no FGVC model), plus a seeded unified model
    and three seeded AB ensemble members saved with the port's
    ``save_ensemble``, each head shifted so that its decisions vary."""
    ws = cli_workspace(tmp_path_factory.mktemp("torch_port_cli_serving"), N_VAL,
                       names=("stage1", "stage2", "rect", "ab"))
    calib = images_u16(60, 128, 16)
    x = torch.from_numpy(ws["val"].samples.astype(np.float32) / 1023.0)
    unified = seeded_torch_model(tm.UnifiedV6Model, 61, calib)
    with torch.no_grad():
        logits = unified(x).numpy()
    for name, (lo, hi) in tm.UNIFIED_LOGIT_SLICES.items():
        part = logits[:, lo] if name == "stage1" else logits[:, lo:hi]
        part = set_first_class_share(getattr(unified, f"head_{name}"), part,
                                     FIRST_CLASS_SHARE[name])
        assert_input_sensitive(part, 1e-4)
    ws["unified"] = unified
    ws["ckpts"]["unified"] = save_variables_npz(ws["root"] / "unified_variables.npz",
                                                jax_variables(unified), compress=False)
    members = []
    for seed in (62, 63, 64):
        member = seeded_torch_model(tm.Stage3ABModel, seed, calib)
        with torch.no_grad():
            logits = member(x).numpy()
        assert_input_sensitive(set_first_class_share(member.head, logits, 0.35), 1e-4)
        members.append(member)
    ws["members"] = members
    ws["ensemble"] = ws["root"] / "ensemble"
    save_ensemble(ws["ensemble"], [jax_variables(m) for m in members])
    return ws


@pytest.fixture(scope="module")
def calibration(ws):
    """Each package's ``optimize_thresholds`` output directory."""
    out = {}
    for name, cli in (("jax", jax_optimize), ("port", port_optimize)):
        out[name] = ws["root"] / f"calibration_{name}"
        argv = ["--dataset-dir", str(ws["dataset"]), "--block-size", "16",
                "--stage1-checkpoint", str(ws["ckpts"]["stage1"]),
                "--output-dir", str(out[name]), "--batch-size", str(BATCH)]
        cli.main(argv + (["--device", "cpu"] if name == "port" else []))
    return out


def _int8_models(ws, mode):
    """The port's int8 models of ``mode``, calibrated on the CLI's rows."""
    train = np.load(ws["dataset"] / "block_16" / "train.npz")["samples"]
    calib = train_calibration_blocks(train, INT8_CALIB if mode == "int8" else 512)
    calib = torch.from_numpy(calib.astype(np.float32) / 1023.0)
    if mode == "unified_int8":
        return quantize_unified(ws["unified"], calib)
    return {name: quantize_stage(ws["port"][name], calib)
            for name in ("stage1", "stage2", "rect", "ab")}


def _margins(ws, mode):
    """Per-sample margin of every decision behind the final label."""
    x = torch.from_numpy(ws["val"].samples.astype(np.float32) / 1023.0)
    port = _int8_models(ws, mode) if mode.endswith("int8") else ws["port"]
    with torch.no_grad():
        if mode == "unified_int8":
            s1, *logits = tm.split_unified_logits(port(x))
        elif mode.startswith("unified"):
            s1, *logits = tm.split_unified_logits(ws["unified"](x))
        else:
            def run(m, align=False):
                return tta_mean_logits(m, x, align) if mode == "tta" else m(x)

            s1 = run(port["stage1"])
            logits = [run(port["stage2"]), run(port["rect"]), run(port["ab"], True)]
            if mode == "ensemble":
                logits[2] = torch.stack([torch.softmax(m(x), -1) for m in ws["members"]]
                                        ).mean(0)
    margins = [np.abs(torch.sigmoid(s1).numpy().reshape(-1) - STAGE1_THRESHOLD)]
    margins += [top2_margin(lg.numpy()) for lg in logits]
    return np.min(np.stack(margins), axis=0), torch.sigmoid(s1).numpy().reshape(-1)


SERVING = {  # mode -> extra run_pipeline_eval arguments
    "folded_capacity_0.5": ["--folded", "--capacity", "0.5"],
    "folded_capacity_auto": ["--folded", "--capacity", "auto", "--capacity-margin", "0.1"],
    "tta": ["--tta"],
    "ensemble": [],
    "unified": ["--variant", "unified"],
    "unified_folded": ["--variant", "unified", "--folded"],
    "int8": ["--int8", "--calib-samples", str(INT8_CALIB)],
    "unified_int8": ["--variant", "unified", "--int8"],
}


def _serving_argv(ws, mode, out, calibration_dir):
    argv = cli_argv(ws["dataset"], ws["ckpts"], out, False, SERVING[mode])
    if mode == "ensemble":  # F4: no --stage3-ab-checkpoint with an ensemble
        i = argv.index("--stage3-ab-checkpoint")
        argv = argv[:i] + argv[i + 2:] + ["--stage3-ab-ensemble-dir", str(ws["ensemble"])]
    if mode.startswith("unified"):
        argv += ["--unified-checkpoint", str(ws["ckpts"]["unified"])]
    if mode == "folded_capacity_auto":
        argv += ["--calibration-dir", str(calibration_dir)]
    return argv


@pytest.mark.parametrize("mode", list(SERVING))
def test_serving_cli_matches_jax_cli(ws, calibration, tmp_path, mode):
    jax_dir, port_dir = tmp_path / "jax", tmp_path / "port"
    jax_cli.main(_serving_argv(ws, mode, jax_dir, calibration["jax"]) + ["--single-device"])
    port_cli.main(_serving_argv(ws, mode, port_dir, calibration["port"])
                  + ["--device", "cpu"])
    margins, prob = _margins(ws, mode)
    int8 = mode.endswith("int8")
    sure = margins > (INT8_MARGIN if int8 else 1e-3)
    if not int8:
        assert sure.mean() > 0.9

    want = np.load(jax_dir / "pipeline_predictions_val.npz")
    got = np.load(port_dir / "pipeline_predictions_val.npz")
    assert set(got.files) == set(want.files)
    np.testing.assert_array_equal(got["labels"], want["labels"])
    np.testing.assert_allclose(got["stage1_prob"], want["stage1_prob"],
                               atol=INT8_PROB_ATOL if int8 else 1e-4, rtol=0)
    np.testing.assert_array_equal(got["predictions"][sure], want["predictions"][sure])
    assert len(np.unique(want["predictions"])) > 2

    jm_ = json.loads((jax_dir / "pipeline_metrics_val.json").read_text())
    pm = json.loads((port_dir / "pipeline_metrics_val.json").read_text())
    assert jm_.pop("throughput_superblocks_per_sec") > 0
    assert pm.pop("throughput_superblocks_per_sec") > 0
    if int8:
        differ = got["predictions"] != want["predictions"]
        assert 1 - differ.mean() >= INT8_LABEL_SHARE
        assert pm["int8"] is jm_["int8"] is True
        _close(pm, jm_, counts=int(differ.sum()), share=float(differ.mean()) + 1e-9)
        return
    # the AUC ranks every (positive, negative) pair: a pair whose
    # probabilities are within the 1e-4 parity tolerance may swap
    auc, want_auc = pm["stage1"].pop("auc"), jm_["stage1"].pop("auc")
    gate = ws["val"].labels["stage1"] == 1
    close = np.abs(want["stage1_prob"][gate][:, None]
                   - want["stage1_prob"][~gate][None, :]) < 2e-4
    assert abs(auc - want_auc) <= close.sum() / close.size
    assert pm == jm_
    if "--capacity" in SERVING[mode]:
        # both packages send the same rows to SPLIT only if the K-th and
        # (K+1)-th probabilities of every chunk are apart
        k = int(np.ceil(pm["capacity"] * BATCH))
        for start in range(0, N_VAL, BATCH):
            real = np.sort(prob[start:start + BATCH])[::-1]
            if len(real) > k:
                assert real[k - 1] - real[k] > 1e-4
        report = (port_dir / "pipeline_report_val.txt").read_text()
        assert f"capacity: {pm['capacity']}" in report and "overflow: " in report


def _close(got, want, counts, share, path="metrics"):
    """The same keys, list lengths, strings and flags; integers (counts)
    within ``counts``, the rows whose labels differ; the accuracy within
    ``share``, their share. Other rates are not held: one differing row moves
    a small class's precision and recall by more than that."""
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), path
        for key in want:
            _close(got[key], want[key], counts, share, f"{path}.{key}")
    elif isinstance(want, list):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _close(g, w, counts, share, f"{path}[{i}]")
    elif isinstance(want, (bool, str)) or want is None:
        assert got == want, path
    elif isinstance(want, int):
        assert abs(got - want) <= counts, path
    elif path.endswith(".accuracy"):
        assert abs(got - want) <= share, (path, got, want)


def test_optimize_thresholds_matches_jax(calibration):
    def rows(path):
        with (path / "threshold_sweep.csv").open() as f:
            return list(csv.DictReader(f))

    got, want = rows(calibration["port"]), rows(calibration["jax"])
    assert len(got) == len(want) == 7 and list(got[0]) == list(want[0])
    for g, w in zip(got, want):
        np.testing.assert_allclose([float(v) for v in g.values()],
                                   [float(v) for v in w.values()], atol=1e-6, rtol=0)
    assert len({r["gate_rate"] for r in want}) > 2
    gs = json.loads((calibration["port"] / "threshold_summary.json").read_text())
    ws_ = json.loads((calibration["jax"] / "threshold_summary.json").read_text())
    assert sorted(gs) == sorted(ws_)
    cal, want_cal = gs.pop("calibration"), ws_.pop("calibration")
    np.testing.assert_allclose(cal["temperature"], want_cal["temperature"], rtol=1e-4)
    for key in ("ece_raw", "ece_calibrated"):
        assert abs(cal[key] - want_cal[key]) < 1e-5
    assert cal["ece_calibrated"] < cal["ece_raw"]
    assert gs == ws_
    ckpt = load_variables_npz(calibration["port"] / "stage1_calibrated_variables.npz")
    want_ckpt = load_variables_npz(calibration["jax"] / "stage1_calibrated_variables.npz")
    np.testing.assert_allclose(ckpt["params"]["temperature"],
                               want_ckpt["params"]["temperature"], rtol=1e-4)
    model = tm.load_jax_variables(tm.Stage1Model(), ckpt)  # the port reads it back
    assert float(model.head.temperature.detach()) == float(ckpt["params"]["temperature"][0])


def _tool_argv(ws):
    """The dataset and the four v6 checkpoints, for compare_thresholds and
    certify_serving."""
    return ["--dataset-dir", str(ws["dataset"]), "--block-size", "16",
            "--batch-size", str(BATCH),
            "--stage1-checkpoint", str(ws["ckpts"]["stage1"]),
            "--stage2-checkpoint", str(ws["ckpts"]["stage2"]),
            "--stage3-rect-checkpoint", str(ws["ckpts"]["rect"]),
            "--stage3-ab-checkpoint", str(ws["ckpts"]["ab"]), "--no-ab-fgvc"]


def test_compare_thresholds_matches_jax(ws, tmp_path, monkeypatch):
    # The JAX CLI hands run_pipeline_eval.build_v6 a namespace without the
    # tta_align_ab / int8 / folded fields it reads (an AttributeError in the
    # JAX package); supply the defaults of run_pipeline_eval's parser.
    def build_v6(args, dtype, mesh=None):
        for field, default in (("tta_align_ab", None), ("int8", False), ("folded", False)):
            if not hasattr(args, field):
                setattr(args, field, default)
        return jax_cli.build_v6(args, dtype, mesh=mesh)

    monkeypatch.setattr(jax_compare, "build_v6", build_v6)
    argv = _tool_argv(ws) + ["--thresholds", "0.45", "0.5", "0.55"]
    jax_dir, port_dir = tmp_path / "jax", tmp_path / "port"
    jax_compare.main(argv + ["--output-dir", str(jax_dir), "--single-device"])
    port_compare.main(argv + ["--output-dir", str(port_dir), "--device", "cpu"])
    got = json.loads((port_dir / "operating_points.json").read_text())
    want = json.loads((jax_dir / "operating_points.json").read_text())
    assert [p["threshold"] for p in got["points"]] == [0.45, 0.5, 0.55]
    assert len({p["accuracy"] for p in want["points"]}) > 1
    assert got == want
    assert (port_dir / "operating_points.md").read_text() == \
        (jax_dir / "operating_points.md").read_text()


def test_analyze_confusion_matches_jax(ws, tmp_path):
    argv = ["--dataset-dir", str(ws["dataset"]), "--block-size", "16",
            "--batch-size", str(BATCH), "--stage2-checkpoint", str(ws["ckpts"]["stage2"])]
    jax_confusion.main(argv + ["--output-dir", str(tmp_path / "jax")])
    port_confusion.main(argv + ["--output-dir", str(tmp_path / "port"), "--device", "cpu"])
    got = json.loads((tmp_path / "port" / "stage2_confusion.json").read_text())
    want = json.loads((tmp_path / "jax" / "stage2_confusion.json").read_text())
    assert np.count_nonzero(want["confusion_matrix"]) > 3
    assert got == want


def test_certify_serving_matches_jax(ws, calibration, tmp_path):
    """Every row, the int8 rows included; those hold the int8 bounds of the
    module docstring."""
    argv = _tool_argv(ws) + [
        "--stage1-threshold", str(STAGE1_THRESHOLD), "--calib-samples", str(INT8_CALIB),
        "--unified-checkpoint", str(ws["ckpts"]["unified"])]
    jax_certify.main(argv + ["--calibration-dir", str(calibration["jax"]),
                             "--output-dir", str(tmp_path / "jax"), "--single-device"])
    port_certify.main(argv + ["--calibration-dir", str(calibration["port"]),
                              "--output-dir", str(tmp_path / "port"), "--device", "cpu"])
    got = json.loads((tmp_path / "port" / "serving_certification.json").read_text())
    want = json.loads((tmp_path / "jax" / "serving_certification.json").read_text())
    got_rows, want_rows = got.pop("rows"), want.pop("rows")
    assert got == want
    assert [r["variant"] for r in got_rows] == [r["variant"] for r in want_rows]
    assert [r["variant"].split("(")[0] for r in got_rows] == [
        "flax", "folded", "int8", "gated", "unified", "unified", "unified"]
    for g, w in zip(got_rows, want_rows):
        assert sorted(g) == sorted(w)
        assert g["throughput_superblocks_per_sec"] > 0
        int8 = "int8" in g["variant"]
        for key in ("accuracy", "macro_f1", "agreement_vs_flax"):
            # int8: the labels of the two int8 graphs differ on up to 10% of
            # the rows, which moves each figure by at most that share
            assert abs(g[key] - w[key]) < (1 - INT8_LABEL_SHARE if int8 else 1e-3), (
                g["variant"], key)
        assert g.get("agreement_reference") == w.get("agreement_reference")
    rows = {r["variant"]: r for r in got_rows}
    assert rows["folded"]["agreement_vs_flax"] > 0.99
    assert rows["unified(folded)"]["agreement_vs_flax"] > 0.99
    # int8 against its float graph: well above chance, below the folded rows
    assert 0.5 < rows["int8"]["agreement_vs_flax"] < 1.0
    assert 0.5 < rows["unified(int8)"]["agreement_vs_flax"] < 1.0
    md = (tmp_path / "port" / "serving_certification.md").read_text()
    assert md.splitlines()[0] == (tmp_path / "jax" / "serving_certification.md"
                                  ).read_text().splitlines()[0]


REFUSALS = {  # case -> extra arguments (after the v6 checkpoints)
    "align_without_tta": ["--tta-align-ab"],
    "unified_align_without_tta": ["--variant", "unified", "--tta-align-ab"],
    "folded_tta": ["--folded", "--tta"],
    "folded_ensemble": ["--folded", "--stage3-ab-ensemble-dir", "ENSEMBLE"],
    "capacity_tta": ["--capacity", "0.5", "--tta"],
    "capacity_ensemble": ["--capacity", "0.5", "--stage3-ab-ensemble-dir", "ENSEMBLE"],
    "unified_capacity": ["--variant", "unified", "--capacity", "0.5"],
    "capacity_above_1": ["--capacity", "1.5"],
    "capacity_not_a_number": ["--capacity", "half"],
    "auto_without_calibration": ["--capacity", "auto"],
    "unified_folded_tta": ["--variant", "unified", "--folded", "--tta"],
    "int8_folded": ["--int8", "--folded"],
    "int8_tta": ["--int8", "--tta"],
    "int8_ensemble": ["--int8", "--stage3-ab-ensemble-dir", "ENSEMBLE"],
    "int8_capacity": ["--int8", "--capacity", "0.5"],
    "unified_int8_folded": ["--variant", "unified", "--int8", "--folded"],
    **{f"{variant}_{flag[0][2:]}": ["--variant", variant, *flag]
       for variant in ("v5", "flatten")
       for flag in (["--int8"], ["--folded"], ["--capacity", "0.5"])},
}


def _refusal(main, argv, capsys) -> str:
    with pytest.raises(SystemExit) as exc:
        main(argv)
    if isinstance(exc.value.code, str):
        return exc.value.code
    return capsys.readouterr().err.strip().splitlines()[-1].split("error: ", 1)[1]


@pytest.mark.parametrize("case", list(REFUSALS))
def test_refusals_match_jax_cli(ws, tmp_path, capsys, case):
    extra = [str(ws["ensemble"]) if a == "ENSEMBLE" else a for a in REFUSALS[case]]
    argv = cli_argv(ws["dataset"], ws["ckpts"], tmp_path, False, extra)
    if "unified" in extra:
        argv += ["--unified-checkpoint", str(ws["ckpts"]["unified"])]
    want = _refusal(jax_cli.main, argv + ["--single-device"], capsys)
    got = _refusal(port_cli.main, argv + ["--device", "cpu"], capsys)
    assert got == want


def test_port_refusals_name_their_reason(ws, tmp_path, capsys):
    """The gated pipeline has no fused front, and the int8 graph no group-1
    hook (K2); a fused front needs the folded or the int8 graph."""
    argv = cli_argv(ws["dataset"], ws["ckpts"], tmp_path, False,
                    ["--folded", "--capacity", "0.5", "--fused-front", "on", "--device", "cpu"])
    assert "no fused front" in _refusal(port_cli.main, argv, capsys)
    argv = cli_argv(ws["dataset"], ws["ckpts"], tmp_path, False,
                    ["--int8", "--fused-front", "g1", "--device", "cpu"])
    assert "no group-1 hook" in _refusal(port_cli.main, argv, capsys)
    argv = cli_argv(ws["dataset"], ws["ckpts"], tmp_path, False,
                    ["--fused-front", "on", "--device", "cpu"])
    assert "--fused-front needs --folded or --int8" in _refusal(port_cli.main, argv, capsys)
