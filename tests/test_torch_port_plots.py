"""The port's plots, reports and profiling (ROADMAP M12) beside the JAX
package, on the CPU; no JAX compile.

One matplotlib draws both packages' figures here, so every PNG must equal
the JAX package's byte for byte, or else in its decoded pixels. The cases
are those of ``tests/test_plots_and_extras.py``: the four figures of
``eval.plots``, ``visualize_blocks``, the HTML report's figures and its text
(equal once the embedded images are masked), ``analysis_report`` over every
input kind, and the profiling utilities. ``write_history`` writes the JAX
CLIs' files, the curves PNG included (``run_pipeline_eval``'s confusion PNG
is held in ``test_torch_port_cli.py``); where matplotlib does not import,
the CLIs print one line and write the rest.
"""
import base64
import io
import json
import os
import re
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from av1tpu.cli import analysis_report as jax_analysis_report
from av1tpu.cli import common as jax_common
from av1tpu.cli import visualize_blocks as jax_visualize_blocks
from av1tpu.eval import html_report as jreport
from av1tpu.eval import plots as jplots
from av1tpu_torch.cli import analysis_report, common, visualize_blocks
from av1tpu_torch.data import BlockSet, build_v6_bundle, save_split
from av1tpu_torch.eval import html_report, plots
from av1tpu_torch.utils import profiling
from chip_smoke import differing_files

REPO = Path(__file__).resolve().parents[1]
IMAGE = re.compile(r"data:image/png;base64,([A-Za-z0-9+/=]+)")


def _pixels(png: bytes) -> np.ndarray:
    import matplotlib.image

    return matplotlib.image.imread(io.BytesIO(png), format="png")


def assert_same_png(got: bytes, want: bytes):
    assert got[:8] == b"\x89PNG\r\n\x1a\n" and len(got) > 1000
    if got != want:
        np.testing.assert_array_equal(_pixels(got), _pixels(want))


def _history(n=3, val_loss=True):
    return [{"epoch": i, "train_loss": 1.0 / (i + 1),
             **({"val_loss": 1.1 / (i + 1)} if val_loss else {}),
             "train_metrics": {"accuracy": 0.5 + 0.1 * i, "macro_f1": 0.4 + 0.1 * i},
             "val_metrics": {"accuracy": 0.5 + 0.08 * i, "macro_f1": 0.4 + 0.08 * i},
             "throughput": 1000 + i} for i in range(n)]


def _draw(name, tmp_path):
    """``(port call, JAX call)`` of one ``eval.plots`` case, each writing
    ``<dir>/<name>.png``."""
    rng = np.random.default_rng(0)
    if name.startswith("confusion"):
        conf = rng.integers(0, 40, (8, 8))
        names = ["NONE", "SPLIT", "HORZ", "VERT", "HORZ_A", "HORZ_B", "VERT_A", "VERT_B"]
        kwargs = {"normalize": name == "confusion", "title": "v6 pipeline (val)"}
        return lambda mod, path: mod.plot_confusion_matrix(conf, names, path, **kwargs)
    if name == "pr_curve":
        y = rng.integers(0, 2, 100)
        p = np.clip(y * 0.5 + rng.uniform(size=100) * 0.5, 0, 1)
        return lambda mod, path: mod.plot_precision_recall_curve(y, p, path)
    if name == "training_curves":
        return lambda mod, path: mod.plot_training_curves(_history(), path)
    samples = rng.integers(0, 1024, (20, 16, 16, 1), dtype=np.uint16)
    labels = np.array([0, 1, 3] * 6 + [0, 1])
    return lambda mod, path: mod.plot_block_grid(
        samples, labels, {0: "NONE", 1: "HORZ", 3: "SPLIT"}, path, per_class=4)


@pytest.mark.parametrize("name", ["confusion", "confusion_counts", "pr_curve",
                                  "training_curves", "block_grid"])
def test_plots_match_jax(tmp_path, name):
    draw = _draw(name, tmp_path)
    got = draw(plots, tmp_path / "port" / f"{name}.png")
    want = draw(jplots, tmp_path / "jax" / f"{name}.png")
    assert got == tmp_path / "port" / f"{name}.png"
    assert_same_png(got.read_bytes(), want.read_bytes())


def test_visualize_blocks_cli_matches_jax(tmp_path, capsys):
    rng = np.random.default_rng(3)
    labels = np.tile([0, 1, 3], 10).astype(np.int32)
    rec = BlockSet(samples=rng.integers(0, 1024, (30, 16, 16, 1), dtype=np.uint16),
                   labels=labels, qps=np.full(30, 80, np.int32))
    save_split(tmp_path / "ds", 16, build_v6_bundle(rec), build_v6_bundle(rec), "v6")
    printed = {}
    for name, cli in (("port", visualize_blocks), ("jax", jax_visualize_blocks)):
        cli.main(["--dataset-dir", str(tmp_path / "ds"), "--block-size", "16",
                  "--out", str(tmp_path / f"{name}.png"), "--per-class", "5"])
        printed[name] = json.loads(capsys.readouterr().out)
    assert_same_png((tmp_path / "port.png").read_bytes(), (tmp_path / "jax.png").read_bytes())
    assert printed["port"]["class_distribution"] == printed["jax"]["class_distribution"]


def test_write_history_writes_the_jax_clis_files(tmp_path):
    result = types.SimpleNamespace(history=_history(4), best_value=0.64)
    result.save_history = lambda path: Path(path).write_text(json.dumps(result.history,
                                                                        indent=2))
    common.write_history(result, tmp_path / "port", "stage1")
    jax_common.write_history(result, tmp_path / "jax", "stage1")
    assert sorted(p.name for p in (tmp_path / "port").iterdir()) == [
        "stage1_history.json", "stage1_summary.json", "stage1_training_curves.png"]
    png = "stage1_training_curves.png"
    assert_same_png((tmp_path / "port" / png).read_bytes(),
                    (tmp_path / "jax" / png).read_bytes())
    assert [f for f in differing_files(tmp_path / "port", tmp_path / "jax") if f != png] == []


def test_without_matplotlib_the_clis_skip_the_png(tmp_path):
    """In a process where matplotlib does not import (the card's machine has
    none): ``write_history`` and ``save_plot`` print one line each and write
    the other files."""
    code = (
        "import sys, json, types\n"
        "sys.modules['matplotlib'] = None\n"
        "from pathlib import Path\n"
        "from av1tpu_torch.cli import common\n"
        "from av1tpu_torch.eval.plots import plot_confusion_matrix\n"
        f"out = Path({str(tmp_path)!r})\n"
        "r = types.SimpleNamespace(history=[{'epoch': 0, 'val_metrics': {}}], best_value=0.5,\n"
        "    save_history=lambda p: Path(p).write_text('[]'))\n"
        "common.write_history(r, out, 'stage1')\n"
        "common.save_plot(lambda p: plot_confusion_matrix([[1]], ['A'], p),\n"
        "                 out / 'pipeline_confusion_val.png')\n"
    )
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.splitlines() == [
        "stage1_training_curves.png not written: matplotlib is not installed",
        "pipeline_confusion_val.png not written: matplotlib is not installed"]
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "stage1_history.json", "stage1_summary.json"]


# ---------------------------------------------------------------------------
# eval.html_report and analysis_report
# ---------------------------------------------------------------------------

TREE_ACC = {
    "per_level": [{"block_size": s, "nodes_reached": 100, "node_accuracy": a}
                  for s, a in ((64, 0.85), (32, 0.76), (16, 0.79), (8, 0.995))],
    "node_accuracy": 0.78, "exact_tree_match": 0.43, "structure_accuracy": 0.83,
    "trees": 2400,
}


def _eval_dir(root: Path, seed: int) -> Path:
    """A ``run_pipeline_eval`` output directory: metrics JSON with the
    cascade decomposition, and a confusion PNG."""
    rng = np.random.default_rng(seed)
    names = ["NONE", "SPLIT", "HORZ", "VERT"]
    frac = rng.dirichlet(np.ones(6))
    payload = {
        "split": "val", "samples": 1024, "throughput_superblocks_per_sec": 123456.7,
        "metrics": {"accuracy": 0.71, "macro_f1": 0.62, "weighted_f1": 0.69,
                    "per_class": {n: {"precision": rng.uniform(), "recall": rng.uniform(),
                                      "f1": rng.uniform(), "support": int(s)}
                                  for n, s in zip(names, rng.integers(1, 500, 4))}},
        "stage1": {"f1": 0.88},
        "cascade": {"error_attribution_fractions": dict(zip(
            ["correct", "stage1_false_negative", "stage1_false_positive",
             "stage2_misroute", "stage3_refinement", "other"], frac.tolist())),
            "conditional": {"stage2_accuracy_given_stage1_correct": 0.8,
                            "stage3_accuracy_given_routed": 0.7}},
    }
    root.mkdir(parents=True)
    (root / "pipeline_metrics_val.json").write_text(json.dumps(payload))
    jplots.plot_confusion_matrix(rng.integers(0, 50, (4, 4)), names,
                                 root / "pipeline_confusion_val.png")
    return root


def _sweep_dir(root: Path) -> Path:
    root.mkdir(parents=True)
    thr = np.linspace(0.05, 0.95, 19)
    rows = ["threshold,f1,precision,recall,f1_calibrated,note"] + [
        f"{t:.2f},{0.9 - (t - 0.45) ** 2:.4f},{0.5 + t / 2:.4f},{1 - t:.4f},"
        f"{0.89 - (t - 0.4) ** 2:.4f},hand" for t in thr]
    (root / "threshold_sweep.csv").write_text("\n".join(rows) + "\n")
    (root / "threshold_summary.json").write_text(json.dumps(
        {"calibration": {"temperature": 1.37, "ece_raw": 0.081, "ece_calibrated": 0.012}}))
    return root


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_port_plots")
    hist = root / "stage1_history.json"
    hist.write_text(json.dumps(_history(5)))
    fgvc = root / "stage3_ab_fgvc_history.json"
    fgvc.write_text(json.dumps(_history(3, val_loss=False)))
    (root / "acc.json").write_text(json.dumps(TREE_ACC))
    (root / "results.json").write_text(json.dumps({"config": {}, "tree_accuracy": TREE_ACC}))
    return {"root": root, "runs": [_eval_dir(root / "pipeline", 1),
                                   _eval_dir(root / "frozen", 2)],
            "sweep": _sweep_dir(root / "calib"), "history": hist, "fgvc": fgvc}


def _masked(text: str):
    """The HTML with every embedded PNG replaced by its index, and the PNGs."""
    images = [base64.b64decode(m) for m in IMAGE.findall(text)]
    return IMAGE.sub("data:image/png;base64,<image>", text), images


def assert_same_html(got: str, want: str, n_images: int):
    got_text, got_images = _masked(got)
    want_text, want_images = _masked(want)
    assert got_text == want_text
    assert len(got_images) == len(want_images) == n_images
    for a, b in zip(got_images, want_images):
        assert_same_png(a, b)


@pytest.mark.parametrize("name", ["threshold_sweep", "cascade", "tree_accuracy", "history",
                                  "history_fgvc"])
def test_report_figures_match_jax(inputs, name):
    if name == "threshold_sweep":
        args = (html_report.load_sweep(inputs["sweep"])[0],)
        assert args[0] == jreport.load_sweep(inputs["sweep"])[0]
    elif name == "cascade":
        args = (json.loads((inputs["runs"][0] / "pipeline_metrics_val.json").read_text())
                ["cascade"],)
    elif name == "tree_accuracy":
        args = (TREE_ACC,)
    else:
        path = inputs["fgvc" if name == "history_fgvc" else "history"]
        args = (json.loads(path.read_text()), "macro_f1")
    fn = "plot_history" if name.startswith("history") else f"plot_{name}"
    got, want = getattr(html_report, fn)(*args), getattr(jreport, fn)(*args)
    assert_same_png(base64.b64decode(got), base64.b64decode(want))


def test_build_report_matches_jax(inputs):
    runs = [html_report.load_eval_run(d, "val") for d in inputs["runs"]]
    jruns = [jreport.load_eval_run(d, "val") for d in inputs["runs"]]
    assert runs == jruns
    rows, summary = html_report.load_sweep(inputs["sweep"] / "threshold_sweep.csv")
    histories = {"stage1": json.loads(inputs["history"].read_text()),
                 "fgvc": json.loads(inputs["fgvc"].read_text())}
    kwargs = dict(history_metric="accuracy", title="a <report>", tree_runs={"t": TREE_ACC})
    got = html_report.build_report(runs, rows, summary, histories, **kwargs)
    want = jreport.build_report(jruns, rows, summary, histories, **kwargs)
    # 2 confusion PNGs + 2 cascades, the sweep, the tree levels, 2 histories
    assert_same_html(got, want, 8)
    for module in (html_report, jreport):
        with pytest.raises(ValueError, match="no data rows"):
            module.plot_threshold_sweep([])
    empty = html_report.build_report([], title="t")
    assert empty == jreport.build_report([], title="t") and "<h2>" not in empty


@pytest.mark.parametrize("case", ["everything", "tree_accuracy_only"])
def test_analysis_report_cli_matches_jax(inputs, tmp_path, case, capsys):
    if case == "everything":
        argv = ["--eval-dir", str(inputs["runs"][0]),
                "--eval-dir", f"frozen={inputs['runs'][1]}",
                "--threshold-sweep", str(inputs["sweep"]),
                "--history", f"stage1={inputs['history']}", "--history", str(inputs["fgvc"]),
                "--tree-accuracy", str(inputs["root"] / "acc.json"), "--title", "runs"]
        n_images = 8
    else:
        argv = ["--tree-accuracy", f"bare={inputs['root'] / 'acc.json'}",
                "--tree-accuracy", f"nested={inputs['root'] / 'results.json'}"]
        n_images = 2
    texts = {}
    for name, cli in (("port", analysis_report), ("jax", jax_analysis_report)):
        cli.main([*argv, "--output", str(tmp_path / name / "report.html")])
        texts[name] = (tmp_path / name / "report.html").read_text()
        assert capsys.readouterr().out.startswith(f"report: {tmp_path / name / 'report.html'}")
    assert_same_html(texts["port"], texts["jax"], n_images)
    if case == "tree_accuracy_only":
        assert "Partition trees: bare" in texts["port"]
        assert "Partition trees: nested" in texts["port"]
    for cli in (analysis_report, jax_analysis_report):
        with pytest.raises(SystemExit):
            cli.main(["--output", str(tmp_path / "none.html")])


# ---------------------------------------------------------------------------
# utils.profiling
# ---------------------------------------------------------------------------


def test_trace_annotate_and_memory_stats(tmp_path):
    """A named region inside ``trace``: a span, read with ``spans()`` after
    the trace, around the op the trace records."""
    with profiling.trace(tmp_path / "traces", "test") as prof:
        with profiling.span("inner"):
            torch.ones(8, 8) @ torch.ones(8, 8)
    trace = json.loads((tmp_path / "traces" / "test.pt.trace.json").read_text())
    names = {e.get("name") for e in trace["traceEvents"]}
    assert {"test", "aten::mm"} <= names
    assert any(e.key == "aten::mm" for e in prof.key_averages())
    (inner,) = [s for s in profiling.spans() if s["name"] == "inner"]
    (mm,) = [e for e in prof.profiler.kineto_results.events() if e.name() == "aten::mm"]
    start = mm.start_ns()
    assert inner["start_ns"] <= start <= start + mm.duration_ns() <= inner["end_ns"]
    if not torch.cuda.is_available():
        assert profiling.device_memory_stats() == {}
