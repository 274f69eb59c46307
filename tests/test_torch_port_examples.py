"""The port's examples (``av1tpu_torch/examples/``) against the JAX package's
``examples/`` scripts on the CPU.

* Helpers, bit for bit: the packed clip, demo_e2e's synthetic dataset,
  bench_ingest_to_trees' synthetic video, int8_selfcalib_ab's ``agreement``
  and model directory, unified_demo's host threshold sweep.
* Orchestration: every CLI ``main`` of both packages is replaced by a stub
  that records ``(cli, argv)`` and writes the files the scripts read back;
  both packages' scripts then run with the same tiny arguments and must call
  the same CLIs with the same arguments, but for the port's ``--device`` and
  ``--fused-front``. Each argv the port records is parsed by that port CLI's
  own parser, so a flag the port lacks fails here.

The slice against the JAX package is ``test_torch_port_examples_slice.py``;
each example run alone on the CPU, ``test_torch_port_examples_run.py``.
"""
import argparse
import functools
import importlib
import importlib.util
import json
import sys
from pathlib import Path

import numpy as np
import pytest

from av1tpu_torch.data.synth_tree import tree_corpus
from av1tpu_torch.examples import _common
from av1tpu_torch.examples import bench_ingest_to_trees as port_bench
from av1tpu_torch.examples import demo_e2e as port_demo
from av1tpu_torch.examples import int8_selfcalib_ab as port_ab
from av1tpu_torch.examples import scale_demo as port_scale
from av1tpu_torch.examples import scale_demo_extras as port_extras
from av1tpu_torch.examples import scale_demo_v5 as port_v5
from av1tpu_torch.examples import tree_demo as port_tree
from av1tpu_torch.examples import tta_eval as port_tta
from av1tpu_torch.examples import unified_demo as port_unified
from av1tpu_torch.train.checkpoint import load_variables_npz, save_variables_npz

REPO = Path(__file__).resolve().parents[1]
CLIS = ("prepare_stage3", "train_stage1", "train_stage2", "train_stage3",
        "train_stage2_flat", "train_unified", "optimize_thresholds", "run_pipeline_eval",
        "certify_serving", "analyze_confusion", "compare_thresholds", "predict_trees")
# the port CLIs' own mains, kept before any test stubs them
PORT_MAINS = {name: importlib.import_module(f"av1tpu_torch.cli.{name}").main for name in CLIS}


@functools.lru_cache(maxsize=None)
def jax_example(name: str):
    """The JAX package's ``examples/<name>.py``, loaded as a module."""
    spec = importlib.util.spec_from_file_location(f"jax_examples_{name}",
                                                  REPO / "examples" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


# ---------------------------------------------------------------------------
# Helpers, bit for bit
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("script", ["tree_demo", "int8_selfcalib_ab"])
def test_pack_yuv_equals_each_jax_copy(tmp_path, script):
    sbs, _, _ = tree_corpus(_common.SB_PER_FRAME, seed=5)
    want, got = tmp_path / "jax.yuv", tmp_path / "port.yuv"
    assert jax_example(script).pack_yuv(sbs, want) == _common.pack_yuv(sbs, got) == 1
    assert want.read_bytes() == got.read_bytes()
    assert got.stat().st_size == _common.FRAME_W * _common.FRAME_H * 3
    for name in ("FRAME_COLS", "FRAME_ROWS", "FRAME_W", "FRAME_H", "SB_PER_FRAME"):
        assert getattr(_common, name) == getattr(jax_example(script), name)


@pytest.mark.parametrize("per_class, seed", [(800, 0), (37, 3)])
def test_demo_dataset_equals_the_jax_script(per_class, seed):
    want = jax_example("demo_e2e").make_dataset(per_class, seed)
    got = port_demo.make_dataset(per_class, seed)
    for key in ("samples", "labels", "qps"):
        assert getattr(got, key).dtype == getattr(want, key).dtype
        np.testing.assert_array_equal(getattr(got, key), getattr(want, key))
    assert len(np.unique(got.labels)) == 8


@pytest.mark.parametrize("width, height, frames", [(128, 64, 2), (65, 33, 3)])
def test_synth_video_equals_the_jax_script(tmp_path, width, height, frames):
    jax_example("bench_ingest_to_trees").write_synth_video(tmp_path / "jax.yuv", width,
                                                           height, frames)
    port_bench.write_synth_video(tmp_path / "port.yuv", width, height, frames)
    assert (tmp_path / "jax.yuv").read_bytes() == (tmp_path / "port.yuv").read_bytes()


def test_agreement_equals_the_jax_script():
    rng = np.random.default_rng(8)
    a = rng.integers(-1, 8, size=(3, 40, 85)).astype(np.int32)
    b = a.copy()
    b[rng.random(a.shape) < 0.02] = 5
    b[0, :10] = a[0, :10]
    for x, y in ((a, b), (a, a), (b, a)):
        assert port_ab.agreement(x, y) == jax_example("int8_selfcalib_ab").agreement(x, y)


def test_models_dir_equals_the_jax_script(tmp_path):
    """Per-stage subdirectories and flat files: the same symlinks, first
    candidate winning (``unified_kd`` over ``unified``, a subdirectory over
    the flat file)."""
    src = tmp_path / "run"
    files = ["stage1/stage1_best_variables.npz", "stage2_best_variables.npz",
             "stage2/stage2_best_variables.npz", "stage3_rect/stage3_rect_best_variables.npz",
             "stage3_ab/stage3_ab_fgvc_best_variables.npz",
             "unified/unified_best_variables.npz", "unified_kd/unified_best_variables.npz"]
    for rel in files:
        (src / rel).parent.mkdir(parents=True, exist_ok=True)
        (src / rel).write_text(rel)
    jax_example("int8_selfcalib_ab").assemble_models_dir(src, tmp_path / "jax")
    port_ab.assemble_models_dir(src, tmp_path / "port")
    links = {side: {p.name: p.resolve() for p in (tmp_path / side).iterdir()}
             for side in ("jax", "port")}
    assert links["port"] == links["jax"]
    assert links["port"]["unified_best_variables.npz"].parent.name == "unified_kd"
    assert links["port"]["stage2_best_variables.npz"].parent.name == "stage2"


def test_host_sweep_equals_the_jax_script():
    rng = np.random.default_rng(4)
    n = 500
    out = {"stage1_prob": rng.random(n).astype(np.float32),
           "stage2_pred": rng.integers(0, 3, n).astype(np.int32),
           "stage3_rect_pred": rng.integers(0, 2, n).astype(np.int32),
           "stage3_ab_pred": rng.integers(0, 4, n).astype(np.int32)}
    raw = rng.integers(0, 10, n).astype(np.int32)
    got = port_unified.sweep_final_metrics(out, raw)
    want = jax_example("unified_demo").sweep_final_metrics(out, raw)
    assert got == want
    assert port_unified.THRESHOLD_GRID == jax_example("unified_demo").THRESHOLD_GRID
    assert len({row["macro_f1"] for row in got[1]}) > 1


# ---------------------------------------------------------------------------
# Orchestration: stubbed CLIs, the same calls in both packages
# ---------------------------------------------------------------------------


def opt(argv, flag, default=None):
    return argv[argv.index(flag) + 1] if flag in argv else default


def history_names(name: str, argv: list) -> list:
    """The ``<name>_history.json`` stems a trainer CLI writes."""
    v5 = opt(argv, "--variant") == "v5"
    if name in ("train_stage1", "train_stage2"):
        return [("v5_" if v5 else "") + name.replace("train_", "")]
    if name == "train_stage2_flat":
        return ["stage2_flat"]
    if name == "train_unified":
        return ["unified"]
    head = opt(argv, "--head")
    if v5:
        return [f"v5_stage3_{head}"]
    if head == "RECT":
        return ["stage3_rect"]
    if "--fgvc" in argv:
        return ["stage3_ab_fgvc"]
    members = int(opt(argv, "--ensemble", 0))
    return [f"stage3_ab_member{i}" for i in range(1, members + 1)] or ["stage3_ab"]


def fake_outputs(name: str, argv: list) -> None:
    """Write what the example scripts read back from the CLI ``name``."""
    if name == "prepare_stage3":
        out, size = Path(opt(argv, "--out")), opt(argv, "--block-size")
        for head in ("RECT", "AB"):
            (out / head / f"block_{size}").mkdir(parents=True, exist_ok=True)
            (out / head / f"block_{size}" / "metadata.json").write_text("{}")
        return
    out = Path(opt(argv, "--output-dir"))
    out.mkdir(parents=True, exist_ok=True)
    if name.startswith("train_"):
        for stem in history_names(name, argv):
            (out / f"{stem}_history.json").write_text(json.dumps(
                [{"val_metrics": {"macro_f1": 0.5 + 0.01 * len(stem), "accuracy": 0.7},
                  "throughput": 100.0 + len(stem)}]))
            head = {f"specialist_{h}": {"kernel": np.full(2, len(stem) + i, np.float32)}
                    for i, h in enumerate(("RECT", "AB"))}
            save_variables_npz(out / f"{stem}_best_variables.npz", {
                "params": {"backbone": {"kernel": np.ones(3, np.float32)}, **head},
                "batch_stats": {"bn": {"mean": np.zeros(2, np.float32)}}})
    elif name == "optimize_thresholds":
        (out / "threshold_summary.json").write_text(json.dumps({
            "f1": {"threshold": 0.4, "f1": 0.71234},
            "calibration": {"temperature": 1.23456, "ece_raw": 0.1, "ece_calibrated": 0.05}}))
    elif name == "run_pipeline_eval":
        (out / "pipeline_metrics_val.json").write_text(json.dumps({
            "metrics": {"accuracy": 0.61, "macro_f1": 0.52}, "stage1": {"f1": 0.8},
            "throughput_superblocks_per_sec": 1234.5, "cascade": {"correct": 0.6}}))
    elif name == "certify_serving":
        (out / "serving_certification.json").write_text(json.dumps({"rows": [
            {"variant": v, "accuracy": 0.6, "macro_f1": 0.5, "agreement_vs_flax": 0.99}
            for v in ("flax", "folded", "int8")]}))
    elif name == "predict_trees":
        frames, i = [], argv.index("--frames") + 1
        while i < len(argv) and not argv[i].startswith("--"):
            frames.append(int(argv[i]))
            i += 1
        trees = np.full((_common.SB_PER_FRAME, 85), -1, np.int32)
        trees[:, 0] = np.arange(_common.SB_PER_FRAME) % 8
        for f in frames:
            np.savez(out / f"trees_frame{f}.npz", trees=trees)
        (out / "tree_stats.json").write_text(json.dumps(
            {str(f): {"seconds": 0.5 + f} for f in frames}))


def stub_clis(monkeypatch, package: str, calls: list) -> None:
    """Replace every CLI ``main`` of ``package`` by a recording stub."""
    for name in CLIS:
        module = importlib.import_module(f"{package}.cli.{name}")

        def stub(argv=None, _name=name):
            calls.append((_name, list(argv)))
            fake_outputs(_name, list(argv))

        monkeypatch.setattr(module, "main", stub)


class Parsed(Exception):
    pass


def parse_only(name: str, argv: list) -> argparse.Namespace:
    """``argv`` through the port CLI's own parser, nothing run after it."""
    original = argparse.ArgumentParser.parse_args

    def parse(self, args=None, namespace=None):
        raise Parsed(original(self, args, namespace))

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(argparse.ArgumentParser, "parse_args", parse)
        with pytest.raises(Parsed) as parsed:
            PORT_MAINS[name](argv)
    return parsed.value.args[0]


def normalized(calls: list, root: Path, renames=()) -> list:
    """``(cli, argv)`` with ``root`` replaced, the port's ``--device`` and
    ``--fused-front`` pairs taken out and each ``(old, new)`` of ``renames``
    applied to every argument."""
    out = []
    for name, argv in calls:
        kept, skip = [], False
        for token in argv:
            if skip:
                skip = False
                continue
            if token in ("--device", "--fused-front"):
                skip = True
                continue
            token = token.replace(str(root), "<root>")
            for old, new in renames:
                token = token.replace(old, new)
            kept.append(token)
        out.append((name, kept))
    return out


def scrubbed(tree, root: Path):
    """Results JSON without wall clocks (``*seconds*``, ``*_wall`` and
    int8_selfcalib_ab's ``wall_s``) and with ``root`` replaced."""
    if isinstance(tree, dict):
        return {k: scrubbed(v, root) for k, v in tree.items()
                if "seconds" not in k and not k.endswith("_wall")
                and k not in ("wall_s", "device", "fused_front")}
    if isinstance(tree, list):
        return [scrubbed(v, root) for v in tree]
    if isinstance(tree, str):
        return tree.replace(str(root), "<root>")
    return tree


def run_jax_script(monkeypatch, name: str, args: list) -> None:
    """A JAX example's ``main``: those that read ``sys.argv`` get ``args``
    there."""
    module = jax_example(name)
    if "argv" in module.main.__code__.co_varnames[:module.main.__code__.co_argcount]:
        module.main(args)
        return
    with monkeypatch.context() as mp:
        mp.setattr(sys, "argv", [name, *args])
        module.main()


@pytest.fixture
def both(tmp_path, monkeypatch):
    """``run(script, args, port_args, renames)``: the JAX script and the
    port's module, each with its CLIs stubbed and ``{root}`` in ``args`` set
    to its own directory, the port's with ``port_args`` appended; returns ``{"jax": ..., "port": ...}`` of
    ``(root, normalized calls)`` and ``"raw"``, the port's calls as made.
    Each port call is parsed by its CLI."""
    ports = {"tree_demo": port_tree, "tta_eval": port_tta, "int8_selfcalib_ab": port_ab,
             "unified_demo": port_unified, "scale_demo": port_scale,
             "scale_demo_extras": port_extras, "scale_demo_v5": port_v5}
    calls = {"jax": [], "port": []}
    stub_clis(monkeypatch, "av1tpu", calls["jax"])
    stub_clis(monkeypatch, "av1tpu_torch", calls["port"])

    def run(script, args, port_args=("--device", "cpu"), renames=()):
        result = {}
        for side in ("jax", "port"):
            root = tmp_path / side
            root.mkdir(exist_ok=True)
            argv = [a.replace("{root}", str(root)) for a in args]
            del calls[side][:]
            if side == "jax":
                run_jax_script(monkeypatch, script, argv)
            else:
                ports[script].main(argv + list(port_args))
                for name, call_argv in calls["port"]:
                    parsed = parse_only(name, call_argv)
                    if name not in ("prepare_stage3",):
                        assert parsed.device == "cpu", (name, call_argv)
            result[side] = (root, normalized(calls[side], root,
                                              renames if side == "port" else ()))
        result["raw"] = list(calls["port"])
        assert result["port"][1] == result["jax"][1]
        assert result["port"][1], "no CLI was called"
        return result

    return run


def results_equal(result, rel: str) -> dict:
    """The results JSON ``rel`` of both sides, scrubbed and equal."""
    docs = {side: scrubbed(json.loads((result[side][0] / rel).read_text()),
                           result[side][0])
            for side in ("jax", "port")}
    assert docs["port"] == docs["jax"]
    return docs["port"]


TREE_ARGS = ["--out", "{root}/tree", "--train-superblocks", "48",
             "--val-superblocks", "240", "--calibrate", "--folded",
             "--stage1-epochs", "1", "--stage2-epochs", "2", "--stage3-epochs", "1"]


@pytest.mark.parametrize("fused_front", ["off", "g1"])
def test_tree_demo_and_tta_eval_call_the_clis_as_the_jax_scripts(both, fused_front):
    """tree_demo (every size, calibrated, folded, the unified family with
    ``--unified-kd``, three variants), then tta_eval over its directory; the
    port passes ``--fused-front`` to the folded variants alone."""
    args = TREE_ARGS + ["--unified-kd", "--unified-epochs", "1",
                        "--variants", "ladder", "unified", "ladder_tta"]
    # the fused variants' trees go to trees_<variant>_<front>
    renames = [] if fused_front == "off" else [
        (f"trees_ladder_{fused_front}", "trees"), (f"_unified_{fused_front}", "_unified")]
    result = both("tree_demo", args, port_args=("--device", "cpu", "--fused-front",
                                                fused_front), renames=renames)
    names = [name for name, _ in result["port"][1]]
    assert names.count("train_stage1") == 4 and names.count("predict_trees") == 3
    assert names.count("optimize_thresholds") == 8
    predicts = [argv for name, argv in result["raw"] if name == "predict_trees"]
    want_front = [None if fused_front == "off" else fused_front] * 2 + [None]
    assert [opt(argv, "--fused-front") for argv in predicts] == want_front
    assert ["--folded" in argv for argv in predicts] == [True, True, False]
    port_doc = json.loads((result["port"][0] / "tree" / "RESULTS.json").read_text())
    suffix = "" if fused_front == "off" else f"_{fused_front}"
    assert sorted(port_doc["tree_accuracy_variants"]) == sorted(
        [f"ladder{suffix}", f"unified{suffix}", "ladder_tta"])
    if fused_front == "off":
        doc = results_equal(result, "tree/RESULTS.json")
        assert doc["sizes"]["8"]["calibrated_threshold"] == 0.4
        assert doc["corpus"]["val_superblocks"] == 240

    result = both("tta_eval", ["--xl-dir", "{root}/tree", "--output", "{root}/tta.json"])
    assert [argv[argv.index("--stage1-threshold") + 5:] for _, argv in result["port"][1]] == [
        ["--bf16"], ["--bf16", "--tta", "--no-tta-align-ab"],
        ["--bf16", "--tta", "--tta-align-ab"]]
    docs = {side: json.loads((result[side][0] / "tta.json").read_text())
            for side in ("jax", "port")}
    assert docs["port"]["configs"].keys() == docs["jax"]["configs"].keys()
    for config, acc in docs["jax"]["configs"].items():
        assert scrubbed(docs["port"]["configs"][config], REPO) == scrubbed(acc, REPO)


def test_tree_demo_resume_skips_completed_steps(tmp_path, monkeypatch):
    """The port's tree_demo ``--resume`` (tests/test_tree.py's case for the
    JAX script): steps whose sentinels exist are skipped, an interrupted
    stage reruns alone, a config mismatch refuses to resume; a second
    ``--fused-front`` adds its trees and keeps the first's scores."""
    calls = []
    stub_clis(monkeypatch, "av1tpu_torch", calls)
    out = tmp_path / "demo"
    argv = ["--out", str(out), "--train-superblocks", "48", "--val-superblocks", "240",
            "--calibrate", "--folded", "--device", "cpu"]

    port_tree.main(argv + ["--fused-front", "g1"])
    first = [name for name, _ in calls]
    assert first.count("predict_trees") == 1 and first.count("train_stage1") == 4
    results = json.loads((out / "RESULTS.json").read_text())
    assert "resumed" not in results

    calls.clear()
    port_tree.main(argv + ["--resume", "--fused-front", "g1"])
    assert calls == []  # every step sentinel present -> all skipped
    results = json.loads((out / "RESULTS.json").read_text())
    assert results["resumed"] is True
    assert "stage1_wall" in results["sizes"]["64"]  # carried forward
    assert results["sizes"]["32"]["calibrated_threshold"] == 0.4

    calls.clear()
    port_tree.main(argv + ["--resume", "--fused-front", "on"])
    assert [(name, opt(a, "--fused-front"), Path(opt(a, "--output-dir")).name)
            for name, a in calls] == [("predict_trees", "on", "trees_ladder_on")]
    results = json.loads((out / "RESULTS.json").read_text())
    assert sorted(results["tree_accuracy_variants"]) == ["ladder_g1", "ladder_on"]

    # interrupted stage: sentinel missing -> only that stage reruns
    (out / "size_32" / "models" / "stage2_history.json").unlink()
    calls.clear()
    port_tree.main(argv + ["--resume", "--fused-front", "g1"])
    assert [name for name, _ in calls] == ["train_stage2"]

    # config mismatch refuses to resume
    with pytest.raises(SystemExit):
        port_tree.main(argv + ["--resume", "--seed", "7"])
    # a fused front needs the folded graph
    with pytest.raises(SystemExit):
        port_tree.main(argv[:-3] + ["--device", "cpu", "--fused-front", "on"])


@pytest.mark.parametrize("fused_front", ["off", "on"])
def test_int8_selfcalib_ab_calls_the_cli_as_the_jax_script(both, tmp_path, fused_front):
    """Per-stage subdirectories with a distilled unified model: the four
    modes, each with ``--single-device`` and the report's agreement."""
    src = tmp_path / "run"
    for sub, stem in (("stage1", "stage1"), ("stage2", "stage2"),
                      ("stage3_rect", "stage3_rect"), ("stage3_ab", "stage3_ab_fgvc"),
                      ("unified_kd", "unified")):
        (src / sub).mkdir(parents=True)
        (src / sub / f"{stem}_best_variables.npz").write_bytes(b"npz")
    result = both("int8_selfcalib_ab", ["--models", str(src), "--out", "{root}/ab",
                                        "--frames", "2"],
                  port_args=("--device", "cpu", "--fused-front", fused_front))
    modes = [tuple(a for a in argv if a in ("--folded", "--int8", "--unified"))
             for _, argv in result["port"][1]]
    assert modes == [("--folded",), ("--int8",), ("--unified", "--folded"),
                     ("--unified", "--int8")]
    assert all(opt(argv, "--fused-front", "off") == fused_front
               for _, argv in result["raw"])
    doc = results_equal(result, "ab/int8_selfcalib_ab.json")
    assert doc["agreement"]["int8_vs_folded"]["node_agreement"] == 1.0
    assert doc["modes"]["folded"]["warm_sb_per_s"] == round(240 / 1.5, 1)


@pytest.fixture
def stubbed_unified_eval(monkeypatch):
    """unified_demo's evaluation, stubbed in both packages: the models are
    not loaded, and every pipeline gives the same seeded outputs, so both
    packages' host sweeps read the same numbers."""
    import av1tpu.cli.common
    import av1tpu.eval
    import av1tpu.eval.hierarchy

    def outputs(_predict, samples, *args, **kwargs):
        rng = np.random.default_rng(len(samples))
        n = len(samples)
        return {"stage1_prob": rng.random(n).astype(np.float32),
                "stage2_pred": rng.integers(0, 3, n).astype(np.int32),
                "stage3_rect_pred": rng.integers(0, 2, n).astype(np.int32),
                "stage3_ab_pred": rng.integers(0, 4, n).astype(np.int32)}

    pipeline = lambda *args, **kwargs: "predict"
    monkeypatch.setattr(av1tpu.cli.common, "load_model_variables", lambda path: {})
    for name in ("make_v6_pipeline", "make_unified_pipeline"):
        monkeypatch.setattr(av1tpu.eval, name, pipeline)
        monkeypatch.setattr(port_unified, name, pipeline)
    monkeypatch.setattr(av1tpu.eval.hierarchy, "run_pipeline_batched", outputs)
    monkeypatch.setattr(port_unified, "run_pipeline_batched", outputs)
    monkeypatch.setattr(port_unified, "load_model", lambda path, cls: cls.__name__)


@pytest.mark.parametrize("ladder", [False, True])
def test_unified_demo_calls_the_clis_as_the_jax_script(both, stubbed_unified_eval, tmp_path,
                                                       ladder):
    """The training part (``--skip-throughput``): the ladder trained, or
    reused with ``--ladder``; the host sweeps of both packages on the same
    stubbed outputs give the same RESULTS.json."""
    args = ["--out", "{root}/uni", "--scale", "0.001", "--epochs", "2",
            "--skip-throughput"]
    if ladder:
        reused = tmp_path / "ladder"
        port_unified.save_split(
            reused / "v6_dataset", 16,
            *(port_unified.build_v6_bundle(b)
              for b in port_unified.reference_shaped_corpus(1, scale=0.001)), "v6")
        args += ["--ladder", str(reused)]
    result = both("unified_demo", args)
    names = [name for name, _ in result["port"][1]]
    assert names[-2:] == ["train_unified", "train_unified"]
    assert len(names) == (2 if ladder else 7)
    doc = results_equal(result, "uni/RESULTS.json")
    assert set(doc["val"]) == {"cascade", "unified", "unified_kd"}


def test_scale_demos_call_the_clis_as_the_jax_scripts(both):
    """scale_demo, then scale_demo_extras on its directory, and
    scale_demo_v5: the same CLI calls, the same RESULTS.json / EXTRAS.json,
    the same merged v5 checkpoints."""
    result = both("scale_demo", ["--out", "{root}/scale", "--scale", "0.001",
                                 "--stage1-epochs", "1", "--stage2-epochs", "2",
                                 "--stage3-epochs", "1", "--flat-epochs", "2"])
    assert len(result["port"][1]) == 11
    doc = results_equal(result, "scale/RESULTS.json")
    assert doc["stages"]["calibration"]["temperature"] == 1.235

    result = both("scale_demo_extras", ["--demo", "{root}/scale", "--scale", "0.001",
                                        "--ensemble-epochs", "1", "--v5-epochs", "1"])
    assert len(result["port"][1]) == 11
    results_equal(result, "scale/EXTRAS.json")
    merged = {side: load_variables_npz(result[side][0] / "scale" / "v5_runs"
                                       / "v5_merged_variables.npz")
              for side in ("jax", "port")}
    assert _flat(merged["port"]) == _flat(merged["jax"])

    result = both("scale_demo_v5", ["--out", "{root}/v5", "--scale", "0.002",
                                    "--stage1-epochs", "1", "--stage2-epochs", "1",
                                    "--stage3-epochs", "1"])
    assert len(result["port"][1]) == 6
    results_equal(result, "v5/RESULTS.json")
    merged = {side: load_variables_npz(result[side][0] / "v5" / "v5_pipeline_variables.npz")
              for side in ("jax", "port")}
    assert _flat(merged["port"]) == _flat(merged["jax"])


def _flat(tree, prefix=""):
    out = {}
    for key, value in tree.items():
        if isinstance(value, dict):
            out.update(_flat(value, f"{prefix}{key}/"))
        else:
            out[prefix + key] = np.asarray(value).tolist()
    return out

