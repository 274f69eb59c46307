"""The port's ``train_stage3``, ``train_stage2_flat`` and ``train_unified``
beside the JAX package's CLIs, on one synthetic 8 px dataset and its
``prepare_stage3`` layout.

Three JAX CLIs run, on one device as the port: ``train_stage3 --head AB
--fgvc`` and ``train_unified`` at ``--epochs 1``, and ``run_pipeline_eval
--stage3-ab-ensemble-dir`` on the port's ``ensemble/``. Each port training run beside them writes the same file
names (the curves PNG included), the same npz keys and
shapes (the FGVC export with its ``centers/centers``), the same checkpoint
``meta.json`` keys, and history and summary keys. ``train_unified`` goes
through the recipe path that every recipe CLI shares (``train_stage``,
``export_best``, ``write_history``), so the port's RECT run (five frozen
epochs and one unfrozen, from a stage-2 checkpoint) and v5 specialist run
are held to its files under their own names, their exports in the keys and
shapes of the flax model's variables. The JAX package's loader
(``av1tpu.cli.common.load_model_variables``, through which its
``run_pipeline_eval`` reads every checkpoint) reads every port export, and
flax's forward on it equals the port's; the JAX ``run_pipeline_eval`` serves
the port's ``ensemble/`` with the port's own CLI's labels. The port's other
paths (noise injection, the ensemble, the v5 specialist, flatten,
distillation from the four exports, a missing stage-2 file) and the
refusals, each beside the JAX parser's.
"""
import json
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from av1tpu import models as jm
from av1tpu.cli import common as jax_common
from av1tpu.cli import run_pipeline_eval as jax_eval
from av1tpu.cli import train_stage3 as jax_stage3
from av1tpu.cli import train_unified as jax_unified
from av1tpu.train.checkpoint import save_variables_npz as jax_save_variables_npz
from av1tpu_torch import models as tm
from av1tpu_torch.cli import (prepare_stage3, run_pipeline_eval, train_stage2_flat,
                               train_stage3, train_unified)
from av1tpu_torch.data import BlockSet, build_flatten_bundle, build_v6_bundle, save_split
from av1tpu_torch.data.bundles import Bundle
from av1tpu_torch.data.synth import synth_blocks
from av1tpu_torch.models.layers import init_like_flax
from av1tpu_torch.train.checkpoint import load_variables_npz, save_variables_npz
from tests.torch_port_fixtures import images_u16, seeded_torch_model

HW = 8
COMMON = ["--block-size", str(HW), "--batch-size", "32"]
N_TRAIN, N_VAL = 192, 64


def _record(rng, n):
    labels = rng.integers(0, 8, size=n).astype(np.int32)
    return BlockSet(samples=synth_blocks(labels, rng, size=HW), labels=labels,
                    qps=np.full(n, 80, np.int32))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("train_cli_rest")
    rng = np.random.default_rng(30)
    train_rec, val_rec = _record(rng, N_TRAIN), _record(rng, N_VAL)
    dataset = root / "dataset"
    save_split(dataset, HW, build_v6_bundle(train_rec), build_v6_bundle(val_rec), "v6")
    save_split(root / "flat_dataset", HW, build_flatten_bundle(train_rec),
               build_flatten_bundle(val_rec), "flatten")
    prepare_stage3.main(["--dataset-dir", str(dataset), "--out", str(root / "stage3"),
                         "--block-size", str(HW), "--ensemble-members", "2"])
    stage1, stage2 = (save_variables_npz(root / f"{name}_variables.npz", tm.to_jax_variables(
        seeded_torch_model(cls, seed, images_u16(seed, 64, HW)).state_dict()), compress=False)
        for name, cls, seed in (("stage1", tm.Stage1Model, 32), ("stage2", tm.Stage2Model, 31)))
    s3 = ["--dataset-dir", str(root / "stage3"), *COMMON, "--epochs", "1"]
    uni = ["--dataset-dir", str(dataset), *COMMON, "--epochs", "1"]
    plan = {
        "fgvc": (train_stage3, jax_stage3, [*s3, "--head", "AB", "--fgvc"]),
        "unified": (train_unified, jax_unified, uni),
        "v5": (train_stage3, None, [*s3, "--head", "AB", "--variant", "v5"]),
        "rect": (train_stage3, None, [*s3, "--head", "RECT", "--stage2-checkpoint", str(stage2)]),
    }
    out = {"root": root, "dataset": dataset, "stage3": root / "stage3", "stage1": stage1,
           "stage2": stage2}
    for name, (port, jax_cli, argv) in plan.items():
        out[name] = root / name
        if jax_cli is not None:
            out[f"jax_{name}"] = root / f"jax_{name}"
            # on one device, as the port (no mesh before M11): the suite's
            # eight virtual CPU devices would partition the compiled step
            with pytest.MonkeyPatch.context() as mp:
                mp.setattr(jax_cli, "make_cli_mesh", lambda num_model_shards=1: None)
                jax_cli.main([*argv, "--output-dir", str(out[f"jax_{name}"])])
        port.main([*argv, "--output-dir", str(out[name]), "--device", "cpu"])
    # the checkpoint directories' listings, then only their meta.json and
    # variables.npz kept: a full-width TrainState is ~140 MB a directory
    out["listing"] = {d: sorted(f.name for f in d.iterdir()) for d in root.glob("*/*")
                      if d.is_dir() and d.name.rsplit("_", 1)[-1] in ("best", "last", "final")}
    for d in out["listing"]:
        for f in d.iterdir():
            if f.name not in ("meta.json", "variables.npz"):
                shutil.rmtree(f) if f.is_dir() else f.unlink()
    yield out
    shutil.rmtree(root)  # full-width checkpoints, tens of MB a run


def _npz_shapes(path):
    with np.load(path) as z:
        return {k: z[k].shape for k in z.files}


def _keys(tree):
    if isinstance(tree, dict):
        return {k: _keys(v) for k, v in tree.items()}
    if isinstance(tree, list) and tree and isinstance(tree[0], dict):
        return [_keys(tree[0])]
    return None


# port run -> (recipe, the JAX run it is held to, the flax model of its export)
EXPORTS = {"fgvc": ("stage3_ab_fgvc", "fgvc", jm.FGVCModel),
           "unified": ("unified", "unified", jm.UnifiedV6Model),
           "v5": ("v5_stage3_AB", "unified", jm.HierarchicalModel)}
RECT = ("stage3_rect", "unified", jm.Stage3RectModel)


def _flax_shapes(cls, path):
    """The npz keys and shapes of ``cls``'s fresh variables, saved by the JAX
    package's ``save_variables_npz`` at ``path``."""
    variables = jax.eval_shape(cls().init, jax.random.PRNGKey(0), jnp.zeros((1, HW, HW, 1)))
    return _npz_shapes(jax_save_variables_npz(path, jax.tree_util.tree_map(
        lambda a: np.zeros(a.shape, a.dtype), dict(variables))))


def _files_match(runs, name, tmp_path):
    """The JAX run's files under this run's recipe name. A run of another
    recipe (the v5 specialist, RECT) is held to the JAX ``train_unified``
    run's layout and its exports to the flax model's variables."""
    recipe, ref_name, flax_cls = RECT if name == "rect" else EXPORTS[name]
    ours, theirs = runs[name], runs[f"jax_{ref_name}"]
    ref_recipe = EXPORTS[ref_name][0]
    export = f"{recipe}_best_variables.npz"
    want = {p.name.replace(ref_recipe, recipe) for p in theirs.iterdir()}
    assert {p.name for p in ours.iterdir()} == want
    shapes = (_npz_shapes(theirs / export) if ref_name == name
              else _flax_shapes(flax_cls, tmp_path / "flax.npz"))
    assert _npz_shapes(ours / export) == shapes
    if name == "fgvc":
        assert want == {export, f"{recipe}_history.json"}
        assert shapes["centers/centers"] == (4, 512)
    else:
        assert want >= {f"{recipe}_best", f"{recipe}_last", f"{recipe}_final",
                        f"{recipe}_summary.json"}
        for ckpt in ("best", "last", "final"):
            mine, ref = ours / f"{recipe}_{ckpt}", theirs / f"{ref_recipe}_{ckpt}"
            assert runs["listing"][mine] == ["meta.json", "state.pt", "variables.npz"]
            assert {"meta.json", "variables.npz"} <= set(runs["listing"][ref])
            assert _npz_shapes(mine / "variables.npz") == (
                _npz_shapes(ref / "variables.npz") if ref_name == name else shapes)
            assert (sorted(json.loads((mine / "meta.json").read_text()))
                    == sorted(json.loads((ref / "meta.json").read_text())))
        mine = json.loads((ours / f"{recipe}_summary.json").read_text())
        assert _keys(mine) == _keys(json.loads((theirs / f"{ref_recipe}_summary.json")
                                               .read_text()))
    history = json.loads((ours / f"{recipe}_history.json").read_text())
    ref = json.loads((theirs / f"{ref_recipe}_history.json").read_text())
    assert _keys(history) == _keys(ref)
    if ref_name == name:
        assert [h["epoch"] for h in history] == [h["epoch"] for h in ref]
        assert [h.get("phase") for h in history] == [h.get("phase") for h in ref]


@pytest.mark.parametrize("name", sorted(EXPORTS))
def test_cli_files_match_the_jax_cli(runs, name, tmp_path):
    _files_match(runs, name, tmp_path)


def test_rect_writes_the_recipe_files_from_stage2(runs, tmp_path):
    """The RECT run's files are the recipe path's (see ``_files_match``); the
    stage-2 backbone seeds it, the five frozen epochs leave it, the unfrozen
    one moves it by at most twice its lr (1e-5) a step (Adam's first steps
    are about lr; the decay and fp32 rounding add the rest)."""
    _files_match(runs, "rect", tmp_path)
    history = json.loads((runs["rect"] / "stage3_rect_history.json").read_text())
    assert [h["phase"] for h in history] == ["frozen"] * 5 + ["unfrozen"]
    stage2 = load_variables_npz(runs["stage2"])["params"]["backbone"]
    final = load_variables_npz(runs["rect"] / "stage3_rect_final" / "variables.npz")
    steps = len(Bundle.load(runs["stage3"] / "RECT" / f"block_{HW}" / "train.npz")) // 32
    for a, b in zip(jax_leaves(final["params"]["backbone"]), jax_leaves(stage2)):
        assert np.abs(a - b).max() <= 2e-5 * steps


# port export -> (flax model, port class)
SERVED = {"stage3_rect_best_variables.npz": (jm.Stage3RectModel, tm.Stage3RectModel),
          "stage3_ab_fgvc_best_variables.npz": (jm.FGVCModel, tm.FGVCModel),
          "unified_best_variables.npz": (jm.UnifiedV6Model, tm.UnifiedV6Model),
          "stage2_flat_best_variables.npz": (jm.Stage2FlatModel, tm.Stage2FlatModel),
          "v5_stage3_AB_best_variables.npz": (jm.HierarchicalModel, tm.HierarchicalModel),
          "member_1_variables.npz": (jm.Stage3ABModel, tm.Stage3ABModel)}


def _served_equal(path):
    """Flax's forward on the JAX loader's reading of ``path`` equals the
    port's forward on its own reading."""
    jcls, tcls = SERVED[path.name]
    variables = jax_common.load_model_variables(path)
    variables.pop("centers", None)
    x = np.random.default_rng(4).integers(0, 1024, (48, HW, HW, 1)).astype(np.float32) / 1023.0
    want = jcls().apply(variables, jnp.asarray(x), train=False)
    own = load_variables_npz(path)
    own.pop("centers", None)
    port = tm.load_jax_variables(tcls(), own).eval()
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    if jcls is jm.HierarchicalModel:
        want, got = want.specialists["AB"], got.specialists["AB"]
    want, got = np.asarray(want), got.numpy()
    assert want.std() > 1e-4
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("name", sorted(EXPORTS) + ["rect"])
def test_the_jax_loader_serves_the_port_export(runs, name):
    recipe = (RECT if name == "rect" else EXPORTS[name])[0]
    _served_equal(runs[name] / f"{recipe}_best_variables.npz")


@pytest.fixture
def cli(runs):
    """Runs a port CLI into a directory of ``runs``' root, removed after the
    test."""
    made = []

    def run(module, name, *argv):
        out = runs["root"] / name
        made.append(out)
        module.main([*argv, *COMMON, "--output-dir", str(out), "--device", "cpu"])
        return out

    yield run
    for out in made:
        shutil.rmtree(out, ignore_errors=True)


def test_the_ensemble_is_read_by_the_jax_package(runs, cli, capsys):
    """The JAX ``run_pipeline_eval`` serves the port's ``ensemble/`` (with the
    port's stage-1, stage-2 and RECT exports) and gives the port CLI's labels
    on every row, and its stage-1 probabilities within 1e-5."""
    out = cli(train_stage3, "ensemble", "--dataset-dir", str(runs["stage3"]), "--head", "AB",
              "--ensemble", "2", "--epochs", "1", "--stage2-checkpoint", str(runs["stage2"]))
    assert capsys.readouterr().out.count("stage-2 weights grafted") == 2
    assert json.loads((out / "ensemble" / "ensemble.json").read_text()) == {
        "num_members": 2, "members": 2, "epochs": 1}
    argv = ["--variant", "v6", "--dataset-dir", str(runs["dataset"]), "--block-size", str(HW),
            "--batch-size", "64", "--stage1-checkpoint", str(runs["stage1"]),
            "--stage2-checkpoint", str(runs["stage2"]), "--stage3-rect-checkpoint",
            str(runs["rect"] / "stage3_rect_best_variables.npz"),
            "--stage3-ab-ensemble-dir", str(out / "ensemble"), "--no-ab-fgvc"]
    served = {}
    for name, main, tail in (("jax", jax_eval.main, ["--single-device"]),
                             ("port", run_pipeline_eval.main, ["--device", "cpu"])):
        main([*argv, "--output-dir", str(out / f"served_{name}"), *tail])
        assert "AB ensemble: 2 members (soft vote)" in capsys.readouterr().out
        with np.load(out / f"served_{name}" / "pipeline_predictions_val.npz") as z:
            served[name] = {k: z[k] for k in ("predictions", "stage1_prob")}
    jax_run, port_run = served["jax"], served["port"]
    assert len(np.unique(jax_run["predictions"])) >= 2
    np.testing.assert_array_equal(port_run["predictions"], jax_run["predictions"])
    np.testing.assert_allclose(port_run["stage1_prob"], jax_run["stage1_prob"], atol=1e-5)
    _served_equal(out / "ensemble" / "member_1_variables.npz")
    for member in (1, 2):
        history = json.loads((out / f"stage3_ab_member{member}_history.json").read_text())
        # --epochs 1: freeze min(5, max(1, 0)) = 1 epoch, then 1 unfrozen
        assert [h["phase"] for h in history] == ["frozen", "unfrozen"]
        assert (out / f"stage3_ab_member{member}_best_variables.npz").exists()
    # different seeds, different members
    a, b = (load_variables_npz(out / "ensemble" / f"member_{i}_variables.npz")
            for i in (1, 2))
    assert not np.array_equal(a["params"]["head"]["Dense_0"]["kernel"],
                              b["params"]["head"]["Dense_0"]["kernel"])


def test_v5_specialist_and_flatten(runs, cli):
    v5 = runs["v5"]
    history = json.loads((v5 / "v5_stage3_AB_history.json").read_text())
    assert [h["phase"] for h in history] == ["specialist"]
    # only the AB specialist trained: the other heads are the fresh init's
    final = load_variables_npz(v5 / "v5_stage3_AB_final" / "variables.npz")["params"]
    init = tm.to_jax_variables(init_like_flax(tm.HierarchicalModel(),
                                              torch.Generator().manual_seed(42))
                               .state_dict())["params"]
    for key in ("backbone", "stage1_head", "stage2_head", "specialist_RECT"):
        for a, b in zip(jax_leaves(final[key]), jax_leaves(init[key])):
            np.testing.assert_array_equal(a, b)
    assert any(not np.array_equal(a, b) for a, b in zip(jax_leaves(final["specialist_AB"]),
                                                        jax_leaves(init["specialist_AB"])))
    flat = cli(train_stage2_flat, "flat", "--dataset-dir", str(runs["root"] / "flat_dataset"),
               "--freeze-epochs", "1", "--epochs", "2")
    history = json.loads((flat / "stage2_flat_history.json").read_text())
    assert [h["phase"] for h in history] == ["frozen", "unfrozen"]
    assert {p.name for p in flat.iterdir()} == {
        "stage2_flat_best", "stage2_flat_last", "stage2_flat_final",
        "stage2_flat_best_variables.npz", "stage2_flat_history.json",
        "stage2_flat_summary.json", "stage2_flat_training_curves.png"}
    _served_equal(flat / "stage2_flat_best_variables.npz")


def jax_leaves(tree):
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in jax_leaves(tree[k])]
    return [np.asarray(tree)]


def test_noise_injection_and_a_missing_stage2_file(runs, cli, capsys):
    out = cli(train_stage3, "rect_noise", "--dataset-dir", str(runs["stage3"]), "--head",
              "RECT", "--epochs", "1", "--noise-ratio", "0.25", "--noise-dataset-dir",
              str(runs["dataset"]), "--noise-label-dist", "0.7,0.3",
              "--stage2-checkpoint", str(runs["root"] / "missing.npz"))
    printed = capsys.readouterr().out
    assert "not found; training from scratch" in printed
    # 1 - 0.25 of the clean rows, then the noise split evenly over two sources
    n = len(Bundle.load(runs["stage3"] / "RECT" / f"block_{HW}" / "train.npz"))
    total = int(n * 0.75) + 2 * ((n - int(n * 0.75)) // 2)
    assert f"noise injection: ratio=0.25, total={total} samples" in printed
    assert (out / "stage3_rect_best_variables.npz").exists()


def test_distillation_from_the_four_exports(runs, cli, capsys):
    out = cli(train_unified, "unified_kd", "--dataset-dir", str(runs["dataset"]),
              "--epochs", "1", "--distill-weight", "0.5", "--teacher-batch-size", "64",
              "--stage1-checkpoint", str(runs["stage1"]), "--stage2-checkpoint", str(runs["stage2"]),
              "--stage3-rect-checkpoint", str(runs["rect"] / "stage3_rect_best_variables.npz"),
              "--stage3-ab-checkpoint",
              str(runs["fgvc"] / "stage3_ab_fgvc_best_variables.npz"))
    assert (f"computing dense teacher logits ({N_TRAIN} train + {N_VAL} val rows)"
            in capsys.readouterr().out)
    history = json.loads((out / "unified_history.json").read_text())
    assert len(history) == 1 and np.isfinite(history[0]["train_loss"])


def _empty_head(root):
    """A stage-3 layout whose RECT val split is empty."""
    src = root / "stage3" / "RECT" / f"block_{HW}"
    dst = root / "empty_stage3" / "RECT" / f"block_{HW}"
    dst.mkdir(parents=True, exist_ok=True)
    shutil.copy(src / "train.npz", dst / "train.npz")
    val = Bundle.load(src / "val.npz")
    val.take(np.arange(0)).save(dst / "val.npz")
    return root / "empty_stage3"


REFUSALS = {
    "noise_without_dir": (train_stage3, jax_stage3, "stage3",
                          ["--head", "RECT", "--noise-ratio", "0.25"]),
    "noise_label_dist": (train_stage3, jax_stage3, "stage3",
                         ["--head", "RECT", "--noise-ratio", "0.25", "--noise-dataset-dir",
                          "DATASET", "--noise-label-dist", "0.5,0.3,0.2"]),
    "empty_head": (train_stage3, jax_stage3, "empty", ["--head", "RECT"]),
    "distill_without_teachers": (train_unified, jax_unified, "dataset",
                                 ["--distill-weight", "0.5"]),
    "distill_one_teacher": (train_unified, jax_unified, "dataset",
                            ["--distill-weight", "0.5", "--stage2-checkpoint", "STAGE2"]),
}


@pytest.mark.parametrize("name", sorted(REFUSALS))
def test_refusals_match_the_jax_parser(runs, name, capsys):
    port, jax_cli, data, extra = REFUSALS[name]
    data_dir = {"stage3": runs["stage3"], "dataset": runs["dataset"],
                "empty": _empty_head(runs["root"]) if data == "empty" else None}[data]
    extra = [{"DATASET": str(runs["dataset"]), "STAGE2": str(runs["stage2"])}.get(a, a)
             for a in extra]
    argv = ["--dataset-dir", str(data_dir), *COMMON, "--output-dir",
            str(runs["root"] / "refused"), *extra]
    messages = []
    for main, tail in ((jax_cli.main, []), (port.main, ["--device", "cpu"])):
        with pytest.raises(SystemExit) as exc:
            main([*argv, *tail])
        assert exc.value.code == 2
        messages.append(capsys.readouterr().err.strip().splitlines()[-1].split("error: ")[-1])
    assert messages[0] == messages[1]
    assert not (runs["root"] / "refused").exists()
