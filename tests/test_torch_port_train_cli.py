"""The port's training CLIs beside the JAX package's, on one synthetic 8 px
dataset: ``train_stage1`` and ``train_stage2`` write the JAX CLIs' file names
(the curves PNG included), the same npz keys and
shapes, the same ``meta.json``, history and summary keys; the JAX package's
serving loader (``av1tpu.cli.common.load_model_variables``, through which
its ``run_pipeline_eval`` reads every checkpoint) reads the port's exports,
and flax's forward on them equals the port's. Then the port CLIs' other
flags: ``--use-hard-mining``, ``--bf16``, ``--variant v5`` (stage 1, then
stage 2 seeded with the full stage-1 state), ``--scratch``,
``--use-adapters`` (its frozen trunk seeded from stage 1, which the JAX CLI
does not do), ``--pipeline-aware``, ``--resume``, and the refusals.
The JAX stage-2 run takes ``--scratch`` (one phase, one compile); its files
are the default run's.
"""
import json
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from av1tpu import models as jm
from av1tpu.cli import common as jax_common
from av1tpu.cli import train_stage1 as jax_stage1
from av1tpu.cli import train_stage2 as jax_stage2
from av1tpu_torch import models as tm
from av1tpu_torch.cli import train_stage1, train_stage2
from av1tpu_torch.data import BlockSet, build_v6_bundle, save_split
from av1tpu_torch.data.synth import synth_blocks
from av1tpu_torch.train.checkpoint import load_variables_npz

HW = 8
COMMON = ["--block-size", str(HW), "--batch-size", "32"]


def _bundle(rng, n):
    labels = rng.integers(0, 8, size=n).astype(np.int32)
    return build_v6_bundle(BlockSet(samples=synth_blocks(labels, rng, size=HW),
                                    labels=labels, qps=np.full(n, 80, np.int32)))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("train_cli")
    rng = np.random.default_rng(20)
    dataset = root / "dataset"
    save_split(dataset, HW, _bundle(rng, 96), _bundle(rng, 48), "v6")
    data = ["--dataset-dir", str(dataset), *COMMON]
    out = {name: root / name for name in ("jax_s1", "jax_s2", "s1", "s2")}
    jax_stage1.main([*data, "--output-dir", str(out["jax_s1"]), "--epochs", "1"])
    jax_stage2.main([*data, "--output-dir", str(out["jax_s2"]), "--epochs", "1", "--scratch",
                     "--stage1-checkpoint", str(out["jax_s1"] / "stage1_best_variables.npz")])
    port = [*data, "--device", "cpu"]
    train_stage1.main([*port, "--output-dir", str(out["s1"]), "--epochs", "2"])
    train_stage2.main([*port, "--output-dir", str(out["s2"]), "--epochs", "2",
                       "--freeze-epochs", "1",
                       "--stage1-checkpoint", str(out["s1"] / "stage1_best_variables.npz")])
    yield {"root": root, "dataset": dataset, "data": port, **out}
    shutil.rmtree(root)  # ~0.7 GB of full-width checkpoints a CLI run


def _npz_shapes(path):
    with np.load(path) as z:
        return {k: z[k].shape for k in z.files}


def _leaves(tree, prefix=()):
    if not isinstance(tree, dict):
        return {prefix: tree}
    return {k: v for key, sub in tree.items() for k, v in _leaves(sub, prefix + (key,)).items()}


def _keys(tree):
    if isinstance(tree, dict):
        return {k: _keys(v) for k, v in tree.items()}
    if isinstance(tree, list) and tree and isinstance(tree[0], dict):
        return [_keys(tree[0])]
    return None


@pytest.mark.parametrize("name", ["stage1", "stage2"])
def test_cli_files_match_the_jax_cli(runs, name):
    ours = runs["s1" if name == "stage1" else "s2"]
    theirs = runs["jax_s1" if name == "stage1" else "jax_s2"]
    want = {p.name for p in theirs.iterdir()}
    assert {p.name for p in ours.iterdir()} == want
    assert want >= {f"{name}_best", f"{name}_last", f"{name}_final",
                    f"{name}_best_variables.npz", f"{name}_history.json",
                    f"{name}_summary.json", f"{name}_training_curves.png"}
    export = f"{name}_best_variables.npz"
    assert _npz_shapes(ours / export) == _npz_shapes(theirs / export)
    for ckpt in ("best", "last", "final"):
        mine, ref = ours / f"{name}_{ckpt}", theirs / f"{name}_{ckpt}"
        assert {"meta.json", "variables.npz", "state.pt"} == {p.name for p in mine.iterdir()}
        assert (ref / "meta.json").exists() and (ref / "variables.npz").exists()
        assert _npz_shapes(mine / "variables.npz") == _npz_shapes(ref / "variables.npz")
        assert (sorted(json.loads((mine / "meta.json").read_text()))
                == sorted(json.loads((ref / "meta.json").read_text())))
    for doc in ("history", "summary"):
        mine = json.loads((ours / f"{name}_{doc}.json").read_text())
        ref = json.loads((theirs / f"{name}_{doc}.json").read_text())
        assert _keys(mine) == _keys(ref)
    history = json.loads((ours / f"{name}_history.json").read_text())
    assert [h["phase"] for h in history] == (["cosine", "cosine"] if name == "stage1"
                                             else ["frozen", "unfrozen"])


@pytest.mark.parametrize("name", ["stage1", "stage2"])
def test_the_jax_loader_serves_the_port_export(runs, name):
    path = runs["s1" if name == "stage1" else "s2"] / f"{name}_best_variables.npz"
    variables = jax_common.load_model_variables(path)
    jcls, tcls = ((jm.Stage1Model, tm.Stage1Model) if name == "stage1"
                  else (jm.Stage2Model, tm.Stage2Model))
    x = np.random.default_rng(4).integers(0, 1024, (64, HW, HW, 1)).astype(np.float32) / 1023.0
    want = np.asarray(jcls().apply(variables, jnp.asarray(x), train=False))
    port = tm.load_jax_variables(tcls(), load_variables_npz(path)).eval()
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    assert want.std() > 1e-4
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5 * np.abs(want).max())


def test_the_stage2_backbone_comes_from_stage1(runs):
    s1 = load_variables_npz(runs["s1"] / "stage1_best_variables.npz")
    s2_final = load_variables_npz(runs["s2"] / "stage2_final" / "variables.npz")
    s2_first = json.loads((runs["s2"] / "stage2_history.json").read_text())[0]
    assert s2_first["phase"] == "frozen"
    # the frozen phase leaves the transplanted backbone's parameters alone
    # and the unfrozen one moves them by at most ~lr * steps
    for key, value in s1["params"]["backbone"]["conv1"].items():
        diff = np.abs(s2_final["params"]["backbone"]["conv1"][key] - value).max()
        assert diff <= 1e-6 * 2 * 4 + 1e-7, key


@pytest.fixture
def cli(runs):
    """Runs a port CLI into a directory of ``runs``' root, removed after the
    test."""
    made = []

    def run(module, name, *extra):
        out = runs["root"] / name
        made.append(out)
        module.main([*runs["data"], "--output-dir", str(out), *extra])
        return out

    yield run
    for out in made:
        shutil.rmtree(out, ignore_errors=True)


@pytest.mark.parametrize("flags", [["--use-hard-mining"], ["--bf16"], ["--variant", "v5"]],
                         ids=["hard_mining", "bf16", "v5"])
def test_stage1_flags(cli, flags):
    out = cli(train_stage1, "s1_" + "_".join(f.strip("-") for f in flags), "--epochs", "1",
              *flags)
    name = "v5_stage1" if "v5" in flags else "stage1"
    summary = json.loads((out / f"{name}_summary.json").read_text())
    assert summary["epochs"] == 1 and np.isfinite(summary["best_value"])
    shapes = _npz_shapes(out / f"{name}_best_variables.npz")
    if "v5" in flags:
        assert "params/stage1_head/Dense_0/kernel" in shapes
    else:
        assert shapes["params/backbone/conv1/kernel"] == (7, 7, 1, 64)


@pytest.mark.parametrize("flags", [["--scratch"], ["--use-adapters"], ["--pipeline-aware"],
                                   ["--variant", "v5"]],
                         ids=["scratch", "adapters", "pipeline_aware", "v5"])
def test_stage2_flags(runs, cli, flags, capsys):
    stage1 = runs["s1"] / "stage1_best_variables.npz"
    if "v5" in flags:
        v5_dir = cli(train_stage1, "s1_v5_seed", "--epochs", "1", "--variant", "v5")
        stage1 = v5_dir / "v5_stage1_best_variables.npz"
    out = cli(train_stage2, "s2_" + "_".join(f.strip("-") for f in flags), "--epochs", "1",
              "--freeze-epochs", "1", "--stage1-checkpoint", str(stage1), *flags)
    printed = capsys.readouterr().out
    name = "v5_stage2" if "v5" in flags else "stage2"
    history = json.loads((out / f"{name}_history.json").read_text())
    phases = {"--scratch": ["scratch", "scratch"], "--use-adapters": ["adapters", "adapters"],
              "--pipeline-aware": ["frozen", "unfrozen"], "--variant": ["main"]}[flags[0]]
    assert [h["phase"] for h in history] == phases
    if "--pipeline-aware" in flags:
        assert "pipeline-aware filter:" in printed
    if "v5" in flags:
        assert "seeded full v5 state" in printed
        s1 = load_variables_npz(stage1)["params"]["stage1_head"]
        s2 = load_variables_npz(out / "v5_stage2_final" / "variables.npz")["params"]
        # stage 1's head rides along untrained (the 5-way loss does not reach it)
        assert sorted(s2["stage1_head"]) == sorted(s1)
    if "--use-adapters" in flags:
        # stage 1's backbone/<x> seeds the adapter model's backbone_<x>, which
        # the adapter phase keeps frozen: its parameters end as stage 1's
        assert "seeded backbone_bn1, backbone_conv1, backbone_layer1_0" in printed
        s1 = load_variables_npz(stage1)["params"]["backbone"]
        s2 = load_variables_npz(out / "stage2_final" / "variables.npz")["params"]
        for x, tree in s1.items():
            got = _leaves(s2[f"backbone_{x}"])
            assert sorted(got) == sorted(_leaves(tree))
            for path, value in _leaves(tree).items():
                assert got[path].tobytes() == value.tobytes(), (x, path)


def test_resume_continues_the_epochs(runs, cli):
    out = cli(train_stage1, "s1_resumed", "--epochs", "3",
              "--resume", str(runs["s1"] / "stage1_last"))
    history = json.loads((out / "stage1_history.json").read_text())
    assert [h["epoch"] for h in history] == [2]


@pytest.mark.parametrize("flags, message", [
    (["--num-model-shards", "2"], "M11"),
    (["--device", "cuda"], "no CUDA device"),
])
def test_refusals(runs, flags, message, capsys):
    if "cuda" in flags and torch.cuda.is_available():
        pytest.skip("this machine has a card")
    argv = [a for a in runs["data"] if a not in ("--device", "cpu")]
    with pytest.raises(SystemExit):
        train_stage1.main([*argv, "--output-dir", str(runs["root"] / "refused"), *flags,
                           *(["--device", "cpu"] if "--device" not in flags else [])])
    assert message in capsys.readouterr().err
