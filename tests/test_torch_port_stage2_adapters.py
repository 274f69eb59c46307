"""``train_stage2 --use-adapters --stage1-checkpoint`` seeds the adapter
model's trunk from stage 1 in the port (``cli.train_stage2.seed_from_stage1``).

The adapter model names its trunk ``backbone_conv1``, ``backbone_layer1_0``
and so on; stage 1 keeps it under ``backbone``. The JAX CLI transplants
stage 1 under a ``backbone`` key that model never reads, so its adapters
train over a random frozen trunk. The port maps stage 1's ``backbone/<x>``
onto ``backbone_<x>`` instead, in params and batch_stats, as the reference
loads the stage-1 backbone. Held here: the mapped trunk equals stage 1's
bit for bit and the rest of the fresh init is untouched, a shape mismatch
is refused, and one adapter step of the port's ``train_stage`` from that
init equals the JAX package's ``train_stage`` given the same init through
its own ``init_params`` / ``init_batch_stats`` (dropout and augmentation
off on both sides, as ``test_torch_port_train_step.py`` holds its steps):
the loss and the BN statistics of the step's forward, the frozen trunk
bitwise, and every entry that the step moves decisively (see DECISIVE).
"""
from dataclasses import replace

import flax.linen
import jax
import numpy as np
import pytest
import torch
from torch import nn

from av1tpu.data.bundles import build_v6_bundle as j_build_v6_bundle
from av1tpu.data.records import BlockSet as JBlockSet
from av1tpu.train import stages as jst
from av1tpu_torch import models as tm
from av1tpu_torch.cli.train_stage2 import seed_from_stage1
from av1tpu_torch.data import BlockSet, build_v6_bundle, class_counts
from av1tpu_torch.models.layers import init_like_flax
from av1tpu_torch.train import stages as tst
from av1tpu_torch.train.checkpoint import transplant_flat_backbone
from chip_smoke import set_first_class_share
from tests.torch_port_fixtures import assert_input_sensitive, images_u16, seeded_torch_model

HW, BATCH = 8, 16
LOSS_RTOL, PARAM_TOL, STATS_TOL = 1e-5, 1e-4, 1e-5
# An entry whose first AdamW step is at least DECISIVE of the largest step has
# |g| >= ~100 eps: both packages must take the same step there. Below that the
# gradient is near zero and its fp32 rounding decides the step (the adapters'
# up-projection biases feed a train-mode BatchNorm, which removes a per-channel
# shift: their gradient is rounding), which moves an entry by at most twice
# the largest step.
DECISIVE = 0.99


def _leaves(tree, prefix=()):
    if not isinstance(tree, dict):
        return {prefix: np.asarray(tree)}
    return {k: v for key, sub in tree.items() for k, v in _leaves(sub, prefix + (key,)).items()}


def _no_dropout(model: nn.Module) -> nn.Module:
    for mod in model.modules():
        if isinstance(mod, nn.Dropout):
            mod.p = 0.0
    return model


def _identity_dropout(self, inputs, deterministic=None, rng=None):
    return inputs


def _blocks(seed, n):
    labels = np.tile([3, 1, 4, 7], n // 4).astype(np.int32)  # SPLIT, RECT, AB, AB
    return images_u16(seed, n, HW), labels, np.full(n, 80, np.int32)


@pytest.fixture(scope="module")
def seeded():
    """Stage 1's variables, a fresh adapter init and the port's mapped init;
    the adapter head shifted so that its decisions vary (F2 guard)."""
    stage1 = seeded_torch_model(tm.Stage1Model, 81, images_u16(82, 128, HW))
    stage1_vars = tm.to_jax_variables(stage1.state_dict())
    fresh = tst.variables_of(init_like_flax(tm.Stage2ModelWithAdapters(),
                                            torch.Generator().manual_seed(0)))
    params, stats = seed_from_stage1(fresh, stage1_vars, "v6")
    model = _no_dropout(tm.load_jax_variables(tm.Stage2ModelWithAdapters(),
                                              {"params": params, "batch_stats": stats}))
    probe = torch.from_numpy(images_u16(83, 256, HW).astype(np.float32) / 1023.0)
    with torch.no_grad():
        logits = model.eval()(probe).numpy()
    assert_input_sensitive(set_first_class_share(model.head, logits, 0.4), LOSS_RTOL)
    mapped = tst.variables_of(model)
    return {"stage1": stage1_vars, "fresh": fresh, "params": params, "stats": stats,
            "init": mapped}


def test_the_adapter_trunk_is_stage1s_bit_for_bit(seeded, capsys):
    for col, params in (("params", seeded["params"]), ("batch_stats", seeded["stats"])):
        source = seeded["stage1"][col]["backbone"]
        for x, tree in source.items():
            got, want = _leaves(params[f"backbone_{x}"]), _leaves(tree)
            assert sorted(got) == sorted(want), (col, x)
            for path, value in want.items():
                assert got[path].dtype == value.dtype and got[path].tobytes() == value.tobytes()
        seeded_keys = {f"backbone_{x}" for x in source}
        assert set(params) == set(seeded["fresh"][col])
        for key in set(params) - seeded_keys:  # adapters, head: the fresh init
            for path, value in _leaves(seeded["fresh"][col][key]).items():
                assert _leaves(params[key])[path].tobytes() == value.tobytes(), (col, key)
    assert {k for k in seeded["params"] if k.startswith("backbone_")} == {
        f"backbone_{x}" for x in seeded["stage1"]["params"]["backbone"]}
    seed_from_stage1(seeded["fresh"], seeded["stage1"], "v6")
    printed = capsys.readouterr().out
    assert printed.startswith("seeded backbone_bn1, backbone_conv1, backbone_layer1_0")
    assert "backbone_spatial_attn from stage-1 checkpoint's backbone/<x>" in printed


def test_a_mismatched_trunk_is_refused(seeded, capsys):
    stage1 = {"params": {"backbone": dict(seeded["stage1"]["params"]["backbone"])}}
    stage1["params"]["backbone"]["conv1"] = {"kernel": np.zeros((3, 3, 1, 64), np.float32)}
    with pytest.raises(ValueError, match="backbone/conv1"):
        transplant_flat_backbone(seeded["fresh"]["params"], stage1["params"])
    assert seed_from_stage1(seeded["fresh"], stage1, "v6") == (None, None)
    assert "backbone transplant skipped" in capsys.readouterr().out


def _recipe(module, counts):
    recipe = module.stage2_recipe(samples_per_class=counts, freeze_epochs=1,
                                  unfreeze_epochs=0, batch_size=BATCH,
                                  steps_per_epoch=1, use_adapters=True)
    model = (recipe.model if module is jst
             else lambda: _no_dropout(tm.Stage2ModelWithAdapters()))
    return replace(recipe, model=model, augment=None, input_shape=(HW, HW, 1))


def test_one_adapter_step_matches_jax_train_stage(seeded):
    train_rows, val_rows = _blocks(84, BATCH), _blocks(85, BATCH)
    train = build_v6_bundle(BlockSet(*train_rows))
    val = build_v6_bundle(BlockSet(*val_rows))
    counts = class_counts(train.labels["stage2"], 3)
    init = seeded["init"]
    port = tst.train_stage(_recipe(tst, counts), train, val, seed=0, log=lambda s: None,
                           init_params=init["params"], init_batch_stats=init["batch_stats"],
                           device="cpu")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(flax.linen.Dropout, "__call__", _identity_dropout)
        want = jst.train_stage(
            _recipe(jst, counts), j_build_v6_bundle(JBlockSet(*train_rows)),
            j_build_v6_bundle(JBlockSet(*val_rows)), seed=0, log=lambda s: None,
            init_params=init["params"], init_batch_stats=init["batch_stats"])
    assert [h["phase"] for h in port.history] == [h["phase"] for h in want.history] == [
        "adapters"]
    # the step's forward, from the seeded trunk: the loss, and the BN statistics
    got, ref = port.history[0]["train_loss"], want.history[0]["train_loss"]
    assert abs(got - ref) <= LOSS_RTOL * abs(ref)
    after = tst.variables_of(port.state.model)
    final = jax.tree_util.tree_map(np.asarray, {"params": want.state.params,
                                                "batch_stats": want.state.batch_stats})
    got, exp = _leaves(after["batch_stats"]), _leaves(final["batch_stats"])
    assert sorted(got) == sorted(exp)
    for path, value in exp.items():
        assert np.abs(got[path] - value).max() <= STATS_TOL * np.abs(value).max(), path
    # the step: the frozen trunk is still stage 1's in both packages; AdamW's
    # first step moves each trainable entry by lr * g / (|g| + eps)
    got, exp, start = (_leaves(after["params"]), _leaves(final["params"]),
                       _leaves(init["params"]))
    assert sorted(got) == sorted(exp)
    moves = {}
    for path, value in exp.items():
        if path[0].startswith("backbone_"):
            assert got[path].tobytes() == start[path].tobytes() == value.tobytes(), path
        else:
            moves[path] = np.abs(value - start[path])
    step = max(m.max() for m in moves.values())
    decisive = n = 0
    for path, move in moves.items():
        clear = move >= DECISIVE * step
        err = np.abs(got[path] - exp[path])
        assert err.max() <= 2 * step, path
        assert err[clear].max(initial=0) <= PARAM_TOL * np.abs(exp[path]).max(), path
        decisive += int(clear.sum())
        n += move.size
    assert decisive >= 0.5 * n, (decisive, n)
