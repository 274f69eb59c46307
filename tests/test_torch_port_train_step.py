"""One train step and ``train_stage`` of the port against the JAX package.

* One fp32 train step of ``Stage1Model`` and ``Stage2Model`` (both ULMFiT
  phases) at 8 px and batch 8, on weights carried across by
  ``models/jax_import.py`` (calibrated BN, input sensitivity checked first,
  the F2 guard): the loss within 1e-5 rel, each gradient tensor within 1e-4
  of its largest entry (floored, see SMALL_GRAD), the BatchNorm statistics after the step within 1e-5
  of each tensor's largest entry (flax's update: the biased batch variance).
  Dropout is off on both sides: ``flax.linen.Dropout.__call__`` is
  monkeypatched to the identity on the JAX side, the port's dropout rates are
  set to 0. A bf16 step is held loosely (the two packages cast differently).
  Each JAX step is compiled once, with an optimizer whose state captures the
  gradients.
* ``train_stage`` for two epochs (a frozen and an unfrozen phase) on a tiny
  model twin, augment off: every epoch's losses and metrics within 1e-4 rel
  of the JAX package's; resume mid-phase and at the phase boundary bitwise
  equal to the uninterrupted port run; a JAX run's ``variables.npz``
  resumes in the port; the device-resident and streaming epochs agree
  bitwise; the checkpoint round trip and its guard.
"""
import copy

import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch import nn

from av1tpu import models as jm
from av1tpu.data.records import BlockSet as JBlockSet
from av1tpu.data.bundles import build_v6_bundle as j_build_v6_bundle
from av1tpu.models.layers import MLPHead as JMLPHead
from av1tpu.train import losses as jl
from av1tpu.train import schedules as jsch
from av1tpu.train import stages as jst
from av1tpu.train import trainer as jt
from av1tpu_torch import models as tm
from av1tpu_torch.data import BlockSet, build_v6_bundle
from av1tpu_torch.models.layers import BatchNorm2d, MLPHead, SpatialConv, init_like_flax
from av1tpu_torch.train import checkpoint as tc
from av1tpu_torch.train import losses as tl
from av1tpu_torch.train import schedules as tsch
from av1tpu_torch.train import stages as tst
from av1tpu_torch.train import trainer as tt
from tests.torch_port_fixtures import assert_input_sensitive, images_u16, seeded_torch_model

HW, BATCH = 8, 8
LOSS_RTOL, GRAD_TOL, STATS_TOL = 1e-5, 1e-4, 1e-5
# Both packages' fp32 gradients carry absolute rounding noise of about the
# same size in every tensor. A tensor whose gradient is hundreds of times
# smaller than the model's largest (the spatial attention's 7x7 conv at 8 px)
# keeps that absolute noise, so its scale is floored at SMALL_GRAD of the
# model's largest gradient entry.
SMALL_GRAD = 0.1
S2_COUNTS = [23942, 71378, 57280]
# bf16: the JAX package runs every flax module in bf16 (its loss too), the
# port autocasts convs and matmuls and keeps BN statistics and the loss in
# fp32; held loosely
BF16_LOSS_RTOL, BF16_GRAD_SLACK = 5e-2, 2.0


def _capture():
    """An optax transform whose state is the last gradients (updates zero):
    the JAX train step then returns its gradients in ``opt_state``."""
    return optax.GradientTransformation(
        lambda p: jax.tree_util.tree_map(jnp.zeros_like, p),
        lambda g, s, p=None: (jax.tree_util.tree_map(jnp.zeros_like, g), g))


def _identity_dropout(self, inputs, deterministic=None, rng=None):
    return inputs


STEP_MODELS = {  # name: (port class, JAX class, label key, classes, binary)
    "stage1": (tm.Stage1Model, jm.Stage1Model, "stage1", 2, True),
    "stage2": (tm.Stage2Model, jm.Stage2Model, "stage2", 3, False),
}


def _loss(module, name):
    if name == "stage1":
        return lambda lo, ta: module.binary_focal_loss(lo, ta, 0.25, 2.5)
    return lambda lo, ta: module.class_balanced_focal_loss(lo, ta, S2_COUNTS, 0.9999, 2.0)


def _batch(name):
    samples = images_u16(70, BATCH, HW)
    rng = np.random.default_rng(71)
    labels = rng.integers(0, STEP_MODELS[name][3], size=BATCH).astype(np.int32)
    return samples, labels


@pytest.fixture(scope="module")
def jax_steps():
    """Per (model, dtype): the carried variables, and the JAX train step's
    loss, gradients and batch stats on the batch (dropout off)."""
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(flax.linen.Dropout, "__call__", _identity_dropout)
        for name, dtype in (("stage1", "float32"), ("stage2", "float32"),
                            ("stage1", "bfloat16")):
            tcls, jcls, key, classes, binary = STEP_MODELS[name]
            port = seeded_torch_model(tcls, 60 + classes, images_u16(61, 128, HW))
            variables = tm.to_jax_variables(port.state_dict())
            samples, labels = _batch(name)
            cfg = jt.StepConfig(loss_fn=_loss(jl, name), label_key=key, binary=binary,
                                num_classes=classes)
            model = jcls(dtype=jnp.bfloat16 if dtype == "bfloat16" else jnp.float32)
            step = jt.make_train_step(model, _capture(), cfg)
            state = jt.TrainState.create(variables, _capture())
            new, metrics = step(state, {"samples": jnp.asarray(samples),
                                        key: jnp.asarray(labels)}, jax.random.PRNGKey(0))
            out[name, dtype] = {
                "variables": variables, "loss": float(metrics["loss"]),
                "grads": tm.from_jax_variables({"params": jax.tree_util.tree_map(
                    np.asarray, new.opt_state)}),
                "stats": tm.from_jax_variables({"batch_stats": jax.tree_util.tree_map(
                    np.asarray, new.batch_stats)}),
            }
    return out


OPTIMIZERS = {
    "adamw": lambda m: tsch.as_optimizer(m, tsch.adamw(tsch.cosine_schedule(1e-3, 10))),
    "frozen": lambda m: tsch.ulmfit_phase1(m, 5e-4, 10),
    "unfrozen": lambda m: tsch.ulmfit_phase2(m, 5e-4, 1e-6, 10),
}


def _port_step(name, variables, opt_name, dtype=torch.float32):
    """The port's train step on the same batch: returns the model after the
    step, the optimizer, the loss and the gradients it was given (before the
    per-partition clip)."""
    tcls, _, key, classes, binary = STEP_MODELS[name]
    model = tm.load_jax_variables(tcls(), variables)
    for mod in model.modules():
        if isinstance(mod, nn.Dropout):
            mod.p = 0.0
    before = copy.deepcopy(model.state_dict())
    opt = OPTIMIZERS[opt_name](model)
    grads = {}
    names = {id(p): n for n, p in model.named_parameters()}
    step = opt.step

    def capturing_step():
        grads.update({names[id(p)]: torch.zeros_like(p) if p.grad is None else p.grad.clone()
                      for p in opt.params})
        step()

    opt.step = capturing_step
    cfg = tt.StepConfig(loss_fn=_loss(tl, name), label_key=key, binary=binary,
                        num_classes=classes, compute_dtype=dtype)
    samples, labels = _batch(name)
    metrics = tt.make_train_step(model, opt, cfg)(
        tt.TrainState(model, opt), {"samples": torch.from_numpy(samples),
                                    key: torch.from_numpy(labels)},
        torch.Generator().manual_seed(0))
    return model, before, opt, float(metrics["loss"]), grads


def _guard(name, variables):
    """F2: the carried model's logits depend on the input."""
    model = tm.load_jax_variables(STEP_MODELS[name][0](), variables).eval()
    with torch.no_grad():
        logits = model(torch.from_numpy(images_u16(72, 256, HW).astype(np.float32) / 1023.0))
    assert_input_sensitive(logits.numpy(), LOSS_RTOL)


@pytest.mark.parametrize("name, opt_name", [("stage1", "adamw"), ("stage2", "frozen"),
                                            ("stage2", "unfrozen")])
def test_train_step_matches_jax(jax_steps, name, opt_name):
    want = jax_steps[name, "float32"]
    _guard(name, want["variables"])
    model, before, opt, loss, grads = _port_step(name, want["variables"], opt_name)
    assert abs(loss - want["loss"]) <= LOSS_RTOL * abs(want["loss"])
    trainable = {n for n, p in model.named_parameters() if any(p is q for q in opt.params)}
    assert set(grads) == trainable
    if opt_name == "frozen":
        assert all(not n.startswith("backbone") for n in trainable)
        assert any(n.startswith("head") for n in trainable)
    else:
        assert len(trainable) == len(list(model.parameters()))
    largest = max(want["grads"][n].abs().max().item() for n in grads)
    for n, g in grads.items():
        ref = want["grads"][n]
        scale = max(ref.abs().max().item(), SMALL_GRAD * largest)
        assert (g - ref).abs().max().item() <= GRAD_TOL * scale, n
    after = model.state_dict()
    n_stats = 0
    for k, ref in want["stats"].items():
        if k.endswith("num_batches_tracked"):
            continue
        err = (after[k] - ref).abs().max().item()
        assert err <= STATS_TOL * ref.abs().max().item(), k
        assert not torch.equal(after[k], before[k]), k  # frozen or not, BN moved
        n_stats += 1
    assert n_stats == 2 * sum(isinstance(m, BatchNorm2d) for m in model.modules())
    for n, p in model.named_parameters():
        if n not in trainable:
            assert torch.equal(p, before[n]), n  # frozen: no update, no decay


def _flat(grads, names):
    return torch.cat([grads[n].reshape(-1).double() for n in names])


def test_bf16_train_step_is_close_to_jax(jax_steps):
    """bf16 is held loosely: the loss within BF16_LOSS_RTOL of the JAX bf16
    step's, and the port's bf16 gradient no farther from the fp32 gradient
    (relative L2 over the whole model) than BF16_GRAD_SLACK times the JAX
    bf16 gradient is, plus 0.05."""
    want, fp32 = jax_steps["stage1", "bfloat16"], jax_steps["stage1", "float32"]
    _, _, _, loss, grads = _port_step("stage1", want["variables"], "adamw", torch.bfloat16)
    assert abs(loss - want["loss"]) <= BF16_LOSS_RTOL * abs(want["loss"])
    names = sorted(grads)
    ref = _flat(fp32["grads"], names)
    port_dist = ((_flat(grads, names) - ref).norm() / ref.norm()).item()
    jax_dist = ((_flat(want["grads"], names) - ref).norm() / ref.norm()).item()
    assert port_dist <= BF16_GRAD_SLACK * jax_dist + 0.05, (port_dist, jax_dist)


# ---------------------------------------------------------------------------
# train_stage on a tiny model twin
# ---------------------------------------------------------------------------


class JTinyBackbone(flax.linen.Module):
    @flax.linen.compact
    def __call__(self, x, train: bool = False):
        x = flax.linen.Conv(8, (3, 3), use_bias=False, name="conv1")(x)
        x = flax.linen.BatchNorm(use_running_average=not train, momentum=0.9, name="bn1")(x)
        return jnp.mean(flax.linen.relu(x), axis=(1, 2))


class JTinyStage(flax.linen.Module):
    """A conv + BN backbone and an MLP head, named as the bridge maps them."""

    @flax.linen.compact
    def __call__(self, x, train: bool = False):
        feats = JTinyBackbone(name="backbone")(x, train=train)
        out = JMLPHead(hidden=(6,), num_outputs=1, dropout=(0.0,), name="head")(
            feats, train=train)
        return jnp.squeeze(out, -1)


class TinyBackbone(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv1 = SpatialConv(1, 8, 3)
        self.bn1 = BatchNorm2d(8)

    def forward(self, x):
        return torch.relu(self.bn1(self.conv1(x.permute(0, 3, 1, 2)))).mean(dim=(2, 3))


class TinyStage(nn.Module):
    def __init__(self):
        super().__init__()
        self.backbone = TinyBackbone()
        self.head = MLPHead(8, (6,), 1, (0.0,))

    def forward(self, x):
        return self.head(self.backbone(x)).squeeze(-1)


def _bundles(module_build, blockset):
    rng = np.random.default_rng(3)
    out = []
    for n in (96, 40):
        labels = np.tile([0, 3, 1, 0], n // 4).astype(np.int32)
        base = 200 + labels[:, None, None, None] * 90
        samples = (base + rng.normal(0, 60, (n, 8, 8, 1))).clip(0, 1023).astype(np.uint16)
        out.append(module_build(blockset(samples=samples, labels=labels,
                                         qps=np.full(n, 80, np.int32))))
    return out


def _phases(module, first, second):
    sch = jsch if module is jst else tsch
    return [module.Phase(first, lambda p, spe: sch.ulmfit_phase1(p, 2e-2, first * spe),
                         "frozen"),
            module.Phase(second, lambda p, spe: sch.adamw(
                sch.cosine_schedule(1e-2, second * spe)), "unfrozen")]


def _recipe(module, first=1, second=1):
    return module.StageRecipe(
        name="tiny", model=JTinyStage() if module is jst else TinyStage, label_key="stage1",
        num_classes=2, binary=True,
        loss_fn=(jl if module is jst else tl).binary_focal_loss,
        balance=True, phases=_phases(module, first, second), batch_size=16,
        input_shape=(8, 8, 1))


@pytest.fixture(scope="module")
def tiny_runs(tmp_path_factory):
    """The JAX package's two-epoch run of the tiny twin, and its init
    variables (both packages start from them)."""
    root = tmp_path_factory.mktemp("tiny")
    j_train, j_val = _bundles(j_build_v6_bundle, JBlockSet)
    init = jax.tree_util.tree_map(np.asarray, JTinyStage().init(
        jax.random.PRNGKey(5), jnp.zeros((2, 8, 8, 1))))
    full = jst.train_stage(_recipe(jst), j_train, j_val, seed=0, log=lambda s: None,
                           init_params=init["params"], init_batch_stats=init["batch_stats"],
                           checkpoint_dir=root / "jax_full")
    jst.train_stage(_recipe(jst), j_train, j_val, seed=0, log=lambda s: None,
                    init_params=init["params"], init_batch_stats=init["batch_stats"],
                    checkpoint_dir=root / "jax_split", stop_after_epoch=0)
    return {"root": root, "init": init, "jax": full,
            "bundles": _bundles(build_v6_bundle, BlockSet)}


def _port_run(tiny, first=1, second=1, **kw):
    train, val = tiny["bundles"]
    return tst.train_stage(_recipe(tst, first, second), train, val, seed=0,
                           log=lambda s: None, init_params=tiny["init"]["params"],
                           init_batch_stats=tiny["init"]["batch_stats"], device="cpu", **kw)


def _close_metrics(got, want, rtol=1e-4):
    if isinstance(want, dict):
        for k in want:
            _close_metrics(got[k], want[k], rtol)
    elif isinstance(want, list):
        np.testing.assert_allclose(got, want, rtol=rtol, atol=1e-7)
    else:
        assert abs(got - want) <= rtol * abs(want) + 1e-7


def test_train_stage_two_epochs_match_jax(tiny_runs, tmp_path):
    port = _port_run(tiny_runs, checkpoint_dir=tmp_path)
    want = tiny_runs["jax"].history
    assert [h["epoch"] for h in port.history] == [h["epoch"] for h in want] == [0, 1]
    assert [h["phase"] for h in port.history] == ["frozen", "unfrozen"]
    for got, ref in zip(port.history, want):
        for key in ("train_loss", "val_loss", "train_metrics", "val_metrics"):
            _close_metrics(got[key], ref[key])
    # the learned state: parameters and BN statistics near the JAX run's
    final = tm.from_jax_variables(jax.tree_util.tree_map(np.asarray, {
        "params": tiny_runs["jax"].state.params,
        "batch_stats": tiny_runs["jax"].state.batch_stats}))
    for k, ref in final.items():
        if not k.endswith("num_batches_tracked"):
            got = port.state.model.state_dict()[k]
            assert (got - ref).abs().max().item() <= 1e-4 * max(ref.abs().max().item(), 1e-3), k
    for name in ("tiny_best", "tiny_last", "tiny_final"):
        assert {p.name for p in (tmp_path / name).iterdir()} == {
            "meta.json", "state.pt", "variables.npz"}


def _assert_same_state(a: tt.TrainState, b: tt.TrainState):
    assert tc.states_equal(a, b)


@pytest.mark.parametrize("phases, stop", [((1, 3), 1), ((2, 2), 1)],
                         ids=["mid_phase", "phase_boundary"])
def test_resume_is_bitwise_identical(tiny_runs, tmp_path, phases, stop):
    full = _port_run(tiny_runs, *phases, checkpoint_dir=tmp_path / "full")
    _port_run(tiny_runs, *phases, checkpoint_dir=tmp_path / "split", stop_after_epoch=stop)
    resumed = _port_run(tiny_runs, *phases, checkpoint_dir=tmp_path / "split",
                        resume_from=tmp_path / "split" / "tiny_last")
    assert [h["epoch"] for h in resumed.history] == list(range(stop + 1, sum(phases)))
    _assert_same_state(full.state, resumed.state)
    by_epoch = {h["epoch"]: h for h in full.history}
    for h in resumed.history:
        assert h["val_loss"] == by_epoch[h["epoch"]]["val_loss"]
        assert h["train_loss"] == by_epoch[h["epoch"]]["train_loss"]


def test_a_jax_checkpoint_resumes_in_the_port(tiny_runs):
    """The JAX run stopped after epoch 0 (the phase boundary); the port
    resumes from its ``tiny_last`` through ``variables.npz`` with a fresh
    optimizer, which is what the uninterrupted run does at the boundary, so
    its epoch 1 matches the JAX run's epoch 1."""
    resumed = _port_run(tiny_runs, resume_from=tiny_runs["root"] / "jax_split" / "tiny_last")
    assert [h["epoch"] for h in resumed.history] == [1]
    want = tiny_runs["jax"].history[1]
    for key in ("train_loss", "val_loss", "train_metrics", "val_metrics"):
        _close_metrics(resumed.history[0][key], want[key])


def test_resident_and_streaming_epochs_agree(tiny_runs, monkeypatch):
    resident = _port_run(tiny_runs)
    monkeypatch.setenv("AV1TPU_STREAM_DATA", "1")
    streaming = _port_run(tiny_runs)
    _assert_same_state(resident.state, streaming.state)
    for a, b in zip(resident.history, streaming.history):
        assert a["train_loss"] == b["train_loss"] and a["val_loss"] == b["val_loss"]
        assert a["val_metrics"] == b["val_metrics"]


def test_checkpoint_round_trip_and_its_guard(tiny_runs, tmp_path, monkeypatch):
    result = _port_run(tiny_runs, checkpoint_dir=tmp_path / "run")
    state = result.state
    tc.save_checkpoint(tmp_path / "ck", state, meta={"epoch": 3}, verify=True)
    model = TinyStage()
    template = tt.TrainState(model, tsch.as_optimizer(model, tsch.adamw(1e-2)))
    restored, meta = tc.restore_checkpoint(tmp_path / "ck", template)
    assert meta == {"epoch": 3} and restored.step == state.step
    _assert_same_state(state, restored)
    best = tc.load_variables_npz(tmp_path / "run" / "tiny_best" / "variables.npz")
    assert sorted(best) == ["batch_stats", "params"]
    real_load = torch.load

    def flipped(*args, **kwargs):  # one parameter a ulp off after the reload
        payload = real_load(*args, **kwargs)
        w = payload["model"]["head.head.0.weight"]
        w.view(-1)[0] = torch.nextafter(w.view(-1)[0], torch.tensor(1.0))
        return payload

    monkeypatch.setattr(torch, "load", flipped)
    with pytest.raises(RuntimeError, match="quirk-Q4"):
        tc.save_checkpoint(tmp_path / "ck2", state, verify=True)


def test_init_like_flax_draws_flax_distributions():
    """``init_like_flax``: lecun-normal weights truncated at 2 std with unit
    variance over the fan-in, zero biases, BN 1/0 and stats 0/1, adapters
    normal(1e-3); and the same seed draws the same model."""
    model = tm.Stage2ModelWithAdapters()
    init_like_flax(model, torch.Generator().manual_seed(0))
    w = model.backbone_layer2[0].conv1.weight  # fan-in 64 * 9
    std = (1.0 / (64 * 9)) ** 0.5
    assert abs(w.std().item() / std - 1) < 0.02
    assert w.abs().max().item() <= 2 * std / 0.87962566103423978 + 1e-6
    assert model.head.head[0].bias.abs().max().item() == 0
    assert abs(model.adapter_layer1.down.weight.std().item() / 1e-3 - 1) < 0.05
    bn = model.backbone_bn1
    assert bn.weight.eq(1).all() and bn.bias.eq(0).all()
    assert bn.running_mean.eq(0).all() and bn.running_var.eq(1).all()
    again = init_like_flax(tm.Stage2ModelWithAdapters(), torch.Generator().manual_seed(0))
    for (n, a), b in zip(model.state_dict().items(), again.state_dict().values()):
        assert torch.equal(a, b), n
