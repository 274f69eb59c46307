"""The port's unified multi-task training (``train.unified``) against the JAX
package's ``av1tpu.train.unified``, on the same numpy-seeded inputs at 8 px:
the label packing and the composed 8-class metric labels exactly; the hard
and distillation losses with -1 masks and padding rows within 1e-6; the
predictions (``v6_route`` over the four heads) exactly; both augmentations
bitwise on the JAX package's own draws; ``compute_teacher_logits`` (the four
stage models dense, the AB one an FGVC model); and one unified train step,
with hard labels and with distillation, within the train-step tolerances
(loss 1e-5 rel, gradients 1e-4 of their largest entry, BN statistics 1e-5).
Dropout is off on both sides.
"""
import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch import nn

from av1tpu import models as jm
from av1tpu.data import bundles as jb
from av1tpu.eval import PipelineModels as JPipelineModels
from av1tpu.train import trainer as jt
from av1tpu.train import unified as ju
from av1tpu_torch import models as tm
from av1tpu_torch.data import bundles as tb
from av1tpu_torch.data.records import BlockSet
from av1tpu_torch.data.synth import synth_blocks
from av1tpu_torch.eval.hierarchy import PipelineModels
from av1tpu_torch.train import augment as ta
from av1tpu_torch.train import schedules as tsch
from av1tpu_torch.train import trainer as tt
from av1tpu_torch.train import unified as tu
from chip_smoke import captured_step
from tests.test_torch_port_train import _jax_draws, _stack_draws
from tests.torch_port_fixtures import (
    assert_input_sensitive,
    cascade_unified_models,
    images_u16,
    seeded_torch_model,
)

HW, BATCH = 8, 8
RTOL = 1e-6
LOSS_RTOL, GRAD_TOL, STATS_TOL, SMALL_GRAD = 1e-5, 1e-4, 1e-5, 0.1
S2_COUNTS, AB_COUNTS = [5986, 17844, 14320], [5500, 1125, 1195, 6500]


def _bundles(seed, n):
    """A port and a JAX v6 bundle of the same ``n`` synthetic 8 px blocks."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, 8, n).astype(np.int32)
    port = tb.build_v6_bundle(BlockSet(samples=synth_blocks(labels, rng, size=HW),
                                       labels=labels, qps=np.full(n, 80, np.int32)))
    return port, jb.Bundle(samples=port.samples, qps=port.qps, labels=dict(port.labels))


def _teachers(seed, n):
    return (np.random.default_rng(seed).normal(size=(n, 10)) * 2).astype(np.float32)


def _packed(seed, n, teachers=True, pad=2):
    """Packed labels of a bundle (with teacher columns), the last ``pad`` rows
    set to -1 as the eval padding sets them."""
    port, _ = _bundles(seed, n)
    packed = tu.pack_unified_labels(port, _teachers(seed + 1, n) if teachers else None)
    packed[n - pad:] = -1
    return packed


def test_label_packing_and_metric_labels_equal_the_jax_package():
    port, jax_b = _bundles(1, 200)
    teachers = _teachers(2, 200)
    for t in (None, teachers):
        got, want = tu.pack_unified_labels(port, t), ju.pack_unified_labels(jax_b, t)
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)
    got_b = tu.with_unified_labels(port, teachers)
    np.testing.assert_array_equal(got_b.labels["unified"],
                                  ju.with_unified_labels(jax_b, teachers).labels["unified"])
    assert set(got_b.labels) == set(port.labels) | {"unified"}
    with pytest.raises(ValueError):
        tu.pack_unified_labels(port, teachers[:, :9])
    packed = tu.pack_unified_labels(port, teachers)
    packed[-3:] = -1
    got = tu.unified_metric_labels(torch.from_numpy(packed))
    want = np.asarray(ju.unified_metric_labels(jnp.asarray(packed)))
    np.testing.assert_array_equal(got.numpy(), want)
    assert set(np.unique(want)) >= {-1, 0, 1} and (want >= 2).any()
    assert tu.unified_counts(port) == ju.unified_counts(jax_b)


LOSSES = {
    "hard": {},
    "hard_weighted": {"head_weights": (1.0, 0.5, 2.0, 1.5), "alpha": 0.3, "gamma": 2.0},
    "distilled": {"distill_weight": 0.5},
    "distilled_t4": {"distill_weight": 0.8, "kd_temperature": 4.0,
                     "head_weights": (0.5, 1.0, 1.0, 2.0)},
}


@pytest.mark.parametrize("name", sorted(LOSSES))
def test_unified_loss_equals_the_jax_package(name):
    kw = LOSSES[name]
    packed = _packed(3, 64, teachers="distill_weight" in kw)
    outputs = (np.random.default_rng(4).normal(size=(64, 10)) * 3).astype(np.float32)
    want = ju.make_unified_loss(S2_COUNTS, AB_COUNTS, **kw)(jnp.asarray(outputs),
                                                            jnp.asarray(packed))
    got = tu.make_unified_loss(S2_COUNTS, AB_COUNTS, **kw)(torch.from_numpy(outputs),
                                                           torch.from_numpy(packed))
    np.testing.assert_allclose(float(got), float(want), rtol=RTOL)


@pytest.mark.parametrize("threshold", [0.5, 0.45])
def test_predictions_equal_the_jax_router(threshold):
    outputs = (np.random.default_rng(5).normal(size=(300, 10)) * 2).astype(np.float32)
    got = tu.make_unified_predictions(threshold)(torch.from_numpy(outputs))
    want = np.asarray(ju.make_unified_predictions(threshold)(jnp.asarray(outputs)))
    np.testing.assert_array_equal(got.numpy(), want)
    assert len(np.unique(want)) >= 6


def _unified_draws(keys, shape, labeled):
    """The port's draws of the unified pipelines from the JAX per-sample keys
    (the labeled pipeline splits each key in six, the noise-only one in two)."""
    if labeled:
        spec = [("hflip_ab", 0.5, {}), ("vflip_ab", 0.5, {}), ("rot90_ab", 0.5, {}),
                ("noise", 0.3, {}), ("cutout", 0.3, {"size": 4})]
        children = [jax.random.split(k, 6) for k in keys]
    else:
        spec = [("noise", 0.3, {}), ("cutout", 0.3, {"size": 4})]
        children = [jax.random.split(k) for k in keys]
    return [_stack_draws([_jax_draws(kind, ch[i], shape, p, **kw) for ch in children])
            for i, (kind, p, kw) in enumerate(spec)]


@pytest.mark.parametrize("labeled", [True, False], ids=["labeled", "noise_only"])
def test_augmentation_applies_bitwise_on_the_jax_draws(labeled):
    n = 32
    images = np.random.default_rng(6).uniform(size=(n, 16, 16, 1)).astype(np.float32)
    packed = _packed(7, n, pad=0)
    packed[::5, 2:4] = -1  # undefined RECT / AB labels stay -1
    keys = jax.random.split(jax.random.PRNGKey(8 + labeled), n)
    jfn = ju.unified_augment_labeled if labeled else ju.unified_augment_noise_only
    want_x, want_y = jax.vmap(jfn)(keys, jnp.asarray(images), jnp.asarray(packed))
    draws = _unified_draws(keys, images.shape[1:], labeled)
    pipeline = tu.UNIFIED_LABELED if labeled else tu.UNIFIED_NOISE_ONLY
    got_x, got_y = ta.apply_pipeline(pipeline, torch.from_numpy(images),
                                     torch.from_numpy(packed), draws)
    np.testing.assert_array_equal(got_x.numpy(), np.asarray(want_x))
    np.testing.assert_array_equal(got_y.numpy(), np.asarray(want_y))
    np.testing.assert_array_equal(got_y.numpy()[:, 4:], packed[:, 4:])  # teachers untouched
    if labeled:
        assert (got_y.numpy()[:, 2:4] != packed[:, 2:4]).any()
        assert ((packed[:, 2:4] == -1) == (got_y.numpy()[:, 2:4] == -1)).all()
    # the port's own draws run and keep the contract
    aug = tu.unified_augment_labeled if labeled else tu.unified_augment_noise_only
    out_x, out_y = aug(torch.Generator().manual_seed(0), torch.from_numpy(images),
                       torch.from_numpy(packed))
    assert out_x.shape == images.shape and out_y.shape == packed.shape


def test_teacher_logits_equal_the_jax_package():
    calib = images_u16(30, 128, HW)
    port = [seeded_torch_model(cls, 31 + i, calib) for i, cls in enumerate(
        (tm.Stage1Model, tm.Stage2Model, tm.Stage3RectModel, tm.FGVCModel))]
    samples = images_u16(35, 100, HW)
    x = torch.from_numpy(samples.astype(np.float32) / 1023.0)
    with torch.no_grad():
        for m in port:
            assert_input_sensitive(m.eval()(x).numpy(), 1e-4)
    variables = [tm.to_jax_variables(m.state_dict()) for m in port]
    jmodels = JPipelineModels(jm.Stage1Model(), variables[0], jm.Stage2Model(), variables[1],
                              jm.Stage3RectModel(), variables[2], jm.FGVCModel(), variables[3])
    want = ju.compute_teacher_logits(jmodels, samples, batch_size=64)
    got = tu.compute_teacher_logits(PipelineModels(*port), samples, batch_size=64,
                                    device="cpu")
    assert got.shape == want.shape == (100, 10) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5 * np.abs(want).max())


# ---------------------------------------------------------------------------
# One unified train step
# ---------------------------------------------------------------------------


def _capture():
    return optax.GradientTransformation(
        lambda p: jax.tree_util.tree_map(jnp.zeros_like, p),
        lambda g, s, p=None: (jax.tree_util.tree_map(jnp.zeros_like, g), g))


def _identity_dropout(self, inputs, deterministic=None, rng=None):
    return inputs


STEPS = {"hard": 0.0, "distilled": 0.5}


@pytest.fixture(scope="module")
def unified_steps():
    model = cascade_unified_models(40, sizes=(HW,))[HW]
    variables = tm.to_jax_variables(model.state_dict())
    samples = images_u16(41, BATCH, HW)
    out = {"variables": variables, "samples": samples}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(flax.linen.Dropout, "__call__", _identity_dropout)
        for name, weight in STEPS.items():
            packed = _packed(42, BATCH, teachers=weight > 0, pad=1)
            recipe = ju.unified_recipe(S2_COUNTS, AB_COUNTS, epochs=1, distill_weight=weight)
            cfg = jt.StepConfig(loss_fn=recipe.loss_fn, label_key="unified",
                                augment_labeled=recipe.augment_labeled, num_classes=8,
                                predictions_fn=recipe.predictions_fn,
                                metric_labels_fn=recipe.metric_labels_fn)
            step = jt.make_train_step(jm.UnifiedV6Model(), _capture(), cfg)
            rng = jax.random.PRNGKey(43)
            new, metrics = step(jt.TrainState.create(variables, _capture()),
                                {"samples": jnp.asarray(samples),
                                 "unified": jnp.asarray(packed)}, rng)
            out[name] = {"packed": packed, "rng": rng, "loss": float(metrics["loss"]),
                         "confusion": np.asarray(metrics["confusion"]),
                         "grads": jax.tree_util.tree_map(np.asarray, new.opt_state),
                         "stats": jax.tree_util.tree_map(np.asarray, new.batch_stats)}
    return out


@pytest.mark.parametrize("name", sorted(STEPS))
def test_unified_step_matches_jax(unified_steps, name):
    case = unified_steps[name]
    weight = STEPS[name]
    model = tm.load_jax_variables(tm.UnifiedV6Model(), unified_steps["variables"])
    for mod in model.modules():
        if isinstance(mod, nn.Dropout):
            mod.p = 0.0
    recipe = tu.unified_recipe(S2_COUNTS, AB_COUNTS, epochs=1, distill_weight=weight)
    aug_key = jax.random.split(case["rng"], 3)[0]
    draws = _unified_draws(jax.random.split(aug_key, BATCH), (HW, HW, 1), weight == 0)
    pipeline = tu.UNIFIED_NOISE_ONLY if weight > 0 else tu.UNIFIED_LABELED
    cfg = tt.StepConfig(loss_fn=recipe.loss_fn, label_key="unified", num_classes=8,
                        augment_labeled=lambda gen, x, y: ta.apply_pipeline(pipeline, x, y,
                                                                            draws),
                        predictions_fn=recipe.predictions_fn,
                        metric_labels_fn=recipe.metric_labels_fn)
    opt = tsch.as_optimizer(model, tsch.adamw(tsch.cosine_schedule(1e-3, 10)))
    metrics = {}

    def step():
        metrics.update(tt.make_train_step(model, opt, cfg)(
            tt.TrainState(model, opt), {"samples": torch.from_numpy(unified_steps["samples"]),
                                        "unified": torch.from_numpy(case["packed"])},
            torch.Generator().manual_seed(0)))
        return metrics["loss"]

    captured = captured_step(model, opt, step)
    loss, grads = captured["loss"], captured["grads"]
    assert abs(loss - case["loss"]) <= LOSS_RTOL * abs(case["loss"])
    assert float(metrics["confusion"].sum()) == float(case["confusion"].sum())
    want = {k: v.numpy() for k, v in tm.from_jax_variables({"params": case["grads"]}).items()
            if not k.endswith("num_batches_tracked")}
    assert set(want) == set(grads)
    largest = max(float(np.abs(v).max()) for v in want.values())
    for n, g in grads.items():
        scale = max(float(np.abs(want[n]).max()), SMALL_GRAD * largest)
        assert float(np.abs(g.numpy() - want[n]).max()) <= GRAD_TOL * scale, n
    after = model.state_dict()
    for key, ref in tm.from_jax_variables({"batch_stats": case["stats"]}).items():
        if not key.endswith("num_batches_tracked"):
            err = (after[key] - ref).abs().max().item()
            assert err <= STATS_TOL * ref.abs().max().item(), key
