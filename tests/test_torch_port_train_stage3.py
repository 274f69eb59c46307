"""The port's stage-3, FGVC and flatten training against the JAX package's,
on the same numpy-seeded inputs at 8 px.

* ``models.layers.BatchNorm1d`` in train mode against flax's
  ``nn.BatchNorm(momentum=0.9)``, fp32 and bf16: the output, the running mean
  and the running (biased) variance.
* ``center_loss`` and ``init_centers``.
* One FGVC composite step (``train.fgvc_step``: the label-aware AB
  augmentation, CutMix, CE and the center loss) on the JAX step's own draws:
  the loss, its CE and center terms, the gradients of the model and of the
  centers, the BN statistics; then the clipped AdamW over the model and the
  centers on the JAX gradients (one global norm, the centers decayed).
* One train step of every new recipe (stage-3 RECT, AB-FGVC, the AB-ensemble
  member with Mixup, flatten, the v5 AB specialist), augmentation and mixing
  on the JAX draws, each phase's optimizer on the JAX gradients; for the v5
  specialist every frozen parameter bitwise unchanged and without AdamW state.
* ``build_noisy_bundle`` bitwise, and ``prepare_stage3``'s files: the members
  of every npz byte for byte (the zip headers hold the time of writing) and
  ``metadata.json`` byte for byte.

Weights go across through ``models/jax_import``; dropout is off on both sides
(flax's ``Dropout`` monkeypatched to the identity, the port's rates 0).
"""
import copy
import types
import zipfile

import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch import nn

from av1tpu import models as jm
from av1tpu.cli import prepare_stage3 as jax_prepare
from av1tpu.data import bundles as jb
from av1tpu.data import noise as jnoise
from av1tpu.models import fgvc as jfgvc
from av1tpu.train import fgvc_step as jfs
from av1tpu.train import schedules as jsch
from av1tpu.train import stages as jst
from av1tpu.train import trainer as jt
from av1tpu_torch import models as tm
from av1tpu_torch.cli import prepare_stage3
from av1tpu_torch.data import bundles as tb
from av1tpu_torch.data import noise as tnoise
from av1tpu_torch.data.records import BlockSet
from av1tpu_torch.data.synth import synth_blocks
from av1tpu_torch.models import fgvc as tfgvc
from av1tpu_torch.models.layers import BatchNorm1d
from av1tpu_torch.train import augment as ta
from av1tpu_torch.train import fgvc_step as tfs
from av1tpu_torch.train import losses as tl
from av1tpu_torch.train import schedules as tsch
from av1tpu_torch.train import stages as tst
from av1tpu_torch.train import trainer as tt
from chip_smoke import captured_step, set_first_class_share
from tests.test_torch_port_train import PIPELINES, _jax_draws, _stack_draws
from tests.torch_port_fixtures import assert_input_sensitive, images_u16, seeded_torch_model

HW, BATCH = 8, 8
LOSS_RTOL, GRAD_TOL, STATS_TOL, SMALL_GRAD = 1e-5, 1e-4, 1e-5, 0.1
BN_RTOL = 1e-6
# The optimizer on identical gradients (tests/test_torch_port_train.py): each
# tensor within OPT_TOL of its largest entry plus OPTAX_BC2 of the update
OPT_TOL, OPTAX_BC2 = 1e-6, 1e-5


def _capture():
    """An optax transform whose state is the last gradients (updates zero)."""
    return optax.GradientTransformation(
        lambda p: jax.tree_util.tree_map(jnp.zeros_like, p),
        lambda g, s, p=None: (jax.tree_util.tree_map(jnp.zeros_like, g), g))


def _identity_dropout(self, inputs, deterministic=None, rng=None):
    return inputs


def _no_dropout(model):
    for mod in model.modules():
        if isinstance(mod, nn.Dropout):
            mod.p = 0.0
    return model


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


# ---------------------------------------------------------------------------
# BatchNorm1d, the center loss
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_batchnorm1d_train_mode_equals_flax(dtype):
    rng = np.random.default_rng(3)
    x = (rng.normal(size=(32, 16)) * 2 + 0.5).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, 16).astype(np.float32)
    bias = rng.normal(size=16).astype(np.float32)
    mean = rng.normal(size=16).astype(np.float32)
    var = rng.uniform(0.5, 2, 16).astype(np.float32)
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" else (jnp.bfloat16,
                                                                        torch.bfloat16)
    bn = flax.linen.BatchNorm(use_running_average=False, momentum=0.9, dtype=jdt)
    variables = {"params": {"scale": scale, "bias": bias},
                 "batch_stats": {"mean": mean, "var": var}}
    want, upd = bn.apply(variables, jnp.asarray(x, jdt), mutable=["batch_stats"])
    port = BatchNorm1d(16, eps=1e-5)
    port.load_state_dict({"weight": torch.from_numpy(scale), "bias": torch.from_numpy(bias),
                          "running_mean": torch.from_numpy(mean),
                          "running_var": torch.from_numpy(var),
                          "num_batches_tracked": torch.tensor(0)})
    got = port.train()(torch.from_numpy(x).to(tdt))
    assert got.dtype == tdt
    want = np.asarray(want, np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(got.detach().numpy(), want, rtol=BN_RTOL,
                                   atol=BN_RTOL * np.abs(want).max())
    else:  # the same fp32 arithmetic, rounded once to bf16
        np.testing.assert_array_equal(got.detach().float().numpy(), want)
    for leaf, mine in (("mean", port.running_mean), ("var", port.running_var)):
        # the two packages sum the batch in another order: 1 ulp apart at most
        ref = np.asarray(upd["batch_stats"][leaf])
        np.testing.assert_allclose(mine.numpy(), ref, rtol=BN_RTOL,
                                   atol=BN_RTOL * np.abs(ref).max())
    # the biased variance: torch's own BatchNorm1d would move it by n/(n-1)
    torch_bn = nn.BatchNorm1d(16)
    torch_bn.load_state_dict(port.state_dict())
    torch_bn.running_var.copy_(torch.from_numpy(var))
    torch_bn.train()(torch.from_numpy(x))
    assert not np.allclose(torch_bn.running_var.numpy(),
                           np.asarray(upd["batch_stats"]["var"]), rtol=1e-4)
    port.eval()  # eval mode is torch's
    np.testing.assert_array_equal(port(torch.from_numpy(x)).detach().numpy(),
                                  nn.BatchNorm1d.forward(port, torch.from_numpy(x))
                                  .detach().numpy())


def test_center_loss_and_centers_equal_the_jax_package():
    rng = np.random.default_rng(4)
    feats = rng.normal(size=(24, 32)).astype(np.float32)
    labels = rng.integers(0, 4, 24).astype(np.int32)
    centers = rng.normal(size=(4, 32)).astype(np.float32)
    want = jfgvc.center_loss(jnp.asarray(feats), jnp.asarray(labels), jnp.asarray(centers))
    got = tfgvc.center_loss(torch.from_numpy(feats), torch.from_numpy(labels),
                            torch.from_numpy(centers))
    np.testing.assert_allclose(float(got), float(want), rtol=BN_RTOL)
    drawn = tfgvc.init_centers(torch.Generator().manual_seed(0), 4, 512)
    assert drawn.shape == jfgvc.init_centers(jax.random.PRNGKey(0), 4, 512).shape
    assert drawn.dtype == torch.float32
    assert abs(drawn.mean().item()) < 0.05 and abs(drawn.std().item() - 1) < 0.05
    again = tfgvc.init_centers(torch.Generator().manual_seed(0), 4, 512)
    assert torch.equal(drawn, again)


# ---------------------------------------------------------------------------
# The FGVC composite step
# ---------------------------------------------------------------------------


def _seeded(cls, seed):
    return seeded_torch_model(cls, seed, images_u16(seed, 128, HW))


def _batch(seed, classes):
    samples = images_u16(seed, BATCH, HW)
    labels = np.random.default_rng(seed + 1).integers(0, classes, BATCH).astype(np.int32)
    return samples, labels


def _pipeline_draws(stage, keys, shape):
    """The port's draws of one of ``PIPELINES``' stage pipelines, from the
    per-sample keys the JAX pipeline splits."""
    spec = PIPELINES[stage][2]
    children = [jax.random.split(k, len(spec)) for k in keys]
    return [_stack_draws([_jax_draws(kind, ch[i], shape, p, **kw) for ch in children])
            for i, (kind, p, kw) in enumerate(spec)]


def _cutmix_draws(key, n):
    k_apply, k_lam, k_perm, k_cx, k_cy = jax.random.split(key, 5)
    return {"apply": bool(jax.random.uniform(k_apply) < 0.5),
            "lam0": float(jax.random.beta(k_lam, 1.0, 1.0)),
            "cx": int(jax.random.randint(k_cx, (), 0, HW)),
            "cy": int(jax.random.randint(k_cy, (), 0, HW)),
            "perm": torch.from_numpy(np.array(jax.random.permutation(k_perm, n)))}


def _fgvc_rng():
    """The first step key whose CutMix gate opens (the box and the permuted
    center term then take part)."""
    for seed in range(64):
        rng = jax.random.PRNGKey(seed)
        if _cutmix_draws(jax.random.split(rng, 3)[1], BATCH)["apply"]:
            return rng
    raise AssertionError("no key opens the CutMix gate")


@pytest.fixture(scope="module")
def fgvc_case():
    port = _seeded(tm.FGVCModel, 140)
    with torch.no_grad():
        x = torch.from_numpy(images_u16(141, 256, HW).astype(np.float32) / 1023.0)
        assert_input_sensitive(port.eval()(x).numpy(), LOSS_RTOL)
    variables = tm.to_jax_variables(port.state_dict())
    centers = np.random.default_rng(142).normal(size=(4, 512)).astype(np.float32)
    samples, labels = _batch(143, 4)
    rng = _fgvc_rng()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(flax.linen.Dropout, "__call__", _identity_dropout)
        step = jfs.make_fgvc_train_step(jm.FGVCModel(), _capture())
        params = {"model": variables["params"], "centers": jnp.asarray(centers)}
        state = jt.TrainState(step=jnp.zeros((), jnp.int32), params=params,
                              batch_stats=variables["batch_stats"],
                              opt_state=_capture().init(params))
        new, metrics = step(state, {"samples": jnp.asarray(samples),
                                    "stage3_AB": jnp.asarray(labels)}, rng)
    aug_key, cutmix_key, _ = jax.random.split(rng, 3)
    keys = jax.random.split(aug_key, BATCH)
    draws = {"augment": _pipeline_draws("stage3_ab", keys, (HW, HW, 1)),
             "cutmix": _cutmix_draws(cutmix_key, BATCH)}
    return {"variables": variables, "centers": centers, "samples": samples, "labels": labels,
            "draws": draws, "metrics": {k: float(v) for k, v in metrics.items()
                                        if k != "confusion"},
            "confusion": np.asarray(metrics["confusion"]),
            "grads": _np(new.opt_state), "stats": _np(new.batch_stats)}


def _close(got, want, rtol):
    assert abs(got - want) <= rtol * abs(want), (got, want)


def _check_grads(got: dict, want: dict):
    largest = max(float(np.abs(v).max()) for v in want.values())
    for name, ref in want.items():
        scale = max(float(np.abs(ref).max()), SMALL_GRAD * largest)
        err = float(np.abs(got[name] - ref).max())
        assert err <= GRAD_TOL * scale, (name, err, scale)


def _check_stats(model, stats_tree):
    want = tm.from_jax_variables({"batch_stats": stats_tree})
    after = model.state_dict()
    n = 0
    for key, ref in want.items():
        if key.endswith("num_batches_tracked"):
            continue
        err = (after[key] - ref).abs().max().item()
        assert err <= STATS_TOL * ref.abs().max().item(), key
        n += 1
    assert n > 0


def test_fgvc_step_matches_jax(fgvc_case):
    case = fgvc_case
    model = _no_dropout(tm.load_jax_variables(tm.FGVCModel(), case["variables"])).train()
    centers = nn.Parameter(torch.tensor(case["centers"]))
    images = torch.from_numpy(case["samples"].astype(np.float32) / 1023.0)
    total, ce, c_loss, conf = tfs.fgvc_loss(model, centers, images,
                                            torch.from_numpy(case["labels"]).long(),
                                            case["draws"], 0.001, 4)
    want = case["metrics"]
    _close(total.item(), want["loss"], LOSS_RTOL)
    _close(ce.item(), want["ce"], LOSS_RTOL)
    _close(c_loss.item(), want["center"], LOSS_RTOL)
    np.testing.assert_array_equal(conf.numpy(), case["confusion"])
    total.backward()
    grads = {n: p.grad.numpy() for n, p in model.named_parameters()}
    want_grads = {k: v.numpy() for k, v in tm.from_jax_variables(
        {"params": case["grads"]["model"]}).items() if not k.endswith("num_batches_tracked")}
    assert set(grads) == set(want_grads)
    _check_grads({**grads, "centers": centers.grad.numpy()},
                 {**want_grads, "centers": case["grads"]["centers"]})
    _check_stats(model, case["stats"])


def test_fgvc_clipped_adamw_matches_optax_over_model_and_centers(fgvc_case):
    """optax's ``adamw(cosine, grad_clip)`` over ``{"model", "centers"}``
    against one ``TrainOptimizer`` partition over the model's parameters and
    the centers, on the JAX step's gradients: one global norm (the clip set
    to half of it, so that it engages), the decay on the centers too."""
    case = fgvc_case
    grads = case["grads"]
    norm = float(optax.global_norm(grads))
    clip = 0.5 * norm
    params = {"model": case["variables"]["params"], "centers": jnp.asarray(case["centers"])}
    tx = jsch.adamw(jsch.cosine_schedule(1e-3, 10), grad_clip=clip)

    @jax.jit
    def one_step(params, grads):
        updates, _ = tx.update(grads, tx.init(params), params)
        return optax.apply_updates(params, updates)

    want = _np(one_step(params, jax.tree_util.tree_map(jnp.asarray, grads)))
    model = tm.load_jax_variables(tm.FGVCModel(), case["variables"])
    centers = nn.Parameter(torch.tensor(case["centers"]))
    opt = tsch.TrainOptimizer([("all", [*model.parameters(), centers],
                                tsch.adamw(tsch.cosine_schedule(1e-3, 10), grad_clip=clip))])
    port_grads = tm.from_jax_variables({"params": grads["model"]})
    for n, p in model.named_parameters():
        p.grad = port_grads[n].clone()
    centers.grad = torch.tensor(grads["centers"])
    opt.step()
    before = tm.from_jax_variables({"params": case["variables"]["params"]})
    after = tm.from_jax_variables({"params": want["model"]})
    pairs = [(p.detach().numpy(), after[n].numpy(), before[n].numpy())
             for n, p in model.named_parameters()]
    pairs.append((centers.detach().numpy(), want["centers"], case["centers"]))
    for got, ref, start in pairs:
        bound = OPT_TOL * np.abs(ref).max() + OPTAX_BC2 * np.abs(ref - start)
        assert (np.abs(got - ref) <= bound).all()
    # without the decay the centers would move by the Adam update alone
    no_decay = tsch.TrainOptimizer([("all", [nn.Parameter(torch.tensor(case["centers"]))],
                                     tsch.adamw(tsch.cosine_schedule(1e-3, 10), 0.0))])
    no_decay.params[0].grad = torch.tensor(grads["centers"]) * min(1.0, clip / norm)
    no_decay.step()
    assert not np.allclose(no_decay.params[0].detach().numpy(), want["centers"], rtol=0,
                           atol=1e-9)


def test_fgvc_train_step_runs_its_own_draws():
    """``make_fgvc_train_step`` (the draws from the generator) and the eval
    step: finite losses, the confusion over the batch, the state's step."""
    state = tfs.create_fgvc_state(tm.FGVCModel(), tsch.adamw(1e-3, grad_clip=1.0), seed=0,
                                  device="cpu")
    before = state.centers.detach().clone()
    samples, labels = _batch(150, 4)
    batch = {"samples": torch.from_numpy(samples), "stage3_AB": torch.from_numpy(labels)}
    step = tfs.make_fgvc_train_step(state.model, state.optimizer, state.centers)
    metrics = step(state, batch, torch.Generator().manual_seed(1))
    assert state.step == 1 and np.isfinite(float(metrics["loss"]))
    assert float(metrics["confusion"].sum()) == BATCH
    assert not torch.equal(state.centers.detach(), before)
    out = tfs.make_fgvc_eval_step(state.model)(state, batch)
    assert out["logits"].shape == (BATCH, 4) and np.isfinite(float(out["loss"]))


# ---------------------------------------------------------------------------
# One step of every new recipe
# ---------------------------------------------------------------------------


def _spread(head_seq: nn.Sequential, logits: np.ndarray, share: float) -> None:
    """Centre each class's logit on the probe blocks, then shift class 0 to
    ``share`` (a random head takes one decision on every block)."""
    median = np.median(logits, axis=0)
    with torch.no_grad():
        head_seq[-1].bias -= torch.as_tensor(median, dtype=torch.float32)
    set_first_class_share(types.SimpleNamespace(head=head_seq), logits - median, share)


CW2 = np.array([0.7, 1.3], np.float32)
FLAT_COUNTS = [900, 400, 300, 200, 50, 60, 500]
V5_CW = np.array([0.4, 1.6, 1.2, 0.8], np.float32)

# name: (JAX recipe, port recipe, JAX model, port class, label key, classes,
#        augmentation (stage of PIPELINES, "v5_ab" or None), mixup)
RECIPES = {
    "stage3_rect": (lambda: jst.stage3_rect_recipe(CW2, 1, 1),
                    lambda: tst.stage3_rect_recipe(CW2, 1, 1),
                    jm.Stage3RectModel(), tm.Stage3RectModel, "stage3_RECT", 2,
                    "stage3_rect", False),
    "stage3_ab_fgvc": (lambda: jst.stage3_ab_fgvc_recipe(1, 1),
                       lambda: tst.stage3_ab_fgvc_recipe(1, 1),
                       jm.FGVCModel(), tm.FGVCModel, "stage3_AB", 4, "stage3_ab", False),
    "stage3_ab_ensemble": (lambda: jst.stage3_ab_ensemble_recipe(1, freeze_epochs=1,
                                                                 unfreeze_epochs=1),
                           lambda: tst.stage3_ab_ensemble_recipe(1, freeze_epochs=1,
                                                                 unfreeze_epochs=1),
                           jm.Stage3ABModel(), tm.Stage3ABModel, "stage3_AB", 4,
                           "stage3_ab", True),
    "flatten": (lambda: jst.flatten_recipe(FLAT_COUNTS, 1, 1),
                lambda: tst.flatten_recipe(FLAT_COUNTS, 1, 1),
                jm.Stage2FlatModel(), tm.Stage2FlatModel, "flatten", 7, "stage2", False),
    "v5_stage3_AB": (lambda: jst.v5_stage3_recipe("AB", V5_CW, epochs=1),
                     lambda: tst.v5_stage3_recipe("AB", V5_CW, epochs=1),
                     jm.HierarchicalModel(), tm.HierarchicalModel, "stage3_AB", 4, "v5_ab",
                     False),
}


def _guarded_model(name):
    """The recipe's port model, calibrated, its heads spread so that the
    logits the loss reads pass the F2 guard."""
    _, _, _, tcls, _, _, _, _ = RECIPES[name]
    model = _seeded(tcls, 160 + len(name))
    probe = torch.from_numpy(images_u16(161, 256, HW).astype(np.float32) / 1023.0)
    with torch.no_grad():
        out = model.eval()(probe)
    if name == "v5_stage3_AB":
        logits = out.specialists["AB"].numpy()
        _spread(model.specialist_heads["AB"].fc, logits, 0.4)
        with torch.no_grad():
            logits = model(probe).specialists["AB"].numpy()
    elif name == "flatten":
        _spread(model.head.head, out.numpy(), 0.3)
        with torch.no_grad():
            logits = model(probe).numpy()
    else:
        logits = out.numpy()
    assert_input_sensitive(logits, LOSS_RTOL)
    return model


def _step_draws(name, rng):
    """The JAX step's draws from ``rng``: the per-sample augmentation's and
    Mixup's, as the port's draw dicts."""
    aug = RECIPES[name][6]
    aug_key, _, mix_key = jax.random.split(rng, 3)
    keys = jax.random.split(aug_key, BATCH)
    if aug == "v5_ab":
        pairs = [jax.random.split(k) for k in keys]
        draws = [{"flip": torch.tensor([float(jax.random.uniform(a)) < 0.5 for a, _ in pairs]),
                  "rot": torch.tensor([float(jax.random.uniform(b)) < 0.5 for _, b in pairs])}]
    else:
        draws = _pipeline_draws(aug, keys, (HW, HW, 1))
    mix = None
    if RECIPES[name][7]:
        key_lam, key_perm = jax.random.split(mix_key)
        mix = (torch.from_numpy(np.array(jax.random.permutation(key_perm, BATCH))),
               float(jax.random.beta(key_lam, 0.4, 0.4)))
    return draws, mix


@pytest.fixture(scope="module")
def recipe_steps():
    """Per recipe: the carried variables, the batch and the JAX step's loss,
    gradients and BN statistics (one compile each, dropout off)."""
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(flax.linen.Dropout, "__call__", _identity_dropout)
        for name, (jrec_fn, _, jmodel, _, key, classes, _, _) in RECIPES.items():
            variables = tm.to_jax_variables(_guarded_model(name).state_dict())
            jrec = jrec_fn()
            samples, labels = _batch(170 + len(name), classes)
            cfg = jt.StepConfig(loss_fn=jrec.loss_fn, label_key=key, augment=jrec.augment,
                                augment_labeled=jrec.augment_labeled, num_classes=classes,
                                logits_fn=jrec.logits_fn, batch_mix=jrec.batch_mix)
            step = jt.make_train_step(jmodel, _capture(), cfg)
            rng = jax.random.PRNGKey(len(name))
            new, metrics = step(jt.TrainState.create(variables, _capture()),
                                {"samples": jnp.asarray(samples), key: jnp.asarray(labels)},
                                rng)
            out[name] = {"variables": variables, "samples": samples, "labels": labels,
                         "rng": rng, "loss": float(metrics["loss"]),
                         "grads": _np(new.opt_state), "stats": _np(new.batch_stats),
                         "recipe": jrec}
    return out


def _port_recipe_step(name, case, phase):
    """The port recipe's step on the JAX draws with the phase's optimizer:
    the model after it, the state before, the optimizer, the loss and the
    gradients it was given."""
    _, trec_fn, _, tcls, key, classes, aug, _ = RECIPES[name]
    trec = trec_fn()
    model = _no_dropout(tm.load_jax_variables(tcls(), case["variables"]))
    before = copy.deepcopy(model.state_dict())
    opt = tst._phase_optimizer(trec.phases[phase], model, 10)
    draws, mix = _step_draws(name, case["rng"])
    pipeline = {"v5_ab": ta.V5_STAGE3_AB}.get(aug) or PIPELINES[aug][1]
    augment = augment_labeled = batch_mix = None
    if trec.augment_labeled is not None:
        augment_labeled = lambda gen, x, y: ta.apply_pipeline(pipeline, x, y, draws)
    else:
        augment = lambda gen, x: ta.apply_pipeline(pipeline, x, None, draws)[0]
    if mix is not None:
        assert trec.batch_mix is not None
        batch_mix = lambda gen, x: (tl.mixup_apply(x, *mix), *mix)
    cfg = tt.StepConfig(loss_fn=trec.loss_fn, label_key=key, augment=augment,
                        augment_labeled=augment_labeled, num_classes=classes,
                        logits_fn=trec.logits_fn, batch_mix=batch_mix)
    step = captured_step(model, opt, lambda: tt.make_train_step(model, opt, cfg)(
        tt.TrainState(model, opt), {"samples": torch.from_numpy(case["samples"]),
                                    key: torch.from_numpy(case["labels"])},
        torch.Generator().manual_seed(0))["loss"])
    return model, before, opt, step["loss"], step["grads"]


PHASES = [(name, i) for name in RECIPES for i in range(len(RECIPES[name][1]().phases))]


@pytest.mark.parametrize("name, phase", PHASES, ids=[f"{n}-{i}" for n, i in PHASES])
def test_recipe_step_matches_jax(recipe_steps, name, phase):
    case = recipe_steps[name]
    model, before, opt, loss, grads = _port_recipe_step(name, case, phase)
    _close(loss, case["loss"], LOSS_RTOL)
    want = {k: v.numpy() for k, v in tm.from_jax_variables({"params": case["grads"]}).items()}
    trainable = {n for n, p in model.named_parameters() if any(p is q for q in opt.params)}
    assert set(grads) == trainable and trainable
    largest = max(float(np.abs(v).max()) for v in want.values())
    for n, g in grads.items():
        scale = max(float(np.abs(want[n]).max()), SMALL_GRAD * largest)
        assert float(np.abs(g.numpy() - want[n]).max()) <= GRAD_TOL * scale, n
    _check_stats(model, case["stats"])
    state = opt.adamw.state if opt.adamw is not None else {}
    for n, p in model.named_parameters():
        if n not in trainable:  # frozen: no update, no decay, no AdamW state
            assert torch.equal(p, before[n]), n
            assert p not in state, n
    if name == "v5_stage3_AB":
        assert trainable == {n for n, _ in model.named_parameters()
                             if n.startswith("specialist_heads.AB.")}


@pytest.mark.parametrize("name, phase", PHASES, ids=[f"{n}-{i}" for n, i in PHASES])
def test_recipe_optimizer_matches_optax(recipe_steps, name, phase):
    """The phase's optimizer on the JAX step's gradients: every parameter
    within the optimizer tolerance of optax's, the frozen ones bitwise
    unchanged (several steps on a small model: tests/test_torch_port_train.py)."""
    case = recipe_steps[name]
    _, trec_fn, _, tcls, _, _, _, _ = RECIPES[name]
    params = case["variables"]["params"]
    tx = jst._phase_optimizer(case["recipe"].phases[phase], params, 10)

    @jax.jit
    def one_step(params, grads):
        updates, _ = tx.update(grads, tx.init(params), params)
        return optax.apply_updates(params, updates)

    jparams = one_step(jax.tree_util.tree_map(jnp.asarray, params),
                       jax.tree_util.tree_map(jnp.asarray, case["grads"]))
    model = tm.load_jax_variables(tcls(), case["variables"])
    opt = tst._phase_optimizer(trec_fn().phases[phase], model, 10)
    port_grads = tm.from_jax_variables({"params": case["grads"]})
    for n, p in model.named_parameters():
        p.grad = port_grads[n].clone()
    opt.step()
    want = tm.from_jax_variables({"params": _np(jparams)})
    start = tm.from_jax_variables({"params": params})
    moved = 0
    for n, p in model.named_parameters():
        got, ref, s = p.detach().numpy(), want[n].numpy(), start[n].numpy()
        if not any(p is q for q in opt.params):
            np.testing.assert_array_equal(got, s)
            np.testing.assert_array_equal(ref, s)
            continue
        bound = OPT_TOL * np.abs(ref).max() + OPTAX_BC2 * np.abs(ref - s)
        assert (np.abs(got - ref) <= bound).all(), n
        moved += 1
    assert moved > 0


def test_v5_ab_augment_equals_the_jax_recipe_augment():
    """The v5 AB flips on the JAX recipe's own draws, bitwise, labels too."""
    jaug = jst.v5_stage3_recipe("AB", V5_CW).augment_labeled
    rng = np.random.default_rng(5)
    images = rng.uniform(size=(24, HW, HW, 1)).astype(np.float32)
    labels = rng.integers(0, 4, 24).astype(np.int32)
    keys = jax.random.split(jax.random.PRNGKey(9), 24)
    want_x, want_y = jax.vmap(jaug)(keys, jnp.asarray(images), jnp.asarray(labels))
    pairs = [jax.random.split(k) for k in keys]
    draws = {"flip": torch.tensor([float(jax.random.uniform(a)) < 0.5 for a, _ in pairs]),
             "rot": torch.tensor([float(jax.random.uniform(b)) < 0.5 for _, b in pairs])}
    assert 0 < int(draws["flip"].sum()) < 24 and 0 < int(draws["rot"].sum()) < 24
    got_x, got_y = ta.apply_pipeline(ta.V5_STAGE3_AB, torch.from_numpy(images),
                                     torch.from_numpy(labels), [draws])
    np.testing.assert_array_equal(got_x.numpy(), np.asarray(want_x))
    np.testing.assert_array_equal(got_y.numpy(), np.asarray(want_y))


# ---------------------------------------------------------------------------
# Noise injection and prepare_stage3: bitwise
# ---------------------------------------------------------------------------


def _v6_pair(seed, n):
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, 8, n).astype(np.int32)  # synth_blocks' eight classes
    port = tb.build_v6_bundle(BlockSet(samples=synth_blocks(labels, rng, size=HW),
                                       labels=labels, qps=rng.integers(20, 200, n)
                                       .astype(np.int32)))
    return port, jb.Bundle(samples=port.samples, qps=port.qps, labels=dict(port.labels))


def _same_bundle(got, want):
    for a, b in ((got.samples, want.samples), (got.qps, want.qps)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert sorted(got.labels) == sorted(want.labels)
    for k in want.labels:
        assert got.labels[k].dtype == want.labels[k].dtype
        np.testing.assert_array_equal(got.labels[k], want.labels[k])


@pytest.mark.parametrize("dist", [None, [0.7, 0.3]], ids=["uniform", "distribution"])
def test_noisy_bundle_equals_the_jax_package(dist):
    port, jax_b = _v6_pair(30, 400)
    clean_t, clean_j = tb.filter_stage3(port, "RECT"), jb.filter_stage3(jax_b, "RECT")
    sources_t = [tb.filter_stage3(port, "AB"), port.take(np.flatnonzero(
        port.labels["stage2"] == 0))]
    sources_j = [jb.Bundle(samples=s.samples, qps=s.qps, labels=dict(s.labels))
                 for s in sources_t]
    kw = dict(label_key="stage3_RECT", num_label_classes=2, noise_ratio=0.25, seed=7,
              label_distribution=None if dist is None else np.array(dist))
    got = tnoise.build_noisy_bundle(clean_t, sources_t, **kw)
    want = jnoise.build_noisy_bundle(clean_j, sources_j, **kw)
    _same_bundle(got, want)
    assert len(got) == len(clean_t)
    with pytest.raises(ValueError):
        tnoise.build_noisy_bundle(clean_t, sources_t, **{**kw, "noise_ratio": 1.0})


def _npz_members(path):
    with zipfile.ZipFile(path) as z:
        return {name: z.read(name) for name in sorted(z.namelist())}


def test_prepare_stage3_writes_the_jax_files(tmp_path):
    port, jax_b = _v6_pair(31, 600)
    val_port, _ = _v6_pair(32, 200)
    tb.save_split(tmp_path / "data", HW, port, val_port, "v6")
    args = ["--dataset-dir", str(tmp_path / "data"), "--block-size", str(HW),
            "--ensemble-members", "2", "--seed", "5"]
    prepare_stage3.main([*args, "--out", str(tmp_path / "port")])
    jax_prepare.main([*args, "--out", str(tmp_path / "jax")])
    files = sorted(p.relative_to(tmp_path / "jax") for p in (tmp_path / "jax").rglob("*")
                   if p.is_file())
    assert files == sorted(p.relative_to(tmp_path / "port")
                           for p in (tmp_path / "port").rglob("*") if p.is_file())
    assert {f.name for f in files} == {"train.npz", "train_v1.npz", "train_v2.npz", "val.npz",
                                       "metadata.json"}
    for f in files:
        mine, theirs = tmp_path / "port" / f, tmp_path / "jax" / f
        if f.suffix == ".json":
            assert mine.read_bytes() == theirs.read_bytes()
        else:
            assert _npz_members(mine) == _npz_members(theirs), f
    assert prepare_stage3.parse_factor_map("1:5,2:5") == jax_prepare.parse_factor_map("1:5,2:5")
