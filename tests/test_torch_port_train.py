"""The port's training building blocks against the JAX package's, on the same
numpy-seeded inputs: the data layer (sampling, records, bundles, the
synthetic corpus) bitwise; every loss within rtol 1e-6; every schedule's lr
within 1e-7; AdamW and both ULMFiT phases over three steps on identical
parameters and identical given gradients within 1e-6 of each tensor's
largest entry plus 1e-5 of the update (optax's float32 bias correction;
see OPTAX_BC2) (a head gradient
large enough to be clipped; frozen parameters bitwise unchanged); the
augmentations bitwise on the JAX package's own draws at p = 0 and p = 1 and
through every stage pipeline, and the port's draws by rate and range.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch import nn

from av1tpu.data import bundles as jb
from av1tpu.data import records as jr
from av1tpu.data import sampling as js
from av1tpu.data import synth as jsy
from av1tpu.train import augment as ja
from av1tpu.train import losses as jl
from av1tpu.train import schedules as jsch
from av1tpu_torch.data import bundles as tb
from av1tpu_torch.data import records as tr
from av1tpu_torch.data import sampling as ts
from av1tpu_torch.data import synth as tsy
from av1tpu_torch.train import augment as ta
from av1tpu_torch.train import losses as tl
from av1tpu_torch.train import schedules as tsch

torch.set_num_threads(1)


def _same(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def _record(seed, n=96, bs=8):
    rng = np.random.default_rng(seed)
    return dict(samples=rng.integers(0, 1024, size=(n, bs, bs, 1), dtype=np.uint16),
                labels=rng.integers(0, 10, size=n).astype(np.int32),
                qps=rng.integers(20, 200, size=n).astype(np.int32))


# ---------------------------------------------------------------------------
# Data: bitwise
# ---------------------------------------------------------------------------

def test_sampling_equals_the_jax_package():
    labels = np.random.default_rng(1).choice(4, size=500, p=[0.6, 0.25, 0.1, 0.05])
    for seed in (0, 7, 42):
        _same(ts.balanced_epoch_indices(labels, seed), js.balanced_epoch_indices(labels, seed))
        _same(ts.balanced_epoch_indices(labels, seed, num_samples=123,
                                        oversample_factor={1: 3.0, 3: 5.0}),
              js.balanced_epoch_indices(labels, seed, num_samples=123,
                                        oversample_factor={1: 3.0, 3: 5.0}))
        _same(ts.shuffled_epoch_indices(500, seed), js.shuffled_epoch_indices(500, seed))
    cw = np.array([0.5, 1.0, 2.0, 4.0], np.float32)
    for kw in ({}, {"class_weights": cw}, {"oversample_factor": {2: 4.0}}, {"beta": 0.999}):
        _same(ts.sample_weights_from_labels(labels, **kw),
              js.sample_weights_from_labels(labels, **kw))
    counts = np.array([0, 5, 500, 20000])
    _same(ts.effective_number_weights(counts, 0.9999),
          js.effective_number_weights(counts, 0.9999))
    _same(ts.inverse_frequency_weights(counts[1:]), js.inverse_frequency_weights(counts[1:]))
    _same(ts.oversample_indices(labels, {1: 2, 3: 5}), js.oversample_indices(labels, {1: 2, 3: 5}))
    order = js.shuffled_epoch_indices(103, 3)
    for index in range(4):
        _same(ts.host_shard(order, index, 4), js.host_shard(order, index, 4))


def _as_jax_bundle(b):
    return jb.Bundle(samples=b.samples, qps=b.qps, labels=dict(b.labels))


def _same_bundle(got, want):
    _same(got.samples, want.samples)
    _same(got.qps, want.qps)
    assert sorted(got.labels) == sorted(want.labels)
    for key in want.labels:
        _same(got.labels[key], want.labels[key])


def test_records_and_bundles_equal_the_jax_package():
    rec = _record(2)
    t_rec, j_rec = tr.BlockSet(**rec), jr.BlockSet(**rec)
    for got, want in zip(tr.train_test_split(t_rec, 0.25, 5), jr.train_test_split(j_rec, 0.25, 5)):
        _same(got.samples, want.samples)
        _same(got.labels, want.labels)
        _same(got.qps, want.qps)
    cat = t_rec.concat(t_rec.take(np.arange(5)))
    assert len(cat) == 101 and cat.block_size == 8
    _same(tr.normalize_images(rec["samples"]), jr.normalize_images(rec["samples"]))
    for build in ("build_v5_bundle", "build_v6_bundle", "build_flatten_bundle"):
        _same_bundle(getattr(tb, build)(t_rec), getattr(jb, build)(j_rec))
    v6_t, v6_j = tb.build_v6_bundle(t_rec), jb.build_v6_bundle(j_rec)
    _same_bundle(tb.filter_partitioned_only(v6_t), jb.filter_partitioned_only(v6_j))
    for head in ("RECT", "AB"):
        _same_bundle(tb.filter_stage3(v6_t, head), jb.filter_stage3(v6_j, head))
    ab_t, ab_j = tb.filter_stage3(v6_t, "AB"), jb.filter_stage3(v6_j, "AB")
    _same_bundle(tb.oversample_ab(ab_t, {1: 5, 2: 5}), jb.oversample_ab(ab_j, {1: 5, 2: 5}))
    for got, want in zip(tb.ensemble_shuffles(ab_t, 3, 11), jb.ensemble_shuffles(ab_j, 3, 11)):
        _same_bundle(got, want)
    assert tb.class_counts(v6_t.labels["stage2"], 3) == jb.class_counts(v6_j.labels["stage2"], 3)
    with pytest.raises(ValueError):
        tb.filter_stage3(v6_t, "1TO4")


def test_synthetic_corpus_equals_the_jax_package():
    _same(tsy.class_templates(16), jsy.class_templates(16))
    labels = np.random.default_rng(3).integers(0, 8, size=200)
    _same(tsy.synth_blocks(labels, np.random.default_rng(4), size=16),
          jsy.synth_blocks(labels, np.random.default_rng(4), size=16))
    _same(tsy.synth_blocks(labels, np.random.default_rng(4), size=8, contrast=None,
                           mix_prob=0.0),
          jsy.synth_blocks(labels, np.random.default_rng(4), size=8, contrast=None,
                           mix_prob=0.0))
    for got, want in zip(tsy.reference_shaped_corpus(5, size=16, scale=0.02),
                         jsy.reference_shaped_corpus(5, size=16, scale=0.02)):
        _same(got.samples, want.samples)
        _same(got.labels, want.labels)
        _same(got.qps, want.qps)


# ---------------------------------------------------------------------------
# Losses: rtol 1e-6
# ---------------------------------------------------------------------------

LOSS_RTOL = 1e-6


def _logits_targets(seed, n=64, c=3, pad=True):
    rng = np.random.default_rng(seed)
    logits = (rng.normal(size=(n, c)) * 3).astype(np.float32)
    targets = rng.integers(0, c if c > 1 else 2, size=n).astype(np.int32)
    if pad:
        targets[-5:] = -1  # eval padding rows
    if c == 1:
        logits = logits[:, 0]
    return logits, targets


def _close(got, want, rtol=LOSS_RTOL):
    np.testing.assert_allclose(np.asarray(got.detach() if isinstance(got, torch.Tensor)
                                          else got, np.float64),
                               np.asarray(want, np.float64), rtol=rtol, atol=1e-7)


CASES = {
    "binary_focal": (1, lambda m, lo, ta: m.binary_focal_loss(lo, ta, 0.25, 2.5)),
    "binary_focal_none": (1, lambda m, lo, ta: m.binary_focal_loss(lo, ta, 0.4, 2.0, "none")),
    "multiclass_focal": (4, lambda m, lo, ta: m.multiclass_focal_loss(lo, ta, 2.0)),
    "class_balanced_focal": (3, lambda m, lo, ta: m.class_balanced_focal_loss(
        lo, ta, [23942, 71378, 57280], 0.9999, 2.0)),
    "cb_focal_empty_class": (3, lambda m, lo, ta: m.class_balanced_focal_loss(
        lo, ta, [0, 10, 1000], 0.999, 2.0, "sum")),
    "ce_smoothing": (5, lambda m, lo, ta: m.weighted_ce_label_smoothing(lo, ta, None, 0.1)),
    "ce_weighted": (2, lambda m, lo, ta: m.weighted_ce_label_smoothing(
        lo, ta, np.array([0.3, 1.7], np.float32), 0.05)),
    "v5_focal_bce": (1, lambda m, lo, ta: m.stage1_focal_bce_v5(lo, ta, 2.0, 0.0)),
    "v5_focal_bce_gamma": (1, lambda m, lo, ta: m.stage1_focal_bce_v5(lo, ta, 1.5, 2.0)),
    "masked_mean": (1, lambda m, lo, ta: m.masked_mean(lo, ta >= 0)),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_loss_equals_the_jax_package(name):
    c, fn = CASES[name]
    logits, targets = _logits_targets(len(name), c=c)
    want = fn(jl, jnp.asarray(logits), jnp.asarray(targets))
    got = fn(tl, torch.from_numpy(logits), torch.from_numpy(targets))
    _close(got, want)


@pytest.mark.parametrize("stage", ["stage1", "stage1_hard", "stage2", "stage3_rect", "stage3_ab"])
def test_get_loss_function_equals_the_jax_package(stage):
    c = {"stage1": 1, "stage1_hard": 1, "stage2": 3, "stage3_rect": 2, "stage3_ab": 4}[stage]
    cfg = {"hard_mining": True, "neg_pos_ratio": 2.0} if stage == "stage1_hard" else None
    name = "stage1" if stage == "stage1_hard" else stage
    logits, targets = _logits_targets(9, c=c, pad=stage != "stage1_hard")
    want = jl.get_loss_function(name, cfg)(jnp.asarray(logits), jnp.asarray(targets))
    got = tl.get_loss_function(name, cfg)(torch.from_numpy(logits), torch.from_numpy(targets))
    _close(got, want)
    with pytest.raises(ValueError):
        tl.get_loss_function("stage4")


@pytest.mark.parametrize("base", ["focal", "bce"])
def test_hard_negative_mining_keeps_the_lower_index_among_ties(base):
    """4 positives at ratio 1.5 keep 6 negatives; negatives 4..11 tie at the
    cut. The kept ones are the first six by a stable sort, so the gradient
    (which sample gets one) equals the JAX package's."""
    logits = np.concatenate([np.full(4, 2.0), [3.0, 2.5, 0.7, 0.7, 0.7, 0.7, 0.7, 0.7],
                             np.linspace(-3, -1, 8)]).astype(np.float32)
    targets = np.array([1] * 4 + [0] * 16, np.int32)
    jfn = lambda lo: jl.hard_negative_mining_loss(lo, jnp.asarray(targets), 1.5, base)
    want, want_grad = jax.value_and_grad(jfn)(jnp.asarray(logits))
    x = torch.from_numpy(logits).requires_grad_(True)
    got = tl.hard_negative_mining_loss(x, torch.from_numpy(targets), 1.5, base)
    got.backward()
    _close(got, want)
    _close(x.grad, want_grad)
    kept = np.flatnonzero(np.asarray(want_grad) != 0)
    assert list(kept) == [0, 1, 2, 3, 4, 5, 6, 7, 8, 9]


def test_mixup_and_cutmix_apply_equal_the_jax_package_on_its_draws():
    rng = np.random.default_rng(12)
    images = rng.uniform(size=(16, 8, 8, 1)).astype(np.float32)
    labels = rng.integers(0, 4, size=16).astype(np.int32)
    logits = rng.normal(size=(16, 4)).astype(np.float32)
    loss = lambda m: (lambda lo, ta: m.multiclass_focal_loss(lo, ta, 2.0))
    mixed, perm, lam = jl.mixup_batch(jax.random.PRNGKey(3), jnp.asarray(images), 0.4)
    perm = torch.from_numpy(np.array(perm))
    got = tl.mixup_apply(torch.from_numpy(images), perm, float(lam))
    _close(got, mixed)
    _close(tl.mixed_loss(loss(tl), torch.from_numpy(logits), torch.from_numpy(labels),
                         perm, float(lam)),
           jl.mixed_loss(loss(jl), jnp.asarray(logits), jnp.asarray(labels),
                         jnp.asarray(perm.numpy()), lam))
    for seed in range(6):
        key = jax.random.PRNGKey(seed)
        want_x, want_perm, want_lam = jl.cutmix_batch(key, jnp.asarray(images), 1.0, 0.5)
        k_apply, k_lam, k_perm, k_cx, k_cy = jax.random.split(key, 5)
        draws = {"apply": bool(jax.random.uniform(k_apply) < 0.5),
                 "lam0": float(jax.random.beta(k_lam, 1.0, 1.0)),
                 "cx": int(jax.random.randint(k_cx, (), 0, 8)),
                 "cy": int(jax.random.randint(k_cy, (), 0, 8)),
                 "perm": torch.from_numpy(np.array(jax.random.permutation(k_perm, 16)))}
        got_x, got_perm, got_lam = tl.cutmix_apply(torch.from_numpy(images), draws)
        _same(got_x.numpy(), np.asarray(want_x))
        _same(got_perm.numpy().astype(np.int64), np.asarray(want_perm).astype(np.int64))
        _close(got_lam, want_lam)
    gen = torch.Generator().manual_seed(0)
    out, perm, lam = tl.cutmix_batch(gen, torch.from_numpy(images))
    assert out.shape == images.shape and sorted(perm.tolist()) == list(range(16))
    assert 0.0 <= lam <= 1.0
    _, perm, lam = tl.mixup_batch(gen, torch.from_numpy(images), 0.4)
    assert sorted(perm.tolist()) == list(range(16)) and 0.0 <= lam <= 1.0


# ---------------------------------------------------------------------------
# Schedules and the optimizer
# ---------------------------------------------------------------------------

SCHEDULES = {
    "cosine": (lambda m: m.cosine_schedule(1e-3, 37), 45),
    "cosine_one_step": (lambda m: m.cosine_schedule(5e-4, 0), 3),
    "warmup_cosine": (lambda m: m.cosine_schedule(5e-4, 40, 7), 45),
    "onecycle": (lambda m: m.onecycle_schedule(1e-3, 50), 55),
    "onecycle_short": (lambda m: m.onecycle_schedule(3e-3, 7, 0.5), 10),
}


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_schedule_equals_optax(name):
    make, steps = SCHEDULES[name]
    want, got = make(jsch), make(tsch)
    for k in range(steps):
        assert abs(float(want(k)) - got(k)) <= 1e-7, (k, float(want(k)), got(k))


class TwoPart(nn.Module):
    """A backbone (conv + its BN) and a two-layer head: the top-level names
    the ULMFiT partitions label."""

    def __init__(self):
        super().__init__()
        self.backbone = nn.Sequential(nn.Conv2d(1, 4, 3, bias=False), nn.BatchNorm2d(4))
        self.head = nn.Sequential(nn.Linear(4, 6), nn.ReLU(), nn.Linear(6, 2))


def _jax_tree(named):
    """{top-level name: {rest of the name: array}}: the same top-level keys,
    so optax labels its partitions as the port does."""
    tree = {}
    for name, value in named.items():
        top, rest = name.split(".", 1)
        tree.setdefault(top, {})[rest] = jnp.asarray(value)
    return tree


OPTIMIZERS = {
    # name: (JAX transform of params, port optimizer of the model, clipped partition)
    "adamw": (lambda p: jsch.adamw(jsch.cosine_schedule(1e-2, 5), 1e-2),
              lambda m: tsch.as_optimizer(m, tsch.adamw(tsch.cosine_schedule(1e-2, 5), 1e-2))),
    "adamw_clipped": (lambda p: jsch.adamw(1e-3, 0.05, grad_clip=1.0),
                      lambda m: tsch.as_optimizer(m, tsch.adamw(1e-3, 0.05, grad_clip=1.0))),
    "ulmfit_phase1": (lambda p: jsch.ulmfit_phase1(p, 5e-3, 4),
                      lambda m: tsch.ulmfit_phase1(m, 5e-3, 4)),
    "ulmfit_phase2": (lambda p: jsch.ulmfit_phase2(p, 5e-3, 1e-3, 4),
                      lambda m: tsch.ulmfit_phase2(m, 5e-3, 1e-3, 4)),
    "onecycle_no_clip": (lambda p: jsch.ulmfit_phase2(p, 1e-2, 1e-4, 6, grad_clip=None),
                         lambda m: tsch.ulmfit_phase2(m, 1e-2, 1e-4, 6, grad_clip=None)),
}


# Parameters agree within OPT_TOL of the tensor's largest entry (torch's AdamW
# decays, lerps and divides in another order than optax: a few ulps) plus
# OPTAX_BC2 of the update: optax takes the bias correction 1 - b2^t in float32
# with b2 = 0.999 rounded to float32, 1.3e-5 below the exact value at small t,
# which shrinks its updates by up to 6.4e-6 against torch's float64 one.
OPT_TOL = 1e-6
OPTAX_BC2 = 1e-5


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_optimizer_steps_equal_optax_on_given_gradients(name):
    """Three steps from identical parameters with identical gradients; the
    head's gradients are large enough that the head partition is clipped
    (by its own norm; the backbone's stays under 1)."""
    make_jax, make_port = OPTIMIZERS[name]
    torch.manual_seed(0)
    model = TwoPart()
    named = {n: p.detach().numpy().copy() for n, p in model.named_parameters()}
    rng = np.random.default_rng(5)
    grads = [{n: (rng.normal(size=v.shape) * (3.0 if n.startswith("head") else 0.05))
              .astype(np.float32) for n, v in named.items()} for _ in range(3)]
    head_norm = math.sqrt(sum(float((g ** 2).sum()) for n, g in grads[0].items()
                              if n.startswith("head")))
    assert head_norm > 1.0  # the clip engages on the head partition

    params = _jax_tree(named)
    tx = make_jax(params)
    opt_state = tx.init(params)
    for g in grads:
        updates, opt_state = tx.update(_jax_tree(g), opt_state, params)
        params = optax.apply_updates(params, updates)

    opt = make_port(model)
    for g in grads:
        for n, p in model.named_parameters():
            p.grad = torch.from_numpy(g[n].copy())
        opt.step()
    assert opt.count == 3
    frozen = name == "ulmfit_phase1"
    for n, p in model.named_parameters():
        top, rest = n.split(".", 1)
        want = np.asarray(params[top][rest])
        if frozen and top == "backbone":
            _same(p.detach().numpy(), named[n])  # no update, no decay
            _same(want, named[n])
            assert all(p is not q for q in opt.params)  # no optimizer state
        else:
            got = p.detach().numpy()
            bound = OPT_TOL * np.abs(want).max() + OPTAX_BC2 * np.abs(want - named[n])
            assert (np.abs(got - want) <= bound).all(), n
            assert not np.array_equal(got, named[n])


def test_optimizer_labels_and_lr_follow_the_schedule():
    model = TwoPart()
    labels = tsch.label_params_by_prefix(model, {"backbone": "frozen"})
    assert set(labels.values()) == {"frozen", "head"}
    assert all(lab == "frozen" for n, lab in labels.items() if n.startswith("backbone"))
    with pytest.raises(ValueError):
        tsch.partitioned_optimizer(model, {"head": tsch.adamw(1e-3)}, {"backbone": "frozen"})
    opt = tsch.ulmfit_phase2(model, 5e-4, 1e-6, 10)
    sched = {"backbone": jsch.cosine_schedule(1e-6, 10), "head": jsch.cosine_schedule(5e-4, 10)}
    for k in range(4):
        for p in model.parameters():
            p.grad = torch.ones_like(p)
        opt.step()
        for label, group in zip(opt.labels, opt.adamw.param_groups):
            assert abs(group["lr"] - float(sched[label](k))) <= 1e-7
    # a new phase restarts its schedule from step 0
    restart = tsch.ulmfit_phase2(model, 5e-4, 1e-6, 10)
    assert restart.count == 0
    state = opt.state_dict()
    restart.load_state_dict(state)
    assert restart.count == 4


# ---------------------------------------------------------------------------
# Augmentations
# ---------------------------------------------------------------------------

N_AUG = 24


def _images(seed, hw=16):
    rng = np.random.default_rng(seed)
    return rng.uniform(size=(N_AUG, hw, hw, 1)).astype(np.float32)


def _keys(seed):
    return jax.random.split(jax.random.PRNGKey(seed), N_AUG)


def _u(key):
    return float(jax.random.uniform(key))


def _ri(key, hi):
    return int(jax.random.randint(key, (), 0, hi))


def _jax_draws(kind, key, shape, p, **kw):
    """The per-sample draws the JAX transform ``kind`` takes from ``key``
    (its own split of the key), as the port's draw dict of one sample."""
    h, w = shape[0], shape[1]
    if kind in ("hflip", "vflip", "hflip_ab", "vflip_ab"):
        return {"apply": _u(key) < p}
    k_apply, k_other = jax.random.split(key)[:2]
    if kind == "rot90":
        return {"apply": _u(k_apply) < p, "k": _ri(k_other, 4)}
    if kind == "rot90_ab":
        return {"apply": _u(k_apply) < p, "use_270": bool(jax.random.bernoulli(k_other))}
    if kind == "noise":
        return {"apply": _u(k_apply) < p,
                "z": np.asarray(jax.random.normal(k_other, shape, jnp.float32))}
    if kind == "grid_shuffle":
        return {"apply": _u(k_apply) < p,
                "perm": np.asarray(jax.random.permutation(k_other, kw["g"] ** 2))}
    if kind == "cutout":
        k_apply, k_x, k_y = jax.random.split(key, 3)
        size = kw["size"]
        return {"apply": _u(k_apply) < p, "x0": _ri(k_x, max(1, w - size + 1)),
                "y0": _ri(k_y, max(1, h - size + 1))}
    if kind == "coarse_dropout":
        k_apply, *holes = jax.random.split(key, kw["holes"] + 1)
        size = kw["size"]
        xy = [jax.random.split(hk) for hk in holes]
        return {"apply": _u(k_apply) < p,
                "x0": [_ri(kx, max(1, w - size + 1)) for kx, _ in xy],
                "y0": [_ri(ky, max(1, h - size + 1)) for _, ky in xy]}
    raise KeyError(kind)


def _stack_draws(per_sample):
    """A list of one-sample draw dicts -> the port's batched draw dict."""
    out = {}
    for name in per_sample[0]:
        vals = np.array([d[name] for d in per_sample])
        if name in ("x0", "y0") and vals.ndim == 2:  # coarse dropout: (holes, n)
            vals = vals.T
        out[name] = torch.from_numpy(vals)
    return out


# kind: (JAX single-image transform at p, port transform at p, keyword args)
TRANSFORMS = {
    "hflip": (lambda p, kw: lambda k, x: ja.random_hflip(k, x, p),
              lambda p, kw: ta.random_hflip(p), {}),
    "vflip": (lambda p, kw: lambda k, x: ja.random_vflip(k, x, p),
              lambda p, kw: ta.random_vflip(p), {}),
    "rot90": (lambda p, kw: lambda k, x: ja.random_rot90(k, x, p),
              lambda p, kw: ta.random_rot90(p), {}),
    "noise": (lambda p, kw: lambda k, x: ja.gaussian_noise(k, x, 0.01, p),
              lambda p, kw: ta.gaussian_noise(0.01, p), {}),
    "cutout": (lambda p, kw: lambda k, x: ja.cutout(k, x, 4, p),
               lambda p, kw: ta.cutout(4, p), {"size": 4}),
    "coarse_dropout": (lambda p, kw: lambda k, x: ja.coarse_dropout(k, x, 3, 4, p),
                       lambda p, kw: ta.coarse_dropout(3, 4, p), {"holes": 3, "size": 4}),
    "grid_shuffle": (lambda p, kw: lambda k, x: ja.grid_shuffle(k, x, 4, p),
                     lambda p, kw: ta.grid_shuffle(4, p), {"g": 4}),
    "hflip_ab": (lambda p, kw: lambda k, x, y: ja.hflip_with_label_swap(k, x, y, p),
                 lambda p, kw: ta.hflip_with_label_swap(p), {}),
    "vflip_ab": (lambda p, kw: lambda k, x, y: ja.vflip_with_label_swap(k, x, y, p),
                 lambda p, kw: ta.vflip_with_label_swap(p), {}),
    "rot90_ab": (lambda p, kw: lambda k, x, y: ja.rot90_with_label_rotate(k, x, y, p),
                 lambda p, kw: ta.rot90_with_label_rotate(p), {}),
}


@pytest.mark.parametrize("p", [0.0, 1.0])
@pytest.mark.parametrize("kind", sorted(TRANSFORMS))
def test_transform_applies_bitwise_on_the_jax_draws(kind, p):
    make_jax, make_port, kw = TRANSFORMS[kind]
    hw = 8 if kind == "grid_shuffle" else 16
    images = _images(len(kind), hw)
    labels = np.random.default_rng(1).integers(0, 4, size=N_AUG).astype(np.int32)
    keys = _keys(len(kind) + int(p))
    labeled = kind.endswith("_ab")
    jfn = make_jax(p, kw)
    if labeled:
        want_x, want_y = jax.vmap(jfn)(keys, jnp.asarray(images), jnp.asarray(labels))
    else:
        want_x, want_y = jax.vmap(jfn)(keys, jnp.asarray(images)), None
    draws = _stack_draws([_jax_draws(kind, k, images.shape[1:], p, **kw) for k in keys])
    got_x, got_y = make_port(p, kw).apply(
        torch.from_numpy(images), torch.from_numpy(labels) if labeled else None, draws)
    _same(got_x.numpy(), np.asarray(want_x))
    if labeled:
        _same(got_y.numpy(), np.asarray(want_y))
    if p == 0.0:
        _same(got_x.numpy(), images)


# The JAX pipelines' key splits: per transform, the child key it gets.
PIPELINES = {
    "stage1": (ja.stage1_augment, ta.STAGE1,
               [("hflip", 0.5, {}), ("vflip", 0.5, {}), ("rot90", 0.5, {}),
                ("noise", 0.3, {})]),
    "stage2": (ja.stage2_augment, ta.STAGE2,
               [("hflip", 0.5, {}), ("vflip", 0.5, {}), ("rot90", 0.5, {}),
                ("noise", 0.3, {}), ("cutout", 0.3, {"size": 4}),
                ("grid_shuffle", 0.2, {"g": 4})]),
    "stage3_rect": (ja.stage3_rect_augment, ta.STAGE3_RECT,
                    [("hflip", 0.5, {}), ("vflip", 0.5, {}), ("noise", 0.3, {}),
                     ("cutout", 0.2, {"size": 4})]),
    "stage3_ab": (ja.stage3_ab_augment, ta.STAGE3_AB,
                  [("hflip_ab", 0.5, {}), ("vflip_ab", 0.5, {}), ("rot90_ab", 0.5, {}),
                   ("noise", 0.3, {}), ("coarse_dropout", 0.3, {"holes": 3, "size": 4}),
                   ("cutout", 0.3, {"size": 4})]),
}


@pytest.mark.parametrize("stage", sorted(PIPELINES))
def test_stage_pipeline_applies_bitwise_on_the_jax_draws(stage):
    """The whole pipeline, in order, on the draws the JAX pipeline takes
    from each sample's key (its gates included)."""
    jfn, pipeline, spec = PIPELINES[stage]
    images = _images(40 + len(stage))
    labels = np.random.default_rng(2).integers(0, 4, size=N_AUG).astype(np.int32)
    keys = _keys(len(stage))
    labeled = stage == "stage3_ab"
    if labeled:
        want_x, want_y = jax.vmap(jfn)(keys, jnp.asarray(images), jnp.asarray(labels))
    else:
        want_x = jax.vmap(jfn)(keys, jnp.asarray(images))
    children = [jax.random.split(k, len(spec)) for k in keys]
    draws = [_stack_draws([_jax_draws(kind, ch[i], images.shape[1:], p, **kw)
                           for ch in children])
             for i, (kind, p, kw) in enumerate(spec)]
    assert [t.name for t in pipeline] == [kind for kind, _, _ in spec]
    got_x, got_y = ta.apply_pipeline(pipeline, torch.from_numpy(images),
                                     torch.from_numpy(labels) if labeled else None, draws)
    _same(got_x.numpy(), np.asarray(want_x))
    if labeled:
        _same(got_y.numpy(), np.asarray(want_y))
    # at least one gate opened and one stayed shut, per transform
    for d in draws:
        assert 0 < int(d["apply"].sum()) < N_AUG or N_AUG < 8


def _within(share, p, n, sigmas=5.0):
    return abs(share - p) <= sigmas * math.sqrt(p * (1 - p) / n) + 1e-12


@pytest.mark.parametrize("stage", sorted(PIPELINES))
def test_port_draws_have_the_jax_rates_and_ranges(stage):
    """On 20,000 samples from a seeded generator: every gate opens at its
    rate, rot90's k is uniform over 0..3, the 270-degree coin is fair, box
    origins cover their range uniformly, grid permutations are permutations
    with every cell uniform at each place, the noise is N(0, 1)."""
    _, pipeline, spec = PIPELINES[stage]
    n = 20000
    gen = torch.Generator().manual_seed(17)
    draws = ta.draw_pipeline(pipeline, gen, torch.zeros((n, 16, 16, 1)))
    for d, (kind, p, kw) in zip(draws, spec):
        assert _within(d["apply"].float().mean().item(), p, n), kind
        if "k" in d:
            counts = torch.bincount(d["k"], minlength=4).numpy() / n
            assert all(_within(c, 0.25, n) for c in counts), counts
        if "use_270" in d:
            assert _within(d["use_270"].float().mean().item(), 0.5, n)
        if "x0" in d:
            hi = 16 - kw["size"] + 1
            for name in ("x0", "y0"):
                v = d[name].reshape(-1)
                assert int(v.min()) == 0 and int(v.max()) == hi - 1
                counts = torch.bincount(v, minlength=hi).numpy() / len(v)
                assert all(_within(c, 1 / hi, len(v)) for c in counts)
        if "perm" in d:
            cells = kw["g"] ** 2
            assert torch.equal(torch.sort(d["perm"], dim=1).values,
                               torch.arange(cells).expand(n, -1))
            first = torch.bincount(d["perm"][:, 0], minlength=cells).numpy() / n
            assert all(_within(c, 1 / cells, n) for c in first)
        if "z" in d:
            z = d["z"]
            assert abs(z.mean().item()) < 5e-3 and abs(z.std().item() - 1) < 5e-3


def test_pipelines_run_on_a_generator_and_keep_shapes():
    x = torch.from_numpy(_images(3))
    y = torch.from_numpy(np.random.default_rng(3).integers(0, 4, N_AUG).astype(np.int64))
    for stage in ("stage1", "stage2", "stage3_rect"):
        out = ta.get_augmentation(stage)(torch.Generator().manual_seed(1), x)
        assert out.shape == x.shape and out.dtype == x.dtype
    out_x, out_y = ta.get_augmentation("stage3_ab")(torch.Generator().manual_seed(1), x, y)
    assert out_x.shape == x.shape and out_y.shape == y.shape
    assert set(out_y.tolist()) <= {0, 1, 2, 3}
    with pytest.raises(ValueError):
        ta.get_augmentation("stage9")
    # the same generator state gives the same batch
    a = ta.stage2_augment(torch.Generator().manual_seed(5), x)
    b = ta.stage2_augment(torch.Generator().manual_seed(5), x)
    _same(a.numpy(), b.numpy())
