"""Port parity of the ensemble, operating-point and calibration helpers
(``av1tpu_torch.eval.ensemble``, ``eval.compare``, ``eval.metrics``) against
the JAX package, on the CPU.

Votes and stacking predictions are compared on the same seeded logits, whose
members disagree on part of the samples and whose classes all occur. The
stacking fit starts from another package's random numbers, so the test holds
the objective and its gradient at one shared ``w``, then the objectives the
two fits reach. Model logits (TTA and per-member) come from seeded, calibrated
AB models and agree within 1e-4; the numpy metrics agree bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from av1tpu import models as jm
from av1tpu.eval import compare as jax_compare
from av1tpu.eval import ensemble as jax_ens
from av1tpu.eval import metrics as jax_metrics
from av1tpu_torch import models as tm
from av1tpu_torch.eval import compare as port_compare
from av1tpu_torch.eval import ensemble as port_ens
from av1tpu_torch.eval import metrics as port_metrics
from chip_smoke import set_first_class_share
from tests.torch_port_fixtures import (
    assert_input_sensitive,
    images_u16,
    jax_variables,
    seeded_torch_model,
)

M, N, C = 3, 240, 4


@pytest.fixture(scope="module")
def member_logits():
    """(M, N, C) logits: a shared signal plus member noise, so that members
    agree on most samples and disagree on some."""
    rng = np.random.default_rng(40)
    base = rng.normal(0, 1.5, (1, N, C))
    logits = (base + rng.normal(0, 1.0, (M, N, C))).astype(np.float32)
    for member in logits:
        assert_input_sensitive(member, 1e-4)
        assert len(np.unique(member.argmax(-1))) == C
    disagreement = jax_ens.ensemble_diversity(logits)["mean_disagreement"]
    assert 0.1 < disagreement < 0.9
    return logits


@pytest.fixture(scope="module")
def ab_members():
    """Three seeded AB models (each head shifted so that its argmax varies)
    as JAX variable trees, and 32 normalised 8 px blocks."""
    calib = images_u16(41, 128, 8)
    blocks = images_u16(42, 32, 8).astype(np.float32) / 1023.0
    members = []
    for seed in (50, 51, 52):
        model = seeded_torch_model(tm.Stage3ABModel, seed, calib)
        with torch.no_grad():
            logits = model(torch.from_numpy(blocks)).numpy()
        logits = set_first_class_share(model.head, logits, 0.35)
        assert_input_sensitive(logits, 1e-4)
        members.append(jax_variables(model))
    return members, blocks


@pytest.mark.parametrize("vote", ["soft_vote", "hard_vote", "weighted_vote"])
def test_votes_equal_jax(member_logits, vote):
    args = (member_logits, [0.5, 0.2, 0.3]) if vote == "weighted_vote" else (member_logits,)
    got = getattr(port_ens, vote)(*args)
    want = np.asarray(getattr(jax_ens, vote)(*args))
    assert len(np.unique(want)) > 1
    np.testing.assert_array_equal(got, want)


def test_uncertainty_and_diversity_equal_jax(member_logits):
    got = port_ens.predict_with_uncertainty(member_logits)
    want = jax_ens.predict_with_uncertainty(member_logits)
    assert sorted(got) == sorted(want)
    np.testing.assert_array_equal(got["predictions"], want["predictions"])
    np.testing.assert_array_equal(got["agreement"], want["agreement"])
    for key in ("mean_probs", "std_probs"):
        assert got[key].dtype == want[key].dtype == np.float32
        np.testing.assert_allclose(got[key], want[key], atol=1e-6, rtol=0)
    assert port_ens.ensemble_diversity(member_logits) == jax_ens.ensemble_diversity(member_logits)


def _jax_objective(member_logits, labels, w, l2):
    """The loss ``av1tpu.eval.ensemble.fit_stacking`` descends (its own body)."""
    probs = np.asarray(jax.nn.softmax(jnp.asarray(member_logits), axis=-1))
    m, n, c = probs.shape
    feats = np.concatenate([probs.transpose(1, 0, 2).reshape(n, m * c),
                            np.ones((n, 1))], axis=1)
    x, y = jnp.asarray(feats, dtype=jnp.float32), jnp.asarray(labels)

    def loss_fn(w):
        ce = optax.softmax_cross_entropy_with_integer_labels(x @ w, y).mean()
        return ce + l2 * jnp.sum(w * w)

    return float(loss_fn(w)), np.asarray(jax.grad(loss_fn)(jnp.asarray(w)))


def _port_objective(member_logits, labels, w, l2):
    x = torch.as_tensor(port_ens._stacking_features(member_logits), dtype=torch.float32)
    y = torch.as_tensor(labels, dtype=torch.int64)
    w = torch.tensor(w, requires_grad=True)
    loss = port_ens._stacking_objective(w, x, y, l2)
    (grad,) = torch.autograd.grad(loss, w)
    return float(loss.detach()), grad.numpy()


def test_stacking_objective_fit_and_predict_equal_jax(member_logits):
    labels = np.random.default_rng(43).integers(0, C, N)
    labels[:N // 2] = member_logits[0, :N // 2].argmax(-1)  # a learnable half
    l2 = 1e-3
    shared = np.random.default_rng(44).normal(0, 0.5, (M * C + 1, C)).astype(np.float32)
    got_loss, got_grad = _port_objective(member_logits, labels, shared, l2)
    want_loss, want_grad = _jax_objective(member_logits, labels, shared, l2)
    assert np.abs(want_grad).max() > 1e-3
    assert abs(got_loss - want_loss) < 1e-6
    np.testing.assert_allclose(got_grad, want_grad, atol=1e-6, rtol=0)

    w_port = port_ens.fit_stacking(member_logits, labels, l2=l2, steps=300, device="cpu")
    w_jax = jax_ens.fit_stacking(member_logits, labels, l2=l2, steps=300)
    assert w_port.shape == w_jax.shape == (M * C + 1, C) and w_port.dtype == np.float32
    fitted = [_jax_objective(member_logits, labels, w, l2)[0] for w in (w_port, w_jax)]
    assert fitted[0] < want_loss - 0.1
    assert abs(fitted[0] - fitted[1]) < 1e-3

    got = port_ens.stacking_predict(member_logits, w_jax)
    want = jax_ens.stacking_predict(member_logits, w_jax)
    assert len(np.unique(want)) > 1
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_saved_ensemble_loads_in_the_other_package(ab_members, tmp_path, writer):
    # the head and the stem's BN of each member: the layout without the bulk
    # of a ResNet-18 to compress
    members = [{"params": {"head": v["params"]["head"]},
                "batch_stats": {"backbone": {"bn1": v["batch_stats"]["backbone"]["bn1"]}}}
               for v in ab_members[0]]
    save, load = ((port_ens.save_ensemble, jax_ens.load_ensemble) if writer == "port"
                  else (jax_ens.save_ensemble, port_ens.load_ensemble))
    save(tmp_path, members, {"note": "seeded"})
    loaded, meta = load(tmp_path)
    assert meta == {"num_members": 3, "note": "seeded"}
    assert len(loaded) == 3
    for got, want in zip(loaded, members):
        flat_got = dict(jax.tree_util.tree_leaves_with_path(got))
        flat_want = dict(jax.tree_util.tree_leaves_with_path(want))
        assert sorted(flat_got, key=str) == sorted(flat_want, key=str)
        for key, value in flat_want.items():
            np.testing.assert_array_equal(flat_got[key], value)


def test_tta_and_member_logits_equal_jax(ab_members):
    members, blocks = ab_members
    got = port_ens.tta_logits(tm.Stage3ABModel(), members[0], blocks, batch_size=24,
                              device="cpu")
    want = jax_ens.tta_logits(jm.Stage3ABModel(), members[0], blocks, batch_size=24)
    assert_input_sensitive(want, 1e-4)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)

    got = port_ens.stacked_member_logits(tm.Stage3ABModel(), members, blocks,
                                         batch_size=24, device="cpu")
    want = jax_ens.stacked_member_logits(jm.Stage3ABModel(), members, blocks, batch_size=24)
    assert got.shape == want.shape == (3, len(blocks), 4)
    for member in want:
        assert_input_sensitive(member, 1e-4)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


@pytest.fixture(scope="module")
def binary():
    """Overconfident logits of a gate whose labels follow them, float64."""
    rng = np.random.default_rng(45)
    true_logits = rng.normal(0, 2.0, 4000)
    labels = (rng.uniform(size=4000) < 1 / (1 + np.exp(-true_logits))).astype(np.int64)
    logits = true_logits * 3.0
    return logits, labels, 1 / (1 + np.exp(-logits))


@pytest.mark.parametrize("fn", ["find_optimal_threshold", "threshold_sweep", "best_by",
                                "expected_calibration_error", "fit_temperature"])
def test_metrics_functions_equal_jax_bitwise(binary, fn):
    logits, labels, probs = binary
    args = {
        "find_optimal_threshold": (labels, probs),
        "threshold_sweep": (labels, probs, 0.3, 0.7, 0.05),
        "best_by": (jax_metrics.threshold_sweep(labels, probs),),
        "expected_calibration_error": (labels, probs),
        "fit_temperature": (logits, labels),
    }[fn]
    got = getattr(port_metrics, fn)(*args)
    want = getattr(jax_metrics, fn)(*args)
    assert got == want
    if fn == "fit_temperature":
        assert 2.5 < got < 3.6  # it recovers the scale of 3


def test_operating_points_equal_jax():
    rng = np.random.default_rng(46)
    outputs = {"stage1_prob": rng.uniform(size=300).astype(np.float32),
               "stage2_pred": rng.integers(0, 3, 300), "stage3_rect_pred": rng.integers(0, 2, 300),
               "stage3_ab_pred": rng.integers(0, 4, 300)}
    labels = rng.integers(-1, 8, 300)
    names = [f"c{i}" for i in range(8)]
    for th in (0.3, 0.45, 0.6):
        got = port_compare.compose_final(outputs, th)
        np.testing.assert_array_equal(got, jax_compare.compose_final(outputs, th))
        assert len(np.unique(got)) == 8
    got = port_compare.compare_operating_points(outputs, labels, [0.45, 0.5, 0.6], names)
    want = jax_compare.compare_operating_points(outputs, labels, [0.45, 0.5, 0.6], names)
    assert got == want
    assert port_compare.render_markdown(got) == jax_compare.render_markdown(want)
