"""The step-parity helpers of ``chip_smoke.py`` on the CPU: the decision tape
(``DecisionTape``) that makes a float64 step take an fp32 step's ReLU masks,
max-pool indices and ``amax`` tie sets. Recording changes nothing; replaying
a float64 forward's own choices gives plain float64 autograd's gradients;
replaying another forward's choices follows them, not the input's; a replay
that does not fit the forward is refused. The card-only half (the card's
fp32 step against this float64 step, TF32 as the control) runs in
``chip_smoke.py``.
"""
import contextlib

import numpy as np
import pytest
import torch
from torch import nn

from av1tpu_torch import models as tm
from chip_smoke import DecisionTape, fp64_grads, grad_err_of_largest
from tests.torch_port_fixtures import images_u16, seeded_torch_model

HW, BATCH = 8, 16


def _no_dropout(model):
    for mod in model.modules():
        if isinstance(mod, nn.Dropout):
            mod.p = 0.0
    return model.train()


def _loss(model, device, x, labels):
    """Stage 1's binary cross-entropy on its one logit."""
    logits = model(x.to(device)).reshape(len(x))
    return nn.functional.binary_cross_entropy_with_logits(
        logits, labels.to(device, logits.dtype))


@pytest.fixture(scope="module")
def case():
    """A seeded stage-1 model (stem ReLU, max pool, the CBAM spatial gate's
    channel ``amax``, SE ReLUs) and one batch of 8 px blocks."""
    model = _no_dropout(seeded_torch_model(tm.Stage1Model, 3, images_u16(3, 64, HW)))
    x = torch.from_numpy(images_u16(4, BATCH, HW)).float() / 1023.0
    labels = torch.from_numpy(np.random.default_rng(5).integers(0, 2, BATCH))
    return model, x, labels


def _grads(model, x, labels, tape=None):
    model.zero_grad()
    with tape if tape is not None else contextlib.nullcontext():
        loss = _loss(model, "cpu", x, labels)
    loss.backward()
    return {n: p.grad.clone() for n, p in model.named_parameters() if p.grad is not None}


def test_recording_changes_nothing(case):
    model, x, labels = case
    tape = DecisionTape()
    recorded, plain = _grads(model, x, labels, tape), _grads(model, x, labels)
    kinds = [c.dtype for c in tape.choices]
    assert torch.bool in kinds and torch.int64 in kinds  # masks and pool indices
    for name, g in plain.items():
        assert torch.equal(recorded[name], g), name


def test_replaying_its_own_choices_is_plain_float64_autograd(case):
    model, x, labels = case
    model64 = _no_dropout(seeded_torch_model(tm.Stage1Model, 3, images_u16(3, 64, HW)))
    model64 = model64.to(torch.float64)
    tape = DecisionTape()
    plain = _grads(model64, x.double(), labels, tape)
    replayed = fp64_grads(_no_dropout(seeded_torch_model(
        tm.Stage1Model, 3, images_u16(3, 64, HW))),
        lambda m, d: _loss(m, d, x.double(), labels), "cpu", tape.choices)
    err, worst = grad_err_of_largest(replayed, plain)
    assert err <= 1e-12, (err, worst)


def test_the_fp32_step_is_within_the_bound_of_its_replayed_float64_step(case):
    """On the CPU, as ``check_step_pair`` holds the card: the fp32 gradients
    within 1e-4 of each tensor's largest entry of the float64 step that
    replays the fp32 step's choices."""
    model, x, labels = case
    tape = DecisionTape()
    fp32 = _grads(model, x, labels, tape)
    fp64 = fp64_grads(_no_dropout(seeded_torch_model(tm.Stage1Model, 3, images_u16(3, 64, HW))),
                      lambda m, d: _loss(m, d, x.double(), labels), "cpu", tape.choices)
    err, worst = grad_err_of_largest(fp32, fp64)
    assert err <= 1e-4, (err, worst)


def test_a_replay_follows_the_recorded_choices():
    """Choices recorded on one input steer the gradient of another: the ReLU
    passes where the recording's input was positive, the max pool and the
    ``amax`` send the gradient to the recorded elements (ties shared)."""
    with DecisionTape() as tape:
        torch.relu(torch.tensor([-1.0, 1.0, 2.0]))
        nn.MaxPool2d(2)(torch.tensor([[[[4.0, 1.0], [0.0, 0.0]]]]))
        torch.tensor([[1.0, 1.0, 0.0]]).amax(dim=1)
    x = torch.tensor([1.0, 1.0, 2.0], dtype=torch.float64, requires_grad=True)
    p = torch.tensor([[[[1.0, 4.0], [0.0, 0.0]]]], dtype=torch.float64, requires_grad=True)
    a = torch.tensor([[1.0, 0.5, 0.0]], dtype=torch.float64, requires_grad=True)
    with DecisionTape(tape.choices) as replay:
        y = torch.relu(x).sum() + nn.MaxPool2d(2)(p).sum() + a.amax(dim=1).sum()
    assert replay.used == 3
    y.backward()
    np.testing.assert_array_equal(x.grad.numpy(), [0.0, 1.0, 1.0])
    np.testing.assert_array_equal(p.grad.numpy().ravel(), [1.0, 0.0, 0.0, 0.0])
    np.testing.assert_array_equal(a.grad.numpy(), [[0.5, 0.5, 0.0]])


def test_a_replay_that_does_not_fit_is_refused(case):
    model, x, labels = case
    with DecisionTape() as tape:
        torch.relu(torch.ones(3))
    with pytest.raises(AssertionError, match="shape"), DecisionTape(tape.choices):
        torch.relu(torch.ones(4))
    tape = DecisionTape()
    _grads(model, x, labels, tape)
    with pytest.raises(AssertionError, match="recorded choices"):
        fp64_grads(_no_dropout(seeded_torch_model(tm.Stage1Model, 3, images_u16(3, 64, HW))),
                   lambda m, d: _loss(m, d, x.double(), labels), "cpu",
                   tape.choices + tape.choices[:1])
