"""Port parity: av1tpu_torch models and weight bridge against the flax
models, fp32 on the CPU.

Weights are flax inits with calibrated-then-perturbed BN running stats
(``torch_port_fixtures``), carried over by ``from_jax_variables``; every
parity assertion is preceded by the F2 input-sensitivity guard.
"""
import jax
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from av1tpu import models as jm
from av1tpu_torch import models as tm
from av1tpu_torch.models.layers import SpatialConv
from tests.torch_port_fixtures import (
    assert_input_sensitive,
    calibrated_variables,
    images_u16,
)

TOL = 1e-4
MODELS = {  # name -> (flax class, port class, init seed)
    "stage1": (jm.Stage1Model, tm.Stage1Model, 30),
    "stage2": (jm.Stage2Model, tm.Stage2Model, 31),
    "rect": (jm.Stage3RectModel, tm.Stage3RectModel, 32),
    "ab": (jm.Stage3ABModel, tm.Stage3ABModel, 33),
    "fgvc": (jm.FGVCModel, tm.FGVCModel, 34),
}


@pytest.fixture(scope="module")
def variables():
    """``get(name, hw)``: calibrated variables, built once per extent."""
    cache = {}

    def get(name, hw=16):
        if (name, hw) not in cache:
            jcls, _, seed = MODELS[name]
            cache[name, hw] = calibrated_variables(jcls(), seed, hw)
        return cache[name, hw]

    return get


@pytest.mark.parametrize("hw", [16, 8])
@pytest.mark.parametrize("name", list(MODELS))
def test_stage_model_matches_flax(variables, name, hw):
    """Logits of each model equal flax's ``apply(..., train=False)`` to
    1e-4; backbone embeddings, whose entries reach tens, to 1e-4 of their
    largest magnitude (fp32 sums in another order through 20 layers)."""
    jcls, tcls, _ = MODELS[name]
    v = variables(name, hw)
    x = images_u16(40 + hw, 64, hw).astype(np.float32) / 1023.0
    want = np.asarray(jax.jit(lambda v, x: jcls().apply(v, x, train=False))(v, x))
    bb = {"params": v["params"]["backbone"],
          "batch_stats": v["batch_stats"]["backbone"]}
    want_emb = np.asarray(jax.jit(
        lambda v, x: jm.ImprovedBackbone().apply(v, x, train=False))(bb, x))

    model = tm.load_jax_variables(tcls(), v).eval()
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
        got_emb = model.backbone(torch.from_numpy(x)).numpy()

    assert_input_sensitive(want, TOL)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)
    emb_tol = TOL * max(1.0, float(np.abs(want_emb).max()))
    assert want_emb.std(axis=0).mean() >= 100 * emb_tol
    np.testing.assert_allclose(got_emb, want_emb, atol=emb_tol, rtol=0)


@pytest.mark.parametrize("extent", [8, 4, 2, 1])
def test_stride2_conv_pads_like_xla_same(extent):
    """F1: a stride-2 3x3 conv pads (0, 1) at even extents under XLA
    "SAME"; PyTorch's padding=1 is wrong there. At extent 1 both read the
    center tap."""
    rng = np.random.default_rng(extent)
    x = rng.normal(size=(3, extent, extent, 8)).astype(np.float32)
    k = rng.normal(size=(3, 3, 8, 5)).astype(np.float32)
    want = np.asarray(jax.lax.conv_general_dilated(
        x, k, (2, 2), "SAME", dimension_numbers=("NHWC", "HWIO", "NHWC")))

    conv = SpatialConv(8, 5, 3, stride=2)
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(k.transpose(3, 2, 0, 1)))
        xt = torch.from_numpy(x).permute(0, 3, 1, 2)
        got = conv(xt).permute(0, 2, 3, 1).numpy()
        naive = F.conv2d(xt, conv.weight, stride=2, padding=1).permute(0, 2, 3, 1)

    assert want.std() >= 100 * 1e-5
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    if extent % 2 == 0:
        assert np.abs(naive.numpy() - want).max() > 0.1
    else:
        np.testing.assert_allclose(naive.numpy(), want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("name", list(MODELS))
def test_bridge_round_trip_is_bitwise(variables, name):
    """to_jax_variables(from_jax_variables(v)) reproduces the tree bit for
    bit, and the state dict loads strictly into the port's model."""
    v = variables(name)
    back = tm.to_jax_variables(tm.from_jax_variables(v))
    assert (jax.tree_util.tree_structure(back)
            == jax.tree_util.tree_structure(jax.tree_util.tree_map(np.asarray, v)))
    for a, b in zip(jax.tree_util.tree_leaves(v), jax.tree_util.tree_leaves(back)):
        a = np.asarray(a)
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()
    tm.load_jax_variables(MODELS[name][1](), v)


def test_bridge_names_follow_reference_checkpoints():
    """Port keys use the reference's torchvision-style names."""
    keys = set(tm.Stage1Model().state_dict())
    for key in ("backbone.layer2.0.downsample.0.weight",
                "backbone.layer2.0.downsample.1.running_var",
                "backbone.se3.excitation.2.weight",
                "backbone.spatial_attn.conv.weight",
                "head.head.3.bias", "head.temperature"):
        assert key in keys, key
    fgvc = set(tm.FGVCModel().state_dict())
    assert {"feat_proj.0.weight", "feat_proj.5.running_mean",
            "classifier.weight"} <= fgvc
