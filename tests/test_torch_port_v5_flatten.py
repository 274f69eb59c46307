"""Port parity of the v5 and flatten families on the CPU: the v5 layers and
``HierarchicalModel``, ``Stage2FlatModel``, ``Stage2ModelWithAdapters``, the
weight bridge for their trees, reference ``.pt`` import, and the v5 and
flatten pipelines, each against the JAX package on the same numpy-seeded
weights and inputs.

Logits agree to 1e-4 in fp32 after the F2 guard (``assert_input_sensitive``);
pipeline outputs are equal wherever the decisions behind them have a margin
above 1e-3, and ``stage1_prob`` agrees to 1e-4. A ``.pt`` gives the port the
JAX package's variable tree bitwise.
"""
import functools
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from av1tpu import models as jm
from av1tpu.cli.common import load_model_variables as jax_load_model_variables
from av1tpu.eval import make_flatten_pipeline as jax_flatten
from av1tpu.eval import make_v5_pipeline as jax_v5
from av1tpu.models import torch_import as jax_torch_import
from av1tpu_torch import models as tm
from av1tpu_torch.cli.common import load_model_variables
from av1tpu_torch.eval import make_flatten_pipeline, make_v5_pipeline, run_pipeline_batched
from av1tpu_torch.models import from_jax_variables, load_jax_variables, to_jax_variables
from av1tpu_torch.models import torch_import as port_torch_import
from tests import torch_reference as ref
from chip_smoke import set_first_class_share
from tests.torch_port_fixtures import (
    STAGE1_THRESHOLD,
    assert_input_sensitive,
    calibrated_variables,
    images_u16,
    jax_variables,
    seeded_torch_model,
    top2_margin,
)

TOL = 1e-4
MARGIN = 1e-3
N = 256
HEADS = ("RECT", "AB", "1TO4")


def qp_values(seed: int, n: int) -> np.ndarray:
    """Per-block QPs 0..255 divided by 255, as the CLI feeds them."""
    return (np.random.default_rng(seed).integers(0, 256, size=n) / 255.0).astype(np.float32)


def leaves(tree, prefix=()):
    out = {}
    for key, value in tree.items():
        if isinstance(value, dict):
            out.update(leaves(value, prefix + (key,)))
        else:
            out[prefix + (key,)] = np.asarray(value)
    return out


def assert_same_tree(got, want):
    got, want = leaves(got), leaves(want)
    assert sorted(got) == sorted(want)
    for path, value in want.items():
        assert got[path].dtype == value.dtype and got[path].shape == value.shape, path
        assert got[path].tobytes() == value.tobytes(), path


def spread_decisions(variables, logits: dict, share: float = 0.6):
    """Shift the logits bias of each v5 head (``logits``: head name -> its
    logits on probe blocks) so that the first decision (the gate opens, or
    class 0 wins) is taken on ``share`` of the probe blocks, as
    ``chip_smoke.set_first_class_share`` does for the v6 heads: a random head
    takes one decision on every input."""
    params = jax.tree_util.tree_map(np.array, dict(variables["params"]))
    for head, lg in logits.items():
        lg = np.asarray(lg, np.float64)
        bias = params[head]["Dense_1"]["bias"]
        if lg.ndim == 1:
            threshold = np.log(STAGE1_THRESHOLD / (1 - STAGE1_THRESHOLD))
            bias[0] += threshold - np.quantile(lg, 1 - share)
        else:
            bias[0] += np.quantile(lg[:, 1:].max(axis=1) - lg[:, 0], share)
    return {**variables, "params": params}


@pytest.fixture(scope="module")
def v5_variables():
    """``(use_qp, hw) -> variables``: calibrated flax v5 trees, each head's
    decisions spread over probe blocks, drawn once."""

    @functools.lru_cache(maxsize=None)
    def get(use_qp: bool, hw: int):
        qp = qp_values(2000 + hw, 128) if use_qp else None
        model = jm.HierarchicalModel(use_qp=use_qp)
        variables = calibrated_variables(model, 30 + hw, hw, extra=() if qp is None else (qp,))
        probe = images_u16(3000 + hw, 128, hw).astype(np.float32) / 1023.0
        out = model.apply(variables, jnp.asarray(probe), qp, train=False)
        return spread_decisions(variables, {
            "stage1_head": out.stage1, "stage2_head": out.stage2,
            **{f"specialist_{h}": out.specialists[h] for h in HEADS}})

    return get


FLAT_MODELS = {  # name -> (flax class, port class, seed)
    "flat": (jm.Stage2FlatModel, tm.Stage2FlatModel, 50),
    "adapters": (jm.Stage2ModelWithAdapters, tm.Stage2ModelWithAdapters, 51),
    "stage1": (jm.Stage1Model, tm.Stage1Model, 52),
}


@pytest.fixture(scope="module")
def v6_variables():
    """The flax trees of :data:`FLAT_MODELS`, drawn and BN-calibrated in torch
    (``seeded_torch_model``: no jax compile), the stage-1 gate shifted to open
    on 60% of probe blocks."""
    calib, probe = images_u16(90, 128, 16), images_u16(91, 128, 16)
    out = {}
    for name, (_, tcls, seed) in FLAT_MODELS.items():
        model = seeded_torch_model(tcls, seed, calib)
        if name == "stage1":
            with torch.no_grad():
                logits = model(torch.from_numpy(probe.astype(np.float32) / 1023.0)).numpy()
            set_first_class_share(model.head, logits, 0.6)
        out[name] = jax_variables(model)
    return out


# ---------------------------------------------------------------------------
# Layers
# ---------------------------------------------------------------------------


def _perturbed(variables, seed):
    """A flax layer's variables with every leaf redrawn (BN stats too), so
    that BN is not the identity."""
    rng = np.random.default_rng(seed)

    def draw(path, a):
        a = np.asarray(a)
        if path[-1] == "var":
            return rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
        scale = 1.0 / np.sqrt(np.prod(a.shape[:-1])) if path[-1] == "kernel" else 0.3
        return (rng.standard_normal(a.shape) * scale + (path[-1] == "scale")).astype(np.float32)

    def walk(tree, path=()):
        return {k: walk(v, path + (k,)) if isinstance(v, dict) else draw(path + (k,), v)
                for k, v in tree.items()}

    return walk(jax.tree_util.tree_map(np.asarray, dict(variables)))


def _nested(variables, *path):
    """``variables`` moved under ``path`` in both collections."""
    def put(tree):
        for key in reversed(path):
            tree = {key: tree}
        return tree
    return {col: put(tree) for col, tree in variables.items()}


def _load_under(module, variables, jax_path, torch_prefix):
    """Load a layer's flax tree into ``module`` through the bridge: the tree
    sits where the v5 model keeps such a layer (``jax_path``), and the torch
    keys lose ``torch_prefix``."""
    sd = from_jax_variables(_nested(variables, *jax_path))
    module.load_state_dict({k[len(torch_prefix):]: v for k, v in sd.items()})
    return module.eval()


def _nhwc(t):
    return t.permute(0, 2, 3, 1).numpy()


LAYERS = {  # name -> (flax layer, port layer, flax tree path, torch prefix, in channels)
    "conv_bn_act": (jm.ConvBNAct(8), lambda: tm.ConvBNAct(3, 8), ("backbone", "stem"),
                    "backbone.stem.", 3),
    "conv_bn_act_s2": (jm.ConvBNAct(8, strides=(2, 2)), lambda: tm.ConvBNAct(3, 8, stride=2),
                       ("backbone", "stem"), "backbone.stem.", 3),
    "dsconv": (jm.DepthwiseSeparableConv(12), lambda: tm.DepthwiseSeparableConv(6, 12),
               ("backbone", "block1"), "backbone.blocks.0.", 6),
    "dsconv_s2": (jm.DepthwiseSeparableConv(12, strides=(2, 2)),
                  lambda: tm.DepthwiseSeparableConv(6, 12, stride=2),
                  ("backbone", "block1"), "backbone.blocks.0.", 6),
}


@pytest.mark.parametrize("name", list(LAYERS))
def test_conv_layers_match_flax(name):
    flax_layer, port_layer, jax_path, prefix, cin = LAYERS[name]
    x = np.random.default_rng(3).standard_normal((8, 8, 8, cin)).astype(np.float32)
    variables = _perturbed(flax_layer.init(jax.random.PRNGKey(0), jnp.asarray(x)), 4)
    want = np.asarray(flax_layer.apply(variables, jnp.asarray(x)))
    port = _load_under(port_layer(), variables, jax_path, prefix)
    with torch.no_grad():
        got = _nhwc(port(torch.from_numpy(x).permute(0, 3, 1, 2)))
    assert want.std() > 100 * TOL
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)


def test_dual_attention_matches_flax():
    x = np.random.default_rng(5).standard_normal((8, 4, 4, 32)).astype(np.float32)
    layer = jm.DualAttention()
    params = _perturbed(layer.init(jax.random.PRNGKey(1), jnp.asarray(x)), 6)["params"]
    want = np.asarray(layer.apply({"params": params}, jnp.asarray(x)))
    port = tm.DualAttention(32)
    port.load_state_dict({
        "mlp.0.weight": torch.from_numpy(params["Dense_0"]["kernel"].T.copy()),
        "mlp.2.weight": torch.from_numpy(params["Dense_1"]["kernel"].T.copy()),
        "conv.weight": torch.from_numpy(params["Conv_0"]["kernel"].transpose(3, 2, 0, 1).copy()),
    })
    with torch.no_grad():
        got = _nhwc(port(torch.from_numpy(x).permute(0, 3, 1, 2)))
    assert want.std() > 100 * TOL
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)


@pytest.mark.parametrize("extent", [8, 4, 2, 1])
def test_depthwise_stride2_pads_like_xla(extent):
    """The stride-2 depthwise conv pads (0, 1) at an even extent, as XLA
    ``"SAME"`` does, where torch's ``padding=1`` pads (1, 1) (ROADMAP F1); at
    extent 1 both pad (1, 1)."""
    rng = np.random.default_rng(extent)
    x = rng.standard_normal((2, extent, extent, 6)).astype(np.float32)
    kernel = rng.standard_normal((3, 3, 1, 6)).astype(np.float32)
    want = np.asarray(jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(kernel), (2, 2), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC"), feature_group_count=6))
    conv = tm.SpatialConv(6, 6, 3, stride=2, groups=6)
    weight = torch.from_numpy(kernel.transpose(3, 2, 0, 1).copy())
    conv.weight.data.copy_(weight)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    with torch.no_grad():
        got = _nhwc(conv(xt))
        symmetric = _nhwc(F.conv2d(xt, weight, stride=2, padding=1, groups=6))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    if extent % 2 == 0:
        assert np.abs(symmetric - want).max() > 0.1
    else:
        np.testing.assert_allclose(symmetric, want, atol=1e-5, rtol=0)


# ---------------------------------------------------------------------------
# Models and the bridge
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("hw", [8, 16, 32])
@pytest.mark.parametrize("use_qp", [False, True], ids=["plain", "qp"])
def test_v5_model_matches_flax(v5_variables, use_qp, hw):
    variables = v5_variables(use_qp, hw)
    images = images_u16(40 + hw, N, hw).astype(np.float32) / 1023.0
    qp = qp_values(60 + hw, N) if use_qp else None
    model = jm.HierarchicalModel(use_qp=use_qp)
    port = load_jax_variables(tm.HierarchicalModel(use_qp=use_qp), variables).eval()
    for q in ([qp, None] if use_qp else [None]):  # with use_qp, None means zeros
        want = model.apply(variables, jnp.asarray(images),
                           None if q is None else jnp.asarray(q), train=False)
        with torch.no_grad():
            got = port(torch.from_numpy(images), None if q is None else torch.from_numpy(q))
        pairs = [(got.stage1, want.stage1), (got.stage2, want.stage2)]
        pairs += [(got.specialists[h], want.specialists[h]) for h in HEADS]
        for g, w in pairs:
            assert_input_sensitive(np.asarray(w), TOL)
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=TOL, rtol=0)


@pytest.mark.parametrize("name", ["flat", "adapters"])
def test_flat_and_adapter_models_match_flax(v6_variables, name):
    jcls, tcls, seed = FLAT_MODELS[name]
    images = images_u16(seed, N, 16).astype(np.float32) / 1023.0
    want = np.asarray(jcls().apply(v6_variables[name], jnp.asarray(images), train=False))
    port = load_jax_variables(tcls(), v6_variables[name]).eval()
    with torch.no_grad():
        got = port(torch.from_numpy(images)).numpy()
    assert_input_sensitive(want, TOL)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)


@pytest.mark.parametrize("tree", ["v5", "v5_qp", "flat", "adapters"])
def test_bridge_round_trip_is_bitwise(v5_variables, v6_variables, tree):
    variables = (v5_variables(tree == "v5_qp", 16) if tree.startswith("v5")
                 else v6_variables[tree])
    variables = jax.tree_util.tree_map(np.asarray, dict(variables))
    assert_same_tree(to_jax_variables(from_jax_variables(variables)), variables)


# ---------------------------------------------------------------------------
# Reference .pt checkpoints
# ---------------------------------------------------------------------------

@pytest.fixture
def tmp_path(tmp_path):
    """pytest's ``tmp_path``, removed after the test: the tests here write
    full-width checkpoints, and pytest keeps its last three runs."""
    yield tmp_path
    shutil.rmtree(tmp_path, ignore_errors=True)


REFERENCE = {  # name -> (reference module, port class)
    "v5": (ref.TorchHierarchicalModel, tm.HierarchicalModel),
    "v5_qp": (functools.partial(ref.TorchHierarchicalModel, use_qp=True),
              functools.partial(tm.HierarchicalModel, use_qp=True)),
    "stage1": (functools.partial(ref.torch_v6_stage, "stage1"), tm.Stage1Model),
    "stage2": (functools.partial(ref.torch_v6_stage, "stage2"), tm.Stage2Model),
    "rect": (functools.partial(ref.torch_v6_stage, "rect"), tm.Stage3RectModel),
    "ab": (functools.partial(ref.torch_v6_stage, "ab"), tm.Stage3ABModel),
    "flat": (functools.partial(ref.TorchStage2Model, num_classes=7), tm.Stage2FlatModel),
    "fgvc": (ref.TorchFGVCModel, tm.FGVCModel),
}


@pytest.mark.parametrize("name", list(REFERENCE))
def test_pt_import_matches_jax_import(tmp_path, name):
    """A reference-shaped ``.pt`` (both payload keys) gives the port the JAX
    package's variable tree bitwise, through ``torch_import`` and through the
    CLIs' ``load_model_variables``; the port model's state dict has the
    reference module's keys and shapes and reads the file back exactly."""
    make_ref, port_cls = REFERENCE[name]
    torch.manual_seed(7)
    reference = make_ref()
    with torch.no_grad():  # running stats that are not the init's 0 and 1
        for mod in reference.modules():
            if isinstance(mod, torch.nn.modules.batchnorm._BatchNorm):
                mod.running_mean.normal_()
                mod.running_var.uniform_(0.5, 1.5)
    sd = reference.state_dict()
    port = port_cls()
    assert {k: tuple(v.shape) for k, v in port.state_dict().items()} == \
        {k: tuple(v.shape) for k, v in sd.items()}
    path = tmp_path / f"{name}.pt"
    payload_key = "model_state" if name == "stage2" else "model_state_dict"
    torch.save({payload_key: sd, "epoch": 3}, path)

    got = port_torch_import.import_any(port_torch_import.load_torch_checkpoint(path))
    want = jax_torch_import.import_any(jax_torch_import.load_torch_checkpoint(path))
    assert_same_tree(got, want)
    assert_same_tree(load_model_variables(path),
                     jax.tree_util.tree_map(np.asarray, jax_load_model_variables(path)))
    load_jax_variables(port, got)
    for key, value in port.state_dict().items():
        if not key.endswith("num_batches_tracked"):
            assert torch.equal(value, sd[key]), key


# ---------------------------------------------------------------------------
# Pipelines
# ---------------------------------------------------------------------------


def _assert_outputs(got, want, margins):
    """Every output key equal where the decisions behind it have a margin
    above 1e-3; ``stage1_prob`` within 1e-4."""
    assert set(got) == set(want)
    np.testing.assert_allclose(got["stage1_prob"], want["stage1_prob"], atol=TOL, rtol=0)
    for key, margin in margins.items():
        sure = margin > MARGIN
        assert sure.mean() > 0.9, (key, sure.mean())
        np.testing.assert_array_equal(got[key][sure], want[key][sure])
        assert got[key].dtype == np.int32, key


@pytest.fixture(scope="module")
def v5_setup(v5_variables):
    """The QP-conditioned 16 px v5 model, 256 blocks with their QPs, and the
    margin of each output's decisions (from the port's logits)."""
    variables = v5_variables(True, 16)
    port = load_jax_variables(tm.HierarchicalModel(use_qp=True), variables).eval()
    images, qps = images_u16(81, N, 16), qp_values(82, N)
    with torch.no_grad():
        out = port(torch.from_numpy(images.astype(np.float32) / 1023.0), torch.from_numpy(qps))
    margins = {
        "stage1_pred": np.abs(torch.sigmoid(out.stage1).numpy() - STAGE1_THRESHOLD),
        "stage2_pred": top2_margin(out.stage2.numpy()),
        **{f"stage3_{h}_pred": top2_margin(out.specialists[h].numpy()) for h in HEADS},
    }
    margins["final"] = np.min(np.stack(list(margins.values())), axis=0)
    return variables, port, images, qps, margins


@pytest.mark.parametrize("available", [HEADS, ("RECT",), ()], ids=["all", "rect", "none"])
def test_v5_pipeline_matches_jax(v5_setup, available):
    variables, port, images, qps, margins = v5_setup
    want = jax_v5(jm.HierarchicalModel(use_qp=True), variables,
                  stage1_threshold=STAGE1_THRESHOLD, available_specialists=available)(
        jnp.asarray(images), jnp.asarray(qps))
    want = {k: np.asarray(v) for k, v in want.items()}
    got = make_v5_pipeline(port, STAGE1_THRESHOLD, available, device="cpu")(
        torch.from_numpy(images), torch.from_numpy(qps))
    got = {k: v.numpy() for k, v in got.items()}
    _assert_outputs(got, want, margins)
    assert len(np.unique(want["final"])) >= (4 if len(available) == 3 else 3)


@pytest.fixture(scope="module")
def flatten_setup(v6_variables):
    images = images_u16(83, N, 16)
    s1 = load_jax_variables(tm.Stage1Model(), v6_variables["stage1"]).eval()
    flat = load_jax_variables(tm.Stage2FlatModel(), v6_variables["flat"]).eval()
    with torch.no_grad():
        x = torch.from_numpy(images.astype(np.float32) / 1023.0)
        s1_logits, flat_logits = s1(x).numpy(), flat(x).numpy()
    assert_input_sensitive(s1_logits, TOL)
    margins = {"stage1_pred": np.abs(1 / (1 + np.exp(-s1_logits.astype(np.float64)))
                                     - STAGE1_THRESHOLD),
               "flatten_pred": top2_margin(flat_logits)}
    margins["final"] = np.minimum(margins["stage1_pred"], margins["flatten_pred"])
    return s1, flat, images, margins


def test_flatten_pipeline_matches_jax(v6_variables, flatten_setup):
    s1, flat, images, margins = flatten_setup
    want = jax_flatten(jm.Stage1Model(), v6_variables["stage1"], jm.Stage2FlatModel(),
                       v6_variables["flat"], stage1_threshold=STAGE1_THRESHOLD)(
        jnp.asarray(images))
    want = {k: np.asarray(v) for k, v in want.items()}
    got = make_flatten_pipeline(s1, flat, STAGE1_THRESHOLD, device="cpu")(
        torch.from_numpy(images))
    got = {k: v.numpy() for k, v in got.items()}
    _assert_outputs(got, want, margins)
    assert len(np.unique(want["final"])) >= 4


def test_flatten_pipeline_bf16_matches_jax(v6_variables, flatten_setup):
    """``--bf16``: both packages run the two models in bf16 and gate in bf16
    (the JAX graph takes the sigmoid of bf16 logits and compares it with the
    threshold in bf16), and round inside their bf16 layers at other places:
    flax casts fp32 parameters per op, the port casts the modules, as its plain
    v6 graph does. Each bf16 graph is far from its fp32 graph on these random
    ResNets (measured: JAX stage-1 probabilities up to 0.099 off, 98.0% of the
    labels equal; the port 0.131, 97.7%). So the port's bf16 graph is held to
    the JAX bf16 graph within twice the JAX graph's own bf16 error, and to 95%
    equal labels (measured 0.104 and 97.3%)."""
    s1, flat, images, _ = flatten_setup

    def jax_run(dtype):
        out = jax_flatten(jm.Stage1Model(dtype=dtype), v6_variables["stage1"],
                          jm.Stage2FlatModel(dtype=dtype), v6_variables["flat"],
                          stage1_threshold=STAGE1_THRESHOLD)(jnp.asarray(images))
        return {k: np.asarray(v) for k, v in out.items()}

    want, want_fp32 = jax_run(jnp.bfloat16), jax_run(jnp.float32)
    got = make_flatten_pipeline(s1, flat, STAGE1_THRESHOLD, input_dtype=torch.bfloat16,
                                device="cpu")(torch.from_numpy(images))
    got = {k: v.numpy() for k, v in got.items()}
    assert set(got) == set(want)
    assert want["stage1_prob"].dtype == jnp.bfloat16 and got["stage1_prob"].dtype == np.float32
    prob = want["stage1_prob"].astype(np.float32)
    # the port's gate is its own bf16 probability against the bf16 threshold
    gate = torch.from_numpy(got["stage1_prob"]).to(torch.bfloat16) >= STAGE1_THRESHOLD
    np.testing.assert_array_equal(got["stage1_pred"], gate.numpy())
    bf16_error = np.abs(prob - want_fp32["stage1_prob"]).max()
    assert np.abs(got["stage1_prob"] - prob).max() <= 2 * bf16_error
    assert len(np.unique(want["final"])) >= 4
    for key in ("final", "stage1_pred", "flatten_pred"):
        assert (got[key] == want[key]).mean() >= 0.95, key


def test_batched_qps_follow_their_rows(v5_setup):
    """Batches of 100 over 256 blocks (a tail of 56 at its own size) give one
    256-block batch's outputs: each batch gets its own rows' QPs. A predictor
    with ``accepts_valid`` gets the row count, not the QPs."""
    _, port, images, qps, _ = v5_setup
    predict = make_v5_pipeline(port, STAGE1_THRESHOLD, device="cpu")
    whole = run_pipeline_batched(predict, images, batch_size=N, device="cpu", qps=qps)
    parts = run_pipeline_batched(predict, images, batch_size=100, device="cpu", qps=qps)
    without = run_pipeline_batched(predict, images, batch_size=100, device="cpu")
    for key in whole:
        np.testing.assert_allclose(parts[key], whole[key], atol=1e-6, rtol=0)
    assert np.abs(without["stage1_prob"] - whole["stage1_prob"]).max() > 1e-3

    def gated(chunk, valid):
        return {"valid": torch.tensor(valid)}

    gated.accepts_valid = True
    out = run_pipeline_batched(gated, images, batch_size=100, device="cpu", qps=qps)
    np.testing.assert_array_equal(out["valid"], [100, 100, 56])


@pytest.mark.parametrize("pipeline", ["v5", "flatten"])
def test_mesh_raises_and_names_m11(v5_setup, flatten_setup, pipeline):
    with pytest.raises(NotImplementedError, match="M11"):
        if pipeline == "v5":
            make_v5_pipeline(v5_setup[1], device="cpu", mesh=object())
        else:
            make_flatten_pipeline(*flatten_setup[:2], device="cpu", mesh=object())
