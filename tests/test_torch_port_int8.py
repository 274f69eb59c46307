"""Port parity of int8 serving: ``av1tpu_torch.quant.ptq`` against the JAX
package's ``av1tpu.quant.ptq`` on the CPU, at 8 and 16 px, fp32 and bf16.

* Integer primitives, SMM matrices, plans and patches: exact equality.
* State carried across (``models.jax_import.quant_model_from_arrays``): the
  JAX package's scales, int8 weights, corrected biases, plan and absmax drive
  the port's graph. In bf16 every rounding of the JAX graph is reproduced and
  each site's int8 activations are equal. In fp32 a 1-ulp difference of a
  float island (the stem conv's sum order) moves an activation across a
  rounding boundary now and then, and each such flip moves the next layer's
  inputs: the bounds below are measured, and labels are equal wherever the
  decision margin exceeds that int8 noise.
* The port's own quantization against the JAX package's, on the same
  weights and calibration blocks.
* Both pipelines, each calibrating on its own, and the drift checker.

The models are the cascade fixtures' (calibrated at the size they serve,
heads shifted so that decisions vary); each JAX model set is quantized once
per module, on 64 calibration blocks.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from av1tpu import models as jm
from av1tpu.eval import PipelineModels as JaxPipelineModels
from av1tpu.eval.hierarchy import v6_route as jax_v6_route
from av1tpu.quant import ptq as jq
from av1tpu_torch.eval import (
    PipelineModels,
    make_unified_pipeline_folded,
    make_v6_pipeline_folded,
    run_pipeline_batched,
    v6_route,
)
from av1tpu_torch.models import UNIFIED_LOGIT_SLICES
from av1tpu_torch.models.jax_import import quant_model_from_arrays
from av1tpu_torch.quant import ptq as pq
from tests.torch_port_fixtures import (
    STAGE1_THRESHOLD,
    assert_input_sensitive,
    blocks_of_every_size,
    cascade_stage_models,
    cascade_unified_models,
    jax_variables,
    superblocks_u16,
    top2_margin,
    world_of_one,
)

CALIB, EVAL = 64, 192  # blocks of each size
DTYPES = {"fp32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
# Bounds of the bridged state, measured on these models (see the module
# docstring). bf16: each site's int8 activations equal (held to >= 99.99% and
# one step), logits within one bf16 step of |logit| < 4 (XLA's fusion of the
# jitted JAX graph; op by op they are equal), so labels equal beyond two such
# steps (a mismatch was measured at a margin of 0.0017). fp32: the least share of equal activations at a
# site (measured down to 98.95%), the share of equal labels, and the margin
# beyond which every label is equal (mismatches measured at margins up to
# 0.10), from the int8 noise that one flipped activation sets off.
SITE_SHARE = {"fp32": 0.98, "bf16": 0.9999}
LOGIT_ATOL = {"bf16": 0.02}
LABEL_SHARE = {"fp32": 0.97, "bf16": 0.98}
LABEL_MARGIN = {"fp32": 0.25, "bf16": 0.03}
# Each package quantizing on its own: absmax within 2e-5 of each site's
# largest (measured 8.8e-6), scales within 1e-5, int8 weights equal on 99.9%
# (one step elsewhere), corrected biases within 2e-3 on output channels whose
# int8 weights are equal (measured 8.5e-4: the calibration activations that
# flip feed the correction's mean). The two int8 graphs then differ by int8
# noise: their labels must agree at least as often as the port's int8 labels
# agree with its fp32 folded pipeline (measured 94-96% against 82-86%), and
# never where every decision's margin exceeds PIPELINE_MARGIN.
PIPELINE_MARGIN = 0.25
PIPELINE_PROB_ATOL = 0.2
# The im2col lowering, each package quantizing on its own: the mean logit
# difference within IM2COL_LOGIT of the float logits' scale (measured
# 0.002-0.007), labels equal at least as often as the port's int8 labels equal
# its fp32 folded forward's (measured 88-98% against 67-94%) and wherever every
# decision's margin exceeds PIPELINE_MARGIN. Each lowering keeps within
# INT8_SCALE of the float forward and of the other, on average (the JAX
# package's own bound, tests/test_quant.py).
IM2COL_LOGIT = 0.02
INT8_SCALE = 0.08


def _u16(blocks):
    return jnp.asarray(blocks, jnp.uint16)


def _x(blocks):
    return blocks.astype(np.float32) / 1023.0


@pytest.fixture(scope="module")
def ws():
    """Port models, their JAX variables, calibration and evaluation blocks."""
    stages = cascade_stage_models(seed=710, sizes=(16, 8))
    unified = cascade_unified_models(seed=720, sizes=(16, 8))
    blocks = blocks_of_every_size(superblocks_u16(730, 16))
    models = {  # (kind, hw) -> port model
        ("stage", 16): stages[16]["stage2"], ("stage", 8): stages[8]["rect"],
        ("unified", 16): unified[16], ("unified", 8): unified[8],
    }
    return {
        "stages": stages, "models": models,
        "vars": {k: jax_variables(m) for k, m in models.items()},
        "stage_vars": {n: jax_variables(m) for n, m in stages[16].items()},
        "calib": {hw: blocks[hw][:CALIB] for hw in (16, 8)},
        "eval": {hw: blocks[hw][CALIB:CALIB + EVAL] for hw in (16, 8)},
    }


@pytest.fixture(scope="module")
def jax_side(ws):
    """The JAX package's int8 pipelines at 16 px (their quantized models via
    ``quant_out``) and its quantized models at 8 px."""
    v = ws["stage_vars"]
    pm = JaxPipelineModels(jm.Stage1Model(), v["stage1"], jm.Stage2Model(), v["stage2"],
                           jm.Stage3RectModel(), v["rect"], jm.Stage3ABModel(), v["ab"])
    stage_q, unified_q = [], []
    v6 = jq.make_v6_pipeline_int8(pm, _u16(ws["calib"][16]), quant_out=stage_q)
    uni = jq.make_unified_pipeline_int8(ws["vars"][("unified", 16)], _u16(ws["calib"][16]),
                                        quant_out=unified_q)
    calib8 = jnp.asarray(_x(ws["calib"][8]))
    return {
        "out": {"v6": v6(_u16(ws["eval"][16])), "unified": uni(_u16(ws["eval"][16]))},
        "q": {("stage", 16): stage_q[1], ("unified", 16): unified_q[0],
              ("stage", 8): jq.quantize_stage(ws["vars"][("stage", 8)], calib8),
              ("unified", 8): jq.quantize_unified(ws["vars"][("unified", 8)], calib8)},
        "stage_q": stage_q, "fwd": {},
    }


@pytest.fixture(scope="module")
def port_side(ws):
    """The port's int8 pipelines and models on the same blocks, on the CPU."""
    m = ws["stages"][16]
    pm = PipelineModels(m["stage1"], m["stage2"], m["rect"], m["ab"])
    stage_q, unified_q = [], []
    v6 = pq.make_v6_pipeline_int8(pm, ws["calib"][16], quant_out=stage_q, device="cpu")
    uni = pq.make_unified_pipeline_int8(ws["models"][("unified", 16)], ws["calib"][16],
                                        quant_out=unified_q, device="cpu")
    images = torch.from_numpy(ws["eval"][16])
    calib8 = torch.from_numpy(_x(ws["calib"][8]))
    folded = {  # the fp32 folded pipelines: the int8 noise's yardstick
        "v6": make_v6_pipeline_folded(pm, float_dtype=torch.float32, device="cpu"),
        "unified": make_unified_pipeline_folded(ws["models"][("unified", 16)],
                                                float_dtype=torch.float32, device="cpu")}
    return {
        "out": {"v6": v6(images), "unified": uni(images)},
        "float": {k: p(images)["final"].numpy() for k, p in folded.items()},
        "q": {("stage", 16): stage_q[1], ("unified", 16): unified_q[0],
              ("stage", 8): pq.quantize_stage(ws["models"][("stage", 8)], calib8),
              ("unified", 8): pq.quantize_unified(ws["models"][("unified", 8)], calib8)},
        "stage_q": stage_q,
    }


def _decisions(logits, kind):
    """Per-sample margin of every decision of ``kind``'s logits, and the
    decisions: the stage-1 gate's distance from its threshold, else the top-2
    logit gap."""
    logits = np.asarray(logits, np.float64)
    parts = ([logits[:, lo] if name == "stage1" else logits[:, lo:hi]
              for name, (lo, hi) in UNIFIED_LOGIT_SLICES.items()]
             if kind == "unified" else [logits])
    margins, decisions = [], []
    for part in parts:
        if part.ndim == 1 or part.shape[1] == 1:
            prob = 1 / (1 + np.exp(-part.reshape(-1)))
            margins.append(np.abs(prob - STAGE1_THRESHOLD))
            decisions.append(prob >= STAGE1_THRESHOLD)
        else:
            margins.append(top2_margin(part))
            decisions.append(part.argmax(-1))
    return np.min(margins, axis=0), np.stack(decisions, -1)


# ---------------------------------------------------------------------------
# Exact: SMM matrices, plans, patches, weights, integer products
# ---------------------------------------------------------------------------


def _smm_shapes(hw):
    """Every (extent, stride) the plan gives an SMM conv at ``hw`` px, and
    those of its 1x1 downsamples."""
    s, convs, ds = jq._stem_out_extent(hw), set(), set()
    for gi in range(1, 5):
        for bi in range(2):
            stride = 2 if (gi > 1 and bi == 0) else 1
            so = max(1, -(-s // stride))
            if s <= 2 or (s <= 4 and gi >= 2):
                convs |= {(s, stride), (so, 1)}
                if bi == 0 and gi > 1:
                    ds.add((s, stride))
            s = so
    return sorted(convs), sorted(ds)


def test_stem_out_extent_matches_jax():
    for hw in range(4, 130):
        assert pq._stem_out_extent(hw) == jq._stem_out_extent(hw)


@pytest.mark.parametrize("hw", [8, 16, 32, 64])
def test_smm_matrices_match_jax(hw):
    convs, ds = _smm_shapes(hw)
    assert convs and ds
    assert ((1, 2) in convs) == (hw <= 16)  # the 1x1, stride-2 center tap
    rng = np.random.default_rng(hw)
    for (s, stride) in convs:
        k = rng.standard_normal((3, 3, 4, 5)).astype(np.float32)
        got = pq.build_smm_matrix(torch.from_numpy(k), s, s, stride)
        np.testing.assert_array_equal(got, jq.build_smm_matrix(k, s, s, stride))
    for (s, stride) in ds:
        k = rng.standard_normal((1, 1, 4, 5)).astype(np.float32)
        got = pq.build_smm_matrix_1x1(torch.from_numpy(k), s, s, stride)
        np.testing.assert_array_equal(got, jq.build_smm_matrix_1x1(k, s, s, stride))


@pytest.mark.parametrize("hw", [8, 16, 32, 64])
def test_plan_matches_jax(ws, hw):
    """Each block's form, extents, stride and width, and the SMM weights and
    tiled biases, from the same folded arrays."""
    folded = jq.fold_backbone(ws["stage_vars"]["stage2"])
    as_torch = jax.tree_util.tree_map(lambda a: torch.from_numpy(np.array(a)), folded)
    got, want = pq._plan_backbone(as_torch, hw), jq._plan_backbone(folded, hw)
    assert got["hw"] == want["hw"] == hw
    assert got["blocks"] == want["blocks"]
    assert {b["form"] for b in want["blocks"].values()} == (
        {"smm"} if hw == 8 else {"conv", "smm"})
    for key in ("smm_w", "smm_b"):
        assert sorted(got[key]) == sorted(want[key])
        for wkey in want[key]:
            np.testing.assert_array_equal(got[key][wkey].numpy(), want[key][wkey])


@pytest.mark.parametrize("stride", [1, 2])
def test_patches3x3_match_jax(stride):
    x = np.random.default_rng(stride).integers(-127, 128, (3, 4, 6, 5)).astype(np.int8)
    got = pq._patches3x3(torch.from_numpy(x), stride).numpy()
    want = np.asarray(jq._patches3x3(jnp.asarray(x), stride))
    assert got.dtype == np.int8
    np.testing.assert_array_equal(got, want)


def test_quant_weight_matches_jax():
    k = np.random.default_rng(3).standard_normal((3, 3, 16, 8)).astype(np.float32)
    k[..., 0] = 0.0  # a dead output channel takes the 1e-8 floor
    got_w, got_s = pq._quant_weight(torch.from_numpy(k))
    want_w, want_s = jq._quant_weight(jnp.asarray(k))
    assert got_w.dtype == torch.int8 and got_w.shape == (144, 8)
    np.testing.assert_array_equal(got_w.numpy(), np.asarray(want_w))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))


INT32 = {  # case -> (x shape, w shape, stride): conv if w is 4-D, else a product
    "conv_4x4_s1": ((3, 4, 4, 16), (3, 3, 16, 24), 1),
    "conv_4x4_s2": ((3, 4, 4, 16), (3, 3, 16, 24), 2),
    "conv_2x2_s2": ((3, 2, 2, 16), (3, 3, 16, 24), 2),
    "smm_product": ((40, 1024), (1024, 512), 1),
    "head_3_outputs_5_rows": ((5, 128), (128, 3), 1),
}


@pytest.mark.parametrize("case", list(INT32))
def test_int32_products_match_jax(case):
    """``_int_conv`` and ``_int_dot`` (padded to the card's ``_int_mm`` shapes
    and trimmed) against XLA's int8 conv and dot with int32 accumulation."""
    xs, ws_, stride = INT32[case]
    rng = np.random.default_rng(len(case))
    x = rng.integers(-127, 128, xs).astype(np.int8)
    w = rng.integers(-127, 128, ws_).astype(np.int8)
    if len(ws_) == 4:
        got = pq._int_conv(torch.from_numpy(x), torch.from_numpy(w), stride)
        want = jax.lax.conv_general_dilated(
            jnp.asarray(x), jnp.asarray(w), (stride, stride), "SAME",
            dimension_numbers=("NHWC", "HWIO", "NHWC"), preferred_element_type=jnp.int32)
    else:
        got = pq._int_dot(torch.from_numpy(x), torch.from_numpy(w))
        want = jax.lax.dot_general(jnp.asarray(x), jnp.asarray(w), (((1,), (0,)), ((), ())),
                                   preferred_element_type=jnp.int32)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert np.abs(np.asarray(want)).max() > 2 ** 16  # sums beyond any float16


QCONV = {  # case -> (x shape, conv kernel size, stride)
    "3x3_at_4x4_s1": ((4, 4, 4, 32), 3, 1),
    "3x3_at_4x4_s2": ((4, 4, 4, 32), 3, 2),
    "3x3_center_tap_1x1_s1": ((4, 1, 1, 32), 3, 1),
    "3x3_center_tap_1x1_s2": ((4, 1, 1, 32), 3, 2),
    "1x1_at_4x4_s2": ((4, 4, 4, 32), 1, 2),
}


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", list(QCONV))
def test_quantized_convs_match_jax(case, dtype):
    """``_qconv3x3`` (im2col or center tap) and ``_qconv1x1``: quantize,
    integer product, dequantize, round to the serving dtype; bit-equal."""
    xs, k, stride = QCONV[case]
    rng = np.random.default_rng(len(case))
    x = rng.standard_normal(xs).astype(np.float32) * 3
    kernel = rng.standard_normal((k, k, xs[-1], 16)).astype(np.float32)
    inv = (rng.uniform(10, 40, xs[-1])).astype(np.float32)
    s_x = 0.02345
    w_i8, s_w = jq._quant_weight(jnp.asarray(kernel))
    jdt, tdt = DTYPES[dtype]
    fn_j, fn_p = (jq._qconv3x3, pq._qconv3x3) if k == 3 else (jq._qconv1x1, pq._qconv1x1)
    want = fn_j(jnp.asarray(x), (jnp.asarray(inv), s_x), w_i8, s_w, stride, jdt)
    got = fn_p(torch.from_numpy(x), (torch.from_numpy(inv), s_x),
               torch.from_numpy(np.array(w_i8)), torch.from_numpy(np.array(s_w)),
               stride, tdt)
    assert got.dtype == tdt and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))


# ---------------------------------------------------------------------------
# The JAX package's int8 state in the port's graph
# ---------------------------------------------------------------------------


def _bridge(jax_q, model, dtype):
    plan = jax_q.plan
    return quant_model_from_arrays(
        model,
        scales={s: (np.asarray(inv), s_x) for s, (inv, s_x) in jax_q.scales.items()},
        qw={k: (np.asarray(w), np.asarray(s)) for k, (w, s) in jax_q.qw.items()},
        qbias={k: np.asarray(b) for k, b in jax_q.qbias.items()},
        plan={"hw": plan["hw"], "blocks": plan["blocks"], "smm_w": plan["smm_w"],
              "smm_b": plan["smm_b"]},
        calib_amax=jax_q.calib_amax, float_dtype=dtype)


def _heads_of(q):
    return q.heads if isinstance(q, jq.QuantUnifiedModel) else {"head": q.head}


def _jax_forward(jax_side, kind, hw, dtype, x):
    """Logits and each site's int8 activations of the JAX int8 graph of
    ``(kind, hw)`` in ``dtype`` (one compile each, kept for the module)."""
    key = (kind, hw, dtype)
    if key not in jax_side["fwd"]:
        q = dataclasses.replace(jax_side["q"][(kind, hw)], float_dtype=DTYPES[dtype][0])

        def run(x):
            captured = {}
            feats = jq._backbone_apply_hybrid(q.folded, x, q.plan, q.scales, q.qw,
                                              float_dtype=q.float_dtype, qbias=q.qbias,
                                              captured=captured)
            logits = [jq._head_apply(stack, feats, q.scales, q.qw,
                                     float_dtype=q.float_dtype, qbias=q.qbias,
                                     captured=captured, site_prefix=name)
                      .astype(jnp.float32) for name, stack in _heads_of(q).items()]
            acts = {site: jq._quant_act(t, q.scales[site]) for site, t in captured.items()}
            return jnp.concatenate(logits, axis=-1), acts

        logits, acts = jax.jit(run)(jnp.asarray(x))
        jax_side["fwd"][key] = (np.asarray(logits),
                                {k: np.asarray(v) for k, v in acts.items()})
    return jax_side["fwd"][key]


def _port_forward(q, x):
    captured = {}
    with torch.no_grad():
        feats = pq._backbone_apply_hybrid(q.folded, x, q.plan, q.scales, q.qw,
                                          float_dtype=q.float_dtype, qbias=q.qbias,
                                          captured=captured)
        logits = [pq._head_apply_int8(stack, feats, q.scales, q.qw,
                                      float_dtype=q.float_dtype, qbias=q.qbias,
                                      captured=captured, site_prefix=name).float()
                  for name, stack in q.heads.items()]
    acts = {site: pq._quant_act(t, q.scales[site]).numpy() for site, t in captured.items()}
    return torch.cat(logits, -1).numpy(), acts


def _labels_agree(got, want, kind, margin, share):
    """Decisions equal on ``share`` of the samples and wherever every
    decision's margin (from ``want``) exceeds ``margin``."""
    margins, want_dec = _decisions(want, kind)
    _, got_dec = _decisions(got, kind)
    equal = (got_dec == want_dec).all(-1)
    assert equal.mean() >= share, equal.mean()
    assert equal[margins > margin].all(), margins[~equal].max()


KINDS = [("stage", 8), ("stage", 16), ("unified", 8), ("unified", 16)]


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("kind, hw", KINDS)
def test_bridged_state_matches_jax(ws, jax_side, kind, hw, dtype):
    """The JAX package's int8 state, carried across as numpy arrays, in the
    port's graph: each site's int8 activations, the logits and the labels."""
    x = _x(ws["eval"][hw])
    want, want_acts = _jax_forward(jax_side, kind, hw, dtype, x)
    port_q = _bridge(jax_side["q"][(kind, hw)], ws["models"][(kind, hw)], DTYPES[dtype][1])
    got, got_acts = _port_forward(port_q, torch.from_numpy(x))
    assert_input_sensitive(want, LOGIT_ATOL["bf16"] / 10)  # std >= 10x the bf16 bound
    assert sorted(got_acts) == sorted(want_acts)
    for site, w in want_acts.items():
        g = got_acts[site]
        assert g.dtype == np.int8 and g.shape == w.shape, site
        diff = np.abs(g.astype(np.int32) - w)
        assert (diff == 0).mean() >= SITE_SHARE[dtype], (site, (diff == 0).mean())
        if dtype == "bf16":
            assert diff.max() <= 1, (site, diff.max())
    if dtype == "bf16":
        np.testing.assert_allclose(got, want, atol=LOGIT_ATOL[dtype], rtol=0)
    _labels_agree(got, want, kind, LABEL_MARGIN[dtype], LABEL_SHARE[dtype])
    with torch.no_grad():  # the model's own forward is the graph run above
        np.testing.assert_array_equal(port_q(torch.from_numpy(x)).float().numpy(), got)


@pytest.mark.parametrize("kind, hw", KINDS)
def test_own_quantization_matches_jax(ws, jax_side, port_side, kind, hw):
    """Each package folds, calibrates and quantizes the same weights on the
    same blocks (bounds above)."""
    want, got = jax_side["q"][(kind, hw)], port_side["q"][(kind, hw)]
    assert sorted(got.calib_amax) == sorted(want.calib_amax)
    assert sorted(got.scales) == sorted(want.scales) == sorted(got.calib_amax)
    for site, a in want.calib_amax.items():
        np.testing.assert_allclose(got.calib_amax[site], a, rtol=0,
                                   atol=2e-5 * np.abs(a).max(), err_msg=site)
        np.testing.assert_allclose(got.scales[site][1], want.scales[site][1], rtol=1e-5)
    assert sorted(got.qw) == sorted(want.qw) == sorted(got.qbias)
    equal = total = 0
    for wkey, (w, s) in want.qw.items():
        g = got.qw[wkey][0].numpy().astype(np.int32)
        w = np.asarray(w).astype(np.int32)
        assert g.shape == w.shape, wkey
        assert np.abs(g - w).max() <= 1, wkey
        equal, total = equal + (g == w).sum(), total + g.size
        np.testing.assert_allclose(got.qw[wkey][1].numpy(), np.asarray(s), rtol=1e-5)
        same = (g == w).all(axis=0)
        np.testing.assert_allclose(got.qbias[wkey].numpy()[same],
                                   np.asarray(want.qbias[wkey])[same],
                                   atol=2e-3, rtol=0, err_msg=wkey)
    assert equal / total >= 0.999
    assert got.plan["blocks"] == want.plan["blocks"]


@pytest.mark.parametrize("family", ["v6", "unified"])
def test_pipeline_matches_jax(ws, jax_side, port_side, family):
    """Each package calibrates on its own: same keys, shapes and dtypes; the
    final label is ``v6_route`` of the pipeline's own stage predictions; the
    labels of the two int8 pipelines agree at least as often as the port's
    int8 labels agree with its fp32 folded pipeline, and wherever every
    decision's margin exceeds PIPELINE_MARGIN."""
    want = {k: np.asarray(v) for k, v in jax_side["out"][family].items()}
    got = {k: v.numpy() for k, v in port_side["out"][family].items()}
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key].dtype == want[key].dtype and got[key].shape == want[key].shape, key
    preds = ("stage1_pred", "stage2_pred", "stage3_rect_pred", "stage3_ab_pred")
    np.testing.assert_array_equal(
        got["final"], v6_route(*(torch.from_numpy(got[k]) for k in preds)).numpy())
    np.testing.assert_array_equal(
        want["final"], np.asarray(jax_v6_route(*(jnp.asarray(want[k]) for k in preds))))
    assert len(np.unique(want["final"])) > 2
    x = torch.from_numpy(_x(ws["eval"][16]))
    with torch.no_grad():
        if family == "v6":
            margins = np.min([_decisions(q(x).numpy(), "stage")[0]
                              for q in port_side["stage_q"]], axis=0)
        else:
            margins = _decisions(port_side["q"][("unified", 16)](x).numpy(), "unified")[0]
    equal = got["final"] == want["final"]
    assert equal[margins > PIPELINE_MARGIN].all()
    assert equal.mean() >= max(0.9, (got["final"] == port_side["float"][family]).mean())
    np.testing.assert_allclose(got["stage1_prob"], want["stage1_prob"],
                               atol=PIPELINE_PROB_ATOL, rtol=0)


def test_drift_checker_matches_jax(ws, jax_side, port_side):
    """The same worst site and ratio (rtol 1e-5) on an in-range batch and on a
    3x brightened one, from each package's own quantized stage-2 model."""
    x = _x(ws["eval"][16])
    check_j = jq.make_drift_checker(jax_side["q"][("stage", 16)])
    check_p = pq.make_drift_checker(port_side["q"][("stage", 16)])
    ratios = []
    for batch in (x, np.minimum(x * 3, 1.0)):
        want = check_j(jnp.asarray(batch))
        got = check_p(torch.from_numpy(batch))
        assert got["worst_site"] == want["worst_site"]
        np.testing.assert_allclose(got["max_ratio"], want["max_ratio"], rtol=1e-5)
        ratios.append(got["max_ratio"])
    assert ratios[0] < 1.5 < ratios[1]


@pytest.mark.parametrize("kind, hw", KINDS)
def test_im2col_lowering_matches_jax(ws, port_side, kind, hw):
    """``lowering="im2col"`` (every 3x3 and 1x1 site an int8 conv, no plan),
    quantized by each package on the same weights and blocks (bounds above):
    the same sites, absmax within 2e-5 of each site's largest, logits and
    labels; within INT8_SCALE of the fp32 folded forward and of the hybrid
    lowering. It serves the other block size (8 <-> 16 px) as the JAX
    package's im2col model does, where the hybrid model refuses, and K1
    attaches to it."""
    model, calib = ws["models"][(kind, hw)], _x(ws["calib"][hw])
    quantize = {"stage": (jq.quantize_stage, pq.quantize_stage),
                "unified": (jq.quantize_unified, pq.quantize_unified)}[kind]
    want_q = quantize[0](ws["vars"][(kind, hw)], jnp.asarray(calib), lowering="im2col")
    got_q = quantize[1](model, torch.from_numpy(calib), lowering="im2col")
    assert got_q.plan is None and want_q.plan is None
    assert sorted(got_q.qw) == sorted(want_q.qw) == sorted(got_q.qbias)
    assert sorted(got_q.calib_amax) == sorted(want_q.calib_amax) == sorted(got_q.scales)
    for site, a in want_q.calib_amax.items():
        np.testing.assert_allclose(got_q.calib_amax[site], a, rtol=0,
                                   atol=2e-5 * np.abs(a).max(), err_msg=site)
    forward = jax.jit(lambda t: want_q(t))
    x, other = _x(ws["eval"][hw]), _x(ws["eval"][8 if hw == 16 else 16])
    want = np.asarray(forward(jnp.asarray(x)), np.float32)
    assert_input_sensitive(want, LOGIT_ATOL["bf16"] / 10)
    with torch.no_grad():
        got = got_q(torch.from_numpy(x)).float().numpy()
        ref = got_q.float_forward(torch.from_numpy(x)).float().numpy()
        hybrid = port_side["q"][(kind, hw)](torch.from_numpy(x)).float().numpy()
    scale = max(np.abs(ref).max(), 0.1)
    assert np.abs(got - want).mean() <= IM2COL_LOGIT * scale
    margins, want_dec = _decisions(want, kind)
    got_dec, ref_dec = _decisions(got, kind)[1], _decisions(ref, kind)[1]
    equal = (got_dec == want_dec).all(-1)
    assert equal.mean() >= (got_dec == ref_dec).all(-1).mean()
    assert equal[margins > PIPELINE_MARGIN].all()
    assert np.abs(got - ref).mean() < INT8_SCALE * scale
    assert np.abs(got - hybrid).mean() < INT8_SCALE * scale

    with pytest.raises(ValueError, match=f"quantized for {hw}x{hw}"):
        port_side["q"][(kind, hw)](torch.from_numpy(other))
    want_other = np.asarray(forward(jnp.asarray(other)), np.float32)
    with torch.no_grad():
        got_other = got_q(torch.from_numpy(other)).float().numpy()
    assert np.abs(got_other - want_other).mean() <= INT8_SCALE * scale

    assert pq.attach_fused_front(got_q, hw)
    with torch.no_grad():
        fused = got_q(torch.from_numpy(x)).float().numpy()
    _labels_agree(fused, got, kind, LABEL_MARGIN["fp32"], LABEL_SHARE["fp32"])


# ---------------------------------------------------------------------------
# The port's own: K1 on the int8 path, buffers, refusals
# ---------------------------------------------------------------------------


def test_fused_front_attaches_at_8_and_16_px_only(ws, port_side):
    """K1 (its plain version on the CPU) replaces the stem of an int8 model at
    8 and 16 px in the model's dtype, and nowhere else; labels keep to the
    plain stem's beyond the bridged fp32 margin. ``.to()`` moves every buffer
    and rebuilds the front on the new device."""
    q = port_side["q"][("stage", 16)]
    x = torch.from_numpy(_x(ws["eval"][16]))
    with torch.no_grad():
        plain = q(x).numpy()
        assert pq.attach_fused_front(q, 16)
        assert q.front_fn is not None and q._front == (16, torch.float32)
        fused = q(x).numpy()
        q.front_fn, q._front = None, None
    _labels_agree(fused, plain, "stage", LABEL_MARGIN["fp32"], LABEL_SHARE["fp32"])
    for hw in (32, 64):
        assert not pq.attach_fused_front(q, hw) and q.front_fn is None
    moved = pq.quantize_stage(ws["models"][("stage", 8)],
                              torch.from_numpy(_x(ws["calib"][8])), torch.bfloat16)
    assert pq.attach_fused_front(moved, 8)
    assert moved._front == (8, torch.bfloat16)
    moved.to("meta")
    assert {t.device.type for t in moved.buffers()} == {"meta"}
    assert moved.qw["head.0"][0].device.type == "meta"
    assert moved.plan["smm_w"]["layer2_0.conv1"].device.type == "meta"
    assert moved.folded["stem"]["kernel"].device.type == "meta"
    assert moved.front_fn is not None
    names = dict(moved.named_buffers())
    assert names["qw__layer1_0_conv1__0"].dtype == torch.int8
    assert "plan__smm_w__layer4_1_conv2" in names and "scales__head_0__0" in names


def test_refusals_name_their_reason(ws, tmp_path):
    """What the int8 builders refuse names its reason. A mesh (ROADMAP M11)
    is no longer refused: on a mesh of one process both int8 pipelines give
    the outputs of no mesh, as the JAX package's one-device mesh does."""
    model, calib = ws["models"][("stage", 16)], ws["calib"][16]
    pm = PipelineModels(*(ws["stages"][16][n] for n in ("stage1", "stage2", "rect", "ab")))
    images = ws["eval"][16]
    builders = {
        "v6": lambda **kw: pq.make_v6_pipeline_int8(pm, calib, device="cpu", **kw),
        "unified": lambda **kw: pq.make_unified_pipeline_int8(
            ws["models"][("unified", 16)], calib, device="cpu", **kw),
    }
    for name, build in builders.items():
        want = run_pipeline_batched(build(), images, 64, device="cpu")
        with world_of_one(tmp_path / name) as mesh:
            got = run_pipeline_batched(build(mesh=mesh), images, 64, device="cpu", mesh=mesh)
        for key, value in want.items():
            np.testing.assert_array_equal(got[key], value, err_msg=f"{name} {key}")
    with pytest.raises(ValueError, match="no group-1 hook"):
        pq.make_v6_pipeline_int8(pm, calib, use_fused_front="g1", device="cpu")
    x = torch.from_numpy(_x(calib))
    with pytest.raises(ValueError, match="unknown lowering"):
        pq.quantize_unified(ws["models"][("unified", 16)], x, lowering="spatial")
    q = pq.quantize_stage(model, x)
    with pytest.raises(ValueError, match="quantized for 16x16"):
        q(torch.from_numpy(_x(ws["eval"][8])))
    # the im2col lowering is ported: no plan, no refusal, and the same logits
    # as the hybrid lowering within the JAX package's bound between the two
    im2col = pq.quantize_stage(model, x, lowering="im2col")
    assert im2col.plan is None
    images16 = torch.from_numpy(_x(ws["eval"][16]))
    with torch.no_grad():
        ref = q.float_forward(images16).numpy()
        diff = np.abs(im2col(images16).numpy() - q(images16).numpy()).mean()
    assert diff < INT8_SCALE * max(np.abs(ref).max(), 0.1)
