"""Port parity: the single-trunk ``UnifiedV6Model`` family, the stage models at
32 and 64 px, and the TTA and AB-ensemble options of ``make_v6_pipeline``,
against the JAX package in fp32 on the CPU.

Models are drawn and calibrated in torch on blocks of the size they serve and
carried to flax with ``to_jax_variables``; every comparison follows the F2
input-sensitivity guard. Tolerances: logits 1e-4; ``stage1_prob`` 1e-4; every
integer output equal wherever the decision behind it has a margin above 1e-3
(fp32 sums run in another order in the two frameworks). bf16 bounds are
stated in ``test_unified_folded_bf16_agrees_with_jax``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from av1tpu import models as jm
from av1tpu.eval import PipelineModels as JaxModels
from av1tpu.eval import make_unified_pipeline as jax_unified
from av1tpu.eval import make_unified_pipeline_folded as jax_unified_folded
from av1tpu.eval import make_v6_pipeline as jax_plain
from av1tpu.train import augment as jax_augment
from av1tpu_torch import models as tm
from av1tpu_torch.eval import (
    PipelineModels,
    make_unified_pipeline,
    make_unified_pipeline_folded,
    make_v6_pipeline,
    run_pipeline_batched,
)
from av1tpu_torch.eval.hierarchy import tta_mean_logits
from av1tpu_torch.train import augment as port_augment
from tests.torch_port_fixtures import (
    STAGE1_THRESHOLD,
    STAGE_CLASSES,
    assert_input_sensitive,
    blocks_of_every_size,
    cascade_stage_models,
    cascade_unified_models,
    jax_variables,
    seeded_torch_model,
    superblocks_u16,
    top2_margin,
    world_of_one,
)

TOL = 1e-4
MARGIN = 1e-3
N = 256


@pytest.fixture(scope="module")
def blocks():
    """``{size: (256, size, size, 1) uint16}`` structured blocks."""
    return {s: b[:N] for s, b in blocks_of_every_size(superblocks_u16(400, N)).items()}


@pytest.fixture(scope="module")
def unified():
    """``{size: UnifiedV6Model}``, calibrated per size, heads recentred."""
    return cascade_unified_models(seed=410)


@pytest.fixture(scope="module")
def stages():
    """``{size: {name: stage model}}`` for 16 px (the pipeline tests)."""
    return cascade_stage_models(seed=420, sizes=(16,))


def _x(blocks_u16):
    return blocks_u16.astype(np.float32) / 1023.0


@pytest.mark.parametrize("hw", [8, 16, 32, 64])
def test_unified_model_matches_flax(unified, blocks, hw):
    model, x = unified[hw], _x(blocks[hw][:64])
    v = jax_variables(model)
    want = np.asarray(jax.jit(
        lambda v, x: jm.UnifiedV6Model().apply(v, x, train=False))(v, x))
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (64, tm.UNIFIED_LOGIT_DIM)
    s1, s2, rect, ab = tm.split_unified_logits(want)
    for part in (s1, s2, rect, ab):
        assert_input_sensitive(part, TOL)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)


def test_unified_model_options_match_flax(unified, blocks):
    """``apply_temp`` divides the stage-1 logit by the temperature (1.5);
    ``from_features`` runs the heads on a given embedding."""
    model, x = unified[16], _x(blocks[16][:32])
    v = jax_variables(model)
    want = np.asarray(jm.UnifiedV6Model().apply(v, x, train=False, apply_temp=True))
    with torch.no_grad():
        xt = torch.from_numpy(x)
        plain = model(xt).numpy()
        got = model(xt, apply_temp=True).numpy()
        from_feats = model(model.backbone(xt), from_features=True).numpy()
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)
    np.testing.assert_allclose(got[:, 0] * 1.5, plain[:, 0], atol=1e-6, rtol=0)
    np.testing.assert_array_equal(got[:, 1:], plain[:, 1:])
    np.testing.assert_array_equal(from_feats, plain)
    assert tm.UNIFIED_LOGIT_SLICES == jm.UNIFIED_LOGIT_SLICES
    assert tm.UNIFIED_LOGIT_DIM == jm.UNIFIED_LOGIT_DIM
    for got_part, want_part in zip(tm.split_unified_logits(torch.from_numpy(plain)),
                                   jm.split_unified_logits(plain)):
        np.testing.assert_array_equal(got_part.numpy(), want_part)


@pytest.mark.parametrize("hw", [32, 64])
@pytest.mark.parametrize("name", list(STAGE_CLASSES))
def test_stage_model_matches_flax_at_large_blocks(blocks, name, hw):
    """The four stage models at 32 and 64 px (8 and 16 px are held in
    ``test_torch_port_models.py``)."""
    jcls, tcls = STAGE_CLASSES[name]
    model = seeded_torch_model(tcls, 430 + hw, blocks[hw][64:192])
    x = _x(blocks[hw][:64])
    want = np.asarray(jax.jit(lambda v, x: jcls().apply(v, x, train=False))(
        jax_variables(model), x))
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    assert want.std(axis=0).min() >= 100 * TOL  # the logits depend on the input
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)


def test_unified_bridge_round_trip_is_bitwise(unified):
    """A unified tree has flax's own structure, shapes and dtypes, survives
    to_jax -> from_jax -> to_jax bit for bit, loads strictly, and maps
    ``head_*`` and the top-level ``temperature``."""
    model = unified[16]
    v = jax_variables(model)
    flax_tree = jax.eval_shape(  # the structure of a flax init, without compiling one
        lambda: jm.UnifiedV6Model().init(jax.random.PRNGKey(0), jnp.zeros((2, 16, 16, 1))))
    want = {"params": flax_tree["params"], "batch_stats": flax_tree["batch_stats"]}
    assert jax.tree_util.tree_structure(v) == jax.tree_util.tree_structure(want)
    for a, b in zip(jax.tree_util.tree_leaves(v), jax.tree_util.tree_leaves(want)):
        assert a.shape == b.shape and a.dtype == b.dtype
    sd = tm.from_jax_variables(v)
    for key in ("temperature", "head_stage1.head.0.weight", "head_stage2.head.6.bias",
                "head_rect.head.3.weight", "head_ab.head.6.weight",
                "backbone.layer4.0.downsample.1.running_var"):
        assert key in sd, key
    assert "head.temperature" not in sd
    back = tm.to_jax_variables(sd)
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(v)
    for a, b in zip(jax.tree_util.tree_leaves(v), jax.tree_util.tree_leaves(back)):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()
    loaded = tm.load_jax_variables(tm.UnifiedV6Model(), v)
    assert loaded.temperature.item() == 1.5
    for key, value in model.state_dict().items():
        if not key.endswith("num_batches_tracked"):  # flax keeps no such count
            assert torch.equal(loaded.state_dict()[key], value), key


def test_tta_views_and_alignment_equal_the_jax_package(blocks):
    x = _x(blocks[16][:5])
    np.testing.assert_array_equal(port_augment.tta_views(torch.from_numpy(x)).numpy(),
                                  np.asarray(jax_augment.tta_views(jnp.asarray(x))))
    np.testing.assert_array_equal(port_augment.TTA_AB_ALIGN_V6, jax_augment.TTA_AB_ALIGN_V6)
    assert port_augment.TTA_AB_ALIGN_V6.dtype == jax_augment.TTA_AB_ALIGN_V6.dtype
    logits = np.random.default_rng(0).normal(size=(4, 7, 4)).astype(np.float32)
    np.testing.assert_array_equal(
        port_augment.align_tta_ab_logits(torch.from_numpy(logits)).numpy(),
        np.asarray(jax_augment.align_tta_ab_logits(jnp.asarray(logits))))


def _unified_margins(logits):
    s1, s2, rect, ab = tm.split_unified_logits(np.asarray(logits, np.float64))
    margins = {
        "stage1_pred": np.abs(1 / (1 + np.exp(-s1)) - STAGE1_THRESHOLD),
        "stage2_pred": top2_margin(s2),
        "stage3_rect_pred": top2_margin(rect),
        "stage3_ab_pred": top2_margin(ab),
    }
    margins["final"] = np.min(np.stack(list(margins.values())), axis=0)
    return margins


def _assert_same(got, want, margins):
    assert set(got) == set(want)
    assert len(np.unique(want["final"])) >= 3
    np.testing.assert_allclose(got["stage1_prob"], want["stage1_prob"], atol=TOL, rtol=0)
    for key, margin in margins.items():
        sure = margin > MARGIN
        assert sure.mean() > 0.9, (key, sure.mean())
        np.testing.assert_array_equal(got[key][sure], want[key][sure])
        assert got[key].dtype == np.int32


def _run(jax_predict, port_predict, images):
    want = {k: np.asarray(v) for k, v in jax_predict(jnp.asarray(images)).items()}
    got = {k: v.numpy() for k, v in port_predict(torch.from_numpy(images)).items()}
    return got, want


@pytest.mark.parametrize("tta, align", [(False, True), (True, True), (True, False)],
                         ids=["plain", "tta_aligned", "tta_naive"])
def test_unified_pipeline_matches_jax(unified, blocks, tta, align):
    model, images = unified[16], blocks[16]
    got, want = _run(
        jax_unified(jm.UnifiedV6Model(), jax_variables(model),
                    stage1_threshold=STAGE1_THRESHOLD, tta=tta, tta_align_ab=align),
        make_unified_pipeline(model, stage1_threshold=STAGE1_THRESHOLD, tta=tta,
                              tta_align_ab=align, device="cpu"),
        images)
    with torch.no_grad():
        x = torch.from_numpy(_x(images))
        logits = tta_mean_logits(model, x, align) if tta else model(x)
    _assert_same(got, want, _unified_margins(logits.numpy()))


@pytest.mark.parametrize("hw, front", [(16, False), (16, True), (16, "g1"), (8, "g1"),
                                       (8, True), (32, True), (64, "g1")])
def test_unified_folded_matches_jax(unified, blocks, hw, front):
    """fp32, fronts off/on/g1; the JAX fronts in interpret mode, the port's on
    their plain versions. At 32 and 64 px the kernels do not apply and both
    packages run the plain front."""
    model, images = unified[hw], blocks[hw][:128]
    got, want = _run(
        jax_unified_folded(jax_variables(model), stage1_threshold=STAGE1_THRESHOLD,
                           float_dtype=jnp.float32, use_fused_front=front,
                           interpret=True),
        make_unified_pipeline_folded(model, stage1_threshold=STAGE1_THRESHOLD,
                                     float_dtype=torch.float32, use_fused_front=front,
                                     device="cpu"),
        images)
    with torch.no_grad():
        logits = model(torch.from_numpy(_x(images)))
    _assert_same(got, want, _unified_margins(logits.numpy()))


@pytest.mark.parametrize("front", [True, "g1"], ids=["on", "g1"])
def test_unified_folded_bf16_agrees_with_jax(unified, blocks, front):
    """The serving dtype. bf16 rounds at other places in the two frameworks'
    plain layers, so labels cannot be identical: the stage-1 probability stays
    within 0.1 on every block and 0.01 on average, and the final label agrees
    on at least 97% of 256 blocks (measured since the folded path's sigmoid
    rounds as XLA's does: 0.017, 0.0004 and 100% for ``on``; 0.011, 0.0005 and
    100% for ``g1``; with ``torch.sigmoid`` 0.058, 0.0061 and 96.1-98.0%)."""
    model, images = unified[16], blocks[16]
    got, want = _run(
        jax_unified_folded(jax_variables(model), stage1_threshold=STAGE1_THRESHOLD,
                           float_dtype=jnp.bfloat16, use_fused_front=front,
                           interpret=True),
        make_unified_pipeline_folded(model, stage1_threshold=STAGE1_THRESHOLD,
                                     float_dtype=torch.bfloat16, use_fused_front=front,
                                     device="cpu"),
        images)
    assert len(np.unique(want["final"])) >= 3
    prob_err = np.abs(got["stage1_prob"].astype(np.float32)
                      - want["stage1_prob"].astype(np.float32))
    assert prob_err.max() <= 0.1 and prob_err.mean() <= 0.01
    assert (got["final"] == want["final"]).mean() >= 0.97


def test_unified_pipelines_reject_what_is_not_ported(unified, tmp_path):
    """An unknown front is refused. A mesh (ROADMAP M11) is ported: on a
    mesh of one process both unified pipelines give the outputs of no mesh,
    as the JAX package's one-device mesh does."""
    with pytest.raises(ValueError, match="use_fused_front"):
        make_unified_pipeline_folded(unified[16], use_fused_front="g2", device="cpu")
    images = blocks_of_every_size(superblocks_u16(431, 2))[16]
    for i, build in enumerate((make_unified_pipeline, make_unified_pipeline_folded)):
        want = run_pipeline_batched(build(unified[16], device="cpu"), images, 16,
                                    device="cpu")
        with world_of_one(tmp_path / str(i)) as mesh:
            got = run_pipeline_batched(build(unified[16], mesh=mesh, device="cpu"), images,
                                       16, device="cpu", mesh=mesh)
        for key, value in want.items():
            np.testing.assert_array_equal(got[key], value, err_msg=key)


# ---------------------------------------------------------------------------
# make_v6_pipeline: TTA, AB alignment, AB ensembles
# ---------------------------------------------------------------------------


def _stage_margins(logit_fns, x):
    with torch.no_grad():
        s1, s2, rect, ab = (fn(x).numpy().astype(np.float64) for fn in logit_fns)
    margins = {
        "stage1_pred": np.abs(1 / (1 + np.exp(-s1)) - STAGE1_THRESHOLD),
        "stage2_pred": top2_margin(s2),
        "stage3_rect_pred": top2_margin(rect),
        "stage3_ab_pred": top2_margin(ab),
    }
    margins["final"] = np.min(np.stack(list(margins.values())), axis=0)
    return margins


@pytest.mark.parametrize("tta, align, members", [
    (True, False, 0), (True, True, 3), (False, True, 0),
], ids=["tta", "ensemble_tta_aligned", "align_without_tta"])
def test_pipeline_options_match_jax(stages, blocks, tta, align, members):
    """``tta`` (a mean of logits over four views), ``tta_align_ab`` and a
    three-member ``ab_ensemble_vars`` (softmax, then the mean over members).
    ``tta_align_ab`` without ``tta`` is ignored, as in the JAX package."""
    models, images = stages[16], blocks[16]
    ensemble = [jax_variables(seeded_torch_model(tm.Stage3ABModel, 440 + i,
                                                 blocks[16][:128]))
                for i in range(members)]
    jax_args = [x for name, m in models.items()
                for x in (STAGE_CLASSES[name][0](), jax_variables(m))]
    got, want = _run(
        jax_plain(JaxModels(*jax_args), stage1_threshold=STAGE1_THRESHOLD, tta=tta,
                  tta_align_ab=align, ab_ensemble_vars=ensemble or None),
        make_v6_pipeline(PipelineModels(*models.values()),
                         stage1_threshold=STAGE1_THRESHOLD, tta=tta, tta_align_ab=align,
                         ab_ensemble_vars=ensemble or None, device="cpu"),
        images)

    def logits_of(model, align_ab=False):
        return (lambda x: tta_mean_logits(model, x, align_ab)) if tta else model

    ab_fn = logits_of(models["ab"], align)
    if members:
        nets = [logits_of(tm.load_jax_variables(tm.Stage3ABModel(), v).eval(), align)
                for v in ensemble]
        ab_fn = lambda x: torch.stack([torch.softmax(n(x), -1) for n in nets]).mean(0)
    margins = _stage_margins(
        [logits_of(models["stage1"]), logits_of(models["stage2"]),
         logits_of(models["rect"]), ab_fn], torch.from_numpy(_x(images)))
    _assert_same(got, want, margins)
    if (tta, align, members) == (False, True, 0):
        plain = make_v6_pipeline(PipelineModels(*models.values()),
                                 stage1_threshold=STAGE1_THRESHOLD, device="cpu")
        for key, value in plain(torch.from_numpy(images)).items():
            np.testing.assert_array_equal(got[key], value.numpy())
