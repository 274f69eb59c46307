"""Port parity: the port's v6 pipelines against the JAX builders on 256
blocks, on the CPU.

In fp32 ``stage1_prob`` agrees to 1e-4; every other output is identical
wherever the decision behind it has a margin above 1e-3 (the margin guard of
``tests/test_torch_differential.py``), after the F2 guard on each stage's
logits. In bf16, with the fused fronts, the bounds are looser and stated in
``test_pipeline_bf16_matches_jax``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from av1tpu import models as jm
from av1tpu.eval import PipelineModels as JaxModels
from av1tpu.eval import make_v6_pipeline as jax_plain
from av1tpu.eval import make_v6_pipeline_folded as jax_folded
from av1tpu_torch import models as tm
from av1tpu_torch.eval import (
    PipelineModels,
    make_v6_pipeline,
    make_v6_pipeline_folded,
    run_pipeline_batched,
)
from tests.torch_port_fixtures import (
    STAGE1_THRESHOLD,
    assert_input_sensitive,
    calibrated_variables,
    images_u16,
    top2_margin,
    world_of_one,
)

N = 256
MARGIN = 1e-3
STAGES = (  # (flax class, port class, seed)
    (jm.Stage1Model, tm.Stage1Model, 70),
    (jm.Stage2Model, tm.Stage2Model, 71),
    (jm.Stage3RectModel, tm.Stage3RectModel, 72),
    (jm.Stage3ABModel, tm.Stage3ABModel, 73),
)


@pytest.fixture(scope="module")
def setup():
    variables = [calibrated_variables(j(), seed, 16) for j, _, seed in STAGES]
    jax_models = JaxModels(*[x for (j, _, _), v in zip(STAGES, variables)
                             for x in (j(), v)])
    port = [tm.load_jax_variables(t(), v).eval()
            for (_, t, _), v in zip(STAGES, variables)]
    images = images_u16(80, N, 16)
    with torch.no_grad():
        x = torch.from_numpy(images.astype(np.float32) / 1023.0)
        logits = [m(x).numpy() for m in port]
    for lg in logits:
        assert_input_sensitive(lg, 1e-4)
    s1_prob = 1 / (1 + np.exp(-logits[0].astype(np.float64)))
    margins = {
        "stage1_pred": np.abs(s1_prob - STAGE1_THRESHOLD),
        "stage2_pred": top2_margin(logits[1]),
        "stage3_rect_pred": top2_margin(logits[2]),
        "stage3_ab_pred": top2_margin(logits[3]),
    }
    margins["final"] = np.min(np.stack(list(margins.values())), axis=0)
    return jax_models, PipelineModels(*port), images, margins


def _assert_same(got, want, margins):
    assert set(got) == set(want)
    np.testing.assert_allclose(got["stage1_prob"], want["stage1_prob"],
                               atol=1e-4, rtol=0)
    for key, margin in margins.items():
        sure = margin > MARGIN
        assert sure.mean() > 0.9, (key, sure.mean())
        np.testing.assert_array_equal(got[key][sure], want[key][sure])
        assert got[key].dtype == np.int32


BUILDERS = {
    "plain": (
        lambda m: jax_plain(m, stage1_threshold=STAGE1_THRESHOLD,
                            input_dtype=jnp.float32),
        lambda m: make_v6_pipeline(m, stage1_threshold=STAGE1_THRESHOLD,
                                   device="cpu"),
    ),
    **{
        f"folded_{name}{'_groups' if groups else ''}": (
            lambda m, mode=mode, groups=groups: jax_folded(
                m, stage1_threshold=STAGE1_THRESHOLD, float_dtype=jnp.float32,
                use_fused_front=mode, use_pallas_groups=groups, interpret=True),
            lambda m, mode=mode, groups=groups: make_v6_pipeline_folded(
                m, stage1_threshold=STAGE1_THRESHOLD, float_dtype=torch.float32,
                use_fused_front=mode, use_pallas_groups=groups, device="cpu"),
        )
        for groups in (False, True)
        for name, mode in (("off", False), ("on", True), ("g1", "g1"))
    },
}


@pytest.mark.parametrize("builder", list(BUILDERS))
def test_pipeline_matches_jax(setup, builder):
    jax_models, port_models, images, margins = setup
    make_jax, make_port = BUILDERS[builder]
    want = {k: np.asarray(v) for k, v in make_jax(jax_models)(
        jnp.asarray(images)).items()}
    got = {k: v.numpy() for k, v in make_port(port_models)(
        torch.from_numpy(images)).items()}
    _assert_same(got, want, margins)


@pytest.mark.parametrize("mode", [True, "g1"], ids=["folded_on", "folded_g1"])
def test_pipeline_bf16_matches_jax(setup, mode):
    """The serving dtype: K1 (``on``) and K2 (``g1``) in bf16 on the CPU against
    the JAX builders on the same 256 blocks. bf16 rounds at other places in the
    two frameworks' plain layers, so labels cannot be identical: the stage-1
    probability stays within 0.02 and the final label agrees on at least 95%
    of the blocks (measured since the folded path's sigmoid rounds as XLA's
    does: 0.0051 and 100% for ``on``, 0.0085 and 100% for ``g1``; with
    ``torch.sigmoid`` 0.013 and 98.4%, 0.0095 and 98.4%)."""
    jax_models, port_models, images, _ = setup
    want = {k: np.asarray(v) for k, v in jax_folded(
        jax_models, stage1_threshold=STAGE1_THRESHOLD, float_dtype=jnp.bfloat16,
        use_fused_front=mode, interpret=True)(jnp.asarray(images)).items()}
    got = {k: v.numpy() for k, v in make_v6_pipeline_folded(
        port_models, stage1_threshold=STAGE1_THRESHOLD, float_dtype=torch.bfloat16,
        use_fused_front=mode, device="cpu")(torch.from_numpy(images)).items()}
    assert set(got) == set(want)
    assert len(np.unique(want["final"])) >= 2
    prob_err = np.abs(got["stage1_prob"].astype(np.float32)
                      - want["stage1_prob"].astype(np.float32)).max()
    assert prob_err <= 0.02
    assert (got["final"] == want["final"]).mean() >= 0.95


def test_batched_run_with_ragged_tail_equals_one_batch(setup):
    """Batches of 100 over 256 blocks (tail of 56 at its own size) give the
    outputs of one 256-block batch: the graph works per sample."""
    _, port_models, images, _ = setup
    predict = make_v6_pipeline_folded(port_models, float_dtype=torch.float32,
                                      use_fused_front="g1", device="cpu")
    whole = run_pipeline_batched(predict, images, batch_size=N, device="cpu")
    parts = run_pipeline_batched(predict, images, batch_size=100, device="cpu")
    for key in whole:
        np.testing.assert_allclose(parts[key], whole[key], atol=1e-6, rtol=0)


@pytest.fixture(scope="module")
def jax_outputs(setup):
    """The JAX package's plain pipeline on the 256 blocks, unstacked and
    stacked, as numpy."""
    jax_models, _, images, _ = setup
    return {stacked: {k: np.asarray(v) for k, v in jax_plain(
        jax_models, stage1_threshold=STAGE1_THRESHOLD, input_dtype=jnp.float32,
        stacked=stacked)(jnp.asarray(images)).items()} for stacked in (False, True)}


@pytest.mark.parametrize("option, item", [
    ({"stacked": True}, "the JAX package's stacked pipeline"),
    ({"stacked": True, "tta": True}, "the unstacked TTA pipeline"),
    ({"mesh": "of one process"}, "no mesh"),
])
def test_unported_pipeline_options_raise(setup, jax_outputs, option, item, tmp_path):
    """None of these options raises any more; each case holds the pipeline it
    builds against ``item``. ``stacked`` runs the four backbones as one
    vmapped forward: the same function as the unstacked graph (``final``
    equal, ``stage1_prob`` within rtol 1e-5, atol 1e-6, the JAX package's own
    bound) and the JAX package's ``stacked=True`` pipeline (the margin guard).
    With ``tta`` the option is ignored, as in the JAX package: the outputs are
    the unstacked TTA pipeline's bit for bit (on 64 blocks). On a mesh of one process the
    plain pipeline gives the outputs of no mesh, as the JAX package's
    one-device mesh does."""
    _, port_models, images, margins = setup
    if "mesh" in option:
        want = run_pipeline_batched(make_v6_pipeline(port_models, device="cpu"), images,
                                    batch_size=100, device="cpu")
        with world_of_one(tmp_path) as mesh:
            got = run_pipeline_batched(make_v6_pipeline(port_models, device="cpu", mesh=mesh),
                                       images, batch_size=100, device="cpu", mesh=mesh)
        for key, value in want.items():
            np.testing.assert_array_equal(got[key], value, err_msg=key)
        return
    unstacked_option = {**option, "stacked": False}
    x = torch.from_numpy(images[:64] if "tta" in option else images)
    got = {k: v.numpy() for k, v in make_v6_pipeline(
        port_models, stage1_threshold=STAGE1_THRESHOLD, device="cpu", **option)(x).items()}
    want = {k: v.numpy() for k, v in make_v6_pipeline(
        port_models, stage1_threshold=STAGE1_THRESHOLD, device="cpu",
        **unstacked_option)(x).items()}
    if "tta" in option:
        for key, value in want.items():
            np.testing.assert_array_equal(got[key], value, err_msg=key)
        return
    np.testing.assert_array_equal(got["final"], want["final"])
    np.testing.assert_allclose(got["stage1_prob"], want["stage1_prob"], rtol=1e-5, atol=1e-6)
    assert len(np.unique(got["final"])) >= 2
    _assert_same(got, jax_outputs[True], margins)


@pytest.mark.parametrize("case", ["ensemble", "mismatched_backbones"])
def test_stacked_falls_back_to_unstacked(setup, case):
    """As in the JAX package, ``stacked`` is ignored with an AB ensemble and
    when a stage model has no ``backbone`` of the others' layout (here the
    adapter stage 2): the outputs are the unstacked pipeline's bit for bit."""
    jax_models, port_models, images, _ = setup
    kwargs = {"stage1_threshold": STAGE1_THRESHOLD, "device": "cpu"}
    if case == "ensemble":
        kwargs["ab_ensemble_vars"] = [jax_models.stage3_ab_vars] * 2
    else:
        torch.manual_seed(3)
        port_models = PipelineModels(port_models.stage1, tm.Stage2ModelWithAdapters().eval(),
                                     port_models.stage3_rect, port_models.stage3_ab)
    x = torch.from_numpy(images)
    got, want = (make_v6_pipeline(port_models, stacked=stacked, **kwargs)(x)
                 for stacked in (True, False))
    for key, value in want.items():
        np.testing.assert_array_equal(got[key].numpy(), value.numpy(), err_msg=key)


@pytest.mark.parametrize("prefetch", [0, 2, 4])
def test_prefetch_matches_jax(setup, jax_outputs, prefetch):
    """``run_pipeline_batched`` in batches of 100 (a tail of 56) with the
    producer ``prefetch`` batches ahead: outputs bitwise the serial loop's
    and, within the margin guard, the JAX package's pipeline."""
    _, port_models, images, margins = setup
    predict = make_v6_pipeline(port_models, stage1_threshold=STAGE1_THRESHOLD, device="cpu")
    got = run_pipeline_batched(predict, images, batch_size=100, device="cpu",
                               prefetch=prefetch)
    serial = run_pipeline_batched(predict, images, batch_size=100, device="cpu", prefetch=0)
    for key, value in serial.items():
        np.testing.assert_array_equal(got[key], value, err_msg=key)
    _assert_same(got, jax_outputs[False], margins)


def test_unported_folded_options_raise(setup):
    with pytest.raises(ValueError, match="use_fused_front"):
        make_v6_pipeline_folded(setup[1], use_fused_front="g2", device="cpu")
