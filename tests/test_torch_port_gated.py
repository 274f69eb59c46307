"""Port parity of the capacity-gated pipeline (``av1tpu_torch.eval.gated``)
and of ``run_pipeline_batched``'s padded tail, against the JAX package, fp32
on the CPU.

The batch is 100 blocks at batch 64: one full chunk and a 36-row tail that
both packages pad to 64 with copies of its first row, which passes the gate
(the case the gate's padding mask exists for). Labels agree under the margin
guard; where K is short of the gate's passers, both packages must send the
same rows to the SPLIT fallback, so the test asserts that the K-th and
(K+1)-th probabilities of every chunk are further apart than float noise.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from av1tpu.eval import PipelineModels as JaxPipelineModels
from av1tpu.eval import run_pipeline_batched as jax_batched
from av1tpu.eval.gated import auto_capacity as jax_auto_capacity
from av1tpu.eval.gated import make_v6_pipeline_gated as jax_gated
from av1tpu_torch.eval import (
    PipelineModels,
    auto_capacity,
    make_v6_pipeline,
    make_v6_pipeline_folded,
    make_v6_pipeline_gated,
    run_pipeline_batched,
)
from chip_smoke import set_first_class_share
from tests.torch_port_fixtures import (
    FIRST_CLASS_SHARE,
    STAGE1_THRESHOLD,
    STAGE_CLASSES,
    assert_input_sensitive,
    images_u16,
    jax_variables,
    seeded_torch_model,
    top2_margin,
)

N, BATCH = 100, 64
GATE_SHARE = 0.75


@pytest.fixture(scope="module")
def stages():
    """Seeded stage models, their heads shifted so that every decision varies
    (the stage-1 gate opens on 75% of the blocks),
    the blocks with a gate-passing row first in the tail, and the margins."""
    calib = images_u16(5, 128, 16)
    models = {name: seeded_torch_model(classes[1], 300 + i, calib)
              for i, (name, classes) in enumerate(STAGE_CLASSES.items())}
    images = images_u16(6, N, 16)
    x = torch.from_numpy(images.astype(np.float32) / 1023.0)
    with torch.no_grad():
        logits = {name: m(x).numpy() for name, m in models.items()}
    for name, share in {**FIRST_CLASS_SHARE, "stage1": GATE_SHARE}.items():
        logits[name] = set_first_class_share(models[name].head, logits[name], share)
        assert_input_sensitive(logits[name], 1e-4)
    prob = 1 / (1 + np.exp(-logits["stage1"]))
    # the tail's first row, which both packages repeat as padding, passes the gate
    first = int(np.flatnonzero((prob >= STAGE1_THRESHOLD)[BATCH:])[0]) + BATCH
    order = np.arange(N)
    order[[BATCH, first]] = order[[first, BATCH]]
    images, prob = images[order], prob[order]
    margins = np.min(np.stack(
        [np.abs(prob - STAGE1_THRESHOLD)]
        + [top2_margin(logits[name][order]) for name in ("stage2", "rect", "ab")]), axis=0)
    jax_models = JaxPipelineModels(*(
        part for name, classes in STAGE_CLASSES.items()
        for part in (classes[0](), jax_variables(models[name]))))
    return {"port": PipelineModels(*models.values()), "jax": jax_models,
            "images": images, "prob": prob, "sure": margins > 1e-3}


def _passers_per_chunk(prob):
    return [int((prob[s:s + BATCH] >= STAGE1_THRESHOLD).sum()) for s in range(0, N, BATCH)]


def _check_against_jax(got, want, sure):
    assert sure.mean() > 0.9
    np.testing.assert_allclose(got["stage1_prob"], want["stage1_prob"], atol=1e-5, rtol=0)
    for key in ("final", "stage1_pred", "stage2_pred"):
        assert got[key].dtype == np.int32
        np.testing.assert_array_equal(got[key][sure], np.asarray(want[key])[sure])
    np.testing.assert_array_equal(got["overflow"], np.asarray(want["overflow"]))
    assert sorted(got) == sorted(want)


@pytest.mark.parametrize("folded", [False, True], ids=["plain", "folded"])
@pytest.mark.parametrize("cover", ["capacity_1", "covering"])
def test_gated_equals_dense_where_k_covers_the_gate(stages, folded, cover):
    images, prob = stages["images"], stages["prob"]
    passers = _passers_per_chunk(prob)
    assert 0 < min(passers) and max(passers) < BATCH
    capacity = 1.0 if cover == "capacity_1" else (max(passers) + 2) / BATCH
    gated = make_v6_pipeline_gated(stages["port"], capacity=capacity,
                                   stage1_threshold=STAGE1_THRESHOLD, folded=folded,
                                   device="cpu")
    got = run_pipeline_batched(gated, images, BATCH, device="cpu")
    assert got["overflow"].tolist() == [0, 0]
    if folded:
        dense = make_v6_pipeline_folded(stages["port"], STAGE1_THRESHOLD,
                                        float_dtype=torch.float32, device="cpu")
    else:
        dense = make_v6_pipeline(stages["port"], STAGE1_THRESHOLD, device="cpu")
    want = run_pipeline_batched(dense, images, BATCH, device="cpu")
    np.testing.assert_array_equal(got["final"], want["final"])
    np.testing.assert_array_equal(got["stage1_pred"], want["stage1_pred"])
    np.testing.assert_allclose(got["stage1_prob"], want["stage1_prob"], atol=1e-6, rtol=0)
    ran = got["stage2_pred"] >= 0
    assert ran[want["stage1_pred"] == 1].all()
    np.testing.assert_array_equal(got["stage2_pred"][ran], want["stage2_pred"][ran])

    jax_out = jax_batched(jax_gated(stages["jax"], capacity=capacity,
                                    stage1_threshold=STAGE1_THRESHOLD, folded=folded),
                          images, BATCH)
    _check_against_jax(got, jax_out, stages["sure"])


def test_gated_overflow_and_split_fallback_match_jax(stages):
    """K = 32 places for ~48 passers in the full chunk: the same overflow
    count, and the same rows fall back to SPLIT. The tail's padding copies of
    its first (passing) row evict none of its real passers."""
    images, prob = stages["images"], stages["prob"]
    capacity, k = 0.5, 32
    for start in range(0, N, BATCH):
        real = np.sort(prob[start:start + BATCH])[::-1]
        if len(real) > k:
            assert real[k - 1] - real[k] > 1e-4
    assert prob[BATCH] >= STAGE1_THRESHOLD
    passers = _passers_per_chunk(prob)
    assert passers[0] > k >= passers[1]

    got = run_pipeline_batched(
        make_v6_pipeline_gated(stages["port"], capacity=capacity,
                               stage1_threshold=STAGE1_THRESHOLD, device="cpu"),
        images, BATCH, device="cpu")
    want = jax_batched(jax_gated(stages["jax"], capacity=capacity,
                                 stage1_threshold=STAGE1_THRESHOLD), images, BATCH)
    assert got["overflow"].tolist() == [passers[0] - k, 0]
    _check_against_jax(got, want, stages["sure"])
    fallback = (got["stage1_pred"] == 1) & (got["stage2_pred"] < 0)
    want_fallback = (np.asarray(want["stage1_pred"]) == 1) & (np.asarray(want["stage2_pred"]) < 0)
    assert fallback.sum() == passers[0] - k
    np.testing.assert_array_equal(fallback, want_fallback)
    np.testing.assert_array_equal(got["final"][fallback], 1)


SWEEP = [
    {"threshold": 0.40, "gate_rate": 0.5},
    {"threshold": 0.45, "tp": 30, "fp": 10, "fn": 10, "tn": 50},  # counts only
]


@pytest.mark.parametrize("rows, threshold, margin", [
    (SWEEP, 0.40, 0.1), (SWEEP, 0.46, 0.1), (SWEEP, 0.45, 0.0),
    ([{"threshold": 0.4, "gate_rate": 0.99}], 0.4, 0.1),
    ([], 0.4, 0.1), (SWEEP, 0.60, 0.1),
    ([{"threshold": 0.4, "gate_rate": 0.5}], 0.55, 0.1),
])
def test_auto_capacity_equals_jax(rows, threshold, margin):
    try:
        want = jax_auto_capacity(rows, threshold, margin)
    except ValueError as exc:
        with pytest.raises(ValueError) as caught:
            auto_capacity(rows, threshold, margin)
        assert str(caught.value) == str(exc)
        return
    assert auto_capacity(rows, threshold, margin) == want


def test_batched_pads_the_tail_for_gated_predictors_only():
    """F3: a predictor with ``accepts_valid`` gets every chunk at the batch
    size with the real row count; a 0-d output gathers to one entry per
    chunk; a per-sample predictor runs the tail at its own size. Both
    packages return the same arrays."""
    images = images_u16(7, 70, 8)

    def port_gated(chunk, valid):
        return {"row_sum": chunk.to(torch.int64).sum(dim=(1, 2, 3)),
                "rows": torch.tensor(chunk.shape[0]), "valid": torch.tensor(valid)}

    def jax_gated_fn(chunk, valid):
        return {"row_sum": jnp.sum(chunk.astype(jnp.int32), axis=(1, 2, 3)),
                "rows": jnp.int32(chunk.shape[0]), "valid": jnp.int32(valid)}

    port_gated.accepts_valid = jax_gated_fn.accepts_valid = True
    got = run_pipeline_batched(port_gated, images, 32, device="cpu")
    want = jax_batched(jax_gated_fn, images, 32)
    assert got["rows"].tolist() == [32, 32, 32]
    assert got["valid"].tolist() == [32, 32, 6]
    np.testing.assert_array_equal(got["row_sum"], images.astype(np.int64).sum(axis=(1, 2, 3)))
    for key in want:
        np.testing.assert_array_equal(got[key], np.asarray(want[key]))

    seen = []

    def per_sample(chunk):
        seen.append(chunk.shape[0])
        return {"row_sum": chunk.to(torch.int64).sum(dim=(1, 2, 3)),
                "rows": torch.tensor(chunk.shape[0])}

    got = run_pipeline_batched(per_sample, images, 32, device="cpu")
    assert seen == [32, 32, 6] and got["rows"].tolist() == seen
    np.testing.assert_array_equal(got["row_sum"], images.astype(np.int64).sum(axis=(1, 2, 3)))


@pytest.mark.parametrize("build", [make_v6_pipeline_folded, make_v6_pipeline_gated],
                         ids=lambda f: f.__name__)
def test_mesh_raises_and_names_m11(stages, build):
    """F6: every pipeline constructor refuses a mesh and names the ROADMAP item."""
    with pytest.raises(NotImplementedError, match="ROADMAP M11"):
        build(stages["port"], mesh=object(), device="cpu")


@pytest.mark.parametrize("capacity", [0.0, -0.5, 1.5, math.inf])
def test_bad_capacity_raises_as_in_jax(stages, capacity):
    with pytest.raises(ValueError) as want:
        jax_gated(stages["jax"], capacity=capacity)
    with pytest.raises(ValueError) as got:
        make_v6_pipeline_gated(stages["port"], capacity=capacity, device="cpu")
    assert str(got.value) == str(want.value)
