"""Port parity: partition-tree assembly, ingest and the 64->32->16->8 cascade
against the JAX package, on the CPU.

Everything here is integer-valued, so equality is exact: trees, ``modes_*``
and ``overflow_*`` of ``predict_partition_trees`` must equal the JAX
function's, dense, gated with K covering the live set, and gated under
overflow (where which nodes the top-K keeps decides the trees). The real
predictors are the fp32 folded pipelines of sixteen seeded stage models (four
stages at four block sizes) and of four unified models, carried across with
``to_jax_variables``; their decisions agree exactly unless a logit margin sits
inside float noise, and a seed whose margins do is replaced, not tolerated.
The cascades run on the superblocks of a ``tree_corpus`` of the port's
``data.synth_tree``, whose ground-truth trees the composed trees are scored
against with ``tree_accuracy``, equal in both packages.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from av1tpu.codec import tree as jax_tree
from av1tpu.eval import PipelineModels as JaxModels
from av1tpu.eval import make_unified_pipeline_folded as jax_unified_folded
from av1tpu.eval import make_v6_pipeline_folded as jax_folded
from av1tpu.eval import tree_infer as jax_infer
from av1tpu.eval import tree_metrics as jax_metrics
from av1tpu.ingest import tiler as jax_tiler
from av1tpu.ingest import yuv as jax_yuv
from av1tpu_torch.codec import tree as port_tree
from av1tpu_torch.codec.partitions import PARTITION_SPLIT
from av1tpu_torch.data.synth_tree import tree_corpus
from av1tpu_torch.eval import (
    PipelineModels,
    make_unified_pipeline_folded,
    make_v6_pipeline_folded,
    predict_frame_trees,
    predict_partition_trees,
    quad_tile_on_device,
    tree_accuracy,
)
from av1tpu_torch.ingest import tiler as port_tiler
from av1tpu_torch.ingest import yuv as port_yuv
from tests.torch_port_fixtures import (
    LEVEL_SIZES,
    STAGE1_THRESHOLD,
    STAGE_CLASSES,
    cascade_stage_models,
    cascade_unified_models,
    jax_variables,
    superblocks_u16,
    world_of_one,
)

CAPACITIES = {  # name -> level_capacities
    "dense": None,
    "gated_exact": {32: 0.9, 16: 0.8, 8: 0.7},
    "gated_overflow": {32: 0.5, 16: 0.2, 8: 0.05},
}
# The seeded models keep about 4% of the corpus's 8 px nodes alive: the
# folded cascade overflows that level at a capacity of 2%.
FOLDED_CAPACITIES = {**CAPACITIES, "gated_overflow": {32: 0.5, 16: 0.2, 8: 0.02}}


def _corpus(seed, n):
    """``(superblocks (n, 64, 64) uint16, ground-truth trees (n, 85))`` of the
    port's ``tree_corpus``."""
    sbs, trees, _ = tree_corpus(n, seed=seed)
    return sbs[..., 0], trees


def _level_modes(seed, n):
    """Random raw modes per level with SPLIT (3) on about half the nodes."""
    rng = np.random.default_rng(seed)
    return [np.where(rng.random((n, nodes)) < 0.5, PARTITION_SPLIT,
                     rng.integers(0, 8, (n, nodes))).astype(np.int32)
            for nodes in port_tree.NODES_PER_LEVEL]


def test_tree_constants_equal_the_jax_package():
    assert port_tree.__all__ == jax_tree.__all__
    for name in ("LEVEL_SIZES", "NODES_PER_LEVEL", "TREE_SLOTS", "LEVEL_OFFSETS"):
        assert getattr(port_tree, name) == getattr(jax_tree, name)


@pytest.mark.parametrize("kind", ["numpy", "torch"])
def test_assemble_trees_equals_the_jax_package(kind):
    """On numpy arrays against the JAX package on numpy and on jax arrays; on
    torch tensors the result is a tensor with the same values and dtype."""
    levels = _level_modes(1, 33)
    want = jax_tree.assemble_trees(levels)
    want_jax = np.asarray(jax_tree.assemble_trees([jnp.asarray(m) for m in levels]))
    np.testing.assert_array_equal(want, want_jax)
    assert (want[:, 21:] >= 0).mean() > 0.05  # some trees reach the 8 px level
    if kind == "numpy":
        got = port_tree.assemble_trees(levels)
    else:
        got = port_tree.assemble_trees([torch.from_numpy(m) for m in levels])
        assert isinstance(got, torch.Tensor)
        got = got.numpy()
    assert got.dtype == want.dtype and got.shape == (33, 85)
    np.testing.assert_array_equal(got, want)


def test_tree_helpers_equal_the_jax_package():
    trees = port_tree.assemble_trees(_level_modes(2, 17))
    assert port_tree.tree_depth_stats(trees) == jax_tree.tree_depth_stats(trees)
    for row in trees[:5]:
        assert port_tree.tree_to_nested(row) == jax_tree.tree_to_nested(row)
    sbs = superblocks_u16(3, 3)
    got, want = port_tree.flatten_superblock(sbs), jax_tree.flatten_superblock(sbs)
    assert sorted(got) == sorted(want) == sorted(LEVEL_SIZES)
    for size in LEVEL_SIZES:
        np.testing.assert_array_equal(got[size], want[size])


def test_tree_accuracy_equals_the_jax_package():
    pred = port_tree.assemble_trees(_level_modes(4, 40))
    true = _corpus(5, 40)[1].astype(pred.dtype)
    true[:10] = pred[:10]
    got = tree_accuracy(pred, true)
    assert got == jax_metrics.tree_accuracy(pred, true)
    assert 0.2 < got["exact_tree_match"] < 0.9
    with pytest.raises(ValueError, match="shape mismatch"):
        tree_accuracy(pred, true[:5])


@pytest.mark.parametrize("size", LEVEL_SIZES)
def test_quad_tile_on_device_equals_quad_tile(size):
    """The tensor tiling against the numpy ``_quad_tile`` of both packages
    and against the JAX package's device tiling, on uint16 and on the int16
    view that the cascade tiles."""
    sbs = superblocks_u16(6, 5)
    want = jax_tree._quad_tile(sbs, size).reshape(-1, size, size)[..., None]
    np.testing.assert_array_equal(
        port_tree._quad_tile(sbs, size).reshape(-1, size, size)[..., None], want)
    np.testing.assert_array_equal(
        np.asarray(jax_infer.quad_tile_on_device(jnp.asarray(sbs), size)), want)
    got = quad_tile_on_device(torch.from_numpy(sbs), size)
    assert got.dtype == torch.uint16 and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    viewed = quad_tile_on_device(torch.from_numpy(sbs).view(torch.int16), size)
    np.testing.assert_array_equal(viewed.view(torch.uint16).numpy(), want)


@pytest.mark.parametrize("shape", [(64, 128), (100, 150), (1080, 1920)])
def test_tiling_equals_the_jax_package(shape):
    """Multiples of 64, a frame padded on both sides, and 1080p (17 x 30)."""
    rng = np.random.default_rng(shape[0])
    frames = rng.integers(0, 1024, (2,) + shape, dtype=np.uint16)
    for bs in (64, 16):
        got, grid = port_tiler.tile_frame(frames[0], bs)
        want, want_grid = jax_tiler.tile_frame(frames[0], bs)
        np.testing.assert_array_equal(got, want)
        assert (grid.num_rows, grid.num_cols, grid.num_blocks) == (
            want_grid.num_rows, want_grid.num_cols, want_grid.num_blocks)
        got, _ = port_tiler.tile_frames(frames, bs)
        np.testing.assert_array_equal(got, jax_tiler.tile_frames(frames, bs)[0])
    if shape == (1080, 1920):
        assert port_tiler.tile_frame(frames[0], 64)[1].num_blocks == 510


def test_yuv_reading_equals_the_jax_package(tmp_path):
    w, h, n = 72, 40, 3
    rng = np.random.default_rng(9)
    path = tmp_path / f"clip_{w}x{h}_30.yuv"
    with open(path, "wb") as f:
        for _ in range(n):
            f.write(rng.integers(0, 1024, h * w, dtype="<u2").tobytes())
            f.write(rng.integers(0, 1024, 2 * (h // 2) * (w // 2), dtype="<u2").tobytes())
    assert port_yuv.infer_resolution(path.name) == jax_yuv.infer_resolution(path.name) == (w, h)
    geom, jgeom = port_yuv.Yuv420p10Geometry(w, h), jax_yuv.Yuv420p10Geometry(w, h)
    assert geom.frame_bytes == jgeom.frame_bytes
    assert geom.validate_file(path) == jgeom.validate_file(path) == (n, 0)
    for i in range(n):
        np.testing.assert_array_equal(port_yuv.read_y_frame(path, i, geom),
                                      jax_yuv.read_y_frame(path, i, jgeom))
    np.testing.assert_array_equal(
        port_yuv.read_y_frames_batch(path, geom, [2, 0]),
        jax_yuv.read_y_frames_batch(path, jgeom, [2, 0]))
    assert len(list(port_yuv.iter_y_frames(path, geom, start=1))) == 2
    with pytest.raises(EOFError):
        port_yuv.read_y_frame(path, n, geom)


# ---------------------------------------------------------------------------
# The cascade with stub predictors: exact integer functions of the block
# ---------------------------------------------------------------------------


def _stub_final(total, xp):
    """Final v6 ids from a block's pixel sum: SPLIT (1) on two thirds of the
    blocks, else one of the eight ids."""
    return xp.where(total % 3 != 0, 1, total % 8)


def _jax_stub(images):
    total = jnp.sum(images.astype(jnp.int32), axis=(1, 2, 3))
    return {"final": _stub_final(total, jnp).astype(jnp.int32)}


def _port_stub(images):
    total = images.to(torch.int32).sum(dim=(1, 2, 3))
    return {"final": _stub_final(total, torch).to(torch.int32)}


def _assert_same_result(got, want):
    assert sorted(got) == sorted(want)
    for key, value in want.items():
        if key.startswith("overflow_"):
            assert isinstance(got[key], int) and got[key] == value, key
        else:
            assert got[key].dtype == value.dtype, key
            np.testing.assert_array_equal(got[key], value, err_msg=key)


@pytest.mark.parametrize("case", list(CAPACITIES))
def test_cascade_with_stub_predictors_equals_jax(case):
    """Batches of 100 leave ragged tails at every level. Under overflow the
    kept nodes, and at dead slots the evaluated ones, depend on the order in
    which the selection takes equal scores: ``modes_*`` is compared whole."""
    sbs = _corpus(11, 10)[0]
    want = jax_infer.predict_partition_trees(
        sbs, {s: _jax_stub for s in LEVEL_SIZES}, batch_size=100,
        level_capacities=CAPACITIES[case])
    got = predict_partition_trees(
        sbs, {s: _port_stub for s in LEVEL_SIZES}, batch_size=100,
        level_capacities=CAPACITIES[case], device="cpu")
    _assert_same_result(got, want)
    assert (want["trees"][:, 21:] >= 0).any()
    overflow = [want[f"overflow_{s}"] for s in (32, 16, 8) if case != "dense"]
    if case == "gated_exact":
        assert overflow == [0, 0, 0]
    if case == "gated_overflow":
        assert min(overflow) > 0


def test_gate_is_exact_when_k_covers_the_live_set():
    sbs = _corpus(12, 8)[0]
    preds = {s: _port_stub for s in LEVEL_SIZES}
    dense = predict_partition_trees(sbs, preds, 64, device="cpu")
    gated = predict_partition_trees(sbs, preds, 64, device="cpu",
                                    level_capacities=CAPACITIES["gated_exact"])
    np.testing.assert_array_equal(gated["trees"], dense["trees"])
    short = predict_partition_trees(sbs, preds, 64, device="cpu",
                                    level_capacities=CAPACITIES["gated_overflow"])
    assert (short["trees"] != dense["trees"]).any()


def test_as_numpy_false_returns_tensors_with_the_same_values():
    sbs = _corpus(13, 6)[0]
    preds = {s: _port_stub for s in LEVEL_SIZES}
    caps = CAPACITIES["gated_overflow"]
    host = predict_partition_trees(sbs, preds, 64, level_capacities=caps, device="cpu")
    dev = predict_partition_trees(torch.from_numpy(sbs)[..., None], preds, 64,
                                  level_capacities=caps, device="cpu", as_numpy=False)
    assert sorted(dev) == sorted(host)
    for key, value in dev.items():
        assert isinstance(value, torch.Tensor), key
        if key.startswith("overflow_"):
            assert value.dim() == 0 and value.dtype == torch.int32
            assert int(value) == host[key]
        else:
            np.testing.assert_array_equal(value.numpy(), host[key])


def test_predict_frame_trees_grid_equals_jax():
    """A 100 x 150 plane pads to 2 x 3 superblocks, row-major."""
    plane = np.random.default_rng(14).integers(0, 1024, (100, 150), dtype=np.uint16)
    want = jax_infer.predict_frame_trees(plane, {s: _jax_stub for s in LEVEL_SIZES}, 64)
    got = predict_frame_trees(plane, {s: _port_stub for s in LEVEL_SIZES}, 64,
                              device="cpu")
    np.testing.assert_array_equal(got["grid_shape"], [2, 3])
    assert got["grid_shape"].dtype == want["grid_shape"].dtype
    assert got["trees"].shape == (6, 85)
    _assert_same_result(got, want)


def test_cascade_argument_errors(tmp_path):
    """The cascade's refusals. A mesh (ROADMAP M11) is no longer one: on a
    mesh of one process the trees equal those of no mesh, as the JAX
    package's one-device mesh gives them."""
    sbs = superblocks_u16(15, 2)
    preds = {s: _port_stub for s in LEVEL_SIZES}
    with pytest.raises(ValueError, match="missing level predictors.*8"):
        predict_partition_trees(sbs, {s: _port_stub for s in (64, 32, 16)}, device="cpu")
    with pytest.raises(ValueError, match="capacities must be in"):
        predict_partition_trees(sbs, preds, level_capacities={16: 0.0}, device="cpu")
    caps = {32: 0.75, 16: 0.5, 8: 0.25}
    want = predict_partition_trees(sbs, preds, level_capacities=caps, device="cpu")
    with world_of_one(tmp_path) as mesh:
        got = predict_partition_trees(sbs, preds, mesh=mesh, level_capacities=caps,
                                      device="cpu")
    _assert_same_result(got, want)
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            predict_partition_trees(sbs, preds)  # the card is the default


# ---------------------------------------------------------------------------
# The cascade with the folded pipelines of sixteen seeded models
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def predictors():
    """``get(family) -> (jax predictors, port predictors)`` per block size, fp32
    folded: the four per-stage models with the plain front, or one unified
    model with ``use_fused_front="g1"`` (the JAX kernel in interpret mode, the
    port's on its plain version; at 64 and 32 px both take the plain front)."""
    cache = {}

    def get(family):
        if family in cache:
            return cache[family]
        jax_preds, port_preds = {}, {}
        if family == "stages":
            for size, stages in cascade_stage_models(seed=300).items():
                jm_args = [x for name, m in stages.items()
                           for x in (STAGE_CLASSES[name][0](), jax_variables(m))]
                jax_preds[size] = jax_folded(
                    JaxModels(*jm_args), stage1_threshold=STAGE1_THRESHOLD,
                    float_dtype=jnp.float32)
                port_preds[size] = make_v6_pipeline_folded(
                    PipelineModels(*stages.values()), stage1_threshold=STAGE1_THRESHOLD,
                    float_dtype=torch.float32, device="cpu")
        else:
            for size, model in cascade_unified_models(seed=320).items():
                jax_preds[size] = jax_unified_folded(
                    jax_variables(model), stage1_threshold=STAGE1_THRESHOLD,
                    float_dtype=jnp.float32, use_fused_front="g1", interpret=True)
                port_preds[size] = make_unified_pipeline_folded(
                    model, stage1_threshold=STAGE1_THRESHOLD, float_dtype=torch.float32,
                    use_fused_front="g1", device="cpu")
        cache[family] = (jax_preds, port_preds)
        return cache[family]

    return get


@pytest.mark.parametrize("family, case", [
    ("stages", "dense"), ("stages", "gated_exact"), ("stages", "gated_overflow"),
    ("unified_g1", "dense"),
])
def test_cascade_with_folded_predictors_equals_jax(predictors, family, case):
    jax_preds, port_preds = predictors(family)
    sbs, truth = _corpus(310, 12)
    want = jax_infer.predict_partition_trees(
        sbs, jax_preds, batch_size=128, level_capacities=FOLDED_CAPACITIES[case])
    got = predict_partition_trees(sbs, port_preds, batch_size=128,
                                  level_capacities=FOLDED_CAPACITIES[case], device="cpu")
    _assert_same_result(got, want)
    # the composed trees scored against the corpus's ground truth
    accuracy = tree_accuracy(got["trees"], truth)
    assert accuracy == jax_metrics.tree_accuracy(want["trees"], truth)
    trees = want["trees"]
    assert len(np.unique(trees[trees >= 0])) >= 4  # several modes, not one
    reached = (trees >= 0).sum(axis=1)
    assert reached.min() < 21 < reached.max()  # shallow trees and 8 px leaves
    if case == "gated_overflow":
        assert want["overflow_8"] > 0
