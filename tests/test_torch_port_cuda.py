"""The port's CUDA kernels on a card against their plain versions:
K1 and K2 (fused fronts), K3a and K3b (preprocess), K4 (fused dense,
forward and backward) and K5 (layer groups 1-2), also at the row counts the
64->32->16->8 tree cascade gives them, and the cascade on the card against
the cascade on the CPU.

These tests need a card: they carry the ``cuda`` marker and skip without
one. This file imports no jax, so it runs where jax is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py
"""
import copy

import numpy as np
import pytest
import torch

from av1tpu_torch.kernels import _build
from av1tpu_torch.kernels import fused_front as ff
from av1tpu_torch.kernels import preprocess as pp
from av1tpu_torch.kernels import resnet_group as rg
from av1tpu_torch.kernels.fused_dense import (
    ACTS,
    fused_dense,
    fused_dense_reference,
    takes_fast_path,
)
from av1tpu_torch.eval import (
    PipelineModels,
    make_v6_pipeline_folded,
    predict_partition_trees,
)
from av1tpu_torch.models import Stage1Model, Stage2Model, Stage3ABModel, Stage3RectModel
from av1tpu_torch.quant.ptq import fold_backbone

RAGGED = 4099  # not a multiple of any kernel's samples per block
FP32_TOL = {"fused_front": 1e-5, "fused_front_g1": 5e-5}
FP32_REL_TOL = {"fused_group12": 2e-5, "fused_dense": 1e-5}  # of max(1, max|plain|)
BF16_REL_TOL = 1e-2  # of max(1, max|plain|)


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _calibrated(cls, seed):
    """A model whose BN running stats are a random batch's own statistics:
    activations stay near unit scale, as in a trained net."""
    torch.manual_seed(seed)
    model = cls()
    for m in model.modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            m.reset_running_stats()
            m.momentum = None  # cumulative average: one batch's statistics
    with torch.no_grad():
        model.train()
        model(torch.randint(0, 1024, (256, 16, 16, 1)).float() / 1023.0)
    return model.eval()


@pytest.fixture(scope="module")
def folded():
    """The folded backbone of a calibrated stage-1 model."""
    return fold_backbone(_calibrated(Stage1Model, 0).backbone)


def _args(name, folded, dtype, card):
    if name == "fused_front":
        w, b = ff.stem_weights(folded["stem"]["weight"], folded["stem"]["bias"], dtype)
        return ff.fused_front, ff.fused_front_reference, (w.to(card), b.to(card))
    return (ff.fused_front_g1, ff.fused_front_g1_reference,
            tuple(a.to(card) for a in ff.g1_weights(folded, dtype)))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("batch, layout", [(1, "aligned"), (255, "aligned"),
                                           (RAGGED, "aligned"), (RAGGED, "offset_by_one")])
@pytest.mark.parametrize("hw", [8, 16])
@pytest.mark.parametrize("name", ["fused_front", "fused_front_g1"])
def test_kernel_matches_plain_version(card, folded, name, hw, batch, layout, dtype):
    """One sample, one short of a bf16 K1/K2 block's multiple, and a ragged
    batch; and a contiguous view that starts one value into its buffer, off the
    16-byte grid of the bf16 kernels' vector loads. In bf16 few outputs differ
    from the plain version at all (measured on an H100: K1 under 0.001%, K2
    up to 1.6%, each by one bf16 step)."""
    gen = torch.Generator().manual_seed(hw)
    x = (torch.randint(0, 1024, (batch * hw * hw + 1,), generator=gen).float()
         / 1023.0).to(card, dtype)
    x = x[1:] if layout == "offset_by_one" else x[:-1]
    x = x.view(batch, hw, hw, 1)
    assert x.is_contiguous() and (x.data_ptr() % 16 != 0) == (layout == "offset_by_one")
    kernel, plain, args = _args(name, folded, dtype, card)
    before = ff.launch_counts[name]
    got = kernel(x, *args)
    torch.cuda.synchronize()
    assert ff.launch_counts[name] == before + 1
    want = plain(x, *args)
    assert got.shape == want.shape and got.dtype == want.dtype
    scale = want.float().abs().max().item()
    assert want.float().std().item() >= 1e-2
    tol = FP32_TOL[name] if dtype == torch.float32 else BF16_REL_TOL * max(1.0, scale)
    assert (got.float() - want.float()).abs().max().item() <= tol
    if dtype == torch.bfloat16:
        assert (got != want).float().mean().item() < 0.05


@pytest.mark.cuda
def test_wrapper_rejects_weights_on_another_device(card, folded):
    w, b = ff.stem_weights(folded["stem"]["weight"], folded["stem"]["bias"],
                           torch.float32)
    x = torch.zeros(4, 16, 16, 1, device=card)
    with pytest.raises(ValueError, match="expected cuda"):
        ff.fused_front(x, w, b)


def _close(got, want, rel_tol):
    assert got.shape == want.shape and got.dtype == want.dtype
    scale = want.float().abs().max().item()
    assert want.float().std().item() >= 1e-2
    err = (got.float() - want.float()).abs().max().item()
    assert err <= rel_tol * max(1.0, scale), (err, scale)


def _codes(seed, shape):
    """Seeded 10-bit codes as uint16."""
    return np.random.default_rng(seed).integers(0, 1024, size=shape, dtype=np.uint16)


def _counted(name, fn, *args, **kwargs):
    before = _build.launch_counts[name]
    out = fn(*args, **kwargs)
    torch.cuda.synchronize()
    assert _build.launch_counts[name] == before + 1
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("e", [2, 4, 8, 16])
def test_group12_matches_plain_version(card, folded, e, dtype):
    """K5 on the stem's output of ragged batches of 4e px blocks."""
    gen = torch.Generator().manual_seed(e)
    img = (torch.randint(0, 1024, (RAGGED, 4 * e, 4 * e, 1), generator=gen).float()
           / 1023.0).to(card)
    stem = ff.stem_weights(folded["stem"]["weight"], folded["stem"]["bias"],
                           torch.float32)
    x = ff.fused_front_reference(img, *(t.to(card) for t in stem)).to(dtype)
    weights = tuple(w.to(card) for w in rg.pack_group12_weights(folded, dtype))
    stream = rg.group12_conv_stream(weights) if dtype == torch.bfloat16 else None
    got = _counted("fused_group12", rg.fused_group12, x, weights, stream)
    want = rg.fused_group12_reference(x, weights)
    tol = FP32_REL_TOL["fused_group12"] if dtype == torch.float32 else BF16_REL_TOL
    _close(got, want, tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("bs", [4, 16, 64])
def test_tile_normalize_matches_plain_version_exactly(card, bs, dtype):
    """bs 4 takes the one-value path, 16 and 64 the 8-value path."""
    frames = torch.from_numpy(_codes(bs, (3, 1088, 1920))).to(card)
    got = _counted("tile_normalize_frames", pp.tile_normalize_frames, frames, bs,
                   dtype)
    want = pp.tile_normalize_reference(frames, bs, dtype)
    assert got.shape == want.shape == (3 * 1088 * 1920 // bs ** 2, bs, bs, 1)
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("layout", ["aligned", "offset_by_one"])
def test_normalize_blocks_matches_plain_version_exactly(card, layout, dtype):
    """Ragged N; a view one value into the buffer takes the unaligned path
    and ends in a partial vector."""
    blocks = torch.from_numpy(_codes(7, (RAGGED, 16, 16, 1))).to(card)
    if layout == "offset_by_one":
        blocks = blocks.view(-1)[1:]
    got = _counted("normalize_blocks", pp.normalize_blocks, blocks, dtype)
    assert got.shape == blocks.shape
    assert torch.equal(got, pp.normalize_blocks_reference(blocks, dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("act", ["linear", "relu", "silu", "sigmoid"])
def test_fused_dense_matches_plain_version(card, act, dtype):
    """A ragged M and a K and N off the 16-byte rows: the general kernel."""
    gen = torch.Generator().manual_seed(3)
    x = torch.randn(RAGGED, 500, generator=gen).to(card, dtype)
    w = (torch.randn(500, 250, generator=gen) * 0.05).to(card, dtype)
    b = torch.randn(250, generator=gen).to(card)
    got = _counted("fused_dense", fused_dense, x, w, b, act)
    tol = FP32_REL_TOL["fused_dense"] if dtype == torch.float32 else BF16_REL_TOL
    _close(got, fused_dense_reference(x, w, b, act), tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("k, n, fast", [(512, 256, True), (4096, 256, True),
                                        (40, 24, True), (500, 250, False),
                                        (512, 250, False)])
def test_fused_dense_kernels_match_plain_version(card, k, n, fast, dtype):
    """Aligned (K, N) take the tensor-core kernel, others the general one;
    both match the plain version at a ragged M. fp32 on the tensor cores is
    also held to the library's distance from a float64 product."""
    gen = torch.Generator().manual_seed(k + n)
    x = torch.randn(RAGGED, k, generator=gen).to(card, dtype)
    w = (torch.randn(k, n, generator=gen) / k ** 0.5).to(card, dtype)
    b = torch.randn(n, generator=gen).to(card)
    assert takes_fast_path(x, w) is fast
    got = _counted("fused_dense", fused_dense, x, w, b, "linear")
    want = fused_dense_reference(x, w, b, "linear")
    tol = FP32_REL_TOL["fused_dense"] if dtype == torch.float32 else BF16_REL_TOL
    _close(got, want, tol)
    if fast and dtype == torch.float32:
        exact = x.double() @ w.double() + b.double()
        ours = (got.double() - exact).abs().max().item()
        library = (want.double() - exact).abs().max().item()
        assert ours <= 1.25 * library, (ours, library)


@pytest.mark.cuda
@pytest.mark.parametrize("e", [2, 4, 8, 16])
def test_group12_bf16_with_a_prebuilt_conv_stream(card, folded, e):
    """The serving call: bf16, the conv stream built once. Few outputs differ
    from the plain version at all, and none by more than the tolerance."""
    gen = torch.Generator().manual_seed(20 + e)
    img = (torch.randint(0, 1024, (RAGGED, 4 * e, 4 * e, 1), generator=gen).float()
           / 1023.0).to(card)
    stem = ff.stem_weights(folded["stem"]["weight"], folded["stem"]["bias"],
                           torch.float32)
    x = ff.fused_front_reference(img, *(t.to(card) for t in stem)).bfloat16()
    weights = tuple(w.to(card) for w in rg.pack_group12_weights(folded, torch.bfloat16))
    stream = rg.group12_conv_stream(weights)
    got = _counted("fused_group12", rg.fused_group12, x, weights, stream)
    want = rg.fused_group12_reference(x, weights)
    _close(got, want, BF16_REL_TOL)
    assert (got != want).float().mean().item() < 0.02
    for bad in (None, stream[:-8]):
        with pytest.raises(ValueError, match="conv_stream"):
            rg.fused_group12(x, weights, bad)


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [1, 63, RAGGED])
@pytest.mark.parametrize("e", [2, 4, 8, 16])
def test_group12_bf16_off_whole_clusters(card, folded, e, batch):
    """The wgmma kernel at batches that fill no whole cluster of two blocks of
    ``rg.samples_per_block(e)`` samples: one sample, 63 and a ragged 4,099,
    against the plain version, and the same output on a second call."""
    gen = torch.Generator().manual_seed(40 + e + batch)
    img = (torch.randint(0, 1024, (batch, 4 * e, 4 * e, 1), generator=gen).float()
           / 1023.0).to(card)
    stem = ff.stem_weights(folded["stem"]["weight"], folded["stem"]["bias"],
                           torch.float32)
    x = ff.fused_front_reference(img, *(t.to(card) for t in stem)).bfloat16()
    weights = tuple(w.to(card) for w in rg.pack_group12_weights(folded, torch.bfloat16))
    stream = rg.group12_conv_stream(weights)
    got = _counted("fused_group12", rg.fused_group12, x, weights, stream)
    _close(got, rg.fused_group12_reference(x, weights), BF16_REL_TOL)
    assert torch.equal(got, rg.fused_group12(x, weights, stream))


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [1, 63, 127, RAGGED, 16384])
@pytest.mark.parametrize("hw", [8, 16])
@pytest.mark.parametrize("name", ["fused_front", "fused_front_g1"])
def test_fronts_wgmma_at_block_and_group_edges(card, folded, name, hw, batch):
    """The bf16 wgmma kernels at batches that end inside a block, a cluster
    of two K2 blocks (16 or 32 samples each) and a K1 worker's group (2 or 4
    samples), and at 16,384 samples (K1's workers take several groups each):
    against the plain version, and the same output on a second call."""
    gen = torch.Generator().manual_seed(60 + hw + batch)
    x = (torch.randint(0, 1024, (batch, hw, hw, 1), generator=gen).float()
         / 1023.0).to(card, torch.bfloat16)
    kernel, plain, args = _args(name, folded, torch.bfloat16, card)
    got = _counted(name, kernel, x, *args)
    _close(got, plain(x, *args), BF16_REL_TOL)
    assert torch.equal(got, kernel(x, *args))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("m", [1, 65, RAGGED])
def test_fused_dense_wgmma_at_ragged_rows(card, m, dtype):
    """The tensor-core kernel (128-row tiles) at one row, one past a warpgroup's
    64 and a ragged 4,099, a v6 head's first layer, relu."""
    gen = torch.Generator().manual_seed(m)
    x = torch.randn(m, 512, generator=gen).to(card, dtype)
    w = (torch.randn(512, 256, generator=gen) / 512 ** 0.5).to(card, dtype)
    b = torch.randn(256, generator=gen).to(card)
    assert takes_fast_path(x, w)
    got = _counted("fused_dense", fused_dense, x, w, b, "relu")
    tol = FP32_REL_TOL["fused_dense"] if dtype == torch.float32 else BF16_REL_TOL
    _close(got, fused_dense_reference(x, w, b, "relu"), tol)


GRAD_ATOL = {"x": 1e-4, "w": 5e-4, "b": 1e-4}


@pytest.mark.cuda
@pytest.mark.parametrize("act", ["linear", "relu", "silu", "sigmoid"])
def test_fused_dense_gradients_match_autograd(card, act):
    """Gradients of sum(out ** 2), fp32: the custom backward against float64
    autograd, at rtol 1e-3 / atol 1e-4 (tests/test_kernels.py). dW alone gets
    atol 5e-4: it is a torch fp32 product over 4099 rows in both paths, and
    at entries near zero that sum alone is 0.9e-4 (this path) to 2.4e-4
    (autograd through the plain version) from float64 on an H100."""
    gen = torch.Generator().manual_seed(4)
    data = (torch.randn(RAGGED, 512, generator=gen),
            torch.randn(512, 256, generator=gen) * 0.05,
            torch.randn(256, generator=gen))
    grads = []
    for fn, dtype in ((fused_dense, torch.float32),
                      (lambda x, w, b, a: ACTS[a](x @ w + b), torch.float64)):
        params = [t.to(card, dtype).requires_grad_() for t in data]
        (fn(*params, act) ** 2).sum().backward()
        grads.append([p.grad.double() for p in params])
    for arg, got, exact in zip("xwb", *grads):
        torch.testing.assert_close(got, exact, rtol=1e-3, atol=GRAD_ATOL[arg])


@pytest.mark.cuda
def test_kernel_launch_failure_raises(card):
    """A launch the kernel refuses raises instead of returning garbage."""
    with pytest.raises(RuntimeError, match="CUDA error"):
        _build.launch("normalize_blocks", 0, 0, 0, 0, 0)


# Rows per kernel call when one and four 1080p frames (510 superblocks each)
# go through the cascade at batch 4096: whole levels, full chunks and tails.
CASCADE_ROWS = {  # K5 extent (block px / 4) -> row counts
    16: (510, 2040), 8: (2040, 4096, 4064), 4: (4096, 4064, 3968), 2: (4096, 3968, 3584),
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["fused_front", "fused_front_g1"])
@pytest.mark.parametrize("hw, rows", [(16, 4064), (16, 3968), (8, 3968), (8, 3584)])
def test_fronts_at_the_cascade_row_counts(card, folded, name, hw, rows):
    """K1 and K2 in bf16 on the tails that 8,160 / 32,640 blocks (one frame)
    and four times those leave after 4,096-row chunks."""
    gen = torch.Generator().manual_seed(rows)
    x = (torch.randint(0, 1024, (rows, hw, hw, 1), generator=gen).float()
         / 1023.0).to(card, torch.bfloat16)
    kernel, plain, args = _args(name, folded, torch.bfloat16, card)
    got = _counted(name, kernel, x, *args)
    _close(got, plain(x, *args), BF16_REL_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("e, rows", [(e, r) for e, rs in CASCADE_ROWS.items() for r in rs])
def test_group12_at_the_cascade_row_counts(card, folded, e, rows):
    """K5 in bf16 at every level's extent and row counts."""
    gen = torch.Generator().manual_seed(e * rows)
    img = (torch.randint(0, 1024, (rows, 4 * e, 4 * e, 1), generator=gen).float()
           / 1023.0).to(card)
    stem = ff.stem_weights(folded["stem"]["weight"], folded["stem"]["bias"],
                           torch.float32)
    x = ff.fused_front_reference(img, *(t.to(card) for t in stem)).bfloat16()
    weights = tuple(w.to(card) for w in rg.pack_group12_weights(folded, torch.bfloat16))
    got = _counted("fused_group12", rg.fused_group12, x, weights,
                   rg.group12_conv_stream(weights))
    _close(got, rg.fused_group12_reference(x, weights), BF16_REL_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("front, groups", [(False, False), ("g1", False), (True, True)],
                         ids=["off", "g1", "k1_k5"])
def test_cascade_on_the_card_matches_the_cpu(card, front, groups):
    """fp32 folded predictors (one set of seeded models for all four levels):
    the gated cascade over 64 superblocks on the card against the same call
    on the CPU. Slots may differ only where a decision's margin is inside
    fp32 noise, so at least 99% of the 85 x 64 slots agree, the overflow
    counts stay device scalars, and the fused kernels are launched."""
    models = PipelineModels(*(_calibrated(cls, seed) for seed, cls in enumerate(
        (Stage1Model, Stage2Model, Stage3RectModel, Stage3ABModel))))
    sbs = _codes(3, (64, 64, 64))
    caps = {32: 0.9, 16: 0.8, 8: 0.7}
    results = {}
    for device in ("cpu", card):
        predict = make_v6_pipeline_folded(
            models, float_dtype=torch.float32, use_fused_front=front,
            use_pallas_groups=groups, device=device)
        before = dict(_build.launch_counts)
        results[str(device)] = predict_partition_trees(
            sbs, {s: predict for s in (64, 32, 16, 8)}, batch_size=4096,
            level_capacities=caps, device=device, as_numpy=False)
        launched = {k: v - before[k] for k, v in _build.launch_counts.items()}
    got, want = results[str(card)], results["cpu"]
    assert got["trees"].is_cuda and got["overflow_8"].is_cuda
    assert got["overflow_8"].dim() == 0
    assert (got["trees"].cpu() == want["trees"]).float().mean().item() >= 0.99
    assert launched["fused_front_g1"] == (8 if front == "g1" else 0)
    assert launched["fused_front"] == (8 if front is True else 0)
    assert launched["fused_group12"] == (16 if groups else 0)


@pytest.mark.cuda
def test_prefetch_on_the_card_equals_the_serial_loop(card, tmp_path):
    """``run_pipeline_batched``'s producer (pinned ring, copies on a side
    stream) gives the serial loop's outputs bit for bit, on an array and on
    a memmap, with a ragged tail and with a capacity-gated predictor (whose
    tail is padded on the card); K2 launches once a stage a batch."""
    from av1tpu_torch.eval import make_v6_pipeline_gated, run_pipeline_batched

    models = PipelineModels(*(_calibrated(cls, seed) for seed, cls in enumerate(
        (Stage1Model, Stage2Model, Stage3RectModel, Stage3ABModel))))
    samples = _codes(4, (1000, 16, 16, 1))
    np.save(tmp_path / "blocks.npy", samples)
    memmap = np.load(tmp_path / "blocks.npy", mmap_mode="r")
    predicts = {
        "g1": make_v6_pipeline_folded(models, float_dtype=torch.bfloat16,
                                      use_fused_front="g1", device=card),
        "gated": make_v6_pipeline_gated(models, 0.5, input_dtype=torch.bfloat16,
                                        folded=True, device=card),
    }
    for name, predict in predicts.items():
        want = run_pipeline_batched(predict, samples, 128, card, prefetch=0)
        for blocks in (samples, memmap):
            for prefetch in (1, 2, 4):
                before = _build.launch_counts["fused_front_g1"]
                got = run_pipeline_batched(predict, blocks, 128, card, prefetch=prefetch)
                for key, value in want.items():
                    np.testing.assert_array_equal(got[key], value, err_msg=(name, key))
                if name == "g1":
                    assert _build.launch_counts["fused_front_g1"] - before == 4 * 8


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_stacked_backbones_on_the_card(card, dtype):
    """``make_v6_pipeline(stacked=True)`` (one vmapped forward of the four
    backbones, grouped convolutions) against the unstacked pipeline on 512
    blocks: stage-1 probabilities within 1e-5 in fp32 (0.02 in bf16) and the
    labels equal on 99% of the blocks."""
    from av1tpu_torch.eval import make_v6_pipeline

    models = PipelineModels(*(_calibrated(cls, seed) for seed, cls in enumerate(
        (Stage1Model, Stage2Model, Stage3RectModel, Stage3ABModel))))
    images = torch.from_numpy(_codes(5, (512, 16, 16, 1))).to(card)
    got, want = (make_v6_pipeline(models, input_dtype=dtype, device=card,
                                  stacked=stacked)(images) for stacked in (True, False))
    atol = 1e-5 if dtype == torch.float32 else 0.02
    assert (got["stage1_prob"] - want["stage1_prob"]).abs().max().item() <= atol
    assert (got["final"] == want["final"]).float().mean().item() >= 0.99


# ---------------------------------------------------------------------------
# Training on the card
# ---------------------------------------------------------------------------


def _train_batch(n, seed=5):
    gen = torch.Generator().manual_seed(seed)
    samples = torch.randint(0, 1024, (n, 16, 16, 1), generator=gen).to(torch.uint16)
    return samples, torch.randint(0, 3, (n,), generator=gen)


def _step_on(device, model_cls, variables, opt_fn, cfg, samples, labels):
    """One fp32 train step of a copy of the model on ``device``: the loss,
    the gradients before the optimizer, the state after it."""
    from av1tpu_torch.models import load_jax_variables
    from av1tpu_torch.train.trainer import TrainState, make_train_step

    model = load_jax_variables(model_cls(), variables).to(device)
    for mod in model.modules():
        if isinstance(mod, torch.nn.Dropout):
            mod.p = 0.0
    opt = opt_fn(model)
    grads, step = {}, opt.step
    names = {id(p): n for n, p in model.named_parameters()}

    def capturing_step():
        grads.update({names[id(p)]: (torch.zeros_like(p) if p.grad is None
                                     else p.grad.clone()).cpu() for p in opt.params})
        step()

    opt.step = capturing_step
    out = make_train_step(model, opt, cfg)(
        TrainState(model, opt), {"samples": samples.to(device),
                                 cfg.label_key: labels.to(device)},
        torch.Generator(device=device).manual_seed(0))
    return float(out["loss"]), grads, {k: v.cpu() for k, v in model.state_dict().items()}


def _float64_grads(model_cls, variables, cfg, samples, labels):
    """The step's gradients in float64 on the CPU (forward, loss, backward)."""
    from av1tpu_torch.models import load_jax_variables

    def to64(tree):
        return ({k: to64(v) for k, v in tree.items()} if isinstance(tree, dict)
                else np.asarray(tree, np.float64))

    model = load_jax_variables(model_cls().double(), to64(variables))
    for mod in model.modules():
        if isinstance(mod, torch.nn.Dropout):
            mod.p = 0.0
    model.train()
    cfg.loss_fn(model(samples.double() / 1023.0), labels).backward()
    return {n: p.grad for n, p in model.named_parameters() if p.grad is not None}


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["stage1_adamw", "stage2_frozen", "stage2_unfrozen"])
def test_train_step_on_the_card_matches_the_cpu(card, name):
    """The port's fp32 step (TF32 off) on the card against the CPU on the
    same weights and batch (no augment, dropout off): the loss within 1e-5
    rel, the BN statistics within 1e-5 of their largest entry, and the
    model's whole gradient no farther (relative L2) from a float64 run of the
    same step than twice the CPU's fp32 gradient is, no tensor off by more
    than 1e-2 of the largest entry. On these calibrated random models with
    uniform inputs some gradients are sums with heavy cancellation, where the
    CPU's own fp32 gradient is percents of a tensor's largest entry off the
    float64 one, so a fixed per-tensor tolerance does not separate right from
    wrong here; chip_smoke.py holds trained models to 1e-4 of each tensor's
    largest entry."""
    from av1tpu_torch.models import to_jax_variables
    from av1tpu_torch.train import losses, schedules
    from av1tpu_torch.train.trainer import StepConfig

    stage1 = name.startswith("stage1")
    cls = Stage1Model if stage1 else Stage2Model
    variables = to_jax_variables(_calibrated(cls, 7).state_dict())
    opt_fn = {
        "stage1_adamw": lambda m: schedules.as_optimizer(
            m, schedules.adamw(schedules.cosine_schedule(1e-3, 10))),
        "stage2_frozen": lambda m: schedules.ulmfit_phase1(m, 5e-4, 10),
        "stage2_unfrozen": lambda m: schedules.ulmfit_phase2(m, 5e-4, 1e-6, 10),
    }[name]
    cfg = StepConfig(
        loss_fn=(lambda lo, ta: losses.binary_focal_loss(lo, ta, 0.25, 2.5)) if stage1
        else (lambda lo, ta: losses.class_balanced_focal_loss(lo, ta, [3, 5, 4])),
        label_key="labels", binary=stage1, num_classes=2 if stage1 else 3)
    samples, labels = _train_batch(256)
    labels = labels.clamp(max=1) if stage1 else labels
    got = _step_on(card, cls, variables, opt_fn, cfg, samples, labels)
    want = _step_on("cpu", cls, variables, opt_fn, cfg, samples, labels)
    exact = _float64_grads(cls, variables, cfg, samples, labels)
    assert abs(got[0] - want[0]) <= 1e-5 * abs(want[0])
    assert set(got[1]) == set(want[1])
    names = sorted(want[1])
    ref = torch.cat([exact.get(n, torch.zeros(want[1][n].shape, dtype=torch.float64))
                     .reshape(-1) for n in names])  # a parameter the loss misses: zero
    dist = {side: ((torch.cat([grads[n].double().reshape(-1) for n in names]) - ref).norm()
                   / ref.norm()).item() for side, grads in (("card", got[1]), ("cpu", want[1]))}
    assert dist["card"] <= 2 * dist["cpu"] + 1e-6, dist
    largest = ref.abs().max().item()
    for n in names:  # and no tensor far off: a wrong gradient is off by its own size
        err = (got[1][n].double() - exact.get(n, 0.0)).abs().max().item()
        assert err <= 1e-2 * largest, (n, err, largest)
    for k, v in want[2].items():
        if k.endswith(("running_mean", "running_var")):
            assert (got[2][k] - v).abs().max().item() <= 1e-5 * v.abs().max().item(), k


@pytest.mark.cuda
def test_resident_and_streaming_epochs_agree_on_the_card(card):
    """One balanced epoch of Stage1Model at batch 64 over 512 blocks, from the
    same state and generator seed, resident and streamed, with cuDNN's
    deterministic algorithms (by default two runs of the same step on the card
    differ: cuDNN picks nondeterministic backward algorithms): the same
    samples, loss and final state, bitwise."""
    from av1tpu_torch.train import losses, schedules
    from av1tpu_torch.train.trainer import (
        StepConfig, TrainState, make_train_step, run_train_epoch, run_train_epoch_resident,
        to_device)

    samples, labels = _train_batch(512, seed=6)
    arrays = {"samples": samples.numpy(), "stage1": labels.clamp(max=1).int().numpy()}
    base = _calibrated(Stage1Model, 8).to(card)
    for mod in base.modules():
        if isinstance(mod, torch.nn.BatchNorm2d):
            mod.momentum = 0.1  # the trainer's (flax's) running-stat update
    results = {}
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    for mode in ("resident", "streaming"):
        torch.manual_seed(4)  # dropout draws from the global generator
        model = copy.deepcopy(base)
        opt = schedules.as_optimizer(model, schedules.adamw(1e-3))
        cfg = StepConfig(loss_fn=losses.binary_focal_loss, label_key="stage1", binary=True)
        step, state = make_train_step(model, opt, cfg), TrainState(model, opt)
        gen = torch.Generator(device=card).manual_seed(3)
        if mode == "resident":
            _, epoch = run_train_epoch_resident(step, state, to_device(arrays, card), 64, gen,
                                                11, 2, balance_labels=arrays["stage1"])
        else:
            _, epoch = run_train_epoch(step, state, arrays, 64, gen, 11, 2,
                                       balance_labels=arrays["stage1"], device=card)
        results[mode] = (epoch, {k: v.cpu() for k, v in model.state_dict().items()})
    torch.backends.cudnn.deterministic = deterministic
    (a, sa), (b, sb) = results["resident"], results["streaming"]
    assert a.samples == b.samples == 512
    assert a.loss == b.loss and a.metrics == b.metrics
    for k, v in sa.items():
        assert torch.equal(v, sb[k]), k


@pytest.mark.cuda
def test_checkpoint_round_trip_on_the_card(card, tmp_path):
    """A TrainState on the card (model, AdamW moments, step) saved with the
    bitwise verification and restored into a fresh state on the card."""
    from av1tpu_torch.train import checkpoint, schedules
    from av1tpu_torch.train.trainer import TrainState

    model = _calibrated(Stage2Model, 9).to(card).train()
    opt = schedules.ulmfit_phase2(model, 5e-4, 1e-6, 10)
    for p in model.parameters():
        p.grad = torch.randn_like(p)
    opt.step()
    state = TrainState(model, opt, step=1)
    checkpoint.save_checkpoint(tmp_path / "ck", state, meta={"epoch": 0}, verify=True)
    fresh = Stage2Model().to(card)
    template = TrainState(fresh, schedules.ulmfit_phase2(fresh, 5e-4, 1e-6, 10))
    restored, meta = checkpoint.restore_checkpoint(tmp_path / "ck", template)
    assert meta == {"epoch": 0} and restored.step == 1 and restored.optimizer.count == 1
    assert next(fresh.parameters()).is_cuda
    assert checkpoint.states_equal(state, restored)
