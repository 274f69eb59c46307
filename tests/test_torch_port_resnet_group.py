"""Port parity: kernel K5's plain version against the JAX Pallas kernel
``fused_group12`` in interpret mode, its weight packing, the
``group12_fn`` hook of the folded forward, and the wrapper's checks, on the
CPU.

The input of K5 is what the stem gives it: the plain K1 front of a
calibrated stage-1 backbone applied to seeded 10-bit blocks of 8, 16 and
32 px (extents 2, 4 and 8). fp32 is held to 1e-5 per unit of the largest
output: both sides sum in fp32 in different orders over eight convs, and
the JAX kernel alone already sits up to 9e-6 from a float64 evaluation at
outputs near 19. bf16 is held to one bf16 ulp of the largest output. The
CUDA kernel itself runs only on a card (``test_torch_port_cuda.py``,
``chip_smoke.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from av1tpu import models as jm
from av1tpu.kernels.resnet_group import fused_group12 as jax_group12
from av1tpu.kernels.resnet_group import pack_group12_weights as jax_pack
from av1tpu.quant.ptq import fold_backbone as jax_fold
from av1tpu_torch import models as tm
from av1tpu_torch.kernels import fused_front as ff
from av1tpu_torch.kernels import resnet_group as rg
from av1tpu_torch.kernels._build import launch_counts
from av1tpu_torch.quant.ptq import _backbone_apply, fold_backbone
from tests.torch_port_fixtures import calibrated_variables, images_u16

BATCH = 64
F32_REL_TOL = 1e-5  # of max(1, max|JAX output|)
DTYPES = {"fp32": (torch.float32, jnp.float32), "bf16": (torch.bfloat16, jnp.bfloat16)}


@pytest.fixture(scope="module")
def stage():
    """``get(e)``: (JAX folded tree, port folded tree, K5 input (B, e, e, 64)
    as fp32 numpy) for a stage-1 backbone calibrated at 4*e px."""
    cache = {}

    def get(e):
        if e not in cache:
            hw = 4 * e
            v = calibrated_variables(jm.Stage1Model(), 90 + e, hw)
            pf = fold_backbone(tm.load_jax_variables(tm.Stage1Model(), v).backbone)
            img = images_u16(10 + e, BATCH, hw).astype(np.float32) / 1023.0
            stem = ff.stem_weights(pf["stem"]["weight"], pf["stem"]["bias"], torch.float32)
            x = ff.fused_front_reference(torch.from_numpy(img), *stem).numpy()
            cache[e] = jax_fold(v), pf, x
        return cache[e]

    return get


def _ulp_bf16(v: float) -> float:
    return 2.0 ** (np.floor(np.log2(v)) - 7)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("e", [2, 4, 8])
def test_plain_group12_matches_pallas(stage, e, dtype):
    """Plain K5 == JAX fused_group12(interpret=True) on weights packed by
    each package from the same calibrated variables."""
    tdt, jdt = DTYPES[dtype]
    jf, pf, x = stage(e)
    jw = tuple(w.astype(jdt) for w in jax_pack(jf))
    want = np.asarray(jax_group12(jnp.asarray(x, jdt), jw, interpret=True),
                      dtype=np.float32)
    got = rg.fused_group12(torch.from_numpy(x).to(tdt),
                           rg.pack_group12_weights(pf, tdt))
    assert got.dtype == tdt
    got = got.float().numpy()
    assert got.shape == want.shape == (BATCH, e // 2, e // 2, 128)
    scale = float(np.abs(want).max())
    f32_tol = F32_REL_TOL * max(1.0, scale)
    # F2 guard: samples differ far above the fp32 tolerance
    flat = want.reshape(BATCH, -1)
    assert len(np.unique(flat.argmax(-1))) >= 2
    assert flat.std(axis=0).mean() >= 100 * f32_tol
    tol = f32_tol if dtype == "fp32" else _ulp_bf16(scale)
    np.testing.assert_allclose(got, want, atol=tol, rtol=0)


def test_pack_matches_jax_layouts(stage):
    """Each packed array is the JAX package's, in the layout the module
    docstring states, cast to the serving dtype."""
    jf, pf, _ = stage(4)
    for dtype in (torch.float32, torch.bfloat16):
        packed = rg.pack_group12_weights(pf, dtype)
        assert len(packed) == len(rg.PACK_ORDER) == 22
        for name, got, want in zip(rg.PACK_ORDER, packed, jax_pack(jf)):
            assert got.dtype == dtype and got.is_contiguous()
            assert tuple(got.shape) == rg.PACKED_SHAPES[name]
            want = np.asarray(want)
            if name.endswith(".k") and want.ndim == 4:
                want = want.reshape(9, *want.shape[2:])
            elif name.startswith("se"):
                want = want.T
            scale = max(1.0, float(np.abs(want).max()))
            tol = 1e-6 * scale if dtype == torch.float32 else _ulp_bf16(scale)
            np.testing.assert_allclose(got.float().numpy(), want, atol=tol, rtol=0,
                                       err_msg=name)


def test_backbone_hook_matches_plain_groups(stage):
    """The folded forward with ``group12_fn`` (after the plain stem and
    after ``front_fn``) equals the one without it, fp32 at 16 px."""
    _, pf, _ = stage(4)
    x = torch.from_numpy(images_u16(5, BATCH, 16).astype(np.float32) / 1023.0)
    packed = rg.pack_group12_weights(pf, torch.float32)
    front = ff.make_fused_front(pf["stem"]["weight"], pf["stem"]["bias"], 16,
                                float_dtype=torch.float32)
    want = _backbone_apply(pf, x)
    for front_fn in (None, front):
        got = _backbone_apply(pf, x, front_fn=front_fn,
                              group12_fn=lambda t: rg.fused_group12(t, packed))
        scale = max(1.0, float(want.abs().max()))
        assert float(want.std(dim=0).mean()) >= 100 * F32_REL_TOL * scale
        torch.testing.assert_close(got, want, atol=F32_REL_TOL * scale, rtol=0)


def test_front_g1_takes_precedence_over_group12(stage):
    """As in the JAX package: with ``front_g1_fn`` group 1 is done and
    ``group12_fn`` is never called."""
    _, pf, _ = stage(4)
    x = torch.from_numpy(images_u16(6, 8, 16).astype(np.float32) / 1023.0)
    front_g1 = ff.make_fused_front_g1(pf, 16, float_dtype=torch.float32)

    def must_not_run(t):
        raise AssertionError("group12_fn ran after front_g1_fn")

    got = _backbone_apply(pf, x, front_g1_fn=front_g1, group12_fn=must_not_run)
    want = _backbone_apply(pf, x, front_g1_fn=front_g1)
    torch.testing.assert_close(got, want, atol=0, rtol=0)


@pytest.mark.parametrize("bad", [
    "extent_3", "extent_32", "not_square", "channels_32", "x_float16",
    "x_not_contiguous", "x_empty", "weight_dtype", "weight_shape",
    "weight_count", "weight_not_contiguous",
])
def test_wrapper_rejects_what_the_kernel_does_not_take(stage, bad):
    _, pf, x = stage(4)
    x = torch.from_numpy(x)
    weights = list(rg.pack_group12_weights(pf, torch.float32))
    if bad == "extent_3":
        x = torch.zeros(4, 3, 3, 64)
    elif bad == "extent_32":
        x = torch.zeros(4, 32, 32, 64)
    elif bad == "not_square":
        x = torch.zeros(4, 4, 8, 64)
    elif bad == "channels_32":
        x = torch.zeros(4, 4, 4, 32)
    elif bad == "x_float16":
        x = x.half()
    elif bad == "x_not_contiguous":
        x = torch.zeros(4, 4, 64, 4).permute(0, 1, 3, 2)
    elif bad == "x_empty":
        x = x[:0]
    elif bad == "weight_dtype":
        weights[3] = weights[3].to(torch.bfloat16)
    elif bad == "weight_shape":
        weights[0] = weights[0][:, :32]
    elif bad == "weight_count":
        weights = weights[:-1]
    elif bad == "weight_not_contiguous":
        weights[10] = weights[10].transpose(1, 2).contiguous().transpose(1, 2)
    with pytest.raises(ValueError):
        rg.fused_group12(x, weights)


def test_cpu_tensors_run_the_plain_version_without_launching(stage):
    """A CPU tensor takes the plain version; the launch count stays 0."""
    _, pf, x = stage(2)
    x = torch.from_numpy(x)
    weights = rg.pack_group12_weights(pf, torch.float32)
    before = launch_counts["fused_group12"]
    got = rg.fused_group12(x, weights)
    assert launch_counts["fused_group12"] == before
    torch.testing.assert_close(got, rg.fused_group12_reference(x, weights),
                               atol=0, rtol=0)
