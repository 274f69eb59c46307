"""Port parity: the plain versions of kernels K1 and K2 against the JAX
Pallas kernels in interpret mode, and the wrappers' checks, on the CPU.

fp32 is held to 1e-5 (K1) and 5e-5 (K2). In bf16, the serving dtype, plain K1
equals the Pallas kernel bit for bit; plain K2 rounds where that kernel casts
(each conv input, and five places in SE1) and is held to one bf16 step of the
largest output on at most 1% of the output elements: the two sum in fp32 in
different orders, and an intermediate that rounds the other way moves what
follows by one step.

The CUDA kernels themselves run only on a card: ``test_torch_port_cuda.py``
and ``chip_smoke.py`` hold them against these plain versions there.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from av1tpu import models as jm
from av1tpu.kernels.fused_front import make_fused_front as jax_front
from av1tpu.kernels.fused_front import make_fused_front_g1 as jax_front_g1
from av1tpu.quant.ptq import fold_backbone as jax_fold
from av1tpu_torch import models as tm
from av1tpu_torch.kernels import fused_front as ff
from av1tpu_torch.quant.ptq import fold_backbone
from tests.torch_port_fixtures import calibrated_variables, images_u16

BATCH = 20  # not a multiple of the JAX kernels' tile: exercises their padding


@pytest.fixture(scope="module")
def folded():
    """``get(hw)``: (JAX folded tree, port folded tree) of one calibrated
    stage-1 backbone."""
    cache = {}

    def get(hw):
        if hw not in cache:
            v = calibrated_variables(jm.Stage1Model(), 50, hw)
            model = tm.load_jax_variables(tm.Stage1Model(), v)
            cache[hw] = jax_fold(v), fold_backbone(model.backbone)
        return cache[hw]

    return get


def _input(hw):
    return images_u16(60 + hw, BATCH, hw).astype(np.float32) / 1023.0


def _guard(out, tol):
    """F2 guard for an activation map: samples differ, far above tol."""
    flat = out.reshape(out.shape[0], -1)
    assert len(np.unique(flat.argmax(-1))) >= 2
    assert flat.std(axis=0).mean() >= 100 * tol


@pytest.mark.parametrize("hw", [16, 8])
def test_plain_fused_front_matches_pallas(folded, hw):
    """Plain K1 == JAX make_fused_front(interpret=True) to 1e-5."""
    jf, pf = folded(hw)
    x = _input(hw)
    want = np.asarray(jax_front(jf["stem"]["kernel"], jf["stem"]["bias"], hw,
                                float_dtype=jnp.float32, tile=16,
                                interpret=True)(x))
    front = ff.make_fused_front(pf["stem"]["weight"], pf["stem"]["bias"], hw,
                                float_dtype=torch.float32)
    got = front(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (BATCH, hw // 4, hw // 4, 64)
    _guard(want, 1e-5)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("hw", [16, 8])
def test_plain_fused_front_g1_matches_pallas(folded, hw):
    """Plain K2 == JAX make_fused_front_g1(interpret=True) to 5e-5."""
    jf, pf = folded(hw)
    x = _input(hw)
    want = np.asarray(jax_front_g1(jf, hw, float_dtype=jnp.float32, tile=16,
                                   interpret=True)(x))
    got = ff.make_fused_front_g1(pf, hw, float_dtype=torch.float32)(
        torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (BATCH, hw // 4, hw // 4, 64)
    _guard(want, 5e-5)
    np.testing.assert_allclose(got, want, atol=5e-5, rtol=0)


def _bf16_step(v: float) -> float:
    """The spacing of bf16 values at magnitude ``v``."""
    return 2.0 ** (np.floor(np.log2(v)) - 7)


@pytest.mark.parametrize("hw", [16, 8])
def test_plain_fused_front_bf16_equals_pallas(folded, hw):
    """bf16: plain K1 == JAX make_fused_front(interpret=True), bit for bit
    (products of two bf16 values are exact in fp32, and rounding commutes
    with the max-pool)."""
    jf, pf = folded(hw)
    x = _input(hw)
    want = np.asarray(jax_front(jf["stem"]["kernel"], jf["stem"]["bias"], hw,
                                float_dtype=jnp.bfloat16, tile=16,
                                interpret=True)(x)).astype(np.float32)
    got = ff.make_fused_front(pf["stem"]["weight"], pf["stem"]["bias"], hw,
                              float_dtype=torch.bfloat16)(torch.from_numpy(x))
    assert got.dtype == torch.bfloat16
    _guard(want, 1e-5)
    np.testing.assert_array_equal(got.float().numpy(), want)


def _g1_with_fp32_se(x, stem_w, stem_b, conv_w, conv_b, se_d0, se_d1):
    """Plain K2 with each conv input rounded but SE1 left in fp32: what the
    port computed before it rounded where the TPU kernel casts."""
    z = ff._stem_pool_f32(x, stem_w, stem_b)
    for i in range(4):
        w = conv_w[i].float().reshape(3, 3, 64, 64).permute(3, 2, 0, 1)
        a = (z if i % 2 == 0 else h).to(conv_w.dtype).float()
        y = F.conv2d(a, w, padding=1) + conv_b[i][None, :, None, None]
        if i % 2 == 0:
            h = torch.relu(y)
        else:
            z = torch.relu(y + z)
    s = torch.relu(z.mean(dim=(2, 3)) @ se_d0.T)
    z = z * torch.sigmoid(s @ se_d1.T)[:, :, None, None]
    return z.permute(0, 2, 3, 1).to(x.dtype)


@pytest.mark.parametrize("hw", [16, 8])
def test_plain_fused_front_g1_bf16_matches_pallas(folded, hw):
    """bf16: plain K2 against JAX make_fused_front_g1(interpret=True). No
    element is more than one bf16 step of the largest output away, and at
    most 1% of the elements differ at all. With SE1 left in fp32 a third of
    the elements differ: the guard that this test sees the roundings."""
    jf, pf = folded(hw)
    x = _input(hw)
    want = np.asarray(jax_front_g1(jf, hw, float_dtype=jnp.bfloat16, tile=16,
                                   interpret=True)(x)).astype(np.float32)
    got = ff.make_fused_front_g1(pf, hw, float_dtype=torch.bfloat16)(
        torch.from_numpy(x))
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    assert got.shape == want.shape == (BATCH, hw // 4, hw // 4, 64)
    _guard(want, 5e-5)
    step = _bf16_step(float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, atol=step, rtol=0)
    assert (got != want).mean() <= 0.01
    xb = torch.from_numpy(x).bfloat16()
    unrounded = ff.g1_weights(pf, torch.bfloat16)[:4] + tuple(
        pf["se1"][k].detach().float() for k in ("d0", "d1"))
    old = _g1_with_fp32_se(xb, *unrounded).float().numpy()
    assert (old != want).mean() >= 0.2


@pytest.mark.parametrize("bad", [
    "x_float16", "x_extent_12", "x_two_channels", "x_not_contiguous",
    "x_empty", "w_dtype", "w_shape", "bias_bf16",
])
@pytest.mark.parametrize("kernel", ["fused_front", "fused_front_g1"])
def test_wrappers_reject_what_the_kernels_do_not_take(folded, kernel, bad):
    _, pf = folded(16)
    args = list(ff.g1_weights(pf, torch.float32))
    x = torch.from_numpy(_input(16))
    if bad == "x_float16":
        x = x.half()
    elif bad == "x_extent_12":
        x = torch.zeros(4, 12, 12, 1)
    elif bad == "x_two_channels":
        x = torch.zeros(4, 16, 16, 2)
    elif bad == "x_not_contiguous":
        x = torch.zeros(16, 16, 4, 1).permute(2, 0, 1, 3)
    elif bad == "x_empty":
        x = x[:0]
    elif bad == "w_dtype":
        args[0] = args[0].to(torch.bfloat16)
    elif bad == "w_shape":
        args[0] = args[0][:48]
    elif bad == "bias_bf16":
        args[1] = args[1].to(torch.bfloat16)
    fn = ff.fused_front if kernel == "fused_front" else ff.fused_front_g1
    n_args = 2 if kernel == "fused_front" else 6
    with pytest.raises(ValueError):
        fn(x, *args[:n_args])


def test_cpu_tensors_run_the_plain_version_without_launching(folded):
    """A CPU tensor takes the plain version; the launch counts stay 0."""
    _, pf = folded(16)
    ff.reset_launch_counts()
    x = torch.from_numpy(_input(16))
    args = ff.g1_weights(pf, torch.float32)
    out = ff.fused_front(x, *args[:2])
    out_g1 = ff.fused_front_g1(x, *args)
    assert ff.launch_counts == {"fused_front": 0, "fused_front_g1": 0}
    torch.testing.assert_close(out, ff.fused_front_reference(x, *args[:2]),
                               rtol=0, atol=0)
    torch.testing.assert_close(out_g1, ff.fused_front_g1_reference(x, *args),
                               rtol=0, atol=0)


def test_builders_reject_unsupported_extents(folded):
    _, pf = folded(16)
    with pytest.raises(ValueError, match="8/16px"):
        ff.make_fused_front(pf["stem"]["weight"], pf["stem"]["bias"], 32)
    with pytest.raises(ValueError, match="8/16px"):
        ff.make_fused_front_g1(pf, 32)
    front = ff.make_fused_front(pf["stem"]["weight"], pf["stem"]["bias"], 16)
    with pytest.raises(ValueError, match="built for 16px"):
        front(torch.zeros(2, 8, 8, 1, dtype=torch.bfloat16))
