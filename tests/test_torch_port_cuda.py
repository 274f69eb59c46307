"""Kernels K1 and K2 on a CUDA card against their plain versions.

These tests need a card: they carry the ``cuda`` marker and skip without
one. This file imports no jax, so it runs where jax is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py
"""
import pytest
import torch

from av1tpu_torch.kernels import fused_front as ff
from av1tpu_torch.models import Stage1Model
from av1tpu_torch.quant.ptq import fold_backbone

RAGGED = 4099  # not a multiple of the kernels' 4 samples per block
FP32_TOL = {"fused_front": 1e-5, "fused_front_g1": 5e-5}
BF16_REL_TOL = 1e-2  # of max(1, max|plain|)


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.fixture(scope="module")
def folded():
    """A stage-1 backbone whose BN running stats are a random batch's own
    statistics: activations stay near unit scale, as in a trained net."""
    torch.manual_seed(0)
    model = Stage1Model()
    for m in model.modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            m.reset_running_stats()
            m.momentum = None  # cumulative average: one batch's statistics
    with torch.no_grad():
        model.train()
        model(torch.randint(0, 1024, (256, 16, 16, 1)).float() / 1023.0)
    return fold_backbone(model.eval().backbone)


def _args(name, folded, dtype, card):
    if name == "fused_front":
        w, b = ff.stem_weights(folded["stem"]["weight"], folded["stem"]["bias"], dtype)
        return ff.fused_front, ff.fused_front_reference, (w.to(card), b.to(card))
    return (ff.fused_front_g1, ff.fused_front_g1_reference,
            tuple(a.to(card) for a in ff.g1_weights(folded, dtype)))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("hw", [8, 16])
@pytest.mark.parametrize("name", ["fused_front", "fused_front_g1"])
def test_kernel_matches_plain_version(card, folded, name, hw, dtype):
    gen = torch.Generator().manual_seed(hw)
    x = (torch.randint(0, 1024, (RAGGED, hw, hw, 1), generator=gen).float()
         / 1023.0).to(card, dtype)
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


@pytest.mark.cuda
def test_wrapper_rejects_weights_on_another_device(card, folded):
    w, b = ff.stem_weights(folded["stem"]["weight"], folded["stem"]["bias"],
                           torch.float32)
    x = torch.zeros(4, 16, 16, 1, device=card)
    with pytest.raises(ValueError, match="expected cuda"):
        ff.fused_front(x, w, b)
