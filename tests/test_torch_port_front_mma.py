"""What surrounds the tensor-core kernels K1 and K2, on the CPU: the layout of
the stem's implicit GEMM (the weight tile and the tile elements each GEMM
column reads, as ``csrc/fused_front.cu`` builds them in shared memory), K2's
conv weights as the head of K5's conv stream, and the SE matrices K2 is given.
The kernels themselves run only on a card (``test_torch_port_cuda.py``).
"""
import pytest
import torch
import torch.nn.functional as F

from av1tpu_torch.kernels import fused_front as ff
from av1tpu_torch.kernels import resnet_group as rg
from av1tpu_torch.models import Stage1Model
from av1tpu_torch.quant.ptq import fold_backbone

DTYPES = pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                                 ids=["fp32", "bf16"])


@pytest.fixture(scope="module")
def folded():
    torch.manual_seed(11)
    model = Stage1Model()
    for m in model.modules():  # running stats off their defaults, so the fold is not trivial
        if isinstance(m, torch.nn.BatchNorm2d):
            m.running_mean.normal_(0.0, 0.2)
            m.running_var.uniform_(0.5, 1.5)
    return fold_backbone(model.eval().backbone)


def _blocks(hw, n=6, seed=3):
    gen = torch.Generator().manual_seed(seed + hw)
    return torch.randint(0, 1024, (n, hw, hw), generator=gen).float() / 1023.0


@DTYPES
def test_stem_gemm_weight_is_the_window_as_eight_rows_of_eight(folded, dtype):
    """Row 8*dy + dx + 1 is tap (dy, dx) of ``stem_weights``, bit-equal; the 15
    other rows are zero, so whatever the tile holds there is multiplied by 0."""
    w, _ = ff.stem_weights(folded["stem"]["weight"], folded["stem"]["bias"], dtype)
    padded = ff.stem_gemm_weight(w)
    assert padded.shape == (64, 64) and padded.dtype == dtype
    live = [8 * dy + dx + 1 for dy in range(7) for dx in range(7)]
    assert torch.equal(padded[live], w)
    dead = sorted(set(range(64)) - set(live))
    assert len(dead) == 15 and not padded[dead].any()
    assert dead == [8 * dy for dy in range(7)] + list(range(56, 64))


@pytest.mark.parametrize("hw", [8, 16])
def test_stem_gemm_index_picks_the_pixels_unfold_picks(hw):
    """Column 8*dy + dx + 1 of the index table reads, for every conv position,
    the pixel ``F.unfold`` gives tap (dy, dx); every column stays inside the
    sample's tile, and a k-pair (2j, 2j + 1) is one aligned 32-bit word."""
    x = _blocks(hw)
    tiles = F.pad(x, (4, 4, 3, 3))  # 3 rows above, 4 columns left
    assert tiles.shape[1:] == (hw + 6, hw + 8)
    index = ff.stem_gemm_index(hw)
    assert index.shape == ((hw // 2) ** 2, 64)
    assert int(index.min()) == 0 and int(index.max()) == tiles[0].numel() - 3
    assert not (index[:, 0::2] % 2).any() and torch.equal(index[:, 1::2], index[:, 0::2] + 1)
    a = tiles.reshape(len(x), -1)[:, index]  # (n, positions, 64)
    want = F.unfold(x[:, None], kernel_size=7, stride=2, padding=3)  # (n, 49, positions)
    for dy in range(7):
        for dx in range(7):
            assert torch.equal(a[:, :, 8 * dy + dx + 1], want[:, 7 * dy + dx]), (dy, dx)


@pytest.mark.parametrize("hw", [8, 16])
def test_stem_gemm_reproduces_the_stem_conv(folded, hw):
    """A (tile elements by the index table) times B (the weight tile) is the
    7x7/2 conv with pad 3, whatever the dead columns of A hold."""
    w, _ = ff.stem_weights(folded["stem"]["weight"], folded["stem"]["bias"], torch.float32)
    x = _blocks(hw)
    a = F.pad(x, (4, 4, 3, 3)).reshape(len(x), -1)[:, ff.stem_gemm_index(hw)]
    got = a @ ff.stem_gemm_weight(w)  # (n, positions, 64)
    want = F.conv2d(x[:, None], w.T.reshape(64, 1, 7, 7), stride=2, padding=3)
    assert float(want.std()) > 1e-2
    torch.testing.assert_close(got, want.flatten(2).transpose(1, 2), atol=1e-5, rtol=0)


@DTYPES
def test_k2_conv_weights_are_the_head_of_k5s_conv_stream(folded, dtype):
    """K2 reads ``conv_w`` through the conv routine it shares with K5, as 36
    chunks of 64 k-rows x 64 columns: flattened, it is bit-equal to the first
    36 x 64 x 64 values of K5's stream built from the same folded tree."""
    conv_w = ff.g1_weights(folded, dtype)[2]
    stream = rg.group12_conv_stream(rg.pack_group12_weights(folded, dtype))
    assert conv_w.shape == (4, 9, 64, 64) and conv_w.is_contiguous()
    assert torch.equal(conv_w.reshape(-1), stream[:36 * 64 * 64])
    chunks = conv_w.reshape(36, 64, 64)  # chunk 9*conv + tap: [ci][co] of that tap
    assert torch.equal(chunks[9 * 2 + 4], conv_w[2, 4])


@DTYPES
def test_g1_weights_hold_the_se_matrices_as_values_of_the_serving_dtype(folded, dtype):
    """d0 and d1 stay fp32 arrays (the kernels' ABI) but hold values of the
    serving dtype, rounded once: the TPU kernel keeps them in that dtype."""
    d0, d1 = ff.g1_weights(folded, dtype)[4:]
    assert d0.dtype == d1.dtype == torch.float32
    assert d0.shape == (4, 64) and d1.shape == (64, 4)
    for got, name in ((d0, "d0"), (d1, "d1")):
        src = folded["se1"][name].detach().float()
        assert torch.equal(got, src.to(dtype).float())
        assert torch.equal(got, got.to(dtype).float())
    if dtype == torch.bfloat16:
        assert not torch.equal(d0, folded["se1"]["d0"].detach().float())


def test_plain_k2_roundings_are_the_identity_in_fp32(folded):
    """fp32: the plain version equals the chain written without any rounding."""
    x = _blocks(16, n=8)[..., None]
    args = ff.g1_weights(folded, torch.float32)
    z = ff._stem_pool_f32(x, *args[:2])
    for i in (0, 2):
        w = [a.reshape(3, 3, 64, 64).permute(3, 2, 0, 1) for a in args[2][i:i + 2]]
        h = torch.relu(F.conv2d(z, w[0], padding=1) + args[3][i][None, :, None, None])
        z = torch.relu(F.conv2d(h, w[1], padding=1) + args[3][i + 1][None, :, None, None] + z)
    gate = torch.sigmoid(torch.relu(z.mean(dim=(2, 3)) @ args[4].T) @ args[5].T)
    want = (z * gate[:, :, None, None]).permute(0, 2, 3, 1)
    assert float(want.std()) > 1e-2
    torch.testing.assert_close(ff.fused_front_g1_reference(x, *args), want, atol=0, rtol=0)
