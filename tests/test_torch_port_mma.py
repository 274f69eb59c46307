"""What surrounds the tensor-core kernels K4 and K5, on the CPU: the conv
stream K5 reads (a permutation of the packed weights, laid out as the
kernel's chunk schedule assumes), plain emulations of the two splits of an
fp32 value into bf16 pieces, and K4's choice between its two kernels. The
kernels themselves run only on a card (``test_torch_port_cuda.py``).
"""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from av1tpu_torch.kernels import resnet_group as rg
from av1tpu_torch.kernels.fused_dense import fused_dense, takes_fast_path

# csrc/resnet_group.cu: a chunk is 64 k-rows of 64 (layer 1) or 128 columns
KC, CHUNKS1, CHUNKS = 64, 36, 100


def _weights(dtype, seed=0):
    gen = torch.Generator().manual_seed(seed)
    return tuple(torch.randn(rg.PACKED_SHAPES[name], generator=gen).to(dtype)
                 for name in rg.PACK_ORDER)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_conv_stream_is_a_permutation_of_the_packed_convs(dtype):
    """Round trip, bit-equal; nothing but the nine conv kernels is in it."""
    weights = _weights(dtype)
    stream = rg.group12_conv_stream(weights)
    assert stream.shape == (rg.CONV_STREAM_SIZE,) and stream.dtype == dtype
    assert stream.is_contiguous()
    back = rg.split_conv_stream(stream)
    by_name = dict(zip(rg.PACK_ORDER, weights))
    assert list(back) == list(rg.CONV_STREAM_ORDER)
    assert sorted(back) == sorted(n for n in rg.PACK_ORDER if n.endswith(".k"))
    for name, got in back.items():
        assert torch.equal(got, by_name[name]), name
    assert rg.CONV_STREAM_SIZE == sum(by_name[n].numel() for n in back) == 671744


def test_conv_stream_chunks_follow_the_kernels_schedule():
    """Chunk c of the stream (the kernel's offsets) is 64 consecutive k-rows
    (k = tap * CI + ci) of the conv that uses it, convs in order of use."""
    weights = _weights(torch.float32, seed=1)
    stream = rg.group12_conv_stream(weights)
    by_name = dict(zip(rg.PACK_ORDER, weights))
    assert rg.CONV_STREAM_SIZE == CHUNKS1 * KC * 64 + (CHUNKS - CHUNKS1) * KC * 128
    c = 0
    for name in rg.CONV_STREAM_ORDER:
        k_major = by_name[name].reshape(-1, by_name[name].shape[-1])
        n = k_major.shape[1]
        assert n == (64 if c < CHUNKS1 else 128) and k_major.shape[0] % KC == 0
        for j in range(k_major.shape[0] // KC):
            off = c * KC * 64 if c < CHUNKS1 else CHUNKS1 * KC * 64 + (c - CHUNKS1) * KC * 128
            got = stream[off:off + KC * n].reshape(KC, n)
            assert torch.equal(got, k_major[j * KC:(j + 1) * KC]), (name, j)
            c += 1
    assert c == CHUNKS


def _bf16(t):
    return t.to(torch.bfloat16).float()


@pytest.mark.parametrize("stride", [1, 2])
def test_hi_lo_pair_on_a_conv_stays_within_2_to_minus_15(stride):
    """K5's numerics on one 3x3 conv: exact bf16 weights, an fp32 activation
    as hi = bf16(a), lo = bf16(a - hi), two products on the same weights,
    fp32 sums. Against the product sum of the unsplit activation (float64)
    the error stays below 2^-15 of the largest output; one bf16 pass (K2's
    numerics) does not."""
    gen = torch.Generator().manual_seed(7 + stride)
    a = torch.randn(8, 64, 8, 8, generator=gen) * 3.0
    w = _bf16(torch.randn(128, 64, 3, 3, generator=gen) / 24.0)
    hi = _bf16(a)
    lo = _bf16(a - hi)
    assert float((a - (hi + lo)).abs().max()) <= 2.0 ** -16 * float(a.abs().max())
    conv = lambda t: F.conv2d(t, w.to(t.dtype), stride=stride, padding=1)
    want = conv(a.double())
    scale = float(want.abs().max())
    pair = (conv(hi) + conv(lo)).double()
    assert float((pair - want).abs().max()) <= 2.0 ** -15 * scale
    assert float((conv(hi).double() - want).abs().max()) > 2.0 ** -15 * scale


def test_three_piece_split_by_truncation_is_exact():
    """K4's fp32 split (csrc/mma.cuh split3_pack), emulated on bit patterns:
    hi, mid and lo are bf16 values that sum to the fp32 value exactly."""
    rng = np.random.default_rng(5)
    v = np.concatenate([rng.normal(size=4096) * 10.0 ** rng.integers(-6, 6, size=4096),
                        [0.0, 1.0, -1.0, 2.0 ** -20, 3.4e38, 1.1754944e-38]]
                       ).astype(np.float32)
    top = np.uint32(0xFFFF0000)
    cut = lambda f: (f.view(np.uint32) & top).view(np.float32)
    hi = cut(v)
    r = v - hi
    mid = cut(r)
    lo = r - mid
    assert np.array_equal(cut(lo), lo)  # lo needs no rounding to fit bf16
    assert np.array_equal(hi.astype(np.float64) + mid.astype(np.float64)
                          + lo.astype(np.float64), v.astype(np.float64))
    nonzero = v != 0
    assert np.all(np.abs(mid[nonzero]) <= 2.0 ** -7 * np.abs(v[nonzero]))
    assert np.all(np.abs(lo[nonzero]) <= 2.0 ** -14 * np.abs(v[nonzero]))


@pytest.mark.parametrize("dtype, k, n, fast", [
    (torch.bfloat16, 512, 256, True), (torch.bfloat16, 40, 24, True),
    (torch.bfloat16, 500, 250, False), (torch.bfloat16, 512, 252, False),
    (torch.bfloat16, 508, 256, False),
    (torch.float32, 512, 256, True), (torch.float32, 500, 252, True),
    (torch.float32, 500, 250, False), (torch.float32, 510, 256, False),
])
def test_fused_dense_picks_the_general_kernel_for_unaligned_rows(dtype, k, n, fast):
    """Rows of x and w must be whole 16-byte chunks for the tensor-core
    kernel: K and N multiples of 8 in bf16, of 4 in fp32."""
    x, w = torch.zeros(16, k, dtype=dtype), torch.zeros(k, n, dtype=dtype)
    assert takes_fast_path(x, w) is fast
    assert takes_fast_path(x, w, torch.empty(16, n, dtype=dtype)) is fast


def test_fused_dense_fast_path_needs_aligned_contiguous_tensors():
    x, w = torch.zeros(16, 64), torch.zeros(64, 32)
    assert takes_fast_path(x, w)
    assert not takes_fast_path(x, torch.zeros(32, 64).T)        # not contiguous
    assert not takes_fast_path(torch.zeros(16 * 64 + 1)[1:].view(16, 64), w)  # off by 4 B


@pytest.mark.parametrize("k, n", [(500, 250), (512, 256)])
def test_fused_dense_still_takes_any_k_and_n_on_the_cpu(k, n):
    gen = torch.Generator().manual_seed(9)
    x, w = torch.randn(7, k, generator=gen), torch.randn(k, n, generator=gen)
    b = torch.randn(n, generator=gen)
    torch.testing.assert_close(fused_dense(x, w, b, "relu"), torch.relu(x @ w + b))


def test_group12_rejects_a_wrong_conv_stream_only_where_it_is_read():
    """The stream is the bf16 CUDA kernel's operand: a CPU call ignores it."""
    weights = _weights(torch.float32, seed=2)
    x = torch.zeros(2, 4, 4, 64)
    got = rg.fused_group12(x, weights, conv_stream=torch.zeros(3))
    assert got.shape == (2, 2, 2, 128)


def test_group12_bf16_kernel_call_needs_its_conv_stream():
    """The operand check of a bf16 launch: no stream built per call, a
    stream of the wrong size refused, none asked for in fp32."""
    weights = _weights(torch.bfloat16, seed=3)
    x = torch.zeros(2, 4, 4, 64, dtype=torch.bfloat16)
    stream = rg.group12_conv_stream(weights)
    assert rg._conv_stream_pointer(x, stream) == stream.data_ptr()
    assert rg._conv_stream_pointer(x.float(), None) is None
    for bad in (None, stream[:-8], stream.float()):
        with pytest.raises(ValueError, match="conv_stream"):
            rg._conv_stream_pointer(x, bad)
