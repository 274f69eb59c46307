"""Port parity: the plain versions of kernels K3a (``tile_normalize_frames``)
and K3b (``normalize_blocks``) against the JAX Pallas kernels in interpret
mode, bit for bit at fp32 and bf16, and the wrappers' checks, on the CPU.

Both sides multiply 10-bit codes by float32(1/1023) and round once to the
output dtype, so they agree exactly. The CUDA kernels themselves run only
on a card (``test_torch_port_cuda.py``, ``chip_smoke.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from av1tpu.ingest.tiler import tile_frames
from av1tpu.kernels import normalize_blocks as jax_normalize
from av1tpu.kernels import pad_frames as jax_pad_frames
from av1tpu.kernels import tile_normalize_frames as jax_tile_normalize
from av1tpu_torch import kernels as K
from av1tpu_torch.kernels._build import launch_counts

DTYPES = {"fp32": (torch.float32, jnp.float32), "bf16": (torch.bfloat16, jnp.bfloat16)}


def _frames(seed, shape):
    return np.random.default_rng(seed).integers(0, 1024, size=shape, dtype=np.uint16)


def _bits(a: np.ndarray) -> np.ndarray:
    """The raw bits of a float array, for exact comparison."""
    return a.view(np.uint16 if a.dtype.itemsize == 2 else np.uint32)


def _as_numpy(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _jax_bits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.itemsize == 2 else a.view(np.uint32)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("bs, shape", [(16, (3, 32, 64)), (32, (2, 64, 128))])
def test_plain_tile_normalize_matches_pallas_bit_for_bit(bs, shape, dtype):
    tdt, jdt = DTYPES[dtype]
    frames = _frames(bs, shape)
    want = jax_tile_normalize(jnp.asarray(frames), bs, out_dtype=jdt, interpret=True)
    got = K.tile_normalize_frames(torch.from_numpy(frames), bs, out_dtype=tdt)
    assert got.dtype == tdt and tuple(got.shape) == want.shape
    assert got.shape[1:] == (bs, bs, 1)
    np.testing.assert_array_equal(_bits(_as_numpy(got)), _jax_bits(want))


@pytest.mark.parametrize("bs", [16, 32])
def test_tile_normalize_matches_host_tiler(bs):
    """Frame-major, row-major block order of ``ingest.tiler.tile_frames``."""
    frames = _frames(7, (2, 64, 96))
    want_blocks, _ = tile_frames(frames, bs)
    want = want_blocks.astype(np.float32)[..., None] / 1023.0
    got = K.tile_normalize_frames(torch.from_numpy(frames), bs).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-6)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_tile_normalize_reference_matches_the_wrapper(dtype):
    tdt, _ = DTYPES[dtype]
    frames = torch.from_numpy(_frames(8, (2, 48, 80)))
    torch.testing.assert_close(K.tile_normalize_frames(frames, 16, tdt),
                               K.tile_normalize_reference(frames, 16, tdt),
                               atol=0, rtol=0)


def test_tile_normalize_rejects_unpadded_frames():
    frames = torch.zeros((1, 30, 64), dtype=torch.uint16)
    with pytest.raises(ValueError, match="pad_frames"):
        K.tile_normalize_frames(frames, 16)


def test_pad_frames_matches_jax():
    frames = np.ones((2, 30, 50), dtype=np.uint16)
    padded = K.pad_frames(frames, 16)
    assert padded.shape == (2, 32, 64)
    np.testing.assert_array_equal(padded, jax_pad_frames(frames, 16))
    assert K.pad_frames(padded, 16) is padded
    tiled = K.tile_normalize_frames(torch.from_numpy(padded), 16)
    assert tiled.shape == (2 * 2 * 4, 16, 16, 1)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("n, bs", [(1037, 16), (100, 8)])
def test_plain_normalize_blocks_matches_pallas_bit_for_bit(n, bs, dtype):
    """Ragged N (1037 is prime: the JAX kernel's tile shrinks to it)."""
    tdt, jdt = DTYPES[dtype]
    blocks = _frames(n, (n, bs, bs, 1))
    want = jax_normalize(jnp.asarray(blocks), out_dtype=jdt, interpret=True)
    got = K.normalize_blocks(torch.from_numpy(blocks), out_dtype=tdt)
    assert got.dtype == tdt and tuple(got.shape) == blocks.shape
    np.testing.assert_array_equal(_bits(_as_numpy(got)), _jax_bits(want))


def test_every_10bit_code_matches_pallas():
    """All 1024 codes, fp32: the multiply by 1/1023, not a divide."""
    codes = np.arange(1024, dtype=np.uint16).reshape(16, 8, 8, 1)
    want = jax_normalize(jnp.asarray(codes), interpret=True)
    got = K.normalize_blocks(torch.from_numpy(codes)).numpy()
    np.testing.assert_array_equal(_bits(got), _jax_bits(want))
    divided = codes.astype(np.float32) / np.float32(1023.0)
    assert (got != divided).sum() == 24  # the pipelines' divide differs here


@pytest.mark.parametrize("bad", ["int32_input", "float16_out", "not_contiguous",
                                 "two_dims"])
def test_wrappers_reject_what_the_kernels_do_not_take(bad):
    frames = torch.zeros((2, 32, 32), dtype=torch.uint16)
    out_dtype = torch.float32
    if bad == "int32_input":
        frames = frames.to(torch.int32)
    elif bad == "float16_out":
        out_dtype = torch.float16
    elif bad == "not_contiguous":
        frames = torch.zeros((2, 32, 64), dtype=torch.uint16)[:, :, ::2]
    elif bad == "two_dims":
        frames = frames[0]
    with pytest.raises(ValueError):
        K.tile_normalize_frames(frames, 16, out_dtype)
    if bad != "two_dims":
        with pytest.raises(ValueError):
            K.normalize_blocks(frames, out_dtype)


def test_cpu_tensors_run_the_plain_versions_without_launching():
    frames = torch.from_numpy(_frames(9, (1, 32, 32)))
    before = dict(launch_counts)
    K.tile_normalize_frames(frames, 16)
    K.normalize_blocks(frames)
    assert launch_counts == before
