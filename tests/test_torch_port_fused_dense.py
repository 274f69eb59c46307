"""Port parity: kernel K4 (``fused_dense``) against the JAX Pallas kernel in
interpret mode, forward and gradients, and the wrapper's checks, on the CPU.

Tolerances are those of ``tests/test_kernels.py``: forward within rtol 2e-4
and atol 2e-5, gradients of ``sum(out ** 2)`` within rtol 1e-3 and atol
1e-4. The CUDA forward runs only on a card (``test_torch_port_cuda.py``,
``chip_smoke.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from av1tpu.kernels import fused_dense as jax_dense
from av1tpu_torch import kernels as K
from av1tpu_torch.kernels._build import launch_counts
from av1tpu_torch.kernels.fused_dense import fused_dense_reference

ACTS = ["linear", "relu", "silu", "sigmoid"]


def _inputs(seed, m, k, n):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(m, k)).astype(np.float32),
            (rng.normal(size=(k, n)) * 0.05).astype(np.float32),
            rng.normal(size=(n,)).astype(np.float32))


def _guard(out, tol):
    """F2 guard: rows differ far above the tolerance."""
    assert np.asarray(out).std(axis=0).mean() >= 100 * tol


@pytest.mark.parametrize("act", ACTS)
def test_forward_matches_pallas(act):
    x, w, b = _inputs(3, 100, 128, 256)
    want = np.asarray(jax_dense(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                                act, 512, True))
    got = K.fused_dense(*map(torch.from_numpy, (x, w, b)), act)
    assert got.dtype == torch.float32 and tuple(got.shape) == (100, 256)
    _guard(want, 2e-5)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("act", ACTS)
def test_gradients_match_jax_grad(act):
    x, w, b = _inputs(4, 32, 128, 128)

    def loss(x, w, b):
        return jnp.sum(jax_dense(x, w, b, act, 512, True) ** 2)

    want = jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, (x, w, b)))
    params = [torch.from_numpy(a).requires_grad_() for a in (x, w, b)]
    (K.fused_dense(*params, act) ** 2).sum().backward()
    for name, p, g in zip("xwb", params, want):
        _guard(g, 1e-4)
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(g), rtol=1e-3,
                                   atol=1e-4, err_msg=name)


def test_bf16_forward_matches_pallas():
    """bf16 x and w, fp32 sums: within one bf16 ulp of the largest output."""
    x, w, b = _inputs(5, 100, 128, 256)
    want = np.asarray(jax_dense(jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16),
                                jnp.asarray(b), "relu", 512, True), dtype=np.float32)
    got = K.fused_dense(torch.from_numpy(x).bfloat16(), torch.from_numpy(w).bfloat16(),
                        torch.from_numpy(b), "relu")
    assert got.dtype == torch.bfloat16
    ulp = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=ulp)


@pytest.mark.parametrize("bad", ["act", "k_mismatch", "n_mismatch", "w_dtype",
                                 "x_float16", "x_3d", "k_zero"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    x, w, b = map(torch.from_numpy, _inputs(6, 8, 16, 4))
    act = "relu"
    if bad == "act":
        act = "gelu"
    elif bad == "k_mismatch":
        w = w[:8]
    elif bad == "n_mismatch":
        b = b[:2]
    elif bad == "w_dtype":
        w = w.bfloat16()
    elif bad == "x_float16":
        x, w = x.half(), w.half()
    elif bad == "x_3d":
        x = x[None]
    elif bad == "k_zero":
        x, w = x[:, :0], w[:0]
    with pytest.raises(ValueError):
        K.fused_dense(x, w, b, act)


def test_cpu_tensors_run_the_plain_version_without_launching():
    x, w, b = map(torch.from_numpy, _inputs(7, 8, 16, 4))
    before = launch_counts["fused_dense"]
    got = K.fused_dense(x, w, b, "silu")
    assert launch_counts["fused_dense"] == before
    torch.testing.assert_close(got, fused_dense_reference(x, w, b, "silu"),
                               atol=0, rtol=0)
