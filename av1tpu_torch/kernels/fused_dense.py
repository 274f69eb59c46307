"""Fused dense layer ``act(x @ w + b)``: kernel K4 (``csrc/fused_dense.cu``).

Counterpart of ``av1tpu.kernels.fused_dense``. The forward is the CUDA
kernel: products summed in fp32, bias and activation in fp32, the output in
x's dtype. Rows that are 16-byte aligned (K and N multiples of 8 in bf16, of
4 in fp32) take the tensor-core kernel: one bf16 MMA pass for bf16 inputs,
a split-precision product (bf16 triples) that keeps fp32 accuracy for fp32
inputs. Every other shape takes the general SIMT kernel of the same file. The backward mirrors the JAX custom VJP ``_fused_dense_bwd`` in
plain torch ops (silu recomputes ``z``), as the JAX package computes it
outside Pallas. The TPU kernel's ``tile_m`` (its VMEM row tile) and
``interpret`` (Pallas interpreter) have no counterpart here.

A CPU tensor runs the plain twin ``fused_dense_reference``; a CUDA tensor
launches the kernel or raises, and a launch adds one to
``_build.launch_counts["fused_dense"]``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from av1tpu_torch.kernels import _build

ACTS = {
    "linear": lambda z: z,
    "relu": torch.relu,
    "silu": F.silu,
    "sigmoid": torch.sigmoid,
}
_ACT_CODE = {"linear": 0, "relu": 1, "silu": 2, "sigmoid": 3}
_DTYPES = (torch.float32, torch.bfloat16)


def fused_dense_reference(x, w, b, act: str = "relu"):
    """Plain K4 forward: fp32 product, bias and activation; x's dtype out."""
    z = x.float() @ w.float() + b.float()
    return ACTS[act](z).to(x.dtype)


def _check(x, w, b, act):
    if act not in ACTS:
        raise ValueError(f"act {act!r} not in {tuple(ACTS)}")
    if x.dim() != 2 or w.dim() != 2 or b.dim() != 1:
        raise ValueError(f"expected x (M, K), w (K, N), b (N,); got "
                         f"{tuple(x.shape)}, {tuple(w.shape)}, {tuple(b.shape)}")
    if x.shape[1] != w.shape[0] or w.shape[1] != b.shape[0]:
        raise ValueError(f"shapes do not chain: {tuple(x.shape)} @ {tuple(w.shape)} "
                         f"+ {tuple(b.shape)}")
    if x.shape[1] == 0 or w.shape[1] == 0:
        raise ValueError("K and N must be positive")
    if x.dtype not in _DTYPES or w.dtype != x.dtype or b.dtype not in _DTYPES:
        raise ValueError(f"dtypes x {x.dtype}, w {w.dtype}, b {b.dtype}: x and w "
                         f"must share one of {_DTYPES}")
    if not (x.device == w.device == b.device) or x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"devices x {x.device}, w {w.device}, b {b.device}")


def takes_fast_path(x, w, out=None) -> bool:
    """True where the tensor-core kernel takes ``x @ w``: contiguous x, w
    (and out) that start on a 16-byte boundary, with K and N multiples of
    one 16-byte chunk (8 values in bf16, 4 in fp32). Otherwise the general
    kernel runs."""
    per_chunk = 16 // x.element_size()
    k, n = int(w.shape[0]), int(w.shape[1])
    tensors = (x, w) if out is None else (x, w, out)
    return (k % per_chunk == 0 and n % per_chunk == 0
            and all(t.is_contiguous() and t.data_ptr() % 16 == 0 for t in tensors))


def _forward(x, w, b, act):
    if x.device.type == "cpu":
        return fused_dense_reference(x, w, b, act)
    x, w, b = x.contiguous(), w.contiguous(), b.float().contiguous()
    m, k = map(int, x.shape)
    n = int(w.shape[1])
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    if m:
        _build.launch("fused_dense", x.data_ptr(), w.data_ptr(), b.data_ptr(),
                      out.data_ptr(), m, k, n, _ACT_CODE[act],
                      int(x.dtype == torch.bfloat16),
                      int(takes_fast_path(x, w, out)), _build.stream_of(x))
    return out


class FusedDense(torch.autograd.Function):
    """``act(x @ w + b)``: the kernel forward and the JAX package's VJP."""

    @staticmethod
    def forward(ctx, x, w, b, act):
        out = _forward(x, w, b, act)
        ctx.save_for_backward(x, w, b, out)
        ctx.act = act
        return out

    @staticmethod
    def backward(ctx, g):
        x, w, b, out = ctx.saved_tensors
        act = ctx.act
        if act == "linear":
            d_pre = g
        elif act == "relu":
            d_pre = g * (out > 0).to(g.dtype)
        elif act == "sigmoid":
            d_pre = g * out * (1.0 - out)
        else:  # silu'(z) = sig(z) * (1 + z * (1 - sig(z))); recompute z
            z = x @ w + b[None, :]
            s = torch.sigmoid(z)
            d_pre = g * (s * (1.0 + z * (1.0 - s)))
        return d_pre @ w.T, x.T @ d_pre, d_pre.sum(dim=0), None


def fused_dense(x, w, b, act: str = "relu"):
    """``act(x @ w + b)`` with the activation fused into the matmul's
    epilogue. ``x`` (M, K) and ``w`` (K, N) share fp32 or bf16; ``b`` (N,)
    is fp32 or bf16; act is linear, relu, silu or sigmoid. Differentiable."""
    _check(x, w, b, act)
    return FusedDense.apply(x, w, b, act)


__all__ = ["ACTS", "fused_dense", "fused_dense_reference", "takes_fast_path"]
