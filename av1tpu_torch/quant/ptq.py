"""BN folding, the folded float forward, and post-training int8 serving.

Counterpart of ``av1tpu.quant.ptq``. The float part (``fold_backbone``,
``fold_head``, ``is_plain_stage``, ``_conv_f``, the float paths of
``_backbone_apply`` / ``_head_apply``) serves the folded pipelines; folded
trees hold torch layouts there: conv ``weight`` OIHW, dense ``weight``
``(out, in)``, plus ``bias``. Both parts compute the SE and spatial-attention
gates as XLA expands ``jax.nn.sigmoid`` (``_sigmoid``), so that bf16 rounds
where the JAX graph rounds. Folding runs in fp32; the serving dtype is
applied afterwards (``cast_tree``), as the JAX path casts folded fp32
kernels per call.

The int8 part is the JAX package's two lowerings, "hybrid" (the default)
and "im2col":

* **Layouts.** The int8 graph runs channels-last (NHWC) over a folded tree
  in the JAX package's layouts: conv ``kernel`` HWIO, dense ``kernel``
  ``(in, out)`` (:func:`jax_layout_backbone`, :func:`jax_layout_head`). A
  flattened int8 kernel is ``(9 * C, O)`` in (dh, dw, c) row order, a
  spatial-matmul site flattens its activation in NHWC row order, and a
  calibration absmax is one value per channel (or per flat position and
  channel), so weights, scales, SMM matrices and absmax equal the JAX
  package's element for element.
* **Integer products** (``_int_dot``) are ``torch._int_mm``: int8 x int8 ->
  int32, exact, on the CPU and on the card's int8 tensor cores. The card's
  ``_int_mm`` takes more than 16 rows and widths that are multiples of 8, so
  ``_int_dot`` pads with zero rows and zero columns and trims; nothing falls
  back to a float product. A 3x3 conv is im2col (``_patches3x3``, XLA
  "SAME" padding) then one product; at a 1x1 extent it is the center tap.
* **Spatial matmul (SMM), hybrid only.** Blocks at extent <= 2, or <= 4
  outside layer group 1, run each conv as one dense ``(h*w*Ci, ho*wo*Co)``
  product whose zeros carry the padding (:func:`build_smm_matrix`, padding
  from ``models.layers.same_padding``). The plan that says so bakes the
  calibration extent into the model, which refuses any other.
* **im2col** (``plan=None``) runs every 3x3 and 1x1 site as an int8 conv
  (the center tap at a 1x1 extent): no SMM matrix and no extent baked in,
  so one model serves any block size.
* **Float islands** (stem, SE and spatial-attention gates, residual adds,
  dequantization) run in ``float_dtype``, rounding where the JAX graph
  rounds: activations quantize from fp32, products dequantize as
  ``int32 -> fp32 * scale``, cast to ``float_dtype``, then the bias is added
  in ``float_dtype``.
* **Calibration** (per-site absmax, equalization, bias correction) is one
  observe-mode fp32 forward, with TF32 off for convs and matmuls
  (:func:`exact_fp32`). Kernel K1 replaces the stem in serving only
  (:func:`attach_fused_front`), at 8 and 16 px.

``QuantStageModel`` and ``QuantUnifiedModel`` are ``nn.Module``s whose int8
weights, scales, biases, folded weights and SMM matrices are buffers, so
``.to(device)`` moves the whole model (and rebuilds an attached K1 front).
"""
from __future__ import annotations

import contextlib
from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from av1tpu_torch.data.records import NORM_10BIT
from av1tpu_torch.kernels.fused_front import make_fused_front, supports_extent
from av1tpu_torch.models.layers import BN_EPS, MLPHead, pad_same, same_padding
from av1tpu_torch.models.v6 import ImprovedBackbone

_GROUPS = ("layer1", "layer2", "layer3", "layer4")


def _fold(conv_weight: torch.Tensor, bn: nn.BatchNorm2d):
    """Fold an inference-mode BatchNorm into the conv before it:
    ``conv(x)*k + (bias - mean*k)`` with ``k = scale/sqrt(var+eps)``."""
    k = bn.weight.detach().float() / torch.sqrt(
        bn.running_var.detach().float() + BN_EPS
    )
    w = conv_weight.detach().float() * k[:, None, None, None]
    return {"weight": w, "bias": bn.bias.detach().float() - bn.running_mean.float() * k}


def is_plain_stage(model: nn.Module) -> bool:
    """True for the ImprovedBackbone + MLPHead layout that
    ``fold_backbone`` / ``fold_head`` understand (the FGVC model's
    projection + cosine head is not one)."""
    return isinstance(getattr(model, "backbone", None), ImprovedBackbone) and (
        isinstance(getattr(model, "head", None), MLPHead)
    )


def fold_backbone(backbone: ImprovedBackbone) -> Dict[str, Any]:
    """BN-fold an ImprovedBackbone into conv weight+bias entries plus the
    SE and spatial-attention weights, all fp32."""
    folded: Dict[str, Any] = {"stem": _fold(backbone.conv1.weight, backbone.bn1)}
    for gi, gname in enumerate(_GROUPS, start=1):
        for bi, blk in enumerate(getattr(backbone, gname)):
            folded[f"{gname}_{bi}"] = {
                "conv1": _fold(blk.conv1.weight, blk.bn1),
                "conv2": _fold(blk.conv2.weight, blk.bn2),
                "downsample": None if blk.downsample is None
                else _fold(blk.downsample[0].weight, blk.downsample[1]),
            }
        exc = getattr(backbone, f"se{gi}").excitation
        folded[f"se{gi}"] = {
            "d0": exc[0].weight.detach().float(),
            "d1": exc[2].weight.detach().float(),
        }
    folded["spatial_attn"] = backbone.spatial_attn.conv.weight.detach().float()
    return folded


def fold_head(head: MLPHead) -> List[Dict[str, torch.Tensor]]:
    """An MLPHead's Linear layers as an ordered weight+bias list."""
    return [
        {"weight": m.weight.detach().float(), "bias": m.bias.detach().float()}
        for m in head.head if isinstance(m, nn.Linear)
    ]


def cast_tree(tree, device, dtype):
    """Copy every tensor of a folded tree to ``device`` / ``dtype``."""
    if isinstance(tree, dict):
        return {k: cast_tree(v, device, dtype) for k, v in tree.items()}
    if isinstance(tree, list):
        return [cast_tree(v, device, dtype) for v in tree]
    if tree is None:
        return None
    return tree.to(device=device, dtype=dtype)


def _conv_f(x: torch.Tensor, weight: torch.Tensor, stride: int) -> torch.Tensor:
    """3x3 XLA-"SAME" conv of an NCHW tensor, as a center-tap matmul at a
    1x1 extent with stride 1 (as the JAX path does)."""
    weight = weight.to(x.dtype)
    if x.shape[2] == 1 and x.shape[3] == 1 and stride == 1 and weight.shape[2] == 3:
        return (x[:, :, 0, 0] @ weight[:, :, 1, 1].T)[:, :, None, None]
    return F.conv2d(pad_same(x, weight.shape[2], stride), weight, stride=stride)


def _sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``1 / (1 + exp(-x))`` with every op rounded to ``x``'s dtype: how XLA
    expands ``jax.nn.sigmoid``. In bf16 ``torch.sigmoid`` rounds once and
    differs from it by one step on about a third of the values."""
    return torch.reciprocal(1 + torch.exp(-x))


def _bias(t: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    return t + bias.to(t.dtype)[None, :, None, None]


def _backbone_apply(
    folded: Dict[str, Any],
    x: torch.Tensor,
    float_dtype=torch.float32,
    front_fn: Optional[Callable] = None,
    front_g1_fn: Optional[Callable] = None,
    group12_fn: Optional[Callable] = None,
) -> torch.Tensor:
    """ImprovedBackbone forward over folded weights: NHWC ``(B, H, W, 1)``
    in, ``(B, 512)`` embedding out.

    ``front_fn`` replaces stem conv + bias + relu + maxpool (kernel K1,
    ``kernels.fused_front.make_fused_front``); ``front_g1_fn`` replaces
    that and layer group 1 with SE1 (kernel K2), so the forward resumes at
    group 2. Both take the NHWC input and return NHWC ``(B, H/4, W/4, 64)``.
    ``group12_fn`` replaces layer groups 1 and 2 with SE1 and SE2 (kernel
    K5, ``kernels.resnet_group.fused_group12``): NHWC ``(B, h, w, 64)`` in,
    ``(B, h/2, w/2, 128)`` out, after ``front_fn`` or the plain stem. As in
    the JAX package, ``front_g1_fn`` takes precedence: with it, group 1 is
    done and ``group12_fn`` is not called.
    """
    x = x.to(float_dtype)
    groups = list(enumerate(_GROUPS, start=1))
    if front_g1_fn is not None:
        x = front_g1_fn(x).permute(0, 3, 1, 2)
        groups = groups[1:]
        group12_fn = None
    elif front_fn is not None:
        x = front_fn(x).permute(0, 3, 1, 2)
    else:
        stem = folded["stem"]
        x = F.conv2d(x.permute(0, 3, 1, 2), stem["weight"].to(float_dtype),
                     stride=2, padding=3)
        x = torch.relu(_bias(x, stem["bias"]))
        x = F.max_pool2d(x, 3, stride=2, padding=1)
    if group12_fn is not None:
        x = group12_fn(x.permute(0, 2, 3, 1).contiguous()).permute(0, 3, 1, 2)
        groups = groups[2:]

    for gi, gname in groups:
        for bi in range(2):
            blk = folded[f"{gname}_{bi}"]
            stride = 2 if (gi > 1 and bi == 0) else 1
            y = torch.relu(_bias(_conv_f(x, blk["conv1"]["weight"], stride),
                                 blk["conv1"]["bias"]))
            y = _bias(_conv_f(y, blk["conv2"]["weight"], 1), blk["conv2"]["bias"])
            res = x
            if blk["downsample"] is not None:
                ds = blk["downsample"]
                res = _bias(F.conv2d(x, ds["weight"].to(x.dtype), stride=stride),
                            ds["bias"])
            x = torch.relu(y + res)
        se = folded[f"se{gi}"]
        g = x.mean(dim=(2, 3))
        g = torch.relu(g @ se["d0"].to(g.dtype).T)
        g = _sigmoid(g @ se["d1"].to(g.dtype).T)
        x = x * g[:, :, None, None]

    sa = folded["spatial_attn"].to(float_dtype)  # (1, 2, 7, 7)
    a = torch.cat([x.mean(dim=1, keepdim=True), x.amax(dim=1, keepdim=True)], 1)
    if x.shape[2] == 1 and x.shape[3] == 1:
        attn = (a[:, :, 0, 0] @ sa[0, :, 3, 3])[:, None, None, None]
    else:
        attn = F.conv2d(a, sa, padding=3)
    x = x * _sigmoid(attn)
    return x.mean(dim=(2, 3))


def _head_apply(head: List[Dict[str, torch.Tensor]], x: torch.Tensor,
                float_dtype=torch.float32) -> torch.Tensor:
    """MLPHead forward over ``fold_head`` layers (dropout is identity)."""
    x = x.to(float_dtype)
    for i, layer in enumerate(head):
        x = x @ layer["weight"].to(x.dtype).T + layer["bias"].to(x.dtype)
        if i < len(head) - 1:
            x = torch.relu(x)
    return x


# ---------------------------------------------------------------------------
# int8: layouts and helpers
# ---------------------------------------------------------------------------


_HWIO, _OIHW = (2, 3, 1, 0), (3, 2, 0, 1)  # the permutes OIHW -> HWIO -> OIHW


def _oihw(kernel: torch.Tensor) -> torch.Tensor:
    return kernel.permute(*_OIHW).contiguous()


def _relayout(folded: Dict[str, Any], src: str, dst: str, perm) -> Dict[str, Any]:
    """A folded backbone tree with its conv entries' ``src`` tensors permuted
    by ``perm`` into ``dst``, and the SE matrices transposed."""

    def conv(entry):
        if entry is None:
            return None
        return {dst: entry[src].permute(*perm).contiguous(), "bias": entry["bias"]}

    out: Dict[str, Any] = {"stem": conv(folded["stem"])}
    for gi, gname in enumerate(_GROUPS, start=1):
        for bi in range(2):
            blk = folded[f"{gname}_{bi}"]
            out[f"{gname}_{bi}"] = {k: conv(blk[k]) for k in ("conv1", "conv2", "downsample")}
        out[f"se{gi}"] = {k: v.T.contiguous() for k, v in folded[f"se{gi}"].items()}
    out["spatial_attn"] = folded["spatial_attn"].permute(*perm).contiguous()
    return out


def jax_layout_backbone(folded: Dict[str, Any]) -> Dict[str, Any]:
    """A :func:`fold_backbone` tree in the JAX package's layouts: conv
    ``kernel`` HWIO, SE ``d0`` / ``d1`` ``(in, out)``, spatial attention
    ``(7, 7, 2, 1)``; the tree the int8 graph runs on."""
    return _relayout(folded, "weight", "kernel", _HWIO)


def _torch_layout_backbone(folded: Dict[str, Any]) -> Dict[str, Any]:
    """The inverse of :func:`jax_layout_backbone`."""
    return _relayout(folded, "kernel", "weight", _OIHW)


def jax_layout_head(head: List[Dict[str, torch.Tensor]]) -> List[Dict[str, torch.Tensor]]:
    """A :func:`fold_head` stack with ``(in, out)`` dense kernels."""
    return [{"kernel": layer["weight"].T.contiguous(), "bias": layer["bias"]}
            for layer in head]


@contextlib.contextmanager
def exact_fp32():
    """TF32 off for cuDNN convs and cuBLAS matmuls (cuDNN uses it for fp32 by
    default), restored on exit: calibration and bias correction are fp32
    reference arithmetic."""
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def _f32(value: float) -> float:
    """``value`` rounded to fp32, as ``np.float32(s_x)`` rounds it in JAX."""
    return float(np.float32(value))


def _conv_nhwc(x: torch.Tensor, kernel: torch.Tensor, stride: int,
               padding=None) -> torch.Tensor:
    """Conv of an NHWC tensor with an HWIO kernel: XLA "SAME" padding, or
    ``padding`` (symmetric) when given."""
    xc = x.permute(0, 3, 1, 2)
    weight = _oihw(kernel.to(x.dtype))
    if padding is None:
        y = F.conv2d(pad_same(xc, kernel.shape[0], stride), weight, stride=stride)
    else:
        y = F.conv2d(xc, weight, stride=stride, padding=padding)
    return y.permute(0, 2, 3, 1)


def _conv_f_nhwc(x: torch.Tensor, kernel: torch.Tensor, stride: int) -> torch.Tensor:
    """Float 3x3 SAME conv (NHWC, HWIO) with the center-tap collapse at a 1x1
    extent and stride 1."""
    kernel = kernel.to(x.dtype)
    if x.shape[1] == 1 and x.shape[2] == 1 and stride == 1 and kernel.shape[0] == 3:
        return (x[:, 0, 0, :] @ kernel[1, 1])[:, None, None, :]
    return _conv_nhwc(x, kernel, stride)


def _conv1x1_f(x: torch.Tensor, kernel: torch.Tensor, stride: int) -> torch.Tensor:
    """Float 1x1 SAME conv (the downsample): no padding at any extent, so it
    reads every ``stride``-th position."""
    return x[:, ::stride, ::stride, :] @ kernel[0, 0].to(x.dtype)


# ---------------------------------------------------------------------------
# int8: integer primitives
# ---------------------------------------------------------------------------


def _quant_weight(kernel: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-output-channel symmetric int8: kernel ``(..., O)`` -> (``(K, O)``
    int8, ``(O,)`` fp32 scales). The row order of an HWIO kernel's flat form
    is (dh, dw, c), that of :func:`_patches3x3`."""
    flat = kernel.float().reshape(-1, kernel.shape[-1])
    s = flat.abs().amax(dim=0).clamp_min(1e-8) / 127.0
    wq = torch.clamp(torch.round(flat / s), -127, 127).to(torch.int8)
    return wq, s


def _quant_act(x: torch.Tensor, act) -> torch.Tensor:
    """Symmetric int8 activation (zero-point 0). ``act = (inv, s_x)``:
    ``inv`` is the per-channel multiplier ``1 / (e_c * s_x)`` folding the
    equalization vector into the quantizer, ``s_x`` the per-tensor scale the
    dequantization uses. Rounds half to even, from fp32."""
    return torch.clamp(torch.round(x.float() * act[0]), -127, 127).to(torch.int8)


def _int_dot(lhs: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """``lhs (..., K) int8 @ rhs (K, N) int8 -> (..., N) int32``, exact.

    One ``torch._int_mm``; on the card it takes more than 16 rows and K and N
    that are multiples of 8, so the operands are padded with zero rows and
    columns (which add nothing to any sum) and the result is trimmed."""
    lead, k = lhs.shape[:-1], lhs.shape[-1]
    a = lhs.reshape(-1, k)
    m, n = a.shape[0], rhs.shape[1]
    pad_m, pad_k, pad_n = max(0, 17 - m), -k % 8, -n % 8
    if pad_m or pad_k:
        a = F.pad(a, (0, pad_k, 0, pad_m))
    if pad_k or pad_n:
        rhs = F.pad(rhs, (0, pad_n, 0, pad_k))
    y = torch._int_mm(a.contiguous(), rhs.contiguous())
    if pad_m or pad_n:
        y = y[:m, :n]
    return y.reshape(*lead, n)


def _patches3x3(x: torch.Tensor, stride: int) -> torch.Tensor:
    """SAME 3x3 im2col: ``(B, H, W, C) -> (B, H', W', 9C)``, zero padded
    (exact for symmetric quantization), any dtype. Padding is XLA "SAME":
    stride 1 pads (1, 1); stride 2 on even extents pads (0, 1), so the window
    of output ``o`` starts at input row ``2 * o``."""
    b, h, w, c = x.shape
    top, bottom = same_padding(h, 3, stride)
    left, right = same_padding(w, 3, stride)
    xp = F.pad(x, (0, 0, left, right, top, bottom))
    ho, wo = -(-h // stride), -(-w // stride)
    taps = [xp[:, dh:dh + stride * (ho - 1) + 1:stride, dw:dw + stride * (wo - 1) + 1:stride, :]
            for dh in range(3) for dw in range(3)]
    return torch.cat(taps, dim=-1)


def _int_conv(x_i8: torch.Tensor, k_i8: torch.Tensor, stride: int) -> torch.Tensor:
    """Direct int8 SAME 3x3 conv with int32 accumulation: im2col, then one
    integer product with the HWIO kernel flattened to ``(9 * C, O)``."""
    return _int_dot(_patches3x3(x_i8, stride), k_i8.reshape(-1, k_i8.shape[-1]))


def _qconv3x3(x, act, w_i8, s_w, stride: int, float_dtype):
    """int8 3x3 SAME conv: the center tap at a 1x1 extent (exact for any
    stride: the window holds only padding zeros besides the center pixel),
    im2col and one integer product otherwise. ``w_i8`` is the flat
    ``(9 * C, O)`` int8 kernel."""
    xq = _quant_act(x, act)
    scale = s_w * _f32(act[1])
    c = x.shape[-1]
    if x.shape[1] == 1 and x.shape[2] == 1:
        y = _int_dot(xq[:, 0, 0, :], w_i8.reshape(9, c, -1)[4])
        return (y.float() * scale)[:, None, None, :].to(float_dtype)
    y = _int_conv(xq, w_i8.reshape(3, 3, c, -1), stride)
    return (y.float() * scale).to(float_dtype)


def _qconv1x1(x, act, w_i8, s_w, stride: int, float_dtype):
    xq = _quant_act(x, act)
    if stride != 1:
        xq = xq[:, ::stride, ::stride, :]
    y = _int_dot(xq, w_i8)
    return (y.float() * (s_w * _f32(act[1]))).to(float_dtype)


# ---------------------------------------------------------------------------
# int8: the spatial-matmul (SMM) lowering
# ---------------------------------------------------------------------------
#
# After the stem the 16 px pipeline's extents are 4x4 -> 1x1. The SMM lowering
# flattens spatial x channel into one axis (NHWC row order) and writes a SAME
# conv at extent (h, w) as one dense (h*w*Ci, ho*wo*Co) product whose block
# structure holds the taps and the padding zeros: fewer MACs than 9-tap
# im2col at 2x2, 16/9 more at 4x4, one large integer product either way.


def build_smm_matrix(kernel, h: int, w: int, stride: int) -> np.ndarray:
    """Dense ``(h*w*Ci, ho*wo*Co)`` matrix equal to a SAME 3x3 conv (HWIO
    ``kernel``) at extent (h, w): ``conv(x) == (x.reshape(B, -1) @ M)
    .reshape(B, ho, wo, Co)``. Padding is ``models.layers.same_padding``'s:
    stride 1 pads (1, 1); stride 2 pads (0, 1) at even extents and (1, 1) at
    a 1x1 extent, where the single output reads the center tap."""
    k = np.asarray(kernel.detach().cpu() if isinstance(kernel, torch.Tensor) else kernel,
                   np.float32)
    kh, kw, ci, co = k.shape
    ho, wo = -(-h // stride), -(-w // stride)
    m = np.zeros((h * w * ci, ho * wo * co), np.float32)
    pad_y = same_padding(h, kh, stride)[0]
    pad_x = same_padding(w, kw, stride)[0]
    for oy in range(ho):
        for ox in range(wo):
            dst = (oy * wo + ox) * co
            for dy in range(kh):
                for dx in range(kw):
                    iy, ix = oy * stride + dy - pad_y, ox * stride + dx - pad_x
                    if 0 <= iy < h and 0 <= ix < w:
                        src = (iy * w + ix) * ci
                        m[src:src + ci, dst:dst + co] = k[dy, dx]
    return m


def build_smm_matrix_1x1(kernel, h: int, w: int, stride: int) -> np.ndarray:
    """SMM matrix of a 1x1 conv (the downsample shortcut): output position
    (oy, ox) reads input position (oy * stride, ox * stride)."""
    k = np.asarray(kernel.detach().cpu() if isinstance(kernel, torch.Tensor) else kernel,
                   np.float32)[0, 0]
    ci, co = k.shape
    ho, wo = -(-h // stride), -(-w // stride)
    m = np.zeros((h * w * ci, ho * wo * co), np.float32)
    for oy in range(ho):
        for ox in range(wo):
            src = ((oy * stride) * w + (ox * stride)) * ci
            dst = (oy * wo + ox) * co
            m[src:src + ci, dst:dst + co] = k
    return m


def _stem_out_extent(hw: int) -> int:
    """Input extent -> extent after the stem (7x7/2 conv, padding 3) and the
    3x3/2 maxpool (padding 1)."""
    conv_out = (hw + 6 - 7) // 2 + 1
    return (conv_out + 2 - 3) // 2 + 1


def _plan_backbone(folded: Dict[str, Any], hw: int) -> Dict[str, Any]:
    """Each block's lowering at input extent ``hw``, with the SMM weights and
    position-tiled biases (fp32, on the folded tree's device). A block lowers
    to SMM when its input extent is <= 2, or <= 4 outside group 1; otherwise
    it stays an int8 conv. ``folded`` is in JAX layouts.

    Returns ``{"hw", "blocks": {name: {"form", "s", "so", "stride", "ch"}},
    "smm_w": {wkey: (K, N)}, "smm_b": {wkey: (N,)}}``."""
    device = folded["stem"]["kernel"].device
    s = _stem_out_extent(hw)
    blocks: Dict[str, Dict] = {}
    smm_w: Dict[str, torch.Tensor] = {}
    smm_b: Dict[str, torch.Tensor] = {}

    def put(wkey, matrix, bias, so):
        smm_w[wkey] = torch.from_numpy(matrix).to(device)
        smm_b[wkey] = bias.detach().float().repeat(so * so).to(device)

    for gi, gname in enumerate(_GROUPS, start=1):
        for bi in range(2):
            n = f"{gname}_{bi}"
            blk = folded[n]
            stride = 2 if (gi > 1 and bi == 0) else 1
            so = max(1, -(-s // stride))
            use_smm = s <= 2 or (s <= 4 and gi >= 2)
            blocks[n] = {"form": "smm" if use_smm else "conv", "s": s, "so": so,
                         "stride": stride, "ch": int(blk["conv2"]["kernel"].shape[-1])}
            if use_smm:
                put(f"{n}.conv1", build_smm_matrix(blk["conv1"]["kernel"], s, s, stride),
                    blk["conv1"]["bias"], so)
                put(f"{n}.conv2", build_smm_matrix(blk["conv2"]["kernel"], so, so, 1),
                    blk["conv2"]["bias"], so)
                if blk["downsample"] is not None:
                    put(f"{n}.ds", build_smm_matrix_1x1(blk["downsample"]["kernel"],
                                                        s, s, stride),
                        blk["downsample"]["bias"], so)
            s = so
    return {"hw": hw, "blocks": blocks, "smm_w": smm_w, "smm_b": smm_b}


def _check_plan_extent(plan: Optional[Dict], x) -> None:
    """A hybrid-lowered model bakes its calibration extent into its SMM
    matrices and scales: refuse another extent up front (an im2col model,
    ``plan=None``, takes any)."""
    hw = plan.get("hw") if plan is not None else None
    if hw is not None and (x.shape[1] != hw or x.shape[2] != hw):
        raise ValueError(
            f"model was quantized for {hw}x{hw} inputs, got "
            f"{x.shape[1]}x{x.shape[2]} — re-quantize with calibration "
            f"images of this extent (the hybrid lowering bakes SMM "
            f"matrices per spatial size)"
        )


# ---------------------------------------------------------------------------
# int8: the hybrid forward (observe mode / quantize mode)
# ---------------------------------------------------------------------------


def _observer(observed, captured):
    def observe(site, t):
        if observed is not None:
            m = t.abs().amax(dim=tuple(range(t.ndim - 1))).float()
            observed[site] = torch.maximum(observed[site], m) if site in observed else m
        if captured is not None:
            captured[site] = t
    return observe


def _backbone_apply_hybrid(
    folded: Dict[str, Any],
    x: torch.Tensor,
    plan: Optional[Dict[str, Any]],
    scales: Optional[Dict[str, Tuple]] = None,
    qw: Optional[Dict[str, Tuple]] = None,
    observed: Optional[Dict] = None,
    float_dtype=torch.float32,
    qbias: Optional[Dict[str, torch.Tensor]] = None,
    captured: Optional[Dict] = None,
    front_fn: Optional[Callable] = None,
) -> torch.Tensor:
    """The int8-lowered backbone forward, NHWC ``(B, H, W, 1)`` in,
    ``(B, 512)`` out, over a folded tree in JAX layouts: each block as
    ``plan`` says (hybrid), or every block as an int8 conv with
    ``plan=None`` (im2col, the JAX package's ``_backbone_apply``).

    ``qw`` and ``scales`` given: the int8 graph (``qbias`` overrides the
    folded biases per weight key). Otherwise the float graph of the same
    lowering; ``observed={}`` collects each site's per-channel absmax (per
    flat position and channel at SMM sites) and ``captured={}`` keeps each
    site's input, the tensors the int8 graph quantizes. ``front_fn`` replaces
    stem + bias + relu + maxpool (kernel K1), NHWC in and out."""
    quant = qw is not None
    nb = x.shape[0]
    observe = _observer(observed, captured)

    def bias(wkey, base):
        if quant and qbias is not None and wkey in qbias:
            return qbias[wkey]
        return base

    def conv3(site, wkey, xin, entry, stride):
        observe(site, xin)
        if quant:
            y = _qconv3x3(xin, scales[site], *qw[wkey], stride, float_dtype)
        else:
            y = _conv_f_nhwc(xin, entry["kernel"], stride)
        return y + bias(wkey, entry["bias"]).to(y.dtype)

    def conv1(site, wkey, xin, entry, stride):
        observe(site, xin)
        if quant:
            y = _qconv1x1(xin, scales[site], *qw[wkey], stride, float_dtype)
        else:
            y = _conv1x1_f(xin, entry["kernel"], stride)
        return y + bias(wkey, entry["bias"]).to(y.dtype)

    def smm_mm(site, wkey, xin):
        observe(site, xin)
        if quant:
            act = scales[site]
            w_i8, s_w = qw[wkey]
            y = (_int_dot(_quant_act(xin, act), w_i8).float()
                 * (s_w * _f32(act[1]))).to(float_dtype)
        else:
            y = xin @ plan["smm_w"][wkey].to(xin.dtype)
        return y + bias(wkey, plan["smm_b"][wkey]).to(y.dtype)

    x = x.to(float_dtype)
    if front_fn is not None:
        x = front_fn(x)
    else:
        stem = folded["stem"]
        x = _conv_nhwc(x, stem["kernel"], 2, padding=3)
        x = torch.relu(x + stem["bias"].to(float_dtype))
        x = F.max_pool2d(x.permute(0, 3, 1, 2), 3, stride=2, padding=1).permute(0, 2, 3, 1)

    flat = False
    for gi, gname in enumerate(_GROUPS, start=1):
        for bi in range(2):
            n = f"{gname}_{bi}"
            blk = folded[n]
            stride = 2 if (gi > 1 and bi == 0) else 1
            p = {"form": "conv"} if plan is None else plan["blocks"][n]
            if p["form"] == "smm":
                if not flat:
                    x = x.reshape(nb, -1)
                    flat = True
                y = torch.relu(smm_mm(f"{n}.in", f"{n}.conv1", x))
                y = smm_mm(f"{n}.mid", f"{n}.conv2", y)
                res = x if blk["downsample"] is None else smm_mm(f"{n}.in", f"{n}.ds", x)
            else:
                if flat:
                    x = x.reshape(nb, p["s"], p["s"], -1)
                    flat = False
                y = torch.relu(conv3(f"{n}.in", f"{n}.conv1", x, blk["conv1"], stride))
                y = conv3(f"{n}.mid", f"{n}.conv2", y, blk["conv2"], 1)
                res = x if blk["downsample"] is None else conv1(
                    f"{n}.in", f"{n}.ds", x, blk["downsample"], stride)
            x = torch.relu(y + res)
        se = folded[f"se{gi}"]
        if flat:
            ch = plan["blocks"][f"{gname}_1"]["ch"]
        g = x.reshape(nb, -1, ch).mean(dim=1) if flat else x.mean(dim=(1, 2))
        g = torch.relu(g @ se["d0"].to(g.dtype))
        g = _sigmoid(g @ se["d1"].to(g.dtype))
        if flat:
            x = (x.reshape(nb, -1, ch) * g[:, None, :]).reshape(nb, -1)
        else:
            x = x * g[:, None, None, :]

    if flat:
        so = plan["blocks"]["layer4_1"]["so"]
        x = x.reshape(nb, so, so, -1)
    sa = folded["spatial_attn"].to(float_dtype)  # (7, 7, 2, 1)
    a = torch.cat([x.mean(dim=-1, keepdim=True), x.amax(dim=-1, keepdim=True)], dim=-1)
    if x.shape[1] == 1 and x.shape[2] == 1:
        attn = (a[:, 0, 0, :] @ sa[3, 3])[:, None, None, :]
    else:
        attn = _conv_nhwc(a, sa, 1)
    x = x * _sigmoid(attn)
    return x.mean(dim=(1, 2))


def _head_apply_int8(
    head: List[Dict[str, torch.Tensor]],
    x: torch.Tensor,
    scales: Optional[Dict[str, Tuple]] = None,
    qw: Optional[Dict[str, Tuple]] = None,
    observed: Optional[Dict] = None,
    float_dtype=torch.float32,
    qbias: Optional[Dict[str, torch.Tensor]] = None,
    captured: Optional[Dict] = None,
    site_prefix: str = "head",
) -> torch.Tensor:
    """MLPHead forward over ``(in, out)`` kernels, observe or quantize mode.
    ``site_prefix`` names the sites (``head.0``, ...) so that several heads on
    one backbone (the unified model) calibrate under distinct keys."""
    quant = qw is not None
    observe = _observer(observed, captured)
    x = x.to(float_dtype)
    for i, layer in enumerate(head):
        site = f"{site_prefix}.{i}"
        observe(site, x)
        if quant:
            w_i8, s_w = qw[site]
            act = scales[site]
            b = qbias[site] if qbias is not None and site in qbias else layer["bias"]
            x = (_int_dot(_quant_act(x, act), w_i8).float()
                 * (s_w * _f32(act[1]))).to(float_dtype) + b.to(float_dtype)
        else:
            x = x @ layer["kernel"].to(x.dtype) + layer["bias"].to(x.dtype)
        if i < len(head) - 1:
            x = torch.relu(x)
    return x


# ---------------------------------------------------------------------------
# int8: quantized models
# ---------------------------------------------------------------------------


def _leaves(tree, path=()):
    if isinstance(tree, torch.Tensor):
        yield path, tree
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (str(i),))


def _rebuild(tree, buffers, path=()):
    """``tree`` with every tensor replaced by the buffer of its path."""
    if isinstance(tree, torch.Tensor):
        return buffers[_buffer_name(path)]
    if isinstance(tree, dict):
        return {k: _rebuild(v, buffers, path + (str(k),)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, buffers, path + (str(i),)) for i, v in enumerate(tree))
    return tree


def _buffer_name(path) -> str:
    return "__".join(path).replace(".", "_")


class _QuantModel(nn.Module):
    """State and behaviour shared by the int8 stage and unified models.

    The tensor trees ``folded``, the heads, ``scales`` (site -> ``(inv,
    s_x)``), ``qw`` (weight key -> ``(int8 (K, O), s_w (O,))``), ``qbias`` and
    ``plan`` are registered as buffers (``calib_amax`` stays host numpy, as
    the JAX package keeps it), so ``.to(device)`` moves them all; an attached
    K1 front is rebuilt on the new device. ``plan=None`` is the im2col
    lowering."""

    _TREES = ("folded", "heads", "scales", "qw", "qbias", "plan")

    def __init__(self, folded, heads, scales, qw, float_dtype=torch.float32,
                 qbias=None, plan=None, calib_amax=None):
        super().__init__()
        self.float_dtype = float_dtype
        self.calib_amax = calib_amax
        self.front_fn = None
        self._front = None  # (hw, dtype) of an attached K1 front
        self._trees = {}
        for name, tree in zip(self._TREES, (folded, heads, scales, qw, qbias, plan)):
            for path, t in _leaves(tree, (name,)):
                self.register_buffer(_buffer_name(path), t)
            self._trees[name] = tree

    folded = property(lambda self: self._trees["folded"])
    heads = property(lambda self: self._trees["heads"])
    scales = property(lambda self: self._trees["scales"])
    qw = property(lambda self: self._trees["qw"])
    qbias = property(lambda self: self._trees["qbias"])
    plan = property(lambda self: self._trees["plan"])

    def _apply(self, fn, recurse=True):
        super()._apply(fn, recurse)
        self._trees = {name: _rebuild(tree, self._buffers, (name,))
                       for name, tree in self._trees.items()}
        if self._front is not None:
            attach_fused_front(self, *self._front)
        return self

    def _features(self, x, quant: bool):
        if not quant:  # the BN-folded float reference forward: the plain conv graph
            return _backbone_apply(_torch_layout_backbone(self.folded), x)
        _check_plan_extent(self.plan, x)
        return _backbone_apply_hybrid(
            self.folded, x, self.plan, self.scales, self.qw,
            float_dtype=self.float_dtype, qbias=self.qbias, front_fn=self.front_fn)

    def _head(self, name, feats, quant: bool):
        if quant:
            return _head_apply_int8(self.heads[name], feats, self.scales, self.qw,
                                    float_dtype=self.float_dtype, qbias=self.qbias,
                                    site_prefix=name)
        return _head_apply_int8(self.heads[name], feats)


class QuantStageModel(_QuantModel):
    """A BN-folded, int8-quantized v6 stage model: ``forward(x) -> logits``
    on normalized NHWC images, through the hybrid lowering of ``plan`` (or
    im2col without one).
    ``float_forward`` is the BN-folded fp32 reference (same weights, no
    int8)."""

    def __init__(self, folded, head, scales, qw, float_dtype=torch.float32,
                 qbias=None, plan=None, calib_amax=None):
        super().__init__(folded, {"head": head}, scales, qw, float_dtype, qbias, plan,
                         calib_amax)

    @property
    def head(self):
        return self.heads["head"]

    def forward(self, x):
        return self._head("head", self._features(x, True), True)

    def float_forward(self, x):
        with exact_fp32():
            return self._head("head", self._features(x, False), False)


# Unified-model head order; the site prefixes are the flax submodule names,
# and the packed logits follow models.v6.UNIFIED_LOGIT_SLICES.
_UNIFIED_HEADS = ("head_stage1", "head_stage2", "head_rect", "head_ab")


class QuantUnifiedModel(_QuantModel):
    """An int8-quantized ``UnifiedV6Model``: ``forward(x) -> (N, 10)`` fp32
    packed logits (``split_unified_logits`` layout) from one int8 backbone
    forward and four int8 dense head stacks."""

    def _forward(self, x, quant: bool):
        feats = self._features(x, quant)
        return torch.cat([self._head(name, feats, quant).float()
                          for name in _UNIFIED_HEADS], dim=-1)

    def forward(self, x):
        return self._forward(x, True)

    def float_forward(self, x):
        with exact_fp32():
            return self._forward(x, False)


# ---------------------------------------------------------------------------
# int8: calibration and quantization
# ---------------------------------------------------------------------------


def _as_heads(head) -> Dict[str, List[Dict]]:
    """One dense stack (list) -> the named-heads form ``{"head": stack}``."""
    return head if isinstance(head, Mapping) else {"head": head}


def calibrate(folded: Dict[str, Any], head, calib_x: torch.Tensor,
              capture: bool = False, plan: Optional[Dict] = None):
    """One fp32 observe-mode forward of the graph that ``plan`` lowers (im2col
    without one) over ``calib_x`` (normalized NHWC, on the folded tree's
    device), TF32 off: each int8 site's per-channel absmax as a float64 numpy
    vector, plus each site's input tensor when ``capture`` (for bias
    correction). ``head`` is one dense stack or a dict of named stacks;
    ``folded`` and the stacks are in JAX layouts."""
    observed: Dict[str, torch.Tensor] = {}
    captured: Optional[Dict[str, torch.Tensor]] = {} if capture else None
    with exact_fp32(), torch.no_grad():
        feats = _backbone_apply_hybrid(folded, calib_x.float(), plan, observed=observed,
                                       captured=captured)
        for prefix, stack in _as_heads(head).items():
            _head_apply_int8(stack, feats, observed=observed, captured=captured,
                             site_prefix=prefix)
    amax = {k: np.maximum(v.cpu().numpy().astype(np.float64), 0.0)
            for k, v in observed.items()}
    return (amax, captured) if capture else amax


def _site_consumers(folded: Dict[str, Any], head, plan: Optional[Dict[str, Any]]):
    """Site -> the weights that read it, as ``(wkey, kernel, stride, bias)``.
    A block's input feeds conv1 and the downsample, which then share one
    equalization vector; an SMM block contributes its matrices (2-D) and
    position-tiled biases."""
    sites: Dict[str, List[Tuple[str, torch.Tensor, int, torch.Tensor]]] = {}
    for gi, gname in enumerate(_GROUPS, start=1):
        for bi in range(2):
            n = f"{gname}_{bi}"
            blk = folded[n]
            stride = 2 if (gi > 1 and bi == 0) else 1
            if plan is not None and plan["blocks"][n]["form"] == "smm":
                w, b = plan["smm_w"], plan["smm_b"]
                cons = [(f"{n}.conv1", w[f"{n}.conv1"], 1, b[f"{n}.conv1"])]
                if blk["downsample"] is not None:
                    cons.append((f"{n}.ds", w[f"{n}.ds"], 1, b[f"{n}.ds"]))
                sites[f"{n}.in"] = cons
                sites[f"{n}.mid"] = [(f"{n}.conv2", w[f"{n}.conv2"], 1, b[f"{n}.conv2"])]
                continue
            cons = [(f"{n}.conv1", blk["conv1"]["kernel"], stride, blk["conv1"]["bias"])]
            if blk["downsample"] is not None:
                cons.append((f"{n}.ds", blk["downsample"]["kernel"], stride,
                             blk["downsample"]["bias"]))
            sites[f"{n}.in"] = cons
            sites[f"{n}.mid"] = [(f"{n}.conv2", blk["conv2"]["kernel"], 1,
                                  blk["conv2"]["bias"])]
    for prefix, stack in _as_heads(head).items():
        for i, layer in enumerate(stack):
            sites[f"{prefix}.{i}"] = [(f"{prefix}.{i}", layer["kernel"], 1, layer["bias"])]
    return sites


def _quantize_sites(folded, heads, calib_x, equalize: bool, bias_correct: bool,
                    plan: Optional[Dict[str, Any]]):
    """The fold-calibrate-quantize core: ``(scales, qw, qbias, amax)`` for a
    folded backbone and named dense stacks. Equalization folds
    ``e_c = sqrt(a_c / w_c)`` (activation over weight absmax, per input
    channel) into the weights and the quantizer; bias correction adds the
    calibration batch's mean error ``E[conv_f(x) - conv_q(x)]`` per output
    channel to each bias. ``amax`` is the raw per-site absmax, the drift
    checker's reference."""
    amax, captured = calibrate(folded, heads, calib_x, capture=True, plan=plan)
    sites = _site_consumers(folded, heads, plan)
    scales: Dict[str, Tuple[torch.Tensor, float]] = {}
    qw: Dict[str, Tuple[torch.Tensor, torch.Tensor]] = {}
    for site, consumers in sites.items():
        a = amax[site]
        e = np.ones_like(a)
        if equalize:  # per-input-channel weight absmax across all consumers
            w = np.zeros_like(a)
            for _, kernel, _, _ in consumers:
                k = kernel.abs()
                k = k.reshape(-1, k.shape[-2], k.shape[-1]) if k.ndim == 4 else k[None]
                w = np.maximum(w, k.amax(dim=(0, 2)).cpu().numpy().astype(np.float64))
            ok = (a > 0) & (w > 0)
            e[ok] = np.sqrt(a[ok] / w[ok])
        s_x = max(float((a / e).max()), 1e-6) / 127.0
        e32 = torch.from_numpy(e.astype(np.float32)).to(calib_x.device)
        scales[site] = (torch.from_numpy((1.0 / (e * s_x)).astype(np.float32))
                        .to(calib_x.device), s_x)
        for wkey, kernel, _, _ in consumers:
            shape = [1] * kernel.ndim
            shape[kernel.ndim - 2] = -1  # input channels: axis 2 of HWIO, 0 of (in, out)
            qw[wkey] = _quant_weight(kernel * e32.reshape(shape))

    qbias: Optional[Dict[str, torch.Tensor]] = None
    if bias_correct:
        qbias = {}
        with exact_fp32(), torch.no_grad():
            for site, consumers in sites.items():
                x = captured[site].float()
                act = scales[site]
                for wkey, kernel, stride, base in consumers:
                    q_int, q_scale = qw[wkey]
                    if kernel.ndim == 2:  # dense head layer or SMM matrix
                        y_f = x @ kernel
                        y_q = (_int_dot(_quant_act(x, act), q_int).float()
                               * (q_scale * _f32(act[1])))
                    elif kernel.shape[0] == 1:  # 1x1 downsample
                        y_f = _conv1x1_f(x, kernel, stride)
                        y_q = _qconv1x1(x, act, q_int, q_scale, stride, torch.float32)
                    else:
                        y_f = _conv_f_nhwc(x, kernel, stride)
                        y_q = _qconv3x3(x, act, q_int, q_scale, stride, torch.float32)
                    d = y_f - y_q
                    qbias[wkey] = base.float() + d.reshape(-1, d.shape[-1]).mean(dim=0)
    return scales, qw, qbias, amax


def _plan_for(lowering: str, folded: Dict[str, Any], hw: int) -> Optional[Dict[str, Any]]:
    """The hybrid lowering's plan at ``hw`` px; None for im2col."""
    if lowering not in ("hybrid", "im2col"):
        raise ValueError(f"unknown lowering {lowering!r}")
    return _plan_backbone(folded, hw) if lowering == "hybrid" else None


def quantize_stage(model: nn.Module, calib_x: torch.Tensor, float_dtype=torch.float32,
                   equalize: bool = True, bias_correct: bool = True,
                   lowering: str = "hybrid") -> QuantStageModel:
    """Fold, calibrate and quantize one v6 stage model (an ``nn.Module`` with
    ``backbone`` and ``head``) on ``calib_x``, normalized NHWC images on the
    device the model is to live on. ``equalize`` and ``bias_correct`` as in
    the JAX package. ``lowering``: ``"hybrid"`` (int8 convs in layer group 1,
    SMM products after it; the model serves the calibration extent only) or
    ``"im2col"`` (every site an int8 conv; any extent)."""
    device = calib_x.device
    folded = cast_tree(jax_layout_backbone(fold_backbone(model.backbone)), device,
                       torch.float32)
    head = cast_tree(jax_layout_head(fold_head(model.head)), device, torch.float32)
    plan = _plan_for(lowering, folded, int(calib_x.shape[1]))
    scales, qw, qbias, amax = _quantize_sites(folded, {"head": head}, calib_x, equalize,
                                              bias_correct, plan)
    return QuantStageModel(folded, head, scales, qw, float_dtype=float_dtype, qbias=qbias,
                           plan=plan, calib_amax=amax)


def quantize_unified(model: nn.Module, calib_x: torch.Tensor, float_dtype=torch.float32,
                     equalize: bool = True, bias_correct: bool = True,
                     lowering: str = "hybrid") -> QuantUnifiedModel:
    """Fold, calibrate and quantize a ``UnifiedV6Model``: its four heads share
    one set of backbone scales and get their own dense-stack scales.
    ``lowering`` as in :func:`quantize_stage`."""
    device = calib_x.device
    folded = cast_tree(jax_layout_backbone(fold_backbone(model.backbone)), device,
                       torch.float32)
    heads = {name: cast_tree(jax_layout_head(fold_head(getattr(model, name))), device,
                             torch.float32)
             for name in _UNIFIED_HEADS}
    plan = _plan_for(lowering, folded, int(calib_x.shape[1]))
    scales, qw, qbias, amax = _quantize_sites(folded, heads, calib_x, equalize,
                                              bias_correct, plan)
    return QuantUnifiedModel(folded, heads, scales, qw, float_dtype=float_dtype,
                             qbias=qbias, plan=plan, calib_amax=amax)


# ---------------------------------------------------------------------------
# int8: calibration drift
# ---------------------------------------------------------------------------


def make_drift_checker(q: _QuantModel) -> Callable:
    """A running activation-range check for an int8 model: ``check(x)`` runs
    one fp32 observe-mode forward over ``x`` (normalized NHWC images on the
    model's device; ~64 blocks suffice) and returns ``{"max_ratio",
    "worst_site"}``, the largest ratio of a site's observed absmax to its
    calibration absmax, per tensor. ``max_ratio <= 1``: inside the calibrated
    range; sustained ratios above ~1.5 call for recalibration."""
    if q.calib_amax is None:
        raise ValueError("model carries no calibration amax")
    base = {site: max(float(np.max(np.asarray(v, np.float64))), 1e-12)
            for site, v in q.calib_amax.items()}

    def check(x) -> Dict[str, Any]:
        amax = calibrate(q.folded, q.heads, x, plan=q.plan)
        worst, worst_site = 0.0, None
        for site, b in base.items():
            if site not in amax:
                continue
            r = float(np.max(amax[site] / b))
            if r > worst:
                worst, worst_site = r, site
        return {"max_ratio": worst, "worst_site": worst_site}

    return check


# ---------------------------------------------------------------------------
# int8: pipelines
# ---------------------------------------------------------------------------


def attach_fused_front(q: _QuantModel, hw: int, float_dtype=None) -> bool:
    """Swap an int8 model's stem + maxpool for kernel K1
    (``kernels.fused_front.make_fused_front``) at ``hw`` px, in
    ``float_dtype`` (default: the model's own, so that a bf16 stem never
    enters an fp32-calibrated graph). False, and nothing attached, at an
    extent K1 does not support (32 and 64 px)."""
    if not supports_extent(hw):
        return False
    if float_dtype is None:
        float_dtype = q.float_dtype
    stem = q.folded["stem"]
    q.front_fn = make_fused_front(_oihw(stem["kernel"]), stem["bias"], hw, float_dtype)
    q._front = (hw, float_dtype)
    return True


def _calib_input(calib_images, norm_scale: float, device) -> torch.Tensor:
    images = torch.as_tensor(calib_images).to(device)
    return images.to(torch.float32) / norm_scale


def _check_int8_options(use_fused_front) -> None:
    if use_fused_front not in (False, True):
        raise ValueError("use_fused_front must be False or True: the int8 graph has "
                         f"no group-1 hook (got {use_fused_front!r})")


def make_v6_pipeline_int8(
    models,
    calib_images,
    stage1_threshold: float = 0.45,
    norm_scale: float = NORM_10BIT,
    float_dtype=torch.float32,
    mesh=None,
    use_fused_front: bool = False,
    quant_out: Optional[list] = None,
    device="cuda",
) -> Callable:
    """int8 twin of ``eval.make_v6_pipeline_folded`` on ``device``.

    ``models``: a ``PipelineModels``; ``calib_images``: uint16 calibration
    blocks ``(N, H, W, 1)`` (a few hundred representative blocks), numpy or
    a tensor. Each plain stage quantizes on them; an FGVC AB model stays
    float (its own forward in ``float_dtype``) inside the same predict.
    ``use_fused_front`` runs each int8 stage's stem + maxpool as kernel K1 at
    8 and 16 px (other extents keep the plain stem). ``quant_out``, a list,
    receives the int8 stage models (for the drift checker). Returns
    ``predict(images_u16) -> dict``, the ``make_v6_pipeline`` contract. With
    ``mesh`` every rank quantizes on the same calibration blocks and serves
    its rows of each batch on its own ``device`` (the JAX package's
    ``_shard_map_predict`` has no counterpart: ``run_pipeline_batched(mesh=...)``
    slices and gathers)."""
    from av1tpu_torch.eval.hierarchy import assemble_v6_predict, on_device

    _check_int8_options(use_fused_front)
    device = torch.device(device)
    calib_x = _calib_input(calib_images, norm_scale, device)
    fns = [quantize_stage(m, calib_x, float_dtype)
           for m in (models.stage1, models.stage2, models.stage3_rect)]
    if is_plain_stage(models.stage3_ab):
        fns.append(quantize_stage(models.stage3_ab, calib_x, float_dtype))
    else:
        fns.append(on_device(models.stage3_ab, device, float_dtype))
    quantized = [f for f in fns if isinstance(f, QuantStageModel)]
    if quant_out is not None:
        quant_out.extend(quantized)
    if use_fused_front:
        for q in quantized:
            attach_fused_front(q, int(calib_x.shape[1]), float_dtype)
    return assemble_v6_predict(*fns, stage1_threshold, norm_scale, float_dtype=float_dtype)


def make_unified_pipeline_int8(
    model: nn.Module,
    calib_images,
    stage1_threshold: float = 0.45,
    norm_scale: float = NORM_10BIT,
    float_dtype=torch.float32,
    mesh=None,
    use_fused_front: bool = False,
    quant_out: Optional[list] = None,
    device="cuda",
) -> Callable:
    """int8 twin of ``eval.make_unified_pipeline_folded``: one int8 trunk
    forward and four int8 head stacks serve all four stage decisions,
    routed by ``eval.unified._route_from_unified``. Arguments as in
    :func:`make_v6_pipeline_int8`; ``model`` is a ``UnifiedV6Model``."""
    from av1tpu_torch.eval.unified import _unified_predict

    _check_int8_options(use_fused_front)
    device = torch.device(device)
    calib_x = _calib_input(calib_images, norm_scale, device)
    q = quantize_unified(model, calib_x, float_dtype)
    if quant_out is not None:
        quant_out.append(q)
    if use_fused_front:
        attach_fused_front(q, int(calib_x.shape[1]), float_dtype)
    return _unified_predict(q, stage1_threshold, norm_scale, float_dtype)


__all__ = [
    "QuantStageModel",
    "QuantUnifiedModel",
    "attach_fused_front",
    "build_smm_matrix",
    "build_smm_matrix_1x1",
    "calibrate",
    "cast_tree",
    "exact_fp32",
    "fold_backbone",
    "fold_head",
    "is_plain_stage",
    "jax_layout_backbone",
    "jax_layout_head",
    "make_drift_checker",
    "make_unified_pipeline_int8",
    "make_v6_pipeline_int8",
    "quantize_stage",
    "quantize_unified",
]
