"""Layer groups 1 and 2 with both SE gates in one kernel: K5
(``csrc/resnet_group.cu``).

Counterpart of ``av1tpu.kernels.resnet_group``. ``fused_group12`` runs
layer1_0, layer1_1, SE1, layer2_0 (3x3/2 conv with XLA-SAME padding (0, 1)
and a 1x1/2 downsample), layer2_1 and SE2 on BN-folded weights: NHWC
``(B, E, E, 64)`` -> ``(B, E/2, E/2, 128)`` for E in {2, 4, 8, 16}, the
extents after the stem of 8 to 64 px blocks. The input and the 22 packed
weights share the serving dtype (fp32 or bf16); inside, everything is
kept beyond that dtype and only the output is rounded, as the TPU kernel
does. In bf16 the CUDA kernel runs every conv on the tensor cores, with each
fp32 activation carried as a pair of bf16 values (16 bits); its conv weights
come as one stream in the order of use, :func:`group12_conv_stream`, which a
pipeline builds once and which the kernel reads by TMA through two tensor
maps, encoded once per stream (:func:`conv_stream_boxes` gives their
geometry). Which taps each 64-row tile of a block computes is the host's
table :func:`group12_tile_taps`; the block's rows are position-major
(:func:`group12_row_order`). In fp32 it runs on the CUDA cores.

The TPU kernel's ``tile`` (its VMEM batch tile) and ``interpret`` (Pallas
interpreter mode) have no counterpart here: the CUDA kernel picks its own
samples per block (:func:`samples_per_block`), and a CPU tensor runs the plain twin
``fused_group12_reference``. A CUDA tensor launches the kernel or raises; a
launch adds one to ``_build.launch_counts["fused_group12"]``.

Layouts of :func:`pack_group12_weights`, in ``PACK_ORDER``: 3x3 conv kernels
``(9, CI, CO)`` as [tap][ci][co], the downsample ``(64, 128)`` as [ci][co],
biases ``(CO,)``, SE ``d0`` ``(C/16, C)`` and ``d1`` ``(C, C/16)`` (Linear
layouts).
"""
from __future__ import annotations

import ctypes
import itertools
import math
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from av1tpu_torch.kernels import _build
from av1tpu_torch.models.layers import pad_same

C1, C2 = 64, 128
EXTENTS = (2, 4, 8, 16)
_DTYPES = (torch.float32, torch.bfloat16)

PACK_ORDER = (
    "layer1_0.conv1.k", "layer1_0.conv1.b", "layer1_0.conv2.k", "layer1_0.conv2.b",
    "layer1_1.conv1.k", "layer1_1.conv1.b", "layer1_1.conv2.k", "layer1_1.conv2.b",
    "se1.d0", "se1.d1",
    "layer2_0.conv1.k", "layer2_0.conv1.b", "layer2_0.conv2.k", "layer2_0.conv2.b",
    "layer2_0.ds.k", "layer2_0.ds.b",
    "layer2_1.conv1.k", "layer2_1.conv1.b", "layer2_1.conv2.k", "layer2_1.conv2.b",
    "se2.d0", "se2.d1",
)


def _packed_shapes() -> Dict[str, Tuple[int, ...]]:
    shapes = {}
    for name, ci, co in (("layer1_0", C1, C1), ("layer1_1", C1, C1),
                         ("layer2_0", C1, C2), ("layer2_1", C2, C2)):
        shapes[f"{name}.conv1.k"] = (9, ci, co)
        shapes[f"{name}.conv2.k"] = (9, co, co)
        shapes[f"{name}.conv1.b"] = shapes[f"{name}.conv2.b"] = (co,)
    shapes["layer2_0.ds.k"], shapes["layer2_0.ds.b"] = (C1, C2), (C2,)
    for se, c in (("se1", C1), ("se2", C2)):
        shapes[f"{se}.d0"], shapes[f"{se}.d1"] = (c // 16, c), (c, c // 16)
    return shapes


PACKED_SHAPES = _packed_shapes()


def pack_group12_weights(folded, float_dtype=torch.bfloat16) -> Tuple[torch.Tensor, ...]:
    """The layer-1/layer-2 part of a ``quant.ptq.fold_backbone`` tree as the
    kernel's 22 arrays in ``PACK_ORDER``, each cast to ``float_dtype`` on the
    tree's device (the JAX pipeline casts the packed fp32 arrays the same
    way)."""
    flat = {}
    for name in ("layer1_0", "layer1_1", "layer2_0", "layer2_1"):
        blk = folded[name]
        for conv in ("conv1", "conv2"):
            w = blk[conv]["weight"].detach().float()  # OIHW
            flat[f"{name}.{conv}.k"] = w.permute(2, 3, 1, 0).reshape(9, w.shape[1], w.shape[0])
            flat[f"{name}.{conv}.b"] = blk[conv]["bias"].detach().float()
        if blk["downsample"] is not None:
            flat[f"{name}.ds.k"] = blk["downsample"]["weight"].detach().float()[:, :, 0, 0].T
            flat[f"{name}.ds.b"] = blk["downsample"]["bias"].detach().float()
    for se in ("se1", "se2"):
        flat[f"{se}.d0"] = folded[se]["d0"].detach().float()
        flat[f"{se}.d1"] = folded[se]["d1"].detach().float()
    return tuple(flat[k].to(float_dtype).contiguous() for k in PACK_ORDER)


# The nine conv kernels in the order the bf16 kernel uses them. ``[tap][ci][co]``
# is k-major already, so the stream is each array flattened, end to end.
CONV_STREAM_ORDER = (
    "layer1_0.conv1.k", "layer1_0.conv2.k", "layer1_1.conv1.k", "layer1_1.conv2.k",
    "layer2_0.conv1.k", "layer2_0.conv2.k", "layer2_0.ds.k",
    "layer2_1.conv1.k", "layer2_1.conv2.k",
)
CONV_STREAM_SIZE = sum(math.prod(PACKED_SHAPES[name]) for name in CONV_STREAM_ORDER)


def group12_conv_stream(weights) -> torch.Tensor:
    """The conv kernels of ``weights`` (22 arrays in ``PACK_ORDER``) as one
    contiguous 1-D tensor in ``CONV_STREAM_ORDER``: a permutation of their
    values, which :func:`split_conv_stream` undoes."""
    by_name = dict(zip(PACK_ORDER, weights))
    return torch.cat([by_name[name].reshape(-1) for name in CONV_STREAM_ORDER])


def split_conv_stream(stream) -> Dict[str, torch.Tensor]:
    """The inverse of :func:`group12_conv_stream`: name -> packed array."""
    sizes = [math.prod(PACKED_SHAPES[name]) for name in CONV_STREAM_ORDER]
    return {name: part.reshape(PACKED_SHAPES[name])
            for name, part in zip(CONV_STREAM_ORDER, torch.split(stream, sizes))}


# ---------------------------------------------------------------------------
# The bf16 kernel's host tables (csrc/resnet_group.cu reads them as given)
# ---------------------------------------------------------------------------

KC = 64                    # k-rows of a weight chunk
CLUSTER = 2                # blocks of a cluster; each fetches 1/CLUSTER of a chunk
BOX = (KC // CLUSTER, 64)  # a TMA box: rows, columns (64 bf16: the 128-byte swizzle)
# The stream as the kernel's two TMA maps, (first element, rows, columns):
# layer 1's 36 chunks of 64 columns, then layer 2's 64 chunks of 128.
CHUNKS1, CHUNKS = 36, 100
STREAM_PARTS = ((0, CHUNKS1 * KC, C1), (CHUNKS1 * KC * C1, (CHUNKS - CHUNKS1) * KC, C2))


def samples_per_block(e: int) -> int:
    """Samples a bf16 block holds at extent ``e``: 256 layer-1 rows, 128 at
    extent 2 (4,096 samples make 128 blocks)."""
    return (128 if e == 2 else 256) // (e * e)


def group12_convs(e: int) -> Tuple[Tuple[str, int, int, int, int, int], ...]:
    """The nine convs in ``CONV_STREAM_ORDER`` at input extent ``e``: (name,
    input extent, output extent, stride, taps, input channels)."""
    e2 = e // 2
    geometry = ((e, e, 1, 9, C1),) * 4 + ((e, e2, 2, 9, C1), (e2, e2, 1, 9, C2),
                                           (e, e2, 2, 1, C1), (e2, e2, 1, 9, C2),
                                           (e2, e2, 1, 9, C2))
    return tuple((name,) + g for name, g in zip(CONV_STREAM_ORDER, geometry))


def _tap_shift(stride: int, taps: int, tap: int) -> Tuple[int, int]:
    """(dy, dx) of a tap from the window's start: SAME's (-1, 0, 1) at stride
    1, XLA's (0, 1, 2) at stride 2 (padding (0, 1)), (0, 0) for a 1x1."""
    if taps == 1:
        return 0, 0
    lead = 1 if stride == 1 else 0
    return tap // 3 - lead, tap % 3 - lead


def group12_row_order(e: int) -> Tuple[np.ndarray, np.ndarray]:
    """Layers 1 and 2 of a block: for each of its rows, the sample-major row
    (sample x positions + position) it holds. Rows are position-major (row
    p * SPB + s); layer 2 fills a 64-row tile, and at extent 2 its last 32
    rows are padding (-1). The output write maps sample s, position p back
    from row p * SPB + s."""
    spb = samples_per_block(e)
    orders = []
    for oe in (e, e // 2):
        positions = oe * oe
        rows = np.arange(max(spb * positions, 64))
        orders.append(np.where(rows < spb * positions,
                               (rows % spb) * positions + rows // spb, -1))
    return orders[0], orders[1]


def group12_tile_taps(e: int) -> np.ndarray:
    """(9, 4) uint16: bit ``tap`` of ``[j, tile]`` is set where a row of 64-row
    tile ``tile`` of conv j (``CONV_STREAM_ORDER``) reads inside the image at
    that tap. Layer 1 has 256 / 64 tiles (2 at extent 2), layer 2 one; the
    rest is 0. The kernel multiplies only the set taps of a tile and fetches
    only the taps set for some tile."""
    spb = samples_per_block(e)
    table = np.zeros((len(CONV_STREAM_ORDER), 4), np.uint16)
    for j, (_, ie, oe, stride, taps, _) in enumerate(group12_convs(e)):
        rows = spb * oe * oe
        for tile in range(1 if j >= 4 else rows // 64):
            positions = {r // spb for r in range(64 * tile, min(64 * tile + 64, rows))}
            for tap in range(taps):
                dy, dx = _tap_shift(stride, taps, tap)
                if any(0 <= (p // oe) * stride + dy < ie and 0 <= (p % oe) * stride + dx < ie
                       for p in positions):
                    table[j, tile] |= 1 << tap
    return table


def conv_stream_boxes(chunk: int) -> Tuple[Tuple[int, int, int], ...]:
    """The TMA boxes that bring chunk ``chunk`` of the stream: (part of
    ``STREAM_PARTS``, first row, first column) of each, for every block rank
    of a cluster and every 64-column box."""
    part = 0 if chunk < CHUNKS1 else 1
    local = chunk if part == 0 else chunk - CHUNKS1
    return tuple((part, local * KC + rank * BOX[0], bx * BOX[1])
                 for bx in range(STREAM_PARTS[part][2] // BOX[1]) for rank in range(CLUSTER))


_MAPS: Dict[Tuple[torch.device, int], ctypes.Array] = {}  # encoded maps by stream address
_TAPS: Dict[int, ctypes.Array] = {}                      # group12_tile_taps by extent


def _conv_stream_maps(conv_stream) -> ctypes.Array:
    """The two TMA maps of ``conv_stream``, encoded at its first use: a map
    holds the address and the geometry, never the values."""
    key = (conv_stream.device, conv_stream.data_ptr())
    maps = _MAPS.get(key)
    if maps is None:
        maps = ctypes.create_string_buffer(256)
        parts = (ctypes.c_longlong * 6)(*itertools.chain(*STREAM_PARTS))
        _build.check_launch("group12_encode_maps", _build.load_kernels().av1_group12_encode_maps(
            conv_stream.data_ptr(), parts, BOX[0], BOX[1], maps))
        _MAPS[key] = maps
    return maps


def _tile_taps(e: int) -> ctypes.Array:
    if e not in _TAPS:
        _TAPS[e] = (ctypes.c_uint16 * 36)(*group12_tile_taps(e).reshape(-1).tolist())
    return _TAPS[e]


# ---------------------------------------------------------------------------
# Plain PyTorch version (fp32 inside, output rounded to x's dtype)
# ---------------------------------------------------------------------------


def fused_group12_reference(x, weights):
    """Plain K5: ``(B, E, E, 64)`` -> ``(B, E/2, E/2, 128)`` in x's dtype.
    The input and weights are widened to fp32 and every step runs in fp32."""
    w = dict(zip(PACK_ORDER, (t.float() for t in weights)))

    def conv(a, name, stride=1):
        k = w[f"{name}.k"]
        k = k.reshape(3, 3, k.shape[1], k.shape[2]).permute(3, 2, 0, 1)
        y = F.conv2d(pad_same(a, 3, stride), k, stride=stride)
        return y + w[f"{name}.b"][None, :, None, None]

    def block(a, name, stride=1):
        y = conv(torch.relu(conv(a, f"{name}.conv1", stride)), f"{name}.conv2")
        if stride == 2:
            res = torch.einsum("bchw,co->bohw", a[:, :, ::2, ::2], w[f"{name}.ds.k"])
            a = res + w[f"{name}.ds.b"][None, :, None, None]
        return torch.relu(y + a)

    def se(a, name):
        g = torch.relu(a.mean(dim=(2, 3)) @ w[f"{name}.d0"].T)
        return a * torch.sigmoid(g @ w[f"{name}.d1"].T)[:, :, None, None]

    z = x.float().permute(0, 3, 1, 2)
    z = se(block(block(z, "layer1_0"), "layer1_1"), "se1")
    z = se(block(block(z, "layer2_0", 2), "layer2_1"), "se2")
    return z.permute(0, 2, 3, 1).to(x.dtype).contiguous()


# ---------------------------------------------------------------------------
# Wrapper
# ---------------------------------------------------------------------------


def _check(x, weights):
    if x.dim() != 4 or x.shape[3] != C1 or x.shape[1] != x.shape[2]:
        raise ValueError(f"x: expected (B, E, E, {C1}), got {tuple(x.shape)}")
    if int(x.shape[1]) not in EXTENTS:
        raise ValueError(f"x: extent {x.shape[1]} not in {EXTENTS}")
    if x.dtype not in _DTYPES:
        raise ValueError(f"x: dtype {x.dtype} not in {_DTYPES}")
    if x.shape[0] == 0:
        raise ValueError("x: empty batch")
    if not x.is_contiguous():
        raise ValueError("x: must be contiguous")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"x: unsupported device {x.device}")
    if len(weights) != len(PACK_ORDER):
        raise ValueError(f"weights: {len(weights)} arrays, expected {len(PACK_ORDER)}")
    for name, t in zip(PACK_ORDER, weights):
        if tuple(t.shape) != PACKED_SHAPES[name]:
            raise ValueError(f"{name}: shape {tuple(t.shape)}, "
                             f"expected {PACKED_SHAPES[name]}")
        if t.dtype != x.dtype:
            raise ValueError(f"{name}: dtype {t.dtype}, expected {x.dtype}")
        if t.device != x.device:
            raise ValueError(f"{name}: on {t.device}, expected {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: must be contiguous")


def _conv_stream_pointer(x, conv_stream):
    """The bf16 kernel's third operand; the fp32 kernel takes none."""
    if x.dtype != torch.bfloat16:
        return None
    if conv_stream is None:
        raise ValueError("conv_stream: the bf16 kernel needs group12_conv_stream(weights), "
                         "built once by the caller")
    if (conv_stream.shape != (CONV_STREAM_SIZE,) or conv_stream.dtype != x.dtype
            or conv_stream.device != x.device or not conv_stream.is_contiguous()):
        raise ValueError(f"conv_stream: expected a contiguous ({CONV_STREAM_SIZE},) "
                         f"{x.dtype} tensor on {x.device}")
    return conv_stream.data_ptr()


def fused_group12(x, weights, conv_stream=None):
    """K5 on ``x`` ``(B, E, E, 64)`` with ``weights`` from
    :func:`pack_group12_weights` in x's dtype; returns ``(B, E/2, E/2, 128)``.
    A bf16 tensor on the card also needs ``conv_stream``,
    :func:`group12_conv_stream` of the same weights, which the caller builds
    once (``eval/folded.py`` does, per stage); without it the call raises.
    The fp32 kernel and the plain version on the CPU do not read it."""
    weights = tuple(weights)
    _check(x, weights)
    if x.device.type == "cpu":
        return fused_group12_reference(x, weights)
    e = int(x.shape[1])
    maps = taps = None
    if _conv_stream_pointer(x, conv_stream) is not None:
        maps, taps = _conv_stream_maps(conv_stream), _tile_taps(e)
    out = torch.empty((x.shape[0], e // 2, e // 2, C2), dtype=x.dtype, device=x.device)
    ptrs = (ctypes.c_void_p * len(weights))(*(t.data_ptr() for t in weights))
    _build.launch("fused_group12", x.data_ptr(), ptrs, maps, taps, out.data_ptr(),
                  int(x.shape[0]), e, int(x.dtype == torch.bfloat16), _build.stream_of(x))
    return out


__all__ = [
    "BOX",
    "CLUSTER",
    "CONV_STREAM_ORDER",
    "CONV_STREAM_SIZE",
    "EXTENTS",
    "PACK_ORDER",
    "STREAM_PARTS",
    "conv_stream_boxes",
    "fused_group12",
    "fused_group12_reference",
    "group12_conv_stream",
    "group12_convs",
    "group12_row_order",
    "group12_tile_taps",
    "pack_group12_weights",
    "samples_per_block",
    "split_conv_stream",
]
