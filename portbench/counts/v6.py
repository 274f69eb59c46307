"""Operations of the v6 models' parts on one block, from the configuration's
sizes; each model family's ``per_block`` sums them for its models.

Every convolution counts only the taps that fall inside its input (the
padding's taps are not work): at the 1x1 and 2x2 extents of layers 3 and 4
eight of a 3x3 window's nine taps are padding. The SE and spatial-attention
products and the MLP heads count too, each multiply-add as two; the
elementwise work (biases, ReLUs, sigmoids, pooling, converts) does not. This
is the count of the port's ``examples/_bench.py`` (``backbone_flops``; with
the per-stage family's ``per_block``, ``flops_per_block``), worked out here
from the configuration.
"""
from __future__ import annotations

from typing import Dict, Tuple


def same_padding(size: int, kernel: int, stride: int) -> Tuple[int, int]:
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def valid_taps(extent: int, kernel: int, stride: int, pad: Tuple[int, int]) -> Tuple[int, int]:
    """``(output extent, taps summed over the outputs that fall inside the
    input)`` along one axis."""
    lo, hi = pad
    out = (extent + lo + hi - kernel) // stride + 1
    taps = sum(1 for o in range(out) for t in range(kernel) if 0 <= o * stride - lo + t < extent)
    return out, taps


def conv(extent: int, cin: int, cout: int, kernel: int, stride: int, pad) -> Tuple[int, int]:
    """``(operations, output extent)`` of a square convolution."""
    out, taps = valid_taps(extent, kernel, stride, pad)
    return 2 * cin * cout * taps * taps, out


def backbone(arch: dict, px: int) -> Dict[str, int]:
    """Operations of one ``px`` block in each part of the trunk: ``stem``,
    ``layer1``-``layer4`` (downsample included), ``se1``-``se4``, ``attn``."""
    stem, pool = arch["stem"], arch["pool"]
    parts = {}
    parts["stem"], e = conv(px, 1, stem["channels"], stem["kernel"], stem["stride"],
                            (stem["padding"], stem["padding"]))
    e = (e + 2 * pool["padding"] - pool["kernel"]) // pool["stride"] + 1
    cin = stem["channels"]
    for g, width in enumerate(arch["widths"], start=1):
        total = 0
        for b in range(arch["blocks_per_group"]):
            stride = 2 if (g > 1 and b == 0) else 1
            c1, e_out = conv(e, cin, width, 3, stride, same_padding(e, 3, stride))
            c2, _ = conv(e_out, width, width, 3, 1, same_padding(e_out, 3, 1))
            total += c1 + c2
            if cin != width or stride != 1:
                total += conv(e, cin, width, 1, stride, (0, 0))[0]
            cin, e = width, e_out
        parts[f"layer{g}"] = total
        parts[f"se{g}"] = 2 * 2 * width * (width // arch["se_reduction"])
    k = arch["attention_kernel"]
    parts["attn"] = conv(e, 2, 1, k, 1, same_padding(e, k, 1))[0]
    return parts


def head(widths, in_dim: int) -> int:
    total = 0
    for width in widths:
        total += 2 * in_dim * width
        in_dim = width
    return total
