"""K2, the port's fused stem + max-pool + layer group 1 + SE1
(``kernels/fused_front.py`` ``fused_front_g1``): ``(B, hw, hw, 1)`` to
``(B, hw/4, hw/4, 64)``.

Operations: the stem's, layer 1's and SE1's valid taps. Bytes: each input
and output element once (bf16), and once a call the stem ``(49, 64)`` and
layer 1's four ``(9, 64, 64)`` kernels in bf16, their fp32 biases and SE1's
two fp32 matrices.
"""
import re

from portbench.counts import v6

KERNEL = re.compile(r"fused_front_g1_(?:wgmma_)?kernel<(\d+)")
ELEMENT = 2  # bf16


def block_px(match: re.Match) -> int:
    return int(match.group(1))


def ops(config: dict, px: int) -> int:
    parts = v6.backbone(config["arch"], px)
    return parts["stem"] + parts["layer1"] + parts["se1"]


def io_bytes(config: dict, px: int) -> int:
    c = config["arch"]["stem"]["channels"]
    return ELEMENT * (px * px + (px // 4) ** 2 * c)


def weight_bytes(config: dict, px: int) -> int:
    arch = config["arch"]
    c, k = arch["stem"]["channels"], arch["stem"]["kernel"]
    hidden = c // arch["se_reduction"]
    convs = 2 * arch["blocks_per_group"]
    return (ELEMENT * (k * k * c + convs * 9 * c * c)
            + 4 * (c + convs * c + 2 * hidden * c))
