"""K5, the port's fused layer groups 1 and 2 with SE1 and SE2
(``kernels/resnet_group.py`` ``fused_group12``): ``(B, E, E, 64)`` to
``(B, E/2, E/2, 128)`` for blocks of ``4 E`` px. The kernel's template
argument is ``E``.

Operations: layer 1's, SE1's, layer 2's and SE2's valid taps. Bytes: each
input and output element once (bf16), and once a call the 22 packed arrays
(``PACK_ORDER``), all in bf16: nine 3x3 kernels, the downsample, the biases
and the SE matrices.
"""
import re

from portbench.counts import v6

KERNEL = re.compile(r"fused_group12_(?:wgmma_)?kernel<(\d+)")
ELEMENT = 2  # bf16


def block_px(match: re.Match) -> int:
    return 4 * int(match.group(1))


def ops(config: dict, px: int) -> int:
    parts = v6.backbone(config["arch"], px)
    return sum(parts[k] for k in ("layer1", "se1", "layer2", "se2"))


def io_bytes(config: dict, px: int) -> int:
    c1, c2 = config["arch"]["widths"][:2]
    e = px // 4
    return ELEMENT * (e * e * c1 + (e // 2) ** 2 * c2)


def weight_bytes(config: dict, px: int) -> int:
    arch = config["arch"]
    c1, c2 = arch["widths"][:2]
    r = arch["se_reduction"]
    convs = 4 * 9 * c1 * c1 + 9 * c1 * c2 + 3 * 9 * c2 * c2 + c1 * c2
    biases = 4 * c1 + 5 * c2
    se = 2 * c1 * (c1 // r) + 2 * c2 * (c2 // r)
    return ELEMENT * (convs + biases + se)
