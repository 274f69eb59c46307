"""K1, the port's fused stem + max-pool (``kernels/fused_front.py``
``fused_front``): one ``(B, hw, hw, 1)`` input to ``(B, hw/4, hw/4, 64)``.

Its operations are the stem's valid taps; its bytes each input and output
element once, in the serving dtype (bf16), and its weights once a call: the
stem ``(49, 64)`` in bf16 and its fp32 bias.
"""
import re

from portbench.counts import v6

KERNEL = re.compile(r"fused_front_(?:wgmma_)?kernel<(\d+)")
ELEMENT = 2  # bf16


def block_px(match: re.Match) -> int:
    return int(match.group(1))


def ops(config: dict, px: int) -> int:
    return v6.backbone(config["arch"], px)["stem"]


def io_bytes(config: dict, px: int) -> int:
    c = config["arch"]["stem"]["channels"]
    return ELEMENT * (px * px + (px // 4) ** 2 * c)


def weight_bytes(config: dict, px: int) -> int:
    stem = config["arch"]["stem"]
    return ELEMENT * stem["kernel"] ** 2 * stem["channels"] + 4 * stem["channels"]
