"""The benchmark's operation counts against the port's own copy of them
(``av1tpu_torch/examples/_bench.py``) and PERF.md's figures."""
import pytest

from av1tpu_torch.examples import _bench
from portbench import spec
from portbench.counts import v6

STAGES = spec.load_config("v6_stages")
UNIFIED = spec.load_config("v6_unified")
PER_BLOCK = {name: spec.load_family(name).reference.per_block for name in ("stages", "unified")}
MFLOP = {8: 14.97, 16: 35.27, 32: 163.2, 64: 856.5}  # PERF.md, four stages dense


@pytest.mark.parametrize("px", [8, 16, 32, 64])
def test_per_block_matches_the_port_and_perf_md(px):
    assert PER_BLOCK["stages"](STAGES, px) == _bench.flops_per_block(px)
    assert round(PER_BLOCK["stages"](STAGES, px) / 1e6, 2 if px < 32 else 1) == MFLOP[px]


@pytest.mark.parametrize("px", [8, 16, 32, 64])
def test_backbone_parts_match_the_port(px):
    assert v6.backbone(STAGES["arch"], px) == _bench.backbone_flops(px)


def test_unified_is_one_trunk_and_four_heads():
    trunk = sum(v6.backbone(UNIFIED["arch"], 16).values())
    heads = (PER_BLOCK["stages"](STAGES, 16) - 4 * trunk)
    assert PER_BLOCK["unified"](UNIFIED, 16) == trunk + heads


def test_kernel_counts():
    k1, k2, k5 = (spec.load_count(k) for k in ("K1", "K2", "K5"))
    parts = _bench.backbone_flops(16)
    assert k1.ops(STAGES, 16) == parts["stem"]
    assert k2.ops(STAGES, 16) == parts["stem"] + parts["layer1"] + parts["se1"]
    assert k5.ops(STAGES, 16) == sum(parts[k] for k in ("layer1", "se1", "layer2", "se2"))
    # 4096 blocks of 16 px: K1 moves 10.5 MB, K2 14.7 GFLOP (PERF.md's bounds)
    assert round(4096 * k1.io_bytes(STAGES, 16) / 1e6, 1) == 10.5
    assert round(4096 * k2.ops(STAGES, 16) / 1e9, 1) == 14.7
    assert round(4096 * k5.ops(STAGES, 16) / 1e9, 1) == 21.8
    assert k1.block_px(k1.KERNEL.search("void fused_front_wgmma_kernel<16>(x)")) == 16
    assert k5.block_px(k5.KERNEL.search("fused_group12_wgmma_kernel<2>(x)")) == 8
    assert k2.KERNEL.search("fused_front_wgmma_kernel<8>") is None
    assert k1.KERNEL.search("fused_front_g1_wgmma_kernel<8>") is None
