"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch twin:
``fused_front`` (K1, K2), ``preprocess`` (K3a, K3b), ``fused_dense`` (K4)
and ``resnet_group`` (K5). The package exports what ``av1tpu.kernels``
exports.

Kernels build with nvcc at first launch (``_build``); importing this
package touches neither nvcc nor the card.
"""
from av1tpu_torch.kernels.fused_dense import fused_dense  # noqa: F401
from av1tpu_torch.kernels.preprocess import (  # noqa: F401
    normalize_blocks,
    pad_frames,
    tile_normalize_frames,
    tile_normalize_reference,
)
from av1tpu_torch.kernels.resnet_group import (  # noqa: F401
    fused_group12,
    pack_group12_weights,
)
