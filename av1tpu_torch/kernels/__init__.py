"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch twin
(``fused_front``: K1 and K2).

Kernels build with nvcc at first launch (``_build``); importing this
package touches neither nvcc nor the card.
"""
