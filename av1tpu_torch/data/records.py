"""The normalization policy of block samples.

The port's own copy of what it uses of ``av1tpu.data.records``: samples are
stored as uint16 NHWC end to end and normalized exactly once, on the device,
at the model's input (``av1tpu_torch.kernels.preprocess``), by
``NORM_10BIT``. The block records and the text-layout and ``.pt`` loaders of
the JAX package are not ported yet (ROADMAP M13).
"""
NORM_10BIT = 1023.0

__all__ = ["NORM_10BIT"]
