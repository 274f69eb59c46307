"""Folded float serving of the port (int8 waits for ROADMAP M9)."""
from av1tpu_torch.quant.ptq import (  # noqa: F401
    cast_tree,
    fold_backbone,
    fold_head,
    is_plain_stage,
)
