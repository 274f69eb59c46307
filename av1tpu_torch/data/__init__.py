"""Dataset containers of the port: split bundles and the sample norm."""
from av1tpu_torch.data.bundles import Bundle, bundle_metadata, save_split
from av1tpu_torch.data.records import NORM_10BIT

__all__ = ["Bundle", "NORM_10BIT", "bundle_metadata", "save_split"]
