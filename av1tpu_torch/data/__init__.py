"""Dataset layer of the port: block records, split bundles and their label
views, epoch sampling, the sample norm, the stage-3 noise injection and the
reference-shaped synthetic corpus."""
from av1tpu_torch.data.bundles import (
    Bundle,
    build_flatten_bundle,
    build_v5_bundle,
    build_v6_bundle,
    bundle_metadata,
    class_counts,
    ensemble_shuffles,
    filter_partitioned_only,
    filter_stage2_v6,
    filter_stage3,
    oversample_ab,
    save_split,
)
from av1tpu_torch.data.noise import build_noisy_bundle
from av1tpu_torch.data.records import (
    NORM_10BIT,
    NORM_10BIT_DOUBLE,
    BlockSet,
    normalize_images,
    train_test_split,
)
from av1tpu_torch.data.sampling import (
    balanced_epoch_indices,
    effective_number_weights,
    host_shard,
    inverse_frequency_weights,
    oversample_indices,
    sample_weights_from_labels,
    shuffled_epoch_indices,
)

__all__ = [
    "BlockSet", "Bundle", "NORM_10BIT", "NORM_10BIT_DOUBLE", "balanced_epoch_indices",
    "build_flatten_bundle", "build_noisy_bundle", "build_v5_bundle", "build_v6_bundle", "bundle_metadata",
    "class_counts", "effective_number_weights", "ensemble_shuffles",
    "filter_partitioned_only", "filter_stage2_v6", "filter_stage3", "host_shard",
    "inverse_frequency_weights", "normalize_images", "oversample_ab",
    "oversample_indices", "sample_weights_from_labels", "save_split",
    "shuffled_epoch_indices", "train_test_split",
]
