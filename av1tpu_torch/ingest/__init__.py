"""Frame ingestion of the port: raw yuv420p10le reading and superblock tiling
(numpy only). The dump parsers, the ETL and the C++ IO are not ported yet."""
from av1tpu_torch.ingest.tiler import (  # noqa: F401
    TileGrid,
    extract_labeled_blocks,
    join_blocks_with_labels,
    label_cols_from_units,
    tile_frame,
    tile_frames,
)
from av1tpu_torch.ingest.yuv import (  # noqa: F401
    Yuv420p10Geometry,
    infer_resolution,
    iter_y_frames,
    read_y_frame,
    read_y_frames_batch,
)
