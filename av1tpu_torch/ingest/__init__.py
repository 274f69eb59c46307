"""Frame ingestion of the port, numpy only: raw yuv420p10le reading,
superblock tiling, the encoder-dump and Excel-archive parsers, the one-pass
ETL and the native (C++) reader's bindings."""
from av1tpu_torch.ingest.etl import (  # noqa: F401
    EtlReport,
    SequenceExtract,
    extract_sequence,
    write_npz,
    write_reference_layout,
)
from av1tpu_torch.ingest.partition_dump import (  # noqa: F401
    DumpParseResult,
    FrameBlocks,
    discover_dump_files,
    parse_dump_directory,
    parse_dump_file,
)
from av1tpu_torch.ingest.tiler import (  # noqa: F401
    TileGrid,
    extract_labeled_blocks,
    join_blocks_with_labels,
    label_cols_from_units,
    tile_frame,
    tile_frames,
)
from av1tpu_torch.ingest.xlsx import (  # noqa: F401
    export_dump_dir_to_xlsx,
    parse_xlsx_directory,
    parse_xlsx_file,
    read_frame_xlsx,
    write_frame_xlsx,
)
from av1tpu_torch.ingest.yuv import (  # noqa: F401
    Yuv420p10Geometry,
    infer_resolution,
    iter_y_frames,
    read_y_frame,
    read_y_frames_batch,
)
