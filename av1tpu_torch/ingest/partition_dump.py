"""libaom encoder partition-dump parsing.

The port's own copy of ``av1tpu.ingest.partition_dump`` (numpy only): the
same records and the same warnings for the same files.

Parses ``partition_frame_<N>.txt`` files (7 whitespace-separated integer
fields per line: ``order_hint frame_type block_size row col partition_mode
qp``) into columnar numpy arrays.

Design departure from the reference: scripts 004-007
(``pesquisa_v5/004_prepare_partition_data_v2.py`` etc.) round-trip the dump
through per-frame Excel workbooks and three intermediate text formats. Here
the dump parses directly into arrays consumed by the tiler/label-join in one
pass — the Excel hop disappears — while the compat writers in
:mod:`av1tpu_torch.ingest.etl` still emit the reference's on-disk text formats so
downstream reference tooling keeps working.

Semantics preserved exactly:
  * 7-field line contract with silent skip of malformed lines (004:43-65)
  * intra-only filter ``frame_type == 0`` (004:119)
  * block-size index map {3,6,9,12} -> {8,16,32,64} px (004:67-79)
  * order_hint cross-validation against the filename (004:112-126)
  * the real per-block QP is carried through — the reference's constant
    QP=80 fallback (007:96-99, quirk Q6 in SURVEY.md) is available as an
    explicit compat option, not the default.
"""
from __future__ import annotations

import re
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Tuple

import numpy as np

from av1tpu_torch.codec.partitions import BSIZE_INDEX_TO_PIXELS

_FRAME_FILE_RE = re.compile(r"partition_frame_(\d+)\.txt$")

# Columnar dtype for one dump file worth of block records.
DUMP_FIELDS = ("order_hint", "frame_type", "block_px", "row_units", "col_units", "mode", "qp")


@dataclass
class FrameBlocks:
    """All intra blocks of one frame for one block size, in dump order."""

    frame_index: int
    block_px: int
    row_units: np.ndarray  # int32, 4-pixel units
    col_units: np.ndarray  # int32, 4-pixel units
    modes: np.ndarray      # int32, partition mode 0..9
    qps: np.ndarray        # int32


@dataclass
class DumpParseResult:
    frame_index: int
    per_block_size: Dict[int, FrameBlocks] = field(default_factory=dict)
    warnings: List[str] = field(default_factory=list)
    total_lines: int = 0
    intra_blocks: int = 0


def frame_index_from_name(path: Path) -> int:
    m = _FRAME_FILE_RE.search(Path(path).name)
    if m is None:
        raise ValueError(
            f"invalid dump filename {Path(path).name!r} "
            "(expected partition_frame_<N>.txt)"
        )
    return int(m.group(1))


def parse_dump_file(path: Path) -> DumpParseResult:
    """Parse one dump file into per-block-size columnar arrays.

    Uses a single ``np.loadtxt``-style bulk parse for well-formed files and
    falls back to a tolerant line loop when malformed lines are present.
    """
    path = Path(path)
    frame_index = frame_index_from_name(path)
    result = DumpParseResult(frame_index=frame_index)

    text = path.read_text(encoding="utf-8")
    rows: List[Tuple[int, ...]] = []
    for lineno, line in enumerate(text.splitlines(), 1):
        parts = line.split()
        if not parts:
            continue
        result.total_lines += 1
        if len(parts) != 7:
            result.warnings.append(f"{path.name}:{lineno}: malformed line")
            continue
        try:
            rows.append(tuple(int(p) for p in parts))
        except ValueError:
            result.warnings.append(f"{path.name}:{lineno}: non-integer field")

    if not rows:
        return result

    arr = np.asarray(rows, dtype=np.int64)
    order_hint, frame_type, bsize, row_u, col_u, mode, qp = arr.T

    mismatched = order_hint != frame_index
    if mismatched.any():
        result.warnings.append(
            f"{path.name}: {int(mismatched.sum())} lines with order_hint != "
            f"{frame_index}"
        )

    intra = frame_type == 0
    result.intra_blocks = int(intra.sum())

    for bsize_idx, px in BSIZE_INDEX_TO_PIXELS.items():
        mask = intra & (bsize == bsize_idx)
        if not mask.any():
            continue
        result.per_block_size[px] = FrameBlocks(
            frame_index=frame_index,
            block_px=px,
            row_units=row_u[mask].astype(np.int32),
            col_units=col_u[mask].astype(np.int32),
            modes=mode[mask].astype(np.int32),
            qps=qp[mask].astype(np.int32),
        )
    return result


def discover_dump_files(directory: Path) -> List[Path]:
    """All ``partition_frame_*.txt`` under ``directory``, by frame index."""
    files = [
        p for p in Path(directory).iterdir() if _FRAME_FILE_RE.search(p.name)
    ]
    return sorted(files, key=frame_index_from_name)


def parse_dump_directory(directory: Path) -> List[DumpParseResult]:
    return [parse_dump_file(p) for p in discover_dump_files(directory)]


__all__ = [
    "DumpParseResult",
    "FrameBlocks",
    "discover_dump_files",
    "frame_index_from_name",
    "parse_dump_directory",
    "parse_dump_file",
]
