"""One-pass ETL: YUV + encoder dump -> labeled superblock datasets.

The port's own copy of ``av1tpu.ingest.etl`` (numpy, and the native reader
of :mod:`av1tpu_torch.ingest.native` where it is built): the same files for
the same clip and dumps.

Fuses the reference's four-script chain (004 dump->Excel, 005 YUV->blocks +
label join, 006 per-frame merge, 007 Excel->label/QP text files; see
``pesquisa_v5/004_prepare_partition_data_v2.py`` through
``007_generate_label_qp_v2.py``) into a single vectorized pass per sequence:

    for each frame with a dump file:
        read Y plane (lossless uint16)            ingest.yuv
        for each block size:
            tile + label-join (vectorized)        ingest.tiler
            collect blocks / modes / qps
    concatenate per sequence, write outputs

Outputs are written in the reference's exact on-disk contract so existing
tooling and the data hub loader stay compatible:

    intra_raw_blocks/<seq>_sample_<S>.txt   raw little-endian uint16 blocks
    labels/<seq>_labels_<S>_intra.txt       space-separated partition modes
    qps/<seq>_qps_<S>_intra.txt             space-separated QPs

QP policy: the real per-block QP from the dump is the default. The reference
pipeline hardcodes QP=80 for every block (007:96-99 — quirk Q6); pass
``qp_mode="constant80"`` to reproduce that byte-for-byte.

Integrity: the reference MD5-verifies every written file by re-reading it
(005:567-607). ``verify=True`` performs the same write->readback comparison.
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from av1tpu_torch.ingest.native import native_available, read_y_frames
from av1tpu_torch.ingest.partition_dump import (
    DumpParseResult,
    parse_dump_directory,
)
from av1tpu_torch.ingest.tiler import extract_labeled_blocks
from av1tpu_torch.ingest.xlsx import parse_xlsx_directory
from av1tpu_torch.ingest.yuv import Yuv420p10Geometry, infer_resolution, read_y_frame

DEFAULT_BLOCK_SIZES = (64, 32, 16, 8)
CONSTANT_QP = 80  # reference 007_generate_label_qp_v2.py:96-99


@dataclass
class SequenceExtract:
    """In-memory extraction result for one sequence and one block size."""

    block_size: int
    blocks: np.ndarray  # (N, bs, bs) uint16
    modes: np.ndarray   # (N,) int32
    qps: np.ndarray     # (N,) int32
    frames: np.ndarray  # (N,) int32 source frame index per block

    @property
    def num_blocks(self) -> int:
        return int(self.blocks.shape[0])


@dataclass
class EtlReport:
    sequence: str
    width: int
    height: int
    frames_processed: int = 0
    per_block_size: Dict[int, int] = field(default_factory=dict)
    warnings: List[str] = field(default_factory=list)
    files_written: List[str] = field(default_factory=list)


def extract_sequence(
    yuv_path: Path,
    dump_dir: Path,
    block_sizes: Sequence[int] = DEFAULT_BLOCK_SIZES,
    resolution: Optional[Tuple[int, int]] = None,
    qp_mode: str = "real",
    max_frames: Optional[int] = None,
    use_native: bool = True,
    dump_format: str = "txt",
) -> Tuple[Dict[int, SequenceExtract], EtlReport]:
    """Extract labeled blocks for every dumped intra frame of one sequence.

    With ``use_native`` (default) and the C++ IO library built, all needed
    frames batch-load through the multithreaded native reader; otherwise
    frames stream through the numpy reader one by one.

    ``dump_format="xlsx"`` ingests the reference's per-frame Excel label
    archives (``{video}-intra-{N}.xlsx``, 004:145-172) instead of raw
    ``partition_frame_N.txt`` dumps — for users who kept only the
    workbooks (see :mod:`av1tpu_torch.ingest.xlsx`).
    """
    yuv_path = Path(yuv_path)
    if resolution is None:
        resolution = infer_resolution(yuv_path.name)
        if resolution is None:
            raise ValueError(
                f"cannot infer WxH from {yuv_path.name}; pass resolution="
            )
    width, height = resolution
    geom = Yuv420p10Geometry(width=width, height=height)
    num_frames, remainder = geom.validate_file(yuv_path)

    report = EtlReport(sequence=yuv_path.stem, width=width, height=height)
    if remainder:
        report.warnings.append(f"{remainder} trailing bytes ignored")

    if dump_format == "xlsx":
        dumps: List[DumpParseResult] = parse_xlsx_directory(dump_dir)
    else:
        dumps = parse_dump_directory(dump_dir)
    if max_frames is not None:
        dumps = dumps[:max_frames]

    acc: Dict[int, Dict[str, List[np.ndarray]]] = {
        bs: {"blocks": [], "modes": [], "qps": [], "frames": []}
        for bs in block_sizes
    }

    valid_dumps = []
    for dump in dumps:
        report.warnings.extend(dump.warnings)
        if dump.frame_index >= num_frames:
            report.warnings.append(
                f"frame {dump.frame_index} beyond file ({num_frames} frames)"
            )
            continue
        valid_dumps.append(dump)

    preloaded = None
    if use_native and valid_dumps and native_available():
        preloaded = read_y_frames(
            yuv_path, geom, [d.frame_index for d in valid_dumps],
            validate_range=True,
        )

    for di, dump in enumerate(valid_dumps):
        if preloaded is not None:
            y_plane = preloaded[di]
        else:
            y_plane = read_y_frame(yuv_path, dump.frame_index, geom)
        report.frames_processed += 1

        for bs in block_sizes:
            fb = dump.per_block_size.get(bs)
            if fb is None or fb.col_units.size == 0:
                continue
            blocks, label_idx, _ = extract_labeled_blocks(
                y_plane, bs, fb.col_units
            )
            if blocks.shape[0] == 0:
                continue
            acc[bs]["blocks"].append(blocks)
            acc[bs]["modes"].append(fb.modes[label_idx])
            if qp_mode == "constant80":
                qps = np.full(label_idx.shape[0], CONSTANT_QP, dtype=np.int32)
            else:
                qps = fb.qps[label_idx]
            acc[bs]["qps"].append(qps)
            acc[bs]["frames"].append(
                np.full(label_idx.shape[0], dump.frame_index, dtype=np.int32)
            )

    extracts: Dict[int, SequenceExtract] = {}
    for bs in block_sizes:
        if not acc[bs]["blocks"]:
            continue
        extracts[bs] = SequenceExtract(
            block_size=bs,
            blocks=np.concatenate(acc[bs]["blocks"], axis=0),
            modes=np.concatenate(acc[bs]["modes"], axis=0),
            qps=np.concatenate(acc[bs]["qps"], axis=0),
            frames=np.concatenate(acc[bs]["frames"], axis=0),
        )
        report.per_block_size[bs] = extracts[bs].num_blocks
    return extracts, report


def _write_verified(path: Path, payload: bytes, verify: bool) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_bytes(payload)
    if verify:
        digest = hashlib.md5(payload).hexdigest()
        readback = hashlib.md5(path.read_bytes()).hexdigest()
        if digest != readback:
            raise IOError(f"write->readback checksum mismatch for {path}")


def write_reference_layout(
    extracts: Dict[int, SequenceExtract],
    out_dir: Path,
    sequence_name: str,
    verify: bool = True,
    report: Optional[EtlReport] = None,
) -> None:
    """Write the reference three-directory text layout for one sequence."""
    out_dir = Path(out_dir)
    for bs, ext in extracts.items():
        sample_path = out_dir / "intra_raw_blocks" / f"{sequence_name}_sample_{bs}.txt"
        label_path = out_dir / "labels" / f"{sequence_name}_labels_{bs}_intra.txt"
        qp_path = out_dir / "qps" / f"{sequence_name}_qps_{bs}_intra.txt"

        _write_verified(
            sample_path,
            np.ascontiguousarray(ext.blocks, dtype="<u2").tobytes(),
            verify,
        )
        _write_verified(
            label_path,
            " ".join(str(int(m)) for m in ext.modes).encode(),
            verify,
        )
        _write_verified(
            qp_path,
            " ".join(str(int(q)) for q in ext.qps).encode(),
            verify,
        )
        if report is not None:
            report.files_written += [str(sample_path), str(label_path), str(qp_path)]


def write_npz(
    extracts: Dict[int, SequenceExtract],
    out_dir: Path,
    sequence_name: str,
) -> List[Path]:
    """Write the native columnar format: one compressed npz per block size."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    paths = []
    for bs, ext in extracts.items():
        path = out_dir / f"{sequence_name}_block{bs}.npz"
        np.savez_compressed(
            path,
            blocks=ext.blocks,
            modes=ext.modes,
            qps=ext.qps,
            frames=ext.frames,
        )
        paths.append(path)
    return paths


__all__ = [
    "CONSTANT_QP",
    "DEFAULT_BLOCK_SIZES",
    "EtlReport",
    "SequenceExtract",
    "extract_sequence",
    "write_npz",
    "write_reference_layout",
]
