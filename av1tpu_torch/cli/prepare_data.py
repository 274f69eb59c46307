"""CLI: raw extraction — YUV + encoder dumps -> labeled block files.

One-pass replacement for the reference's four-script ETL chain
(004_prepare_partition_data_v2 / 005_rearrange_video_YUV_420_10bit_LOSSLESS
/ 006_merge_sample_v2 / 007_generate_label_qp_v2):

    python -m av1tpu_torch.cli.prepare_data \
        --yuv data/Clip_1920x1080_60.yuv --dumps data/dumps/clip1 \
        --out data/extracted --formats reference npz

Emits the reference's three-directory text layout and/or the native
columnar npz, with write->readback verification and a JSON report. The
port's own copy of ``av1tpu.cli.prepare_data``: host numpy (and the native
reader where ``make -C native`` built it), no device, every flag of the
JAX CLI.
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

from av1tpu_torch.ingest.etl import (
    DEFAULT_BLOCK_SIZES,
    extract_sequence,
    write_npz,
    write_reference_layout,
)


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--yuv", type=Path, required=True,
                        help="YUV 4:2:0 10-bit file (name should contain WxH)")
    parser.add_argument("--dumps", type=Path, required=True,
                        help="directory of partition_frame_N.txt encoder dumps"
                        " (or of <video>-intra-<N>.xlsx workbooks with "
                        "--dump-format xlsx)")
    parser.add_argument("--dump-format", choices=("txt", "xlsx"),
                        default="txt",
                        help="xlsx ingests the reference's per-frame Excel "
                        "label archives (004:145-172) when raw dumps were "
                        "discarded")
    parser.add_argument("--out", type=Path, required=True)
    parser.add_argument("--sequence-name", type=str, default=None)
    parser.add_argument("--resolution", type=str, default=None,
                        help="WxH override, e.g. 1920x1080")
    parser.add_argument("--block-sizes", type=int, nargs="+",
                        default=list(DEFAULT_BLOCK_SIZES))
    parser.add_argument("--qp-mode", choices=("real", "constant80"),
                        default="real",
                        help="constant80 reproduces the reference's "
                        "hardcoded QP (quirk Q6)")
    parser.add_argument("--formats", nargs="+",
                        choices=("reference", "npz"), default=["reference"])
    parser.add_argument("--no-verify", action="store_true",
                        help="skip write->readback checksum verification")
    parser.add_argument("--max-frames", type=int, default=None)
    args = parser.parse_args(argv)

    resolution = None
    if args.resolution:
        w, h = args.resolution.lower().split("x")
        resolution = (int(w), int(h))

    extracts, report = extract_sequence(
        args.yuv, args.dumps, block_sizes=tuple(args.block_sizes),
        resolution=resolution, qp_mode=args.qp_mode,
        max_frames=args.max_frames, dump_format=args.dump_format,
    )
    seq_name = args.sequence_name or args.yuv.stem

    if "reference" in args.formats:
        write_reference_layout(
            extracts, args.out, seq_name, verify=not args.no_verify,
            report=report,
        )
    if "npz" in args.formats:
        write_npz(extracts, args.out / "npz", seq_name)

    args.out.mkdir(parents=True, exist_ok=True)
    report_payload = {
        "sequence": report.sequence,
        "resolution": [report.width, report.height],
        "frames_processed": report.frames_processed,
        "blocks_per_size": report.per_block_size,
        "warnings": report.warnings,
        "qp_mode": args.qp_mode,
    }
    (args.out / f"{seq_name}_etl_report.json").write_text(
        json.dumps(report_payload, indent=2)
    )
    print(json.dumps(report_payload, indent=2))


if __name__ == "__main__":
    main()
