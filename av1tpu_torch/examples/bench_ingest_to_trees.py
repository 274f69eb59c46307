"""End-to-end throughput: YUV file on disk -> per-superblock partition trees.

Measures the complete north-star path — lossless 10-bit luma ingestion
(the native C++ reader when built, numpy otherwise), superblock tiling,
normalization, and the 4-level hierarchical inference cascade — as one
number: 64x64 superblocks per second from disk to assembled partition
trees, on ``--device``. Four v6 stage models are drawn on the device from
seeds 1-4 (random weights: the work does not depend on them). A first pass
is warm-up (cuDNN's first picks, the allocator); the second is timed.

    python -m av1tpu_torch.examples.bench_ingest_to_trees [--frames 32] \
        [--bf16] [--out runs/bench_ingest_to_trees] [--device cuda]

Writes the synthetic clip and ``report.json`` under ``--out``.
"""
import argparse
import json
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from av1tpu_torch.eval import PipelineModels, make_v6_pipeline
from av1tpu_torch.eval.tree_infer import predict_partition_trees
from av1tpu_torch.examples._common import add_device_arg, parse_example_args, timed
from av1tpu_torch.ingest.native import native_available, read_y_frames
from av1tpu_torch.ingest.tiler import tile_frames
from av1tpu_torch.ingest.yuv import Yuv420p10Geometry
from av1tpu_torch.models import Stage1Model, Stage2Model, Stage3ABModel, Stage3RectModel
from av1tpu_torch.models.layers import init_like_flax


def write_synth_video(path: Path, width: int, height: int, frames: int) -> None:
    rng = np.random.default_rng(0)
    cw, ch = (width + 1) // 2, (height + 1) // 2
    chroma = np.zeros((ch, cw), dtype="<u2").tobytes()
    with open(path, "wb") as f:
        for _ in range(frames):
            plane = rng.integers(0, 1024, (height, width), dtype=np.uint16)
            f.write(plane.astype("<u2").tobytes())
            f.write(chroma)
            f.write(chroma)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--width", type=int, default=1920)
    parser.add_argument("--height", type=int, default=1088)
    parser.add_argument("--frames", type=int, default=32)
    parser.add_argument("--batch-size", type=int, default=8192)
    parser.add_argument("--chunk-frames", type=int, default=8,
                        help="frames per double-buffered IO/compute chunk")
    parser.add_argument("--bf16", action=argparse.BooleanOptionalAction,
                        default=True,
                        help="bf16 compute (default; --no-bf16 for float32)")
    parser.add_argument("--out", type=Path, default=Path("runs/bench_ingest_to_trees"))
    add_device_arg(parser)
    args = parse_example_args(parser, argv)
    device = torch.device(args.device)

    dtype = torch.bfloat16 if args.bf16 else torch.float32
    print(f"device={args.device} native_io={native_available()}")

    args.out.mkdir(parents=True, exist_ok=True)
    video = args.out / f"synth_{args.width}x{args.height}_60.yuv"
    write_synth_video(video, args.width, args.height, args.frames)
    geom = Yuv420p10Geometry(width=args.width, height=args.height)

    def build(cls, seed):
        model = cls().to(device)
        return init_like_flax(model, torch.Generator(device=device).manual_seed(seed))

    predict = make_v6_pipeline(
        PipelineModels(*(build(cls, seed) for seed, cls in enumerate(
            (Stage1Model, Stage2Model, Stage3RectModel, Stage3ABModel), 1))),
        input_dtype=dtype, device=device,
    )
    predictors = {size: predict for size in (64, 32, 16, 8)}

    chunk = max(1, args.chunk_frames)
    frame_chunks = [
        list(range(s, min(s + chunk, args.frames)))
        for s in range(0, args.frames, chunk)
    ]

    def load_chunk(frame_ids):
        """Disk read + host tiling for one chunk (runs on the IO thread)."""
        planes = read_y_frames(video, geom, frame_ids)
        superblocks, _ = tile_frames(planes, 64)
        return superblocks

    io_seconds = 0.0

    def one_pass():
        """Double-buffered: the IO thread reads+tiles chunk i+1 while the
        device runs the 4-level cascade on chunk i (device outputs stay
        unsynchronized until the very end)."""
        nonlocal io_seconds
        io_seconds = 0.0
        device_trees = []
        with ThreadPoolExecutor(max_workers=1) as pool:
            future = pool.submit(load_chunk, frame_chunks[0])
            for ci in range(len(frame_chunks)):
                t0 = time.perf_counter()
                sbs = future.result()
                io_seconds += time.perf_counter() - t0
                if ci + 1 < len(frame_chunks):
                    future = pool.submit(load_chunk, frame_chunks[ci + 1])
                out = predict_partition_trees(
                    sbs, predictors, args.batch_size, as_numpy=False, device=device
                )
                device_trees.append(out["trees"])
        return np.concatenate([t.cpu().numpy() for t in device_trees])

    sbs_per_frame = -(-args.height // 64) * -(-args.width // 64)
    one_pass()  # warm-up: cuDNN's first picks, the allocator
    trees, seconds = timed(one_pass, device)  # steady state
    total_trees = trees.shape[0]

    report = {
        "resolution": f"{args.width}x{args.height}",
        "frames": args.frames,
        "superblocks": total_trees,
        "seconds": round(seconds, 3),
        "superblocks_per_sec_disk_to_tree": round(total_trees / seconds, 1),
        "frames_per_sec": round(args.frames / seconds, 2),
        "io_wait_seconds": round(io_seconds, 3),
        "chunk_frames": chunk,
        "native_io": native_available(),
        "device": (torch.cuda.get_device_name(device)
                   if device.type == "cuda" else "cpu"),
        "note": "every potential 64/32/16/8 block evaluated dense; "
        f"{sbs_per_frame} superblocks/frame = "
        f"{sbs_per_frame * 85} potential tree nodes/frame; IO+tiling "
        "double-buffered against device compute",
    }
    (args.out / "report.json").write_text(json.dumps(report, indent=2))
    print(json.dumps(report, indent=2))


if __name__ == "__main__":
    main()
