"""CLI: full AV1 partition-tree prediction for whole YUV frames (PyTorch port).

Tile each frame into 64x64 superblocks, run the per-block-size v6 cascades
over every level of the 64->32->16->8 hierarchy, and emit one 85-slot
partition quadtree per superblock:

    python -m av1tpu_torch.cli.predict_trees \
        --yuv clip_1920x1080_60.yuv --frames 0 1 2 \
        --models-64 runs64 --models-32 runs32 \
        --models-16 runs16 --models-8 runs8 \
        --output-dir runs/trees

Each ``--models-<S>`` directory holds that block size's four stage
checkpoints (stage1/stage2/stage3_rect/stage3_ab ``*_best_variables.npz``),
or with ``--unified`` one ``unified_best_variables.npz``. Outputs, as
``av1tpu.cli.predict_trees`` writes them: ``trees_frame<N>.npz`` (trees +
per-level modes + grid) and a JSON stats summary. ``--int8`` serves every
level through the int8 pipelines (``quant.ptq``), each calibrated on the
clip's own blocks of its size, drawn as the JAX CLI draws them. ``--device``
and ``--fused-front`` are the port's own.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from av1tpu_torch.cli.common import (
    add_single_device_arg,
    load_model_variables,
    serving_mesh,
)
from av1tpu_torch.codec.tree import LEVEL_SIZES, tree_depth_stats
from av1tpu_torch.eval import (
    PipelineModels,
    make_unified_pipeline,
    make_unified_pipeline_folded,
    make_v6_pipeline,
    make_v6_pipeline_folded,
    predict_partition_trees,
)
from av1tpu_torch.ingest.tiler import tile_frame
from av1tpu_torch.ingest.yuv import Yuv420p10Geometry, infer_resolution, read_y_frame
from av1tpu_torch.models import (
    FGVCModel,
    Stage1Model,
    Stage2Model,
    Stage3ABModel,
    Stage3RectModel,
    UnifiedV6Model,
    load_jax_variables,
)
from av1tpu_torch.parallel.mesh import is_writer
from av1tpu_torch.quant import make_unified_pipeline_int8, make_v6_pipeline_int8

CKPT_NAMES = {
    "stage1": (Stage1Model, "stage1_best_variables.npz"),
    "stage2": (Stage2Model, "stage2_best_variables.npz"),
    "stage3_rect": (Stage3RectModel, "stage3_rect_best_variables.npz"),
}
UNIFIED_CKPT_NAME = "unified_best_variables.npz"
FUSED_FRONT = {"off": False, "on": True, "g1": "g1"}


def build_level_predictor(
    model_dir: Path, threshold: float, dtype, ab_fgvc: bool, device="cuda",
    folded: bool = False, tta: bool = False, tta_align_ab: bool = False,
    unified: bool = False, use_fused_front=False, int8_calib=None, mesh=None,
):
    """One level's ``predict`` from the checkpoints in ``model_dir``; the
    int8 pipeline when ``int8_calib`` (uint16 calibration blocks) is given."""
    if unified:
        # single-backbone family (models.UnifiedV6Model): one checkpoint
        # per level serves the whole hierarchy, same output contract
        model = load_jax_variables(
            UnifiedV6Model(), load_model_variables(model_dir / UNIFIED_CKPT_NAME)
        ).eval()
        if int8_calib is not None:
            return make_unified_pipeline_int8(
                model, int8_calib, stage1_threshold=threshold, float_dtype=dtype,
                use_fused_front=use_fused_front, device=device, mesh=mesh,
            )
        if folded:
            return make_unified_pipeline_folded(
                model, stage1_threshold=threshold, float_dtype=dtype,
                use_fused_front=use_fused_front, device=device, mesh=mesh,
            )
        return make_unified_pipeline(
            model, stage1_threshold=threshold, input_dtype=dtype, tta=tta,
            tta_align_ab=tta_align_ab, device=device, mesh=mesh,
        )
    loaded = {
        key: load_jax_variables(cls(), load_model_variables(model_dir / fname)).eval()
        for key, (cls, fname) in CKPT_NAMES.items()
    }
    ab_path = model_dir / (
        "stage3_ab_fgvc_best_variables.npz" if ab_fgvc else "stage3_ab_best_variables.npz"
    )
    if not ab_path.exists():
        alt = model_dir / "stage3_ab_best_variables.npz"
        ab_path = alt if alt.exists() else model_dir / "stage3_ab_fgvc_best_variables.npz"
    ab_vars = load_model_variables(ab_path)
    ab_vars.pop("centers", None)
    ab_cls = FGVCModel if "fgvc" in ab_path.name else Stage3ABModel
    models = PipelineModels(
        loaded["stage1"], loaded["stage2"], loaded["stage3_rect"],
        load_jax_variables(ab_cls(), ab_vars).eval(),
    )
    if int8_calib is not None:
        return make_v6_pipeline_int8(
            models, int8_calib, stage1_threshold=threshold, float_dtype=dtype,
            use_fused_front=use_fused_front, device=device, mesh=mesh,
        )
    if folded:
        return make_v6_pipeline_folded(
            models, stage1_threshold=threshold, float_dtype=dtype,
            use_fused_front=use_fused_front, device=device, mesh=mesh,
        )
    return make_v6_pipeline(
        models, stage1_threshold=threshold, input_dtype=dtype, device=device,
        tta=tta, tta_align_ab=tta_align_ab, mesh=mesh,
    )


def normalize_thresholds(values):
    """1 global or 4 per-size (64/32/16/8 order) gate thresholds ->
    the per-size list; raises ValueError on any other count."""
    values = list(values)
    if len(values) == 1:
        return values * 4
    if len(values) != 4:
        raise ValueError(
            f"--stage1-threshold takes 1 or 4 values (64 32 16 8), "
            f"got {len(values)}"
        )
    return values


def int8_calibration_blocks(yuv: Path, geom: Yuv420p10Geometry, frames,
                            max_blocks: int) -> dict:
    """``{size: (k, size, size, 1) uint16}``: the self-serve calibration set
    of each level, as the JAX CLI draws it. The superblocks of up to four
    evenly spaced requested frames, cut into blocks of each size; ``k =
    min(max(1, max_blocks), blocks)`` of them drawn without replacement by one
    ``default_rng(0)`` in level order 64, 32, 16, 8, kept in row order. A
    single frame's scales drift out of range across later content, so the
    sample spans the clip."""
    n_calib_frames = min(4, len(frames))
    calib_frames = sorted({
        frames[round(i * (len(frames) - 1) / max(1, n_calib_frames - 1))]
        for i in range(n_calib_frames)
    })
    sbs = np.concatenate([tile_frame(read_y_frame(yuv, f, geom), 64)[0]
                          for f in calib_frames])
    rng = np.random.default_rng(0)
    out = {}
    for size in LEVEL_SIZES:
        f = 64 // size
        blocks = (sbs.reshape(-1, f, size, f, size).transpose(0, 1, 3, 2, 4)
                  .reshape(-1, size, size))
        k = min(max(1, max_blocks), blocks.shape[0])
        idx = rng.choice(blocks.shape[0], size=k, replace=False)
        out[size] = blocks[np.sort(idx)][..., None]
    return out


def split_group_result(result, n_frames, frame_sbs, j):
    """Slice frame ``j``'s view out of a stacked multi-frame ``result``.

    Per-superblock arrays (leading dim ``n_frames * frame_sbs``) are
    sliced to the frame's rows. Gate-overflow counters from a stacked
    dispatch are renamed ``group_overflow_*``: the gate's top-K ran over
    the whole group, so the counter cannot be attributed to one frame and
    a per-frame name would over-count by ``n_frames`` when summing the
    per-frame files. Everything else passes through unchanged.
    """
    out = {}
    for k, v in result.items():
        if v.ndim and v.shape[0] == n_frames * frame_sbs:
            out[k] = v[j * frame_sbs : (j + 1) * frame_sbs]
        elif k.startswith("overflow_") and n_frames > 1:
            out[f"group_{k}"] = v
        else:
            out[k] = v
    return out


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--yuv", type=Path, required=True)
    parser.add_argument("--resolution", type=str, default=None)
    parser.add_argument("--frames", type=int, nargs="+", default=[0])
    for size in LEVEL_SIZES:
        parser.add_argument(f"--models-{size}", type=Path, required=True)
    parser.add_argument("--output-dir", type=Path, required=True)
    parser.add_argument("--stage1-threshold", type=float, nargs="+",
                        default=[0.45],
                        help="stage-1 gate threshold: one global value, or "
                        "four per-size values in 64 32 16 8 order (feed "
                        "each level its calibrated operating point)")
    parser.add_argument("--batch-size", type=int, default=4096)
    parser.add_argument("--bf16", action="store_true")
    parser.add_argument("--no-ab-fgvc", dest="ab_fgvc", action="store_false",
                        default=True)
    add_single_device_arg(parser)
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                        help="cuda needs a GPU; nothing falls back to the CPU")
    parser.add_argument("--level-capacity", type=float, nargs=4,
                        default=None, metavar=("C64", "C32", "C16", "C8"),
                        help="per-level node-evaluation capacities in "
                        "(0, 1] (64 32 16 8 order; 1.0 = dense). A node "
                        "only matters if every ancestor predicted SPLIT, "
                        "so a static top-K over aliveness is exact when K "
                        "covers the live set; alive overflow beyond K "
                        "truncates that subtree and is reported")
    parser.add_argument("--frames-per-batch", type=int, default=1,
                        help="stack this many frames' superblocks into one "
                        "cascade dispatch: the per-level chain of launches "
                        "is paid once for the group, and the levels' batches "
                        "are that many times larger")
    parser.add_argument("--serial-io", action="store_true",
                        help="disable IO/compute overlap (read -> compute "
                        "-> sync per frame group); exists to measure the "
                        "overlap A/B")
    parser.add_argument("--unified", action="store_true",
                        help="serve each level from a single-backbone "
                        "UnifiedV6Model checkpoint "
                        f"({UNIFIED_CKPT_NAME} in each --models-* dir) "
                        "instead of the four per-stage checkpoints: one "
                        "backbone forward per block instead of four; "
                        "composes with --folded/--tta/--level-capacity")
    parser.add_argument("--folded", action="store_true",
                        help="serve each level through the BN-folded graph "
                        "(eval.folded; an FGVC AB checkpoint runs unfolded "
                        "through its own forward inside the pipeline)")
    parser.add_argument("--fused-front", choices=tuple(FUSED_FRONT),
                        default="off",
                        help="with --folded: at the 16 and 8 px levels, "
                        "stem+maxpool as kernel K1 (on) or stem+maxpool+"
                        "layer group 1+SE1 as kernel K2 (g1); with --int8: "
                        "on (K1) only")
    parser.add_argument("--int8", action="store_true",
                        help="serve each level through the int8 PTQ graph "
                        "(quant.ptq hybrid lowering). Calibration is "
                        "self-serve: each level calibrates on the clip's own "
                        "blocks of its size, sampled across up to 4 evenly "
                        "spaced requested frames. Incompatible with --folded/"
                        "--tta (int8 is its own folded graph); an FGVC AB "
                        "checkpoint stays float inside the pipeline")
    parser.add_argument("--int8-calib-blocks", type=int, default=256,
                        help="with --int8: max calibration blocks sampled "
                        "per level size across the calibration frames")
    parser.add_argument("--tta", action="store_true",
                        help="average each stage over the 4 TTA views "
                        "(original/hflip/vflip/rot180) at every level, four "
                        "times the compute; plain graph only (incompatible "
                        "with --folded)")
    parser.add_argument("--tta-align-ab", action=argparse.BooleanOptionalAction,
                        default=None,
                        help="with --tta: remap flipped views' AB logits "
                        "through the training swap tables before averaging. "
                        "DEFAULT ON with --tta: the naive mean "
                        "(--no-tta-align-ab) mixes the swapped pairs")
    return parser


def main(argv=None) -> None:
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.tta and args.folded:
        parser.error("--tta is incompatible with --folded")
    if args.int8 and (args.tta or args.folded):
        parser.error("--int8 is a distinct serving path (no --tta/--folded)")
    if args.tta_align_ab and not args.tta:
        parser.error("--tta-align-ab requires --tta")
    if args.fused_front != "off" and not (args.folded or args.int8):
        parser.error("--fused-front needs --folded or --int8")
    if args.int8 and args.fused_front == "g1":
        parser.error("--fused-front g1: the int8 graph has no group-1 hook; "
                     "use --fused-front on")
    tta_align_ab = args.tta and args.tta_align_ab is not False

    if args.resolution:
        w, h = (int(v) for v in args.resolution.lower().split("x"))
    else:
        res = infer_resolution(args.yuv.name)
        if res is None:
            parser.error("cannot infer resolution; pass --resolution WxH")
        w, h = res
    geom = Yuv420p10Geometry(width=w, height=h)

    if args.device == "cuda" and not torch.cuda.is_available():
        parser.error("--device cuda: no CUDA device is available")
    device = torch.device(args.device)
    mesh = serving_mesh(args)
    dtype = torch.bfloat16 if args.bf16 else torch.float32
    try:
        thresholds = normalize_thresholds(args.stage1_threshold)
    except ValueError as e:
        parser.error(str(e))
    calib_by_size = (int8_calibration_blocks(args.yuv, geom, args.frames,
                                             args.int8_calib_blocks)
                     if args.int8 else dict.fromkeys(LEVEL_SIZES))
    predictors = {
        size: build_level_predictor(
            getattr(args, f"models_{size}"), threshold, dtype,
            args.ab_fgvc, device=device, folded=args.folded,
            tta=args.tta, tta_align_ab=tta_align_ab, unified=args.unified,
            use_fused_front=FUSED_FRONT[args.fused_front],
            int8_calib=calib_by_size[size], mesh=mesh,
        )
        for size, threshold in zip(LEVEL_SIZES, thresholds)
    }

    out_dir = Path(args.output_dir)
    if is_writer():  # under a mesh every rank holds the whole result; rank 0 writes it
        out_dir.mkdir(parents=True, exist_ok=True)
    summary = {}
    capacities = None
    if args.level_capacity is not None:
        capacities = dict(zip(LEVEL_SIZES, args.level_capacity))
        if capacities[64] < 1.0 and is_writer():
            # the root level always evaluates dense (every root node is
            # alive by definition), so a sub-1.0 C64 would silently do
            # nothing: say so instead of accepting it quietly
            print(
                f"warning: --level-capacity C64={capacities[64]:g} has no "
                "effect: the 64px root level always evaluates dense; "
                "gating applies to 32/16/8 only",
                file=sys.stderr,
            )
            capacities[64] = 1.0
    # Frame-pipelined loop: each group's trees are launched on the device
    # with as_numpy=False (no sync), then the NEXT group's disk read + host
    # tiling start on a background thread BEFORE this group's results are
    # pulled to the host, so disk IO overlaps device compute.
    # --frames-per-batch stacks several frames' superblocks into one cascade
    # dispatch to spread the per-level launch chain over more blocks.
    fpb = max(1, args.frames_per_batch)
    groups = [args.frames[i : i + fpb]
              for i in range(0, len(args.frames), fpb)]

    def load_group(indices):
        tiles = [
            tile_frame(read_y_frame(args.yuv, i, geom), 64) for i in indices
        ]
        sbs = (
            np.concatenate([t[0] for t in tiles])
            if len(tiles) > 1 else tiles[0][0]
        )
        return sbs, tiles[0][1]

    with ThreadPoolExecutor(max_workers=1) as loader:
        if not args.serial_io:
            future = loader.submit(load_group, groups[0])
        for pos, group in enumerate(groups):
            if args.serial_io:
                sbs, grid = load_group(group)
            else:
                sbs, grid = future.result()
            start = time.perf_counter()
            result = predict_partition_trees(
                sbs, predictors, args.batch_size,
                level_capacities=capacities, as_numpy=args.serial_io,
                device=device, mesh=mesh,
            )
            # everything is launched: kick off the next group's IO, then
            # block on this group's outputs
            if not args.serial_io and pos + 1 < len(groups):
                future = loader.submit(load_group, groups[pos + 1])
            result = {
                k: v.cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
                for k, v in result.items()
            }
            seconds = time.perf_counter() - start
            grid_shape = np.asarray([grid.num_rows, grid.num_cols])
            frame_sbs = grid.num_rows * grid.num_cols
            for j, frame_index in enumerate(group):
                frame_result = split_group_result(
                    result, len(group), frame_sbs, j
                )
                if is_writer():
                    np.savez(out_dir / f"trees_frame{frame_index}.npz",
                             grid_shape=grid_shape, **frame_result)
                stats = tree_depth_stats(frame_result["trees"])
                stats["superblocks"] = int(frame_result["trees"].shape[0])
                # group wall-clock amortized per frame
                stats["seconds"] = seconds / len(group)
                if len(group) > 1:
                    stats["frames_in_batch"] = len(group)
                for key, value in frame_result.items():
                    if key.startswith(("overflow_", "group_overflow_")):
                        stats[key] = int(value)
                summary[str(frame_index)] = stats
    if is_writer():
        (out_dir / "tree_stats.json").write_text(json.dumps(summary, indent=2))
        print(json.dumps(summary, indent=2))


if __name__ == "__main__":
    main()
