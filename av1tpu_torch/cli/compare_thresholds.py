"""CLI: side-by-side comparison of stage-1 operating points (PyTorch port).

    python -m av1tpu_torch.cli.compare_thresholds \
        --dataset-dir data/v6_dataset --block-size 16 \
        --stage1-checkpoint ... --stage2-checkpoint ... \
        --stage3-rect-checkpoint ... --stage3-ab-checkpoint ... \
        --thresholds 0.45 0.50 0.55 --output-dir runs/op_compare

The plain v6 pipeline runs once on the card; every operating point
recomposes from the cached stage outputs (routing does not depend on the
threshold). Writes ``operating_points.json`` and ``operating_points.md`` as
``av1tpu.cli.compare_thresholds`` does.
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

import torch

from av1tpu_torch.cli.common import (
    add_single_device_arg,
    load_model,
    load_split,
    serving_mesh,
)
from av1tpu_torch.codec.partitions import V6_EVAL_CLASS_NAMES, raw_to_v6_final
from av1tpu_torch.eval import PipelineModels, make_v6_pipeline, run_pipeline_batched
from av1tpu_torch.eval.compare import compare_operating_points, render_markdown
from av1tpu_torch.models import (
    FGVCModel,
    Stage1Model,
    Stage2Model,
    Stage3ABModel,
    Stage3RectModel,
)
from av1tpu_torch.parallel.mesh import is_writer


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--dataset-dir", type=Path, required=True)
    parser.add_argument("--block-size", type=int, default=16)
    parser.add_argument("--split", choices=("train", "val"), default="val")
    parser.add_argument("--output-dir", type=Path, required=True)
    parser.add_argument("--batch-size", type=int, default=4096)
    parser.add_argument("--thresholds", type=float, nargs="+",
                        default=[0.45, 0.50, 0.55])
    parser.add_argument("--stage1-checkpoint", type=Path, required=True)
    parser.add_argument("--stage2-checkpoint", type=Path, required=True)
    parser.add_argument("--stage3-rect-checkpoint", type=Path, required=True)
    parser.add_argument("--stage3-ab-checkpoint", type=Path, required=True)
    parser.add_argument("--ab-fgvc", action="store_true", default=True)
    parser.add_argument("--no-ab-fgvc", dest="ab_fgvc", action="store_false")
    parser.add_argument("--bf16", action="store_true")
    add_single_device_arg(parser)
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                        help="cuda needs a GPU; nothing falls back to the CPU")
    args = parser.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        parser.error("--device cuda: no CUDA device is available")

    mesh = serving_mesh(args)
    dtype = torch.bfloat16 if args.bf16 else torch.float32
    train_b, val_b, _ = load_split(args.dataset_dir, args.block_size)
    bundle = val_b if args.split == "val" else train_b
    models = PipelineModels(
        load_model(args.stage1_checkpoint, Stage1Model),
        load_model(args.stage2_checkpoint, Stage2Model),
        load_model(args.stage3_rect_checkpoint, Stage3RectModel),
        load_model(args.stage3_ab_checkpoint, FGVCModel if args.ab_fgvc else Stage3ABModel),
    )
    predict = make_v6_pipeline(models, stage1_threshold=args.thresholds[0],
                               input_dtype=dtype, device=args.device, mesh=mesh)
    outputs = run_pipeline_batched(predict, bundle.samples, args.batch_size, args.device,
                                   mesh=mesh)
    if not is_writer():
        return
    labels = raw_to_v6_final(bundle.labels["stage0"])

    report = compare_operating_points(
        outputs, labels, args.thresholds, list(V6_EVAL_CLASS_NAMES)
    )
    out = Path(args.output_dir)
    out.mkdir(parents=True, exist_ok=True)
    (out / "operating_points.json").write_text(json.dumps(report, indent=2))
    md = render_markdown(report)
    (out / "operating_points.md").write_text(md)
    print(md)


if __name__ == "__main__":
    main()
