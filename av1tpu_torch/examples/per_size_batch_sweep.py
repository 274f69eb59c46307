"""Per-block-size batch sweep for the folded serving graph.

The serving batch is the number of rows of every implicit GEMM a conv
lowers to, and the number of blocks each of a predict's launches covers:
this sweeps it per block size on ``--device`` and prints a markdown table of
blocks/s and MFU (``examples._bench``: the operations of one block counted
from the layer shapes, over the card's dense bf16 peak), then the best batch
of each size. The numbers are the card's; on the CPU the MFU column reads
"not measured".

    python -m av1tpu_torch.examples.per_size_batch_sweep [--sizes 8 32 64 16] \
        [--iters 20] [--device cuda]

A batch that does not fit on the card prints a FAILED row and the sweep goes
on; any other error stops it.
"""
import argparse

import torch

from av1tpu_torch.eval import make_v6_pipeline_folded
from av1tpu_torch.examples._bench import (
    _build_models,
    _time_predict,
    describe_device,
    mfu_cell,
)
from av1tpu_torch.examples._common import add_device_arg, parse_example_args

SWEEP = {
    8: (8192, 16384, 32768, 65536),
    16: (4096, 8192, 16384, 32768),
    32: (1024, 2048, 4096, 8192),
    64: (256, 512, 1024, 2048),
}


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--sizes", type=int, nargs="+", default=[8, 32, 64, 16])
    parser.add_argument("--iters", type=int, default=20)
    add_device_arg(parser)
    args = parse_example_args(parser, argv)

    dtype = torch.bfloat16
    models = _build_models(args.device)
    print(describe_device(args.device))
    print("| px | batch | sb/s | MFU |")
    print("|---|---|---|---|")
    best = {}
    for px in args.sizes:
        for batch in SWEEP[px]:
            predict = make_v6_pipeline_folded(
                models, stage1_threshold=0.45, float_dtype=dtype, device=args.device
            )
            try:
                thr, _, mfu = _time_predict(
                    predict, batch, px, iters=args.iters, device=args.device
                )
            except torch.cuda.OutOfMemoryError as exc:
                print(f"| {px} | {batch} | FAILED: {type(exc).__name__} | |",
                      flush=True)
                continue
            print(f"| {px} | {batch} | {thr:,.0f} | {mfu_cell(mfu)} |", flush=True)
            if px not in best or thr > best[px][1]:
                best[px] = (batch, thr, mfu)
    print("\nbest:", {
        px: {"batch": b, "sb_per_s": round(t, 1),
             "mfu": round(m, 4) if m else None}
        for px, (b, t, m) in best.items()
    })


if __name__ == "__main__":
    main()
