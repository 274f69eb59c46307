"""Superblocks-per-dispatch sweep for the composed 4-level tree cascade.

The cascade (``examples._bench.bench_tree_cascade``) evaluates every
64->32->16->8 node of ``n`` superblocks resident on ``--device``, one predict
a level, so its per-level serving batches are n / 4n / 16n / 64n. This sweeps
``n`` and prints a markdown table of trees/s and MFU (the four levels'
operations per tree, counted from the layer shapes, over the card's dense
bf16 peak), then the best row as JSON. The numbers are the card's; on the
CPU the MFU column reads "not measured".

    python -m av1tpu_torch.examples.cascade_batch_sweep [--n 512 1024 2048] \
        [--iters 20] [--device cuda]

An ``n`` that does not fit on the card prints a FAILED row and the sweep goes
on; any other error stops it.
"""
import argparse
import json

import torch

from av1tpu_torch.examples._bench import (
    _build_models,
    bench_tree_cascade,
    describe_device,
    mfu_cell,
)
from av1tpu_torch.examples._common import add_device_arg, parse_example_args


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--n", type=int, nargs="+", default=[512, 1024, 2048])
    parser.add_argument("--iters", type=int, default=20)
    add_device_arg(parser)
    args = parse_example_args(parser, argv)

    dtype = torch.bfloat16
    models = _build_models(args.device)
    print(describe_device(args.device))
    print("| n (superblocks/dispatch) | trees/s | MFU |")
    print("|---|---|---|")
    results = []
    for n in args.n:
        try:
            r = bench_tree_cascade(
                models, dtype, n_superblocks=n, iters=args.iters, device=args.device
            )
        except torch.cuda.OutOfMemoryError as exc:
            print(f"| {n} | FAILED: {type(exc).__name__} | |", flush=True)
            continue
        results.append(r)
        print(f"| {n} | {r['trees_per_sec']:,.0f} | {mfu_cell(r['mfu'])} |", flush=True)
    print("\nbest:", json.dumps(
        max(results, key=lambda r: r["trees_per_sec"]) if results else None
    ))


if __name__ == "__main__":
    main()
