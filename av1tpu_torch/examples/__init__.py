"""The examples of the port: the JAX package's ``examples/`` scripts as
modules, each run with ``python -m av1tpu_torch.examples.<name>``.

    demo_e2e               synthetic blocks -> the four v6 stages trained through
                           ``train_stage`` -> the plain pipeline, calibrated
    tree_demo              per-size ladders on a ``tree_corpus`` -> calibration ->
                           ``predict_trees`` -> ``tree_accuracy`` (RESULTS.json)
    tta_eval               ``predict_trees`` over a tree_demo directory without
                           TTA, with the naive and with the swap-aligned mean
    unified_demo           the per-stage ladder against the unified model, plain
                           and distilled, and the folded serving throughput
    int8_selfcalib_ab      ``predict_trees --folded`` against ``--int8`` (and
                           the unified pair) on one clip: tree agreement
    scale_demo             the v6 ladder through every training and serving CLI
    scale_demo_extras      the AB ensemble, TTA and gated rows, operating points
                           and the v5 ladder on scale_demo's directory
    scale_demo_v5          the v5 ladder and its merged pipeline
    bench_ingest_to_trees  superblocks/s from a yuv file on disk to trees, disk
                           reads and tiling on a thread beside the device
    per_size_batch_sweep   blocks/s and MFU of the folded bf16 pipeline per block
                           size and serving batch
    cascade_batch_sweep    trees/s and MFU of the tree cascade, one predict a
                           level, per number of superblocks a dispatch

Each takes ``main(argv=None)`` and ``--device {cuda,cpu}`` (default ``cuda``,
passed on to every CLI and library call; nothing falls back to the CPU), and
writes under its output directory (the two sweeps only print). ``--fused-front`` (tree_demo,
unified_demo, int8_selfcalib_ab) is the folded pipelines' ``use_fused_front``:
K1 (``on``) or K2 (``g1``) at the 16 and 8 px blocks. The two sweeps time
with ``_bench.py``, the port's own copies of the ``bench.py`` helpers they
import (``_build_models``, ``_time_predict``, ``bench_tree_cascade``), whose
MFU counts each block's operations from the layer shapes; they print the
card's numbers, and "not measured" for MFU on the CPU.
"""
