#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``av1tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout. Phases, one JSON line each:
  1. device: ``nvidia-smi`` name and power limit, the torch device name;
  2. build: nvcc builds the kernels from ``av1tpu_torch/csrc``, one process
     per source, all started together; the registers, spill bytes and static
     shared memory ptxas reports for each fused kernel, and the count of its
     C75xx warnings (wgmmas it serialised);
  3. kernel checks, each kernel against its plain PyTorch version on the
     card, fp32 (TF32 off) and bf16, with the share of output elements that
     differ at all: K1 and K2 at 8 and 16 px on batches of 1, 255 and 4099
     and on a 4099-block view that starts one value into its buffer (off the
     16-byte grid of the bf16 kernels' loads); K5 at extents 2-16 (8-64 px
     blocks), batch 4099; K3a on three padded 1080p frames at bs 16
     and 64 and K3b on 4099 blocks (bit-exact); K4 forward for each
     activation at (4099, 512) x (512, 256), at a head's second layer
     (256, 8), at an unaligned (500, 250) that takes the general kernel and
     at K = 4096, with the fp32 error against a float64 product beside the
     library's (cuBLAS fp32), and K4 backward against float64 autograd;
  4. reference: the folded fp32 pipeline on the card (fronts off/on/g1, and
     K5 with fronts off/on) against the plain nn.Module pipeline on the CPU;
  5. the main paths, each driven with the launch counts set to 0 just
     before it and read just after, on a synthetic 65,536-block 16 px
     dataset and four seeded stage models (plus an FGVC AB model) at the
     published v6 widths:
       a. the port's ``run_pipeline_eval --variant v6 --folded --bf16
          --batch-size 4096`` with ``--fused-front off``, ``on``, ``g1`` and
          ``on --ab-fgvc`` (K1, K2);
       b. ``make_v6_pipeline_folded(..., use_pallas_groups=True)`` with
          fronts off and on, through ``run_pipeline_batched`` at batch 4096,
          bf16 (K5, K1);
       c. the ``av1tpu_torch.kernels`` API: K3a and K3b ingest of eight
          1080p frames, then three training steps of a two-layer head built
          from K4 on the stage-1 embeddings of 4096 blocks;
       d. the frame -> partition-tree cascade on a synthetic yuv420p10le clip
          of eight 1920x1080 frames (510 superblocks each), every level of
          64/32/16/8 px with its own seeded models: the port's
          ``predict_trees --folded --bf16 --frames-per-batch 4`` with
          ``--fused-front off`` (after a warm-up), ``on`` and ``g1``, the same
          with ``--unified``, one run with ``--level-capacity 1 0.75 0.38
          0.15`` (a group without overflow must agree with the dense run on
          99.9% of its slots), ``--int8 --fused-front on`` per-stage and
          ``--unified`` (K1 at 16 and 8 px on the int8 path), and
          ``predict_partition_trees`` with K5 predictors, fronts off and on
          (K1 and K2 at 16 and 8 px, K5 at every extent);
       then path a's second part (``a_serving``), on path a's dataset, bf16,
       batch 4096: ``optimize_thresholds`` on the stage-1 checkpoint (the
       calibration directory of what follows); ``--folded --capacity auto
       --capacity-margin 0.1`` and ``--folded --capacity 0.5`` (the gated
       pipeline: its overflow summed over batches; exactly the passers
       outside each batch's K rows are SPLIT, and every other row's label
       equals the ``off`` run's on 99.9%); ``--variant unified
       --folded --fused-front off|on|g1`` with path d's 16 px unified model
       (K1, K2); ``--tta`` and ``--stage3-ab-ensemble-dir`` (three seeded AB
       members saved with ``save_ensemble``) on the plain graph; then
       ``certify_serving`` in fp32, int8 rows included (its folded and
       unified(folded) rows agree with their plain graphs on 99%),
       ``compare_thresholds`` and ``analyze_confusion``, each of which must
       write its files; after it (phase ``stacking``, outside the path) the
       three members' logits on 4,096 of its blocks and the stacking
       meta-model fit on them on the card, whose objective must equal the
       CPU fit's within 1e-4 and fall below the starting weights';
       e. int8 serving (``quant.ptq``), calibrated on 512 train rows of path
          a's dataset drawn as the CLI draws them. First, outside the path:
          ``_int_mm`` on the card against the CPU's product at a group-1
          conv, an SMM conv and two head layers (exact); a stage and a
          unified model quantized on the CPU and moved to the card, their
          per-site int8 activations, logits and labels against the CPU's, in
          fp32 and bf16; K1's launches per predict (4 per-stage, 1 unified,
          none without the fused front), K1-on labels against K1-off labels,
          int8 labels and stage-1 probabilities against the folded fp32
          pipeline, the seconds calibration and quantization take, and the
          per-stage pipeline at 8 px with K1. Then the path: the port's
          ``run_pipeline_eval --int8`` per-stage and ``--variant unified``,
          fp32 and ``--bf16``, ``--fused-front off`` and ``on``;
       f. v5 and flatten serving (plain module forwards, as in the JAX
          package: no port kernel may launch) on a 65,536-block 16 px dataset
          with raw labels 0..9 and a QP drawn per block, batch 4096: the port's
          ``run_pipeline_eval --variant v5`` (base 32; a warm-up run first,
          and one before flatten too) with ``--bf16``, which
          still serves fp32, and with ``--available-specialists RECT`` (the
          AB and 1TO4 fallbacks), a QP-conditioned v5 model from a ``.pt``
          fed the bundle's QPs, and ``--variant flatten`` (path a's stage 1
          and a seeded ``Stage2FlatModel`` at ResNet-18 widths) in fp32 and
          ``--bf16``. Each run's first 4,096 labels are held against the same
          CLI on the CPU in fp32: equal wherever the decision margin exceeds
          1e-3 (stage-1 probabilities within 1e-4); the bf16 flatten run's
          labels on at least the share the CPU's own bf16 run reaches, less
          0.02. Then (``f_reference_pt``) path a's ``--folded --bf16
          --fused-front on`` from reference-shaped ``.pt`` files of the same
          four stage models, whose labels and probabilities must equal path
          a's npz run's;
       g. training (``train_stage1`` / ``train_stage2``, which launch no port
          kernel: the JAX training path calls no Pallas kernel) on
          ``reference_shaped_corpus(0, 16, scale=0.125)`` (45,271 train and
          11,349 val blocks in the documented class mix) written with
          ``save_split``: ``train_stage1 --epochs 2 --batch-size 256`` in fp32
          (cuDNN's deterministic algorithms) and ``--bf16``, then
          ``train_stage2 --stage1-checkpoint ... --freeze-epochs 1 --epochs 2``
          (the frozen and the unfrozen ULMFiT phase); outside the counts, a
          ``train_stage`` stopped after epoch 0 and resumed from
          ``stage1_last``, whose final state must equal the uninterrupted CLI
          run's bitwise, and one step of the trained stage-1 and stage-2
          models on the card against the same step on the CPU (fp32: loss
          1e-5 rel, BN statistics 1e-5; the card's fp32 gradients and its
          float64 ones within 1e-4 of each tensor's largest entry from the
          CPU's float64 step made with the card's ReLU masks and max
          choices; the same step with TF32 on, a control, must miss that
          bound: ``check_step_pair``); then
          (``g_serving``) the two exports with path a's stage-3 models served
          by ``run_pipeline_eval --folded --bf16 --fused-front off|on|g1`` on
          the corpus's val split (K1, K2); then the step ms at batch 256 and
          4096, fp32 and bf16 (ABBA turns), kernels, host launch calls, busy
          ms and idle share per step, resident and streaming epoch
          samples/s, and the seconds of a verified ``save_checkpoint``;
       h. the rest of training on path g's corpus, which launches no port
          kernel either: ``prepare_stage3 --ensemble-members 2`` (RECT 8,922
          train / 2,237 val blocks; AB 7,160 / 1,795, oversampled to 11,800),
          then through the CLIs at batch 256: ``train_stage3 --head RECT
          --epochs 2`` from path g's stage-2 export (5 frozen epochs and 1
          unfrozen), the same with ``--noise-ratio 0.25``, ``--head AB --fgvc
          --batch-size 128``, ``--head AB --ensemble 2``, ``--variant v5
          --head AB --epochs 1`` from scratch, ``train_stage2_flat
          --freeze-epochs 1 --epochs 2`` on the corpus's flatten split,
          ``train_unified --epochs 2`` and ``train_unified --distill-weight
          0.5 --epochs 1`` (teachers: path g's stage 1 and 2, this path's RECT
          and FGVC); outside the counts, one fp32 step of the trained FGVC model
          (CutMix, center loss, the clipped AdamW over model and centers) and
          of the distilled unified model on the card against the CPU with the
          same draws, held as path g's; then
          (``h_serving``) the fully trained ladder served ``--folded --bf16
          --fused-front off|on|g1 --ab-fgvc`` (K1, K2 at three folded stages a
          batch), the trained unified model ``--variant unified --folded
          --fused-front off|on|g1`` (K1, K2) and the trained ensemble through
          ``--stage3-ab-ensemble-dir``; then the step ms, kernels, host launch
          calls, busy ms and idle share of the FGVC step at batch 128 and the
          unified step at 256;
       i. the data layer on the card's machine, inside the port's
          ``utils.profiling.trace`` (a ``torch.profiler`` trace of the path,
          then ``device_memory_stats()``): six 1920x1080 frames rendered
          by ``synth_tree.render_superblocks`` from ``sample_trees`` (one tree
          per 64 px superblock) written as a yuv420p10le clip, with one
          ``partition_frame_<n>.txt`` dump per frame naming every reached
          node of its trees at 64/32/16/8 px that lies inside the frame (its
          mode, a QP drawn per block); ``make -C native`` builds the C++
          reader (a failed build fails the path); the port's ``prepare_data
          --formats reference npz`` once with the native reader and once
          with numpy: byte-equal outputs (npz by members), blocks per size
          equal to the trees' in-frame nodes; ``prepare_dataset --variant v6
          --block-size 64 32 16 8`` from the reference layout and from the
          npz: equal bundles; then ``run_pipeline_eval --variant v6 --folded
          --batch-size 4096 --fused-front off|on|g1`` on the 16 and 8 px
          datasets with path d's models of that size, bf16 (after a warm-up)
          and fp32 (K1, K2 at both sizes): an fp32 front's labels equal the
          fp32 ``off`` run's on 99.9%, a bf16 front's agree with the fp32
          ``off`` run's at least as well as the bf16 ``off`` run's do (less
          three standard errors), each beside path a's agreement of ``on``
          and ``g1`` with ``off``;
       j. several processes (``parallel.mesh``) on the one card, each rank
          a process started by ``torch.multiprocessing`` that meets the
          others over a ``FileStore``; NCCL refuses two ranks on one
          device, so: j1 a world of one over NCCL serves path a's models
          through ``make_mesh(num_data=1)`` with ``g1`` (K2), labels and
          probabilities bitwise path a's ``g1`` run's; j2 two ranks over
          gloo serve path a's blocks through ``run_pipeline_eval``'s default
          mesh (data 2) after a warm-up, ``on`` and ``g1`` (K1, K2 in each
          rank), labels bitwise path a's; path d's clip through
          ``predict_trees --level-capacity`` (trees bitwise path d's gated
          run's) and four frames through K5 + K1 predictors with the same
          capacities (K5 in each rank; trees bitwise one process's); j3 the
          two ranks take 20 stage-1 steps at batch 256 on path g's corpus
          (data 2, deterministic cuDNN; ranks bitwise equal, the divergence
          from one process over the same global batches emitted) and one
          data-2 and one model-2 step, each held to one process at path g's
          step tolerances; every rank's launch counts are summed into the
          ``kernels`` line;
       k. the port's examples (``av1tpu_torch/examples``), each through its
          ``main`` at the published widths with corpora and epochs cut:
          k1 ``demo_e2e`` (its default three epochs: its own gate wants a
          pipeline accuracy above 0.5); k2 ``tree_demo`` at every size on one
          1280x768 val frame and 1,500 train superblocks, batch 64, two
          epochs for stage 1, three for stage 2 (one frozen), one for stage
          3, ``--calibrate --folded --fused-front g1`` (K2), then ``--resume
          --fused-front on`` (K1), its trees held as path d's (a root on every
          tree, mean nodes in (2, 60)) with their ``tree_accuracy`` and the
          share of slots ``on`` and ``g1`` agree on, then ``tta_eval
          --configs none tta_aligned`` over its directory; k3
          ``int8_selfcalib_ab`` on k2's 16 px models, two frames,
          ``--fused-front on`` (K1; the folded and int8 trees' agreement is
          emitted, not held); k5 ``scale_demo``, ``scale_demo_extras`` and
          ``scale_demo_v5`` at corpus scale 0.01, one epoch a stage; k4
          ``unified_demo --ladder`` on k5's ladder with ``--fused-front g1``
          (K2) and its folded throughput at batch 4096; k6
          ``bench_ingest_to_trees --frames 8``. Each must write its results
          file; its numbers are emitted;
       l. the JAX package's last library options, on path a's blocks and
          models at batch 4096: l1 ``make_v6_pipeline(stacked=True)`` (the
          four backbones as one ``torch.func.vmap`` forward) against the
          unstacked pipeline in fp32 (TF32 off) and bf16: labels equal
          wherever every decision's margin exceeds 1e-3 (fp32) or 0.1
          (bf16), stage-1 probabilities within 1e-5 (0.02), with each
          pipeline's kernels, host launch calls, device busy ms, device ms
          (CUDA graph) and predict ms; l2 ``quantize_stage(lowering=
          "im2col")`` beside the hybrid default at 16 px (path a's stage 2)
          and 8 px (path d's 8 px stage 2 on the top-left 8 x 8 of path a's
          blocks), bf16, K1 attached: each within 0.08 of the float logits'
          scale of the fp32 folded forward and of each other, on average,
          the label agreement, K1's launches, the im2col model serving the
          other block size with K1 rebuilt for it (the hybrid model must
          refuse); l3 ``run_pipeline_batched`` with the folded ``g1`` predict
          (K2) on a ``np.memmap`` of the 65,536 blocks, ``prefetch`` 0, 2
          and 4 in turns: outputs bitwise equal, the wall ms of each, and
          the producer's staging of one batch (host ms) beside its copy on
          the side stream (H2D ms) and the predict's ms;
       m. the two sweep examples on the port's bench helpers
          (``av1tpu_torch/examples/_bench.py``), bf16, folded, four seeded
          stage models at the published widths: m1 ``per_size_batch_sweep``
          at its default grid (16 cells: 8 px at 8,192-65,536 blocks down to
          64 px at 256-2,048) and m2 ``cascade_batch_sweep`` at n = 512, 1,024
          and 2,048 superblocks, one predict a level, each through its
          ``main`` at its default ``--iters 20``: every row present, none
          FAILED, blocks/s or trees/s above 0 and MFU in (0, 1], no port
          kernel launched; m3 the kernels through the helpers' own
          parameters: ``_time_predict`` with ``use_fused_front="g1"`` (K2) at
          8 and 16 px and ``use_pallas_groups=True`` (K5) at 32 and 64 px,
          each at m1's best batch, ``bench_tree_cascade`` with K5 at 64 and
          32 px and K2 at 16 and 8 px at n = 512, and that cascade's modes at
          every level beside the ``off`` cascade's (the shares of equal modes
          are emitted, not held: the weights are uncalibrated draws); K2 and
          K5 launch exactly as many times as ``m_predicted_launches`` says;
          then, outside the counted run, K2 and K5 against their plain
          versions at every row count m3 gave them, on m3's own inputs and
          each stage's weights (bf16, ``BF16_REL_TOL``), and each kernel
          predict's stage-1 probabilities beside ``off``'s on its cell's
          blocks (emitted);
     each run prints blocks/s (or frames/s and superblocks/s), its launches,
     and its agreement with its path's ``off`` run;
  6. predict: the CUDA-event time of one 4,096-block bf16 predict on a
     batch already on the card, for fronts off / on / g1, K5 with fronts
     off / on and the gated pipeline at path a's ``auto`` capacity and at
     0.5, in ABC...CBA turns, and from a ``torch.profiler`` trace the
     kernels launched per predict, the device's busy time and idle share;
     then int8 (bf16) with K1 off and on beside the folded ``off``; then
     path f's pipelines (v5 and the QP-conditioned v5 in fp32, flatten in
     fp32 and bf16), which must launch no port kernel; then the
     same per level of the cascade for one group of four frames
     (``cascade_level``: per-stage off / g1 / K5+K1 and unified g1);
  7. timing: each kernel, its plain version and, for K4, one library call
     (``torch.addmm`` + ``relu_``) in turns at the main paths' shapes, K1 and
     K2 also at 8 px, K4 in fp32 and bf16, K5 at all four extents and at the
     cascade's 64 and 32 px rows (extent 16 x 510 and 2,040, extent 8 x
     2,040). ``ms`` is
     device time: the calls are captured in a CUDA graph and the graph is
     replayed, so Python's
     per-call overhead (larger than K4's run time) stays out; ``eager_ms``
     is the same call launched from Python. ``bound_ms`` is the least time
     the card could take: the larger of the bytes (each input read once,
     each output written once) over 3.35 TB/s and the operations over the
     peak for the input type (989 TFLOP/s bf16 on the tensor cores,
     67 TFLOP/s fp32); a convolution's operations count the taps that fall
     inside its input only, as the sweeps' MFU does
     (``examples/_bench.backbone_flops``).
Then the card's ``nvidia-smi`` line, a ``{"kernels": [...]}`` line, and as the
last line ``{"ok": true, "device": {...}}``. Any failed phase raises and the
script exits non-zero; without a CUDA device it fails before printing.
"""
from __future__ import annotations

import ast
import contextlib
import copy
import functools
import io
import itertools
import json
import math
import re
import shutil
import subprocess
import sys
import time
import types
import zipfile
from dataclasses import replace
from pathlib import Path
from typing import Callable, NamedTuple, Optional
from unittest import mock

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing  # noqa: F401  (spawn_ranks)
import torch.nn.functional as F
from torch import nn
from torch.overrides import TorchFunctionMode

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

from av1tpu_torch.cli import (  # noqa: E402
    analyze_confusion,
    certify_serving,
    compare_thresholds,
    optimize_thresholds,
    predict_trees,
    prepare_data,
    prepare_dataset,
    prepare_stage3,
    run_pipeline_eval,
    train_stage1,
    train_stage2,
    train_stage2_flat,
    train_stage3,
    train_unified,
)
from av1tpu_torch.codec.partitions import BSIZE_INDEX_TO_PIXELS, map_to_stage2_v6  # noqa: E402
from av1tpu_torch.codec.tree import LEVEL_OFFSETS, LEVEL_SIZES, NODES_PER_LEVEL  # noqa: E402
from av1tpu_torch.data.bundles import (  # noqa: E402
    Bundle,
    build_flatten_bundle,
    build_v6_bundle,
    class_counts,
    save_split,
)
from av1tpu_torch.data.records import BlockSet  # noqa: E402
from av1tpu_torch.data.sampling import host_shard  # noqa: E402
from av1tpu_torch.data.synth import reference_shaped_corpus  # noqa: E402
from av1tpu_torch.data.synth_tree import (  # noqa: E402
    _node_origin,
    render_superblocks,
    sample_trees,
)
from av1tpu_torch.eval import (  # noqa: E402
    PipelineModels,
    make_flatten_pipeline,
    make_unified_pipeline,
    make_unified_pipeline_folded,
    make_v5_pipeline,
    make_v6_pipeline,
    make_v6_pipeline_folded,
    make_v6_pipeline_gated,
    predict_partition_trees,
    quad_tile_on_device,
    fit_stacking,
    load_ensemble,
    run_pipeline_batched,
    save_ensemble,
    stacked_member_logits,
    v6_route,
)
from av1tpu_torch.eval.ensemble import _stacking_features, _stacking_objective  # noqa: E402
from av1tpu_torch.eval.hierarchy import on_device  # noqa: E402
from av1tpu_torch.examples import _bench as bench_helpers  # noqa: E402
from av1tpu_torch.examples import (  # noqa: E402
    bench_ingest_to_trees,
    cascade_batch_sweep,
    demo_e2e,
    int8_selfcalib_ab,
    per_size_batch_sweep,
    scale_demo,
    scale_demo_extras,
    scale_demo_v5,
    tree_demo,
    tta_eval,
    unified_demo,
)
from av1tpu_torch.ingest import (  # noqa: E402
    Yuv420p10Geometry,
    etl,
    native,
    read_y_frames_batch,
    tile_frames,
)
from av1tpu_torch.kernels import _build  # noqa: E402
from av1tpu_torch.kernels import fused_front as ff  # noqa: E402
from av1tpu_torch.kernels import preprocess as pp  # noqa: E402
from av1tpu_torch.kernels import resnet_group as rg  # noqa: E402
from av1tpu_torch.kernels.fused_dense import (  # noqa: E402
    ACTS,
    fused_dense,
    fused_dense_reference,
    takes_fast_path,
)
from av1tpu_torch.models import (  # noqa: E402
    FGVCModel,
    HierarchicalModel,
    Stage1Model,
    Stage2FlatModel,
    Stage2Model,
    Stage3ABModel,
    Stage3RectModel,
    UnifiedV6Model,
    load_jax_variables,
    split_unified_logits,
    to_jax_variables,
)
from av1tpu_torch.cli.common import load_model, train_calibration_blocks  # noqa: E402
from av1tpu_torch.parallel.mesh import (  # noqa: E402
    ColumnParallel,
    make_mesh,
    place_params,
    shard_batch,
)
from av1tpu_torch.quant import ptq  # noqa: E402
from av1tpu_torch.quant.ptq import (  # noqa: E402
    fold_backbone,
    make_unified_pipeline_int8,
    make_v6_pipeline_int8,
)
from av1tpu_torch.train.checkpoint import (  # noqa: E402
    load_variables_npz,
    save_checkpoint,
    save_variables_npz,
    states_equal,
)
from av1tpu_torch.train import trainer  # noqa: E402
from av1tpu_torch.train.augment import apply_pipeline, draw_pipeline  # noqa: E402
from av1tpu_torch.train.fgvc_step import (  # noqa: E402
    fgvc_draws,
    fgvc_loss,
    make_fgvc_train_step,
)
from av1tpu_torch.train.losses import (  # noqa: E402
    binary_focal_loss,
    class_balanced_focal_loss,
)
from av1tpu_torch.train.schedules import (  # noqa: E402
    TrainOptimizer,
    adamw,
    as_optimizer,
    cosine_schedule,
    ulmfit_phase2,
)
from av1tpu_torch.train.stages import stage1_recipe, train_stage  # noqa: E402
from av1tpu_torch.train.trainer import (  # noqa: E402
    StepConfig,
    TrainState,
    make_train_step,
    run_train_epoch,
    run_train_epoch_resident,
    to_device,
)
from av1tpu_torch.utils import profiling  # noqa: E402
from av1tpu_torch.train.unified import (  # noqa: E402
    UNIFIED_NOISE_ONLY,
    compute_teacher_logits,
    make_unified_loss,
    make_unified_predictions,
    pack_unified_labels,
    unified_metric_labels,
    unified_recipe,
)

SEED = 0
N_VAL = 65536
HW = 16
BATCH = 4096
RAGGED = 4099
THRESHOLD = 0.45
FRAMES = (8, 1080, 1920)  # eight 1080p luma frames
HEAD = (512, 256, 8)      # a v6 head's widths: embedding, hidden, classes
FP32_TOL = {"fused_front": 1e-5, "fused_front_g1": 5e-5}  # absolute
FP32_REL_TOL = {"fused_group12": 2e-5, "fused_dense": 1e-5}  # of max(1, max|plain|)
BF16_REL_TOL = 1e-2  # of max(1, max|plain|): ~1 bf16 ulp of the largest output
GRAD_RTOL = 1e-3  # K4 backward against float64 autograd (tests/test_kernels.py)
# dW is a torch fp32 product over 4099 rows in either path: at entries near 0
# that sum alone is up to 2.4e-4 from float64 (`atol_needed` below prints it)
GRAD_ATOL = {"x": 1e-4, "w": 5e-4, "b": 1e-4}
# Published peaks of an H100 SXM (NVIDIA's data sheet, dense rates)
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
FORBIDDEN_MODULES = ("jax", "flax", "optax", "av1tpu", "bench")  # the port imports none
# Path d: the tree cascade on a clip of eight 1080p frames, four frames a group
CLIP = (8, 1080, 1920)
FRAME_SBS = 17 * 30       # 64 px superblocks of one padded 1080p frame
FRAMES_PER_BATCH = 4
LEVEL_CAPACITY = (1.0, 0.75, 0.38, 0.15)
# The share of blocks on which each level's gate opens and its stage 2 says
# SPLIT, chosen so that about 54% / 24% / 8% of the 32 / 16 / 8 px nodes are
# alive and LEVEL_CAPACITY covers them.
GATE_SHARE = 0.9
SPLIT_SHARE = {64: 0.6, 32: 0.5, 16: 0.37, 8: 0.3}
RECT_SHARE, AB_SHARE = 0.5, 0.3  # HORZ among the RECT pair, HORZ_A among the AB four
STAGE_CKPT = {"stage1": "stage1", "stage2": "stage2", "rect": "stage3_rect",
              "ab": "stage3_ab"}
STAGE_CLASSES = {"stage1": Stage1Model, "stage2": Stage2Model,
                 "rect": Stage3RectModel, "ab": Stage3ABModel}
# Rows of one kernel call when one and four frames go through the cascade at
# batch 4096: whole levels, full chunks and the tails they leave. By K5's
# extent (block px / 4); K1 and K2 see the 16 and 8 px rows.
CASCADE_ROWS = {16: (510, 2040), 8: (2040, 4096, 4064), 4: (4096, 4064, 3968),
                2: (4096, 3968, 3584)}
WORK = ROOT / "build" / "chip_smoke"
FRONT_KERNELS = {"on": ["fused_front"], "g1": ["fused_front_g1"]}  # by --fused-front
CAPACITY_MARGIN = 0.1     # --capacity auto's headroom over the calibrated gate rate
ENSEMBLE_MEMBERS = 3      # seeded AB members of --stage3-ab-ensemble-dir
N_TRAIN = 4096            # train rows of path a's dataset: int8 calibration draws from them
INT8_CALIB = 512          # --calib-samples' default
# The int8 graph on the card against the same model on the CPU, held to the
# bounds tests/test_torch_port_int8.py holds the two packages to: the least
# share of equal int8 activations at a site, the share of equal labels, and
# the largest margin at which a label may differ (int8 noise: a flipped
# activation spreads).
INT8_SITE_SHARE, INT8_LABEL_SHARE, INT8_MARGIN = 0.98, 0.97, 0.25
# Path f: v5 and flatten serving. Its card runs are held against the same CLI
# on the CPU over the first N_CPU_REF blocks, fp32. A bf16 run is far from
# fp32 on these random ResNets (on an H100 the plain bf16 flatten graph moved
# 8% of the labels off the CPU's fp32 run, as the CPU's own bf16 graph did),
# so its labels must equal the CPU fp32 run's on at least the share that the
# CPU's own bf16 run does, less BF16_SLACK.
N_CPU_REF = 4096
BF16_SLACK = 0.02
# First-decision shares of path f's heads on probe blocks: the gate opens,
# stage 2 (v5: NONE) or the flatten class 0 (NONE) wins, the specialist's class 0
F_SHARES = {"stage1": 0.8, "stage2": 0.3, "specialist": 0.5, "flat": 0.3}
V5_HEADS = ("RECT", "AB", "1TO4")
KERNELS = {  # name: (source, the TPU kernel it replaces)
    "fused_front": ("av1tpu_torch/csrc/fused_front.cu",
                    "av1tpu/kernels/fused_front.py:105"),
    "fused_front_g1": ("av1tpu_torch/csrc/fused_front.cu",
                       "av1tpu/kernels/fused_front.py:212"),
    "tile_normalize_frames": ("av1tpu_torch/csrc/preprocess.cu",
                              "av1tpu/kernels/preprocess.py:53"),
    "normalize_blocks": ("av1tpu_torch/csrc/preprocess.cu",
                         "av1tpu/kernels/preprocess.py:102"),
    "fused_dense": ("av1tpu_torch/csrc/fused_dense.cu",
                    "av1tpu/kernels/fused_dense.py:59"),
    "fused_group12": ("av1tpu_torch/csrc/resnet_group.cu",
                      "av1tpu/kernels/resnet_group.py:162"),
}


T0 = time.perf_counter()


def emit(phase: str, **fields) -> None:
    """One JSON line: the phase, its fields and the script's elapsed seconds."""
    print(json.dumps({"phase": phase, **fields, "t": time.perf_counter() - T0}), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def seeded_model(cls, gen: torch.Generator, calib: torch.Tensor,
                 device="cpu") -> nn.Module:
    """A model on the CPU drawn from ``gen``: lecun-normal weights, BN running
    stats set to a calibration batch's statistics (the forward that takes
    them runs on ``device``) and then perturbed, so that the logits depend on
    the input."""
    model = cls()
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, (nn.Conv2d, nn.Linear)):
                fan_in = mod.weight[0].numel()
                mod.weight.copy_(torch.randn(mod.weight.shape, generator=gen)
                                 / math.sqrt(fan_in))
                if mod.bias is not None:
                    mod.bias.zero_()
            elif isinstance(mod, nn.modules.batchnorm._BatchNorm):
                mod.weight.fill_(1.0)
                mod.bias.zero_()
                mod.reset_running_stats()
                mod.momentum = None  # running stats = the batch's own
        if hasattr(model, "classifier"):
            model.classifier.weight.copy_(
                torch.randn(model.classifier.weight.shape, generator=gen))
        model.to(device).train()
        model(calib.to(device))
        model.cpu().eval()
        for mod in model.modules():
            if isinstance(mod, nn.modules.batchnorm._BatchNorm):
                std = mod.running_var.sqrt()
                mod.running_mean += 0.2 * std * torch.randn(std.shape, generator=gen)
                mod.running_var *= 0.5 + torch.rand(std.shape, generator=gen)
    return model


def codes(rng: np.random.Generator, shape) -> np.ndarray:
    """Uniform 10-bit codes as uint16."""
    return rng.integers(0, 1024, size=shape, dtype=np.uint16)


def structured_luma(rng: np.random.Generator, shape) -> np.ndarray:
    """uint16 luma planes ``(..., H, W)`` (multiples of 16) with structure at
    every scale of the 64->32->16->8 hierarchy: a random level per 16 px cell
    plus noise whose amplitude is drawn per 8 px cell, so that blocks of every
    size differ from their neighbours in brightness and in texture."""
    *lead, h, w = shape
    level = np.kron(rng.uniform(100, 900, (*lead, h // 16, w // 16)), np.ones((16, 16)))
    amp = np.kron(rng.uniform(0, 250, (*lead, h // 8, w // 8)), np.ones((8, 8)))
    noisy = level + amp * rng.standard_normal(level.shape, dtype=np.float32)
    return np.clip(noisy, 0, 1023).astype(np.uint16)


def set_first_class_share(head: nn.Module, logits: np.ndarray, share: float) -> np.ndarray:
    """Shift the bias of an ``MLPHead``'s last Linear in place so that, on the
    probe blocks that gave ``logits``, the share ``share`` takes the first
    decision: the stage-1 gate opens (``(N,)`` logits, against ``THRESHOLD``)
    or class 0, SPLIT for stage 2, wins the argmax (``(N, C)``). Returns the
    shifted logits. A random head takes one decision on every input; a cascade
    needs its SPLIT decisions to vary with the block."""
    logits = np.asarray(logits, np.float64)
    shift = np.zeros(head.head[-1].bias.shape[0])
    if logits.ndim == 1:
        shift[0] = math.log(THRESHOLD / (1 - THRESHOLD)) - np.quantile(logits, 1 - share)
    else:
        shift[0] = np.quantile(logits[:, 1:].max(axis=1) - logits[:, 0], share)
    with torch.no_grad():
        head.head[-1].bias += torch.as_tensor(shift, dtype=torch.float32)
    return logits + (shift[0] if logits.ndim == 1 else shift)


def host_tile(frames: np.ndarray, bs: int) -> np.ndarray:
    """(F, H, W) -> (F*R*C, bs, bs, 1), frame-major then row-major."""
    f, h, w = frames.shape
    x = frames.reshape(f, h // bs, bs, w // bs, bs).transpose(0, 1, 3, 2, 4)
    return np.ascontiguousarray(x.reshape(-1, bs, bs, 1))


def time_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    """Per-call time of ``fn`` launched from Python (CUDA events)."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters: int = 20, replays: int = 5) -> float:
    """Per-call device time of ``fn``: ``iters`` calls captured in a CUDA
    graph, the graph replayed ``replays`` times between two events."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm up off the default stream
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (iters * replays)


def tensor_bytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(n_bytes: int, flops: float, dtype) -> tuple:
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    operations over the peak rate for ``dtype``."""
    by_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    by_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def front_flops(hw: int, with_g1: bool) -> float:
    """Per sample: K1's 7x7/2 stem conv on ``hw`` px, and with K2 layer group 1
    and SE1 at extent hw/4; valid taps only (``_bench.backbone_flops``, the
    sweeps' count; biases, pooling and gates are not counted)."""
    parts = bench_helpers.backbone_flops(hw)
    return float(parts["stem"] + (parts["layer1"] + parts["se1"] if with_g1 else 0))


def group12_flops(e: int) -> float:
    """Per sample: K5's layer groups 1 and 2 and their SE products at input
    extent ``e`` (the blocks of 4e px), valid taps only, as ``front_flops``."""
    parts = bench_helpers.backbone_flops(4 * e)
    return float(sum(parts[k] for k in ("layer1", "se1", "layer2", "se2")))


# ---------------------------------------------------------------------------
# Phase 3: every kernel against its plain version
# ---------------------------------------------------------------------------


def compare(name, got, want, tol, **fields) -> float:
    """Max |got - want|, emitted; raises above ``tol``."""
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"{name}: {got.shape}/{got.dtype} "
                             f"vs {want.shape}/{want.dtype}")
    diff = (got.float() - want.float()).abs()
    err = diff.max().item()
    scale = want.float().abs().max().item()
    emit("kernel_check", kernel=name, max_abs_err=err, tol=tol,
         max_abs_out=scale, share_differing=(diff > 0).float().mean().item(), **fields)
    if not (err <= tol and math.isfinite(scale)):
        raise AssertionError(f"{name} {fields}: err {err} > {tol}")
    return err


def rel_tol(name, dtype, want) -> float:
    rel = FP32_REL_TOL[name] if dtype == torch.float32 else BF16_REL_TOL
    return rel * max(1.0, want.float().abs().max().item())


def front_args(name, folded, dtype, dev):
    if name == "fused_front":
        w, b = ff.stem_weights(folded["stem"]["weight"], folded["stem"]["bias"], dtype)
        return ff.fused_front, ff.fused_front_reference, (w.to(dev), b.to(dev))
    args = tuple(a.to(dev) for a in ff.g1_weights(folded, dtype))
    return ff.fused_front_g1, ff.fused_front_g1_reference, args


def stem_pool(folded, img: torch.Tensor, dev) -> torch.Tensor:
    """K5's input: the fp32 stem + pool of the normalized blocks ``img``."""
    stem = ff.stem_weights(folded["stem"]["weight"], folded["stem"]["bias"],
                           torch.float32)
    return ff.fused_front_reference(img.to(dev), *(t.to(dev) for t in stem))


def stem_output(folded, gen, n, hw, dev) -> torch.Tensor:
    """K5's input for ``n`` random ``hw`` px blocks."""
    img = torch.randint(0, 1024, (n, hw, hw, 1), generator=gen).float() / 1023.0
    return stem_pool(folded, img, dev)


def check_kernels(folded, gen, dev) -> dict:
    """Each kernel against its plain version on the card; returns the max
    error per kernel at its main path's shape and dtype."""
    errors = {}
    bf16, f32 = torch.bfloat16, torch.float32
    for hw in (8, 16):  # K1, K2
        size = hw * hw
        u16 = torch.randint(0, 1024, (RAGGED, hw, hw, 1), generator=gen).view(-1)
        u16 = torch.cat([u16, u16[:1]])  # one value more, for the view that starts at 1
        for dtype in (f32, bf16):
            flat = (u16.float() / 1023.0).to(dev, dtype)
            views = [(batch, "aligned", flat[:batch * size]) for batch in (1, 255, RAGGED)]
            views.append((RAGGED, "offset_by_one", flat[1:]))
            for (batch, layout, view), name in itertools.product(
                    views, ("fused_front", "fused_front_g1")):
                x = view.view(batch, hw, hw, 1)
                kern, plain, args = front_args(name, folded, dtype, dev)
                got = kern(x, *args)
                torch.cuda.synchronize()
                want = plain(x, *args)
                tol = (FP32_TOL[name] if dtype == f32
                       else BF16_REL_TOL * max(1.0, want.float().abs().max().item()))
                err = compare(name, got, want, tol, hw=hw, batch=batch, layout=layout,
                              dtype=str(dtype))
                if (hw, dtype, batch, layout) == (HW, bf16, RAGGED, "aligned"):
                    errors[name] = err

    for e in rg.EXTENTS:  # K5 on the stem's output of 4e px blocks
        x32 = stem_output(folded, gen, RAGGED, 4 * e, dev)
        for dtype in (f32, bf16):
            x = x32.to(dtype)
            w = tuple(t.to(dev) for t in rg.pack_group12_weights(folded, dtype))
            stream = rg.group12_conv_stream(w) if dtype == bf16 else None
            got = rg.fused_group12(x, w, stream)
            torch.cuda.synchronize()
            want = rg.fused_group12_reference(x, w)
            err = compare("fused_group12", got, want, rel_tol("fused_group12", dtype, want),
                          extent=e, batch=RAGGED, dtype=str(dtype))
            if e == HW // 4 and dtype == bf16:
                errors["fused_group12"] = err

    rng = np.random.default_rng(SEED)
    frames = torch.from_numpy(pp.pad_frames(codes(rng, (3,) + FRAMES[1:]), 64)).to(dev)
    blocks = torch.from_numpy(codes(rng, (RAGGED, HW, HW, 1))).to(dev)
    for dtype in (f32, bf16):  # K3a, K3b: bit-exact
        for bs in (16, 64):
            got = pp.tile_normalize_frames(frames, bs, dtype)
            torch.cuda.synchronize()
            err = compare("tile_normalize_frames", got,
                          pp.tile_normalize_reference(frames, bs, dtype), 0.0,
                          block_size=bs, frames=list(frames.shape), dtype=str(dtype))
            if bs == HW and dtype == bf16:
                errors["tile_normalize_frames"] = err
        for layout, b in (("aligned", blocks), ("offset_by_one", blocks.view(-1)[1:])):
            got = pp.normalize_blocks(b, dtype)
            torch.cuda.synchronize()
            err = compare("normalize_blocks", got, pp.normalize_blocks_reference(b, dtype),
                          0.0, shape=list(b.shape), layout=layout, dtype=str(dtype))
            if layout == "aligned" and dtype == bf16:
                errors["normalize_blocks"] = err

    # K4 forward, ragged M: a head's two layers (tensor-core kernel; the
    # second is 8 columns of a 64-wide tile), a (K, N) off the 16-byte rows
    # (general kernel), and a long K
    d_in, d_hid, d_out = HEAD
    for k, n, acts in ((d_in, d_hid, ("linear", "relu", "silu", "sigmoid")),
                       (d_hid, d_out, ("linear",)),
                       (500, 250, ("linear", "relu", "silu", "sigmoid")),
                       (4096, d_hid, ("linear",))):
        shape = (RAGGED, k, n)
        cpu = (torch.randn(RAGGED, k, generator=gen),
               torch.randn(k, n, generator=gen) / math.sqrt(k),
               torch.randn(n, generator=gen))
        if shape == (RAGGED, d_in, d_hid):
            data = cpu  # the backward check below reuses it
        for dtype in (f32, bf16):
            x, w = cpu[0].to(dev, dtype), cpu[1].to(dev, dtype)
            b = cpu[2].to(dev)
            fast = takes_fast_path(x, w)
            if fast != (k % 8 == 0 and n % 8 == 0):
                raise AssertionError(f"fused_dense {shape}: fast path {fast}")
            for act in acts:
                got = fused_dense(x, w, b, act)
                torch.cuda.synchronize()
                want = fused_dense_reference(x, w, b, act)
                err = compare("fused_dense", got, want,
                              rel_tol("fused_dense", dtype, want), shape=list(shape),
                              act=act, dtype=str(dtype), tensor_cores=fast)
                if act == "relu" and dtype == f32 and k == d_in:
                    errors["fused_dense"] = err
                if act == "linear" and dtype == f32:
                    # both against a float64 product; `want` is cuBLAS fp32
                    exact = x.double() @ w.double() + b.double()
                    ours = (got.double() - exact).abs().max().item()
                    library = (want.double() - exact).abs().max().item()
                    emit("kernel_check", kernel="fused_dense_vs_float64",
                         shape=list(shape), tensor_cores=fast, max_abs_err=ours,
                         library_max_abs_err=library,
                         max_abs_out=exact.abs().max().item())
                    if fast and k == d_in and ours > library:
                        raise AssertionError(
                            f"fused_dense fp32 {shape}: {ours} from float64, "
                            f"the library {library}")
    # K4 backward: the custom VJP, and autograd through the plain version
    # beside it, against float64 autograd, on two draws of the head's first
    # layer. `atol_needed` is the least atol with which each would pass at
    # GRAD_RTOL, and `between_atol_needed` what holding one to the other needs.
    second = torch.Generator().manual_seed(SEED + 4)
    draws = (data, (torch.randn(RAGGED, d_in, generator=second),
                    torch.randn(d_in, d_hid, generator=second) * 0.05,
                    torch.randn(d_hid, generator=second)))
    for (draw, cpu), act in itertools.product(enumerate(draws), ACTS):
        grads = []
        for fn, dtype in ((fused_dense, f32), (fused_dense_reference, f32),
                          (lambda x, w, b, a: ACTS[a](x @ w + b), torch.float64)):
            params = [t.to(dev, dtype).requires_grad_() for t in cpu]
            (fn(*params, act) ** 2).sum().backward()
            grads.append([p.grad.double() for p in params])
        for arg, got, plain_grad, exact in zip("xwb", *grads):
            def needed(grad, ref=exact):
                return ((grad - ref).abs() - GRAD_RTOL * ref.abs()).max().item()
            emit("kernel_check", kernel="fused_dense_backward", draw=draw, act=act,
                 grad=arg, max_abs_err=(got - exact).abs().max().item(),
                 plain_max_abs_err=(plain_grad - exact).abs().max().item(),
                 atol_needed=needed(got), plain_atol_needed=needed(plain_grad),
                 between_atol_needed=needed(got, plain_grad),
                 max_abs_out=exact.abs().max().item(), rtol=GRAD_RTOL, atol=GRAD_ATOL[arg])
            torch.testing.assert_close(got, exact, rtol=GRAD_RTOL, atol=GRAD_ATOL[arg])
    return errors


# ---------------------------------------------------------------------------
# Phase 4: the folded fp32 pipeline against the plain nn.Module pipeline
# ---------------------------------------------------------------------------


def check_reference(models: PipelineModels, samples: np.ndarray, dev) -> None:
    """Folded fp32 pipeline on the card with each front, with and without
    K5, vs the plain nn.Module pipeline on the CPU: stage-1 probabilities
    within 1e-4 and every label equal where the decision margin exceeds
    1e-3."""
    images = torch.from_numpy(samples)
    want = make_v6_pipeline(models, stage1_threshold=THRESHOLD, device="cpu")(images)
    with torch.inference_mode():
        x = images.float() / 1023.0
        s1 = torch.sigmoid(models.stage1(x))
        margins = {"stage1_pred": (s1 - THRESHOLD).abs()}
        for key, m in (("stage2_pred", models.stage2),
                       ("stage3_rect_pred", models.stage3_rect),
                       ("stage3_ab_pred", models.stage3_ab)):
            top = m(x).topk(2, dim=-1).values
            margins[key] = top[:, 0] - top[:, 1]
    margins["final"] = torch.stack(list(margins.values())).amin(0)
    for mode, groups in ((False, False), (True, False), ("g1", False),
                         (False, True), (True, True)):
        got = make_v6_pipeline_folded(models, THRESHOLD, float_dtype=torch.float32,
                                      use_fused_front=mode, use_pallas_groups=groups,
                                      device=dev)(images.to(dev))
        got = {k: v.cpu() for k, v in got.items()}
        prob_err = (got["stage1_prob"] - want["stage1_prob"]).abs().max().item()
        mismatches = {}
        for key, margin in margins.items():
            sure = margin > 1e-3
            mismatches[key] = int((got[key] != want[key])[sure].sum())
        emit("reference", fused_front=mode, pallas_groups=groups, samples=len(samples),
             stage1_prob_max_abs_err=prob_err,
             guarded_share=float((margins["final"] > 1e-3).float().mean()),
             mismatches_above_margin=mismatches)
        if prob_err > 1e-4 or any(mismatches.values()):
            raise AssertionError(f"folded fp32 ({mode}, groups={groups}) "
                                 "disagrees with the reference")


# ---------------------------------------------------------------------------
# Phase 5: the main paths
# ---------------------------------------------------------------------------


def make_dataset() -> Path:
    rng = np.random.default_rng(SEED)

    def bundle(n):
        stage0 = rng.integers(0, 8, size=n).astype(np.int32)
        return Bundle(
            samples=codes(rng, (n, HW, HW, 1)),
            qps=np.full(n, 90, np.int32),
            labels={"stage0": stage0, "stage1": (stage0 != 0).astype(np.int32),
                    "stage2": map_to_stage2_v6(stage0)[0].astype(np.int32)},
        )

    root = WORK / "dataset"
    train, val = bundle(64), bundle(N_VAL)
    extra = bundle(N_TRAIN - 64)  # drawn after val, which stays as it was
    train = Bundle(samples=np.concatenate([train.samples, extra.samples]),
                   qps=np.concatenate([train.qps, extra.qps]),
                   labels={k: np.concatenate([v, extra.labels[k]])
                           for k, v in train.labels.items()})
    save_split(root, HW, train, val, "v6")
    return root


def v6_checkpoints(ckpts: dict, ab: str = "ab") -> list:
    """The per-stage checkpoint arguments of the CLIs; ``ab`` is ``"ab"``,
    ``"fgvc"`` or ``"ensemble"`` (a ``save_ensemble`` directory)."""
    args = ["--stage1-checkpoint", str(ckpts["stage1"]),
            "--stage2-checkpoint", str(ckpts["stage2"]),
            "--stage3-rect-checkpoint", str(ckpts["rect"])]
    if ab == "ensemble":
        return args + ["--stage3-ab-ensemble-dir", str(ckpts["ensemble"])]
    return args + ["--stage3-ab-checkpoint", str(ckpts[ab]),
                   "--ab-fgvc" if ab == "fgvc" else "--no-ab-fgvc"]


def quietly(main: Callable, argv: list) -> str:
    """Run a CLI's ``main``; return what it printed (its summary lines are
    read, not shown)."""
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        main(argv)
    return printed.getvalue()


def cli_argv(dataset: Path, name: str, args: list, dev, bf16: bool = True,
             block_size: int = HW) -> list:
    """``run_pipeline_eval``'s arguments for :func:`run_cli`."""
    return ["--dataset-dir", str(dataset), "--block-size", str(block_size),
            "--output-dir", str(WORK / "runs" / name), "--batch-size", str(BATCH),
            "--stage1-threshold", str(THRESHOLD), *(["--bf16"] if bf16 else []),
            "--device", dev.type, *args]


def run_cli(dataset: Path, name: str, args: list, dev, bf16: bool = True,
            block_size: int = HW) -> dict:
    """The port's ``run_pipeline_eval`` on path a's dataset (or another at
    ``block_size``), bf16 (or fp32), batch 4096, with ``args`` (variant,
    serving options, checkpoints)."""
    out = WORK / "runs" / name
    printed = quietly(run_pipeline_eval.main, cli_argv(dataset, name, args, dev, bf16,
                                                       block_size))
    summary = json.loads(printed[printed.rindex("{\n"):])  # the CLI's last print
    metrics = json.loads((out / "pipeline_metrics_val.json").read_text())
    preds = np.load(out / "pipeline_predictions_val.npz")
    return {"samples": metrics["samples"],
            "blocks_per_s": metrics["throughput_superblocks_per_sec"],
            "capacity": metrics["capacity"], "overflow": summary.get("overflow"),
            "final": preds["predictions"], "stage1_prob": preds["stage1_prob"]}


def drive(path: str, plan, run_one) -> tuple:
    """One main path: counts set to 0, each ``(name, arg)`` of ``plan``
    run through ``run_one``, counts read (and the path's wall seconds
    emitted). Returns (runs, launches)."""
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    runs, before = [], dict(_build.launch_counts)
    for name, arg in plan:
        run = run_one(arg)
        run["name"] = name
        run["launches"] = {k: v - before[k] for k, v in _build.launch_counts.items()
                           if v - before[k]}
        before = dict(_build.launch_counts)
        runs.append(run)
    launches = dict(_build.launch_counts)
    emit("main_path", path=path, launches=launches, seconds=time.perf_counter() - t0)
    return runs, launches


def report_runs(path, runs, base, expect) -> None:
    """Emit each serving run; check its outputs and that ``expect(run)``'s
    kernels launched."""
    for run in runs:
        finite = bool(np.isfinite(run["stage1_prob"]).all())
        emit("end_to_end", path=path, run=run["name"], samples=run["samples"],
             blocks_per_s=run["blocks_per_s"], launches=run["launches"],
             final_agrees_with_off=float((run["final"] == base["final"]).mean()),
             stage1_prob_max_abs_diff_vs_off=float(
                 np.abs(run["stage1_prob"] - base["stage1_prob"]).max()),
             finite=finite)
        if run["samples"] != N_VAL or len(run["final"]) != N_VAL or not finite:
            raise AssertionError(f"{run['name']}: bad outputs")
        if not np.isin(run["final"], np.arange(8)).all():
            raise AssertionError(f"{run['name']}: labels outside 0..7")
        for kernel in expect(run):
            if run["launches"].get(kernel, 0) == 0:
                raise AssertionError(f"{run['name']}: {kernel} never launched")


def serving_plan(dataset: Path, ckpts: dict, unified_ckpt: Path, dev) -> list:
    """The second part of path a, in order: the calibration sweep, the gated
    pipeline at ``auto`` and 0.5, the unified family with each front, the
    plain graph with TTA and with the AB ensemble, then the tools."""
    calibration = WORK / "calibration"
    data = ["--dataset-dir", str(dataset), "--block-size", str(HW),
            "--batch-size", str(BATCH), "--bf16", "--device", dev.type]
    unified = ["--variant", "unified", "--unified-checkpoint", str(unified_ckpt), "--folded"]
    return [
        ("optimize_thresholds", ("tool", optimize_thresholds.main, data + [
            "--stage1-checkpoint", str(ckpts["stage1"]), "--output-dir", str(calibration)],
            ["threshold_sweep.csv", "threshold_summary.json",
             "stage1_calibrated_variables.npz"])),
        ("gated_auto", ("cli", ["--folded", "--capacity", "auto", "--capacity-margin",
                                str(CAPACITY_MARGIN), "--calibration-dir", str(calibration),
                                *v6_checkpoints(ckpts)])),
        ("gated_0.5", ("cli", ["--folded", "--capacity", "0.5", *v6_checkpoints(ckpts)])),
        *((f"unified_{mode}", ("cli", [*unified, "--fused-front", mode]))
          for mode in ("off", "on", "g1")),
        ("tta", ("cli", ["--tta", *v6_checkpoints(ckpts)])),
        ("ensemble", ("cli", v6_checkpoints(ckpts, "ensemble"))),
        # fp32: a certification of the folded graphs against the plain ones.
        # In bf16 the seeded random heads put ~5% of the labels within one
        # rounding of their decision boundary (94.5% agreement on 300 blocks on a CPU).
        ("certify_serving", ("tool", certify_serving.main, [a for a in data if a != "--bf16"] + [
            "--output-dir", str(WORK / "certify"), "--stage1-threshold", str(THRESHOLD),
            "--calibration-dir", str(calibration),
            "--unified-checkpoint", str(unified_ckpt), *v6_checkpoints(ckpts)],
            ["serving_certification.json", "serving_certification.md"])),
        ("compare_thresholds", ("tool", compare_thresholds.main, data + [
            "--output-dir", str(WORK / "operating_points"),
            "--thresholds", "0.45", "0.5", "0.55", *v6_checkpoints(ckpts)],
            ["operating_points.json", "operating_points.md"])),
        ("analyze_confusion", ("tool", analyze_confusion.main, data + [
            "--output-dir", str(WORK / "confusion"),
            "--stage2-checkpoint", str(ckpts["stage2"])], ["stage2_confusion.json"])),
    ]


def serve_one(dataset: Path, dev) -> Callable:
    """``run_one`` of path a: a ``run_pipeline_eval`` run, or a tool CLI whose
    files must appear (its output directory is the argument after
    ``--output-dir``)."""

    def run_one(arg):
        name, (kind, *rest) = arg
        if kind == "cli":
            return {**run_cli(dataset, name, rest[0], dev), "kind": kind}
        main, argv, files = rest
        out = Path(argv[argv.index("--output-dir") + 1])
        t0 = time.perf_counter()
        quietly(main, argv)
        missing = [f for f in files if not (out / f).exists()]
        if missing:
            raise AssertionError(f"{name} did not write {missing}")
        return {"kind": kind, "seconds": time.perf_counter() - t0, "out": out}

    return run_one


def gated_overflow_rows(run: dict) -> np.ndarray:
    """The rows the gated pipeline sent to the SPLIT fallback, from its own
    stage-1 probabilities: per batch, the passers outside the K rows that a
    stable descending sort puts first (``eval.gated``)."""
    prob = run["stage1_prob"]
    rows = np.zeros(len(prob), bool)
    k = max(1, int(-(-run["capacity"] * BATCH // 1)))
    for start in range(0, len(prob), BATCH):
        p = prob[start:start + BATCH]
        chosen = np.zeros(len(p), bool)
        chosen[np.argsort(-p, kind="stable")[:k]] = True
        rows[start:start + BATCH] = (p >= THRESHOLD) & ~chosen
    return rows


def check_serving_runs(runs: list, base: dict) -> None:
    """Path a's second part: serving runs against ``base`` (the per-stage
    ``off`` run) or the unified ``off`` run, the gated runs' fallback, and the
    certification's folded rows."""
    by_name = {run["name"]: run for run in runs}
    cli = [run for run in runs if run["kind"] == "cli"]
    report_runs("a_serving", [r for r in cli if not r["name"].startswith("unified")], base,
                lambda r: [])
    report_runs("a_serving_unified", [r for r in cli if r["name"].startswith("unified")],
                by_name["unified_off"], lambda r: FRONT_KERNELS.get(r["name"][8:], []))
    for name in ("gated_auto", "gated_0.5"):
        run = by_name[name]
        rows = gated_overflow_rows(run)
        kept = ~rows
        agree_kept = float((run["final"][kept] == base["final"][kept]).mean())
        emit("gated_cli", run=name, capacity=run["capacity"], overflow=run["overflow"],
             gate_rate=float((run["stage1_prob"] >= THRESHOLD).mean()),
             final_agrees_with_off=float((run["final"] == base["final"]).mean()),
             rows_outside_overflow_agree_with_off=agree_kept,
             blocks_per_s=run["blocks_per_s"])
        if run["overflow"] != int(rows.sum()):
            raise AssertionError(f"{name}: overflow {run['overflow']}, but {rows.sum()} "
                                 "passers lie outside the K rows")
        if agree_kept < 0.999:
            raise AssertionError(f"{name}: only {agree_kept:.5f} of the labels outside the "
                                 "overflow rows equal the dense run's")
        if (run["final"][rows] != 1).any():
            raise AssertionError(f"{name}: an overflow row is not SPLIT")
    for run in runs:
        if run["kind"] == "tool":
            emit("tool", run=run["name"], seconds=run["seconds"], launches=run["launches"],
                 files=sorted(f.name for f in run["out"].iterdir()))
    cert = json.loads((by_name["certify_serving"]["out"]
                       / "serving_certification.json").read_text())
    emit("certify_serving", capacity=cert["capacity"], rows=cert["rows"])
    rows = {row["variant"]: row for row in cert["rows"]}
    for name in ("folded", "unified(folded)"):
        if rows[name]["agreement_vs_flax"] < 0.99:
            raise AssertionError(f"certify_serving: the {name} row agrees with its "
                                 f"plain graph on {rows[name]['agreement_vs_flax']:.4f}")
    sweep = json.loads((WORK / "calibration" / "threshold_summary.json").read_text())
    emit("calibration", temperature=sweep["calibration"]["temperature"],
         ece_raw=sweep["calibration"]["ece_raw"],
         ece_calibrated=sweep["calibration"]["ece_calibrated"],
         best_f1_threshold=sweep["f1"]["threshold"])


def stacking_phase(ensemble_dir: Path, samples: np.ndarray, dev) -> None:
    """The AB ensemble's members on ``BATCH`` blocks, then the stacking
    meta-model fit on the card against the same fit on the CPU (both start
    from the same host-drawn weights), on labels that follow member 0."""
    members, _ = load_ensemble(ensemble_dir)
    images = samples[:BATCH].astype(np.float32) / 1023.0
    logits = stacked_member_logits(Stage3ABModel(), members, images, batch_size=BATCH,
                                   device=dev)
    labels = logits[0].argmax(-1)
    x = torch.as_tensor(_stacking_features(logits), dtype=torch.float32)
    y = torch.as_tensor(labels, dtype=torch.int64)
    objective = lambda w: float(_stacking_objective(torch.as_tensor(w), x, y, 1e-3))
    t0 = time.perf_counter()
    w_card = fit_stacking(logits, labels, steps=300, device=dev)
    seconds = time.perf_counter() - t0
    w_cpu = fit_stacking(logits, labels, steps=300, device="cpu")
    start = objective(torch.randn(w_cpu.shape, generator=torch.Generator().manual_seed(0)) * 0.01)
    fitted = {"card": objective(w_card), "cpu": objective(w_cpu)}
    emit("stacking", logits_shape=list(logits.shape), classes=int(len(np.unique(labels))),
         start_objective=start, fitted_objective=fitted, card_seconds=seconds)
    if not (np.isfinite(logits).all() and np.isfinite(w_card).all()):
        raise AssertionError("stacking: non-finite member logits or weights")
    if abs(fitted["card"] - fitted["cpu"]) > 1e-4 or fitted["card"] >= start:
        raise AssertionError(f"stacking: the card's fit reached {fitted['card']}, the "
                             f"CPU's {fitted['cpu']}, from {start}")


def serve_with_groups(models: PipelineModels, samples: np.ndarray, dev):
    """``run_one`` of path b: K5 with the given front, bf16, batch 4096."""
    predicts = {}

    def run_one(mode):
        if mode not in predicts:
            predicts[mode] = make_v6_pipeline_folded(
                models, THRESHOLD, float_dtype=torch.bfloat16, use_fused_front=mode,
                use_pallas_groups=True, device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = run_pipeline_batched(predicts[mode], samples, batch_size=BATCH, device=dev)
        seconds = time.perf_counter() - t0
        return {"samples": len(out["final"]), "blocks_per_s": len(samples) / seconds,
                "final": out["final"], "stage1_prob": out["stage1_prob"], "mode": mode}

    return run_one


def kernel_api_path(models, val: Bundle, dev) -> dict:
    """Path c through ``av1tpu_torch.kernels``: K3a/K3b ingest of eight
    1080p frames, then three training steps of a K4 head."""
    rng = np.random.default_rng(SEED + 1)
    frames = pp.pad_frames(codes(rng, FRAMES), HW)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    frames_dev = torch.from_numpy(frames).to(dev)
    tiled = pp.tile_normalize_frames(frames_dev, HW, torch.bfloat16)
    torch.cuda.synchronize()
    ingest_s = time.perf_counter() - t0
    again = pp.normalize_blocks(torch.from_numpy(host_tile(frames, HW)).to(dev),
                                torch.bfloat16)
    f, h, w = frames.shape
    if tiled.shape != (f * (h // HW) * (w // HW), HW, HW, 1) or not torch.equal(tiled, again):
        raise AssertionError("K3a blocks differ from K3b on host-tiled blocks")
    emit("kernel_api", step="ingest", frames=list(frames.shape), blocks=tiled.shape[0],
         blocks_per_s=tiled.shape[0] / ingest_s, k3a_equals_k3b_on_host_tiles=True)

    x = pp.normalize_blocks(torch.from_numpy(val.samples[:BATCH]).to(dev))
    labels = torch.from_numpy(val.labels["stage0"][:BATCH]).long().to(dev)
    backbone = copy.deepcopy(models.stage1.backbone).to(dev).eval()
    with torch.no_grad():
        emb = backbone(x)
        emb = (emb - emb.mean(0)) / (emb.std(0) + 1e-6)  # standardised features
    gen = torch.Generator().manual_seed(SEED)
    params = []
    for d_in, d_out in zip(HEAD[:-1], HEAD[1:]):
        params += [(torch.randn(d_in, d_out, generator=gen) / math.sqrt(d_in)).to(dev),
                   torch.zeros(d_out, device=dev)]
    for p in params:
        p.requires_grad_()
    losses = []
    for _ in range(3):
        h = fused_dense(emb, params[0], params[1], "relu")
        loss = F.cross_entropy(fused_dense(h, params[2], params[3], "linear"), labels)
        loss.backward()
        with torch.no_grad():
            for p in params:
                p -= 0.1 * p.grad
                p.grad = None
        losses.append(loss.item())
    emit("kernel_api", step="head_training", batch=BATCH, widths=list(HEAD),
         losses=losses)
    if not all(map(math.isfinite, losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"K4 head training did not reduce its loss: {losses}")
    return {"tiled": tiled}


# ---------------------------------------------------------------------------
# Path d: the frame -> partition-tree cascade
# ---------------------------------------------------------------------------


def cascade_models(dev) -> dict:
    """``{size: {"stage1" | "stage2" | "rect" | "ab" | "unified": model}}``:
    each level of the cascade has its own seeded models, calibrated on
    structured blocks of its own size (a random ResNet calibrated at one block
    size saturates or dies at another; those forwards run on ``dev``), with the
    heads shifted to ``GATE_SHARE``, ``SPLIT_SHARE``, ``RECT_SHARE`` and
    ``AB_SHARE`` on probe blocks."""
    sbs = structured_luma(np.random.default_rng(SEED + 3), (512, 64, 64))
    out = {}
    for size in LEVEL_SIZES:
        blocks = torch.from_numpy(host_tile(sbs, size)[:512].astype(np.float32) / 1023.0)
        calib, probe = blocks[:256], blocks[256:]
        gen = torch.Generator().manual_seed(SEED + size)
        out[size] = {}
        for name, cls in (*STAGE_CLASSES.items(), ("unified", UnifiedV6Model)):
            model = seeded_model(cls, gen, calib, dev)
            with torch.no_grad():
                logits = model.to(dev)(probe.to(dev)).cpu().numpy()
            model.cpu()
            shares = {"stage1": GATE_SHARE, "stage2": SPLIT_SHARE[size],
                      "rect": RECT_SHARE, "ab": AB_SHARE}
            if name == "unified":
                parts = dict(zip(shares, split_unified_logits(logits)))
                for head, share in shares.items():
                    set_first_class_share(getattr(model, f"head_{head}"), parts[head], share)
            else:
                set_first_class_share(model.head, logits, shares[name])
            out[size][name] = model
    return out


def write_clip() -> Path:
    """Eight structured 1080p frames as a yuv420p10le file (about 50 MB)."""
    f, h, w = CLIP
    luma = structured_luma(np.random.default_rng(SEED + 4), (f, -(-h // 16) * 16, w))[:, :h]
    return write_yuv(WORK / f"clip_{w}x{h}_30.yuv", luma)


def write_cascade_checkpoints(models: dict) -> dict:
    """One directory per block size under the names the CLI looks for."""
    dirs = {}
    for size, by_name in models.items():
        dirs[size] = WORK / "tree_ckpt" / f"models_{size}"
        for name, model in by_name.items():
            stem = "unified" if name == "unified" else STAGE_CKPT[name]
            save_variables_npz(dirs[size] / f"{stem}_best_variables.npz",
                               to_jax_variables(model.state_dict()), compress=False)
    return dirs


def level_pipeline_models(models: dict, size: int) -> PipelineModels:
    return PipelineModels(*(models[size][name] for name in STAGE_CLASSES))


def tree_cli_argv(clip: Path, dirs: dict, name: str, extra: list, dev) -> list:
    """``predict_trees``' arguments for :func:`run_tree_cli`."""
    serving = [] if "--int8" in extra else ["--folded"]
    argv = ["--yuv", str(clip), "--frames", *map(str, range(CLIP[0])),
            "--output-dir", str(WORK / "trees" / name), "--batch-size", str(BATCH),
            "--stage1-threshold", str(THRESHOLD), *serving, "--bf16", "--no-ab-fgvc",
            "--frames-per-batch", str(FRAMES_PER_BATCH), "--device", dev.type, *extra]
    for size in LEVEL_SIZES:
        argv += [f"--models-{size}", str(dirs[size])]
    return argv


def run_tree_cli(clip: Path, dirs: dict, name: str, extra: list, dev) -> dict:
    """The port's ``predict_trees`` CLI over the whole clip, bf16, four frames
    a group, folded unless ``extra`` asks for ``--int8``. ``seconds`` is the
    CLI's own: each group from the upload of its superblocks to its trees on
    the host."""
    out = WORK / "trees" / name
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):  # its stats are read from the file
        predict_trees.main(tree_cli_argv(clip, dirs, name, extra, dev))
    wall = time.perf_counter() - t0
    stats = json.loads((out / "tree_stats.json").read_text())
    files = [np.load(out / f"trees_frame{i}.npz") for i in range(CLIP[0])]
    overflow = [{k: v for k, v in stats[str(first)].items() if "overflow" in k}
                for first in range(0, CLIP[0], FRAMES_PER_BATCH)]
    return {"trees": np.concatenate([f["trees"] for f in files]), "frames": CLIP[0],
            "seconds": sum(st["seconds"] for st in stats.values()),
            "cli_wall_seconds": wall, "overflow": overflow,
            "mean_nodes": float(np.mean([st["mean_nodes"] for st in stats.values()]))}


def run_tree_library(models: dict, sbs: np.ndarray, front, dev) -> dict:
    """Path d4: ``predict_partition_trees`` over four frames' superblocks with
    K5 predictors (``use_pallas_groups=True``, no CLI flag in either package),
    built once per level; timed on the second call."""
    predictors = {
        size: make_v6_pipeline_folded(
            level_pipeline_models(models, size), THRESHOLD, float_dtype=torch.bfloat16,
            use_fused_front=front, use_pallas_groups=True, device=dev)
        for size in LEVEL_SIZES
    }
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        result = predict_partition_trees(sbs, predictors, BATCH, device=dev)
        seconds = time.perf_counter() - t0
    trees = result["trees"]
    return {"trees": trees, "frames": len(sbs) // FRAME_SBS, "seconds": seconds,
            "cli_wall_seconds": None, "overflow": [],
            "mean_nodes": float((trees >= 0).sum(axis=1).mean())}


def report_tree_runs(runs: list, expect: dict) -> None:
    """Emit each run of path d; check its trees and that the kernels
    ``expect[name]`` launched. ``tree_slots_equal_to_off`` compares with the
    dense ``--fused-front off`` run of the same model family (per-stage or
    unified) on the same frames."""
    by_name = {run["name"]: run for run in runs}
    for run in runs:
        trees = run["trees"]
        n = run["frames"] * FRAME_SBS
        base = by_name["unified_off" if run["name"].startswith("unified") else "off"]
        equal = float((trees == base["trees"][:n]).mean()) if trees.shape[0] == n else None
        emit("end_to_end", path="d_trees", run=run["name"], frames=run["frames"],
             superblocks=n, seconds=run["seconds"],
             frames_per_s=run["frames"] / run["seconds"],
             superblocks_per_s=n / run["seconds"], cli_wall_seconds=run["cli_wall_seconds"],
             launches=run["launches"], tree_slots_equal_to_off=equal,
             mean_nodes_per_tree=run["mean_nodes"], overflow=run["overflow"])
        if trees.shape != (n, 85) or trees.min() < -1 or trees.max() > 7:
            raise AssertionError(f"{run['name']}: bad trees {trees.shape}")
        if (trees[:, 0] < 0).any() or not 2.0 < run["mean_nodes"] < 60.0:
            raise AssertionError(f"{run['name']}: the trees do not vary "
                                 f"(mean nodes {run['mean_nodes']})")
        for kernel in expect.get(run["name"], []):
            if run["launches"].get(kernel, 0) == 0:
                raise AssertionError(f"{run['name']}: {kernel} never launched")


def check_gated_run(gated: dict, dense: dict) -> None:
    """Path d3. The gate is exact when K covers the live set, but its chunks
    hold other rows than the dense run's, and cuDNN may sum a row's bf16
    convolution in another order in another batch: a group without overflow
    must agree with the dense run on at least 99.9% of its slots."""
    rows = FRAMES_PER_BATCH * FRAME_SBS
    for g, overflow in enumerate(gated["overflow"]):
        part = slice(g * rows, (g + 1) * rows)
        share = float((gated["trees"][part] == dense["trees"][part]).mean())
        covered = all(v == 0 for v in overflow.values())
        emit("gated_cascade", group=g, level_capacity=list(LEVEL_CAPACITY), overflow=overflow,
             k_covers_the_live_set=covered, tree_slots_equal_to_dense=share)
        if len(overflow) != 3:
            raise AssertionError(f"gated run, group {g}: overflow counts {overflow}")
        if covered and share < 0.999:
            raise AssertionError(f"gated run, group {g}: no overflow, yet only "
                                 f"{share:.5f} of the slots equal the dense run's")


def check_tree_reference(models: dict, sbs: np.ndarray, dev) -> None:
    """The folded fp32 cascade on the card (fronts off/on/g1, and K5 with K1)
    against the plain nn.Module cascade on the CPU: every tree slot equal
    wherever each decision on the node's ancestry has a margin above 1e-3.
    Then, per level, the unified folded fp32 pipeline on the card against
    ``UnifiedV6Model``'s own forward on the CPU: stage-1 probability within
    1e-4, labels equal above the margin."""
    margins = {size: [] for size in LEVEL_SIZES}

    def plain_predictor(size):
        m = level_pipeline_models(models, size)

        @torch.inference_mode()
        def predict(images):
            x = images.to(torch.float32) / 1023.0
            s1 = torch.sigmoid(m.stage1(x))
            logits = [m.stage2(x), m.stage3_rect(x), m.stage3_ab(x)]
            tops = [lg.topk(2, dim=-1).values for lg in logits]
            margins[size].append(torch.stack(
                [(s1 - THRESHOLD).abs()] + [t[:, 0] - t[:, 1] for t in tops]).amin(0))
            preds = [lg.argmax(-1).to(torch.int32) for lg in logits]
            return {"final": v6_route((s1 >= THRESHOLD).to(torch.int32), *preds)}

        return predict

    want = predict_partition_trees(
        sbs, {size: plain_predictor(size) for size in LEVEL_SIZES}, BATCH, device="cpu")
    # a node's slot depends on its own decision and on every ancestor's
    sure, above = [], None
    for size, nodes in zip(LEVEL_SIZES, NODES_PER_LEVEL):
        own = torch.cat(margins[size]).reshape(len(sbs), nodes) > 1e-3
        above = own if above is None else own & above.repeat_interleave(4, dim=1)
        sure.append(above)
    sure = torch.cat(sure, dim=1).numpy()
    for mode, groups in ((False, False), (True, False), ("g1", False), (True, True)):
        got = predict_partition_trees(sbs, {
            size: make_v6_pipeline_folded(
                level_pipeline_models(models, size), THRESHOLD, float_dtype=torch.float32,
                use_fused_front=mode, use_pallas_groups=groups, device=dev)
            for size in LEVEL_SIZES}, BATCH, device=dev)
        mismatches = int((got["trees"] != want["trees"])[sure].sum())
        emit("reference", path="d_trees", fused_front=mode, pallas_groups=groups,
             superblocks=len(sbs), guarded_share=float(sure.mean()),
             slots_equal=float((got["trees"] == want["trees"]).mean()),
             mismatches_above_margin=mismatches,
             mean_nodes_per_tree=float((want["trees"] >= 0).sum(axis=1).mean()))
        if mismatches or sure.mean() < 0.5:
            raise AssertionError(f"folded fp32 cascade ({mode}, groups={groups}) "
                                 "disagrees with the plain cascade")

    blocks = {size: host_tile(sbs, size)[:256] for size in LEVEL_SIZES}
    for size, mode in itertools.product(LEVEL_SIZES, (False, True, "g1")):
        model, images = models[size]["unified"], torch.from_numpy(blocks[size])
        want = make_unified_pipeline(model, THRESHOLD, device="cpu")(images)
        with torch.inference_mode():
            s1, s2, rect, ab = split_unified_logits(model(images.float() / 1023.0))
        tops = [lg.topk(2, dim=-1).values for lg in (s2, rect, ab)]
        sure = torch.stack([(torch.sigmoid(s1) - THRESHOLD).abs()]
                           + [t[:, 0] - t[:, 1] for t in tops]).amin(0) > 1e-3
        got = make_unified_pipeline_folded(
            model, THRESHOLD, float_dtype=torch.float32, use_fused_front=mode,
            device=dev)(images.to(dev))
        prob_err = (got["stage1_prob"].cpu() - want["stage1_prob"]).abs().max().item()
        mismatches = int((got["final"].cpu() != want["final"])[sure].sum())
        emit("reference", path="d_unified", block_size=size, fused_front=mode,
             samples=len(images), stage1_prob_max_abs_err=prob_err,
             guarded_share=float(sure.float().mean()), mismatches_above_margin=mismatches)
        if prob_err > 1e-4 or mismatches:
            raise AssertionError(f"unified folded fp32 ({size} px, {mode}) disagrees "
                                 "with the model's own forward")


def check_kernels_at_cascade_shapes(folded, gen, dev) -> None:
    """K1, K2 and K5 in bf16, the cascade's dtype, against their plain versions
    at the row counts of ``CASCADE_ROWS``."""
    bf16 = torch.bfloat16
    wg = tuple(t.to(dev) for t in rg.pack_group12_weights(folded, bf16))
    stream = rg.group12_conv_stream(wg)
    for e, rows in ((e, r) for e, rs in CASCADE_ROWS.items() for r in rs):
        hw = 4 * e
        if ff.supports_extent(hw):
            x = (torch.randint(0, 1024, (rows, hw, hw, 1), generator=gen).float()
                 / 1023.0).to(dev, bf16)
            for name in ("fused_front", "fused_front_g1"):
                kern, plain, args = front_args(name, folded, bf16, dev)
                got = kern(x, *args)
                torch.cuda.synchronize()
                want = plain(x, *args)
                compare(name, got, want, rel_tol(name, bf16, want), hw=hw, batch=rows,
                        shape="cascade", dtype=str(bf16))
        x = stem_output(folded, gen, rows, hw, dev).to(bf16)
        got = rg.fused_group12(x, wg, stream)
        torch.cuda.synchronize()
        want = rg.fused_group12_reference(x, wg)
        compare("fused_group12", got, want, rel_tol("fused_group12", bf16, want),
                extent=e, batch=rows, shape="cascade", dtype=str(bf16))


# ---------------------------------------------------------------------------
# Path e: int8 serving (quant.ptq), K1 as its stem
# ---------------------------------------------------------------------------


def int8_forward(q, x: torch.Tensor) -> tuple:
    """Logits (fp32, host) and each site's int8 activations (host) of an int8
    model on ``x`` (normalized NHWC, on the model's device)."""
    captured = {}
    with torch.inference_mode():
        feats = ptq._backbone_apply_hybrid(
            q.folded, x, q.plan, q.scales, q.qw, float_dtype=q.float_dtype,
            qbias=q.qbias, captured=captured, front_fn=q.front_fn)
        logits = torch.cat([
            ptq._head_apply_int8(stack, feats, q.scales, q.qw, float_dtype=q.float_dtype,
                                 qbias=q.qbias, captured=captured, site_prefix=name).float()
            for name, stack in q.heads.items()], dim=-1)
        acts = {site: ptq._quant_act(t, q.scales[site]).cpu() for site, t in captured.items()}
    return logits.cpu().numpy(), acts


def decision_margins(logits: np.ndarray, unified: bool) -> tuple:
    """Per-sample margin of every decision in ``logits`` (the gate's distance
    from ``THRESHOLD``, else the top-2 gap), and the decisions."""
    parts = split_unified_logits(torch.from_numpy(logits)) if unified else (
        torch.from_numpy(logits),)
    margins, decisions = [], []
    for part in parts:
        part = part.double()
        if part.dim() == 1 or part.shape[1] == 1:
            prob = torch.sigmoid(part.reshape(-1))
            margins.append((prob - THRESHOLD).abs())
            decisions.append((prob >= THRESHOLD).long())
        else:
            top = part.topk(2, dim=-1).values
            margins.append(top[:, 0] - top[:, 1])
            decisions.append(part.argmax(-1))
    return torch.stack(margins).amin(0).numpy(), torch.stack(decisions, -1).numpy()


def labels_agree(got: np.ndarray, want: np.ndarray, unified: bool) -> dict:
    """Share of samples whose decisions are all equal, and the largest margin
    (of ``want``) at which one differs."""
    margins, want_dec = decision_margins(want, unified)
    equal = (decision_margins(got, unified)[1] == want_dec).all(-1)
    return {"label_share": float(equal.mean()),
            "max_margin_of_a_mismatch": float(margins[~equal].max()) if (~equal).any() else 0.0}


def check_int8_products(q, x: torch.Tensor, dev) -> None:
    """``_int_mm`` on the card against the CPU's product, exactly, at one site
    of each form of an int8 model quantized on the CPU: a group-1 conv
    (im2col at 4x4), an SMM conv, a head's first layer, its last (3 outputs:
    padded to 8 columns), and a 5-row batch (padded to 17 rows)."""
    _, acts = int8_forward(q, x)
    sites = {"layer1_0.in": "layer1_0.conv1", "layer2_0.in": "layer2_0.conv1",
             "head.0": "head.0", "head.2": "head.2"}
    assert q.plan["blocks"]["layer1_0"]["form"] == "conv"
    assert q.plan["blocks"]["layer2_0"]["form"] == "smm"
    results = {}
    for site, wkey in sites.items():
        xq, w = acts[site], q.qw[wkey][0].cpu()
        if xq.dim() == 4:
            def product(a, b):
                return ptq._int_conv(a, b.reshape(3, 3, a.shape[-1], -1), 1)
        else:
            product = ptq._int_dot
        for rows in (len(xq), 5):
            want = product(xq[:rows], w)
            got = product(xq[:rows].to(dev), w.to(dev)).cpu()
            results[f"{site}x{rows}"] = {"shape": list(want.shape),
                                        "equal": bool(torch.equal(got, want))}
    emit("int8_products", sites=results)
    if not all(r["equal"] for r in results.values()):
        raise AssertionError(f"int32 products differ between the card and the CPU: {results}")


def check_int8_card_vs_cpu(model, calib: torch.Tensor, x: torch.Tensor, dev,
                           unified: bool) -> None:
    """Quantize on the CPU, move the model to the card: in fp32 and bf16 the
    card's per-site int8 activations, logits and labels against the CPU's,
    held to the bounds that tests/test_torch_port_int8.py holds two packages
    to (a 1-ulp difference of a float island flips an activation now and then,
    and the flip spreads)."""
    quantize = ptq.quantize_unified if unified else ptq.quantize_stage
    for dtype in (torch.float32, torch.bfloat16):
        q = quantize(model, calib, dtype)
        want, want_acts = int8_forward(q, x)
        q.to(dev)
        got, got_acts = int8_forward(q, x.to(dev))
        shares = {s: float((got_acts[s] == a).float().mean()) for s, a in want_acts.items()}
        steps = max(int((got_acts[s].int() - a.int()).abs().max()) for s, a in want_acts.items())
        agree = labels_agree(got, want, unified)
        emit("int8_card_vs_cpu", model="unified" if unified else "stage2", dtype=str(dtype),
             samples=len(x), min_site_share=min(shares.values()), max_site_step=steps,
             logit_max_abs_diff=float(np.abs(got - want).max()),
             logit_std=float(want.std(0).min()), **agree)
        if (min(shares.values()) < INT8_SITE_SHARE or agree["label_share"] < INT8_LABEL_SHARE
                or agree["max_margin_of_a_mismatch"] > INT8_MARGIN):
            raise AssertionError(f"int8 on the card disagrees with the CPU ({dtype})")


def int8_library_checks(models: PipelineModels, unified_model, models8: PipelineModels,
                        calib: np.ndarray, samples: np.ndarray, dev) -> None:
    """The int8 pipelines on the card: K1's launches per predict (per-stage 4
    with the fused front, unified 1, none without), K1-on labels against
    K1-off labels, the int8 labels against the folded fp32 pipeline's, and the
    seconds that calibration and quantization take; then the per-stage int8
    pipeline at 8 px with K1."""
    images = torch.from_numpy(samples[:BATCH]).to(dev)
    folded = {
        "v6": make_v6_pipeline_folded(models, THRESHOLD, float_dtype=torch.float32,
                                      device=dev)(images),
        "unified": make_unified_pipeline_folded(unified_model, THRESHOLD,
                                                float_dtype=torch.float32,
                                                device=dev)(images)}
    for family, dtype in itertools.product(("v6", "unified"), (torch.float32, torch.bfloat16)):
        outs, kernels, seconds = {}, {}, {}
        for front in (False, True):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if family == "v6":
                predict = make_v6_pipeline_int8(models, calib, THRESHOLD, float_dtype=dtype,
                                                use_fused_front=front, device=dev)
            else:
                predict = make_unified_pipeline_int8(unified_model, calib, THRESHOLD,
                                                     float_dtype=dtype,
                                                     use_fused_front=front, device=dev)
            torch.cuda.synchronize()
            seconds[front] = time.perf_counter() - t0
            kernels[front] = launched_by(lambda: predict(images))
            outs[front] = {k: v.cpu() for k, v in predict(images).items()}
        want_k1 = {False: 0, True: 4 if family == "v6" else 1}
        on, off, ref = outs[True], outs[False], folded[family]
        emit("int8_pipeline", family=family, dtype=str(dtype), batch=BATCH,
             calib_blocks=len(calib), build_seconds=seconds,
             k1_per_predict={str(f): kernels[f].get("fused_front", 0) for f in kernels},
             on_labels_equal_off=float((on["final"] == off["final"]).float().mean()),
             labels_equal_folded_fp32=float((off["final"] == ref["final"].cpu())
                                            .float().mean()),
             stage1_prob_mean_abs_diff_vs_folded_fp32=float(
                 (off["stage1_prob"] - ref["stage1_prob"].cpu()).abs().mean()),
             distinct_labels=int(len(off["final"].unique())))
        for front, want in want_k1.items():
            if kernels[front].get("fused_front", 0) != want or set(kernels[front]) - {
                    "fused_front"}:
                raise AssertionError(f"int8 {family} (front {front}): launched "
                                     f"{kernels[front]}, want fused_front x {want}")
        if not all(torch.isfinite(o["stage1_prob"]).all() for o in outs.values()):
            raise AssertionError(f"int8 {family}: non-finite outputs")
    # K1-on against K1-off logits in fp32, per-stage (stage 2) and unified
    x = images.float() / 1023.0
    for name, model, quantize in (("stage2", models.stage2, ptq.quantize_stage),
                                  ("unified", unified_model, ptq.quantize_unified)):
        q = quantize(model, torch.from_numpy(calib).to(dev).float() / 1023.0)
        off, _ = int8_forward(q, x)
        ptq.attach_fused_front(q, HW)
        on, _ = int8_forward(q, x)
        agree = labels_agree(on, off, name == "unified")
        emit("int8_fused_front", model=name, dtype="torch.float32", **agree)
        if agree["label_share"] < INT8_LABEL_SHARE or agree["max_margin_of_a_mismatch"] > INT8_MARGIN:
            raise AssertionError(f"int8 {name}: K1-on labels disagree with K1-off labels")
    # the per-stage int8 pipeline at 8 px, K1 on
    blocks8 = host_tile(structured_luma(np.random.default_rng(SEED + 6), (64, 64, 64)), 8)
    predict = make_v6_pipeline_int8(models8, blocks8[:INT8_CALIB], THRESHOLD,
                                    float_dtype=torch.bfloat16, use_fused_front=True,
                                    device=dev)
    launched = launched_by(lambda: predict(torch.from_numpy(blocks8).to(dev)))
    emit("int8_pipeline", family="v6", block_size=8, dtype="torch.bfloat16",
         rows=len(blocks8), k1_per_predict=launched.get("fused_front", 0))
    if launched.get("fused_front", 0) != 4:
        raise AssertionError(f"int8 at 8 px: launched {launched}")


def int8_plan(dataset: Path, ckpts: dict, unified_ckpt: Path) -> list:
    """Path e's CLI runs: ``run_pipeline_eval --int8`` per-stage and unified,
    fp32 and bf16, fused front off and on."""
    plan = []
    for family, dtype, front in itertools.product(("v6", "unified"), ("fp32", "bf16"),
                                                  ("off", "on")):
        args = ["--int8", "--fused-front", front]
        args += (["--variant", "unified", "--unified-checkpoint", str(unified_ckpt)]
                 if family == "unified" else v6_checkpoints(ckpts))
        name = f"{family}_{dtype}_{front}"
        plan.append((name, (name, args, dtype == "bf16")))
    return plan


def check_int8_runs(runs: list, bases: dict) -> None:
    """Path e's runs: outputs, K1 launches (4 a predict per-stage, 1 unified,
    none with ``off``), labels against the same family and dtype's ``off``
    run and against the folded bf16 ``off`` run of the same family
    (``bases``: path a's per-stage and unified runs)."""
    predicts = -(-N_VAL // BATCH)
    by_name = {run["name"]: run for run in runs}
    for run in runs:
        family, dtype, front = run["name"].split("_")
        off = by_name[f"{family}_{dtype}_off"]
        k1 = run["launches"].get("fused_front", 0)
        want = 0 if front == "off" else predicts * (4 if family == "v6" else 1)
        emit("end_to_end", path="e_int8", run=run["name"], samples=run["samples"],
             blocks_per_s=run["blocks_per_s"], launches=run["launches"],
             final_agrees_with_off=float((run["final"] == off["final"]).mean()),
             final_agrees_with_folded_bf16_off=float(
                 (run["final"] == bases[family]["final"]).mean()),
             finite=bool(np.isfinite(run["stage1_prob"]).all()))
        if run["samples"] != N_VAL or not np.isin(run["final"], np.arange(8)).all():
            raise AssertionError(f"{run['name']}: bad outputs")
        if k1 != want or set(run["launches"]) - {"fused_front"}:
            raise AssertionError(f"{run['name']}: launched {run['launches']}, want "
                                 f"fused_front x {want}")


# ---------------------------------------------------------------------------
# Path f: v5 and flatten serving, and path a's pipeline from reference .pt files
# ---------------------------------------------------------------------------


def make_dataset_f() -> tuple:
    """Path f's split: ``N_VAL`` 16 px val blocks with raw labels 0..9 and a QP
    drawn per block; a copy of it whose val split holds the first ``N_CPU_REF``
    blocks (the CPU's runs). Returns (card dir, CPU dir, val bundle)."""
    rng = np.random.default_rng(SEED + 6)

    def bundle(n):
        stage0 = rng.integers(0, 10, size=n).astype(np.int32)
        return Bundle(
            samples=codes(rng, (n, HW, HW, 1)),
            qps=rng.integers(0, 256, size=n).astype(np.int32),
            labels={"stage0": stage0, "stage1": (stage0 != 0).astype(np.int32),
                    "stage2": map_to_stage2_v6(stage0)[0].astype(np.int32)},
        )

    train, val = bundle(64), bundle(N_VAL)
    card, cpu = WORK / "dataset_f", WORK / "dataset_f_cpu"
    save_split(card, HW, train, val, "v6")
    save_split(cpu, HW, train, val.take(np.arange(N_CPU_REF)), "v6")
    return card, cpu, val


def v5_logits(model, x: torch.Tensor, qps: Optional[torch.Tensor]) -> dict:
    """``{head module name: logits}`` of a v5 model, as numpy."""
    with torch.inference_mode():
        out = model(x, qps if model.use_qp else None)
    return {"stage1_head": out.stage1.numpy(), "stage2_head": out.stage2.numpy(),
            **{f"specialist_heads.{h}": out.specialists[h].numpy() for h in V5_HEADS}}


def path_f_models(gen: torch.Generator, calib: torch.Tensor, val: Bundle) -> dict:
    """Path f's seeded models at the published widths, BN calibrated on
    ``calib`` and perturbed: the v5 model (base 32), its QP-conditioned twin
    and the 7-way flatten model, every head's first decision shifted to
    ``F_SHARES`` on probe blocks (the last 2,048 val blocks)."""
    probe = torch.from_numpy(val.samples[-2048:]).float() / 1023.0
    qps = torch.from_numpy(val.qps[-2048:]).float() / 255.0
    out = {"v5": seeded_model(HierarchicalModel, gen, calib),
           "v5_qp": seeded_model(functools.partial(HierarchicalModel, use_qp=True),
                                 gen, calib),
           "flat": seeded_model(Stage2FlatModel, gen, calib)}
    def spread(head, logits, share):
        # centre each class's logit on the probe blocks first, so that no class
        # wins everywhere (the QP embedding adds a near-constant vector)
        if logits.ndim == 2:
            median = np.median(logits, axis=0)
            with torch.no_grad():
                head.head[-1].bias -= torch.as_tensor(median, dtype=torch.float32)
            logits = logits - median
        set_first_class_share(head, logits, share)

    for name in ("v5", "v5_qp"):
        for head, logits in v5_logits(out[name], probe, qps).items():
            fc = types.SimpleNamespace(head=out[name].get_submodule(head).fc)
            spread(fc, logits, F_SHARES[head.split("_")[0]])
    with torch.inference_mode():
        logits = out["flat"](probe).numpy()
    spread(out["flat"].head, logits, F_SHARES["flat"])
    return out


def path_f_margins(models: dict, stage1, val: Bundle) -> dict:
    """``{model: (N_CPU_REF,) least margin of the decisions behind a label}``
    over the first ``N_CPU_REF`` val blocks, on the CPU: the stage-1
    probability's distance from ``THRESHOLD``, every other head's top-2 gap."""
    x = torch.from_numpy(val.samples[:N_CPU_REF]).float() / 1023.0
    qps = torch.from_numpy(val.qps[:N_CPU_REF]).float() / 255.0

    def margin(logits):
        if logits.ndim == 1:
            return np.abs(1 / (1 + np.exp(-logits.astype(np.float64))) - THRESHOLD)
        top = np.sort(logits, axis=-1)
        return top[:, -1] - top[:, -2]

    out = {name: np.min([margin(lg) for lg in v5_logits(models[name], x, qps).values()],
                        axis=0) for name in ("v5", "v5_qp")}
    with torch.inference_mode():
        out["flatten"] = np.minimum(margin(stage1(x).numpy()),
                                    margin(models["flat"](x).numpy()))
    return out


def path_f_plan(ckpts: dict) -> list:
    """Path f's runs: (name, (run_pipeline_eval arguments, bf16, margin key,
    labels the run may give))."""
    v5 = ["--variant", "v5", "--v5-checkpoint", str(ckpts["v5"])]
    flatten = ["--variant", "flatten", "--stage1-checkpoint", str(ckpts["stage1"]),
               "--flatten-checkpoint", str(ckpts["flat"])]
    every = tuple(range(10))
    return [
        # a warm-up run pays cuDNN's and the allocator's first calls
        ("v5_warmup", (v5, True, "v5", every)),
        # --bf16 is accepted and v5 still runs fp32, as in the JAX CLI
        ("v5", (v5, True, "v5", every)),
        # a missing AB / 1TO4 specialist falls back to its group's first id
        ("v5_rect_only", (v5 + ["--available-specialists", "RECT"], False, "v5",
                          (0, 1, 2, 3, 4, 8))),
        ("v5_qp_pt", (["--variant", "v5", "--v5-checkpoint", str(ckpts["v5_qp_pt"])],
                      False, "v5_qp", every)),
        ("flatten_warmup", (flatten, False, "flatten", tuple(range(8)))),
        ("flatten", (flatten, False, "flatten", tuple(range(8)))),
        ("flatten_bf16", (flatten, True, "flatten", tuple(range(8)))),
    ]


def check_path_f_runs(runs: list, cpu_runs: dict, margins: dict) -> None:
    """Each card run of path f: its outputs, no port kernel launched, and its
    first ``N_CPU_REF`` labels against the same CLI on the CPU in fp32
    (``cpu_runs[name]``; a warm-up run against its twin's): equal wherever the
    decision margin exceeds 1e-3 and stage-1 probabilities within 1e-4, or,
    for a bf16 run, equal on at least the share that the CPU's bf16 run
    (``cpu_runs[name + ":bf16"]``) equals, less ``BF16_SLACK``."""
    for run in runs:
        args, bf16, margin_key, allowed = run["plan"]
        name = run["name"].removesuffix("_warmup")
        cpu = cpu_runs[name]
        head = run["final"][:N_CPU_REF]
        sure = margins[margin_key] > 1e-3
        fp32 = not bf16 or margin_key.startswith("v5")  # v5 serves fp32 under --bf16
        mismatches = int((head != cpu["final"])[sure].sum())
        prob_err = float(np.abs(run["stage1_prob"][:N_CPU_REF] - cpu["stage1_prob"]).max())
        agree = float((head == cpu["final"]).mean())
        cpu_bf16 = (float((cpu_runs[f"{name}:bf16"]["final"] == cpu["final"]).mean())
                    if f"{name}:bf16" in cpu_runs else None)
        labels = np.unique(run["final"])
        emit("end_to_end", path="f_v5_flatten", run=run["name"], samples=run["samples"],
             blocks_per_s=run["blocks_per_s"], launches=run["launches"],
             cpu_blocks=N_CPU_REF, final_agrees_with_cpu=agree,
             cpu_bf16_final_agrees_with_cpu=cpu_bf16,
             guarded_share=float(sure.mean()), mismatches_above_margin=mismatches,
             stage1_prob_max_abs_diff_vs_cpu=prob_err, labels=labels.tolist(),
             finite=bool(np.isfinite(run["stage1_prob"]).all()))
        if run["samples"] != N_VAL or not np.isfinite(run["stage1_prob"]).all():
            raise AssertionError(f"{run['name']}: bad outputs")
        if not set(labels.tolist()) <= set(allowed) or len(labels) < 4:
            raise AssertionError(f"{run['name']}: labels {labels.tolist()}, want "
                                 f"several of {allowed}")
        if run["launches"]:
            raise AssertionError(f"{run['name']}: launched {run['launches']}; the v5 and "
                                 "flatten paths are plain")
        if fp32 and (mismatches or prob_err > 1e-4):
            raise AssertionError(f"{run['name']}: {mismatches} labels above the margin "
                                 f"differ from the CPU's, stage-1 probability {prob_err}")
        if not fp32 and agree < cpu_bf16 - BF16_SLACK:
            raise AssertionError(f"{run['name']}: {agree:.4f} of the labels equal the "
                                 f"CPU's fp32 run, {cpu_bf16:.4f} of the CPU's bf16 run's")


def write_reference_pt(models: dict) -> dict:
    """Path a's four stage models as reference-shaped ``.pt`` files (each state
    dict under ``model_state_dict``)."""
    out = {}
    for name in ("stage1", "stage2", "rect", "ab"):
        out[name] = WORK / "pt" / f"{name}.pt"
        out[name].parent.mkdir(parents=True, exist_ok=True)
        torch.save({"model_state_dict": models[name].state_dict()}, out[name])
    return out


def run_path_f(models: dict, ckpts: dict, dataset: Path, npz_on_run: dict, dev) -> tuple:
    """Path f: v5 and flatten serving on a dataset whose QPs vary per block,
    each run against the same CLI on the CPU (``check_path_f_runs``); then
    path a's ``--folded --fused-front on`` pipeline served from
    reference-shaped ``.pt`` files, whose labels and probabilities must equal
    ``npz_on_run``'s (path a's run of the same weights from npz). Returns
    (path f's models, its val bundle, the launches of each part)."""
    t0 = time.perf_counter()
    dataset_f, dataset_f_cpu, val_f = make_dataset_f()
    calib_f = torch.from_numpy(val_f.samples[-2560:-2048]).float() / 1023.0
    f_models = path_f_models(torch.Generator().manual_seed(SEED + 7), calib_f, val_f)
    f_ckpts = {"stage1": ckpts["stage1"], "v5_qp_pt": WORK / "pt" / "v5_qp.pt"}
    for name in ("v5", "flat"):
        f_ckpts[name] = save_variables_npz(WORK / "ckpt" / f"{name}_variables.npz",
                                           to_jax_variables(f_models[name].state_dict()))
    f_ckpts["v5_qp_pt"].parent.mkdir(parents=True, exist_ok=True)
    torch.save({"model_state_dict": f_models["v5_qp"].state_dict()}, f_ckpts["v5_qp_pt"])
    f_plan = path_f_plan(f_ckpts)
    f_margins = path_f_margins(f_models, models["stage1"], val_f)
    cpu = torch.device("cpu")
    cpu_runs = {name: run_cli(dataset_f_cpu, f"{name}_cpu", args, cpu, bf16=False)
                for name, (args, *_) in f_plan if not name.endswith("_warmup")}
    cpu_runs.update({f"{name}:bf16": run_cli(dataset_f_cpu, f"{name}_cpu_bf16", args, cpu)
                     for name, (args, bf16, key, _) in f_plan
                     if bf16 and key == "flatten" and not name.endswith("_warmup")})
    emit("f_setup", seconds=time.perf_counter() - t0, cpu_blocks=N_CPU_REF,
         models="v5 (base 32), v5 with QP embedding, Stage2FlatModel + path a's stage 1")
    f_runs, f_launches = drive("f_v5_flatten", [(name, (name, spec)) for name, spec in f_plan],
                               lambda arg: {**run_cli(dataset_f, arg[0], arg[1][0], dev,
                                                      bf16=arg[1][1]), "plan": arg[1]})
    check_path_f_runs(f_runs, cpu_runs, f_margins)
    if any(f_launches.values()):
        raise AssertionError(f"path f launched {f_launches}")

    pt_ckpts = write_reference_pt(models)
    (pt_run,), pt_launches = drive("f_reference_pt", [("v6_pt_on", (
        "v6_pt_on", ["--folded", "--fused-front", "on", *v6_checkpoints(pt_ckpts)]))],
        lambda arg: run_cli(dataset, *arg, dev))
    agree = float((pt_run["final"] == npz_on_run["final"]).mean())
    same_prob = bool(np.array_equal(pt_run["stage1_prob"], npz_on_run["stage1_prob"]))
    emit("end_to_end", path="f_reference_pt", run=pt_run["name"], samples=pt_run["samples"],
         blocks_per_s=pt_run["blocks_per_s"], launches=pt_run["launches"],
         final_agrees_with_npz_run=agree, stage1_prob_equal_to_npz_run=same_prob)
    if agree != 1.0 or not same_prob or pt_launches["fused_front"] != 4 * -(-N_VAL // BATCH):
        raise AssertionError(f"v6 from .pt: {agree} of the labels equal the npz run's, "
                             f"probabilities equal: {same_prob}, launches {pt_launches}")
    return f_models, val_f, f_launches, pt_launches


# ---------------------------------------------------------------------------
# Path g: training (train_stage1 / train_stage2 on the card)
# ---------------------------------------------------------------------------

# The reference-shaped synthetic corpus at an eighth of its documented size
# (a quarter until path k needed the time): 45,271 train and 11,349 val 16 px
# blocks with the documented class mix
TRAIN_SCALE = 0.125
TRAIN_BATCH = 256
STEP_BATCHES = (256, 4096)
# One train step on the card against the same step on the CPU (TF32 off),
# held to tests/test_torch_port_train_step.py's tolerances: the loss and the
# BN statistics in fp32, the gradients against float64 made with the card's
# discrete choices (check_step_pair)
STEP_LOSS_RTOL, STEP_GRAD_TOL, STEP_STATS_TOL, STEP_SMALL_GRAD = 1e-5, 1e-4, 1e-5, 0.1
STEP_PARITY_ROWS = 256
G_FRONT_AGREEMENT = 0.97  # least share of a front's labels equal to off's (bf16)
EPOCH_MODE_ROWS = 8192  # the resident / streaming epoch comparison: 32 steps of 256
RESUME_ROWS = 16384  # train rows of the resume check (64 steps an epoch)


def make_train_corpus() -> tuple:
    """``reference_shaped_corpus(SEED, 16, TRAIN_SCALE)`` as v6 bundles,
    written with ``save_split``. Returns (dataset dir, train, val)."""
    train, val = (build_v6_bundle(s) for s in reference_shaped_corpus(
        SEED, size=HW, scale=TRAIN_SCALE))
    root = save_split(WORK / "train_dataset", HW, train, val, "v6").parent
    return root, train, val


@contextlib.contextmanager
def deterministic_cudnn():
    """cuDNN's deterministic algorithms for the body: by default two runs of
    the same train step on the card differ (nondeterministic backward
    algorithms), so only runs made this way can be compared bitwise."""
    before = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = before


def run_train_cli(dataset: Path, name: str, module, args: list, deterministic: bool,
                  dev) -> dict:
    """One port training CLI on the corpus at batch ``TRAIN_BATCH``; returns
    its history, summary and output directory, and the CLI's seconds."""
    out = WORK / "train" / name
    t0 = time.perf_counter()
    with deterministic_cudnn() if deterministic else contextlib.nullcontext():
        quietly(module.main, ["--dataset-dir", str(dataset), "--block-size", str(HW),
                              "--batch-size", str(TRAIN_BATCH), "--output-dir", str(out),
                              "--device", dev.type, *args])
    recipe = "stage1" if module is train_stage1 else "stage2"
    return {"out": out, "recipe": recipe, "seconds": time.perf_counter() - t0,
            "history": json.loads((out / f"{recipe}_history.json").read_text()),
            "summary": json.loads((out / f"{recipe}_summary.json").read_text()),
            "deterministic": deterministic}


def report_train_runs(runs: list, smi: str) -> None:
    """Each run's epochs (phase, losses, val F1, samples/s); every loss finite,
    every checkpoint and export written."""
    for run in runs:
        recipe = run["recipe"]
        for h in run["history"]:
            emit("train_epoch", path="g_train", run=run["name"], epoch=h["epoch"],
                 train_phase=h["phase"], train_loss=h["train_loss"], val_loss=h["val_loss"],
                 val_macro_f1=h["val_metrics"]["macro_f1"],
                 val_accuracy=h["val_metrics"]["accuracy"],
                 train_seconds=h["train_seconds"], samples_per_s=h["throughput"],
                 nvidia_smi=smi)
        emit("train_run", path="g_train", run=run["name"], seconds=run["seconds"],
             best_value=run["summary"]["best_value"], launches=run["launches"],
             deterministic_cudnn=run["deterministic"])
        losses = [v for h in run["history"] for v in (h["train_loss"], h["val_loss"])]
        if not all(map(math.isfinite, losses)):
            raise AssertionError(f"{run['name']}: a loss is not finite: {losses}")
        for part in ("best", "last", "final"):
            if not (run["out"] / f"{recipe}_{part}" / "state.pt").exists():
                raise AssertionError(f"{run['name']}: no {recipe}_{part} checkpoint")
        if not (run["out"] / f"{recipe}_best_variables.npz").exists():
            raise AssertionError(f"{run['name']}: no export")


def check_resume(train: Bundle, val: Bundle, dev) -> None:
    """``train_stage`` on the first ``RESUME_ROWS`` train rows for two epochs,
    and the same run stopped after epoch 0 and resumed from ``stage1_last``,
    both with cuDNN's deterministic algorithms: the final states must be
    equal bitwise, as on the CPU (tests/test_torch_port_train_step.py)."""
    t0 = time.perf_counter()
    train, val = train.take(np.arange(RESUME_ROWS)), val.take(np.arange(RESUME_ROWS // 4))
    recipe = replace(stage1_recipe(epochs=2, batch_size=TRAIN_BATCH), input_shape=(HW, HW, 1))
    quiet = lambda line: None
    with deterministic_cudnn():
        full = train_stage(recipe, train, val, seed=42, device=dev, log=quiet)
        split = WORK / "train" / "resume"
        train_stage(recipe, train, val, seed=42, checkpoint_dir=split, stop_after_epoch=0,
                    device=dev, log=quiet)
        resumed = train_stage(recipe, train, val, seed=42, checkpoint_dir=split,
                              resume_from=split / "stage1_last", device=dev, log=quiet)
    want, got = full.state.model.state_dict(), resumed.state.model.state_dict()
    diffs = {k: (got[k].double() - v.double()).abs().max().item()
             for k, v in want.items() if v.is_floating_point()}
    same_opt = states_equal(full.state, resumed.state)
    emit("resume", path="g_train", rows=RESUME_ROWS,
         epochs=[h["epoch"] for h in resumed.history],
         max_abs_diff=max(diffs.values()), optimizer_state_bitwise_equal=same_opt,
         val_loss=resumed.history[-1]["val_loss"],
         uninterrupted_val_loss=full.history[-1]["val_loss"],
         seconds=time.perf_counter() - t0)
    if ([h["epoch"] for h in resumed.history] != [1] or any(diffs.values())
            or not same_opt):
        raise AssertionError(f"resume: epochs {[h['epoch'] for h in resumed.history]}, "
                             f"largest difference {max(diffs.values())}, "
                             f"optimizer state equal: {same_opt}")


class DecisionTape(TorchFunctionMode):
    """The discrete choices of a forward: each ReLU's mask, each max pool's
    indices and each ``amax``'s maximal elements, in call order. Made
    without ``choices`` it records them and changes nothing; made with a
    recorded list it replays them in another forward of the same code, where
    each ReLU multiplies by its mask and each max takes its recorded
    elements (ties shared as ``amax``'s gradient shares them). A float64
    step so replayed makes the choices of the fp32 step it was recorded
    from: where an input of a ReLU or a max lies within rounding of its
    threshold, the two would otherwise send one gradient entry down
    different paths, an error of the order of that entry, not of rounding."""

    def __init__(self, choices: Optional[list] = None):
        super().__init__()
        self.replaying = choices is not None
        self.choices = [] if choices is None else choices
        self.used = 0

    def _next(self, x: torch.Tensor, shape=None) -> torch.Tensor:
        choice = self.choices[self.used]
        self.used += 1
        if shape is not None and tuple(choice.shape) != tuple(shape):
            raise AssertionError(f"replayed choice {self.used - 1} has shape "
                                 f"{tuple(choice.shape)}, the forward {tuple(shape)}")
        return choice.to(x.device)

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name, x = getattr(func, "__name__", ""), args[0] if args else None
        if name == "relu":
            if self.replaying:
                return x * self._next(x, x.shape).to(x.dtype)
            out = func(*args, **kwargs)
            self.choices.append(out.detach() > 0)
            return out
        if name == "max_pool2d":
            if self.replaying:
                idx = self._next(x)
                return x.flatten(2).gather(2, idx.flatten(2)).view(idx.shape)
            out = func(*args, **kwargs)
            with torch.no_grad():
                self.choices.append(F.max_pool2d_with_indices(
                    x.detach(), *args[1:], **{k: v for k, v in kwargs.items()
                                              if k != "return_indices"})[1])
            return out
        if name == "amax":
            dim = kwargs.get("dim", args[1] if len(args) > 1 else ())
            keepdim = kwargs.get("keepdim", args[2] if len(args) > 2 else False)
            if self.replaying:
                top = self._next(x, x.shape).to(x.dtype)
                return (x * top / top.sum(dim=dim, keepdim=True)).sum(dim=dim, keepdim=keepdim)
            out = func(*args, **kwargs)
            self.choices.append(x.detach() == x.detach().amax(dim=dim, keepdim=True))
            return out
        return func(*args, **kwargs)


def captured_step(model: nn.Module, opt, step: Callable) -> dict:
    """Run ``step()`` (one train step that ends in ``opt.step()``) with
    dropout off and return the loss it returns, the gradients ``opt`` was
    given before its clip (by parameter name, the FGVC centers as
    ``centers``), the state dict after it and its forward's discrete
    choices (:class:`DecisionTape`)."""
    for mod in model.modules():
        if isinstance(mod, nn.Dropout):
            mod.p = 0.0
    names = {id(p): n for n, p in model.named_parameters()}
    grads, inner = {}, opt.step

    def capturing():
        grads.update({names.get(id(p), "centers"): (
            torch.zeros_like(p) if p.grad is None else p.grad.detach().clone()).cpu()
            for p in opt.params})
        inner()

    opt.step = capturing
    with DecisionTape() as tape:
        loss = step()
    return {"loss": float(loss), "grads": grads, "choices": tape.choices,
            "state": {k: v.cpu() for k, v in model.state_dict().items()}}


def _one_step(model_cls, variables, opt_fn, loss_fn, label_key, classes, binary,
              samples, labels, device) -> dict:
    """One fp32 train step of the port on ``device`` (no augment, dropout
    off), as :func:`captured_step` returns it."""
    model = load_jax_variables(model_cls(), variables).to(device)
    opt = opt_fn(model)
    cfg = StepConfig(loss_fn=loss_fn, label_key=label_key, binary=binary, num_classes=classes)
    step = make_train_step(model, opt, cfg)
    batch = {"samples": torch.from_numpy(samples).to(device),
             label_key: torch.from_numpy(labels).to(device)}
    return captured_step(model, opt, lambda: step(
        TrainState(model, opt), batch, torch.Generator(device=device).manual_seed(0))["loss"])


def check_step_parity(s1_run: dict, s2_run: dict, val: Bundle, dev) -> None:
    """One fp32 step of the trained stage-1 model (AdamW) and stage-2 model
    (the unfrozen ULMFiT phase) on the card against the same step on the
    CPU, same weights and batch: loss, every gradient, the BN statistics."""
    samples = val.samples[:STEP_PARITY_ROWS]
    counts = class_counts(val.labels["stage2"], 3)
    cases = {
        "stage1": (Stage1Model, s1_run["out"] / "stage1_best_variables.npz",
                   lambda m: as_optimizer(m, adamw(cosine_schedule(1e-3, 10))),
                   lambda lo, ta: binary_focal_loss(lo, ta, 0.25, 2.5), "stage1", 2, True),
        "stage2_unfrozen": (Stage2Model, s2_run["out"] / "stage2_best_variables.npz",
                            lambda m: ulmfit_phase2(m, 5e-4, 1e-6, 10),
                            lambda lo, ta: class_balanced_focal_loss(lo, ta, counts),
                            "stage2", 3, False),
    }
    for name, (cls, path, opt_fn, loss_fn, key, classes, binary) in cases.items():
        variables = load_variables_npz(path)
        labels = np.clip(val.labels[key][:STEP_PARITY_ROWS], 0, None).astype(np.int32)
        args = (cls, variables, opt_fn, loss_fn, key, classes, binary, samples, labels)

        def loss64(model, device, loss_fn=loss_fn, labels=labels):
            x = torch.from_numpy(samples).to(device).double() / 1023.0
            return loss_fn(model(x), torch.from_numpy(labels).to(device).long())

        check_step_pair("g_train", name, functools.partial(_one_step, *args),
                        lambda d, choices, cls=cls, v=variables, loss64=loss64: fp64_grads(
                            load_jax_variables(cls(), v), loss64, d, choices), dev)


def fp64_grads(model: nn.Module, loss_of: Callable, device, choices: list,
               extra: Optional[dict] = None) -> dict:
    """The gradients of ``loss_of(model, device, **extra)`` with ``model``
    (train mode, dropout off) in float64 on ``device``, replaying the
    recorded ``choices`` (:class:`DecisionTape`), by parameter name, and of
    the float64 tensors in ``extra`` (the FGVC centers) under their names,
    on the CPU."""
    model = model.to(device, torch.float64).train()
    for mod in model.modules():
        if isinstance(mod, nn.Dropout):
            mod.p = 0.0
    extra = {k: nn.Parameter(v.to(device, torch.float64)) for k, v in (extra or {}).items()}
    with DecisionTape(choices) as tape:
        loss = loss_of(model, device, **extra)
    if tape.used != len(choices):
        raise AssertionError(f"the float64 forward made {tape.used} of the "
                             f"{len(choices)} recorded choices")
    loss.backward()
    grads = {n: p.grad.detach().cpu() for n, p in model.named_parameters()
             if p.grad is not None}
    grads.update({k: v.grad.detach().cpu() for k, v in extra.items()})
    return grads


@contextlib.contextmanager
def tf32_on():
    """TF32 in cuDNN's convolutions and cuBLAS's products for the body
    (``main`` turns both off)."""
    before = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = before


def grad_err_of_largest(got: dict, want: dict) -> tuple:
    """The largest gradient difference, each tensor's over its largest entry
    floored at ``STEP_SMALL_GRAD`` times the largest entry of all, and the
    tensor that has it."""
    largest = max(g.abs().max().item() for g in want.values())
    return max(((got[n].double() - g.double()).abs().max().item()
                / max(g.abs().max().item(), STEP_SMALL_GRAD * largest), n)
               for n, g in want.items())


def check_step_pair(path: str, name: str, step: Callable, fp64: Callable, dev) -> None:
    """A train step on the card against the same step on the CPU.
    ``step(device)`` runs the fp32 step (as :func:`captured_step` returns
    it), ``fp64(device, choices)`` returns the same step's gradients in
    float64, made with the recorded ``choices`` (:class:`DecisionTape`).

    The loss within ``STEP_LOSS_RTOL`` and the BN statistics after the step
    within ``STEP_STATS_TOL`` of the CPU's fp32 step; the card's fp32
    gradients and its float64 ones within ``STEP_GRAD_TOL`` of each tensor's
    largest entry (floored at ``STEP_SMALL_GRAD`` of the largest of all) from
    the CPU's float64 gradients made with the card's fp32 choices. The card's
    step with TF32 on, held the same way to the CPU's float64 step made with
    its own choices, is the control: it must miss ``STEP_GRAD_TOL``, or the
    bound could not see a backward that rounds coarser than fp32.

    Why the float64 step replays the fp32 step's choices: where the input of
    a ReLU, a max pool or a channel max lies within rounding of its threshold
    or of a rival, fp32 and float64 may choose differently, and that one
    choice moves a gradient entry by its own size. Such choices turn up in
    some runs and not in others, on either device, with the trained weights
    and the batch: held to float64 without the replay, a sound fp32 FGVC step
    on an H100 read 1.2e-2 of a tensor's largest entry, more than TF32 steps
    of other runs. With the replay only rounding is left."""
    cpu_dev = torch.device("cpu")
    card, cpu = step(dev), step(cpu_dev)
    with tf32_on():
        control = step(dev)
    cpu64 = fp64(cpu_dev, card["choices"])
    fp64_err, fp64_worst = grad_err_of_largest(fp64(dev, card["choices"]), cpu64)
    fp32_err, fp32_worst = grad_err_of_largest(card["grads"], cpu64)
    tf32_err, tf32_worst = grad_err_of_largest(control["grads"],
                                               fp64(cpu_dev, control["choices"]))
    stats_err = max((card["state"][k] - v).abs().max().item() / v.abs().max().item()
                    for k, v in cpu["state"].items()
                    if k.endswith(("running_mean", "running_var")))
    loss_err = abs(card["loss"] - cpu["loss"]) / abs(cpu["loss"])
    emit("step_parity", path=path, model=name, batch=STEP_PARITY_ROWS, loss=card["loss"],
         loss_rel_err=loss_err, stats_err_of_largest=stats_err, tensors=len(cpu["grads"]),
         choices=len(card["choices"]),
         fp64_grad_err_of_largest=fp64_err, fp64_worst_tensor=fp64_worst,
         fp32_grad_err_of_largest=fp32_err, fp32_worst_tensor=fp32_worst,
         tf32_control_grad_err_of_largest=tf32_err, tf32_control_worst_tensor=tf32_worst)
    if (loss_err > STEP_LOSS_RTOL or stats_err > STEP_STATS_TOL or fp64_err > STEP_GRAD_TOL
            or fp32_err > STEP_GRAD_TOL or tf32_err <= STEP_GRAD_TOL):
        raise AssertionError(f"{name}: the card's train step disagrees with the CPU's "
                             f"(loss {loss_err}, stats {stats_err}, float64 gradients "
                             f"{fp64_err} at {fp64_worst}, fp32 gradients {fp32_err} at "
                             f"{fp32_worst}; the TF32 control {tf32_err} at {tf32_worst} "
                             f"must exceed {STEP_GRAD_TOL})")


def g_serving_plan(s1_run: dict, s2_run: dict, ckpts: dict) -> list:
    """The trained stage-1 and stage-2 exports with path a's stage-3 models,
    served folded in bf16 with each front."""
    args = ["--stage1-checkpoint", str(s1_run["out"] / "stage1_best_variables.npz"),
            "--stage2-checkpoint", str(s2_run["out"] / "stage2_best_variables.npz"),
            "--stage3-rect-checkpoint", str(ckpts["rect"]),
            "--stage3-ab-checkpoint", str(ckpts["ab"]), "--no-ab-fgvc"]
    return [(name, (name, ["--folded", "--fused-front", front, *args]))
            for name, front in (("g_off", "off"), ("g_on", "on"), ("g_g1", "g1"))]


def check_g_serving(runs: list, n_val: int) -> None:
    base = runs[0]
    for run in runs:
        agree = float((run["final"] == base["final"]).mean())
        emit("end_to_end", path="g_serving", run=run["name"], samples=run["samples"],
             blocks_per_s=run["blocks_per_s"], launches=run["launches"],
             final_agrees_with_off=agree,
             stage1_prob_max_abs_diff_vs_off=float(
                 np.abs(run["stage1_prob"] - base["stage1_prob"]).max()))
        if run["samples"] != n_val or not np.isfinite(run["stage1_prob"]).all():
            raise AssertionError(f"{run['name']}: bad outputs")
        # bf16 fronts round where cuDNN's bf16 stem does not: path a's and path
        # d's agree with off on 98.7-99.9% of labels, this path's first run on 98.8%
        if agree < G_FRONT_AGREEMENT:
            raise AssertionError(f"{run['name']}: {agree} of the labels equal off's")
    expect = {"g_on": "fused_front", "g_g1": "fused_front_g1"}
    for run in runs:
        kernel = expect.get(run["name"])
        if kernel and run["launches"].get(kernel, 0) == 0:
            raise AssertionError(f"{run['name']}: {kernel} never launched")


def train_timing_phase(s1_run: dict, train: Bundle, dev, smi: str) -> None:
    """Step ms at batch 256 and 4096, fp32 and bf16 (the stage-1 recipe's
    step with its augmentation; CUDA events, each sample the mean of 10
    steps, the median of ABBA turns); kernels, host launch calls, device busy
    ms and idle share per step (``torch.profiler``), and at batch 4096 the
    kernels that take the most device time; samples/s of an epoch
    over ``EPOCH_MODE_ROWS`` train rows, resident and streaming in ABBA
    turns; the seconds of a verified ``save_checkpoint``."""
    variables = load_variables_npz(s1_run["out"] / "stage1_best_variables.npz")
    recipe = stage1_recipe(epochs=1, batch_size=TRAIN_BATCH)
    rng = np.random.default_rng(SEED + 9)

    def make(batch, dtype):
        model = load_jax_variables(Stage1Model(), variables).to(dev)
        opt = as_optimizer(model, adamw(cosine_schedule(1e-3, 1000)))
        cfg = StepConfig(loss_fn=recipe.loss_fn, label_key="stage1", augment=recipe.augment,
                         binary=True, num_classes=2, compute_dtype=dtype)
        step, state = make_train_step(model, opt, cfg), TrainState(model, opt)
        idx = rng.integers(0, len(train), batch)
        data = {"samples": torch.from_numpy(train.samples[idx]).to(dev),
                "stage1": torch.from_numpy(train.labels["stage1"][idx]).to(dev)}
        gen = torch.Generator(device=dev).manual_seed(0)
        return lambda: step(state, data, gen), state

    for batch in STEP_BATCHES:
        fns = {name: make(batch, dtype)[0] for name, dtype in
               (("fp32", torch.float32), ("bf16", torch.bfloat16))}
        for fn in fns.values():
            for _ in range(3):
                fn()
        samples_ms = {name: [] for name in fns}
        for name in ["fp32", "bf16", "bf16", "fp32"]:
            samples_ms[name].append(time_ms(fns[name], iters=10, warmup=1))
        for name, fn in fns.items():
            trace = trace_calls(fn)
            ms = float(np.median(samples_ms[name]))
            busy = trace["device_busy_ms"]
            extra = ({"top_kernels": device_time_by_kernel(fn)} if batch == max(STEP_BATCHES)
                     else {})
            emit("train_step", batch=batch, dtype=name, step_ms=ms, samples_ms=samples_ms[name],
                 samples_per_s=batch / ms * 1e3, kernels_per_step=trace["kernels"],
                 host_launch_calls_per_step=trace["host_launch_calls"],
                 device_busy_ms=busy,
                 idle_share=None if busy is None else max(0.0, 1.0 - busy / ms),
                 port_kernels_per_step=launched_by(fn), nvidia_smi=smi, **extra)
            if launched_by(fn):
                raise AssertionError("a train step launched a port kernel")

    fn, state = make(TRAIN_BATCH, torch.float32)
    arrays = {"samples": train.samples[:EPOCH_MODE_ROWS],
              "stage1": train.labels["stage1"][:EPOCH_MODE_ROWS]}
    resident = to_device(arrays, dev)
    model, opt = state.model, state.optimizer
    cfg = StepConfig(loss_fn=recipe.loss_fn, label_key="stage1", augment=recipe.augment,
                     binary=True, num_classes=2)
    step = make_train_step(model, opt, cfg)
    for mode in ("resident", "streaming", "streaming", "resident"):
        gen = torch.Generator(device=dev).manual_seed(1)
        if mode == "resident":
            _, result = run_train_epoch_resident(step, state, resident, TRAIN_BATCH, gen, 1, 2,
                                                 balance_labels=arrays["stage1"])
        else:
            _, result = run_train_epoch(step, state, arrays, TRAIN_BATCH, gen, 1, 2,
                                        balance_labels=arrays["stage1"], device=dev)
        emit("train_epoch_mode", mode=mode, batch=TRAIN_BATCH, samples=result.samples,
             seconds=result.seconds, samples_per_s=result.throughput, nvidia_smi=smi)
    seconds = []
    for i in range(3):
        t0 = time.perf_counter()
        save_checkpoint(WORK / "train" / f"save_{i}", state, meta={"epoch": i}, verify=True)
        seconds.append(time.perf_counter() - t0)
    emit("save_checkpoint", verify=True, seconds=seconds,
         state_bytes=(WORK / "train" / "save_0" / "state.pt").stat().st_size, nvidia_smi=smi)


def run_path_g(ckpts: dict, dev, smi: str) -> tuple:
    """Path g: the corpus, the training CLIs (stage 1 fp32 and bf16, then
    stage 2 through its frozen and unfrozen phases from stage 1's export),
    which must launch none of K1-K5; a library resume; one step on the card
    against the CPU; the trained exports served with each front (K1, K2).
    Returns the serving runs' launches and what path h trains on: the
    corpus's directory, its val split and the two exports."""
    t0 = time.perf_counter()
    dataset, train, val = make_train_corpus()
    emit("g_setup", seconds=time.perf_counter() - t0, train_blocks=len(train),
         val_blocks=len(val), train_stage1_counts=class_counts(train.labels["stage1"], 2),
         train_stage2_counts=class_counts(train.labels["stage2"], 3))
    s1_export = WORK / "train" / "s1" / "stage1_best_variables.npz"
    plan = [("s1", (train_stage1, ["--epochs", "2"], False)),
            ("s1_bf16", (train_stage1, ["--epochs", "2", "--bf16"], False)),
            ("s2", (train_stage2, ["--epochs", "2", "--freeze-epochs", "1",
                                   "--stage1-checkpoint", str(s1_export)], False))]
    runs, launches = drive("g_train", [(name, (name, *spec)) for name, spec in plan],
                           lambda arg: run_train_cli(dataset, *arg, dev))
    report_train_runs(runs, smi)
    if any(launches.values()):
        raise AssertionError(f"training launched port kernels: {launches}")
    by_name = {run["name"]: run for run in runs}
    if [h["phase"] for h in by_name["s2"]["history"]] != ["frozen", "unfrozen"]:
        raise AssertionError("stage 2 did not run its frozen and unfrozen phases")
    check_resume(train, val, dev)
    check_step_parity(by_name["s1"], by_name["s2"], val, dev)
    serving, serving_launches = drive(
        "g_serving", g_serving_plan(by_name["s1"], by_name["s2"], ckpts),
        lambda arg: run_cli(dataset, *arg, dev))
    check_g_serving(serving, len(val))
    train_timing_phase(by_name["s1"], train, dev, smi)
    loaded = sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN_MODULES)
    if loaded:
        raise AssertionError(f"path g loaded {loaded[:5]}")
    return serving_launches, {
        "dataset": dataset, "val": val,
        "stage1": by_name["s1"]["out"] / "stage1_best_variables.npz",
        "stage2": by_name["s2"]["out"] / "stage2_best_variables.npz"}


# Path h: the rest of training (prepare_stage3, train_stage3, train_stage2_flat,
# train_unified) on path g's corpus, then the fully trained ladder served
H_MEMBERS = 2          # prepare_stage3 --ensemble-members and train_stage3 --ensemble
FGVC_BATCH = 128       # train_stage3 --fgvc --batch-size
H_NOISE_RATIO = 0.25


def h_train_plan(g_out: dict, stage3: Path, flat: Path) -> list:
    """Path h's trainers in order: ``(name, (name, module, argv, history
    names, export))``; each runs at batch ``TRAIN_BATCH`` unless its argv sets
    one."""
    s3 = ["--dataset-dir", str(stage3)]
    s2 = ["--stage2-checkpoint", str(g_out["stage2"])]
    rect_out, fgvc_out = WORK / "train_h" / "rect", WORK / "train_h" / "ab_fgvc"
    teachers = ["--stage1-checkpoint", str(g_out["stage1"]), *s2,
                "--stage3-rect-checkpoint", str(rect_out / "stage3_rect_best_variables.npz"),
                "--stage3-ab-checkpoint", str(fgvc_out / "stage3_ab_fgvc_best_variables.npz")]
    g_data = ["--dataset-dir", str(g_out["dataset"])]
    return [
        ("rect", ("rect", train_stage3, [*s3, "--head", "RECT", "--epochs", "2", *s2],
                  ["stage3_rect"], "stage3_rect_best_variables.npz")),
        ("rect_noise", ("rect_noise", train_stage3, [*s3, "--head", "RECT", "--epochs", "2", *s2,
                                       "--noise-ratio", str(H_NOISE_RATIO),
                                       "--noise-dataset-dir", str(g_out["dataset"])],
                        ["stage3_rect"], "stage3_rect_best_variables.npz")),
        ("ab_fgvc", ("ab_fgvc", train_stage3, [*s3, "--head", "AB", "--fgvc", "--epochs", "2", *s2,
                                    "--batch-size", str(FGVC_BATCH)],
                     ["stage3_ab_fgvc"], "stage3_ab_fgvc_best_variables.npz")),
        ("ab_ensemble", ("ab_ensemble", train_stage3, [*s3, "--head", "AB", "--ensemble", str(H_MEMBERS),
                                        "--epochs", "2", *s2],
                         [f"stage3_ab_member{i}" for i in range(1, H_MEMBERS + 1)],
                         "ensemble/ensemble.json")),
        ("v5_ab", ("v5_ab", train_stage3, [*s3, "--variant", "v5", "--head", "AB", "--epochs", "1"],
                   ["v5_stage3_AB"], "v5_stage3_AB_best_variables.npz")),
        ("flat", ("flat", train_stage2_flat, ["--dataset-dir", str(flat), "--freeze-epochs", "1",
                                      "--epochs", "2"],
                  ["stage2_flat"], "stage2_flat_best_variables.npz")),
        ("unified", ("unified", train_unified, [*g_data, "--epochs", "2"], ["unified"],
                     "unified_best_variables.npz")),
        ("unified_kd", ("unified_kd", train_unified, [*g_data, "--epochs", "1", "--distill-weight", "0.5",
                                        *teachers], ["unified"],
                        "unified_best_variables.npz")),
    ]


def run_h_cli(name: str, module, argv: list, histories: list, export: str, dev) -> dict:
    """One of path h's training CLIs; returns its histories, output directory
    and seconds."""
    out = WORK / "train_h" / name
    batch = [] if "--batch-size" in argv else ["--batch-size", str(TRAIN_BATCH)]
    t0 = time.perf_counter()
    quietly(module.main, [*argv, "--block-size", str(HW), *batch, "--output-dir", str(out),
                          "--device", dev.type])
    seconds = time.perf_counter() - t0
    if not (out / export).exists():
        raise AssertionError(f"{name}: no {export}")
    return {"out": out, "seconds": seconds,
            "histories": {h: json.loads((out / f"{h}_history.json").read_text())
                          for h in histories}}


def report_h_runs(runs: list, smi: str) -> None:
    """Each trainer's epochs (phase, losses, val macro-F1, seconds,
    samples/s) and its run line; every loss finite."""
    for run in runs:
        best = {}
        for recipe, history in run["histories"].items():
            for h in history:
                emit("train_epoch", path="h_train", run=run["name"], recipe=recipe,
                     epoch=h["epoch"], train_phase=h.get("phase"),
                     train_loss=h["train_loss"], val_loss=h["val_loss"],
                     val_macro_f1=h["val_metrics"]["macro_f1"],
                     val_accuracy=h["val_metrics"]["accuracy"],
                     train_seconds=h["train_seconds"], samples_per_s=h["throughput"],
                     nvidia_smi=smi)
            losses = [v for h in history for v in (h["train_loss"], h["val_loss"])]
            if not history or not all(map(math.isfinite, losses)):
                raise AssertionError(f"{run['name']}: no epoch, or a loss is not finite")
            best[recipe] = max(h["val_metrics"]["macro_f1"] for h in history)
        emit("train_run", path="h_train", run=run["name"], seconds=run["seconds"],
             best_val_macro_f1=best, launches=run["launches"],
             epochs={k: len(v) for k, v in run["histories"].items()})


def _to_device(tree, dev):
    """Every tensor of a nest of dicts and lists moved to ``dev``."""
    if isinstance(tree, torch.Tensor):
        return tree.to(dev)
    if isinstance(tree, dict):
        return {k: _to_device(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_device(v, dev) for v in tree]
    return tree


def check_h_step_parity(runs: dict, g_out: dict, dev) -> None:
    """One fp32 step of the trained FGVC model (CutMix, the center loss,
    the clipped AdamW over model and centers) and of the trained unified model
    with distillation (teacher columns from path g's stage 1 and 2 and this
    path's RECT and FGVC models), each on the card against the same step on
    the CPU with the same draws."""
    val = g_out["val"]
    samples = val.samples[:STEP_PARITY_ROWS]
    images = torch.from_numpy(samples).float() / 1023.0
    fgvc_vars = load_variables_npz(runs["ab_fgvc"]["out"] / "stage3_ab_fgvc_best_variables.npz")
    ab = np.clip(val.labels["stage3_AB"][:STEP_PARITY_ROWS], 0, None)
    fgvc_draw = fgvc_draws(torch.Generator().manual_seed(SEED + 11), images)

    def fgvc_step(device):
        model = load_jax_variables(FGVCModel(), fgvc_vars).to(device).train()
        centers = nn.Parameter(torch.tensor(fgvc_vars["centers"]["centers"], device=device))
        opt = TrainOptimizer([("all", [*model.parameters(), centers],
                               adamw(cosine_schedule(1e-3, 10), grad_clip=1.0))])

        def step():
            total, _, _, _ = fgvc_loss(model, centers, images.to(device),
                                       torch.from_numpy(ab).to(device),
                                       _to_device(fgvc_draw, device), 0.001, 4)
            opt.zero_grad()
            total.backward(inputs=opt.params)
            opt.step()
            return total.detach()

        return captured_step(model, opt, step)

    def fgvc_loss64(model, device, centers):
        return fgvc_loss(model, centers, images.to(device).double(),
                         torch.from_numpy(ab).to(device).long(),
                         _to_device(fgvc_draw, device), 0.001, 4)[0]

    check_step_pair("h_train", "fgvc", fgvc_step, lambda d, choices: fp64_grads(
        load_jax_variables(FGVCModel(), fgvc_vars), fgvc_loss64, d, choices,
        {"centers": torch.from_numpy(fgvc_vars["centers"]["centers"])}), dev)

    teachers = PipelineModels(*(load_model(path, cls) for path, cls in (
        (g_out["stage1"], Stage1Model), (g_out["stage2"], Stage2Model),
        (runs["rect"]["out"] / "stage3_rect_best_variables.npz", Stage3RectModel),
        (runs["ab_fgvc"]["out"] / "stage3_ab_fgvc_best_variables.npz", FGVCModel))))
    subset = val.take(np.arange(STEP_PARITY_ROWS))
    packed = pack_unified_labels(subset, compute_teacher_logits(teachers, samples,
                                                                device="cpu"))
    uni_vars = load_variables_npz(runs["unified_kd"]["out"] / "unified_best_variables.npz")
    loss_fn = make_unified_loss(class_counts(val.labels["stage2"], 3),
                                class_counts(val.labels["stage3_AB"], 4), distill_weight=0.5)
    noise_draw = draw_pipeline(UNIFIED_NOISE_ONLY, torch.Generator().manual_seed(SEED + 12),
                               images)

    def unified_step(device):
        model = load_jax_variables(UnifiedV6Model(), uni_vars).to(device)
        opt = as_optimizer(model, adamw(cosine_schedule(1e-3, 10)))
        draws = _to_device(noise_draw, device)
        cfg = StepConfig(
            loss_fn=loss_fn, label_key="unified", num_classes=8,
            augment_labeled=lambda gen, x, y: apply_pipeline(UNIFIED_NOISE_ONLY, x, y, draws),
            predictions_fn=make_unified_predictions(), metric_labels_fn=unified_metric_labels)
        step = make_train_step(model, opt, cfg)
        batch = {"samples": torch.from_numpy(samples).to(device),
                 "unified": torch.from_numpy(packed).to(device)}
        return captured_step(model, opt, lambda: step(
            TrainState(model, opt), batch, torch.Generator(device=device))["loss"])

    def unified_loss64(model, device):
        x, y = apply_pipeline(UNIFIED_NOISE_ONLY, images.to(device).double(),
                              torch.from_numpy(packed).to(device).double(),
                              _to_device(noise_draw, device))
        return loss_fn(model(x), y)

    check_step_pair("h_train", "unified_distilled", unified_step, lambda d, choices: fp64_grads(
        load_jax_variables(UnifiedV6Model(), uni_vars), unified_loss64, d, choices), dev)


def h_serving_plan(g_out: dict, runs: dict) -> list:
    """The fully trained ladder (path g's stage 1 and 2, this path's RECT and
    AB-FGVC) folded in bf16 with each front; the trained unified model folded
    with each front; the trained AB ensemble on the plain graph."""
    ladder = ["--stage1-checkpoint", str(g_out["stage1"]),
              "--stage2-checkpoint", str(g_out["stage2"]),
              "--stage3-rect-checkpoint",
              str(runs["rect"]["out"] / "stage3_rect_best_variables.npz")]
    fgvc = ["--stage3-ab-checkpoint",
            str(runs["ab_fgvc"]["out"] / "stage3_ab_fgvc_best_variables.npz"), "--ab-fgvc"]
    unified = ["--variant", "unified", "--folded", "--unified-checkpoint",
               str(runs["unified"]["out"] / "unified_best_variables.npz")]
    return [
        *((f"h_{mode}", (f"h_{mode}", ["--folded", "--fused-front", mode, *ladder, *fgvc]))
          for mode in ("off", "on", "g1")),
        *((f"h_unified_{mode}", (f"h_unified_{mode}", [*unified, "--fused-front", mode]))
          for mode in ("off", "on", "g1")),
        ("h_ensemble", ("h_ensemble", [*ladder, "--stage3-ab-ensemble-dir",
                                       str(runs["ab_ensemble"]["out"] / "ensemble")])),
    ]


def check_h_serving(runs: list, n_val: int) -> None:
    """Each run's outputs; the fronts' labels against their family's ``off``
    run (at least ``G_FRONT_AGREEMENT``) and K1 / K2 at their expected
    counts: one launch a batch for each folded stage (the FGVC AB stage has
    its own unfolded forward, so three stages per-stage; one for unified)."""
    by_name = {run["name"]: run for run in runs}
    batches = -(-n_val // BATCH)
    expect = {"h_on": {"fused_front": 3 * batches}, "h_g1": {"fused_front_g1": 3 * batches},
              "h_unified_on": {"fused_front": batches},
              "h_unified_g1": {"fused_front_g1": batches}}
    for run in runs:
        base = by_name["h_unified_off" if "unified" in run["name"] else "h_off"]
        agree = float((run["final"] == base["final"]).mean())
        emit("end_to_end", path="h_serving", run=run["name"], samples=run["samples"],
             blocks_per_s=run["blocks_per_s"], launches=run["launches"],
             expected_launches=expect.get(run["name"], {}), final_agrees_with_off=agree,
             final_agrees_with_ladder_off=float((run["final"] == by_name["h_off"]["final"])
                                                .mean()))
        if (run["samples"] != n_val or not np.isfinite(run["stage1_prob"]).all()
                or not np.isin(run["final"], np.arange(8)).all()):
            raise AssertionError(f"{run['name']}: bad outputs")
        if run["name"] != "h_ensemble" and agree < G_FRONT_AGREEMENT:
            raise AssertionError(f"{run['name']}: {agree} of the labels equal off's")
        if run["launches"] != expect.get(run["name"], {}):
            raise AssertionError(f"{run['name']}: launches {run['launches']}, expected "
                                 f"{expect.get(run['name'], {})}")


H_STEP_BATCHES = {"fgvc": FGVC_BATCH, "unified": TRAIN_BATCH}


def h_step_timing(runs: dict, train: Bundle, stage3: Path, dev, smi: str) -> None:
    """Step ms of the FGVC composite step (batch 128, on the AB train split)
    and the unified step (batch 256, hard labels), fp32, on the trained
    exports: CUDA events, each sample the mean of 10 steps, the median of
    ABBA turns; kernels, host launch calls, device busy ms and idle share per
    step (``torch.profiler``). Neither may launch a port kernel."""
    rng = np.random.default_rng(SEED + 13)
    fgvc_vars = load_variables_npz(runs["ab_fgvc"]["out"] / "stage3_ab_fgvc_best_variables.npz")
    model = load_jax_variables(FGVCModel(), fgvc_vars).to(dev)
    centers = nn.Parameter(torch.tensor(fgvc_vars["centers"]["centers"], device=dev))
    opt = TrainOptimizer([("all", [*model.parameters(), centers],
                           adamw(cosine_schedule(1e-3, 1000), grad_clip=1.0))])
    ab = Bundle.load(stage3 / "AB" / f"block_{HW}" / "train.npz")
    idx = rng.integers(0, len(ab), FGVC_BATCH)
    fgvc_batch = {"samples": torch.from_numpy(ab.samples[idx]).to(dev),
                  "stage3_AB": torch.from_numpy(ab.labels["stage3_AB"][idx]).to(dev)}
    fgvc_step = make_fgvc_train_step(model, opt, centers)
    fgvc_state = TrainState(model, opt)

    uni_model = load_jax_variables(
        UnifiedV6Model(), load_variables_npz(runs["unified"]["out"] / "unified_best_variables.npz")
    ).to(dev)
    recipe = unified_recipe(class_counts(train.labels["stage2"], 3),
                            class_counts(train.labels["stage3_AB"], 4))
    uni_opt = as_optimizer(uni_model, adamw(cosine_schedule(1e-3, 1000)))
    cfg = StepConfig(loss_fn=recipe.loss_fn, label_key="unified",
                     augment_labeled=recipe.augment_labeled, num_classes=8,
                     predictions_fn=recipe.predictions_fn,
                     metric_labels_fn=recipe.metric_labels_fn)
    idx = rng.integers(0, len(train), TRAIN_BATCH)
    uni_batch = {"samples": torch.from_numpy(train.samples[idx]).to(dev),
                 "unified": torch.from_numpy(pack_unified_labels(train.take(idx))).to(dev)}
    uni_step = make_train_step(uni_model, uni_opt, cfg)
    uni_state = TrainState(uni_model, uni_opt)
    gen = torch.Generator(device=dev).manual_seed(0)
    fns = {"fgvc": lambda: fgvc_step(fgvc_state, fgvc_batch, gen),
           "unified": lambda: uni_step(uni_state, uni_batch, gen)}
    for fn in fns.values():
        for _ in range(3):
            fn()
    samples_ms = {name: [] for name in fns}
    for name in ["fgvc", "unified", "unified", "fgvc"]:
        samples_ms[name].append(time_ms(fns[name], iters=10, warmup=1))
    for name, fn in fns.items():
        trace = trace_calls(fn)
        ms, busy = float(np.median(samples_ms[name])), trace["device_busy_ms"]
        launched = launched_by(fn)
        emit("train_step", path="h_train", model=name, batch=H_STEP_BATCHES[name],
             dtype="fp32", step_ms=ms, samples_ms=samples_ms[name],
             samples_per_s=H_STEP_BATCHES[name] / ms * 1e3, kernels_per_step=trace["kernels"],
             host_launch_calls_per_step=trace["host_launch_calls"], device_busy_ms=busy,
             idle_share=None if busy is None else max(0.0, 1.0 - busy / ms),
             port_kernels_per_step=launched, nvidia_smi=smi)
        if launched:
            raise AssertionError(f"the {name} train step launched a port kernel")


def run_path_h(g_out: dict, dev, smi: str) -> dict:
    """Path h: ``prepare_stage3`` on path g's corpus, then every stage-3,
    flatten and unified trainer through its CLI, which must launch none of
    K1-K5; one FGVC and one distilled unified step on the card against the
    CPU; then the fully trained ladder, the unified model and the ensemble
    served (K1, K2). Returns the serving runs' launches."""
    t0 = time.perf_counter()
    stage3 = WORK / "stage3_dataset"
    corpus_val, corpus_train = g_out["val"], Bundle.load(
        g_out["dataset"] / f"block_{HW}" / "train.npz")
    flat = save_split(WORK / "flat_dataset", HW, *(
        build_flatten_bundle(BlockSet(samples=b.samples, labels=b.labels["stage0"], qps=b.qps))
        for b in (corpus_train, corpus_val)), "flatten").parent
    _, prep_launches = drive("h_prepare", [("prepare_stage3", None)], lambda _: {
        "printed": quietly(prepare_stage3.main, [
            "--dataset-dir", str(g_out["dataset"]), "--out", str(stage3),
            "--block-size", str(HW), "--ensemble-members", str(H_MEMBERS)])})
    meta = {head: json.loads((stage3 / head / f"block_{HW}" / "metadata.json").read_text())
            for head in ("RECT", "AB")}
    ab_train = Bundle.load(stage3 / "AB" / f"block_{HW}" / "train.npz")
    emit("h_setup", seconds=time.perf_counter() - t0, stage3=meta,
         ab_oversampled_train=len(ab_train),
         ab_members=sorted(p.name for p in (stage3 / "AB" / f"block_{HW}").glob("train_v*")),
         flatten_counts=class_counts(Bundle.load(flat / f"block_{HW}" / "train.npz")
                                     .labels["flatten"], 7))
    if len(ab_train) <= meta["AB"]["train"] or any(prep_launches.values()):
        raise AssertionError("prepare_stage3: AB not oversampled, or a kernel launched")

    runs, launches = drive("h_train", h_train_plan(g_out, stage3, flat),
                           lambda arg: run_h_cli(*arg, dev))
    report_h_runs(runs, smi)
    if any(launches.values()):
        raise AssertionError(f"training launched port kernels: {launches}")
    by_name = {run["name"]: run for run in runs}
    rect_phases = [h["phase"] for h in by_name["rect"]["histories"]["stage3_rect"]]
    if rect_phases != ["frozen"] * 5 + ["unfrozen"]:  # --epochs 2: 5 frozen, 1 unfrozen
        raise AssertionError(f"RECT phases {rect_phases}")
    check_h_step_parity(by_name, g_out, dev)
    serving, serving_launches = drive("h_serving", h_serving_plan(g_out, by_name),
                                      lambda arg: run_cli(g_out["dataset"], *arg, dev))
    check_h_serving(serving, len(g_out["val"]))
    h_step_timing(by_name, corpus_train, stage3, dev, smi)
    emit("h_done", seconds=time.perf_counter() - t0)
    return serving_launches


# ---------------------------------------------------------------------------
# Path i: a raw clip -> prepare_data -> prepare_dataset -> K1 / K2 serving
# ---------------------------------------------------------------------------

I_CLIP = (6, 1080, 1920)  # frames, height, width: 1080p luma, the size users encode
I_SIZES = (16, 8)         # the levels served: the sizes K1 and K2 take
I_QP_RANGE = (60, 140)    # a QP drawn per dumped block
I_FP32_AGREEMENT = 0.999  # least share of an fp32 front's labels equal to fp32 off's
DUMP_BSIZE = {px: index for index, px in BSIZE_INDEX_TO_PIXELS.items()}


def write_yuv(path: Path, luma: np.ndarray) -> Path:
    """``(F, H, W)`` uint16 luma as a yuv420p10le file, chroma flat at 512."""
    _, h, w = luma.shape
    path.parent.mkdir(parents=True, exist_ok=True)
    chroma = np.full(2 * ((h + 1) // 2) * ((w + 1) // 2), 512, "<u2").tobytes()
    with open(path, "wb") as out:
        for plane in luma:
            out.write(plane.astype("<u2").tobytes())
            out.write(chroma)
    return path


def tree_clip(root: Path, clip: tuple, seed: int) -> dict:
    """A yuv420p10le clip rendered from partition trees, and its encoder dumps.

    One tree per 64 px superblock (``synth_tree.sample_trees``), rendered by
    ``render_superblocks``; the frames hold the superblocks in raster order,
    cropped to ``clip``'s height and width. ``partition_frame_<n>.txt`` names
    every reached node of frame n's trees that lies inside the frame, in the
    dump's seven fields (order hint, frame type 0, block-size index, row and
    column in 4 px units, the node's mode, a QP drawn per block), each size in
    raster order. Returns the clip, the dump directory, the trees and the
    in-frame nodes per size."""
    frames, h, w = clip
    rows, cols = -(-h // 64), -(-w // 64)
    rng = np.random.default_rng(seed)
    trees = sample_trees(frames * rows * cols, rng)
    sbs = render_superblocks(trees, rng)[..., 0]
    luma = (sbs.reshape(frames, rows, cols, 64, 64).transpose(0, 1, 3, 2, 4)
            .reshape(frames, rows * 64, cols * 64)[:, :h, :w])
    yuv = write_yuv(root / f"clip_{w}x{h}_30.yuv", luma)
    dumps = root / "dumps"
    dumps.mkdir(parents=True, exist_ok=True)
    sb_row = np.repeat(np.arange(rows), cols)[:, None] * 64
    sb_col = np.tile(np.arange(cols), rows)[:, None] * 64
    nodes_in_frame = dict.fromkeys(LEVEL_SIZES, 0)
    for f, frame_trees in enumerate(trees.reshape(frames, rows * cols, -1)):
        lines = []
        for level, (size, nodes, off) in enumerate(
                zip(LEVEL_SIZES, NODES_PER_LEVEL, LEVEL_OFFSETS)):
            origin = np.array([_node_origin(level, j) for j in range(nodes)])
            r, c = sb_row + origin[:, 0], sb_col + origin[:, 1]
            modes = frame_trees[:, off:off + nodes]
            keep = (modes >= 0) & (r + size <= h) & (c + size <= w)
            order = np.lexsort((c[keep], r[keep]))
            r, c, modes = r[keep][order], c[keep][order], modes[keep][order]
            qps = rng.integers(*I_QP_RANGE, len(modes))
            lines += [f"{f} 0 {DUMP_BSIZE[size]} {a // 4} {b // 4} {m} {q}"
                      for a, b, m, q in zip(r, c, modes, qps)]
            nodes_in_frame[size] += len(modes)
        (dumps / f"partition_frame_{f}.txt").write_text("\n".join(lines) + "\n")
    return {"yuv": yuv, "dumps": dumps, "trees": trees, "nodes": nodes_in_frame}


def differing_files(a: Path, b: Path) -> list:
    """The files under ``a`` and ``b`` that differ: by bytes, an npz or an
    xlsx workbook by its members (zip headers hold the time of writing); a
    file on one side only counts too."""
    files = {side: sorted(str(f.relative_to(side)) for f in side.rglob("*") if f.is_file())
             for side in (a, b)}
    differ = sorted(set(files[a]) ^ set(files[b]))
    for name in sorted(set(files[a]) & set(files[b])):
        if name.endswith((".npz", ".xlsx")):
            with zipfile.ZipFile(a / name) as za, zipfile.ZipFile(b / name) as zb:
                same = (za.namelist() == zb.namelist()
                        and all(za.read(m) == zb.read(m) for m in za.namelist()))
        else:
            same = (a / name).read_bytes() == (b / name).read_bytes()
        if not same:
            differ.append(name)
    return differ


@contextlib.contextmanager
def counted(module, name: str):
    """Count the calls of ``module.name`` inside the block."""
    real, calls = getattr(module, name), []

    def wrapper(*args, **kwargs):
        calls.append(None)
        return real(*args, **kwargs)

    setattr(module, name, wrapper)
    try:
        yield calls
    finally:
        setattr(module, name, real)


def run_prepare_data(raw: dict, out: Path, use_native: bool) -> dict:
    """The port's ``prepare_data --formats reference npz`` on the clip, its
    frames read by the native reader or (``use_native`` off) by numpy, one
    frame at a time; the reader that ran is counted."""
    argv = ["--yuv", str(raw["yuv"]), "--dumps", str(raw["dumps"]), "--out", str(out),
            "--formats", "reference", "npz"]
    with contextlib.ExitStack() as stack:
        if not use_native:
            stack.enter_context(mock.patch.object(etl, "native_available", lambda: False))
        reads = stack.enter_context(counted(etl, "read_y_frames" if use_native
                                            else "read_y_frame"))
        t0 = time.perf_counter()
        quietly(prepare_data.main, argv)
        seconds = time.perf_counter() - t0
    report = json.loads((out / f"{raw['yuv'].stem}_etl_report.json").read_text())
    return {"seconds": seconds, "reads": len(reads), "report": report}


def i_serving_plan(dataset: Path, tree_dirs: dict) -> list:
    """``run_pipeline_eval --variant v6 --folded --fused-front off|on|g1`` at
    each of ``I_SIZES`` with path d's models of that size, in bf16 (after a
    warm-up) and in fp32."""
    plan = []
    for size in I_SIZES:
        ckpts = {name: tree_dirs[size] / f"{stem}_best_variables.npz"
                 for name, stem in STAGE_CKPT.items()}
        for precision, modes in (("bf16", ("off_warmup", "off", "on", "g1")),
                                 ("fp32", ("off", "on", "g1"))):
            for mode in modes:
                name = f"{size}px_{precision}_{mode}"
                plan.append((name, (dataset, f"i_{name}", [
                    "--folded", "--fused-front", mode.split("_")[0], *v6_checkpoints(ckpts)],
                    precision == "bf16", size)))
    return plan


def check_i_serving(runs: list, n_val: dict, path_a_agreement: float) -> None:
    """Each run's labels, probabilities and kernels (K1 for ``on``, K2 for
    ``g1``, at each size). Against the fp32 ``off`` run of its size: an fp32
    front's labels equal on ``I_FP32_AGREEMENT`` (the fp32 kernels are the
    plain graph within rounding); a bf16 front's labels equal on at least the
    share the bf16 ``off`` run's do, less three binomial standard errors (the
    front adds no error beyond bf16's own). Each run's agreement with the
    ``off`` run of its precision is emitted beside path a's."""
    by_name = {run["name"]: run for run in runs}
    for run in runs:
        size, precision, mode = run["name"].split("_", 2)
        n = n_val[int(size[:-2])]
        ref = by_name[f"{size}_fp32_off"]["final"]
        agree = {"off": float((run["final"] == by_name[f"{size}_{precision}_off"]["final"])
                              .mean()),
                 "fp32_off": float((run["final"] == ref).mean())}
        bf16_off = float((by_name[f"{size}_bf16_off"]["final"] == ref).mean())
        bound = (I_FP32_AGREEMENT if precision == "fp32"
                 else bf16_off - 3 * math.sqrt(max(bf16_off * (1 - bf16_off), 1 / n) / n))
        finite = bool(np.isfinite(run["stage1_prob"]).all())
        emit("end_to_end", path="i_serving", run=run["name"], samples=run["samples"],
             blocks_per_s=run["blocks_per_s"], launches=run["launches"],
             final_agrees_with_off=agree["off"], final_agrees_with_fp32_off=agree["fp32_off"],
             least_agreement_with_fp32_off=bound, path_a_agreement=path_a_agreement,
             classes=int(len(np.unique(run["final"]))), finite=finite)
        if run["samples"] != n or len(run["final"]) != n or not finite:
            raise AssertionError(f"path i {run['name']}: bad outputs")
        if not np.isin(run["final"], np.arange(8)).all() or len(np.unique(run["final"])) < 2:
            raise AssertionError(f"path i {run['name']}: labels outside 0..7 or constant")
        for kernel in FRONT_KERNELS.get(mode, []):
            if run["launches"].get(kernel, 0) == 0:
                raise AssertionError(f"path i {run['name']}: {kernel} never launched")
        if agree["fp32_off"] < bound:
            raise AssertionError(f"path i {run['name']}: {agree['fp32_off']:.5f} of the "
                                 f"labels equal fp32 off's, below {bound:.5f}")


def run_path_i(tree_dirs: dict, path_a_agreement: float, dev) -> dict:
    """Path i, inside ``utils.profiling.trace``: a 1080p clip rendered from
    partition trees and its dumps; the native library built with ``make``;
    ``prepare_data --formats reference npz`` with the native reader and with
    numpy (byte-equal outputs; blocks per size equal to the trees' in-frame
    nodes); ``prepare_dataset --variant v6 --block-size 64 32 16 8`` from the
    reference layout and from the npz (equal bundles); then the 16 and 8 px
    datasets served on the card with fronts off / on / g1 (K1, K2), bf16 and
    fp32. Returns the serving runs' launches."""
    root = WORK / "path_i"
    shutil.rmtree(root, ignore_errors=True)
    t0 = time.perf_counter()
    with profiling.trace(root / "trace", "path_i") as prof:
        raw = tree_clip(root / "raw", I_CLIP, SEED + 9)
        t_clip = time.perf_counter() - t0
        make = subprocess.run(["make", "-B", "-C", str(ROOT / "native")],
                              capture_output=True, text=True)
        if make.returncode != 0 or not native.native_available():
            raise AssertionError(f"make -C native failed: {make.stderr[-2000:]}")
        etl_runs = {name: run_prepare_data(raw, root / name, use_native)
                    for name, use_native in (("native", True), ("numpy", False))}
        differ = differing_files(root / "native", root / "numpy")
        blocks = {int(k): v for k, v in etl_runs["native"]["report"]["blocks_per_size"].items()}
        emit("i_etl", clip=list(I_CLIP), clip_bytes=raw["yuv"].stat().st_size,
             clip_seconds=t_clip, nodes_in_frame=raw["nodes"], blocks_per_size=blocks,
             **{f"{name}_seconds": run["seconds"] for name, run in etl_runs.items()},
             **{f"{name}_reads": run["reads"] for name, run in etl_runs.items()},
             differing_files=differ, warnings=etl_runs["native"]["report"]["warnings"])
        if differ:
            raise AssertionError(f"path i: native and numpy ETL outputs differ: {differ}")
        if blocks != raw["nodes"]:
            raise AssertionError(f"path i: blocks per size {blocks}, trees {raw['nodes']}")
        if etl_runs["native"]["reads"] != 1 or etl_runs["numpy"]["reads"] != I_CLIP[0]:
            raise AssertionError(f"path i: readers ran {etl_runs['native']['reads']} / "
                                 f"{etl_runs['numpy']['reads']} times")

        t1 = time.perf_counter()
        sizes = [str(size) for size in LEVEL_SIZES]
        for name, extra in (("dataset_reference", ["--raw", str(root / "native")]),
                            ("dataset_npz", ["--raw", str(root / "native" / "npz"),
                                             "--format", "npz"])):
            quietly(prepare_dataset.main, [*extra, "--out", str(root / name),
                                           "--variant", "v6", "--block-size", *sizes])
        differ = differing_files(root / "dataset_reference", root / "dataset_npz")
        meta = {size: json.loads((root / "dataset_reference" / f"block_{size}"
                                  / "metadata.json").read_text()) for size in LEVEL_SIZES}
        emit("i_dataset", seconds=time.perf_counter() - t1, differing_files=differ,
             rows={size: [m["train_samples"], m["val_samples"]] for size, m in meta.items()})
        if differ:
            raise AssertionError(f"path i: the bundles from the reference layout and "
                                 f"from the npz differ: {differ}")

        dataset = root / "dataset_reference"
        runs, launches = drive("i_serving", i_serving_plan(dataset, tree_dirs),
                               lambda arg: run_cli(*arg[:3], dev, bf16=arg[3],
                                                   block_size=arg[4]))
        check_i_serving(runs, {size: meta[size]["val_samples"] for size in I_SIZES},
                        path_a_agreement)
        torch.cuda.synchronize()
        traced_s = time.perf_counter() - t0
    kernels, busy_us = device_busy(prof.events())
    trace_file = root / "trace" / "path_i.pt.trace.json"
    emit("i_done", seconds=time.perf_counter() - t0, traced_seconds=traced_s,
         traced_device_events=kernels, device_busy_s=busy_us / 1e6,
         device_idle_share=1 - busy_us / 1e6 / traced_s,
         trace_bytes=trace_file.stat().st_size,
         device_memory_stats=profiling.device_memory_stats())
    if kernels == 0:
        raise AssertionError("path i: the trace holds no device event")
    return launches


# Path j: ROADMAP M11, the port on several processes. The card's machine has
# one H100, and NCCL refuses two ranks on one device: j1 is a world of one
# over NCCL, j2 and j3 are two ranks that share the card over gloo (compute
# on the card, collectives through gloo's CUDA path)
J_RANKS = 2
J_TRAIN_STEPS = 20        # train_stage1's steps at batch TRAIN_BATCH, data 2
J_TREE_CAPACITY = dict(zip(LEVEL_SIZES, LEVEL_CAPACITY))
J_TIMEOUT = 600           # seconds for one spawn of the ranks
J_STEP_DTYPES = (torch.float32, torch.float64)  # j3's single steps


def spawn_ranks(world: int, backend: str, job: dict) -> list:
    """Run :func:`path_j_rank` in ``world`` new processes that meet over a
    ``FileStore`` in ``job["out"]``, wait for them and return each rank's
    results. A rank that fails or is late fails the path, and every process
    is stopped first."""
    out = Path(job["out"])
    if out.exists():
        shutil.rmtree(out)
    out.mkdir(parents=True)
    ranks = torch.multiprocessing.start_processes(
        path_j_rank, args=(world, backend, job), nprocs=world, join=False,
        start_method="spawn")
    deadline = time.monotonic() + J_TIMEOUT
    try:
        while not ranks.join(timeout=1):
            if time.monotonic() > deadline:
                raise AssertionError(f"path j: the ranks did not end within {J_TIMEOUT} s")
    finally:
        for proc in ranks.processes:
            if proc.is_alive():
                proc.kill()
    return [torch.load(out / f"rank{r}.pt", weights_only=False) for r in range(world)]


def path_j_rank(rank: int, world: int, backend: str, job: dict) -> None:
    """One rank of path j: join the world, then run each part of
    ``job["parts"]`` (:data:`J_PARTS`) with the launch counts set to 0 just
    before it and read just after, and save what the parts return."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.set_device(0)
    store = dist.FileStore(str(Path(job["out"]) / "store"), world)
    dist.init_process_group(backend, store=store, rank=rank, world_size=world)
    try:
        _build.load_kernels()
        dev = torch.device("cuda", 0)
        results = {"backend": dist.get_backend(), "world": dist.get_world_size()}
        for part in job["parts"]:
            _build.reset_launch_counts()
            t0 = time.perf_counter()
            results[part] = J_PARTS[part](rank, job, dev)
            torch.cuda.synchronize()
            results[part]["seconds"] = time.perf_counter() - t0
            results[part]["launches"] = dict(_build.launch_counts)
        torch.save(results, Path(job["out"]) / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def j1_serve(rank: int, job: dict, dev) -> dict:
    """Path a's models through ``make_mesh(num_data=1)``, K2 (``g1``), bf16."""
    mesh = make_mesh(num_data=1)
    models = PipelineModels(*(load_model(path, cls) for path, cls in job["stages"]))
    predict = make_v6_pipeline_folded(models, THRESHOLD, float_dtype=torch.bfloat16,
                                      use_fused_front="g1", device=dev, mesh=mesh)
    samples = Bundle.load(job["val"]).samples
    run_pipeline_batched(predict, samples[:BATCH], BATCH, dev, mesh=mesh)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = run_pipeline_batched(predict, samples, BATCH, dev, mesh=mesh)
    return {"final": out["final"], "stage1_prob": out["stage1_prob"],
            "mesh": str(mesh), "predict_seconds": time.perf_counter() - t0}


def j2_serve(rank: int, job: dict, dev) -> dict:
    """``run_pipeline_eval --folded --fused-front on|g1 --bf16`` over the
    world (the CLI's default mesh); rank 0 reads the files the CLI wrote."""
    runs = {}
    for mode, args in job["serve"].items():
        before = dict(_build.launch_counts)
        if rank == 0:
            runs[mode] = run_cli(job["dataset"], f"j2_{mode}", args, dev)
        else:
            quietly(run_pipeline_eval.main, cli_argv(job["dataset"], f"j2_{mode}", args, dev))
            runs[mode] = {}
        runs[mode]["launches"] = {k: v - before[k] for k, v in _build.launch_counts.items()
                                  if v - before[k]}
    return {"runs": runs}


def j_level_predictors(dirs: dict, dev, mesh) -> dict:
    """Path d's per-level models from their checkpoints, folded, K1 and K5."""
    return {size: make_v6_pipeline_folded(
        PipelineModels(*(load_model(Path(dirs[size]) / f"{STAGE_CKPT[name]}_best_variables.npz",
                                    cls) for name, cls in STAGE_CLASSES.items())),
        THRESHOLD, float_dtype=torch.bfloat16, use_fused_front=True, use_pallas_groups=True,
        device=dev, mesh=mesh) for size in LEVEL_SIZES}


def j2_trees(rank: int, job: dict, dev) -> dict:
    """Path d's clip through ``predict_trees --level-capacity`` over the world,
    then four frames through ``predict_partition_trees`` with K5 predictors
    and the same capacities on the data-2 mesh."""
    extra = ["--fused-front", "off", "--level-capacity", *map(str, LEVEL_CAPACITY)]
    cli = {}
    if rank == 0:
        cli = run_tree_cli(job["clip"], job["tree_dirs"], "j2_gated", extra, dev)
    else:
        quietly(predict_trees.main, tree_cli_argv(job["clip"], job["tree_dirs"], "j2_gated",
                                                  extra, dev))
    mesh = make_mesh()
    predictors = j_level_predictors(job["tree_dirs"], dev, mesh)
    before = dict(_build.launch_counts)
    library = predict_partition_trees(np.load(job["sbs"]), predictors, BATCH, mesh=mesh,
                                      level_capacities=J_TREE_CAPACITY, device=dev)
    return {"cli_trees": cli.get("trees"), "library": library,
            "library_launches": {k: v - before[k] for k, v in _build.launch_counts.items()
                                 if v - before[k]}}


class InDtype(nn.Module):
    """``model`` given its input in ``dtype``: a float64 step through the
    trainer, which feeds float32 images."""

    def __init__(self, model: nn.Module, dtype: torch.dtype):
        super().__init__()
        self.model, self.dtype = model, dtype

    def forward(self, x, *args, **kwargs):
        return self.model(x.to(self.dtype), *args, **kwargs)


def j_step(state: dict, batch: dict, mesh, dev, dtype=torch.float32) -> dict:
    """One stage-1 train step (AdamW; no augmentation and dropout off, as
    path g's step parity) in ``dtype`` from ``state`` on ``batch`` (this
    rank's rows of it under a data axis), under deterministic cuDNN: the
    loss, the gradients the optimizer was given (whole layers) and the state
    dict after the step, on the host."""
    model = Stage1Model()
    model.load_state_dict(state)
    for mod in model.modules():
        if isinstance(mod, nn.Dropout):
            mod.p = 0.0
    model.to(dev, dtype)
    if mesh is not None:
        place_params(model, mesh)
    opt = as_optimizer(model, adamw(1e-3))
    names = {id(p): n for n, p in model.named_parameters()}
    layers = {id(m.weight): m for m in model.modules() if isinstance(m, ColumnParallel)}
    grads, inner = {}, opt.step

    def capturing():
        for p in opt.params:
            g = torch.zeros_like(p) if p.grad is None else p.grad
            grads[names[id(p)]] = (layers[id(p)].full(g) if id(p) in layers
                                   else g).detach().cpu().clone()
        inner()

    opt.step = capturing
    cfg = StepConfig(loss_fn=lambda lo, ta: binary_focal_loss(lo, ta, 0.25, 2.5),
                     label_key="stage1", binary=True, num_classes=2)
    rows = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
    if mesh is not None:
        rows = shard_batch(rows, mesh)
    net = model if dtype == torch.float32 else InDtype(model, dtype)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    with deterministic_cudnn():
        out = make_train_step(net, opt, cfg, mesh)(TrainState(net, opt), rows, gen)
    return {"loss": float(out["loss"]), "grads": grads,
            "state": {k: v.cpu() for k, v in model.state_dict().items()}}


def j_train(recipe, train: Bundle, val: Bundle, dev, mesh) -> dict:
    """``train_stage`` (the library under ``train_stage1``) under
    deterministic cuDNN: the final state on the host, the history, seconds."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with deterministic_cudnn():
        result = train_stage(recipe, train, val, seed=SEED, device=dev, mesh=mesh,
                             log=lambda message: None)
    torch.cuda.synchronize()
    return {"state": {k: v.cpu() for k, v in result.state.model.state_dict().items()},
            "history": result.history, "train_seconds": result.history[-1]["train_seconds"],
            "seconds": time.perf_counter() - t0}


def j3_train(rank: int, job: dict, dev) -> dict:
    """Twenty stage-1 steps at batch 256 on the data-2 mesh; one step on it
    and one on the model-2 mesh."""
    train, val = Bundle.load(job["train"]), Bundle.load(job["val_train"])
    out = {"train": j_train(j_recipe(), train, val, dev, make_mesh())}
    step = torch.load(job["step"], weights_only=False)
    for name, mesh in (("data2_step", make_mesh()), ("model2_step", make_mesh(num_model=2))):
        out[name] = {str(dt): j_step(step["state"], step["batch"], mesh, dev, dt)
                     for dt in J_STEP_DTYPES}
    return out


J_PARTS = {"j1_serve": j1_serve, "j2_serve": j2_serve, "j2_trees": j2_trees,
           "j3_train": j3_train}


def j_recipe():
    """train_stage1's recipe, one epoch of :data:`J_TRAIN_STEPS` steps."""
    return replace(stage1_recipe(epochs=1, batch_size=TRAIN_BATCH,
                                 steps_per_epoch=J_TRAIN_STEPS),
                   input_shape=(HW, HW, 1))


@contextlib.contextmanager
def composed_epochs(ranks: int):
    """One process trains on the global batches of a data-``ranks`` run: step
    s is every rank's rows s*b..(s+1)*b of its contiguous shard of the epoch
    order (the JAX package's multi-host composition)."""
    base = trainer._epoch_indices

    def composed(n, batch_size, epoch_seed, balance_labels, mesh=None):
        indices, _ = base(n, batch_size, epoch_seed, balance_labels)
        local = batch_size // ranks
        shards = [host_shard(indices, r, ranks) for r in range(ranks)]
        steps = len(shards[0]) // local
        return np.concatenate([sh[s * local:(s + 1) * local]
                               for s in range(steps) for sh in shards]), batch_size

    with mock.patch.object(trainer, "_epoch_indices", composed):
        yield


def check_j_step(name: str, ranks: list, want: dict) -> dict:
    """A step on the mesh against one process, as path g holds a step: both
    ranks bitwise equal; the fp32 loss within ``STEP_LOSS_RTOL`` and the BN
    statistics within ``STEP_STATS_TOL``; the gradients within
    ``STEP_GRAD_TOL`` of each tensor's largest entry (floored at
    ``STEP_SMALL_GRAD``) in float64, where no ReLU or max choice lies within
    rounding (path g replays the fp32 choices in float64 for the same
    reason: an fp32 choice within rounding flips between two reductions of
    the same sum and moves one gradient entry by its own size; the fp32
    gradients' distance is emitted beside)."""
    result = {}
    for dtype in J_STEP_DTYPES:
        got, other, ref = (r[name][str(dtype)] for r in (*ranks, want))
        key = str(dtype).replace("torch.", "")
        result[f"{key}_ranks_bitwise_equal"] = got["loss"] == other["loss"] and all(
            torch.equal(g, other["grads"][n]) for n, g in got["grads"].items())
        result[f"{key}_loss_rel_err"] = abs(got["loss"] - ref["loss"]) / abs(ref["loss"])
        result[f"{key}_grad_err_of_largest"], result[f"{key}_worst_tensor"] = \
            grad_err_of_largest(got["grads"], ref["grads"])
        result[f"{key}_stats_err_of_largest"] = max(
            (got["state"][k] - v).abs().max().item() / v.abs().max().item()
            for k, v in ref["state"].items() if k.endswith(("running_mean", "running_var")))
    emit("j_step", step=name, batch=TRAIN_BATCH, **result)
    if (not all(result[f"{str(dt).replace('torch.', '')}_ranks_bitwise_equal"]
                for dt in J_STEP_DTYPES)
            or result["float32_loss_rel_err"] > STEP_LOSS_RTOL
            or result["float32_stats_err_of_largest"] > STEP_STATS_TOL
            or result["float64_grad_err_of_largest"] > STEP_GRAD_TOL):
        raise AssertionError(f"path j: the {name} disagrees with one process: {result}")
    return result


def run_path_j(dataset: Path, ckpts: dict, cli_runs: list, tree_dirs: dict, clip: Path,
               clip_sbs: np.ndarray, tree_models: dict, d_gated: dict, g_out: dict, dev,
               smi: str) -> dict:
    """Path j; returns the kernels' launches summed over the ranks of j1 and
    j2 (their main paths)."""
    t0 = time.perf_counter()
    root = WORK / "path_j"
    by_name = {run["name"]: run for run in cli_runs}
    stages = [(ckpts[name], cls) for name, cls in (
        ("stage1", Stage1Model), ("stage2", Stage2Model), ("rect", Stage3RectModel),
        ("ab", Stage3ABModel))]
    val = dataset / f"block_{HW}" / "val.npz"

    # j1: a world of one over NCCL
    (j1,) = spawn_ranks(1, "nccl", {"out": str(root / "j1"), "parts": ["j1_serve"],
                                    "stages": stages, "val": str(val)})
    g1 = by_name["g1"]
    equal = bool(np.array_equal(j1["j1_serve"]["final"], g1["final"])
                 and np.array_equal(j1["j1_serve"]["stage1_prob"], g1["stage1_prob"]))
    emit("end_to_end", path="j1_nccl", run="g1", backend=j1["backend"], world=j1["world"],
         mesh=j1["j1_serve"]["mesh"], launches=j1["j1_serve"]["launches"],
         seconds=j1["j1_serve"]["seconds"],
         ms_per_predict=1e3 * j1["j1_serve"]["predict_seconds"] / (N_VAL / BATCH),
         single_process_ms_per_predict=1e3 * BATCH / g1["blocks_per_s"],
         bitwise_equal_to_a_g1=equal)
    if not equal or j1["backend"] != "nccl":
        raise AssertionError("path j1: the NCCL world of one differs from path a's g1 run")

    # j2 and j3: two ranks sharing the card over gloo
    np.save(root / "sbs.npy", clip_sbs)
    train = Bundle.load(g_out["dataset"] / f"block_{HW}" / "train.npz")
    val_train = g_out["val"]
    rows = J_TRAIN_STEPS * TRAIN_BATCH
    train_j = train.take(np.arange(rows))
    val_j = val_train.take(np.arange(min(len(val_train), 4 * TRAIN_BATCH)))
    for name, bundle in (("train", train_j), ("val_train", val_j)):
        bundle.save(root / f"{name}.npz")
    gen = torch.Generator().manual_seed(SEED + 12)
    calib = torch.randint(0, 1024, (512, HW, HW, 1), generator=gen).float() / 1023.0
    step_state = seeded_model(Stage1Model, gen, calib).state_dict()
    rng = np.random.default_rng(SEED + 12)
    step_batch = {"samples": codes(rng, (TRAIN_BATCH, HW, HW, 1)),
                  "stage1": rng.integers(0, 2, TRAIN_BATCH).astype(np.int32)}
    torch.save({"state": step_state, "batch": step_batch}, root / "step.pt")
    # a warm-up run first, as path a's: each rank's first CLI pays cuDNN's first calls
    front = {mode: ["--folded", "--fused-front", mode.split("_")[0], *v6_checkpoints(ckpts)]
             for mode in ("off_warmup", "on", "g1")}
    ranks = spawn_ranks(J_RANKS, "gloo", {
        "out": str(root / "j2"), "parts": ["j2_serve", "j2_trees", "j3_train"],
        "dataset": dataset, "serve": front, "clip": clip, "tree_dirs": tree_dirs,
        "sbs": str(root / "sbs.npy"), "train": str(root / "train.npz"),
        "val_train": str(root / "val_train.npz"), "step": str(root / "step.pt")})
    if {r["backend"] for r in ranks} != {"gloo"} or {r["world"] for r in ranks} != {J_RANKS}:
        raise AssertionError("path j2: the ranks did not form a gloo world of two")

    # j2: serving, labels bitwise equal to path a's single-process runs
    for mode in ("on", "g1"):
        got, want = ranks[0]["j2_serve"]["runs"][mode], by_name[mode]
        equal = bool(np.array_equal(got["final"], want["final"]))
        emit("end_to_end", path="j2_gloo", run=mode, ranks=J_RANKS,
             launches=[r["j2_serve"]["runs"][mode]["launches"] for r in ranks],
             blocks_per_s=got["blocks_per_s"],
             ms_per_predict=1e3 * BATCH / got["blocks_per_s"],
             single_process_ms_per_predict=1e3 * BATCH / want["blocks_per_s"],
             final_bitwise_equal=equal,
             stage1_prob_bitwise_equal=bool(np.array_equal(got["stage1_prob"],
                                                           want["stage1_prob"])),
             nvidia_smi=smi)
        if not equal:
            raise AssertionError(f"path j2: {mode}'s labels differ from path a's")
        for r in ranks:
            if r["j2_serve"]["runs"][mode]["launches"].get(FRONT_KERNELS[mode][0], 0) == 0:
                raise AssertionError(f"path j2: a rank never launched {FRONT_KERNELS[mode]}")

    # j2: trees, bitwise equal to path d's gated CLI run and to one process
    single = predict_partition_trees(clip_sbs, {
        size: make_v6_pipeline_folded(level_pipeline_models(tree_models, size), THRESHOLD,
                                      float_dtype=torch.bfloat16, use_fused_front=True,
                                      use_pallas_groups=True, device=dev)
        for size in LEVEL_SIZES}, BATCH, level_capacities=J_TREE_CAPACITY, device=dev)
    cli_equal = bool(np.array_equal(ranks[0]["j2_trees"]["cli_trees"], d_gated["trees"]))
    lib_equal = all(np.array_equal(r["j2_trees"]["library"][k], v)
                    for r in ranks for k, v in single.items())
    emit("end_to_end", path="j2_trees", ranks=J_RANKS,
         cli_trees_bitwise_equal_to_d_gated=cli_equal,
         k5_trees_bitwise_equal_to_one_process=lib_equal,
         overflow={k: int(v) for k, v in single.items() if k.startswith("overflow")},
         launches=[r["j2_trees"]["launches"] for r in ranks],
         seconds=[r["j2_trees"]["seconds"] for r in ranks])
    if not (cli_equal and lib_equal):
        raise AssertionError("path j2: the trees differ from one process's")
    for r in ranks:
        if r["j2_trees"]["library_launches"].get("fused_group12", 0) == 0:
            raise AssertionError("path j2: a rank never launched fused_group12")

    # j3: training on the card, data 2 and model 2
    r0, r1 = (r["j3_train"]["train"] for r in ranks)
    same = all(torch.equal(v, r1["state"][k]) for k, v in r0["state"].items())
    with composed_epochs(J_RANKS):
        want = j_train(j_recipe(), train_j, val_j, dev, None)
    diffs = {k: (v.double() - want["state"][k].double()).abs().max().item()
             / want["state"][k].double().abs().max().item()
             for k, v in r0["state"].items() if v.is_floating_point()}
    worst = max(diffs, key=diffs.get)
    emit("j_train", steps=J_TRAIN_STEPS, batch=TRAIN_BATCH, ranks_bitwise_equal=same,
         finite=all(torch.isfinite(v).all().item() for v in r0["state"].values()
                    if v.is_floating_point()),
         train_loss=r0["history"][0]["train_loss"],
         single_process_train_loss=want["history"][0]["train_loss"],
         val_loss=r0["history"][0]["val_loss"],
         single_process_val_loss=want["history"][0]["val_loss"],
         max_diff_of_largest=diffs[worst], worst_tensor=worst,
         ms_per_step=[1e3 * r["j3_train"]["train"]["train_seconds"] / J_TRAIN_STEPS
                      for r in ranks],
         single_process_ms_per_step=1e3 * want["train_seconds"] / J_TRAIN_STEPS,
         nvidia_smi=smi)
    if not same:
        raise AssertionError("path j3: the two ranks' states differ after 20 steps")
    step = torch.load(root / "step.pt", weights_only=False)
    one = {str(dt): j_step(step["state"], step["batch"], None, dev, dt) for dt in J_STEP_DTYPES}
    for name in ("data2_step", "model2_step"):
        check_j_step(name, [r["j3_train"] for r in ranks], {name: one})

    emit("j_done", seconds=time.perf_counter() - t0)
    runs = [j1["j1_serve"]] + [r[part] for r in ranks for part in ("j2_serve", "j2_trees")]
    return {k: sum(run["launches"].get(k, 0) for run in runs) for k in _build.KERNELS}


# ---------------------------------------------------------------------------
# Path k: the port's examples (av1tpu_torch/examples), each through its main
# ---------------------------------------------------------------------------

# tree_demo's corpus: one 1280x768 val frame and a train corpus cut to an
# eighth of the script's 12,000 superblocks; batch 64, so that the 64 px level
# (one block a superblock) still takes ~20 steps an epoch. Stages 1 and 2 take
# two and three epochs (one frozen): with one each the 64 px stage 2 split no
# superblock and every tree was its root (on an H100); with these the trees
# hold 4.03 nodes on average (PERF.md, PR 13).
K_TREE = ["--train-superblocks", "1500", "--val-superblocks", "240", "--batch-size", "64",
          "--stage1-epochs", "2", "--stage2-epochs", "3", "--freeze-epochs", "1",
          "--stage3-epochs", "1", "--calibrate", "--folded"]
K_SCALE = "0.01"   # the scale demos' corpus: 3,622 train / 908 val blocks
K_INT8_FRAMES = 2
K_BENCH_FRAMES = 8
# k's runs in which the folded graph serves with a fused front
K_EXPECT = {"k2_tree_g1": ["fused_front_g1"], "k2_tree_on": ["fused_front"],
            "k3_int8": ["fused_front"], "k4_unified": ["fused_front_g1"]}


def k_plan(root: Path, dev) -> list:
    """``(name, (example module, argv, results file))`` in the order they run:
    k5's ladder feeds k4, k2's 16 px models feed k3."""
    cpu_or_card = ["--device", dev.type]
    tree, scale = root / "tree_demo", root / "scale_demo"
    return [
        ("k1_demo_e2e", (demo_e2e, ["--out", str(root / "demo"), *cpu_or_card],
                         root / "demo" / "demo_results.json")),
        ("k2_tree_g1", (tree_demo, ["--out", str(tree), *K_TREE, "--fused-front", "g1",
                                    *cpu_or_card], tree / "RESULTS.json")),
        ("k2_tree_on", (tree_demo, ["--out", str(tree), *K_TREE, "--resume",
                                    "--fused-front", "on", *cpu_or_card],
                        tree / "RESULTS.json")),
        ("k2_tta_eval", (tta_eval, ["--xl-dir", str(tree), "--configs", "none",
                                    "tta_aligned", "--output", str(tree / "tta_eval.json"),
                                    *cpu_or_card], tree / "tta_eval.json")),
        ("k3_int8", (int8_selfcalib_ab, [
            "--models", str(tree / "size_16" / "models"), "--out", str(root / "int8_ab"),
            "--frames", str(K_INT8_FRAMES), "--fused-front", "on", *cpu_or_card],
            root / "int8_ab" / "int8_selfcalib_ab.json")),
        ("k5_scale_demo", (scale_demo, [
            "--out", str(scale), "--scale", K_SCALE, "--stage1-epochs", "1",
            "--stage2-epochs", "1", "--stage3-epochs", "1", "--flat-epochs", "1",
            *cpu_or_card], scale / "RESULTS.json")),
        ("k5_scale_demo_extras", (scale_demo_extras, [
            "--demo", str(scale), "--scale", K_SCALE, "--ensemble-epochs", "1",
            "--v5-epochs", "1", *cpu_or_card], scale / "EXTRAS.json")),
        ("k5_scale_demo_v5", (scale_demo_v5, [
            "--out", str(root / "scale_demo_v5"), "--scale", K_SCALE, "--stage1-epochs", "1",
            "--stage2-epochs", "1", "--stage3-epochs", "1", *cpu_or_card],
            root / "scale_demo_v5" / "RESULTS.json")),
        ("k4_unified", (unified_demo, [
            "--out", str(root / "unified_demo"), "--ladder", str(scale), "--epochs", "1",
            "--throughput-batch", str(BATCH), "--fused-front", "g1", *cpu_or_card],
            root / "unified_demo" / "RESULTS.json")),
        ("k6_bench_ingest", (bench_ingest_to_trees, [
            "--frames", str(K_BENCH_FRAMES), "--out", str(root / "bench"), *cpu_or_card],
            root / "bench" / "report.json")),
    ]


def run_example(arg) -> dict:
    """One example's ``main`` (its prints captured); its results file."""
    module, argv, results = arg
    t0 = time.perf_counter()
    quietly(module.main, argv)
    seconds = time.perf_counter() - t0
    if not results.exists():
        raise AssertionError(f"{module.__name__}: {results} was not written")
    return {"seconds": seconds, "results": json.loads(results.read_text())}


def k_numbers(name: str, results: dict) -> dict:
    """What path k emits of an example's results file."""
    if name == "k1_demo_e2e":
        return {k: results[k] for k in ("stage1_val_f1", "stage2_val_f1",
                                        "stage3_rect_val_f1", "stage3_ab_val_f1",
                                        "pipeline_accuracy", "pipeline_macro_f1")}
    if name.startswith("k2_tree"):
        return {"tree_accuracy_variants": results["tree_accuracy_variants"],
                "calibrated_thresholds": {s: r["calibrated_threshold"]
                                          for s, r in results["sizes"].items()},
                "walls": {s: {k: v for k, v in r.items() if k.endswith("_wall")}
                          for s, r in results["sizes"].items()}}
    if name == "k2_tta_eval":
        return {c: {k: a[k] for k in ("node_accuracy", "exact_tree_match",
                                      "predict_wall_seconds")}
                for c, a in results["configs"].items()}
    if name == "k3_int8":
        return {"modes": results["modes"], "agreement": results["agreement"]}
    if name == "k4_unified":
        return {"throughput": results["throughput"],
                "val": {f: {k: v for k, v in r.items() if k != "sweep"}
                        for f, r in results["val"].items()}}
    if name == "k6_bench_ingest":  # its "seconds" is the timed pass's
        return {("timed_seconds" if k == "seconds" else k): v for k, v in results.items()}
    return {"stages": results.get("stages", results)}


def check_k_trees(tree: Path, runs: dict) -> None:
    """k2's trees, as path d's are held (``report_tree_runs``): (n, 85) in
    -1..7, a root on every tree, mean nodes between 2 and 60, the expected
    kernels launched; the share of slots equal between ``on`` and ``g1`` and
    each run's ``tree_accuracy`` emitted beside them."""
    truth = np.load(tree / "val_trees_truth.npy")
    trees = {front: np.load(tree / f"trees_ladder_{front}" / "trees_frame0.npz")["trees"]
             for front in ("g1", "on")}
    accuracy = runs["k2_tree_on"]["results"]["tree_accuracy_variants"]
    for front, got in trees.items():
        mean_nodes = float((got >= 0).sum(axis=1).mean())
        acc = accuracy[f"ladder_{front}"]
        emit("end_to_end", path="k_trees", run=f"ladder_{front}", superblocks=len(got),
             mean_nodes_per_tree=mean_nodes, node_accuracy=acc["node_accuracy"],
             exact_tree_match=acc["exact_tree_match"],
             structure_accuracy=acc["structure_accuracy"],
             predict_wall_seconds=acc["predict_wall_seconds"],
             tree_slots_equal_on_vs_g1=float((trees["on"] == trees["g1"]).mean()),
             launches=runs[f"k2_tree_{front}"]["launches"])
        if got.shape != truth.shape or got.shape[1] != 85 or got.min() < -1 or got.max() > 7:
            raise AssertionError(f"k2 {front}: bad trees {got.shape}")
        if (got[:, 0] < 0).any() or not 2.0 < mean_nodes < 60.0:
            raise AssertionError(f"k2 {front}: the trees do not vary (mean nodes {mean_nodes})")


def run_path_k(dev) -> dict:
    """Path k: the port's examples on the card, each through its ``main`` at
    the published v6 widths with corpora and epochs cut (``K_*``): demo_e2e;
    tree_demo at every size, calibrated, folded with ``g1`` and again
    (``--resume``) with ``on``, then tta_eval over its directory; int8_selfcalib_ab
    on tree_demo's 16 px models with ``on``; scale_demo, scale_demo_extras and
    scale_demo_v5; unified_demo on scale_demo's ladder with ``g1``;
    bench_ingest_to_trees. Each must write its results file; k2's trees are
    held as path d's. Returns the path's launches."""
    root = WORK / "examples"
    shutil.rmtree(root, ignore_errors=True)
    t0 = time.perf_counter()
    runs, launches = drive("k_examples", k_plan(root, dev), run_example)
    by_name = {run["name"]: run for run in runs}
    for run in runs:
        emit("end_to_end", path="k_examples", run=run["name"], seconds=run["seconds"],
             launches=run["launches"], **k_numbers(run["name"], run["results"]))
        for kernel in K_EXPECT.get(run["name"], []):
            if run["launches"].get(kernel, 0) == 0:
                raise AssertionError(f"{run['name']}: {kernel} never launched")
    check_k_trees(root / "tree_demo", by_name)  # demo_e2e holds its own accuracy gate
    emit("k_done", seconds=time.perf_counter() - t0, nvidia_smi=nvidia_smi_line())
    shutil.rmtree(root, ignore_errors=True)
    return launches


# ---------------------------------------------------------------------------
# Path l: the last library options (stacked backbones, im2col int8, prefetch)
# ---------------------------------------------------------------------------

L_DTYPES = {"fp32": torch.float32, "bf16": torch.bfloat16}
L_MARGIN = {"fp32": 1e-3, "bf16": 0.1}  # labels equal where every decision's margin exceeds it
L_PROB_ATOL = {"fp32": 1e-5, "bf16": 0.02}  # stacked vs unstacked stage-1 probability
L_INT8_SCALE = 0.08  # mean |logit error| over the float logits' scale (tests/test_quant.py)
L_PREFETCH = (0, 2, 4)


def plain_margins(models: PipelineModels, x: torch.Tensor, dtype) -> np.ndarray:
    """Per-sample smallest margin of the four v6 decisions of the plain
    stage modules in ``dtype`` on ``x`` (normalized NHWC on the card): the
    gate's distance from ``THRESHOLD``, else the top-2 logit gap."""
    margins = []
    with torch.inference_mode():
        for model in (models.stage1, models.stage2, models.stage3_rect, models.stage3_ab):
            logits = on_device(model, x.device, dtype)(x.to(dtype)).float()
            if logits.dim() == 1:
                logits = logits[:, None]
            margins.append(decision_margins(logits.cpu().numpy(), unified=False)[0])
    return np.min(margins, axis=0)


def l1_stacked(models: PipelineModels, samples: np.ndarray, dev, dtype_name: str) -> dict:
    """l1: ``make_v6_pipeline(stacked=True)`` against the unstacked pipeline on
    one 4,096-block batch: labels equal wherever every decision's margin
    exceeds ``L_MARGIN``, stage-1 probabilities within ``L_PROB_ATOL``; the
    kernels a predict launches and the device ms of each (CUDA graph)."""
    dtype = L_DTYPES[dtype_name]
    batch = torch.from_numpy(samples[:BATCH]).to(dev)
    predicts = {name: make_v6_pipeline(models, THRESHOLD, input_dtype=dtype, device=dev,
                                       stacked=stacked)
                for name, stacked in (("unstacked", False), ("stacked", True))}
    out = {name: {k: v.cpu().numpy() for k, v in p(batch).items()}
           for name, p in predicts.items()}
    margins = plain_margins(models, batch.float() / 1023.0, dtype)
    sure = margins > L_MARGIN[dtype_name]
    equal = out["stacked"]["final"] == out["unstacked"]["final"]
    prob_err = float(np.abs(out["stacked"]["stage1_prob"]
                            - out["unstacked"]["stage1_prob"]).max())
    numbers = {"dtype": dtype_name, "final_share_equal": float(equal.mean()),
               "guarded_share": float(sure.mean()),
               "mismatches_above_margin": int((~equal & sure).sum()),
               "stage1_prob_max_abs_diff": prob_err,
               "distinct_labels": int(len(np.unique(out["unstacked"]["final"])))}
    for name, predict in predicts.items():
        fn = functools.partial(predict, batch)
        trace = trace_calls(fn)
        numbers[name] = {"kernels_per_predict": trace["kernels"],
                         "device_busy_ms": trace["device_busy_ms"],
                         "host_launch_calls_per_predict": trace["host_launch_calls"],
                         "device_ms": device_ms(fn, iters=3, replays=2),
                         "predict_ms": time_ms(fn, iters=5, warmup=1)}
    if numbers["mismatches_above_margin"] or prob_err > L_PROB_ATOL[dtype_name]:
        raise AssertionError(f"l1 {dtype_name}: stacked differs from unstacked: {numbers}")
    if numbers["distinct_labels"] < 2 or not np.isfinite(out["stacked"]["stage1_prob"]).all():
        raise AssertionError(f"l1 {dtype_name}: bad outputs {numbers}")
    return numbers


def l2_im2col(model: nn.Module, calib: np.ndarray, samples: np.ndarray, hw: int,
              dev) -> dict:
    """l2: ``quantize_stage`` with ``lowering="im2col"`` and the hybrid default,
    bf16, K1 attached to both, on ``hw`` px blocks (the top-left ``hw`` x
    ``hw`` of path a's blocks): each int8 model's mean logit error against the
    BN-folded fp32 forward, and im2col's against hybrid's, under
    ``L_INT8_SCALE`` of the float logits' scale; label agreement; K1's
    launches in one im2col predict; the im2col model serving the other
    extent (8 <-> 16 px) with K1 rebuilt for it, which the hybrid model
    refuses."""
    def blocks(u16):
        return torch.from_numpy(np.ascontiguousarray(u16[:, :hw, :hw])).to(dev).float() / 1023.0

    calib_x, x = blocks(calib), blocks(samples[:BATCH])
    t0 = time.perf_counter()
    q = {lowering: ptq.quantize_stage(model, calib_x, torch.bfloat16, lowering=lowering)
         for lowering in ("hybrid", "im2col")}
    seconds = time.perf_counter() - t0
    for qm in q.values():
        if not ptq.attach_fused_front(qm, hw):
            raise AssertionError(f"l2: K1 did not attach at {hw} px")
    with torch.inference_mode():
        ref = q["hybrid"].float_forward(x).float()
        got = {lowering: qm(x).float() for lowering, qm in q.items()}
        k1 = launched_by(lambda: q["im2col"](x)).get("fused_front", 0)
        other = 8 if hw == 16 else 16
        x_other = torch.from_numpy(np.ascontiguousarray(
            samples[:256, :other, :other])).to(dev).float() / 1023.0
        ptq.attach_fused_front(q["im2col"], other)  # K1 is built per extent
        served = q["im2col"](x_other).float()
    scale = max(float(ref.abs().max()), 0.1)
    err = {name: float((g - ref).abs().mean()) / scale for name, g in got.items()}
    err["im2col_vs_hybrid"] = float((got["im2col"] - got["hybrid"]).abs().mean()) / scale
    numbers = {"hw": hw, "quantize_seconds_both": seconds, "mean_err_over_scale": err,
               "float_scale": scale, "k1_launches_per_im2col_predict": k1,
               "labels_im2col_vs_hybrid": labels_agree(got["im2col"].cpu().numpy(),
                                                        got["hybrid"].cpu().numpy(), False),
               "labels_im2col_vs_float": labels_agree(got["im2col"].cpu().numpy(),
                                                       ref.cpu().numpy(), False),
               "other_extent": other, "other_extent_finite": bool(
                   torch.isfinite(served).all() and served.shape == (256, ref.shape[1]))}
    if max(err.values()) >= L_INT8_SCALE or not numbers["other_extent_finite"] or k1 == 0:
        raise AssertionError(f"l2 {hw} px: {numbers}")
    try:
        q["hybrid"](x_other)
    except ValueError:
        pass
    else:
        raise AssertionError(f"l2: the hybrid model served {other} px blocks")
    return numbers


def l3_prefetch(models: PipelineModels, samples: np.ndarray, dev) -> dict:
    """l3: the folded ``g1`` predict (K2) through ``run_pipeline_batched`` on a
    ``np.memmap`` of the blocks, ``prefetch`` 0, 2 and 4 in 0 2 4 4 2 0 turns
    after a warm-up: outputs bitwise equal, wall ms of each; then the
    producer's staging alone per batch (``eval.hierarchy._Staging``: the
    slice of the memmap into a pinned buffer, host ms) beside its copy on a
    side stream (H2D ms, CUDA events) and the predict's ms on a batch on the
    card."""
    from av1tpu_torch.eval.hierarchy import _Staging

    path = WORK / "l_blocks.npy"
    np.save(path, samples)
    blocks = np.load(path, mmap_mode="r")
    predict = make_v6_pipeline_folded(models, THRESHOLD, float_dtype=torch.bfloat16,
                                      use_fused_front="g1", device=dev)
    want = run_pipeline_batched(predict, blocks, BATCH, dev, prefetch=2)  # warm-up
    wall = {k: [] for k in L_PREFETCH}
    for k in L_PREFETCH + L_PREFETCH[::-1]:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = run_pipeline_batched(predict, blocks, BATCH, dev, prefetch=k)
        wall[k].append((time.perf_counter() - t0) * 1e3)
        for key, value in want.items():
            if not np.array_equal(got[key], value):
                raise AssertionError(f"l3: prefetch={k} changed {key}")
    side = torch.cuda.Stream(dev)
    staging = _Staging((BATCH,) + blocks.shape[1:], torch.uint16, 3, side)
    host_ms, h2d_ms = [], []
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    for first in range(0, len(blocks), BATCH):
        t0 = time.perf_counter()
        _, _, copied = staging.upload(blocks[first:first + BATCH], None, dev)
        host_ms.append((time.perf_counter() - t0) * 1e3)
        copied.synchronize()
        with torch.cuda.stream(side):
            start.record()
            staging.bufs[0].to(dev, non_blocking=True)
            end.record()
        end.synchronize()
        h2d_ms.append(start.elapsed_time(end))
    batch = torch.from_numpy(samples[:BATCH]).to(dev)
    return {"blocks": len(blocks), "batches": -(-len(blocks) // BATCH),
            "final_bitwise_equal": True, "distinct_labels": int(len(np.unique(want["final"]))),
            "wall_ms": {str(k): v for k, v in wall.items()},
            "wall_ms_median": {str(k): float(np.median(v)) for k, v in wall.items()},
            "staging_host_ms_per_batch": float(np.median(host_ms)),
            "h2d_ms_per_batch": float(np.median(h2d_ms)),
            "h2d_bytes_per_batch": BATCH * int(np.prod(blocks.shape[1:])) * 2,
            "predict_ms_per_batch": time_ms(functools.partial(predict, batch), iters=10)}


def run_path_l(models: PipelineModels, model8: nn.Module, calib: np.ndarray,
               samples: np.ndarray, dev) -> dict:
    """Path l: the JAX package's last library options on the port, on path
    a's blocks and models (path d's 8 px stage 2 at 8 px): l1 stacked
    backbones, fp32 (TF32 off) and bf16; l2 the int8 im2col lowering at 16
    and 8 px with K1; l3 ``run_pipeline_batched``'s producer (K2). Returns
    the path's launches."""
    plan = [("l1_stacked_fp32", ("l1", "fp32")), ("l1_stacked_bf16", ("l1", "bf16")),
            ("l2_im2col_16", ("l2", 16)), ("l2_im2col_8", ("l2", 8)),
            ("l3_prefetch", ("l3", None))]

    def run_one(arg):
        part, option = arg
        if part == "l1":
            return l1_stacked(models, samples, dev, option)
        if part == "l2":
            return l2_im2col(models.stage2 if option == HW else model8, calib, samples,
                             option, dev)
        return l3_prefetch(models, samples, dev)

    t0 = time.perf_counter()
    runs, launches = drive("l_options", plan, run_one)
    by_name = {run["name"]: run for run in runs}
    for name, run in by_name.items():
        emit("end_to_end", path="l_options", run=name,
             **{k: v for k, v in run.items() if k != "name"})
    for name, kernel in (("l2_im2col_16", "fused_front"), ("l2_im2col_8", "fused_front"),
                         ("l3_prefetch", "fused_front_g1")):
        if by_name[name]["launches"].get(kernel, 0) == 0:
            raise AssertionError(f"{name}: {kernel} never launched")
    emit("l_done", seconds=time.perf_counter() - t0, nvidia_smi=nvidia_smi_line())
    return launches


# ---------------------------------------------------------------------------
# Path m: the two sweep examples, then the kernels through the bench helpers
# ---------------------------------------------------------------------------

M_ITERS = 20            # timed calls of each sweep cell (after WARMUP_ITERS): the default
M_CASCADE_N = 512       # superblocks of m3's kernel cascade and of its tree comparison
M_FRONTS = {8: {"use_fused_front": "g1"}, 16: {"use_fused_front": "g1"},
            32: {"use_pallas_groups": True}, 64: {"use_pallas_groups": True}}


def m_predicted_launches() -> dict:
    """m3's launches: each kernel cell calls its predict WARMUP_ITERS +
    M_ITERS times, four stages each (K2 at 8 and 16 px, K5 at 32 and 64 px);
    the cascade as often, two levels a kernel, and once more for its trees."""
    calls = bench_helpers.WARMUP_ITERS + M_ITERS
    per_kernel = 2 * calls * 4 + calls * 2 * 4 + 2 * 4
    return {"fused_front_g1": per_kernel, "fused_group12": per_kernel}


def sweep_rows(printed: str, columns: int) -> tuple:
    """A sweep's table rows (cells stripped) and its ``best:`` value."""
    rows = [[c.strip() for c in line.strip().strip("|").split("|")]
            for line in printed.splitlines() if re.match(r"\|\s*\d", line)]
    best = printed[printed.rindex("best:") + 5:].strip()
    if any(len(r) != columns for r in rows):
        raise AssertionError(f"malformed sweep table:\n{printed}")
    return rows, best


def m_rows(name: str, rows: list, want: int, smi: str) -> list:
    """Hold a sweep's rows (``want`` of them, none FAILED, rate > 0, MFU in
    (0, 1]) and emit each; returns ``(key, rate, mfu)`` per row."""
    out = []
    for row in rows:
        *key, rate, mfu = row
        if "FAILED" in rate:
            raise AssertionError(f"{name}: {row} failed")
        rate = float(rate.replace(",", ""))
        mfu = float(mfu.rstrip("%")) / 100.0 if mfu.endswith("%") else float("nan")
        emit("end_to_end", path="m_sweeps", run=name, key=[int(k) for k in key],
             per_s=rate, mfu=mfu, nvidia_smi=smi)
        if not rate > 0 or not 0 < mfu <= 1:
            raise AssertionError(f"{name}: {row}: rate or MFU out of range")
        out.append(([int(k) for k in key], rate, mfu))
    if len(out) != want:
        raise AssertionError(f"{name}: {len(out)} rows, want {want}")
    return out


def m3_kernels(best: dict, dev, keep: dict) -> dict:
    """m3: the bench helpers with the kernels: ``_time_predict`` with K2
    (``g1``) at 8 and 16 px and K5 at 32 and 64 px at m1's best batches,
    ``bench_tree_cascade`` with K5 at 64 and 32 px and K2 at 16 and 8 px,
    and the modes of that cascade and of the ``off`` cascade at every level
    for ``M_CASCADE_N`` superblocks. Leaves the models and predictors in
    ``keep`` for :func:`check_m3_kernels`."""
    dtype = torch.bfloat16
    models = bench_helpers._build_models(dev)
    predicts = {px: make_v6_pipeline_folded(models, THRESHOLD, float_dtype=dtype, device=dev,
                                            **M_FRONTS[px]) for px in M_FRONTS}
    cells = {}
    for px, predict in predicts.items():
        rate, flops, mfu = bench_helpers._time_predict(predict, best[px]["batch"], px,
                                                      iters=M_ITERS, device=dev)
        cells[px] = {"batch": best[px]["batch"], "blocks_per_s": rate, "mfu": mfu,
                     "flops_per_block": flops, "off_blocks_per_s": best[px]["sb_per_s"]}
    cascade = bench_helpers.bench_tree_cascade(models, dtype, M_CASCADE_N, iters=M_ITERS,
                                               predict_by_size=predicts, device=dev)
    sbs = torch.from_numpy(bench_helpers.seeded_superblocks(M_CASCADE_N)).to(dev)
    off = make_v6_pipeline_folded(models, THRESHOLD, float_dtype=dtype, device=dev)
    got, want = (predict_partition_trees(sbs, level_predictors, 64 * M_CASCADE_N, device=dev)
                 for level_predictors in (predicts, dict.fromkeys(LEVEL_SIZES, off)))
    trees, trees_off = got["trees"], want["trees"]
    if trees.shape != (M_CASCADE_N, 85) or trees.min() < -1 or trees.max() > 7 \
            or (trees[:, 0] < 0).any():
        raise AssertionError(f"m3: bad trees {trees.shape}")
    keep.update(models=models, predicts=predicts, off=off)
    return {"cells": cells, "cascade": cascade,
            "tree_slots_equal_to_off": float((trees == trees_off).mean()),
            "modes_equal_to_off": {size: float((got[f"modes_{size}"]
                                                == want[f"modes_{size}"]).mean())
                                   for size in LEVEL_SIZES},
            "mean_nodes_per_tree": float((trees >= 0).sum(axis=1).mean()),
            "mean_nodes_per_tree_off": float((trees_off >= 0).sum(axis=1).mean())}


def check_m3_kernels(kept: dict, best: dict, dev) -> None:
    """K2 and K5 against their plain versions at every row count m3 gave
    them (m1's best batch of each size, and the n = ``M_CASCADE_N``
    cascade's n to 64n rows), on m3's own blocks (``bench.py``'s seeded
    draws, the tiles of its seeded superblocks) with each stage's folded
    weights, in bf16; then each kernel predict's stage-1 probabilities and
    labels beside ``off``'s on its cell's blocks (emitted, not held)."""
    bf16 = torch.bfloat16
    models = kept["models"]
    folded = [fold_backbone(m.backbone) for m in
              (models.stage1, models.stage2, models.stage3_rect, models.stage3_ab)]
    sbs = torch.from_numpy(bench_helpers.seeded_superblocks(M_CASCADE_N)).to(dev)
    for px, rows, where in ((px, rows, where) for px in M_FRONTS for rows, where in (
            (best[px]["batch"], "cell"), (M_CASCADE_N * (64 // px) ** 2, "cascade"))):
        u16 = (torch.from_numpy(bench_helpers.seeded_blocks(rows, px)).to(dev)
               if where == "cell" else quad_tile_on_device(sbs.view(torch.int16), px))
        x = u16.view(torch.uint16).float() / 1023.0
        for stage, f in enumerate(folded, 1):
            if M_FRONTS[px].get("use_fused_front") == "g1":
                name = "fused_front_g1"
                kern, plain, args = front_args(name, f, bf16, dev)
                xin = x.to(bf16)
                got = kern(xin, *args)
                torch.cuda.synchronize()
                want = plain(xin, *args)
            else:
                name = "fused_group12"
                wg = tuple(t.to(dev) for t in rg.pack_group12_weights(f, bf16))
                xin = stem_pool(f, x, dev).to(bf16)
                got = rg.fused_group12(xin, wg, rg.group12_conv_stream(wg))
                torch.cuda.synchronize()
                want = rg.fused_group12_reference(xin, wg)
            compare(name, got, want, rel_tol(name, bf16, want), block_px=px, batch=rows,
                    shape=f"m3_{where}", stage=stage, dtype="bfloat16")
    for px, predict in kept["predicts"].items():
        images = torch.from_numpy(bench_helpers.seeded_blocks(best[px]["batch"], px)).to(dev)
        got, want = predict(images), kept["off"](images)
        emit("m3_vs_off", block_px=px, batch=best[px]["batch"], kernel_options=M_FRONTS[px],
             stage1_prob_max_abs_diff=(got["stage1_prob"] - want["stage1_prob"]).abs()
             .max().item(), final_agrees=(got["final"] == want["final"]).float().mean().item(),
             finite=bool(torch.isfinite(got["stage1_prob"]).all()))
        if not torch.isfinite(got["stage1_prob"]).all():
            raise AssertionError(f"m3 {px} px: non-finite stage-1 probabilities")


def run_path_m(dev, smi: str) -> dict:
    """Path m: m1 ``per_size_batch_sweep`` and m2 ``cascade_batch_sweep``
    through their ``main``s at their default grids and ``--iters`` (no port
    kernel: the folded graph with fronts off); m3 the kernels through the
    bench helpers' own parameters (:func:`m3_kernels`), whose K2 and K5
    launches must be exactly :func:`m_predicted_launches`; then, after the
    counts are read, :func:`check_m3_kernels`. Returns the path's
    launches."""
    found, kept = {}, {}

    def run_one(part):
        if part == "m3":
            return m3_kernels(found["m1"], dev, kept)
        module = per_size_batch_sweep if part == "m1" else cascade_batch_sweep
        t0 = time.perf_counter()
        printed = quietly(module.main, ["--iters", str(M_ITERS), "--device", dev.type])
        rows, best = sweep_rows(printed, 4 if part == "m1" else 3)
        found[part] = ast.literal_eval(best) if part == "m1" else json.loads(best)
        return {"seconds": time.perf_counter() - t0, "rows": rows, "best": found[part],
                "device_line": printed.splitlines()[0]}

    t0 = time.perf_counter()
    runs, launches = drive("m_sweeps", [("m1_per_size", "m1"), ("m2_cascade", "m2"),
                                        ("m3_kernels", "m3")], run_one)
    m1, m2, m3 = runs
    m_rows("m1_per_size", m1["rows"], sum(len(b) for b in per_size_batch_sweep.SWEEP.values()),
           smi)
    m_rows("m2_cascade", m2["rows"], 3, smi)
    for name, run in (("m1_per_size", m1), ("m2_cascade", m2)):
        emit("end_to_end", path="m_sweeps", run=name, seconds=run["seconds"],
             best=run["best"], device_line=run["device_line"], launches=run["launches"])
        if run["launches"]:
            raise AssertionError(f"{name}: the fronts-off sweep launched {run['launches']}")
    want = m_predicted_launches()
    emit("end_to_end", path="m_sweeps", run="m3_kernels", launches=m3["launches"],
         predicted_launches=want, nvidia_smi=smi,
         **{k: v for k, v in m3.items() if k not in ("name", "launches")})
    if m3["launches"] != want:
        raise AssertionError(f"m3: launches {m3['launches']}, predicted {want}")
    for px, cell in m3["cells"].items():
        if not cell["blocks_per_s"] > 0 or not 0 < cell["mfu"] <= 1:
            raise AssertionError(f"m3 {px} px: {cell}")
    if not 0 < m3["cascade"]["mfu"] <= 1:
        raise AssertionError(f"m3 cascade: {m3['cascade']}")
    check_m3_kernels(kept, found["m1"], dev)
    emit("m_done", seconds=time.perf_counter() - t0, nvidia_smi=nvidia_smi_line())
    return launches


def device_time_by_kernel(fn: Callable, top: int = 8) -> list:
    """The ``top`` kernel names by device ms in one traced call of ``fn``:
    ``[name, calls, ms]``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            calls, us = by_name.get(e.name, (0, 0.0))
            by_name[e.name] = (calls + 1, us + e.time_range.end - e.time_range.start)
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:top]
    return [[name[:80], calls, us / 1e3] for name, (calls, us) in ranked]


def int8_predict_phase(models: PipelineModels, calib: np.ndarray, samples: np.ndarray,
                       dev, smi: str) -> None:
    """One 4,096-block bf16 predict, int8 with K1 off and on beside the folded
    ``off`` pipeline (``time_predicts``, with the kernels that take the most
    device time)."""
    batch = torch.from_numpy(samples[:BATCH]).to(dev)
    predicts = {
        "folded_off": make_v6_pipeline_folded(models, THRESHOLD, float_dtype=torch.bfloat16,
                                              device=dev),
        "int8_off": make_v6_pipeline_int8(models, calib, THRESHOLD,
                                          float_dtype=torch.bfloat16, device=dev),
        "int8_on": make_v6_pipeline_int8(models, calib, THRESHOLD, float_dtype=torch.bfloat16,
                                         use_fused_front=True, device=dev),
    }
    time_predicts({name: (functools.partial(predict, batch), "bfloat16")
                   for name, predict in predicts.items()}, smi, top_kernels=True)


def time_predicts(predicts: dict, smi: str, top_kernels: bool = False) -> dict:
    """CUDA-event ms of one predict per mode (``predicts``: name -> (a call
    of one 4,096-block predict on a batch already on the card, its dtype)):
    two warm-up rounds of 10 calls, then six samples per mode in ABC...CBA
    turns (each the mean of 10 predicts; ``predict_ms`` is their median),
    with the port's kernels launched per predict and, from a
    ``torch.profiler`` trace, the kernels, host launch calls, device busy ms
    and idle share; with ``top_kernels`` the kernels that take the most
    device time. Emits one ``predict`` line per mode and returns the port's
    kernels launched per predict, by mode."""
    for _ in range(2):  # warm-up: cuDNN plans, the allocator, the clocks
        for fn, _ in predicts.values():
            for _ in range(10):
                fn()
    names = list(predicts)
    samples_ms = {name: [] for name in names}
    for name in (names + names[::-1]) * 3:
        samples_ms[name].append(time_ms(predicts[name][0], iters=10))
    launched = {}
    for name in names:
        fn, dtype = predicts[name]
        launched[name] = launched_by(fn)
        trace = trace_calls(fn)
        ms = float(np.median(samples_ms[name]))
        busy = trace["device_busy_ms"]
        extra = {"top_kernels": device_time_by_kernel(fn)} if top_kernels else {}
        emit("predict", mode=name, batch=BATCH, hw=HW, dtype=dtype, predict_ms=ms,
             samples_ms=samples_ms[name], port_kernels_per_predict=launched[name],
             idle_share=None if busy is None else max(0.0, 1.0 - busy / ms),
             nvidia_smi=smi, kernels_per_predict=trace["kernels"], device_busy_ms=busy,
             host_launch_calls_per_predict=trace["host_launch_calls"], **extra)
    return launched


def v5_flatten_predict_phase(f_models: dict, stage1, val: Bundle, dev, smi: str) -> None:
    """One 4,096-block predict of path f's pipelines (``time_predicts``): v5
    and the QP-conditioned v5 (fp32, fed the batch's QPs / 255), flatten in
    fp32 and bf16. None may launch a port kernel."""
    batch = torch.from_numpy(val.samples[:BATCH]).to(dev)
    qps = (torch.from_numpy(val.qps[:BATCH]).float() / 255.0).to(dev)
    v5, v5_qp = (make_v5_pipeline(f_models[name], THRESHOLD, device=dev)
                 for name in ("v5", "v5_qp"))
    flatten = {dtype: make_flatten_pipeline(stage1, f_models["flat"], THRESHOLD,
                                            input_dtype=dtype, device=dev)
               for dtype in (torch.float32, torch.bfloat16)}
    launched = time_predicts({
        "v5": (functools.partial(v5, batch), "float32"),
        "v5_qp": (functools.partial(v5_qp, batch, qps), "float32"),
        "flatten": (functools.partial(flatten[torch.float32], batch), "float32"),
        "flatten_bf16": (functools.partial(flatten[torch.bfloat16], batch), "bfloat16"),
    }, smi, top_kernels=True)
    if any(launched.values()):
        raise AssertionError(f"the v5 and flatten predicts launched {launched}")


# ---------------------------------------------------------------------------
# Phase 6: one predict per mode
# ---------------------------------------------------------------------------

PREDICT_MODES = {  # name: (use_fused_front, use_pallas_groups)
    "off": (False, False), "on": (True, False), "g1": ("g1", False),
    "groups_off": (False, True), "groups_on": (True, True),
}


def trace_calls(fn: Callable, repeats: int = 3) -> dict:
    """Per call of ``fn``, from a ``torch.profiler`` trace of ``repeats`` calls:
    the kernels on the device, the device's busy ms (the union of the kernels'
    intervals) and the host's launch calls. The device fields are None if the
    trace shows no device activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(repeats):
            fn()
        torch.cuda.synchronize()
    events = prof.events()
    launch_calls = sum(e.device_type == DeviceType.CPU and "LaunchKernel" in e.name
                       for e in events) / repeats
    kernels, busy_us = device_busy(events)
    if not kernels:
        return {"kernels": None, "device_busy_ms": None, "host_launch_calls": launch_calls}
    return {"kernels": kernels / repeats, "device_busy_ms": busy_us / 1e3 / repeats,
            "host_launch_calls": launch_calls}


def device_busy(events) -> tuple:
    """``(device events, busy us)`` of a ``torch.profiler`` trace: the count of
    its device events and the union of their intervals."""
    from torch.autograd import DeviceType

    spans = sorted((e.time_range.start, e.time_range.end) for e in events
                   if e.device_type == DeviceType.CUDA)
    if not spans:
        return 0, 0.0
    busy, (lo, hi) = 0.0, spans[0]
    for start, end in spans[1:]:
        if start > hi:
            busy, lo, hi = busy + hi - lo, start, end
        else:
            hi = max(hi, end)
    return len(spans), busy + hi - lo


def launched_by(fn: Callable) -> dict:
    """The port's kernels that one call of ``fn`` launches."""
    before = dict(_build.launch_counts)
    fn()
    return {k: v - before[k] for k, v in _build.launch_counts.items() if v - before[k]}


def predict_phase(models: PipelineModels, samples: np.ndarray, dev, smi: str,
                  capacities: dict) -> None:
    """One 4,096-block bf16 predict on a batch on the card (``time_predicts``)
    for each of ``PREDICT_MODES`` and the folded gated pipeline at each of
    ``capacities`` (name: capacity)."""
    batch = torch.from_numpy(samples[:BATCH]).to(dev)
    predicts = {
        name: make_v6_pipeline_folded(models, THRESHOLD, float_dtype=torch.bfloat16,
                                      use_fused_front=front, use_pallas_groups=groups,
                                      device=dev)
        for name, (front, groups) in PREDICT_MODES.items()
    }
    for name, capacity in capacities.items():
        predicts[name] = make_v6_pipeline_gated(
            models, capacity, THRESHOLD, input_dtype=torch.bfloat16, folded=True, device=dev)
    time_predicts({name: (functools.partial(predict, batch), "bfloat16")
                   for name, predict in predicts.items()}, smi)


LEVEL_MODES = {  # name: (family, use_fused_front, use_pallas_groups)
    "off": ("stages", False, False), "g1": ("stages", "g1", False),
    "groups_on": ("stages", True, True), "unified_g1": ("unified", "g1", False),
}


def cascade_levels_phase(models: dict, sbs: np.ndarray, dev, smi: str) -> None:
    """The cascade level by level for one group of four frames (2,040
    superblocks on the card), bf16, dense: per mode and block size the CUDA-event
    ms of the level's ``run_pipeline_batched`` (median of three), the port's
    kernels it launches, and from a ``torch.profiler`` trace of one run its
    kernel count, the device's busy ms and the idle share."""
    sbs_dev = torch.from_numpy(sbs).to(dev).view(torch.int16)
    for mode, (family, front, groups) in LEVEL_MODES.items():
        for size in LEVEL_SIZES:
            if family == "unified":
                predict = make_unified_pipeline_folded(
                    models[size]["unified"], THRESHOLD, float_dtype=torch.bfloat16,
                    use_fused_front=front, device=dev)
            else:
                predict = make_v6_pipeline_folded(
                    level_pipeline_models(models, size), THRESHOLD,
                    float_dtype=torch.bfloat16, use_fused_front=front,
                    use_pallas_groups=groups, device=dev)
            blocks = quad_tile_on_device(sbs_dev, size).view(torch.uint16)
            rows = blocks.shape[0]
            level_batch = min(BATCH, -(-rows // 256) * 256)  # as the cascade sets it

            def run_level():
                return run_pipeline_batched(predict, blocks, level_batch, dev,
                                            as_numpy=False)

            run_level()  # warm-up: cuDNN plans at this level's shapes
            samples = [time_ms(run_level, iters=1, warmup=0) for _ in range(3)]
            launched = launched_by(run_level)
            trace = trace_calls(run_level, repeats=1)
            ms = float(np.median(samples))
            busy = trace["device_busy_ms"]
            emit("cascade_level", mode=mode, block_size=size, rows=rows,
                 chunks=-(-rows // level_batch), dtype="bfloat16", level_ms=ms,
                 samples_ms=samples, port_kernels=launched,
                 idle_share=None if busy is None else max(0.0, 1.0 - busy / ms),
                 nvidia_smi=smi, **trace)


# ---------------------------------------------------------------------------
# Phase 7: timing
# ---------------------------------------------------------------------------


class TimingCase(NamedTuple):
    kernel: str                   # a name of KERNELS
    run: Callable                 # the kernel's wrapper
    plain: Callable               # its plain PyTorch version
    library: Optional[Callable]   # one PyTorch call for the same function, if any
    n_bytes: int                  # inputs read once + outputs written once
    flops: float                  # the function's operations on these inputs
    dtype: torch.dtype            # the type whose peak rate bounds the operations
    shape: dict
    main: bool                    # the case of the main path: the `kernels` line


def timing_cases(folded, gen, dev) -> list:
    """Every kernel at its main path's shape, K1 and K2 also at 8 px, K4 also
    in bf16 and K5 at the other extents."""
    bf16, f32 = torch.bfloat16, torch.float32
    cases = []
    inputs = {hw: (torch.randint(0, 1024, (BATCH, hw, hw, 1), generator=gen).float()
                   / 1023.0).to(dev, bf16) for hw in (HW, 8)}
    for (hw, x), name in itertools.product(inputs.items(),
                                           ("fused_front", "fused_front_g1")):
        kern, plain, args = front_args(name, folded, bf16, dev)
        cases.append(TimingCase(
            name, lambda k=kern, x=x, a=args: k(x, *a),
            lambda p=plain, x=x, a=args: p(x, *a), None,
            tensor_bytes(x, *args, kern(x, *args)),
            BATCH * front_flops(hw, with_g1=name == "fused_front_g1"), bf16,
            {"batch": BATCH, "hw": hw, "dtype": "bfloat16"}, hw == HW))
    wg = tuple(t.to(dev) for t in rg.pack_group12_weights(folded, bf16))
    stream = rg.group12_conv_stream(wg)
    for e in (HW // 4,) + tuple(e for e in rg.EXTENTS if e != HW // 4):
        xg = stem_output(folded, gen, BATCH, 4 * e, dev).to(bf16)
        cases.append(TimingCase(
            "fused_group12", lambda xg=xg: rg.fused_group12(xg, wg, stream),
            lambda xg=xg: rg.fused_group12_reference(xg, wg), None,
            tensor_bytes(xg, *wg, rg.fused_group12(xg, wg, stream)),
            BATCH * group12_flops(e), bf16,
            {"batch": BATCH, "extent": e, "dtype": "bfloat16"}, e == HW // 4))
    for e, rows in ((16, 510), (16, 2040), (8, 2040)):  # levels 64 and 32 px of path d
        xg = stem_output(folded, gen, rows, 4 * e, dev).to(bf16)
        cases.append(TimingCase(
            "fused_group12", lambda xg=xg: rg.fused_group12(xg, wg, stream),
            lambda xg=xg: rg.fused_group12_reference(xg, wg), None,
            tensor_bytes(xg, *wg, rg.fused_group12(xg, wg, stream)),
            rows * group12_flops(e), bf16,
            {"batch": rows, "extent": e, "dtype": "bfloat16"}, False))
    rng = np.random.default_rng(SEED + 2)
    frames = torch.from_numpy(pp.pad_frames(codes(rng, FRAMES), HW)).to(dev)
    cases.append(TimingCase(
        "tile_normalize_frames", lambda: pp.tile_normalize_frames(frames, HW, bf16),
        lambda: pp.tile_normalize_reference(frames, HW, bf16), None,
        tensor_bytes(frames, pp.tile_normalize_frames(frames, HW, bf16)),
        float(frames.numel()), f32,  # one fp32 divide per value
        {"frames": list(frames.shape), "block_size": HW, "dtype": "bfloat16"}, True))
    blocks = torch.from_numpy(codes(rng, (N_VAL, HW, HW, 1))).to(dev)
    cases.append(TimingCase(
        "normalize_blocks", lambda: pp.normalize_blocks(blocks, bf16),
        lambda: pp.normalize_blocks_reference(blocks, bf16), None,
        tensor_bytes(blocks, pp.normalize_blocks(blocks, bf16)), float(blocks.numel()), f32,
        {"shape": list(blocks.shape), "dtype": "bfloat16"}, True))
    d_in, d_hid, _ = HEAD
    cpu = (torch.randn(BATCH, d_in, generator=gen),
           torch.randn(d_in, d_hid, generator=gen) / math.sqrt(d_in),
           torch.randn(d_hid, generator=gen))
    for dtype in (f32, bf16):  # fp32 is path c's dtype
        xd, wd, bd = cpu[0].to(dev, dtype), cpu[1].to(dev, dtype), cpu[2].to(dev)
        bias = bd.to(dtype)  # addmm wants one dtype
        cases.append(TimingCase(
            "fused_dense", lambda xd=xd, wd=wd: fused_dense(xd, wd, bd, "relu"),
            lambda xd=xd, wd=wd: fused_dense_reference(xd, wd, bd, "relu"),
            lambda xd=xd, wd=wd, bias=bias: torch.addmm(bias, xd, wd).relu_(),
            tensor_bytes(xd, wd, bd, fused_dense(xd, wd, bd, "relu")),
            # fp32 too at the tensor cores' bf16 rate: the kernel runs it there
            2.0 * BATCH * d_in * d_hid, bf16,
            {"shape": [BATCH, d_in, d_hid], "act": "relu",
             "dtype": str(dtype).replace("torch.", "")}, dtype == f32))
    return cases


def time_case(case: TimingCase, smi: str) -> dict:
    """The case's calls in turns (plain, library, kernel, kernel, library,
    plain), device time through a CUDA graph; the wrapper also from Python."""
    order = [case.plain, case.library, case.run, case.run, case.library, case.plain]
    slow = case.shape.get("extent", 0) >= 8
    t = [None if fn is None else device_ms(fn, iters=4 if slow else 20,
                                           replays=2 if slow else 5) for fn in order]
    bound_ms, bound_by = bound(case.n_bytes, case.flops, case.dtype)
    result = {
        "ms": (t[2] + t[3]) / 2, "plain_ms": (t[0] + t[5]) / 2,
        "library_ms": None if case.library is None else (t[1] + t[4]) / 2,
        "bound_ms": bound_ms, "bound_by": bound_by,
    }
    emit("timing", kernel=case.kernel, **result, share_of_bound=bound_ms / result["ms"],
         eager_ms=time_ms(case.run, iters=10 if slow else 50), samples_ms=t[2:4],
         plain_samples_ms=[t[0], t[5]],
         library_samples_ms=None if case.library is None else [t[1], t[4]],
         bytes=case.n_bytes, flops=case.flops, nvidia_smi=smi, **case.shape)
    return result


def ptxas_report(lib: Path) -> dict:
    """Registers, spill bytes (stores, loads), static shared memory and the
    count of ptxas's C75xx warnings (wgmmas it serialised) of every fused
    kernel, from the ``-Xptxas -v`` lines in nvcc's logs beside the library."""
    mangled = re.compile(r"\S*?(?<=\d)(fused_[a-z0-9_]+?_kernel)I(\S*?)Ev\S*")
    entry = re.compile(
        r"Compiling entry function '(\S+)'.*?"
        r"(\d+) bytes spill stores, (\d+) bytes spill loads.*?Used (\d+) registers([^\n]*)",
        re.S)

    def key(name: str) -> Optional[str]:
        found = mangled.fullmatch(name)
        if found is None:
            return None
        args = [a or b or c for a, b, c in
                re.findall(r"Li(\d+)E|(f)|13__nv_(bfloat16)", found.group(2))]
        return f"{found.group(1)}<{', '.join(args)}>"

    report = {}
    for log in sorted(lib.parent.glob("*.nvcc.log")):
        text = log.read_text()
        for name, stores, loads, regs, rest in entry.findall(text):
            if key(name) is None:
                continue
            smem = re.search(r"(\d+) bytes smem", rest)
            report[key(name)] = {
                "registers": int(regs), "spill_bytes": [int(stores), int(loads)],
                "static_smem_bytes": int(smem.group(1)) if smem else 0, "c75_warnings": 0}
        for name in re.findall(r"\(C75\d\d\)[^\n]*?'(\S+?)'", text):
            report.setdefault(key(name) or "unattributed", {"c75_warnings": 0})["c75_warnings"] += 1
    return report


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke test needs one",
              file=sys.stderr)
        return 1
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smi = nvidia_smi_line()
    kind = torch.cuda.get_device_name(0)
    emit("device", nvidia_smi=smi, kind=kind, count=torch.cuda.device_count(),
         torch=torch.__version__, cuda=torch.version.cuda)
    loaded = sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN_MODULES)
    if loaded:
        raise AssertionError(f"the port must import nothing of {FORBIDDEN_MODULES}; "
                             f"loaded: {loaded[:5]}")

    t0 = time.perf_counter()
    lib = _build.build_kernels()
    _build.load_kernels()
    emit("build", seconds=time.perf_counter() - t0, library=str(lib.relative_to(ROOT)),
         sources=[str(s.relative_to(ROOT)) for s in _build.SOURCES],
         ptxas=ptxas_report(lib))

    torch.manual_seed(SEED)  # dropout during BN calibration
    gen = torch.Generator().manual_seed(SEED)
    calib = torch.randint(0, 1024, (512, HW, HW, 1), generator=gen).float() / 1023.0
    models = {name: seeded_model(cls, gen, calib) for name, cls in (
        ("stage1", Stage1Model), ("stage2", Stage2Model),
        ("rect", Stage3RectModel), ("ab", Stage3ABModel), ("fgvc", FGVCModel),
    )}
    folded = fold_backbone(models["stage1"].backbone)
    errors = check_kernels(folded, gen, dev)
    check_kernels_at_cascade_shapes(folded, gen, dev)

    dataset = make_dataset()
    val = Bundle.load(dataset / f"block_{HW}" / "val.npz")
    plain = PipelineModels(models["stage1"], models["stage2"], models["rect"],
                           models["ab"])
    check_reference(plain, val.samples[:2048], dev)

    ckpts = {}
    for name, model in models.items():
        ckpts[name] = save_variables_npz(WORK / "ckpt" / f"{name}_variables.npz",
                                         to_jax_variables(model.state_dict()))

    # path a: the serving CLI. A warm-up run pays cuDNN's and the
    # allocator's first calls; then each front once.
    def front(mode, ab="ab"):
        return ["--folded", "--fused-front", mode, *v6_checkpoints(ckpts, ab)]

    cli_runs, cli_launches = drive("a_cli", [
        (name, (name, args)) for name, args in (
            ("off_warmup", front("off")), ("off", front("off")), ("on", front("on")),
            ("g1", front("g1")), ("on_fgvc", front("on", "fgvc")))
    ], lambda arg: run_cli(dataset, *arg, dev))
    base = cli_runs[1]
    report_runs("a_cli", cli_runs, base,
                lambda r: FRONT_KERNELS.get(r["name"].split("_")[0], []))

    # path b: K5 serving, fronts off and on, after a warm-up, in turns
    k5_runs, k5_launches = drive("b_groups", [
        ("groups_off_warmup", False), ("groups_off", False), ("groups_on", True),
        ("groups_on_2", True), ("groups_off_2", False),
    ], serve_with_groups(plain, val.samples, dev))
    report_runs("b_groups", k5_runs, base, lambda r: ["fused_group12"] + (
        ["fused_front"] if r["mode"] else []))

    # path c: the kernels API
    _, api_launches = drive("c_kernel_api", [("ingest_and_head", None)],
                            lambda _: kernel_api_path(plain, val, dev))

    # path d: the tree cascade on eight 1080p frames, each level with its own
    # seeded models; first its fp32 reference check on 256 superblocks
    t0 = time.perf_counter()
    tree_models = cascade_models(dev)
    clip, tree_dirs = write_clip(), write_cascade_checkpoints(tree_models)
    clip_sbs = tile_frames(read_y_frames_batch(
        clip, Yuv420p10Geometry(CLIP[2], CLIP[1]), range(FRAMES_PER_BATCH)), 64)[0]
    emit("tree_setup", seconds=time.perf_counter() - t0, clip=str(clip.relative_to(ROOT)),
         clip_bytes=clip.stat().st_size, superblocks_per_frame=FRAME_SBS,
         models="4 stage models + 1 unified model per block size, each calibrated "
                "at its own size")
    check_tree_reference(tree_models, clip_sbs[:256], dev)

    def run_tree(arg):
        kind, name, extra = arg
        if kind == "cli":
            return run_tree_cli(clip, tree_dirs, name, extra, dev)
        return run_tree_library(tree_models, clip_sbs, extra, dev)

    fronts = [("off", ["--fused-front", "off"]), ("on", ["--fused-front", "on"]),
              ("g1", ["--fused-front", "g1"])]
    tree_runs, tree_launches = drive("d_trees", [
        ("off_warmup", ("cli", "off_warmup", fronts[0][1])),
        *((name, ("cli", name, extra)) for name, extra in fronts),
        *((f"unified_{name}", ("cli", f"unified_{name}", ["--unified", *extra]))
          for name, extra in fronts),
        ("gated", ("cli", "gated", ["--fused-front", "off", "--level-capacity",
                                    *map(str, LEVEL_CAPACITY)])),
        ("int8_on", ("cli", "int8_on", ["--int8", "--fused-front", "on"])),
        ("unified_int8_on", ("cli", "unified_int8_on",
                             ["--unified", "--int8", "--fused-front", "on"])),
        ("groups_off", ("library", "groups_off", False)),
        ("groups_on", ("library", "groups_on", True)),
    ], run_tree)
    by_name = {run["name"]: run for run in tree_runs}
    report_tree_runs(tree_runs, {
        "on": ["fused_front"], "g1": ["fused_front_g1"],
        "unified_on": ["fused_front"], "unified_g1": ["fused_front_g1"],
        "groups_off": ["fused_group12"], "groups_on": ["fused_group12", "fused_front"],
        "int8_on": ["fused_front"], "unified_int8_on": ["fused_front"],
    })
    check_gated_run(by_name["gated"], by_name["off"])
    for name in ("fused_front", "fused_front_g1", "fused_group12"):
        if tree_launches[name] == 0:
            raise AssertionError(f"{name} was never launched by the tree cascade")

    # path a, second part: the rest of v6 serving on path a's dataset, with
    # three seeded AB members as an ensemble and path d's 16 px unified model
    ckpts["ensemble"] = WORK / "ensemble"
    members = torch.Generator().manual_seed(SEED + 5)
    save_ensemble(ckpts["ensemble"], [
        to_jax_variables(seeded_model(Stage3ABModel, members, calib).state_dict())
        for _ in range(ENSEMBLE_MEMBERS)])
    plan = serving_plan(dataset, ckpts, tree_dirs[HW] / "unified_best_variables.npz", dev)
    serving_runs, serving_launches = drive(
        "a_serving", [(name, (name, spec)) for name, spec in plan], serve_one(dataset, dev))
    check_serving_runs(serving_runs, base)
    stacking_phase(ckpts["ensemble"], val.samples, dev)

    # path e: int8 serving on path a's dataset and models (path d's 16 px
    # unified model), calibrated on the CLI's 512 train rows; first the
    # library checks against the CPU and of K1's launches
    t0 = time.perf_counter()
    train = Bundle.load(dataset / f"block_{HW}" / "train.npz")
    calib = train_calibration_blocks(train.samples, INT8_CALIB)
    calib_x = torch.from_numpy(calib).float() / 1023.0
    x_cpu = torch.from_numpy(val.samples[:2048]).float() / 1023.0
    check_int8_products(ptq.quantize_stage(models["stage2"], calib_x), x_cpu, dev)
    check_int8_card_vs_cpu(models["stage2"], calib_x, x_cpu, dev, unified=False)
    check_int8_card_vs_cpu(tree_models[HW]["unified"], calib_x, x_cpu, dev, unified=True)
    int8_library_checks(plain, tree_models[HW]["unified"], level_pipeline_models(tree_models, 8),
                        calib, val.samples, dev)
    emit("int8_checks", seconds=time.perf_counter() - t0)
    int8_runs, int8_launches = drive(
        "e_int8", int8_plan(dataset, ckpts, tree_dirs[HW] / "unified_best_variables.npz"),
        lambda arg: run_cli(dataset, arg[0], arg[1], dev, bf16=arg[2]))
    check_int8_runs(int8_runs, {"v6": base, "unified": next(
        run for run in serving_runs if run["name"] == "unified_off")})

    # path f: v5 and flatten serving, then path a's pipeline from .pt files
    f_models, val_f, f_launches, pt_launches = run_path_f(
        models, ckpts, dataset, next(run for run in cli_runs if run["name"] == "on"), dev)

    # path g: training on the card, then the trained checkpoints served
    g_launches, g_out = run_path_g(ckpts, dev, smi)

    # path h: the rest of training on path g's corpus, then the trained ladder served
    h_launches = run_path_h(g_out, dev, smi)

    # path i: a raw 1080p clip through prepare_data and prepare_dataset, then
    # served at 16 and 8 px with path d's models (path a's fronts' agreement
    # with off is emitted beside its runs')
    path_a_agreement = min(float((run["final"] == base["final"]).mean())
                           for run in cli_runs if run["name"] in ("on", "g1"))
    i_launches = run_path_i(tree_dirs, path_a_agreement, dev)

    # path j: the port on several processes (ROADMAP M11): a world of one over
    # NCCL, then two ranks sharing the card over gloo that serve path a's
    # blocks and path d's clip and train, each held to one process
    j_launches = run_path_j(dataset, ckpts, cli_runs, tree_dirs, clip, clip_sbs,
                            tree_models, by_name["gated"], g_out, dev, smi)

    # path k: the port's examples, each through its main (ROADMAP M12 rest)
    k_launches = run_path_k(dev)

    # path l: stacked backbones, the int8 im2col lowering with K1 and the
    # batching producer with K2, on path a's blocks and models
    l_launches = run_path_l(plain, tree_models[8]["stage2"], calib, val.samples, dev)

    # path m: the two sweep examples through their mains, then K2 and K5
    # through the bench helpers' parameters
    m_launches = run_path_m(dev, smi)

    launches = {k: cli_launches[k] + k5_launches[k] + api_launches[k] + tree_launches[k]
                + serving_launches[k] + int8_launches[k] + f_launches[k] + pt_launches[k]
                + g_launches[k] + h_launches[k] + i_launches[k] + j_launches[k]
                + k_launches[k] + l_launches[k] + m_launches[k] for k in _build.KERNELS}
    for name in KERNELS:
        if launches[name] == 0:
            raise AssertionError(f"{name} was never launched by a main path")

    predict_phase(plain, val.samples, dev, smi, {
        name: next(r["capacity"] for r in serving_runs if r["name"] == name)
        for name in ("gated_auto", "gated_0.5")})
    int8_predict_phase(plain, calib, val.samples, dev, smi)
    v5_flatten_predict_phase(f_models, models["stage1"], val_f, dev, smi)
    cascade_levels_phase(tree_models, clip_sbs, dev, smi)

    kernels = []
    for case in timing_cases(folded, gen, dev):
        result = time_case(case, smi)
        if case.main:
            source, replaces = KERNELS[case.kernel]
            kernels.append({"name": case.kernel, "route": "cuda", "source": source,
                            "replaces": replaces, "launches": launches[case.kernel],
                            "max_abs_err": errors[case.kernel], **result})
    if sorted(k["name"] for k in kernels) != sorted(KERNELS):
        raise AssertionError("the kernels line must list every kernel once")

    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
