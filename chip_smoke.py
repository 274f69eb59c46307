#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``av1tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout. Phases, one JSON line each:
  1. device: ``nvidia-smi`` name and power limit, the torch device name;
  2. build: nvcc builds the kernels from ``av1tpu_torch/csrc``, one process
     per source, all started together;
  3. kernel checks, each kernel against its plain PyTorch version on the
     card, fp32 (TF32 off) and bf16: K1 and K2 at 8 and 16 px and K5 at
     extents 2-16 (8-64 px blocks), batch 4099; K3a on three padded 1080p
     frames at bs 16 and 64 and K3b on 4099 blocks (bit-exact); K4 forward
     for each activation at (4099, 512) x (512, 256) and K4 backward;
  4. reference: the folded fp32 pipeline on the card (fronts off/on/g1, and
     K5 with fronts off/on) against the plain nn.Module pipeline on the CPU;
  5. three main paths, each driven with the launch counts set to 0 just
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
     each run prints blocks/s (or its own rate), its launches, and its
     agreement with path a's ``off`` run;
  6. timing: each kernel and its plain version in turns at the main paths'
     shapes.
Then the card's ``nvidia-smi`` line, a ``{"kernels": [...]}`` line, and as the
last line ``{"ok": true, "device": {...}}``. Any failed phase raises and the
script exits non-zero; without a CUDA device it fails before printing.
"""
from __future__ import annotations

import copy
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

from av1tpu_torch.cli import run_pipeline_eval  # noqa: E402
from av1tpu_torch.cli.common import Bundle, save_split  # noqa: E402
from av1tpu_torch.eval import (  # noqa: E402
    PipelineModels,
    make_v6_pipeline,
    make_v6_pipeline_folded,
    run_pipeline_batched,
)
from av1tpu_torch.kernels import _build  # noqa: E402
from av1tpu_torch.kernels import fused_front as ff  # noqa: E402
from av1tpu_torch.kernels import preprocess as pp  # noqa: E402
from av1tpu_torch.kernels import resnet_group as rg  # noqa: E402
from av1tpu_torch.kernels.fused_dense import (  # noqa: E402
    fused_dense,
    fused_dense_reference,
)
from av1tpu_torch.models import (  # noqa: E402
    FGVCModel,
    Stage1Model,
    Stage2Model,
    Stage3ABModel,
    Stage3RectModel,
    to_jax_variables,
)
from av1tpu_torch.quant.ptq import fold_backbone  # noqa: E402
from av1tpu_torch.train.checkpoint import save_variables_npz  # noqa: E402

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
GRAD_TOL = {"rtol": 1e-3, "atol": 1e-4}  # K4 backward, as tests/test_kernels.py
WORK = ROOT / "build" / "chip_smoke"
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


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def seeded_model(cls, gen: torch.Generator, calib: torch.Tensor) -> nn.Module:
    """A model drawn from ``gen``: lecun-normal weights, BN running stats
    set to a calibration batch's statistics and then perturbed, so that
    the logits depend on the input."""
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
        model.train()
        model(calib)
        model.eval()
        for mod in model.modules():
            if isinstance(mod, nn.modules.batchnorm._BatchNorm):
                std = mod.running_var.sqrt()
                mod.running_mean += 0.2 * std * torch.randn(std.shape, generator=gen)
                mod.running_var *= 0.5 + torch.rand(std.shape, generator=gen)
    return model


def codes(rng: np.random.Generator, shape) -> np.ndarray:
    """Uniform 10-bit codes as uint16."""
    return rng.integers(0, 1024, size=shape, dtype=np.uint16)


def host_tile(frames: np.ndarray, bs: int) -> np.ndarray:
    """(F, H, W) -> (F*R*C, bs, bs, 1), frame-major then row-major."""
    f, h, w = frames.shape
    x = frames.reshape(f, h // bs, bs, w // bs, bs).transpose(0, 1, 3, 2, 4)
    return np.ascontiguousarray(x.reshape(-1, bs, bs, 1))


def time_ms(fn, iters: int = 50) -> float:
    for _ in range(5):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# ---------------------------------------------------------------------------
# Phase 3: every kernel against its plain version
# ---------------------------------------------------------------------------


def compare(name, got, want, tol, **fields) -> float:
    """Max |got - want|, emitted; raises above ``tol``."""
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"{name}: {got.shape}/{got.dtype} "
                             f"vs {want.shape}/{want.dtype}")
    err = (got.float() - want.float()).abs().max().item()
    scale = want.float().abs().max().item()
    emit("kernel_check", kernel=name, max_abs_err=err, tol=tol,
         max_abs_out=scale, **fields)
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


def stem_output(folded, gen, n, hw, dev) -> torch.Tensor:
    """K5's input: the fp32 stem + pool of ``n`` random ``hw`` px blocks."""
    img = (torch.randint(0, 1024, (n, hw, hw, 1), generator=gen).float()
           / 1023.0).to(dev)
    stem = ff.stem_weights(folded["stem"]["weight"], folded["stem"]["bias"],
                           torch.float32)
    return ff.fused_front_reference(img, *(t.to(dev) for t in stem))


def check_kernels(folded, gen, dev) -> dict:
    """Each kernel against its plain version on the card; returns the max
    error per kernel at its main path's shape and dtype."""
    errors = {}
    bf16, f32 = torch.bfloat16, torch.float32
    for hw in (8, 16):  # K1, K2
        x_u16 = torch.randint(0, 1024, (RAGGED, hw, hw, 1), generator=gen)
        for dtype in (f32, bf16):
            x = (x_u16.float() / 1023.0).to(dev, dtype)
            for name in ("fused_front", "fused_front_g1"):
                kern, plain, args = front_args(name, folded, dtype, dev)
                got = kern(x, *args)
                torch.cuda.synchronize()
                want = plain(x, *args)
                tol = (FP32_TOL[name] if dtype == f32
                       else BF16_REL_TOL * max(1.0, want.float().abs().max().item()))
                err = compare(name, got, want, tol, hw=hw, batch=RAGGED,
                              dtype=str(dtype))
                if hw == HW and dtype == bf16:
                    errors[name] = err

    for e in rg.EXTENTS:  # K5 on the stem's output of 4e px blocks
        x32 = stem_output(folded, gen, RAGGED, 4 * e, dev)
        for dtype in (f32, bf16):
            x = x32.to(dtype)
            w = tuple(t.to(dev) for t in rg.pack_group12_weights(folded, dtype))
            got = rg.fused_group12(x, w)
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

    d_in, d_hid, _ = HEAD  # K4 forward at a head's first layer, ragged M
    data = (torch.randn(RAGGED, d_in, generator=gen),
            torch.randn(d_in, d_hid, generator=gen) / math.sqrt(d_in),
            torch.randn(d_hid, generator=gen))
    for dtype in (f32, bf16):
        x, w = data[0].to(dev, dtype), data[1].to(dev, dtype)
        b = data[2].to(dev)
        for act in ("linear", "relu", "silu", "sigmoid"):
            got = fused_dense(x, w, b, act)
            torch.cuda.synchronize()
            want = fused_dense_reference(x, w, b, act)
            err = compare("fused_dense", got, want, rel_tol("fused_dense", dtype, want),
                          shape=[RAGGED, d_in, d_hid], act=act, dtype=str(dtype))
            if act == "relu" and dtype == f32:
                errors["fused_dense"] = err
    for act in ("relu", "silu"):  # K4 backward: the custom VJP vs autograd
        grads = []
        for fn in (fused_dense, fused_dense_reference):
            params = [t.to(dev).requires_grad_() for t in data]
            (fn(*params, act) ** 2).sum().backward()
            grads.append([p.grad for p in params])
        for arg, got, want in zip("xwb", *grads):
            err = (got - want).abs().max().item()
            emit("kernel_check", kernel="fused_dense_backward", act=act, grad=arg,
                 max_abs_err=err, max_abs_out=want.abs().max().item(), **GRAD_TOL)
            torch.testing.assert_close(got, want, **GRAD_TOL)
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
    want = make_v6_pipeline(models, stage1_threshold=THRESHOLD)(images)
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
            labels={"stage0": stage0, "stage1": (stage0 != 0).astype(np.int32)},
        )

    root = WORK / "dataset"
    save_split(root, HW, bundle(64), bundle(N_VAL), "v6")
    return root


def run_cli(dataset: Path, ckpts: dict, mode: str, fgvc: bool, dev) -> dict:
    out = WORK / "runs" / (f"{mode}_fgvc" if fgvc else mode)
    argv = [
        "--variant", "v6", "--dataset-dir", str(dataset), "--block-size", str(HW),
        "--output-dir", str(out), "--batch-size", str(BATCH),
        "--stage1-threshold", str(THRESHOLD), "--folded", "--bf16",
        "--fused-front", mode, "--device", dev.type,
        "--stage1-checkpoint", str(ckpts["stage1"]),
        "--stage2-checkpoint", str(ckpts["stage2"]),
        "--stage3-rect-checkpoint", str(ckpts["rect"]),
        "--stage3-ab-checkpoint", str(ckpts["fgvc" if fgvc else "ab"]),
        "--ab-fgvc" if fgvc else "--no-ab-fgvc",
    ]
    run_pipeline_eval.main(argv)
    metrics = json.loads((out / "pipeline_metrics_val.json").read_text())
    preds = np.load(out / "pipeline_predictions_val.npz")
    return {"samples": metrics["samples"],
            "blocks_per_s": metrics["throughput_superblocks_per_sec"],
            "final": preds["predictions"], "stage1_prob": preds["stage1_prob"]}


def drive(path: str, plan, run_one) -> tuple:
    """One main path: counts set to 0, each ``(name, arg)`` of ``plan``
    run through ``run_one``, counts read. Returns (runs, launches)."""
    _build.reset_launch_counts()
    runs, before = [], dict(_build.launch_counts)
    for name, arg in plan:
        run = run_one(arg)
        run["name"] = name
        run["launches"] = {k: v - before[k] for k, v in _build.launch_counts.items()
                           if v - before[k]}
        before = dict(_build.launch_counts)
        runs.append(run)
    launches = dict(_build.launch_counts)
    emit("main_path", path=path, launches=launches)
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
# Phase 6: timing
# ---------------------------------------------------------------------------


def timing_cases(folded, gen, dev) -> dict:
    """name -> (kernel call, plain call, shape note) at the main paths' shapes."""
    bf16 = torch.bfloat16
    cases = {}
    x = (torch.randint(0, 1024, (BATCH, HW, HW, 1), generator=gen).float()
         / 1023.0).to(dev, bf16)
    for name in ("fused_front", "fused_front_g1"):
        kern, plain, args = front_args(name, folded, bf16, dev)
        cases[name] = (lambda k=kern, a=args: k(x, *a), lambda p=plain, a=args: p(x, *a),
                       {"batch": BATCH, "hw": HW, "dtype": "bfloat16"})
    xg = stem_output(folded, gen, BATCH, HW, dev).to(bf16)
    wg = tuple(t.to(dev) for t in rg.pack_group12_weights(folded, bf16))
    cases["fused_group12"] = (lambda: rg.fused_group12(xg, wg),
                              lambda: rg.fused_group12_reference(xg, wg),
                              {"batch": BATCH, "extent": HW // 4, "dtype": "bfloat16"})
    rng = np.random.default_rng(SEED + 2)
    frames = torch.from_numpy(pp.pad_frames(codes(rng, FRAMES), HW)).to(dev)
    cases["tile_normalize_frames"] = (
        lambda: pp.tile_normalize_frames(frames, HW, bf16),
        lambda: pp.tile_normalize_reference(frames, HW, bf16),
        {"frames": list(frames.shape), "block_size": HW, "dtype": "bfloat16"})
    blocks = torch.from_numpy(codes(rng, (N_VAL, HW, HW, 1))).to(dev)
    cases["normalize_blocks"] = (lambda: pp.normalize_blocks(blocks, bf16),
                                 lambda: pp.normalize_blocks_reference(blocks, bf16),
                                 {"shape": list(blocks.shape), "dtype": "bfloat16"})
    d_in, d_hid, _ = HEAD
    xd = torch.randn(BATCH, d_in, generator=gen).to(dev)
    wd = (torch.randn(d_in, d_hid, generator=gen) / math.sqrt(d_in)).to(dev)
    bd = torch.randn(d_hid, generator=gen).to(dev)
    cases["fused_dense"] = (lambda: fused_dense(xd, wd, bd, "relu"),
                            lambda: fused_dense_reference(xd, wd, bd, "relu"),
                            {"shape": [BATCH, d_in, d_hid], "act": "relu",
                             "dtype": "float32"})
    return cases


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
    if "jax" in sys.modules or "av1tpu.kernels" in sys.modules:
        raise AssertionError("the port must not import jax or the JAX kernels")

    t0 = time.perf_counter()
    lib = _build.build_kernels()
    _build.load_kernels()
    emit("build", seconds=time.perf_counter() - t0, library=str(lib.relative_to(ROOT)),
         sources=[str(s.relative_to(ROOT)) for s in _build.SOURCES])

    torch.manual_seed(SEED)  # dropout during BN calibration
    gen = torch.Generator().manual_seed(SEED)
    calib = torch.randint(0, 1024, (512, HW, HW, 1), generator=gen).float() / 1023.0
    models = {name: seeded_model(cls, gen, calib) for name, cls in (
        ("stage1", Stage1Model), ("stage2", Stage2Model),
        ("rect", Stage3RectModel), ("ab", Stage3ABModel), ("fgvc", FGVCModel),
    )}
    folded = fold_backbone(models["stage1"].backbone)
    errors = check_kernels(folded, gen, dev)

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
    cli_runs, cli_launches = drive("a_cli", [
        ("off_warmup", ("off", False)), ("off", ("off", False)), ("on", ("on", False)),
        ("g1", ("g1", False)), ("on_fgvc", ("on", True)),
    ], lambda arg: dict(run_cli(dataset, ckpts, *arg, dev), mode=arg[0]))
    base = cli_runs[1]
    front_kernel = {"on": ["fused_front"], "g1": ["fused_front_g1"]}
    report_runs("a_cli", cli_runs, base, lambda r: front_kernel.get(r["mode"], []))

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

    launches = {k: cli_launches[k] + k5_launches[k] + api_launches[k]
                for k in _build.KERNELS}
    for name in KERNELS:
        if launches[name] == 0:
            raise AssertionError(f"{name} was never launched by a main path")

    kernels = []
    for name, (kern, plain_fn, shape) in timing_cases(folded, gen, dev).items():
        order = (plain_fn, kern, kern, plain_fn)  # in turns
        t = [time_ms(fn) for fn in order]
        ms, plain_ms = (t[1] + t[2]) / 2, (t[0] + t[3]) / 2
        emit("timing", kernel=name, ms=ms, plain_ms=plain_ms, samples_ms=t[1:3],
             plain_samples_ms=[t[0], t[3]], nvidia_smi=smi, **shape)
        source, replaces = KERNELS[name]
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": launches[name],
                        "max_abs_err": errors[name], "ms": ms, "plain_ms": plain_ms})

    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
