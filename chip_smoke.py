#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``av1tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout. Phases, one JSON line each:
  1. device: ``nvidia-smi`` name and power limit, the torch device name;
  2. build: nvcc builds the kernels from ``av1tpu_torch/csrc``;
  3. kernel checks: K1 (fused front) and K2 (fused front + layer group 1 +
     SE1) against their plain PyTorch versions on the card, at 8 and 16 px,
     batch 4099, fp32 (TF32 off) and bf16;
  4. reference: the folded pipeline in fp32 on the card, with each front,
     against the plain nn.Module pipeline on the CPU;
  5. end to end: a synthetic 65,536-block 16 px dataset and four seeded
     stage models (plus an FGVC AB model) saved as npz, then the port's
     ``run_pipeline_eval --variant v6 --folded --bf16 --batch-size 4096``
     with ``--fused-front off``, ``on`` and ``g1`` (and ``--ab-fgvc``):
     blocks/s, kernel launches, label agreement with the ``off`` run;
  6. timing: K1, K2 and their plain versions at batch 4096, 16 px, bf16.
Then the card's ``nvidia-smi`` line, a ``{"kernels": [...]}`` line, and as the
last line ``{"ok": true, "device": {...}}``. Any failed phase raises and the
script exits non-zero; without a CUDA device it fails before printing.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
from torch import nn

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

from av1tpu_torch.cli import run_pipeline_eval  # noqa: E402
from av1tpu_torch.cli.common import Bundle, save_split  # noqa: E402
from av1tpu_torch.eval import (  # noqa: E402
    PipelineModels,
    make_v6_pipeline,
    make_v6_pipeline_folded,
)
from av1tpu_torch.kernels import _build  # noqa: E402
from av1tpu_torch.kernels import fused_front as ff  # noqa: E402
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
FP32_TOL = {"fused_front": 1e-5, "fused_front_g1": 5e-5}
BF16_REL_TOL = 1e-2  # of max(1, max|plain|): ~1 bf16 ulp of the largest output
WORK = ROOT / "build" / "chip_smoke"
SOURCE = "av1tpu_torch/csrc/fused_front.cu"
REPLACES = {
    "fused_front": "av1tpu/kernels/fused_front.py:105",
    "fused_front_g1": "av1tpu/kernels/fused_front.py:212",
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


def kernel_args(name, folded, dtype, dev):
    if name == "fused_front":
        w, b = ff.stem_weights(folded["stem"]["weight"], folded["stem"]["bias"], dtype)
        return ff.fused_front, ff.fused_front_reference, (w.to(dev), b.to(dev))
    args = tuple(a.to(dev) for a in ff.g1_weights(folded, dtype))
    return ff.fused_front_g1, ff.fused_front_g1_reference, args


def check_kernels(folded, gen, dev) -> dict:
    """Each kernel against its plain version on the card; returns the
    max error per kernel at 16 px in bf16 (the main path's shape)."""
    errors = {}
    for hw in (8, 16):
        x_u16 = torch.randint(0, 1024, (RAGGED, hw, hw, 1), generator=gen)
        for dtype in (torch.float32, torch.bfloat16):
            x = (x_u16.float() / 1023.0).to(dev, dtype)
            for name in ("fused_front", "fused_front_g1"):
                kern, plain, args = kernel_args(name, folded, dtype, dev)
                got = kern(x, *args)
                torch.cuda.synchronize()
                want = plain(x, *args)
                if got.shape != want.shape or got.dtype != want.dtype:
                    raise AssertionError(f"{name}: {got.shape}/{got.dtype} "
                                         f"vs {want.shape}/{want.dtype}")
                err = (got.float() - want.float()).abs().max().item()
                scale = want.float().abs().max().item()
                tol = (FP32_TOL[name] if dtype == torch.float32
                       else BF16_REL_TOL * max(1.0, scale))
                emit("kernel_check", kernel=name, hw=hw, batch=RAGGED,
                     dtype=str(dtype), max_abs_err=err, tol=tol, max_abs_out=scale)
                if not (err <= tol and math.isfinite(scale)):
                    raise AssertionError(f"{name} hw={hw} {dtype}: err {err} > {tol}")
                if hw == HW and dtype == torch.bfloat16:
                    errors[name] = err
    return errors


def check_reference(models: PipelineModels, samples: np.ndarray, dev) -> None:
    """Folded fp32 pipeline on the card with each front vs the plain
    nn.Module pipeline on the CPU: stage-1 probabilities within 1e-4 and
    every label equal where the decision margin exceeds 1e-3."""
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
    for mode in (False, True, "g1"):
        got = make_v6_pipeline_folded(models, THRESHOLD, float_dtype=torch.float32,
                                      use_fused_front=mode, device=dev)(images.to(dev))
        got = {k: v.cpu() for k, v in got.items()}
        prob_err = (got["stage1_prob"] - want["stage1_prob"]).abs().max().item()
        mismatches = {}
        for key, margin in margins.items():
            sure = margin > 1e-3
            mismatches[key] = int((got[key] != want[key])[sure].sum())
        emit("reference", fused_front=mode, samples=len(samples),
             stage1_prob_max_abs_err=prob_err,
             guarded_share=float((margins["final"] > 1e-3).float().mean()),
             mismatches_above_margin=mismatches)
        if prob_err > 1e-4 or any(mismatches.values()):
            raise AssertionError(f"folded fp32 ({mode}) disagrees with the reference")


def make_dataset(gen: torch.Generator) -> Path:
    rng = np.random.default_rng(SEED)

    def bundle(n):
        stage0 = rng.integers(0, 8, size=n).astype(np.int32)
        return Bundle(
            samples=rng.integers(0, 1024, size=(n, HW, HW, 1), dtype=np.uint16),
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
    return {"metrics": metrics, "final": preds["predictions"],
            "stage1_prob": preds["stage1_prob"]}


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
    if "jax" in sys.modules:
        raise AssertionError("the port must not import jax")

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

    dataset = make_dataset(gen)
    val = Bundle.load(dataset / f"block_{HW}" / "val.npz")
    plain = PipelineModels(models["stage1"], models["stage2"], models["rect"],
                           models["ab"])
    check_reference(plain, val.samples[:2048], dev)

    ckpts = {}
    for name, model in models.items():
        ckpts[name] = save_variables_npz(WORK / "ckpt" / f"{name}_variables.npz",
                                         to_jax_variables(model.state_dict()))

    # the main path: counts start at 0 here and are read after the last run.
    # A warm-up run pays cuDNN's and the allocator's first calls; then each
    # mode runs twice in the order off, on, g1, g1, on, off.
    ff.reset_launch_counts()
    plan = [("off_warmup", "off", False)] + [
        (f"{mode}_{i}", mode, False)
        for i, mode in enumerate(("off", "on", "g1", "g1", "on", "off"))
    ] + [("on_fgvc", "on", True)]
    runs, before = [], dict(ff.launch_counts)
    for name, mode, fgvc in plan:
        run = run_cli(dataset, ckpts, mode, fgvc, dev)
        run["name"], run["mode"] = name, mode
        run["launches"] = {k: ff.launch_counts[k] - before[k] for k in before}
        before = dict(ff.launch_counts)
        runs.append(run)
    launches = dict(ff.launch_counts)
    base = runs[1]
    for run in runs:
        m = run["metrics"]
        finite = bool(np.isfinite(run["stage1_prob"]).all())
        emit("end_to_end", run=run["name"], samples=m["samples"],
             blocks_per_s=m["throughput_superblocks_per_sec"],
             accuracy=m["metrics"]["accuracy"], launches=run["launches"],
             final_agrees_with_off=float((run["final"] == base["final"]).mean()),
             stage1_prob_max_abs_diff_vs_off=float(
                 np.abs(run["stage1_prob"] - base["stage1_prob"]).max()),
             finite=finite)
        if m["samples"] != N_VAL or len(run["final"]) != N_VAL or not finite:
            raise AssertionError(f"{run['name']}: bad outputs")
        if not np.isin(run["final"], np.arange(8)).all():
            raise AssertionError(f"{run['name']}: labels outside 0..7")
        expect = {"on": "fused_front", "g1": "fused_front_g1"}.get(run["mode"])
        if expect and run["launches"][expect] == 0:
            raise AssertionError(f"{run['name']}: {expect} never launched")

    kernels = []
    x = (torch.randint(0, 1024, (BATCH, HW, HW, 1), generator=gen).float()
         / 1023.0).to(dev, torch.bfloat16)
    for name in ("fused_front", "fused_front_g1"):
        kern, plain_fn, args = kernel_args(name, folded, torch.bfloat16, dev)
        # in turns: plain, kernel, kernel, plain
        order = (plain_fn, kern, kern, plain_fn)
        t = [time_ms(lambda fn=fn: fn(x, *args)) for fn in order]
        ms, plain_ms = (t[1] + t[2]) / 2, (t[0] + t[3]) / 2
        emit("timing", kernel=name, batch=BATCH, hw=HW, dtype="bfloat16",
             ms=ms, plain_ms=plain_ms, samples_ms=t[1:3],
             plain_samples_ms=[t[0], t[3]], nvidia_smi=smi)
        kernels.append({"name": name, "route": "cuda", "source": SOURCE,
                        "replaces": REPLACES[name], "launches": launches[name],
                        "max_abs_err": errors[name], "ms": ms, "plain_ms": plain_ms})

    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
