"""One run of one cell:

    python3 -m portbench --workload <config>.<mix> --seed <n> --seconds <s> --trace <0|1>

Set-up (counted in ``setup_s``, from the process's start): the port's
kernel library (built by nvcc in a checkout's first run; that build's seconds
are also printed apart as ``build_s``), inputs and weights from the seed on
the device, the port's level predictors, and a warm-up of the cell's own
shapes. Then the window of ``--seconds`` (with
``--trace 0``) or the traced phases (with ``--trace 1``), the device's memory
peak, the program's state freed, the output check against the plain
reference, and a look for JAX in the process. The last line of standard
output is one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics``, ``device``, with ``--trace 1`` ``breakdown``, and last
``checks``, each number compared beside its limit (also the last lines of
standard error).
"""
from __future__ import annotations

import argparse
import gc
import json
import os
import statistics
import sys
import time
from typing import Dict, Optional

import numpy as np
import torch

from portbench import check, spec
from portbench.loops import LOOPS
from portbench.weights import make_level_models

FORBIDDEN = ("jax", "jaxlib", "flax", "av1tpu")
REFERENCE_ROWS = {64: 1024, 32: 4096, 16: 16384, 8: 32768}
THREADS = 1  # few threads: runs spread less than at torch's default (PERF.md §2)


def process_start() -> float:
    """The process's start on the ``time.perf_counter`` clock (to the
    kernel's clock tick), or now where ``/proc`` cannot say."""
    try:
        with open("/proc/self/stat", encoding="ascii") as f:
            started = int(f.read().rsplit(")", 1)[1].split()[19]) / os.sysconf("SC_CLK_TCK")
        with open("/proc/uptime", encoding="ascii") as f:
            uptime = float(f.read().split()[0])
        return time.perf_counter() - max(uptime - started, 0.0)
    except (OSError, ValueError, IndexError):
        return time.perf_counter()


def forbidden_modules() -> list:
    """Top-level names in ``sys.modules`` that the run may not load, compared whole."""
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def _p95(values) -> float:
    if len(values) < 2:
        return float(values[0])
    return statistics.quantiles(values, n=100, method="inclusive")[94]


def end_to_end(records: list, t_start: float) -> Dict[str, float]:
    """Every end-to-end number a window gives; the cell reports its own."""
    window = records[-1]["t_end"] - records[0]["t_open"]
    out = {"setup_s": records[0]["t_open"] - t_start}
    if "frames" in records[0]:
        out["frames_per_s"] = sum(r["frames"] for r in records) / window
        out["frame_ms_p95"] = 1e3 * _p95([r["t_end"] - r["t0"] for r in records])
    else:
        out["blocks_per_s"] = sum(r["blocks"] for r in records) / window
    return out


def _free(device: torch.device) -> None:
    gc.unfreeze()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def run_cell(cell: str, seed: int, seconds: float, traced: bool, device: torch.device,
             bench: Optional[dict] = None, config: Optional[dict] = None,
             traffic: Optional[dict] = None, limits: Optional[dict] = None,
             system=None, family: Optional[spec.Family] = None,
             t_start: Optional[float] = None) -> dict:
    """The result object of one run (not printed). The keyword arguments
    replace what the cell's files give, for tests and for the control."""
    t_start = time.perf_counter() if t_start is None else t_start
    bench = spec.load_benchmark() if bench is None else bench
    entry = spec.workload(bench, cell)
    config = spec.load_config(entry["config"]) if config is None else config
    traffic = spec.load_traffic(entry["traffic"]) if traffic is None else traffic
    limits = spec.load_limits(cell) if limits is None else limits
    if system is None:
        from portbench import system
    family = spec.load_family(config["family"]) if family is None else family
    e2e, per_layer = spec.cell_metrics(bench, cell)

    build_s = 0.0
    if device.type == "cuda":  # nvcc's build, in a checkout's first run, apart
        t_build = time.perf_counter()
        system.load_kernels()
        build_s = time.perf_counter() - t_build
    gen = torch.Generator(device).manual_seed(seed % (1 << 63))
    mix = LOOPS[traffic["kind"]](traffic, gen, device)
    level_models = make_level_models(family, config, mix.calib, gen, device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    predictors = system.build_predictors(family, config, level_models, device, mix.calib)
    launches0 = system.launch_counts()
    ran = mix.run(system, predictors, seconds, traced)
    launches = {k: v - launches0.get(k, 0) for k, v in system.launch_counts().items() if v}
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    del predictors
    _free(device)

    records = ran["records"]
    rng = np.random.default_rng([seed, 1])
    threshold, scale = config["stage1_threshold"], config["norm_scale"]
    if traffic["kind"] == "cascade":
        grid = mix.grid if traffic["loop"] == "frame" else None
        frames = list(mix.occurrences(records))
        bad = [check.malformed_frame(f, mix.superblocks, grid) for _, f in frames]
        good = [f for f, b in zip(frames, bad) if not b]
        seen = sorted({index for index, _ in good})
        sample = sorted(rng.choice(seen, size=min(traffic["check_frames"], len(seen)),
                                   replace=False).tolist()) if seen else []
        numbers = check.cascade(family, config["arch"], level_models, mix.pool, good, sample,
                                threshold, scale, device, REFERENCE_ROWS)
        attempted, failed = len(frames), sum(bad)
    else:
        n = traffic["dataset_blocks"]
        sample = np.sort(rng.choice(n, size=min(traffic["check_blocks"], n), replace=False))
        px = traffic["block_px"]
        numbers = check.blocks(family, config["arch"], level_models[px], mix.dataset,
                               [r["out"] for r in records], sample, threshold, scale, device,
                               REFERENCE_ROWS[px])
        attempted, failed = n * len(records), 0
    compared = {k: numbers[k] for k in limits}
    correct = failed == 0 and check.judge(numbers, limits)

    metrics = {}
    if traced:
        summary = {"config": config, "family": family, "traffic": traffic, "peaks": spec.peaks(),
                   "on_card": device.type == "cuda", "host": ran["host"], "trace": ran["trace"]}
        for m in per_layer:
            value = spec.load_reader(m["name"])(summary)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = end_to_end(records, t_start)
        for m in e2e:
            metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}

    result = {"correct": bool(correct), "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": {
                  "platform": "gpu" if device.type == "cuda" else "cpu",
                  "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
                  "count": 1, "memory_peak_bytes": int(peak)}}
    if traced and ran["trace"] is not None:
        result["device"]["busy_s"] = ran["trace"]["busy_s"]
        result["device"]["window_s"] = ran["trace"]["window_s"]
        result["breakdown"] = {"device_ops": ran["trace"]["device_ops"],
                               "idle_gaps": ran["trace"]["idle_gaps"]}
        result["trace_edges_s"] = ran["trace"]["edges_s"]
    result["build_s"] = build_s
    result["launch_counts"] = launches
    result["dispatch_ms"] = [round(1e3 * (r["t_end"] - r["t0"]), 2) for r in records]
    result["agreement"] = {k: v for k, v in numbers.items() if k not in limits}
    result["checks"] = {k: {"value": getattr(v, "item", lambda: v)(), "limit": limits[k]}
                        for k, v in compared.items()}  # numpy scalars as plain numbers
    return result


def parse(argv) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="python3 -m portbench", description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    t_start = process_start()
    args = parse(argv)
    bench = spec.load_benchmark()
    chips = spec.workload(bench, args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: {args.workload} needs {chips} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    torch.set_num_threads(THREADS)
    result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                      torch.device("cuda", 0), bench=bench, t_start=t_start)
    found = forbidden_modules()
    if found:
        print(f"portbench: the run loaded {', '.join(found)}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


__all__ = ["end_to_end", "forbidden_modules", "main", "process_start", "run_cell"]
