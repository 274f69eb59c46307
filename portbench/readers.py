"""What the per-layer metric files read, from the run's summary.

The summary a run hands each reader (``metrics/<name>.py``'s ``read``):

* ``config``, ``traffic`` and ``peaks`` (``counts/peaks.json``);
* ``family``: the configuration's model family (``spec.Family``), whose
  reference counts the trunks a row runs through the fused kernels
  (``trunks``) and a block's operations (``per_block``);
* ``on_card``: whether the run was on the card (no device metric otherwise);
* ``host``: the untraced dispatches of a traced run: ``cascade_call_s``
  (the host's seconds inside each call into the cascade), ``seconds`` (their
  window) and ``level_rows`` (``{block px: rows}`` they served);
* ``trace``: the profiled dispatches, :func:`portbench.trace.summarize` with
  ``frames``, ``batches`` and ``level_rows`` beside it; None off the card.

A reader that finds nothing to read returns None, and the run leaves its
metric out.
"""
from __future__ import annotations

import statistics
from typing import Optional

from portbench import spec


def roofline(summary: dict, kernel: str) -> Optional[float]:
    """The kernel's share of its roofline, in %: over its calls in the trace,
    the least time the card could take (the larger of valid-tap operations
    over the bf16 peak and bytes over the memory rate, by block size) over
    the kernel's device time."""
    trace = summary.get("trace")
    if not trace:
        return None
    count = spec.load_count(kernel)
    by_px = {}
    for name, start, end in trace["kernels"]:
        match = count.KERNEL.search(name)
        if match:
            calls, ns = by_px.get(count.block_px(match), (0, 0))
            by_px[count.block_px(match)] = (calls + 1, ns + end - start)
    if not by_px:
        return None
    config, peaks = summary["config"], summary["peaks"]
    trunks = summary["family"].reference.trunks(config)
    bound = seconds = 0.0
    for px, (calls, ns) in by_px.items():
        rows = trace["level_rows"].get(px, 0) * trunks
        by_ops = rows * count.ops(config, px) / peaks["bf16_flops_per_s"]
        by_bytes = (rows * count.io_bytes(config, px)
                    + calls * count.weight_bytes(config, px)) / peaks["hbm_bytes_per_s"]
        bound += max(by_ops, by_bytes)
        seconds += ns / 1e9
    return 100.0 * bound / seconds if seconds > 0 else None


def mfu(summary: dict) -> Optional[float]:
    """The whole step's valid-tap operations per second over the bf16 peak,
    in %, from the untraced dispatches' host clock."""
    host = summary.get("host")
    if not summary.get("on_card") or not host or not host.get("seconds"):
        return None
    config, per_block = summary["config"], summary["family"].reference.per_block
    ops = sum(rows * per_block(config, px) for px, rows in host["level_rows"].items())
    return 100.0 * ops / host["seconds"] / summary["peaks"]["bf16_flops_per_s"]


def cascade_host_ms(summary: dict) -> Optional[float]:
    """The median host ms a call into the cascade takes to enqueue its work."""
    host = summary.get("host")
    if not host or not host.get("cascade_call_s"):
        return None
    return 1e3 * statistics.median(host["cascade_call_s"])


def launches(summary: dict, per: str) -> Optional[float]:
    """Device kernels in the trace per ``frames`` or ``batches``."""
    trace = summary.get("trace")
    if not trace or not trace["kernels"] or not trace.get(per):
        return None
    return len(trace["kernels"]) / trace[per]


def idle_share(summary: dict) -> Optional[float]:
    """The traced window's share, in %, in which no operation ran on the device."""
    trace = summary.get("trace")
    if not trace or trace["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - trace["busy_s"] / trace["window_s"])


__all__ = ["cascade_host_ms", "idle_share", "launches", "mfu", "roofline"]
