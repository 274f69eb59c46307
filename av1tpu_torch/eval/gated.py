"""Fixed-capacity gated inference: stages 2 and 3 on a static share of the batch.

Counterpart of ``av1tpu.eval.gated``. The dense pipeline
(:mod:`av1tpu_torch.eval.hierarchy`) runs stages 2 and 3 on every sample,
though the stage-1 gate discards most of them. Here:

  * stage 1 runs dense;
  * a static capacity ``K = ceil(capacity * N)`` of samples is selected by
    stage-1 probability (a stable descending sort, so that ties keep their
    index order as ``jnp.argsort`` keeps it);
  * stages 2 and 3 run only on the K rows; the results scatter back.

Whenever the gate passes at most K samples, the output equals the dense
pipeline's (the K rows hold every passing sample). With more passers than
K, the lowest-probability overflow samples fall back to PARTITION_SPLIT and
``overflow`` says how many. ``capacity=1.0`` is dense.
"""
from __future__ import annotations

from typing import Callable, Dict

import torch
import torch.distributed as dist

from av1tpu_torch.data.records import NORM_10BIT
from av1tpu_torch.eval.folded import _folded_stage_fn
from av1tpu_torch.eval.hierarchy import PipelineModels, on_device, v6_route
from av1tpu_torch.parallel.mesh import DATA_AXIS, axis_group, gather_group, local_rows
from av1tpu_torch.quant.ptq import is_plain_stage


def auto_capacity(sweep_rows, threshold: float, margin: float = 0.1) -> float:
    """The gated-serving capacity from a calibration sweep.

    Picks the sweep row nearest the serving threshold and returns its
    measured gate pass rate scaled by ``1 + margin`` (clipped to 1.0).
    While the deployment's pass rate stays within the margin, gated output
    equals dense output. Rows are ``compute_binary_metrics`` dicts, as
    ``optimize_thresholds`` writes them to threshold_sweep.csv. A sweep
    whose grid does not reach the serving threshold (within one grid step)
    is refused rather than extrapolated.
    """
    if not sweep_rows:
        raise ValueError("empty calibration sweep")
    row = min(sweep_rows, key=lambda r: abs(float(r["threshold"]) - threshold))
    grid = sorted(float(r["threshold"]) for r in sweep_rows)
    step = max((b - a for a, b in zip(grid, grid[1:])), default=0.0)
    dist = abs(float(row["threshold"]) - threshold)
    if dist > max(step, 1e-9):
        raise ValueError(
            f"calibration sweep does not cover threshold {threshold:g}: "
            f"nearest row is at {float(row['threshold']):g} "
            f"(distance {dist:g} > grid step {step:g}); re-run "
            "optimize_thresholds with a grid spanning the serving point"
        )
    if "gate_rate" in row:
        rate = float(row["gate_rate"])
    else:  # a sweep written before gate_rate was recorded: from the counts
        passed = float(row["tp"]) + float(row["fp"])
        total = passed + float(row["fn"]) + float(row["tn"])
        rate = passed / max(total, 1.0)
    return float(min(1.0, rate * (1.0 + margin)))


def make_v6_pipeline_gated(
    models: PipelineModels,
    capacity: float = 0.5,
    stage1_threshold: float = 0.45,
    norm_scale: float = NORM_10BIT,
    input_dtype=torch.float32,
    folded: bool = False,
    device="cuda",
    mesh=None,
) -> Callable:
    """The capacity-gated v6 pipeline on ``device`` (the card unless the
    caller passes ``"cpu"``; ``"cuda"`` without a card raises).

    Returns ``predict(images_u16, valid=None) -> dict`` with the keys of the
    dense pipeline but the stage-3 predictions, ``stage2_pred`` -1 where
    stage 2 did not run, and ``overflow`` (a 0-d tensor: gate-passing samples
    beyond capacity that fell back to SPLIT). ``valid`` is the number of real
    rows at the top of the batch; the rest are padding and never take one of
    the K places. ``predict.accepts_valid`` tells ``run_pipeline_batched`` to
    pad the last batch and pass it. ``folded`` runs each stage's BN-folded
    forward (``eval.folded``) without the fused kernels, as the JAX package
    does; an FGVC AB stage runs through its own forward.

    With ``mesh`` (``parallel.mesh``) ``images`` are this rank's rows of the
    batch and ``valid`` the batch's count of real rows: the stage-1
    probabilities are gathered over the data group, so that K and the top-K
    are taken over the global batch, stages 2 and 3 run on each rank's share
    of the K rows, and the per-sample outputs come back as this rank's rows
    (``overflow`` is global). A rank-local top-K would give other labels."""
    if not 0.0 < capacity <= 1.0:
        raise ValueError("capacity must be in (0, 1]")
    device = torch.device(device)
    group = axis_group(mesh, DATA_AXIS)
    if folded:
        f1, stage2_fn, rect_fn = (
            _folded_stage_fn(m, input_dtype, False, False, device)
            for m in (models.stage1, models.stage2, models.stage3_rect)
        )
        if is_plain_stage(models.stage3_ab):
            ab_fn = _folded_stage_fn(models.stage3_ab, input_dtype, False, False, device)
        else:
            ab_fn = on_device(models.stage3_ab, device, input_dtype)

        def stage1_fn(x):
            return f1(x).squeeze(-1)
    else:
        stage1_fn, stage2_fn, rect_fn, ab_fn = (
            on_device(m, device, input_dtype) for m in (
                models.stage1, models.stage2, models.stage3_rect, models.stage3_ab))

    def normalized(images):
        return (images.to(torch.float32) / norm_scale).to(input_dtype)

    def selected_heads(x_sel):
        s2 = torch.argmax(stage2_fn(x_sel), dim=-1).to(torch.int32)
        rect = torch.argmax(rect_fn(x_sel), dim=-1).to(torch.int32)
        ab = torch.argmax(ab_fn(x_sel), dim=-1).to(torch.int32)
        return s2, v6_route(torch.ones_like(s2), s2, rect, ab)

    def sharded_heads(images, topk_idx):
        """Stages 2 and 3 on the K selected rows of the global batch, each
        data rank on its contiguous share of them (the index padded with its
        first entry to a multiple of the ranks), the results gathered."""
        ranks, rank = dist.get_world_size(group), dist.get_rank(group)
        k = topk_idx.shape[0]
        per = -(-k // ranks)
        idx = torch.cat([topk_idx, topk_idx[:1].expand(per * ranks - k)])
        x_all = normalized(gather_group(images, group))
        s2, final = selected_heads(x_all.index_select(0, idx[rank * per:(rank + 1) * per]))
        return gather_group(s2, group)[:k], gather_group(final, group)[:k]

    @torch.inference_mode()
    def predict(images: torch.Tensor, valid=None) -> Dict[str, torch.Tensor]:
        x = normalized(images)
        # Under a mesh the gate runs on this rank's rows and the K places
        # are taken over the global batch, as one process takes them.
        s1_prob = gather_group(torch.sigmoid(stage1_fn(x).float()), group)
        n = s1_prob.shape[0]
        if valid is None:
            valid = n
        k = max(1, int(-(-capacity * n // 1)))  # ceil, as the JAX package computes it
        # Padding rows (run_pipeline_batched repeats the tail's first row)
        # must never take one of the K places from a real gate-passing row.
        row_ok = torch.arange(n, device=x.device) < valid
        s1_pred = ((s1_prob >= stage1_threshold) & row_ok).to(torch.int32)
        order = torch.argsort(torch.where(row_ok, s1_prob, -1.0),
                              descending=True, stable=True)
        topk_idx = order[:k]
        if group is None:
            s2_pred_k, final_k = selected_heads(x.index_select(0, topk_idx))
        else:
            s2_pred_k, final_k = sharded_heads(images, topk_idx)

        # scatter back; unselected gate-passers fall back to SPLIT (1)
        final = torch.ones((n,), dtype=torch.int32, device=x.device)
        final[topk_idx] = final_k
        final = torch.where(s1_pred == 0, 0, final)
        s2_full = torch.full((n,), -1, dtype=torch.int32, device=x.device)
        s2_full[topk_idx] = s2_pred_k
        overflow = ((s1_pred == 1) & (s2_full < 0)).sum().to(torch.int32)
        return {
            "final": local_rows(final, group),
            "stage1_prob": local_rows(s1_prob, group),
            "stage1_pred": local_rows(s1_pred, group),
            "stage2_pred": local_rows(s2_full, group),
            "overflow": overflow,
        }

    predict.accepts_valid = True
    return predict


__all__ = ["auto_capacity", "make_v6_pipeline_gated"]
