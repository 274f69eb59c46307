"""Cascade error decomposition for the hierarchical pipeline (numpy only;
the port's own copy of ``av1tpu.eval.cascade``).

The reference's central research finding is cascade degradation: stage-3
specialists at 68%/24% standalone collapse to ~4%/1.5% inside the pipeline
(docs_v6/00_README.md:59), analyzed manually in
docs_v6/05_avaliacao_pipeline_completo.md. This module turns that analysis
into a tool: every wrong final prediction is attributed to the FIRST stage
that broke the chain, and every stage gets conditional ("given correct
routing") metrics — the numbers needed to see where accuracy dies.

Attribution categories:
  stage1_false_negative   gate said NONE for a partitioned block
  stage1_false_positive   gate passed a NONE block downstream
  stage2_misroute         gate correct, stage-2 macro class wrong
  stage3_refinement       routing fully correct, specialist picked the
                          wrong member within the group
  correct                 final prediction equals the label
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np

from av1tpu_torch.codec.partitions import map_to_stage2_v6, raw_to_v6_final


def decompose_v6(
    outputs: Mapping[str, np.ndarray],
    labels_stage0: np.ndarray,
) -> Dict[str, object]:
    """Attribute each sample's outcome for a v6 pipeline run.

    ``outputs`` is the dict from :func:`av1tpu_torch.eval.hierarchy.make_v6_pipeline`
    predictions (``final``, ``stage1_pred``, ``stage2_pred``, ...);
    ``labels_stage0`` the raw 10-class ground truth.
    """
    labels_stage0 = np.asarray(labels_stage0)
    final = np.asarray(outputs["final"])
    s1_pred = np.asarray(outputs["stage1_pred"])
    s2_pred = np.asarray(outputs["stage2_pred"])

    true_s1 = (labels_stage0 != 0).astype(np.int64)
    true_s2, s2_valid = map_to_stage2_v6(labels_stage0)

    # Correctly aligned v6 8-class final space (quirk Q7: the reference
    # compares raw ids against the reordered space and misaligns
    # SPLIT/HORZ/VERT). 1TO4 truths map to -1 and count as "other".
    true_final = raw_to_v6_final(labels_stage0)
    correct = (final == true_final) & (true_final >= 0)

    s1_fn = (true_s1 == 1) & (s1_pred == 0)
    s1_fp = (true_s1 == 0) & (s1_pred == 1)
    s1_ok = ~s1_fn & ~s1_fp

    s2_wrong = s1_ok & (true_s1 == 1) & s2_valid & (s2_pred != true_s2)
    routing_ok = s1_ok & ((true_s1 == 0) | (s2_valid & (s2_pred == true_s2)))
    s3_wrong = routing_ok & ~correct

    n = len(labels_stage0)
    counts = {
        "correct": int(correct.sum()),
        "stage1_false_negative": int((s1_fn & ~correct).sum()),
        "stage1_false_positive": int((s1_fp & ~correct).sum()),
        "stage2_misroute": int((s2_wrong & ~correct).sum()),
        "stage3_refinement": int(s3_wrong.sum()),
    }
    attributed = sum(counts.values())
    counts["other"] = n - attributed  # e.g. 1TO4 truths outside the v6 space

    # Conditional stage metrics: performance given correct upstream routing
    gated = s1_pred == 1
    s2_support = gated & s2_valid
    s2_cond_acc = (
        float((s2_pred[s2_support] == true_s2[s2_support]).mean())
        if s2_support.any()
        else 0.0
    )
    rect_mask = routing_ok & (true_s2 == 1) & s2_valid
    ab_mask = routing_ok & (true_s2 == 2) & s2_valid
    rect_cond_acc = (
        float(correct[rect_mask].mean()) if rect_mask.any() else 0.0
    )
    ab_cond_acc = float(correct[ab_mask].mean()) if ab_mask.any() else 0.0

    return {
        "total": n,
        "accuracy": float(correct.mean()),
        "error_attribution": counts,
        "error_attribution_fractions": {
            k: v / n for k, v in counts.items()
        },
        "conditional": {
            "stage2_acc_given_gate_pass": s2_cond_acc,
            "stage3_rect_acc_given_routing": rect_cond_acc,
            "stage3_ab_acc_given_routing": ab_cond_acc,
        },
    }


__all__ = ["decompose_v6"]
