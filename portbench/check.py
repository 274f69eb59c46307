"""The output check: what the timed path produced, against the plain
reference, once the window has closed.

Numbers compared (each beside its limit from ``checks/<cell>.json``):

* ``sure_flip_share_<px>`` (cascades, one per level) and ``sure_flip_share``
  (blocks): the share of the program's decisions at that block size that go
  against a reference that is sure of its own. For each decision a node's answer
  implies (the gate for every node; stage 2 where the gate opened; the RECT or
  AB head where stage 2 chose it; for blocks, every returned head), its
  regret is how far the reference's logit of the program's choice lies below
  the reference's best (for the gate, the reference's distance from the
  threshold where the sides differ), in units of the median margin of that
  head at that block size over the sample. Rounding flips decisions that the
  reference takes by a hair; this counts regrets above :data:`SURE`. A level
  is judged on its own, since the 64 px level holds about one decision in a
  hundred of a frame's and a fault there would vanish in a frame's total. In a
  frame, a block that recurs with the same answer counts once: the zero rows
  that pad a frame to whole superblocks hold hundreds of equal blocks, whose
  one decision would otherwise move a level's share by up to a percent.
* ``trees_wrong``: tree slots that differ from the reference's assembly of
  the program's own modes (exact, 0). A frame whose outputs break the shapes,
  the raw ids or the superblock grid counts as ``failed`` instead.
* ``route_wrong`` (blocks): labels that differ from the routing of the
  program's own stage outputs, and gate labels that differ from its own
  probability against the threshold (exact, 0).

Printed beside them, and compared only where the limits file gives them a
limit: ``gap`` (the widest regret), ``flip_share_over_<t>`` (the share of
regrets above other multiples; for cascades over all levels, and per level as
``flip_share_over_<t>_<px>``), ``mismatch_share`` (answers that differ from
the reference's) and, for blocks, ``prob_err`` (the widest gap between the
program's stage-1 probability and the reference's).
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

from portbench.reference import cascade as ref
from portbench.reference.v6 import threshold_logit

VALID_RAW = set(ref.FINAL_TO_RAW.tolist())
SURE = 0.25  # a regret above this many median margins is no rounding flip
OVER = (0.25, 0.5, 1.0)  # the shares printed beside it


def _scales(logits: Dict[str, torch.Tensor], threshold: float) -> Dict[str, float]:
    return {h: max(float(np.median(m)), 1e-12) for h, m in ref.margins(logits, threshold).items()}


def _tally(reg: Dict[str, np.ndarray], scale: Dict[str, float]) -> np.ndarray:
    """``[widest regret, decisions judged, decisions over each of OVER]`` in
    units of each head's median margin."""
    out = np.zeros(2 + len(OVER))
    for h in ref.DECISIONS:
        r = reg[h][~np.isnan(reg[h])] / scale[h]
        if r.size:
            out[1:] += (r.size, *((r > t).sum() for t in OVER))
            out[0] = max(out[0], float(r.max()))
    return out


def _add(tally: np.ndarray, t: np.ndarray) -> np.ndarray:
    return np.concatenate([[max(tally[0], t[0])], tally[1:] + t[1:]])


def _numbers(tally: np.ndarray, differing: int, total: int) -> Dict[str, float]:
    judged = tally[1] if tally[1] else float("nan")
    out = {f"flip_share_over_{t:g}": tally[2 + i] / judged for i, t in enumerate(OVER)}
    out.update(sure_flip_share=out[f"flip_share_over_{SURE:g}"], gap=float(tally[0]),
               mismatch_share=differing / total if total else float("nan"))
    return out


def first_of_each(blocks: np.ndarray, answers: np.ndarray) -> np.ndarray:
    """Mask of the first row of each distinct pair of input block and answer."""
    rows = np.ascontiguousarray(np.concatenate(
        [blocks.reshape(len(blocks), -1).astype(np.int32), answers.reshape(-1, 1)
         .astype(np.int32)], axis=1))
    keys = rows.view(np.dtype((np.void, rows.dtype.itemsize * rows.shape[1]))).ravel()
    mask = np.zeros(len(rows), dtype=bool)
    mask[np.unique(keys, return_index=True)[1]] = True
    return mask


def malformed_frame(out: dict, superblocks: int, grid=None) -> bool:
    """Whether a frame's outputs break the contract: shapes, raw ids, grid."""
    trees = np.asarray(out["trees"])
    if trees.shape != (superblocks, 85):
        return True
    for size, nodes in zip(ref.LEVELS, ref.NODES):
        modes = np.asarray(out[f"modes_{size}"])
        if modes.shape != (superblocks, nodes) or not set(np.unique(modes).tolist()) <= VALID_RAW:
            return True
    if grid is not None and list(np.asarray(out["grid_shape"]).tolist()) != list(grid):
        return True
    return not set(np.unique(trees).tolist()) <= VALID_RAW | {-1}


def cascade(family, arch: dict, level_models: dict, pool: np.ndarray,
            occurrences: Sequence[tuple], sample: Sequence[int], threshold: float,
            norm_scale: float, device, rows: Dict[int, int]) -> Dict[str, float]:
    """``occurrences``: ``(pool index, outputs of that frame)`` for every frame
    of the window. The reference (``family``'s, a ``spec.Family``) runs once
    over the ``sample`` of pool frames and every occurrence of a sampled frame
    is judged against it."""
    want = ref.frame_reference(family, arch, level_models, [pool[i] for i in sample], threshold,
                               norm_scale, device, rows)
    n_sb = want["trees"].shape[1]
    scales = {size: _scales(want["logits"][size], threshold) for size in ref.LEVELS}
    slot = {i: k for k, i in enumerate(sample)}
    tally = {size: np.zeros(2 + len(OVER)) for size in ref.LEVELS}
    differing, total, trees_wrong = 0, 0, 0
    judged = set()
    for index, out in occurrences:
        modes = [np.asarray(out[f"modes_{s}"]) for s in ref.LEVELS]
        trees_wrong += int((np.asarray(out["trees"]) != ref.assemble(modes)).sum())
        key = (index, hash(b"".join(m.tobytes() for m in modes)))
        if index not in slot or key in judged:
            continue  # the program answered this frame so before
        judged.add(key)
        k = slot[index]
        sbs = ref.tile_superblocks(np.asarray(pool[index]))
        for li, (size, nodes) in enumerate(zip(ref.LEVELS, ref.NODES)):
            rows_k = slice(k * n_sb * nodes, (k + 1) * n_sb * nodes)
            got = modes[li].reshape(-1)
            differing += int((got != want["modes"][li][k].reshape(-1)).sum())
            total += got.size
            logits = {h: t[rows_k] for h, t in want["logits"][size].items()}
            choices = ref.choices_from_final(ref.RAW_TO_FINAL[got])
            reg = ref.regrets(logits, threshold, choices)
            repeat = ~first_of_each(ref.quad_tile(sbs, size), got)
            for h in reg:
                reg[h][repeat] = np.nan
            tally[size] = _add(tally[size], _tally(reg, scales[size]))
    whole = np.zeros(2 + len(OVER))
    for t in tally.values():
        whole = _add(whole, t)
    numbers = _numbers(whole, differing, total)
    for size, t in tally.items():
        numbers.update({f"{k}_{size}": v for k, v in _numbers(t, 0, 0).items()
                        if k != "mismatch_share"})
    return {**numbers, "trees_wrong": trees_wrong}


def blocks(family, arch: dict, models: dict, dataset: np.ndarray, passes: List[dict],
           sample: np.ndarray, threshold: float, norm_scale: float, device,
           rows: int) -> Dict[str, float]:
    """Every pass's outputs at the ``sample`` of block indices, against the
    reference's (``family``'s, a ``spec.Family``) logits of those blocks."""
    logits = ref.block_logits(family, arch, models, dataset[sample], norm_scale, device, rows)
    scale = _scales(logits, threshold)
    want_final = ref.route(logits, threshold).numpy()
    want_prob = torch.sigmoid(logits["stage1"].double()).numpy()
    tally, prob_err, route_wrong, differing, total = np.zeros(2 + len(OVER)), 0.0, 0, 0, 0
    names = {"stage1": "stage1_pred", "stage2": "stage2_pred", "rect": "stage3_rect_pred",
             "ab": "stage3_ab_pred"}
    for out in passes:
        got = {h: np.asarray(out[k])[sample].astype(np.int64) for h, k in names.items()}
        final = np.asarray(out["final"])[sample].astype(np.int64)
        prob = np.asarray(out["stage1_prob"])[sample].astype(np.float64)
        routed = ref.route({"stage1": torch.from_numpy(np.where(got["stage1"] == 1, 1.0, -1.0)
                                                       + threshold_logit(threshold)),
                            **{h: torch.nn.functional.one_hot(torch.from_numpy(got[h]), n)
                               for h, n in (("stage2", 3), ("rect", 2), ("ab", 4))}},
                           threshold).numpy()
        route_wrong += int((routed != final).sum())
        route_wrong += int(((prob >= threshold).astype(np.int64) != got["stage1"]).sum())
        prob_err = max(prob_err, float(np.abs(prob - want_prob).max()))
        tally = _add(tally, _tally(ref.regrets(logits, threshold, got), scale))
        differing += int((final != want_final).sum())
        total += final.size
    return {**_numbers(tally, differing, total), "prob_err": prob_err,
            "route_wrong": route_wrong}


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Every number that has a limit is within it (a NaN never is)."""
    return all(numbers.get(k, float("nan")) <= v for k, v in limits.items())


__all__ = ["blocks", "cascade", "first_of_each", "judge", "malformed_frame"]
