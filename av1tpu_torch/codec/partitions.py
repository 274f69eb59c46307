"""AV1 partition-mode domain: ID maps and hierarchical stage label mappings.

This is the semantic foundation of the framework: every downstream dataset,
loss, and evaluation graph derives its labels from the mappings here. The
semantics mirror the reference research code
(``pesquisa_v5/v5_pipeline/data_hub.py:23-59`` and
``pesquisa_v6/v6_pipeline/data_hub.py:25-53,207-273`` in
chiarorosa/cnn-av1-research) but are implemented as vectorized, jit-compatible
integer lookup tables instead of per-element ``np.vectorize`` string matching.

The port's own copy of ``av1tpu.codec.partitions`` (the port imports nothing
of the JAX package): the same tables and maps, numpy only. All mapping
functions accept numpy arrays or torch tensors and return the same kind (they
only use ``take``-style indexing on small constant tables).
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

# ---------------------------------------------------------------------------
# Canonical AV1 partition modes (libaom PARTITION_TYPE order).
# Reference parity: pesquisa_v5/v5_pipeline/data_hub.py:23-34.
# ---------------------------------------------------------------------------
PARTITION_NONE = 0
PARTITION_HORZ = 1
PARTITION_VERT = 2
PARTITION_SPLIT = 3
PARTITION_HORZ_A = 4
PARTITION_HORZ_B = 5
PARTITION_VERT_A = 6
PARTITION_VERT_B = 7
PARTITION_HORZ_4 = 8
PARTITION_VERT_4 = 9

NUM_PARTITION_MODES = 10

PARTITION_ID_TO_NAME: Dict[int, str] = {
    PARTITION_NONE: "PARTITION_NONE",
    PARTITION_HORZ: "PARTITION_HORZ",
    PARTITION_VERT: "PARTITION_VERT",
    PARTITION_SPLIT: "PARTITION_SPLIT",
    PARTITION_HORZ_A: "PARTITION_HORZ_A",
    PARTITION_HORZ_B: "PARTITION_HORZ_B",
    PARTITION_VERT_A: "PARTITION_VERT_A",
    PARTITION_VERT_B: "PARTITION_VERT_B",
    PARTITION_HORZ_4: "PARTITION_HORZ_4",
    PARTITION_VERT_4: "PARTITION_VERT_4",
}
PARTITION_NAME_TO_ID = {name: idx for idx, name in PARTITION_ID_TO_NAME.items()}

# libaom block-size index -> luma pixels, as emitted by the encoder partition
# dump (reference: pesquisa_v5/004_prepare_partition_data_v2.py:67-79).
BSIZE_INDEX_TO_PIXELS: Dict[int, int] = {3: 8, 6: 16, 9: 32, 12: 64}
BLOCK_SIZES: Tuple[str, ...] = ("8", "16", "32", "64")

# ---------------------------------------------------------------------------
# v5 hierarchy: stage2 is 5-way {NONE, SPLIT, RECT, AB, 1TO4}
# Reference parity: pesquisa_v5/v5_pipeline/data_hub.py:36-59,222-251.
# ---------------------------------------------------------------------------
STAGE2_GROUPS_V5: Dict[str, Tuple[str, ...]] = {
    "NONE": ("PARTITION_NONE",),
    "SPLIT": ("PARTITION_SPLIT",),
    "RECT": ("PARTITION_HORZ", "PARTITION_VERT"),
    "AB": (
        "PARTITION_HORZ_A",
        "PARTITION_HORZ_B",
        "PARTITION_VERT_A",
        "PARTITION_VERT_B",
    ),
    "1TO4": ("PARTITION_HORZ_4", "PARTITION_VERT_4"),
}
STAGE2_NAME_TO_ID_V5 = {name: i for i, name in enumerate(STAGE2_GROUPS_V5)}
STAGE2_NAMES_V5 = tuple(STAGE2_GROUPS_V5.keys())

STAGE3_GROUPS_V5: Dict[str, Tuple[str, ...]] = {
    "RECT": ("PARTITION_HORZ", "PARTITION_VERT"),
    "AB": (
        "PARTITION_HORZ_A",
        "PARTITION_HORZ_B",
        "PARTITION_VERT_A",
        "PARTITION_VERT_B",
    ),
    "1TO4": ("PARTITION_HORZ_4", "PARTITION_VERT_4"),
}

# ---------------------------------------------------------------------------
# v6 hierarchy: stage2 is 3-way {SPLIT, RECT, AB}; NONE gated by stage1,
# 1TO4 never occurs in real data (reference ARQUITETURA_V6.md:87-99).
# Reference parity: pesquisa_v6/v6_pipeline/data_hub.py:207-234.
# ---------------------------------------------------------------------------
STAGE2_GROUPS_V6: Dict[str, Tuple[str, ...]] = {
    "SPLIT": ("PARTITION_SPLIT",),
    "RECT": ("PARTITION_HORZ", "PARTITION_VERT"),
    "AB": (
        "PARTITION_HORZ_A",
        "PARTITION_HORZ_B",
        "PARTITION_VERT_A",
        "PARTITION_VERT_B",
    ),
}
STAGE2_NAME_TO_ID_V6 = {name: i for i, name in enumerate(STAGE2_GROUPS_V6)}
STAGE2_NAMES_V6 = tuple(STAGE2_GROUPS_V6.keys())

STAGE3_GROUPS_V6: Dict[str, Tuple[str, ...]] = {
    "RECT": ("PARTITION_HORZ", "PARTITION_VERT"),
    "AB": (
        "PARTITION_HORZ_A",
        "PARTITION_HORZ_B",
        "PARTITION_VERT_A",
        "PARTITION_VERT_B",
    ),
}

# ---------------------------------------------------------------------------
# Flatten architecture: 7-way direct classification (NONE dropped; the
# 9-class remap 1-9 -> 0-8 never realizes HORZ_4/VERT_4 in practice).
# Reference parity: pesquisa_v6/v6_pipeline/data_hub.py:41-49 and
# pesquisa_v6/scripts/001b_prepare_flatten_dataset.py:65-87.
# ---------------------------------------------------------------------------
FLATTEN_ID_TO_NAME: Dict[int, str] = {
    0: "PARTITION_HORZ",
    1: "PARTITION_VERT",
    2: "PARTITION_SPLIT",
    3: "PARTITION_HORZ_A",
    4: "PARTITION_HORZ_B",
    5: "PARTITION_VERT_A",
    6: "PARTITION_VERT_B",
}
FLATTEN_NAME_TO_ID = {name: idx for idx, name in FLATTEN_ID_TO_NAME.items()}

# Pipeline-eval class names for the realized v6 8-class output space
# (reference: pesquisa_v6/scripts/008_run_pipeline_eval_v6.py:288).
V6_EVAL_CLASS_NAMES = (
    "NONE", "SPLIT", "HORZ", "VERT", "HORZ_A", "HORZ_B", "VERT_A", "VERT_B",
)

# v6 8-class pipeline output id -> raw 10-class partition mode
# (NONE->NONE, SPLIT->SPLIT, HORZ/VERT->1/2, AB->4..7).
V6_FINAL_TO_RAW = np.array([0, 3, 1, 2, 4, 5, 6, 7], dtype=np.int32)

# Inverse: raw partition id -> v6 8-class pipeline id; 1TO4 (raw 8/9) has no
# slot in the realized v6 space and maps to -1 (excluded from metrics).
#
# QUIRK Q7 (reference bug): the reference's v6 pipeline eval compares its
# reordered predictions (SPLIT=1, HORZ=2, VERT=3) directly against the raw
# ``labels_stage0`` (HORZ=1, VERT=2, SPLIT=3) — see
# 008_run_pipeline_eval_v6.py:51-67,138-149 vs 001_prepare_v6_dataset.py:87 —
# so SPLIT/HORZ/VERT are misaligned in its published pipeline metrics. This
# table is the correct alignment; the CLIs keep a compat switch that
# reproduces the reference's misaligned comparison for number-matching.
RAW_TO_V6_FINAL = np.array([0, 2, 3, 1, 4, 5, 6, 7, -1, -1], dtype=np.int32)


def raw_to_v6_final(raw_ids):
    return _take(RAW_TO_V6_FINAL, raw_ids)


def _build_table(groups: Dict[str, Tuple[str, ...]], fill: int = -1) -> np.ndarray:
    """Build a 10-entry partition-id -> group-id lookup table."""
    table = np.full(NUM_PARTITION_MODES, fill, dtype=np.int32)
    for gid, (gname, members) in enumerate(groups.items()):
        for member in members:
            table[PARTITION_NAME_TO_ID[member]] = gid
    return table


# Integer lookup tables (index = raw partition id 0..9).
STAGE1_TABLE = (np.arange(NUM_PARTITION_MODES) != PARTITION_NONE).astype(np.int32)
STAGE2_TABLE_V5 = _build_table(STAGE2_GROUPS_V5, fill=0)  # all ids covered
STAGE2_TABLE_V6 = _build_table(STAGE2_GROUPS_V6, fill=-1)  # NONE/1TO4 -> -1

def _stage3_table(members: Tuple[str, ...]) -> np.ndarray:
    table = np.full(NUM_PARTITION_MODES, -1, dtype=np.int32)
    for i, member in enumerate(members):
        table[PARTITION_NAME_TO_ID[member]] = i
    return table


STAGE3_TABLES_V5 = {h: _stage3_table(m) for h, m in STAGE3_GROUPS_V5.items()}
STAGE3_TABLES_V6 = {h: _stage3_table(m) for h, m in STAGE3_GROUPS_V6.items()}

# 10-class raw id -> 7-class flatten id (NONE and 1TO4 -> -1 i.e. dropped).
FLATTEN_TABLE = np.full(NUM_PARTITION_MODES, -1, dtype=np.int32)
for _fid, _name in FLATTEN_ID_TO_NAME.items():
    FLATTEN_TABLE[PARTITION_NAME_TO_ID[_name]] = _fid

# 7-class flatten id -> 10-class raw id (for pipeline eval remap;
# reference: pesquisa_v6/scripts/008b_run_pipeline_flatten_eval.py:148-174).
FLATTEN_TO_RAW = np.array(
    [PARTITION_NAME_TO_ID[FLATTEN_ID_TO_NAME[i]] for i in range(len(FLATTEN_ID_TO_NAME))],
    dtype=np.int32,
)


def _take(table: np.ndarray, ids):
    """Index a constant table with numpy or torch ids, preserving array kind."""
    if isinstance(ids, torch.Tensor):
        return torch.from_numpy(table).to(ids.device)[ids.long()]
    return table[np.asarray(ids)]


def map_to_stage1(label_ids):
    """Binary split/no-split: 0 for PARTITION_NONE, 1 otherwise."""
    return _take(STAGE1_TABLE, label_ids)


def map_to_stage2_v5(label_ids):
    """5-way v5 macro class: NONE=0, SPLIT=1, RECT=2, AB=3, 1TO4=4."""
    return _take(STAGE2_TABLE_V5, label_ids)


def map_to_stage2_v6(label_ids):
    """3-way v6 macro class (SPLIT=0, RECT=1, AB=2) plus validity mask.

    NONE and 1TO4 map to -1 and are masked invalid, matching
    ``map_to_stage2_v6`` in the reference v6 data hub.
    """
    mapped = _take(STAGE2_TABLE_V6, label_ids)
    return mapped, mapped != -1


def map_to_stage3_v5(label_ids):
    """Per-head specialist labels; -1 where the sample is outside the head."""
    return {h: _take(t, label_ids) for h, t in STAGE3_TABLES_V5.items()}


def map_to_stage3_v6(label_ids):
    return {h: _take(t, label_ids) for h, t in STAGE3_TABLES_V6.items()}


def map_to_flatten(label_ids):
    """10-class raw id -> 7-class flatten id (-1 = dropped: NONE/1TO4)."""
    return _take(FLATTEN_TABLE, label_ids)


def flatten_to_raw(flatten_ids):
    """7-class flatten id -> 10-class raw partition id."""
    return _take(FLATTEN_TO_RAW, flatten_ids)


# ---------------------------------------------------------------------------
# Label-aware augmentation swap tables for the AB specialist head
# (labels are the head-local ids 0..3 = HORZ_A, HORZ_B, VERT_A, VERT_B).
#
# v6 semantics (pesquisa_v6/v6_pipeline/augmentation.py:13-75):
#   hflip: HORZ_A <-> HORZ_B          rot90 cw : HA->VA, HB->VB, VA->HB, VB->HA
#   vflip: VERT_A <-> VERT_B          rot270 cw: HA->VB, HB->VA, VA->HA, VB->HB
#
# v5 semantics differ (pesquisa_v5/012_train_stage3.py:215-219):
#   hflip_swap = {0:1, 1:0, 2:3, 3:2}; rot90_swap = {0:2, 2:0, 1:3, 3:1}
# ---------------------------------------------------------------------------
AB_HFLIP_SWAP_V6 = np.array([1, 0, 2, 3], dtype=np.int32)
AB_VFLIP_SWAP_V6 = np.array([0, 1, 3, 2], dtype=np.int32)
AB_ROT90_SWAP_V6 = np.array([2, 3, 1, 0], dtype=np.int32)
AB_ROT270_SWAP_V6 = np.array([3, 2, 0, 1], dtype=np.int32)

AB_HFLIP_SWAP_V5 = np.array([1, 0, 3, 2], dtype=np.int32)
AB_ROT90_SWAP_V5 = np.array([2, 3, 0, 1], dtype=np.int32)


def class_distribution(label_ids: np.ndarray) -> Dict[str, float]:
    """Fraction of each partition mode present in ``label_ids``."""
    label_ids = np.asarray(label_ids)
    total = label_ids.size
    counts = np.bincount(label_ids, minlength=NUM_PARTITION_MODES)
    return {
        PARTITION_ID_TO_NAME[i]: counts[i] / total
        for i in range(NUM_PARTITION_MODES)
        if counts[i] > 0
    }


__all__ = [
    "AB_HFLIP_SWAP_V5",
    "AB_HFLIP_SWAP_V6",
    "AB_ROT270_SWAP_V6",
    "AB_ROT90_SWAP_V5",
    "AB_ROT90_SWAP_V6",
    "AB_VFLIP_SWAP_V6",
    "BLOCK_SIZES",
    "BSIZE_INDEX_TO_PIXELS",
    "FLATTEN_ID_TO_NAME",
    "FLATTEN_NAME_TO_ID",
    "FLATTEN_TABLE",
    "FLATTEN_TO_RAW",
    "NUM_PARTITION_MODES",
    "PARTITION_ID_TO_NAME",
    "PARTITION_NAME_TO_ID",
    "STAGE1_TABLE",
    "STAGE2_GROUPS_V5",
    "STAGE2_GROUPS_V6",
    "STAGE2_NAMES_V5",
    "STAGE2_NAMES_V6",
    "STAGE2_NAME_TO_ID_V5",
    "STAGE2_NAME_TO_ID_V6",
    "STAGE2_TABLE_V5",
    "STAGE2_TABLE_V6",
    "STAGE3_GROUPS_V5",
    "STAGE3_GROUPS_V6",
    "STAGE3_TABLES_V5",
    "STAGE3_TABLES_V6",
    "RAW_TO_V6_FINAL",
    "V6_EVAL_CLASS_NAMES",
    "V6_FINAL_TO_RAW",
    "raw_to_v6_final",
    "class_distribution",
    "flatten_to_raw",
    "map_to_flatten",
    "map_to_stage1",
    "map_to_stage2_v5",
    "map_to_stage2_v6",
    "map_to_stage3_v5",
    "map_to_stage3_v6",
]
