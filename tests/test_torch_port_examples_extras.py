"""The port's scale_demo_extras run alone on the CPU (``--device cpu``),
every CLI for real, over a scale_demo directory built without its training
(:func:`ladder`): the v6 dataset at corpus scale 0.0005, its stage-3
datasets from ``prepare_stage3``, seeded 16 px stage checkpoints and an FGVC
one (tests/torch_port_fixtures.py) where scale_demo's trainers write theirs,
and the calibration of ``optimize_thresholds`` on the stage-1 checkpoint.
scale_demo itself runs whole in ``test_torch_port_examples_scale.py``.
The directory is removed at teardown, and each trainer's TrainState
checkpoints when its CLI returns (``test_torch_port_examples_run.remove_outputs``).
"""
import json
import shutil

import numpy as np
import pytest

from av1tpu_torch import models as tm
from av1tpu_torch.cli import optimize_thresholds, prepare_stage3
from av1tpu_torch.data import build_v6_bundle
from av1tpu_torch.data.bundles import save_split
from av1tpu_torch.data.synth import reference_shaped_corpus
from av1tpu_torch.examples import scale_demo_extras
from av1tpu_torch.train.checkpoint import save_variables_npz
from tests.test_torch_port_examples_run import remove_outputs  # noqa: F401  (fixture)
from tests.torch_port_fixtures import (
    blocks_of_every_size,
    cascade_stage_models,
    jax_variables,
    seeded_torch_model,
    superblocks_u16,
)

CPU = ["--device", "cpu"]
LADDER_SCALE = "0.0005"
CHECKPOINTS = {"stage1": "stage1/stage1", "stage2": "stage2/stage2",
               "rect": "stage3_rect/stage3_rect"}


@pytest.fixture(scope="module")
def ladder(tmp_path_factory):
    """A scale_demo output directory with seeded checkpoints for trained ones."""
    root = tmp_path_factory.mktemp("examples_ladder")
    train, val = reference_shaped_corpus(42, scale=float(LADDER_SCALE))
    save_split(root / "v6_dataset", 16, build_v6_bundle(train), build_v6_bundle(val), "v6")
    prepare_stage3.main(["--dataset-dir", str(root / "v6_dataset"), "--out",
                         str(root / "stage3_datasets"), "--block-size", "16",
                         "--ensemble-members", "3"])
    for name, model in cascade_stage_models(seed=710, sizes=(16,))[16].items():
        if name in CHECKPOINTS:
            save_variables_npz(root / f"{CHECKPOINTS[name]}_best_variables.npz",
                               jax_variables(model), compress=False)
    calib = blocks_of_every_size(superblocks_u16(730, 8))[16]
    save_variables_npz(root / "stage3_ab" / "stage3_ab_fgvc_best_variables.npz",
                       {**jax_variables(seeded_torch_model(tm.FGVCModel, 731, calib)),
                        "centers": {"centers": np.zeros((4, 128), np.float32)}},
                       compress=False)
    optimize_thresholds.main([
        "--dataset-dir", str(root / "v6_dataset"), "--block-size", "16",
        "--stage1-checkpoint", str(root / "stage1" / "stage1_best_variables.npz"),
        "--output-dir", str(root / "calibration"), *CPU])
    yield root
    shutil.rmtree(root)


def test_scale_demo_extras(ladder):
    scale_demo_extras.main(["--demo", str(ladder), "--scale", LADDER_SCALE,
                            "--batch-size", "32", "--ensemble-epochs", "1",
                            "--v5-epochs", "1", *CPU])
    extras = json.loads((ladder / "EXTRAS.json").read_text())
    assert {"ab_ensemble_train", "pipeline_v6_ab_ensemble", "pipeline_v6_tta",
            "pipeline_v6_gated_05", "compare_thresholds", "v5_prepare_stage3",
            "v5_stage1", "v5_stage2", "v5_stage3_RECT", "v5_stage3_AB",
            "v5_pipeline"} == set(extras)
    for member in (1, 2, 3):
        assert 0.0 <= extras["ab_ensemble_train"][f"member{member}_best_f1"] <= 1.0
    for row in ("pipeline_v6_ab_ensemble", "pipeline_v6_tta", "pipeline_v6_gated_05",
                "v5_pipeline"):
        assert 0.0 <= extras[row]["accuracy"] <= 1.0, row
    assert (ladder / "operating_points").is_dir()
    assert (ladder / "v5_runs" / "v5_merged_variables.npz").exists()
