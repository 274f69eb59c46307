"""The port's unified_demo and demo_e2e run alone on the CPU (``--device
cpu``):

* unified_demo with ``--ladder`` over the seeded scale_demo directory of
  ``test_torch_port_examples_extras.ladder``: both unified trainings, the
  host sweeps and the folded throughput with ``--fused-front g1`` (the
  per-stage trainers that make a ladder run whole in ``..._scale.py``);
* demo_e2e un-stubbed but for its dataset, cut to 16 blocks a class (the
  script's own ``make_dataset(n_per_class)``), one epoch, fp32: one epoch
  on 96 blocks learns nothing, so its accuracy gate fires after it has
  written its results (``chip_smoke.py`` path k passes the gate on the
  card at the script's size).

Every test removes what it wrote, and each trainer's TrainState checkpoints
when its CLI returns (``test_torch_port_examples_run.remove_outputs``).
"""
import functools
import json

import numpy as np
import pytest

from av1tpu_torch.examples import demo_e2e, unified_demo
from tests.test_torch_port_examples_extras import ladder  # noqa: F401  (fixture)
from tests.test_torch_port_examples_run import CPU, remove_outputs  # noqa: F401  (fixture)


def test_unified_demo_on_a_ladder(tmp_path, ladder):  # noqa: F811
    out = tmp_path / "uni"
    unified_demo.main(["--out", str(out), "--ladder", str(ladder), "--epochs", "1",
                       "--batch-size", "32", "--throughput-batch", "16",
                       "--fused-front", "g1", "--no-bf16", *CPU])
    results = json.loads((out / "RESULTS.json").read_text())
    assert results["ladder"] == str(ladder)
    assert list(results["stages"]) == ["unified", "unified_kd"]
    assert set(results["val"]) == {"cascade", "unified", "unified_kd"}
    for family in results["val"].values():
        assert 0.2 <= family["threshold"] <= 0.8 and len(family["sweep"]) == 13
    throughput = results["throughput"]
    assert throughput["folded_unified_sb_per_sec"] > 0 and throughput["fused_front"] == "g1"
    assert throughput["unified_batch"] in (16, 64)


def test_demo_e2e(tmp_path, monkeypatch):
    out = tmp_path / "demo"
    monkeypatch.setattr(demo_e2e, "make_dataset",
                        functools.partial(demo_e2e.make_dataset, n_per_class=16))
    with pytest.raises(AssertionError, match="pipeline failed to learn"):
        demo_e2e.main(["--epochs", "1", "--batch-size", "32", "--no-bf16",
                       "--out", str(out), *CPU])
    results = json.loads((out / "demo_results.json").read_text())
    for key in ("stage1_val_f1", "stage2_val_f1", "stage3_rect_val_f1", "stage3_ab_val_f1",
                "pipeline_accuracy", "pipeline_macro_f1", "best_threshold_f1"):
        assert np.isfinite(results[key]), key
    assert results["backend"] == "cpu"
    assert "conditional" in results["cascade"]
