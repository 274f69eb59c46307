"""The port's scale_demo run alone on the CPU (``--device cpu``), every CLI
for real: corpus scale 0.0005, one epoch a stage (the recipes' frozen epochs
still run: five for stage 2, RECT and FGVC, fifteen for flatten),
``certify_serving`` with its int8 rows. What it wrote is removed
(``test_torch_port_examples_run.remove_outputs``).
"""
import json

from av1tpu_torch.examples import scale_demo
from tests.test_torch_port_examples_run import remove_outputs  # noqa: F401  (fixture)


def test_scale_demo(tmp_path):
    out = tmp_path / "scale"
    scale_demo.main(["--out", str(out), "--scale", "0.0005", "--batch-size", "32",
                     "--stage1-epochs", "1", "--stage2-epochs", "1",
                     "--stage3-epochs", "1", "--flat-epochs", "1", "--no-bf16",
                     "--device", "cpu"])
    results = json.loads((out / "RESULTS.json").read_text())
    stages = results["stages"]
    assert list(stages) == [
        "prepare_stage3", "stage1", "calibration", "stage2", "stage3_rect",
        "stage3_ab_fgvc", "stage2_flat", "pipeline_v6", "pipeline_flatten",
        "certify_serving", "analyze_confusion"]
    assert stages["stage2"]["epochs"] == 6  # five frozen, one unfrozen
    assert stages["stage2_flat"]["epochs"] > 1  # the frozen phase ran (early stop at 8)
    assert 0.3 <= stages["calibration"]["best_threshold"] <= 0.7
    assert {"flax", "folded", "int8"} <= set(stages["certify_serving"])
    assert 0.0 <= stages["pipeline_v6"]["accuracy"] <= 1.0
    assert (out / "RESULTS.md").exists()
