"""The port's examples run alone on the CPU (``--device cpu``):

* int8_selfcalib_ab over one level's seeded stage and unified checkpoints
  (``test_torch_port_examples_run.level_models``), the frame geometry
  patched to 192x128 as in part 1, ``--fused-front on``, two frames, four
  modes, the int8 calibration for real;
* scale_demo_v5 un-stubbed at corpus scale 0.002, one epoch a stage;
* bench_ingest_to_trees un-stubbed on two 128x128 frames.

Every test removes what it wrote, and each trainer's TrainState checkpoints
when its CLI returns (``test_torch_port_examples_run.remove_outputs``).
"""
import json

from av1tpu_torch.examples import bench_ingest_to_trees, int8_selfcalib_ab, scale_demo_v5
from tests.test_torch_port_examples_run import (  # noqa: F401  (fixtures)
    CPU,
    level_models,
    remove_outputs,
    small_frames,
)


def test_int8_selfcalib_ab(tmp_path, small_frames, level_models):  # noqa: F811
    out = tmp_path / "ab"
    int8_selfcalib_ab.main(["--models", str(level_models), "--out", str(out),
                            "--frames", "2", "--fused-front", "on", *CPU])
    report = json.loads((out / "int8_selfcalib_ab.json").read_text())
    assert sorted(report["modes"]) == ["folded", "int8", "unified_folded", "unified_int8"]
    for pair in ("int8_vs_folded", "unified_int8_vs_unified_folded"):
        agreement = report["agreement"][pair]
        assert 0.0 <= agreement["exact_tree"] <= agreement["node_agreement"] <= 1.0
    assert report["clip"]["superblocks"] == 12
    assert all(mode["warm_sb_per_s"] > 0 for mode in report["modes"].values())


def test_scale_demo_v5(tmp_path):
    out = tmp_path / "v5"
    scale_demo_v5.main(["--out", str(out), "--scale", "0.002", "--batch-size", "32",
                        "--stage1-epochs", "1", "--stage2-epochs", "1",
                        "--stage3-epochs", "1", "--no-bf16", *CPU])
    results = json.loads((out / "RESULTS.json").read_text())
    assert list(results["stages"]) == ["prepare_stage3", "stage1", "stage2",
                                       "stage3_RECT", "stage3_AB", "pipeline_eval"]
    assert 0.0 <= results["pipeline"]["accuracy"] <= 1.0
    assert (out / "v5_pipeline_variables.npz").exists()


def test_bench_ingest_to_trees(tmp_path):
    out = tmp_path / "bench"
    bench_ingest_to_trees.main(["--width", "128", "--height", "128", "--frames", "2", "--chunk-frames", "1",
                "--batch-size", "64", "--no-bf16", "--out", str(out), *CPU])
    report = json.loads((out / "report.json").read_text())
    assert report["superblocks"] == 8 and report["frames"] == 2
    assert report["superblocks_per_sec_disk_to_tree"] > 0
