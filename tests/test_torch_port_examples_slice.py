"""The slice against the JAX package: ``int8_selfcalib_ab.run_mode`` of both
packages (the port's ``av1tpu_torch/examples`` module, the JAX package's
``examples/`` script) over one clip and one directory of a level's four
stage checkpoints and its unified one, ``--folded`` and ``--unified
--folded``, in fp32: the trees are equal exactly, as the CLI parity of
``test_torch_port_predict_trees.py`` requires, and so are the two packages'
``agreement`` of folded against unified. The JAX side runs only folded
graphs (its plain per-stage graph takes minutes to compile).
"""
import shutil

import numpy as np
import pytest

from av1tpu_torch.examples import int8_selfcalib_ab as port_ab
from tests.test_torch_port_examples import jax_example
from tests.torch_port_fixtures import (
    cascade_stage_models,
    cascade_unified_models,
    jax_variables,
    superblocks_u16,
)

CKPT = {"stage1": "stage1", "stage2": "stage2", "rect": "stage3_rect", "ab": "stage3_ab"}
W, H, FRAMES = 192, 128, 2  # 3 x 2 superblocks a frame
MODES = {"folded": ["--folded"], "unified_folded": ["--unified", "--folded"]}
SLICE_SIZE = 32  # the level whose models serve every level: its trees vary at each


def fp32_at_batch_64(main):
    """``predict_trees.main`` without run_mode's ``--bf16`` and at batch 64
    for its 4096 (the shapes tests/test_torch_port_predict_trees.py
    compiles), so that the comparison is fp32."""
    def wrapped(argv):
        argv = list(argv)
        argv.remove("--bf16")
        argv[argv.index("--batch-size") + 1] = "64"
        return main(argv)
    return wrapped


@pytest.fixture(scope="module")
def slice_runs(tmp_path_factory):
    """Both packages' ``run_mode`` in each mode on one clip and one directory
    holding a level's four stage checkpoints and its unified one."""
    import av1tpu.cli.predict_trees as jax_cli
    import av1tpu_torch.cli.predict_trees as port_cli
    from av1tpu_torch.train.checkpoint import save_variables_npz

    root = tmp_path_factory.mktemp("examples_slice")
    sbs = superblocks_u16(500, FRAMES * 6).reshape(FRAMES, 2, 3, 64, 64)
    luma = sbs.transpose(0, 1, 3, 2, 4).reshape(FRAMES, H, W)
    yuv = root / f"clip_{W}x{H}_30.yuv"
    with open(yuv, "wb") as f:
        for plane in luma:
            f.write(plane.astype("<u2").tobytes())
            f.write(np.full(2 * (H // 2) * (W // 2), 512, "<u2").tobytes())
    models = root / "models"
    stages = cascade_stage_models(seed=610, sizes=(SLICE_SIZE,))[SLICE_SIZE]
    for name, model in stages.items():
        save_variables_npz(models / f"{CKPT[name]}_best_variables.npz",
                           jax_variables(model), compress=False)
    unified = cascade_unified_models(seed=620, sizes=(SLICE_SIZE,))[SLICE_SIZE]
    save_variables_npz(models / "unified_best_variables.npz", jax_variables(unified),
                       compress=False)
    runs = {"jax": {}, "port": {}}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_cli, "main", fp32_at_batch_64(jax_cli.main))
        mp.setattr(port_cli, "main", fp32_at_batch_64(port_cli.main))
        for mode, extra in MODES.items():
            runs["jax"][mode] = jax_example("int8_selfcalib_ab").run_mode(
                yuv, models, root / f"jax_{mode}", list(range(FRAMES)), extra)
            runs["port"][mode] = port_ab.run_mode(
                yuv, models, root / f"port_{mode}", list(range(FRAMES)), extra,
                device="cpu")
    yield runs
    shutil.rmtree(models)


@pytest.mark.parametrize("mode", list(MODES))
def test_run_mode_trees_equal_the_jax_script(slice_runs, mode):
    want, got = slice_runs["jax"][mode]["trees"], slice_runs["port"][mode]["trees"]
    nodes = (want >= 0).sum(axis=-1).ravel()
    assert nodes.min() == 1 and nodes.max() > 5, "F2: the trees do not vary"
    assert len(np.unique(want[..., 0])) >= 2, "F2: every root takes one decision"
    assert got.shape == want.shape == (FRAMES, 6, 85)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    assert slice_runs["port"][mode]["warm_frame_s"] > 0


def test_run_mode_agreement_equals_the_jax_script(slice_runs):
    want = jax_example("int8_selfcalib_ab").agreement(
        slice_runs["jax"]["folded"]["trees"], slice_runs["jax"]["unified_folded"]["trees"])
    got = port_ab.agreement(slice_runs["port"]["folded"]["trees"],
                            slice_runs["port"]["unified_folded"]["trees"])
    assert got == want
    assert 0.0 < got["node_agreement"] < 1.0
