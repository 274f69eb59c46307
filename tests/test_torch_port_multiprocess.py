"""ROADMAP M11 in a real world of two processes: ``parallel/mesh.py`` on
``torch.distributed`` (gloo, the CPU), data- and model-sharded serving and
training held against one process.

Two workers start through ``torch.multiprocessing.spawn`` and meet over a
``FileStore`` in ``tmp_path`` (no port, so no race between pytest-xdist's
workers), each with one torch thread. They import no JAX: this module
imports JAX and the shared fixtures (which import JAX) only inside the
tests, which run in the parent. The parent builds the models and data,
passes them to the workers (tensors through shared memory) and computes the
one-process references itself.

* Serving, data 2: the folded v6 pipeline with the fused front (K1's plain
  version here) on a block count that leaves a tail, the gated pipeline at
  capacity 0.5 (its top-K over the global batch) and the tree cascade with
  level capacities {16: 0.5, 8: 0.25}: labels and trees bitwise equal to one
  process, on both ranks.
* Training, data 2: two epochs of the stage-1 recipe (balanced epochs, the
  stage-1 augmentation, CutMix, dropout) on a small v6-style model: both
  ranks bitwise equal; parameters and BatchNorm running statistics within
  ``rtol=1e-5, atol=1e-6`` of one process over the global batches composed
  the multi-host way (``tests/test_multiprocess.py``). The model is small
  because Adam's first steps scale each gradient entry to about ``lr``
  whatever its size: in a ResNet-18 at 16 px, entries whose gradient is
  rounding noise (taps that see mostly padding) move by ``lr`` in a
  direction the reduction order decides, in both packages alike.
* Model 2: one train step of ``Stage1Model`` with its 256- and 512-wide
  layers column-parallel, against one process: the loss, every gradient and
  the BatchNorm statistics within the same tolerance; its checkpoint holds
  the whole state and restores bitwise.
* One data-2 step without augmentation against the JAX package's step on
  ``make_mesh(num_data=2, num_model=2)`` from the same variables, within
  ``tests/test_torch_port_train_step.py``'s tolerance.
* The ``run_pipeline_eval`` and ``train_stage1`` CLIs in two processes
  (``WORLD_SIZE`` / ``RANK`` / ``MASTER_ADDR`` / ``MASTER_PORT`` set as
  ``torchrun`` sets them) against one process.
"""
import json
import os
import socket
import time
from dataclasses import replace
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from torch import nn

from av1tpu_torch.cli import run_pipeline_eval, train_stage1
from av1tpu_torch.data.bundles import Bundle, save_split
from av1tpu_torch.eval import (
    PipelineModels,
    make_v6_pipeline_folded,
    make_v6_pipeline_gated,
    predict_partition_trees,
    run_pipeline_batched,
)
from av1tpu_torch.models import Stage1Model, Stage2Model, Stage3ABModel, Stage3RectModel
from av1tpu_torch.models.layers import BatchNorm2d, MLPHead, SpatialConv
from av1tpu_torch.parallel import mesh as pm
from av1tpu_torch.train import checkpoint as tc
from av1tpu_torch.train import schedules as tsch
from av1tpu_torch.train import trainer as tt
from av1tpu_torch.train.losses import binary_focal_loss, cutmix_batch
from av1tpu_torch.train.stages import stage1_recipe, train_stage

WORLD = 2
TIMEOUT = 300  # seconds for one spawn of both workers
THRESHOLD = 0.45
N_SERVE, SERVE_BATCH = 150, 64  # a tail of 22 rows
LEVEL_CAPACITIES = {16: 0.5, 8: 0.25}
TRAIN_BATCH, TRAIN_ROWS, VAL_ROWS = 16, 64, 40
RTOL, ATOL = 1e-5, 1e-6  # tests/test_multiprocess.py
STAGE_CLASSES = (Stage1Model, Stage2Model, Stage3RectModel, Stage3ABModel)


class TinyStage1(nn.Module):
    """A small stage-1 model of the v6 building blocks: a SAME 3x3 conv,
    flax-train-mode BatchNorm, relu, the spatial mean and an MLP head with
    dropout; ``(B,)`` logits."""

    def __init__(self):
        super().__init__()
        self.conv = SpatialConv(1, 8, 3)
        self.bn = BatchNorm2d(8)
        self.head = MLPHead(8, (16,), 1, (0.3,))

    def forward(self, x):
        x = torch.relu(self.bn(self.conv(x.permute(0, 3, 1, 2))))
        return self.head(x.mean(dim=(2, 3))).squeeze(-1)


# ---------------------------------------------------------------------------
# What each rank runs (also run by the parent without a mesh, as the reference)
# ---------------------------------------------------------------------------

def _models(state_dicts):
    out = []
    for cls, sd in zip(STAGE_CLASSES, state_dicts):
        model = cls()
        model.load_state_dict(sd)
        out.append(model.eval())
    return PipelineModels(*out)


def serve(inputs, mesh):
    """The folded pipeline with the fused front, and the gated pipeline."""
    models = _models(inputs["serving_models"])
    images = inputs["images"]
    folded = make_v6_pipeline_folded(models, THRESHOLD, float_dtype=torch.float32,
                                     use_fused_front=True, device="cpu", mesh=mesh)
    gated = make_v6_pipeline_gated(models, 0.5, THRESHOLD, device="cpu", mesh=mesh)
    return {"folded": run_pipeline_batched(folded, images, SERVE_BATCH, "cpu", mesh=mesh),
            "gated": run_pipeline_batched(gated, images, SERVE_BATCH, "cpu", mesh=mesh)}


def trees(inputs, mesh):
    """The four-level cascade, folded with the fused front, gated at 16 and 8 px."""
    predictors = {
        size: make_v6_pipeline_folded(_models(sds), THRESHOLD, float_dtype=torch.float32,
                                      use_fused_front=True, device="cpu", mesh=mesh)
        for size, sds in inputs["cascade_models"].items()
    }
    return predict_partition_trees(inputs["superblocks"], predictors, 128, mesh=mesh,
                                   level_capacities=LEVEL_CAPACITIES, device="cpu")


def tiny_recipe():
    """The stage-1 recipe on :class:`TinyStage1`, with CutMix added."""
    recipe = stage1_recipe(epochs=2, batch_size=TRAIN_BATCH,
                           steps_per_epoch=TRAIN_ROWS // TRAIN_BATCH)
    return replace(recipe, model=TinyStage1, input_shape=(16, 16, 1),
                   batch_mix=lambda gen, images: cutmix_batch(gen, images, 1.0, 0.9))


def train(inputs, mesh):
    result = train_stage(tiny_recipe(), inputs["train"], inputs["val"], seed=7, device="cpu",
                         mesh=mesh, log=lambda message: None)
    return {"state": {k: v.clone() for k, v in result.state.model.state_dict().items()},
            "losses": [h["train_loss"] for h in result.history],
            "val": [h["val_metrics"] for h in result.history]}


def one_step(inputs, mesh, model_cls=Stage1Model, augment=True):
    """One train step from ``inputs["step_state"]`` on ``inputs["step_batch"]``
    (this rank's rows of it under a data axis): the loss, the gradients the
    optimizer was given (whole layers) and the state dict after the step."""
    model = model_cls()
    model.load_state_dict(inputs["step_state"])
    if not augment:
        for mod in model.modules():
            if isinstance(mod, nn.Dropout):
                mod.p = 0.0
    if mesh is not None:
        pm.place_params(model, mesh)
    opt = tsch.as_optimizer(model, tsch.adamw(1e-3))
    grads, step = {}, opt.step
    names = {id(p): n for n, p in model.named_parameters()}
    layers = {id(m.weight): m for m in model.modules() if isinstance(m, pm.ColumnParallel)}

    def capturing_step():
        for p in opt.params:
            g = torch.zeros_like(p) if p.grad is None else p.grad
            grads[names[id(p)]] = (layers[id(p)].full(g) if id(p) in layers else g).clone()
        step()

    opt.step = capturing_step
    cfg = tt.StepConfig(loss_fn=lambda lo, ta: binary_focal_loss(lo, ta, 0.25, 2.5),
                        label_key="stage1", binary=True, num_classes=2,
                        augment=inputs["augment"] if augment else None)
    batch = {k: torch.from_numpy(v) for k, v in inputs["step_batch"].items()}
    if mesh is not None:
        batch = pm.shard_batch(batch, mesh)
    torch.manual_seed(5)
    state = tt.TrainState(model, opt)
    out = tt.make_train_step(model, opt, cfg, mesh)(state, batch,
                                                    torch.Generator().manual_seed(9))
    return {"loss": float(out["loss"]), "grads": grads, "state": model.state_dict(),
            "train_state": state}


def model_sharded_step(inputs, mesh):
    """:func:`one_step` on the model-2 mesh, then its checkpoint's round trip."""
    out = one_step(inputs, mesh)
    ckpt = tc.save_checkpoint(Path(inputs["dir"]) / "model2_ckpt", out.pop("train_state"))
    template = Stage1Model()
    pm.place_params(template, mesh)
    template = tt.TrainState(template, tsch.as_optimizer(template, tsch.adamw(1e-3)))
    restored, _ = tc.restore_checkpoint(ckpt, template)
    again = tc._state_payload(restored)
    saved = torch.load(ckpt / tc.STATE_FILE, weights_only=True)
    out["restored_equal"] = tc._bitwise_equal(again, saved)
    return out


def jax_step(inputs, mesh):
    out = one_step({**inputs, "step_state": inputs["jax_state"],
                    "step_batch": inputs["jax_batch"]}, mesh, augment=False)
    out.pop("train_state")
    return out


def mesh_errors(inputs, mesh):
    """The messages of the mesh's refusals in a world of two."""
    errors = {}
    for name, call in (("model", lambda: pm.make_mesh(num_model=3)),
                       ("devices", lambda: pm.make_mesh(num_data=4)),
                       ("batch", lambda: pm.local_batch_slice(3, mesh))):
        try:
            call()
        except ValueError as exc:
            errors[name] = str(exc)
    return errors


# ---------------------------------------------------------------------------
# The workers
# ---------------------------------------------------------------------------

def _library_worker(rank, store, inputs, out_dir):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, WORLD), rank=rank,
                            world_size=WORLD)
    try:
        data2, model2 = pm.make_mesh(device_type="cpu"), None
        results = {"serve": serve(inputs, data2), "trees": trees(inputs, data2),
                   "train": train(inputs, data2), "errors": mesh_errors(inputs, data2),
                   "jax_step": jax_step(inputs, data2)}
        results["rank_of_data"] = pm.axis_index(data2, pm.DATA_AXIS)
        model2 = pm.make_mesh(num_model=2, device_type="cpu")
        results["model2"] = model_sharded_step(inputs, model2)
        torch.save(results, Path(out_dir) / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def _cli_worker(rank, port, argvs):
    torch.set_num_threads(1)
    os.environ.update({"WORLD_SIZE": str(WORLD), "RANK": str(rank), "LOCAL_RANK": str(rank),
                       "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port)})
    try:
        run_pipeline_eval.main(argvs["serve"])
        train_stage1.main(argvs["train"])
        if rank == 0:  # the world these CLIs ran in
            Path(argvs["world"]).write_text(f"{dist.get_world_size()} {dist.get_backend()}")
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _spawn(fn, args):
    """Run ``fn(rank, *args)`` in two spawned processes; raise if one fails
    or both are not done within ``TIMEOUT`` seconds (then kill them)."""
    context = mp.start_processes(fn, args=args, nprocs=WORLD, join=False,
                                 start_method="spawn")
    deadline = time.monotonic() + TIMEOUT
    try:
        while not context.join(timeout=1):
            if time.monotonic() > deadline:
                raise TimeoutError(f"workers did not finish within {TIMEOUT} s")
    finally:
        for p in context.processes:
            if p.is_alive():
                p.kill()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


# ---------------------------------------------------------------------------
# The parent: inputs, the workers' results, the one-process references
# ---------------------------------------------------------------------------

def _bundle(rng, n):
    stage1 = rng.integers(0, 2, size=n).astype(np.int32)
    return Bundle(samples=rng.integers(0, 1024, size=(n, 16, 16, 1), dtype=np.uint16),
                  qps=np.full(n, 90, np.int32), labels={"stage1": stage1})


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    from tests.torch_port_fixtures import (
        cascade_stage_models,
        images_u16,
        seeded_torch_model,
        superblocks_u16,
    )
    from av1tpu_torch.train.augment import stage1_augment

    root = tmp_path_factory.mktemp("two_processes")
    calib = images_u16(40, 128, 16)
    serving = [seeded_torch_model(cls, 410 + i, calib) for i, cls in enumerate(STAGE_CLASSES)]
    cascade = cascade_stage_models(seed=420)
    rng = np.random.default_rng(430)
    step_rng = np.random.default_rng(440)
    jax_rng = np.random.default_rng(450)
    inputs = {
        "dir": str(root),
        "serving_models": [m.state_dict() for m in serving],
        "images": images_u16(41, N_SERVE, 16),
        "cascade_models": {size: [models[n].state_dict()
                                  for n in ("stage1", "stage2", "rect", "ab")]
                           for size, models in cascade.items()},
        "superblocks": superblocks_u16(42, 4),
        "train": _bundle(rng, TRAIN_ROWS), "val": _bundle(rng, VAL_ROWS),
        "step_state": seeded_torch_model(Stage1Model, 460, calib).state_dict(),
        "step_batch": {"samples": step_rng.integers(0, 1024, (16, 16, 16, 1), dtype=np.uint16),
                       "stage1": step_rng.integers(0, 2, 16).astype(np.int32)},
        "augment": stage1_augment,
        "jax_state": seeded_torch_model(Stage1Model, 470, images_u16(43, 128, 8)).state_dict(),
        "jax_batch": {"samples": jax_rng.integers(0, 1024, (8, 8, 8, 1), dtype=np.uint16),
                      "stage1": jax_rng.integers(0, 2, 8).astype(np.int32)},
    }
    _spawn(_library_worker, (str(root / "store"), inputs, str(root)))
    ranks = [torch.load(root / f"rank{r}.pt", weights_only=False) for r in range(WORLD)]
    return {"inputs": inputs, "ranks": ranks, "root": root}


def _assert_outputs_equal(got, want):
    """Labels, trees and counts bitwise; the stage-1 probabilities within fp32
    rounding (one process runs a tail at its own size, the ranks run their
    rows of the padded batch, and the CPU's convolutions round a row alike
    only at one batch size)."""
    assert set(got) == set(want)
    for key, value in want.items():
        if key == "stage1_prob":
            np.testing.assert_allclose(got[key], value, rtol=1e-6, atol=0, err_msg=key)
        else:
            np.testing.assert_array_equal(got[key], value, err_msg=key)


@pytest.mark.parametrize("name", ["folded", "gated"])
def test_data_sharded_serving_equals_one_process(world, name):
    want = serve(world["inputs"], None)[name]
    for rank in world["ranks"]:
        _assert_outputs_equal(rank["serve"][name], want)
    if name == "gated":  # the K places were taken over each global batch
        assert want["overflow"].sum() > 0 and (want["stage2_pred"] >= 0).any()


def test_tree_cascade_with_level_capacities_equals_one_process(world):
    want = trees(world["inputs"], None)
    assert (want["trees"][:, 21:] >= 0).any()  # the trees reach the 8 px level
    for rank in world["ranks"]:
        _assert_outputs_equal(rank["trees"], want)


def test_data_sharded_training_equals_one_process(world):
    """One process trains on the global batches of the data-2 run
    (``chip_smoke.composed_epochs``: step s is every rank's rows s*b..(s+1)*b
    of its contiguous shard of the epoch order, ``tests/test_multiprocess.py``)."""
    from chip_smoke import composed_epochs

    r0, r1 = (rank["train"] for rank in world["ranks"])
    for key, value in r0["state"].items():
        assert torch.equal(value, r1["state"][key]), key
    assert r0["losses"] == r1["losses"] and r0["val"] == r1["val"]
    with composed_epochs(WORLD):
        want = train(world["inputs"], None)
    np.testing.assert_allclose(r0["losses"], want["losses"], rtol=RTOL, atol=ATOL)
    assert r0["val"][-1]["support"] == want["val"][-1]["support"]
    moved = 0
    for key, value in want["state"].items():
        if key.endswith("num_batches_tracked"):
            assert torch.equal(r0["state"][key], value)
            continue
        np.testing.assert_allclose(r0["state"][key].numpy(), value.numpy(), rtol=RTOL,
                                   atol=ATOL, err_msg=key)
        moved += "running" in key
    assert moved == 2  # the BatchNorm running statistics are held too


def _assert_step_close(got, want, rtol, atol):
    assert abs(got["loss"] - want["loss"]) <= rtol * abs(want["loss"])
    assert set(got["grads"]) == set(want["grads"])
    for name, g in want["grads"].items():
        np.testing.assert_allclose(got["grads"][name].numpy(), g.numpy(), rtol=rtol,
                                   atol=atol, err_msg=name)
    for key, value in want["state"].items():
        if "running" in key:
            np.testing.assert_allclose(got["state"][key].numpy(), value.numpy(), rtol=rtol,
                                       atol=atol, err_msg=key)


def test_model_sharded_step_equals_one_process(world):
    r0, r1 = (rank["model2"] for rank in world["ranks"])
    assert r0["loss"] == r1["loss"]
    for name, g in r0["grads"].items():
        assert torch.equal(g, r1["grads"][name]), name
    want = one_step(world["inputs"], None)
    _assert_step_close(r0, want, RTOL, ATOL)
    # the wide layers were sharded, and their state_dict is whole again
    full = Stage1Model().state_dict()
    for key, value in r0["state"].items():
        assert value.shape == full[key].shape, key
    assert r0["restored_equal"] and r1["restored_equal"]
    saved = torch.load(world["root"] / "model2_ckpt" / tc.STATE_FILE, weights_only=True)
    assert saved["model"]["backbone.layer4.1.conv2.weight"].shape == (512, 512, 3, 3)
    moments = saved["optimizer"]["adamw"]["state"]
    assert any(m["exp_avg"].shape == (512, 512, 3, 3) for m in moments.values())


def test_mesh_errors_match_jax(world):
    """``make_mesh`` and ``local_batch_slice`` refuse what the JAX package's
    refuse, with its messages (``tests/test_sharding.py``), in a world of two."""
    from av1tpu.parallel import mesh as jmesh

    want = {}
    for name, call in (("model", lambda: jmesh.make_mesh(num_model=3)),
                       ("devices", lambda: jmesh.make_mesh(num_data=16)),
                       ("batch", lambda: jmesh.local_batch_slice(30, jmesh.make_mesh()))):
        with pytest.raises(ValueError) as exc:
            call()
        want[name] = str(exc.value)
    assert want["model"] == "8 devices not divisible by model=3"
    for rank in world["ranks"]:
        got = rank["errors"]
        assert got["model"] == want["model"].replace("8 devices", "2 devices")
        assert got["devices"] == "need 4 devices, have 2"
        assert want["devices"] == "need 16 devices, have 8"
        assert got["batch"] == want["batch"].replace("batch 30", "batch 3").replace(
            "axis 8", "axis 2")
    assert [rank["rank_of_data"] for rank in world["ranks"]] == [0, 1]


def test_data_sharded_step_matches_jax_mesh_step(world):
    """One data-2 step of the port (two processes) against the JAX package's
    step on a (data 2, model 2) mesh from the same variables, within
    ``test_torch_port_train_step.py``'s tolerance: the loss 1e-5 rel, each
    gradient within 1e-4 of its largest entry (floored at 0.1 of the model's
    largest), the BatchNorm statistics within 1e-5 of each tensor's largest."""
    import flax.linen
    import jax
    import jax.numpy as jnp
    import optax

    from av1tpu import models as jm
    from av1tpu.parallel.mesh import make_mesh, shard_batch
    from av1tpu.train import losses as jl
    from av1tpu.train import trainer as jt
    from av1tpu_torch.models import from_jax_variables, to_jax_variables

    inputs = world["inputs"]
    variables = to_jax_variables(inputs["jax_state"])
    capture = optax.GradientTransformation(
        lambda p: jax.tree_util.tree_map(jnp.zeros_like, p),
        lambda g, s, p=None: (jax.tree_util.tree_map(jnp.zeros_like, g), g))
    cfg = jt.StepConfig(loss_fn=lambda lo, ta: jl.binary_focal_loss(lo, ta, 0.25, 2.5),
                        label_key="stage1", binary=True, num_classes=2)
    mesh = make_mesh(num_data=2, num_model=2)
    with pytest.MonkeyPatch.context() as patch:
        patch.setattr(flax.linen.Dropout, "__call__",
                      lambda self, inputs, deterministic=None, rng=None: inputs)
        step = jt.make_train_step(jm.Stage1Model(), capture, cfg)
        state = jt.place_state(jt.TrainState.create(variables, capture), mesh)
        batch = shard_batch({k: jnp.asarray(v) for k, v in inputs["jax_batch"].items()}, mesh)
        new, metrics = step(state, batch, jax.random.PRNGKey(0))
    want_grads = from_jax_variables({"params": jax.tree_util.tree_map(np.asarray,
                                                                      new.opt_state)})
    want_stats = from_jax_variables({"batch_stats": jax.tree_util.tree_map(
        np.asarray, new.batch_stats)})
    largest = max(g.abs().max().item() for g in want_grads.values())
    for rank in world["ranks"]:
        got = rank["jax_step"]
        assert abs(got["loss"] - float(metrics["loss"])) <= 1e-5 * abs(float(metrics["loss"]))
        assert set(got["grads"]) == {k for k in want_grads
                                     if not k.endswith("num_batches_tracked")}
        for name, g in got["grads"].items():
            ref = want_grads[name]
            scale = max(ref.abs().max().item(), 0.1 * largest)
            assert (g - ref).abs().max().item() <= 1e-4 * scale, name
        for key, ref in want_stats.items():
            if key.endswith("num_batches_tracked"):
                continue
            err = (got["state"][key] - ref).abs().max().item()
            assert err <= 1e-5 * ref.abs().max().item(), key


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    """Both CLIs in two processes and in one: their output directories."""
    from tests.torch_port_fixtures import images_u16, seeded_torch_model

    from av1tpu_torch.models import to_jax_variables
    from av1tpu_torch.train.checkpoint import save_variables_npz

    root = tmp_path_factory.mktemp("cli_two_processes")
    rng = np.random.default_rng(480)
    stage0 = lambda n: rng.integers(0, 8, size=n).astype(np.int32)  # noqa: E731

    def bundle(n):
        s0 = stage0(n)
        return Bundle(samples=rng.integers(0, 1024, (n, 16, 16, 1), dtype=np.uint16),
                      qps=np.full(n, 90, np.int32),
                      labels={"stage0": s0, "stage1": (s0 != 0).astype(np.int32)})

    save_split(root / "dataset", 16, bundle(32), bundle(150), "v6")
    calib = images_u16(44, 128, 16)
    ckpts = [save_variables_npz(root / f"{cls.__name__}.npz", to_jax_variables(
        seeded_torch_model(cls, 490 + i, calib).state_dict()), compress=False)
        for i, cls in enumerate(STAGE_CLASSES)]

    def argvs(out):
        data = ["--dataset-dir", str(root / "dataset"), "--block-size", "16",
                "--device", "cpu"]
        return {
            "serve": [*data, "--output-dir", str(out / "serve"), "--batch-size", "64",
                      "--folded", "--fused-front", "on", "--no-ab-fgvc",
                      "--stage1-checkpoint", str(ckpts[0]), "--stage2-checkpoint",
                      str(ckpts[1]), "--stage3-rect-checkpoint", str(ckpts[2]),
                      "--stage3-ab-checkpoint", str(ckpts[3])],
            "train": [*data, "--output-dir", str(out / "train"), "--epochs", "1",
                      "--batch-size", "32", "--num-model-shards", "2"],
            "world": str(out / "world.txt"),
        }

    two, one = argvs(root / "two"), argvs(root / "one")
    _spawn(_cli_worker, (_free_port(), two))
    run_pipeline_eval.main(one["serve"])
    # one process holds the whole model: no model axis
    train_stage1.main([a if a != "2" else "1" for a in one["train"]])
    return {"two": root / "two", "one": root / "one"}


def test_serving_cli_in_two_processes_equals_one(cli_runs):
    assert (cli_runs["two"] / "world.txt").read_text() == "2 gloo"
    got = np.load(cli_runs["two"] / "serve" / "pipeline_predictions_val.npz")
    want = np.load(cli_runs["one"] / "serve" / "pipeline_predictions_val.npz")
    assert sorted(got.files) == sorted(want.files)
    for key in want.files:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def test_model_sharded_train_cli_in_two_processes_equals_one(cli_runs):
    """``train_stage1 --num-model-shards 2`` in two processes against the
    CLI in one, on one step (32 rows, batch 32). Column-parallel layers
    compute every output channel whole, so the step's forward is the one
    process's bit for bit: its loss and the BatchNorm running statistics it
    moved are equal. The gradients are held at 1e-5 by
    ``test_model_sharded_step_equals_one_process``; the parameters after an
    Adam step are not compared here, since Adam moves an entry whose
    gradient is rounding noise by about ``lr`` either way. Every file is
    written once, with whole layers."""
    one, two = cli_runs["one"] / "train", cli_runs["two"] / "train"
    assert {p.name for p in one.iterdir()} == {p.name for p in two.iterdir()}
    got_history = json.loads((two / "stage1_history.json").read_text())
    want_history = json.loads((one / "stage1_history.json").read_text())
    assert [h["train_loss"] for h in got_history] == [h["train_loss"] for h in want_history]
    np.testing.assert_allclose([h["val_loss"] for h in got_history],
                               [h["val_loss"] for h in want_history], rtol=RTOL)
    got = _flat(tc.load_variables_npz(two / "stage1_final" / "variables.npz"))
    want = _flat(tc.load_variables_npz(one / "stage1_final" / "variables.npz"))
    assert got.keys() == want.keys()
    for key, value in want.items():
        assert got[key].shape == value.shape, key
        if key.startswith("batch_stats"):
            np.testing.assert_array_equal(got[key], value, err_msg=key)


def _flat(tree, prefix=""):
    out = {}
    for key, value in tree.items():
        if isinstance(value, dict):
            out.update(_flat(value, f"{prefix}{key}/"))
        else:
            out[f"{prefix}{key}"] = np.asarray(value)
    return out
