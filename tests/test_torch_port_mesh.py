"""``av1tpu_torch.parallel.mesh`` (ROADMAP M11) in one process, against the
JAX package's ``av1tpu.parallel.mesh``.

* ``param_partition_spec`` shards the same parameters as the JAX rule on
  every parameter of the four v6 stage models and ``UnifiedV6Model`` (names
  carried across by ``models.jax_import``): the output dim of a ``Conv2d`` or
  ``Linear`` weight of at least 256 outputs, divisible by the model axis.
  BatchNorm scales, which torch also names ``weight``, are never sharded.
* ``make_mesh`` and ``local_batch_slice`` refuse what the JAX package's
  refuse, with its messages (``tests/test_sharding.py``).
* A world of one over gloo, in this process (a ``FileStore`` in ``tmp_path``),
  equals no mesh: serving, the gated pipeline, a train step and
  ``train_stage``; ``ColumnParallel`` over a group of one equals its layer.

The two-process runs are ``tests/test_torch_port_multiprocess.py``.
"""
import copy
import re

import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import PartitionSpec as P
from torch import nn

from av1tpu.parallel import mesh as jmesh
from av1tpu_torch import models as tm
from av1tpu_torch.data.bundles import Bundle
from av1tpu_torch.eval import (
    PipelineModels,
    make_v6_pipeline_folded,
    make_v6_pipeline_gated,
    run_pipeline_batched,
)
from av1tpu_torch.models.layers import SpatialConv
from av1tpu_torch.parallel import mesh as pm
from av1tpu_torch.train import schedules as tsch
from av1tpu_torch.train import trainer as tt
from av1tpu_torch.train.losses import binary_focal_loss
from av1tpu_torch.train.stages import stage1_recipe, train_stage
from tests.torch_port_fixtures import (
    STAGE1_THRESHOLD,
    images_u16,
    seeded_torch_model,
    world_of_one,
)

MODELS = {"stage1": tm.Stage1Model, "stage2": tm.Stage2Model, "rect": tm.Stage3RectModel,
          "ab": tm.Stage3ABModel, "unified": tm.UnifiedV6Model}


def _jax_leaf(name: str, value: torch.Tensor):
    """The JAX path and value of one port parameter (``models.jax_import``)."""
    tree = tm.to_jax_variables({name: value.detach()})
    (col, node), = ((c, n) for c, n in tree.items() if n)
    path = [col]
    while isinstance(node, dict):
        (key, node), = node.items()
        path.append(key)
    return tuple(path[1:]), node


@pytest.mark.parametrize("num_model", [2, 4])
@pytest.mark.parametrize("name", list(MODELS))
def test_param_partition_spec_matches_jax(name, num_model):
    model = MODELS[name]()
    modules = dict(model.named_modules())
    sharded, wide_bn = [], 0
    for full, value in model.named_parameters():
        owner, _, leaf = full.rpartition(".")
        got = pm.param_partition_spec(modules[owner], leaf, value, num_model)
        path, jvalue = _jax_leaf(full, value)
        want = jmesh.param_partition_spec(path, jvalue, num_model)
        assert (got != ()) == (want != P()), full
        if got:
            assert got == (pm.MODEL_AXIS,) + (None,) * (value.dim() - 1), full
            assert want == P(*([None] * (jvalue.ndim - 1) + [jmesh.MODEL_AXIS])), full
            sharded.append(full)
        if isinstance(modules[owner], nn.modules.batchnorm._BatchNorm) and len(value) >= 256:
            wide_bn += 1
            assert got == (), full  # a BatchNorm scale stays replicated
    assert wide_bn > 0
    # layer 3 and layer 4 (256 and 512 outputs), SE3/SE4's up-projections and
    # the heads' 256-wide Dense layers
    assert any(".layer3." in n for n in sharded) and any(".layer4." in n for n in sharded)
    assert all(".layer1." not in n and ".layer2." not in n for n in sharded)
    heads = [n for n in sharded if "head" in n]
    assert heads == [n for n, p in model.named_parameters()
                     if "head" in n and n.endswith("weight") and p.shape[0] == 256]
    assert pm.param_partition_spec(modules[owner], leaf, value, 1) == ()


def test_make_mesh_errors_match_jax():
    """In a world of one (no process group): the JAX package's two refusals
    of ``make_mesh`` on its eight virtual devices, with the device count."""
    cases = {"model": {"num_model": 3}, "devices": {"num_data": 16}}
    for name, kw in cases.items():
        with pytest.raises(ValueError) as want:
            jmesh.make_mesh(**kw)
        with pytest.raises(ValueError) as got:
            pm.make_mesh(**kw)
        assert str(got.value) == re.sub(r"\b8\b", "1", str(want.value)), name
    assert pm.default_mesh() is None and pm.world_size() == 1 and pm.is_writer()


def test_local_batch_slice_and_shard_batch_in_a_world_of_one(tmp_path):
    jax_mesh = jmesh.make_mesh()
    assert jmesh.local_batch_slice(64, jax_mesh) == 8
    with pytest.raises(ValueError, match="not divisible by data axis 8"):
        jmesh.local_batch_slice(30, jax_mesh)
    batch = {"samples": torch.arange(60).reshape(30, 2), "stage1": torch.arange(30)}
    with world_of_one(tmp_path) as mesh:
        assert pm.axis_size(mesh, pm.DATA_AXIS) == pm.axis_size(mesh, pm.MODEL_AXIS) == 1
        assert pm.local_batch_slice(30, mesh) == 30
        rows = pm.shard_batch(batch, mesh)
        back = pm.gather_rows(rows, mesh)
        assert pm.assemble_global_batch(rows, mesh) is rows
        for key, value in batch.items():
            assert torch.equal(rows[key], value) and torch.equal(back[key], value)
        assert pm.axis_group(mesh, pm.DATA_AXIS) is None


def test_distributed_init(tmp_path, monkeypatch):
    """No address: nothing (a single-process run). An address: a group of the
    CPU's backend (gloo); the ``torchrun`` environment of a world of one
    starts nothing."""
    pm.distributed_init(None)
    monkeypatch.setenv("WORLD_SIZE", "1")
    pm.init_from_env(device="cpu")
    assert not dist.is_initialized()
    pm.distributed_init(f"file://{tmp_path / 'store'}", 1, 0, device="cpu")
    try:
        assert dist.get_backend() == "gloo" and dist.get_world_size() == 1
        pm.distributed_init("tcp://127.0.0.1:1", 1, 0)  # a second call: nothing
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def serving():
    calib = images_u16(500, 128, 16)
    models = PipelineModels(*(seeded_torch_model(cls, 501 + i, calib) for i, cls in enumerate(
        (tm.Stage1Model, tm.Stage2Model, tm.Stage3RectModel, tm.Stage3ABModel))))
    return models, images_u16(502, 100, 16)


@pytest.mark.parametrize("build", [
    lambda m, **kw: make_v6_pipeline_folded(m, STAGE1_THRESHOLD, float_dtype=torch.float32,
                                            use_fused_front=True, **kw),
    lambda m, **kw: make_v6_pipeline_gated(m, 0.5, STAGE1_THRESHOLD, **kw),
], ids=["folded_fused_front", "gated"])
def test_world_of_one_serving_equals_no_mesh(serving, build, tmp_path):
    models, images = serving
    want = run_pipeline_batched(build(models, device="cpu"), images, 64, device="cpu")
    with world_of_one(tmp_path) as mesh:
        got = run_pipeline_batched(build(models, device="cpu", mesh=mesh), images, 64,
                                   device="cpu", mesh=mesh)
    assert set(got) == set(want)
    for key, value in want.items():
        np.testing.assert_array_equal(got[key], value, err_msg=key)


def _step(model, mesh):
    opt = tsch.as_optimizer(model, tsch.adamw(1e-3))
    cfg = tt.StepConfig(loss_fn=binary_focal_loss, label_key="stage1", binary=True)
    rng = np.random.default_rng(503)
    batch = {"samples": torch.from_numpy(images_u16(504, 16, 16)),
             "stage1": torch.from_numpy(rng.integers(0, 2, 16).astype(np.int32))}
    torch.manual_seed(0)
    out = tt.make_train_step(model, opt, cfg, mesh)(tt.TrainState(model, opt), batch,
                                                    torch.Generator().manual_seed(1))
    return float(out["loss"]), model.state_dict()


def test_world_of_one_train_step_and_stage_equal_no_mesh(tmp_path):
    """A train step (dropout on) and two epochs of ``train_stage`` on a mesh
    of one process are bitwise the steps without a mesh."""
    start = seeded_torch_model(tm.Stage1Model, 505, images_u16(506, 64, 16))
    want_loss, want = _step(copy.deepcopy(start), None)
    rng = np.random.default_rng(507)

    def bundle(n):
        return Bundle(samples=images_u16(508 + n, n, 16), qps=np.full(n, 90, np.int32),
                      labels={"stage1": rng.integers(0, 2, n).astype(np.int32)})

    train, val = bundle(48), bundle(20)
    recipe = stage1_recipe(epochs=2, batch_size=16, steps_per_epoch=3)
    quiet = dict(seed=3, device="cpu", log=lambda message: None)
    stage_want = train_stage(recipe, train, val, **quiet)
    with world_of_one(tmp_path) as mesh:
        got_loss, got = _step(copy.deepcopy(start), mesh)
        stage_got = train_stage(recipe, train, val, mesh=mesh, **quiet)
    assert got_loss == want_loss
    for key, value in want.items():
        assert torch.equal(got[key], value), key
    assert [h["train_loss"] for h in stage_got.history] == [
        h["train_loss"] for h in stage_want.history]
    for key, value in stage_want.state.model.state_dict().items():
        assert torch.equal(stage_got.state.model.state_dict()[key], value), key


@pytest.mark.parametrize("layer", [
    lambda: SpatialConv(4, 6, 3, stride=2),
    lambda: nn.Conv2d(4, 6, 3, stride=2, padding=1, bias=False),
    lambda: SpatialConv(6, 6, 3, stride=2, groups=6),
    lambda: nn.Linear(5, 6),
], ids=["same_conv", "conv", "depthwise", "linear"])
def test_column_parallel_over_a_group_of_one_equals_its_layer(layer, tmp_path):
    """Its forward, its gradients and its state dict (the whole layer's)."""
    torch.manual_seed(9)
    plain = layer()
    x = torch.randn(3, 6 if plain.weight.shape[1] == 1 else plain.weight.shape[1], 8, 8)
    if isinstance(plain, nn.Linear):
        x = torch.randn(3, 5)
    with world_of_one(tmp_path) as mesh:
        sharded = pm.ColumnParallel(copy.deepcopy(plain), mesh.get_group(pm.DATA_AXIS))
        xs = x.clone().requires_grad_()
        got = sharded(xs)
        got.square().sum().backward()
        sd = sharded.state_dict()
        twin = copy.deepcopy(sharded)  # a copy shares the group
        assert twin.group is sharded.group
    xp = x.clone().requires_grad_()
    want = plain(xp)
    want.square().sum().backward()
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)
    torch.testing.assert_close(xs.grad, xp.grad, rtol=0, atol=1e-5)
    torch.testing.assert_close(sharded.weight.grad, plain.weight.grad, rtol=0, atol=1e-5)
    assert sd.keys() == plain.state_dict().keys()
    for key, value in plain.state_dict().items():
        assert torch.equal(sd[key], value), key
