"""Device mesh and sharding rules on ``torch.distributed``.

Counterpart of ``av1tpu.parallel.mesh``: a 2-D ``(data, model)`` mesh over
the world, the batch and parameter sharding rules, and multi-host
initialization. PyTorch runs one process per device (``torchrun``, or
``WORLD_SIZE`` / ``RANK`` / ``MASTER_ADDR`` / ``MASTER_PORT`` set by hand), so
a mesh is a ``DeviceMesh`` over the world's ranks and every collective is
written out where XLA's GSPMD inserted one:

  * **data parallelism** gives each rank of the data axis its contiguous
    slice of every global batch. Serving gathers the outputs over the data
    group, so that every rank returns the whole result, as the JAX package
    replicates them. Training all-reduces the gradients (their mean over the
    data group) after ``backward``; inside :func:`data_parallel` the BatchNorm
    statistics and the losses that reduce over the batch by something other
    than its row count reduce over the global batch (``models.layers``,
    ``train.losses``), so that a run equals one process on the same global
    batches.
  * **model parallelism** (``model > 1``) shards the output channels of the
    wide ``Conv2d`` and ``Linear`` layers over the model axis
    (:func:`param_partition_spec`): :func:`place_params` replaces each such
    layer by a :class:`ColumnParallel` that keeps this rank's rows of the
    weight, computes its share of the output channels and all-gathers them.

The collectives are ``all_reduce``, ``all_gather`` and ``broadcast`` only,
which gloo also runs on CUDA tensors (two ranks sharing one card).

``batch_sharding`` and ``replicated`` (JAX ``NamedSharding`` objects) have no
torch meaning: a rank holds its rows of a batch as a plain tensor, and a
replicated value is one that every rank holds. They are not ported.
"""
from __future__ import annotations

import contextlib
import contextvars
import datetime
import os
from typing import Dict, Iterator, Mapping, Optional, Tuple

import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

DATA_AXIS = "data"
MODEL_AXIS = "model"


def world_size() -> int:
    """Processes in the default group (1 when none is initialized)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def is_writer() -> bool:
    """Whether this process writes a run's files and prints its results:
    rank 0, or the only process."""
    return not dist.is_initialized() or dist.get_rank() == 0


def make_mesh(num_data: Optional[int] = None, num_model: int = 1,
              device_type: Optional[str] = None) -> DeviceMesh:
    """A ``(data, model)`` ``DeviceMesh`` over the world's ranks.

    ``num_data=None`` uses every rank divided by ``num_model``. Ranks fill
    the model axis first, so that a model group is ranks ``k * model`` to
    ``(k + 1) * model - 1``. ``device_type`` defaults to ``"cuda"`` where
    there is a card, else ``"cpu"``. The world must be initialized
    (:func:`distributed_init`) unless the errors below apply."""
    world = world_size()
    if num_data is None:
        if world % num_model:
            raise ValueError(f"{world} devices not divisible by model={num_model}")
        num_data = world // num_model
    needed = num_data * num_model
    if needed > world:
        raise ValueError(f"need {needed} devices, have {world}")
    if needed != world:
        raise ValueError(f"a torch mesh spans the whole world: {needed} of {world} ranks")
    if device_type is None:
        device_type = "cuda" if torch.cuda.is_available() else "cpu"
    return init_device_mesh(device_type, (num_data, num_model),
                            mesh_dim_names=(DATA_AXIS, MODEL_AXIS))


def default_mesh(min_devices: int = 2) -> Optional[DeviceMesh]:
    """Data-parallel mesh over the whole world, or ``None`` in a world of
    fewer than ``min_devices`` ranks (the serving CLIs' default)."""
    world = world_size()
    if world < min_devices:
        return None
    return make_mesh(num_data=world, num_model=1)


def axis_size(mesh: Optional[DeviceMesh], axis: str) -> int:
    """The mesh's extent along ``axis`` (1 without a mesh)."""
    if mesh is None:
        return 1
    return int(mesh.size(mesh.mesh_dim_names.index(axis)))


def axis_index(mesh: Optional[DeviceMesh], axis: str) -> int:
    """This rank's coordinate along ``axis`` (0 without a mesh)."""
    return 0 if mesh is None else int(mesh.get_local_rank(axis))


def axis_group(mesh: Optional[DeviceMesh], axis: str):
    """The process group along ``axis`` through this rank, or ``None`` when
    the axis has one rank (nothing to reduce over)."""
    if axis_size(mesh, axis) == 1:
        return None
    return mesh.get_group(axis)


def local_batch_slice(global_batch: int, mesh: DeviceMesh) -> int:
    """Per-rank share of a global batch under the data axis."""
    num_data = axis_size(mesh, DATA_AXIS)
    if global_batch % num_data:
        raise ValueError(
            f"global batch {global_batch} not divisible by data axis {num_data}"
        )
    return global_batch // num_data


def _map(batch, fn):
    if isinstance(batch, Mapping):
        return {k: fn(v) for k, v in batch.items()}
    return fn(batch)


def shard_batch(batch, mesh: DeviceMesh):
    """This rank's contiguous rows of a global batch (a tensor, an array or
    a dict of them): rows ``d * b`` to ``(d + 1) * b`` at data coordinate
    ``d``, ``b`` the local batch."""
    d = axis_index(mesh, DATA_AXIS)

    def rows(x):
        b = local_batch_slice(x.shape[0], mesh)
        return x[d * b:(d + 1) * b]

    return _map(batch, rows)


def assemble_global_batch(local_batch, mesh: DeviceMesh):
    """The global batch from this rank's local rows. In torch a rank holds
    its shard of a global batch as it is, so the local rows are returned
    unchanged: the JAX package assembles one global array from them,
    the port's steps gather what they need over the data group
    (:func:`gather_rows`)."""
    return local_batch


def gather_group(t: torch.Tensor, group) -> torch.Tensor:
    """The rows of ``t`` from every rank of ``group``, concatenated in rank
    order (``t`` itself when ``group`` is None). No gradient. The rows
    travel as their bytes, so that every dtype goes through gloo (which
    has no int16 or uint16 collectives) unchanged, bit for bit."""
    if group is None:
        return t
    rows = t.detach().contiguous()
    flat = rows.reshape(rows.shape[0], -1).view(torch.uint8)
    parts = [torch.empty_like(flat) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, flat, group=group)
    return torch.cat(parts).view(t.dtype).reshape((-1,) + tuple(t.shape[1:]))


def gather_rows(batch, mesh: DeviceMesh):
    """The global batch put back together from every data rank's rows (a
    tensor or a dict of tensors): the inverse of :func:`shard_batch`."""
    group = axis_group(mesh, DATA_AXIS)
    return _map(batch, lambda t: gather_group(t, group))


def local_rows(t: torch.Tensor, group) -> torch.Tensor:
    """This rank's contiguous rows of a tensor that holds the rows of every
    rank of ``group`` (``t`` itself when ``group`` is None)."""
    if group is None:
        return t
    n = dist.get_world_size(group)
    b = t.shape[0] // n
    r = dist.get_rank(group)
    return t[r * b:(r + 1) * b]


class _AllReduceSum(torch.autograd.Function):
    """The sum over a group, forward and backward: every rank's copy of the
    sum depends on every rank's input, so each input's gradient is the sum of
    the copies' gradients (``torch.distributed.nn.functional.all_reduce``,
    which is deprecated)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        x = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, grad):
        return _AllReduceSum.apply(grad, ctx.group), None


def all_reduce_sum(t: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``t`` over ``group``, differentiable (the gradient of every
    rank's copy is summed back to each input), ``t`` when ``group`` is None."""
    if group is None:
        return t
    return _AllReduceSum.apply(t, group)


def barrier(device) -> None:
    """Wait until every rank gets here: an all-reduce of one element on
    ``device`` (a collective that every backend runs on every device)."""
    if world_size() > 1:
        dist.all_reduce(torch.zeros(1, device=device))


# ---------------------------------------------------------------------------
# Reductions over the global batch inside a data-parallel step
# ---------------------------------------------------------------------------

_DATA_GROUP: contextvars.ContextVar = contextvars.ContextVar("data_group", default=None)


@contextlib.contextmanager
def data_parallel(mesh: Optional[DeviceMesh]) -> Iterator[None]:
    """Within the block, the BatchNorm train statistics, the masked means
    and the batch-wise choices of the losses (hard negatives, mixing
    partners) reduce over ``mesh``'s data group: the global batch. Without a
    mesh, or with one data rank, the block changes nothing."""
    token = _DATA_GROUP.set(axis_group(mesh, DATA_AXIS))
    try:
        yield
    finally:
        _DATA_GROUP.reset(token)


def current_data_group():
    """The data group of the enclosing :func:`data_parallel` block, or None."""
    return _DATA_GROUP.get()


def global_sum(t: torch.Tensor) -> torch.Tensor:
    """``t.sum()`` over the global batch: differentiable under a data group."""
    return all_reduce_sum(t.sum(), current_data_group())


def global_rows(t: torch.Tensor) -> torch.Tensor:
    """``t``'s rows from every data rank, in rank order (no gradient)."""
    return gather_group(t, current_data_group())


def own_rows(t: torch.Tensor) -> torch.Tensor:
    """This rank's rows of a tensor over the global batch."""
    return local_rows(t, current_data_group())


def sync_gradients(params, mesh: Optional[DeviceMesh]) -> None:
    """Each parameter's gradient replaced by its mean over the data group
    (one all-reduce of the concatenated gradients). A parameter the loss
    did not reach counts as a zero gradient, as in ``TrainOptimizer.step``."""
    group = axis_group(mesh, DATA_AXIS)
    if group is None:
        return
    params = list(params)
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    flat = torch.cat([p.grad.reshape(-1) for p in params])
    dist.all_reduce(flat, group=group)
    flat /= dist.get_world_size(group)
    offset = 0
    for p in params:
        n = p.numel()
        p.grad.copy_(flat[offset:offset + n].view_as(p.grad))
        offset += n


# ---------------------------------------------------------------------------
# Model parallelism: column-parallel Conv2d and Linear layers
# ---------------------------------------------------------------------------

def param_partition_spec(module: nn.Module, name: str, value, num_model: int,
                         min_shard_dim: int = 256) -> Tuple:
    """Sharding rule for parameter ``name`` of ``module``, as a partition
    spec over its dims: ``()`` replicated, ``(MODEL_AXIS, None, ...)`` its
    output dim over the model axis.

    With ``num_model == 1`` everything is replicated. Otherwise the weight
    of a ``Conv2d`` or ``Linear`` whose output dim (dim 0 in torch, the last
    dim of the flax kernel) is at least ``min_shard_dim`` and divisible by
    ``num_model`` is sharded on it (column parallel); every other parameter,
    biases and BatchNorm scales (which torch also names ``weight``)
    included, is replicated. The module type decides, never the name alone."""
    if num_model <= 1 or name != "weight":
        return ()
    if not isinstance(module, (nn.Conv2d, nn.Linear, ColumnParallel)):
        return ()
    shape = tuple(getattr(value, "shape", ()))
    if isinstance(module, ColumnParallel):
        shape = (module.out_features,) + shape[1:]
    if not shape or shape[0] < min_shard_dim or shape[0] % num_model:
        return ()
    if isinstance(module, nn.Conv2d) and module.groups not in (1, module.in_channels):
        return ()  # grouped convs other than depthwise are not in this model family
    return (MODEL_AXIS,) + (None,) * (len(shape) - 1)


def shard_params(model: nn.Module, mesh: DeviceMesh) -> Dict[str, Tuple]:
    """The partition spec of every parameter of ``model``, by its name."""
    num_model = axis_size(mesh, MODEL_AXIS)
    modules = dict(model.named_modules())
    specs = {}
    for full, value in model.named_parameters():
        owner, _, name = full.rpartition(".")
        specs[full] = param_partition_spec(modules[owner], name, value, num_model)
    return specs


class _Shared:
    """A reference that copies share: a process group cannot be copied, and a
    copy of a sharded model computes over the same group."""

    def __init__(self, value):
        self.value = value

    def __deepcopy__(self, memo):
        return self


class _CopyToGroup(torch.autograd.Function):
    """Identity forward; the input's gradient summed over the model group
    (each rank's share of the output channels contributes to it)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        # a copy: autograd may hand the same gradient tensor to other nodes
        grad = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _GatherFromGroup(torch.autograd.Function):
    """All-gather along ``dim`` forward; backward keeps this rank's slice of
    the gradient. The computation after the gather is replicated over the
    model group, so every rank holds the same gradient of the gathered
    tensor. (``torch.distributed.nn.functional.all_gather`` sums the
    ranks' gradients instead, ``model`` times this one, and with gloo goes
    through ``scatter``, which is not among the collectives used here.)"""

    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, x, group=group)
        return torch.cat(parts, dim=dim)

    @staticmethod
    def backward(ctx, grad):
        # a copy, not a view: autograd may accumulate into the incoming
        # gradient in place while this slice is still to be read
        n = dist.get_world_size(ctx.group)
        own = grad.chunk(n, dim=ctx.dim)[dist.get_rank(ctx.group)]
        return own.clone(memory_format=torch.contiguous_format), None, None


class ColumnParallel(nn.Module):
    """A ``Conv2d`` (plain, ``SpatialConv`` "SAME" or depthwise) or ``Linear``
    whose output channels are split over a model group: this rank keeps rows
    ``r * k`` to ``(r + 1) * k`` of ``weight`` (``k = out / model``), computes
    those channels and all-gathers them; the bias, replicated, is added
    after the gather. ``state_dict`` returns the whole weight (a collective
    over the group) and ``load_state_dict`` takes a whole one, so that
    checkpoints and ``variables_of`` see the unsharded layer."""

    def __init__(self, layer: nn.Module, group):
        from av1tpu_torch.models.layers import SpatialConv  # layers imports this module

        super().__init__()
        n, r = dist.get_world_size(group), dist.get_rank(group)
        self.out_features = int(layer.weight.shape[0])
        k = self.out_features // n
        self.rows = (r * k, (r + 1) * k)
        self._group = _Shared(group)
        self.kind = "linear" if isinstance(layer, nn.Linear) else "conv"
        if self.kind == "conv":
            self.same = isinstance(layer, SpatialConv)
            self.stride, self.padding = layer.stride, layer.padding
            self.dilation = layer.dilation
            self.depthwise = layer.groups != 1
            self.kernel_size = layer.kernel_size
        self.weight = nn.Parameter(layer.weight.detach()[self.rows[0]:self.rows[1]].clone())
        self.bias = (None if layer.bias is None
                     else nn.Parameter(layer.bias.detach().clone()))
        self.weight.column_parallel = self
        self._register_state_dict_hook(ColumnParallel._full_weight)
        self._register_load_state_dict_pre_hook(ColumnParallel._own_rows, with_module=True)

    @property
    def group(self):
        return self._group.value

    def full(self, t: torch.Tensor) -> torch.Tensor:
        """A tensor of this rank's rows (the weight, or an optimizer moment
        of it) gathered into the whole layer's (no gradient)."""
        return gather_group(t.detach(), self.group)

    def own(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's rows of a whole-layer tensor."""
        return t[self.rows[0]:self.rows[1]]

    @staticmethod
    def _full_weight(module, state_dict, prefix, local_metadata):
        key = prefix + "weight"
        state_dict[key] = module.full(state_dict[key])
        return state_dict

    def _own_rows(self, state_dict, prefix, local_metadata, strict, missing, unexpected,
                  errors):
        key = prefix + "weight"
        if key in state_dict and state_dict[key].shape[0] == self.out_features:
            state_dict[key] = self.own(state_dict[key])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = _CopyToGroup.apply(x, self.group)
        if self.kind == "linear":
            y = torch.nn.functional.linear(x, self.weight)
            dim = -1
        else:
            groups = 1
            if self.depthwise:  # each output channel reads its own input channel
                x = x[:, self.rows[0]:self.rows[1]]
                groups = self.rows[1] - self.rows[0]
            if self.same:
                from av1tpu_torch.models.layers import pad_same

                x = pad_same(x, self.kernel_size[0], self.stride[0])
                padding = 0
            else:
                padding = self.padding
            y = torch.nn.functional.conv2d(x, self.weight, None, self.stride, padding,
                                           self.dilation, groups)
            dim = 1
        y = _GatherFromGroup.apply(y, self.group, dim)
        if self.bias is None:
            return y
        shape = (-1,) if dim == -1 else (1, -1, 1, 1)
        return y + self.bias.view(shape)


def place_params(model: nn.Module, mesh: DeviceMesh) -> nn.Module:
    """Shard ``model`` in place by :func:`shard_params`: each layer with a
    sharded weight becomes a :class:`ColumnParallel` over the mesh's model
    group, under the same name. With one model rank nothing changes."""
    group = axis_group(mesh, MODEL_AXIS)
    if group is None:
        return model
    specs = shard_params(model, mesh)
    for full, spec in specs.items():
        if not spec:
            continue
        owner = full.rpartition(".")[0]
        parent_name, _, child = owner.rpartition(".")
        parent = model.get_submodule(parent_name) if parent_name else model
        layer = getattr(parent, child)
        if not isinstance(layer, ColumnParallel):
            setattr(parent, child, ColumnParallel(layer, group))
    return model


def column_parallel_of(p: torch.Tensor) -> Optional[ColumnParallel]:
    """The :class:`ColumnParallel` whose rows ``p`` holds, or None."""
    return getattr(p, "column_parallel", None)


def distributed_init(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     backend: Optional[str] = None,
                     device: Optional[str] = None) -> None:
    """Multi-process initialization; nothing for a single-process run (no
    address). ``coordinator_address`` is ``host:port`` (or a full
    ``tcp://`` / ``file://`` init method); ``backend`` defaults to ``nccl``
    for a CUDA ``device`` and ``gloo`` for the CPU (``device`` defaults to
    the card where there is one)."""
    if coordinator_address is None or dist.is_initialized():
        return
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    if backend is None:
        backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    method = (coordinator_address if "://" in coordinator_address
              else f"tcp://{coordinator_address}")
    if torch.device(device).type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", process_id or 0))
        torch.cuda.set_device(local % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=method, world_size=num_processes,
                            rank=process_id, timeout=datetime.timedelta(minutes=10))


def init_from_env(device: Optional[str] = None, backend: Optional[str] = None) -> None:
    """:func:`distributed_init` from the ``torchrun`` environment
    (``WORLD_SIZE``, ``RANK``, ``MASTER_ADDR``, ``MASTER_PORT``); nothing in
    a world of one, or when a group already exists."""
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world <= 1 or dist.is_initialized():
        return
    address = f"{os.environ.get('MASTER_ADDR', 'localhost')}:{os.environ['MASTER_PORT']}"
    distributed_init(address, world, int(os.environ["RANK"]), backend=backend,
                     device=device)


__all__ = [
    "ColumnParallel",
    "DATA_AXIS",
    "MODEL_AXIS",
    "all_reduce_sum",
    "assemble_global_batch",
    "axis_group",
    "axis_index",
    "axis_size",
    "barrier",
    "column_parallel_of",
    "current_data_group",
    "data_parallel",
    "default_mesh",
    "distributed_init",
    "gather_group",
    "gather_rows",
    "global_rows",
    "global_sum",
    "init_from_env",
    "is_writer",
    "local_batch_slice",
    "local_rows",
    "make_mesh",
    "own_rows",
    "param_partition_spec",
    "place_params",
    "shard_batch",
    "shard_params",
    "sync_gradients",
    "world_size",
]
