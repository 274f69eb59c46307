"""Multi-device execution on ``torch.distributed``: the ``(data, model)``
mesh, batch and parameter sharding, multi-process initialization
(:mod:`av1tpu_torch.parallel.mesh`)."""
from av1tpu_torch.parallel.mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    ColumnParallel,
    assemble_global_batch,
    data_parallel,
    default_mesh,
    distributed_init,
    gather_rows,
    init_from_env,
    is_writer,
    local_batch_slice,
    make_mesh,
    param_partition_spec,
    place_params,
    shard_batch,
    shard_params,
)

__all__ = [
    "ColumnParallel",
    "DATA_AXIS",
    "MODEL_AXIS",
    "assemble_global_batch",
    "data_parallel",
    "default_mesh",
    "distributed_init",
    "gather_rows",
    "init_from_env",
    "is_writer",
    "local_batch_slice",
    "make_mesh",
    "param_partition_spec",
    "place_params",
    "shard_batch",
    "shard_params",
]
