"""av1tpu_torch — the PyTorch/CUDA port of av1tpu for NVIDIA Hopper.

The JAX package ``av1tpu`` stays the reference; this package mirrors its
layout module by module and imports nothing of it, nor jax or flax. What it
needs of the jax-free modules of ``av1tpu`` it keeps as its own copies, under
the same names: ``codec.partitions``, ``codec.tree``, ``data.bundles``,
``data.records``, ``data.sampling``, ``data.synth``, ``ingest.yuv``,
``ingest.tiler``, ``eval.tree_metrics`` and ``models.torch_import``.

Layer map:
    codec.partitions  partition ids, names and the label maps (numpy)
    codec.tree        (N, 85) partition-tree assembly (numpy or torch)
    ingest            yuv420p10le luma reading and superblock tiling (numpy)
    data              block records, split bundles (npz + metadata.json) and
                      their label views, epoch sampling, the synthetic corpus
    train             the stage trainer (train_stage, recipes, the train
                      step, resident and streaming epochs), losses, schedules
                      and the partitioned AdamW, augmentations (and the TTA
                      views), verified checkpoints and the npz variable files
    models            nn.Module v6 stage models, UnifiedV6Model, FGVC, the v5
                      HierarchicalModel (models.v5), the flatten and adapter
                      models, the JAX weight bridge (models.jax_import) and
                      the reference .pt import (models.torch_import)
    quant.ptq         BN folding, the folded float forward and int8 serving
    kernels           hand-written CUDA kernels (csrc/) with their plain twins
    parallel          the (data, model) mesh on torch.distributed: batch and
                      parameter sharding, the collectives of a data- or
                      model-sharded step, multi-process initialization (one
                      process per device; the JAX NamedSharding objects
                      batch_sharding and replicated have no torch meaning)
    eval              per-stage, unified, gated, v5 and flatten pipelines,
                      batching, ensembles, the 64->32->16->8 tree cascade,
                      metrics, report writers
    cli               run_pipeline_eval (v6, unified, v5, flatten),
                      predict_trees, the operating-point tools, the trainers
                      and the data tools; under torchrun every serving CLI
                      shards over the processes (--single-device keeps one)
                      and every trainer takes --num-model-shards
"""

from av1tpu_torch import parallel

__version__ = "0.1.0"
__all__ = ["parallel"]
