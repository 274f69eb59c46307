"""av1tpu_torch — the PyTorch/CUDA port of av1tpu for NVIDIA Hopper.

The JAX package ``av1tpu`` stays the reference; this package mirrors its
layout module by module and imports nothing of it, nor jax or flax. What it
needs of the jax-free modules of ``av1tpu`` it keeps as its own copies, under
the same names: ``codec.partitions``, ``data.bundles`` and ``data.records``.

Layer map:
    codec.partitions  partition ids, names and the label maps (numpy)
    data              split bundles (npz + metadata.json) and the sample norm
    train.checkpoint  flat npz variable files (the JAX package's format)
    models            nn.Module v6 stage models + FGVC, and the JAX weight bridge
    quant.ptq         BN folding and the folded float forward
    kernels           hand-written CUDA kernels (csrc/) with their plain twins
    eval              pipelines, batching, metrics, report writers
    cli               run_pipeline_eval
"""

__version__ = "0.1.0"
