"""av1tpu_torch — the PyTorch/CUDA port of av1tpu for NVIDIA Hopper.

The JAX package ``av1tpu`` stays the reference; this package mirrors its
layout module by module and never imports jax or flax. It shares the
jax-free parts of ``av1tpu`` (``codec.partitions``, ``data.bundles``,
``data.records``) instead of copying them.

Layer map:
    train.checkpoint  flat npz variable files (the JAX package's format)
    models            nn.Module v6 stage models + FGVC, and the JAX weight bridge
    quant.ptq         BN folding and the folded float forward
    kernels           hand-written CUDA kernels (csrc/) with their plain twins
    eval              pipelines, batching, metrics, report writers
    cli               run_pipeline_eval
"""

__version__ = "0.1.0"
