"""The benchmark of the PyTorch and CUDA port (``av1tpu_torch``): run one
cell with ``python3 -m portbench --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` from the root of a checkout. See ``portbench/README.md``."""
