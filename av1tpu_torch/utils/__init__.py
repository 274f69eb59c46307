"""Seeded host initialization (``utils.initialization``) and the port's
tracing and throughput observability (``utils.profiling``)."""
from av1tpu_torch.utils.initialization import init_on_cpu  # noqa: F401
from av1tpu_torch.utils.profiling import (  # noqa: F401
    ThroughputMeter,
    annotate,
    device_memory_stats,
    trace,
)
