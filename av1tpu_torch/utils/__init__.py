"""Tracing and throughput observability of the port (``utils.profiling``)."""
from av1tpu_torch.utils.profiling import (  # noqa: F401
    ThroughputMeter,
    annotate,
    device_memory_stats,
    trace,
)
