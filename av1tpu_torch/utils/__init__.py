"""Seeded host initialization (``utils.initialization``) and the port's
tracing: profiler capture, its own spans and device memory
(``utils.profiling``)."""
from av1tpu_torch.utils.initialization import init_on_cpu  # noqa: F401
from av1tpu_torch.utils.profiling import (  # noqa: F401
    device_memory_stats,
    span,
    spans,
    trace,
)
