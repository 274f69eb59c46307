"""The producer's host ms a batch staging (``batching.stage``: slice, copy
into pinned memory, copy issued), less its waits for a pinned buffer
(``batching.ring_wait``: back-pressure, not staging work)."""
from portbench import program_spans


def read(summary):
    return program_spans.per_unit(summary, lambda spans, _: program_spans.self_ms(
        spans, "batching.stage", ("batching.ring_wait",)))
