"""The consumer's ms a batch blocked on the producer's queue
(``batching.wait``)."""
from portbench import program_spans


def read(summary):
    return program_spans.per_unit(summary, lambda spans, _: program_spans.total_ms(
        spans, "batching.wait"))
