"""Device idle ms a frame (``.blocks``: a batch) while the innermost program
span on the calling thread is ``batching.predict``: the card waiting on the
launch chain (copies and fills count as idle)."""
from portbench import program_spans


def read(summary):
    return program_spans.per_unit(summary, lambda spans, trace: program_spans.idle_ms(
        spans, trace["kernels"], "batching.predict"))
