"""Host ms a frame (``.blocks``: a batch) inside the batching layer's calls
of the level predictors (``batching.predict``): the launch chain. Over
``launches_per_frame`` (``_per_batch``) it is the host's time a launch."""
from portbench import program_spans


def read(summary):
    return program_spans.per_unit(summary, lambda spans, _: program_spans.total_ms(
        spans, "batching.predict"))
