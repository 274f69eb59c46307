"""Host ms a frame the port spends tiling frames into superblocks (its
``ingest.tile`` spans in the traced dispatches)."""
from portbench import program_spans


def read(summary):
    return program_spans.per_unit(summary, lambda spans, _: program_spans.total_ms(
        spans, "ingest.tile"))
