"""Host ms a frame the cascade spends making its superblocks contiguous and
copying them to the card (its ``cascade.upload`` spans)."""
from portbench import program_spans


def read(summary):
    return program_spans.per_unit(summary, lambda spans, _: program_spans.total_ms(
        spans, "cascade.upload"))
