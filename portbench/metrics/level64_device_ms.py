"""The compute stream's ms a frame between the two markers of the cascade's
64 px level (its ``cascade.level`` spans with ``px`` 64)."""
from portbench import program_spans


def read(summary):
    return program_spans.per_unit(summary, lambda spans, _: program_spans.device_ms(
        spans, "cascade.level", px=64))
