"""Host ms a frame inside the cascade's call (``cascade``) but outside its
upload and level loop (``cascade.upload``, ``cascade.level``): argument
checks, the remap table and the trees' assembly."""
from portbench import program_spans


def read(summary):
    return program_spans.per_unit(summary, lambda spans, _: program_spans.self_ms(
        spans, "cascade", ("cascade.upload", "cascade.level")))
