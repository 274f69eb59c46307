"""The cascade's valid-tap operations per second over the bf16 peak."""
from portbench import readers


def read(summary):
    return readers.mfu(summary)
