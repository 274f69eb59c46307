"""K2's share of its roofline over its calls in the traced dispatches."""
from portbench import readers


def read(summary):
    return readers.roofline(summary, "K2")
