"""Device kernels in the traced passes over their batches."""
from portbench import readers


def read(summary):
    return readers.launches(summary, "batches")
