"""Device kernels in the traced dispatches over their frames."""
from portbench import readers


def read(summary):
    return readers.launches(summary, "frames")
