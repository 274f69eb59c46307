"""The traced window's share in which no operation ran on the device."""
from portbench import readers


def read(summary):
    return readers.idle_share(summary)
