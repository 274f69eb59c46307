"""Host ms a call into the cascade takes until it returns with its work
enqueued (median over the untraced dispatches of a traced run): the host's
launch chain."""
from portbench import readers


def read(summary):
    return readers.cascade_host_ms(summary)
