"""device_idle: the share of the traced window, in %, in which no device
operation ran (1 - the union of device activity over the window's wall),
whatever the cell's units are."""

from port_bench import profiling


def read(trace):
    return profiling.idle_share(trace)
