"""absorption_read_s: seconds a unit in which the xrays program's phase 2
read its rows: the program's span ``gft.absorption.read_row`` (a row's
read from the store and its copy to the device), summed."""

from port_bench import program_spans


def read(trace):
    return program_spans.seconds_per_unit(trace,
                                          ("gft.absorption.read_row",))
