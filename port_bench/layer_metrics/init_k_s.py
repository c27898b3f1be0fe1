"""init_k_s: seconds a unit of the xrays program's Newton init of kx, the
program's span ``gft.xrays.init_k`` (``init_s`` of its timings)."""

from port_bench import program_spans


def read(trace):
    return program_spans.seconds_per_unit(trace, ("gft.xrays.init_k",))
