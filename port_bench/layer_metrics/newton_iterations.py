"""newton_iterations: Newton's iterations a unit, the program's spans
``gft.newton.iteration`` (one an iteration of ``ops/newton``, each with
its readback) counted."""

from port_bench import program_spans


def read(trace):
    return program_spans.count_per_unit(trace, "gft.newton.iteration")
