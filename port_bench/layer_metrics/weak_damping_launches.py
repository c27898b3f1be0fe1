"""weak_damping_launches: the weak damping kernel's launches a unit, the
program's spans ``gft.weak_damping.kernel`` (one a launch of K9, forward
or VJP) counted; nothing where the program has no such span (a program
from before the kernel)."""

from port_bench import program_spans

SPAN = "gft.weak_damping.kernel"


def read(trace):
    if not program_spans.named(trace, SPAN):
        return None
    return program_spans.count_per_unit(trace, SPAN)
