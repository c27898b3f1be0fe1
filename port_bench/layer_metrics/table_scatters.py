"""table_scatters: the spline tables' gradient scatters a unit, the
program's spans ``gft.table_scatter`` (one a launch of its
``table_scatter_kernel``) counted; nothing where the program has no such
span (a program from before the kernel)."""

from port_bench import program_spans

SPAN = "gft.table_scatter"


def read(trace):
    if not program_spans.named(trace, SPAN):
        return None
    return program_spans.count_per_unit(trace, SPAN)
