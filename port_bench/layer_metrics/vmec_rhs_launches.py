"""vmec_rhs_launches: the VMEC ray RHS kernel's launches a unit, the
program's spans ``gft.vmec_rhs`` (one a launch of its ``vmec_rhs_kernel``)
counted; nothing where the program has no such span (a program from before
the kernel)."""

from port_bench import program_spans

SPAN = "gft.vmec_rhs"


def read(trace):
    if not program_spans.named(trace, SPAN):
        return None
    return program_spans.count_per_unit(trace, SPAN)
