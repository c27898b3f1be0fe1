"""loop_host_us: the host loop's microseconds a window: the program's
span ``gft.solver.run`` (``Solver.run``) less the ``gft.efit_window``
spans inside it, its self time, over those windows."""

from port_bench import program_spans


def read(trace):
    windows = program_spans.named(trace, "gft.efit_window")
    own, count = 0.0, 0
    for run in program_spans.named(trace, "gft.solver.run"):
        inside = program_spans.within(windows, [run])
        own += (run[1] - run[0]) - program_spans.seconds(inside)
        count += len(inside)
    return 1e6 * own / count if count else None
