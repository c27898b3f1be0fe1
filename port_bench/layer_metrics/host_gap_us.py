"""host_gap_us: microseconds a K1 launch in which the card sat idle inside
the benchmark's spans around ``Solver.run`` (the host loop and the window
wrapper ``kernels/efit_step.efit_window``): the idle time inside the spans,
from the profiler's timeline, over the K1 launches the port's counter
``efit_window_launches`` counted."""

from port_bench import profiling


def read(trace):
    return profiling.idle_per_launch(trace, "Solver.run", "k1_launches")
