"""window_host_us: the mean microseconds of the program's span
``gft.efit_window``, the window wrapper ``kernels/efit_step.efit_window``
from entry to return (its checks, the outputs' allocation, the ctypes call
that launches K1), one a window, on the host's clock under the
profiler."""

from port_bench import program_spans


def read(trace):
    spans = program_spans.named(trace, "gft.efit_window")
    if not spans:
        return None
    return 1e6 * program_spans.seconds(spans) / len(spans)
