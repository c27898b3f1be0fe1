"""rhs_host_us: the mean microseconds of the program's span
``gft.ray_rhs``, one evaluation of the eager ray right-hand side
(``models/rays.make_ray_rhs``: the geometry, D and its ``autograd.grad``
pass) from entry to return, on the host's clock under the profiler."""

from port_bench import program_spans


def read(trace):
    spans = program_spans.named(trace, "gft.ray_rhs")
    if not spans:
        return None
    return 1e6 * program_spans.seconds(spans) / len(spans)
