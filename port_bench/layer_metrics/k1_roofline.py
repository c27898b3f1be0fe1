"""k1_roofline: K1's share of its roofline, in %: the least time a window
of the rays can take (K1's frozen operation count over the f32 peak, or
the bytes over the HBM rate, the larger; ``counts.window_bound_s``) over
K1's mean device time by name."""

from port_bench import profiling


def read(trace):
    return profiling.roofline_share(trace, "k1", "efit_window_kernel")
