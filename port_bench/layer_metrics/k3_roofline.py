"""k3_roofline: K3's share of its roofline, in %: the least time a
window of the batch's rays can take (the frozen operation count of K3 rk4
over the f32 peak, or the bytes over the HBM rate, the larger;
``counts.window_bound_s``) over K3's mean device time by name in the
traced units.  Config 5's backward runs K3 alone (no K2), which the
counters confirm."""

from port_bench import profiling


def read(trace):
    if trace.counters.get("k2_launches"):
        return None
    return profiling.roofline_share(trace, "k3", "efit_window_bwd_kernel")
