"""k4_roofline: K4's share of its roofline, in %: the least time a launch
over the cell's rays and modes can take (K4's operation count over the f32
peak, or its bytes over the HBM rate, the larger;
``counts_vmec.jet_bound_s``) over the mean device time of the kernels named
``vmec_geom_kernel``; nothing where the trace holds none."""

import sys

from port_bench import counts_vmec, profiling


def read(trace):
    mean = profiling.kernel_mean_s(trace, "vmec_geom_kernel")
    info = trace.info
    if mean is None or "modes" not in info:
        return None
    bound, by = counts_vmec.jet_bound_s(info["rays"], info["modes"],
                                        info["table_bytes"])
    print(f"K4 bound by {by}, {bound * 1e3:.6f} ms a launch against "
          f"{mean * 1e3:.6f} ms measured", file=sys.stderr)
    return 100.0 * bound / mean
