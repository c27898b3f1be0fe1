"""table_grad_ms: device milliseconds a unit in the spline tables' gradient
scatter, the transpose of the gathers that config 5's weak damping
differentiates: the operations whose name holds the program's kernel
``table_scatter_kernel`` (``csrc/table_scatter.cu``) or the library's
``indexing_backward_kernel`` (``index_put_`` with accumulate, the
program's path before that kernel), summed over the traced units."""

from port_bench import program_spans

KERNELS = ("table_scatter_kernel", "indexing_backward_kernel")


def read(trace):
    units = program_spans.units(trace)
    times = [e - s for n, s, e in trace.device
             if any(k in n for k in KERNELS)]
    if not units or not times:
        return None
    return 1e3 * sum(times) / units
