"""trace_write_s: seconds of the xrays program's phase 1 (the trace
and the writer thread that drains its rows into the store), the program's
own timer ``timings["trace_s"]`` (a host clock that ends once the writer
has drained), averaged over the traced units."""


def read(trace):
    return trace.timings.get("trace_s")
