"""absorption_s: seconds of the xrays program's phase 2 (the
weak-damping kamp of every recorded row, models/absorption), the
program's own timer ``timings["absorption_s"]``, averaged over the traced
units."""


def read(trace):
    return trace.timings.get("absorption_s")
