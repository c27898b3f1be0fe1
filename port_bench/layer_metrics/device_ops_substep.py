"""device_ops_substep: the device operations a substep of the traced
traces: the operations that start inside the benchmark's ``Solver.run``
spans, over the substeps those runs took (``trace.info
["substeps_per_run"]`` a span).  The host dispatches them one by one, so
their count sets the pace of a trace whose device mostly waits; a launch
still queued when its span ends is left out (a few a run)."""

import bisect


def read(trace):
    runs = trace.spans.get("Solver.run")
    per_run = trace.info.get("substeps_per_run")
    if not runs or not per_run or not trace.device:
        return None
    starts = [s for _, s, _ in trace.device]
    inside = sum(bisect.bisect_right(starts, hi) - bisect.bisect_left(
        starts, lo) for lo, hi in runs)
    return inside / (len(runs) * per_run)
