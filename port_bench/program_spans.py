"""The program's own spans in a traced window: what the readers of the
``program_span`` and ``program_counter`` metrics take.

The port marks its layer boundaries with spans named ``gft.<layer>...``
(its ``telemetry`` module); while the profiler records, each enters the
trace's host timeline as a record-function range, on the clock of the
device's operations.  :func:`profiling.collect` keeps every host event in
``trace.host``, so they are there as (name, start, end) in seconds.  A
program that has no such spans gives the readers nothing: each then
returns None.
"""

from __future__ import annotations

import bisect

PREFIX = "gft."
#: The harness's span around each traced unit.
UNIT = "bench.unit"


def named(trace, name):
    """The (start, end) of every host event called ``name``, by start."""
    return [(s, e) for n, s, e in trace.host if n == name]


def has_spans(trace):
    """Whether the traced program marks its layers with spans at all."""
    return any(n.startswith(PREFIX) for n, _, _ in trace.host)


def units(trace):
    """The units the traced window ran."""
    return len(named(trace, UNIT))


def within(inner, outer):
    """The intervals of ``inner`` (sorted by start) that lie inside some
    interval of ``outer``."""
    starts = [s for s, _ in inner]
    out = []
    for lo, hi in outer:
        i = bisect.bisect_left(starts, lo)
        while i < len(inner) and inner[i][0] <= hi:
            if inner[i][1] <= hi:
                out.append(inner[i])
            i += 1
    return out


def seconds(intervals):
    return sum(e - s for s, e in intervals)


def seconds_per_unit(trace, names, inside=None):
    """Seconds a unit in the spans ``names`` (those inside the spans
    ``inside``, when given); None where the program has no spans, the
    window no unit, or ``inside`` no span."""
    n = units(trace)
    if not n or not has_spans(trace):
        return None
    spans = sorted(iv for name in names for iv in named(trace, name))
    if inside is not None:
        outer = named(trace, inside)
        if not outer:
            return None
        spans = within(spans, outer)
    return seconds(spans) / n


def count_per_unit(trace, name):
    """Spans ``name`` a unit; None where the program has no spans or the
    window no unit."""
    n = units(trace)
    if not n or not has_spans(trace):
        return None
    return len(named(trace, name)) / n
