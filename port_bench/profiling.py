"""The reduction of one traced window to the numbers the per-layer readers
take: device operations, host operations and the benchmark's spans on one
timeline.

A traced run wraps a few units of work in ``torch.profiler`` (CPU and CUDA
activity) and in spans of its own (``torch.profiler.record_function``): the
window (:data:`WINDOW`), each unit, and each call into a layer of the
program that the job names.  :func:`collect` reads the profiler's raw
events (kineto's, without building the profiler's own event tree, which is
slow at tens of thousands of events) into a :class:`Trace` in seconds.
The arithmetic on it (busy and idle time, a kernel's mean time by name,
idle time inside a span, the breakdown) is here, shared by the readers in
``layer_metrics/``.
"""

from __future__ import annotations

import bisect
import collections
import dataclasses
import sys

from port_bench import counts

WINDOW = "bench.window"


@dataclasses.dataclass
class Trace:
    """One traced window: ``device`` and ``host`` operations as (name,
    start, end) in seconds, ``window`` its (start, end), ``spans`` the
    benchmark's spans by name, and what the job adds: ``counters`` (the
    program's counters over the window), ``info`` (sizes and names the
    readers need), ``timings`` (phase seconds the program reported)."""
    device: list
    host: list
    window: tuple
    spans: dict
    counters: dict = dataclasses.field(default_factory=dict)
    info: dict = dataclasses.field(default_factory=dict)
    timings: dict = dataclasses.field(default_factory=dict)


def collect(prof, span_names=()):
    """A :class:`Trace` of a finished ``torch.profiler.profile``:
    ``span_names`` are the record_function names to keep as spans (the
    window's is always kept)."""
    from torch.autograd import DeviceType

    events = prof.profiler.kineto_results.events()
    device, host = [], []
    spans = collections.defaultdict(list)
    keep = set(span_names) | {WINDOW}
    for e in events:
        start = e.start_ns() * 1e-9
        end = start + e.duration_ns() * 1e-9
        if e.device_type() == DeviceType.CUDA:
            if not e.is_user_annotation():
                device.append((e.name(), start, end))
        else:
            host.append((e.name(), start, end))
            if e.name() in keep:
                spans[e.name()].append((start, end))
    if not spans[WINDOW]:
        raise RuntimeError("the traced window's span is missing")
    window = spans[WINDOW][0]
    device.sort(key=lambda op: op[1])
    host.sort(key=lambda op: op[1])
    return Trace(device=device, host=host, window=window, spans=dict(spans))


def merged(intervals, lo, hi):
    """The union of (start, end) intervals clipped to [lo, hi], as
    disjoint sorted intervals."""
    out = []
    for start, end in sorted((max(s, lo), min(e, hi))
                             for s, e in intervals):
        if end <= start:
            continue
        if out and start <= out[-1][1]:
            out[-1][1] = max(out[-1][1], end)
        else:
            out.append([start, end])
    return out


def busy_s(trace, lo=None, hi=None):
    """Seconds in which some device operation ran, within [lo, hi] (the
    window by default)."""
    lo = trace.window[0] if lo is None else lo
    hi = trace.window[1] if hi is None else hi
    return sum(e - s for s, e in merged(
        [(s, e) for _, s, e in trace.device], lo, hi))


def window_s(trace):
    return trace.window[1] - trace.window[0]


def idle_share(trace):
    """The share of the window in which no device operation ran, in %;
    None where the trace holds no device operation."""
    if not trace.device:
        return None
    return 100.0 * (1.0 - busy_s(trace) / window_s(trace))


def idle_inside(trace, span):
    """Seconds inside the spans named ``span`` in which the device ran
    nothing; None where there is no such span or no device operation."""
    if not trace.device or not trace.spans.get(span):
        return None
    return sum((e - s) - busy_s(trace, s, e) for s, e in trace.spans[span])


def kernel_mean_s(trace, name):
    """Mean device seconds of the operations whose name holds ``name``;
    None where the trace holds none with a duration."""
    times = [e - s for n, s, e in trace.device if name in n and e > s]
    return sum(times) / len(times) if times else None


def idle_per_launch(trace, span, counter):
    """Microseconds of device idle inside the spans named ``span`` per
    count of ``counter`` over the traced units; None where either is
    missing."""
    idle, launches = idle_inside(trace, span), trace.counters.get(counter)
    if idle is None or not launches:
        return None
    return 1e6 * idle / launches


def roofline_share(trace, kernel, name):
    """The share, in %, of its roofline that the kernel ``kernel`` (a key
    of ``counts.WINDOW_OPS``, as ``trace.info`` names it) reaches: the
    least time a window of ``trace.info["rays"]`` rays can take over the
    mean device time of the operations named ``name``; None where the
    trace holds neither."""
    key, mean = trace.info.get(kernel), kernel_mean_s(trace, name)
    if key is None or mean is None:
        return None
    bound, by = counts.window_bound_s(key, trace.info["rays"],
                                      trace.info["table_bytes"])
    print(f"{key} bound by {by}, {bound * 1e3:.6f} ms a window against "
          f"{mean * 1e3:.6f} ms measured", file=sys.stderr)
    return 100.0 * bound / mean


def _host_at(host, starts, t, reach=400):
    """The innermost host operation running at time t: of those that
    started before it and end after it, the one that started last."""
    i = bisect.bisect_right(starts, t)
    for j in range(i - 1, max(i - 1 - reach, -1), -1):
        if host[j][2] >= t:
            return host[j][0]
    return "(no host operation)"


def breakdown(trace, top=10):
    """The ``breakdown`` of the result line: the ``top`` device
    operations by their summed seconds, and the ``top`` kinds of idle gap
    by the host operation running in the middle of each gap, summed."""
    by_op = collections.Counter()
    for name, s, e in trace.device:
        by_op[name] += e - s
    lo, hi = trace.window
    gaps, cursor = collections.Counter(), lo
    starts = [op[1] for op in trace.host]
    for s, e in merged([(s, e) for _, s, e in trace.device], lo, hi) + [
            [hi, hi]]:
        if s > cursor:
            gaps[_host_at(trace.host, starts, 0.5 * (cursor + s))] += (
                s - cursor)
        cursor = max(cursor, e)
    return {"device_ops": [[n, v] for n, v in by_op.most_common(top)],
            "idle_gaps": [[n, v] for n, v in gaps.most_common(top)]}
