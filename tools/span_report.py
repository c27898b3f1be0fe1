#!/usr/bin/env python3
"""The port's spans against a traced window of a benchmark cell, on the card.

    python3 tools/span_report.py traced <cell> [--seed N] [--units U]
        [--events PATH]
    python3 tools/span_report.py cost [--seed N] [--rounds R] [--units U]

from the root of a checkout (``port_bench``'s cells and jobs).

``traced`` sets the cell up as ``port_bench/run.py`` does, traces ``U``
units under ``torch.profiler`` and prints one JSON line: the breakdown's
idle gaps (``port_bench/profiling.breakdown``), the share of the device's
idle seconds in the window that lies inside some ``gft.*`` span (a union
of intervals, not the breakdown's naming), the per-layer readers' values,
and, where the units launch K1, the offset from the start of each
``gft.efit_window`` span to the start of the K1 kernel it launched (the
i-th kernel with the i-th span).  ``--events`` writes the window's host
and device events there (gzipped JSON) for a later look.

``cost`` runs the 100k trace cell in one process: ``R`` rounds of a traced
window of ``U`` units with the spans in the profiler's trace and without
(``telemetry.follow_profiler``), then of ``2U`` untraced units with spans
off and kept (``telemetry.enable``), the two in turns whose order swaps
each round, each with its rate and, where kept, ``gft.efit_window``'s
mean microseconds from the aggregate; and the median rate of each kind.
"""

from __future__ import annotations

import argparse
import bisect
import gzip
import json
import pathlib
import statistics
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from port_bench import harness, profiling  # noqa: E402

K1 = "efit_window_kernel"


def setup(cell, seed):
    spec = harness.load_spec()
    _, config, traffic = harness.find_cell(spec, cell)
    job = harness.load_job(traffic).Job(config, traffic, seed, "cuda")
    job.setup()
    return spec, job


def idle_intervals(trace):
    """The window's intervals in which no device operation ran."""
    lo, hi = trace.window
    out, cursor = [], lo
    for s, e in profiling.merged([(s, e) for _, s, e in trace.device],
                                 lo, hi):
        if s > cursor:
            out.append((cursor, s))
        cursor = max(cursor, e)
    if hi > cursor:
        out.append((cursor, hi))
    return out


def overlap(a, b):
    """Seconds in both of two lists of disjoint sorted intervals."""
    i = j = 0
    total = 0.0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        total += max(0.0, hi - lo)
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def clock_offsets(trace):
    """Microseconds from each gft.efit_window span's start to its K1
    kernel's start, the i-th kernel with the i-th span; from the CUDA
    runtime's launch record inside each span (its host-side call, on the
    same host clock as the span) to the kernel's start; and the drift of
    the latter over the window, in parts per million."""
    spans = sorted((s, e) for n, s, e in trace.host
                   if n == "gft.efit_window")
    kernels = sorted(s for n, s, _ in trace.device if K1 in n)
    if not kernels:
        return None
    launches = sorted(s for n, s, _ in trace.host
                      if n == "cudaLaunchKernel")
    offsets, from_launch, at = [], [], []
    for (s, e), k in zip(spans, kernels):
        offsets.append(1e6 * (k - s))
        i = bisect.bisect_left(launches, s)
        if i < len(launches) and launches[i] <= e:
            from_launch.append(1e6 * (k - launches[i]))
            at.append(launches[i])
    out = {"spans": len(spans), "kernels": len(kernels),
           "median_us": statistics.median(offsets),
           "least_us": min(offsets),
           "negative": sum(o < 0 for o in offsets),
           "spans_with_launch": len(from_launch)}
    if len(from_launch) > 1:
        t0 = at[0]
        xs = [t - t0 for t in at]
        mx, my = statistics.fmean(xs), statistics.fmean(from_launch)
        slope = (sum((x - mx) * (y - my) for x, y in zip(xs, from_launch))
                 / sum((x - mx) ** 2 for x in xs))
        out.update(launch_median_us=statistics.median(from_launch),
                   launch_least_us=min(from_launch),
                   launch_first_us=from_launch[0],
                   drift_ppm=slope)
    return out


def traced(args):
    spec, job = setup(args.cell, args.seed)
    trace, walls, window, failed = harness._traced(job, args.units)
    idle = idle_intervals(trace)
    lo, hi = trace.window
    spans = profiling.merged(
        [(s, e) for n, s, e in trace.host if n.startswith("gft.")], lo, hi)
    idle_s = sum(e - s for s, e in idle)
    metrics = {}
    for m in harness.metrics_of(spec, "per_layer", args.cell):
        metrics[m["name"]] = harness.load_reader(m["name"])(trace)
    out = {"cell": args.cell, "seed": args.seed, "units": len(walls),
           "failed": failed, "window_s": window,
           "end_to_end": job.end_to_end(walls, window),
           "idle_s": idle_s,
           "idle_in_spans_share": overlap(idle, spans) / idle_s
           if idle_s else None,
           "breakdown": profiling.breakdown(trace),
           "metrics": metrics, "k1_clock": clock_offsets(trace),
           "card": harness.power_limit()}
    if args.events:
        with gzip.open(args.events, "wt") as fh:
            json.dump({"window": trace.window, "host": trace.host,
                       "device": trace.device}, fh)
    print(json.dumps(out), flush=True)


def cost(args):
    from graph_framework_tpu_torch import telemetry

    cell = "xrays_bench_100k.trace"
    _, job = setup(cell, args.seed)
    reader = harness.load_reader("window_host_us.trace")
    harness._traced(job, args.units)              # the profiler's first use
    rows = []
    for r in range(args.rounds):
        order = (True, False) if r % 2 == 0 else (False, True)
        for follow in order:
            telemetry.follow_profiler(follow)
            trace, walls, window, _ = harness._traced(job, args.units)
            rows.append({"round": r, "traced": True, "spans": follow,
                         "ray_steps_per_s": job.end_to_end(
                             walls, window)["ray_steps_per_s"],
                         "window_host_us": reader(trace)})
        telemetry.follow_profiler(True)
        for keep in order:
            telemetry.reset()
            telemetry.enable(keep)
            t0 = time.perf_counter()
            for _ in range(2 * args.units):
                job.unit()
            window = time.perf_counter() - t0
            telemetry.enable(False)
            row = {"round": r, "traced": False, "spans": keep,
                   "ray_steps_per_s": job.ray_steps() * 2 * args.units
                   / window}
            if keep:
                spans = telemetry.summary()
                n = spans["gft.efit_window"]["count"]
                row["window_host_us"] = (
                    1e6 * spans["gft.efit_window"]["total_s"] / n)
                row["loop_host_us"] = (
                    1e6 * spans["gft.solver.run"]["self_s"] / n)
            rows.append(row)
    summary = {}
    for traced in (True, False):
        for on in (True, False):
            rates = [r["ray_steps_per_s"] for r in rows
                     if r["traced"] == traced and r["spans"] == on]
            summary[f"{'traced' if traced else 'untraced'}_"
                    f"{'on' if on else 'off'}"] = statistics.median(rates)
    print(json.dumps({"cell": cell, "seed": args.seed, "units": args.units,
                      "median_ray_steps_per_s": summary, "rows": rows,
                      "card": harness.power_limit()}), flush=True)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = p.add_subparsers(dest="mode", required=True)
    t = sub.add_parser("traced")
    t.add_argument("cell")
    t.add_argument("--seed", type=int, default=1234567891)
    t.add_argument("--units", type=int, default=None)
    t.add_argument("--events", default=None)
    c = sub.add_parser("cost")
    c.add_argument("--seed", type=int, default=1234567891)
    c.add_argument("--rounds", type=int, default=3)
    c.add_argument("--units", type=int, default=4)
    args = p.parse_args(argv)
    if args.mode == "traced":
        if args.units is None:
            spec = harness.load_spec()
            args.units = harness.find_cell(spec, args.cell)[2][
                "traced_units"]
        traced(args)
    else:
        cost(args)


if __name__ == "__main__":
    main()
