"""Run one cell of ``BENCHMARK.json`` on the card and print its result.

A cell is a configuration (``configs/<config>.json``: the deployment's
numbers) under a traffic mix (``traffic/<mix>.json``: which job runs, its
parameters and the limits of its check).  The job (``jobs/<job>.py``) sets
up the program from the seed, warms up the cell's shapes, runs units of
work back to back for the measured window, and afterwards checks what the
last unit produced against the plain reference.  A traced run
(``--trace 1``) runs a few units under the profiler instead and hands the
trace to each per-layer metric's reader (``layer_metrics/<metric>.py``).

Nothing here names a cell, a configuration or a metric: everything comes
from ``BENCHMARK.json`` and the files it names, so a later cell is new
files and new entries only.  A metric ``<quantity>.<part>`` (a quantity
split by the cells that report it) reports the job's ``<quantity>`` where
it is end to end, and reads with the quantity's reader where it is per
layer and has no reader of its own.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib
import importlib.util
import json
import pathlib
import subprocess
import sys
import time
import traceback

from port_bench import profiling

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent
#: Top-level modules that may not be loaded: the JAX package, JAX itself.
FORBIDDEN = ("jax", "jaxlib", "flax", "graph_framework_tpu")


def load_spec(root=ROOT):
    return json.loads((root / "BENCHMARK.json").read_text())


def find_cell(spec, workload, root=ROOT):
    """(cell, configuration, traffic) of the named cell: the cell's entry
    and the two data files it names."""
    cells = {c["name"]: c for c in spec["workloads"]}
    if workload not in cells:
        raise KeyError(f"no cell {workload!r} in BENCHMARK.json "
                       f"(cells: {sorted(cells)})")
    cell = cells[workload]
    entry = {c["name"]: c for c in spec["configs"]}[cell["config"]]
    config = json.loads((root / entry["file"]).read_text())
    traffic = json.loads(
        (root / HERE.name / "traffic" / f"{cell['traffic']}.json")
        .read_text())
    return cell, config, traffic


def metrics_of(spec, kind, workload):
    """The ``kind`` ("end_to_end" or "per_layer") metrics the cell
    reports: those with no ``workloads`` key and those that list it."""
    return [m for m in spec[kind]
            if workload in m.get("workloads", [workload])]


def load_job(traffic):
    return importlib.import_module(f"port_bench.jobs.{traffic['job']}")


def reader_path(name, root=ROOT):
    """The reader of the per-layer metric ``name``: ``layer_metrics/
    <name>.py`` where there is one, else the reader of its quantity, the
    part of the name before the first dot (``device_idle.grad`` reads
    with ``layer_metrics/device_idle.py``)."""
    folder = root / HERE.name / "layer_metrics"
    path = folder / f"{name}.py"
    return path if path.is_file() else folder / f"{name.split('.')[0]}.py"


def load_reader(name, root=ROOT):
    """The ``read(trace)`` of the metric's reader (:func:`reader_path`)."""
    path = reader_path(name, root)
    spec = importlib.util.spec_from_file_location(
        f"port_bench.layer_metrics.{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def forbidden_modules():
    """Loaded modules whose top-level name, compared whole, is one the
    benchmark may not load."""
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def power_limit():
    """The card's name and power limit as nvidia-smi reports them."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return None


def log(text):
    print(text, file=sys.stderr, flush=True)


def sync(device):
    """Wait for the card's queue (nothing on the CPU)."""
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _window(job, seconds):
    """Units back to back until ``seconds`` have passed: (the wall of each
    completed unit, the seconds from the window's start to the last
    unit's end, units attempted, units failed)."""
    walls, attempted, failed = [], 0, 0
    t0 = time.perf_counter()
    end = t0
    while time.perf_counter() - t0 < seconds:
        attempted += 1
        u0 = time.perf_counter()
        try:
            ok = job.unit()
        except Exception:                         # counted, and reported
            log(f"unit {attempted} raised:\n{traceback.format_exc()}")
            failed += 1
            continue
        end = time.perf_counter()
        walls.append(end - u0)
        failed += not ok
    return walls, end - t0, attempted, failed


def _traced(job, units):
    """``units`` units under the profiler: (the trace, the units' walls,
    the window's seconds, units failed)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    before = job.counters()
    walls, failed = [], 0
    job.tracing = True
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        with record_function(profiling.WINDOW):
            for _ in range(units):
                u0 = time.perf_counter()
                with record_function("bench.unit"):
                    ok = job.unit()
                walls.append(time.perf_counter() - u0)
                failed += not ok
        seconds = time.perf_counter() - t0
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    job.tracing = False
    after = job.counters()
    trace = profiling.collect(prof, job.SPANS)
    trace.counters = {k: after[k] - before[k] for k in after}
    trace.info = job.info()
    trace.timings = job.timings()
    return trace, walls, seconds, failed


def run(workload, seed, seconds, trace, *, device="cuda", root=ROOT,
        start=None, overrides=None):
    """Run one cell: (the result line as a dict, the checks as a dict name
    -> (value, limit, passed)).  ``device`` and ``overrides`` (numbers of
    the configuration replaced, keyed as in its file) are for the CPU
    tests, which drive a run at a small size with the program's plain
    versions; the benchmark itself runs the card at the sizes in the
    files."""
    import torch

    start = time.perf_counter() if start is None else start
    spec = load_spec(root)
    cell, config, traffic = find_cell(spec, workload, root)
    config = {**config, **(overrides or {})}
    job = load_job(traffic).Job(config, traffic, seed, device)
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    job.setup()
    setup_s = time.perf_counter() - start
    log(f"set-up {setup_s:.3f} s: {json.dumps(job.setup_notes())}")

    result = {"correct": False, "attempted": 0, "failed": 0, "metrics": {}}
    if trace:
        tr, walls, window, failed = _traced(job, traffic["traced_units"])
        result["attempted"], result["failed"] = len(walls), failed
        traced_rates = job.end_to_end(walls, window)
        log(f"traced window: {len(walls)} units in {window:.6f} s; "
            f"end to end under the profiler {json.dumps(traced_rates)}; "
            f"counters {json.dumps(tr.counters)}; {len(tr.device)} device "
            f"and {len(tr.host)} host operations")
        for m in metrics_of(spec, "per_layer", workload):
            value = load_reader(m["name"], root)(tr)
            if value is not None:
                result["metrics"][m["name"]] = {"value": value,
                                                "unit": m["unit"]}
    else:
        walls, window, attempted, failed = _window(job, seconds)
        result["attempted"], result["failed"] = attempted, failed
        values = {**job.end_to_end(walls, window), "setup_s": setup_s}
        log(f"window: {len(walls)} units completed of {attempted} in "
            f"{window:.6f} s; walls (s) min {min(walls, default=0):.6f} "
            f"max {max(walls, default=0):.6f}")
        for m in metrics_of(spec, "end_to_end", workload):
            value = values.get(m["name"], values.get(m["name"].split(".")[0]))
            if value is not None:
                result["metrics"][m["name"]] = {"value": value,
                                                "unit": m["unit"]}

    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": cell["chips"],
           "memory_peak_bytes": (max(torch.cuda.max_memory_allocated(i)
                                     for i in range(cell["chips"]))
                                 if cuda else 0)}
    if cuda:
        dev["power_limit"] = power_limit()
    if trace:
        dev["busy_s"] = profiling.busy_s(tr)
        dev["window_s"] = profiling.window_s(tr)
        result["breakdown"] = profiling.breakdown(tr)
    result["device"] = dev
    job.release()
    t0 = time.perf_counter()
    checks = job.check()
    log(f"check: {time.perf_counter() - t0:.3f} s against the plain "
        f"reference; {json.dumps(job.check_notes())}")
    result["correct"] = all(ok for _, _, ok in checks.values())
    result["checks"] = {k: {"value": v, "limit": lim}
                        for k, (v, lim, _) in checks.items()}
    return result, checks


def main(argv=None, start=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    try:
        spec = load_spec()
        cell = find_cell(spec, args.workload)[0]
    except (OSError, KeyError, ValueError) as exc:
        log(f"port_bench: {exc}")
        return 2
    import torch

    if not torch.cuda.is_available():
        log("port_bench: no CUDA card (torch.cuda.is_available() is "
            "false); nothing was run")
        return 2
    if torch.cuda.device_count() < cell["chips"]:
        log(f"port_bench: the cell needs {cell['chips']} cards, "
            f"{torch.cuda.device_count()} present; nothing was run")
        return 2
    result, checks = run(args.workload, args.seed, args.seconds,
                         args.trace, start=start)
    loaded = forbidden_modules()
    if loaded:
        log(f"port_bench: the process loaded {loaded}; no result")
        return 3
    for name, (value, limit, ok) in checks.items():
        log(f"check {name}: {value!r} limit {limit!r} "
            f"{'ok' if ok else 'FAILED'}")
    print(json.dumps(result), flush=True)
    return 0


@contextlib.contextmanager
def span(job, name):
    """A profiler span around a call into a layer, while ``job`` is
    traced; nothing otherwise."""
    if not job.tracing:
        yield
        return
    from torch.profiler import record_function

    with record_function(name):
        yield
