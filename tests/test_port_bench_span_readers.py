"""The benchmark's readers of the program's spans (``port_bench/
layer_metrics``: ``window_host_us``, ``loop_host_us``, ``writer_wait_s``,
``absorption_read_s``, ``init_k_s``, ``newton_iterations``).

Each reads a hand-built trace of known spans exactly, reads nothing from a
trace without the program's spans (a program from before them), and
reads a CPU traced run of its cell through the harness.
"""

import pytest

from port_bench import harness, profiling, program_spans

TRACE_CELL = "xrays_bench_100k.trace"
PIPELINE = "xrays_bench_100k.pipeline"
READERS = {"window_host_us.trace": TRACE_CELL,
           "loop_host_us.trace": TRACE_CELL,
           "writer_wait_s.xrays": PIPELINE,
           "absorption_read_s.xrays": PIPELINE,
           "init_k_s.xrays": PIPELINE,
           "newton_iterations.xrays": PIPELINE}


def _trace(host, device=()):
    host = sorted(host, key=lambda op: op[1])
    return profiling.Trace(device=sorted(device, key=lambda op: op[1]),
                           host=host, window=(0.0, 200.0), spans={})


def _trace_unit():
    """Two units of Solver.run: windows of 1, 2 and 1.5 s in runs of 9 s,
    and a window of 0.5 s outside any run."""
    return _trace([
        ("bench.unit", 0.0, 10.0), ("bench.unit", 10.0, 20.0),
        ("gft.solver.run", 0.5, 9.5), ("gft.solver.run", 10.5, 19.5),
        ("gft.efit_window", 1.0, 2.0), ("gft.efit_window", 3.0, 5.0),
        ("aten::empty_like", 3.5, 3.75), ("gft.efit_window", 11.0, 12.5),
        ("gft.efit_window", 21.0, 21.5)],
        [("efit_window_kernel", 2.0, 2.5), ("efit_window_kernel", 5.0, 6.0)])


def _pipeline():
    """Two units of the xrays program, the first with every span: init
    2 s in 5 iterations; in the trace phase 2 + 1 s of puts and 2 s of
    the close; a put of phase 2 outside it; two row reads of 0.75 s."""
    return _trace([
        ("bench.unit", 0.0, 100.0), ("bench.unit", 100.0, 200.0),
        ("gft.xrays.init_k", 1.0, 3.0),
        *[("gft.newton.iteration", 1.0 + 0.25 * i, 1.25 + 0.25 * i)
          for i in range(5)],
        ("gft.xrays.trace", 10.0, 40.0), ("gft.trace.drain", 11.0, 15.0),
        ("gft.writer.put", 12.0, 14.0), ("gft.writer.put", 20.0, 21.0),
        ("gft.writer.close", 38.0, 40.0),
        ("gft.xrays.absorption", 45.0, 60.0),
        ("gft.absorption.read_row", 50.0, 50.5),
        ("gft.absorption.read_row", 51.0, 51.25),
        ("gft.writer.put", 52.0, 54.0)],
        [("Memcpy HtoD", 50.25, 50.5), ("kernel", 55.0, 56.0)])


EXACT = {"window_host_us.trace": (_trace_unit, 1.25e6),
         "loop_host_us.trace": (_trace_unit, 4.5e6),
         "writer_wait_s.xrays": (_pipeline, 2.5),
         "absorption_read_s.xrays": (_pipeline, 0.375),
         "init_k_s.xrays": (_pipeline, 1.0),
         "newton_iterations.xrays": (_pipeline, 2.5)}


@pytest.mark.parametrize("name", sorted(EXACT))
def test_reader_is_exact_on_known_spans(name):
    make, want = EXACT[name]
    assert harness.load_reader(name)(make()) == want


@pytest.mark.parametrize("name", sorted(EXACT))
def test_reader_reads_nothing_without_program_spans(name):
    """A program without spans (the benchmark's own spans and ATen
    operations only): None, which leaves the metric off the line."""
    full = EXACT[name][0]()
    bare = _trace([op for op in full.host
                   if not op[0].startswith(program_spans.PREFIX)],
                  full.device)
    assert harness.load_reader(name)(bare) is None


def test_breakdown_names_gaps_by_the_spans():
    """The breakdown names an idle gap by the innermost host event at its
    middle: the program's span where no ATen operation runs."""
    busy = [(0.0, 12.5), (13.5, 20.25), (20.75, 38.5), (39.5, 51.0625),
            (51.1875, 200.0)]
    trace = _pipeline()
    trace.device = [("kernel", s, e) for s, e in busy]
    gaps = dict(map(tuple, profiling.breakdown(trace)["idle_gaps"]))
    assert gaps == {"gft.writer.put": 1.5, "gft.writer.close": 1.0,
                    "gft.absorption.read_row": 0.125}


def test_within_keeps_only_contained_intervals():
    inner = [(0.0, 1.0), (1.5, 2.5), (2.0, 4.0), (5.0, 6.0)]
    assert program_spans.within(inner, [(1.0, 3.0), (4.5, 7.0)]) == [
        (1.5, 2.5), (5.0, 6.0)]


@pytest.fixture
def small(monkeypatch):
    """The pipeline's traffic cut to a CPU's size."""
    find = harness.find_cell

    def cut(spec, workload, root=harness.ROOT):
        cell, config, traffic = find(spec, workload, root)
        if workload == PIPELINE:
            traffic = {**traffic, "rows": 10, "check_rays": 32}
        return cell, config, traffic

    monkeypatch.setattr(harness, "find_cell", cut)


SIZES = {TRACE_CELL: dict(rays=256, steps=2, dtype="float64",
                          compensated=False),
         PIPELINE: dict(rays=1024)}


@pytest.mark.parametrize("cell", [TRACE_CELL, PIPELINE])
def test_readers_read_a_traced_cpu_run(small, cell):
    """A traced run of the cell on the CPU (the program's plain versions)
    reports each of its readers' metrics, with the values the spans
    give."""
    result, _ = harness.run(cell, 29, 0.5, 1, device="cpu",
                            overrides=SIZES[cell])
    assert result["correct"], result["checks"]
    values = {k: v["value"] for k, v in result["metrics"].items()}
    for name, at in READERS.items():
        assert (name in values) == (at == cell), name
    if cell == TRACE_CELL:
        assert 0.0 < values["loop_host_us.trace"] < \
            values["window_host_us.trace"]
        return
    assert values["newton_iterations.xrays"] >= 1.0
    assert values["newton_iterations.xrays"] == \
        int(values["newton_iterations.xrays"])
    assert values["init_k_s.xrays"] > 0.0
    assert values["absorption_read_s.xrays"] > 0.0
    assert 0.0 <= values["writer_wait_s.xrays"] < \
        values["trace_write_s.xrays"]
    assert values["absorption_read_s.xrays"] < values["absorption_s.xrays"]
