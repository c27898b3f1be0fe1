"""The benchmark's readers of the spline tables' gradient scatter
(``port_bench/layer_metrics``: ``table_grad_ms``, ``table_scatters``), on
hand-built traces of config 5's units.

``table_grad_ms`` sums the device time of the program's kernel and of the
library's ``index_put_`` backward that it replaced, so it reads the
program before the kernel too; ``table_scatters`` counts the program's
``gft.table_scatter`` spans and reads nothing from a program without them.
"""

import pytest

from port_bench import harness, profiling

CELL = "absorbed_power_1m.absorbed_power_grad"
NAMES = ("table_grad_ms.grad", "table_scatters.grad")

KERNEL = "void gft::(anonymous namespace)::table_scatter_kernel<float>(long)"
LIBRARY = ("void (anonymous namespace)::indexing_backward_kernel_small_"
           "stride<float>(long const*)")


def _trace(host, device):
    return profiling.Trace(device=sorted(device, key=lambda op: op[1]),
                           host=sorted(host, key=lambda op: op[1]),
                           window=(0.0, 100.0), spans={})


def _units(n=2):
    return [("bench.unit", 50.0 * u, 50.0 * (u + 1)) for u in range(n)]


def _program():
    """Two units with three launches of the kernel (0.5, 1 and 1.5 ms),
    each inside its span, beside a K3 launch and a fill."""
    starts = (10.0, 20.0, 60.0)
    host = _units() + [("gft.absorbed_power.backward", 5.0, 40.0)] + [
        ("gft.table_scatter", s, s + 0.1) for s in starts]
    device = [(KERNEL, s + 0.2, s + 0.2 + d)
              for s, d in zip(starts, (0.5e-3, 1.0e-3, 1.5e-3))]
    device += [("void gft::efit_window_bwd_kernel<float>", 30.0, 30.01),
               ("Memset (Device)", 9.0, 9.5)]
    return _trace(host, device)


def _library():
    """The program before the kernel: two units of the library's
    index_put_ backward, 14 ms each, no scatter span."""
    host = _units() + [("gft.absorbed_power.backward", 5.0, 40.0),
                       ("aten::index_put_", 10.0, 10.1)]
    device = [(LIBRARY, 10.2, 10.214), (LIBRARY, 60.2, 60.214),
              ("void gft::efit_window_bwd_kernel<float>", 30.0, 30.01)]
    return _trace(host, device)


def test_the_metrics_are_in_the_benchmark():
    spec = harness.load_spec()
    per_layer = {m["name"]: m for m in spec["per_layer"]}
    for name in NAMES:
        m = per_layer[name]
        assert (m["layer"], m["moves"], m["workloads"]) == (
            "absorption", "grad_ray_steps_per_s", [CELL])
        assert harness.reader_path(name).name == f"{name.split('.')[0]}.py"


@pytest.mark.parametrize("make, want", [
    (_program, {"table_grad_ms.grad": 1.5, "table_scatters.grad": 1.5}),
    (_library, {"table_grad_ms.grad": 14.0, "table_scatters.grad": None})],
    ids=["kernel", "library"])
def test_readers_on_known_traces(make, want):
    for name, value in want.items():
        got = harness.load_reader(name)(make())
        if value is None:
            assert got is None
        else:
            assert got == pytest.approx(value, rel=1e-12, abs=1e-12)


def test_readers_read_nothing_without_units_or_scatters():
    bare = _trace([("gft.efit_window", 1.0, 2.0)],
                  [("void gft::efit_window_kernel<float>", 1.5, 1.6)])
    for name in NAMES:
        assert harness.load_reader(name)(bare) is None
    no_units = _program()
    no_units.host = [op for op in no_units.host if op[0] != "bench.unit"]
    for name in NAMES:
        assert harness.load_reader(name)(no_units) is None


def test_weak_damping_launches_counts_the_kernels_spans():
    """``weak_damping_launches.grad`` counts the program's
    ``gft.weak_damping.kernel`` spans, one a launch of K9 (forward or VJP),
    a unit; a program without them (the eager weak damping) gives
    nothing, and so does a window without units."""
    m = {m["name"]: m for m in harness.load_spec()["per_layer"]}[
        "weak_damping_launches.grad"]
    assert (m["layer"], m["source"], m["moves"], m["workloads"], m["unit"],
            m["better"]) == ("absorption", "program_counter",
                             "grad_ray_steps_per_s", [CELL], "count",
                             "lower")
    assert harness.reader_path(m["name"]).name == "weak_damping_launches.py"
    read = harness.load_reader("weak_damping_launches.grad")
    assert read(_program()) is None
    assert read(_library()) is None
    spans = [("gft.weak_damping.kernel", t, t + 0.01)
             for t in (1.0, 2.0, 3.0, 45.0, 51.0, 52.0)]
    full = _trace(_units() + spans, [])
    assert read(full) == 3.0
    no_units = _trace(spans, [])
    assert read(no_units) is None
