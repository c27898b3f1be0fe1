"""The benchmark's readers of the VMEC cell (``port_bench/layer_metrics``:
``k4_roofline``, ``device_ops_substep``, ``rhs_host_us``, and the quantity
reader ``device_idle``), on hand-built traces of its units, and the
yardstick's copy of K4's operation count (``port_bench/counts_vmec.py``).

Each reader reads a trace of known operations and spans exactly, and reads
nothing from a trace without the benchmark's ``Solver.run`` spans, K4's
kernels or the program's ``gft.ray_rhs`` spans.
"""

import json
import shutil
import subprocess
import sys

import pytest

from port_bench import counts_vmec, harness, profiling

CELL = "w7x_vmec_100k.trace"
LAYERS = {"k4_roofline.vmec": ("kernel K4", "device_trace"),
          "device_idle.vmec": ("device", "device_trace"),
          "device_ops_substep.vmec": ("VMEC ray RHS", "device_trace"),
          "rhs_host_us.vmec": ("VMEC ray RHS", "program_span")}
K4 = ("void gft::(anonymous namespace)::vmec_geom_kernel<float>(float "
      "const*, float const*)")
INFO = {"rays": 100_000, "modes": 86, "substeps_per_run": 50,
        "table_bytes": 198 * 4 * 86 * 4 * 2 + 197 * 4 * 86 * 4}


def _trace(host, device, info=INFO, spans=None):
    return profiling.Trace(device=sorted(device, key=lambda op: op[1]),
                           host=sorted(host, key=lambda op: op[1]),
                           window=(0.0, 10.0), spans=spans or {},
                           info=dict(info))


def _units():
    """Two units: a Solver.run span of 4 s each, with its RHS spans (3 of
    0.5 s and 1 of 1 s), 6 device operations inside the runs (two K4
    launches of 40 and 50 us, four others) and 2 outside; 1.4 s of device
    work in the 10 s window."""
    runs = [(0.5, 4.5), (5.0, 9.0)]
    host = [("bench.unit", 0.0, 5.0), ("bench.unit", 5.0, 10.0),
            ("gft.ray_rhs", 1.0, 1.5), ("gft.ray_rhs", 2.0, 2.5),
            ("gft.ray_rhs", 6.0, 6.5), ("gft.ray_rhs", 7.0, 8.0)]
    device = [(K4, 1.2, 1.2 + 40e-6), (K4, 6.2, 6.2 + 50e-6),
              ("void at::native::elementwise_kernel", 1.3, 1.6),
              ("aten::mul kernel", 2.1, 2.4),
              ("Memcpy DtoH (Device -> Pinned)", 6.3, 6.6),
              ("void at::native::reduce_kernel", 7.1, 7.4 - 90e-6),
              ("void at::native::elementwise_kernel", 0.1, 0.2),
              ("void at::native::reduce_kernel", 4.6, 4.7)]
    return _trace(host, device, spans={"Solver.run": runs})


def test_the_metrics_are_in_the_benchmark():
    per_layer = {m["name"]: m for m in harness.load_spec()["per_layer"]}
    for name, (layer, source) in LAYERS.items():
        m = per_layer[name]
        assert (m["layer"], m["source"], m["moves"], m["workloads"]) == (
            layer, source, "trace_p95_ms", [CELL])
        assert harness.reader_path(name).name == f"{name.split('.')[0]}.py"


def test_readers_on_known_traces():
    trace = _units()
    read = {name: harness.load_reader(name)(trace) for name in LAYERS}
    ops = (420 + 90 * 86) * 100_000 + 27 + 7 * 86
    assert read["k4_roofline.vmec"] == pytest.approx(
        100.0 * ops / 67.0e12 / 45e-6, rel=1e-12)
    assert read["device_ops_substep.vmec"] == pytest.approx(6 / 100,
                                                            rel=1e-12)
    assert read["rhs_host_us.vmec"] == pytest.approx(0.625e6, rel=1e-12)
    assert read["device_idle.vmec"] == pytest.approx(
        100.0 * (1.0 - 1.4 / 10.0), rel=1e-12)


def test_k4_bound_takes_the_larger_side():
    """At 100k rays and 86 modes K4 is bound by its operations (0.0122
    ms, the bytes 0.0038 ms); with few modes its bytes bound it."""
    seconds, by = counts_vmec.jet_bound_s(100_000, 86, INFO["table_bytes"])
    assert by == "operations"
    assert seconds == pytest.approx(1.218e-5, rel=1e-3)
    assert counts_vmec.jet_bound_s(100_000, 1, 0)[1] == "bytes"


def test_readers_read_nothing_without_their_sources():
    full = _units()
    no_runs = _trace(full.host, full.device)
    assert harness.load_reader("device_ops_substep.vmec")(no_runs) is None
    no_k4 = _trace(full.host, [op for op in full.device if op[0] != K4],
                   spans=full.spans)
    assert harness.load_reader("k4_roofline.vmec")(no_k4) is None
    no_info = _trace(full.host, full.device, info={}, spans=full.spans)
    assert harness.load_reader("k4_roofline.vmec")(no_info) is None
    assert harness.load_reader("device_ops_substep.vmec")(no_info) is None
    no_rhs = _trace([op for op in full.host if op[0] != "gft.ray_rhs"],
                    full.device, spans=full.spans)
    assert harness.load_reader("rhs_host_us.vmec")(no_rhs) is None
    bare = _trace(full.host, [], spans=full.spans)
    for name in LAYERS:
        if name != "rhs_host_us.vmec":
            assert harness.load_reader(name)(bare) is None, name


def test_frozen_k4_counts_equal_the_programs():
    """The yardstick's copy of K4's counts equals what the port's
    operation counter gives from ``csrc/vmec_geom.cu`` today."""
    if shutil.which("g++") is None:
        pytest.skip("the counter compiles the sources with g++")
    out = subprocess.run(
        [sys.executable, "-m", "graph_framework_tpu_torch.tools.count_ops"],
        cwd=harness.ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout)["ops"]["K4"] == counts_vmec.JET_OPS


def test_vmec_rhs_launches_counts_the_kernels_spans():
    """``vmec_rhs_launches.vmec`` counts the program's ``gft.vmec_rhs``
    spans, one a launch of K8, a unit; a program without them (the eager
    RHS) gives nothing."""
    m = {m["name"]: m for m in harness.load_spec()["per_layer"]}[
        "vmec_rhs_launches.vmec"]
    assert (m["layer"], m["source"], m["moves"], m["workloads"], m["unit"],
            m["better"]) == ("VMEC ray RHS", "program_counter",
                             "trace_p95_ms", [CELL], "count", "lower")
    full = _units()
    read = harness.load_reader("vmec_rhs_launches.vmec")
    assert read(full) is None
    host = full.host + [("gft.vmec_rhs", t, t + 1e-5)
                        for t in (1.1, 1.3, 2.1, 6.1, 7.1, 7.3)]
    assert read(_trace(host, full.device, spans=full.spans)) == 3.0
