"""The harness's own parts on the CPU: the import rule, the counts, the
metric arithmetic, and that a cell or a per-layer metric is found from new
files and entries alone."""

import json
import re
import pathlib
import shutil
import subprocess
import sys

import numpy as np
import pytest

from port_bench import counts, harness, profiling
from port_bench.jobs import trace as trace_job

ROOT = pathlib.Path(__file__).resolve().parents[2]


def test_no_forbidden_module_is_loaded():
    """A fresh process that loads the harness, every job and the
    references holds no module whose top-level name is JAX's or the JAX
    package's; the references load nothing of the program."""
    code = (
        "import sys, importlib, pathlib\n"
        "sys.path.insert(0, '.')\n"
        "from port_bench import harness\n"
        "for p in pathlib.Path('port_bench/reference').glob('*.py'):\n"
        "    importlib.import_module('port_bench.reference.' + p.stem)\n"
        "assert not [m for m in sys.modules\n"
        "            if m.split('.')[0] == 'graph_framework_tpu_torch'], \\\n"
        "    'a reference loaded the program'\n"
        "for p in pathlib.Path('port_bench/jobs').glob('*.py'):\n"
        "    importlib.import_module('port_bench.jobs.' + p.stem)\n"
        "import graph_framework_tpu_torch.solver\n"
        "import graph_framework_tpu_torch.cli.xrays\n"
        "print(harness.forbidden_modules())\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_forbidden_names_compare_whole_top_levels(monkeypatch):
    monkeypatch.setitem(sys.modules, "graph_framework_tpu_torch_x", sys)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "graph_framework_tpu.solver", sys)
    assert harness.forbidden_modules() == ["graph_framework_tpu.solver"]


def test_no_card_no_result():
    """Without a CUDA card the command exits non-zero and prints no
    result line."""
    out = subprocess.run(
        [sys.executable, "port_bench/run.py", "--workload",
         "xrays_bench_100k.trace", "--seed", "3", "--seconds", "1",
         "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
        timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "no CUDA card" in out.stderr


def test_frozen_counts_equal_the_programs():
    """The yardstick's copies of K1's and K3's counts equal what the
    port's operation counter gives from the CUDA sources today."""
    if shutil.which("g++") is None:
        pytest.skip("the counter compiles the sources with g++")
    out = subprocess.run(
        [sys.executable, "-m", "graph_framework_tpu_torch.tools.count_ops"],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr
    ops = json.loads(out.stdout)["ops"]
    for kernel, per_ray in counts.WINDOW_OPS.items():
        assert ops[kernel]["per_ray_window"] == per_ray, kernel


def test_trace_counts_and_p95():
    """ray_steps_per_s counts rays x steps x substeps of every completed
    unit over the window; trace_p95_ms is the 95th percentile of the
    units' walls."""
    job = trace_job.Job({"rays": 1000, "steps": 100, "sub_steps": 10,
                         "compensated": True}, {}, 1, "cpu")
    walls = list(np.linspace(0.1, 0.2, 201))
    out = job.end_to_end(walls, 30.0)
    assert out["ray_steps_per_s"] == pytest.approx(1000 * 100 * 10 * 201
                                                   / 30.0)
    assert out["trace_p95_ms"] == pytest.approx(195.0)
    assert job.end_to_end([], 30.0) == {}


def test_profile_arithmetic():
    tr = profiling.Trace(
        device=[("k1", 0.1, 0.2), ("k1", 0.15, 0.3), ("copy", 0.5, 0.6)],
        host=[("Solver.run", 0.0, 1.0), ("aten::empty", 0.35, 0.45)],
        window=(0.0, 1.0), spans={"Solver.run": [(0.0, 1.0)]})
    assert profiling.busy_s(tr) == pytest.approx(0.3)
    assert profiling.idle_share(tr) == pytest.approx(70.0)
    assert profiling.idle_inside(tr, "Solver.run") == pytest.approx(0.7)
    assert profiling.kernel_mean_s(tr, "k1") == pytest.approx(0.125)
    gaps = dict(map(tuple, profiling.breakdown(tr)["idle_gaps"]))
    assert gaps["aten::empty"] == pytest.approx(0.2)
    assert gaps["Solver.run"] == pytest.approx(0.5)
    empty = profiling.Trace(device=[], host=[], window=(0.0, 1.0), spans={})
    assert profiling.idle_share(empty) is None
    assert profiling.kernel_mean_s(empty, "k1") is None


def _copy_root(tmp_path):
    """A checkout of the benchmark's files alone, in ``tmp_path``."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "port_bench", tmp_path / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    return json.loads((tmp_path / "BENCHMARK.json").read_text())


def test_a_new_cell_and_metric_come_from_files_and_entries(tmp_path):
    """A configuration file, a traffic file, a reader file and their
    entries in BENCHMARK.json (the new cell also named in the workloads of
    the end-to-end metric it reports) make a new cell with a new per-layer
    metric; no file that was there changes."""
    spec = _copy_root(tmp_path)
    before = {p: p.read_bytes() for p in (tmp_path / "port_bench").rglob(
        "*.py")}
    cfg = json.loads((tmp_path / "port_bench/configs/"
                      "xrays_bench_100k.json").read_text())
    cfg.update(rays=2048, steps=3, dtype="float64", compensated=False)
    (tmp_path / "port_bench/configs/tiny_f64.json").write_text(
        json.dumps(cfg))
    traffic = json.loads((tmp_path / "port_bench/traffic/trace.json")
                         .read_text())
    traffic.update(check_rays=8, traced_units=1)
    (tmp_path / "port_bench/traffic/trace_small.json").write_text(
        json.dumps(traffic))
    (tmp_path / "port_bench/layer_metrics/host_ops.small.py").write_text(
        "def read(trace):\n    return float(len(trace.host))\n")
    spec["configs"].append({"name": "tiny_f64", "source": "test",
                            "file": "port_bench/configs/tiny_f64.json",
                            "reduced": [], "why": "test"})
    spec["workloads"].append({"name": "tiny_f64.trace_small",
                              "config": "tiny_f64", "traffic": "trace_small",
                              "chips": 1, "why": "test"})
    spec["per_layer"].append({"name": "host_ops.small", "unit": "ops",
                              "better": "lower", "source": "device_trace",
                              "layer": "host", "moves": "ray_steps_per_s",
                              "workloads": ["tiny_f64.trace_small"]})
    for m in spec["end_to_end"]:
        if m["name"] == "ray_steps_per_s":
            m["workloads"].append("tiny_f64.trace_small")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    result, _ = harness.run("tiny_f64.trace_small", 5, 1.0, 1,
                            device="cpu", root=tmp_path)
    assert result["metrics"]["host_ops.small"]["value"] > 0
    assert result["correct"]
    result, _ = harness.run("tiny_f64.trace_small", 5, 1.0, 0,
                            device="cpu", root=tmp_path)
    assert set(result["metrics"]) == {"ray_steps_per_s", "setup_s"}
    assert list(result)[-1] == "checks"
    assert before == {p: p.read_bytes() for p in before}


NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 and not any(
        c in text for c in "\n\t")


def test_benchmark_json_keeps_to_its_contract():
    """BENCHMARK.json's shape: keys, names, units, bounds, the files and
    readers it names, and what every cell reports."""
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert list(spec) == ["command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"]
    assert spec["paths"] == ["port_bench"]
    assert 1 <= spec["run_seconds"] <= 51
    assert (ROOT / spec["command"][1]).is_file()
    assert (2 + 14 * 24) * (spec["run_seconds"] + 60) + 24 * 180 + 1200 \
        <= 43200
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in spec[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    cells = {c["name"]: c for c in spec["workloads"]}
    for c in spec["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert _line(c["source"]) and _line(c["why"])
        data = json.loads((ROOT / c["file"]).read_text())
        assert data["reduced"] == c["reduced"]
        assert all(NAME.match(k) for k in c["reduced"])
        assert any(w["config"] == c["name"] for w in cells.values())
    for w in cells.values():
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and _line(w["why"])
        assert (ROOT / "port_bench/traffic" / f"{w['traffic']}.json"
                ).is_file()
    pairs = [(w["config"], w["traffic"]) for w in cells.values()]
    assert len(pairs) == len(set(pairs))
    e2e = {m["name"]: m for m in spec["end_to_end"]}
    assert "setup_s" in e2e and "workloads" not in e2e["setup_s"]
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert set(m) - {"workloads"} == (
            {"name", "unit", "better", "bound", "source"}
            if m in spec["end_to_end"] else
            {"name", "unit", "better", "source", "layer", "moves"})
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert all(c in cells for c in m.get("workloads", []))
    for m in spec["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in spec["per_layer"]:
        assert _line(m["layer"]) and m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert harness.reader_path(m["name"]).is_file()
        moved = e2e[m["moves"]].get("workloads", list(cells))
        assert all(c in moved for c in m["workloads"])
    for c in cells:
        assert len(harness.metrics_of(spec, "end_to_end", c)) >= 2
        assert harness.metrics_of(spec, "per_layer", c)
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
