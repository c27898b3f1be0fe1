"""The port's spans (``graph_framework_tpu_torch.telemetry``) on the CPU.

Off, a span site records nothing and hands out one shared object.  Under
``torch.profiler`` the ``gft.*`` spans are kineto host events, nested as
called and on the clock of ``time.time_ns()``.  Kept in memory
(``telemetry.enable``), they count what the program does: a window a
``gft.efit_window``, a Newton iteration a ``gft.newton.iteration``, a
source compiled a ``gft.build.nvcc``; ``xrays --timing_json`` writes them
beside its phase timers, which are spans too.
"""

import dataclasses
import json
import os
import stat
import threading
import time
import types

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import chip_smoke
from graph_framework_tpu_torch import telemetry
from graph_framework_tpu_torch.cli import xrays
from graph_framework_tpu_torch.models.dispersion import cold_plasma
from graph_framework_tpu_torch.solver import Solver, init_k

SLAB = ["--dispersion=cold_plasma", "--equilibrium=slab_density",
        "--num_rays=16", "--num_times=40", "--sub_steps=10",
        "--endtime=0.02", "--init_w_mean=1000.0", "--init_kx_mean=800.0",
        "--init_y_mean=0.0", "--init_kz_mean=100.0",
        "--init_kz_dist=normal", "--init_kz_sigma=0.0",
        "--absorption_model=weak_damping", "--device=cpu"]


@pytest.fixture
def kept():
    """Spans kept in memory for the test, from an empty aggregate."""
    telemetry.reset()
    previous = telemetry.enable(True)
    yield
    telemetry.enable(previous)
    telemetry.reset()


@pytest.fixture(scope="module")
def eq():
    return chip_smoke.synthetic_equilibrium(torch.float64, "cpu", grid=33)


@pytest.fixture(scope="module")
def root(eq):
    return init_k(chip_smoke.launch(8, torch.float64, "cpu"), cold_plasma,
                  eq)


def _solver(eq, sub_steps=4, freeze_every=2, compensated=True):
    return Solver(cold_plasma, eq, method="rk2", dt=1e-4,
                  sub_steps=sub_steps, frozen_cells=True,
                  freeze_every=freeze_every, compensated=compensated,
                  window_kernel=True)


def test_off_records_nothing(eq, root):
    """Spans off (the default): a site hands out one shared object, and a
    Solver run and a Newton solve leave the aggregate empty."""
    assert not telemetry.enabled()
    telemetry.reset()
    assert telemetry.span("gft.a") is telemetry.span("gft.b")
    _solver(eq).run(root, 2)
    init_k(chip_smoke.launch(8, torch.float64, "cpu"), cold_plasma, eq)
    assert telemetry.summary() == {}


def test_spans_are_profiler_host_events_on_its_clock(eq, root):
    """Under torch.profiler the spans are kineto host events, nested as
    called (the test's own, gft.solver.run in them, each window in that),
    each inside the time.time_ns() reads taken around it."""
    solver = _solver(eq)
    solver.run(root, 1)                           # first-call costs
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        a0 = time.time_ns()
        with telemetry.span("gft.test.outer"):
            b0 = time.time_ns()
            with telemetry.span("gft.test.inner"):
                c0 = time.time_ns()
                solver.run(root, 2)
                c1 = time.time_ns()
            b1 = time.time_ns()
        a1 = time.time_ns()
    events = {}
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith("gft."):
            events.setdefault(e.name(), []).append(
                (e.start_ns(), e.start_ns() + e.duration_ns()))
    (outer,) = events["gft.test.outer"]
    (inner,) = events["gft.test.inner"]
    (run,) = events["gft.solver.run"]
    windows = events["gft.efit_window"]
    assert a0 <= outer[0] <= b0 and b1 <= outer[1] <= a1
    assert b0 <= inner[0] <= c0 and c1 <= inner[1] <= b1
    assert c0 <= run[0] and run[1] <= c1
    assert len(windows) == 2 * 4 // 2
    assert all(run[0] <= s and e <= run[1] for s, e in windows)
    assert all(a[1] <= b[0] for a, b in zip(windows, windows[1:]))


@pytest.mark.parametrize("path", ["kernel", "autograd"])
@pytest.mark.parametrize("sub_steps,freeze_every", [(4, 2), (6, 3)])
def test_a_window_a_span(kept, eq, root, path, sub_steps, freeze_every):
    """Solver.run of s steps: s x sub_steps / freeze_every
    gft.efit_window spans, on the forward path and through EfitWindow
    (the autograd path, whose backward adds a gft.efit_window.bwd a
    window and, for the tables, a gft.efit_window.scatter)."""
    steps = 3
    windows = steps * sub_steps // freeze_every
    if path == "kernel":
        _solver(eq, sub_steps, freeze_every).run(root, steps)
    else:
        psi = eq.psi_coeffs.clone().requires_grad_(True)
        grad_eq = dataclasses.replace(eq, psi_coeffs=psi)
        out = _solver(grad_eq, sub_steps, freeze_every,
                      compensated=False).run(root, steps)
        out.x.sum().backward()
        assert psi.grad is not None
    spans = telemetry.summary()
    assert spans["gft.efit_window"]["count"] == windows
    assert spans["gft.solver.run"]["count"] == 1
    run = spans["gft.solver.run"]
    assert run["self_s"] == pytest.approx(
        run["total_s"] - spans["gft.efit_window"]["total_s"], abs=1e-9)
    if path == "autograd":
        assert spans["gft.efit_window.bwd"]["count"] == windows
        assert spans["gft.efit_window.scatter"]["count"] == windows
    else:
        assert "gft.efit_window.bwd" not in spans


def test_newton_iterations_are_counted(kept, eq):
    """The gft.newton.iteration spans of init_k's solve number
    NewtonDiagnostics.iterations."""
    _, diag = init_k(chip_smoke.launch(16, torch.float64, "cpu"),
                     cold_plasma, eq, return_diagnostics=True)
    assert diag.iterations > 0
    assert telemetry.summary()["gft.newton.iteration"]["count"] == \
        diag.iterations


def test_newton_keeps_its_iterations():
    """A fixed number of iterations (x^2 - 2 from 1 stops at rounding;
    the cap stops a longer solve) comes out as before, span or none."""
    from graph_framework_tpu_torch.ops.newton import newton_solve

    x0 = torch.ones(4, dtype=torch.float64)
    x, ok, diag = newton_solve(lambda x: x * x - 2.0, x0)
    assert ok and abs(float(x[0]) - 2.0 ** 0.5) < 1e-15
    _, ok, capped = newton_solve(lambda x: x * x - 2.0, x0,
                                 max_iterations=2)
    assert capped.iterations == 2 and not ok
    assert diag.iterations > 2


def test_self_seconds_and_threads(kept, monkeypatch):
    """Self seconds are the total less the spans opened inside on the same
    thread; another thread's spans are their own stack's."""
    clock = iter(range(0, 10 ** 6, 10))
    monkeypatch.setattr(telemetry, "time", types.SimpleNamespace(
        time_ns=lambda: next(clock)))
    with telemetry.span("gft.t.outer"):          # 0 .. 50
        with telemetry.span("gft.t.inner"):      # 10 .. 20
            pass
        with telemetry.span("gft.t.inner"):      # 30 .. 40
            pass
    spans = telemetry.summary()
    assert spans["gft.t.outer"] == {"count": 1,
                                    "total_s": pytest.approx(50e-9),
                                    "self_s": pytest.approx(30e-9)}
    assert spans["gft.t.inner"]["count"] == 2
    monkeypatch.undo()
    seen = []

    def worker():
        with telemetry.span("gft.t.worker") as s:
            seen.append((s.parent, s.thread))

    with telemetry.span("gft.t.main"):
        t = threading.Thread(target=worker)
        t.start()
        t.join()
    assert seen == [(None, t.ident)]
    assert telemetry.summary()["gft.t.worker"]["count"] == 1


def test_every_thread_counts(kept):
    """Threads that close spans at once, more of them than cores and with
    a short switch interval, lose no count."""
    import sys

    threads, spans = 4 * (os.cpu_count() or 1), 200
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(spans):
                with telemetry.span("gft.t.stress"):
                    pass

        pool = [threading.Thread(target=work) for _ in range(threads)]
        for t in pool:
            t.start()
        for t in pool:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in pool)
    assert telemetry.summary()["gft.t.stress"]["count"] == threads * spans


def test_phase_measures_when_off():
    """A phase timer reads its seconds with spans off, and keeps
    nothing."""
    telemetry.reset()
    with telemetry.Span("gft.t.phase") as p:
        time.sleep(0.01)
    assert 0.01 <= p.seconds < 1.0
    assert telemetry.summary() == {}


def test_run_xrays_timing_json_adds_spans():
    """run_xrays with --timing_json: every key of the run without it, the
    phase timers equal to their spans' totals, and the spans; the setting
    is back off after the run."""
    plain = xrays.resolve_stack(xrays.build_parser().parse_args(
        [*SLAB, "--output=plain.nc"]), "cpu")
    timed = xrays.resolve_stack(xrays.build_parser().parse_args(
        [*SLAB, "--output=timed.nc", "--timing_json=t.json"]), "cpu")
    eq = xrays.make_equilibrium(plain, torch.float64, torch.device("cpu"))
    without = xrays.run_xrays(plain, eq, chip_smoke.MemoryFiles().open)
    with_spans = xrays.run_xrays(timed, eq, chip_smoke.MemoryFiles().open)
    assert not telemetry.enabled()
    t = with_spans.timings
    assert set(t) == set(without.timings) | {"spans"}
    spans = t["spans"]
    for key, name in (("init_s", "init_k"), ("compile_s", "compile"),
                      ("trace_s", "trace"), ("absorption_s", "absorption"),
                      ("bin_power_s", "bin_power")):
        assert spans[f"gft.xrays.{name}"]["count"] == 1
        assert t[key] == pytest.approx(
            spans[f"gft.xrays.{name}"]["total_s"], abs=1e-6)
        assert without.timings[key] > 0.0
    assert t["setup_s"] == pytest.approx(
        spans["gft.xrays.setup"]["total_s"], abs=1e-6)
    rows = 40 // 10 + 1
    assert spans["gft.writer.row"]["count"] == 3 * rows
    assert spans["gft.absorption.read_row"]["count"] == rows
    assert spans["gft.newton.iteration"]["count"] >= 1
    assert spans["gft.xrays.trace"]["self_s"] < \
        spans["gft.xrays.trace"]["total_s"]


def test_timing_json_file_holds_the_spans(tmp_path):
    """xrays's main writes timings["spans"] into --timing_json."""
    tj = tmp_path / "t.json"
    xrays.main([*SLAB, f"--output={tmp_path / 'r.nc'}",
                f"--timing_json={tj}"])
    t = json.loads(tj.read_text())
    assert t["spans"]["gft.xrays.trace"]["count"] == 1
    assert t["trace_s"] == pytest.approx(
        t["spans"]["gft.xrays.trace"]["total_s"], abs=1e-6)


def test_a_build_counts_its_sources(kept, tmp_path, monkeypatch):
    """A build that compiles is a gft.build span with a gft.build.nvcc
    span a source; a build that finds its library records neither."""
    from graph_framework_tpu_torch.kernels import build

    nvcc = tmp_path / "nvcc"
    nvcc.write_text('#!/bin/sh\nwhile [ $# -gt 0 ]; do\n'
                    '  if [ "$1" = "-o" ]; then : > "$2"; fi\n'
                    '  shift\ndone\n')
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(build, "find_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(build, "build_log", build.build_log)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "_build")
    out = build.build()
    assert out.is_file() and out.parent == tmp_path / "_build"
    sources = len(list(build.CSRC.glob("*.cu")))
    spans = telemetry.summary()
    assert spans["gft.build"]["count"] == 1
    assert spans["gft.build.nvcc"]["count"] == sources
    build.build()
    assert telemetry.summary()["gft.build"]["count"] == 1
    assert os.path.exists(out)
