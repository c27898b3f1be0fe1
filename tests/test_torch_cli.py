"""The port's command-line programs against the JAX package's.

``xrays`` runs as a user runs it, in a subprocess: the port's with
``--device=cpu``, the JAX package's with ``JAX_PLATFORMS=cpu``, the same
arguments otherwise; both result files are read back and held to each
other (relative 1e-10 of each variable's scale in float64, 1e-5 in
float32): the three-phase slab run of tests/test_cli_e2e.py with both
absorption models, a three-phase run on the synthetic EFIT file, and the
fused VMEC geometry with compensated accumulation on a synthetic
``vmec.nc``.  Per-row streaming (``--stream_segment=1``) writes the same
file as the segmented trace.  ``xrays_bench``, ``xkorc`` and ``xpic`` run
in this process at a few rays or particles against the same computation
in the JAX package, and :func:`resolve_stack` picks the production stack
only where it should.
"""

import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from conftest import REPO_ROOT
from test_torch_common import efit_path
from graph_framework_tpu.io.output import ResultFile as JaxResultFile
from graph_framework_tpu.tools.make_splines import (
    write_efit_file, write_vmec_file)
from graph_framework_tpu_torch.cli import xkorc, xpic, xrays, xrays_bench

SLAB = ["--dispersion=cold_plasma", "--equilibrium=slab_density",
        "--num_rays=16", "--num_times=40", "--sub_steps=10",
        "--endtime=0.02", "--init_w_mean=1000.0", "--init_kx_mean=800.0",
        "--init_y_mean=0.0", "--init_kz_mean=100.0",
        "--init_kz_dist=normal", "--init_kz_sigma=0.0"]


def run_cli(module, out, args, env_extra=()):
    env = dict(os.environ, PYTHONPATH=str(REPO_ROOT), **dict(env_extra))
    proc = subprocess.run(
        [sys.executable, "-m", module, f"--output={out}", *args],
        cwd=REPO_ROOT, env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc


def run_both(tmp_path, args):
    """(port's variables, JAX's variables) of the same xrays run."""
    port = tmp_path / "port.nc"
    ref = tmp_path / "jax.nc"
    run_cli("graph_framework_tpu_torch.cli.xrays", port,
            [*args, "--device=cpu"])
    run_cli("graph_framework_tpu.cli.xrays", ref, args,
            {"JAX_PLATFORMS": "cpu"})
    return read_all(port), read_all(ref)


def read_all(path):
    with JaxResultFile(path, mode="r") as f:
        return {n: np.stack([f.read_step(i, [n], complex_valued=n == "kamp")
                             [n] for i in range(f.num_steps)])
                for n in f.variables()}


def assert_files_close(got, want, rtol):
    """Each variable within rtol of its largest magnitude; the residual
    D^2 as |D| within rtol (its terms are of order 1, and D itself is
    their rounding)."""
    assert sorted(got) == sorted(want)
    for name, ref in want.items():
        assert got[name].shape == ref.shape, name
        if name == "residual":
            dev = np.abs(np.sqrt(got[name]) - np.sqrt(ref)).max()
            assert dev <= rtol, (name, dev)
            continue
        scale = np.abs(ref).max()
        dev = np.abs(got[name] - ref).max()
        assert dev <= rtol * scale, (name, dev, scale)


@pytest.mark.parametrize("model", ["weak_damping", "root_find"])
def test_xrays_slab_three_phase_matches_jax(tmp_path, model):
    """tests/test_cli_e2e.py's slab pipeline: trace, absorption, power;
    the schema, 5 rows of 16 rays, power <= 1 and non-increasing."""
    got, want = run_both(tmp_path, [*SLAB, f"--absorption_model={model}"])
    assert_files_close(got, want, 1e-10)
    assert set(got) == {"time", "residual", "w", "x", "y", "z", "kx", "ky",
                        "kz", "kamp", "power", "d_power"}
    assert got["x"].shape == (5, 16)
    p = got["power"]
    assert np.all(p <= 1.0) and np.all(np.diff(p, axis=0) <= 0.0)


def test_xrays_efit_matches_jax(tmp_path_factory, tmp_path):
    """A three-phase cold-plasma run over the synthetic EFIT file: Newton
    init of kx, rk4 in f64, weak damping, power."""
    path = efit_path("synthetic", tmp_path_factory)
    got, want = run_both(tmp_path, [
        "--dispersion=cold_plasma", "--equilibrium=efit",
        f"--equilibrium_file={path}", "--num_rays=8", "--num_times=40",
        "--sub_steps=10", "--endtime=0.004", "--init_w_mean=500.0",
        "--init_kx_mean=-500.0", "--init_x_mean=2.5",
        "--init_x_dist=normal", "--init_x_sigma=0.02",
        "--init_ky_mean=150.0", "--init_ky_dist=normal",
        "--init_ky_sigma=10.0", "--absorption_model=weak_damping"])
    assert_files_close(got, want, 1e-10)
    assert float(np.max(got["residual"][1:])) < 1e-8
    assert np.all(got["x"][-1] < got["x"][0])


def test_xrays_vmec_fused_compensated_matches_jax(tmp_path):
    """--vmec_fused (K4's plain version here, the JAX K4 in interpret
    mode) with --compensated, f32, over a synthetic vmec.nc."""
    path = tmp_path / "vmec.nc"
    write_vmec_file(path, **chip_smoke.synthetic_vmec_samples(knots=41))
    got, want = run_both(tmp_path, [
        "--dispersion=cold_plasma", "--equilibrium=vmec",
        f"--equilibrium_file={path}", "--num_rays=4", "--num_times=10",
        "--sub_steps=5", "--endtime=2.5e-5", "--f32", "--init_w_mean=900",
        "--init_x_mean=0.5", "--init_y_mean=0.5", "--init_kx_mean=500",
        "--vmec_fused", "--compensated"])
    assert_files_close(got, want, 1e-5)


def test_streaming_matches_segmented(tmp_path):
    """One row a host block (--stream_segment=1), the default 16, and 3,
    a segment that does not divide the 4 rows, write the same file, bit
    for bit."""
    files = {}
    for seg in (1, 3, 16):
        out = tmp_path / f"seg{seg}.nc"
        xrays.main([*SLAB, f"--output={out}", f"--stream_segment={seg}",
                    "--device=cpu"])
        files[seg] = read_all(out)
    for seg in (3, 16):
        for name, ref in files[1].items():
            np.testing.assert_array_equal(files[seg][name], ref)


def test_timing_json(tmp_path):
    tj = tmp_path / "t.json"
    xrays.main([*SLAB, f"--output={tmp_path / 'r.nc'}", "--device=cpu",
                f"--timing_json={tj}", "--absorption_model=weak_damping"])
    t = json.loads(tj.read_text())
    for key in ("setup_s", "init_s", "compile_s", "trace_s",
                "trace_ray_steps_per_s", "absorption_s", "bin_power_s"):
        assert t[key] > 0.0, key
    assert t["backend"] == "cpu" and t["solver"] == "rk4"


@pytest.mark.parametrize("option", ["--no_such_option=1",
                                    "--pallas_window",
                                    "--pallas_block_rows=2"])
def test_xrays_rejects_unknown_options(option):
    """Unknown options, and the JAX options not carried over, fail."""
    proc = subprocess.run(
        [sys.executable, "-m", "graph_framework_tpu_torch.cli.xrays",
         option, "--device=cpu"], cwd=REPO_ROOT,
        env=dict(os.environ, PYTHONPATH=str(REPO_ROOT)),
        capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and "unrecognized" in proc.stderr


def _args(*extra):
    return xrays.build_parser().parse_args(list(extra))


# w = 0: every 1/w^2 of the dispersion divides by zero (the JAX package's
# tests/test_debug_mode.py configuration); no Newton init
_NAN_RUN = ("--dispersion=simple", "--equilibrium=gaussian_density",
            "--num_rays=4", "--num_times=4", "--sub_steps=2",
            "--init_w_mean=0.0", "--init_kx_mean=0.25",
            "--init_kx_dist=normal", "--init_ky_mean=0.25",
            "--init_ky_dist=normal", "--init_kz_mean=0.15",
            "--init_kz_dist=normal", "--device=cpu")


def test_xrays_debug_flag():
    """--debug: the run's first NaN raises a located error naming the
    operation, the leaf and the ray; without it the same run writes its
    NaN rows; either way debug mode is off after the run."""
    from graph_framework_tpu_torch import utils
    from graph_framework_tpu_torch.models.equilibrium import (
        make_gaussian_density)

    args = xrays.resolve_stack(_args(*_NAN_RUN, "--debug"), "cpu")
    with pytest.raises(utils.NonFiniteError, match="ray 0"):
        xrays.run_xrays(args, make_gaussian_density(),
                        chip_smoke.MemoryFiles().open)
    assert not utils.debug_enabled()
    files = chip_smoke.MemoryFiles()
    args = xrays.resolve_stack(_args(*_NAN_RUN), "cpu")
    xrays.run_xrays(args, make_gaussian_density(), files.open)
    assert not np.isfinite(files[args.output].stack("kx")[-1]).all()


def test_xrays_print_expressions(capsys):
    """--print_expressions prints the autograd graphs of D and the six RHS
    components on the first ray, and on the production stack the kernel
    unit each window launches; the run itself is unchanged."""
    eq = chip_smoke.synthetic_equilibrium(torch.float32, "cpu", grid=33)
    run = ["--dispersion=cold_plasma", "--equilibrium=efit",
           "--num_rays=4", "--num_times=20", "--sub_steps=10",
           "--endtime=0.002", "--init_w_mean=500", "--init_x_mean=2.5",
           "--init_kx_mean=-500", "--init_ky_mean=150", "--device=cpu",
           "--solver=rk2", "--frozen_cells", "--freeze_every=10",
           "--compensated", "--window_kernel", "--f32"]
    rows = {}
    for extra in ((), ("--print_expressions",)):
        files = chip_smoke.MemoryFiles()
        args = xrays.resolve_stack(_args(*run, *extra), "cpu")
        xrays.run_xrays(args, eq, files.open)
        rows[extra] = files[args.output].stack("kx")
    out = capsys.readouterr().out
    assert np.array_equal(*rows.values())
    assert "autograd graph of D and the ray RHS (first ray):" in out
    for label in ("D", "dx/dt", "dy/dt", "dz/dt", "dkx/dt", "dky/dt",
                  "dkz/dt"):
        assert f"\n  {label} = n" in out, label
    assert "MulBackward0(" in out and "(kx, ky, kz)" in out
    assert ("kernel unit of each freeze window: graph_framework_tpu_torch/"
            "csrc/efit_window.cu (K1") in out


_PRODUCTION = ("rk2", True, 10, False)


@pytest.mark.parametrize("device,dispersion,want", [
    ("cuda", "cold_plasma", _PRODUCTION),
    ("cuda", "extra_ordinary_wave", _PRODUCTION),
    ("cuda", "bohm_gross", _PRODUCTION),
    ("cpu", "cold_plasma", ("rk4", False, 1, True)),
] + [("cuda", name, _PRODUCTION) for name in xrays.DISPERSION_CHOICES
     if name not in ("cold_plasma", "extra_ordinary_wave", "bohm_gross")])
def test_resolve_stack(device, dispersion, want):
    """On the card over EFIT, every dispersion of --dispersion (each one
    the window kernel implements) takes the production stack (frozen rk2,
    freeze_every 10, compensated, window kernel, f32); the CPU rk4 in
    f64."""
    got = xrays.resolve_stack(
        _args("--equilibrium=efit", f"--dispersion={dispersion}"), device)
    assert (got.solver, got.window_kernel, got.freeze_every,
            got.x64) == want
    assert got.frozen_cells == got.compensated == got.window_kernel


def test_resolve_stack_respects_explicit_options():
    """--portable, an explicit solver or stack option, another
    equilibrium, and a sub_steps that 10 does not divide."""
    for extra in (["--portable"], ["--solver=rk4"], ["--compensated"],
                  ["--equilibrium=slab"]):
        got = xrays.resolve_stack(
            _args("--equilibrium=efit", "--dispersion=cold_plasma", *extra),
            "cuda")
        assert not got.window_kernel and got.x64 is True, extra
    got = xrays.resolve_stack(
        _args("--equilibrium=efit", "--dispersion=cold_plasma",
              "--sub_steps=4"), "cuda")
    assert got.freeze_every == 2
    got = xrays.resolve_stack(
        _args("--equilibrium=efit", "--dispersion=cold_plasma", "--f32"),
        "cuda")
    assert got.window_kernel and got.x64 is False


@pytest.mark.parametrize("device", ["cuda", "cpu"])
def test_explicit_window_kernel_refuses_other_dispersions(device):
    """The window kernel takes every dispersion of --dispersion; the hot
    plasmas (complex only, not among its choices) are refused where
    resolve_stack meets them, on every device."""
    for name in ("hot_plasma", "hot_plasma_expansion"):
        args = _args("--equilibrium=efit", "--frozen_cells",
                     "--window_kernel")
        args.dispersion = name
        with pytest.raises(ValueError, match="hot plasmas are complex"):
            xrays.resolve_stack(args, device)
    for name in xrays.DISPERSION_CHOICES:
        got = xrays.resolve_stack(_args(
            "--equilibrium=efit", f"--dispersion={name}", "--frozen_cells",
            "--window_kernel"), device)
        assert got.window_kernel, name


def _jax_bench(dtype, path, num_rays, num_times, sub_steps):
    """JAX's bench_one as computed (it prints, returns nothing): the final
    state of the same calls."""
    from graph_framework_tpu.models import dispersion as jdisp
    from graph_framework_tpu.models.efit import make_efit
    from graph_framework_tpu.solver import Solver, init_k, make_ray_state
    eq = make_efit(path, dtype=jnp.float64 if "double" in dtype
                   else jnp.float32)
    jdt = dict(float=jnp.float32, complex_double=jnp.complex128)[dtype]
    state = make_ray_state(num_rays, w=500.0, x=2.5, kx=-600.0, ky=150.0,
                           dtype=jdt)
    state = init_k(state, jdisp.cold_plasma, eq, "kx", tolerance=1e-10,
                   max_iterations=200)
    step = Solver(jdisp.cold_plasma, eq, method="rk4", dt=1.0 / num_times,
                  sub_steps=sub_steps).step_fn()
    for _ in range(num_times // sub_steps):
        state = step(state)
    return state


@pytest.mark.parametrize("dtype,rtol", [("float", 1e-5),
                                        ("complex_double", 1e-10)])
def test_xrays_bench_matches_jax(tmp_path_factory, dtype, rtol, capsys):
    """bench_one on the synthetic EFIT file at 4 rays x 30 steps: its
    timers print, and its final state is the JAX package's."""
    from graph_framework_tpu.cli.xrays_bench import bench_one as jax_bench
    path = efit_path("synthetic", tmp_path_factory)
    got = xrays_bench.bench_one(dtype, path, 4, 30, 10, device="cpu")
    port_lines = capsys.readouterr().out.splitlines()
    jax_bench(dtype, str(path), 4, 30, 10)
    jax_lines = capsys.readouterr().out.splitlines()
    assert [l.split()[0] for l in port_lines] == [
        l.split()[0] for l in jax_lines]
    want = _jax_bench(dtype, path, 4, 30, 10)
    assert got["final"].x.dtype == xrays_bench.DTYPES[dtype]
    for field in ("x", "y", "z", "kx", "ky", "kz"):
        a = getattr(got["final"], field).numpy()
        b = np.asarray(getattr(want, field))
        scale = max(np.abs(b).max(), 1.0)
        assert np.abs(a - b).max() <= rtol * scale, field
    for key in ("setup_s", "init_s", "compile_s", "steps_s"):
        assert got[key] > 0.0


def test_xkorc_matches_jax(tmp_path):
    """xkorc through the synthetic EFIT map with its axis moved
    (chip_smoke.KORC_AXIS, as tests/test_torch_particles.py): 8 particles
    x 20 steps, f64."""
    from graph_framework_tpu.cli.xkorc import main as jax_main
    path = tmp_path / "efit.nc"
    write_efit_file(path, **chip_smoke.synthetic_samples(
        **chip_smoke.KORC_AXIS))
    common = [f"--equilibrium_file={path}", "--num_particles=8",
              "--num_steps=20"]
    xkorc.main([*common, f"--output={tmp_path / 'port.nc'}",
                "--device=cpu"])
    jax_main([*common, f"--output={tmp_path / 'jax.nc'}"])
    got, want = read_all(tmp_path / "port.nc"), read_all(tmp_path / "jax.nc")
    assert sorted(got) == sorted(xkorc.PARTICLE_NAMES)
    assert_files_close(got, want, 1e-10)


def test_xpic_files_match_jax_layout(tmp_path):
    """xpic at 256 particles x 1000 grid points x 3 steps of dt 1e-14
    (chip_smoke's phase 12: a step that keeps the particles on the grid)
    writes the JAX CLI's two files: the same variables and shapes, finite
    values, a positive density.  The two packages draw their random start
    differently (torch.Generator, jax.random), so the values are held to
    the JAX package from one start in tests/test_torch_pic.py."""
    from graph_framework_tpu.cli.xpic import main as jax_main
    common = ["--num_particles=256", "--num_grid=1000", "--num_steps=3",
              "--dt=1e-14"]
    out = {}
    for who, run, extra in (("port", xpic.main, ["--device=cpu"]),
                            ("jax", jax_main, [])):
        run([*common, *extra,
             f"--particles_output={tmp_path / (who + '_p.nc')}",
             f"--fields_output={tmp_path / (who + '_f.nc')}"])
        out[who] = {**read_all(tmp_path / (who + "_p.nc")),
                    **read_all(tmp_path / (who + "_f.nc"))}
    assert {k: v.shape for k, v in out["port"].items()} == {
        k: v.shape for k, v in out["jax"].items()}
    assert sorted(out["port"]) == ["epara", "n", "vpara", "x"]
    assert all(np.isfinite(v).all() for v in out["port"].values())
    assert out["port"]["n"].max() > 0.0


def test_chip_smoke_pipeline_phases_run_on_the_cpu():
    """chip_smoke's phases 19, 19d, 19b, 19c and 20 at a few rays on the CPU
    (the kernels' plain versions; the CLI's stack named explicitly, since
    it takes the production stack on the card only), so that their checks
    are exercised before a chip run: the CLI's phase function into the
    in-memory store, the root finder, the damped launch, bench_one, xpic,
    and the special functions against scipy."""
    cpu = torch.device("cpu")
    stack = ("--solver=rk2", "--frozen_cells", "--freeze_every=10",
             "--compensated", "--window_kernel", "--f32")
    out = chip_smoke.phase_xrays(cpu, n=64, check_launches=False,
                                 options=stack)
    assert out["timings"]["solver"] == "rk2"
    out = chip_smoke.phase_xrays(
        cpu, n=64, check_launches=False, with_absorption=False, label="19d",
        options=stack + ("--dispersion=cold_plasma_expansion",))
    assert out["timings"]["dispersion"] == "cold_plasma_expansion"
    chip_smoke.phase_xrays_damped(cpu, n=300, check_launches=False,
                                  options=stack)
    assert chip_smoke.phase_cli_extras(cpu, n_float=16, n_complex=8,
                                       particles=512,
                                       check_launches=False) == 0
    chip_smoke.phase_special(cpu, n=5000)
