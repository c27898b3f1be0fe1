"""Shared inputs of the PyTorch-port tests, and the package-boundary tests.

The port (``graph_framework_tpu_torch``) is held to the JAX package on the
same inputs: a synthetic EFIT file written by the JAX package's
``write_efit_file`` (the flux map and profiles of ``chip_smoke.py``, so
the card's smoke run equilibrium is exercised here too), loaded by both
packages' ``make_efit``; and the reference's ``efit.nc`` where that file
is present.  Launch states come from a seeded numpy generator and go to
both packages as the same float64 arrays.

The other ``test_torch_*`` files import the helpers below.
"""

import os
import shutil
import subprocess
import sys
import types
from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from conftest import REFERENCE_DATA, REPO_ROOT
from graph_framework_tpu.models.efit import make_efit as jax_make_efit
from graph_framework_tpu.solver import make_ray_state as jax_make_ray_state
from graph_framework_tpu.tools.make_splines import write_efit_file
from graph_framework_tpu_torch.convert import ray_state_from_numpy
from graph_framework_tpu_torch.models.efit import make_efit

torch.set_num_threads(2)

#: The EFIT inputs every port test runs on.
SOURCES = ["synthetic", "efit.nc"]
NUM_RAYS = 256


def efit_path(source, tmp_path_factory):
    """Path of the EFIT file for ``source``; skips when the reference's
    efit.nc is not present."""
    if source == "efit.nc":
        path = REFERENCE_DATA / "efit.nc"
        if not path.exists():
            pytest.skip(f"{path} is not present")
        return path
    path = tmp_path_factory.mktemp("efit") / "synthetic_efit.nc"
    write_efit_file(path, **chip_smoke.synthetic_samples())
    return path


def load_both(source, tmp_path_factory):
    """(JAX equilibrium, port equilibrium), both float64, one file."""
    path = efit_path(source, tmp_path_factory)
    return (jax_make_efit(path, dtype=jnp.float64),
            make_efit(path, device="cpu"))


def launch_arrays(n=NUM_RAYS, seed=0):
    """The launch of chip_smoke.py (the reference benchmark's values with
    x and ky spread normally) as float64 numpy arrays, kx unsolved."""
    rng = np.random.default_rng(seed)
    x = chip_smoke.X0 + chip_smoke.X_SPREAD * rng.standard_normal(n)
    ky = chip_smoke.KY0 + chip_smoke.KY_SPREAD * rng.standard_normal(n)
    full = np.full(n, 1.0)
    return dict(t=0.0 * full, w=chip_smoke.W0 * full, x=x, y=0.0 * full,
                z=0.0 * full, kx=chip_smoke.KX0 * full, ky=ky,
                kz=0.0 * full)


def both_states(arrays):
    """(JAX RayState, port RayState) of the same float64 arrays."""
    jax_state = jax_make_ray_state(len(arrays["x"]), **arrays)
    return jax_state, ray_state_from_numpy(jax_state, device="cpu")


def leaf_errors(port_state, jax_state):
    """Per-leaf deviation of the port from JAX, relative to the scale of
    the leaf's group (chip_smoke.leaf_errors)."""
    return chip_smoke.leaf_errors(port_state,
                                  ray_state_from_numpy(jax_state,
                                                       device="cpu"))


# -- the package boundary ----------------------------------------------------

PORT = REPO_ROOT / "graph_framework_tpu_torch"

_NO_JAX_SCRIPT = """
import sys, torch
import graph_framework_tpu_torch
import chip_smoke
from graph_framework_tpu_torch.models.dispersion import cold_plasma
from graph_framework_tpu_torch.solver import Solver, init_k
eq = chip_smoke.synthetic_equilibrium(torch.float64, "cpu", grid=33)
state = init_k(chip_smoke.launch(8, torch.float64, "cpu"), cold_plasma, eq)
out = Solver(cold_plasma, eq, method="rk2", dt=1e-4, sub_steps=2,
             frozen_cells=True, freeze_every=2, compensated=True,
             window_kernel=True).run(state, 1)
assert bool(torch.isfinite(out.x).all())
from graph_framework_tpu_torch.models.pic import run_pic
assert bool(torch.isfinite(run_pic(64, 16, 1, device="cpu").x).all())
from graph_framework_tpu_torch.kernels import vmec_modes
veq = chip_smoke.synthetic_vmec(torch.float32, "cpu", knots=11,
                                fused_mode_sums=True)
vst = init_k(chip_smoke.vmec_launch(4, torch.float32, "cpu"), cold_plasma,
             veq)
vout = Solver(cold_plasma, veq, method="rk2", dt=2.5e-6, sub_steps=2,
              frozen_cells=True, freeze_every=2).run(
    Solver(cold_plasma, veq, method="rk2", dt=2.5e-6).run(vst, 1), 1)
assert bool(torch.isfinite(vout.kx).all())
from graph_framework_tpu_torch import postprocess
from graph_framework_tpu_torch.cli import xkorc, xpic, xrays, xrays_bench
from graph_framework_tpu_torch.io import AsyncWriter, ResultFile, state_row
from graph_framework_tpu_torch.models.absorption import make_weak_damping
kamp = make_weak_damping(eq)(init_k(chip_smoke.launch(
    4, torch.complex128, "cpu"), cold_plasma, eq))
assert bool(torch.isfinite(kamp).all())
from graph_framework_tpu_torch import utils
from graph_framework_tpu_torch.io import restore_ray_state, save_ray_state
from graph_framework_tpu_torch.models.absorbed_power import (
    absorbed_power_fn)
with torch.no_grad():
    power = absorbed_power_fn(eq, state, 1, 10, form="kernel")(
        eq.psi_coeffs, 0.0)
assert bool(torch.isfinite(power))
from graph_framework_tpu_torch import capi_bridge, expr
x = expr.variable(8, 3.0, "x", device="cpu")
work = expr.Workflow(device="cpu")
expr.newton(work, [x], [x], x * x - 2.0, tolerance=1e-28)
work.compile()
work.run()
assert abs(float(x.data[0]) - 2.0 ** 0.5) < 1e-12
from graph_framework_tpu_torch.parallel import (
    distributed, ray_mesh, run_blocked_sharded, shard_rays)
mesh = ray_mesh(device="cpu")
assert distributed.host_output_filename() == "result0.nc"
assert bool(torch.isfinite(run_blocked_sharded(Solver(
    cold_plasma, eq, method="rk2", dt=1e-4), shard_rays(state, mesh), 1,
    mesh).x).all())
print(sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.")
             or m == "graph_framework_tpu"
             or m.startswith("graph_framework_tpu.")))
"""


def test_port_never_imports_jax():
    """Importing the port and running one solver step (in a fresh
    interpreter) loads neither jax nor the JAX package."""
    env = dict(os.environ, PYTHONPATH=str(REPO_ROOT))
    out = subprocess.run([sys.executable, "-c", _NO_JAX_SCRIPT], env=env,
                         cwd=REPO_ROOT, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]", out.stdout


@pytest.mark.parametrize("name", ["jax", "graph_framework_tpu"])
def test_port_sources_import_no_jax(name):
    """No module of the port (nor chip_smoke.py) names jax or the JAX
    package in an import statement."""
    files = sorted(PORT.rglob("*.py")) + [REPO_ROOT / "chip_smoke.py"]
    bad = []
    for path in files:
        for line in path.read_text().splitlines():
            words = line.split()
            if (len(words) >= 2 and words[0] in ("import", "from")
                    and words[1].split(".")[0] == name):
                bad.append(f"{path.name}: {line.strip()}")
    assert not bad, bad


def _entry_points(tmp_path_factory):
    """Each entry point of the port that makes tensors, called without a
    device (so on the card), as a zero-argument callable."""
    from graph_framework_tpu.tools.make_splines import write_vmec_file
    from graph_framework_tpu_torch import convert, expr, parallel
    from graph_framework_tpu_torch.cli import xkorc, xpic, xrays, xrays_bench
    from graph_framework_tpu_torch.models import (
        absorption, efit, korc, pic, vmec)
    from graph_framework_tpu_torch.models.equilibrium import make_slab
    from graph_framework_tpu_torch.solver import make_ray_state
    from graph_framework_tpu_torch.tools.make_splines import (
        efit_tables, vmec_tables)

    samples = chip_smoke.synthetic_samples(grid=9)
    cpu_eq = chip_smoke.synthetic_equilibrium(torch.float64, "cpu", grid=9)
    vmec_samples = chip_smoke.synthetic_vmec_samples(knots=11)
    cpu_vmec = chip_smoke.synthetic_vmec(torch.float64, "cpu", knots=11)
    vmec_path = tmp_path_factory.mktemp("vmec") / "synthetic_vmec.nc"
    write_vmec_file(vmec_path, **vmec_samples)
    ray = types.SimpleNamespace(**{f: np.zeros(2) for f in (
        "t", "w", "x", "y", "z", "kx", "ky", "kz")})
    particle = types.SimpleNamespace(**{f: np.zeros(2) for f in (
        "x", "y", "z", "ux", "uy", "uz", "gamma")})
    state = types.SimpleNamespace(**{f: np.zeros(2) for f in (
        "x", "vpara", "epara", "n")})
    return {
        "make_ray_state": lambda: make_ray_state(2, w=1.0),
        "efit_from_tables": lambda: efit.efit_from_tables(
            efit_tables(**samples)),
        "make_efit": lambda: efit.make_efit(
            efit_path("synthetic", tmp_path_factory)),
        "efit_from_numpy": lambda: convert.efit_from_numpy(cpu_eq),
        "vmec_from_tables": lambda: vmec.vmec_from_tables(
            vmec_tables(**vmec_samples)),
        "make_vmec": lambda: vmec.make_vmec(vmec_path),
        "vmec_from_numpy": lambda: convert.vmec_from_numpy(cpu_vmec),
        "ray_state_from_numpy": lambda: convert.ray_state_from_numpy(ray),
        "particle_state_from_numpy":
            lambda: convert.particle_state_from_numpy(particle),
        "pic_state_from_numpy": lambda: convert.pic_state_from_numpy(state),
        "run_korc": lambda: korc.run_korc(cpu_eq, 2, 1),
        "make_deposit": lambda: pic.make_deposit(8, 0.25, -1.0,
                                                 torch.float32),
        "pic_start": lambda: pic.pic_start(8, 8),
        "run_pic": lambda: pic.run_pic(8, 8, 1),
        "run_absorption": lambda: _run_absorption_default(),
        "restore_ray_state": lambda: _restore_default(tmp_path_factory),
        "restore_ray_state_mesh": lambda: _restore_default(
            tmp_path_factory, mesh=True),
        "ray_mesh": lambda: parallel.ray_mesh(),
        "make_weak_damping": lambda: absorption.make_weak_damping(
            make_slab())(make_ray_state(2, w=1.0, dtype=torch.complex128)),
        "run_xrays": lambda: xrays.run_xrays(
            xrays.build_parser().parse_args(["--num_rays=2"]), make_slab(),
            chip_smoke.MemoryFiles().open),
        "run_xkorc": lambda: xkorc.run_xkorc(
            xkorc.build_parser().parse_args([
                "--equilibrium_file=unused", "--num_particles=2",
                "--num_steps=1"]), cpu_eq, chip_smoke.MemoryFiles().open),
        "run_xpic": lambda: xpic.run_xpic(
            xpic.build_parser().parse_args([
                "--num_particles=8", "--num_grid=8", "--num_steps=1"]),
            chip_smoke.MemoryFiles().open),
        "bench_one": lambda: xrays_bench.bench_one(
            "double", None, 2, 10, 10, eq=cpu_eq),
        "make_context": lambda: _make_context_default(),
        "evaluate": lambda: (expr.constant(2.0)
                             * expr.sqrt(expr.Constant(3.0))).evaluate(),
        "variable": lambda: expr.variable(4, 1.0, "x"),
        "Workflow": lambda: _workflow_default(),
    }


def _make_context_default():
    """capi_bridge.make_context without GRAPH_TORCH_DEVICE."""
    from graph_framework_tpu_torch import capi_bridge
    with mock.patch.dict(os.environ):
        os.environ.pop(capi_bridge.DEVICE_VARIABLE, None)
        capi_bridge.make_context(1, False)


def _workflow_default():
    """A Workflow without a device, of an item without variables."""
    from graph_framework_tpu_torch import expr
    work = expr.Workflow()
    work.add_item([], [expr.constant(2.0) + expr.random(4)], [])
    work.compile()
    work.run()


def _restore_default(tmp_path_factory, mesh=False):
    """restore_ray_state without a template or a device; with ``mesh``,
    rank 1's slice of two under a mesh on the card's default device."""
    from graph_framework_tpu_torch.io import (
        restore_ray_state, save_ray_state)
    from graph_framework_tpu_torch.models.rays import RayState
    from graph_framework_tpu_torch.parallel.mesh import RayMesh
    path = tmp_path_factory.mktemp("checkpoint")
    save_ray_state(path, RayState(*[torch.zeros(2)] * 8))
    if mesh:
        restore_ray_state(path, mesh=RayMesh(2, 1, torch.device("cuda", 0)))
    else:
        restore_ray_state(path)


def _run_absorption_default():
    """run_absorption without a device over a one-row in-memory trace."""
    from graph_framework_tpu_torch.models import absorption
    from graph_framework_tpu_torch.models.equilibrium import make_slab
    store = chip_smoke.MemoryStore(2)
    for name in absorption.STATE_NAMES:
        store.create_variable(name)
    store.write_step(0, {name: np.ones(2) for name in absorption.STATE_NAMES})
    absorption.run_absorption(store, make_slab())


ENTRY_POINTS = ["make_ray_state", "efit_from_tables", "make_efit",
                "efit_from_numpy", "vmec_from_tables", "make_vmec",
                "vmec_from_numpy", "ray_state_from_numpy",
                "particle_state_from_numpy", "pic_state_from_numpy",
                "run_korc", "make_deposit", "pic_start", "run_pic",
                "run_absorption", "restore_ray_state",
                "restore_ray_state_mesh", "ray_mesh", "make_weak_damping",
                "run_xrays",
                "run_xkorc", "run_xpic", "bench_one", "make_context",
                "evaluate", "variable", "Workflow"]


@pytest.mark.parametrize("name", ENTRY_POINTS)
def test_entry_points_default_to_the_card(name, tmp_path_factory):
    """Called without a device, an entry point puts its tensors on the
    card: where torch has no CUDA it raises, as torch does for any CUDA
    tensor, and never runs on the CPU instead."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    call = _entry_points(tmp_path_factory)[name]
    with pytest.raises((AssertionError, RuntimeError), match="CUDA"):
        call()


def test_chip_smoke_refuses_without_cuda(tmp_path):
    """chip_smoke.py exits non-zero, and prints no result line, where
    torch has no CUDA device - it never falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    env = dict(os.environ, PYTHONPATH=str(REPO_ROOT))
    out = subprocess.run([sys.executable, str(REPO_ROOT / "chip_smoke.py")],
                         env=env, cwd=tmp_path, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_chip_smoke_alone_fails(tmp_path):
    """chip_smoke.py copied into an empty directory fails: it needs the
    port's package beside it."""
    script = tmp_path / "chip_smoke.py"
    script.write_text((REPO_ROOT / "chip_smoke.py").read_text())
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, str(script)], env=env,
                         cwd=tmp_path, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_ptxas_summary_names_each_variant():
    """chip_smoke reads each kernel variant's registers and spills from
    nvcc's -Xptxas -v output (the format of CUDA 12): K1's
    efit_window_kernel<T, METHOD, COMPENSATED>, the backward kernels'
    efit_window_bwd_kernel<T, METHOD, TAB> (K2 without the table
    cotangents, K3 with them), K5's slab_push_kernel<T>, K6's seven
    kernels (its tile kernel, its bins scan and its rows scan, which has
    no dtype, named here), K4's
    vmec_geom_kernel<T> and K7's vmec_modes_kernel<T>."""
    log = "\n".join([
        "ptxas info    : 0 bytes gmem",
        "ptxas info    : Compiling entry function '_ZN3gft18efit_window_"
        "kernelIdLi4ELb1EEEvNS_9StatePtrsIT_EES3_PKS2_S5_NS_6ParamsIS2_EEix'"
        " for 'sm_90a'",
        "ptxas info    : Function properties for _ZN3gft18efit_window_"
        "kernelIdLi4ELb1EEEvNS_9StatePtrsIT_EES3_PKS2_S5_NS_6ParamsIS2_EEix",
        "    304 bytes stack frame, 352 bytes spill stores, 944 bytes spill "
        "loads",
        "ptxas info    : Used 255 registers, used 0 barriers",
        "ptxas info    : Compile time = 700.410 ms",
        "ptxas info    : Compiling entry function '_ZN3gft18efit_window_"
        "kernelIfLi2ELb0EEEvNS_9StatePtrsIT_EES3_PKS2_S5_NS_6ParamsIS2_EEix'"
        " for 'sm_90a'",
        "ptxas info    : Used 154 registers, used 0 barriers",
        "ptxas info    : Compiling entry function '_ZN3gft22efit_window_bwd_"
        "kernelIfLi4ELb0EEEvNS_9StatePtrsIT_EES3_S3_PKS2_S5_NS_6ParamsIS2_"
        "EEixPS2_S8_PxS9_' for 'sm_90a'",
        "ptxas info    : Function properties for _ZN3gft22efit_window_bwd_"
        "kernelIfLi4ELb0EEEvNS_9StatePtrsIT_EES3_S3_PKS2_S5_NS_6ParamsIS2_"
        "EEixPS2_S8_PxS9_",
        "    6096 bytes stack frame, 7864 bytes spill stores, 10484 bytes "
        "spill loads",
        "ptxas info    : Used 168 registers, used 0 barriers, 6096 bytes "
        "cumulative stack size",
        "ptxas info    : Compiling entry function '_ZN3gft22efit_window_bwd_"
        "kernelIdLi2ELb1EEEvNS_9StatePtrsIT_EES3_S3_PKS2_S5_NS_6ParamsIS2_"
        "EEixPS2_S8_PxS9_' for 'sm_90a'",
        "ptxas info    : Used 255 registers, used 0 barriers",
        "ptxas info    : Compiling entry function '_ZN3gft12_GLOBAL__N_116"
        "slab_push_kernelIfEEvNS0_9ParticlesIT_EENS0_10SlabParamsIS3_EEix' "
        "for 'sm_90a'",
        "ptxas info    : Function properties for _ZN3gft12_GLOBAL__N_116"
        "slab_push_kernelIfEEvNS0_9ParticlesIT_EENS0_10SlabParamsIS3_EEix",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 29 registers, used 0 barriers",
        "ptxas info    : Compiling entry function '_ZN3gft12_GLOBAL__N_119"
        "deposit_tile_kernelIdEEvPKT_iPKNS0_6LayoutIS2_EEPKiS4_S4_PS2_S2_"
        "S2_i' for 'sm_90a'",
        "ptxas info    : Used 40 registers, used 1 barriers, 16640 bytes "
        "smem",
        "ptxas info    : Compiling entry function '_ZN3gft12_GLOBAL__N_119"
        "deposit_bins_kernelIfEEvPNS0_6LayoutIT_EEiPiPKS3_PKi' for "
        "'sm_90a'",
        "ptxas info    : Used 32 registers, used 1 barriers",
        "ptxas info    : Compiling entry function '_ZN3gft12_GLOBAL__N_119"
        "deposit_rows_kernelEPKiiPiS3_' for 'sm_90a'",
        "ptxas info    : Used 16 registers, used 0 barriers",
        "ptxas info    : Compiling entry function '_ZN3gft12_GLOBAL__N_116"
        "vmec_geom_kernelIfEEvPKT_S4_S4_S4_S4_S4_S4_PS2_xiiiS2_S2_S2_' for "
        "'sm_90a'",
        "ptxas info    : Used 72 registers, used 0 barriers",
        "ptxas info    : Compiling entry function '_ZN3gft12_GLOBAL__N_117"
        "vmec_modes_kernelIdEEvPKT_S4_NS0_10ModeBlocksIS2_EES4_S4_PS2_xi' "
        "for 'sm_90a'",
        "ptxas info    : Used 37 registers, used 0 barriers",
    ])
    assert chip_smoke.ptxas_summary(log) == {
        "K5 f32": "0 bytes stack frame, 0 bytes spill stores, 0 bytes "
                  "spill loads; Used 29 registers, used 0 barriers",
        "K6 tile f64": "Used 40 registers, used 1 barriers, 16640 bytes "
                       "smem",
        "K6 bins f32": "Used 32 registers, used 1 barriers",
        "K6 rows": "Used 16 registers, used 0 barriers",
        "K4 f32": "Used 72 registers, used 0 barriers",
        "K7 f64": "Used 37 registers, used 0 barriers",
        "K2 f32/rk4": "6096 bytes stack frame, 7864 bytes spill stores, "
                      "10484 bytes spill loads; Used 168 registers, used 0 "
                      "barriers, 6096 bytes cumulative stack size",
        "K3 f64/rk2": "Used 255 registers, used 0 barriers",
        "f32/rk2/plain": "Used 154 registers, used 0 barriers",
        "f64/rk4/comp": "304 bytes stack frame, 352 bytes spill stores, "
                        "944 bytes spill loads; Used 255 registers, used 0 "
                        "barriers",
    }


def test_ptxas_summary_names_the_modes():
    """The O- and X-mode instances of the window kernels (their Disp
    template argument, OrdinaryWave or ExtraOrdinaryWave, mangled after the
    flags) get variant names of their own: omode f32/rk2/plain, K2 xmode
    f64/rk4, ...; cold plasma's keep theirs."""
    def entry(kernel, args, regs):
        return [f"ptxas info    : Compiling entry function '_ZN3gft{kernel}"
                f"{args}' for 'sm_90a'",
                f"ptxas info    : Used {regs} registers, used 0 barriers"]

    log = "\n".join(
        entry("18efit_window_kernelIfLi2ELb0ENS_10ColdPlasmaEEEv",
              "NS_9StatePtrsIT_EES4_", 110)
        + entry("18efit_window_kernelIfLi2ELb1ENS_12OrdinaryWaveEEEv",
                "NS_9StatePtrsIT_EES4_", 101)
        + entry("18efit_window_kernelIdLi4ELb0ENS_17ExtraOrdinaryWaveEEEv",
                "NS_9StatePtrsIT_EES4_", 202)
        + entry("22efit_window_bwd_kernelIdLi4ELb0ENS_17ExtraOrdinaryWave"
                "EEEv", "NS_9StatePtrsIT_EES4_S4_", 203)
        + entry("22efit_window_bwd_kernelIfLi2ELb1ENS_12OrdinaryWaveEEEv",
                "NS_9StatePtrsIT_EES4_S4_", 150))
    assert chip_smoke.ptxas_summary(log) == {
        "f32/rk2/plain": "Used 110 registers, used 0 barriers",
        "omode f32/rk2/comp": "Used 101 registers, used 0 barriers",
        "xmode f64/rk4/plain": "Used 202 registers, used 0 barriers",
        "K2 xmode f64/rk4": "Used 203 registers, used 0 barriers",
        "K3 omode f32/rk2": "Used 150 registers, used 0 barriers",
    }


def test_sass_per_item_reads_the_hot_loop():
    """chip_smoke's SASS reader (phases 13 and 17): a loop is a backward
    branch; the hot loop is the one whose marker count is a multiple of
    the marker's count an item, the inner one on a tie, and its length is
    shared among the items the compiler unrolled into it."""
    listing = [(0x00, "LDC R1, c[0x0][0x28]"), (0x10, "LDG.E R2, [R4]"),
               (0x20, "MUFU.RSQ R7, R6"), (0x30, "FFMA R2, R3, R4, R5"),
               (0x40, "MUFU.RSQ R8, R6"), (0x50, "MUFU.RCP R9, R6"),
               (0x60, "@P0 BRA 0x20"), (0x70, "IADD3 R1, R1, 0x1, RZ"),
               (0x80, "BRA.U !UP0, 0x10"), (0x90, "EXIT")]
    loops = chip_smoke.sass_loops(listing)
    assert [len(body) for body in loops] == [5, 8]
    assert chip_smoke.sass_per_item(listing, "MUFU.RSQ", 1) == dict(
        per_item=2.5, unrolled=2, mufu=1.5, branches=0.5)
    assert chip_smoke.sass_per_item(listing, "LDG", 1)["per_item"] == 8
    assert chip_smoke.sass_per_item(listing, "MUFU.RSQ", 3) is None


def test_op_counts_match_the_sources():
    """The operation counts behind the kernels' bounds (chip_smoke's
    WINDOW_OPS, kernels.boris.SLAB_PUSH_OPS, kernels.deposit.DEPOSIT_OPS,
    kernels.vmec_geom.JET_OPS, kernels.vmec_modes.MODE_SUM_OPS,
    kernels.vmec_rhs.RHS_OPS) are what
    tools/count_ops.py counts over the CUDA sources as they stand.  K1's
    source runs exactly the stages its count of what the function needs
    takes (D's gradient by the hand-written reverse sweep), so its own
    count equals that count in all four variants of each dispersion."""
    if shutil.which("g++") is None:
        pytest.skip("count_ops needs g++")
    from graph_framework_tpu_torch.kernels import (
        boris, deposit, vmec_geom, vmec_modes, vmec_rhs)
    from graph_framework_tpu_torch.tools import count_ops

    counted = count_ops.count()
    assert counted["window"] == chip_smoke.FREEZE_EVERY
    ops = counted["ops"]
    for kernel, value in chip_smoke.WINDOW_OPS.items():
        assert ops[kernel]["per_ray_window"] == value, kernel
    # a bound for every rk2 backward kernel there is, and only for those
    # (no K3 for a tail that reads no table)
    assert {k for k in ops if k[:2] in ("K2", "K3") and k.endswith("rk2")} \
        == {k for k in chip_smoke.WINDOW_OPS
            if k[:2] in ("K2", "K3") and k.endswith("rk2")}
    assert ops["K5"]["per_particle_step"] == boris.SLAB_PUSH_OPS
    for mode in count_ops.DISPERSION_LABELS:
        for variant in ("rk2 plain", "rk2 comp", "rk4 plain", "rk4 comp"):
            kernel = f"K1{mode} {variant}"
            assert (ops[kernel]["source_per_ray_window"]
                    == ops[kernel]["per_ray_window"]), kernel
    assert ops["K6"] == deposit.DEPOSIT_OPS
    assert ops["K4"] == vmec_geom.JET_OPS
    assert ops["K7"] == vmec_modes.MODE_SUM_OPS
    assert ops["K8"] == vmec_rhs.RHS_OPS


def test_synthetic_equilibrium_matches_file(tmp_path_factory):
    """chip_smoke's in-memory equilibrium (no file, no h5py) holds the
    same tables as the file written from the same samples."""
    from_file = make_efit(efit_path("synthetic", tmp_path_factory),
                          device="cpu")
    in_memory = chip_smoke.synthetic_equilibrium(torch.float64, "cpu")
    for name in ("psi_coeffs", "profile_coeffs", "ne_coeffs", "te_coeffs",
                 "pres_coeffs", "fpol_coeffs"):
        assert torch.equal(getattr(from_file, name),
                           getattr(in_memory, name)), name
    for name in ("psimin", "dpsi", "rmin", "dr", "zmin", "dz", "ne_scale",
                 "te_scale", "pres_scale"):
        assert getattr(from_file, name) == getattr(in_memory, name), name
