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
import subprocess
import sys

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
    return jax_make_efit(path, dtype=jnp.float64), make_efit(path)


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
    return jax_state, ray_state_from_numpy(jax_state)


def leaf_errors(port_state, jax_state):
    """Per-leaf deviation of the port from JAX, relative to the scale of
    the leaf's group (chip_smoke.leaf_errors)."""
    return chip_smoke.leaf_errors(port_state,
                                  ray_state_from_numpy(jax_state))


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
    efit_window_kernel<T, METHOD, COMPENSATED> and the backward kernels'
    efit_window_bwd_kernel<T, METHOD, TAB> (K2 without the table
    cotangents, K3 with them)."""
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
    ])
    assert chip_smoke.ptxas_summary(log) == {
        "K2 f32/rk4": "6096 bytes stack frame, 7864 bytes spill stores, "
                      "10484 bytes spill loads; Used 168 registers, used 0 "
                      "barriers, 6096 bytes cumulative stack size",
        "K3 f64/rk2": "Used 255 registers, used 0 barriers",
        "f32/rk2/plain": "Used 154 registers, used 0 barriers",
        "f64/rk4/comp": "304 bytes stack frame, 352 bytes spill stores, "
                        "944 bytes spill loads; Used 255 registers, used 0 "
                        "barriers",
    }


def test_synthetic_equilibrium_matches_file(tmp_path_factory):
    """chip_smoke's in-memory equilibrium (no file, no h5py) holds the
    same tables as the file written from the same samples."""
    from_file = make_efit(efit_path("synthetic", tmp_path_factory))
    in_memory = chip_smoke.synthetic_equilibrium(torch.float64, "cpu")
    for name in ("psi_coeffs", "profile_coeffs", "ne_coeffs", "te_coeffs",
                 "pres_coeffs", "fpol_coeffs"):
        assert torch.equal(getattr(from_file, name),
                           getattr(in_memory, name)), name
    for name in ("psimin", "dpsi", "rmin", "dr", "zmin", "dz", "ne_scale",
                 "te_scale", "pres_scale"):
        assert getattr(from_file, name) == getattr(in_memory, name), name
