"""The port against the independent referee fixtures.

``tests/fixtures/golden_*.npz`` were made by ``tools/golden_reference.py``,
an implementation of the same physics that shares no code with either
package (scipy DOP853 at rtol 1e-12, ray equations by finite differences,
raw global spline polynomials).  tests/test_reference_parity.py holds the
JAX package to them; this file holds the port, on the CPU in float64, to
the same fixtures at the same tolerances:

* ``init_k`` from the fixtures' guesses (rtol 1e-9 for the analytic
  configs, 5e-8 for the spline ones, atol 1e-9);
* the recorded trajectories (positions rtol 1e-6, atol 1e-8; wave vectors
  rtol 1e-6, atol 2e-8 of the largest launch |k|), rk4 at the fixtures'
  dt;
* ``adaptive_rk4`` on the stiff system against its analytic referee at
  the landed times, and the scheme's failure on the O-mode slab (dt leaves
  the domain) with the fixed-step rk4 trace checked there at its landed
  time;
* the endpoint gradients: tests/test_torch_referee_grad.py.

Configs 1, 2 and 2b need only the analytic equilibria.  Config 3 reads
the reference's ``efit.nc`` and config 4 its ``vmec.nc``: their legs skip
where the file is absent.
"""

import pathlib

import numpy as np
import pytest
import torch

from conftest import REFERENCE_DATA
from graph_framework_tpu_torch.models import dispersion
from graph_framework_tpu_torch.models.efit import make_efit
from graph_framework_tpu_torch.models.equilibrium import (
    make_gaussian_density, make_no_magnetic_field, make_slab_density)
from graph_framework_tpu_torch.models.vmec import make_vmec
from graph_framework_tpu_torch.solver import Solver, init_k, make_ray_state

FIXTURES = pathlib.Path(__file__).resolve().parent / "fixtures"


def _reference_file(name):
    path = REFERENCE_DATA / name
    if not path.exists():
        pytest.skip(f"{path} is not present")
    return path


# name -> (dispersion, equilibrium factory, substep dt), as
# tests/test_reference_parity.py CONFIGS
CONFIGS = {
    "golden_config1_omode_slab": (
        dispersion.ordinary_wave, make_slab_density, 1.0e-3),
    "golden_config2_xmode_slab": (
        dispersion.extra_ordinary_wave, make_slab_density, 1.0e-3),
    "golden_config2_bohm_gross": (
        dispersion.bohm_gross, make_gaussian_density, 2.5e-4),
    "golden_config3_efit": (
        dispersion.cold_plasma,
        lambda: make_efit(_reference_file("efit.nc"), device="cpu"),
        2.5e-4),
    "golden_config4_vmec": (
        dispersion.cold_plasma,
        lambda: make_vmec(_reference_file("vmec.nc"), device="cpu"),
        2.0e-6),
}

K_NAMES = ("kx", "ky", "kz")


def load(name):
    return dict(np.load(FIXTURES / f"{name}.npz"))


def solver_for(name, gold, horizon=None):
    """(Solver of rk4 steps of the fixture's dt, each recorded step
    reaching the next record time - or ``horizon`` in one - the
    equilibrium, the number of recorded steps)."""
    disp, make_eq, dt = CONFIGS[name]
    eq = make_eq()
    n_rec = 1 if horizon else len(gold["t_record"]) - 1
    interval = horizon or float(gold["t_record"][-1]) / n_rec
    sub = int(round(interval / dt))
    assert abs(sub * dt - interval) < 1e-12 * max(1.0, interval)
    return Solver(disp, eq, method="rk4", dt=dt, sub_steps=sub), eq, n_rec


def launch_state(gold, k):
    p = gold["p_launch"]
    return make_ray_state(
        p.shape[0], w=float(gold["w"]), x=torch.from_numpy(p[:, 0]),
        y=torch.from_numpy(p[:, 1]), z=torch.from_numpy(p[:, 2]),
        kx=torch.from_numpy(k[:, 0]), ky=torch.from_numpy(k[:, 1]),
        kz=torch.from_numpy(k[:, 2]), dtype=torch.float64, device="cpu")


@pytest.mark.parametrize("name", list(CONFIGS))
def test_newton_init_k_matches_referee(name):
    gold = load(name)
    _, eq, _ = solver_for(name, gold)
    st = init_k(launch_state(gold, gold["k_guess"]), CONFIGS[name][0], eq,
                K_NAMES[int(gold["which"])], tolerance=1.0e-24,
                max_iterations=100)
    ours = torch.stack([st.kx, st.ky, st.kz], dim=1).numpy()
    rtol = 1e-9 if name.startswith(("golden_config1",
                                    "golden_config2")) else 5e-8
    np.testing.assert_allclose(ours, gold["k_init"], rtol=rtol, atol=1e-9)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_trajectory_matches_referee(name):
    gold = load(name)
    sol, _, n_rec = solver_for(name, gold)
    _, traj = sol.trace(launch_state(gold, gold["k_init"]), n_rec)
    ours = torch.stack(list(traj[2:]), dim=-1).transpose(0, 1).numpy()
    k_scale = float(np.abs(gold["k_init"]).max())
    np.testing.assert_allclose(ours[..., :3], gold["traj"][..., :3],
                               rtol=1e-6, atol=1e-8)
    np.testing.assert_allclose(ours[..., 3:], gold["traj"][..., 3:],
                               rtol=1e-6, atol=2e-8 * k_scale)


def test_adaptive_rk4_matches_referee():
    """adaptive_rk4 on the stiff system D = (1e3 (x - e^-t) - e^-t) kx + w,
    whose referee is analytic: every state lies on the referee trajectory
    at its landed time, and the first step adapts dt away from the
    configured 1e-4.  The persisted (dt, lambda) then drive dt towards
    zero: the trace stalls (the reference's scheme, kept)."""
    gold = load("golden_adaptive_stiff")
    ts_ref, traj_ref = gold["t_record"], gold["traj"][0]
    st = make_ray_state(1, w=float(gold["w"]), x=1.0, kx=1.0,
                        dtype=torch.float64, device="cpu")
    sol = Solver(dispersion.stiff, make_no_magnetic_field(),
                 method="adaptive_rk4", dt=1.0e-4, sub_steps=1)
    step = sol.carry_step_fn()
    carry = sol.init_carry(st)
    first_dt = None
    for _ in range(10):
        carry = step(carry)
        if first_dt is None:
            first_dt = float(carry.dt[0])
        s = sol.carry_state(carry)
        t = float(s.t[0])
        assert t < float(ts_ref[-1])
        x_ref = float(np.interp(t, ts_ref, traj_ref[:, 0]))
        k_ref = float(np.interp(t, ts_ref, traj_ref[:, 3]))
        np.testing.assert_allclose(float(s.x[0]), x_ref, atol=5e-8)
        np.testing.assert_allclose(float(s.kx[0]), k_ref, rtol=1e-5)
    assert abs(first_dt - 1.0e-4) > 1.0e-6
    assert float(carry.dt[0]) < 1e-20    # stalled


def test_adaptive_scheme_domain_boundary():
    """On the O-mode slab rk4 conserves D to rounding, the lambda update
    divides by D^2 ~ 0 and dt leaves the domain after one adaptive step
    (the reference's scheme, pinned as the JAX package's test pins it);
    the same fixture holds the fixed-step rk4 trace at its landed time."""
    gold = load("golden_adaptive_omode_slab")
    eq = make_slab_density()
    st = launch_state(gold, gold["k_init"])
    sol = Solver(dispersion.ordinary_wave, eq, method="adaptive_rk4",
                 dt=1.0e-3, sub_steps=1)
    carry = sol.carry_step_fn()(sol.init_carry(st))
    assert float(carry.dt.min()) < 0.0

    ts_ref, traj_ref = gold["t_record"], gold["traj"]
    step = Solver(dispersion.ordinary_wave, eq, method="rk4", dt=1.0e-3,
                  sub_steps=10).step_fn()
    s = st
    for _ in range(8):
        s = step(s)
    t = float(s.t[0])
    for r in range(traj_ref.shape[0]):
        want = np.array([np.interp(t, ts_ref, traj_ref[r][:, c])
                         for c in range(6)])
        ours = np.array([float(a[r]) for a in
                         (s.x, s.y, s.z, s.kx, s.ky, s.kz)])
        scale = np.maximum(np.abs(want), 1.0)
        np.testing.assert_allclose(ours / scale, want / scale, rtol=0,
                                   atol=1e-6)
