"""Debug mode of the port (``utils.set_debug``) against the JAX package's
tests/test_debug_mode.py, case for case, on the same configurations.

* a NaN/inf-making configuration (w = 0: every 1/w^2 of the dispersion
  divides by zero) raises a located error under debug mode, naming the
  operation, the leaf and the first bad ray;
* the same configuration does not raise with debug off (the values
  propagate, as in production);
* a healthy configuration never raises in either mode - also the EFIT
  production stack through the window kernel's wrapper - and debug mode
  leaves its trace bit for bit as it was.

Besides: the kernel wrappers' output check (``check_kernel_outputs``)
names the kernel, the output and the first bad ray, and does nothing with
debug off; with debug off the Solver's step is not wrapped at all.
"""

import numpy as np
import pytest
import torch

import chip_smoke
from graph_framework_tpu_torch import utils
from graph_framework_tpu_torch.models import dispersion as disp
from graph_framework_tpu_torch.models.equilibrium import (
    make_gaussian_density)
from graph_framework_tpu_torch.solver import Solver, init_k, make_ray_state


@pytest.fixture
def debug_mode():
    """Enable debug mode for the test, always restore afterwards."""
    utils.set_debug(True)
    yield
    utils.set_debug(False)


def _nan_state():
    # w = 0 makes every 1/w^2 term in the dispersion divide by zero
    return make_ray_state(4, w=0.0, kx=0.25, ky=0.25, kz=0.15,
                          device="cpu")


def test_checked_step_raises_located_error_under_debug(debug_mode):
    fn = utils.checked_step(lambda x: torch.sqrt(x) / torch.sum(x))
    with pytest.raises(utils.NonFiniteError) as exc_info:
        fn(torch.zeros(4, dtype=torch.float64))  # 0/0 -> nan
    msg = str(exc_info.value).lower()
    assert "nan" in msg and "ray 0" in msg
    assert "div" in msg


def test_checked_step_silent_without_debug():
    assert not utils.debug_enabled()

    def fn(x):
        return torch.sqrt(x) / torch.sum(x)

    assert utils.checked_step(fn) is fn
    out = fn(torch.zeros(4, dtype=torch.float64))  # must NOT raise
    assert bool(torch.isnan(out).all())


def test_solver_step_raises_on_nan_config_under_debug(debug_mode):
    eq = make_gaussian_density()
    sol = Solver(disp.simple, eq, method="rk4", dt=1.0e-3, sub_steps=2)
    step = sol.step_fn()
    with pytest.raises(utils.NonFiniteError) as exc_info:
        step(_nan_state())
    msg = str(exc_info.value)
    assert "nan" in msg or "inf" in msg
    assert "models/dispersion.py" in msg       # the operation's call site
    assert "kx (" in msg and "ray 0" in msg      # the leaf, the first ray


def test_solver_step_silent_on_nan_config_without_debug():
    assert not utils.debug_enabled()
    eq = make_gaussian_density()
    sol = Solver(disp.simple, eq, method="rk4", dt=1.0e-3, sub_steps=2)
    st = sol.step_fn()(_nan_state())
    # production mode: non-finite values propagate instead of raising
    assert not bool(torch.isfinite(st.kx).all())


def test_solver_healthy_config_never_raises(debug_mode):
    """No false positives: the solver_test configuration runs clean with
    float checks armed, and gives the same trace as without them."""
    eq = make_gaussian_density()
    st = make_ray_state(4, w=0.5, kx=0.25, ky=0.25, kz=0.15, device="cpu")
    st = init_k(st, disp.simple, eq, "kx")
    sol = Solver(disp.simple, eq, method="rk4", dt=0.5, sub_steps=2)
    out = sol.step_fn()(st)
    assert bool(torch.isfinite(out.kx).all())
    utils.set_debug(False)
    plain = sol.step_fn()(st)
    assert all(torch.equal(a, b) for a, b in zip(out, plain))


def test_production_stack_never_raises(debug_mode):
    """The EFIT production stack (frozen rk2, K = 10, compensated, the
    window kernel's wrapper; its plain version on CPU tensors) and the
    plain rk4 trace run clean under debug mode, bit for bit as without."""
    eq = chip_smoke.synthetic_equilibrium(torch.float32, "cpu", grid=33)
    st = init_k(chip_smoke.launch(16, torch.float32, "cpu"),
                disp.cold_plasma, eq)
    for sol in (chip_smoke.production_solver(eq),
                Solver(disp.cold_plasma, eq, method="rk4", dt=1e-4,
                       sub_steps=2)):
        utils.set_debug(True)
        checked = sol.run(st, 2)
        utils.set_debug(False)
        plain = sol.run(st, 2)
        assert all(torch.equal(a, b) for a, b in zip(checked, plain))


def test_kernel_output_check(debug_mode):
    """A kernel wrapper's check names the kernel, the output and the first
    bad ray, and says whether the inputs were already bad; finite outputs
    pass, and with debug off nothing is looked at."""
    good = torch.ones(5)
    bad = torch.tensor([1.0, 2.0, np.inf, np.nan, 3.0])
    utils.check_kernel_outputs("efit_window (K1)", ("x", "kx"),
                               (good, good), (good,))
    with pytest.raises(utils.NonFiniteError) as exc_info:
        utils.check_kernel_outputs("efit_window (K1)", ("x", "kx"),
                                   (good, bad), (good,))
    msg = str(exc_info.value)
    assert "efit_window (K1)" in msg and "kx" in msg
    assert "inf first at ray 2" in msg and "inputs were finite" in msg
    with pytest.raises(utils.NonFiniteError, match="already non-finite"):
        utils.check_kernel_outputs("deposit (K6)", ("n",), (bad,), (bad,),
                                   unit="grid point")
    utils.set_debug(False)
    utils.check_kernel_outputs("efit_window (K1)", ("x",), (bad,))
