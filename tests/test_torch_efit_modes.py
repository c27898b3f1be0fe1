"""The O- and X-mode freeze windows against the JAX window kernel.

The EFIT window kernels K1, K2 and K3 implement ``ordinary_wave`` and
``extra_ordinary_wave`` beside cold plasma (a hand-written reverse sweep of
each D, csrc/efit_adjoint.cuh).  On the CPU the port's wrapper runs the
plain versions with the dispersion; the JAX side runs its window kernel,
which takes any dispersion, in interpret mode
(``make_frozen_window_step(eq, ordinary_wave, ...)``), as
tests/test_torch_efit_step.py does for cold plasma.  256 rays of
chip_smoke's launch with kx solved for each mode, float64, over the
synthetic EFIT file.  Tolerance 1e-10 relative to each leaf group's scale
(forward) and to each leaf's largest magnitude (gradients), the limits of
the cold-plasma tests.  The kernels' own source runs against the same
plain versions in tests/test_torch_efit_window_host.py and
tests/test_torch_efit_bwd_host.py, and on the card in chip_smoke's phase
3b; the Solver, the refusals and the gradients are in
tests/test_torch_efit_modes_solver.py.
"""

import jax
import pytest

from graph_framework_tpu.models import dispersion as jax_disp
from graph_framework_tpu.ops.compensated import (
    comp_state as jax_comp_state, init_comp_carry as jax_init_comp_carry)
from graph_framework_tpu.pallas.efit_step import make_frozen_window_step
from graph_framework_tpu.solver import init_k as jax_init_k
from graph_framework_tpu_torch.kernels import efit_step
from graph_framework_tpu_torch.models import dispersion
from graph_framework_tpu_torch.ops.compensated import (
    comp_state, init_comp_carry)
from graph_framework_tpu_torch.solver import init_k
from test_torch_common import (
    both_states, launch_arrays, leaf_errors, load_both)

DT, SUB_STEPS, STEPS = 1e-4, 10, 2
TOL = 1e-10
MODES = ["ordinary_wave", "extra_ordinary_wave"]


@pytest.fixture(scope="module")
def eqs(tmp_path_factory):
    return load_both("synthetic", tmp_path_factory)


_ROOTS = {}


def roots(eqs, name):
    """(JAX root, port root) of the launch for the mode ``name``."""
    if name not in _ROOTS:
        jeq, peq = eqs
        jstate, pstate = both_states(launch_arrays())
        _ROOTS[name] = (
            jax_init_k(jstate, jax_disp.DISPERSIONS[name], jeq, "kx"),
            init_k(pstate, dispersion.DISPERSIONS[name], peq, "kx"))
    return _ROOTS[name]


@pytest.mark.parametrize("compensated", [False, True],
                         ids=["plain", "compensated"])
@pytest.mark.parametrize("method", ["rk2", "rk4"])
@pytest.mark.parametrize("name", MODES)
def test_mode_window_matches_jax_window_kernel(eqs, name, method,
                                               compensated):
    """STEPS recorded steps of K = 5 windows: efit_window with the mode
    (its plain version here) against the JAX window kernel."""
    jeq, peq = eqs
    jroot, proot = roots(eqs, name)
    step = make_frozen_window_step(
        jeq, jax_disp.DISPERSIONS[name], method=method, dt=DT,
        sub_steps=SUB_STEPS, freeze_every=5, block_rows=2,
        compensated=compensated, interpret=True)

    def go(c):
        def body(c, _):
            return step(c), None
        return jax.lax.scan(body, c, None, length=STEPS)[0]

    want = jax.jit(go)(jax_init_comp_carry(jroot) if compensated else jroot)
    want = jax_comp_state(want) if compensated else want
    carry = init_comp_carry(proot) if compensated else proot
    efit_step.efit_window_launches = 0
    for _ in range(STEPS * SUB_STEPS // 5):
        carry = efit_step.efit_window(
            peq, carry, method=method, dt=DT, steps=5,
            compensated=compensated,
            dispersion=dispersion.DISPERSIONS[name])
    got = comp_state(carry) if compensated else carry
    errs = leaf_errors(got, want)
    assert max(errs.values()) < TOL, errs
    assert efit_step.efit_window_launches == 0
