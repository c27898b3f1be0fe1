"""The other eight dispersions of the EFIT window kernels against the JAX
window kernel.

The kernels K1, K2 and K3 take every real dispersion the JAX window kernel
takes: beside cold plasma and the O and X modes
(tests/test_torch_efit_modes.py), the eight tails of
``chip_smoke.TAILS`` (cold_plasma_expansion, bohm_gross, light_wave,
ion_cyclotron, acoustic_wave, simple, gaussian_well, stiff; a hand-written
reverse sweep of each D, csrc/efit_adjoint.cuh).  On the CPU the port's
wrapper runs the plain versions with the dispersion; the JAX side runs its
window kernel, which takes any dispersion, in interpret mode, as the
cold-plasma and mode tests do.  256 rays of each tail's own launch
(``chip_smoke.tail_launch``: its k component solved by the port's
``init_k``, or a fixed state where D has no real root, and its dt), the
same float64 arrays on both sides, over the synthetic EFIT file.

* the window: STEPS recorded steps of K = 5 windows, rk2/rk4 x plain/
  compensated, against ``make_frozen_window_step(eq, dispersion, ...)``;
* the VJP and the block cotangents: tests/test_torch_efit_tails_grad.py.

Tolerance 1e-10 relative to each leaf group's scale (forward) and to each
leaf's or table's largest magnitude (gradients), the limits of the O/X
tests.  The kernels' own source runs against the same plain versions in
tests/test_torch_efit_window_host.py and tests/test_torch_efit_bwd_host.py,
and on the card in chip_smoke's phase 3c.
"""

import jax
import pytest

import chip_smoke
from graph_framework_tpu.models import dispersion as jax_disp
from graph_framework_tpu.ops.compensated import (
    comp_state as jax_comp_state, init_comp_carry as jax_init_comp_carry)
from graph_framework_tpu.pallas.efit_step import make_frozen_window_step
from graph_framework_tpu_torch.kernels import efit_step
from graph_framework_tpu_torch.models.rays import RayState
from graph_framework_tpu_torch.ops.compensated import (
    comp_state, init_comp_carry)
from test_torch_common import both_states, leaf_errors, load_both

SUB_STEPS, STEPS = 10, 2
TOL = 1e-10
TAGS = list(chip_smoke.TAILS)


@pytest.fixture(scope="module")
def eqs(tmp_path_factory):
    return load_both("synthetic", tmp_path_factory)


_ROOTS = {}


def roots(eqs, tag):
    """(JAX state, port state, dt) of the launch of ``tag``: the port's
    root, handed to both packages as the same float64 arrays."""
    if tag not in _ROOTS:
        _, peq = eqs
        state, dt = chip_smoke.tail_launch(tag, 256, peq)
        arrays = {f: leaf.numpy() for f, leaf in zip(RayState._fields,
                                                     state)}
        _ROOTS[tag] = (*both_states(arrays), dt)
    return _ROOTS[tag]


def _jax_fn(tag):
    return jax_disp.DISPERSIONS[chip_smoke.TAILS[tag].__name__]


@pytest.mark.parametrize("compensated", [False, True],
                         ids=["plain", "compensated"])
@pytest.mark.parametrize("method", ["rk2", "rk4"])
@pytest.mark.parametrize("tag", TAGS)
def test_tail_window_matches_jax_window_kernel(eqs, tag, method,
                                               compensated):
    """STEPS recorded steps of K = 5 windows: efit_window with the tail's
    dispersion (its plain version here) against the JAX window kernel."""
    jeq, peq = eqs
    jroot, proot, dt = roots(eqs, tag)
    step = make_frozen_window_step(
        jeq, _jax_fn(tag), method=method, dt=dt, sub_steps=SUB_STEPS,
        freeze_every=5, block_rows=2, compensated=compensated,
        interpret=True)

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
            peq, carry, method=method, dt=dt, steps=5,
            compensated=compensated, dispersion=chip_smoke.TAILS[tag])
    got = comp_state(carry) if compensated else carry
    errs = leaf_errors(got, want)
    assert max(errs.values()) < TOL, errs
    assert efit_step.efit_window_launches == 0
