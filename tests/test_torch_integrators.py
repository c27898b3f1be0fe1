"""The port's split-symplectic and adaptive RK4 steppers against the JAX
package's.

Seeded float64 inputs go through both packages:

* ``split_symplectic_step`` (position-kick-position) on ``light_wave``
  over the density ramp of ``make_slab_density`` - D = wpe^2(x) + |k|^2 -
  w^2 is separable - and the Solver's ``split_simplextic`` trace;
* ``check_separable`` on that separable case and on ``ordinary_wave``,
  whose drift depends on the position through B's direction... and on the
  wave number through D_w, which the Solver refuses as the reference does
  ("Hamiltonian is not separable.");
* ``adaptive_rk4_carry_step`` on the stiff system (one step from the same
  carry, two launches), and the Solver's adaptive run, whose per-ray (dt,
  lambda) persist across recorded steps.

Tolerance 1e-10 relative to each leaf group's scale (position, wave
vector), as the other trace tests: the two packages round the same
algebra differently by ~1e-14 an evaluation.  The adaptive (dt, lambda)
are Newton roots of a loss whose loop stops where its residual stagnates,
so they agree only as far as the two loops' last iterates do: one step
reads 3e-11 relative in dt, and each further step multiplies the
difference by some 100 (the persisted lambda grows by that factor a step,
which is what drives dt to zero): ADAPTIVE_TOL holds one step to 1e-9 and
two steps to 1e-6.  The adaptive cases are single rays: the loop's stop
test takes the ensemble's largest residual, so rays in one call steer
each other's iteration counts.  On the O-mode slab the scheme leaves the
domain (dt < 0), where the two packages' roots share only their sign
(tests/test_torch_referee.py pins that).
"""

import numpy as np
import pytest
import torch

from graph_framework_tpu.models import dispersion as jax_disp
from graph_framework_tpu.models import equilibrium as jax_equilibrium
from graph_framework_tpu.models.rays import make_ray_rhs as jax_make_ray_rhs
from graph_framework_tpu.ops.adaptive import (
    adaptive_rk4_carry_step as jax_adaptive_step,
    init_adaptive_carry as jax_init_adaptive_carry)
from graph_framework_tpu.ops.integrators import (
    check_separable as jax_check_separable,
    split_symplectic_step as jax_split_step)
from graph_framework_tpu.solver import Solver as JaxSolver
from graph_framework_tpu_torch.models import dispersion, equilibrium
from graph_framework_tpu_torch.models.rays import make_ray_rhs
from graph_framework_tpu_torch.ops.adaptive import (
    AdaptiveCarry, adaptive_rk4_carry_step, adaptive_rk4_step,
    init_adaptive_carry)
from graph_framework_tpu_torch.ops.integrators import (
    check_separable, split_symplectic_step)
from graph_framework_tpu_torch.solver import Solver
from test_torch_common import both_states, leaf_errors

TOL = 1e-10
#: one adaptive step, two adaptive steps (the module docstring)
ADAPTIVE_TOL = (1e-9, 1e-6)


def _slab_states(n=16, seed=21):
    """(JAX, port) states over the slab: w in 700-1000 /m, positions within
    0.5 m, wave vectors of 300-600 /m."""
    rng = np.random.default_rng(seed)
    k = rng.normal(size=(3, n))
    k *= rng.uniform(300.0, 600.0, n) / np.linalg.norm(k, axis=0)
    return both_states(dict(
        t=np.zeros(n), w=rng.uniform(700.0, 1000.0, n),
        x=rng.uniform(-0.5, 0.5, n), y=rng.uniform(-0.5, 0.5, n),
        z=rng.uniform(-0.5, 0.5, n), kx=k[0], ky=k[1], kz=k[2]))


def _stiff_state(x, kx):
    """(JAX, port) one ray of the stiff system at (x, kx), w = 1."""
    one = np.ones(1)
    return both_states(dict(t=0 * one, w=one, x=x * one, y=0 * one,
                            z=0 * one, kx=kx * one, ky=0 * one, kz=0 * one))


def _rel(got, want):
    want = np.asarray(want, dtype=np.float64)
    return float(np.max(np.abs(got.numpy() - want))
                 / max(np.max(np.abs(want)), 1e-300))


def test_split_symplectic_step_matches_jax():
    jst, pst = _slab_states()
    jrhs = jax_make_ray_rhs(jax_disp.light_wave,
                            jax_equilibrium.make_slab_density())
    prhs = make_ray_rhs(dispersion.light_wave,
                        equilibrium.make_slab_density())
    want = jax_split_step(jrhs, jst, 1e-3)
    got = split_symplectic_step(prhs, pst, 1e-3)
    errs = leaf_errors(got, want)
    assert max(errs.values()) < TOL, errs
    # and it moved: a step is not the identity
    assert max(leaf_errors(pst, want).values()) > 1e3 * TOL


@pytest.mark.parametrize("name,separable", [("light_wave", True),
                                            ("ordinary_wave", False)])
def test_check_separable_matches_jax(name, separable):
    jst, pst = _slab_states()
    jeq, peq = (jax_equilibrium.make_slab_density(),
                equilibrium.make_slab_density())
    want = jax_check_separable(
        jax_make_ray_rhs(jax_disp.DISPERSIONS[name], jeq), jst)
    got = check_separable(
        make_ray_rhs(dispersion.DISPERSIONS[name], peq), pst)
    assert got is want is separable


def test_solver_split_simplextic_matches_jax():
    """The Solver's split_simplextic run on the separable case against
    the JAX Solver's; a system that is not separable is refused at the
    first entry."""
    jst, pst = _slab_states()
    kw = dict(method="split_simplextic", dt=1e-3, sub_steps=5)
    want = JaxSolver(jax_disp.light_wave,
                     jax_equilibrium.make_slab_density(), **kw).run(jst, 4)
    got = Solver(dispersion.light_wave, equilibrium.make_slab_density(),
                 **kw).run(pst, 4)
    errs = leaf_errors(got, want)
    assert max(errs.values()) < TOL, errs
    sol = Solver(dispersion.ordinary_wave, equilibrium.make_slab_density(),
                 **kw)
    for entry in (lambda: sol.run(pst, 1), lambda: sol.step_fn()(pst)):
        with pytest.raises(ValueError, match="Hamiltonian is not separable"):
            entry()


@pytest.mark.parametrize("x,kx,dt", [(1.0, 1.0, 1e-4), (1.0, 1.0, 5e-5)])
def test_adaptive_carry_step_matches_jax(x, kx, dt):
    """One adaptive step from the same carry (dt, lambda = 1) on the stiff
    system: the adapted (dt, lambda) and the advanced state."""
    jst, pst = _stiff_state(x, kx)
    jeq, peq = (jax_equilibrium.make_no_magnetic_field(),
                equilibrium.make_no_magnetic_field())
    jfn, pfn = jax_disp.stiff, dispersion.stiff
    want = jax_adaptive_step(jfn, jeq, jax_make_ray_rhs(jfn, jeq),
                             jax_init_adaptive_carry(jst, dt))
    got = adaptive_rk4_carry_step(pfn, peq, make_ray_rhs(pfn, peq),
                                  init_adaptive_carry(pst, dt))
    assert isinstance(got, AdaptiveCarry)
    assert _rel(got.dt, want.dt) < ADAPTIVE_TOL[0]
    assert _rel(got.lam, want.lam) < ADAPTIVE_TOL[0]
    assert abs(float(got.dt[0]) - dt) > 1e-2 * dt    # it adapted
    errs = leaf_errors(got.state, want.state)
    assert max(errs.values()) < TOL, errs
    # the single-shot form takes the same step
    once = adaptive_rk4_step(pfn, peq, make_ray_rhs(pfn, peq), pst, dt)
    assert all(torch.equal(a, b) for a, b in zip(once, got.state))


def test_solver_adaptive_persists_the_carry():
    """Solver(adaptive_rk4): run's carry holds the per-ray (dt, lambda),
    which persist across recorded steps as the JAX Solver's do; step_fn
    over a plain RayState starts afresh on each call."""
    jst, pst = _stiff_state(1.0, 1.0)
    kw = dict(method="adaptive_rk4", dt=1e-4, sub_steps=1)
    jeq, peq = (jax_equilibrium.make_no_magnetic_field(),
                equilibrium.make_no_magnetic_field())
    want, wcarry = JaxSolver(jax_disp.stiff, jeq, **kw).run(
        jst, 2, return_carry=True)
    sol = Solver(dispersion.stiff, peq, **kw)
    got, carry = sol.run(pst, 2, return_carry=True)
    assert isinstance(carry, AdaptiveCarry)
    assert _rel(carry.dt, wcarry.dt) < ADAPTIVE_TOL[1]
    assert _rel(carry.lam, wcarry.lam) < ADAPTIVE_TOL[1]
    errs = leaf_errors(got, want)
    assert max(errs.values()) < TOL, errs
    # carry_step_fn continues from the carry; step_fn starts afresh
    step = sol.carry_step_fn()
    one = step(sol.init_carry(pst))
    two = step(one)
    assert not torch.equal(two.dt, one.dt)
    fresh = sol.step_fn()
    assert torch.equal(fresh(pst).x, one.state.x)
    assert torch.equal(fresh(one.state).x, step(sol.init_carry(
        one.state)).state.x)
