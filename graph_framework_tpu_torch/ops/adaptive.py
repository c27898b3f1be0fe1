"""Adaptive-dt RK4 stepper (reference: solver::adaptive_rk4,
solver.hpp:881-1006).

Counterpart of ``graph_framework_tpu.ops.adaptive``.  The reference keeps
``dt`` and ``lambda`` as per-ray variables that persist across solver
steps: before every RK4 step a Newton loop adapts them on the loss

    loss(dt, lambda) = 1/dt + lambda * D(next_state(dt))^2

with next_state(dt) the full RK4 update as a function of the per-ray dt
(solver.hpp:905-930).  Each step's Newton starts from the previous step's
adapted values.  :class:`AdaptiveCarry` carries (dt, lambda) from step to
step, as the reference's device buffers do.

The scheme is the reference's, kept as it is: on the stiff system the
persisted lambda grows and dt shrinks until traces stall; on a dispersion
that RK4 conserves to rounding (the O-mode slab) the lambda update divides
by D^2 ~ 0 and dt leaves the domain (tests/test_reference_parity.py pins
both for the JAX package; tests/test_torch_referee.py for the port).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from graph_framework_tpu_torch.models.rays import (
    RayState, dispersion_residual)
from graph_framework_tpu_torch.ops.integrators import rk4_step
from graph_framework_tpu_torch.ops.newton import newton_solve_multi


class AdaptiveCarry(NamedTuple):
    """Persistent per-ray adaptive-integrator state (the reference's dt and
    lambda device variables, solver.hpp:887-903)."""
    state: RayState
    dt: torch.Tensor     # per-ray time step, kept adapted across steps
    lam: torch.Tensor    # per-ray Lagrange multiplier of the loss


def init_adaptive_carry(state: RayState, dt) -> AdaptiveCarry:
    """The configured scalar dt on every ray and lambda = 1 (the
    reference's initial variable fill, solver.hpp:887-891)."""
    dt0 = torch.full_like(state.t, float(dt))
    return AdaptiveCarry(state=state, dt=dt0, lam=torch.ones_like(dt0))


def adaptive_rk4_carry_step(dispersion: Callable, eq, rhs,
                            carry: AdaptiveCarry, *,
                            tolerance=1.0e-30,
                            max_iterations=1000) -> AdaptiveCarry:
    """One adaptive step: Newton-adapt (dt, lambda) per ray from their
    carried values (``newton_solve_multi``: each unknown by its own
    partial, the reference's stop rules), then take the RK4 step with the
    adapted dt.  Returns the new carry: the state advanced once, (dt,
    lambda) kept for the next step.  The adapted dt carries no gradient:
    the Newton loop is not differentiated, as in the JAX package."""
    state = carry.state
    d_all = dispersion_residual(dispersion, eq)

    def loss(dt_var, lam):
        d = d_all(*rk4_step(rhs, state, dt_var))
        return 1.0 / dt_var + lam * d * d

    (dt_new, lam_new), _, _ = newton_solve_multi(
        loss, (carry.dt, carry.lam), tolerance=tolerance,
        max_iterations=max_iterations)
    return AdaptiveCarry(state=rk4_step(rhs, state, dt_new), dt=dt_new,
                         lam=lam_new)


def adaptive_rk4_step(dispersion: Callable, eq, rhs, state: RayState, dt,
                      *, tolerance=1.0e-30, max_iterations=1000):
    """One adaptive step from a fresh (dt, lambda = 1) carry, returning
    only the new RayState.  For several steps use
    :func:`adaptive_rk4_carry_step` (``Solver.run``/``carry_step_fn``), so
    that the adapted dt persists between steps."""
    return adaptive_rk4_carry_step(
        dispersion, eq, rhs, init_adaptive_carry(state, dt),
        tolerance=tolerance, max_iterations=max_iterations).state
