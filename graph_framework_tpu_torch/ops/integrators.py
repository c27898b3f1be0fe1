"""Runge-Kutta and symplectic steppers over RayState tuples.

Counterpart of ``graph_framework_tpu.ops.integrators`` (reference:
solver.hpp rk2 :95-125, rk4 :263-330, split_simplextic :1016-1130).
Every stepper maps ``(rhs, state, dt) -> next_state`` with ``dt`` a
Python float or a per-ray tensor (the adaptive stepper's) in normalized
time units (t' = c t, meters); it advances ``t`` by dt and leaves ``w``
untouched.  The increment forms return the raw, unfolded increment the
compensated accumulator needs (ops.compensated).

The EFIT window kernels (csrc/efit_adjoint.cuh) write out the same rk2/rk4
stage algebra; keep the two in step.
"""

from __future__ import annotations

from typing import Callable

import torch

from graph_framework_tpu_torch.models.rays import RayState, RayDerivatives


def _shift(state: RayState, d: RayDerivatives, f, dt_shift) -> RayState:
    """state + f * derivs, with t advanced by dt_shift."""
    return RayState(
        t=state.t + dt_shift,
        w=state.w,
        x=state.x + f * d.dxdt,
        y=state.y + f * d.dydt,
        z=state.z + f * d.dzdt,
        kx=state.kx + f * d.dkxdt,
        ky=state.ky + f * d.dkydt,
        kz=state.kz + f * d.dkzdt,
    )


def _rk2_sum(rhs, state, dt):
    """Heun's averaged slope times dt/2 (solver.hpp rk2:95-125)."""
    d1 = rhs(state)
    d2 = rhs(_shift(state, d1, dt, dt))
    half = dt / 2.0
    return [half * (a + b) for a, b in zip(d1, d2)]


def _rk4_sum(rhs, state, dt):
    """The classical RK4 slope sum times dt/6 (solver.hpp rk4:263-330)."""
    half = dt / 2.0
    d1 = rhs(state)
    d2 = rhs(_shift(state, d1, half, half))
    d3 = rhs(_shift(state, d2, half, half))
    d4 = rhs(_shift(state, d3, dt, dt))
    sixth = dt / 6.0
    return [sixth * (a + 2.0 * (b + c) + e)
            for a, b, c, e in zip(d1, d2, d3, d4)]


def _fold(state: RayState, inc, dt) -> RayState:
    x, y, z, kx, ky, kz = inc
    return RayState(t=state.t + dt, w=state.w,
                    x=state.x + x, y=state.y + y, z=state.z + z,
                    kx=state.kx + kx, ky=state.ky + ky, kz=state.kz + kz)


def _unfolded(state: RayState, inc, dt) -> RayState:
    x, y, z, kx, ky, kz = inc
    return RayState(t=torch.full_like(state.t, dt),
                    w=torch.zeros_like(state.w),
                    x=x, y=y, z=z, kx=kx, ky=ky, kz=kz)


def rk2_step(rhs: Callable, state: RayState, dt) -> RayState:
    """Heun's method: k1 at the state, k2 at state + dt k1, average."""
    return _fold(state, _rk2_sum(rhs, state, dt), dt)


def rk4_step(rhs: Callable, state: RayState, dt) -> RayState:
    """Classical RK4."""
    return _fold(state, _rk4_sum(rhs, state, dt), dt)


def rk2_increment(rhs: Callable, state: RayState, dt) -> RayState:
    """Heun increment NOT folded into the state: the raw delta the
    compensated accumulator needs (the rounding of ``state + delta`` is
    exactly the error it removes)."""
    return _unfolded(state, _rk2_sum(rhs, state, dt), dt)


def rk4_increment(rhs: Callable, state: RayState, dt) -> RayState:
    """Classical RK4 increment (see rk2_increment for why unfolded)."""
    return _unfolded(state, _rk4_sum(rhs, state, dt), dt)


def split_symplectic_step(rhs: Callable, state: RayState, dt) -> RayState:
    """Position-kick-position splitting (solver.hpp split_simplextic:
    1016-1130): half drift with dx/dt at the current k, full kick of k at
    the drifted position, half drift with dx/dt at the new k.

    Valid only for separable Hamiltonians (dx/dt independent of x, dk/dt
    independent of k); the reference asserts this symbolically
    (solver.hpp:1076-1094), :func:`check_separable` numerically.
    """
    half = dt / 2.0
    d1 = rhs(state)
    s1 = state._replace(x=state.x + half * d1.dxdt,
                        y=state.y + half * d1.dydt,
                        z=state.z + half * d1.dzdt)
    d2 = rhs(s1)
    s2 = s1._replace(kx=state.kx + dt * d2.dkxdt,
                     ky=state.ky + dt * d2.dkydt,
                     kz=state.kz + dt * d2.dkzdt)
    d3 = rhs(s2)
    return s2._replace(t=state.t + dt,
                       x=s1.x + half * d3.dxdt,
                       y=s1.y + half * d3.dydt,
                       z=s1.z + half * d3.dzdt)


def check_separable(rhs: Callable, state: RayState, rtol=1e-6) -> bool:
    """The numeric stand-in of the reference's symbolic separability
    assert (solver.hpp:1076-1094): finite-difference the drift rates
    (dx/dt) over the position and the kick rates (dk/dt) over the wave
    number at the sample ``state``; every such cross derivative must
    vanish.

    Each 3x3 block is judged against its own rate scale, with a relative
    state bump (1e-4 of the leaf's magnitude, at least 1e-4) and an
    absolute rtol floor so that blocks that are zero pass (the JAX
    package's rule)."""
    d0 = rhs(state)
    blocks = ((("x", "y", "z"), ("dxdt", "dydt", "dzdt")),
              (("kx", "ky", "kz"), ("dkxdt", "dkydt", "dkzdt")))
    ok = True
    for fields, comps in blocks:
        scale = max(max(float(getattr(d0, c).abs().max()) for c in comps),
                    1e-30)
        for field in fields:
            v = getattr(state, field)
            eps = 1e-4 * max(float(v.abs().max()), 1.0)
            d = rhs(state._replace(**{field: v + eps}))
            for comp in comps:
                diff = float((getattr(d, comp) - getattr(d0, comp))
                             .abs().max())
                ok &= diff <= rtol * (scale + 1.0)
    return bool(ok)


STEPPERS = {
    "rk2": rk2_step,
    "rk4": rk4_step,
    "split_simplextic": split_symplectic_step,
}

INCREMENTS = {
    "rk2": rk2_increment,
    "rk4": rk4_increment,
}
