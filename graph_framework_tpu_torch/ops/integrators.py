"""Runge-Kutta steppers over RayState tuples.

Counterpart of ``graph_framework_tpu.ops.integrators`` (reference:
solver.hpp rk2 :95-125, rk4 :263-330).  Every stepper maps
``(rhs, state, dt) -> next_state`` with ``dt`` a Python float in
normalized time units (t' = c t, meters); it advances ``t`` by dt and
leaves ``w`` untouched.  The increment forms return the raw, unfolded
increment the compensated accumulator needs (ops.compensated).

The CUDA window kernel (csrc/efit_window.cu) writes out the same stage
algebra; keep the two in step.  ``split_symplectic`` is not ported yet.
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


STEPPERS = {
    "rk2": rk2_step,
    "rk4": rk4_step,
}

INCREMENTS = {
    "rk2": rk2_increment,
    "rk4": rk4_increment,
}
