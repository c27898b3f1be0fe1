"""Relativistic Boris particle pusher (the xkorc application).

Counterpart of ``graph_framework_tpu.models.korc`` (reference:
graph_korc/xkorc.cpp:10-188): push particles through an equilibrium's
field, with time normalized to the gyro period at the characteristic
field b0 and lengths to the Larmor radius.  The u'/tau/sigma rotation
(xkorc.cpp:87-103) is the exactly energy-conserving relativistic Boris
variant, written componentwise on (N,) tensors.  The JAX package's
``lax.scan`` is a Python loop here; the step is plain PyTorch for any
field.  The slab-field push with the state kept on chip for many steps is
the CUDA kernel :func:`graph_framework_tpu_torch.kernels.boris.make_slab_push`.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class ParticleState(NamedTuple):
    """Positions, normalized momenta u = gamma v/c, and gamma."""
    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor
    ux: torch.Tensor
    uy: torch.Tensor
    uz: torch.Tensor
    gamma: torch.Tensor


#: physical constants as xkorc.cpp:33-35 uses them (me is the CODATA-2022
#: value 9.1093837139e-31, not dispersion.hpp's 9.1093837015e-31).
Q_KORC = 1.602176634e-19
ME_KORC = 9.1093837139e-31
C_KORC = 299792458.0


def initialize_gamma(state: ParticleState) -> ParticleState:
    """The "initialize_gamma" pre-item (xkorc.cpp:76-86): gamma =
    1/sqrt(1 - u.u) for u given as a velocity fraction, then u <- gamma u."""
    u2 = state.ux * state.ux + state.uy * state.uy + state.uz * state.uz
    gamma = 1.0 / torch.sqrt(1.0 - u2)
    return state._replace(ux=gamma * state.ux, uy=gamma * state.uy,
                          uz=gamma * state.uz, gamma=gamma)


def make_boris_step(eq, b0, dt: float, larmor_radius: float):
    """One Boris step (xkorc.cpp:87-118) over (N,) tensors.

    ``b0``: the normalizing field (the equilibrium's characteristic
    field); ``larmor_radius``: c me / (q b0) in meters (xkorc.cpp:37-40).
    """

    def step(st: ParticleState) -> ParticleState:
        b = eq.magnetic_field(torch.stack([st.x, st.y, st.z]))
        bx, by, bz = b[0] / b0, b[1] / b0, b[2] / b0
        h = dt / (2.0 * st.gamma)

        # u' = u - h (u x b)
        upx = st.ux - h * (st.uy * bz - st.uz * by)
        upy = st.uy - h * (st.uz * bx - st.ux * bz)
        upz = st.uz - h * (st.ux * by - st.uy * bx)

        tx, ty, tz = -0.5 * dt * bx, -0.5 * dt * by, -0.5 * dt * bz
        tau_sq = tx * tx + ty * ty + tz * tz
        speed_sq = upx * upx + upy * upy + upz * upz
        sigma = 1.0 + speed_sq - tau_sq
        ustar = upx * tx + upy * ty + upz * tz
        gamma_next = torch.sqrt(0.5 * (
            sigma + torch.sqrt(sigma * sigma
                               + 4.0 * (tau_sq + ustar * ustar))))
        inv_gn = 1.0 / gamma_next
        tvx, tvy, tvz = tx * inv_gn, ty * inv_gn, tz * inv_gn
        s = 1.0 + tvx * tvx + tvy * tvy + tvz * tvz
        updt = upx * tvx + upy * tvy + upz * tvz
        inv_s = 1.0 / s
        unx = (upx + updt * tvx + (upy * tvz - upz * tvy)) * inv_s
        uny = (upy + updt * tvy + (upz * tvx - upx * tvz)) * inv_s
        unz = (upz + updt * tvz + (upx * tvy - upy * tvx)) * inv_s

        f = larmor_radius * dt * inv_gn
        return ParticleState(st.x + f * unx, st.y + f * uny,
                             st.z + f * unz, unx, uny, unz, gamma_next)

    return step


def run_korc(eq, num_particles=1024, num_steps=1000, dt=0.5,
             dtype=torch.float64, x0=1.7, u0=(0.0, 0.99, 0.1),
             device="cuda"):
    """The xkorc main loop (xkorc.cpp:10-160): ``num_steps`` Boris steps
    of ``num_particles`` particles through ``eq``'s field, on ``device``
    (the card unless the caller names another; ``eq``'s tables must lie
    there too).  Returns the final ParticleState.  The initial conditions
    are the reference's: x = 1.7 m on the midplane, u = (0, 0.99, 0.1) c.
    """
    b0 = float(eq.characteristic_field())
    gyro_period = ME_KORC / (Q_KORC * b0)
    larmor_radius = C_KORC * gyro_period

    def full(value):
        return torch.full((num_particles,), value, dtype=dtype,
                          device=device)

    state = initialize_gamma(ParticleState(
        x=full(x0), y=full(0.0), z=full(0.0), ux=full(u0[0]),
        uy=full(u0[1]), uz=full(u0[2]), gamma=full(1.0)))
    step = make_boris_step(eq, b0, dt, larmor_radius)
    with torch.no_grad():
        for _ in range(num_steps):
            state = step(state)
    return state
