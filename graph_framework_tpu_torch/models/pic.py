"""1D electrostatic particle-in-cell demo (the xpic application).

Counterpart of ``graph_framework_tpu.models.pic`` (reference:
graph_pic/xpic.cpp:10-192).  Model (xpic.cpp:17-35): the gaussian shape
function n(x) = exp(-x^2/1e-4); E_par = -(1/(q n)) d(n te)/dx per
particle-grid distance, deposited onto the grid from every particle; an
RK4 push with the field gathered from the grid (``index_1d``,
xpic.cpp:80-93).

The deposit on the card is the hand-written kernel
:func:`graph_framework_tpu_torch.kernels.deposit.deposit`; :func:`deposit`
here, the counterpart of the JAX package's dense blocked sum, is that
kernel's plain version with every particle counted.  The JAX package's
deposit methods and tiling arguments are not carried over: the tensors'
device picks the kernel (CUDA) or its plain version (CPU).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from graph_framework_tpu_torch.kernels.deposit import (
    deposit as deposit_kernel, deposit_plain)
from graph_framework_tpu_torch.ops.tables import index_1d

#: The shape function's width w of exp(-dx^2/w) (xpic.cpp:17-20).
WIDTH = 1.0e-4


class PicState(NamedTuple):
    x: torch.Tensor        # particle positions
    vpara: torch.Tensor    # particle parallel velocities
    epara: torch.Tensor    # grid electric field
    n: torch.Tensor        # grid density


def shape_density(dx):
    """Particle shape function exp(-dx^2/1e-4) (xpic.cpp:17-20)."""
    return torch.exp(dx * dx / -WIDTH)


def shape_efield(dx, te=1.0, q=1.0):
    """E = -(1/(q n)) d(n te)/dx by autograd (the reference differentiates
    the density graph symbolically, xpic.cpp:27-35)."""
    with torch.enable_grad():
        d = dx.detach().requires_grad_(True)
        (dpe,) = torch.autograd.grad((shape_density(d) * te).sum(), d)
    return -dpe / (q * shape_density(dx))


def _efield_dense(dx, te=1.0, q=1.0):
    """The analytic derivative of pe = te exp(-dx^2/1e-4):
    E = -(1/(q n)) dpe/dx = (te/q) 2 dx / 1e-4, per pair."""
    return (te / q) * (2.0 * dx / WIDTH)


def deposit(x, grid_position, scale, offset):
    """Density and E-field of all particles on the grid: for every grid
    point, the shape function and the field summed over the particles in
    blocks (the JAX package's dense deposit, whose ``scale`` and
    ``offset`` go unused too).  Returns (n, e).  It is the deposit
    kernel's plain version with every particle counted."""
    return deposit_plain(x, torch.ones_like(x), grid_position, width=WIDTH)


def make_push_step(grid_scale, grid_offset, dt=1.0e-5, q=1.0, m=1.0):
    """RK4 particle push with grid-field gathers (xpic.cpp:80-96)."""

    def step(state: PicState) -> PicState:
        x, v, e = state.x, state.vpara, state.epara

        def accel(xq):
            return -q / m * index_1d(e, xq, grid_scale, grid_offset)

        x1 = dt * v
        v1 = accel(x)
        x2 = dt * (v + v1 / 2.0)
        v2 = accel(x + x1 / 2.0)
        x3 = dt * (v + v2 / 2.0)
        v3 = accel(x + x2 / 2.0)
        x4 = dt * (v + v3)
        v4 = accel(x + x3)
        # The reference's v-update omits dt on the acceleration stages
        # (xpic.cpp:82-93); the JAX package applies the standard RK4 dt
        # factor, and so does the port.
        x_next = x + (x1 + 2.0 * (x2 + x3) + x4) / 6.0
        v_next = v + dt * (v1 + 2.0 * (v2 + v3) + v4) / 6.0
        return state._replace(x=x_next, vpara=v_next)

    return step


def make_grid(num_grid, scale, offset, dtype, device="cuda"):
    """The grid points offset + scale * i, i = 0 .. num_grid - 1."""
    return offset + scale * torch.arange(num_grid, dtype=dtype,
                                         device=device)


def make_deposit(num_grid, scale, offset, dtype, device="cuda"):
    """Build ``dep(x) -> (n, epara)`` onto the grid of ``num_grid`` points:
    the deposit kernel on a CUDA ``device``, its plain version on the CPU.
    Every particle counts (mask 1).  The JAX package's ``num_particles``
    (for its padding), ``method``, ``interpret``, ``block`` and ``tile``
    have no counterpart: the kernel takes any count."""
    grid = make_grid(num_grid, scale, offset, dtype, device)

    def dep(x):
        return deposit_kernel(x, torch.ones_like(x), grid, width=WIDTH)

    return dep


def pic_start(num_particles, num_grid, seed=0, dtype=torch.float32,
              device="cuda"):
    """run_pic's initial PicState on ``device`` (the card unless the caller
    names another): positions and velocities 0.25 standard normals drawn
    from a ``torch.Generator`` seeded with ``seed`` on that device (the JAX
    package draws from ``jax.random``: other numbers), fields zero."""
    gen = torch.Generator(device=device).manual_seed(seed)
    x = 0.25 * torch.randn(num_particles, generator=gen, dtype=dtype,
                           device=device)
    v = 0.25 * torch.randn(num_particles, generator=gen, dtype=dtype,
                           device=device)
    zeros = torch.zeros(num_grid, dtype=dtype, device=device)
    return PicState(x=x, vpara=v, epara=zeros, n=zeros.clone())


def run_pic(num_particles=100_000, num_grid=1000, num_steps=100,
            dt=1.0e-5, seed=0, dtype=torch.float32, device="cuda"):
    """The xpic main loop (xpic.cpp:43-178) from :func:`pic_start`:
    deposit the fields, push the particles, repeat, on ``device`` (the
    card unless the caller names another).  Returns the final PicState."""
    scale = 2.0 / (num_grid - 1.0)
    offset = -1.0
    dep = make_deposit(num_grid, scale, offset, dtype, device)
    push = make_push_step(scale, offset, dt)
    state = pic_start(num_particles, num_grid, seed, dtype, device)
    with torch.no_grad():
        for _ in range(num_steps):
            n, e = dep(state.x)
            state = push(state._replace(n=n, epara=e))
    return state
