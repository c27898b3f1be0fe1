"""Hamiltonian ray equations from the dispersion relation via autograd.

Counterpart of ``graph_framework_tpu.models.rays`` (reference:
dispersion.hpp:1319-1448):

    dx/dt = -D_k / D_w,        dk/dt = D_x / D_w

For a cartesian (batched) equilibrium the seven per-ray derivatives
(D_w, D_x, D_y, D_z, D_kx, D_ky, D_kz) come from ONE reverse pass of
``torch.autograd.grad`` over sum(D): the rays are independent, so the
gradient of the sum is the per-ray gradient.  The CUDA window kernel
gets the same seven numbers by forward mode on dual numbers instead
(csrc/efit_window.cu).

Only the batched path is ported; the per-ray path for non-cartesian
coordinates and ``reference_correction`` wait for the VMEC port.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch


class RayState(NamedTuple):
    """Per-ray phase-space state; each leaf has shape (num_rays,).

    The eight variables of the reference's solver kernel
    (solver.hpp:303-349): time, frequency, position, covariant wave number.
    """
    t: torch.Tensor
    w: torch.Tensor
    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor
    kx: torch.Tensor
    ky: torch.Tensor
    kz: torch.Tensor

    @property
    def pos(self):
        return torch.stack([self.x, self.y, self.z])

    @property
    def kcov(self):
        return torch.stack([self.kx, self.ky, self.kz])


class RayDerivatives(NamedTuple):
    """dx/dt and dk/dt (dispersion.hpp:1436-1438)."""
    dxdt: torch.Tensor
    dydt: torch.Tensor
    dzdt: torch.Tensor
    dkxdt: torch.Tensor
    dkydt: torch.Tensor
    dkzdt: torch.Tensor

    @property
    def dsdt(self):
        return torch.sqrt(self.dxdt * self.dxdt + self.dydt * self.dydt
                          + self.dzdt * self.dzdt)


def _check_batched(eq):
    if not eq.supports_batched():
        raise NotImplementedError(
            f"{type(eq).__name__} is not batched; the per-ray ray "
            "equations are not ported yet")


def dispersion_residual(dispersion: Callable, eq):
    """Per-ray D at the state (Newton init and the residual output;
    dispersion.hpp:1482-1486 returns D*D - this returns D)."""
    _check_batched(eq)

    def d_all(t, w, x, y, z, kx, ky, kz):
        pos = torch.stack([x, y, z])
        kcov = torch.stack([kx, ky, kz])
        geq = eq.bind_point(pos)
        return dispersion(w, geq.kvec(kcov, pos), pos, t, geq)

    return d_all


def make_ray_rhs(dispersion: Callable, eq):
    """Build the batched ray right-hand side ``rhs(state) ->
    RayDerivatives``: one ``torch.autograd.grad`` of sum(D) over
    (w, x, y, z, kx, ky, kz) gives all seven derivatives.

    The state's leaves are detached first, so the RHS is a value (reverse
    mode through a trace is not ported yet)."""
    d_all = dispersion_residual(dispersion, eq)

    def rhs(state: RayState) -> RayDerivatives:
        with torch.enable_grad():
            args = [leaf.detach().requires_grad_(True) for leaf in
                    (state.w, state.x, state.y, state.z,
                     state.kx, state.ky, state.kz)]
            d = d_all(state.t, *args).sum()
            grads = torch.autograd.grad(d, args, allow_unused=True)
        dw, dx, dy, dz, dkx, dky, dkz = [
            torch.zeros_like(a) if g is None else g
            for a, g in zip(args, grads)]
        return RayDerivatives(-dkx / dw, -dky / dw, -dkz / dw,
                              dx / dw, dy / dw, dz / dw)

    return rhs


def residual_fn(dispersion: Callable, eq):
    """Batched D^2 residual of a RayState (solver residual output,
    solver.hpp:331)."""
    d_all = dispersion_residual(dispersion, eq)

    def residual(state: RayState):
        d = d_all(*state)
        return d * d

    return residual
