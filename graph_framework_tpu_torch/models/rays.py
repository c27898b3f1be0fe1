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

import dataclasses
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


def _closure_requires_grad(obj) -> bool:
    """True if a tensor that ``obj`` holds - directly, or in a nested
    dataclass such as a frozen view's ``base`` - requires grad (an
    equilibrium whose spline tables are being differentiated)."""
    if isinstance(obj, torch.Tensor):
        return obj.requires_grad
    return dataclasses.is_dataclass(obj) and any(
        _closure_requires_grad(getattr(obj, f.name))
        for f in dataclasses.fields(obj))


def make_ray_rhs(dispersion: Callable, eq):
    """Build the batched ray right-hand side ``rhs(state) ->
    RayDerivatives``: one ``torch.autograd.grad`` of sum(D) over
    (w, x, y, z, kx, ky, kz) gives all seven derivatives.

    Two paths, chosen per call:

    * value: when grad mode is off, or neither a state leaf nor a tensor
      of ``eq`` requires grad, the leaves are detached and the result
      carries no graph;
    * differentiable: otherwise the seven partials are taken with
      ``create_graph=True`` on fresh views of the leaves, so the result is
      a differentiable function of the state and of the equilibrium's
      tables (the JAX package differentiates its ``jax.grad`` RHS the same
      way).  The views keep each partial a partial: a leaf computed from
      another (kx solved from ky by ``init_k``) does not leak its
      dependence into the other's derivative."""
    d_all = dispersion_residual(dispersion, eq)
    eq_grad = _closure_requires_grad(eq)

    def rhs(state: RayState) -> RayDerivatives:
        leaves = (state.w, state.x, state.y, state.z,
                  state.kx, state.ky, state.kz)
        differentiable = torch.is_grad_enabled() and (
            eq_grad or any(leaf.requires_grad for leaf in leaves))
        with torch.enable_grad():
            args = [leaf.view_as(leaf)
                    if differentiable and leaf.requires_grad
                    else leaf.detach().requires_grad_(True)
                    for leaf in leaves]
            d = d_all(state.t, *args).sum()
            grads = torch.autograd.grad(d, args, allow_unused=True,
                                        create_graph=differentiable)
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
