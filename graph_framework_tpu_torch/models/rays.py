"""Hamiltonian ray equations from the dispersion relation via autograd.

Counterpart of ``graph_framework_tpu.models.rays`` (reference:
dispersion.hpp:1319-1448):

    dx/dt = -D_k / D_w,        dk/dt = D_x / D_w

The seven per-ray derivatives (D_w, D_x, D_y, D_z, D_kx, D_ky, D_kz) come
from ONE reverse pass of ``torch.autograd.grad`` over sum(D): the rays are
independent, so the gradient of the sum is the per-ray gradient.  The
EFIT window kernels get the same seven numbers from a reverse sweep of D
written by hand (csrc/efit_adjoint.cuh).

In flux coordinates (VMEC) the position is (s, u, v) and the wave vector
covariant: D is evaluated at kvec = sum_i k_i e^i of the point-bound view,
and the x-derivatives are total ones, through the basis too - the
canonical form of the JAX package, which keeps rays on D = 0.
``reference_correction=True`` gives the reference's literal equations
instead: kvec is evaluated at a separate copy of the position, so the
spatial gradient excludes the flow through the basis (the JAX package's
``reference_correction``; no effect on a Cartesian equilibrium).

A complex state (the reference traces ``complex_float`` and
``complex_double``, xrays_bench.cpp) takes holomorphic partials, as the
JAX package's ``holomorphic=True`` gradient does: torch's autograd gives
the conjugate of each complex derivative, and
``ops.special.holomorphic_grad`` conjugates it back before the ratios
-D_k/D_w and D_x/D_w are formed.

An equilibrium whose ``supports_batched()`` is false takes (3,)
positions only: D is then evaluated per ray under ``torch.func.vmap``,
as the JAX package vmaps its per-ray function; the gradient of the sum
stays the per-ray gradient.

An equilibrium may offer a hand-written value path of the RHS
(``Equilibrium.value_rhs``): the VMEC equilibrium whose geometry the
kernel K4 serves takes cold plasma's derivatives from the kernel K8
(``kernels.vmec_rhs``), the chain rule written by hand over K4's jet, in
place of the eager geometry, D and the autograd pass.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import torch
from torch.autograd.function import once_differentiable

from graph_framework_tpu_torch import telemetry
from graph_framework_tpu_torch.ops.special import holomorphic_grad


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


def _per_ray(fn, eq):
    """``fn`` over (num_rays,) leaves: itself for a batched equilibrium,
    else its ``torch.func.vmap`` over the rays (``fn`` then sees one ray's
    0-dim leaves)."""
    if eq.supports_batched():
        return fn
    return torch.func.vmap(fn)


def dispersion_residual(dispersion: Callable, eq):
    """Per-ray D at the state (Newton init and the residual output;
    dispersion.hpp:1482-1486 returns D*D - this returns D):
    ``d_all(t, w, x, y, z, kx, ky, kz)``."""

    def d_all(t, w, x, y, z, kx, ky, kz):
        pos = torch.stack([x, y, z])
        kcov = torch.stack([kx, ky, kz])
        geq = eq.bind_point(pos)
        return dispersion(w, geq.kvec(kcov, pos), pos, t, geq)

    return _per_ray(d_all, eq)


def _split_residual(dispersion: Callable, eq):
    """D with kvec taken at the separate position (xk, yk, zk) and the
    rest at (x, y, z) (dispersion.hpp:1392-1433, the reference's
    generalized-coordinate form): ``d(t, w, x, y, z, kx, ky, kz, xk, yk,
    zk)``.  Unbound equilibrium, as in the JAX package."""

    def d_all(t, w, x, y, z, kx, ky, kz, xk, yk, zk):
        kvec = eq.kvec(torch.stack([kx, ky, kz]), torch.stack([xk, yk, zk]))
        return dispersion(w, kvec, torch.stack([x, y, z]), t, eq)

    return _per_ray(d_all, eq)


def grad_tensors(obj, found=None):
    """The tensors that ``obj`` holds - directly, or in a nested dataclass
    such as a frozen view's ``base`` - and that require grad (an
    equilibrium whose spline tables are being differentiated)."""
    found = [] if found is None else found
    if isinstance(obj, torch.Tensor):
        if obj.requires_grad and not any(obj is f for f in found):
            found.append(obj)
    elif dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        for f in dataclasses.fields(obj):
            grad_tensors(getattr(obj, f.name), found)
    return found


def rebind(obj, old, new):
    """``obj`` with each tensor of ``old`` replaced by the same-index one
    of ``new``, through nested dataclasses (``obj`` itself if it holds
    none of them)."""
    if isinstance(obj, torch.Tensor):
        return next((n for o, n in zip(old, new) if obj is o), obj)
    if not dataclasses.is_dataclass(obj) or isinstance(obj, type):
        return obj
    changes = {}
    for f in dataclasses.fields(obj):
        if not f.init:
            continue
        value = getattr(obj, f.name)
        rebound = rebind(value, old, new)
        if rebound is not value:
            changes[f.name] = rebound
    return dataclasses.replace(obj, **changes) if changes else obj


class LocalGraph(torch.autograd.Function):
    """``fn(*inputs, create_graph=...)`` as one node of the caller's graph
    (the ray RHS, the weak damping's kamp), differentiable once.

    ``apply(fn, keep, *inputs)``.  With ``keep``, ``forward`` evaluates
    ``fn`` over fresh copies of the inputs that require grad with
    ``create_graph=True`` (D's partials differentiable) and keeps that
    local graph for ``backward``, which pulls the cotangents back through
    it.  Without, ``forward`` evaluates ``fn(..., create_graph=False)``,
    keeps only the inputs, and ``backward`` builds the local graph then:
    one more evaluation, and nothing between the passes but the inputs -
    what a checkpointed unit (``Solver(remat_substeps=True)``) needs, whose
    recompute restores the inputs.  The local graphs live under saved-tensor
    hooks of their own, so a surrounding ``torch.utils.checkpoint`` never
    packs them: the partials taken inside ``fn`` would otherwise unpack
    checkpointed tensors and recompute the unit from inside its own forward
    (tests/test_torch_grad.py counts one evaluation a stage a pass).  Taking
    D's
    partials against the caller's tensors themselves would make autograd
    walk the whole graph behind them on every call - quadratic in the
    length of a differentiated trace (200 rk4 steps of one ray: 55 s on a
    CPU, against 0.5 s).  The backward's pull through the local graph is
    the span ``gft.local_graph.grad`` (``telemetry``)."""

    @staticmethod
    def forward(ctx, fn, keep, *inputs):
        with torch.enable_grad(), _own_saved_tensors():
            if keep:
                ctx.fresh = [a.detach().requires_grad_(True)
                             for a in inputs]
                ctx.out = fn(*ctx.fresh, create_graph=True)
                out = ctx.out
            else:
                ctx.fn = fn
                ctx.save_for_backward(*inputs)
                out = fn(*[a.detach() for a in inputs], create_graph=False)
        if isinstance(out, torch.Tensor):
            return out.detach()
        return tuple(o.detach() for o in out)

    @staticmethod
    @once_differentiable
    def backward(ctx, *cts):
        with torch.enable_grad(), _own_saved_tensors():
            if hasattr(ctx, "out"):
                fresh, out = ctx.fresh, ctx.out
                del ctx.fresh, ctx.out
            else:
                fresh = [a.detach().requires_grad_(True)
                         for a in ctx.saved_tensors]
                out = ctx.fn(*fresh, create_graph=True)
            with telemetry.span("gft.local_graph.grad"):
                grads = torch.autograd.grad(out, fresh, cts,
                                            allow_unused=True)
        return (None, None, *grads)


def _own_saved_tensors():
    """Saved-tensor hooks that keep tensors as they are (a local graph out
    of reach of an enclosing checkpoint's hooks)."""
    return torch.autograd.graph.saved_tensors_hooks(lambda a: a,
                                                     lambda a: a)


def make_ray_rhs(dispersion: Callable, eq, *,
                 reference_correction: bool = False,
                 keep_local_graph: bool = True):
    """Build the ray right-hand side ``rhs(state) -> RayDerivatives``:
    one ``torch.autograd.grad`` of sum(D) over (w, x, y, z, kx, ky, kz)
    gives all seven derivatives (holomorphic ones for a complex state).

    ``reference_correction``: the reference's literal generalized-
    coordinate equations (kvec at a separate copy of the position, which
    the x-derivatives do not see) instead of the canonical form; see the
    module docstring.  No effect for Cartesian equilibria.

    Two paths, chosen per call:

    * value: when grad mode is off, or neither a state leaf nor a tensor
      of ``eq`` requires grad, the leaves are detached and the result
      carries no graph;
    * differentiable: otherwise the RHS is one node of the caller's graph
      (:class:`LocalGraph`), a function of the state, of the basis position
      and of the equilibrium's tables that require grad, differentiable
      once (the JAX package differentiates its ``jax.grad`` RHS the same
      way).  The partials are taken against fresh copies of the leaves, so
      each partial stays a partial: a leaf computed from another (kx
      solved from ky by ``init_k``) does not leak its dependence into the
      other's derivative.

    ``keep_local_graph``: the differentiable RHS keeps its local graph
    between the passes (:class:`LocalGraph` with ``keep``); False keeps
    only its inputs and rebuilds the local graph in the backward pass,
    as an RHS inside a checkpointed unit needs
    (``Solver(remat_substeps=True)``): the unit's recompute restores
    them.

    The value path in the canonical form takes the equilibrium's own
    value path instead (``eq.value_rhs(dispersion)``) where it serves
    the leaves: K4 and K8 for cold plasma over a ``VmecEquilibrium``
    whose geometry K4 serves (``fused_mode_sums``, cell-local tables) at
    (rays,) float32 leaves.  Everything else - the differentiable RHS,
    float64, unfused or frozen equilibria, ``reference_correction``, the
    other dispersions and equilibria - is the eager path.

    Each call of the RHS, from entry to return (the geometry, D and the
    ``autograd.grad`` pass, or the kernels' wrappers), is the span
    ``gft.ray_rhs`` (``telemetry``)."""
    split = reference_correction and not eq.is_cartesian()
    make_d = _split_residual if split else dispersion_residual
    d_all = make_d(dispersion, eq)
    closure = grad_tensors(eq)
    fused = None if split else eq.value_rhs(dispersion)

    def partials(d_fn, t, leaves, basis, create_graph):
        """The RHS from D's seven partials over ``leaves``."""
        with torch.enable_grad():
            d = d_fn(t, *leaves, *basis)
            grads = holomorphic_grad(d, leaves, allow_unused=True,
                                     create_graph=create_graph)
        dw, dx, dy, dz, dkx, dky, dkz = [
            torch.zeros_like(a) if g is None else g
            for a, g in zip(leaves, grads)]
        return (-dkx / dw, -dky / dw, -dkz / dw, dx / dw, dy / dw, dz / dw)

    def rhs_of(t, *rest, create_graph):
        """The RHS over the state's seven leaves, then the basis position
        (when split), then ``closure``'s tensors; ``create_graph``: the
        leaves require grad, and the result is differentiable in all of
        them."""
        leaves, basis = rest[:7], rest[7:7 + 3 * split]
        if not create_graph:
            leaves = [a.requires_grad_(True) for a in leaves]
        fresh_eq = rebind(eq, closure, rest[7 + 3 * split:])
        d_fn = d_all if fresh_eq is eq else make_d(dispersion, fresh_eq)
        return partials(d_fn, t, leaves, basis, create_graph)

    def rhs(state: RayState) -> RayDerivatives:
        with telemetry.span("gft.ray_rhs"):
            leaves = (state.w, state.x, state.y, state.z,
                      state.kx, state.ky, state.kz)
            # the basis position: the state itself, not the leaves D is
            # differentiated against, so D_x does not see it
            basis = leaves[1:4] if split else ()
            if torch.is_grad_enabled() and (closure or any(
                    a.requires_grad for a in (state.t, *leaves))):
                return RayDerivatives(*LocalGraph.apply(
                    rhs_of, keep_local_graph, state.t, *leaves, *basis,
                    *closure))
            derivs = None if fused is None else fused(leaves)
            if derivs is not None:
                return RayDerivatives(*derivs)
            fresh = [a.detach().requires_grad_(True) for a in leaves]
            return RayDerivatives(*partials(
                d_all, state.t.detach(), fresh,
                [a.detach() for a in basis], False))

    return rhs


def residual_fn(dispersion: Callable, eq):
    """Batched D^2 residual of a RayState (solver residual output,
    solver.hpp:331)."""
    d_all = dispersion_residual(dispersion, eq)

    def residual(state: RayState):
        d = d_all(*state)
        return d * d

    return residual
