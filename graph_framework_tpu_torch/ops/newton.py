"""Batched Newton root-finding with the reference's convergence loop.

Counterpart of ``graph_framework_tpu.ops.newton.newton_solve`` (reference:
newton.hpp:34-51, workflow.hpp:179-205).  The update ``x <- x - step *
f/f'(x)`` runs on every ray until the ensemble-wide max of f^2 drops below
the tolerance, stagnates, oscillates with period 2, or the iteration cap
is reached.  f' comes from ``torch.autograd.grad`` of sum(f): f is
elementwise over rays, so the gradient of the sum is the per-ray
derivative.  A complex unknown takes the holomorphic path (the JAX
package's ``holomorphic=True``): the residual measure is |f|^2, and the
slope is the complex derivative f', which torch's autograd gives
conjugated (``ops.special.holomorphic_grad``).

The loop is a host loop with one scalar readback per iteration (the
reference likewise reads its max-reduction back each pass).  It runs
detached; the root's gradient comes from the implicit function theorem,
as the JAX package's ``lax.custom_root`` gives it (see
:func:`newton_solve`).  :func:`newton_solve_multi` is the several-unknown
form (newton.hpp:42-47); its callers take no gradient of the root, and it
gives none.

With ``mesh=`` (a ``parallel.mesh.RayMesh``) the rays are this rank's
slice of an ensemble split across processes, and the ensemble max is taken
over every rank (``RayMesh.ensemble_max``, NaN where any rank's is NaN):
all ranks take the same iterations, and each ray's root is the
one-process root bit for bit.  Still one readback an iteration.

Each iteration is a span ``gft.newton.iteration`` (``telemetry``): the
update, f at the new point and the readback; their count is
``NewtonDiagnostics.iterations``.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Sequence

import torch

from graph_framework_tpu_torch import telemetry
from graph_framework_tpu_torch.ops.special import holomorphic_grad


class NewtonDiagnostics(NamedTuple):
    """Telemetry of one Newton solve (workflow.hpp:184-204 reports the
    iteration count and the residual reached)."""
    iterations: int           # loop trips taken
    residual: torch.Tensor    # final ensemble max of f^2 (0-dim)
    converged: bool           # residual <= tolerance


def _abs2(v):
    """|v|^2 as a real tensor (real and complex residuals)."""
    if v.is_complex():
        return v.real * v.real + v.imag * v.imag
    return v * v


def _value_and_slopes(f, xs):
    """f at ``xs`` (detached) and its partial derivative in each: the
    complex derivative for complex unknowns."""
    with torch.enable_grad():
        leaves = [x.detach().requires_grad_(True) for x in xs]
        fx = f(*leaves)
        grads = holomorphic_grad(fx, leaves)
    return fx.detach(), grads


def newton_solve(f: Callable, x0, *, tolerance: float = 1.0e-30,
                 max_iterations: int = 1000, step: float = 1.0, mesh=None):
    """Solve ``f(x) = 0`` for one unknown per ray.

    ``f`` maps the batched unknown to the residual of the same shape, all
    other ray state closed over.  The loop (:func:`newton_solve_multi`
    with one unknown) stops on the first of (workflow.hpp:184-204):

      max f^2 <= tol                       (converged)
      |last - current| <= tol              (stagnation)
      |before_last - current| <= tol       (2-cycle oscillation)
      iterations >= max_iterations         (give up)

    with the comparisons made in the working dtype, as the JAX loop makes
    them.  Returns ``(x, converged, NewtonDiagnostics)``.  A complex
    unknown takes f as holomorphic: Newton in the complex plane with f',
    the residual |f|^2.

    Gradient: when grad mode is on and ``f`` closes over tensors that
    require grad, the root x* is returned as

        x* - (f(x*) - f(x*).detach()) / f'(x*).detach()

    whose value is x* bit for bit and whose gradient with respect to what
    ``f`` closes over (theta) is -f_theta / f_x: the implicit function
    theorem, one extra evaluation of f instead of differentiating the
    loop.  The initial guess ``x0`` gets no gradient.
    """
    (x,), converged, diag = newton_solve_multi(
        f, (x0,), tolerance=tolerance, max_iterations=max_iterations,
        step=step, mesh=mesh)
    if torch.is_grad_enabled():
        with torch.enable_grad():
            f_attached = f(x)
        if f_attached.requires_grad:
            _, (dfx,) = _value_and_slopes(f, (x,))
            x = x - (f_attached - f_attached.detach()) / dfx
    return x, converged, diag


def newton_solve_multi(f: Callable, xs0: Sequence, *,
                       tolerance: float = 1.0e-30,
                       max_iterations: int = 1000, step: float = 1.0,
                       mesh=None):
    """Simultaneous Newton on several unknowns of one residual
    (``solver::newton`` with several variables, newton.hpp:42-47): each
    unknown takes ``x_i <- x_i - step * f / (df/dx_i)`` with its partial
    derivative, all from the same state of the iteration, under
    :func:`newton_solve`'s stop rules, with one readback per iteration.
    Used by the EFIT axis find (equilibrium.hpp:1584-1615).

    ``f(*xs)`` returns the residual; ``mesh``: the ranks over which the
    ensemble max is taken (module doc).  Returns ``(xs, converged,
    NewtonDiagnostics)``; the unknowns come back detached.
    """
    xs = [x.detach() for x in xs0]
    real = xs[0].real.dtype
    last = off_last = torch.tensor(torch.finfo(real).max, dtype=real,
                                   device=xs[0].device)

    def evaluate(xs):
        """f and its slopes at ``xs``, the ensemble max of |f|^2, and
        whether the loop goes on (the readback)."""
        fx, grads = _value_and_slopes(f, xs)
        cur = _abs2(fx).max()
        if mesh is not None:
            cur = mesh.ensemble_max(cur)
        keep = ((cur.abs() > tolerance) & ((last - cur).abs() > tolerance)
                & ((off_last - cur).abs() > tolerance))
        return fx, grads, cur, it < max_iterations and bool(keep)

    it = 0
    fx, grads, cur, go = evaluate(xs)
    while go:
        # an iteration: the update, f at the new point, the readback
        with telemetry.span("gft.newton.iteration"):
            if it % 2 == 0:
                off_last = cur
            xs = [x - step * fx / g for x, g in zip(xs, grads)]
            last = cur
            it += 1
            fx, grads, cur, go = evaluate(xs)
    converged = bool(cur <= tolerance)
    return tuple(xs), converged, NewtonDiagnostics(it, cur, converged)
