"""Batched Newton root-finding with the reference's convergence loop.

Counterpart of ``graph_framework_tpu.ops.newton.newton_solve`` (reference:
newton.hpp:34-51, workflow.hpp:179-205).  The update ``x <- x - step *
f/f'(x)`` runs on every ray until the ensemble-wide max of f^2 drops below
the tolerance, stagnates, oscillates with period 2, or the iteration cap
is reached.  f' comes from ``torch.autograd.grad`` of sum(f): f is
elementwise over rays, so the gradient of the sum is the per-ray
derivative.

The loop is a host loop with one scalar readback per iteration (the
reference likewise reads its max-reduction back each pass).  It runs
detached; the root's gradient comes from the implicit function theorem,
as the JAX package's ``lax.custom_root`` gives it (see
:func:`newton_solve`).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch


class NewtonDiagnostics(NamedTuple):
    """Telemetry of one Newton solve (workflow.hpp:184-204 reports the
    iteration count and the residual reached)."""
    iterations: int           # loop trips taken
    residual: torch.Tensor    # final ensemble max of f^2 (0-dim)
    converged: bool           # residual <= tolerance


def _value_and_slope(f, x):
    with torch.enable_grad():
        xg = x.detach().requires_grad_(True)
        fx = f(xg)
        (dfx,) = torch.autograd.grad(fx.sum(), xg)
    return fx.detach(), dfx


def newton_solve(f: Callable, x0, *, tolerance: float = 1.0e-30,
                 max_iterations: int = 1000, step: float = 1.0):
    """Solve ``f(x) = 0`` for one unknown per ray.

    ``f`` maps the batched unknown to the residual of the same shape, all
    other ray state closed over.  The loop stops on the first of
    (workflow.hpp:184-204):

      max f^2 <= tol                       (converged)
      |last - current| <= tol              (stagnation)
      |before_last - current| <= tol       (2-cycle oscillation)
      iterations >= max_iterations         (give up)

    with the comparisons made in the working dtype, as the JAX loop makes
    them.  Returns ``(x, converged, NewtonDiagnostics)``.

    Gradient: when grad mode is on and ``f`` closes over tensors that
    require grad, the root x* is returned as

        x* - (f(x*) - f(x*).detach()) / f'(x*).detach()

    whose value is x* bit for bit and whose gradient with respect to what
    ``f`` closes over (theta) is -f_theta / f_x: the implicit function
    theorem, one extra evaluation of f instead of differentiating the
    loop.  The initial guess ``x0`` gets no gradient.
    """
    x = x0.detach()
    big = torch.tensor(torch.finfo(x.dtype).max, dtype=x.dtype,
                       device=x.device)
    last, off_last, it = big, big, 0
    while True:
        fx, dfx = _value_and_slope(f, x)
        cur = (fx * fx).max()
        keep = ((cur.abs() > tolerance) & ((last - cur).abs() > tolerance)
                & ((off_last - cur).abs() > tolerance))
        if it >= max_iterations or not bool(keep):
            break
        if it % 2 == 0:
            off_last = cur
        x = x - step * fx / dfx
        last = cur
        it += 1
    converged = bool(cur <= tolerance)
    if torch.is_grad_enabled():
        with torch.enable_grad():
            f_attached = f(x)
        if f_attached.requires_grad:
            x = x - (f_attached - f_attached.detach()) / dfx
    return x, converged, NewtonDiagnostics(it, cur, converged)
