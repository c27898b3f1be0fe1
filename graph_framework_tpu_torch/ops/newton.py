"""Batched Newton root-finding with the reference's convergence loop.

Counterpart of ``graph_framework_tpu.ops.newton.newton_solve`` (reference:
newton.hpp:34-51, workflow.hpp:179-205).  The update ``x <- x - step *
f/f'(x)`` runs on every ray until the ensemble-wide max of f^2 drops below
the tolerance, stagnates, oscillates with period 2, or the iteration cap
is reached.  f' comes from ``torch.autograd.grad`` of sum(f): f is
elementwise over rays, so the gradient of the sum is the per-ray
derivative.

The loop is a host loop with one scalar readback per iteration (the
reference likewise reads its max-reduction back each pass).  The
implicit-function gradient of the root (the JAX package's
``lax.custom_root``) waits for reverse mode.
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
    return x, converged, NewtonDiagnostics(it, cur, converged)
