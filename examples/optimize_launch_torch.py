"""Gradient-based launch optimisation through a whole trace, on the
PyTorch port - the counterpart of ``examples/optimize_launch.py``.

One ray's launch wave numbers (ky, kz) are optimised so that the ray hits
a target point: kx is Newton-solved onto D = 0 by ``init_k``, the ray is
traced 30 recorded steps of rk4, and the miss^2 between its endpoint and
the target is minimised by normalised steepest descent with a
backtracking step, its gradient by ``torch.autograd`` through the trace and
the root (``init_k``'s implicit root gradient).

The map: the reference's ``efit.nc`` (the file the JAX example reads, its
``EFIT``), given as ``--efit``, where it is present and ``h5py`` can read
it, with the JAX example's target; otherwise the synthetic map of
``chip_smoke.py`` (the one the port's tests use), whose target is the
endpoint of its own (ky, kz) = (45, 60) launch - exactly reachable, as the
JAX example builds its target - so the miss can be driven to ~0.

Run:  python examples/optimize_launch_torch.py [--device=cpu]
          [--efit=PATH/efit.nc] [--iterations=40] [--steps=30]
(``--device`` defaults to the card.)
"""

from __future__ import annotations

import argparse
import importlib.util
import pathlib
import sys

import torch

HERE = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(HERE.parent))

from graph_framework_tpu_torch.models.dispersion import cold_plasma  # noqa: E402
from graph_framework_tpu_torch.solver import (  # noqa: E402
    Solver, init_k, make_ray_state)

#: The launch: w, x and the kx seed of the JAX example, (ky, kz) free.
LAUNCH = dict(w=500.0, x=2.5, y=0.0, z=0.0, kx=-500.0)
START = (30.0, 30.0)
SYNTHETIC_TARGET_LAUNCH = (45.0, 60.0)
#: The JAX example's target on efit.nc: the endpoint of its (45, 60) launch.
EFIT_TARGET = (2.0438, 0.0485, 0.0602)
DT, SUB_STEPS = 2.0e-3, 10


def load_map(device, efit=None):
    """(equilibrium, name): the EFIT file ``efit`` where given, present and
    readable, else chip_smoke's synthetic map (float64 on ``device``)."""
    if (efit is not None and pathlib.Path(efit).is_file()
            and importlib.util.find_spec("h5py") is not None):
        from graph_framework_tpu_torch.models.efit import make_efit
        return make_efit(efit, device=device), "efit.nc"
    import chip_smoke
    return (chip_smoke.synthetic_equilibrium(torch.float64, device),
            "synthetic")


def trace_endpoint(eq, ky, kz, steps):
    """The endpoint (x, y, z) of one ray launched with (ky, kz), kx
    Newton-solved onto D = 0, after ``steps`` recorded steps of rk4."""
    st = make_ray_state(1, **LAUNCH, ky=ky, kz=kz,
                        device=eq.psi_coeffs.device)
    st = init_k(st, cold_plasma, eq, "kx", tolerance=1e-22,
                max_iterations=50)
    fin = Solver(cold_plasma, eq, method="rk4", dt=DT,
                 sub_steps=SUB_STEPS).run(st, steps)
    return torch.stack([fin.x[0], fin.y[0], fin.z[0]])


def make_loss(eq, steps, target):
    """miss^2(params) of the endpoint against ``target``."""
    target = torch.as_tensor(target, dtype=eq.psi_coeffs.dtype,
                             device=eq.psi_coeffs.device)

    def loss(params):
        d = trace_endpoint(eq, params[0], params[1], steps) - target
        return torch.sum(d * d)

    return loss


def value_and_grad(loss, params):
    p = params.detach().clone().requires_grad_(True)
    v = loss(p)
    (g,) = torch.autograd.grad(v, [p])
    return v.detach(), g


def optimize(loss, params, iterations, step=8.0, log=print):
    """Normalised steepest descent with a backtracking step size (robust
    to the wide dynamic range of d(miss)/dk along a refracting ray), as
    the JAX example: a step is taken only if it lowers the miss; then the
    step grows by 1.2, else it halves.  Returns (params, the accepted
    misses in order)."""
    v, g = value_and_grad(loss, params)
    history = [float(v)]
    for i in range(iterations):
        cand = params - step * g / (torch.linalg.norm(g) + 1e-30)
        v_new, g_new = value_and_grad(loss, cand)
        if float(v_new) < float(v):
            params, v, g = cand, v_new, g_new
            history.append(float(v))
            step *= 1.2
        else:
            step *= 0.5
        if i % 5 == 0 or v < 1e-6:
            log(f"iter {i:2d}  miss^2 = {float(v):.3e}  "
                f"ky = {float(params[0]):+.3f}  kz = {float(params[1]):+.3f}")
        if v < 1e-7:
            break
    return params, history


def target_of(eq, name, steps):
    if name == "efit.nc":
        return EFIT_TARGET
    with torch.no_grad():
        end = trace_endpoint(eq, *SYNTHETIC_TARGET_LAUNCH, steps)
    return tuple(float(c) for c in end)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda")
    p.add_argument("--efit", default=None,
                   help="the reference's efit.nc (else the synthetic map)")
    p.add_argument("--iterations", type=int, default=40)
    p.add_argument("--steps", type=int, default=30)
    args = p.parse_args(argv)
    eq, name = load_map(torch.device(args.device), args.efit)
    target = target_of(eq, name, args.steps)
    loss = make_loss(eq, args.steps, target)
    params = torch.tensor(START, dtype=torch.float64, device=args.device)
    params, history = optimize(loss, params, args.iterations)
    with torch.no_grad():
        end = trace_endpoint(eq, params[0], params[1], args.steps)
    print(f"map {name}: final endpoint {[round(float(c), 4) for c in end]} "
          f"target {[round(c, 4) for c in target]}; miss^2 {history[0]:.3e} "
          f"-> {history[-1]:.3e} in {len(history) - 1} accepted steps")
    return params, history


if __name__ == "__main__":
    main()
