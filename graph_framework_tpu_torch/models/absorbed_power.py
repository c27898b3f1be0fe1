"""Config 5: the gradient of the absorbed power of an EFIT ray ensemble.

Counterpart of the JAX package's staged config 5 (``bench.py``
``run_config5``, ``tests/test_config5.py`` ``_absorbed_power_fn``;
reference: xrays.cpp:673-793).  Cold-plasma rays are traced with rk4 over
``steps`` recorded steps of ``sub`` substeps (dt = 1 / (steps sub), so the
trace ends at t = 1); after each recorded step the weak damping's Im(kamp)
of the new state times the step's path length dl is added to the ray's
k_sum (a non-finite Im(kamp) counts 0: the vacuum-edge scrub of
bench.py:999).  The loss is the absorbed power summed over the rays,
sum(1 - exp(-2 |k_sum|)); reverse mode gives its gradient with respect to
the psi spline tables and the launch kz.

The launch kz0 replaces every ray's kz *after* ``init_k`` solved kx for the
launch's own kz, as in the JAX package: where kz0 differs from that kz the
traced rays start slightly off D = 0.

Forms (:data:`FORMS`):

* ``"plain"``: rk4 with ``remat_substeps`` (the JAX test's checkpointed
  step);
* ``"frozen"``: frozen cells with a freeze window of 10 substeps in plain
  torch, each window checkpointed (the JAX package's XLA frozen path,
  which bench.py also runs with ``remat_substeps``);
* ``"kernel"``: the same windows through the window kernel (bench.py's
  ``BENCH_PALLAS_WINDOW=1``): on CUDA tensors each window is one K1 launch
  forward and one K3 launch backward, whose block cotangents the table
  scatter (``kernels/table_scatter.py``) adds into the tables, as it does
  the weak damping's gathers' cotangents; on CPU tensors the wrapper runs
  the plain frozen window.

The rays are independent and the loss is a sum, so the loss and gradients
of ray batches add up exactly to those of the whole ensemble
(:func:`absorbed_power_grad`, bench.py:1013-1040): that is how 1M rays fit
on one card.  The TPU's ray padding is not needed: the kernel masks a
ragged block.  For the same reason an ensemble split across processes
(``parallel``) needs one collective: each rank's sums, added over the
ranks at the end (``mesh=``; the JAX package's sharded config 5,
bench.py:922-950).  Each batch's trace and its backward are the spans
``gft.absorbed_power.forward`` and ``gft.absorbed_power.backward``
(``telemetry``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from graph_framework_tpu_torch import telemetry
from graph_framework_tpu_torch.models.absorption import (
    make_weak_damping_real)
from graph_framework_tpu_torch.models.dispersion import cold_plasma
from graph_framework_tpu_torch.models.rays import RayState
from graph_framework_tpu_torch.solver import Solver

#: The freeze window of the frozen and kernel forms, in substeps (bench.py's
#: BENCH_FREEZE_EVERY default under BENCH_PALLAS_WINDOW=1).
FREEZE_EVERY = 10

#: The Solver options of each form.
FORMS = {
    "plain": dict(remat_substeps=True),
    "frozen": dict(frozen_cells=True, freeze_every=FREEZE_EVERY,
                   remat_substeps=True),
    "kernel": dict(frozen_cells=True, freeze_every=FREEZE_EVERY,
                   window_kernel=True),
}


def absorbed_power_fn(eq0, state: RayState, steps: int, sub: int, *,
                      form: str = "plain",
                      mask: Optional[torch.Tensor] = None):
    """``loss(psi_coeffs, kz0)``: the absorbed power of ``state`` (a solved
    launch) traced over ``eq0`` with ``psi_coeffs`` as its psi tables and
    every ray's kz set to ``kz0`` (a 0-dim tensor or a float).  ``mask``:
    a per-ray weight of each ray's absorbed power (bench.py's padded-ray
    mask)."""
    if form not in FORMS:
        raise ValueError(f"form {form!r}: one of {sorted(FORMS)}")

    def loss(psi_coeffs, kz0):
        eq = dataclasses.replace(eq0, psi_coeffs=psi_coeffs)
        sol = Solver(cold_plasma, eq, method="rk4", dt=1.0 / (steps * sub),
                     sub_steps=sub, **FORMS[form])
        kamp = make_weak_damping_real(eq)
        step = sol.step_fn()
        kz = torch.zeros_like(state.kz) + kz0
        s = state._replace(kz=kz)
        k_sum = torch.zeros_like(s.x)
        for _ in range(steps):
            s2 = step(s)
            dl = torch.sqrt((s2.x - s.x) ** 2 + (s2.y - s.y) ** 2
                            + (s2.z - s.z) ** 2)
            kim = torch.nan_to_num(kamp(s2).imag, nan=0.0, posinf=0.0,
                                   neginf=0.0)
            k_sum = k_sum + kim * dl
            s = s2
        absorbed = 1.0 - torch.exp(-2.0 * torch.abs(k_sum))
        if mask is not None:
            absorbed = absorbed * mask
        return absorbed.sum()

    return loss


def ray_batches(state: RayState, batches: int):
    """``state`` cut into ``batches`` consecutive ray batches (the last may
    be shorter)."""
    n = state.x.shape[0]
    size = -(-n // batches)
    return [RayState(*[leaf[i:i + size] for leaf in state])
            for i in range(0, n, size)]


def absorbed_power_grad(eq0, state: RayState, steps: int, sub: int,
                        psi_coeffs: torch.Tensor, kz0, *, form="plain",
                        batches: int = 1, mesh=None):
    """(loss, (d loss / d psi_coeffs, d loss / d kz0)) of
    :func:`absorbed_power_fn` at (``psi_coeffs``, ``kz0``), as the sums of
    those of ``batches`` ray batches, each traced, differentiated and freed
    before the next (bench.py's ray-batched accumulation).  With ``mesh``
    (a ``parallel.mesh.RayMesh``) ``state`` is this rank's slice, cut into
    its own ``batches``, and the three sums are added over the ranks by
    one all-reduce at the end: every rank returns the whole ensemble's."""
    psi = psi_coeffs.detach()
    kz = torch.as_tensor(kz0, dtype=psi.dtype, device=psi.device).detach()
    value = torch.zeros((), dtype=psi.dtype, device=psi.device)
    g_psi, g_kz = torch.zeros_like(psi), torch.zeros_like(kz)
    for batch in ray_batches(state, batches):
        p = psi.clone().requires_grad_(True)
        k = kz.clone().requires_grad_(True)
        with telemetry.span("gft.absorbed_power.forward"):
            v = absorbed_power_fn(eq0, batch, steps, sub, form=form)(p, k)
        with telemetry.span("gft.absorbed_power.backward"):
            gp, gk = torch.autograd.grad(v, [p, k])
        value, g_psi, g_kz = value + v.detach(), g_psi + gp, g_kz + gk
    if mesh is not None:
        value, g_psi, g_kz = mesh.all_reduce_sum([value, g_psi, g_kz])
    return value, (g_psi, g_kz)
