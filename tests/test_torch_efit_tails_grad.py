"""The gradients through the other eight dispersions' windows against the
JAX window kernel's backward kernels.

As tests/test_torch_efit_tails.py (the windows themselves): the eight tails
of ``chip_smoke.TAILS``, 256 rays of each tail's own launch in float64 on
the synthetic EFIT file, the plain versions on the CPU.

* the VJP: gradients of the endpoint loss through EfitWindow (K2's plain
  version) against ``jax.grad`` through the JAX window kernel's
  custom_vjp (``_window_bwd_kernel``), K = 1;
* the block cotangents: gradients with respect to the psi and profile
  tables (K3's plain version and its scatter; the pressure row included,
  which acoustic_wave's and ion_cyclotron's D read) against the JAX
  ``table_grads`` window (``_window_bwd_tab_kernel``), K = 1.

The JAX window kernel's backward cannot trace bohm_gross and
acoustic_wave: their ``_kpar2`` select leaves a nested jaxpr that its
``_depad_call`` refuses.  For those two the gradients are taken through
the JAX XLA frozen path, ``Solver(frozen_cells=True, freeze_every=1)``,
which the JAX package holds to its window kernel's custom_vjp within
1e-10 (test_pallas_efit_step.py), as tests/test_torch_grad_window.py
does for K > 1.

Tolerance 1e-10 of each leaf's or table's largest magnitude, the limit of
the O/X tests.
"""

import dataclasses

import jax
import pytest
import torch

import chip_smoke
from graph_framework_tpu.pallas.efit_step import make_frozen_window_step
from graph_framework_tpu.solver import Solver as JaxSolver
from graph_framework_tpu_torch.kernels import efit_step
from graph_framework_tpu_torch.models.rays import RayState
from test_torch_efit_tails import (  # noqa: F401  (eqs is a fixture)
    STEPS, SUB_STEPS, TAGS, TOL, _jax_fn, eqs, roots)
from test_torch_grad import _jax_loss, _loss, _rel

#: The tails whose gradients the JAX window kernel's backward cannot trace
#: (see the top of this file).
JAX_XLA_GRADS = {"bohm", "acoustic"}


@pytest.mark.parametrize("tables", [False, True], ids=["K2", "K3"])
@pytest.mark.parametrize("tag", TAGS)
def test_tail_window_gradients_match_jax(eqs, tag, tables):
    """Gradients of the endpoint loss over STEPS recorded steps of K = 1
    windows: with respect to the launch state through EfitWindow (K2's
    plain version) or, with ``tables``, also to the psi and profile tables
    (K3's plain version and the scatter), against jax.grad through the
    JAX window kernel's custom_vjp (window8, or windowt with table_grads)
    in interpret mode, or the JAX XLA frozen path (JAX_XLA_GRADS)."""
    jeq, peq = eqs
    jroot, proot, dt = roots(eqs, tag)
    disp = chip_smoke.TAILS[tag]

    def jax_loss(s, *blocks):
        eq = (dataclasses.replace(jeq, psi_coeffs=blocks[0],
                                  profile_coeffs=blocks[1])
              if tables else jeq)
        if tag in JAX_XLA_GRADS:
            return _jax_loss(JaxSolver(
                _jax_fn(tag), eq, method="rk2", dt=dt, sub_steps=SUB_STEPS,
                frozen_cells=True, freeze_every=1).run(s, STEPS))
        step = make_frozen_window_step(
            eq, _jax_fn(tag), method="rk2", dt=dt, sub_steps=SUB_STEPS,
            freeze_every=1, block_rows=2, interpret=True,
            table_grads=tables)

        def body(c, _):
            return step(c), None
        return _jax_loss(jax.lax.scan(body, s, None, length=STEPS)[0])

    jargs = (jroot,) + ((jeq.psi_coeffs, jeq.profile_coeffs) if tables
                        else ())
    want = jax.jit(jax.grad(jax_loss, argnums=tuple(range(len(jargs)))))(
        *jargs)

    leaves = [leaf.detach().clone().requires_grad_(True) for leaf in proot]
    eq, extra = peq, []
    if tables:
        extra = [peq.psi_coeffs.clone().requires_grad_(True),
                 peq.profile_coeffs.clone().requires_grad_(True)]
        eq = dataclasses.replace(peq, psi_coeffs=extra[0],
                                 profile_coeffs=extra[1])
    carry = RayState(*leaves)
    for _ in range(STEPS * SUB_STEPS):
        carry = efit_step.efit_window(eq, carry, method="rk2", dt=dt,
                                      steps=1, compensated=False,
                                      dispersion=disp)
    assert "EfitWindow" in type(carry.x.grad_fn).__name__
    got = torch.autograd.grad(_loss(carry), leaves + extra,
                              allow_unused=True)
    got = [torch.zeros_like(a) if g is None else g
           for a, g in zip(leaves + extra, got)]
    for f, g, w in zip(RayState._fields, got, want[0]):
        assert _rel(g, w) < TOL, f
    if tables:
        for name, g, w in zip(("psi", "profile"), got[8:], want[1:]):
            assert _rel(g, w) < TOL, name
        pres_row = got[9][:, 2, :]
        # the pressure row carries a gradient exactly where D reads it
        assert bool(pres_row.any()) == (disp in (
            chip_smoke.TAILS["ioncyc"], chip_smoke.TAILS["acoustic"]))
        if chip_smoke.reads_map(disp):
            assert bool(got[8].any())
