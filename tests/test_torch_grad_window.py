"""The window kernel's autograd Function against the JAX window kernel's.

``kernels.efit_step.efit_window`` with gradients runs ``EfitWindow``:
on CPU tensors its forward is the plain window and its backward the plain
versions of K2 (state cotangents) and K3 (block cotangents, scattered
into the tables with ``index_add_``), as on the card.  The JAX side runs
its window kernel's custom_vjps (window8, windowt) in interpret mode.
Inputs, loss and tolerance as in test_torch_grad.py: 256 rays of
chip_smoke's launch in float64, 1e-10 of each leaf's (table's) largest
magnitude - the JAX window kernel test's own limit.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from graph_framework_tpu.models.dispersion import cold_plasma as jax_cold
from graph_framework_tpu.pallas.efit_step import make_frozen_window_step
from graph_framework_tpu.solver import Solver as JaxSolver
from graph_framework_tpu_torch.kernels import efit_step
from graph_framework_tpu_torch.models.rays import RayState
from test_torch_grad import (  # noqa: F401  (setup is a fixture)
    DT, STEPS, SUB_STEPS, TOL, _grad_leaves, _jax_loss, _leaf_rels, _loss,
    _rel, setup)


# -- the window kernel's Function against the JAX custom_vjps ----------------

def _jax_window_loss(jeq, method, k, tables):
    """The JAX loss over STEPS recorded steps of k-substep windows.  K = 1
    runs the JAX window kernel (window8, or windowt with ``tables``) in
    interpret mode; K > 1 runs the XLA frozen path
    (Solver(frozen_cells=True, freeze_every=k)), which the JAX package
    holds to its window kernel's custom_vjp within 1e-10
    (test_pallas_efit_step.py test_window_kernel_gradient_matches_xla_
    frozen): interpret mode unrolls each window's per-substep VJPs into
    one XLA program, whose compile takes minutes at K = 5."""
    def run(s, eq):
        if k == 1:
            step = make_frozen_window_step(
                eq, jax_cold, method=method, dt=DT, sub_steps=SUB_STEPS,
                freeze_every=k, block_rows=2, interpret=True,
                table_grads=tables)

            def body(c, _):
                return step(c), None
            return _jax_loss(jax.lax.scan(body, s, None, length=STEPS)[0])
        return _jax_loss(JaxSolver(
            jax_cold, eq, method=method, dt=DT, sub_steps=SUB_STEPS,
            frozen_cells=True, freeze_every=k).run(s, STEPS))

    if not tables:
        return lambda s: run(s, jeq)
    return lambda s, p, q: run(s, dataclasses.replace(
        jeq, psi_coeffs=p, profile_coeffs=q))


def _port_window_grads(peq, proot, method, k, tables):
    leaves = _grad_leaves(proot)
    eq, extra = peq, []
    if tables:
        extra = [peq.psi_coeffs.clone().requires_grad_(True),
                 peq.profile_coeffs.clone().requires_grad_(True)]
        eq = dataclasses.replace(peq, psi_coeffs=extra[0],
                                 profile_coeffs=extra[1])
    carry = RayState(*leaves)
    for _ in range(STEPS * SUB_STEPS // k):
        carry = efit_step.efit_window(eq, carry, method=method, dt=DT,
                                      steps=k, compensated=False)
    assert "EfitWindow" in type(carry.x.grad_fn).__name__
    grads = torch.autograd.grad(_loss(carry), leaves + extra,
                                allow_unused=True)
    return [torch.zeros_like(a) if g is None else g
            for a, g in zip(leaves + extra, grads)]


@pytest.mark.parametrize("k", [1, 5])
@pytest.mark.parametrize("method", ["rk2", "rk4"])
def test_window_state_gradients_match_jax_window_kernel(setup, method, k):
    """State gradients through efit_window (EfitWindow: the plain window
    forward, the plain version of K2 backward) against jax.grad through
    the JAX window kernel's window8 custom_vjp (K = 1) or the XLA frozen
    path it is held to (K = 5), per leaf."""
    jeq, peq, jroot, proot = setup
    efit_step.efit_window_bwd_launches = 0
    got = _port_window_grads(peq, proot, method, k, False)
    want = jax.jit(jax.grad(_jax_window_loss(jeq, method, k, False)))(jroot)
    rels = _leaf_rels(got, want)
    assert max(rels.values()) < TOL, rels
    # CPU tensors run the plain versions: no kernel was launched
    assert efit_step.efit_window_bwd_launches == 0


@pytest.mark.parametrize("method", ["rk2", "rk4"])
def test_window_table_gradients_match_jax_window_kernel(setup, method):
    """Table gradients (K3's plain version + the scatter into the
    tables) against the JAX window kernel with table_grads, K = 1 (the
    K = 5 table gradients are held to the plain frozen path's in
    test_torch_grad.py test_solver_gradient_paths_agree)."""
    jeq, peq, jroot, proot = setup
    k = 1
    got = _port_window_grads(peq, proot, method, k, True)
    want = jax.jit(jax.grad(_jax_window_loss(jeq, method, k, True),
                            argnums=(0, 1, 2)))(
        jroot, jeq.psi_coeffs, jeq.profile_coeffs)
    rels = _leaf_rels(got[:8], want[0])
    assert max(rels.values()) < TOL, rels
    for g, w in zip(got[8:], want[1:]):
        assert float(np.max(np.abs(np.asarray(w)))) > 0
        assert _rel(g, w) < TOL


def test_function_asks_for_the_tables_it_needs(setup):
    """Only the tables that require grad get a gradient, and the block
    cotangents are only computed when one does (needs_input_grad)."""
    _, peq, _, proot = setup
    p = peq.psi_coeffs.clone().requires_grad_(True)
    eq = dataclasses.replace(peq, psi_coeffs=p)
    calls = []
    real = efit_step._window_vjp

    def spy(*args):
        calls.append(args[-1])
        return real(*args)

    efit_step._window_vjp = spy
    try:
        out = efit_step.efit_window(eq, proot, method="rk2", dt=DT, steps=5,
                                    compensated=False)
        (g,) = torch.autograd.grad(_loss(out), [p])
        leaves = _grad_leaves(proot)
        out = efit_step.efit_window(peq, RayState(*leaves), method="rk2",
                                    dt=DT, steps=5, compensated=False)
        torch.autograd.grad(_loss(out), leaves, allow_unused=True)
    finally:
        efit_step._window_vjp = real
    assert calls == [True, False]
    assert g.shape == p.shape and float(g.abs().max()) > 0
    # rows the rays never gathered from get exactly zero
    touched = (g.reshape(-1, 16) != 0).any(dim=1)
    assert 0 < int(touched.sum()) < touched.numel()
