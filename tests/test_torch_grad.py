"""Reverse mode through the port against the JAX package's.

The port takes gradients with torch.autograd: through the differentiable
ray RHS (models/rays.make_ray_rhs), through Newton's root by the implicit
function theorem (ops/newton.newton_solve), and through the window kernel's
autograd Function (kernels/efit_step.EfitWindow), whose backward on CPU
tensors runs the plain versions of the backward kernels K2 and K3 -
autograd of the plain window - and scatters the block cotangents into the
tables as it does on the card.  This file holds the RHS, the root
gradient, the Solver paths and the refusals; test_torch_grad_window.py
holds the window Function against the JAX window kernel's custom_vjps.

Inputs: 256 rays of chip_smoke's launch (seeded numpy, float64) over the
synthetic EFIT file and efit.nc where present.  Tolerances, each relative
to the largest magnitude of the quantity compared (per leaf, per table):
1e-10 for gradients through windows and traces - the JAX window kernel
test's own limit; both sides differentiate the same algebra, which rounds
differently by ~1e-14 - and 1e-8 for gradients through init_k, whose root
gradient divides by the slope dD/dkx.  Central differences: rtol 1e-5
with tests/test_gradients.py's step sizes, on the plain (unfrozen) trace,
whose endpoint is smooth in the launch; a frozen trace is only piecewise
smooth (the window-base cells jump), so its differences carry ~1e-6
relative noise.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graph_framework_tpu.models.dispersion import cold_plasma as jax_cold
from graph_framework_tpu.models.rays import (
    RayDerivatives as JaxRayDerivatives, make_ray_rhs as jax_make_ray_rhs)
from graph_framework_tpu.solver import (
    Solver as JaxSolver, init_k as jax_init_k)
from graph_framework_tpu_torch.kernels import efit_step
from graph_framework_tpu_torch.models.dispersion import cold_plasma
from graph_framework_tpu_torch.models.rays import RayState, make_ray_rhs
from graph_framework_tpu_torch.ops.compensated import init_comp_carry
from graph_framework_tpu_torch.solver import Solver, init_k
from test_torch_common import SOURCES, both_states, launch_arrays, load_both

DT, SUB_STEPS, STEPS = 1e-4, 10, 2
TOL = 1e-10
ROOT_TOL = 1e-8


@pytest.fixture(scope="module", params=SOURCES)
def setup(request, tmp_path_factory):
    """(JAX eq, port eq, JAX root state, port root state)."""
    jeq, peq = load_both(request.param, tmp_path_factory)
    jstate, pstate = both_states(launch_arrays())
    return (jeq, peq, jax_init_k(jstate, jax_cold, jeq, "kx"),
            init_k(pstate, cold_plasma, peq, "kx"))


def _rel(got, want):
    """max |got - want| / max |want| (0 where both vanish)."""
    got = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got,
                     dtype=np.float64)
    want = np.asarray(want, dtype=np.float64)
    return float(np.max(np.abs(got - want))
                 / (np.max(np.abs(want)) + 1e-300))


def _leaf_rels(got, want):
    return {f: _rel(g, w) for f, g, w in zip(RayState._fields, got, want)}


def _loss(s):
    """The JAX window kernel test's loss (test_pallas_efit_step.py)."""
    return (s.x.sum() + s.z.sum() + 1e-3 * s.kx.sum()) / s.x.shape[0]


def _jax_loss(s):
    return (jnp.sum(s.x) + jnp.sum(s.z) + 1e-3 * jnp.sum(s.kx)) / s.x.shape[0]


def _grad_leaves(state):
    return [leaf.detach().clone().requires_grad_(True) for leaf in state]


# -- F1: the differentiable ray RHS -------------------------------------------

@pytest.mark.parametrize("frozen", [False, True])
def test_rhs_vjp_matches_jax_vjp(setup, frozen):
    """The VJP of the port's RHS against jax.vjp of the JAX package's, on
    the same float64 states and cotangents, per state leaf."""
    jeq, peq, jroot, proot = setup
    if frozen:
        jeq = jeq.freeze_cells(jnp.stack([jroot.x, jroot.y, jroot.z]))
        peq = peq.freeze_cells(torch.stack([proot.x, proot.y, proot.z]))
    rng = np.random.default_rng(11)
    ct = [rng.standard_normal(proot.x.shape[0]) for _ in range(6)]
    _, vjp = jax.vjp(jax_make_ray_rhs(jax_cold, jeq), jroot)
    (want,) = vjp(JaxRayDerivatives(*[jnp.asarray(c) for c in ct]))
    leaves = _grad_leaves(proot)
    out = make_ray_rhs(cold_plasma, peq)(RayState(*leaves))
    assert all(o.requires_grad for o in out)
    got = torch.autograd.grad(list(out), leaves,
                              [torch.from_numpy(c) for c in ct],
                              allow_unused=True)
    got = [torch.zeros_like(a) if g is None else g
           for a, g in zip(leaves, got)]
    rels = _leaf_rels(got, want)
    assert max(rels.values()) < TOL, rels


def test_rhs_vjp_wrt_tables_matches_jax(setup):
    """The RHS closes over the spline tables: its VJP with respect to
    psi_coeffs and profile_coeffs matches JAX's."""
    jeq, peq, jroot, proot = setup
    rng = np.random.default_rng(12)
    ct = [rng.standard_normal(proot.x.shape[0]) for _ in range(6)]

    def jax_rhs(p, q):
        eq = dataclasses.replace(jeq, psi_coeffs=p, profile_coeffs=q)
        return jax_make_ray_rhs(jax_cold, eq)(jroot)

    _, vjp = jax.vjp(jax_rhs, jeq.psi_coeffs, jeq.profile_coeffs)
    want = vjp(JaxRayDerivatives(*[jnp.asarray(c) for c in ct]))
    p = peq.psi_coeffs.clone().requires_grad_(True)
    q = peq.profile_coeffs.clone().requires_grad_(True)
    eq = dataclasses.replace(peq, psi_coeffs=p, profile_coeffs=q)
    out = make_ray_rhs(cold_plasma, eq)(proot)
    got = torch.autograd.grad(list(out), [p, q],
                              [torch.from_numpy(c) for c in ct])
    for g, w in zip(got, want):
        assert _rel(g, w) < TOL


def test_frozen_trace_gradient_matches_jax(setup):
    """Gradients of a short frozen-cell trace (the plain path, autograd
    through the RHS) against the JAX Solver(frozen_cells=True), as
    tests/test_gradients.py test_frozen_cells_gradients_match_plain
    drives it."""
    jeq, peq, jroot, proot = setup
    kw = dict(method="rk4", dt=DT, sub_steps=5, frozen_cells=True)

    def jax_endpoint(s0):
        s = JaxSolver(jax_cold, jeq, **kw).run(s0, 4)
        return jnp.sum(s.x) + jnp.sum(s.kx)

    want = jax.grad(jax_endpoint)(jroot)
    leaves = _grad_leaves(proot)
    s = Solver(cold_plasma, peq, **kw).run(RayState(*leaves), 4)
    got = torch.autograd.grad(s.x.sum() + s.kx.sum(), leaves,
                              allow_unused=True)
    got = [torch.zeros_like(a) if g is None else g
           for a, g in zip(leaves, got)]
    rels = _leaf_rels(got, want)
    assert max(rels.values()) < TOL, rels


# -- F2: the root gradient of init_k ------------------------------------------

TRACES = {
    "plain_rk4": dict(method="rk4", dt=DT, sub_steps=5),
    "window_rk2_K5": dict(method="rk2", dt=DT, sub_steps=10,
                          frozen_cells=True, freeze_every=5),
}


def _port_launch_loss(peq, pstate, kw, window):
    def loss(ky):
        st = init_k(pstate._replace(ky=ky), cold_plasma, peq)
        return _loss(Solver(cold_plasma, peq, window_kernel=window,
                            **kw).run(st, 2))
    return loss


@pytest.mark.parametrize("trace", sorted(TRACES))
def test_launch_gradient_through_init_k(setup, trace):
    """d(endpoint)/d(launch ky) through init_k's Newton root and a trace:
    against jax.grad through the JAX init_k (lax.custom_root) and Solver,
    and, on the smooth plain trace, against central differences along the
    gradient."""
    jeq, peq, _, _ = setup
    kw = TRACES[trace]
    window = "frozen_cells" in kw
    arrays = launch_arrays()
    jstate, pstate = both_states(arrays)

    def jax_loss(ky):
        # the window trace against the JAX XLA frozen path (see
        # test_torch_grad_window._jax_window_loss for why not the
        # interpreted window kernel at K = 5)
        st = jax_init_k(jstate._replace(ky=ky), jax_cold, jeq, "kx")
        return _jax_loss(JaxSolver(jax_cold, jeq, **kw).run(st, 2))

    want = jax.grad(jax_loss)(jstate.ky)
    loss = _port_launch_loss(peq, pstate, kw, window)
    ky = pstate.ky.clone().requires_grad_(True)
    (got,) = torch.autograd.grad(loss(ky), [ky])
    assert _rel(got, want) < ROOT_TOL
    if window:
        return
    h = 1e-3                      # tests/test_gradients.py's launch step
    v = got / got.norm()
    with torch.no_grad():
        fd = (loss(pstate.ky + h * v) - loss(pstate.ky - h * v)) / (2 * h)
    np.testing.assert_allclose(float(got.norm()), float(fd), rtol=1e-5)


def test_root_gradient_keeps_the_root(setup):
    """The implicit-gradient step leaves the root's value bit for bit; the
    root carries a gradient only when D closes over something that
    requires grad."""
    _, peq, _, proot = setup
    _, pstate = both_states(launch_arrays())
    ky = pstate.ky.clone().requires_grad_(True)
    root = init_k(pstate._replace(ky=ky), cold_plasma, peq)
    assert root.kx.requires_grad
    assert torch.equal(root.kx.detach(), proot.kx)
    assert not init_k(pstate, cold_plasma, peq).kx.requires_grad
    with torch.no_grad():
        assert not init_k(pstate._replace(ky=ky), cold_plasma,
                          peq).kx.requires_grad


# -- Solver paths and refusals ------------------------------------------------

def _solver_grads(peq, proot, **kw):
    leaves = _grad_leaves(proot)
    p = peq.psi_coeffs.clone().requires_grad_(True)
    eq = dataclasses.replace(peq, psi_coeffs=p)
    s = Solver(cold_plasma, eq, method="rk2", dt=DT, sub_steps=SUB_STEPS,
               **kw).run(RayState(*leaves), STEPS)
    return torch.autograd.grad(_loss(s), leaves + [p], allow_unused=True)


@pytest.mark.parametrize("variant", ["window_kernel", "remat_substeps"])
def test_solver_gradient_paths_agree(setup, variant):
    """Solver(window_kernel=True) (EfitWindow) and Solver(remat_substeps=
    True) (torch.utils.checkpoint per window) give the gradients of the
    plain frozen path, state and psi table alike."""
    _, peq, _, proot = setup
    kw = dict(frozen_cells=True, freeze_every=5)
    want = _solver_grads(peq, proot, **kw)
    got = _solver_grads(peq, proot, **kw, **{variant: True})
    for g, w in zip(got, want):
        if w is None:
            assert g is None or float(g.abs().max()) == 0
        else:
            assert _rel(g, w) < 1e-12


def test_remat_on_the_unfrozen_path(setup):
    _, peq, _, proot = setup
    want = _solver_grads(peq, proot)
    got = _solver_grads(peq, proot, remat_substeps=True)
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if w is not None:
            assert _rel(g, w) < 1e-12


def test_refusals(setup):
    _, peq, _, proot = setup
    leaves = _grad_leaves(proot)
    with pytest.raises(ValueError, match="forward-only"):
        efit_step.efit_window(peq, init_comp_carry(RayState(*leaves)),
                              method="rk2", dt=DT, steps=5, compensated=True)
    p = peq.psi_coeffs.clone().requires_grad_(True)
    with pytest.raises(ValueError, match="forward-only"):
        Solver(cold_plasma, dataclasses.replace(peq, psi_coeffs=p),
               method="rk2", sub_steps=10, frozen_cells=True, freeze_every=5,
               compensated=True, window_kernel=True).run(proot, 1)
    # forward-only means it still runs without grad
    with torch.no_grad():
        efit_step.efit_window(peq, init_comp_carry(RayState(*leaves)),
                              method="rk2", dt=DT, steps=5, compensated=True)
    with pytest.raises(ValueError, match="redundant"):
        Solver(cold_plasma, peq, method="rk2", frozen_cells=True,
               window_kernel=True, remat_substeps=True)
    for method in ("split_simplextic", "adaptive_rk4"):
        with pytest.raises(ValueError, match="not ported"):
            Solver(cold_plasma, peq, method=method, remat_substeps=True)
