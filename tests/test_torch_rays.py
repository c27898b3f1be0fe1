"""The port's cold-plasma D and ray right-hand side against jax.grad.

Both packages evaluate D on the same float64 states over the same EFIT
tables; the port differentiates with one torch.autograd reverse pass,
JAX with jax.grad.  Tolerance 1e-10 relative to each component's scale
over the rays: the two reverse passes round the same chain rule in a
different order, which costs ~1e-14 here, and the division by D_w adds
no more than a few ulps.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graph_framework_tpu.models.dispersion import cold_plasma as jax_cold
from graph_framework_tpu.models.rays import (
    make_ray_rhs as jax_make_ray_rhs, residual_fn as jax_residual_fn)
from graph_framework_tpu_torch.models.dispersion import (
    DISPERSIONS, cold_plasma)
from graph_framework_tpu_torch.models.rays import (
    RayState, dispersion_residual, make_ray_rhs, residual_fn)
from test_torch_common import SOURCES, both_states, load_both

TOL = 1e-10


@pytest.fixture(scope="module", params=SOURCES)
def eqs(request, tmp_path_factory):
    return load_both(request.param, tmp_path_factory)


def _states(eq, n=256, seed=7):
    """Random in-domain states: positions inside the table's interior
    near the midplane, wave vectors of 300-600 /m in random directions."""
    rng = np.random.default_rng(seed)
    nr, nz = np.asarray(eq.psi_coeffs).shape[:2]
    r = eq.rmin + eq.dr * nr * rng.uniform(0.3, 0.9, n)
    z = eq.zmin + eq.dz * nz * rng.uniform(0.4, 0.6, n)
    phi = rng.uniform(-0.3, 0.3, n)
    k = rng.normal(size=(3, n))
    k *= rng.uniform(300.0, 600.0, n) / np.linalg.norm(k, axis=0)
    return both_states(dict(t=np.zeros(n), w=np.full(n, 500.0),
                            x=r * np.cos(phi), y=r * np.sin(phi), z=z,
                            kx=k[0], ky=k[1], kz=k[2]))


def _rel(a, b):
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))


def _freeze_both(jeq, peq, jstate, pstate):
    jf = jeq.freeze_cells(jnp.stack([jstate.x, jstate.y, jstate.z]))
    pf = peq.freeze_cells(torch.stack([pstate.x, pstate.y, pstate.z]))
    return jf, pf


@pytest.mark.parametrize("frozen", [False, True])
def test_dispersion_residual(eqs, frozen):
    jeq, peq = eqs
    jstate, pstate = _states(jeq)
    if frozen:
        jeq, peq = _freeze_both(jeq, peq, jstate, pstate)
    want = jax_residual_fn(jax_cold, jeq)(jstate)
    got = residual_fn(cold_plasma, peq)(pstate)
    assert _rel(got, want) < TOL
    d = dispersion_residual(cold_plasma, peq)(*pstate)
    assert torch.allclose(d * d, got, rtol=0, atol=0)


@pytest.mark.parametrize("frozen", [False, True])
def test_ray_rhs_matches_jax_grad(eqs, frozen):
    """All six ray derivatives (from the seven partials of D)."""
    jeq, peq = eqs
    jstate, pstate = _states(jeq)
    if frozen:
        jeq, peq = _freeze_both(jeq, peq, jstate, pstate)
    want = jax_make_ray_rhs(jax_cold, jeq)(jstate)
    got = make_ray_rhs(cold_plasma, peq)(pstate)
    for name, g, w in zip(got._fields, got, want):
        assert _rel(g, w) < TOL, name
    assert _rel(got.dsdt, want.dsdt) < TOL


def test_seven_partials_match_jax_grad(eqs):
    """The raw partials (D_w, D_x, D_y, D_z, D_kx, D_ky, D_kz) that the
    window kernel's dual numbers produce by forward mode."""
    jeq, peq = eqs
    jstate, pstate = _states(jeq, seed=8)

    def jax_d(w, x, y, z, kx, ky, kz):
        pos, kvec = jnp.stack([x, y, z]), jnp.stack([kx, ky, kz])
        return jnp.sum(jax_cold(w, kvec, pos, 0.0, jeq))

    want = jax.grad(jax_d, argnums=tuple(range(7)))(*jstate[1:])
    args = [a.clone().requires_grad_(True) for a in pstate[1:]]
    d = cold_plasma(args[0], torch.stack(args[4:]), torch.stack(args[1:4]),
                    0.0, peq).sum()
    got = torch.autograd.grad(d, args)
    for i, (g, w) in enumerate(zip(got, want)):
        assert _rel(g, w) < TOL, i


def test_rhs_leaves_the_state_alone(eqs):
    """The RHS detaches its inputs: no graph is left on the state and a
    call under torch.no_grad still differentiates."""
    jeq, peq = eqs
    _, pstate = _states(jeq, n=8)
    rhs = make_ray_rhs(cold_plasma, peq)
    with torch.no_grad():
        out = rhs(pstate)
    assert all(not leaf.requires_grad for leaf in out)
    assert isinstance(pstate, RayState)
    assert DISPERSIONS["cold_plasma"] is cold_plasma
