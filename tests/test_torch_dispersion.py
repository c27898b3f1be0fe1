"""The port's dispersion zoo and per-ray ray equations against the JAX
package's.

Each of the real dispersions the port has (``models.dispersion.
DISPERSIONS``: the ten beside cold plasma, and cold plasma) goes through
both packages' D (``dispersion_residual``), ``residual_fn`` and
``make_ray_rhs`` on the same float64 states, over each analytic
equilibrium (where D is finite there: a dispersion that normalizes B is not
taken where B = 0) and over the synthetic EFIT file of
``test_torch_common``.  Tolerance 1e-10, as tests/test_torch_rays.py: D
and the residual relative to their largest magnitude over the rays; the
RHS per component relative to the scale of its group - the position rates
by their largest magnitude, the wave-vector rates by theirs but at least
max |k| times the position rates' scale (over one metre), so that a rate
that is zero in exact arithmetic (dk/dt where nothing varies) is held to
rounding, not to itself.

Then the per-ray path of an equilibrium that is not batched (the JAX
package's vmap, the port's ``torch.func.vmap``) and ``reference_correction``
on the synthetic VMEC map, each against the JAX package.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from graph_framework_tpu.models import dispersion as jax_disp
from graph_framework_tpu.models import equilibrium as jax_equilibrium
from graph_framework_tpu.models.rays import (
    dispersion_residual as jax_dispersion_residual,
    make_ray_rhs as jax_make_ray_rhs, residual_fn as jax_residual_fn)
from graph_framework_tpu.models.vmec import make_vmec as jax_make_vmec
from graph_framework_tpu.tools.make_splines import write_vmec_file
from graph_framework_tpu_torch.convert import vmec_from_numpy
from graph_framework_tpu_torch.models import dispersion
from graph_framework_tpu_torch.models import equilibrium
from graph_framework_tpu_torch.models.rays import (
    dispersion_residual, make_ray_rhs, residual_fn)
from test_torch_common import both_states, load_both

TOL = 1e-10
NUM_RAYS = 64

ANALYTIC = ["no_magnetic_field", "slab", "slab_density", "slab_field",
            "gaussian_density"]
#: the dispersions that divide by |B|: not taken where B = 0
NEEDS_B = {"ion_cyclotron", "ordinary_wave", "extra_ordinary_wave",
           "cold_plasma", "cold_plasma_expansion"}
#: the complex-only dispersions: tests/test_torch_absorption.py holds them
#: to the JAX package on complex states
COMPLEX_ONLY = {"hot_plasma", "hot_plasma_expansion"}
CASES = [(name, eq) for name in dispersion.DISPERSIONS
         if name not in COMPLEX_ONLY
         for eq in ANALYTIC + ["efit"]
         if not (name in NEEDS_B and eq == "no_magnetic_field")]


def test_the_zoo_is_the_jax_zoo_less_the_hot_plasmas():
    """The port has every dispersion of the JAX package, under its name:
    the real ones, which this file holds to the JAX package, and the two
    hot plasmas, complex only, which tests/test_torch_absorption.py does."""
    assert set(dispersion.DISPERSIONS) == set(jax_disp.DISPERSIONS)
    assert COMPLEX_ONLY <= set(dispersion.DISPERSIONS)
    for name, fn in dispersion.DISPERSIONS.items():
        assert fn.__name__ == name


@pytest.fixture(scope="module")
def efit(tmp_path_factory):
    return load_both("synthetic", tmp_path_factory)


def _states(kind, n=NUM_RAYS, seed=11):
    """(JAX, port) float64 states: for the analytic equilibria w in
    700-1000 /m (above the 595 /m plasma frequency of 1e19 /m^3) at
    positions within 0.5 m of the origin; for EFIT chip_smoke's w = 500 /m
    inside the table near the midplane.  Wave vectors of 300-600 /m in
    random directions, t in [0, 1)."""
    rng = np.random.default_rng(seed)
    if kind == "efit":
        r = rng.uniform(1.6, 2.6, n)
        phi = rng.uniform(-0.3, 0.3, n)
        pos = dict(x=r * np.cos(phi), y=r * np.sin(phi),
                   z=rng.uniform(-0.2, 0.2, n))
        w = np.full(n, chip_smoke.W0)
    else:
        pos = dict(x=rng.uniform(-0.5, 0.5, n), y=rng.uniform(-0.5, 0.5, n),
                   z=rng.uniform(-0.5, 0.5, n))
        w = rng.uniform(700.0, 1000.0, n)
    k = rng.normal(size=(3, n))
    k *= rng.uniform(300.0, 600.0, n) / np.linalg.norm(k, axis=0)
    return both_states(dict(t=rng.uniform(0.0, 1.0, n), w=w, kx=k[0],
                            ky=k[1], kz=k[2], **pos))


def _equilibria(kind, efit):
    if kind == "efit":
        return efit
    return (getattr(jax_equilibrium, f"make_{kind}")(),
            getattr(equilibrium, f"make_{kind}")())


def _rel(got, want):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want, dtype=np.float64)
    return float(np.max(np.abs(got - want))
                 / max(np.max(np.abs(want)), 1e-300))


def rhs_deviations(got, want, kmax):
    """Per component of the RHS, max |got - want| over the rays relative
    to its group's scale (the module docstring)."""
    want = [np.asarray(w, dtype=np.float64) for w in want]
    got = [g.detach().numpy() for g in got]
    pos_scale = max(np.abs(w).max() for w in want[:3])
    k_scale = max(max(np.abs(w).max() for w in want[3:]), kmax * pos_scale)
    return {f: float(np.abs(g - w).max()) / (pos_scale if i < 3 else
                                             k_scale)
            for i, (f, g, w) in enumerate(zip(
                ("dxdt", "dydt", "dzdt", "dkxdt", "dkydt", "dkzdt"), got,
                want))}


@pytest.mark.parametrize("name,kind", CASES,
                         ids=[f"{n}-{k}" for n, k in CASES])
def test_dispersion_matches_jax(name, kind, efit):
    """D, the D^2 residual and the ray RHS of one dispersion over one
    equilibrium, the port against the JAX package."""
    jeq, peq = _equilibria(kind, efit)
    jst, pst = _states(kind)
    jfn, pfn = jax_disp.DISPERSIONS[name], dispersion.DISPERSIONS[name]
    want_d = jax_dispersion_residual(jfn, jeq)(*jst)
    got_d = dispersion_residual(pfn, peq)(*pst)
    assert np.isfinite(np.asarray(want_d)).all()
    assert _rel(got_d, want_d) < TOL
    assert _rel(residual_fn(pfn, peq)(pst),
                jax_residual_fn(jfn, jeq)(jst)) < TOL
    kmax = float(np.abs(np.stack([jst.kx, jst.ky, jst.kz])).max())
    devs = rhs_deviations(make_ray_rhs(pfn, peq)(pst),
                          jax_make_ray_rhs(jfn, jeq)(jst), kmax)
    assert max(devs.values()) < TOL, devs


class _PerRayJax(jax_equilibrium.SlabField):
    def supports_batched(self):
        return False


class _PerRayPort(equilibrium.SlabField):
    """A slab whose field takes one point, (3,), only: the ray equations
    must evaluate it ray by ray."""

    def supports_batched(self):
        return False

    def magnetic_field(self, pos):
        assert pos.shape == (3,), pos.shape
        return super().magnetic_field(pos)


@pytest.mark.parametrize("name", ["ordinary_wave", "cold_plasma", "stiff"])
def test_unbatched_equilibrium_runs_per_ray(name):
    """An equilibrium that is not batched: D, the residual and the RHS ray
    by ray (torch.func.vmap) against the JAX package's vmapped path, and
    against the port's batched path over the same field."""
    jst, pst = _states("slab_field", n=16)
    jfn, pfn = jax_disp.DISPERSIONS[name], dispersion.DISPERSIONS[name]
    jeq, peq = _PerRayJax(), _PerRayPort()
    got = make_ray_rhs(pfn, peq)(pst)
    kmax = float(np.abs(np.stack([jst.kx, jst.ky, jst.kz])).max())
    devs = rhs_deviations(got, jax_make_ray_rhs(jfn, jeq)(jst), kmax)
    assert max(devs.values()) < TOL, devs
    batched = make_ray_rhs(pfn, equilibrium.SlabField())(pst)
    for a, b in zip(got, batched):
        assert torch.allclose(a, b, rtol=1e-14, atol=0)
    assert _rel(residual_fn(pfn, peq)(pst),
                jax_residual_fn(jfn, jeq)(jst)) < TOL


@pytest.fixture(scope="module")
def vmec(tmp_path_factory):
    """(JAX, port) synthetic VMEC equilibria, float64, 21 knots."""
    path = tmp_path_factory.mktemp("vmec") / "synthetic_vmec.nc"
    write_vmec_file(path, **chip_smoke.synthetic_vmec_samples(21))
    jeq = jax_make_vmec(path, dtype=jnp.float64)
    return jeq, vmec_from_numpy(jeq, device="cpu")


@pytest.mark.parametrize("name", ["cold_plasma", "ordinary_wave"])
def test_reference_correction_on_vmec(name, vmec):
    """reference_correction=True on flux coordinates: kvec at a separate
    copy of the position, so D_x excludes the flow through the basis (the
    JAX package's per-ray path); and it differs from the canonical form
    there, while on a Cartesian equilibrium it changes nothing."""
    jeq, peq = vmec
    arrays = chip_smoke.vmec_launch_arrays(16, seed=5)
    arrays.update(kx=np.full(16, 100.0), ky=np.full(16, 3.0),
                  kz=np.full(16, -2.0))
    jst, pst = both_states(arrays)
    jfn, pfn = jax_disp.DISPERSIONS[name], dispersion.DISPERSIONS[name]
    got = make_ray_rhs(pfn, peq, reference_correction=True)(pst)
    want = jax_make_ray_rhs(jfn, jeq, reference_correction=True)(jst)
    for f, g, w in zip(got._fields, got, want):
        assert _rel(g, w) < TOL, f
    canonical = make_ray_rhs(pfn, peq)(pst)
    assert _rel(canonical.dkxdt, want.dkxdt) > 1e3 * TOL
    jst, pst = _states("slab_density", n=8)
    plain = make_ray_rhs(pfn, equilibrium.make_slab_density())(pst)
    split = make_ray_rhs(pfn, equilibrium.make_slab_density(),
                         reference_correction=True)(pst)
    assert all(torch.equal(a, b) for a, b in zip(plain, split))


def test_reference_correction_is_differentiable(vmec):
    """The split RHS under autograd: its VJP with respect to the state
    matches central differences of its value (the basis copy is a
    function of the state too)."""
    _, peq = vmec
    arrays = chip_smoke.vmec_launch_arrays(4, seed=6)
    arrays.update(kx=np.full(4, 100.0), ky=np.full(4, 3.0),
                  kz=np.full(4, -2.0))
    _, pst = both_states(arrays)
    rhs = make_ray_rhs(dispersion.cold_plasma, peq,
                       reference_correction=True)
    x = pst.x.clone().requires_grad_(True)
    (g,) = torch.autograd.grad(rhs(pst._replace(x=x)).dkxdt.sum(), x)
    h = 1e-6
    with torch.no_grad():
        fd = (rhs(pst._replace(x=pst.x + h)).dkxdt
              - rhs(pst._replace(x=pst.x - h)).dkxdt) / (2 * h)
    assert torch.allclose(g, fd, rtol=1e-5, atol=1e-6 * float(
        fd.abs().max()))
