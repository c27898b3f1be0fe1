"""Config 5 - the gradient of the absorbed power - against the JAX package.

``models.absorbed_power`` traces cold-plasma rays with rk4 and adds the
weak damping's Im(kamp) dl at every recorded step; the loss is the
absorbed power summed over the rays, differentiated with respect to the
psi tables and the launch kz (bench.py run_config5, tests/test_config5.py).
On the CPU in float64, 16 rays x 4 recorded steps x 10 substeps (the
frozen forms 20 x 10, bench's dt, so that a freeze window spans a few
cells as it does there):

* the plain form (rk4, ``remat_substeps``) against the JAX test's own
  loss (``test_config5._absorbed_power_fn``): value to 1e-12 relative,
  dL/dkz to 1e-10, dL/dpsi to 1e-10 of its largest magnitude;
* the kernel form (frozen cells, K = 10, the window kernel's autograd
  Function, on CPU tensors its plain versions and the ``index_add_``
  scatter) against the JAX package's XLA frozen path
  (``Solver(frozen_cells=True, freeze_every=10)``), which the JAX package
  holds to its window kernel within 1e-10: the same limits;
* dL/dkz against central differences (h 1e-3) to rtol 1e-5, and the
  derivative along the psi gradient (h 1e-7) to 1e-4 (test_config5.py's
  steps and limits);
* the differentiable weak damping of a real state against the JAX split
  form's values and gradients (1e-10), and the complex update of
  ``run_absorption`` bit for bit as it was.

Launches: on the synthetic map chip_smoke's CONFIG5_LAUNCH (w 250 /m just
outside the electron cyclotron resonance, moving away from it: a quarter of
the power is absorbed) with kz0 = 50 /m, away from the map's up-down
symmetry; on the reference's efit.nc, where present, test_config5.py's.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from graph_framework_tpu.models import dispersion as jax_disp
from graph_framework_tpu.models.absorption import make_weak_damping_split
from graph_framework_tpu.solver import Solver as JaxSolver
from graph_framework_tpu.solver import init_k as jax_init_k
from graph_framework_tpu_torch.convert import ray_state_from_numpy
from graph_framework_tpu_torch.models import absorption
from graph_framework_tpu_torch.models.absorbed_power import (
    absorbed_power_fn, absorbed_power_grad, ray_batches)
from graph_framework_tpu_torch.models.rays import RayState
from test_config5 import _absorbed_power_fn
from test_torch_common import SOURCES, both_states, load_both

N, STEPS, SUB = 16, 4, 10
STEPS_FROZEN = 20
TOL = 1.0e-10
FD = {"kz": (1.0e-3, 1.0e-5), "psi": (1.0e-7, 1.0e-4)}   # step, rtol


def _launch_arrays(source):
    """The launch as float64 arrays, kx unsolved, and kz0."""
    full = np.ones(N)
    if source == "efit.nc":          # test_config5.py's launch
        return dict(t=0 * full, w=800 * full, x=2 * full, y=0 * full,
                    z=0 * full, kx=-400 * full, ky=-410 * full,
                    kz=50 * full), 50.0
    spec = chip_smoke.CONFIG5_LAUNCH
    rng = np.random.default_rng(0)
    x = spec["x"] + spec["x_spread"] * rng.standard_normal(N)
    ky = spec["ky"] + spec["ky_spread"] * rng.standard_normal(N)
    return dict(t=0 * full, w=spec["w"] * full, x=x, y=0 * full,
                z=0 * full, kx=spec["kx"] * full, ky=ky,
                kz=spec["kz"] * full), chip_smoke.CONFIG5_KZ


_CASES = {}


def _case(source, tmp_path_factory):
    """(JAX eq, port eq, JAX state, port state, kz0): the launch solved by
    the JAX init_k (test_config5.py's tolerance) and handed to both."""
    if source not in _CASES:
        jeq, peq = load_both(source, tmp_path_factory)
        arrays, kz0 = _launch_arrays(source)
        js, _ = both_states(arrays)
        js = jax_init_k(js, jax_disp.cold_plasma, jeq, "kx",
                        tolerance=1.0e-16, max_iterations=100)
        _CASES[source] = (jeq, peq, js, ray_state_from_numpy(
            js, device="cpu"), kz0)
    return _CASES[source]


def _jax_frozen_fn(eq0, state, steps):
    """test_config5.py's loss over the JAX XLA frozen path (K = 10)."""
    def absorbed_power(psi_coeffs, kz0):
        eq = dataclasses.replace(eq0, psi_coeffs=psi_coeffs)
        sol = JaxSolver(jax_disp.cold_plasma, eq, method="rk4",
                        dt=1.0 / (steps * SUB), sub_steps=SUB,
                        frozen_cells=True, freeze_every=10)
        kamp_fn = make_weak_damping_split(eq)
        step = sol.step_fn()
        s0 = state._replace(kz=jnp.full_like(state.kz, kz0))

        def body(carry, _):
            s, ksum = carry
            s2 = step(s)
            dl = jnp.sqrt((s2.x - s.x) ** 2 + (s2.y - s.y) ** 2
                          + (s2.z - s.z) ** 2)
            _, kim = kamp_fn(s2)
            kim = jnp.nan_to_num(kim, nan=0.0, posinf=0.0, neginf=0.0)
            return (s2, ksum + kim * dl), None

        (_, ksum), _ = jax.lax.scan(
            body, (s0, jnp.zeros_like(s0.x)), None, length=steps)
        return jnp.sum(1.0 - jnp.exp(-2.0 * jnp.abs(ksum)))

    return absorbed_power


_PORT = {}


def _port(source, form, tmp_path_factory, steps=STEPS):
    """The port's (value, (dL/dpsi, dL/dkz)) of ``form``, computed once."""
    if (source, form, steps) not in _PORT:
        _, peq, _, ps, kz0 = _case(source, tmp_path_factory)
        _PORT[source, form, steps] = absorbed_power_grad(
            peq, ps, steps, SUB, peq.psi_coeffs, kz0, form=form)
    return _PORT[source, form, steps]


def _assert_matches(got, want):
    v, (g_psi, g_kz) = got
    jv, (jg_psi, jg_kz) = want
    jg_psi = np.asarray(jg_psi)
    assert abs(float(v) - float(jv)) <= 1e-12 * abs(float(jv))
    assert abs(float(g_kz) - float(jg_kz)) <= TOL * abs(float(jg_kz))
    scale = np.abs(jg_psi).max()
    assert scale > 0
    assert np.abs(g_psi.numpy() - jg_psi).max() <= TOL * scale


@pytest.mark.parametrize("source", SOURCES)
def test_plain_form_matches_jax(source, tmp_path_factory):
    """The plain form against test_config5.py's own loss."""
    jeq, _, js, _, kz0 = _case(source, tmp_path_factory)
    want = jax.value_and_grad(_absorbed_power_fn(jeq, js, STEPS, SUB),
                              argnums=(0, 1))(jeq.psi_coeffs,
                                              jnp.float64(kz0))
    _assert_matches(_port(source, "plain", tmp_path_factory), want)


@pytest.mark.parametrize("source", SOURCES)
def test_kernel_form_matches_jax_frozen(source, tmp_path_factory):
    """The kernel form (its plain versions on CPU tensors) against the JAX
    XLA frozen path; the kernel form really ran the window's Function."""
    jeq, peq, js, ps, kz0 = _case(source, tmp_path_factory)
    want = jax.jit(jax.value_and_grad(_jax_frozen_fn(jeq, js, STEPS_FROZEN),
                                      argnums=(0, 1)))(jeq.psi_coeffs,
                                                       jnp.float64(kz0))
    _assert_matches(_port(source, "kernel", tmp_path_factory, STEPS_FROZEN),
                    want)


@pytest.mark.parametrize("source", SOURCES)
def test_gradients_match_central_differences(source, tmp_path_factory):
    """0 < absorbed power < rays, finite gradients that touch the tables,
    and the plain form's gradients against central differences."""
    _, peq, _, ps, kz0 = _case(source, tmp_path_factory)
    v, (g_psi, g_kz) = _port(source, "plain", tmp_path_factory)
    assert 0.0 < float(v) < N
    assert bool(torch.isfinite(g_psi).all())
    assert float(g_psi.abs().sum()) > 0.0
    f = absorbed_power_fn(peq, ps, STEPS, SUB)
    psi = peq.psi_coeffs
    h, rtol = FD["kz"]
    with torch.no_grad():
        fd = (f(psi, kz0 + h) - f(psi, kz0 - h)) / (2 * h)
    np.testing.assert_allclose(float(g_kz), float(fd), rtol=rtol)
    h, rtol = FD["psi"]
    v_dir = g_psi / g_psi.norm()
    with torch.no_grad():
        fd = (f(psi + h * v_dir, kz0) - f(psi - h * v_dir, kz0)) / (2 * h)
    np.testing.assert_allclose(float((g_psi * v_dir).sum()), float(fd),
                               rtol=rtol)


def test_ray_batches_sum_to_the_whole(tmp_path_factory):
    """Three ray batches (one ragged) give the whole ensemble's loss and
    gradients (1e-12 relative), and a mask weights each ray's power (the
    masked loss is the first batch's to 1e-14: the sums' order differs)."""
    _, peq, _, ps, kz0 = _case("synthetic", tmp_path_factory)
    whole = absorbed_power_grad(peq, ps, STEPS, SUB, peq.psi_coeffs, kz0,
                                form="frozen")
    parts = absorbed_power_grad(peq, ps, STEPS, SUB, peq.psi_coeffs, kz0,
                                form="frozen", batches=3)
    assert [b.x.shape[0] for b in ray_batches(ps, 3)] == [6, 6, 4]
    for a, b in ((whole[0], parts[0]), *zip(whole[1], parts[1])):
        assert float((a - b).abs().max()) <= 1e-12 * float(a.abs().max())
    mask = torch.zeros(N, dtype=torch.float64)
    mask[:6] = 1.0
    with torch.no_grad():
        masked = absorbed_power_fn(peq, ps, STEPS, SUB, form="frozen",
                                   mask=mask)(peq.psi_coeffs, kz0)
        first = absorbed_power_fn(peq, ray_batches(ps, 3)[0], STEPS, SUB,
                                  form="frozen")(peq.psi_coeffs, kz0)
    assert abs(float(masked) - float(first)) <= 1e-14 * float(first)


def test_real_weak_damping_matches_jax_split(tmp_path_factory):
    """make_weak_damping_real of a real state: kamp against the JAX split
    form's (re, im), and the gradient of sum(Im kamp) with respect to the
    state and the psi tables against jax.grad of the split form (1e-10 of
    each gradient's largest magnitude); evaluated with and without a
    graph, the values are the same bits."""
    jeq, peq, js, ps, _ = _case("synthetic", tmp_path_factory)
    split = make_weak_damping_split(jeq)
    re, im = split(js)

    def jax_kim(s, psi):
        return jnp.sum(make_weak_damping_split(
            dataclasses.replace(jeq, psi_coeffs=psi))(s)[1])

    want_s, want_psi = jax.grad(jax_kim, argnums=(0, 1))(js, jeq.psi_coeffs)
    kamp = absorption.make_weak_damping_real(peq)(ps)
    assert kamp.dtype == torch.complex128
    for got, want in ((kamp.real, re), (kamp.imag, im)):
        want = np.asarray(want)
        assert np.abs(got.numpy() - want).max() <= TOL * np.abs(want).max()
    assert float(kamp.imag.abs().max()) > 0.0

    leaves = [a.clone().requires_grad_(True) for a in ps]
    psi = peq.psi_coeffs.clone().requires_grad_(True)
    eq = dataclasses.replace(peq, psi_coeffs=psi)
    kamp_g = absorption.make_weak_damping_real(eq)(RayState(*leaves))
    assert torch.equal(kamp_g.detach(), kamp)
    grads = torch.autograd.grad(kamp_g.imag.sum(), leaves + [psi],
                                allow_unused=True)
    grads = [torch.zeros_like(a) if g is None else g
             for a, g in zip(leaves + [psi], grads)]
    for name, got, want in zip(RayState._fields + ("psi_coeffs",), grads,
                               list(want_s) + [want_psi]):
        want = np.asarray(want)
        scale = np.abs(want).max()
        assert np.abs(got.numpy() - want).max() <= TOL * max(scale, 1e-300), \
            name


def _seed_update(eq, state):
    """The complex weak-damping update as the xrays pipeline's phase 2 ran
    it before the real-state form was added (a pinned copy)."""
    from graph_framework_tpu_torch.models import dispersion
    from graph_framework_tpu_torch.ops.special import (
        holomorphic_grad, z_plasma)

    dw_fn = dispersion.make_hot_plasma_expansion(z_plasma)
    t, w = state.t, state.w
    pos, kcov, esup, kvec = absorption._geometry(eq, state)
    klen = torch.sqrt((kvec * kvec).sum(dim=0))
    k_unit = kvec / klen
    with torch.enable_grad():
        kc = kcov.detach().requires_grad_(True)
        dc = dispersion.cold_plasma_expansion(
            w, torch.einsum("in,ijn->jn", kc, esup), pos, t, eq)
        (ddc_dkcov,) = holomorphic_grad(dc, (kc,))
    ddc_vec = torch.einsum("in,ijn->jn", ddc_dkcov, esup)
    dw = dw_fn(w, kvec, pos, t, eq)
    return klen - dw / (k_unit * ddc_vec).sum(dim=0)


@pytest.mark.parametrize("imag", [0.0, 20.0])
def test_complex_weak_damping_unchanged(imag, tmp_path_factory):
    """make_weak_damping (run_absorption's complex update) gives the same
    bits as before, also at a complex kx; it agrees with the real form to
    1e-13 where the state is real."""
    _, peq, _, ps, _ = _case("synthetic", tmp_path_factory)
    cs = RayState(*[a.to(torch.complex128) for a in ps])
    cs = cs._replace(kx=cs.kx + 1j * imag)
    got = absorption.make_weak_damping(peq)(cs)
    assert torch.equal(got, _seed_update(peq, cs))
    if imag == 0.0:
        real = absorption.make_weak_damping_real(peq)(ps)
        assert float((got - real).abs().max()) <= 1e-13 * float(
            got.abs().max())
    with pytest.raises(TypeError, match="real ray state"):
        absorption.make_weak_damping_real(peq)(cs)

