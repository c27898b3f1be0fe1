"""The port's particle path (xkorc) against the JAX package, on the CPU.

The same inputs, made with numpy from a seed, go through the JAX function
and its counterpart in the port, in float64 unless stated: the analytic
equilibria, the gathers, the several-unknown Newton solve and the EFIT
axis field, the Boris step and the whole ``run_korc`` loop through an EFIT
field, and the slab push's plain version against the JAX slab-push kernel
in interpret mode (as tests/test_pallas_boris.py runs it).

The EFIT equilibrium is chip_smoke.py's synthetic flux map moved as
``chip_smoke.KORC_AXIS`` says (why: the comment there), so that the
reference's axis find lands on the same point in both packages.
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from graph_framework_tpu.models import equilibrium as jax_equilibrium
from graph_framework_tpu.models import korc as jax_korc
from graph_framework_tpu.models.efit import make_efit as jax_make_efit
from graph_framework_tpu.ops import tables as jax_tables
from graph_framework_tpu.ops.newton import (
    newton_solve_multi as jax_newton_solve_multi)
from graph_framework_tpu.pallas.boris import (
    make_slab_push as jax_make_slab_push)
from graph_framework_tpu.tools.make_splines import write_efit_file
from graph_framework_tpu_torch.convert import (
    efit_from_numpy, particle_state_from_numpy)
from graph_framework_tpu_torch.kernels import boris
from graph_framework_tpu_torch.models import equilibrium, korc
from graph_framework_tpu_torch.ops import tables
from graph_framework_tpu_torch.ops.newton import newton_solve_multi

EQUILIBRIA = ["no_magnetic_field", "slab", "slab_density", "slab_field",
              "gaussian_density"]


def _rel(got, want):
    """max |got - want| / max |want| (0 when both are 0)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = np.max(np.abs(want)) or 1.0
    return np.max(np.abs(got - want)) / scale


def _particles(n, seed):
    """A seeded ensemble as numpy arrays: positions around x = 1.7 and
    momenta as velocity fractions (initialize_gamma turns them into u)."""
    rng = np.random.default_rng(seed)
    return dict(x=rng.uniform(1.5, 2.0, n), y=rng.uniform(-0.5, 0.5, n),
                z=rng.uniform(-0.5, 0.5, n), ux=rng.uniform(-0.3, 0.3, n),
                uy=np.full(n, 0.9), uz=np.full(n, 0.1), gamma=np.ones(n))


def _both_particles(arrays, dtype=np.float64):
    """(JAX ParticleState, port ParticleState) of the same arrays, after
    each package's initialize_gamma."""
    jst = jax_korc.initialize_gamma(jax_korc.ParticleState(
        **{k: jnp.asarray(v, dtype) for k, v in arrays.items()}))
    pst = korc.initialize_gamma(_port_particles(
        arrays, torch.float64 if dtype == np.float64 else torch.float32))
    return jst, pst


def _port_particles(arrays, dtype=torch.float64):
    """The port's ParticleState of the arrays, on the CPU."""
    return particle_state_from_numpy(types.SimpleNamespace(**arrays),
                                     dtype=dtype, device="cpu")


@pytest.mark.parametrize("name", EQUILIBRIA)
def test_analytic_equilibria_match_jax(name):
    jeq = getattr(jax_equilibrium, f"make_{name}")()
    peq = getattr(equilibrium, f"make_{name}")()
    pos = np.random.default_rng(1).uniform(-2.0, 2.0, (3, 32))
    jpos, ppos = jnp.asarray(pos), torch.from_numpy(pos)
    for accessor in ("electron_density", "electron_temperature",
                     "magnetic_field"):
        got = getattr(peq, accessor)(ppos).numpy()
        want = np.asarray(getattr(jeq, accessor)(jpos))
        assert got.shape == want.shape, accessor
        assert _rel(got, want) <= 1e-14, accessor
    for accessor in ("ion_density", "ion_temperature"):
        assert _rel(getattr(peq, accessor)(0, ppos).numpy(),
                    getattr(jeq, accessor)(0, jpos)) <= 1e-14, accessor
    jq, pq = jeq.plasma_quantities(jpos), peq.plasma_quantities(ppos)
    for field in ("b", "ne", "te"):
        assert _rel(getattr(pq, field).numpy(),
                    getattr(jq, field)) <= 1e-14, field
    for field in ("ni", "ti"):
        assert len(getattr(pq, field)) == len(getattr(jq, field)) == 1
        assert _rel(getattr(pq, field)[0].numpy(),
                    getattr(jq, field)[0]) <= 1e-14, field
    assert peq.characteristic_field() == jeq.characteristic_field()
    assert peq.ion_masses == tuple(jeq.ion_masses)
    assert peq.ion_charges == tuple(jeq.ion_charges)


def test_gathers_match_jax():
    """index_1d, piecewise_1d and piecewise_2d take the same cells as the
    JAX package's, clamped and out-of-range coordinates included; a NaN
    coordinate takes cell 0 in the port."""
    rng = np.random.default_rng(2)
    data1 = rng.standard_normal(9)
    data2 = rng.standard_normal((7, 5))
    x = np.concatenate([rng.uniform(-1.0, 6.0, 64),
                        [-1e9, -1e-12, 0.0, 0.5, 3.999, 4.0, 1e9, np.inf,
                         -np.inf]])
    y = np.concatenate([rng.uniform(-2.0, 3.0, 64),
                        [np.inf, -np.inf, 0.0, 2.5, -0.1, 1e9, -1e9, 0.25,
                         1.0]])
    jx, jy, px, py = (jnp.asarray(x), jnp.asarray(y), torch.from_numpy(x),
                      torch.from_numpy(y))
    np.testing.assert_array_equal(
        tables.index_1d(torch.from_numpy(data1), px, 0.5, -0.25).numpy(),
        np.asarray(jax_tables.index_1d(jnp.asarray(data1), jx, 0.5, -0.25)))
    np.testing.assert_array_equal(
        tables.piecewise_1d(torch.from_numpy(data1), px, 0.5, -0.25).numpy(),
        np.asarray(jax_tables.piecewise_1d(jnp.asarray(data1), jx, 0.5,
                                           -0.25)))
    np.testing.assert_array_equal(
        tables.piecewise_2d(torch.from_numpy(data2), px, 0.75, 0.0, py,
                            0.5, -1.0).numpy(),
        np.asarray(jax_tables.piecewise_2d(jnp.asarray(data2), jx, 0.75,
                                           0.0, jy, 0.5, -1.0)))
    nan = torch.tensor([np.nan])
    assert float(tables.index_1d(torch.from_numpy(data1), nan, 0.5,
                                 0.0)) == data1[0]


@pytest.mark.parametrize("case", ["converges", "stagnates"])
def test_newton_solve_multi_matches_jax(case):
    """The same roots, iteration counts and stop reasons: a residual that
    converges in a few iterations at step 0.5, and a linear one that flips
    its sign each full step (the stagnation rule stops it)."""
    c = np.random.default_rng(3).uniform(1.0, 2.0, 8)
    step = 0.5 if case == "converges" else 1.0

    def residual(a, b, cc):
        return (a * a + b - cc) if case == "converges" else (a + b - cc)

    start = (np.full(8, 1.5), np.full(8, 0.2))
    jxs, jconv, jdiag = jax_newton_solve_multi(
        lambda a, b: residual(a, b, jnp.asarray(c)),
        tuple(jnp.asarray(s) for s in start), step=step)
    pxs, pconv, pdiag = newton_solve_multi(
        lambda a, b: residual(a, b, torch.from_numpy(c)),
        tuple(torch.from_numpy(s) for s in start), step=step)
    assert pconv == bool(jconv)
    assert pdiag.iterations == int(jdiag.iterations)
    for got, want in zip(pxs, jxs):
        assert _rel(got.numpy(), want) <= 1e-12


@pytest.fixture(scope="module")
def efit_pair(tmp_path_factory):
    """(JAX equilibrium, port equilibrium) from one synthetic EFIT file,
    the flux map of chip_smoke's particle phase."""
    path = tmp_path_factory.mktemp("korc_efit") / "korc_efit.nc"
    write_efit_file(path, **chip_smoke.synthetic_samples(
        **chip_smoke.KORC_AXIS))
    jeq = jax_make_efit(path)
    return jeq, efit_from_numpy(jeq, device="cpu")


def test_characteristic_field_matches_jax(efit_pair):
    """The axis find lands where the JAX package's lands.  It stops by the
    stagnation rule after ~190 iterations (|f|^2 cannot reach 1e-30 in
    the flux's rounding), so its landing point carries the rounding of the
    whole walk: the two packages read 5e-13 apart; the limit is 1e-10."""
    jeq, peq = efit_pair
    got, want = float(peq.characteristic_field()), float(
        jeq.characteristic_field())
    assert abs(got - want) <= 1e-10 * abs(want)
    # on the flux = 0 contour 9 cm from the axis: |B| = fpol / R there
    assert 0.36 < got < 0.37


def test_initialize_gamma_matches_jax():
    jst, pst = _both_particles(_particles(16, seed=4))
    for f in jax_korc.ParticleState._fields:
        assert _rel(getattr(pst, f).numpy(), getattr(jst, f)) <= 1e-15, f
    g = 1.0 / np.sqrt(1.0 - (np.asarray(_particles(16, 4)["ux"]) ** 2
                             + 0.9 ** 2 + 0.1 ** 2))
    np.testing.assert_allclose(pst.gamma.numpy(), g, rtol=1e-12)


@pytest.mark.parametrize("name", ["slab", "slab_density"])
def test_boris_step_matches_jax(name):
    """50 Boris steps through an analytic field, leaf by leaf."""
    jeq = getattr(jax_equilibrium, f"make_{name}")()
    peq = getattr(equilibrium, f"make_{name}")()
    jst, pst = _both_particles(_particles(64, seed=5))
    jstep = jax_korc.make_boris_step(jeq, 1.0, 0.5, 1.0)
    pstep = korc.make_boris_step(peq, 1.0, 0.5, 1.0)
    for _ in range(50):
        jst, pst = jstep(jst), pstep(pst)
    for f in jax_korc.ParticleState._fields:
        assert _rel(getattr(pst, f).numpy(), getattr(jst, f)) <= 1e-12, f


def test_boris_energy_conservation():
    """B = z_hat: the Boris rotation keeps gamma to rounding over 200
    steps (tests/test_particles.py, on the port)."""
    st = korc.initialize_gamma(_port_particles(dict(
        x=[1.7], y=[0.0], z=[0.0], ux=[0.3], uy=[0.4], uz=[0.1],
        gamma=[1.0])))
    g0 = float(st.gamma[0])
    step = korc.make_boris_step(equilibrium.make_slab_density(), b0=1.0,
                                dt=0.3, larmor_radius=1.0)
    for _ in range(200):
        st = step(st)
    np.testing.assert_allclose(float(st.gamma[0]), g0, rtol=1e-12)


def test_boris_gyro_radius():
    """Uniform B = z_hat, u perpendicular: the orbit radius in Larmor
    radii is |u| = gamma v/c (tests/test_particles.py, on the port)."""
    st = korc.initialize_gamma(_port_particles(dict(
        x=[0.0], y=[0.0], z=[0.0], ux=[0.5], uy=[0.0], uz=[0.0],
        gamma=[1.0])))
    expected_r = float(st.ux[0])
    step = korc.make_boris_step(equilibrium.make_slab_density(), b0=1.0,
                                dt=0.05, larmor_radius=1.0)
    xs = []
    for _ in range(400):
        st = step(st)
        xs.append(float(st.x[0]))
    r_est = (max(xs) - min(xs)) / 2.0
    np.testing.assert_allclose(r_est, expected_r, rtol=0.02)


def test_run_korc_matches_jax(efit_pair):
    """The whole xkorc slice: run_korc through the EFIT field, 64
    particles x 50 steps, leaf by leaf against the JAX package's run_korc
    (the initial state is deterministic), relative to each leaf's scale."""
    jeq, peq = efit_pair
    want = jax_korc.run_korc(jeq, num_particles=64, num_steps=50, dt=0.5)
    got = korc.run_korc(peq, num_particles=64, num_steps=50, dt=0.5,
                        device="cpu")
    for f in jax_korc.ParticleState._fields:
        assert _rel(getattr(got, f).numpy(), getattr(want, f)) <= 1e-10, f
    r = np.hypot(got.x.numpy(), got.y.numpy())
    assert np.isfinite(r).all() and (r > 0.5).all() and (r < 3.0).all()
    # the particles gyrate: y moved by about a Larmor radius
    assert float(got.y.abs().max()) > 1e-3


@pytest.mark.parametrize("dtype,tol", [(np.float32, 2e-5),
                                       (np.float64, 1e-12)],
                         ids=["f32", "f64"])
def test_slab_push_plain_matches_jax_kernel(dtype, tol):
    """The K5 wrapper on CPU tensors (its plain version) against the JAX
    slab-push kernel in interpret mode, 25 steps.  The JAX kernel takes a
    multiple of 128 particles (256); the port takes the first 200, a
    ragged count.  Tolerances: f64 1e-12 (the same algebra in the same
    order); f32 the JAX kernel test's 2e-5."""
    n, n_port, steps = 256, 200, 25
    jst, pst = _both_particles(_particles(n, seed=6), dtype=dtype)
    kw = dict(dt=0.5, b0=1.0, b1=1.0, b_shear=0.1, larmor=1.0, steps=steps)
    want = jax_make_slab_push(**kw, block_rows=1, interpret=True)(
        jst.x, jst.y, jst.z, jst.ux, jst.uy, jst.uz)
    before = boris.slab_push_launches
    got = boris.make_slab_push(**kw)(
        *[a[:n_port].contiguous() for a in
          (pst.x, pst.y, pst.z, pst.ux, pst.uy, pst.uz)])
    assert boris.slab_push_launches == before
    for name, g, w in zip(("x", "y", "z", "ux", "uy", "uz"), got, want):
        assert g.dtype == pst.x.dtype
        np.testing.assert_allclose(g.numpy(), np.asarray(w)[:n_port],
                                   rtol=tol, atol=tol, err_msg=name)
    # the Boris invariant: gamma recovered from u stays the initial gamma
    gam = np.sqrt(1.0 + sum(np.asarray(u, np.float64) ** 2
                            for u in got[3:]))
    np.testing.assert_allclose(gam, pst.gamma[:n_port].numpy(),
                               rtol=10 * tol)


def test_slab_push_wrapper_refuses():
    """Inputs the kernel does not take raise, on the CPU as on the card:
    mixed shapes or dtypes, non-contiguous tensors, and inputs that
    require grad (the push has no backward)."""
    push = boris.make_slab_push(dt=0.5, b0=1.0, steps=2)
    leaves = [torch.ones(8, dtype=torch.float64) for _ in range(6)]
    with pytest.raises(ValueError, match="contiguous 1-D"):
        push(*leaves[:5], torch.ones(7, dtype=torch.float64))
    with pytest.raises(ValueError, match="contiguous 1-D"):
        push(*leaves[:5], torch.ones(8, dtype=torch.float32))
    with pytest.raises(ValueError, match="contiguous 1-D"):
        push(*leaves[:5], torch.ones(16, dtype=torch.float64)[::2])
    with pytest.raises(TypeError, match="float32/float64"):
        push(*[a.half() for a in leaves])
    with pytest.raises(ValueError, match="no backward"):
        push(*leaves[:5], leaves[5].clone().requires_grad_(True))
    with torch.no_grad():
        out = push(*leaves[:5], leaves[5].clone().requires_grad_(True))
    assert len(out) == 6
