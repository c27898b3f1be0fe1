"""The port's absorption phase (models/absorption.py), its hot-plasma
dispersions and its complex ray states against the JAX package, on the
same seeded inputs, complex128 on the CPU, relative 1e-10 unless a JAX
test states its own limit.

Every complex derivative of the port comes from torch's autograd, which
returns the conjugate of the holomorphic derivative; the cases below put
imaginary parts where the derivative is taken (the wave vector of the
weak-damping gradient, the Newton unknown, the ray state), so a missing
conjugation fails them.  Equilibria: the analytic slab and the synthetic
EFIT file of test_torch_common (both packages load it); the referee legs
read the reference's efit.nc and skip where it is absent.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import REFERENCE_DATA
from test_reference_parity import load as load_fixture
from test_torch_common import efit_path
from graph_framework_tpu.io.output import ResultFile as JaxResultFile
from graph_framework_tpu.models import absorption as jax_absorption
from graph_framework_tpu.models import dispersion as jax_dispersion
from graph_framework_tpu.models.efit import make_efit as jax_make_efit
from graph_framework_tpu.models.equilibrium import make_slab as jax_slab
from graph_framework_tpu.solver import Solver as JaxSolver
from graph_framework_tpu.solver import init_k as jax_init_k
from graph_framework_tpu.solver import make_ray_state as jax_ray_state
from graph_framework_tpu_torch.io.output import AsyncWriter, ResultFile
from graph_framework_tpu_torch.models import absorption, dispersion
from graph_framework_tpu_torch.models.efit import make_efit
from graph_framework_tpu_torch.models.equilibrium import make_slab
from graph_framework_tpu_torch.models.rays import RayState, make_ray_rhs
from graph_framework_tpu_torch.solver import Solver, init_k, make_ray_state

RTOL = 1.0e-10
N = 12


def launch(kind, seed=0, imag=0.0):
    """Seeded launch arrays (complex128) for ``kind``: "slab" near the
    electron cyclotron resonance of Slab (damped: |Im kamp| ~ 1), "efit"
    near the synthetic map's resonance on its axis (R = 2 m, B along y)
    with a parallel ky.  ``imag`` adds i imag to kx."""
    rng = np.random.default_rng(seed)
    full = np.ones(N, dtype=np.complex128)
    if kind == "slab":
        arr = dict(w=600.0 * full, x=0.1 + 0.01 * rng.standard_normal(N),
                   y=0.0 * full, z=0.0 * full, kx=50.0 * full,
                   ky=0.0 * full, kz=500.0 + 5.0 * rng.standard_normal(N))
    else:
        arr = dict(w=215.0 * full, x=2.0 + 0.01 * rng.standard_normal(N),
                   y=0.0 * full, z=0.01 * rng.standard_normal(N),
                   kx=50.0 * full, ky=100.0 + 5.0 * rng.standard_normal(N),
                   kz=0.0 * full)
    arr["kx"] = arr["kx"] + 1j * imag
    arr["t"] = 0.0 * full
    return {k: np.asarray(v, dtype=np.complex128) for k, v in arr.items()}


def states(arr):
    """(JAX RayState, port RayState) of the same complex128 arrays."""
    jax_state = jax_ray_state(N, dtype=jnp.complex128, **{
        k: jnp.asarray(v) for k, v in arr.items()})
    port = make_ray_state(N, dtype=torch.complex128, device="cpu", **{
        k: torch.from_numpy(v) for k, v in arr.items()})
    return jax_state, port


@pytest.fixture(scope="module")
def equilibria(tmp_path_factory):
    """kind -> (JAX equilibrium, port equilibrium)."""
    path = efit_path("synthetic", tmp_path_factory)
    return {"slab": (jax_slab(), make_slab()),
            "efit": (jax_make_efit(path, dtype=jnp.float64),
                     make_efit(path, device="cpu"))}


def assert_close(got, want, rtol=RTOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    scale = np.abs(want).max()
    assert np.all(np.isfinite(got))
    assert np.abs(got - want).max() <= rtol * scale, (
        np.abs(got - want).max() / scale)


@pytest.mark.parametrize("name", ["no_magnetic_field", "slab",
                                  "slab_density", "slab_field",
                                  "gaussian_density", "efit"])
def test_fields_at_complex_positions_match_jax(equilibria, name):
    """B, ne and te at complex positions (phase 2 evaluates the
    equilibrium at complex128 rows): the tables index by the real part
    (ops/tables.py), the polynomials take the complex coordinate."""
    from graph_framework_tpu.models import equilibrium as jax_eqs
    from graph_framework_tpu_torch.models import equilibrium as eqs
    if name == "efit":
        jeq, teq = equilibria["efit"]
        base = launch("efit")
    else:
        jeq = getattr(jax_eqs, f"make_{name}")()
        teq = getattr(eqs, f"make_{name}")()
        base = launch("slab")
    pos = np.stack([base["x"] + 0.01j, base["y"] + 0.02j, base["z"] - 0.01j])
    want = jeq.plasma_quantities(jnp.asarray(pos))
    got = teq.plasma_quantities(torch.from_numpy(pos))
    assert got.b.dtype == torch.complex128
    for g, w in ((got.b, want.b), (got.ne, want.ne), (got.te, want.te)):
        g, w = torch.broadcast_to(g, np.shape(w)).numpy(), np.asarray(w)
        if np.abs(w).max() == 0:          # no_magnetic_field's B
            np.testing.assert_array_equal(g, w)
        else:
            assert_close(g, w)


@pytest.mark.parametrize("kind", ["slab", "efit"])
@pytest.mark.parametrize("name", ["hot_plasma", "hot_plasma_expansion"])
def test_hot_plasma_matches_jax(equilibria, kind, name):
    """D of both hot plasmas at complex wave vectors, batched (3, n)."""
    jeq, teq = equilibria[kind]
    js, ts = states(launch(kind, imag=2.0))
    want = jax_dispersion.DISPERSIONS[name](
        js.w, jnp.stack([js.kx, js.ky, js.kz]),
        jnp.stack([js.x, js.y, js.z]), js.t, jeq)
    got = dispersion.DISPERSIONS[name](ts.w, ts.kcov, ts.pos, ts.t, teq)
    assert got.dtype == torch.complex128
    assert_close(got, want)
    assert np.abs(np.asarray(want).imag).max() > 1e-3 * np.abs(
        np.asarray(want)).max()


@pytest.mark.parametrize("kind", ["slab", "efit"])
@pytest.mark.parametrize("imag", [0.0, 20.0])
def test_weak_damping_matches_jax(equilibria, kind, imag):
    """kamp = |k| - Dw / (khat . dDc/dk) of a damped launch (|Im kamp| of
    order 1), and with a complex kx, where the gradient of Dc is
    complex."""
    jeq, teq = equilibria[kind]
    js, ts = states(launch(kind, imag=imag))
    want = np.asarray(jax_absorption.make_weak_damping(jeq)(js))
    got = absorption.make_weak_damping(teq)(ts)
    assert_close(got, want)
    assert np.abs(want.imag).max() > 0.1


@pytest.mark.parametrize("kind", ["slab", "efit"])
def test_root_finder_matches_jax(equilibria, kind):
    """The complex Newton root of the full hot-plasma D along khat, at
    tests/test_absorption.py's tolerance 1e-24; the root is a root."""
    jeq, teq = equilibria[kind]
    js, ts = states(launch(kind))
    want = np.asarray(jax_absorption.make_root_finder(
        jeq, tolerance=1e-24)(js))
    got, diag = absorption.make_root_finder(
        teq, tolerance=1e-24, return_diagnostics=True)(ts)
    assert diag.converged and diag.iterations < 50
    assert_close(got, want)
    assert np.abs(want.imag).max() > 0.01
    kvec = ts.kcov
    klen = torch.sqrt((kvec * kvec).sum(dim=0))
    d = dispersion.make_hot_plasma()(
        ts.w, kvec + (got - klen) * kvec / klen, ts.pos, ts.t, teq)
    assert float(d.abs().max()) < 1e-10


def test_bin_power_matches_jax():
    rng = np.random.default_rng(4)
    nt, nr = 9, 7
    xyz = [np.cumsum(rng.uniform(0.0, 0.1, (nt, nr)), axis=0)
           for _ in range(3)]
    kim = rng.uniform(0.0, 1.0, (nt, nr))
    want = jax_absorption.bin_power(*map(jnp.asarray, xyz + [kim]))
    got = absorption.bin_power(*map(torch.from_numpy, xyz + [kim]))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-14,
                                   atol=1e-16)
    power = got[0].numpy()
    assert (power <= 1.0).all() and (np.diff(power, axis=0) <= 0).all()


def test_bin_power_analytic():
    """A straight ray at unit speed with constant Im(kamp) K:
    power_j = exp(-2 K 0.1 (j - 1)) (tests/test_absorption.py)."""
    nt, nr, k = 6, 2, 0.7
    x = np.broadcast_to(np.arange(nt)[:, None] * 0.1, (nt, nr)).copy()
    zero = np.zeros((nt, nr))
    power, d_power = absorption.bin_power(
        *map(torch.from_numpy, (x, zero, zero, np.full((nt, nr), k))))
    expect = np.ones(nt)
    expect[2:] = np.exp(-2 * k * 0.1 * np.arange(1, nt - 1))
    np.testing.assert_allclose(power[:, 0].numpy(), expect, rtol=1e-12)
    np.testing.assert_allclose(float(d_power[2, 0]), expect[1] - expect[2],
                               rtol=1e-12)


def write_trace(path, file_cls, rows):
    with file_cls(path, num_rays=N) as f:
        for name in absorption.STATE_NAMES:
            f.create_variable(name)
        for i, row in enumerate(rows):
            f.write_step(i, row)


@pytest.mark.parametrize("method", ["weak_damping", "root_finder"])
def test_run_absorption_round_trip(equilibria, tmp_path, method):
    """A trace file written and reopened by the port's ResultFile, kamp
    appended through an AsyncWriter, read back: the JAX run_absorption's
    kamp on the same rows, written through the JAX package's file."""
    jeq, teq = equilibria["slab"]
    base = launch("slab")
    rows = [{name: np.real(base[key]) + (0.001 * i if key == "x" else 0.0)
             for name, key in zip(absorption.STATE_NAMES,
                                  RayState._fields)} for i in range(3)]
    write_trace(tmp_path / "port.nc", ResultFile, rows)
    write_trace(tmp_path / "jax.nc", JaxResultFile, rows)
    with ResultFile(tmp_path / "port.nc", mode="r+") as f:
        absorption.run_absorption(f, teq, method=method, device="cpu",
                                  writer=AsyncWriter(f))
    with ResultFile(tmp_path / "port.nc", mode="r") as f:
        got = np.stack([f.read_step(i, ["kamp"], complex_valued=True)
                        ["kamp"] for i in range(f.num_steps)])
    with JaxResultFile(tmp_path / "jax.nc", mode="r+") as f:
        jax_absorption.run_absorption(f, jeq, method=method, split=False)
        want = np.stack([f.read_step(i, ["kamp"], complex_valued=True)
                         ["kamp"] for i in range(f.num_steps)])
    assert got.shape == (3, N)
    assert_close(got, want)


@pytest.mark.parametrize("safe_math", [True, False])
def test_safe_math_scrub(tmp_path, safe_math):
    """SAFE_MATH store scrubbing (cuda_context.hpp:883-899): a kamp with a
    NaN or an infinite part is stored as 0; without the scrub it is
    stored as it came."""
    base = launch("slab")
    rows = [{name: np.real(base[key]) for name, key in zip(
        absorption.STATE_NAMES, RayState._fields)}]
    write_trace(tmp_path / "r.nc", ResultFile, rows)

    def update(state):
        kamp = state.kx.clone()
        kamp[1] = complex(np.nan, 1.0)
        kamp[2] = complex(1.0, np.inf)
        return kamp

    with ResultFile(tmp_path / "r.nc", mode="r+") as f:
        absorption.run_absorption(f, make_slab(), update_fn=update,
                                  device="cpu", safe_math=safe_math)
        kamp = f.read_step(0, ["kamp"], complex_valued=True)["kamp"]
    if safe_math:
        assert kamp[1] == 0 and kamp[2] == 0
    else:
        assert np.isnan(kamp[1].real) and np.isinf(kamp[2].imag)
    np.testing.assert_array_equal(kamp[3:], np.real(base["kx"][3:]))


@pytest.mark.parametrize("kind", ["slab", "efit"])
def test_complex_ray_rhs_matches_jax(equilibria, kind):
    """The holomorphic ray RHS at a complex state (Im x and Im kx): torch
    gives the conjugate of each partial, which would conjugate every
    ratio -D_k/D_w, D_x/D_w."""
    from graph_framework_tpu.models.rays import make_ray_rhs as jax_rhs
    jeq, teq = equilibria[kind]
    arr = launch(kind, imag=3.0)
    arr["x"] = arr["x"] + 0.01j
    js, ts = states(arr)
    want = jax_rhs(jax_dispersion.cold_plasma, jeq)(js)
    got = make_ray_rhs(dispersion.cold_plasma, teq)(ts)
    for w, g in zip(want, got):
        assert_close(g, w)
    assert max(np.abs(np.asarray(w).imag).max() for w in want) > 0


def test_complex_init_k_and_trace_match_jax(equilibria):
    """init_k from a complex guess (holomorphic Newton; the default
    tolerance is 1e-30 in complex128, as for float64), then an rk4 trace
    of a state with imaginary parts, against the JAX package."""
    jeq, teq = equilibria["efit"]
    rng = np.random.default_rng(5)
    arr = {k: np.full(N, v, dtype=np.complex128) for k, v in dict(
        t=0.0, w=500.0, y=0.0, z=0.0, kx=-500.0 + 5.0j, kz=0.0).items()}
    arr["x"] = 2.5 + 0.02 * rng.standard_normal(N) + 0.01j
    arr["ky"] = 150.0 + 10.0 * rng.standard_normal(N) + 0j
    js, ts = states(arr)
    js = jax_init_k(js, jax_dispersion.cold_plasma, jeq)
    ts, diag = init_k(ts, dispersion.cold_plasma, teq,
                      return_diagnostics=True)
    assert diag.converged and float(diag.residual) <= 1e-30
    assert_close(ts.kx, js.kx)
    assert np.abs(np.asarray(js.kx).imag).max() > 1e-3
    want, _ = JaxSolver(jax_dispersion.cold_plasma, jeq, method="rk4",
                        dt=1e-4, sub_steps=2).trace(js, 3)
    got, traj = Solver(dispersion.cold_plasma, teq, method="rk4", dt=1e-4,
                       sub_steps=2).trace(ts, 3)
    assert traj.x.shape == (4, N) and traj.x.dtype == torch.complex128
    for field in ("x", "y", "z", "kx", "ky", "kz"):
        assert_close(getattr(got, field), getattr(want, field))


def _referee_state(gold):
    p, k = gold["p"], gold["k"]
    return make_ray_state(
        p.shape[0], w=float(gold["w"]), x=torch.from_numpy(p[:, 0]),
        y=torch.from_numpy(p[:, 1]), z=torch.from_numpy(p[:, 2]),
        kx=torch.from_numpy(k[:, 0]), ky=torch.from_numpy(k[:, 1]),
        kz=torch.from_numpy(k[:, 2]), dtype=torch.complex128, device="cpu")


def _reference_efit():
    path = REFERENCE_DATA / "efit.nc"
    if not path.exists():
        pytest.skip(f"{path} is not present")
    return make_efit(path, device="cpu")


def test_golden_kamp_efit():
    """The referee's weak-damping kamp along an EFIT ray
    (tests/test_reference_parity.py: real part rtol 1e-6, imaginary part
    1e-5), by the port's native complex path."""
    eq = _reference_efit()
    gold = load_fixture("golden_kamp_efit")
    kamp = absorption.make_weak_damping(eq)(_referee_state(gold)).numpy()
    np.testing.assert_allclose(kamp.real, gold["kamp_re"], rtol=1e-6)
    np.testing.assert_allclose(kamp.imag, gold["kamp_im"], rtol=1e-5)


def test_golden_rootfind_efit():
    """The referee's complex Newton kamp roots of the full hot-plasma D
    (tolerance 1e-26, 80 iterations; real part rtol 1e-6, imaginary part
    rtol 1e-5 with atol 1e-10 of the largest real part)."""
    eq = _reference_efit()
    gold = load_fixture("golden_rootfind_efit")
    kamp = absorption.make_root_finder(eq, tolerance=1e-26,
                                       max_iterations=80)(
        _referee_state(gold)).numpy()
    k_scale = float(np.abs(gold["kamp_re"]).max())
    np.testing.assert_allclose(kamp.real, gold["kamp_re"], rtol=1e-6)
    np.testing.assert_allclose(kamp.imag, gold["kamp_im"], rtol=1e-5,
                               atol=1e-10 * k_scale)


def test_jax_grad_is_not_conjugated():
    """The convention the port corrects for: jax.grad(holomorphic=True)
    of z^3 at 1 + i is 3 (1 + i)^2 = 6i; torch's autograd gives -6i, and
    holomorphic_grad 6i."""
    from graph_framework_tpu_torch.ops.special import holomorphic_grad
    z0 = 1.0 + 1.0j
    assert complex(jax.grad(lambda z: z ** 3, holomorphic=True)(
        jnp.complex128(z0))) == 6j
    z = torch.tensor([z0], requires_grad=True)
    (raw,) = torch.autograd.grad(z ** 3, z, torch.ones_like(z))
    assert complex(raw[0]) == -6j
    z = torch.tensor([z0], requires_grad=True)
    assert complex(holomorphic_grad(z ** 3, (z,))[0][0]) == 6j
