"""The port's special functions (ops/special.py) against the JAX package's
and against scipy.special, on seeded complex grids that reach every
branch: the continued fraction (|z| >= 6), Weideman's series (|z| < 6),
erf's Maclaurin disk (|z| < 0.2), both axes, the lower half-plane and
the overflow edges of the imaginary axis.  complex128 to relative 1e-10
unless the JAX test of the function states its own limit.

The holomorphic derivatives are held to ``jax.grad(holomorphic=True)`` at
points with Im z of order 1, where torch's autograd, which returns
conj(f'(z)), would fail without the conjugation of
``ops.special.holomorphic_grad``.
"""

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.special as sps
import torch

from graph_framework_tpu.ops import special as jax_special
from graph_framework_tpu_torch.ops import special

RTOL = 1.0e-10
COMPLEX_FUNCTIONS = ["wofz", "erf_complex", "erfi", "z_plasma",
                     "z_power_series", "z_erfi"]
REAL_FUNCTIONS = ["dawson", "erfcx", "erfi"]


def branch_grid(seed=0):
    """Complex points over every branch of w and erf."""
    rng = np.random.default_rng(seed)
    parts = [
        rng.uniform(-12, 12, 600) + 1j * rng.uniform(-8, 8, 600),
        rng.uniform(-0.2, 0.2, 100) + 1j * rng.uniform(-0.2, 0.2, 100),
        6.0 * np.exp(1j * rng.uniform(0, 2 * np.pi, 100))
        * rng.uniform(0.98, 1.02, 100),
        rng.uniform(-10, 10, 50) + 0j,             # the real axis
        1j * rng.uniform(-10, 10, 50),             # the imaginary axis
        np.array([0.0, 1e-3, -1e-3j, 26j, -26j, 27j, -27j, 30j, -30j,
                  50 + 1j, -30 + 0.1j, 100 - 2j, 7.5, 20j]),
    ]
    return np.concatenate(parts)


def compare(got, want, rtol):
    """Relative deviation where both are finite; the two must agree on
    which points are finite."""
    got = np.asarray(got).astype(np.complex128)
    want = np.asarray(want).astype(np.complex128)
    finite = np.isfinite(want)
    assert np.array_equal(np.isfinite(got), finite)
    scale = np.maximum(np.abs(want[finite]), 1e-300)
    rel = np.abs(got[finite] - want[finite]) / scale
    assert rel.max() <= rtol, rel.max()


@pytest.mark.parametrize("name", COMPLEX_FUNCTIONS)
def test_complex_functions_match_jax(name):
    z = branch_grid()
    want = getattr(jax_special, name)(jnp.asarray(z))
    got = getattr(special, name)(torch.from_numpy(z))
    assert got.dtype == torch.complex128
    compare(got.numpy(), want, RTOL)


@pytest.mark.parametrize("name", REAL_FUNCTIONS)
def test_real_functions_match_jax(name):
    x = np.linspace(-10, 10, 401)
    want = np.asarray(getattr(jax_special, name)(jnp.asarray(x)))
    got = getattr(special, name)(torch.from_numpy(x))
    assert not got.is_complex()
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=1e-300)


def test_wofz_against_scipy():
    """tests/test_special.py's limits: 5e-13 norm-relative on the grid,
    1e-13 at large |z|."""
    z = branch_grid(1)
    want = sps.wofz(z)
    got = special.wofz(torch.from_numpy(z)).numpy()
    finite = np.isfinite(want)
    err = np.abs(got - want)[finite] / np.abs(want[finite])
    assert err.max() < 5e-13, err.max()
    big = np.array([50 + 1j, -30 + 0.1j, 100 - 2j, 7.5 + 0.0j, 20j])
    got = special.wofz(torch.from_numpy(big)).numpy()
    assert (np.abs(got - sps.wofz(big)) / np.abs(sps.wofz(big))).max() \
        < 1e-13


def test_erf_and_real_functions_against_scipy():
    """erf 2e-12 on |Re|, |Im| <= 5 and 1e-14 in the series disk; the
    real erfi 1e-12 (tests/test_special.py); dawson and erfcx 1e-13."""
    rng = np.random.default_rng(7)
    z = rng.uniform(-5, 5, 400) + 1j * rng.uniform(-5, 5, 400)
    got = special.erf_complex(torch.from_numpy(z)).numpy()
    want = sps.erf(z)
    assert (np.abs(got - want) / np.maximum(np.abs(want), 1e-300)).max() \
        < 2e-12
    small = np.array([1e-3 + 1e-3j, 0.05 - 0.02j, -0.01 + 0.1j, 0.0])
    np.testing.assert_allclose(
        special.erf_complex(torch.from_numpy(small)).numpy(),
        sps.erf(small), rtol=1e-14, atol=1e-16)
    x = np.linspace(-5, 5, 101)
    xt = torch.from_numpy(x)
    np.testing.assert_allclose(special.erfi(xt).numpy(), sps.erfi(x),
                               rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(special.dawson(xt).numpy(), sps.dawsn(x),
                               rtol=1e-13, atol=1e-15)
    np.testing.assert_allclose(special.erfcx(xt).numpy(), sps.erfcx(x),
                               rtol=1e-13)


@pytest.mark.parametrize("name", ["wofz", "erf_complex", "z_plasma"])
def test_complex64_path(name):
    """complex64 in, complex64 out, within f32 rounding of the JAX
    package's complex64 evaluation (the Weideman coefficients rounded to
    f32 as there)."""
    z = branch_grid(2)
    z = z[np.abs(z) < 20].astype(np.complex64)
    want = np.asarray(getattr(jax_special, name)(jnp.asarray(z)))
    got = getattr(special, name)(torch.from_numpy(z))
    assert got.dtype == torch.complex64
    compare(got.numpy(), want, 2.0e-6)


@pytest.mark.parametrize("name", ["wofz", "z_plasma", "erf_complex"])
def test_holomorphic_derivative(name):
    """d f/dz from holomorphic_grad against jax.grad(holomorphic=True) at
    points off the real axis, where conj(f') differs from f'."""
    rng = np.random.default_rng(3)
    z = (rng.uniform(-3, 3, 40) + 1j * rng.uniform(0.5, 1.5, 40))
    z = np.concatenate([z, z.conj(), [7.0 + 1.0j, -6.5 + 0.8j]])
    fn = getattr(jax_special, name)
    want = np.asarray(jax.vmap(jax.grad(fn, holomorphic=True))(
        jnp.asarray(z)))
    zt = torch.from_numpy(z).requires_grad_(True)
    (got,) = special.holomorphic_grad(getattr(special, name)(zt), (zt,))
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL)
    assert np.abs(want.imag).max() > 0.1


def test_weideman_coefficients_are_the_jax_packages():
    """The same L and 64 coefficients, in float64 and rounded to f32."""
    ell, a = special._weideman_coeffs(64)
    jell, ja = jax_special._weideman_coeffs(64)
    assert ell == jell and np.array_equal(a, ja)
    _, a32 = special._weideman_table(torch.float32)
    assert np.array_equal(np.asarray(a32, dtype=np.float32),
                          ja.astype(np.float32))


def test_erfi_golden_file(erfi_file):
    """tests/test_special.py's golden leg (erfi_test.cpp): the reference's
    test_erfi.nc from its sixth entry on, 5e-13, where present."""
    if not erfi_file.exists():
        pytest.skip(f"{erfi_file} is not present")
    with h5py.File(erfi_file, "r") as h:
        x, y = h["x"][:], h["y"][:]
        gold = h["re"][:] + 1j * h["img"][:]
    got = special.erfi(torch.from_numpy(x + 1j * y)).numpy()
    for i in range(5, len(x)):
        if not (np.isfinite(gold[i]) and np.isfinite(got[i])):
            continue
        assert abs(1.0 - got[i] / gold[i]) <= 5e-13, (i, gold[i], got[i])
