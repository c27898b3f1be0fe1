"""The four-gather 1D spline (``ops.spline.spline_1d``) against the JAX
package's and scipy's, as tests/test_spline.py holds the JAX one: values to
1e-12 and derivatives (autograd against scipy's first derivative) to
1e-10 on a uniform grid; the port and JAX to 1e-14 of the values' scale,
also in cell-local form and past both table ends (clamped cells)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.interpolate import CubicSpline

from graph_framework_tpu.ops import spline_1d as jax_spline_1d
from graph_framework_tpu_torch.ops.spline import (
    rebase_cells_1d, spline_1d)
from test_spline import _cell_coeffs_from_scipy


def _tables(offset, scale, n, f):
    grid = offset + scale * np.arange(n + 1)
    cs = CubicSpline(grid, f(grid))
    return cs, _cell_coeffs_from_scipy(cs, offset, scale, n)


def test_spline_1d_matches_scipy():
    offset, scale, n = -2.0, 0.125, 48
    cs, coeffs = _tables(offset, scale, n,
                         lambda x: np.sin(x) * np.exp(-0.1 * x ** 2))
    xq = np.linspace(offset + 0.01, offset + scale * n - 0.01, 333)
    got = spline_1d(*[torch.as_tensor(c) for c in coeffs],
                    torch.as_tensor(xq), scale, offset)
    np.testing.assert_allclose(got.numpy(), cs(xq), rtol=0, atol=1e-12)


def test_spline_1d_gradient_matches_scipy_derivative():
    offset, scale, n = 0.0, 0.1, 64
    cs, coeffs = _tables(offset, scale, n, lambda x: np.cos(2.0 * x))
    x = torch.tensor(np.linspace(0.05, scale * n - 0.05, 101),
                     requires_grad=True)
    value = spline_1d(*[torch.as_tensor(c) for c in coeffs], x, scale,
                      offset)
    (grad,) = torch.autograd.grad(value.sum(), x)
    np.testing.assert_allclose(grad.numpy(), cs(x.detach().numpy(), 1),
                               rtol=0, atol=1e-10)


@pytest.mark.parametrize("local", [False, True])
def test_spline_1d_matches_jax(local):
    """Values and x-derivatives of the port against the JAX function on
    the same tables, inside the table and past both ends."""
    offset, scale, n = -1.0, 0.05, 40
    _, coeffs = _tables(offset, scale, n, lambda x: np.tanh(3.0 * x))
    if local:
        coeffs = tuple(rebase_cells_1d(np.stack(coeffs)))
    xq = np.linspace(offset - 0.2, offset + scale * n + 0.2, 257)
    want = jax_spline_1d(*[jnp.asarray(c) for c in coeffs],
                         jnp.asarray(xq), scale, offset, local=local)
    want_grad = jax.vmap(jax.grad(lambda v: jax_spline_1d(
        *[jnp.asarray(c) for c in coeffs], v, scale, offset,
        local=local)))(jnp.asarray(xq))
    x = torch.tensor(xq, requires_grad=True)
    got = spline_1d(*[torch.as_tensor(c) for c in coeffs], x, scale,
                    offset, local=local)
    (got_grad,) = torch.autograd.grad(got.sum(), x)
    for a, b in ((got.detach(), want), (got_grad, want_grad)):
        b = np.asarray(b)
        assert np.abs(a.numpy() - b).max() <= 1e-14 * np.abs(b).max()
