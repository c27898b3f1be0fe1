"""K7, the VMEC mode sums: its plain version and autograd Function against
the JAX package's kernel in Pallas interpret mode.

The pattern of ``tests/test_pallas_vmec_modes.py``: N = 257 rays (not a
multiple of the JAX kernel's block), M = 90 modes on the (10 x 9) grid,
float64, seeded normal coefficient blocks.  On the CPU the port's Function
runs the plain version forward and the plain adjoint backward; the values,
the first-order gradients and reverse over reverse are held to the JAX
kernel's custom vjp to 1e-10 (two frameworks rounding the same sums over
90 modes; they read about 1e-14).  The CUDA kernel is held to the plain
version on the card (``tests/test_torch_card.py``, ``chip_smoke.py`` phase
15).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graph_framework_tpu.pallas.vmec_modes import make_mode_sums as jax_make
from graph_framework_tpu_torch.kernels import vmec_modes

N, M = 257, 90
TOL = 1.0e-10


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    u = rng.uniform(0.0, 6.0, N)
    v = rng.uniform(0.0, 6.0, N)
    blocks = [rng.standard_normal((N, M)) for _ in range(5)]
    xm = np.repeat(np.arange(10.0), 9)
    xn = np.tile(np.arange(9.0) - 4.0, 10)
    return (u, v, *blocks), (xm, xn)


def _both(data):
    args, (xm, xn) = data
    jf = jax_make(jnp.asarray(xm), jnp.asarray(xn), block=128,
                  interpret=True)
    pf = vmec_modes.make_mode_sums(torch.from_numpy(xm),
                                   torch.from_numpy(xn))
    return jf, pf, [jnp.asarray(a) for a in args], [
        torch.from_numpy(a) for a in args]


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))


def _loss(outs):
    return sum((o.sin() if isinstance(o, torch.Tensor) else jnp.sin(o))
               .sum() * (i + 1.0) for i, o in enumerate(outs))


@pytest.mark.parametrize("form", ["plain version", "Function"])
def test_values_match_jax_kernel(form, data):
    jf, pf, jargs, pargs = _both(data)
    want = jf(*jargs)
    if form == "plain version":
        got = vmec_modes.reference_forward(*pargs, *[torch.from_numpy(a)
                                                      for a in data[1]])
    else:
        got = pf(*pargs)
    for g, w in zip(got, want):
        assert _rel(g, w) < TOL


def test_first_order_gradients_match_jax_kernel(data):
    jf, pf, jargs, pargs = _both(data)
    want = jax.grad(lambda *a: _loss(jf(*a)), argnums=tuple(range(7)))(
        *jargs)
    leaves = [a.clone().requires_grad_(True) for a in pargs]
    got = torch.autograd.grad(_loss(pf(*leaves)), leaves)
    for g, w in zip(got, want):
        assert _rel(g, w) < TOL


def test_second_order_gradients_match_jax_kernel(data):
    """grad of grad: the backward is plain torch, differentiable, as the
    JAX kernel's custom vjp is plain JAX."""
    jf, pf, jargs, pargs = _both(data)

    def jax_outer(u):
        def inner(uv):
            out = jf(uv[0], uv[1], *jargs[2:])
            return jnp.sum(out[0] * out[3]) + jnp.sum(out[9])
        return jnp.sum(jax.grad(inner)(jnp.stack([u, jargs[1]])) ** 2)

    want = jax.grad(jax_outer)(jargs[0])
    u = pargs[0].clone().requires_grad_(True)
    v = pargs[1].clone().requires_grad_(True)
    out = pf(u, v, *pargs[2:])
    inner = (out[0] * out[3]).sum() + out[9].sum()
    gu, gv = torch.autograd.grad(inner, [u, v], create_graph=True)
    (got,) = torch.autograd.grad((gu ** 2).sum() + (gv ** 2).sum(), [u])
    assert _rel(got, want) < TOL


def test_wrapper_refuses_and_counts(data):
    _, _, _, pargs = _both(data)
    xm, xn = [torch.from_numpy(a) for a in data[1]]
    before = vmec_modes.vmec_modes_launches
    with pytest.raises(ValueError, match="one dtype and device"):
        vmec_modes.mode_sums(*pargs[:6], pargs[6].float(), xm, xn)
    with pytest.raises(ValueError, match="five"):
        vmec_modes.mode_sums(*pargs[:6], pargs[6][:, :-1].contiguous(),
                             xm, xn)
    assert len(vmec_modes.mode_sums(*pargs, xm, xn)) == 10
    assert vmec_modes.vmec_modes_launches == before
