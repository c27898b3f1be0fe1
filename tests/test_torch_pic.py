"""The port's PIC path (xpic) against the JAX package, on the CPU.

The same inputs, made with numpy from a seed, go through the JAX function
and its counterpart in the port, in float64: the shape functions, the
dense deposit and the deposit kernel's plain version (against the JAX
package's dense deposit and its Pallas deposit kernel in interpret mode),
the RK4 push, and three steps of the whole deposit-then-push loop.  The
port's ``run_pic`` draws its start from a torch.Generator (the JAX
package's from jax.random), so the loop is compared from the same
numpy-made start and ``run_pic`` itself gets a smoke test.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graph_framework_tpu.models import pic as jax_pic
from graph_framework_tpu.pallas.deposit import deposit_pallas
from graph_framework_tpu_torch.convert import pic_state_from_numpy
from graph_framework_tpu_torch.kernels import deposit as k6
from graph_framework_tpu_torch.models import pic

NUM_GRID = 64
SCALE, OFFSET = 2.0 / (NUM_GRID - 1.0), -1.0


def _scaled(got, want):
    """max |got - want| / max |want|."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.max(np.abs(got - want)) / (np.max(np.abs(want)) or 1.0)


def _grid(n=NUM_GRID):
    return OFFSET + SCALE * np.arange(n, dtype=np.float64)


def test_shape_functions_match_jax():
    dx = np.random.default_rng(0).uniform(-0.02, 0.02, 256)
    np.testing.assert_allclose(
        pic.shape_density(torch.from_numpy(dx)).numpy(),
        np.asarray(jax_pic.shape_density(jnp.asarray(dx))), rtol=1e-14)
    np.testing.assert_allclose(
        pic.shape_efield(torch.from_numpy(dx), te=2.0, q=0.5).numpy(),
        np.asarray(jax_pic.shape_efield(jnp.asarray(dx), te=2.0, q=0.5)),
        rtol=1e-13)
    # the field is the analytic (te/q) 2 dx / w of the dense deposit
    np.testing.assert_allclose(
        pic.shape_efield(torch.from_numpy(dx)).numpy(),
        pic._efield_dense(torch.from_numpy(dx)).numpy(), rtol=1e-12)


def test_dense_deposit_matches_jax():
    x = np.random.default_rng(1).normal(0.0, 0.25, 5000)
    want = jax_pic.deposit(jnp.asarray(x), jnp.asarray(_grid()), SCALE,
                           OFFSET)
    got = pic.deposit(torch.from_numpy(x), torch.from_numpy(_grid()),
                      SCALE, OFFSET)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               atol=1e-12)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                               rtol=1e-12)


@pytest.mark.parametrize("num_grid", [64, 61], ids=["G64", "G61-ragged"])
def test_deposit_kernel_plain_matches_jax_kernel(num_grid):
    """K6's wrapper on CPU tensors (its plain version) against the JAX
    deposit kernel in interpret mode, with a mask holding zeros: the port
    takes 3001 particles and any grid; the JAX kernel takes the particles
    padded to its block (mask 0) and the grid padded to its tile, sliced
    back.  n to 1e-12 absolute, e to 1e-12 relative
    (tests/test_particles.py's limits)."""
    rng = np.random.default_rng(2)
    n = 3001
    x = rng.normal(0.0, 0.25, n)
    mask = (rng.uniform(size=n) > 0.1).astype(np.float64)
    block, tile = 1024, 64
    xp = np.zeros(3072)
    xp[:n] = x
    mp = np.zeros(3072)
    mp[:n] = mask
    jn, je = deposit_pallas(jnp.asarray(xp), jnp.asarray(mp),
                            jnp.asarray(_grid(64)), block=block, tile=tile,
                            interpret=True)
    before = k6.deposit_launches
    pn, pe = k6.deposit(torch.from_numpy(x), torch.from_numpy(mask),
                        torch.from_numpy(_grid(num_grid)))
    assert k6.deposit_launches == before
    assert pn.shape == pe.shape == (num_grid,)
    np.testing.assert_allclose(pn.numpy(), np.asarray(jn)[:num_grid],
                               atol=1e-12)
    np.testing.assert_allclose(pe.numpy(), np.asarray(je)[:num_grid],
                               rtol=1e-12)
    # the mask counts: dropping it moves both
    un, ue = k6.deposit(torch.from_numpy(x),
                        torch.ones(n, dtype=torch.float64),
                        torch.from_numpy(_grid(num_grid)))
    assert float((un - pn).abs().max()) > 1.0
    assert float((ue - pe).abs().max()) > 1.0


def test_deposit_wrapper_refuses():
    x = torch.zeros(8, dtype=torch.float64)
    grid = torch.zeros(4, dtype=torch.float64)
    with pytest.raises(ValueError, match="mask"):
        k6.deposit(x, torch.ones(7, dtype=torch.float64), grid)
    with pytest.raises(ValueError, match="one dtype"):
        k6.deposit(x, torch.ones(8, dtype=torch.float32), grid)
    with pytest.raises(ValueError, match="contiguous"):
        k6.deposit(x, torch.ones(16, dtype=torch.float64)[::2], grid)
    with pytest.raises(TypeError, match="float32/float64"):
        k6.deposit(x.half(), x.half(), grid.half())
    with pytest.raises(ValueError, match="no backward"):
        k6.deposit(x.clone().requires_grad_(True), torch.ones_like(x), grid)
    with pytest.raises(ValueError, match="grid point"):
        k6.deposit(x, torch.ones_like(x), grid[:0])
    n, e = k6.deposit(x[:0], x[:0], grid)
    assert not bool(n.any()) and not bool(e.any())


def _start(n, seed):
    rng = np.random.default_rng(seed)
    return dict(x=0.25 * rng.standard_normal(n),
                vpara=0.25 * rng.standard_normal(n),
                epara=np.zeros(NUM_GRID), n=np.zeros(NUM_GRID))


def _both_states(arrays):
    jst = jax_pic.PicState(**{k: jnp.asarray(v) for k, v in arrays.items()})
    return jst, pic_state_from_numpy(jst, device="cpu")


def test_push_step_matches_jax():
    arrays = _start(2000, seed=3)
    arrays["epara"] = np.random.default_rng(4).normal(0.0, 1e3, NUM_GRID)
    jst, pst = _both_states(arrays)
    jst = jax_pic.make_push_step(SCALE, OFFSET, dt=1e-5)(jst)
    pst = pic.make_push_step(SCALE, OFFSET, dt=1e-5)(pst)
    for f in ("x", "vpara"):
        assert _scaled(getattr(pst, f).numpy(), getattr(jst, f)) <= 1e-14, f


def test_xpic_loop_matches_jax():
    """The whole xpic slice: 3 steps of deposit-then-push from the same
    numpy-made start (2000 particles, 64 grid points, dt 1e-9), the port's
    make_deposit/make_push_step loop against the JAX package's (its dense
    deposit), each leaf relative to its scale."""
    jst, pst = _both_states(_start(2000, seed=5))
    jdep = jax_pic.make_deposit(2000, NUM_GRID, SCALE, OFFSET, jnp.float64)
    jpush = jax_pic.make_push_step(SCALE, OFFSET, dt=1e-9)
    pdep = pic.make_deposit(NUM_GRID, SCALE, OFFSET, torch.float64,
                            device="cpu")
    ppush = pic.make_push_step(SCALE, OFFSET, dt=1e-9)
    for _ in range(3):
        n, e = jdep(jst.x)
        jst = jpush(jst._replace(n=n, epara=e))
        n, e = pdep(pst.x)
        pst = ppush(pst._replace(n=n, epara=e))
    for f in jax_pic.PicState._fields:
        assert _scaled(getattr(pst, f).numpy(), getattr(jst, f)) <= 1e-10, f


def test_run_pic_smoke():
    st = pic.run_pic(num_particles=2000, num_grid=NUM_GRID, num_steps=3,
                     dt=1e-9, dtype=torch.float64, device="cpu")
    assert all(bool(torch.isfinite(a).all()) for a in st)
    assert st.n.shape == st.epara.shape == (NUM_GRID,)
    assert float(st.n.max()) > 0
