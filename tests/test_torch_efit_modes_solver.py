"""The O- and X-mode window kernels through the Solver, their refusals
and their gradients, against the JAX package; the other eight tails
through the Solver; the hot plasmas' refusals.

As tests/test_torch_efit_modes.py (the windows themselves): the plain
versions on the CPU against the JAX window kernel in interpret mode, 256
rays of chip_smoke's launch with kx solved for each mode, float64, the
synthetic EFIT file, tolerance 1e-10.
"""

import jax
import numpy as np
import pytest
import torch

import chip_smoke
from graph_framework_tpu.models import dispersion as jax_disp
from graph_framework_tpu.pallas.efit_step import make_frozen_window_step
from graph_framework_tpu.solver import Solver as JaxSolver
from graph_framework_tpu_torch.kernels import efit_step
from graph_framework_tpu_torch.models import dispersion
from graph_framework_tpu_torch.models.rays import RayState
from graph_framework_tpu_torch.solver import Solver
from test_torch_common import leaf_errors
from test_torch_efit_modes import (  # noqa: F401  (eqs is a fixture)
    DT, MODES, STEPS, SUB_STEPS, TOL, eqs, roots)


@pytest.mark.parametrize("name", MODES)
def test_solver_window_kernel_takes_the_modes(eqs, name):
    """Solver(window_kernel=True) with the mode against the JAX
    Solver(pallas_window=True), the production stack; the port's own
    frozen path gives the same numbers exactly."""
    jeq, peq = eqs
    jroot, proot = roots(eqs, name)
    kw = dict(method="rk2", dt=DT, sub_steps=SUB_STEPS, frozen_cells=True,
              freeze_every=5, compensated=True)
    want = JaxSolver(jax_disp.DISPERSIONS[name], jeq, pallas_window=True,
                     pallas_block_rows=2, **kw).run(jroot, STEPS)
    disp = dispersion.DISPERSIONS[name]
    got = Solver(disp, peq, window_kernel=True, **kw).run(proot, STEPS)
    errs = leaf_errors(got, want)
    assert max(errs.values()) < TOL, errs
    same = Solver(disp, peq, **kw).run(proot, STEPS)
    assert all(torch.equal(a, b) for a, b in zip(got, same))


@pytest.mark.parametrize("entry", ["Solver", "efit_window",
                                   "efit_window_vjp"])
@pytest.mark.parametrize("name", ["hot_plasma", "hot_plasma_expansion"])
def test_kernels_refuse_other_dispersions(eqs, name, entry):
    """The window kernels implement every real dispersion; the hot
    plasmas, complex only, raise at each entry point, on the CPU as on
    the card, with no fallback to the plain version."""
    _, peq = eqs
    _, proot = roots(eqs, "ordinary_wave")
    disp = dispersion.DISPERSIONS[name]
    with pytest.raises(ValueError, match="hot plasmas are complex"):
        if entry == "Solver":
            Solver(disp, peq, method="rk2", frozen_cells=True,
                   window_kernel=True)
        elif entry == "efit_window":
            efit_step.efit_window(peq, proot, method="rk2", dt=DT, steps=2,
                                  compensated=False, dispersion=disp)
        else:
            efit_step.efit_window_vjp(peq, proot, proot, method="rk2",
                                      dt=DT, steps=2, dispersion=disp)
    real = {d for n, d in dispersion.DISPERSIONS.items()
            if not n.startswith("hot_plasma")}
    assert set(efit_step.KERNEL_DISPERSIONS) == real
    assert sorted(efit_step.KERNEL_DISPERSIONS.values()) == list(range(11))


@pytest.mark.parametrize("tag", list(chip_smoke.TAILS))
def test_solver_window_kernel_takes_the_tails(eqs, tag):
    """Solver(window_kernel=True) with each of the other eight tails (its
    plain window here, no launch) gives the port's own frozen path exactly,
    from the tail's launch; the JAX comparison of the windows is
    tests/test_torch_efit_tails.py's."""
    _, peq = eqs
    disp = chip_smoke.TAILS[tag]
    proot, dt = chip_smoke.tail_launch(tag, 256, peq)
    kw = dict(method="rk2", dt=dt, sub_steps=SUB_STEPS, frozen_cells=True,
              freeze_every=5, compensated=True)
    efit_step.efit_window_launches = 0
    got = Solver(disp, peq, window_kernel=True, **kw).run(proot, STEPS)
    same = Solver(disp, peq, **kw).run(proot, STEPS)
    assert all(torch.equal(a, b) for a, b in zip(got, same))
    assert all(bool(torch.isfinite(leaf).all()) for leaf in got)
    assert efit_step.efit_window_launches == 0


@pytest.mark.parametrize("name", MODES)
def test_mode_window_gradients_match_jax(eqs, name):
    """State gradients through efit_window with the mode (EfitWindow: the
    plain window forward, K2's plain version backward) against jax.grad
    through the JAX window kernel's custom_vjp, K = 1 (interpret mode)."""
    jeq, peq = eqs
    jroot, proot = roots(eqs, name)
    jfn = jax_disp.DISPERSIONS[name]
    step = make_frozen_window_step(jeq, jfn, method="rk2", dt=DT,
                                   sub_steps=SUB_STEPS, freeze_every=1,
                                   block_rows=2, interpret=True)

    def jax_loss(s):
        def body(c, _):
            return step(c), None
        out = jax.lax.scan(body, s, None, length=STEPS)[0]
        return (out.x.sum() + out.y.sum() + out.z.sum()
                + out.kx.sum()) / out.x.shape[0]

    want = jax.jit(jax.grad(jax_loss))(jroot)
    leaves = [leaf.detach().clone().requires_grad_(True) for leaf in proot]
    carry = RayState(*leaves)
    for _ in range(STEPS * SUB_STEPS):
        carry = efit_step.efit_window(
            peq, carry, method="rk2", dt=DT, steps=1, compensated=False,
            dispersion=dispersion.DISPERSIONS[name])
    assert "EfitWindow" in type(carry.x.grad_fn).__name__
    loss = (carry.x.sum() + carry.y.sum() + carry.z.sum()
            + carry.kx.sum()) / carry.x.shape[0]
    got = torch.autograd.grad(loss, leaves, allow_unused=True)
    for f, g, w in zip(RayState._fields, got, want):
        w = np.asarray(w)
        g = np.zeros_like(w) if g is None else g.numpy()
        scale = max(np.abs(w).max(), 1e-300)
        assert np.abs(g - w).max() / scale < TOL, f
