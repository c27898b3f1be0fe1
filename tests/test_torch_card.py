"""Card-only tests of the CUDA window kernels; they skip without a card.

This file imports no jax, so it also runs on a machine with a card and
without the JAX package's dependencies; from the repository root:

    python -m pytest tests/test_torch_card.py -q -m gpu --noconftest

The kernel is held to its plain version by ``chip_smoke.check_window``:
per leaf, relative to the leaf group's scale, within ``chip_smoke.TOL``
for its dtype and compensation (the kernel's FMA contraction and forward
mode round differently from the plain version's separate operations and
reverse mode), with each limit checked to lie well below what a kernel
that lost the low words or ran the other Runge-Kutta order would show.
The backward kernels K2 and K3 are held to autograd of the plain version
by ``chip_smoke.check_window_bwd`` the same way (``chip_smoke.BWD_TOL``;
the wrong backwards: v_w dropped, the other order's transpose).
"""

import dataclasses


import pytest
import torch

import chip_smoke
from graph_framework_tpu_torch.kernels import efit_step
from graph_framework_tpu_torch.models.dispersion import cold_plasma
from graph_framework_tpu_torch.models.rays import RayState
from graph_framework_tpu_torch.ops.compensated import init_comp_carry
from graph_framework_tpu_torch.solver import init_k

pytestmark = pytest.mark.gpu

RAGGED = 1029     # 8 full blocks of 128 threads and a ragged ninth


@pytest.fixture(scope="module")
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _root(dtype, device, n=RAGGED):
    eq = chip_smoke.synthetic_equilibrium(dtype, device)
    return eq, init_k(chip_smoke.launch(n, dtype, device), cold_plasma, eq)


@pytest.mark.parametrize("compensated", [False, True],
                         ids=["plain", "compensated"])
@pytest.mark.parametrize("method", ["rk2", "rk4"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
def test_kernel_matches_plain_version(device, dtype, method, compensated):
    eq, st = _root(dtype, device)
    before = efit_step.efit_window_launches
    row = chip_smoke.check_window(eq, st, method, 5, compensated)
    assert efit_step.efit_window_launches == before + 2
    assert row["fail"] == [], row


def test_solver_launches_once_per_window(device):
    eq, st = _root(torch.float32, device)
    sol = chip_smoke.production_solver(eq)
    efit_step.efit_window_launches = 0
    out = sol.run(st, 3)
    torch.cuda.synchronize()
    windows = chip_smoke.SUB_STEPS // chip_smoke.FREEZE_EVERY
    assert efit_step.efit_window_launches == 3 * windows
    assert bool(chip_smoke.in_domain(out, eq).all())


def test_wrapper_raises_on_tables_off_the_card(device):
    eq_cpu = chip_smoke.synthetic_equilibrium(torch.float32, "cpu")
    _, st = _root(torch.float32, device, n=16)
    with pytest.raises(ValueError, match="psi_coeffs"):
        efit_step.efit_window(eq_cpu, st, method="rk2", dt=1e-4, steps=2,
                              compensated=False)


@pytest.mark.parametrize("method", ["rk2", "rk4"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
def test_backward_kernels_match_plain_version(device, dtype, method):
    eq, st = _root(dtype, device)
    chip_smoke.reset_launch_counts()
    row = chip_smoke.check_window_bwd(eq, st, method, 5, seed=1)
    # two windows of one recorded step, each through K2 and through K3
    assert chip_smoke.launch_counts() == (0, 2, 2)
    assert row["fail"] == [], row


def test_solver_gradient_launches_k1_and_k2(device):
    eq, st = _root(torch.float32, device)
    sol = chip_smoke.production_solver(eq, compensated=False)
    leaves = [leaf.detach().clone().requires_grad_(True) for leaf in st]
    chip_smoke.reset_launch_counts()
    loss = chip_smoke.endpoint_loss(sol.run(RayState(*leaves), 3))
    grads = torch.autograd.grad(loss, leaves)
    windows = 3 * (chip_smoke.SUB_STEPS // chip_smoke.FREEZE_EVERY)
    assert chip_smoke.launch_counts() == (windows, windows, 0)
    assert all(bool(torch.isfinite(g).all()) for g in grads)

    psi = eq.psi_coeffs.clone().requires_grad_(True)
    eqt = dataclasses.replace(eq, psi_coeffs=psi)
    chip_smoke.reset_launch_counts()
    loss = chip_smoke.endpoint_loss(
        chip_smoke.production_solver(eqt, compensated=False).run(st, 3))
    (g,) = torch.autograd.grad(loss, [psi])
    assert chip_smoke.launch_counts() == (windows, 0, windows)
    assert bool(torch.isfinite(g).all()) and float(g.abs().max()) > 0


def test_compensated_window_refuses_gradients(device):
    eq, st = _root(torch.float32, device, n=16)
    leaves = [leaf.detach().clone().requires_grad_(True) for leaf in st]
    chip_smoke.reset_launch_counts()
    with pytest.raises(ValueError, match="forward-only"):
        efit_step.efit_window(eq, init_comp_carry(RayState(*leaves)),
                              method="rk2", dt=1e-4, steps=2,
                              compensated=True)
    assert chip_smoke.launch_counts() == (0, 0, 0)
