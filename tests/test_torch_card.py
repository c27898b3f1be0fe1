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
the wrong backwards: v_w dropped, the other order's transpose).  The slab
push K5 and the deposit K6 are held to their plain versions within
``chip_smoke.K5_TOL`` and ``chip_smoke.K6_TOL`` (rounding: FMA contraction
and another order of the sums), at ragged counts; the VMEC geometry jet K4
and the mode sums K7 within ``chip_smoke.K4_TOL`` and ``chip_smoke.K7_TOL``
(the order of the sums over the modes, FMA contraction).  The xrays CLI's
phase function takes the production stack and launches K1 on the card;
the complex special functions, the weak damping and the root finder on
the card agree with the CPU's (the last two at a damped launch).  The
spline tables' gradient scatter is held to its plain version on the CPU
within ``chip_smoke.TABLE_SCATTER_EPS`` of each cell's scale, and exactly on
integer-valued rows.
"""

import dataclasses


import pytest
import torch

import chip_smoke
from graph_framework_tpu_torch.kernels import (
    boris, efit_step, vmec_geom, vmec_modes)
from graph_framework_tpu_torch.kernels import deposit as k6
from graph_framework_tpu_torch.kernels import table_scatter
from graph_framework_tpu_torch.models.dispersion import (
    cold_plasma, extra_ordinary_wave, ordinary_wave)
from graph_framework_tpu_torch.models.pic import run_pic
from graph_framework_tpu_torch.models.rays import RayState
from graph_framework_tpu_torch.ops.compensated import init_comp_carry
from graph_framework_tpu_torch.solver import Solver, init_k

pytestmark = pytest.mark.gpu

RAGGED = 1029     # 8 full blocks of 128 threads and a ragged ninth


@pytest.fixture(scope="module")
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _root(dtype, device, n=RAGGED, dispersion=cold_plasma):
    eq = chip_smoke.synthetic_equilibrium(dtype, device)
    return eq, init_k(chip_smoke.launch(n, dtype, device), dispersion, eq)


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


MODES = [ordinary_wave, extra_ordinary_wave]


@pytest.mark.parametrize("dispersion", MODES, ids=lambda d: d.__name__)
@pytest.mark.parametrize("compensated", [False, True],
                         ids=["plain", "compensated"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
def test_mode_kernels_match_plain_version(device, dtype, compensated,
                                          dispersion):
    """K1 of the O and X modes (rk2 and rk4), and their K2/K3 (plain),
    against the plain versions, with the separations of chip_smoke's
    phase 3b (the other mode's window among the wrong kernels)."""
    eq, st = _root(dtype, device, dispersion=dispersion)
    for method in ("rk2", "rk4"):
        row = chip_smoke.check_window(eq, st, method, 5, compensated,
                                      dispersion)
        assert row["fail"] == [], row
        if not compensated:
            chip_smoke.reset_launch_counts()
            row = chip_smoke.check_window_bwd(eq, st, method, 5, 1,
                                              dispersion)
            assert chip_smoke.launch_counts() == (0, 2, 2)
            assert row["fail"] == [], row


@pytest.mark.parametrize("tag", list(chip_smoke.TAILS))
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
def test_tail_kernels_match_plain_version(device, dtype, tag):
    """K1 (all four variants) and K2/K3 (K2 alone where the tail reads no
    table) of the other eight tails against the plain versions from each
    tail's launch, with the separations of chip_smoke's phase 3c."""
    eq = chip_smoke.synthetic_equilibrium(dtype, device)
    st, dt = chip_smoke.tail_launch(tag, 300, eq)
    disp = chip_smoke.TAILS[tag]
    for method in ("rk2", "rk4"):
        for compensated in (False, True):
            row = chip_smoke.check_window(eq, st, method, 5, compensated,
                                          disp, dt)
            assert row["fail"] == [], row
        chip_smoke.reset_launch_counts()
        row = chip_smoke.check_window_bwd(eq, st, method, 5, 1, disp, dt)
        # no K3 where the tail reads no table
        assert chip_smoke.launch_counts() == (
            0, 2, 2 if chip_smoke.reads_map(disp) else 0)
        assert row["fail"] == [], row


@pytest.mark.parametrize("dispersion", MODES, ids=lambda d: d.__name__)
def test_solver_runs_the_modes_through_the_kernels(device, dispersion):
    """Solver(window_kernel=True) with an O- or X-mode dispersion: K1
    forward, K2 under autograd, no plain fallback."""
    eq, st = _root(torch.float32, device, dispersion=dispersion)
    sol = chip_smoke.production_solver(eq, compensated=False,
                                       dispersion=dispersion)
    leaves = [leaf.detach().clone().requires_grad_(True) for leaf in st]
    chip_smoke.reset_launch_counts()
    loss = chip_smoke.endpoint_loss(sol.run(RayState(*leaves), 3))
    grads = torch.autograd.grad(loss, leaves)
    windows = 3 * (chip_smoke.SUB_STEPS // chip_smoke.FREEZE_EVERY)
    assert chip_smoke.launch_counts() == (windows, windows, 0)
    assert all(bool(torch.isfinite(g).all()) for g in grads)


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


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
def test_slab_push_matches_plain_version(device, dtype):
    leaves = chip_smoke.particle_ensemble(RAGGED, dtype, device, seed=7)
    push = boris.make_slab_push(**chip_smoke.SLAB, steps=25)
    boris.slab_push_launches = 0
    got = push(*leaves)
    assert boris.slab_push_launches == 1
    want = boris.slab_push_plain(*leaves, **chip_smoke.SLAB, steps=25)
    assert boris.slab_push_launches == 1
    devs = chip_smoke.relative_deviations(got, want)
    assert max(devs) <= chip_smoke.K5_TOL[dtype], devs
    assert all(g.dtype == dtype and g.device == leaves[0].device
               for g in got)


def test_slab_push_refuses(device):
    leaves = chip_smoke.particle_ensemble(16, torch.float32, device, seed=8)
    push = boris.make_slab_push(**chip_smoke.SLAB, steps=2)
    boris.slab_push_launches = 0
    with pytest.raises(ValueError, match="six contiguous"):
        push(*leaves[:5], leaves[5].cpu())
    with pytest.raises(ValueError, match="no backward"):
        push(*leaves[:5], leaves[5].clone().requires_grad_(True))
    assert boris.slab_push_launches == 0


@pytest.mark.parametrize("num_grid", [64, 1001])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
def test_deposit_matches_plain_version(device, dtype, num_grid):
    x, mask, grid = chip_smoke.deposit_inputs(10_007, num_grid, dtype,
                                              device, seed=9)
    assert bool((mask == 0).any())
    k6.deposit_launches = 0
    got = k6.deposit(x, mask, grid)
    again = k6.deposit(x, mask, grid)
    assert k6.deposit_launches == 2
    want = k6.deposit_plain(x, mask, grid)
    devs = chip_smoke.relative_deviations(got, want)
    assert max(devs) <= chip_smoke.K6_TOL[dtype], devs
    assert all(torch.equal(a, b) for a, b in zip(got, again))


def test_deposit_refuses(device):
    x, mask, grid = chip_smoke.deposit_inputs(100, 8, torch.float32, device,
                                              seed=10)
    k6.deposit_launches = 0
    with pytest.raises(ValueError, match="one dtype and device"):
        k6.deposit(x, mask.cpu(), grid)
    with pytest.raises(ValueError, match="no backward"):
        k6.deposit(x.clone().requires_grad_(True), mask, grid)
    assert k6.deposit_launches == 0


def test_run_pic_launches_once_a_step(device):
    k6.deposit_launches = 0
    st = run_pic(4099, 101, 3, dt=1e-9, device=device)
    assert k6.deposit_launches == 3
    assert all(bool(torch.isfinite(a).all()) for a in st)
    assert float(st.n.max()) > 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
def test_vmec_geom_matches_plain_version(device, dtype):
    _, tables, coords = chip_smoke.k4_inputs(RAGGED, dtype, device, seed=11)
    vmec_geom.vmec_geom_launches = 0
    got = vmec_geom.geometry_jet(*coords, tables)
    assert vmec_geom.vmec_geom_launches == 1
    want = vmec_geom.reference_jet(*coords, tables)
    devs = chip_smoke.relative_rows(got, want)
    assert max(devs) <= chip_smoke.K4_TOL[dtype], devs


def test_vmec_fused_trace_launches_k4(device):
    eq = chip_smoke.synthetic_vmec(torch.float32, device,
                                   fused_mode_sums=True)
    st = init_k(chip_smoke.vmec_launch(RAGGED, torch.float32, device),
                cold_plasma, eq)
    vmec_geom.vmec_geom_launches = 0
    out = Solver(cold_plasma, eq, method="rk2", dt=chip_smoke.VMEC_DT,
                 sub_steps=chip_smoke.VMEC_SUB_STEPS).run(st, 2)
    assert vmec_geom.vmec_geom_launches == 2 * 2 * chip_smoke.VMEC_SUB_STEPS
    assert bool(chip_smoke.in_flux_domain(out).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
def test_vmec_modes_matches_plain_version(device, dtype):
    u, v, blocks, xm, xn = chip_smoke.k7_inputs(RAGGED, dtype, device,
                                                seed=12)
    vmec_modes.vmec_modes_launches = 0
    got = torch.stack(vmec_modes.mode_sums(u, v, *blocks, xm, xn))
    assert vmec_modes.vmec_modes_launches == 1
    want = torch.stack(vmec_modes.reference_forward(u, v, *blocks, xm, xn))
    devs = chip_smoke.relative_rows(got, want)
    assert max(devs) <= chip_smoke.K7_TOL[dtype], devs


def test_xrays_cli_takes_the_production_stack_on_the_card(device):
    """The CLI's phase function over the synthetic map at 1029 rays x 3
    rows: the production stack, K1 once a window plus the warm-up step,
    finite kamp and power in the in-memory store."""
    from graph_framework_tpu_torch.cli import xrays
    args = xrays.resolve_stack(chip_smoke.xrays_args(
        RAGGED, "--num_times=30", "--endtime=0.003",
        "--absorption_model=weak_damping", f"--device={device}"), device)
    assert (args.solver, args.window_kernel, args.x64) == ("rk2", True,
                                                           False)
    files = chip_smoke.MemoryFiles()
    efit_step.efit_window_launches = 0
    xrays.run_xrays(args, chip_smoke.synthetic_equilibrium(
        torch.float32, device), files.open)
    store = files[args.output]
    assert efit_step.efit_window_launches == 3 + 1
    assert store.num_steps == 4
    for name in ("x", "kamp", "power"):
        assert torch.isfinite(torch.from_numpy(store.stack(name))).all()


def test_xrays_cli_traces_the_expansion_on_the_card(device):
    """cold_plasma_expansion (ECRH) through the CLI's phase function, no
    stack options: the production stack and its K1, 1029 rays x 3 rows."""
    from graph_framework_tpu_torch.cli import xrays
    args = xrays.resolve_stack(chip_smoke.xrays_args(
        RAGGED, "--num_times=30", "--endtime=0.003",
        "--dispersion=cold_plasma_expansion", f"--device={device}"), device)
    assert (args.solver, args.window_kernel, args.x64) == ("rk2", True,
                                                           False)
    files = chip_smoke.MemoryFiles()
    efit_step.efit_window_launches = 0
    xrays.run_xrays(args, chip_smoke.synthetic_equilibrium(
        torch.float32, device), files.open)
    store = files[args.output]
    assert efit_step.efit_window_launches == 3 + 1
    assert torch.isfinite(torch.from_numpy(store.stack("kx"))).all()


@pytest.mark.parametrize("name", ["wofz", "erf_complex", "z_plasma"])
def test_special_functions_on_the_card_match_the_cpu(device, name):
    """complex128 on the card against the same function on the CPU, over
    chip_smoke's points on every branch, within 1e-13 of max(|w|, 1)."""
    import numpy as np
    from graph_framework_tpu_torch.ops import special
    z = torch.from_numpy(chip_smoke.special_points(20_000))
    fn = getattr(special, name)
    got, want = fn(z.to(device)).cpu(), fn(z)
    ok = torch.isfinite(want)
    assert torch.equal(torch.isfinite(got), ok)
    dev = (got - want)[ok].abs() / want[ok].abs().clamp(min=1.0)
    assert float(dev.max()) <= 1e-13
    assert np.isfinite(float(dev.max()))


def _damped_state(n=RAGGED):
    """chip_smoke's damped launch (near the synthetic map's resonance)
    in complex128 on the CPU, kx on the cold-plasma surface."""
    cpu_eq = chip_smoke.synthetic_equilibrium(torch.float32, "cpu")
    return cpu_eq, init_k(chip_smoke.launch(
        n, torch.complex128, "cpu", **chip_smoke.DAMPED), cold_plasma,
        cpu_eq)


@pytest.mark.parametrize("imag", [0.0, 20.0])
def test_weak_damping_on_the_card_matches_the_cpu(device, imag):
    """make_weak_damping in complex128 on the card against the CPU at
    chip_smoke's damped launch (f32 tables on both), ray by ray; with
    ``imag``, i imag /m added to kx (a complex gradient of Dc)."""
    from graph_framework_tpu_torch.models.absorption import (
        make_weak_damping)
    cpu_eq, state = _damped_state()
    state = state._replace(kx=state.kx + 1j * imag)
    eq = chip_smoke.synthetic_equilibrium(torch.float32, device)
    want = make_weak_damping(cpu_eq)(state)
    got = make_weak_damping(eq)(RayState(*[l.to(device) for l in state]))
    assert float(want.imag.abs().max()) > 0.1
    dev, _ = chip_smoke.per_ray_deviation(got.cpu().numpy(), want.numpy())
    assert dev <= chip_smoke.KAMP_RTOL


def test_root_finder_on_the_card_matches_the_cpu(device):
    """make_root_finder (tolerance 1e-24) on the card against the CPU at
    chip_smoke's damped launch, ray by ray; both converge."""
    from graph_framework_tpu_torch.models.absorption import make_root_finder
    cpu_eq, state = _damped_state()
    eq = chip_smoke.synthetic_equilibrium(torch.float32, device)
    want, diag_cpu = make_root_finder(cpu_eq, tolerance=1e-24,
                                      return_diagnostics=True)(state)
    got, diag = make_root_finder(eq, tolerance=1e-24,
                                 return_diagnostics=True)(
        RayState(*[l.to(device) for l in state]))
    assert diag.converged and diag_cpu.converged
    assert float(want.imag.abs().max()) > 0.01
    dev, _ = chip_smoke.per_ray_deviation(got.cpu().numpy(), want.numpy())
    assert dev <= chip_smoke.KAMP_RTOL


@pytest.fixture(scope="module")
def config5_scatters(device):
    """The table scatters of one config-5 batch of 125k rays (its kernel
    form over 2 recorded steps: the weak damping's psi gathers)."""
    return chip_smoke.config5_scatter_calls(device, steps=2)


@pytest.mark.parametrize("case", ["config5", "uniform", "ragged"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
def test_table_scatter_matches_plain_version(config5_scatters, dtype, case):
    """The table scatter kernel against the plain version on the CPU, per
    cell within ``chip_smoke.TABLE_SCATTER_EPS`` of its rows' magnitudes
    and exactly on integer-valued rows: at config 5's real calls, at
    uniform cells over the whole table and at ragged row counts; a launch
    each."""
    assert len(config5_scatters) == 4
    grad, idx, cells = config5_scatters[-1]
    if case == "config5":
        parts = [(g, i) for g, i, _ in config5_scatters]
    elif case == "uniform":
        gen = torch.Generator(device=idx.device).manual_seed(3)
        parts = [(grad, torch.randint(0, cells, idx.shape, generator=gen,
                                      device=idx.device))]
    else:
        parts = [(grad[:n], idx[:n]) for n in (1, 31, 4099)]
    for g, i in parts:
        before = table_scatter.table_scatter_launches
        ratio, exact = chip_smoke.check_table_scatter(g.to(dtype), i, cells)
        assert table_scatter.table_scatter_launches == before + 2
        assert exact and ratio <= chip_smoke.TABLE_SCATTER_EPS, ratio
