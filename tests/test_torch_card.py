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
VMEC ray RHS K8 is held to its plain version within ``chip_smoke.K8_TOL``
on the same jet, and a short trace through K4 and K8 to the eager RHS's
within ``chip_smoke.VMEC_TRACE_TOL``.  The
spline tables' gradient scatter is held to its plain version on the CPU
within ``chip_smoke.TABLE_SCATTER_EPS`` of each cell's scale, and exactly on
integer-valued rows; K3's block cotangents reach the tables through it.
Config 5's weak damping K9 is held to its plain version and to autograd
of it at config 5's launch, 125k rays, within ``chip_smoke.K9_TOL`` (its
f32 table gradient cell by cell to the f64 plain version, ``K9_CELL_TOL``);
rays whose kamp is not finite take exact zero cotangents, and a complex
state never reaches it.
"""

import dataclasses


import pytest
import torch

import chip_smoke
from graph_framework_tpu_torch.kernels import (
    boris, efit_step, vmec_geom, vmec_modes, vmec_rhs)
from graph_framework_tpu_torch.kernels import deposit as k6
from graph_framework_tpu_torch.kernels import table_scatter
from graph_framework_tpu_torch.kernels import weak_damping as k9
from graph_framework_tpu_torch.models import absorption
from graph_framework_tpu_torch.models.dispersion import (
    cold_plasma, extra_ordinary_wave, ordinary_wave)
from graph_framework_tpu_torch.models.pic import run_pic
from graph_framework_tpu_torch.models.rays import RayState, make_ray_rhs
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


def test_k3_table_gradient_goes_through_the_table_scatter(device):
    """A window's table gradient: one K3 launch, whose psi and profile
    block cotangents reach the tables by two table scatter launches, within
    ``chip_smoke.TABLE_SCATTER_EPS`` of the plain scatter of the same
    blocks on the CPU."""
    eq, st = _root(torch.float32, device)
    psi = eq.psi_coeffs.clone().requires_grad_(True)
    prof = eq.profile_coeffs.clone().requires_grad_(True)
    eqt = dataclasses.replace(eq, psi_coeffs=psi, profile_coeffs=prof)
    kw = dict(method="rk2", dt=chip_smoke.DT, steps=chip_smoke.FREEZE_EVERY)
    out = efit_step.efit_window(eqt, st, compensated=False, **kw)
    chip_smoke.reset_launch_counts()
    before = table_scatter.table_scatter_launches
    got = torch.autograd.grad(chip_smoke.endpoint_loss(out), [psi, prof])
    assert chip_smoke.launch_counts() == (0, 0, 1)
    assert table_scatter.table_scatter_launches == before + 2
    n = st.x.shape[0]
    ct = RayState(*[torch.full_like(a, 1.0 / n) if f in ("x", "y", "z",
                                                         "kx")
                    else torch.zeros_like(a)
                    for f, a in zip(RayState._fields, st)])
    vjp = efit_step.efit_window_vjp(eq, st, ct, tables=True, **kw)
    eps = torch.finfo(torch.float32).eps
    for g, blocks, cells in ((got[0], vjp.psi_block, vjp.psi_cell),
                             (got[1], vjp.prof_block, vjp.prof_cell)):
        rows = g.reshape(-1, 16).double().cpu()
        b64, i64 = blocks.double().cpu(), cells.cpu()
        want = table_scatter.table_scatter_plain(b64, i64, rows.shape[0])
        scale = table_scatter.table_scatter_plain(b64.abs(), i64,
                                                  rows.shape[0])
        assert float(scale.max()) > 0
        assert ((rows - want).abs()
                <= chip_smoke.TABLE_SCATTER_EPS * eps * scale).all()


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
    with pytest.raises(ValueError, match="contiguous 1-D"):
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
    """The main path's fused f32 rk2 trace: K4 and K8 (the value RHS) each
    launch twice a substep."""
    eq = chip_smoke.synthetic_vmec(torch.float32, device,
                                   fused_mode_sums=True)
    st = init_k(chip_smoke.vmec_launch(RAGGED, torch.float32, device),
                cold_plasma, eq)
    vmec_geom.vmec_geom_launches = vmec_rhs.vmec_rhs_launches = 0
    out = Solver(cold_plasma, eq, method="rk2", dt=chip_smoke.VMEC_DT,
                 sub_steps=chip_smoke.VMEC_SUB_STEPS).run(st, 2)
    assert vmec_geom.vmec_geom_launches == 2 * 2 * chip_smoke.VMEC_SUB_STEPS
    assert vmec_rhs.vmec_rhs_launches == 2 * 2 * chip_smoke.VMEC_SUB_STEPS
    assert bool(chip_smoke.in_flux_domain(out).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
def test_vmec_rhs_matches_plain_version(device, dtype):
    """K8 against its plain version (on the CPU) on the same jet."""
    eq = chip_smoke.synthetic_vmec(dtype, device)
    st = chip_smoke.vmec_rhs_state(RAGGED, dtype, device, seed=13)
    leaves = [st.w, st.x, st.y, st.z, st.kx, st.ky, st.kz]
    jet = vmec_geom.geometry_jet(st.x, st.y, st.z, vmec_geom.jet_tables(eq))
    params = vmec_rhs.rhs_params(eq)
    vmec_rhs.vmec_rhs_launches = 0
    got = vmec_rhs.ray_rhs(leaves, jet, params)
    assert vmec_rhs.vmec_rhs_launches == 1
    cpu = vmec_rhs.rhs_params(chip_smoke.synthetic_vmec(dtype, "cpu"))
    want = vmec_rhs.ray_rhs_plain([a.cpu() for a in leaves], jet.cpu(), cpu)
    devs = chip_smoke.relative_deviations([a.cpu() for a in got], want)
    assert max(devs) <= chip_smoke.K8_TOL[dtype], devs


def test_vmec_fused_rhs_launches_k4_and_k8_once(device):
    eq = chip_smoke.synthetic_vmec(torch.float32, device,
                                   fused_mode_sums=True)
    st = chip_smoke.vmec_rhs_state(RAGGED, torch.float32, device, seed=14)
    vmec_geom.vmec_geom_launches = vmec_rhs.vmec_rhs_launches = 0
    with torch.no_grad():
        make_ray_rhs(cold_plasma, eq)(st)
    assert vmec_geom.vmec_geom_launches == 1
    assert vmec_rhs.vmec_rhs_launches == 1


def test_vmec_fused_trace_matches_eager_rhs(device):
    """A short fused f32 trace (K4 and K8) against the eager RHS's over the
    same tables unfused: tests/test_torch_vmec_geom.py's
    test_fused_trace_matches_default on the card."""
    eq = chip_smoke.synthetic_vmec(torch.float32, device)
    eqf = dataclasses.replace(eq, fused_mode_sums=True)
    st = init_k(chip_smoke.vmec_launch(RAGGED, torch.float32, device),
                cold_plasma, eqf)
    vmec_rhs.vmec_rhs_launches = 0
    f0 = Solver(cold_plasma, eq, method="rk4", dt=2e-7, sub_steps=5).run(st, 3)
    assert vmec_rhs.vmec_rhs_launches == 0
    f1 = Solver(cold_plasma, eqf, method="rk4", dt=2e-7,
                sub_steps=5).run(st, 3)
    assert vmec_rhs.vmec_rhs_launches == 4 * 5 * 3
    for a, b, name in zip(f0, f1, f0._fields):
        scale = max(1.0, float(a.abs().max()))
        assert float((a - b).abs().max()) <= (
            chip_smoke.VMEC_TRACE_TOL * scale), name


def test_vmec_fused_geometry_backward_trace_matches_eager_rhs(device):
    """test_vmec_fused_trace_matches_eager_rhs with ``quirky_chi``, which
    keeps the fused trace on the eager RHS: autograd through K4's
    FusedGeometry and its backward, no K8."""
    eq = dataclasses.replace(chip_smoke.synthetic_vmec(torch.float32, device),
                             quirky_chi=True)
    eqf = dataclasses.replace(eq, fused_mode_sums=True)
    st = init_k(chip_smoke.vmec_launch(RAGGED, torch.float32, device),
                cold_plasma, eqf)
    vmec_geom.vmec_geom_launches = vmec_rhs.vmec_rhs_launches = 0
    f0 = Solver(cold_plasma, eq, method="rk4", dt=2e-7, sub_steps=5).run(st, 3)
    f1 = Solver(cold_plasma, eqf, method="rk4", dt=2e-7,
                sub_steps=5).run(st, 3)
    assert vmec_geom.vmec_geom_launches == 4 * 5 * 3
    assert vmec_rhs.vmec_rhs_launches == 0
    for a, b, name in zip(f0, f1, f0._fields):
        scale = max(1.0, float(a.abs().max()))
        assert float((a - b).abs().max()) <= (
            chip_smoke.VMEC_TRACE_TOL * scale), name


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
    """The weak damping's table scatters of one config-5 batch of 125k rays
    (its kernel form over 2 recorded steps: K9's psi rows, one a step)."""
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
    assert len(config5_scatters) == 2
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


@pytest.fixture(scope="module")
def config5_states(device):
    """Config 5's launch of 125k rays after three recorded steps, f32 and
    f64, on the card: the states K9 sees."""
    return {dtype: chip_smoke.config5_state(125_000, dtype, device)
            for dtype in (torch.float32, torch.float64)}


def _k9_cotangent(state):
    gen = torch.Generator(device=state.x.device).manual_seed(5)
    re, im = (torch.randn(state.x.shape, generator=gen, device=state.x.device,
                          dtype=state.x.dtype) for _ in range(2))
    return torch.complex(re, im)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
def test_weak_damping_kernel_matches_plain_version(config5_states, dtype):
    """K9's forward against the plain version at config 5's launch, 125k
    rays: kamp's parts within ``chip_smoke.K9_TOL`` of their largest."""
    eq, st = config5_states[dtype]
    chip_smoke.reset_launch_counts()
    with torch.no_grad():
        got = absorption.make_weak_damping_real(eq)(st)
        want = absorption.make_weak_damping_real_plain(eq)(st)
    assert chip_smoke.weak_damping_launch_counts() == (1, 0)
    assert torch.isfinite(want).all() and float(want.imag.abs().min()) > 0
    devs = chip_smoke.relative_deviations([got.real, got.imag],
                                          [want.real, want.imag])
    assert max(devs) <= chip_smoke.K9_TOL[dtype], devs


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
def test_weak_damping_vjp_matches_autograd_of_plain_version(config5_states,
                                                            dtype):
    """K9's VJP against autograd of the plain version, 125k rays, a seeded
    complex cotangent: each leaf's cotangent within K9_TOL of its largest;
    dL/dpsi_coeffs within K9_TOL in f64, and in f32, cell by cell, within
    K9_CELL_TOL of the sum of its rows' magnitudes from the f64 plain
    version.  One forward and one VJP launch; one table scatter."""
    eq, st = config5_states[dtype]
    ct = _k9_cotangent(st)
    chip_smoke.reset_launch_counts()
    before = table_scatter.table_scatter_launches
    _, got, got_psi = chip_smoke.weak_damping_vjp(eq, st, ct)
    assert chip_smoke.weak_damping_launch_counts() == (1, 1)
    assert table_scatter.table_scatter_launches == before + 1
    _, want, want_psi = chip_smoke.weak_damping_vjp(eq, st, ct, plain=True)
    devs = chip_smoke.relative_deviations(got, want)
    assert max(devs) <= chip_smoke.K9_TOL[dtype], dict(zip(k9.LEAVES, devs))
    if dtype == torch.float64:
        (dev,) = chip_smoke.relative_deviations([got_psi], [want_psi])
        assert dev <= chip_smoke.K9_TOL[dtype], dev
        return
    eq64, _ = config5_states[torch.float64]
    _, _, ref = chip_smoke.weak_damping_vjp(
        eq64, RayState(*[a.double() for a in st]), ct.to(torch.complex128),
        plain=True)
    psi, prof, params = chip_smoke.k9_tables(eq)
    _, rows, cells = k9._launch_vjp(
        psi, prof, [getattr(st, f) for f in k9.LEAVES], params, ct, True)
    scale = table_scatter.table_scatter(
        rows.abs().double(), cells, psi.shape[0] * psi.shape[1]
    ).reshape(psi.shape)
    touched = scale > 0
    dev = float(((got_psi.double() - ref).abs()[touched]
                 / scale[touched]).max())
    assert int(touched.sum()) > 0 and dev <= chip_smoke.K9_CELL_TOL, dev


def test_weak_damping_kernel_zero_cotangents_where_kamp_is_not_finite(
        config5_states):
    """Rays whose kamp is not finite (k = 0), scrubbed by nan_to_num as
    config 5's loss scrubs them, give exact zero cotangents, and every
    gradient stays finite."""
    eq, st = config5_states[torch.float32]
    bad = torch.zeros_like(st.x, dtype=torch.bool)
    bad[3::101] = True
    st = st._replace(**{f: torch.where(bad, 0.0, getattr(st, f))
                        for f in ("kx", "ky", "kz")})
    psi = eq.psi_coeffs.detach().clone().requires_grad_(True)
    leaves = [a.detach().clone().requires_grad_(True) for a in st]
    kamp = absorption.make_weak_damping_real(
        dataclasses.replace(eq, psi_coeffs=psi))(RayState(*leaves))
    assert not torch.isfinite(kamp.imag[bad]).any()
    kim = torch.nan_to_num(kamp.imag, nan=0.0, posinf=0.0, neginf=0.0)
    grads = torch.autograd.grad(kim.sum(), leaves[1:] + [psi])
    assert all(bool(torch.isfinite(g).all()) for g in grads)
    assert all(int(torch.count_nonzero(g[bad])) == 0 for g in grads[:-1])
    assert float(grads[-1].abs().max()) > 0


def test_complex_state_never_reaches_the_weak_damping_kernel(
        config5_states):
    """The complex update (run_absorption's) stays eager on the card, and
    the real form refuses a complex state: K9 counts no launch."""
    eq, st = config5_states[torch.float64]
    cs = RayState(*[a.to(torch.complex128) for a in st])
    chip_smoke.reset_launch_counts()
    kamp = absorption.make_weak_damping(eq)(cs)
    assert torch.isfinite(kamp).all()
    with pytest.raises(TypeError, match="real ray state"):
        absorption.make_weak_damping_real(eq)(cs)
    assert not absorption.k9_takes(eq, cs)
    assert chip_smoke.weak_damping_launch_counts() == (0, 0)
