"""The port's Newton init and Solver against the JAX package's.

The same float64 launch (256 rays, chip_smoke's launch) goes through both
packages' init_k and Solver.run for 3 recorded steps x 10 substeps.
Tolerances, relative to each leaf group's scale (t, w, position, wave
vector): Newton roots 1e-9 - both loops make the same decisions in the
same order, and the root's last iterate carries the ~1e-14 rounding
difference of the two D evaluations divided by D_k; whole traces 1e-10 -
the right-hand sides agree to ~1e-14 per evaluation (test_torch_rays)
and 30 substeps do not amplify that past 1e-12.
"""

import dataclasses

import numpy as np
import pytest
import torch

from graph_framework_tpu.models.dispersion import cold_plasma as jax_cold
from graph_framework_tpu.solver import (
    Solver as JaxSolver, init_k as jax_init_k)
from graph_framework_tpu_torch.convert import ray_state_from_numpy
from graph_framework_tpu_torch.models.dispersion import cold_plasma
from graph_framework_tpu_torch.ops.compensated import comp_state_f64
from graph_framework_tpu_torch.solver import Solver, init_k, make_ray_state
from test_torch_common import (
    SOURCES, both_states, launch_arrays, leaf_errors, load_both)

RUNS = {
    "rk4": dict(method="rk4"),
    "frozen_rk2_K5": dict(method="rk2", frozen_cells=True, freeze_every=5),
    "compensated_frozen_rk2_K10": dict(method="rk2", frozen_cells=True,
                                       freeze_every=10, compensated=True),
}


@pytest.fixture(scope="module", params=SOURCES)
def setup(request, tmp_path_factory):
    """(JAX eq, port eq, JAX root state, port root state)."""
    jeq, peq = load_both(request.param, tmp_path_factory)
    jstate, pstate = both_states(launch_arrays())
    return (jeq, peq, jax_init_k(jstate, jax_cold, jeq, "kx"),
            init_k(pstate, cold_plasma, peq, "kx"))


def test_init_k_roots(setup):
    jeq, peq, jroot, proot = setup
    want = np.asarray(jroot.kx)
    got = proot.kx.numpy()
    assert np.max(np.abs(got - want) / np.abs(want)) < 1e-9
    # the other components are untouched
    jroot_port = ray_state_from_numpy(jroot, device="cpu")
    assert all(torch.equal(getattr(proot, f), getattr(jroot_port, f))
               for f in ("t", "w", "x", "y", "z", "ky", "kz"))


def test_init_k_diagnostics_and_dtype_tolerance(setup):
    _, peq, _, _ = setup
    _, pstate = both_states(launch_arrays(n=16))
    state, diag = init_k(pstate, cold_plasma, peq, return_diagnostics=True)
    assert diag.converged and diag.iterations > 0
    assert float(diag.residual) <= 1e-30
    # f32: the default tolerance is 1e-10, which f32 resolves
    st32 = make_ray_state(w=pstate.w, x=pstate.x, ky=pstate.ky,
                          kx=pstate.kx, dtype=torch.float32, device="cpu")
    eq32 = dataclasses.replace(peq, **{
        f.name: getattr(peq, f.name).to(torch.float32)
        for f in dataclasses.fields(peq)
        if isinstance(getattr(peq, f.name), torch.Tensor)})
    _, diag32 = init_k(st32, cold_plasma, eq32, return_diagnostics=True)
    assert diag32.converged and float(diag32.residual) <= 1e-10


@pytest.mark.parametrize("run", sorted(RUNS))
def test_solver_run_matches_jax(setup, run):
    jeq, peq, jroot, proot = setup
    kw = dict(dt=1e-4, sub_steps=10, **RUNS[run])
    want = JaxSolver(jax_cold, jeq, **kw).run(jroot, 3)
    got = Solver(cold_plasma, peq, **kw).run(proot, 3)
    errs = leaf_errors(got, want)
    assert max(errs.values()) < 1e-10, errs


def test_trace_and_segmented_rows(setup):
    """trace's rows are run's states; trace_segmented hands the same rows
    to the writer, on the host, in order, across segment boundaries."""
    _, peq, _, proot = setup
    sol = Solver(cold_plasma, peq, method="rk2", dt=1e-4, sub_steps=10,
                 frozen_cells=True, freeze_every=5, compensated=True)
    final, traj = sol.trace(proot, 5)
    assert traj.x.shape == (6, proot.x.shape[0])
    assert torch.equal(traj.x[0], proot.x)
    assert torch.equal(traj.kx[-1], final.kx)
    assert torch.equal(sol.run(proot, 5).x, final.x)
    rows = []
    out = sol.trace_segmented(proot, 5, lambda i, row: rows.append((i, row)),
                              segment=2)
    assert [i for i, _ in rows] == list(range(6))
    for i, row in rows:
        for f in row._fields:
            assert torch.equal(getattr(row, f), getattr(traj, f)[i]), (i, f)
    assert torch.equal(out.x, final.x)


def test_trace_streaming_and_extras_rows(setup):
    """trace_streaming hands trace's rows one at a time, row 0 the launch;
    trace_segmented's ``extras`` come with every row (row 0 too) as
    (RayState, dict) and equal the function of that row."""
    _, peq, _, proot = setup
    sol = Solver(cold_plasma, peq, method="rk4", dt=1e-4, sub_steps=2)
    _, traj = sol.trace(proot, 3)
    rows = []
    sol.trace_streaming(proot, 3, lambda i, row: rows.append((i, row)))
    assert [i for i, _ in rows] == list(range(4))
    for i, row in rows:
        assert torch.equal(row.kx, traj.kx[i]), i
    rows = []
    sol.trace_segmented(proot, 3, lambda i, row: rows.append((i, row)),
                        segment=2, extras=lambda s: {"kx2": s.kx * s.kx})
    assert [i for i, _ in rows] == list(range(4))
    for i, (row, ex) in rows:
        assert torch.equal(row.kx, traj.kx[i]), i
        assert torch.equal(ex["kx2"], traj.kx[i] * traj.kx[i]), i


def test_compensated_carry_is_double_word(setup):
    _, peq, _, proot = setup
    sol = Solver(cold_plasma, peq, method="rk2", dt=1e-4, sub_steps=10,
                 frozen_cells=True, freeze_every=10, compensated=True)
    final, carry = sol.run(proot, 2, return_carry=True)
    assert torch.equal(final.x, carry.hi.x)
    # TwoSum keeps |lo| <= ulp(hi) / 2 on every leaf
    for hi, lo in zip(carry.hi, carry.lo):
        ulp = torch.nextafter(hi.abs(), torch.tensor(float("inf"),
                                                     dtype=hi.dtype))
        assert bool((lo.abs() <= 0.5 * (ulp - hi.abs())).all())
    assert torch.equal(comp_state_f64(carry).x, carry.hi.x + carry.lo.x)


def test_solver_validation(setup):
    _, peq, _, proot = setup
    # the JAX package's refusals (solver.py:182-218)
    with pytest.raises(ValueError, match="unknown method"):
        Solver(cold_plasma, peq, method="euler")
    with pytest.raises(ValueError, match="fixed-dt methods only"):
        Solver(cold_plasma, peq, method="adaptive_rk4", compensated=True)
    with pytest.raises(ValueError, match="increment-form"):
        Solver(cold_plasma, peq, method="split_simplextic",
               compensated=True)
    for method in ("split_simplextic", "adaptive_rk4"):
        with pytest.raises(ValueError, match="frozen_cells supports"):
            Solver(cold_plasma, peq, method=method, frozen_cells=True)
    with pytest.raises(ValueError, match="Hamiltonian is not separable"):
        Solver(cold_plasma, peq, method="split_simplextic").run(proot, 1)
    with pytest.raises(ValueError, match="frozen_cells"):
        Solver(cold_plasma, peq, method="rk2", freeze_every=5, sub_steps=10)
    with pytest.raises(ValueError, match="divide"):
        Solver(cold_plasma, peq, method="rk2", frozen_cells=True,
               freeze_every=3, sub_steps=10)
    with pytest.raises(ValueError, match="frozen_cells"):
        Solver(cold_plasma, peq, method="rk2", window_kernel=True)
    with pytest.raises(ValueError, match="implements the real dispersions"):
        Solver(lambda *a: a[0], peq, method="rk2", frozen_cells=True,
               window_kernel=True)
    with pytest.raises(ValueError, match="freeze_cells"):
        Solver(cold_plasma, object(), method="rk2", frozen_cells=True)
    with pytest.raises(ValueError, match="sub_steps"):
        Solver(cold_plasma, peq, sub_steps=0)


def test_make_ray_state_broadcasts():
    st = make_ray_state(4, w=500.0, x=torch.arange(4.0), kx=-1.0,
                        device="cpu")
    assert all(leaf.shape == (4,) and leaf.dtype == torch.float64
               for leaf in st)
    assert torch.equal(st.x, torch.arange(4.0, dtype=torch.float64))
    st2 = make_ray_state(w=500.0, x=[0.0, 1.0, 2.0], device="cpu")
    assert st2.w.shape == (3,)
