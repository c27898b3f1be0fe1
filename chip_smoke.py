#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one CUDA card.

    python3 chip_smoke.py

The main path is the ``xrays`` ray trace: cold-plasma rays over an EFIT
tokamak equilibrium, in the reference benchmark's configuration (100k
rays, 1000 recorded steps x 10 substeps, endtime 1.0), through the
library entry points ``init_k`` and ``Solver.run`` with the production
stack - frozen-cell rk2, a 10-substep freeze window, compensated f32
accumulation and the hand-written CUDA window kernel (K1).  The second
path is reverse mode through it: gradients of trace endpoints with
respect to the launch state and the spline tables, through the window
kernel's backward kernels K2 and K3 (``torch.autograd.grad`` over
``Solver.run`` with the plain f32 window).  Phases, one line each (any
failed check raises and the script exits non-zero):

1. device: the card's name and, on its own line, ``nvidia-smi``'s
   name and power limit; no CUDA card is a failure, never a CPU run;
2. build: ``nvcc`` builds ``csrc/*.cu`` (one process per source);
   registers and spills of every kernel variant;
3. K1 vs plain PyTorch version at 4099 rays (a ragged count): rk2/rk4
   x plain/compensated x f32/f64, one recorded step at K = 10 and K = 5,
   each within a limit that lies well below what a wrong kernel shows;
   3a. the same for K2 and K3 against autograd of the plain version, with
   random cotangents;
4. main path at full width: 100k rays f32 compensated, then f64 plain,
   then 1M rays for 100 recorded steps; launch counts, validity,
   residuals, the f32/f64 endpoint gap, and ray-steps/s;
   4b'. (phase b) fwd+bwd at full width: the gradient of bench.py's
   endpoint loss with respect to the launch state over 100k rays x 1000
   x 10, twice - the first pass allocates the graph's memory, the
   second finds it cached (K1 and K2 launch counts, finite gradients,
   ray-steps/s, the memory the autograd graph holds) - then table
   gradients over 100k x 100 x 10 through K3;
   4c'. (phase c) the gradient through ``init_k`` and the kernels against
   central differences, f64;
5. ``trace_segmented``: 32 recorded rows of 100k rays kept in memory;
6. the plain version's ray-steps/s on the card beside the kernel's;
7. each kernel's milliseconds per window beside its plain version's.

It then prints the kernel table as one JSON line and, last, the device
line ``{"ok": true, "device": {...}}``.

The equilibrium is built in memory (no file, no ``h5py``): a smooth
up-down symmetric tokamak flux map on a 129 x 129 grid with 129-knot
profiles, chosen so that the cold-plasma wave propagates everywhere the
rays go - see :func:`synthetic_samples`.  Weights-free: everything is
made from ``SEED``.
"""

from __future__ import annotations

import dataclasses
import json
import re
import subprocess
import sys
import time
from unittest import mock

import numpy as np
import torch

from graph_framework_tpu_torch.constants import Q
from graph_framework_tpu_torch.kernels import build, efit_step
from graph_framework_tpu_torch.models.dispersion import cold_plasma
from graph_framework_tpu_torch.models.efit import efit_from_tables
from graph_framework_tpu_torch.models.rays import (
    RayDerivatives, RayState, dispersion_residual, residual_fn)
from graph_framework_tpu_torch.ops.compensated import (
    CompCarry, comp_state_f64, init_comp_carry)
from graph_framework_tpu_torch.solver import Solver, init_k, make_ray_state
from graph_framework_tpu_torch.tools.make_splines import efit_tables

SEED = 0

# -- the synthetic equilibrium -----------------------------------------------
# A tokamak of major radius R0 = 2.0 m, minor radius 0.9 m, elongation 1.5,
# toroidal field B0 = 0.35 T on axis (fpol = R0 B0, B_phi = fpol / R) and a
# poloidal flux psi = PSI0 ((R - R0)^2 / a^2 + Z^2 / (kappa a)^2), so the
# edge poloidal field is about a tenth of the toroidal one (q ~ 2).  Core
# density 2e18 m^-3 and temperature 2 keV, with the same tanh pedestal
# shape for both: the reference's ne <- te table quirk
# (equilibrium.hpp:1478) then leaves ne unchanged.  For the launch
# frequency w = 500 / m (omega = 1.5e11 rad/s), on the grid the plasma
# frequency is at most 266 / m, the electron cyclotron frequency at most
# 411 / m (0.7 T at R = 1 m), the upper hybrid frequency at most 411 / m
# and the R cutoff at most 464 / m (388 / m on axis), so w stays above
# every cutoff and resonance: both cold-plasma branches propagate.
R0, A_MINOR, KAPPA, B0, PSI0 = 2.0, 0.9, 1.5, 0.35, 0.04
NE0, TE0 = 2.0e18, 2.0e3
GRID = 129                   # grid points in R and Z; profile knots
R_RANGE, Z_RANGE = (1.0, 3.0), (-1.0, 1.0)

# -- the launch (the reference benchmark's values, bench.py:171) -------------
W0, X0, KX0, KY0 = 500.0, 2.5, -500.0, 150.0
X_SPREAD, KY_SPREAD = 0.02, 10.0    # normal spreads of x [m] and ky [1/m]
DT, SUB_STEPS, FREEZE_EVERY = 1.0e-4, 10, 10   # endtime 1.0: 1000 x 10 x dt

# -- tolerances of the kernel against its plain version ----------------------
# Per leaf, the largest deviation over the rays divided by the scale of its
# group (t, w, |position|, |wave vector|); for compensated carries it is the
# deviation of the double-word values hi + lo, so a lost low word shows in
# f64 as well.  The two sides differ only in rounding (forward vs reverse
# mode, FMA contraction, operation order).  Keyed by (dtype, compensated),
# each limit sits about 20x above the deviation read on the card over one
# recorded step at 4099 rays (NVIDIA H100 80GB HBM3, 700.00 W):
#   f32 plain   read 9.3e-8: one-ulp flips of x (ulp(2.5) / 2.5 = 9.5e-8);
#   f32 comp    read 4.8e-11: the rounding of the increments themselves;
#   f64 plain   read 1.7e-16: one-ulp flips;
#   f64 comp    read 7.4e-20: the increments' rounding, as in f32.
# Phase 3 also measures, on the plain version, what a wrong kernel would
# show, and asserts that the limit lies SEPARATION times below it: the
# compensated run against the same run with the low words dropped (read
# 4.6e-7 in f32, 5.9e-16 in f64) and, where the rounding leaves room for
# it (CAN_SEE_ORDER), rk2 against rk4 (read 1.9e-12 in f64; under the f32
# rounding).  A wrong order, Euler included, thus fails in f64, and the f32
# variants run the same increment<T, METHOD> template of the kernel.
TOL = {(torch.float32, False): 2.0e-6, (torch.float32, True): 1.0e-9,
       (torch.float64, False): 4.0e-15, (torch.float64, True): 1.5e-18}
SEPARATION = 10.0
CAN_SEE_ORDER = {(torch.float32, False): False,
                 (torch.float32, True): False,
                 (torch.float64, False): True, (torch.float64, True): True}
# Compensated f32 against f64 after 1000 recorded steps (phase 4b), from
# the same f32 Newton root (read 2.5e-8) and from each one's own root
# (read 4.4e-7, mostly the f32 root's error); about 20x above the readings.
# The uncompensated f32 run's gap is measured beside it (read 7.4e-5) and
# must lie SEPARATION times above the same-root limit.
GAP_TOL = {"f32 root": 5.0e-7, "own root": 1.0e-5}

# -- tolerances of the backward kernels against their plain versions ---------
# Per leaf of the state cotangent, and per table of the scattered block
# cotangents: the largest deviation over the rays (table rows) divided by
# the largest magnitude of that leaf (table) in the plain version, over one
# recorded step from seeded normal cotangents at 4099 rays.  The plain
# version is torch.autograd of frozen_window (reverse over reverse); the
# kernels transpose by hand and take the Hessian-vector products by
# forward over forward mode, and the table scatter adds with atomics, so
# the two round differently.  Each limit sits about 20x above what the
# card read (NVIDIA H100 80GB HBM3, 700.00 W):
#   f32 state  read 8.3e-7;   f32 tables read 4.2e-6;
#   f64 state  read 9.3e-16;  f64 tables read 1.2e-14.
# Phase 3a also measures on the plain version what a wrong backward shows
# and asserts that each limit lies SEPARATION times below it: the transpose
# without v_w (D_w's dependence on the state dropped; read 3.8e-3 state,
# 6.7e-3 tables in both dtypes) and, in f64, the other Runge-Kutta order's
# transpose (read 2.6e-9 state, 2.8e-5 tables).
BWD_TOL = {torch.float32: {"state": 2.0e-5, "tables": 1.0e-4},
           torch.float64: {"state": 2.0e-14, "tables": 2.5e-13}}
# Phase c: the directional derivative along the gradient against central
# differences (tests/test_gradients.py's rtol and step sizes).
FD_RTOL = 1.0e-5
FD_STEP = {"launch": 1.0e-3, "psi_coeffs": 1.0e-7}


def synthetic_samples(grid=GRID):
    """Gridded samples of the synthetic equilibrium, the keyword arguments
    of ``tools.make_splines.efit_tables`` / ``write_efit_file``."""
    r = np.linspace(*R_RANGE, grid)
    z = np.linspace(*Z_RANGE, grid)
    psi = PSI0 * ((r[:, None] - R0) ** 2 / A_MINOR ** 2
                  + z[None, :] ** 2 / (KAPPA * A_MINOR) ** 2)
    psi_profile = np.linspace(0.0, 1.02 * psi.max(), grid)
    s = psi_profile / PSI0                       # 1 at the plasma edge
    shape = 0.005 + 0.995 * 0.5 * (1.0 - np.tanh((s - 0.8) / 0.12))
    ne, te = NE0 * shape, TE0 * shape
    return dict(r=r, z=z, psi=psi, psi_profile=psi_profile, ne=ne, te=te,
                pressure=2.0 * Q * ne * te,
                fpol=np.full_like(psi_profile, R0 * B0))


def synthetic_equilibrium(dtype, device, grid=GRID):
    return efit_from_tables(efit_tables(**synthetic_samples(grid)),
                            dtype=dtype, device=device)


def launch(n, dtype, device, seed=SEED):
    """n rays (as cli/xrays.py:230-259 builds them): w fixed, x and ky
    normal around the launch, the rest fixed, kx solved by init_k."""
    rng = np.random.default_rng(seed)
    x = X0 + X_SPREAD * rng.standard_normal(n)
    ky = KY0 + KY_SPREAD * rng.standard_normal(n)
    return make_ray_state(n, w=W0, x=torch.from_numpy(x), kx=KX0,
                          ky=torch.from_numpy(ky), dtype=dtype,
                          device=device)


def production_solver(eq, *, compensated=True, window_kernel=True):
    return Solver(cold_plasma, eq, method="rk2", dt=DT,
                  sub_steps=SUB_STEPS, frozen_cells=True,
                  freeze_every=FREEZE_EVERY, compensated=compensated,
                  window_kernel=window_kernel)


def leaf_deviations(a, b):
    """Per-leaf max |a - b| over the rays, in f64.  For CompCarry arguments
    it is the deviation of the double-word values, (hi_a - hi_b) + (lo_a -
    lo_b): exact for nearby hi words, so a lost low word shows in f64 too."""
    if isinstance(a, CompCarry):
        diffs = [(ha.double() - hb.double()) + (la.double() - lb.double())
                 for ha, hb, la, lb in zip(a.hi, b.hi, a.lo, b.lo)]
    else:
        diffs = [la.double() - lb.double() for la, lb in zip(a, b)]
    return {f: float(d.abs().max()) for f, d in zip(RayState._fields, diffs)}


def leaf_errors(a, b):
    """:func:`leaf_deviations` relative to the scale of each leaf's group
    in b: t, w, position (x, y, z), wave vector (kx, ky, kz)."""
    ref = b.hi if isinstance(b, CompCarry) else b

    def scale(*leaves):
        return max(float(l.abs().max()) for l in leaves) or 1.0

    groups = {"t": scale(ref.t), "w": scale(ref.w),
              "pos": scale(ref.x, ref.y, ref.z),
              "k": scale(ref.kx, ref.ky, ref.kz)}
    of = dict(t="t", w="w", x="pos", y="pos", z="pos",
              kx="k", ky="k", kz="k")
    return {f: d / groups[of[f]] for f, d in leaf_deviations(a, b).items()}


def in_domain(state, eq):
    """Rays whose state is finite and whose position lies in the table
    (bench.py:304-311)."""
    r = torch.sqrt(state.x * state.x + state.y * state.y)
    nr, nz = eq.psi_coeffs.shape[:2]
    finite = torch.stack([torch.isfinite(l) for l in state]).all(dim=0)
    return (finite & (r >= eq.rmin) & (r <= eq.rmin + eq.dr * nr)
            & (state.z >= eq.zmin) & (state.z <= eq.zmin + eq.dz * nz))


def timed(fn, pick=lambda out: out):
    """(result, seconds): synchronize, run, synchronize and read a scalar
    back (a launch queue that reads as finished is not proof of work)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    float(pick(out).x[0])
    return out, time.perf_counter() - t0


def event_ms(fn, reps):
    """Mean device milliseconds of fn over reps calls, after one warm-up."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / reps


def profile_kernel(fn, kernel="efit_window_kernel"):
    """Run fn once under torch.profiler.  Returns (total device ms of the
    kernels whose name holds ``kernel`` from the CUDA trace - None if the
    trace shows no device time - and the device-timeline ms of the whole
    call from CUDA events)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        start.record()
        fn()
        stop.record()
        torch.cuda.synchronize()
    total_us = sum(getattr(e, "device_time_total", 0.0)
                   for e in prof.key_averages()
                   if kernel in e.key)
    return (total_us / 1000.0 if total_us else None,
            start.elapsed_time(stop))


def phase_device():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda."
                         "is_available() is False); nothing was run")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"[1 device] {name}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}; nvcc {build.find_nvcc()}")
    print(smi)
    return name, smi


def ptxas_summary(log):
    """{variant: 'N registers, ... spill ...'} from nvcc's -Xptxas -v log;
    the variant is read from the mangled name of efit_window_kernel<T,
    METHOD, COMPENSATED> (K1: f32/rk2/plain, ...) or of
    efit_window_bwd_kernel<T, METHOD, TAB> (K2 f32/rk2 without the table
    cotangents, K3 f32/rk2 with them)."""
    out, variant = {}, None
    for line in log.splitlines():
        m = re.search(
            r"efit_window_(bwd_)?kernelI([fd])Li([24])ELb([01])", line)
        if m:
            dtype = "f32" if m[2] == "f" else "f64"
            if m[1]:
                variant = f"{'K3' if m[4] == '1' else 'K2'} {dtype}/rk{m[3]}"
            else:
                variant = (f"{dtype}/rk{m[3]}/"
                           f"{'comp' if m[4] == '1' else 'plain'}")
            out[variant] = []
        elif variant and ("spill" in line or "registers" in line):
            out[variant].append(line.split(":", 1)[-1].strip())
    return {k: "; ".join(v) for k, v in sorted(out.items())}


def phase_build():
    t0 = time.perf_counter()
    build.load()
    seconds = time.perf_counter() - t0
    print(f"[2 build] {seconds:.2f} s ({len(list(build.CSRC.glob('*.cu')))}"
          f" nvcc processes in parallel, then a link); ptxas per kernel "
          f"variant:")
    for variant, info in ptxas_summary(build.build_log).items():
        print(f"    {variant}: {info}")


def run_windows(eq, carry, method, k, compensated, kernel):
    """One recorded step (SUB_STEPS // k freeze windows of k substeps) from
    ``carry``, through the kernel's wrapper or its plain version."""
    for _ in range(SUB_STEPS // k):
        if kernel:
            carry = efit_step.efit_window(eq, carry, method=method, dt=DT,
                                          steps=k, compensated=compensated)
        else:
            carry = efit_step.frozen_window(eq, cold_plasma, carry,
                                            method=method, dt=DT, steps=k,
                                            compensated=compensated)
    return carry


def check_window(eq, st, method, k, compensated):
    """Kernel against plain version over one recorded step from the state
    ``st``.  Returns a row: the worst relative leaf deviation, its limit,
    the deviations the plain version shows for a wrong kernel (the other
    Runge-Kutta order; the low words dropped) and ``fail``, the names of
    the checks that failed."""
    key = (st.x.dtype, compensated)
    start = init_comp_carry(st) if compensated else st
    plain = run_windows(eq, start, method, k, compensated, kernel=False)

    def worst(state):
        return max(leaf_errors(state, plain).values())

    row = {"dev": worst(run_windows(eq, start, method, k, compensated,
                                    kernel=True)),
           "limit": TOL[key]}
    if CAN_SEE_ORDER[key]:
        other = "rk4" if method == "rk2" else "rk2"
        row["other order"] = worst(run_windows(eq, start, other, k,
                                               compensated, kernel=False))
    if compensated:
        row["low words dropped"] = worst(init_comp_carry(run_windows(
            eq, st, method, k, False, kernel=False)))
    row["fail"] = ([] if row["dev"] <= row["limit"] else ["dev"]) + [
        s for s in ("other order", "low words dropped")
        if s in row and not row[s] >= SEPARATION * row["limit"]]
    return row


def phase_kernel_vs_plain(device, n=4099):
    rows = {}
    for dtype in (torch.float32, torch.float64):
        eq = synthetic_equilibrium(dtype, device)
        st = init_k(launch(n, dtype, device, seed=SEED + 1), cold_plasma,
                    eq)
        for method in ("rk2", "rk4"):
            for comp in (False, True):
                for k in (10, 5):
                    rows[f"{str(dtype)[6:]}/{method}/"
                         f"{'comp' if comp else 'plain'}/K={k}"] = \
                        check_window(eq, st, method, k, comp)
    print(f"[3 kernel vs plain, {n} rays, 1 recorded step] worst relative "
          f"leaf deviation against its limit, and what a wrong kernel "
          f"would show: {json.dumps(rows)}")
    failed = {key: row for key, row in rows.items() if row["fail"]}
    if failed:
        raise AssertionError(f"kernel vs plain: {failed}")


# -- reverse mode -------------------------------------------------------------


def endpoint_loss(s):
    """bench.py's endpoint functional (run_grad): the mean final position
    and wave-vector sum."""
    return (s.x.sum() + s.y.sum() + s.z.sum() + s.kx.sum()) / s.x.shape[0]


def random_cotangent(like, seed):
    rng = np.random.default_rng(seed)
    return RayState(*[torch.from_numpy(rng.standard_normal(like.x.shape[0]))
                      .to(like.x) for _ in RayState._fields])


def rhs_without_vw(dispersion, feq):
    """A wrong ray RHS for the separation check: the values of
    make_ray_rhs, but 1/D_w is held constant in the transpose, so the
    cotangent loses D_w's dependence on the state (v_w of the kernels)."""
    d_all = dispersion_residual(dispersion, feq)

    def rhs(s):
        args = [leaf.view_as(leaf) for leaf in
                (s.w, s.x, s.y, s.z, s.kx, s.ky, s.kz)]
        g = torch.autograd.grad(d_all(s.t, *args).sum(), args,
                                create_graph=True)
        inv = (1.0 / g[0]).detach()
        return RayDerivatives(-g[4] * inv, -g[5] * inv, -g[6] * inv,
                              g[1] * inv, g[2] * inv, g[3] * inv)

    return rhs


def step_vjp(eq, st, ct, method, k, how, tables):
    """The VJP of one recorded step (SUB_STEPS // k plain windows) from
    ``st`` for the output cotangent ``ct``: (state cotangent, psi-table
    and profile-table cotangents or None).  ``how``: "kernel" (K2, or K3
    with ``tables``), "plain" (autograd of frozen_window), or a wrong
    backward on the plain version: "v_w dropped", "other order"."""
    inputs = [st]
    for _ in range(SUB_STEPS // k - 1):
        inputs.append(efit_step.frozen_window(
            eq, cold_plasma, inputs[-1], method=method, dt=DT, steps=k,
            compensated=False))
    order = method
    if how == "other order":
        order = "rk4" if method == "rk2" else "rk2"
    d_tabs = None
    for s in reversed(inputs):
        if how == "kernel":
            vjp = efit_step.efit_window_vjp(eq, s, ct, method=method,
                                            dt=DT, steps=k, tables=tables)
        elif how == "v_w dropped":
            with mock.patch.object(efit_step, "make_ray_rhs",
                                   rhs_without_vw):
                vjp = efit_step.frozen_window_vjp_blocks(
                    eq, s, ct, method=order, dt=DT, steps=k)
        else:
            vjp = efit_step.frozen_window_vjp_blocks(
                eq, s, ct, method=order, dt=DT, steps=k)
        ct = vjp.state
        if tables:
            tabs = efit_step.scatter_block_cotangents(eq, vjp)
            d_tabs = tabs if d_tabs is None else tuple(
                a + b for a, b in zip(d_tabs, tabs))
    return ct, d_tabs


def relative_deviations(got, want):
    """Per tensor (leaf or table): max |got - want| / max |want|."""
    return [float((a.double() - b.double()).abs().max()
                  / b.double().abs().max().clamp_min(1e-300))
            for a, b in zip(got, want)]


def check_window_bwd(eq, st, method, k, seed):
    """K2 and K3 against autograd of the plain version over one recorded
    step from ``st`` with seeded cotangents.  Returns a row: the worst
    relative deviation of the state cotangent (K2 and K3) and of the
    tables (K3), their limits, what the wrong backwards show, and
    ``fail``."""
    ct = random_cotangent(st, seed)
    tol = BWD_TOL[st.x.dtype]
    want_st, want_tab = step_vjp(eq, st, ct, method, k, "plain", True)
    k2, _ = step_vjp(eq, st, ct, method, k, "kernel", False)
    k3, k3_tab = step_vjp(eq, st, ct, method, k, "kernel", True)
    row = {"state": max(relative_deviations(k2, want_st)
                        + relative_deviations(k3, want_st)),
           "tables": max(relative_deviations(k3_tab, want_tab)),
           "limits": tol}
    wrongs = ["v_w dropped"] + (["other order"]
                                if CAN_SEE_ORDER[st.x.dtype, False] else [])
    for how in wrongs:
        w_st, w_tab = step_vjp(eq, st, ct, method, k, how, True)
        row[how] = {"state": max(relative_deviations(w_st, want_st)),
                    "tables": max(relative_deviations(w_tab, want_tab))}
    row["fail"] = [part for part in ("state", "tables")
                   if not row[part] <= tol[part]] + [
        f"{how} {part}" for how in wrongs for part in ("state", "tables")
        if not row[how][part] >= SEPARATION * tol[part]]
    return row


def phase_bwd_vs_plain(device, n=4099):
    rows = {}
    for dtype in (torch.float32, torch.float64):
        eq = synthetic_equilibrium(dtype, device)
        st = init_k(launch(n, dtype, device, seed=SEED + 1), cold_plasma,
                    eq)
        for method in ("rk2", "rk4"):
            for k in (10, 5):
                rows[f"{str(dtype)[6:]}/{method}/K={k}"] = \
                    check_window_bwd(eq, st, method, k, SEED + 2)
    print(f"[3a K2/K3 vs plain, {n} rays, 1 recorded step, seeded "
          f"cotangents] worst relative deviation of the state cotangent "
          f"and of the table cotangents against their limits, and what a "
          f"wrong backward would show: {json.dumps(rows)}")
    failed = {key: row for key, row in rows.items() if row["fail"]}
    if failed:
        raise AssertionError(f"backward kernels vs plain: {failed}")


def reset_launch_counts():
    efit_step.efit_window_launches = 0
    efit_step.efit_window_bwd_launches = 0
    efit_step.efit_window_bwd_tab_launches = 0


def launch_counts():
    return (efit_step.efit_window_launches,
            efit_step.efit_window_bwd_launches,
            efit_step.efit_window_bwd_tab_launches)


def phase_grad_main(device, n=100_000, steps=1000, steps_tab=100):
    """Phase b: fwd+bwd at full width through K1 and K2, twice, then table
    gradients through K3.  The first pass allocates the autograd graph's
    memory from the card (cudaMalloc, through the caching allocator); the
    second finds it cached, as every pass after the first in a training
    loop does.  Returns the launch counts of the second pass and of the
    table run."""
    eq = synthetic_equilibrium(torch.float32, device)
    root = init_k(launch(n, torch.float32, device), cold_plasma, eq)
    sol = production_solver(eq, compensated=False)
    windows = steps * (SUB_STEPS // FREEZE_EVERY)
    for attempt in ("first pass", "second pass"):
        leaves = [leaf.detach().clone().requires_grad_(True)
                  for leaf in root]
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        reset_launch_counts()
        t0 = time.perf_counter()
        loss = endpoint_loss(sol.run(RayState(*leaves), steps))
        torch.cuda.synchronize()
        t_fwd = time.perf_counter() - t0
        graph_bytes = torch.cuda.memory_allocated() - before
        grads = torch.autograd.grad(loss, leaves)
        torch.cuda.synchronize()
        float(grads[2][0])
        seconds = time.perf_counter() - t0
        counts = launch_counts()
        finite = all(bool(torch.isfinite(g).all()) for g in grads)
        rate = n * steps * SUB_STEPS / seconds
        print(f"[b fwd+bwd f32 rk2 K={FREEZE_EVERY}, {attempt}] {n} rays x "
              f"{steps} x {SUB_STEPS}: forward {t_fwd:.3f} s, forward + "
              f"backward {seconds:.3f} s = {rate:.6e} fwd+bwd ray-steps/s; "
              f"launches K1/K2/K3 {counts}; graph holds "
              f"{graph_bytes / 1e9:.3f} GB, the allocator reserves "
              f"{torch.cuda.memory_reserved() / 1e9:.3f} GB; loss "
              f"{float(loss.detach()):.6f}; max |dL/d leaf| "
              f"{json.dumps({f: float(g.abs().max()) for f, g in zip(RayState._fields, grads)})}")
        if counts != (windows, windows, 0) or not finite:
            raise AssertionError(f"fwd+bwd: launches {counts}, finite "
                                 f"{finite}")
        del loss, grads, leaves

    psi = eq.psi_coeffs.clone().requires_grad_(True)
    prof = eq.profile_coeffs.clone().requires_grad_(True)
    eqt = dataclasses.replace(eq, psi_coeffs=psi, profile_coeffs=prof)
    reset_launch_counts()
    t0 = time.perf_counter()
    loss = endpoint_loss(production_solver(eqt, compensated=False).run(
        root, steps_tab))
    d_psi, d_prof = torch.autograd.grad(loss, [psi, prof])
    torch.cuda.synchronize()
    seconds_tab = time.perf_counter() - t0
    counts_tab = launch_counts()
    windows_tab = steps_tab * (SUB_STEPS // FREEZE_EVERY)
    ok = all(bool(torch.isfinite(g).all()) and float(g.abs().max()) > 0
             for g in (d_psi, d_prof))
    print(f"[b table gradients] {n} rays x {steps_tab} x {SUB_STEPS}: "
          f"{seconds_tab:.3f} s = "
          f"{n * steps_tab * SUB_STEPS / seconds_tab:.6e} fwd+bwd "
          f"ray-steps/s; launches K1/K2/K3 {counts_tab}; max |dL/dpsi| "
          f"{float(d_psi.abs().max()):.6e}, max |dL/dprof| "
          f"{float(d_prof.abs().max()):.6e}, "
          f"{int((d_psi != 0).sum())} psi and {int((d_prof != 0).sum())} "
          f"profile coefficients touched")
    if counts_tab != (windows_tab, 0, windows_tab) or not ok:
        raise AssertionError(f"table gradients: launches {counts_tab}, "
                             f"finite and nonzero {ok}")
    return counts, counts_tab


def phase_grad_fd(device, n=256, steps=20):
    """Phase c: d(endpoint loss) through init_k and the kernels, along
    the gradient, against central differences (f64).

    A frozen-window trace is only piecewise smooth in the launch: a ray
    whose window base crosses a cell boundary switches to the neighbouring
    cell's polynomial, a jump far below the rounding of one step but
    present in every difference quotient.  On the CPU, over these 256 rays
    the quotient lies 2.7e-6 (20 recorded steps) and 6.3e-6 (50) from the
    gradient for any step from 1e-4 to 3e-3, while the same trace without
    frozen cells agrees to 3.5e-8: the trace is kept at 20 recorded
    steps."""
    eq = synthetic_equilibrium(torch.float64, device)
    start = launch(n, torch.float64, device, seed=SEED + 3)

    def loss(st, e):
        root = init_k(st, cold_plasma, e)
        return endpoint_loss(production_solver(e, compensated=False).run(
            root, steps))

    def loss_launch(x, ky):
        return loss(start._replace(x=x, ky=ky), eq)

    def loss_psi(psi):
        return loss(start, dataclasses.replace(eq, psi_coeffs=psi))

    rows = {}
    x = start.x.clone().requires_grad_(True)
    ky = start.ky.clone().requires_grad_(True)
    reset_launch_counts()
    g = torch.autograd.grad(loss_launch(x, ky), [x, ky])
    counts = launch_counts()
    norm = float(torch.sqrt(sum((a * a).sum() for a in g)))
    v = [a / norm for a in g]
    h = FD_STEP["launch"]
    with torch.no_grad():
        fd = (loss_launch(start.x + h * v[0], start.ky + h * v[1])
              - loss_launch(start.x - h * v[0], start.ky - h * v[1])) / (2 * h)
    rows["launch (x, ky)"] = {"grad": norm, "fd": float(fd)}

    psi = eq.psi_coeffs.clone().requires_grad_(True)
    (gp,) = torch.autograd.grad(loss_psi(psi), [psi])
    norm = float(gp.norm())
    v = gp / norm
    h = FD_STEP["psi_coeffs"]
    with torch.no_grad():
        fd = (loss_psi(eq.psi_coeffs + h * v)
              - loss_psi(eq.psi_coeffs - h * v)) / (2 * h)
    rows["psi_coeffs"] = {"grad": norm, "fd": float(fd)}
    for row in rows.values():
        row["rel"] = abs(row["grad"] - row["fd"]) / abs(row["fd"])
    print(f"[c gradient vs central differences, f64, {n} rays x {steps} x "
          f"{SUB_STEPS}, through init_k] directional derivative along the "
          f"gradient: {json.dumps(rows)}, rtol {FD_RTOL}; launches "
          f"K1/K2/K3 of the launch gradient {counts}")
    windows = steps * (SUB_STEPS // FREEZE_EVERY)
    bad = {k: r for k, r in rows.items() if not r["rel"] <= FD_RTOL}
    if bad or counts != (windows, windows, 0):
        raise AssertionError(f"gradient vs central differences: {rows}, "
                             f"launches {counts}")


def run_main(eq, state, steps, compensated):
    """Solver.run of the production stack over ``steps`` recorded steps,
    timed; checks the launch count.  Returns (final, carry, rate)."""
    sol = production_solver(eq, compensated=compensated)
    efit_step.efit_window_launches = 0
    (final, carry), seconds = timed(
        lambda: sol.run(state, steps, return_carry=True),
        pick=lambda out: out[0])
    launches = efit_step.efit_window_launches
    expected = steps * (SUB_STEPS // FREEZE_EVERY)
    if launches != expected:
        raise AssertionError(f"{launches} window launches, expected "
                             f"{expected}")
    rate = state.x.shape[0] * steps * SUB_STEPS / seconds
    return final, carry, rate, seconds, launches


def check_rays(label, final, eq, n):
    ok = in_domain(final, eq)
    frac = float(ok.double().mean())
    res = float(residual_fn(cold_plasma, eq)(final).max())
    if frac != 1.0 or not np.isfinite(res):
        raise AssertionError(f"{label}: {frac} of {n} rays finite and in "
                             f"the table; max D^2 {res}")
    return frac, res


def phase_main(device, n=100_000, steps=1000, n_big=1_000_000,
               steps_big=100):
    out = {}
    eq32 = synthetic_equilibrium(torch.float32, device)
    eq64 = synthetic_equilibrium(torch.float64, device)
    st32, init_s = timed(
        lambda: init_k(launch(n, torch.float32, device), cold_plasma, eq32))
    final32, carry32, rate, secs, launches = run_main(eq32, st32, steps,
                                                      True)
    out["launches"] = launches
    frac, res = check_rays("f32", final32, eq32, n)
    print(f"[4a main f32 compensated] {n} rays x {steps} x {SUB_STEPS}: "
          f"init_k {init_s:.3f} s, run {secs:.3f} s = {rate:.6e} "
          f"ray-steps/s; {launches} launches; in table {frac}; "
          f"max D^2 {res:.3e}")
    out["rate_f32"] = rate

    st64 = init_k(launch(n, torch.float64, device), cold_plasma, eq64)
    final64, _, rate64, secs64, launches64 = run_main(eq64, st64, steps,
                                                      False)
    frac64, res64 = check_rays("f64", final64, eq64, n)
    # the gap to f64 from f64's own Newton root, and from f32's root
    # promoted (the integration alone)
    same = RayState(*[leaf.double() for leaf in st32])
    final64s = production_solver(eq64, compensated=False).run(same, steps)
    uncomp32 = production_solver(eq32, compensated=False).run(st32, steps)
    gaps = {label: max(leaf_errors(comp_state_f64(carry32), ref).values())
            for label, ref in (("own root", final64), ("f32 root", final64s))}
    gaps["uncompensated f32, f32 root"] = max(
        leaf_errors(uncomp32, final64s).values())
    print(f"[4b main f64 plain] run {secs64:.3f} s = {rate64:.6e} "
          f"ray-steps/s; {launches64} launches; in table {frac64}; max "
          f"D^2 {res64:.3e}; largest relative gap to f64 {json.dumps(gaps)}"
          f", limits {json.dumps(GAP_TOL)}")
    if not (all(gaps[label] <= limit for label, limit in GAP_TOL.items())
            and gaps["uncompensated f32, f32 root"]
            >= SEPARATION * GAP_TOL["f32 root"]):
        raise AssertionError(f"compensated f32 vs f64: {gaps}")

    n1m, steps1m = n_big, steps_big
    st1m = init_k(launch(n1m, torch.float32, device), cold_plasma, eq32)
    final1m, _, rate1m, secs1m, launches1m = run_main(eq32, st1m, steps1m,
                                                      True)
    frac1m, res1m = check_rays("1M", final1m, eq32, n1m)
    print(f"[4c main 1M f32 compensated] {n1m} rays x {steps1m} x "
          f"{SUB_STEPS}: run {secs1m:.3f} s = {rate1m:.6e} ray-steps/s; "
          f"{launches1m} launches; in table {frac1m}; max D^2 {res1m:.3e}")
    return out, eq32, st32


def phase_segmented(eq, state, steps=32):
    rows = []
    sol = production_solver(eq)
    final = sol.trace_segmented(state, steps, lambda i, row: rows.append(
        (i, row)))
    if [i for i, _ in rows] != list(range(steps + 1)):
        raise AssertionError(f"trace_segmented wrote {len(rows)} rows")
    finite = all(bool(torch.isfinite(l).all()) for _, row in rows
                 for l in row)
    if not finite or rows[-1][1].x.device.type != "cpu":
        raise AssertionError("trace_segmented rows not finite host rows")
    if not torch.equal(rows[-1][1].x, final.x.cpu()):
        raise AssertionError("last row is not the final state")
    print(f"[5 trace_segmented] {len(rows)} rows of {state.x.shape[0]} "
          f"rays, all finite")


def phase_plain_timing(eq, state, kernel_rate, steps=2):
    sol = production_solver(eq, window_kernel=False)
    _, seconds = timed(lambda: sol.run(state, steps))
    rate = state.x.shape[0] * steps * SUB_STEPS / seconds
    print(f"[6 plain version] {state.x.shape[0]} rays x {steps} x "
          f"{SUB_STEPS}: {rate:.6e} ray-steps/s (kernel {kernel_rate:.6e},"
          f" x{kernel_rate / rate:.1f})")


def kernel_record(eq, state, launches):
    """The kernel line: kernel vs plain on one main-path window (100k rays,
    f32 compensated rk2, K = 10), error and milliseconds of each."""
    carry = init_comp_carry(state)
    kern = run_windows(eq, carry, "rk2", FREEZE_EVERY, True, kernel=True)
    plain = run_windows(eq, carry, "rk2", FREEZE_EVERY, True, kernel=False)
    err = max(d for f, d in leaf_deviations(kern, plain).items()
              if f not in ("t", "w"))
    rel = max(leaf_errors(kern, plain).values())
    if not rel <= TOL[torch.float32, True]:
        raise AssertionError(f"main-path window: kernel vs plain {rel}")

    def kern_call():
        return efit_step.efit_window(eq, carry, method="rk2", dt=DT,
                                     steps=FREEZE_EVERY, compensated=True)

    def plain_call():
        return efit_step.frozen_window(eq, cold_plasma, carry, method="rk2",
                                       dt=DT, steps=FREEZE_EVERY,
                                       compensated=True)

    ms = event_ms(kern_call, 20)
    plain_ms = event_ms(plain_call, 3)
    kernel_ms, _ = profile_kernel(lambda: [kern_call() for _ in range(20)])
    sol = production_solver(eq)
    busy_ms, wall_ms = profile_kernel(lambda: sol.run(state, 50))
    share = None if busy_ms is None else busy_ms / wall_ms
    print(f"[7 kernel time] 100000 rays, f32 compensated rk2 K=10: "
          f"{ms:.4f} ms per window call (CUDA events, wrapper included); "
          f"kernel on the device {kernel_ms and kernel_ms / 20} ms "
          f"(profiler); plain version {plain_ms:.4f} ms per window; over 50 "
          f"recorded steps of Solver.run the kernel is busy {busy_ms} of "
          f"{wall_ms:.3f} device ms (share {share})")
    return {"name": "efit_window", "route": "cuda",
            "source": "graph_framework_tpu_torch/csrc/efit_window.cu",
            "replaces": "graph_framework_tpu/pallas/efit_step.py:159",
            "launches": launches, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms}


def bwd_kernel_records(eq, state, launches, launches_tab):
    """The K2 and K3 lines (phase d): each backward kernel against its
    plain version on one main-path window (100k rays, f32 plain rk2,
    K = 10, seeded cotangents): absolute error and milliseconds, by CUDA
    events per wrapper call and by the profiler on the device."""
    ct = random_cotangent(state, SEED + 4)
    kw = dict(method="rk2", dt=DT, steps=FREEZE_EVERY)
    records = []
    for tables, name, line, count, plain in (
            (False, "efit_window_bwd", 260, launches,
             efit_step.frozen_window_vjp),
            (True, "efit_window_bwd_tab", 318, launches_tab,
             efit_step.frozen_window_vjp_blocks)):
        def kern_call():
            return efit_step.efit_window_vjp(eq, state, ct, tables=tables,
                                             **kw)

        def plain_call():
            return plain(eq, state, ct, **kw)

        got, want = kern_call(), plain_call()
        pairs = list(zip(got.state, want if not tables else want.state))
        if tables:
            pairs += [(got.psi_block, want.psi_block),
                      (got.prof_block, want.prof_block)]
            if not (torch.equal(got.psi_cell, want.psi_cell)
                    and torch.equal(got.prof_cell, want.prof_cell)):
                raise AssertionError(f"{name}: cells differ from the "
                                     f"plain version's")
        err = max(float((a.double() - b.double()).abs().max())
                  for a, b in pairs)
        ms = event_ms(kern_call, 10)
        plain_ms = event_ms(plain_call, 2)
        kernel_ms, _ = profile_kernel(lambda: [kern_call() for _ in range(10)],
                                      kernel="efit_window_bwd_kernel")
        print(f"[7 {name} time] {state.x.shape[0]} rays, f32 rk2 "
              f"K={FREEZE_EVERY}: {ms:.4f} ms per window call (CUDA "
              f"events, wrapper included); kernel on the device "
              f"{kernel_ms and kernel_ms / 10} ms (profiler); plain version "
              f"(autograd of frozen_window) {plain_ms:.4f} ms; max abs "
              f"error {err:.3e}")
        records.append({
            "name": name, "route": "cuda",
            "source": "graph_framework_tpu_torch/csrc/efit_window_bwd.cuh",
            "replaces": f"graph_framework_tpu/pallas/efit_step.py:{line}",
            "launches": count, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms})
    return records


def main():
    name, _ = phase_device()
    device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase_build()
    phase_kernel_vs_plain(device)
    phase_bwd_vs_plain(device)
    out, eq32, st32 = phase_main(device)
    counts, counts_tab = phase_grad_main(device)
    phase_grad_fd(device)
    phase_segmented(eq32, st32)
    phase_plain_timing(eq32, st32, out["rate_f32"])
    records = [kernel_record(eq32, st32, out["launches"])]
    records += bwd_kernel_records(eq32, st32, counts[1], counts_tab[2])
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
