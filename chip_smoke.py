#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one CUDA card.

    python3 chip_smoke.py

The main path is the ``xrays`` ray trace: cold-plasma rays over an EFIT
tokamak equilibrium, in the reference benchmark's configuration (100k
rays, 1000 recorded steps x 10 substeps, endtime 1.0), through the
library entry points ``init_k`` and ``Solver.run`` with the production
stack - frozen-cell rk2, a 10-substep freeze window, compensated f32
accumulation and the hand-written CUDA window kernel.  Phases, one line
each (any failed check raises and the script exits non-zero):

1. device: the card's name and, on its own line, ``nvidia-smi``'s
   name and power limit; no CUDA card is a failure, never a CPU run;
2. build: ``nvcc`` builds ``csrc/efit_window.cu``; registers and spills;
3. kernel vs plain PyTorch version at 4099 rays (a ragged count): rk2/rk4
   x plain/compensated x f32/f64, one recorded step at K = 10 and K = 5,
   each within a limit that lies well below what a wrong kernel shows;
4. main path at full width: 100k rays f32 compensated, then f64 plain,
   then 1M rays for 100 recorded steps; launch counts, validity,
   residuals, the f32/f64 endpoint gap, and ray-steps/s;
5. ``trace_segmented``: 32 recorded rows of 100k rays kept in memory;
6. the plain version's ray-steps/s on the card beside the kernel's;
7. the kernel's milliseconds per window beside the plain version's.

It then prints the kernel table as one JSON line and, last, the device
line ``{"ok": true, "device": {...}}``.

The equilibrium is built in memory (no file, no ``h5py``): a smooth
up-down symmetric tokamak flux map on a 129 x 129 grid with 129-knot
profiles, chosen so that the cold-plasma wave propagates everywhere the
rays go - see :func:`synthetic_samples`.  Weights-free: everything is
made from ``SEED``.
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
import time

import numpy as np
import torch

from graph_framework_tpu_torch.constants import Q
from graph_framework_tpu_torch.kernels import build, efit_step
from graph_framework_tpu_torch.models.dispersion import cold_plasma
from graph_framework_tpu_torch.models.efit import efit_from_tables
from graph_framework_tpu_torch.models.rays import RayState, residual_fn
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


def profile_kernel(fn):
    """Run fn once under torch.profiler.  Returns (total device ms of the
    window kernel from the CUDA trace - None if the trace shows no device
    time - and the device-timeline ms of the whole call from CUDA
    events)."""
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
                   if "efit_window_kernel" in e.key)
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
    the variant (f32/rk2/plain, ...) is read from the mangled name of
    efit_window_kernel<T, METHOD, COMPENSATED>."""
    out, variant = {}, None
    for line in log.splitlines():
        m = re.search(r"efit_window_kernelI([fd])Li([24])ELb([01])", line)
        if m:
            variant = (f"{'f32' if m[1] == 'f' else 'f64'}/rk{m[2]}/"
                       f"{'comp' if m[3] == '1' else 'plain'}")
            out[variant] = []
        elif variant and ("spill" in line or "registers" in line):
            out[variant].append(line.split(":", 1)[-1].strip())
    return {k: "; ".join(v) for k, v in sorted(out.items())}


def phase_build():
    t0 = time.perf_counter()
    build.load()
    seconds = time.perf_counter() - t0
    print(f"[2 build] {seconds:.2f} s; ptxas per kernel variant:")
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


def main():
    name, _ = phase_device()
    device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase_build()
    phase_kernel_vs_plain(device)
    out, eq32, st32 = phase_main(device)
    phase_segmented(eq32, st32)
    phase_plain_timing(eq32, st32, out["rate_f32"])
    record = kernel_record(eq32, st32, out["launches"])
    print(json.dumps({"kernels": [record]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
